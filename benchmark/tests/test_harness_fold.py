"""The fold cell on the CPU: its configuration runs the port with no
environment set, the entry points count a fold-route sweep as they count a
slot-route one, and the fold readers read the port's counts over the
window's solves (and nothing where the port keeps none).

On the CPU the fold route is forced by patching the port's predicate
(``fold_kernels.fold_supported``); its wrappers then run their plain
versions, which build pipelines and launch nothing."""

import collections
import copy
import sys

import numpy as np
import pytest
import torch

from benchmark import check, harness, workload
from benchmark.devicetrace import EntryWork
from benchmark.tests import small

CELL = "jssp20-exact-fold.seeds"


def read(name, run):
    return harness.load_reader(name)(run)


def fold_config() -> dict:
    """The fold configuration at ``small.config()``'s size."""
    cfg = copy.deepcopy(workload.load("configs", "jssp20-exact-fold"))
    base = small.config()
    cfg["instance"], cfg["solver"] = base["instance"], base["solver"]
    return cfg


@pytest.fixture
def fold_route(monkeypatch):
    from queasars_tpu_torch.sim import fold_kernels, fold_pipeline

    monkeypatch.delenv("QUEASARS_MXU", raising=False)
    monkeypatch.setattr(
        fold_kernels, "fold_supported",
        lambda n, device, path="exact": fold_pipeline.LANE_BITS <= n <= fold_kernels._CAPS[path])


def test_the_fold_configuration_is_config_four_with_no_environment():
    slot, fold = (workload.load("configs", name) for name in ("jssp20-exact", "jssp20-exact-fold"))
    assert fold["env"] == {} and fold["reduced"] == []
    for key in ("instance", "solver", "assumed", "guarantees", "precision"):
        assert fold[key] == slot[key], key
    # The same upstream settings, named down to what sets this deployment apart.
    upstream = slot["source"].split("; this repo's")[0]
    assert fold["source"] != slot["source"] and fold["source"].startswith(upstream)
    assert "QUEASARS_MXU unset" in fold["source"]
    entry = next(c for c in small.bench()["configs"] if c["name"] == "jssp20-exact-fold")
    assert entry["source"] == fold["source"]
    assert set(fold["limits"]) == set(check.SOLVE_NUMBERS)
    cell = next(c for c in small.bench()["workloads"] if c["name"] == CELL)
    assert cell["chips"] == 1 and cell["traffic"] == "seeds"


def _sweep_arguments(n=8, pop=3, layers=3, seed=0):
    rng = np.random.default_rng(seed)
    gate_types = torch.tensor(rng.choice([0, 1, 3], size=(pop, layers, n)), dtype=torch.int32)
    controls = torch.full((pop, layers, n), -1, dtype=torch.int32)
    angles = torch.tensor(rng.random((pop, layers, n, 3)), dtype=torch.float32)
    layer_mask = torch.ones((pop, layers), dtype=torch.bool)
    last_layer = torch.tensor([2, 1, 2])
    coords = torch.tensor(rng.integers(0, n, size=(pop, 6, 2)), dtype=torch.int32)
    n_free = torch.tensor([6, 4, 5], dtype=torch.int32)
    active = torch.tensor([True, True, False])
    table = torch.tensor(rng.random(1 << n), dtype=torch.float32)
    return ((gate_types, controls, angles, layer_mask, last_layer, coords, n_free, active, table),
            dict(n_qubits=n, maxiter=12, reset_interval=4, initial_state=None))


def test_entry_points_count_a_fold_sweep_as_a_slot_sweep(monkeypatch, fold_route):
    from queasars_tpu_torch.optim import nft, sweep_kernel_launch
    from queasars_tpu_torch.sim import slot_kernels

    taken = collections.Counter()

    def stub(route):
        def run(*args, **kwargs):
            taken[route] += 1
            return torch.zeros(3, 8, 3), torch.zeros(3)
        return run

    monkeypatch.setattr(sweep_kernel_launch, "nft_layer_sweep_folded_launch", stub("fold"))
    monkeypatch.setattr(slot_kernels, "population_states", lambda *a: None)
    monkeypatch.setattr(slot_kernels, "nft_layer_sweep", stub("slot"))
    args, kwargs = _sweep_arguments()
    original = nft.nft_layer_sweep_launch
    entries = EntryWork()
    entries.install()
    entries.recording = True
    assert nft.nft_layer_sweep_launch is not original
    for route in ("1", "0"):
        monkeypatch.setenv("QUEASARS_MXU", route)
        nft.nft_layer_sweep_launch(*args, **kwargs)
    entries.recording = False
    entries.uninstall()
    assert nft.nft_layer_sweep_launch is original
    assert sweep_kernel_launch.nft_layer_sweep_launch is original
    assert taken == {"fold": 1, "slot": 1}
    total, by_rule = entries.least_seconds()
    assert by_rule["sweep"][3] == 2 and total > 0
    fold_call, slot_call = entries.calls
    entries.calls = [fold_call]
    assert entries.least_seconds()[0] == pytest.approx(total / 2, rel=1e-12)


def _kept(*starts):
    return collections.deque(starts, maxlen=4096)


def test_the_fold_readers_take_the_windows_solves(monkeypatch):
    from queasars_tpu_torch.utils import profiling

    now = {"slot_kernels.energies_exact": 90, "fold_kernels.energies_exact_folded": 700,
           "fold_kernels.nft_layer_sweep_folded": 12, "fold_pipeline.builds": 700,
           "fold_pipeline.host_ns": 9_000_000_000}
    warmup = {"slot_kernels.energies_exact": 0, "fold_kernels.energies_exact_folded": 0,
              "fold_kernels.nft_layer_sweep_folded": 0, "fold_pipeline.builds": 0,
              "fold_pipeline.host_ns": 0}
    window = {"slot_kernels.energies_exact": 90, "fold_kernels.energies_exact_folded": 100,
              "fold_kernels.nft_layer_sweep_folded": 2, "fold_pipeline.builds": 100,
              "fold_pipeline.host_ns": 1_000_000_000}
    monkeypatch.setattr(profiling, "solve_starts", _kept(warmup, warmup, window, window, window))
    monkeypatch.setattr(profiling, "counters", lambda: now)
    run = {"kind": "solve", "done": 2, "attempted": 3, "trace": {"spans": {}}}
    assert read("fold_launches_per_solve", run) == pytest.approx((600 + 10) / 2)
    assert read("fold_build_s", run) == pytest.approx(8.0 / 2)
    for absent in ({**run, "trace": None}, {**run, "kind": "energies"}, {**run, "done": 0},
                   {**run, "attempted": 6}):
        assert read("fold_launches_per_solve", absent) is None
        assert read("fold_build_s", absent) is None


def test_the_fold_readers_read_nothing_from_a_port_without_the_counts(monkeypatch):
    from queasars_tpu_torch.utils import profiling

    run = {"kind": "solve", "done": 2, "attempted": 2, "trace": {"spans": {}}}
    monkeypatch.setattr(profiling, "solve_starts", _kept({}, {}))
    monkeypatch.setattr(profiling, "counters", lambda: {"slot_kernels.energies_exact": 4})
    assert read("fold_build_s", run) is None
    assert read("fold_launches_per_solve", run) == 0.0
    monkeypatch.delattr(profiling, "counts_since")
    assert read("fold_build_s", run) is None
    assert read("fold_launches_per_solve", run) is None
    monkeypatch.delitem(sys.modules, "queasars_tpu_torch.utils.profiling")
    assert read("fold_build_s", run) is None
    assert read("fold_launches_per_solve", run) is None


def test_a_traced_cpu_run_of_the_fold_cell_reads_the_window_builds(monkeypatch, fold_route):
    from queasars_tpu_torch.sim import fold_pipeline
    from queasars_tpu_torch.utils import profiling

    starts = []
    real = profiling.counters

    def kept():
        counts = real()
        starts.append(counts["fold_pipeline.host_ns"])
        return counts

    monkeypatch.setattr(profiling, "counters", kept)
    line = small.run(CELL, trace=True, cfg=fold_config())
    assert line["correct"] is True, line["checked"]
    metrics = line["metrics"]
    assert metrics["fold_launches_per_solve"]["value"] == 0.0  # plain versions launch nothing
    window_ns = fold_pipeline.build_counts["host_ns"] - starts[2]  # after the two warm-ups
    solves = line["attempted"] - line["failed"]
    assert metrics["fold_build_s"]["value"] == pytest.approx(window_ns * 1e-9 / solves, rel=1e-2)
    assert metrics["fold_build_s"]["value"] > 0
    for name in ("device_idle_pct.solve", "kernel_roofline_pct.solve", "launches_per_solve"):
        assert name not in metrics  # no card, no device trace


def test_the_slot_cells_report_no_fold_metric():
    spec = small.bench()
    for cell in spec["workloads"]:
        _, layer = harness.cell_metrics(cell["name"], spec["end_to_end"], spec["per_layer"])
        names = {m["name"] for m in layer}
        assert ({"fold_build_s", "fold_launches_per_solve"} <= names) == (cell["name"] == CELL)
