"""The metric arithmetic: a percentile over all solves, a rate over the
whole window, the device's idle share from kernel intervals, and the
roofline rules against the smoke script's bounds."""

import math

import numpy as np
import pytest
import torch

from benchmark import harness, roofline
from benchmark.devicetrace import Spans, reduce_window, union_seconds


def read(name, run):
    return harness.load_reader(name)(run)


def solve_run(**extra):
    run = {"kind": "solve", "setup_s": 12.5, "window_s": 30.0, "done": 120, "attempted": 120,
           "solve_s": [], "evals": [], "population": None, "trace": None}
    run.update(extra)
    return run


def test_the_percentile_is_the_nearest_rank_over_every_solve():
    times = [float(i) for i in range(1, 101)]
    assert read("solve_s_p90", solve_run(solve_s=times[::-1])) == 90.0
    assert read("solve_s_p90", solve_run(solve_s=[0.3] * 9 + [5.0])) == 0.3
    assert read("solve_s_p90", solve_run(solve_s=[0.3] * 8 + [5.0, 6.0])) == 5.0


def test_rates_are_taken_over_the_whole_window():
    assert read("solves_per_s", solve_run()) == 4.0
    run = {"kind": "energies", "window_s": 10.0, "done": 250, "population": 32, "trace": None}
    assert read("evals_per_s", run) == 800.0
    assert read("solves_per_s", run) is None
    assert read("setup_s", solve_run()) == 12.5


def test_idle_share_comes_from_the_union_of_device_intervals():
    busy, gaps = union_seconds([(1.0, 2.0), (1.5, 3.0), (4.0, 4.5), (9.5, 12.0)], 0.0, 10.0)
    assert busy == pytest.approx(3.0)
    assert gaps == [(0.0, 1.0), (3.0, 4.0), (4.5, 9.5)]
    spans = Spans()
    spans.intervals += [(0.0, 10.0, "solve", 0), (4.4, 9.8, "EVQESelection", 1)]
    events = [("k1", 1.0, 2.0, "kernel"), ("k2", 1.5, 3.0, "kernel"),
              ("Memcpy DtoH", 4.0, 4.5, "memcpy")]
    window = reduce_window(events, 0.0, 10.0, spans)
    assert window["busy_s"] == pytest.approx(2.5) and window["kernels"] == 2
    assert window["kernel_s"] == pytest.approx(2.5)
    assert dict(map(tuple, window["idle_gaps"])) == pytest.approx(
        {"solve": 2.0, "EVQESelection": 5.5})
    run = solve_run(trace={**window, "least_s": 0.25, "spans": {}, "encodes": 0})
    assert read("device_idle_pct.solve", run) == pytest.approx(75.0)
    assert read("kernel_roofline_pct.solve", run) == pytest.approx(10.0)
    assert read("launches_per_solve", run) == pytest.approx(2 / 120)
    assert read("device_idle_pct.energies", run) is None


def _genomes(n, layers, population, seed, min_layers):
    from queasars_tpu_torch.genome import EVQEPopulation, PackedPopulation

    pop = EVQEPopulation.random_population(n, layers, population, True, random_seed=seed)
    packed = PackedPopulation.pack(list(pop.individuals), min_layers=min_layers)
    return packed.gate_types, packed.layer_mask


def test_roofline_reproduces_the_smoke_scripts_bench_bound():
    import chip_smoke

    gt, lm = _genomes(20, 5, 32, 0, 5)
    moved, flops = roofline.energies_work(gt, lm, 20, from_state=False)
    seconds, bound = roofline.least_seconds(moved, flops)
    theirs = chip_smoke.bound(chip_smoke.genome_bytes(torch.as_tensor(gt), torch.as_tensor(lm)) + 4 * (1 << 20) + 4 * 32,
                              chip_smoke.circuit_flops(torch.as_tensor(gt), torch.as_tensor(lm), 20)
                              + chip_smoke.FLOPS_PER_AMPLITUDE_ENERGY * (1 << 20) * 32)
    assert bound == theirs[1] == "operations"
    assert seconds * 1e3 == pytest.approx(theirs[0])
    assert round(seconds * 1e3, 3) == 0.312


def test_roofline_reproduces_row_one_from_a_prefix():
    import chip_smoke

    gt, lm = _genomes(20, 6, 16, 1, 6)
    lm = lm.copy()
    lm[::3, -1] = False
    last = lm.sum(axis=1) - 1
    prefix = lm & (np.arange(lm.shape[1])[None, :] < last[:, None])
    suffix = lm & ~prefix
    moved, flops = roofline.energies_work(gt, suffix, 20, from_state=True)
    seconds, bound = roofline.least_seconds(moved, flops)
    dim = 1 << 20
    theirs = chip_smoke.bound(
        chip_smoke.genome_bytes(torch.as_tensor(gt), torch.as_tensor(lm)) + 4 * dim + 8 * dim * 16
        + 4 * 16,
        chip_smoke.circuit_flops(torch.as_tensor(gt), torch.as_tensor(suffix), 20)
        + chip_smoke.FLOPS_PER_AMPLITUDE_ENERGY * dim * 16)
    assert bound == theirs[1] == "bytes"
    assert seconds * 1e3 == pytest.approx(theirs[0])
    assert round(seconds * 1e3, 4) == 0.0413


def test_sweep_schedule_and_flops_follow_the_smoke_scripts_rule():
    import chip_smoke

    rng = np.random.default_rng(4)
    n, pop, k = 9, 6, 27
    gt = rng.choice([0, 1, 2, 3], size=(pop, n)).astype(np.int32)
    coords = np.zeros((pop, k, 2), dtype=np.int32)
    n_free = rng.integers(0, k + 1, size=pop).astype(np.int32)
    coords[:, :, 0] = rng.integers(0, n, size=(pop, k))
    active = rng.random(pop) < 0.8
    rebuilds, transitions = roofline.sweep_plan(gt, coords[:, :, 0], n_free, active, 40, 32)
    plan = chip_smoke.sweep_plan(torch.as_tensor(gt), torch.as_tensor(coords),
                                 torch.as_tensor(n_free), torch.as_tensor(active), n, 40, 32)
    assert rebuilds == plan["rebuilds"] and transitions == plan["transitions"]
    assert roofline.sweep_flops(gt, n, rebuilds, transitions) == chip_smoke.sweep_flops(plan)
    assert math.isfinite(roofline.least_seconds(1e9, 1e12)[0])
