"""The benchmark's data: cells, configurations, mixes and metric readers
found by name, and traffic drawn from the seed alone."""

import json
import re

import numpy as np
import pytest

from benchmark import harness, workload
from benchmark.reference.encoding import n_qubits
from benchmark.tests.small import ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_finds_its_configuration_and_mix_by_name():
    spec = bench()
    names = {c["name"] for c in spec["configs"]}
    for cfg in spec["configs"]:
        assert (ROOT / cfg["file"]).is_file()
        assert json.loads((ROOT / cfg["file"]).read_text())["name"] == cfg["name"]
    for cell in spec["workloads"]:
        assert cell["config"] in names
        assert workload.load("configs", cell["config"])["limits"]
        assert workload.load("traffic", cell["traffic"])["kind"] in harness.KINDS


def test_every_metric_has_a_reader_and_every_cell_reports_enough():
    spec = bench()
    for metric in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.load_reader(metric["name"]))
    for cell in spec["workloads"]:
        e2e, layer = harness.cell_metrics(cell["name"], spec["end_to_end"], spec["per_layer"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layer


def test_names_and_bounds_keep_the_contract():
    spec = bench()
    metrics = spec["end_to_end"] + spec["per_layer"]
    for entry in metrics + spec["workloads"] + spec["configs"]:
        assert NAME.match(entry["name"]), entry["name"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for metric in spec["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25


def test_a_missing_mix_is_refused_by_name():
    with pytest.raises(FileNotFoundError):
        workload.load("traffic", "no-such-mix")


@pytest.mark.parametrize("mix", ["seeds", "instances"])
def test_solve_traffic_is_drawn_from_the_seed_and_never_repeats(mix):
    cfg = workload.load("configs", "jssp20-exact")
    traffic = workload.load("traffic", mix)
    one = workload.plan_solves(cfg, traffic, 2**31 + 5)
    again = workload.plan_solves(cfg, traffic, 2**31 + 5)
    other = workload.plan_solves(cfg, traffic, 7)
    requests = [one.request(i) for i in range(300)]
    assert requests == [again.request(i) for i in range(300)]
    assert [r[2] for r in requests] != [other.request(i)[2] for i in range(300)]
    assert len({r[2] for r in requests}) == len(requests)
    assert not {one.warmup(k)[2] for k in range(2)} & {r[2] for r in requests}
    limit = cfg["instance"]["makespan_limit"]
    assert {n_qubits(instance, limit) for _, instance, _ in requests} == {20}
    if traffic["fresh_instances"]:
        assert len({r[0] for r in requests}) == len(requests)
    else:
        assert {r[0] for r in requests} == {cfg["instance"]["first_seed"]}


def test_energies_traffic_is_drawn_from_the_seed():
    cfg = workload.load("configs", "jssp20-exact")
    traffic = workload.load("traffic", "energies")
    a = workload.plan_energies(cfg, traffic, 2**31 + 9)
    b = workload.plan_energies(cfg, traffic, 2**31 + 9)
    c = workload.plan_energies(cfg, traffic, 3)
    assert a == b and a.genome_seed != c.genome_seed
    shape = (32, 6, 20, 3)
    assert (a.angles(4, shape) == b.angles(4, shape)).all()
    assert not (a.angles(4, shape) == a.angles(5, shape)).all()
    assert not (a.angles(0, shape) == a.warmup_angles(0, shape)).all()


def test_the_checked_sample_is_drawn_from_the_seed_and_uniform():
    def sample(seed, n=60, k=8):
        kept = list(range(k))
        for i in range(k, n):
            slot = workload.reservoir_slot(seed, i)
            if slot < k:
                kept[slot] = i
        return kept

    assert sample(2**31 + 3) == sample(2**31 + 3) != sample(2**31 + 4)
    counts = np.zeros(60)
    for seed in range(600):
        counts[sample(seed)] += 1
    # each of the 60 requests is kept 8/60 of the time: 80 times in 600 draws
    assert counts.min() > 45 and counts.max() < 120
