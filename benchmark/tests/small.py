"""A configuration and cells at a size a CPU test run holds: config 1's
2x2 JSSP family on 8 qubits, a small population."""

import copy
import json

from benchmark import workload

ROOT = workload.ROOT.parent


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def config() -> dict:
    cfg = copy.deepcopy(workload.load("configs", "jssp20-exact"))
    cfg["instance"].update(n_jobs=2, n_machines=2, relative_op_amount=1.0, op_duration=1,
                           makespan_limit=4, qubits=8, first_seed=0)
    cfg["solver"].update(population_size=6, nft_maxiter=4, max_generations=2, pack_min_layers=2)
    return cfg


def traffic(name: str) -> dict:
    mix = workload.load("traffic", name)
    if mix["kind"] == "energies":
        mix.update(population=4, layers=3, min_layers=4, checked_calls=3)
    return mix


def run(cell_name: str, seed: int = 2**31 + 11, seconds: float = 1.0, trace: bool = False,
        control: bool = False, cfg: dict | None = None) -> dict:
    from benchmark import harness

    spec = bench()
    cell = next(c for c in spec["workloads"] if c["name"] == cell_name)
    return harness.run_cell(cell, cfg or config(), traffic(cell["traffic"]), spec["end_to_end"],
                            spec["per_layer"], seed=seed, seconds=seconds, trace=trace,
                            device="cpu", control=control)
