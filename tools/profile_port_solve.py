#!/usr/bin/env python3
"""Where the time of the port's config-4 solve goes, on one CUDA card.

Run from the repository root on a machine with a CUDA card:

    python3 tools/profile_port_solve.py [--route fold|slot] [--repeats 3]

Runs the 20-qubit JSSP solve of config 4 (the one ``chip_smoke.py``
drives) on one route -- ``fold`` (the default, ``QUEASARS_MXU`` unset) or
``slot`` (``QUEASARS_MXU=0``) -- once to build and warm up, then
``--repeats`` timed solves, each
with every EVQE operator timed on the host clock (synchronised), then one
solve under ``torch.profiler`` for the device time by kernel and the
device's busy share.  Prints the card's name and power limit first and a
JSON summary last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def timed_operators(solver, totals):
    """Wrap each operator's apply_operator with a synchronised host timer."""
    import torch

    for op in solver.configuration.evolutionary_operators:
        inner = op.apply_operator
        name = type(op).__name__

        def timed(population, operator_context, _inner=inner, _name=name):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = _inner(population=population, operator_context=operator_context)
            torch.cuda.synchronize()
            totals[_name] += time.perf_counter() - start
            return out

        op.apply_operator = timed


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--route", choices=("fold", "slot"), default="fold")
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("profile_port_solve: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)
    chip_smoke.use_route(args.route)
    _, _, hamiltonian = chip_smoke.jssp_with_qubits(3, 3, 6, 20, {1: 0.5, 2: 0.5})
    chip_smoke.config4_solver().compute_minimum_eigenvalue(hamiltonian)  # build + warm-up

    runs = []
    for _ in range(args.repeats):
        totals = defaultdict(float)
        solver = chip_smoke.config4_solver()
        timed_operators(solver, totals)
        chip_smoke.reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = solver.compute_minimum_eigenvalue(hamiltonian)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        evals = int(sum(result.circuit_evaluations))
        runs.append({
            "wall_s": wall, "evaluations": evals, "evals_per_s": evals / wall,
            "operators_s": dict(totals), "launches": chip_smoke.launch_counts(),
            "eigenvalue": result.eigenvalue,
        })
        print(json.dumps(runs[-1]), flush=True)

    from torch.profiler import ProfilerActivity, profile

    solver = chip_smoke.config4_solver()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        solver.compute_minimum_eigenvalue(hamiltonian)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    by_kernel = defaultdict(lambda: [0.0, 0])
    for event in prof.key_averages():
        device_us = getattr(event, "self_device_time_total", 0) or 0
        if device_us > 0:
            by_kernel[event.key][0] += device_us / 1e3
            by_kernel[event.key][1] += event.count
    device_ms = sum(ms for ms, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    for key, (ms, count) in top:
        print(f"  {ms:10.2f} ms  {count:7d} calls  {key[:90]}", flush=True)
    summary = {
        "card": card, "route": args.route, "runs": runs, "profiled_wall_s": wall,
        "device_busy_ms": device_ms,
        "device_busy_share": device_ms / (wall * 1e3),
        "top_kernels_ms": {key[:60]: ms for key, (ms, _) in top},
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
