#!/usr/bin/env python3
"""The compacted-gate energies kernel against the slot energies kernel at
``bench.py``'s shape, on one CUDA card: the port's counterpart of
``experiments/exp_compact.py``.

Run from the repository root on a machine with a CUDA card:

    python3 tools/port_compact.py

Builds ``bench.py``'s workload through the port (``chip_smoke.random_genomes``
at n=20, population 32, 5 real layers in the 6-layer bucket, seed 0, and
``chip_smoke.synthetic_table``'s 512-term table), then prints the card's
name and power limit, the compaction's statistics and host time, the
compacted-gate energies and probabilities against the slot kernels' on the
card, and the sustained evaluations/s of each energies kernel over
``ITERS`` angle perturbations per timed call, ``REPEATS`` calls each, in
turns, with their ratio.  A JSON summary is the last line.  Without a
CUDA device it exits non-zero.

``chip_smoke.py`` runs :func:`compact_path` once as its compacted-gate
kernels' main path.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

#: angle perturbations per timed call, and timed calls per kernel
#: (experiments/exp_compact.py's SCAN_ITERS and REPEATS)
ITERS = 40
REPEATS = 3


def compaction_stats(compact, gate_types) -> dict:
    """Active gates per individual against the slot kernels' visits."""
    counts = compact.boundaries[:, -1].cpu().double()
    pop, layers, n = gate_types.shape
    return dict(min=int(counts.min()), max=int(counts.max()), mean=float(counts.mean()),
                padded=compact.max_gates, slot_visits=layers * n, active=int(counts.sum()),
                all_visits=pop * layers * n)


def describe_compaction(stats) -> str:
    return (f"active gates per individual: min={stats['min']} max={stats['max']} "
            f"mean={stats['mean']:.1f} (padded G={stats['padded']}; slot kernel visits "
            f"{stats['slot_visits']}); {stats['active']} of {stats['all_visits']} slot visits "
            f"active ({stats['active'] / stats['all_visits']:.1%})")


def sustained_rates(genome, compact, table) -> dict:
    """Sustained evaluations/s of the compacted-gate energies kernel (row 12)
    and the slot energies kernel (row 1): each timed call evaluates the
    population at ``ITERS`` angle perturbations (angles + 0.001 k, as
    experiments/exp_compact.py's scan does) and ends in a synchronise;
    ``REPEATS`` calls each, in turns, after two warm calls each."""
    import torch

    from queasars_tpu_torch.sim import compact_kernels as ck
    from queasars_tpu_torch.sim import slot_kernels as sk

    gt, ctrl, ang, mask = genome
    pop, n = gt.shape[0], gt.shape[2]

    def compact_run(i):
        base, acc = ang + 0.01 * i, torch.zeros(pop, device=ang.device)
        for k in range(ITERS):
            acc += ck.compact_energies_exact(compact, base + 0.001 * k, table)
        return acc

    def slot_run(i):
        base, acc = ang + 0.01 * i, torch.zeros(pop, device=ang.device)
        for k in range(ITERS):
            acc += sk.energies_exact(gt, ctrl, base + 0.001 * k, mask, table, n)
        return acc

    runs = {"compact": compact_run, "slot": slot_run}
    for run in runs.values():
        run(0)
        run(1)
    torch.cuda.synchronize()
    seconds = dict.fromkeys(runs, 0.0)
    for i in range(REPEATS):
        for name in (("compact", "slot") if i % 2 == 0 else ("slot", "compact")):
            start = time.perf_counter()
            runs[name](i + 2)
            torch.cuda.synchronize()
            seconds[name] += time.perf_counter() - start
    return {name: pop * REPEATS * ITERS / s for name, s in seconds.items()}


def compact_path(genome, table) -> dict:
    """Compact the genome, check the compacted-gate energies and
    probabilities against the slot kernels' on the card, and measure both
    energies kernels' sustained evaluations/s."""
    import torch

    from queasars_tpu_torch.sim import compact_kernels as ck
    from queasars_tpu_torch.sim import slot_kernels as sk

    gt, ctrl, ang, mask = genome
    n = gt.shape[2]
    start = time.perf_counter()
    compact = ck.compact_gates(gt, ctrl, mask, n, device=ang.device)
    host_ms = (time.perf_counter() - start) * 1e3
    e_compact = ck.compact_energies_exact(compact, ang, table)
    p_compact = ck.compact_probs(compact, ang)
    e_slot = sk.energies_exact(gt, ctrl, ang, mask, table, n)
    p_slot = sk.population_probs(gt, ctrl, ang, mask, n)
    rates = sustained_rates(genome, compact, table)
    return dict(
        stats=compaction_stats(compact, gt), host_ms=host_ms,
        energy_diff=float((e_compact.double() - e_slot.double()).abs().max()),
        probs_diff=float((p_compact.double() - p_slot.double()).abs().max()),
        bits_equal=bool(torch.equal(e_compact, e_slot) and torch.equal(p_compact, p_slot)),
        compact_rate=rates["compact"], slot_rate=rates["slot"],
        speedup=rates["compact"] / rates["slot"], iters=ITERS, repeats=REPEATS,
    )


def report_compact_path(result, say=print) -> None:
    say(f"  compact path: {describe_compaction(result['stats'])}; compact_gates "
        f"{result['host_ms']:.3f} ms on the host")
    say(f"  compact path: compact vs slot max|diff|: energies {result['energy_diff']:.3e}, "
        f"probabilities {result['probs_diff']:.3e}; equal bits: {result['bits_equal']}")
    say(f"  compact path: compact kernel sustained {result['compact_rate']:.1f} evals/s, slot "
        f"kernel {result['slot_rate']:.1f} evals/s, speedup {result['speedup']:.4f}x "
        f"({result['iters']} perturbations x {result['repeats']} repeats)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_compact: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)
    n, bench = chip_smoke.N_QUBITS, chip_smoke.BENCH
    genome = chip_smoke.random_genomes(n, bench["layers"], bench["population"], 0)
    table = chip_smoke.synthetic_table(n, bench["terms"])
    result = compact_path(genome, table)
    report_compact_path(result)
    if not result["bits_equal"]:
        print("port_compact: the compacted-gate kernels give other bits than the slot kernels",
              file=sys.stderr)
        return 1
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0), **result}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
