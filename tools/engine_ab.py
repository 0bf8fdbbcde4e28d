#!/usr/bin/env python3
"""Times the slot, fold and compacted-gate kernels (rows 1-13) of two
checkouts of the port on one CUDA card, in turns, at ``chip_smoke.py``'s
shapes.

Run from the repository root on a machine with a CUDA card:

    python3 tools/engine_ab.py --other DIR [--json PATH]

``DIR`` holds another checkout of the repository (for example the parent
commit, unpacked with ``git archive``).  Each turn is a fresh process that
imports ``queasars_tpu_torch`` and ``chip_smoke`` from one checkout, builds
that checkout's kernels and times, with CUDA events after a warm-up, at
n=20, P=16, L=6 on config 4's 20-qubit JSSP table (``chip_smoke.Workload``):

- row 1, the slot energies from the prefix states, from |0...0> and at
  bench.py's shape (P=32, 5 layers, 512-term table); row 2, the slot
  prefix states; row 3, the slot sweep (maxiter 30); row 4, the whole
  circuits' probabilities, also at bench.py's shape; row 5, 512 sampled
  shots from |0...0> and from the prefix states;
- row 6, the fold energies from the prefix states, from |0...0> and at
  bench.py's shape;
- row 7, the prefix states; row 8, the folded sweep (maxiter 30);
- row 9, the whole circuits' probabilities;
- row 10, 512 sampled shots from |0...0> and from the prefix states;
- row 11, the grouped sampler on TFIM-20 (512 shots per group) from
  |0...0> and from the prefix states;
- the fold states kernel on identity factors marked active with no phase:
  in the engine every pass then only streams the planes;
- rows 12 and 13, the compacted-gate energies and probabilities of the
  whole circuits (``compact_gates`` of the genome), at both shapes.

The turns run in the order A B B A (A is this checkout, B the other),
ten timed calls per row and turn (three for a sweep).  Where a checkout's
``chip_smoke.py`` can count them (``engine_bytes`` for the fold engine,
``slot_engine_bytes`` for the slot engine, ``compact_engine_bytes`` for
the compacted-gate kernels on that engine, ``sweep_engine_bytes`` for the
two sweeps) the turn also reports each call's engine bytes (the passes'
traffic by the design's rule, without an epilogue's) and those bytes over
the call's time.
Prints the card's name and power limit and one line per row with both
checkouts' times (ms, mean over their turns, and each turn) and the ratio;
``--json`` writes the whole record to PATH.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = "ABBA"  # the turns: A is this checkout, B the other
REPS = 10  # timed calls per row and turn (3 for the sweep)


def worker(root: str) -> dict:
    """Time rows 1-13 with the checkout at ``root``; returns ms per call
    (and engine bytes per call where the checkout can count them)."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from queasars_tpu_torch.sim import compact_kernels as ck
    from queasars_tpu_torch.sim import fold_kernels as fk
    from queasars_tpu_torch.sim import slot_kernels as sk
    from queasars_tpu_torch.sim.fold_pipeline import (
        FoldPipeline,
        build_fold_pipeline,
        extend_fold_pipeline_with_rotation,
    )
    from queasars_tpu_torch.sim.grouped_sampling import grouped_operands
    from queasars_tpu_torch.utils import cuda_lib, prng

    assert os.path.dirname(os.path.abspath(fk.__file__)).startswith(os.path.abspath(root))
    cuda_lib.load()
    n = cs.N_QUBITS
    _, _, hamiltonian = cs.jssp_with_qubits(3, 3, 6, n, {1: 0.5, 2: 0.5})
    from queasars_tpu_torch.paulis import diagonal_energy_table

    table = diagonal_energy_table(hamiltonian, dtype=torch.float32, device=cs.DEVICE)
    w = cs.Workload(table)
    gt, ctrl, ang = w.gt, w.ctrl, w.ang

    def pipe(mask, genome=(gt, ctrl, ang)):
        return build_fold_pipeline(*genome, mask, n, absorb_diag=True)

    pre, suf, full = pipe(w.pmask), pipe(w.smask), pipe(w.mask)
    bgt, bctrl, bang, bmask = w.bench
    bench = pipe(bmask, (bgt, bctrl, bang))
    prefix = sk.population_states(gt, ctrl, ang, w.pmask, n)
    fold_prefix = fk.population_states_folded(pre, n)
    keys = prng.split(prng.PRNGKey(cs.SAMPLED["seed"]), w.pop)
    frac = prng.uniform(keys, (cs.SAMPLED["shots"],)).to(cs.DEVICE)
    meta = [torch.as_tensor(m, device=cs.DEVICE) for m in fk.fold_sweep_metadata(
        w.gt1.cpu().numpy(), w.ctrl1.cpu().numpy(), n)]
    sweep = (w.gt1, w.ang1, w.coords, w.n_free, w.active, fold_prefix, table, *meta, n,
             cs.SOLVE["maxiter"], 32)
    ops = grouped_operands(cs.tfim20(), cs.DEVICE)
    fracs = [prng.uniform(prng.fold_in(keys, g), (cs.SAMPLED["shots"],)).to(cs.DEVICE)
             for g in range(ops.tables.shape[0])]

    def grouped(start):
        return fk.grouped_shot_indices_folded(full if start is None else suf, ops.rot_factors,
                                              ops.rot_active, fracs, n, start, rotate=ops.rotate)

    # identity factors in every group, marked active, and no phase: every
    # pass runs and has nothing to apply, so it only streams the planes
    eye = torch.zeros_like(pre.factors)
    eye[:, :, :, 0, 0, 0] = eye[:, :, :, 0, 1, 1] = 1.0
    none = torch.zeros_like(pre.diag_count)
    copy = FoldPipeline(eye, *pre[1:4], none, torch.ones_like(pre.group_active), *pre[6:9], none)

    rotations = {key: [extend_fold_pipeline_with_rotation(base, ops.rot_types[g],
                                                          ops.rot_angles[g], n)
                       for g, rotate in enumerate(ops.rotate) if rotate]
                 for key, base in (("full", full), ("suf", suf))}
    bench_table = w.bench_table
    slot_sweep = (w.gt1, w.ctrl1, w.ang1, w.coords, w.n_free, w.active, prefix, table, n,
                  cs.SOLVE["maxiter"], 32)

    def fold(pipeline, rotated=()):
        if hasattr(cs, "engine_bytes"):
            return lambda: cs.engine_bytes(pipeline, n, rotated)
        return None

    def slot(gate_types, mask):
        if hasattr(cs, "slot_engine_bytes"):
            return lambda: cs.slot_engine_bytes(gate_types, mask, n)
        return None

    def listed(lists):
        if hasattr(cs, "compact_engine_bytes"):
            return lambda: cs.compact_engine_bytes(lists, n)
        return None

    compact = ck.compact_gates(gt, ctrl, w.mask, n, device=cs.DEVICE)
    bench_compact = ck.compact_gates(bgt, bctrl, bmask, n, device=cs.DEVICE)

    def swept(route):
        if hasattr(cs, "sweep_engine_bytes"):
            return lambda: cs.sweep_engine_bytes(w.sweep_plan, route)
        return None

    calls = {  # name: (call, its engine bytes or None, timed calls)
        "row 1 energies from prefix": (
            lambda: sk.energies_exact(gt, ctrl, ang, w.smask, table, n, prefix),
            slot(gt, w.smask), REPS),
        "row 1 energies from |0>": (lambda: sk.energies_exact(gt, ctrl, ang, w.mask, table, n),
                                    slot(gt, w.mask), REPS),
        "row 1 energies bench shape": (
            lambda: sk.energies_exact(bgt, bctrl, bang, bmask, bench_table, n),
            slot(bgt, bmask), REPS),
        "row 2 states (prefix circuits)": (
            lambda: sk.population_states(gt, ctrl, ang, w.pmask, n), slot(gt, w.pmask), REPS),
        "row 3 sweep": (lambda: sk.nft_layer_sweep(*slot_sweep), swept("slot"), 3),
        "row 4 probabilities": (lambda: sk.population_probs(gt, ctrl, ang, w.mask, n),
                                slot(gt, w.mask), REPS),
        "row 4 probabilities bench shape": (
            lambda: sk.population_probs(bgt, bctrl, bang, bmask, n), slot(bgt, bmask), REPS),
        "row 5 sampled from |0>": (
            lambda: sk.sampled_shot_indices(gt, ctrl, ang, w.mask, frac, n),
            slot(gt, w.mask), REPS),
        "row 5 sampled from prefix": (
            lambda: sk.sampled_shot_indices(gt, ctrl, ang, w.smask, frac, n, prefix),
            slot(gt, w.smask), REPS),
        "copy passes (identity factors)": (lambda: fk.population_states_folded(copy, n),
                                           fold(copy), REPS),
        "row 6 energies from prefix": (lambda: fk.energies_exact_folded(suf, table, n, prefix),
                                       fold(suf), REPS),
        "row 6 energies from |0>": (lambda: fk.energies_exact_folded(full, table, n), fold(full),
                                    REPS),
        "row 6 energies bench shape": (
            lambda: fk.energies_exact_folded(bench, bench_table, n), fold(bench), REPS),
        "row 7 states (prefix circuits)": (lambda: fk.population_states_folded(pre, n), fold(pre),
                                           REPS),
        "row 8 sweep": (lambda: fk.nft_layer_sweep_folded(*sweep), swept("fold"), 3),
        "row 9 probabilities": (lambda: fk.population_probs_folded(full, n), fold(full), REPS),
        "row 10 sampled from |0>": (lambda: fk.sampled_shot_indices_folded(full, frac, n),
                                    fold(full), REPS),
        "row 10 sampled from prefix": (
            lambda: fk.sampled_shot_indices_folded(suf, frac, n, prefix), fold(suf), REPS),
        "row 11 grouped TFIM from |0>": (lambda: grouped(None),
                                         fold(full, rotations["full"]), REPS),
        "row 11 grouped TFIM from prefix": (lambda: grouped(prefix),
                                            fold(suf, rotations["suf"]), REPS),
        "row 12 energies from |0>": (lambda: ck.compact_energies_exact(compact, ang, table),
                                     listed(compact), REPS),
        "row 12 energies bench shape": (
            lambda: ck.compact_energies_exact(bench_compact, bang, bench_table),
            listed(bench_compact), REPS),
        "row 13 probabilities": (lambda: ck.compact_probs(compact, ang), listed(compact), REPS),
        "row 13 probabilities bench shape": (lambda: ck.compact_probs(bench_compact, bang),
                                             listed(bench_compact), REPS),
    }

    out = {}
    for name, (fn, moved_fn, reps) in calls.items():
        ms = cs.time_ms(fn, reps)
        record = {"ms": ms}
        if moved_fn is not None:
            moved = moved_fn()
            record.update(engine_bytes=moved, engine_gb_per_s=moved / ms / 1e6)
        out[name] = record
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", help="another checkout of the repository")
    parser.add_argument("--json", help="write the record to this file")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("engine_ab: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)
    if not args.other:
        parser.error("--other is needed")
    roots = {"A": HERE, "B": os.path.abspath(args.other)}
    turns = []
    for label in ORDER:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", roots[label]],
            capture_output=True, text=True, cwd=roots[label],
        )
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        turns.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
        print(f"turn {len(turns)} ({label}, {roots[label]}) done", flush=True)
    summary = {}
    for name in turns[0][1]:
        row = {}
        for label in "AB":
            times = [t[name]["ms"] for lab, t in turns if lab == label]
            row[label] = {"ms": sum(times) / len(times), "turns": times}
            extra = next(t[name] for lab, t in turns if lab == label)
            if "engine_bytes" in extra:
                row[label]["engine_bytes"] = extra["engine_bytes"]
                row[label]["engine_gb_per_s"] = extra["engine_bytes"] / row[label]["ms"] / 1e6
        summary[name] = row
        text = "; ".join(
            f"{lab} {r['ms']:.3f} ms ({', '.join(f'{x:.3f}' for x in r['turns'])})"
            + (f", {r['engine_bytes'] / 1e9:.3f} GB, {r['engine_gb_per_s']:.1f} GB/s"
               if "engine_bytes" in r else "")
            for lab, r in row.items())
        print(f"{name}: {text}; B/A {row['B']['ms'] / row['A']['ms']:.3f}", flush=True)
    if args.json:
        with open(args.json, "w") as handle:
            json.dump({"card": card, "roots": roots, "order": ORDER, "rows": summary},
                      handle, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
