#!/usr/bin/env python3
"""Readings for the limits of a cell's comparison, in one process.

    python benchmark/calibrate.py --workload <cell> --seeds 12 --seconds 5 \\
        [--first-seed N] [--out readings.json]

Runs the cell at its own size on each seed in turn (a short window at the
cell's own load, long enough to hold the answers a run checks) and judges the same answers twice: the port's against the
float64 reference, and the control's (the reference in bfloat16 put in the
port's place).  Prints, per number, the largest port reading (the lower
reading of its limit) and the smallest control reading (the upper one),
and every seed's readings.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--first-seed", type=int, default=2**31 + 101)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    from benchmark import harness, workload

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(c for c in bench["workloads"] if c["name"] == args.workload)
    config = workload.load("configs", cell["config"])
    traffic = workload.load("traffic", cell["traffic"])
    rows = []
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        start = time.perf_counter()
        line = harness.run_cell(cell, config, traffic, bench["end_to_end"], bench["per_layer"],
                                seed=seed, seconds=args.seconds, trace=False, control=True)
        rows.append({"seed": seed, "answers": line["checked"]["answers"],
                     "attempted": line["attempted"], "failed": line["failed"],
                     "port": {n: e["value"] for n, e in line["port"].items()},
                     "control": {n: e["value"] for n, e in line["checked"].items()
                                 if n != "answers"},
                     "seconds": time.perf_counter() - start})
        print(json.dumps(rows[-1]), flush=True)
    names = list(rows[0]["port"])
    summary = {"cell": args.workload, "seeds": len(rows),
               "lower": {n: max(r["port"][n] for r in rows) for n in names},
               "upper": {n: min(r["control"][n] for r in rows) for n in names},
               "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: summary[k] for k in ("cell", "seeds", "lower", "upper")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
