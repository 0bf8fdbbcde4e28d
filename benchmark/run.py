#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchmark/configs/<name>.json``) and a traffic mix
(``benchmark/traffic/<name>.json``); each metric has a reader
(``benchmark/metrics/<name>.py``).  With ``--trace 0`` the result line holds
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics.
The last line of standard output is one JSON object; the numbers compared
with the reference end standard error.  Exits non-zero, and prints no
result, without the cards, without the port, or with JAX loaded.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(ROOT))


def parse(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import harness, workload

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"no cell named {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    config = workload.load("configs", cell["config"])
    traffic = workload.load("traffic", cell["traffic"])
    try:
        line = harness.run_cell(cell, config, traffic, bench["end_to_end"], bench["per_layer"],
                                seed=args.seed, seconds=args.seconds, trace=bool(args.trace))
    except harness.NoDevice as err:
        print(f"no result: {err}", file=sys.stderr)
        return 3
    except harness.ForbiddenModules as err:
        print(f"no result: {err}", file=sys.stderr)
        return 4
    found = harness.forbidden_modules()
    if found:
        print(f"no result: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 4
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
