"""fold_build_s: host seconds per completed solve inside the port's
``build_fold_pipeline``, over the window's solves: the growth of the port's
``fold_pipeline.build_counts["host_ns"]`` from the start of the window's
first solve (``utils/profiling.counts_since``).  None where the port keeps
no such count."""

import sys


def read(run):
    trace = run["trace"]
    if run["kind"] != "solve" or not trace or not run["done"]:
        return None
    profiling = sys.modules.get("queasars_tpu_torch.utils.profiling")
    counts_since = getattr(profiling, "counts_since", None)
    counts = counts_since(run["attempted"]) if counts_since else None
    if counts is None or "fold_pipeline.host_ns" not in counts:
        return None
    return counts["fold_pipeline.host_ns"] * 1e-9 / run["done"]
