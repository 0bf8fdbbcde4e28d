"""fold_launches_per_solve: launches of the port's fold kernels (every row
of ``sim/fold_kernels.launch_counts``) per completed solve, over the
window's solves: their growth from the start of the window's first solve
(``utils/profiling.counts_since``).  Above 0, the cell ran the fold route.
None where the port keeps no such count."""

import sys


def read(run):
    trace = run["trace"]
    if run["kind"] != "solve" or not trace or not run["done"]:
        return None
    profiling = sys.modules.get("queasars_tpu_torch.utils.profiling")
    counts_since = getattr(profiling, "counts_since", None)
    counts = counts_since(run["attempted"]) if counts_since else None
    if counts is None:
        return None
    return sum(n for row, n in counts.items() if row.startswith("fold_kernels.")) / run["done"]
