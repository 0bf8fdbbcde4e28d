"""launches_per_solve: every kernel launch in the profiler's window, hand-
written or not, per completed solve."""


def read(run):
    trace = run["trace"]
    if run["kind"] != "solve" or not trace or "kernels" not in trace or not run["done"]:
        return None
    return trace["kernels"] / run["done"]
