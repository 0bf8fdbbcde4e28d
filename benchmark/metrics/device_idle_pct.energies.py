"""device_idle_pct.energies: the share of the traced window in which no
device operation (kernel, copy or fill) runs, from the union of the
profiler's device intervals; 100 (1 - busy_s / window_s)."""


def read(run):
    trace = run["trace"]
    if run["kind"] != "energies" or not trace or "busy_s" not in trace:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
