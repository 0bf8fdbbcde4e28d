"""kernel_roofline_pct.energies: the least time the H100 could take for the
circuit simulations handed to the port's evaluation entry points in the
window (``benchmark/roofline.py``), over the summed device time of all
kernels in the window."""


def read(run):
    trace = run["trace"]
    if run["kind"] != "energies" or not trace or not trace.get("kernel_s"):
        return None
    return 100.0 * trace["least_s"] / trace["kernel_s"]
