"""solve_s_p90: the 90th percentile (nearest rank) of the wall times of all
solves in the window, failed ones included."""

import math


def read(run):
    times = sorted(run["solve_s"])
    if run["kind"] != "solve" or not times:
        return None
    return times[math.ceil(0.9 * len(times)) - 1]
