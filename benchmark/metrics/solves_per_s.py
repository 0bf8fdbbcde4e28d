"""solves_per_s: completed solves over the wall time of the window that
holds them (closed loop, one client)."""


def read(run):
    if run["kind"] != "solve":
        return None
    return run["done"] / run["window_s"]
