"""evals_per_s: circuit evaluations the evaluator completed (population x
completed calls) over the wall time of the window."""


def read(run):
    if run["kind"] != "energies":
        return None
    return run["population"] * run["done"] / run["window_s"]
