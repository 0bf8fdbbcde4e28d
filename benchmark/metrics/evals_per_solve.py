"""evals_per_solve: ``sum(result.circuit_evaluations)`` per completed solve,
the solver's evaluation ledger (`solver/driver.py`); it repeats exactly for a given seed."""


def read(run):
    if run["kind"] != "solve" or not run["evals"]:
        return None
    return sum(run["evals"]) / len(run["evals"])
