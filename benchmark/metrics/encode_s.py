"""encode_s: seconds per completed solve spent building the port's
``JSSPDomainWallHamiltonianEncoder`` and its ``get_problem_hamiltonian()``,
where the traffic encodes inside the window."""


def read(run):
    trace = run["trace"]
    if run["kind"] != "solve" or not trace or not trace.get("encodes") or not run["done"]:
        return None
    return trace["spans"].get("encode", 0.0) / run["done"]
