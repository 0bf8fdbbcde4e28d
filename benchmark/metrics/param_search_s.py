"""param_search_s: seconds per completed solve inside EVQEParameterSearch.apply_operator, from
a host-clock span the benchmark wraps around it (no synchronize)."""


def read(run):
    trace = run["trace"]
    if run["kind"] != "solve" or not trace or not run["done"]:
        return None
    return trace["spans"].get("EVQEParameterSearch", 0.0) / run["done"]
