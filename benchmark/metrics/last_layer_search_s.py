"""last_layer_search_s: seconds per completed solve inside EVQELastLayerParameterSearch.apply_operator, from
a host-clock span the benchmark wraps around it (no synchronize)."""


def read(run):
    trace = run["trace"]
    if run["kind"] != "solve" or not trace or not run["done"]:
        return None
    return trace["spans"].get("EVQELastLayerParameterSearch", 0.0) / run["done"]
