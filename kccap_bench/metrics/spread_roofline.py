"""Kernels and exact program, the zone-spread sweep
(``models/capacity.py::topology_spread_grid`` on ``ops/fit.py``'s per-node
program): the least time the card needs for the spread scenarios of the
traced window, by the route counter (``kccap_route_scenarios_total`` of
``torch_int64_per_node`` / ``topology_spread``; its scenarios over
``specs_per_request`` make the requests), counted by ``spread_bound.py``,
over the device time of all kernels in that window, in percent.  Nothing
where no scenario took the route or no kernel ran."""

from kccap_bench.counters import counter_delta
from kccap_bench.spread_bound import spread_bound_s


def read(artifacts):
    trace, cell = artifacts.get("trace") or {}, artifacts["cell"]
    scenarios = counter_delta(
        artifacts, "trace_start", "trace_stop", "process",
        "kccap_route_scenarios_total",
        lambda labels: (labels.get("kernel"), labels.get("reason")) ==
        ("torch_int64_per_node", "topology_spread"))
    if not trace.get("kernel_s") or scenarios <= 0:
        return None
    least = scenarios / cell["specs_per_request"] * spread_bound_s(
        cell["n_nodes"], cell["live_nodes"], cell["specs_per_request"])
    return least / trace["kernel_s"] * 100.0
