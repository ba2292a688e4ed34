"""Exact int64 program (``ops/fit.py``): the least time the card needs
for the 2-resource sweeps that took the program in the traced window, by
the route counter (``kccap_route_scenarios_total`` of ``torch_int64`` and
``torch_int64_grouped``; its scenarios over ``specs_per_request`` make
the requests), counted by ``roofline.py`` as ``sweep_roofline`` counts
them, over the device time of all kernels in that window, in percent.
Nothing where no scenario took the program or no kernel ran."""

from kccap_bench.counters import counter_delta
from kccap_bench.roofline import sweep_bound_s

EXACT = ("torch_int64", "torch_int64_grouped")


def read(artifacts):
    trace, cell = artifacts.get("trace") or {}, artifacts["cell"]
    scenarios = counter_delta(artifacts, "trace_start", "trace_stop",
                              "process", "kccap_route_scenarios_total",
                              lambda labels: labels.get("kernel") in EXACT)
    if not trace.get("kernel_s") or scenarios <= 0:
        return None
    least = scenarios / cell["specs_per_request"] * sweep_bound_s(
        cell["n_nodes"], cell["live_nodes"], cell["specs_per_request"],
        cell["semantics"])
    return least / trace["kernel_s"] * 100.0
