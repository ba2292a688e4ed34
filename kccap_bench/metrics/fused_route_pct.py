"""Dispatch, eligibility routing (``ops/fused_fit.py``): the share of the
2-resource sweep's routed scenarios from ``start`` to ``end`` that took
kernel B1 (any ``*_i32_fused`` or ``*_i32_rcp_fused`` label, grouped or
not) rather than the exact program (``torch_int64``,
``torch_int64_grouped``), by the route counter
``kccap_route_scenarios_total`` of the process registry, in percent.
Nothing where no 2-resource sweep was routed."""

from kccap_bench.counters import counter_delta

B1 = frozenset(f"{device}_i32{rcp}_fused{grouped}"
               for device in ("cuda", "plain") for rcp in ("", "_rcp")
               for grouped in ("", "_grouped"))
EXACT = frozenset(("torch_int64", "torch_int64_grouped"))


def _scenarios(artifacts, kernels):
    return counter_delta(artifacts, "start", "end", "process",
                         "kccap_route_scenarios_total",
                         lambda labels: labels.get("kernel") in kernels)


def read(artifacts):
    fused = _scenarios(artifacts, B1)
    routed = fused + _scenarios(artifacts, EXACT)
    return fused / routed * 100.0 if routed > 0 else None
