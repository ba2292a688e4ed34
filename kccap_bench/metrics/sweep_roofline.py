"""Kernels and exact program of the 2-resource sweep (``ops/fused_fit.py``,
``ops/fit.py``): the least time the card needs for the sweeps answered in
the traced window, counted from the requests by ``roofline.py``, over the
device time of all kernels in that window, in percent."""

from kccap_bench.artifacts import hist_delta
from kccap_bench.roofline import sweep_bound_s


def read(artifacts):
    trace, cell = artifacts.get("trace") or {}, artifacts["cell"]
    _, n = hist_delta(artifacts, "trace_start", "trace_stop", "server",
                      "kccap_request_latency_seconds", op="sweep")
    if not trace.get("kernel_s") or n <= 0:
        return None
    least = n * sweep_bound_s(cell["n_nodes"], cell["live_nodes"],
                              cell["specs_per_request"], cell["semantics"])
    return least / trace["kernel_s"] * 100.0
