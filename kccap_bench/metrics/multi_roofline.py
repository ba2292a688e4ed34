"""Kernel B2 (``ops/fused_multi.py``, ``csrc/sweep_multi.cu``): as
``sweep_roofline``, for the ``sweep_multi`` requests answered in the
traced window."""

from kccap_bench.artifacts import hist_delta
from kccap_bench.roofline import multi_bound_s


def read(artifacts):
    trace, cell = artifacts.get("trace") or {}, artifacts["cell"]
    _, n = hist_delta(artifacts, "trace_start", "trace_stop", "server",
                      "kccap_request_latency_seconds", op="sweep_multi")
    if not trace.get("kernel_s") or n <= 0:
        return None
    least = n * multi_bound_s(cell["n_nodes"], cell["live_nodes"],
                              cell["cell_ops_per_request"],
                              cell["specs_per_request"], cell["resources"],
                              cell["semantics"])
    return least / trace["kernel_s"] * 100.0
