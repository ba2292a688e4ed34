"""Dispatch of the R-resource sweep (``ops/fused_multi.py``): the mean
``kccap_kernel_steady_seconds`` of the window's synchronous dispatches,
operand staging, launch and fetch; the eligibility proof is not in it."""

from kccap_bench.artifacts import hist_delta, mean_ms


def read(artifacts):
    s, n = hist_delta(artifacts, "start", "end", "process",
                      "kccap_kernel_steady_seconds")
    return mean_ms(s, n)
