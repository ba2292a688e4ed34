"""Dispatch (``ops/fused_fit.py``, ``ops/fused_multi.py``): the
``proof`` phase of the window's requests of the cell's query op, the
kernels' eligibility proofs, over those requests answered.
None where the program has no such phase."""

from kccap_bench.artifacts import hist, hist_delta, mean_ms


def read(artifacts):
    op = artifacts["cell"]["query_op"]
    if not hist(artifacts, "end", "server", "kccap_phase_seconds",
                op=op, phase="proof")[1]:
        return None
    s, _ = hist_delta(artifacts, "start", "end", "server",
                      "kccap_phase_seconds", op=op, phase="proof")
    _, n = hist_delta(artifacts, "start", "end", "server",
                      "kccap_request_latency_seconds", op=op)
    return mean_ms(s, n)
