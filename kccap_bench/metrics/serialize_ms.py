"""Reply build (``service/server.py``): the ``serialize`` phase of the
window's sweeps, over the sweeps answered."""

from kccap_bench.artifacts import hist_delta, mean_ms


def read(artifacts):
    s, _ = hist_delta(artifacts, "start", "end", "server",
                      "kccap_phase_seconds", op="sweep", phase="serialize")
    _, n = hist_delta(artifacts, "start", "end", "server",
                      "kccap_request_latency_seconds", op="sweep")
    return mean_ms(s, n)
