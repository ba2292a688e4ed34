"""Store (``store.py`` through the server's ``update``): the server's mean
``kccap_request_latency_seconds`` of the window's updates."""

from kccap_bench.artifacts import hist_delta, mean_ms


def read(artifacts):
    s, n = hist_delta(artifacts, "start", "end", "server",
                      "kccap_request_latency_seconds", op="update")
    return mean_ms(s, n)
