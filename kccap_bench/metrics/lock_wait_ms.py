"""Store (the server's dispatch lock, which ``update`` holds): the
``lock_wait`` phase of the window's sweeps, over the sweeps answered.
None where the program has no such phase."""

from kccap_bench.artifacts import hist, hist_delta, mean_ms


def read(artifacts):
    if not hist(artifacts, "end", "server", "kccap_phase_seconds",
                op="sweep", phase="lock_wait")[1]:
        return None
    s, _ = hist_delta(artifacts, "start", "end", "server",
                      "kccap_phase_seconds", op="sweep", phase="lock_wait")
    _, n = hist_delta(artifacts, "start", "end", "server",
                      "kccap_request_latency_seconds", op="sweep")
    return mean_ms(s, n)
