"""Store (``store.py`` through the server's ``update``): the ``repack``
phase of the window's updates, ``ClusterStore.snapshot()`` and the
implicit taint mask, over the updates answered.
None where the program has no such phase."""

from kccap_bench.artifacts import hist, hist_delta, mean_ms


def read(artifacts):
    if not hist(artifacts, "end", "server", "kccap_phase_seconds",
                op="update", phase="repack")[1]:
        return None
    s, _ = hist_delta(artifacts, "start", "end", "server",
                      "kccap_phase_seconds", op="update", phase="repack")
    _, n = hist_delta(artifacts, "start", "end", "server",
                      "kccap_request_latency_seconds", op="update")
    return mean_ms(s, n)
