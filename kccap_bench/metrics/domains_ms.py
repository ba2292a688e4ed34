"""Topology spread (``models/capacity.py::topology_spread_grid``): the
``domains`` phase of the window's ``topology_spread`` requests, the masks
and the topology-domain discovery on the host, over those requests
answered.  None where the program has no such phase."""

from kccap_bench.artifacts import hist, hist_delta, mean_ms

OP = "topology_spread"


def read(artifacts):
    if not hist(artifacts, "end", "server", "kccap_phase_seconds",
                op=OP, phase="domains")[1]:
        return None
    s, _ = hist_delta(artifacts, "start", "end", "server",
                      "kccap_phase_seconds", op=OP, phase="domains")
    _, n = hist_delta(artifacts, "start", "end", "server",
                      "kccap_request_latency_seconds", op=OP)
    return mean_ms(s, n)
