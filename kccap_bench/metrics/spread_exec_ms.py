"""Topology spread (``models/capacity.py::topology_spread_grid``): the
``device_exec`` and ``fetch`` phases of the window's ``topology_spread``
requests, the per-node program, the zone fold and the copy of the totals,
over those requests answered.  None where the program records neither
phase for the op."""

from kccap_bench.artifacts import hist, hist_delta, mean_ms

OP = "topology_spread"
PHASES = ("device_exec", "fetch")


def read(artifacts):
    if not any(hist(artifacts, "end", "server", "kccap_phase_seconds",
                    op=OP, phase=p)[1] for p in PHASES):
        return None
    s = sum(hist_delta(artifacts, "start", "end", "server",
                       "kccap_phase_seconds", op=OP, phase=p)[0]
            for p in PHASES)
    _, n = hist_delta(artifacts, "start", "end", "server",
                      "kccap_request_latency_seconds", op=OP)
    return mean_ms(s, n)
