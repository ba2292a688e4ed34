"""Service protocol and client (``service/protocol.py``, the server's
connection handler): the ``decode`` phase of the window's requests of
the cell's query op, the ``json.loads`` of a body already read (the
wait for the frame is not in it), over those requests answered.
None where the program has no such phase."""

from kccap_bench.artifacts import hist, hist_delta, mean_ms


def read(artifacts):
    op = artifacts["cell"]["query_op"]
    if not hist(artifacts, "end", "server", "kccap_phase_seconds",
                op=op, phase="decode")[1]:
        return None
    s, _ = hist_delta(artifacts, "start", "end", "server",
                      "kccap_phase_seconds", op=op, phase="decode")
    _, n = hist_delta(artifacts, "start", "end", "server",
                      "kccap_request_latency_seconds", op=op)
    return mean_ms(s, n)
