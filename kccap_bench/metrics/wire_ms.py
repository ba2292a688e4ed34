"""Service protocol and client (``service/protocol.py``, ``client.py``):
the client's mean send-to-reply time of the cell's query op less the
server's mean ``kccap_request_latency_seconds`` of it, both over the
window: framing, JSON both ways and the socket."""

from kccap_bench.artifacts import hist_delta, mean_ms


def read(artifacts):
    op = artifacts["cell"]["query_op"]
    wire = artifacts["load"]["wire"].get(op)
    s, n = hist_delta(artifacts, "start", "end", "server",
                      "kccap_request_latency_seconds", op=op)
    if not wire or not wire["count"] or n <= 0:
        return None
    return mean_ms(wire["sum"], wire["count"]) - mean_ms(s, n)
