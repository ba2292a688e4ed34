"""Wire protocol: 4-byte big-endian length prefix + UTF-8 JSON body.

A copy of the JAX package's ``service/protocol.py``: the frames are the
same bytes, so either package's client talks to either package's server.
The table lists the whole protocol; the PyTorch port's server answers
``ping``, ``info``, ``fit``, ``sweep``, ``sweep_multi``, ``explain``,
``reload`` and ``drain_server``, and refuses every other op with an error
reply saying it is not yet ported.

Requests are JSON objects with an ``"op"`` field:

=========  ==========================================================
op         params
=========  ==========================================================
ping       —
info       optional ``metrics`` (bool, default false) — include the
           server's telemetry-registry snapshot under ``metrics``;
           optional ``audit`` (bool, default false) — include the
           audit-log and shadow-oracle status under ``audit``
           (``{enabled, log: {segments, records, by_kind,
           last_generation, ...}, shadow: {sample_rate, checked,
           divergences, alert, ...}}``) — the replay/audit visibility
           surface ``kccap -doctor -doctor-service`` reads
fit        ``cpuRequests``/``cpuLimits``/``memRequests``/``memLimits``/
           ``replicas`` (flag STRINGS, parsed server-side with exact
           reference semantics), optional ``output`` (``reference`` |
           ``json`` | ``table``), optional ``backend`` (``tpu`` |
           ``cpu``), optional PodSpec constraint fields
           (``tolerations``/``node_selector``/``affinity_terms``/
           ``anti_affinity_labels``/``spread``/``extended_requests``)
sweep      ``cpu_request_milli``/``mem_request_bytes``/``replicas``
           (numeric arrays) OR ``random: {n, seed}``; optional
           ``kernel`` (``auto`` — the fused kernel when provably
           bit-exact — | ``exact``); result carries the kernel used
sweep_multi  R-resource grid sweep: ``resources`` (``[R]`` names —
           ``cpu`` in millicores, ``memory`` in bytes, anything else an
           extended column of the served snapshot), ``requests``
           (``[S][R]`` numeric), ``replicas`` (``[S]``); optional
           ``kernel`` as for sweep; result carries totals/schedulable
           and the kernel used
place      the fit flag/spec fields plus optional ``policy``
           (``first-fit`` | ``best-fit`` | ``spread``) and optional
           ``assignments`` (bool, default true) — placement
           simulation.  Default: the scan, result maps each replica
           to a node.  ``assignments: false`` opts into the
           closed-form bulk engine (O(N) instead of R scan steps):
           result ``assignments`` is null, ``by_node``/``placed``
           identical to the scan's; result ``engine`` says which ran
explain    the fit flag fields — per-node bottleneck attribution for
           the served snapshot: binding constraint (``cpu`` | ``memory``
           | ``pods`` | ``unhealthy`` | ``masked``) per node, binding
           histogram, saturation summary, and the marginal analysis
           (smallest single-node capacity increment yielding +1
           replica); optional ``output`` (``table`` | ``json``) adds a
           rendered ``report``
dump       the server's flight recorder (ring buffer of the last K
           dispatched requests: op, args digest, snapshot generation,
           trace_id, latency, status, result digest) as
           ``{records, count, matched, capacity, dropped, generation}``;
           optional server-side filters: ``filter_op`` (exact op name —
           the envelope's own ``op`` field is taken), ``status``
           (``ok`` | ``error``), ``limit`` (the N most recent matches)
timeline   the server's capacity timeline: per-generation watchlist
           capacities + binding histograms, attributed
           generation-to-generation deltas (nodes added/removed/mutated
           with per-resource deltas, per-watch capacity movement,
           binding-constraint shift, per-node fit contributions), and
           per-watch alert state (ok | breached | recovered) as
           ``{enabled, depth, count, generation, watchlist, records,
           deltas, alerts}``; optional ``since_generation`` (strictly
           after) and ``watch`` (one name) filters; ``{enabled: false}``
           when the server runs without ``-watch``/``-timeline-depth``
reload     ``path`` — swap the served snapshot (fixture .json or .npz);
           optional ``semantics``; refused with code ``not_leader`` on
           a plane replica
update     ``events`` — watch-style node/pod event list applied
           incrementally to the served snapshot (fixture-backed only);
           refused with code ``not_leader`` on a plane replica
drain_server  graceful drain: stop accepting compute/mutation ops
           (refused with code ``draining``), finish in-flight work
           (optional ``timeout_s`` bounds the wait, optional ``reason``
           is recorded), emit the final drain record, deregister from
           the plane; the reply IS the drain record; idempotent (a
           repeat returns the first record with ``already: true``)
=========  ==========================================================

``info`` additionally reports the protocol feature handshake under
``capabilities`` (``{protocol, plane, admission, drain}``) and a
top-level ``draining`` flag, and accepts optional ``plane`` (bool) to
include the serving-plane section (leader fan-out stats or replica
sync/staleness state) — clients built for the replicated plane
feature-gate on ``capabilities`` so old↔new pairings degrade cleanly.

Any request may additionally carry:

``token``
    shared bearer token (required for every op except ``ping`` when the
    server was started with auth enabled).
``deadline``
    absolute unix timestamp (``time.time()`` epoch seconds) after which
    the caller no longer wants the answer.  The server sheds the request
    with a ``DeadlineExpired`` error instead of dispatching — before
    parsing, and again after any wait for a compute slot — so a queue of
    abandoned requests cannot occupy the device.  Same-host deployments
    share a clock exactly; cross-host callers should keep budgets above
    their NTP skew (the client's own budget check is authoritative).
``trace_id``
    opaque request-correlation string (conventionally 32 hex chars, see
    :mod:`..telemetry.tracing`).  The server stamps it into its span
    record when started with ``-trace-log``, so one client-side ID finds
    the request in the server's trace log; it never changes the reply.
``parent_span_id``
    the caller's span for THIS hop (see :mod:`..telemetry.tracectx`) —
    the receiver's request span parents to it, which is what lets the
    offline analyzer (``kccap -trace-tree``) stitch per-process span
    logs into one tree without comparing wall clocks.
``trace_sampled``
    the caller's sticky tail-sampling decision (bool).  ``true`` forces
    every downstream hop to keep its span bodies for this trace even if
    its own ``-trace-sample`` predicate would drop them, so a kept trace
    is whole rather than a ragged subset.
``trace_hops``
    propagation depth (int), incremented per hop and capped at
    ``tracectx.MAX_HOPS`` — a forwarding loop degrades to untraced
    requests instead of unbounded envelope growth.

All three ride only alongside ``trace_id`` and, like it, never change
the reply — a server without tracing armed ignores them.

Responses: ``{"ok": true, "result": ...}`` or ``{"ok": false, "error": "..."}``.
Every response envelope also carries ``generation`` — the snapshot
generation that answered (a plane replica stamps the LEADER's numbering),
the watermark clients use for read-your-generation monotonicity — and a
refusal additionally carries ``code`` (``overloaded`` | ``draining`` |
``not_leader``): the server provably did no work, so the request is
safe to retry on another replica, mutations included.
Maximum frame size 64 MiB (a 10k-node JSON report is ~3 MB).
"""

from __future__ import annotations

import json
import socket
import struct

__all__ = ["send_msg", "recv_msg", "MAX_FRAME", "ProtocolError"]

MAX_FRAME = 64 * 1024 * 1024


class ProtocolError(RuntimeError):
    pass


def send_msg(sock: socket.socket, obj: dict) -> None:
    body = json.dumps(obj).encode()
    if len(body) > MAX_FRAME:
        raise ProtocolError(f"frame too large: {len(body)}")
    sock.sendall(struct.pack(">I", len(body)) + body)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ProtocolError("connection closed mid-frame")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def recv_msg(sock: socket.socket) -> dict | None:
    """Read one frame; None on clean EOF (or reset) at a frame boundary.

    The error taxonomy is total: every OS-level socket failure surfaces
    as :class:`ProtocolError` (reset before any frame byte is a clean
    None), so callers handle exactly two shapes — None = no more frames,
    ProtocolError = broken peer/transport.
    """
    try:
        header = sock.recv(4)
    except ConnectionResetError:
        return None
    except OSError as e:
        raise ProtocolError(f"socket error awaiting frame: {e}") from e
    if not header:
        return None
    try:
        while len(header) < 4:
            more = sock.recv(4 - len(header))
            if not more:
                raise ProtocolError("connection closed mid-header")
            header += more
        (length,) = struct.unpack(">I", header)
        if length > MAX_FRAME:
            raise ProtocolError(f"frame too large: {length}")
        body = _recv_exact(sock, length)
    except OSError as e:  # reset/abort/timeout mid-frame
        raise ProtocolError(f"socket error mid-frame: {e}") from e
    try:
        return json.loads(body)
    except ValueError as e:  # malformed/empty body is a protocol error
        raise ProtocolError(f"invalid JSON frame: {e}") from e
