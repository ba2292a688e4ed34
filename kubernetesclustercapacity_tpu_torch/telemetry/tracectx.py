"""Cross-process trace context, span emission, and tail-based sampling.

The single-hop tracing of :mod:`.tracing` (client attempt → server
dispatch) generalizes here into Dapper-style causal tracing for the
whole multi-process topology: ReplicaSet failover/hedging, federation
fan-out, plane replication, micro-batch folding.  Three pieces:

* :class:`TraceContext` — the W3C-traceparent-shaped context (trace id,
  current span id, sampled flag, hop count) every wire hop carries.  It
  rides the protocol envelope as plain additive fields
  (:data:`WIRE_FIELDS`), exactly the way ``deadline`` already does, so
  old servers ignore it and old clients never send it.
* :func:`span` — the ONE span-emission call every layer uses.  Field
  names are validated against the documented :data:`SPAN_FIELDS`
  vocabulary (the kccap-lint ``surface-span`` walk pins source literals
  against the same set), and emission never raises: tracing observes
  requests, it never fails them.
* :class:`TailSampler` — tail-based sampling over a bounded in-memory
  ring.  IDs are always generated (cheap: one ``os.urandom`` per hop);
  span BODIES are buffered per trace and only flushed to the JSONL sink
  when the end-of-request :meth:`~TailSampler.finish` verdict says the
  request mattered (breached its op's p99, errored, every-Nth, or
  always).  Because the decision happens at request END, the whole tree
  recorded up to that point survives — the defining property of tail
  sampling.

The ``-trace-sample`` grammar (:func:`parse_sample_spec`)::

    always       keep every trace (the pre-sampling behavior; default)
    p99-breach   keep traces whose request latency breached the op's
                 running p99 estimate (and every errored request)
    errors       keep only errored requests
    rate:N       keep every Nth trace (deterministic counter, N >= 1)

A downstream hop whose envelope says ``trace_sampled: true`` is force-
kept regardless of the local predicate — the hop that made the decision
wins, so one trace is never half-retained across processes.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from kubernetesclustercapacity_tpu_torch.telemetry.tracing import (
    TraceLog,
    new_span_id,
    new_trace_id,
)

__all__ = [
    "MAX_HOPS",
    "SPAN_FIELDS",
    "TailSampler",
    "TraceContext",
    "TraceSampleError",
    "from_wire",
    "parse_sample_spec",
    "span",
]

#: Loop guard: a context that has crossed this many hops stops
#: propagating (the request still runs; only the trace linkage ends).
MAX_HOPS = 32

#: The documented span-record vocabulary.  Every keyword a ``span(...)``
#: call site passes must come from this set — kccap-lint's
#: ``surface-span`` rule and ``test_metric_names.py`` walk the package
#: sources and pin each ``span(`` field literal against it, the same way
#: phase names are pinned to ``phases.PHASES``.
SPAN_FIELDS = frozenset(
    {
        # identity / linkage
        "trace_id", "span_id", "parent_span_id", "links",
        # timing (ts = wall clock at record, start_ts = wall clock at
        # span start, duration_ms = MONOTONIC duration — a wall-clock
        # step mid-span can never produce a negative duration here)
        "ts", "start_ts", "duration_ms",
        # what happened
        "op", "status", "error", "service", "hops",
        # per-layer annotations
        "phase",                       # server phase child spans
        "attempt", "backoff_ms", "attempts",   # client/replicaset
        "endpoint", "hedge", "winner", "failover_reason",  # replicaset
        "batch_size", "leader",        # micro-batcher
        "cluster", "state", "generation",      # federation / plane
        "kind",                        # plane frame kind
    }
)

#: The envelope fields a context occupies on the wire (documented in
#: :mod:`..service.protocol`; excluded from request digests the way
#: ``trace_id`` already is — per-hop noise must not change identity).
WIRE_FIELDS = ("trace_id", "parent_span_id", "trace_sampled", "trace_hops")


class TraceContext:
    """One hop's view of a distributed trace.

    ``span_id`` names the CURRENT span — the one children parent to and
    the one the next wire hop sends as ``parent_span_id``.  ``sampled``
    is the sticky tail-sampling verdict (True once any hop decided to
    keep the trace); ``hops`` counts wire crossings for the
    :data:`MAX_HOPS` loop guard.
    """

    __slots__ = ("trace_id", "span_id", "sampled", "hops")

    def __init__(
        self,
        trace_id: str | None = None,
        span_id: str | None = None,
        *,
        sampled: bool = False,
        hops: int = 0,
    ) -> None:
        self.trace_id = trace_id or new_trace_id()
        self.span_id = span_id or new_span_id()
        self.sampled = bool(sampled)
        self.hops = int(hops)

    def child(self) -> "TraceContext":
        """A fresh span under the same trace (same hop — in-process
        parent/child, e.g. a phase span under its request span)."""
        return TraceContext(
            self.trace_id, sampled=self.sampled, hops=self.hops
        )

    def to_wire(self) -> dict:
        """The envelope fields the NEXT hop should receive: this span
        becomes the remote parent, the hop count advances.  ``{}`` once
        the :data:`MAX_HOPS` guard trips — the request still crosses
        the wire, the trace linkage just stops growing."""
        if self.hops + 1 > MAX_HOPS:
            return {}
        out = {
            "trace_id": self.trace_id,
            "parent_span_id": self.span_id,
            "trace_hops": self.hops + 1,
        }
        if self.sampled:
            out["trace_sampled"] = True
        return out

    def __repr__(self) -> str:  # debugging aid only
        return (
            f"TraceContext(trace_id={self.trace_id!r}, "
            f"span_id={self.span_id!r}, sampled={self.sampled}, "
            f"hops={self.hops})"
        )


def from_wire(msg: dict) -> TraceContext | None:
    """The context a request envelope carried, or ``None`` when the
    caller sent no ``trace_id``.  A fresh span id is minted for THIS
    hop; the envelope's ``parent_span_id`` stays on the message for the
    receiver to record as its span's parent.  Malformed optional fields
    degrade (ignored) rather than refuse — old/foreign callers must not
    lose service over trace metadata."""
    trace_id = msg.get("trace_id")
    if not isinstance(trace_id, str) or not trace_id:
        return None
    hops = msg.get("trace_hops")
    if isinstance(hops, bool) or not isinstance(hops, int) or hops < 0:
        hops = 0
    return TraceContext(
        trace_id,
        sampled=msg.get("trace_sampled") is True,
        hops=min(hops, MAX_HOPS),
    )


def span(sink, **fields) -> None:
    """Emit one span record to ``sink`` (a :class:`~.tracing.TraceLog`,
    a :class:`TailSampler`, or None).  The only sanctioned emission
    call: field names outside :data:`SPAN_FIELDS` are dropped (never
    written, never fatal), and any sink failure is swallowed — a span
    must never fail the request it describes."""
    if sink is None:
        return
    try:
        clean = {k: v for k, v in fields.items() if k in SPAN_FIELDS}
        sink.record(**clean)
    except Exception:  # noqa: BLE001 - tracing never fails the op
        pass


# ---------------------------------------------------------------------------
# Tail-based sampling
# ---------------------------------------------------------------------------
class TraceSampleError(ValueError):
    """A ``-trace-sample`` spec outside the documented grammar."""


def parse_sample_spec(spec: str):
    """Validate a ``-trace-sample`` spec; returns ``(kind, n)`` where
    ``kind`` is one of ``always | p99-breach | errors | rate`` and ``n``
    is the rate divisor (1 except for ``rate:N``)."""
    s = (spec or "").strip()
    if s in ("always", "p99-breach", "errors"):
        return s, 1
    if s.startswith("rate:"):
        arg = s[len("rate:"):]
        if not arg.isdigit() or int(arg) < 1:
            raise TraceSampleError(
                f"bad -trace-sample rate {spec!r} (want rate:N, N >= 1)"
            )
        return "rate", int(arg)
    raise TraceSampleError(
        f"bad -trace-sample {spec!r} "
        "(grammar: always | p99-breach | errors | rate:N)"
    )


#: p99-breach needs this many prior latency samples for an op before the
#: estimate is trusted; below it, nothing breaches (a cold server would
#: otherwise keep everything, defeating the sampler's point).
_P99_MIN_SAMPLES = 30


class TailSampler:
    """Buffer span bodies per trace; flush or drop at request end.

    ``sink`` is the JSONL :class:`~.tracing.TraceLog` kept spans land
    in.  ``spec`` follows the ``-trace-sample`` grammar.  ``latency``
    (optional) is the request-latency histogram family the
    ``p99-breach`` predicate reads (``latency.labels(op=...)``
    snapshots feed :func:`~.slo.estimate_quantile`).

    The ring is bounded two ways: at most ``max_traces`` in-flight
    traces (oldest evicted — their spans drop and count), at most
    ``max_spans_per_trace`` spans per trace (excess drop and count).
    Eviction can only lose a trace whose ``finish`` never came (a
    leaked/abandoned request) — a bounded price for an unbounded-safety
    guarantee.  Thread-safe: kept/dropped counts stay exact under
    concurrent requests.
    """

    def __init__(
        self,
        sink: TraceLog,
        spec: str = "always",
        *,
        latency=None,
        max_traces: int = 512,
        max_spans_per_trace: int = 256,
        registry=None,
    ) -> None:
        self.kind, self.rate_n = parse_sample_spec(spec)
        self.spec = (spec or "").strip()
        self._sink = sink
        self._latency = latency
        self._max_traces = max(1, int(max_traces))
        self._max_spans = max(1, int(max_spans_per_trace))
        self._lock = threading.Lock()
        self._ring: OrderedDict[str, list] = OrderedDict()
        self._rate_counter = 0
        self.kept_spans = 0
        self.dropped_spans = 0
        self._m_spans = None
        if registry is not None:
            from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
                enabled as _telemetry_enabled,
            )

            if _telemetry_enabled():
                self._m_spans = registry.counter(
                    "kccap_trace_spans_total",
                    "Tail-sampled span bodies, by end-of-request "
                    "decision (kept = flushed to the trace log, "
                    "dropped = predicate said no or the ring evicted "
                    "the trace).",
                    ("decision",),
                )

    # -- recording ---------------------------------------------------------
    def record(self, **fields) -> None:
        """Buffer one span body under its trace (``always`` writes
        through — there is no decision to wait for).  Spans with no
        trace id cannot be tail-decided; they write through too (the
        pre-sampling behavior for untraced requests)."""
        trace_id = fields.get("trace_id")
        if self.kind == "always" or not trace_id:
            self._sink.record(**fields)
            with self._lock:
                self.kept_spans += 1
            if self._m_spans is not None:
                self._m_spans.labels(decision="kept").inc()
            return
        evicted = None
        dropped_here = 0
        with self._lock:
            buf = self._ring.get(trace_id)
            if buf is None:
                if len(self._ring) >= self._max_traces:
                    _tid, evicted = self._ring.popitem(last=False)
                buf = []
                self._ring[trace_id] = buf
            if len(buf) < self._max_spans:
                buf.append(fields)
            else:
                dropped_here = 1
            dropped = (len(evicted) if evicted else 0) + dropped_here
            self.dropped_spans += dropped
        if dropped and self._m_spans is not None:
            self._m_spans.labels(decision="dropped").inc(dropped)

    # -- the end-of-request verdict ----------------------------------------
    def decide(
        self,
        op: str,
        duration_s: float,
        error: str | None,
        *,
        forced: bool = False,
    ) -> bool:
        """The tail verdict for one finished request.  ``forced`` is the
        sticky upstream decision (envelope ``trace_sampled``) — it
        always wins, so a trace is never half-kept across hops."""
        if forced or self.kind == "always":
            return True
        if self.kind == "errors":
            return error is not None
        if self.kind == "rate":
            with self._lock:
                self._rate_counter += 1
                # Keep the 1st, (N+1)th, (2N+1)th ... — deterministic,
                # and the first trace is always a keeper (a fresh server
                # should never need N requests before any trace exists).
                return (self._rate_counter - 1) % self.rate_n == 0
        # p99-breach: errors always matter; latency matters once the
        # op's histogram has enough history to estimate a p99 at all.
        if error is not None:
            return True
        if self._latency is None:
            return False
        try:
            child = self._latency.labels(op=op)
            snap = child.snapshot()
            if snap["count"] < _P99_MIN_SAMPLES:
                return False
            from kubernetesclustercapacity_tpu_torch.telemetry.slo import (
                estimate_quantile,
            )

            p99 = estimate_quantile(snap["buckets"], snap["count"], 0.99)
        except Exception:  # noqa: BLE001 - sampling must not fail ops
            return False
        return p99 is not None and duration_s > p99

    def finish(self, trace_id: str | None, *, keep: bool) -> None:
        """Flush (keep) or drop the trace's buffered spans.  A trace id
        never buffered (``always`` mode, unknown id) is a no-op."""
        if not trace_id:
            return
        with self._lock:
            buf = self._ring.pop(trace_id, None)
            if buf is None:
                return
            n = len(buf)
            if keep:
                self.kept_spans += n
            else:
                self.dropped_spans += n
        if keep:
            for fields in buf:
                try:
                    self._sink.record(**fields)
                except Exception:  # noqa: BLE001 - see class docstring
                    pass
        if n and self._m_spans is not None:
            self._m_spans.labels(
                decision="kept" if keep else "dropped"
            ).inc(n)

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        """Doctor/info view: the armed policy and the span ledger."""
        with self._lock:
            return {
                "spec": self.spec,
                "buffered_traces": len(self._ring),
                "kept_spans": self.kept_spans,
                "dropped_spans": self.dropped_spans,
            }
