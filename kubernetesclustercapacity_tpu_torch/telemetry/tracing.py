"""Request tracing: trace/span IDs through the protocol, JSONL span log.

A trace ID rides any service request as a ``trace_id`` field — threaded
through the protocol envelope exactly the way ``deadline`` already is —
so one client-side ID stitches together the client's attempt, the
server's dispatch span, and (later) any fan-out.  Span timings feed a
registry histogram; an optional :class:`TraceLog` appends one JSON line
per finished span, the grep-able forensic record (who asked, which op,
how long, what failed) a latency histogram cannot carry.

IDs follow the W3C-traceparent shape (hex, 16-byte trace / 8-byte span)
without the header framing: this stack speaks framed JSON, not HTTP,
and the hex form converts losslessly if a gateway ever bridges the two.
"""

from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["new_trace_id", "new_span_id", "TraceLog", "Span"]


def new_trace_id() -> str:
    """A fresh 16-byte hex trace ID (W3C trace-id shaped)."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """A fresh 8-byte hex span ID."""
    return os.urandom(8).hex()


class TraceLog:
    """Append-only JSONL span log, safe for many threads.

    One ``record(**fields)`` is one line, written and flushed under a
    lock so concurrent dispatch threads can never interleave bytes.
    Opened lazily (first record) so constructing a server with a trace
    path that never traces costs nothing, and close() is idempotent.

    ``max_bytes`` caps on-disk growth with one-deep rotation: when an
    append pushes the file past the cap, it is renamed to ``PATH.1``
    (clobbering any previous ``.1``) and a fresh file starts — a
    long-lived server cannot fill the disk, and the most recent ~2x
    ``max_bytes`` of spans always survive.  ``0`` (the default) keeps
    the historical unbounded behavior.

    The first lazy open registers an ``atexit`` close for this log, so
    a short-lived ``kccap`` run that never reaches an explicit
    ``close()`` (early ``sys.exit``, an embedder that forgot the
    context manager) still flushes and closes its final spans at
    interpreter shutdown — the last span of a one-shot CLI invocation
    is precisely the one a trace pipeline must not lose.
    """

    def __init__(self, path: str, *, max_bytes: int = 0) -> None:
        if max_bytes < 0:
            raise ValueError(f"max_bytes must be >= 0, got {max_bytes}")
        self.path = path
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._fh = None
        self._closed = False
        self._atexit_registered = False

    def record(self, **fields) -> None:
        line = json.dumps(fields, sort_keys=True)
        with self._lock:
            if self._closed:
                return
            if self._fh is None:
                self._fh = open(self.path, "a", encoding="utf-8")
                if not self._atexit_registered:
                    import atexit

                    atexit.register(self.close)
                    self._atexit_registered = True
            self._fh.write(line + "\n")
            self._fh.flush()
            if self.max_bytes and self._fh.tell() > self.max_bytes:
                self._rotate_locked()

    def _rotate_locked(self) -> None:
        """Rename the full log to ``.1`` and reopen fresh (lock held).

        The record that tripped the cap stays in the rotated file — a
        span is never torn across the boundary, and a single oversized
        span rotates rather than wedging the log.
        """
        try:
            self._fh.close()
        finally:
            self._fh = None
        os.replace(self.path, self.path + ".1")
        self._fh = open(self.path, "a", encoding="utf-8")

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._fh is not None:
                try:
                    self._fh.close()
                finally:
                    self._fh = None

    def __enter__(self) -> "TraceLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Span:
    """One timed operation: context manager feeding histogram + log.

    ``histogram`` is an optional pre-labeled histogram *child* (the
    caller picks the labels — e.g. ``latency.labels(op="sweep")``);
    ``trace_log`` an optional :class:`TraceLog`.  An exception leaving
    the block marks the span ``status="error"`` with the exception type
    and propagates unchanged — tracing observes failures, never eats
    them.  ``extra`` fields ride the log line verbatim.
    """

    def __init__(
        self,
        op: str,
        *,
        trace_id: str | None = None,
        parent_span_id: str | None = None,
        histogram=None,
        trace_log: TraceLog | None = None,
        extra: dict | None = None,
    ) -> None:
        self.op = op
        self.trace_id = trace_id or new_trace_id()
        self.span_id = new_span_id()
        self.parent_span_id = parent_span_id
        self.duration_s: float | None = None
        self.error: str | None = None
        self._histogram = histogram
        self._trace_log = trace_log
        self._extra = dict(extra or {})
        self._t0: float | None = None
        self._wall0: float | None = None

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter()
        self._wall0 = time.time()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # duration_s is MONOTONIC (perf_counter): a wall-clock step
        # mid-span (NTP slew, operator date change) can never yield a
        # negative duration.  The wall clock appears only as the
        # ``start_ts``/``ts`` anchors — which IS where a step shows up,
        # so the trace analyzer flags spans whose recorded duration is
        # negative (foreign/legacy writers) as ``clock_skew`` instead of
        # feeding them to the critical path.
        self.duration_s = time.perf_counter() - (self._t0 or 0.0)
        if exc is not None:
            self.error = f"{exc_type.__name__}: {exc}"
        if self._histogram is not None:
            self._histogram.observe(self.duration_s)
        if self._trace_log is not None:
            rec = {
                "ts": time.time(),
                "start_ts": getattr(self, "_wall0", None),
                "trace_id": self.trace_id,
                "span_id": self.span_id,
                "op": self.op,
                "duration_ms": round(self.duration_s * 1e3, 3),
                "status": "error" if self.error else "ok",
                **self._extra,
            }
            if self.parent_span_id:
                rec["parent_span_id"] = self.parent_span_id
            if self.error:
                rec["error"] = self.error
            self._trace_log.record(**rec)
        # Exceptions propagate (return None/False).
