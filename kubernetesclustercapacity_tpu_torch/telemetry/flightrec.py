"""Flight recorder: a thread-safe ring buffer of the last K requests.

Metrics say HOW MUCH; traces say how long ONE request took; the flight
recorder answers the post-incident question neither can: *what exactly
were the last K things this server was asked to do before it broke?*
Each record is small and fixed-shape — op, a digest of the request
arguments (never the arguments themselves: requests can carry tokens and
multi-MB grids), the snapshot generation it ran against, the caller's
trace ID, latency, status, and a digest of the result — so the ring
costs O(K) memory forever and can be dumped as JSONL at any moment:
on server error (``-flight-dump``), over the wire (the ``dump`` op),
or from ``kccap -doctor -doctor-service``.

Digests are truncated SHA-256 over canonical JSON with the secret-bearing
envelope fields (``token``) stripped.  Two requests with identical
arguments share a digest, which is exactly what replay-style debugging
wants ("the same sweep, 400 times, then the crash").
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from collections import deque

__all__ = ["FlightRecorder", "args_digest", "result_digest"]

#: Envelope fields never folded into a digest: secrets (the shared
#: ``token`` AND the per-tenant ``tenant_token`` — a per-tenant secret
#: is still a secret), and fields that vary per attempt without
#: changing what the request MEANS (the whole trace-context envelope:
#: ids, the remote parent span, the sampling verdict, the hop count).
_DIGEST_EXCLUDED = (
    "token", "tenant_token", "trace_id", "deadline",
    "parent_span_id", "trace_sampled", "trace_hops",
)

_DIGEST_HEX = 16  # 64 bits of SHA-256 — plenty for correlation, tiny on disk


def _digest(obj) -> str:
    try:
        blob = json.dumps(obj, sort_keys=True, default=repr)
    except (TypeError, ValueError):
        blob = repr(obj)
    return hashlib.sha256(blob.encode()).hexdigest()[:_DIGEST_HEX]


def args_digest(msg: dict) -> str:
    """Digest of a request message, secrets/envelope noise stripped."""
    return _digest(
        {k: v for k, v in msg.items() if k not in _DIGEST_EXCLUDED}
    )


def result_digest(result) -> str:
    """Digest of an op result (any JSON-able shape)."""
    return _digest(result)


class FlightRecorder:
    """Bounded in-memory request history, safe for concurrent dispatch.

    ``capacity`` is the K of "the last K requests"; older records fall
    off the far end (``dropped`` counts them, so a dump can say how much
    history it does NOT contain).  ``record`` never raises on behalf of
    the request it observes — recording is observability, not dispatch.
    """

    def __init__(self, capacity: int = 256) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self._seq = 0
        self._dropped = 0

    def record(
        self,
        *,
        op: str,
        args_digest: str,
        generation: int,
        trace_id: str = "",
        latency_ms: float,
        status: str,
        result_digest: str = "",
        error: str | None = None,
        ts: float | None = None,
        audit_ref: str | None = None,
        phases: dict | None = None,
        tenant: str = "",
        trace_sampled: bool | None = None,
    ) -> None:
        """``audit_ref`` — the ``segment:offset`` pointer into the
        server's audit log for this same request (when auditing is on),
        so a ``dump`` record pastes straight into ``kccap -replay
        DIR -replay-ref REF``.  ``phases`` — the request's per-phase
        latency decomposition (``{phase: ms}``, the
        :class:`~.phases.PhaseClock`'s compact form), so a slow request
        pasted from a dump is self-explaining.  ``tenant`` — the DERIVED
        tenant identity (never a token); empty when tenancy is off, and
        then absent from the record so pre-tenancy dumps are unchanged.
        ``trace_sampled`` — the tail-sampling verdict for this request
        (True = its full span tree was retained in the trace log), so a
        ``-replay`` of a divergence knows whether a trace exists for it;
        ``None`` (no sampler armed) keeps the record shape unchanged."""
        rec = {
            "seq": 0,  # assigned under the lock
            "ts": time.time() if ts is None else ts,
            "op": op,
            "args_digest": args_digest,
            "generation": int(generation),
            "trace_id": trace_id or "",
            "latency_ms": round(float(latency_ms), 3),
            "status": status,
            "result_digest": result_digest,
        }
        if tenant:
            rec["tenant"] = tenant
        if trace_sampled is not None:
            rec["trace_sampled"] = bool(trace_sampled)
        if error:
            rec["error"] = error
        if audit_ref:
            rec["audit_ref"] = audit_ref
        if phases:
            rec["phases"] = {
                str(k): round(float(v), 3) for k, v in phases.items()
            }
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            if len(self._ring) == self.capacity:
                self._dropped += 1
            self._ring.append(rec)

    def records(self) -> list[dict]:
        """Oldest-to-newest copy of the ring (records are fresh dicts —
        callers can mutate without corrupting the recorder)."""
        with self._lock:
            return [dict(r) for r in self._ring]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def dropped(self) -> int:
        """Records pushed off the far end since construction/clear."""
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._dropped = 0

    def dump_jsonl(self, path: str) -> int:
        """Append the ring to ``path`` as JSONL; returns lines written.

        Append (not truncate): successive error dumps accumulate rather
        than overwrite the history that preceded the first failure.
        Each dump is framed by a header line carrying the drop count, so
        a reader can tell dumps apart and knows how much history the
        ring had already forgotten.
        """
        records = self.records()
        with self._lock:
            dropped = self._dropped
        with open(path, "a", encoding="utf-8") as fh:
            fh.write(
                json.dumps(
                    {
                        "flight_dump": True,
                        "ts": time.time(),
                        "records": len(records),
                        "dropped": dropped,
                        "capacity": self.capacity,
                    },
                    sort_keys=True,
                )
                + "\n"
            )
            for rec in records:
                fh.write(json.dumps(rec, sort_keys=True) + "\n")
        return len(records) + 1
