"""Durable audit log (counterpart of ``kubernetesclustercapacity_tpu/audit/
log.py``, verbatim but for one fix: the on-disk format, segment naming and
digests are the JAX module's, so either package reads the other's logs.
Two fixes, each writing what the JAX reader already reads: a diff that
adds two or more nodes out of key order records the row order, which the
JAX writer leaves out; and a generation whose taints changed (a tainted
node added, say) is written as a checkpoint, where the JAX writer writes
a diff that drops them; see ``record_generation``).

The log records two families of events:

* **generation records** — one per published snapshot generation.  The
  first record (and every ``checkpoint_every``-th after it, and any
  semantics flip) is a **checkpoint**: the full fit-relevant state
  (names, the seven :data:`~..timeline.diff.NODE_FIELDS` columns,
  semantics, taints).  Every other generation is a **diff**: the
  invertible :class:`~..timeline.diff.SnapshotDiff` against the
  previous generation, so replay cost is bounded by the checkpoint
  cadence while the on-disk cost of steady churn stays O(changed
  nodes).  Each record carries the generation's
  :func:`~..timeline.diff.snapshot_digest` and its parent's, chaining
  the history: a reconstruction that does not hash to the recorded
  digest is a corruption, detected, never silently served.
* **request records** — one per answering/mutating dispatch: op, the
  full arguments (secret-bearing envelope fields stripped), the
  generation that answered, status, and a *canonical* result digest
  (volatile fields like the kernel choice stripped, so a replay on a
  different backend still verifies the semantics).

Segments rotate at ``segment_max_bytes`` (``audit-000001.jsonl``,
``audit-000002.jsonl`` …); a reopened log always starts a fresh
segment, never appends to a possibly-torn one.  Loading is
crash-tolerant: a record torn by a mid-write crash (the final line of
the final segment) is dropped and counted, not fatal — everything
before it replays.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import time

import numpy as np

from kubernetesclustercapacity_tpu_torch.snapshot import ClusterSnapshot
from kubernetesclustercapacity_tpu_torch.timeline.diff import (
    NODE_FIELDS,
    SnapshotDiff,
    diff_summaries,
    node_summary,
    snapshot_digest,
)

__all__ = [
    "AuditError",
    "AuditLog",
    "AuditReader",
    "canonical_result_digest",
    "snapshot_from_summary",
    "strip_args",
]

_SEGMENT_RE = re.compile(r"^audit-(\d{6})\.jsonl$")

#: Envelope fields never recorded in ``args``: secrets (the shared
#: ``token`` AND the per-tenant ``tenant_token`` — the server records
#: the DERIVED tenant name instead, never the credential), per-attempt
#: noise that does not change what the request MEANS (the flight
#: recorder strips the same set from its digests), and ``op`` — a
#: request record carries the op as its own top-level field.
_ARGS_EXCLUDED = (
    "op", "token", "tenant_token", "trace_id", "deadline",
    "parent_span_id", "trace_sampled", "trace_hops",
)

#: Result fields that legitimately vary between record time and replay
#: time without a semantics change: which kernel answered (fused on a
#: TPU, exact on the replay host), its failure note, and rendered
#: report text (reference transcripts carry fixture provenance a
#: reconstructed snapshot cannot).  Stripped before digesting so the
#: digest pins WHAT was answered, not HOW.
#: ``engine`` joins for the gang op: which reduction served (grouped
#: count-matrix vs per-node) is a dispatch choice like ``kernel``, and
#: the gang counts are parity-pinned identical across both.
_VOLATILE_RESULT_FIELDS = frozenset(
    {"kernel", "fast_path_error", "report", "engine"}
)

#: Per-op additions to the volatile set.  The optimize op's float
#: solver artifacts (bounds, residuals, shadow prices, timings, the
#: certificate verdict itself, and the LP-guided per-group split) are
#: legitimately host/device-dependent — f64 iteration on a TPU replays
#: on a CPU — while the INTEGER packing answer (rounded totals, FFD
#: totals, schedulability, demand) is closed-form deterministic and
#: stays in the digest.
_VOLATILE_RESULT_FIELDS_BY_OP = {
    "optimize": frozenset(
        {
            "lp_bound", "gap_pct", "status", "certified", "duality_gap",
            "primal_residual", "dual_residual", "iterations", "tol",
            "solve_seconds", "shadow_prices", "ffd_exceeds_bound",
            "verified", "groups", "grouping_engaged",
        }
    ),
    # The forecast's integer ladders and time-to-breach are exact
    # order statistics over exact integer sweeps — they stay in the
    # digest; only the wall-time measurement is volatile.
    "forecast": frozenset({"eval_ms"}),
    # The catalog plan keeps its INTEGER answer (buy counts, projected
    # capacity, satisfiability) in the digest; float solver artifacts
    # (bounds, prices, costs, the certificate verdict) replay host-
    # dependent exactly like the optimize op's.
    "plan": frozenset(
        {
            "lp_bound", "gap_pct", "shadow_prices", "demand_price",
            "total_cost", "status", "certified", "uncertified_reason",
            "eval_ms", "drain",
        }
    ),
}

_DIGEST_HEX = 16  # matches flightrec/timeline truncation


class AuditError(RuntimeError):
    """Unloadable or integrity-violating audit log content."""


def _jsonable(obj):
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return repr(obj)


def strip_args(msg: dict) -> dict:
    """Request args safe to persist: the message minus envelope secrets
    and per-attempt noise (same exclusion set as the flight recorder's
    digests, so an audit record and a flight record describe the same
    request)."""
    return {k: v for k, v in msg.items() if k not in _ARGS_EXCLUDED}


def canonical_result(op: str, result):
    """The replay-comparable view of an op result (volatile fields
    stripped, globally and per op; non-dict results pass through)."""
    if not isinstance(result, dict):
        return result
    volatile = _VOLATILE_RESULT_FIELDS | _VOLATILE_RESULT_FIELDS_BY_OP.get(
        op, frozenset()
    )
    return {k: v for k, v in result.items() if k not in volatile}


def canonical_result_digest(op: str, result) -> str:
    """Truncated SHA-256 over the canonical result — the bit-exactness
    pin replay asserts against."""
    try:
        blob = json.dumps(
            canonical_result(op, result), sort_keys=True, default=_jsonable
        )
    except (TypeError, ValueError):
        blob = repr(result)
    return hashlib.sha256(blob.encode()).hexdigest()[:_DIGEST_HEX]


def _disambiguate(names: list[str]) -> list[str]:
    """Node keys for a names list — the exact rule
    :func:`~..timeline.diff.node_summary` applies (repeated names get
    ``#<occurrence>`` from their second occurrence on)."""
    seen: dict[str, int] = {}
    keys = []
    for name in names:
        n = seen.get(name, 0)
        seen[name] = n + 1
        keys.append(name if n == 0 else f"{name}#{n}")
    return keys


class AuditLog:
    """Append-only writer; one instance per server, safe for concurrent
    dispatch threads (one lock serializes appends).

    ``registry`` wires a ``kccap_audit_records_total`` counter (by
    record kind); ``None`` — or ``KCCAP_TELEMETRY=0`` — keeps the log
    registry-silent.
    """

    def __init__(
        self,
        directory: str,
        *,
        segment_max_bytes: int = 8 << 20,
        checkpoint_every: int = 16,
        registry=None,
    ) -> None:
        if segment_max_bytes < 1:
            raise ValueError(
                f"segment_max_bytes must be >= 1, got {segment_max_bytes}"
            )
        if checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {checkpoint_every}"
            )
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.segment_max_bytes = int(segment_max_bytes)
        self.checkpoint_every = int(checkpoint_every)
        self._lock = threading.Lock()
        self._fh = None
        self._closed = False
        # Never append to an existing (possibly torn) segment: resume
        # numbering after whatever is already on disk.
        existing = [
            int(m.group(1))
            for f in os.listdir(directory)
            if (m := _SEGMENT_RE.match(f))
        ]
        self._segment_index = max(existing, default=0)
        self._segment_name = None
        self._records = 0
        self._by_kind: dict[str, int] = {}
        # Replay/diff state: the previous generation's summary vocabulary.
        self._last_summary: dict[str, tuple[int, ...]] | None = None
        self._last_taints: list = []
        self._last_semantics: str | None = None
        self._last_digest = ""
        self._last_generation = 0
        self._since_checkpoint = 0
        self._generation_refs: dict[int, str] = {}
        self._m_records = None
        if registry is not None:
            from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
                enabled as _telemetry_enabled,
            )

            if _telemetry_enabled():
                self._m_records = registry.counter(
                    "kccap_audit_records_total",
                    "Audit-log records appended, by kind.",
                    ("kind",),
                )

    # -- appends -----------------------------------------------------------
    def _open_segment_locked(self) -> None:
        self._segment_index += 1
        self._segment_name = f"audit-{self._segment_index:06d}.jsonl"
        self._fh = open(
            os.path.join(self.directory, self._segment_name),
            "a",
            encoding="utf-8",
        )
        header = {
            "kind": "segment_header",
            "version": 1,
            "ts": time.time(),
            "segment": self._segment_name,
        }
        self._fh.write(json.dumps(header, sort_keys=True) + "\n")
        self._fh.flush()
        self._records += 1
        self._by_kind["segment_header"] = (
            self._by_kind.get("segment_header", 0) + 1
        )
        if self._m_records is not None:
            self._m_records.labels(kind="segment_header").inc()

    def _append_locked(self, rec: dict) -> str:
        """Write one record; returns its ``segment:offset`` audit ref.
        The record that crosses the size cap stays in its segment (a
        record is never torn across a rotation boundary)."""
        if self._closed:
            raise AuditError("audit log is closed")
        if self._fh is None:
            self._open_segment_locked()
        offset = self._fh.tell()
        segment = self._segment_name
        self._fh.write(json.dumps(rec, sort_keys=True, default=_jsonable) + "\n")
        self._fh.flush()
        self._records += 1
        kind = rec.get("kind", "?")
        self._by_kind[kind] = self._by_kind.get(kind, 0) + 1
        if self._m_records is not None:
            self._m_records.labels(kind=kind).inc()
        if self._fh.tell() > self.segment_max_bytes:
            self._fh.close()
            self._fh = None
        return f"{segment}:{offset}"

    def record_generation(
        self, snapshot: ClusterSnapshot, generation: int, *, ts=None
    ) -> str:
        """One generation record (checkpoint or diff); returns its
        audit ref.  Must be called in publish order — the diff is taken
        against the previously recorded generation."""
        summary = node_summary(snapshot)
        digest = snapshot_digest(snapshot)
        names_by_key = dict(zip(summary.keys(), snapshot.names))
        with self._lock:
            # Taints ride checkpoints only (a diff has no word for them,
            # and the digest does not cover them): a generation whose
            # taints moved, a tainted node added among them, is written
            # as a checkpoint, so its replay masks what the server masked.
            checkpoint = (
                self._last_summary is None
                or snapshot.semantics != self._last_semantics
                or self._since_checkpoint >= self.checkpoint_every
                or taints_changed(self._last_summary, self._last_taints,
                                  summary, snapshot.taints)
            )
            rec: dict = {
                "generation": int(generation),
                "ts": time.time() if ts is None else float(ts),
                "nodes": snapshot.n_nodes,
                "semantics": snapshot.semantics,
                "digest": digest,
                "parent": self._last_digest,
            }
            if checkpoint:
                rec["kind"] = "checkpoint"
                rec["names"] = list(snapshot.names)
                rec["rows"] = [list(v) for v in summary.values()]
                if any(snapshot.taints or []):
                    rec["taints"] = list(snapshot.taints)
                if any(snapshot.labels or []):
                    # Labels ride checkpoints so gang/topology requests
                    # replay against the hierarchy that answered them.
                    # Like taints, labels sit OUTSIDE the digest-chained
                    # fit vocabulary: an in-place label edit between
                    # checkpoints is carried forward (bounded by the
                    # checkpoint cadence), never detected as a diff.
                    rec["labels"] = list(snapshot.labels)
                self._since_checkpoint = 0
            else:
                diff = diff_summaries(self._last_summary, summary)
                rec["kind"] = "diff"
                rec["added"] = {k: list(v) for k, v in diff.added.items()}
                rec["removed"] = {
                    k: list(v) for k, v in diff.removed.items()
                }
                rec["changed"] = {
                    k: dict(d) for k, d in diff.changed.items()
                }
                added_names = {
                    k: names_by_key[k]
                    for k in diff.added
                    if names_by_key[k] != k
                }
                if added_names:
                    rec["added_names"] = added_names
                if diff.added and any(snapshot.labels or []):
                    labels_by_key = dict(
                        zip(summary.keys(), snapshot.labels)
                    )
                    added_labels = {
                        k: labels_by_key[k]
                        for k in diff.added
                        if labels_by_key.get(k)
                    }
                    if added_labels:
                        rec["added_labels"] = added_labels
                # apply() yields old-order-minus-removed then added; when
                # the true row order differs (a mid-list insert), record
                # it — the digest covers row order, so replay must too.
                # The record is written with sorted keys, so a reader
                # appends the added rows in key order: two nodes added out
                # of key order need the order too (the JAX writer compares
                # with the in-memory order and leaves it out, and its log
                # then fails its own digest chain).
                kept = [
                    k for k in diff.apply(self._last_summary)
                    if k not in diff.added
                ]
                expected = kept + sorted(diff.added)
                if expected != list(summary):
                    rec["order"] = list(summary)
                self._since_checkpoint += 1
            ref = self._append_locked(rec)
            self._last_summary = summary
            self._last_taints = list(snapshot.taints or [])
            self._last_semantics = snapshot.semantics
            self._last_digest = digest
            self._last_generation = int(generation)
            self._generation_refs[int(generation)] = ref
            if len(self._generation_refs) > 1024:
                oldest = min(self._generation_refs)
                self._generation_refs.pop(oldest, None)
            return ref

    def record_request(
        self,
        *,
        op: str,
        args: dict,
        generation,
        status: str,
        result=None,
        error: str | None = None,
        ts=None,
        trace_sampled: bool | None = None,
    ) -> str:
        """One request record; returns its ``segment:offset`` audit ref
        (the flight recorder attaches it, so ``dump`` output points
        straight back into this log).  ``trace_sampled`` — the tail
        sampler's verdict for this request (``None``, no sampler armed,
        keeps the record shape unchanged): a replayed divergence can
        say up front whether a retained trace tree backs it."""
        rec = {
            "kind": "request",
            "ts": time.time() if ts is None else float(ts),
            "op": op,
            "args": args,
            "generation": generation,
            "status": status,
            "result_digest": (
                "" if result is None else canonical_result_digest(op, result)
            ),
        }
        if trace_sampled is not None:
            rec["trace_sampled"] = bool(trace_sampled)
        if error:
            rec["error"] = error
        with self._lock:
            return self._append_locked(rec)

    def append_raw(self, rec: dict) -> str:
        """Append an arbitrary record (the shadow sampler's divergence
        bundles ride the same log when no separate bundle path is
        configured)."""
        with self._lock:
            return self._append_locked(dict(rec))

    def generation_ref(self, generation: int) -> str | None:
        """Audit ref of a recorded generation (recent generations only —
        the map is bounded)."""
        with self._lock:
            return self._generation_refs.get(int(generation))

    def stats(self) -> dict:
        """Compact health view (``info {audit: true}``, doctor,
        ``/healthz``)."""
        with self._lock:
            return {
                "dir": self.directory,
                "segment": self._segment_name,
                "segments": self._segment_index,
                "records": self._records,
                "by_kind": dict(self._by_kind),
                "last_generation": self._last_generation,
                "checkpoint_every": self.checkpoint_every,
            }

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._fh is not None:
                try:
                    self._fh.close()
                finally:
                    self._fh = None

    def __enter__(self) -> "AuditLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class AuditReader:
    """Loaded audit history: records across all segments, in order.

    ``recovered_tail`` counts torn final records dropped during the
    load (0 on a clean shutdown); a torn record anywhere else is an
    :class:`AuditError` — only the tail can legitimately be mid-write
    when a process dies.
    """

    def __init__(
        self, directory: str, records: list[dict], recovered_tail: int
    ) -> None:
        self.directory = directory
        self.records = records
        self.recovered_tail = recovered_tail
        self._snapshots: dict[int, ClusterSnapshot] = {}

    @classmethod
    def load(cls, directory: str) -> "AuditReader":
        try:
            segments = sorted(
                f for f in os.listdir(directory) if _SEGMENT_RE.match(f)
            )
        except OSError as e:
            raise AuditError(f"cannot read audit dir {directory!r}: {e}")
        if not segments:
            raise AuditError(f"no audit segments in {directory!r}")
        records: list[dict] = []
        recovered = 0
        for si, seg in enumerate(segments):
            last_segment = si == len(segments) - 1
            with open(os.path.join(directory, seg), "rb") as fh:
                data = fh.read()
            offset = 0
            while offset < len(data):
                nl = data.find(b"\n", offset)
                if nl == -1:
                    # A committed record is newline-terminated (the
                    # writer appends record + "\n" in one flushed
                    # write): an unterminated tail is a torn write even
                    # when the bytes happen to parse.
                    if last_segment:
                        recovered += 1
                        break
                    raise AuditError(
                        f"unterminated audit record in {seg} at byte "
                        f"{offset}"
                    )
                chunk = data[offset:nl]
                final_chunk = nl >= len(data) - 1
                try:
                    rec = json.loads(chunk.decode("utf-8"))
                    if not isinstance(rec, dict):
                        raise ValueError("record is not an object")
                except (ValueError, UnicodeDecodeError) as e:
                    if last_segment and final_chunk:
                        recovered += 1
                        break
                    raise AuditError(
                        f"corrupt audit record in {seg} at byte {offset}: {e}"
                    )
                rec["_ref"] = f"{seg}:{offset}"
                records.append(rec)
                offset = nl + 1
        return cls(directory, records, recovered)

    # -- views -------------------------------------------------------------
    def generations(self) -> list[dict]:
        """Generation records (checkpoints + diffs), log order."""
        return [
            r for r in self.records if r.get("kind") in ("checkpoint", "diff")
        ]

    def requests(self) -> list[dict]:
        return [r for r in self.records if r.get("kind") == "request"]

    def record_at(self, ref: str) -> dict:
        """The record at one ``segment:offset`` audit ref."""
        segment, _, offset_s = ref.rpartition(":")
        try:
            offset = int(offset_s)
        except ValueError:
            raise AuditError(f"bad audit ref {ref!r} (want SEGMENT:OFFSET)")
        if not _SEGMENT_RE.match(segment):
            raise AuditError(f"bad audit ref segment {segment!r}")
        path = os.path.join(self.directory, segment)
        try:
            with open(path, "rb") as fh:
                fh.seek(offset)
                line = fh.readline()
        except OSError as e:
            raise AuditError(f"cannot read {ref!r}: {e}")
        try:
            rec = json.loads(line.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise AuditError(f"no complete record at {ref!r}: {e}")
        rec["_ref"] = ref
        return rec

    # -- reconstruction ----------------------------------------------------
    def verify_chain(self) -> list[int]:
        """Walk every generation record: parent digests must chain, and
        every reconstruction must hash to its recorded digest.  Returns
        the verified generation numbers (raises on the first break)."""
        verified = []
        prev_digest = None
        for rec in self.generations():
            # A checkpoint with an empty parent restarts the chain: a
            # reopened writer has no prior summary, so its first record
            # is a self-contained (digest-verified) checkpoint.
            if rec["kind"] == "checkpoint" and not rec["parent"]:
                prev_digest = None
            if prev_digest is not None and rec["parent"] != prev_digest:
                raise AuditError(
                    f"digest chain broken at generation "
                    f"{rec['generation']}: parent {rec['parent']!r} != "
                    f"recorded {prev_digest!r}"
                )
            self.snapshot_at(rec["generation"])  # digest-verifying
            prev_digest = rec["digest"]
            verified.append(int(rec["generation"]))
        return verified

    def snapshot_at(self, generation: int) -> ClusterSnapshot:
        """Reconstruct one recorded generation: nearest checkpoint at or
        before it, then ``apply(old, diff)`` forward.  The result is
        digest-verified against the record — a reconstruction that does
        not hash identically raises, never silently replays."""
        generation = int(generation)
        cached = self._snapshots.get(generation)
        if cached is not None:
            return cached
        gens = self.generations()
        target_i = None
        for i, rec in enumerate(gens):
            if rec["generation"] == generation:
                target_i = i
                break
        if target_i is None:
            raise AuditError(f"generation {generation} not in the audit log")
        start_i = None
        for i in range(target_i, -1, -1):
            if gens[i]["kind"] == "checkpoint":
                start_i = i
                break
        if start_i is None:
            raise AuditError(
                f"no checkpoint at or before generation {generation}"
            )
        ck = gens[start_i]
        names = list(ck["names"])
        keys = _disambiguate(names)
        rows = {k: tuple(int(x) for x in row) for k, row in zip(keys, ck["rows"])}
        name_of = dict(zip(keys, names))
        taints_of = {
            k: t for k, t in zip(keys, ck.get("taints") or [])
        }
        labels_of = {
            k: lb for k, lb in zip(keys, ck.get("labels") or [])
        }
        semantics = ck["semantics"]
        for rec in gens[start_i + 1 : target_i + 1]:
            diff = SnapshotDiff(
                added={
                    k: tuple(int(x) for x in v)
                    for k, v in rec.get("added", {}).items()
                },
                removed={
                    k: tuple(int(x) for x in v)
                    for k, v in rec.get("removed", {}).items()
                },
                changed={
                    k: {f: int(d) for f, d in ch.items()}
                    for k, ch in rec.get("changed", {}).items()
                },
            )
            rows = diff.apply(rows)
            order = rec.get("order")
            if order is not None:
                rows = {k: rows[k] for k in order}
            added_names = rec.get("added_names", {})
            added_labels = rec.get("added_labels", {})
            for k in diff.removed:
                name_of.pop(k, None)
                taints_of.pop(k, None)
                labels_of.pop(k, None)
            for k in diff.added:
                name_of[k] = added_names.get(k, k)
                if k in added_labels:
                    labels_of[k] = added_labels[k]
            semantics = rec["semantics"]
        snap = self._snapshot_from_state(
            rows, name_of, taints_of, semantics, labels_of
        )
        recorded = gens[target_i]["digest"]
        actual = snapshot_digest(snap)
        if actual != recorded:
            raise AuditError(
                f"generation {generation} reconstruction digest {actual!r} "
                f"!= recorded {recorded!r} (audit log corrupt or "
                "out-of-vocabulary mutation)"
            )
        self._snapshots[generation] = snap
        return snap

    @staticmethod
    def _snapshot_from_state(
        rows: dict[str, tuple[int, ...]],
        name_of: dict[str, str],
        taints_of: dict[str, list],
        semantics: str,
        labels_of: dict[str, dict] | None = None,
    ) -> ClusterSnapshot:
        return snapshot_from_summary(
            rows, name_of, taints_of, semantics, labels_of=labels_of
        )


def taints_changed(old_summary: dict, old_taints, summary: dict,
                   taints) -> bool:
    """True iff a row of ``summary`` carries other taints than the same
    row of ``old_summary`` (taint lists in row order; a removed row does
    not count)."""
    old = dict(zip(old_summary.keys(), old_taints or []))
    new = dict(zip(summary.keys(), taints or []))
    return any((new.get(k) or []) != (old.get(k) or []) for k in summary)


def snapshot_from_summary(
    rows: dict[str, tuple[int, ...]],
    name_of: dict[str, str],
    taints_of: dict[str, list],
    semantics: str,
    *,
    labels_of: dict[str, dict] | None = None,
) -> ClusterSnapshot:
    """Summary vocabulary → a servable snapshot.  Columns outside the
    fit vocabulary (usage limits, extended resources) reconstruct
    empty — no replayable op consumes them.  Labels ride checkpoint
    records (``labels_of``) so topology/gang requests replay against
    the hierarchy that answered them; absent, they reconstruct empty
    and gang co-location falls to the explicit missing-label policy.
    Shared by the audit replayer and the serving plane's replica
    subscriber (:mod:`..service.plane`), which reconstruct snapshots
    from exactly the same checkpoint+diff record shapes."""
    keys = list(rows)
    n = len(keys)
    cols = {
        f: np.array([rows[k][i] for k in keys], dtype=np.int64)
        for i, f in enumerate(NODE_FIELDS[:-1])
    }
    healthy = np.array(
        [bool(rows[k][len(NODE_FIELDS) - 1]) for k in keys],
        dtype=np.bool_,
    )
    taints = [list(taints_of.get(k) or []) for k in keys]
    labels = [dict((labels_of or {}).get(k) or {}) for k in keys]
    return ClusterSnapshot(
        names=[name_of.get(k, k) for k in keys],
        alloc_cpu_milli=cols["alloc_cpu_milli"],
        alloc_mem_bytes=cols["alloc_mem_bytes"],
        alloc_pods=cols["alloc_pods"],
        used_cpu_req_milli=cols["used_cpu_req_milli"],
        used_cpu_lim_milli=np.zeros(n, dtype=np.int64),
        used_mem_req_bytes=cols["used_mem_req_bytes"],
        used_mem_lim_bytes=np.zeros(n, dtype=np.int64),
        pods_count=cols["pods_count"],
        healthy=healthy,
        semantics=semantics,
        taints=taints if any(taints) else [],
        labels=labels if any(labels) else [],
    )
