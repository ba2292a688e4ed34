"""Generation-to-generation snapshot diffing (counterpart of
``kubernetesclustercapacity_tpu/timeline/diff.py``, verbatim: the audit log's
diff records and digests must be the JAX package's byte for byte).

A :class:`~..snapshot.ClusterSnapshot` is summarized into a per-node
mapping (:func:`node_summary`) and two summaries diff into a
:class:`SnapshotDiff` — nodes added, nodes removed, and nodes mutated
with per-resource deltas.  The diff is *invertible by construction*:
``diff_summaries(old, new).apply(old) == new`` is a pinned property
(``tests/test_timeline.py``), so a recorded diff is a faithful record of
the generation transition, not a lossy rendering of it.

Node identity is the node NAME, which Kubernetes guarantees unique —
except for the reference packer's phantom rows, which all share ``""``
(and fixtures can carry duplicates).  Repeated names are disambiguated
positionally (``name#1``, ``name#2`` …) so every row keeps a stable key
and a churned duplicate shows up as a mutation/removal rather than
silently aliasing its namesake.

All arithmetic is Python-int (the summaries hold plain ints), so wrapped
uint64 CPU carriers survive the round trip bit-exactly.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

from kubernetesclustercapacity_tpu_torch.snapshot import ClusterSnapshot

__all__ = [
    "NODE_FIELDS",
    "SnapshotDiff",
    "diff_summaries",
    "node_summary",
    "shape_key",
    "snapshot_digest",
]

#: The per-node columns a summary row carries, in tuple order.  These are
#: exactly the arrays the fit kernels consume (plus health), so a zero
#: diff proves the two generations answer every query identically.
NODE_FIELDS = (
    "alloc_cpu_milli",
    "alloc_mem_bytes",
    "alloc_pods",
    "used_cpu_req_milli",
    "used_mem_req_bytes",
    "pods_count",
    "healthy",
)

_DIGEST_HEX = 16  # matches the flight recorder's truncation


def node_summary(snap: ClusterSnapshot) -> dict[str, tuple[int, ...]]:
    """``{node key: per-field int tuple}`` in snapshot row order.

    Keys are node names; a repeated name gets ``#<occurrence>`` appended
    from its second occurrence on, so phantom ``""`` rows and duplicate
    fixtures keep one key per ROW.  ``healthy`` rides as 0/1.
    """
    cols = [
        np.asarray(getattr(snap, f)).astype(np.int64) for f in NODE_FIELDS
    ]
    out: dict[str, tuple[int, ...]] = {}
    seen: dict[str, int] = {}
    for i, name in enumerate(snap.names):
        n = seen.get(name, 0)
        seen[name] = n + 1
        key = name if n == 0 else f"{name}#{n}"
        out[key] = tuple(int(c[i]) for c in cols)
    return out


def snapshot_digest(snap: ClusterSnapshot) -> str:
    """Truncated SHA-256 over the summary columns + names: two snapshots
    share a digest iff every fit-relevant column matches row for row
    (same truncation as the flight recorder's request digests)."""
    h = hashlib.sha256()
    h.update("\x00".join(snap.names).encode())
    h.update(snap.semantics.encode())
    for f in NODE_FIELDS:
        arr = np.ascontiguousarray(np.asarray(getattr(snap, f)).astype(np.int64))
        h.update(arr.tobytes())
    return h.hexdigest()[:_DIGEST_HEX]


def shape_key(row: tuple[int, ...]) -> str:
    """Stable short identifier of a node SHAPE (a summary row's field
    tuple): two rows share a key iff every fit-relevant column matches —
    the same equivalence the grouped snapshot compresses on
    (:meth:`..snapshot.ClusterSnapshot.grouped`), so drift attribution
    can say *which* group a churned node joined or left."""
    h = hashlib.sha256("|".join(str(int(v)) for v in row).encode())
    return h.hexdigest()[:8]


@dataclass
class SnapshotDiff:
    """One generation transition: added/removed rows and per-field deltas.

    ``added``/``removed`` carry the full field tuple (``removed`` holds
    the OLD values, making the diff invertible); ``changed`` maps node
    key → ``{field: new - old}`` with zero-delta fields omitted.
    """

    added: dict[str, tuple[int, ...]] = field(default_factory=dict)
    removed: dict[str, tuple[int, ...]] = field(default_factory=dict)
    changed: dict[str, dict[str, int]] = field(default_factory=dict)

    @property
    def empty(self) -> bool:
        return not (self.added or self.removed or self.changed)

    def apply(self, old: dict[str, tuple[int, ...]]) -> dict[str, tuple[int, ...]]:
        """``old ⊕ diff``: reconstruct the new summary (the round-trip
        contract ``diff_summaries(a, b).apply(a) == b``)."""
        out: dict[str, tuple[int, ...]] = {}
        for key, row in old.items():
            if key in self.removed:
                continue
            deltas = self.changed.get(key)
            if deltas:
                out[key] = tuple(
                    v + deltas.get(f, 0) for f, v in zip(NODE_FIELDS, row)
                )
            else:
                out[key] = row
        out.update(self.added)
        return out

    def to_wire(self) -> dict:
        """JSON-able shape for the ``timeline`` op: keys + per-field
        deltas (full tuples for added/removed are summarized as dicts so
        the wire stays self-describing)."""
        return {
            "nodes_added": [
                {"node": k, **dict(zip(NODE_FIELDS, v))}
                for k, v in self.added.items()
            ],
            "nodes_removed": [
                {"node": k, **dict(zip(NODE_FIELDS, v))}
                for k, v in self.removed.items()
            ],
            "nodes_changed": [
                {"node": k, "deltas": dict(d)}
                for k, d in self.changed.items()
            ],
        }


def diff_summaries(
    old: dict[str, tuple[int, ...]], new: dict[str, tuple[int, ...]]
) -> SnapshotDiff:
    """Diff two :func:`node_summary` mappings (pure dict/int math)."""
    diff = SnapshotDiff()
    for key, row in new.items():
        prev = old.get(key)
        if prev is None:
            diff.added[key] = row
        elif prev != row:
            diff.changed[key] = {
                f: b - a
                for f, a, b in zip(NODE_FIELDS, prev, row)
                if b != a
            }
    for key, row in old.items():
        if key not in new:
            diff.removed[key] = row
    return diff
