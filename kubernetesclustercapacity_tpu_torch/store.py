"""Incremental cluster store — the framework's informer analog.

Counterpart of ``kubernetesclustercapacity_tpu/store.py`` (numpy only),
feeding the service's ``update`` op and the ``-follow`` publisher.

The reference re-walks the entire apiserver on every invocation
(``1 + 2N + ΣP`` requests, SURVEY.md §3.4); real Kubernetes controllers
instead keep a *watch*-fed cache and apply object deltas.  This module is
that layer for the packed snapshot: a :class:`ClusterStore` holds the raw
node/pod state plus the dense arrays, and applies watch-style events —

    {"type": "ADDED"|"MODIFIED"|"DELETED",
     "kind": "Pod"|"Node",
     "object": <fixture-schema dict>}

— by recomputing only the affected node *rows* (O(pods-on-node) per pod
event, O(N) array reshape only when nodes join/leave), never the whole
cluster.  The invariant, enforced by tests on randomized event streams:
after any sequence of events the store's snapshot is element-identical to a
full :func:`~.snapshot.snapshot_from_fixture` repack of its state — under
either semantics, including the reference quirks (phantom rows re-homing
orphan pods, mod-2^64 usage wrap, parse-fail→0).
"""

from __future__ import annotations

import collections
import copy

import numpy as np

from kubernetesclustercapacity_tpu_torch.oracle import reference as _oracle
from kubernetesclustercapacity_tpu_torch.snapshot import (
    ClusterSnapshot,
    _effective_pod_resources,
    _clamp_i64,
    _strict_healthy,
    _strict_parse,
    _STRICT_TERMINATED,
    container_cpu_error_payloads as _container_cpu_error_payloads,
)
from kubernetesclustercapacity_tpu_torch.utils.quantity import (
    cpu_parse_error_payload,
)

__all__ = ["StoreError", "ClusterStore"]

_INT_COLS = (
    "alloc_cpu_milli",
    "alloc_mem_bytes",
    "alloc_pods",
    "used_cpu_req_milli",
    "used_cpu_lim_milli",
    "used_mem_req_bytes",
    "used_mem_lim_bytes",
    "pods_count",
)


class StoreError(ValueError):
    """Malformed or inapplicable watch event."""


def _isolate(obj):
    """Deep copy of a JSON-shaped object — the store's aliasing barrier.

    Raw state must never alias caller objects (a caller mutating a pod
    dict after ``apply_event`` would silently corrupt the
    repack-equality invariant).  Watch/fixture objects are plain
    dict/list/scalar trees, for which a direct recursion is ~4x cheaper
    than ``copy.deepcopy``'s memo machinery — this is the per-event hot
    path of the ``-follow`` serve loop.  Anything exotic falls back to
    ``copy.deepcopy``; immutable scalars are shared, which is safe.
    """
    t = type(obj)
    if t is str:  # the overwhelmingly common leaf — test first
        return obj
    if t is dict:
        # Keys are isolated too: deepcopy copies keys, and a mutable-but-
        # hashable custom key must not reach through the barrier.
        return {_isolate(k): _isolate(v) for k, v in obj.items()}
    if t is list:
        return [_isolate(v) for v in obj]
    if t in (int, float, bool, type(None)):
        return obj
    return copy.deepcopy(obj)


def _pod_key(pod: dict) -> tuple[str, str]:
    return (pod.get("namespace", ""), pod.get("name", ""))


class ClusterStore:
    """Watch-fed packed snapshot with per-row incremental updates."""

    def __init__(
        self,
        fixture: dict,
        *,
        semantics: str = "reference",
        extended_resources: tuple[str, ...] = (),
    ):
        if semantics not in ("reference", "strict"):
            raise ValueError(f"unknown semantics {semantics!r}")
        if extended_resources and semantics != "strict":
            # The packer (snapshot_from_fixture) owns this rule; the store
            # re-raises it as a StoreError because its repack-equality
            # invariant would otherwise die later inside a recompute.
            raise StoreError(
                "extended resources require strict semantics"
            )
        self.semantics = semantics
        self.extended_resources = tuple(extended_resources)
        # Raw state, deep-copied: events must never alias caller objects.
        self._nodes: list[dict] = [_isolate(n) for n in fixture.get("nodes", [])]
        if semantics == "strict":
            # Strict mode matches pods to rows BY NAME, so duplicate or
            # empty names would diverge from _pack_strict (whose name index
            # is last-wins and whose "" row never matches): reject them,
            # preserving the element-identical-to-full-repack invariant.
            # (Reference mode keeps them: phantom-row semantics, Q4.)
            names = collections.Counter(
                n.get("name", "") for n in self._nodes
            )
            if names[""]:
                raise StoreError("strict mode requires non-empty node names")
            dups = sorted(x for x, c in names.items() if c > 1)
            if dups:
                raise StoreError(f"duplicate node names in fixture: {dups}")
        # PDBs ride along raw (no packed-array footprint): drain's budget
        # gate reads them from fixture_view, so a store-fed service must
        # not drop them on rematerialization.  Keyed by (namespace, name)
        # so watch events upsert/delete in O(1), like pods.
        self._pdbs: dict[tuple[str, str], dict] = {}
        for b in fixture.get("pdbs", []):
            key = self._validate_pdb(b)
            if key in self._pdbs:
                raise StoreError(f"duplicate PDB {key} in fixture")
            self._pdbs[key] = _isolate(b)
        self._pods: dict[tuple[str, str], dict] = {}
        self._pods_by_node: dict[str, dict[tuple[str, str], dict]] = {}
        for p in fixture.get("pods", []):
            p = _isolate(p)
            key = _pod_key(p)
            if key in self._pods:
                raise StoreError(f"duplicate pod {key} in fixture")
            self._pods[key] = p
            self._pods_by_node.setdefault(p.get("nodeName", ""), {})[key] = p

        n = len(self._nodes)
        # Columns may carry spare capacity beyond the live row count (rows
        # ADD by amortized doubling); every read slices to n_nodes.
        self._cols = {c: np.zeros(n, dtype=np.int64) for c in _INT_COLS}
        self._healthy = np.zeros(n, dtype=np.bool_)
        self._ext = {
            r: (np.zeros(n, dtype=np.int64), np.zeros(n, dtype=np.int64))
            for r in self.extended_resources
        }
        # The name a row *matches pods by*: the raw name in strict mode, the
        # NodeView name in reference mode ("" for phantom rows, Q4) — plus
        # inverted indices so a pod event touches its rows in O(1), not via
        # an O(N) name scan (the round-3 churn bottleneck), and node events
        # locate rows by raw name the same way.
        self._view_names: list[str] = [""] * n
        # Reference-mode transcript provenance, maintained per row so the
        # SERVED snapshot replays the same skip/codec-error lines a fresh
        # pack would (node_log assembles in row order; see snapshot()).
        self._node_events: list[tuple[str | None, str | None]] = [
            (None, None)
        ] * n  # (cpu_err_payload, skip_name)
        self._pod_errs: list[tuple[str, ...]] = [()] * n
        self._node_log_cache: list[tuple[str, str]] | None = None
        # Publication-form labels/taints, rebuilt PER ROW on recompute
        # (node objects are replaced wholesale, never mutated in place).
        # snapshot() then costs outer list copies only — per-publish
        # Python loops over 10k rows starved the GIL against the event
        # thread and collapsed sustained churn throughput ~8x.
        self._labels_pub: list[dict] = [{}] * n
        self._taints_pub: list[list] = [[]] * n
        self._rows_by_view: dict[str, set[int]] = {"": set(range(n))}
        self._rows_by_raw: dict[str, set[int]] = {}
        for i, node in enumerate(self._nodes):
            self._rows_by_raw.setdefault(node.get("name", ""), set()).add(i)
        for i in range(n):
            self._recompute_row(i)
            self._refresh_pub_row(i, self._nodes[i])

    # -- public ------------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return len(self._nodes)

    def has_node(self, name: str) -> bool:
        return bool(self._rows_by_raw.get(name))

    def has_pod(self, namespace: str, name: str) -> bool:
        return (namespace, name) in self._pods

    def has_pdb(self, namespace: str, name: str) -> bool:
        return (namespace, name) in self._pdbs

    def fixture_view(self) -> dict:
        """Current raw state in fixture schema (deep copy)."""
        out = {"nodes": self._nodes, "pods": list(self._pods.values())}
        if self._pdbs:
            out["pdbs"] = list(self._pdbs.values())
        return _isolate(out)

    def snapshot(self) -> ClusterSnapshot:
        """A packed snapshot decoupled from the store's raw state.

        Numeric arrays are copied; names/provenance entries are immutable
        (strings/tuples); labels/taints are outer-copied lists over
        per-row dicts the store REPLACES (never mutates) on node events —
        so no caller mutation can reach raw state or poison repacks.  A
        caller that mutates a returned snapshot's label dicts in place
        can confuse a LATER snapshot's labels (they share row objects
        until that row's node changes); treat snapshots as read-only.
        """
        # Reference mode reports the NodeView name — "" for phantom rows,
        # exactly what the Go slice holds (Q4); strict reports raw names.
        n = len(self._nodes)
        node_log: list[tuple[str, str]] = []
        pod_cpu_errs: list[list[str]] = []
        if self.semantics == "reference":
            if self._node_log_cache is None:
                cache: list[tuple[str, str]] = []
                for cpu_err, skip_name in self._node_events:
                    if cpu_err is not None:
                        cache.append(("cpu_err", cpu_err))
                    if skip_name is not None:
                        cache.append(("skip", skip_name))
                self._node_log_cache = cache
            node_log = list(self._node_log_cache)
            pod_cpu_errs = list(self._pod_errs)
        # Outer-copied lists over per-row publication objects: the store
        # never mutates an inner dict/list in place (rows rebuild them
        # wholesale), so the returned snapshot can never read through to
        # raw state.  Inner objects ARE shared between snapshots — a
        # caller mutating one snapshot's labels can confuse a later
        # snapshot, never the store (fixture_view/repacks read raw state).
        return ClusterSnapshot(
            names=list(self._view_names),
            semantics=self.semantics,
            extended={
                r: (a[:n].copy(), u[:n].copy())
                for r, (a, u) in self._ext.items()
            },
            labels=list(self._labels_pub),
            taints=list(self._taints_pub),
            node_log=node_log,
            pod_cpu_errs=pod_cpu_errs,
            healthy=self._healthy[:n].copy(),
            **{c: self._cols[c][:n].copy() for c in _INT_COLS},
        )

    def apply(self, events: list[dict]) -> ClusterSnapshot:
        """Apply watch events in order; returns the updated snapshot.

        Events are validated before any mutation of the failing event is
        applied — a bad event raises :class:`StoreError` and leaves the
        store at the state after the last good event.
        """
        for ev in events:
            self.apply_event(ev)
        return self.snapshot()

    def apply_event(self, event: dict) -> None:
        etype = event.get("type")
        kind = event.get("kind")
        obj = event.get("object")
        if etype not in ("ADDED", "MODIFIED", "DELETED"):
            raise StoreError(f"unknown event type {etype!r}")
        if not isinstance(obj, dict):
            raise StoreError("event has no object")
        try:
            obj = _isolate(obj)
        except RecursionError as e:
            # A self-referential object is a malformed event, not a crash:
            # keep apply_event's "bad event raises StoreError" contract
            # (copy.deepcopy would have memoized the cycle; the fast
            # copier declines it instead).
            raise StoreError(f"cyclic event object: {e}") from e
        if kind == "Pod":
            self._apply_pod(etype, obj)
        elif kind == "Node":
            self._apply_node(etype, obj)
        elif kind == "PodDisruptionBudget":
            self._apply_pdb(etype, obj)
        else:
            raise StoreError(f"unknown event kind {kind!r}")

    def _apply_pdb(self, etype: str, obj: dict) -> None:
        """PDB events touch only the raw side (no packed arrays): upsert
        or delete by (namespace, name); drain reads the result from
        fixture_view.  A DELETED event only needs the key — real watch
        streams send the full last-known object, but a key-only delete
        (the service ``update`` op's natural shape) must not fail the
        spec-field validation."""
        if etype == "DELETED":
            self._pdbs.pop(
                (str(obj.get("namespace", "")), str(obj.get("name", ""))),
                None,
            )
        else:
            self._pdbs[self._validate_pdb(obj)] = obj

    # -- validation (before ANY mutation: a malformed object must never
    # enter raw state, or it would poison every later recompute AND the
    # full-repack invariant) ----------------------------------------------
    def _validate_pod(self, pod: dict) -> tuple[str, str]:
        try:
            key = _pod_key(pod)
            hash(key)
            hash(pod.get("nodeName", ""))  # it indexes _pods_by_node
            # The phase feeds frozenset membership on every recompute —
            # an unhashable phase must be rejected HERE, not crash later.
            phase = pod.get("phase")
            phase in _STRICT_TERMINATED  # noqa: B015 - hashability probe
            if self.semantics == "reference":
                _oracle.pod_requests_limits([pod])
            else:
                _effective_pod_resources(pod, self.extended_resources)
        except Exception as e:
            raise StoreError(f"malformed pod object: {e}") from e
        return key

    def _validate_pdb(self, pdb: dict) -> tuple[str, str]:
        """Run the budget arithmetic once against a synthetic pod in the
        budget's namespace — the ONE definition of PDB well-formedness
        (``pdb.budget_statuses``) owns the rules — plus a structural
        selector check (``pdb.validate_selector``): the probe pod
        carries no labels, so a non-empty ``matchLabels`` short-circuits
        ``_selector_matches`` before ``matchExpressions`` are ever
        evaluated, and a malformed operator would sail through to poison
        every later ``drain``/``budget_statuses`` read.  The structural
        check evaluates every expression unconditionally, so malformed
        selectors fail at admission."""
        from kubernetesclustercapacity_tpu_torch.pdb import (
            budget_statuses,
            validate_selector,
        )

        try:
            key = (str(pdb.get("namespace", "")), str(pdb.get("name", "")))
            validate_selector(pdb.get("selector") or {})
            probe = {
                "namespace": key[0], "name": "", "nodeName": "probe",
                "phase": "Running", "labels": {},
            }
            budget_statuses({"pdbs": [pdb], "pods": [probe]})
        except Exception as e:
            raise StoreError(f"malformed PDB object: {e}") from e
        return key

    def _validate_node(self, node: dict) -> None:
        try:
            if self.semantics == "reference":
                # Runs the reference health check too: its <4-conditions
                # ReferencePanic (Q3) surfaces as-is, pre-mutation, where
                # the reference process would simply have died.
                _oracle.healthy_nodes({"nodes": [node]})
            else:
                allocatable = node.get("allocatable", {})
                for k in ("cpu", "memory", "pods", *self.extended_resources):
                    _strict_parse(allocatable.get(k), milli=(k == "cpu"))
                _strict_healthy(node.get("conditions", []))
        except _oracle.ReferencePanic:
            raise
        except Exception as e:
            raise StoreError(f"malformed node object: {e}") from e

    # -- pods --------------------------------------------------------------
    def _apply_pod(self, etype: str, pod: dict) -> None:
        key = self._validate_pod(pod)
        old = self._pods.get(key)
        if etype == "ADDED" and old is not None:
            raise StoreError(f"pod {key} already exists")
        if etype in ("MODIFIED", "DELETED") and old is None:
            raise StoreError(f"pod {key} not found")

        touched = set()
        if old is not None:
            old_node = old.get("nodeName", "")
            del self._pods_by_node[old_node][key]
            touched.add(old_node)
        if etype == "DELETED":
            del self._pods[key]
        else:
            new_node = pod.get("nodeName", "")
            self._pods[key] = pod
            self._pods_by_node.setdefault(new_node, {})[key] = pod
            touched.add(new_node)
        for node_name in touched:
            for i in self._rows_matching(node_name):
                self._recompute_row(i)

    def _rows_matching(self, node_name: str) -> list[int]:
        """Rows whose pod-match name equals ``node_name`` (indexed, O(1)).

        In reference mode every phantom row matches ``""`` — an orphan-pod
        event touches all of them (the degenerate field selector, Q4).
        """
        return list(self._rows_by_view.get(node_name, ()))

    def _set_view_name(self, i: int, name: str) -> None:
        """Row view-name write-through that keeps the inverted index true."""
        old = self._view_names[i]
        if old == name:
            return
        rows = self._rows_by_view.get(old)
        if rows is not None:
            rows.discard(i)
        self._rows_by_view.setdefault(name, set()).add(i)
        self._view_names[i] = name

    def _rebuild_indices(self) -> None:
        """Full index rebuild — row indices shifted (node DELETE compaction)."""
        self._rows_by_view = {}
        self._rows_by_raw = {}
        for i, (node, view) in enumerate(zip(self._nodes, self._view_names)):
            self._rows_by_raw.setdefault(node.get("name", ""), set()).add(i)
            self._rows_by_view.setdefault(view, set()).add(i)

    # -- nodes -------------------------------------------------------------
    def _apply_node(self, etype: str, node: dict) -> None:
        name = node.get("name", "")
        if etype in ("ADDED", "MODIFIED"):
            self._validate_node(node)
            if self.semantics == "strict" and not name:
                raise StoreError("strict mode requires non-empty node names")
        idx = sorted(self._rows_by_raw.get(name, ()))
        if etype == "ADDED":
            if idx:
                raise StoreError(f"node {name!r} already exists")
            self._append_row()
            self._nodes.append(node)
            i = len(self._nodes) - 1
            self._rows_by_raw.setdefault(name, set()).add(i)
            self._recompute_row(i)
            self._refresh_pub_row(i, node)
        elif etype == "MODIFIED":
            if not idx:
                raise StoreError(f"node {name!r} not found")
            for i in idx:
                self._nodes[i] = node
                self._recompute_row(i)
                self._refresh_pub_row(i, node)
        else:  # DELETED
            if not idx:
                raise StoreError(f"node {name!r} not found")
            n = len(self._nodes)
            keep = np.ones(n, dtype=bool)
            keep[idx] = False
            for c in _INT_COLS:
                self._cols[c] = self._cols[c][:n][keep]
            self._healthy = self._healthy[:n][keep]
            self._ext = {
                r: (a[:n][keep], u[:n][keep])
                for r, (a, u) in self._ext.items()
            }
            self._nodes = [nd for i, nd in enumerate(self._nodes) if keep[i]]
            self._view_names = [
                v for i, v in enumerate(self._view_names) if keep[i]
            ]
            self._node_events = [
                e for i, e in enumerate(self._node_events) if keep[i]
            ]
            self._pod_errs = [
                e for i, e in enumerate(self._pod_errs) if keep[i]
            ]
            self._labels_pub = [
                e for i, e in enumerate(self._labels_pub) if keep[i]
            ]
            self._taints_pub = [
                e for i, e in enumerate(self._taints_pub) if keep[i]
            ]
            self._node_log_cache = None
            self._rebuild_indices()

    def _append_row(self) -> None:
        """Grow columns by amortized doubling (per-ADD ``np.append`` was
        O(N) — quadratic on relist-scale joins); the new row starts zeroed
        with view name ``""`` and is recomputed by the caller."""
        n = len(self._nodes)
        cap = self._healthy.shape[0]
        if n >= cap:
            pad = max(16, cap)
            self._cols = {
                c: np.concatenate([a, np.zeros(pad, a.dtype)])
                for c, a in self._cols.items()
            }
            self._healthy = np.concatenate(
                [self._healthy, np.zeros(pad, np.bool_)]
            )
            self._ext = {
                r: (
                    np.concatenate([a, np.zeros(pad, np.int64)]),
                    np.concatenate([u, np.zeros(pad, np.int64)]),
                )
                for r, (a, u) in self._ext.items()
            }
        self._view_names.append("")
        self._node_events.append((None, None))
        self._pod_errs.append([])
        self._labels_pub.append({})
        self._taints_pub.append([])
        self._node_log_cache = None
        self._rows_by_view.setdefault("", set()).add(n)

    # -- row packing (the single source of per-row truth) ------------------
    def _node_pods(self, match_name: str) -> list[dict]:
        return list(self._pods_by_node.get(match_name, {}).values())

    def _recompute_row(self, i: int) -> None:
        raw = self._nodes[i]
        if self.semantics == "reference":
            self._recompute_row_reference(i, raw)
        else:
            self._recompute_row_strict(i, raw)

    def _recompute_row_reference(self, i: int, raw: dict) -> None:
        # Single-node oracle walk: health check (incl. the <4-conditions
        # panic), reference codecs, phantom zeroing — identical to
        # _pack_reference's per-node step by construction.
        view = _oracle.healthy_nodes({"nodes": [raw]})[0]
        pods = [
            p
            for p in self._node_pods(view.name)
            if _oracle._survives_field_selector(p)
        ]
        cpu_lim, cpu_req, mem_lim, mem_req = _oracle.pod_requests_limits(pods)
        # Transcript provenance (same events _pack_reference records): the
        # node's cpu codec error, its skip line when unhealthy (with the
        # REAL name — the phantom row keeps ""), and its pods' container
        # codec errors in walk order, limits before requests (:279-284).
        allocatable = raw.get("allocatable", {})
        cpu_err = cpu_parse_error_payload(allocatable.get("cpu", "0"))
        skip = (
            None
            if _oracle.node_is_healthy_reference(raw)
            else raw.get("name", "")
        )
        new_events = (cpu_err, skip)
        if new_events != self._node_events[i]:
            self._node_events[i] = new_events
            self._node_log_cache = None  # row order changed the flat log
        self._pod_errs[i] = tuple(_container_cpu_error_payloads(pods))
        c = self._cols
        c["alloc_cpu_milli"][i] = _clamp_i64(view.allocatable_cpu)
        c["alloc_mem_bytes"][i] = _clamp_i64(view.allocatable_memory)
        c["alloc_pods"][i] = view.allocatable_pods
        c["used_cpu_req_milli"][i] = _clamp_i64(cpu_req)
        c["used_cpu_lim_milli"][i] = _clamp_i64(cpu_lim)
        c["used_mem_req_bytes"][i] = mem_req
        c["used_mem_lim_bytes"][i] = mem_lim
        c["pods_count"][i] = len(pods)
        self._healthy[i] = bool(view.name)
        self._set_view_name(i, view.name)

    def _refresh_pub_row(self, i: int, raw: dict) -> None:
        """Rebuild row ``i``'s publication-form labels/taints (fresh inner
        objects — returned snapshots must never alias raw state).  Called
        only from NODE-driven paths: pod events cannot change labels or
        taints, and rebuilding them per pod event would put allocation
        back on the churn hot path."""
        self._labels_pub[i] = dict(raw.get("labels", {}))
        self._taints_pub[i] = [dict(t) for t in raw.get("taints", [])]

    def _recompute_row_strict(self, i: int, raw: dict) -> None:
        name = raw.get("name", "")
        allocatable = raw.get("allocatable", {})
        c = self._cols
        c["alloc_cpu_milli"][i] = _strict_parse(allocatable.get("cpu"), milli=True)
        c["alloc_mem_bytes"][i] = _strict_parse(allocatable.get("memory"))
        c["alloc_pods"][i] = _strict_parse(allocatable.get("pods"))
        self._healthy[i] = _strict_healthy(raw.get("conditions", []))
        self._set_view_name(i, name)

        totals = dict.fromkeys(
            ("cpu_req", "cpu_lim", "mem_req", "mem_lim", "count"), 0
        )
        ext_used = dict.fromkeys(self.extended_resources, 0)
        for p in self._node_pods(name):
            if p.get("phase") in _STRICT_TERMINATED:
                continue
            totals["count"] += 1
            eff = _effective_pod_resources(p, self.extended_resources)
            for k in ("cpu_req", "cpu_lim", "mem_req", "mem_lim"):
                totals[k] += eff[k]
            for r in self.extended_resources:
                ext_used[r] += eff["ext"][r]
        c["used_cpu_req_milli"][i] = totals["cpu_req"]
        c["used_cpu_lim_milli"][i] = totals["cpu_lim"]
        c["used_mem_req_bytes"][i] = totals["mem_req"]
        c["used_mem_lim_bytes"][i] = totals["mem_lim"]
        c["pods_count"][i] = totals["count"]
        for r in self.extended_resources:
            self._ext[r][0][i] = _strict_parse(allocatable.get(r))
            self._ext[r][1][i] = ext_used[r]
