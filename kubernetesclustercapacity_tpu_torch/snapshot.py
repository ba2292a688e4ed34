"""Cluster snapshot (L2): dense node-resource arrays the sweep consumes.

Counterpart of ``kubernetesclustercapacity_tpu/snapshot.py`` (numpy only;
the arrays become device tensors in :mod:`.devcache`).  The cluster is
snapshotted ONCE into dense int64 columns, so every evaluation — one
scenario or a 1k-scenario sweep — is pure array math.

Two ingestion semantics, pinned by SURVEY.md §2.4:

* ``reference`` — bug-compatible: built on the reference's own node and pod
  walk (:mod:`.oracle.reference`), so phantom zero-nodes, parse-fail→0
  memory and the first-4-conditions health check land in the arrays exactly
  as the Go code would see them.
* ``strict`` — full Kubernetes quantity grammar, health = ``Ready == True``
  and no pressure condition ``True``, pod usage counts all pods assigned to
  the node that are not Succeeded/Failed, and per-pod effective requests
  follow the scheduler rule ``max(sum(containers), max(initContainers))``.
  Unhealthy nodes keep their real allocatables and are masked via
  ``healthy``.

:meth:`ClusterSnapshot.save` / :func:`load_snapshot` read and write the JAX
package's ``.npz`` checkpoint format field for field.  The pod walks run
the native columnar walk (:mod:`.native.ingest`) when it builds, and the
pure-Python loops otherwise; :data:`NATIVE_WALKS` counts the native ones.
:func:`snapshot_from_live_cluster` lists a live apiserver (two paginated
Lists, :mod:`.kubeapi`) and packs the result like a fixture.
"""

from __future__ import annotations

import functools
import json
import os
import threading
from dataclasses import dataclass, field, fields

import numpy as np

from kubernetesclustercapacity_tpu_torch.native import ingest as _ingest
from kubernetesclustercapacity_tpu_torch.oracle import reference as _oracle
from kubernetesclustercapacity_tpu_torch.utils import quantity as _q

__all__ = [
    "COLUMNS",
    "ClusterSnapshot",
    "GroupedSnapshot",
    "snapshot_from_fixture",
    "snapshot_from_live_cluster",
    "synthetic_snapshot",
    "load_snapshot",
    "grouping_enabled",
    "group_min_count",
    "set_group_min_count",
    "grouped_for_dispatch",
    "publish_group_metrics",
    "GROUPING_NODE_FLOOR",
]

#: The int64 node columns, in checkpoint order (``healthy`` is the bool
#: column beside them).
COLUMNS = (
    "alloc_cpu_milli",
    "alloc_mem_bytes",
    "alloc_pods",
    "used_cpu_req_milli",
    "used_cpu_lim_milli",
    "used_mem_req_bytes",
    "used_mem_lim_bytes",
    "pods_count",
)

# Phases that never consume node capacity in strict mode (terminated pods).
_STRICT_TERMINATED = frozenset({"Succeeded", "Failed"})

#: Pod walks that the native extension took, by semantics; a walk that
#: fell back to the pure-Python loop adds nothing.  Read it before and
#: after a pack to see which loop ran.
NATIVE_WALKS = {"reference": 0, "strict": 0}
_NATIVE_WALKS_LOCK = threading.Lock()


def _count_native_walk(semantics: str) -> None:
    with _NATIVE_WALKS_LOCK:
        NATIVE_WALKS[semantics] += 1


@dataclass
class ClusterSnapshot:
    """Dense ``(nodes,)`` arrays of allocatable vs. requested resources.

    All resource arrays are int64 (CPU in millicores, memory in bytes —
    the reference's units, ``ClusterCapacity.go:41-46``).  ``healthy`` is
    the node-health mask: in reference semantics unhealthy rows are ALSO
    zeroed (phantom nodes), in strict semantics they carry real values and
    the mask alone excludes them.

    ``extended`` maps resource name → ``(allocatable[N], used_requests[N])``.
    ``node_log`` and ``pod_cpu_errs`` are the reference packer's transcript
    provenance (codec-error and skip events in emission order), carried
    through checkpoints for the single-spec report.
    """

    names: list[str]
    alloc_cpu_milli: np.ndarray
    alloc_mem_bytes: np.ndarray
    alloc_pods: np.ndarray
    used_cpu_req_milli: np.ndarray
    used_cpu_lim_milli: np.ndarray
    used_mem_req_bytes: np.ndarray
    used_mem_lim_bytes: np.ndarray
    pods_count: np.ndarray
    healthy: np.ndarray
    semantics: str = "reference"
    extended: dict[str, tuple[np.ndarray, np.ndarray]] = field(default_factory=dict)
    labels: list[dict] = field(default_factory=list)
    taints: list[list] = field(default_factory=list)
    node_log: list[tuple[str, str]] = field(default_factory=list)
    pod_cpu_errs: list[list[str]] = field(default_factory=list)

    def __post_init__(self) -> None:
        n = len(self.names)
        for f in COLUMNS:
            arr = np.asarray(getattr(self, f), dtype=np.int64)
            if arr.shape != (n,):
                raise ValueError(f"{f}: expected shape ({n},), got {arr.shape}")
            setattr(self, f, arr)
        self.healthy = np.asarray(self.healthy, dtype=np.bool_)
        if self.healthy.shape != (n,):
            raise ValueError("healthy mask shape mismatch")
        self.node_log = [tuple(t) for t in self.node_log]
        self.pod_cpu_errs = [tuple(e) for e in self.pod_cpu_errs]

    @classmethod
    def from_columns(
        cls, columns: dict[str, np.ndarray], **meta
    ) -> "ClusterSnapshot":
        """Build a snapshot from numpy columns (the :data:`COLUMNS` plus
        ``healthy``, e.g. another package's snapshot arrays) and metadata
        keywords (``names`` required; ``semantics``, ``labels``,
        ``taints``, ... optional)."""
        return cls(
            **{f: columns[f] for f in (*COLUMNS, "healthy")}, **meta
        )

    @property
    def n_nodes(self) -> int:
        return len(self.names)

    def resource_matrix(
        self, resources: tuple[str, ...] = ("cpu", "memory")
    ) -> tuple[np.ndarray, np.ndarray]:
        """``(alloc[R, N], used_req[R, N])`` for the R-resource sweep.

        Row order follows ``resources``; ``"cpu"`` and ``"memory"`` name the
        core columns, anything else must be a key of :attr:`extended`
        (``KeyError`` otherwise).  Memoized per ``resources`` tuple on the
        (immutable) snapshot; the cached matrices are read-only.
        """
        resources = tuple(resources)
        cache = self.__dict__.setdefault("_matrix_cache", {})
        hit = cache.get(resources)
        if hit is not None:
            return hit
        alloc_rows, used_rows = [], []
        for r in resources:
            if r == "cpu":
                alloc, used = self.alloc_cpu_milli, self.used_cpu_req_milli
            elif r == "memory":
                alloc, used = self.alloc_mem_bytes, self.used_mem_req_bytes
            else:
                alloc, used = self.extended[r]
            alloc_rows.append(alloc)
            used_rows.append(used)
        alloc_rn, used_rn = np.stack(alloc_rows), np.stack(used_rows)
        alloc_rn.setflags(write=False)
        used_rn.setflags(write=False)
        cache[resources] = (alloc_rn, used_rn)
        return cache[resources]

    def grouped(self) -> "GroupedSnapshot":
        """The node-shape-compressed form: identical rows deduplicated
        into ``(shape, count)`` groups.

        The grouping key is every fit-relevant column (allocatable, usage
        requests AND limits, pod counts, health, extended columns), so two
        rows share a group iff every value matches.  Capacity is a sum over
        nodes, so evaluating the distinct shapes weighted by count is
        exact.  Groups come in lexicographic row order (column 0 most
        significant), as ``np.unique(rows, axis=0)`` orders them.
        Memoized on the (immutable) snapshot.
        """
        hit = self.__dict__.get("_grouped_cache")
        if hit is not None:
            return hit
        rows = self._group_rows()
        ext_names = sorted(self.extended)
        n = rows.shape[0]
        if n:
            order = np.lexsort(rows.T[::-1])
            sorted_rows = rows[order]
            boundary = np.empty(n, dtype=bool)
            boundary[0] = True
            np.any(
                sorted_rows[1:] != sorted_rows[:-1], axis=1,
                out=boundary[1:],
            )
            gid_sorted = np.cumsum(boundary) - 1
            inverse = np.empty(n, dtype=np.int64)
            inverse[order] = gid_sorted
            uniq = sorted_rows[boundary]
            counts = np.bincount(gid_sorted).astype(np.int64)
        else:
            uniq = rows
            inverse = np.zeros(0, dtype=np.int64)
            counts = np.zeros(0, dtype=np.int64)
        g = uniq.shape[0]
        # First-occurrence representative per group (the lowest node row).
        representative = np.full(g, self.n_nodes, dtype=np.int64)
        if self.n_nodes:
            np.minimum.at(representative, inverse, np.arange(self.n_nodes))
        ext = {
            r: (
                uniq[:, 9 + 2 * e].copy(),
                uniq[:, 9 + 2 * e + 1].copy(),
            )
            for e, r in enumerate(ext_names)
        }
        grouped = GroupedSnapshot(
            snapshot=self,
            alloc_cpu_milli=uniq[:, 0].copy(),
            alloc_mem_bytes=uniq[:, 1].copy(),
            alloc_pods=uniq[:, 2].copy(),
            used_cpu_req_milli=uniq[:, 3].copy(),
            used_cpu_lim_milli=uniq[:, 4].copy(),
            used_mem_req_bytes=uniq[:, 5].copy(),
            used_mem_lim_bytes=uniq[:, 6].copy(),
            pods_count=uniq[:, 7].copy(),
            healthy=uniq[:, 8].astype(np.bool_),
            count=counts,
            group_index=inverse,
            representative=representative,
            extended=ext,
        )
        return self.__dict__.setdefault("_grouped_cache", grouped)

    def _group_rows(self) -> np.ndarray:
        """The ``[N, C]`` int64 grouping-key matrix, shared by
        :meth:`grouped` and the dispatch gate's hash pre-check."""
        cols = [getattr(self, f) for f in COLUMNS]
        cols.append(self.healthy.astype(np.int64))
        for r in sorted(self.extended):
            alloc, used = self.extended[r]
            cols.append(np.asarray(alloc, dtype=np.int64))
            cols.append(np.asarray(used, dtype=np.int64))
        if not self.n_nodes:
            return np.zeros((0, len(cols)), dtype=np.int64)
        return np.stack(cols, axis=1)

    def save(self, path: str) -> None:
        """Checkpoint to ``.npz`` (arrays + JSON metadata), in the JAX
        package's format."""
        meta = {
            "names": self.names,
            "semantics": self.semantics,
            "labels": self.labels,
            "taints": self.taints,
            "extended_names": sorted(self.extended),
            "node_log": [list(t) for t in self.node_log],
            "pod_cpu_errs": self.pod_cpu_errs,
            "version": 1,
        }
        arrays = {
            f.name: getattr(self, f.name)
            for f in fields(self)
            if f.name
            not in (
                "names", "semantics", "extended", "labels", "taints",
                "node_log", "pod_cpu_errs",
            )
        }
        for r_name, (alloc, used) in self.extended.items():
            arrays[f"ext_alloc::{r_name}"] = alloc
            arrays[f"ext_used::{r_name}"] = used
        np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


@dataclass
class GroupedSnapshot:
    """Node-shape-compressed view of a :class:`ClusterSnapshot`.

    ``G`` groups of identical node rows: every per-group array is ``[G]``
    in the parent's column vocabulary, ``count[g]`` is how many node rows
    share shape ``g``, ``group_index`` maps each node row to its group (so
    ``per_group[group_index]`` expands a grouped result back to per-node)
    and ``representative`` names the lowest node row of each group.
    Built only by :meth:`ClusterSnapshot.grouped`; treat as immutable.
    """

    snapshot: ClusterSnapshot
    alloc_cpu_milli: np.ndarray
    alloc_mem_bytes: np.ndarray
    alloc_pods: np.ndarray
    used_cpu_req_milli: np.ndarray
    used_cpu_lim_milli: np.ndarray
    used_mem_req_bytes: np.ndarray
    used_mem_lim_bytes: np.ndarray
    pods_count: np.ndarray
    healthy: np.ndarray
    count: np.ndarray
    group_index: np.ndarray
    representative: np.ndarray
    extended: dict[str, tuple[np.ndarray, np.ndarray]] = field(
        default_factory=dict
    )

    @property
    def n_groups(self) -> int:
        return int(self.count.shape[0])

    @property
    def n_nodes(self) -> int:
        return self.snapshot.n_nodes

    @property
    def semantics(self) -> str:
        return self.snapshot.semantics

    @property
    def compression_ratio(self) -> float:
        """Nodes per group (1.0 = nothing merged)."""
        g = self.n_groups
        return (self.n_nodes / g) if g else 1.0

    def representative_names(self) -> list[str]:
        """One real node name per group (the first row with the shape)."""
        names = self.snapshot.names
        return [names[int(i)] for i in self.representative]

    def effective_counts(self, node_mask=None) -> np.ndarray:
        """Per-group node multiplicity, optionally restricted to a ``[N]``
        bool ``node_mask``.  A masked-out node contributes fit 0 in every
        mode, so ``Σ_g count_g(mask) · fit_g`` equals the masked per-node
        sum exactly."""
        if node_mask is None:
            return self.count
        mask = np.asarray(node_mask, dtype=bool)
        if mask.shape != (self.n_nodes,):
            raise ValueError(
                f"node_mask: expected shape ({self.n_nodes},), "
                f"got {mask.shape}"
            )
        return np.bincount(
            self.group_index[mask], minlength=self.n_groups
        ).astype(np.int64)

    def expand(self, per_group: np.ndarray) -> np.ndarray:
        """Gather a per-group array (last axis ``[G]``) back to per-node
        (last axis ``[N]``) through :attr:`group_index`."""
        return np.asarray(per_group)[..., self.group_index]


# --- grouping dispatch gate ---------------------------------------------
# KCCAP_GROUPING=0 turns grouping off.  The grouped path engages only when
# it pays: below the node floor the ungrouped sweep is already cheap, and a
# mean group occupancy below KCCAP_GROUP_MIN_COUNT means compression would
# not shrink the sweep meaningfully.

#: Minimum cluster size for the grouped dispatch to engage.
GROUPING_NODE_FLOOR = 1024

#: Default minimum mean nodes-per-group (compression ratio) gate.
DEFAULT_GROUP_MIN_COUNT = 2


def grouping_enabled() -> bool:
    """Process-wide grouping switch (``KCCAP_GROUPING=0`` disables)."""
    return os.environ.get("KCCAP_GROUPING", "1") != "0"


#: The gate set by ``-group-min-count`` (None: read the environment).
_group_min_count: int | None = None


def set_group_min_count(value: int | None) -> None:
    """Set the mean-occupancy gate (the ``-group-min-count`` flag); None
    returns to the per-dispatch read of ``KCCAP_GROUP_MIN_COUNT``."""
    global _group_min_count
    if value is not None and value < 1:
        raise ValueError("group min count must be >= 1")
    _group_min_count = None if value is None else int(value)


def group_min_count() -> int:
    """The mean-occupancy gate: the value :func:`set_group_min_count` set,
    else ``KCCAP_GROUP_MIN_COUNT``, read on every dispatch, else 2."""
    if _group_min_count is not None:
        return _group_min_count
    try:
        env = int(os.environ.get("KCCAP_GROUP_MIN_COUNT", "0"))
    except ValueError:
        env = 0
    return env if env > 0 else DEFAULT_GROUP_MIN_COUNT


def grouped_for_dispatch(snapshot: ClusterSnapshot) -> GroupedSnapshot | None:
    """The grouped form IFF the grouped sweep should serve this snapshot:
    grouping enabled, cluster at/above the node floor, and the compression
    ratio clears :func:`group_min_count`.  ``None`` means "dispatch
    ungrouped".

    The decision memoizes per (snapshot, gate), and a heterogeneous fleet
    is rejected by a row-HASH pre-check before the group sort is paid:
    distinct hashes never exceed the true group count, so
    ``N / distinct_hashes`` upper-bounds the compression ratio.
    """
    if not grouping_enabled():
        return None
    n = snapshot.n_nodes
    if n < GROUPING_NODE_FLOOR:
        return None
    mc = group_min_count()
    hit = snapshot.__dict__.get("_grouping_decision")
    if hit is not None and hit[0] == mc:
        return hit[1]
    if "_grouped_cache" not in snapshot.__dict__:
        rows = snapshot._group_rows()
        # Odd multipliers keep the mod-2^64 mix bijective per column
        # (the golden-ratio constant, wrapped onto the int64 carrier).
        phi = np.uint64(0x9E3779B97F4A7C15).astype(np.int64)
        mult = np.arange(1, 2 * rows.shape[1], 2, dtype=np.int64) * phi
        h = rows @ mult  # wraps mod 2^64 — a hash, not a value
        if n < mc * np.unique(h).size:
            snapshot.__dict__["_grouping_decision"] = (mc, None)
            return None
    grouped = snapshot.grouped()
    result = grouped if n >= mc * grouped.n_groups else None
    snapshot.__dict__["_grouping_decision"] = (mc, result)
    return result


# Lazily-built gauges on the process registry (importing this module
# must register nothing; KCCAP_TELEMETRY=0 means zero registry calls —
# same policy as devcache).
_GROUP_MET: dict | None = None
_group_met_lock = threading.Lock()


def _group_metrics() -> dict:
    global _GROUP_MET
    if _GROUP_MET is None:
        with _group_met_lock:
            if _GROUP_MET is None:
                from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
                    REGISTRY,
                )

                _GROUP_MET = {
                    "groups": REGISTRY.gauge(
                        "kccap_group_count",
                        "Distinct (shape, count) node groups in the "
                        "published snapshot.",
                    ),
                    "ratio": REGISTRY.gauge(
                        "kccap_compression_ratio",
                        "Nodes per group of the published snapshot "
                        "(1.0 = nothing merged).",
                    ),
                }
    return _GROUP_MET


def publish_group_metrics(snapshot: ClusterSnapshot) -> None:
    """Update the grouping gauges for a freshly published snapshot.

    Called on the publish path (server construction / snapshot swap),
    never per request.  No-op when telemetry or grouping is off; best
    effort — gauge publication must never fail a publish.
    """
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
        enabled as _telemetry_enabled,
    )

    if not _telemetry_enabled() or not grouping_enabled():
        return
    try:
        grouped = grouped_for_dispatch(snapshot)
        met = _group_metrics()
        if grouped is None:
            # Not engaged (small cluster / heterogeneous fleet): report
            # the sentinel rather than paying the full group sort just
            # for a gauge — 0 groups means "ungrouped dispatch".
            met["groups"].set(0)
            met["ratio"].set(1.0)
        else:
            met["groups"].set(grouped.n_groups)
            met["ratio"].set(round(grouped.compression_ratio, 4))
    except Exception:  # noqa: BLE001 - observability never fails publish
        pass


def load_snapshot(path: str) -> ClusterSnapshot:
    """Read a ``.npz`` checkpoint written by either package."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        extended = {
            r: (data[f"ext_alloc::{r}"], data[f"ext_used::{r}"])
            for r in meta["extended_names"]
        }
        return ClusterSnapshot.from_columns(
            {f: data[f] for f in (*COLUMNS, "healthy")},
            names=meta["names"],
            semantics=meta["semantics"],
            extended=extended,
            labels=meta["labels"],
            taints=meta["taints"],
            node_log=[tuple(t) for t in meta.get("node_log", [])],
            pod_cpu_errs=meta.get("pod_cpu_errs")
            or [[] for _ in meta["names"]],
        )


def snapshot_from_fixture(
    fixture: dict,
    *,
    semantics: str = "reference",
    extended_resources: tuple[str, ...] = (),
) -> ClusterSnapshot:
    """Pack a node/pod fixture into dense arrays under the chosen semantics.

    ``extended_resources`` is strict-only: the reference semantics has no
    extended-column concept (``ClusterCapacity.go:41-46``).
    """
    if extended_resources and semantics != "strict":
        raise ValueError(
            "extended resources require strict semantics (reference "
            "semantics has no extended-column concept)"
        )
    if semantics not in ("reference", "strict"):
        raise ValueError(
            f"unknown semantics {semantics!r} (want 'reference'|'strict')"
        )
    from kubernetesclustercapacity_tpu_torch.telemetry import hostmem

    hostmem.milestone("pack_start")
    if semantics == "reference":
        snap = _pack_reference(fixture)
    else:
        snap = _pack_strict(fixture, extended_resources)
    hostmem.milestone("pack_end")
    return snap


def _pack_reference(fixture: dict) -> ClusterSnapshot:
    """Reference-semantics packing, columnar.

    Phantom nodes (unhealthy → zero-valued, ``ClusterCapacity.go:221-226``)
    keep their zero allocatables AND accumulate usage from pods with an
    empty ``nodeName`` — exactly what the degenerate field selector
    matches (Q4).  Each distinct quantity string parses once into a lookup
    table; per-name usage totals are ``np.add.at`` scatter-adds whose int64
    wraparound is Go's mod-2^64 running-sum wrap; rows sharing a name
    (phantom ``""`` rows, duplicate names) get identical sums, exactly as
    the reference's per-node walk produces.
    """
    raw_nodes = fixture.get("nodes", [])
    n = len(raw_nodes)
    labels = [raw.get("labels", {}) for raw in raw_nodes]
    taints = [raw.get("taints", []) for raw in raw_nodes]
    snap = _empty_arrays(n)

    # Each distinct (cpu, memory, pods) allocatable triple parses ONCE, at
    # first sight and in node order: the reference parses each node's
    # allocatables BEFORE its conditions check, so a bad cpu string on
    # node 5 raises before node 7's <4-conditions panic.
    names: list[str] = []
    node_log: list[tuple[str, str]] = []
    triple_vals: dict = {}  # triple -> (code, cpu, mem, pods, cpu_err)
    healthy_rows: list[int] = []
    row_codes: list[int] = []
    for i, raw in enumerate(raw_nodes):
        allocatable = raw.get("allocatable", {})
        triple = (
            allocatable.get("cpu", "0"),
            allocatable.get("memory", ""),
            allocatable.get("pods", "0"),
        )
        vals = triple_vals.get(triple)
        if vals is None:
            cpu, mem, pods, cpu_err = _oracle.node_allocatable_values(
                *triple
            )
            vals = triple_vals[triple] = (
                len(triple_vals), _clamp_i64(cpu), _clamp_i64(mem), pods,
                cpu_err,
            )
        if vals[4] is not None:  # codec error prints per OCCURRENCE
            node_log.append(("cpu_err", vals[4]))

        if _oracle.node_is_healthy_reference(raw):
            names.append(raw.get("name", ""))
            healthy_rows.append(i)
            row_codes.append(vals[0])
        else:
            # Phantom row keeps the empty name and zero allocatables
            # (ClusterCapacity.go:221-226); the skip line prints the REAL
            # name (:215).
            names.append("")
            node_log.append(("skip", raw.get("name", "")))

    if healthy_rows:
        lut = np.empty((len(triple_vals), 3), dtype=np.int64)
        for code, cpu, mem, pods, _err in triple_vals.values():
            lut[code] = (cpu, mem, pods)
        hr = np.asarray(healthy_rows, dtype=np.int64)
        rc = np.asarray(row_codes, dtype=np.int64)
        snap["alloc_cpu_milli"][hr] = lut[rc, 0]
        snap["alloc_mem_bytes"][hr] = lut[rc, 1]
        snap["alloc_pods"][hr] = lut[rc, 2]
    if n:
        snap["healthy"] = np.fromiter(
            (bool(nm) for nm in names), np.bool_, n
        )

    interned, name_gid, pod_gids, c_gids, c_codes = _walk_pods_reference(
        fixture.get("pods", [])
    )

    pod_cpu_errs: list[list[str]] = [[] for _ in range(n)]
    if name_gid and n:
        # Per-column LUTs over the distinct quads: each string parses once.
        lut = np.empty((4, len(interned)), dtype=np.int64)
        for qi, quad in enumerate(interned):
            lut[0, qi] = _clamp_i64(_q.cpu_to_milli_reference(quad[0]))
            lut[1, qi] = _clamp_i64(_q.cpu_to_milli_reference(quad[1]))
            lut[2, qi] = _clamp_i64(_oracle._mem_value(quad[2]))
            lut[3, qi] = _clamp_i64(_oracle._mem_value(quad[3]))
        g = len(name_gid)
        by_name = {
            k: np.zeros(g, dtype=np.int64)
            for k in ("creq", "clim", "mreq", "mlim", "count")
        }
        np.add.at(by_name["count"], np.asarray(pod_gids, np.int64), 1)
        cg = np.asarray(c_gids, np.int64)
        cc = np.asarray(c_codes, np.int64)
        for key, row in (
            ("creq", 0), ("clim", 1), ("mreq", 2), ("mlim", 3),
        ):
            np.add.at(by_name[key], cg, lut[row][cc])
        row_gid = np.fromiter(
            (name_gid.get(nm, -1) for nm in names), np.int64, n
        )
        hit = row_gid >= 0
        safe = np.where(hit, row_gid, 0)
        for field_name, key in (
            ("used_cpu_req_milli", "creq"),
            ("used_cpu_lim_milli", "clim"),
            ("used_mem_req_bytes", "mreq"),
            ("used_mem_lim_bytes", "mlim"),
            ("pods_count", "count"),
        ):
            snap[field_name] = np.where(hit, by_name[key][safe], 0)

        # Transcript events: container cpu strings that fail the codec
        # print once per OCCURRENCE, limits before requests
        # (ClusterCapacity.go:279-284), grouped per node row; phantom rows
        # share the "" group's list.
        quad_errs: list[list[str]] = []
        any_err = False
        for quad in interned:
            errs = [
                p
                for p in (
                    _q.cpu_parse_error_payload(quad[1]),  # limits first
                    _q.cpu_parse_error_payload(quad[0]),
                )
                if p is not None
            ]
            quad_errs.append(errs)
            any_err = any_err or bool(errs)
        if any_err:
            gid_errs: dict[int, list[str]] = {}
            for gid_i, code_i in zip(c_gids, c_codes):
                errs = quad_errs[code_i]
                if errs:
                    gid_errs.setdefault(int(gid_i), []).extend(errs)
            for i in range(n):
                if hit[i]:
                    pod_cpu_errs[i] = list(
                        gid_errs.get(int(row_gid[i]), ())
                    )

    return ClusterSnapshot(
        names=names,
        semantics="reference",
        labels=labels,
        taints=taints,
        node_log=node_log,
        pod_cpu_errs=pod_cpu_errs,
        **snap,
    )


def container_cpu_error_payloads(pods) -> list[str]:
    """Codec-error payloads of the pods' containers, in the reference
    walk's emission order: per pod, per container, LIMITS before REQUESTS
    (``ClusterCapacity.go:279-284``), one entry per failing occurrence.
    The store's incremental rows use it; the columnar packer replays the
    same payloads through its interned-quad vocabulary.
    """
    errs: list[str] = []
    for pod in pods:
        for c in pod.get("containers", []):
            res = c.get("resources", {})
            req = res.get("requests", {})
            lim = res.get("limits", {})
            for s in (lim.get("cpu", "0"), req.get("cpu", "0")):
                p = _q.cpu_parse_error_payload(s)
                if p is not None:
                    errs.append(p)
    return errs


def _walk_pods_reference(pods):
    """Reference-mode pod walk: returns ``(interned, name_gid, pod_gids,
    c_gids, c_codes)`` — the insertion-ordered quad→code dict, the
    nodeName→group dict, and the per-pod / per-container index vectors.

    Runs the native C walk when available (the same dict operations at C
    speed), and the pure-Python loop otherwise or whenever the native walk
    reports input that is not JSON-shaped (``None``), so malformed
    fixtures raise exactly the pure loop's exceptions.
    """
    if _ingest.available():
        out = _ingest.walk_reference(pods, _oracle._EXCLUDED_PHASES)
        if out is not None:
            _count_native_walk("reference")
            name_gid, interned, pg, cg, cc = out
            return (
                interned,
                name_gid,
                np.frombuffer(pg, dtype=np.int64),
                np.frombuffer(cg, dtype=np.int64),
                np.frombuffer(cc, dtype=np.int64),
            )
    interned: dict = {}  # quad tuple -> code; keys in insertion order
    name_gid: dict[str, int] = {}
    pod_gids: list[int] = []  # per surviving pod: its name group
    c_gids: list[int] = []  # per container: its pod's name group
    c_codes: list[int] = []  # per container: its quad code
    for pod in pods:
        if not _oracle._survives_field_selector(pod):
            continue
        gid = name_gid.setdefault(pod.get("nodeName", ""), len(name_gid))
        pod_gids.append(gid)
        for c in pod.get("containers", []):
            res = c.get("resources", {})
            req, lim = res.get("requests", {}), res.get("limits", {})
            quad = (
                req.get("cpu", "0"),
                lim.get("cpu", "0"),
                req.get("memory"),
                lim.get("memory"),
            )
            c_gids.append(gid)
            c_codes.append(interned.setdefault(quad, len(interned)))
    return interned, name_gid, pod_gids, c_gids, c_codes


def _pack_strict(
    fixture: dict, extended_resources: tuple[str, ...]
) -> ClusterSnapshot:
    """Correct-mode packing: real quantity grammar, scheduler-rule pod usage."""
    raw_nodes = fixture.get("nodes", [])
    n = len(raw_nodes)
    snap = _empty_arrays(n)
    ext = {
        r: (np.zeros(n, dtype=np.int64), np.zeros(n, dtype=np.int64))
        for r in extended_resources
    }
    names, labels, taints = [], [], []
    index = {}
    # Each distinct allocatable tuple parses once into a LUT row; nodes
    # gather their row.
    node_keys: dict = {}
    node_codes: list[int] = []
    healthy_list: list[bool] = []
    for i, raw in enumerate(raw_nodes):
        name = raw.get("name", "")
        names.append(name)
        index[name] = i
        labels.append(raw.get("labels", {}))
        taints.append(raw.get("taints", []))
        allocatable = raw.get("allocatable", {})
        key = (
            allocatable.get("cpu"),
            allocatable.get("memory"),
            allocatable.get("pods"),
            *(allocatable.get(r) for r in extended_resources),
        )
        node_codes.append(node_keys.setdefault(key, len(node_keys)))
        healthy_list.append(_strict_healthy(raw.get("conditions", [])))
    if n:
        n_cols = 3 + len(extended_resources)
        node_lut = np.empty((len(node_keys), n_cols), dtype=np.int64)
        for key, code in node_keys.items():
            node_lut[code, 0] = _strict_parse(key[0], milli=True)
            for k in range(1, n_cols):
                node_lut[code, k] = _strict_parse(key[k])
        codes = np.asarray(node_codes, dtype=np.int64)
        snap["alloc_cpu_milli"] = node_lut[codes, 0]
        snap["alloc_mem_bytes"] = node_lut[codes, 1]
        snap["alloc_pods"] = node_lut[codes, 2]
        snap["healthy"] = np.asarray(healthy_list, dtype=np.bool_)
        for e, r in enumerate(extended_resources):
            ext[r] = (node_lut[codes, 3 + e], ext[r][1])

    # Columnar pod ingestion: one walk interns each container's quantity
    # strings as ONE tuple key; each distinct tuple parses once into
    # per-column LUTs, and the per-pod sums, init-container peaks, the
    # scheduler's ``max(sum, init_peak)`` rule and the per-node totals are
    # numpy gathers/scatters.
    interned, pod_nodes, c_pod, c_codes, i_pod, i_codes = _walk_pods_strict(
        fixture.get("pods", []), index, extended_resources
    )

    p = len(pod_nodes)
    if p:
        n_cols = 4 + len(extended_resources)
        lut = np.empty((n_cols, len(interned)), dtype=np.int64)
        for qi, quad in enumerate(interned):
            lut[0, qi] = _strict_parse(quad[0], milli=True)
            lut[1, qi] = _strict_parse(quad[1], milli=True)
            for k in range(2, n_cols):
                lut[k, qi] = _strict_parse(quad[k])
        idx = np.asarray(pod_nodes, dtype=np.int64)
        np.add.at(snap["pods_count"], idx, 1)
        cp = np.asarray(c_pod, dtype=np.int64)
        cc = np.asarray(c_codes, dtype=np.int64)
        ip = np.asarray(i_pod, dtype=np.int64)
        ic = np.asarray(i_codes, dtype=np.int64)
        i64min = np.iinfo(np.int64).min

        def effective(row: int) -> np.ndarray:
            """Per-pod ``max(sum(containers), max(initContainers))``."""
            acc = np.zeros(p, dtype=np.int64)
            np.add.at(acc, cp, lut[row][cc])
            if ip.size:
                # Peak starts at int64 min so untouched pods keep their
                # plain sum even for (degenerate) negative quantities.
                peak = np.full(p, i64min, dtype=np.int64)
                np.maximum.at(peak, ip, lut[row][ic])
                acc = np.where(peak != i64min, np.maximum(acc, peak), acc)
            return acc

        for row, name in enumerate(
            ("used_cpu_req_milli", "used_cpu_lim_milli",
             "used_mem_req_bytes", "used_mem_lim_bytes")
        ):
            np.add.at(snap[name], idx, effective(row))
        for e, r_name in enumerate(extended_resources):
            np.add.at(ext[r_name][1], idx, effective(4 + e))

    return ClusterSnapshot(
        names=names,
        semantics="strict",
        extended=ext,
        labels=labels,
        taints=taints,
        **snap,
    )


def _walk_pods_strict(pods, index, extended_resources):
    """Strict-mode pod walk (containers + initContainers): returns
    ``(interned, pod_nodes, c_pod, c_codes, i_pod, i_codes)``.  The native
    C walk when available, the pure-Python loop otherwise or on input that
    is not JSON-shaped — see :func:`_walk_pods_reference`."""
    if _ingest.available():
        out = _ingest.walk_strict(
            pods, index, _STRICT_TERMINATED, tuple(extended_resources)
        )
        if out is not None:
            _count_native_walk("strict")
            interned, pn, cp, cc, ip, ic = out
            return (
                interned,
                np.frombuffer(pn, dtype=np.int64),
                np.frombuffer(cp, dtype=np.int64),
                np.frombuffer(cc, dtype=np.int64),
                np.frombuffer(ip, dtype=np.int64),
                np.frombuffer(ic, dtype=np.int64),
            )
    interned: dict = {}  # quad tuple -> code; keys in insertion order
    pod_nodes: list[int] = []
    c_pod: list[int] = []  # container -> pod ordinal
    c_codes: list[int] = []  # container -> quad code
    i_pod: list[int] = []
    i_codes: list[int] = []
    for pod in pods:
        node_name = pod.get("nodeName", "")
        if not node_name or node_name not in index:
            continue
        if pod.get("phase") in _STRICT_TERMINATED:
            continue
        pid = len(pod_nodes)
        pod_nodes.append(index[node_name])
        for kind_pod, kind_codes, key in (
            (c_pod, c_codes, "containers"),
            (i_pod, i_codes, "initContainers"),
        ):
            for c in pod.get(key, []):
                res = c.get("resources", {})
                req, lim = res.get("requests", {}), res.get("limits", {})
                quad = (
                    req.get("cpu"),
                    lim.get("cpu"),
                    req.get("memory"),
                    lim.get("memory"),
                    *(req.get(r) for r in extended_resources),
                )
                kind_pod.append(pid)
                kind_codes.append(
                    interned.setdefault(quad, len(interned))
                )
    return interned, pod_nodes, c_pod, c_codes, i_pod, i_codes


def _effective_pod_resources(
    pod: dict, extended_resources: tuple[str, ...]
) -> dict:
    """Scheduler-rule effective requests: ``max(sum(containers), max(inits))``.

    The reference ignores init containers entirely (Q7); real kube-scheduler
    reserves the max of the init-container peak and the steady-state sum.
    The single-pod path of the store's watch-event updates.
    """
    cpu_req = cpu_lim = mem_req = mem_lim = 0
    ext = dict.fromkeys(extended_resources, 0)
    for c in pod.get("containers", []):
        res = c.get("resources", {})
        req, lim = res.get("requests", {}), res.get("limits", {})
        cpu_req += _strict_parse(req.get("cpu"), milli=True)
        cpu_lim += _strict_parse(lim.get("cpu"), milli=True)
        mem_req += _strict_parse(req.get("memory"))
        mem_lim += _strict_parse(lim.get("memory"))
        for r in extended_resources:
            ext[r] += _strict_parse(req.get(r))
    for c in pod.get("initContainers", []):
        res = c.get("resources", {})
        req, lim = res.get("requests", {}), res.get("limits", {})
        cpu_req = max(cpu_req, _strict_parse(req.get("cpu"), milli=True))
        cpu_lim = max(cpu_lim, _strict_parse(lim.get("cpu"), milli=True))
        mem_req = max(mem_req, _strict_parse(req.get("memory")))
        mem_lim = max(mem_lim, _strict_parse(lim.get("memory")))
        for r in extended_resources:
            ext[r] = max(ext[r], _strict_parse(req.get(r)))
    return {
        "cpu_req": cpu_req,
        "cpu_lim": cpu_lim,
        "mem_req": mem_req,
        "mem_lim": mem_lim,
        "ext": ext,
    }


def _strict_healthy(conditions: list[dict]) -> bool:
    """Correct health predicate: Ready is True, no pressure condition is True."""
    ready = False
    for c in conditions:
        ctype, status = c.get("type", ""), c.get("status", "")
        if ctype == "Ready":
            ready = status == "True"
        elif status == "True":  # any pressure/problem condition firing
            return False
    return ready


@functools.lru_cache(maxsize=1 << 16)
def _strict_parse(s: str | None, *, milli: bool = False) -> int:
    """Strict-grammar parse with absent/invalid → 0; memoized (quantity
    strings repeat across a cluster)."""
    if s is None:
        return 0
    try:
        q = _q.parse_quantity(s)
    except _q.QuantityParseError:
        return 0
    return q.milli_value() if milli else q.value()


def _clamp_i64(u: int) -> int:
    """Reinterpret a Go uint64 as int64 (the snapshot's array dtype)."""
    u %= 1 << 64
    return u - (1 << 64) if u >= 1 << 63 else u


def _empty_arrays(n: int) -> dict:
    out = {f: np.zeros(n, dtype=np.int64) for f in COLUMNS}
    out["healthy"] = np.zeros(n, dtype=np.bool_)
    return out


def synthetic_snapshot(
    n_nodes: int,
    *,
    seed: int = 0,
    mean_utilization: float = 0.4,
    alloc_pods: int = 110,
    kib_quantized: bool = True,
    shapes: int | None = None,
    topology: tuple[int, int] | None = None,
) -> ClusterSnapshot:
    """Array-level synthetic cluster, drawn in O(N) with numpy.

    The same seed draws the same snapshot as the JAX package.  With
    ``kib_quantized=True`` every memory value is a multiple of 1024 (what
    kubelets report), so the fused int32 KiB-rescaled kernel stays
    eligible.  ``shapes=K`` draws only K distinct rows and assigns every
    node one of them — the degenerate-fleet profile
    :meth:`ClusterSnapshot.grouped` compresses.

    ``topology=(zones, racks_per_zone)`` attaches a zone/rack/host
    hierarchy as dense code columns (round-robin racks, nested zones,
    unique hosts) through :func:`~.topology.model.attach_topology`: no
    per-node label dicts are built, so hierarchical 1M-node fleets stay
    O(N) numpy.
    """
    rng = np.random.default_rng(seed)
    n_draw = n_nodes if shapes is None else int(shapes)
    cores = rng.choice(np.array([2, 4, 8, 16, 32, 64]), size=n_draw)
    alloc_cpu = cores.astype(np.int64) * 1000
    mem_kib = cores.astype(np.int64) * 4 * 1024 * 1024 - rng.integers(
        0, 2**18, size=n_draw
    )
    alloc_mem = mem_kib * 1024
    if not kib_quantized:
        alloc_mem += rng.integers(0, 1024, size=n_draw)

    util_cpu = rng.beta(2, 3, size=n_draw) * 2 * mean_utilization
    util_mem = rng.beta(2, 3, size=n_draw) * 2 * mean_utilization
    used_cpu = (alloc_cpu * util_cpu).astype(np.int64)
    used_mem_kib = (mem_kib * util_mem).astype(np.int64)
    used_mem = used_mem_kib * 1024
    if not kib_quantized:
        used_mem += rng.integers(0, 1024, size=n_draw)
    pods = rng.integers(0, 60, size=n_draw).astype(np.int64)

    if shapes is not None:
        assign = rng.integers(0, n_draw, size=n_nodes)
        alloc_cpu = alloc_cpu[assign]
        alloc_mem = alloc_mem[assign]
        used_cpu = used_cpu[assign]
        used_mem = used_mem[assign]
        pods = pods[assign]

    snap = ClusterSnapshot(
        names=[f"node-{i:05d}" for i in range(n_nodes)],
        alloc_cpu_milli=alloc_cpu,
        alloc_mem_bytes=alloc_mem,
        alloc_pods=np.full(n_nodes, alloc_pods, dtype=np.int64),
        used_cpu_req_milli=used_cpu,
        used_cpu_lim_milli=used_cpu * 2,
        used_mem_req_bytes=used_mem,
        used_mem_lim_bytes=used_mem * 2,
        pods_count=pods,
        healthy=np.ones(n_nodes, dtype=np.bool_),
        semantics="reference",
    )
    if topology is not None:
        from kubernetesclustercapacity_tpu_torch.topology.model import (
            attach_topology,
        )

        t_zones, racks_per = topology
        if t_zones < 1 or racks_per < 1:
            raise ValueError(
                f"topology wants (zones >= 1, racks_per_zone >= 1), "
                f"got {topology!r}"
            )
        rack_code = np.arange(n_nodes, dtype=np.int64) % (
            t_zones * racks_per
        )
        attach_topology(snap, rack_code // racks_per, rack_code)
    return snap


def snapshot_from_live_cluster(
    kubeconfig: str | None = None,
    *,
    semantics: str = "strict",
    extended_resources: tuple[str, ...] = (),
) -> ClusterSnapshot:
    """Snapshot a live cluster: two paginated List calls (nodes and pods,
    plus the optional PodDisruptionBudgets), then local packing — the
    reference's ``1 + 2N + ΣP`` requests become three (SURVEY.md §3.4).

    Uses the optional ``kubernetes`` package when it is installed (for its
    wider auth-provider support), else the port's own stdlib client
    (:mod:`.kubeapi`, PyYAML for the kubeconfig file).
    ``extended_resources`` names extra columns to pack (strict only).
    """
    try:
        from kubernetes import client, config  # type: ignore[import-not-found]
    except ImportError:
        from kubernetesclustercapacity_tpu_torch.kubeapi import live_fixture

        return snapshot_from_fixture(
            live_fixture(kubeconfig),
            semantics=semantics,
            extended_resources=extended_resources,
        )

    config.load_kube_config(config_file=kubeconfig)  # pragma: no cover
    v1 = client.CoreV1Api()  # pragma: no cover

    def paginate(list_fn):  # pragma: no cover
        token = None
        while True:
            page = list_fn(limit=500, _continue=token)
            yield from page.items
            token = page.metadata._continue
            if not token:
                return

    def serialize_containers(containers):  # pragma: no cover
        out = []
        for c in containers or []:
            res = c.resources
            out.append(
                {
                    "resources": {
                        "requests": dict(res.requests or {}) if res else {},
                        "limits": dict(res.limits or {}) if res else {},
                    }
                }
            )
        return out

    fixture: dict = {"nodes": [], "pods": []}  # pragma: no cover
    for n in paginate(v1.list_node):  # pragma: no cover
        fixture["nodes"].append(
            {
                "name": n.metadata.name,
                "allocatable": dict(n.status.allocatable or {}),
                "conditions": [
                    {"type": c.type, "status": c.status}
                    for c in (n.status.conditions or [])
                ],
                "labels": dict(n.metadata.labels or {}),
                "taints": [
                    {"key": t.key, "value": t.value or "", "effect": t.effect}
                    for t in (n.spec.taints or [])
                ],
            }
        )
    for p in paginate(v1.list_pod_for_all_namespaces):  # pragma: no cover
        fixture["pods"].append(
            {
                "name": p.metadata.name,
                "namespace": p.metadata.namespace,
                "nodeName": p.spec.node_name or "",
                "phase": p.status.phase,
                "containers": serialize_containers(p.spec.containers),
                "initContainers": serialize_containers(p.spec.init_containers),
            }
        )
    return snapshot_from_fixture(  # pragma: no cover
        fixture, semantics=semantics, extended_resources=extended_resources
    )
