"""Topology model (zone/rack/host hierarchy) on the node axis.

Counterpart of ``kubernetesclustercapacity_tpu/topology/model.py``, host
numpy throughout and verbatim apart from this docstring.  The snapshot's
node labels carry a physical hierarchy — zone, rack, host — which this
module parses into dense small-int **code columns** on the node axis
(``codes[n]`` = the node's domain index at one level, ``-1`` = excluded),
the form every gang program of :mod:`.gang` consumes as a
segmented-reduction index.

Three levels, finest first — :data:`LEVELS` ``("host", "rack", "zone")``
— read from configurable label keys (:class:`TopologyKeys`; defaults are
the upstream well-known keys).  Domains NEST: a rack domain is keyed by
its ``(zone label, rack label)`` pair and a host domain by the full
triple, so ``rack=r0`` in two different zones is two domains (the
hierarchy stays a tree even when label values repeat across parents).

Missing labels are an explicit policy, never a silent default
(:func:`label_codes` ``missing=``):

* ``"own"`` (the topology-model default) — an unlabeled node forms its
  own singleton domain (named ``~node:<row>``): it still holds ranks,
  it just shares a domain with nobody.
* ``"exclude"`` — an unlabeled node gets code ``-1``: it belongs to no
  domain and contributes nothing to any domain-level capacity.  This is
  the policy :meth:`~..models.capacity.CapacityModel.topology_spread`
  applies to unkeyed nodes (they are counted and reported, never
  summed), routed through the same helper so the two surfaces cannot
  drift.

:func:`node_name_index` (the name→row map the anti-affinity mask's
hostname topology uses) lives here too, so ``masks.py`` and the gang
model resolve node identity through the same rule.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "LEVELS",
    "DEFAULT_ZONE_KEY",
    "DEFAULT_RACK_KEY",
    "DEFAULT_HOST_KEY",
    "TopologyKeys",
    "ClusterTopology",
    "label_codes",
    "node_name_index",
    "topology_from_snapshot",
    "attach_topology",
]

#: Hierarchy levels, finest first.  ``None`` (no level) means
#: cluster-wide in every consumer.
LEVELS = ("host", "rack", "zone")

#: Position in the hierarchy (0 = finest).  Shared by GangSpec
#: validation ("spread level must be strictly finer than the
#: co-location level") and the explain surface's level ordering.
LEVEL_ORDER = {level: i for i, level in enumerate(LEVELS)}

DEFAULT_ZONE_KEY = "topology.kubernetes.io/zone"
DEFAULT_RACK_KEY = "topology.kubernetes.io/rack"
DEFAULT_HOST_KEY = "kubernetes.io/hostname"

_MISSING_POLICIES = ("own", "exclude")


@dataclass(frozen=True)
class TopologyKeys:
    """The node-label keys the hierarchy parses from (configurable —
    clouds that label racks as ``failure-domain.beta...`` or zones under
    the legacy key swap them here, nothing downstream changes)."""

    zone: str = DEFAULT_ZONE_KEY
    rack: str = DEFAULT_RACK_KEY
    host: str = DEFAULT_HOST_KEY


def label_codes(
    labels,
    key: str,
    *,
    missing: str = "own",
    eligible=None,
    n_nodes: int | None = None,
):
    """THE label→code helper: one level's label values → dense codes.

    Returns ``(codes[N] int64, domains, missing_count)`` — ``domains``
    is the value list in first-eligible-row order (``codes[i]`` indexes
    it), ``missing_count`` how many eligible rows lacked the key.

    ``labels`` is the snapshot's per-node label-dict list (rows beyond
    its length count as unlabeled — fixture-less snapshots carry an
    empty list); ``eligible`` (``[N]`` bool, optional) restricts which
    rows mint domains at all — an ineligible row keeps code ``-1`` and
    is NOT counted as missing, exactly the membership rule
    ``CapacityModel.topology_spread`` has always applied.  ``missing``
    picks the unlabeled-row policy documented in the module docstring.
    """
    if missing not in _MISSING_POLICIES:
        raise ValueError(
            f"missing-label policy must be one of {_MISSING_POLICIES}, "
            f"got {missing!r}"
        )
    n = len(labels) if n_nodes is None else int(n_nodes)
    codes = np.full(n, -1, dtype=np.int64)
    domains: list = []
    ids: dict = {}
    missing_count = 0
    for i in range(n):
        if eligible is not None and not eligible[i]:
            continue
        row = labels[i] if i < len(labels) else None
        value = (row or {}).get(key)
        if value is None:
            missing_count += 1
            if missing == "own":
                codes[i] = len(domains)
                domains.append(f"~node:{i}")
            continue
        code = ids.get(value)
        if code is None:
            code = ids[value] = len(domains)
            domains.append(value)
        codes[i] = code
    return codes, domains, missing_count


def node_name_index(snapshot) -> dict[str, int]:
    """Node name → row index — the hostname-identity rule shared by the
    anti-affinity mask's hostname topology and the topology model.

    Duplicate names keep the LAST row (dict-comprehension semantics,
    pinned by tests: the pre-topology ``masks.py`` behaved this way and
    reference-mode phantom rows all share the ``""`` key); a pod naming
    a node outside this map is excluded from hostname-topology effects.
    """
    return {name: i for i, name in enumerate(snapshot.names)}


@dataclass
class ClusterTopology:
    """Dense topology-code columns for one snapshot.

    ``codes(level)`` is the ``[N]`` int64 domain index at that level
    (``-1`` = excluded under the ``"exclude"`` policy);
    ``domains(level)`` the human names, indexable by code.  Codes NEST:
    :meth:`parent_map` gives the sub-domain→parent-domain gather (every
    host lies in exactly one rack, every rack in exactly one zone) the
    spread kernels segment over.
    """

    keys: TopologyKeys
    missing: str
    host_code: np.ndarray
    rack_code: np.ndarray
    zone_code: np.ndarray
    host_domains: list = field(default_factory=list)
    rack_domains: list = field(default_factory=list)
    zone_domains: list = field(default_factory=list)
    missing_labels: dict = field(default_factory=dict)

    @property
    def n_nodes(self) -> int:
        return int(self.host_code.shape[0])

    def codes(self, level: str) -> np.ndarray:
        self._check_level(level)
        return getattr(self, f"{level}_code")

    def domains(self, level: str) -> list:
        self._check_level(level)
        return getattr(self, f"{level}_domains")

    def n_domains(self, level: str) -> int:
        return len(self.domains(level))

    @staticmethod
    def _check_level(level: str) -> None:
        if level not in LEVELS:
            raise ValueError(
                f"unknown topology level {level!r} (want one of {LEVELS})"
            )

    @property
    def host_singleton(self) -> bool:
        """True iff every host domain holds exactly one node — the
        common unique-hostname fleet, where host-level domain capacity
        IS per-node capacity (the grouped gang fast path's guard)."""
        codes = self.host_code
        member = codes >= 0
        return len(self.host_domains) == int(member.sum())

    def parent_map(self, sub: str, parent: str) -> np.ndarray:
        """``[n_domains(sub)]`` int64: each sub-domain's parent-domain
        code (``-1`` when the sub-domain's nodes are parent-excluded).
        Well-defined because domains nest by construction."""
        if LEVEL_ORDER[sub] >= LEVEL_ORDER[parent]:
            raise ValueError(
                f"{sub!r} is not strictly finer than {parent!r}"
            )
        sub_codes = self.codes(sub)
        parent_codes = self.codes(parent)
        out = np.full(len(self.domains(sub)), -1, dtype=np.int64)
        member = sub_codes >= 0
        out[sub_codes[member]] = parent_codes[member]
        return out


def _nested_codes(labels, key, parent_eff, *, missing, n):
    """Codes for one level, keyed by ``(parent domain, own label)`` so
    equal label values under different parents stay distinct domains."""
    codes = np.full(n, -1, dtype=np.int64)
    domains: list[str] = []
    ids: dict = {}
    missing_count = 0
    for i in range(n):
        row = labels[i] if i < len(labels) else None
        value = (row or {}).get(key)
        if value is None:
            missing_count += 1
            if missing == "own":
                codes[i] = len(domains)
                domains.append(f"~node:{i}")
            continue
        nested = (parent_eff[i], value)
        code = ids.get(nested)
        if code is None:
            code = ids[nested] = len(domains)
            domains.append(value if parent_eff[i] is None
                           else f"{parent_eff[i]}/{value}")
        codes[i] = code
    return codes, domains, missing_count


def topology_from_snapshot(
    snapshot,
    *,
    keys: TopologyKeys | None = None,
    missing: str = "own",
) -> ClusterTopology:
    """Parse the snapshot's labels into a :class:`ClusterTopology`.

    Memoized per ``(keys, missing)`` on the (immutable) snapshot — the
    label walk is O(N) Python and every gang/watch evaluation of one
    generation reuses it.  Array-built snapshots with no labels still
    work: every level falls to the missing policy (``"own"`` makes each
    node a singleton at every level — gang co-location then degenerates
    to per-node arithmetic, explicitly, not wrongly).  A pre-attached
    topology (:func:`attach_topology` — the synthetic 1M-node path)
    short-circuits the walk entirely.
    """
    if missing not in _MISSING_POLICIES:
        raise ValueError(
            f"missing-label policy must be one of {_MISSING_POLICIES}, "
            f"got {missing!r}"
        )
    keys = keys or TopologyKeys()
    cache = snapshot.__dict__.setdefault("_topology_cache", {})
    cache_key = (keys, missing)
    hit = cache.get(cache_key)
    if hit is not None:
        return hit
    n = snapshot.n_nodes
    labels = snapshot.labels or []

    zone_code, zone_domains, zone_missing = label_codes(
        labels, keys.zone, missing=missing, n_nodes=n
    )
    # Effective parent tag per node for nesting (None = no zone and the
    # exclude policy — nested values then group under a shared "no
    # parent" bucket, which the policy already excluded anyway).
    zone_eff = [
        zone_domains[int(c)] if c >= 0 else None for c in zone_code
    ]
    rack_code, rack_domains, rack_missing = _nested_codes(
        labels, keys.rack, zone_eff, missing=missing, n=n
    )
    rack_eff = [
        rack_domains[int(c)] if c >= 0 else None for c in rack_code
    ]
    host_code, host_domains, host_missing = _nested_codes(
        labels, keys.host, rack_eff, missing=missing, n=n
    )
    topo = ClusterTopology(
        keys=keys,
        missing=missing,
        host_code=host_code,
        rack_code=rack_code,
        zone_code=zone_code,
        host_domains=host_domains,
        rack_domains=rack_domains,
        zone_domains=zone_domains,
        missing_labels={
            "host": host_missing,
            "rack": rack_missing,
            "zone": zone_missing,
        },
    )
    cache[cache_key] = topo
    return topo


def attach_topology(
    snapshot,
    zone_code,
    rack_code,
    *,
    keys: TopologyKeys | None = None,
    missing: str = "own",
) -> ClusterTopology:
    """Attach precomputed zone/rack codes to a snapshot (the array-level
    synthetic path: a 1M-node fleet's hierarchy is generated as numpy
    columns, never as 1M label dicts walked back into columns).

    Host codes are the identity (every node its own host — the unique-
    hostname fleet).  Rack codes must already nest (a rack code maps to
    exactly one zone code); violated nesting raises rather than
    producing a silently-wrong hierarchy.  The result lands in the same
    memo :func:`topology_from_snapshot` reads, under the same key.
    """
    n = snapshot.n_nodes
    zone_code = np.asarray(zone_code, dtype=np.int64)
    rack_code = np.asarray(rack_code, dtype=np.int64)
    if zone_code.shape != (n,) or rack_code.shape != (n,):
        raise ValueError(
            f"topology codes must be shape ({n},), got "
            f"{zone_code.shape}/{rack_code.shape}"
        )
    n_zones = int(zone_code.max()) + 1 if n else 0
    n_racks = int(rack_code.max()) + 1 if n else 0
    if n and (zone_code.min() < 0 or rack_code.min() < 0):
        raise ValueError("attached topology codes must be >= 0")
    # Nesting check: each rack code maps to exactly one zone code.
    parent = np.full(n_racks, -1, dtype=np.int64)
    parent[rack_code] = zone_code
    if n and not (parent[rack_code] == zone_code).all():
        raise ValueError(
            "rack codes do not nest inside zone codes (a rack spans "
            "two zones) — build nested codes, the hierarchy is a tree"
        )
    topo = ClusterTopology(
        keys=keys or TopologyKeys(),
        missing=missing,
        host_code=np.arange(n, dtype=np.int64),
        rack_code=rack_code,
        zone_code=zone_code,
        host_domains=list(snapshot.names),
        rack_domains=[f"rack-{r}" for r in range(n_racks)],
        zone_domains=[f"zone-{z}" for z in range(n_zones)],
        missing_labels={"host": 0, "rack": 0, "zone": 0},
    )
    cache = snapshot.__dict__.setdefault("_topology_cache", {})
    cache[(topo.keys, missing)] = topo
    return topo
