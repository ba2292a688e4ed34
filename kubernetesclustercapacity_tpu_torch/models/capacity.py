"""The capacity model: one object answering "will it schedule?".

Counterpart of ``kubernetesclustercapacity_tpu/models/capacity.py``
(``PodSpec``, the result classes and ``CapacityModel``).
:class:`CapacityModel` composes the layers below it — snapshot columns,
constraint masks and the device programs.  A :class:`PodSpec` describes
the what-if pod (resources AND scheduling constraints, everything the
reference's six flags could not express); ``evaluate`` answers one spec on
the exact int64 program, ``sweep`` a grid through
:func:`..ops.fused_fit.sweep_auto` (kernel B1 when eligible) and
``sweep_multi`` an R-resource grid through
:func:`..ops.fused_multi.sweep_multi_auto` (kernel B2 when eligible).
The scheduler-fidelity surface answers what comes after "how many":
``place`` (where each replica lands, :mod:`..ops.placement`), ``drain``
(can a node's pods be rehomed, with the disruption-budget gate),
``topology_spread`` (capacity under a maxSkew constraint),
``nodes_needed`` (how many template nodes to add) and, with
``PodSpec.priority`` or ``sweep_preemption``, preemption-aware capacity
(:mod:`..ops.preemption`).

The reference equivalent is the whole of ``main`` (``ClusterCapacity.go:
48-150``) minus flag parsing and printing; the constraint families have no
reference equivalent.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

import torch

from kubernetesclustercapacity_tpu_torch import devcache as _devcache
from kubernetesclustercapacity_tpu_torch import masks as _masks
from kubernetesclustercapacity_tpu_torch.ops import placement as _placement
from kubernetesclustercapacity_tpu_torch.ops import preemption as _preemption
from kubernetesclustercapacity_tpu_torch.ops.fit import (
    fit_snapshot,
    sweep_grid,
    sweep_grid_multi_staged,
)
from kubernetesclustercapacity_tpu_torch.ops.fused_fit import sweep_auto
from kubernetesclustercapacity_tpu_torch.ops.fused_multi import (
    sweep_multi_auto,
)
from kubernetesclustercapacity_tpu_torch.scenario import (
    MultiResourceGrid,
    Scenario,
    ScenarioGrid,
)
from kubernetesclustercapacity_tpu_torch.snapshot import (
    _STRICT_TERMINATED,
    ClusterSnapshot,
    _effective_pod_resources,
    _strict_parse,
    snapshot_from_fixture,
)
from kubernetesclustercapacity_tpu_torch.topology.model import label_codes
from kubernetesclustercapacity_tpu_torch.utils.quantity import int64_bits

__all__ = [
    "PodSpec",
    "CapacityModel",
    "CapacityPlan",
    "CapacityResult",
    "DrainResult",
    "PlacementResult",
    "TopologySpreadResult",
]


@dataclass(frozen=True)
class PodSpec:
    """A what-if pod: resources plus the scheduling constraints it carries.

    ``extended_requests`` maps extra resource names (which must exist in
    the snapshot's ``extended`` columns) to per-replica requests.
    Constraint fields mirror the pod-spec fields kube-scheduler filters on;
    all are optional and default to unconstrained.  ``spread`` caps
    replicas per node (self-anti-affinity over the hostname topology; 1 is
    one-per-node spread, ``None`` unlimited; must be >= 1 when set).

    ``priority`` (``None`` = no preemption) makes capacity
    preemption-aware: existing pods of strictly lower priority count as
    evictable, so only pods with ``priority >= this`` consume headroom
    (:mod:`..ops.preemption`, the kube-scheduler preemption upper bound).
    Strict semantics only; needs the model's ``fixture`` (pod priorities
    are not part of the snapshot columns).
    """

    cpu_request_milli: int
    mem_request_bytes: int
    replicas: int = 1
    cpu_limit_milli: int = 0
    mem_limit_bytes: int = 0
    extended_requests: dict[str, int] = field(default_factory=dict)
    tolerations: tuple = ()
    node_selector: dict = field(default_factory=dict)
    affinity_terms: tuple = ()
    anti_affinity_labels: dict = field(default_factory=dict)
    # Scopes anti_affinity_labels the way a PodAffinityTerm with no
    # namespaces field is scoped: to the incoming pod's own namespace.
    # None = match existing pods cluster-wide.
    namespace: str | None = None
    spread: int | None = None
    priority: int | None = None

    def __post_init__(self) -> None:
        # CPU values may arrive as raw uint64 (the reference codec wraps
        # negatives mod 2^64, e.g. "-5" → 2^64−5000); normalize to the
        # int64 bit pattern every tensor and numpy array carries, here, so
        # no consumer can feed an out-of-int64 Python int to a conversion.
        object.__setattr__(
            self, "cpu_request_milli", int64_bits(self.cpu_request_milli)
        )
        object.__setattr__(
            self, "cpu_limit_milli", int64_bits(self.cpu_limit_milli)
        )
        if self.namespace is not None and not isinstance(self.namespace, str):
            # A non-string namespace would compare unequal to every
            # existing pod's namespace and silently disable the scoping.
            raise ValueError(
                f"namespace must be a string, got "
                f"{type(self.namespace).__name__}"
            )
        if self.replicas < 0:
            raise ValueError(
                "replicas must be >= 0 for PodSpec surfaces (the reference"
                "-parity negative-replicas verdict is a Scenario/fit-path "
                "behavior)"
            )
        if self.spread is not None and self.spread < 1:
            raise ValueError("spread must be >= 1 (or None for unlimited)")
        if self.priority is not None and not isinstance(self.priority, int):
            # A non-int priority would compare incoherently against the
            # table's int64 levels (bool is fine: it IS an int).
            raise ValueError(
                f"priority must be an int, got "
                f"{type(self.priority).__name__}"
            )
        for name, qty in self.extended_requests.items():
            if name in ("cpu", "memory"):
                # These alias the core columns: resource_matrix would build
                # a duplicate row and constrain the resource twice.
                raise ValueError(
                    f"extended request {name!r} aliases a core resource — "
                    "use cpu_request_milli / mem_request_bytes"
                )
            # Zero means "does not consume"; a negative request has no
            # coherent semantics, so it is refused at the spec.
            if int(qty) < 0:
                raise ValueError(
                    f"extended request {name!r} must be >= 0, got {qty}"
                )

    @classmethod
    def from_scenario(cls, s: Scenario) -> "PodSpec":
        return cls(
            cpu_request_milli=s.cpu_request_milli,
            mem_request_bytes=s.mem_request_bytes,
            replicas=s.replicas,
            cpu_limit_milli=s.cpu_limit_milli,
            mem_limit_bytes=s.mem_limit_bytes,
        )

    @property
    def constrained(self) -> bool:
        return bool(
            self.tolerations
            or self.node_selector
            or self.affinity_terms
            or self.anti_affinity_labels
            or self.spread is not None
        )


@dataclass
class PlacementResult:
    """Outcome of a placement simulation: node assignment per replica.

    ``assignments`` is ``None`` when the counts-only bulk engine answered
    (per-replica order not requested): ``per_node`` then carries the full
    result — identical counts to what the scan would produce.
    """

    assignments: np.ndarray | None  # [R] node index, -1 = unplaceable
    per_node: np.ndarray  # [N] replicas landed on each node
    node_names: list[str]
    policy: str
    requested: int = 0
    engine: str = "scan"  # "scan" (the device scan), "trace" or "bulk"

    @property
    def placed(self) -> int:
        if self.assignments is None:
            return int(np.sum(self.per_node))
        return int(np.sum(self.assignments >= 0))

    @property
    def all_placed(self) -> bool:
        return self.placed >= self.requested

    def by_node(self) -> dict[str, int]:
        """Non-zero placements keyed by node name."""
        return {
            self.node_names[i]: int(c)
            for i, c in enumerate(self.per_node)
            if c
        }


@dataclass
class DrainResult:
    """Outcome of a drain simulation: a rehoming target per evicted pod.

    ``assignments[i]`` is the node name that takes ``pods[i]`` (placed in
    the order given, size-descending), or ``None`` if no remaining node
    can.  ``blocked`` maps pods whose eviction the disruption-budget
    gate refuses right now to the exhausted PDB names covering them
    (:mod:`..pdb`); ``evictable`` is the drain verdict — every pod has a
    home AND none is budget-blocked.
    """

    node: str
    pods: list[str]  # "namespace/name" keys, in placement order
    assignments: list[str | None]
    per_node: np.ndarray  # [N] rehomed-pod counts (0 at the drained node)
    policy: str
    blocked: dict[str, list[str]] = field(default_factory=dict)

    @property
    def evictable(self) -> bool:
        return not self.blocked and all(
            a is not None for a in self.assignments
        )

    def by_pod(self) -> dict[str, str | None]:
        return dict(zip(self.pods, self.assignments))


@dataclass
class TopologySpreadResult:
    """Capacity under a PodTopologySpreadConstraint (DoNotSchedule).

    ``zones`` maps each eligible topology domain to its raw capacity
    (sum of per-node fits); ``allowed`` to the replicas it may actually
    take under the skew bound — ``min(c_z, min_zone_capacity +
    max_skew)``, the reachable optimum for identical replicas filling
    round-robin.  A domain with zero remaining capacity still anchors
    the global minimum, capping every other domain at ``max_skew`` —
    exactly kube-scheduler's skew arithmetic.  ``unkeyed_nodes`` counts
    eligible nodes missing the topology key (excluded from domains and
    from capacity, the constraint's default node-inclusion behavior).
    """

    topology_key: str
    max_skew: int
    zones: dict[str, int]
    allowed: dict[str, int]
    total: int
    replicas_requested: int
    unkeyed_nodes: int

    @property
    def schedulable(self) -> bool:
        return self.total >= self.replicas_requested


@dataclass
class CapacityPlan:
    """Outcome of a scale-up plan: nodes to add so the spec fits.

    ``nodes_needed`` is ``0`` when current capacity already suffices and
    ``None`` when no count of template nodes can help (the template
    itself fits 0 replicas — wrong shape, untolerated taint, selector
    mismatch, …).
    """

    replicas_requested: int
    current_total: int
    per_node_fit: int  # replicas ONE empty template node takes
    nodes_needed: int | None

    @property
    def satisfiable(self) -> bool:
        return self.nodes_needed is not None


@dataclass
class CapacityResult:
    """Outcome of one evaluation: per-node fits, total, and the verdict."""

    fits: np.ndarray
    total: int
    replicas_requested: int
    mode: str

    @property
    def schedulable(self) -> bool:
        return self.total >= self.replicas_requested  # :144 inclusive >=


class CapacityModel:
    """Evaluate pod specs against one snapshot, with optional constraints.

    ``mode="reference"`` is the bug-compatible 2-resource fit (constraints
    the reference cannot express are refused unless ``allow_extensions``);
    ``mode="strict"`` uses corrected semantics and the full constraint and
    multi-resource surface.  ``fixture`` is only needed for anti-affinity
    against existing pods, for ``drain`` and for preemption (pod labels,
    per-pod requests and priorities are not in the snapshot columns).
    ``priority_table`` seeds the preemption table (a caller that already
    holds the fixture's table skips the fixture walk).  ``device`` is where
    every program runs: ``"cuda"`` by default, which raises without a
    card; ``"cpu"`` runs on the host.
    """

    def __init__(
        self,
        snapshot: ClusterSnapshot,
        *,
        mode: str = "strict",
        fixture: dict | None = None,
        allow_extensions: bool = True,
        priority_table=None,
        device="cuda",
    ) -> None:
        self.snapshot = snapshot
        self.mode = mode
        self.fixture = fixture
        self.allow_extensions = allow_extensions
        self._ptable = priority_table
        self.device = device

    # -- mask assembly -----------------------------------------------------
    def _mask_parts(
        self, spec: PodSpec
    ) -> tuple[np.ndarray | None, np.ndarray | None, np.ndarray | None]:
        """``(taint, node_affinity, pod_anti_affinity)`` masks — split the
        way topology-spread domain discovery needs them: the node-affinity
        family (selector + affinity) filters domains under the default
        ``nodeAffinityPolicy: Honor``, taints by ``node_taints_policy``,
        while inter-pod anti-affinity is a separate predicate that never
        filters domains."""
        snap = self.snapshot
        has_taints = bool(snap.taints) and any(snap.taints)
        taint = None
        if has_taints and (self.mode == "strict" or spec.tolerations):
            taint = _masks.tolerations_mask(snap, list(spec.tolerations))
        affinity_parts = []
        if spec.node_selector:
            affinity_parts.append(
                _masks.node_selector_mask(snap, spec.node_selector)
            )
        if spec.affinity_terms:
            affinity_parts.append(
                _masks.node_affinity_mask(snap, list(spec.affinity_terms))
            )
        anti = None
        if spec.anti_affinity_labels:
            if self.fixture is None:
                raise ValueError(
                    "anti-affinity vs existing pods needs the source fixture "
                    "(pod labels are not part of the dense snapshot)"
                )
            anti = _masks.anti_affinity_existing_mask(
                snap,
                self.fixture,
                spec.anti_affinity_labels,
                namespace=spec.namespace,
            )
        return taint, _masks.combine_masks(*affinity_parts), anti

    def _masks_for(self, spec: PodSpec) -> np.ndarray | None:
        """Mask policy, by mode.

        * ``strict``: the taint mask always applies (a real scheduler never
          places an untolerating pod on a hard-tainted node); the other
          families apply when the spec carries them.
        * ``reference``: the reference ignores constraints, so no mask is
          implicit; carried constraints are an extension and need
          ``allow_extensions`` (:meth:`_check_extensions`).
        """
        return _masks.combine_masks(*self._mask_parts(spec))

    def _require_strict(self, feature: str) -> None:
        """One wording for every strict-only surface's gate."""
        if self.mode != "strict":
            raise ValueError(
                f"{feature} requires strict semantics (the reference "
                "cannot express it)"
            )

    @staticmethod
    def _check_spread_args(max_skew: int, node_taints_policy: str) -> None:
        if max_skew < 1:
            raise ValueError("max_skew must be >= 1")
        if node_taints_policy not in ("ignore", "honor"):
            raise ValueError(
                f"node_taints_policy must be 'ignore' or 'honor', got "
                f"{node_taints_policy!r}"
            )

    def _spread_masks(self, spec: PodSpec, node_taints_policy: str):
        """``(full_mask, domain_mask)`` for the topology-spread family:
        fits always see every family; domain discovery honors the
        node-affinity family, taints by policy, and never inter-pod
        anti-affinity (a separate predicate)."""
        taint_mask, affinity_mask, anti_mask = self._mask_parts(spec)
        full = _masks.combine_masks(taint_mask, affinity_mask, anti_mask)
        domain = (
            affinity_mask
            if node_taints_policy == "ignore"
            else _masks.combine_masks(taint_mask, affinity_mask)
        )
        return full, domain

    def _check_extensions(self, constrained: bool) -> None:
        if (
            constrained
            and self.mode == "reference"
            and not self.allow_extensions
        ):
            raise ValueError(
                "constraints/extended resources are extensions beyond "
                "reference semantics; pass allow_extensions=True"
            )

    # -- preemption (PodSpec.priority) -------------------------------------
    def _priority_table(self):
        """The snapshot's suffix-sum priority table, built once per model
        over ALL extended columns (any spec's subset gathers from it)."""
        if self._ptable is None:
            self._ptable = _preemption.build_priority_table(
                self.fixture,
                self.snapshot,
                tuple(sorted(self.snapshot.extended)),
            )
        return self._ptable

    def _check_preemption(self, spec: PodSpec) -> None:
        if spec.priority is None:
            return
        self._require_strict("preemption-aware capacity (PodSpec.priority)")
        if self.fixture is None:
            raise ValueError(
                "preemption needs the source fixture (pod priorities are "
                "not part of the dense snapshot)"
            )

    def _usage_arrays(self, spec: PodSpec):
        """``(used_cpu, used_mem, pods_count)`` the programs should see:
        the snapshot's own columns, or — when the spec carries a
        ``priority`` — the preemption table's threshold columns (pods of
        strictly lower priority treated as evictable)."""
        snap = self.snapshot
        if spec.priority is None:
            return (
                snap.used_cpu_req_milli,
                snap.used_mem_req_bytes,
                snap.pods_count,
            )
        return self._priority_table().columns(spec.priority)

    def _multi_fit_args(self, spec: PodSpec):
        """The R-resource operands for a spec with extended requests — one
        definition of the row order (``cpu``, ``memory``, then the
        extended names sorted) and the request vector, shared by
        :meth:`evaluate` and :meth:`place`.  With a ``priority`` the usage
        rows come from the preemption table (which refuses a column it
        carries no suffix sums for)."""
        resources = ("cpu", "memory", *sorted(spec.extended_requests))
        alloc_rn, used_rn = self.snapshot.resource_matrix(resources)
        if spec.priority is not None:
            used_rn, _ = self._priority_table().multi_columns(
                spec.priority, resources
            )
        reqs = np.array(
            [
                spec.cpu_request_milli,
                spec.mem_request_bytes,
                *(spec.extended_requests[r] for r in resources[2:]),
            ],
            dtype=np.int64,
        )
        return alloc_rn, used_rn, reqs

    # -- evaluation --------------------------------------------------------
    _MASK_UNSET = object()

    def evaluate(
        self, spec: PodSpec, *, _node_mask=_MASK_UNSET
    ) -> CapacityResult:
        """One spec → per-node fits + verdict.

        The exact 2-resource program (:func:`..ops.fit.fit_per_node`)
        unless the spec requests extended resources, which take the
        R-resource program (:func:`..ops.fit.fit_per_node_multi`); a
        ``priority`` substitutes the preemption table's usage columns.
        Constraint masks and the spread clamp compose around either.
        (``_node_mask``: a caller that already built the spec's mask —
        :meth:`topology_spread` needs its parts — passes it to skip the
        rebuild.)
        """
        snap = self.snapshot
        self._check_extensions(spec.constrained or bool(spec.extended_requests))
        self._check_preemption(spec)
        mask = (
            self._masks_for(spec)
            if _node_mask is self._MASK_UNSET
            else _node_mask
        )
        if not spec.extended_requests:
            if spec.priority is None:
                fits = fit_snapshot(
                    snap,
                    spec.cpu_request_milli,
                    spec.mem_request_bytes,
                    mode=self.mode,
                    node_mask=mask,
                    device=self.device,
                )
            else:
                fits = _preemption.fit_with_preemption(
                    snap,
                    self._priority_table(),
                    spec.cpu_request_milli,
                    spec.mem_request_bytes,
                    spec.priority,
                    mode=self.mode,
                    node_mask=mask,
                    device=self.device,
                )
            if spec.spread is not None:
                fits = np.minimum(fits, spec.spread)
                if mask is not None:  # keep masked nodes at 0 after the clamp
                    fits = np.where(mask, fits, 0)
        else:
            alloc_rn, used_rn, reqs = self._multi_fit_args(spec)
            # cpu/mem usage already rides used_rn; only the pod count
            # needs the (possibly preemption-adjusted) column here.
            fits = sweep_grid_multi_staged(
                alloc_rn,
                used_rn,
                snap.alloc_pods,
                self._usage_arrays(spec)[2],
                snap.healthy,
                reqs[None, :],
                np.array([spec.replicas], dtype=np.int64),
                mode=self.mode,
                node_masks=mask,
                max_per_node=spec.spread,
                return_per_node=True,
                device=self.device,
            )[2][0]
        return CapacityResult(
            fits=fits,
            total=int(fits.sum()),
            replicas_requested=spec.replicas,
            mode=self.mode,
        )

    # Above this replica count, "auto" placement switches from the R-step
    # scan to the closed-form trace engine (the same order, host math) —
    # the scan's R dependent steps are only worth it at small R.
    PLACE_SCAN_MAX = 256

    def place(
        self,
        spec: PodSpec,
        *,
        policy: str = "first-fit",
        assignments: bool | str = "auto",
        topology_key: str | None = None,
        max_skew: int = 1,
        node_taints_policy: str = "ignore",
    ) -> PlacementResult:
        """Simulate WHERE each replica lands under a bin-packing policy.

        The fit programs answer "how many"; this answers "which node gets
        replica k", each placement shrinking the headroom the next one
        sees (:mod:`..ops.placement`).  Strict feasibility semantics;
        constraint masks compose like :meth:`evaluate`; extended
        resources route to the R-resource engines.

        ``assignments`` picks the engine:

        * ``True`` — the scan on the model's device; the result carries
          the per-replica order.
        * ``"trace"`` — the closed-form trace engine
          (:func:`..ops.placement.place_replicas_trace` / ``_trace_multi``):
          the scan's exact order in O(R log R) host math.  Raises for
          degenerate zero-request specs (scan only).
        * ``False`` — the closed-form bulk engine
          (:func:`..ops.placement.place_replicas_bulk`): identical
          per-node counts in O(N); ``result.assignments`` is ``None``.
        * ``"auto"`` (default) — the scan up to :data:`PLACE_SCAN_MAX`
          replicas; beyond that the trace engine when eligible, else the
          scan.

        A spec with ``priority`` places against the preemption-adjusted
        headroom (lower-priority pods treated as already evicted).

        ``topology_key`` adds the PodTopologySpread DoNotSchedule gate:
        every placement is checked against ``max_skew`` over the key's
        domains, with domain discovery per :meth:`topology_spread`'s
        node-inclusion policies.  The skew couples placements globally,
        so only the scan applies; strict semantics, 2-resource specs.
        """
        self._check_extensions(
            spec.constrained or bool(spec.extended_requests)
        )
        self._check_preemption(spec)
        if topology_key is not None:
            return self._place_spread(
                spec,
                policy=policy,
                assignments=assignments,
                topology_key=topology_key,
                max_skew=max_skew,
                node_taints_policy=node_taints_policy,
            )
        if max_skew != 1 or node_taints_policy != "ignore":
            # A caller who set the skew knobs but forgot the key would
            # otherwise run a completely unconstrained placement.
            raise ValueError(
                "max_skew/node_taints_policy need topology_key — without "
                "it the placement has no spread constraint"
            )
        snap = self.snapshot
        mask = self._masks_for(spec)
        kwargs = dict(
            n_replicas=spec.replicas,
            policy=policy,
            node_mask=mask,
            max_per_node=spec.spread,
        )
        if spec.extended_requests:
            alloc_rn, used_rn, reqs = self._multi_fit_args(spec)
            args = (
                alloc_rn, used_rn, snap.alloc_pods,
                self._usage_arrays(spec)[2], snap.healthy, reqs,
            )
            scan_fn = _placement.place_replicas_multi
            bulk_fn = _placement.place_replicas_bulk_multi
            trace_fn = _placement.place_replicas_trace_multi
            # The bulk multi engine needs at least one positive request
            # row (the 2-resource rule generalized).
            bulk_ok = (reqs > 0).any() and (reqs >= 0).all()
        else:
            used_cpu, used_mem, pods_count = self._usage_arrays(spec)
            args = (
                snap.alloc_cpu_milli,
                snap.alloc_mem_bytes,
                snap.alloc_pods,
                used_cpu,
                used_mem,
                pods_count,
                snap.healthy,
                spec.cpu_request_milli,
                spec.mem_request_bytes,
            )
            scan_fn = _placement.place_replicas
            bulk_fn = _placement.place_replicas_bulk
            trace_fn = _placement.place_replicas_trace
            # The closed forms need positive requests; degenerate
            # zero-request specs always take the scan.
            bulk_ok = (
                spec.cpu_request_milli > 0 and spec.mem_request_bytes > 0
            )
        if assignments == "trace":
            if not bulk_ok:
                raise ValueError(
                    "trace engine needs positive cpu AND mem requests "
                    "(or, with extended resources, at least one positive "
                    "request row) — its closed form is proven there; use "
                    "assignments=True (scan) for degenerate specs"
                )
            engine = "trace"
        elif assignments is False and bulk_ok:
            engine = "bulk"
        elif (
            assignments == "auto"
            and spec.replicas > self.PLACE_SCAN_MAX
            and bulk_ok
        ):
            engine = "trace"
        else:
            engine = "scan"
        if engine == "trace":
            order, per_node, _ = trace_fn(*args, **kwargs)
        elif engine == "bulk":
            per_node, _ = bulk_fn(*args, **kwargs)
            order = None
        else:
            order, per_node = scan_fn(*args, **kwargs, device=self.device)
        return PlacementResult(
            assignments=order,
            per_node=np.asarray(per_node),
            node_names=list(snap.names),
            policy=policy,
            requested=spec.replicas,
            engine=engine,
        )

    def _place_spread(
        self,
        spec: PodSpec,
        *,
        policy: str,
        assignments,
        topology_key: str,
        max_skew: int,
        node_taints_policy: str,
    ) -> PlacementResult:
        """Placement under the per-step maxSkew gate — the scan only (the
        moving skew minimum couples every placement)."""
        self._require_strict("topology spread")
        self._check_spread_args(max_skew, node_taints_policy)
        if spec.extended_requests:
            raise ValueError(
                "topology-spread placement covers cpu/memory specs "
                "(extended resources: place without the constraint, or "
                "evaluate capacity via topology_spread)"
            )
        if assignments in ("trace", False):
            raise ValueError(
                "the skew gate couples placements — closed-form engines "
                "cannot apply; use assignments=True/'auto' (scan)"
            )
        # Argument validation must not depend on cluster contents (the
        # zero-domain early return below never reaches the scan's checks).
        if policy not in _placement.POLICIES:
            raise ValueError(
                f"unknown policy {policy!r} (want one of "
                f"{_placement.POLICIES})"
            )
        snap = self.snapshot
        full_mask, domain_mask = self._spread_masks(spec, node_taints_policy)
        zone_ids, member, _ = self._zone_membership(topology_key, domain_mask)
        used_cpu, used_mem, pods_count = self._usage_arrays(spec)
        if not zone_ids:
            return PlacementResult(
                assignments=np.full(spec.replicas, -1, dtype=np.int64),
                per_node=np.zeros(snap.n_nodes, dtype=np.int64),
                node_names=list(snap.names),
                policy=policy,
                requested=spec.replicas,
                engine="scan",
            )
        order, per_node, _ = _placement.place_replicas_spread(
            snap.alloc_cpu_milli,
            snap.alloc_mem_bytes,
            snap.alloc_pods,
            used_cpu,
            used_mem,
            pods_count,
            snap.healthy,
            spec.cpu_request_milli,
            spec.mem_request_bytes,
            member - 1,  # zone index, -1 = no domain
            n_replicas=spec.replicas,
            n_zones=len(zone_ids),
            policy=policy,
            max_skew=max_skew,
            node_mask=full_mask,
            max_per_node=spec.spread,
            device=self.device,
        )
        return PlacementResult(
            assignments=order,
            per_node=per_node,
            node_names=list(snap.names),
            policy=policy,
            requested=spec.replicas,
            engine="scan",
        )

    def drain(
        self, node_name: str, *, policy: str = "best-fit"
    ) -> DrainResult:
        """Simulate ``kubectl drain``: can this node's pods be rehomed?

        Collects the node's counted pods (strict rules: non-terminated,
        scheduler-effective requests), sorts them size-descending (the
        first-fit-decreasing heuristic), and places each — with its OWN
        requests — onto the remaining nodes with
        :func:`..ops.placement.place_pods_multi` on the model's device.
        The drained node is masked out; hard-tainted nodes are excluded
        as targets (evicted pods' tolerations are not part of the fixture
        schema).

        Strict semantics only; needs the model's ``fixture`` (per-pod
        requests are not recoverable from the per-node sums).  Rehoming
        feasibility covers cpu/memory/pod slots, plus every extended
        column some evicted pod requests.  PodDisruptionBudgets carried by
        the fixture (``"pdbs"``) gate evictions as the eviction API would
        (:func:`..pdb.blocked_evictions`): a blocked pod lands in
        ``result.blocked`` and the node is not evictable.  DaemonSet pods
        are NOT distinguished (the fixture schema carries no
        ownerReferences).
        """
        from kubernetesclustercapacity_tpu_torch.pdb import blocked_evictions

        self._require_strict("drain simulation")
        if self.fixture is None:
            raise ValueError(
                "drain needs the source fixture (per-pod requests are not "
                "part of the dense snapshot)"
            )
        snap = self.snapshot
        try:
            node_idx = snap.names.index(node_name)
        except ValueError:
            raise ValueError(f"unknown node {node_name!r}") from None

        ext_names = tuple(sorted(snap.extended))
        pods: list[tuple[str, dict]] = []
        unpacked: dict[str, set[str]] = {}  # pod key -> unpacked resources
        for pod in self.fixture.get("pods", []):
            if pod.get("nodeName") != node_name:
                continue
            if pod.get("phase") in _STRICT_TERMINATED:
                continue
            key = f"{pod.get('namespace', '')}/{pod.get('name', '')}"
            # An evicted pod requesting an extended resource the snapshot
            # does not pack must fail here: _effective_pod_resources drops
            # the request, and the plan would rehome the pod onto nodes
            # with no free units of it.
            for c in (
                *pod.get("containers", []), *pod.get("initContainers", [])
            ):
                for r, qty in (
                    (c.get("resources", {}).get("requests") or {})
                ).items():
                    if (
                        r in ("cpu", "memory", "ephemeral-storage")
                        or r.startswith("hugepages-")
                        or r in ext_names
                    ):
                        continue
                    if _strict_parse(qty) > 0:
                        unpacked.setdefault(key, set()).add(r)
            pods.append((key, _effective_pod_resources(pod, ext_names)))
        if unpacked:
            detail = "; ".join(
                f"{k} requests {', '.join(sorted(rs))}"
                for k, rs in sorted(unpacked.items())
            )
            raise ValueError(
                f"drain {node_name!r}: pods request extended resources "
                f"not packed in this snapshot ({detail}) — rehoming "
                "feasibility would be wrong; repack with "
                "extended_resources=(...) covering them"
            )
        # First-fit-decreasing order; the name breaks ties so the plan is
        # deterministic.
        pods.sort(
            key=lambda t: (-t[1]["cpu_req"], -t[1]["mem_req"], t[0])
        )
        if not pods:
            return DrainResult(
                node=node_name, pods=[], assignments=[],
                per_node=np.zeros(snap.n_nodes, dtype=np.int64),
                policy=policy,
            )
        blocked = blocked_evictions(self.fixture, [k for k, _ in pods])
        # Resource rows: cpu/mem plus only the extended columns the
        # evicted pods request (inactive rows change nothing).
        live_ext = tuple(
            r for r in ext_names if any(e["ext"][r] > 0 for _, e in pods)
        )
        resources = ("cpu", "memory", *live_ext)
        alloc_rn, used_rn = snap.resource_matrix(resources)
        reqs_rp = np.array(
            [
                [e["cpu_req"] for _, e in pods],
                [e["mem_req"] for _, e in pods],
                *([e["ext"][r] for _, e in pods] for r in live_ext),
            ],
            dtype=np.int64,
        )
        mask = self._masks_for(
            PodSpec(cpu_request_milli=1, mem_request_bytes=1)
        )
        mask = (np.ones(snap.n_nodes, dtype=bool) if mask is None
                else mask.copy())
        mask[node_idx] = False
        assignments, counts = _placement.place_pods_multi(
            alloc_rn,
            used_rn,
            snap.alloc_pods,
            snap.pods_count,
            snap.healthy,
            reqs_rp,
            policy=policy,
            node_mask=mask,
            device=self.device,
        )
        return DrainResult(
            node=node_name,
            pods=[k for k, _ in pods],
            assignments=[
                snap.names[i] if i >= 0 else None
                for i in assignments.tolist()
            ],
            per_node=counts,
            policy=policy,
            blocked=blocked,
        )

    def topology_spread(
        self,
        spec: PodSpec,
        *,
        topology_key: str,
        max_skew: int = 1,
        node_taints_policy: str = "ignore",
    ) -> TopologySpreadResult:
        """Capacity under a topology spread constraint — how many replicas
        fit when their counts across ``topology_key`` domains may differ by
        at most ``max_skew`` (PodTopologySpread ``DoNotSchedule``).

        Closed form over the ordinary per-node fits (so masks, taints,
        per-node ``spread``, extended resources and ``priority`` compose):
        group fits into zone capacities ``c_z``, then each zone may take
        ``min(c_z, min_z c_z + max_skew)``.  Domains are the key's values
        among domain-eligible nodes (:meth:`_spread_masks`): a selector
        that excludes a zone removes it from the skew minimum, and a
        full-but-eligible zone anchors it at 0; ``node_taints_policy``
        ``"ignore"`` (the upstream default) keeps a zone whose only nodes
        are hard-tainted as a 0-capacity domain, ``"honor"`` drops it.
        Counts new replicas only (the fresh-deployment model).  Strict
        semantics only.
        """
        self._require_strict("topology spread")
        self._check_spread_args(max_skew, node_taints_policy)
        full_mask, domain_mask = self._spread_masks(spec, node_taints_policy)
        fits = self.evaluate(spec, _node_mask=full_mask).fits
        zone_ids, member, unkeyed = self._zone_membership(
            topology_key, domain_mask
        )
        # One int64 scatter-add pass; slot 0 absorbs non-members.
        sums = np.zeros(len(zone_ids) + 1, dtype=np.int64)
        np.add.at(sums, member, np.asarray(fits, dtype=np.int64))
        zones = {z: int(sums[i + 1]) for z, i in zone_ids.items()}
        if not zones:
            allowed: dict[str, int] = {}
            total = 0
        else:
            floor = min(zones.values())
            allowed = {
                z: min(c, floor + max_skew) for z, c in zones.items()
            }
            total = sum(allowed.values())
        return TopologySpreadResult(
            topology_key=topology_key,
            max_skew=max_skew,
            zones=zones,
            allowed=allowed,
            total=total,
            replicas_requested=spec.replicas,
            unkeyed_nodes=unkeyed,
        )

    def _zone_membership(
        self, topology_key: str, domain_mask
    ) -> tuple[dict[str, int], np.ndarray, int]:
        """The topology-domain membership rule, shared by the scalar and
        grid paths: a node belongs to a domain iff it is healthy,
        domain-mask-eligible, and carries the key.  Returns ``(zone→index,
        member[N] = index+1 or 0, unkeyed_count)`` — ``unkeyed`` counts
        eligible nodes missing the key (:func:`..topology.model.
        label_codes` with the ``"exclude"`` policy)."""
        snap = self.snapshot
        eligible = np.asarray(snap.healthy, dtype=bool)
        if domain_mask is not None:
            eligible = eligible & np.asarray(domain_mask, dtype=bool)
        codes, domains, unkeyed = label_codes(
            snap.labels or [],
            topology_key,
            missing="exclude",
            eligible=eligible,
            n_nodes=snap.n_nodes,
        )
        zone_ids = {z: i for i, z in enumerate(domains)}
        return zone_ids, codes + 1, unkeyed

    def topology_spread_grid(
        self,
        grid: ScenarioGrid,
        *,
        topology_key: str,
        max_skew: int = 1,
        node_taints_policy: str = "ignore",
        tolerations: tuple = (),
        node_selector: dict | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized :meth:`topology_spread` over a scenario grid.

        One exact per-node sweep on the model's device gives ``fits[S,
        N]``; an int64 ``index_add_`` over the node axis groups it into
        ``[S, Z]`` zone capacities there, then the skew clamp is row math.
        Shared constraints compose like :meth:`sweep`.  Returns numpy
        ``(totals[S], schedulable[S])``.
        """
        self._require_strict("topology spread")
        self._check_spread_args(max_skew, node_taints_policy)
        grid.validate()
        snap = self.snapshot
        shared_spec = PodSpec(
            cpu_request_milli=1,
            mem_request_bytes=1,
            tolerations=tolerations,
            node_selector=node_selector or {},
        )
        self._check_extensions(shared_spec.constrained)
        full_mask, domain_mask = self._spread_masks(
            shared_spec, node_taints_policy
        )
        zone_ids, member, _ = self._zone_membership(topology_key, domain_mask)
        n_zones = len(zone_ids)
        if n_zones == 0:
            return (
                np.zeros(grid.size, dtype=np.int64),
                grid.replicas.astype(np.int64) <= 0,
            )
        device, put = _devcache.int64_putter(self.device)
        _, _, fits = sweep_grid(
            *_devcache.CACHE.exact_tensors(snap, device),
            put(grid.cpu_request_milli),
            put(grid.mem_request_bytes),
            put(grid.replicas),
            mode="strict",
            node_mask=(None if full_mask is None
                       else put(full_mask, torch.bool)),
            return_per_node=True,
        )
        # Column 0 absorbs the nodes of no domain.
        c = torch.zeros(
            (grid.size, n_zones + 1), dtype=torch.int64, device=device
        ).index_add_(1, put(member), fits)[:, 1:]
        floor = c.min(dim=1, keepdim=True).values
        totals = torch.minimum(c, floor + max_skew).sum(dim=1).cpu().numpy()
        return totals, totals >= grid.replicas.astype(np.int64)

    def _template_model(self, node_template: dict) -> "CapacityModel":
        """A one-node model over an EMPTY template node — the scale-planning
        unit.  Built through the ordinary packer, so the per-node fit
        inherits every surface: strict quantity grammar, health, taints vs
        the spec's tolerations, selectors, spread, extended columns."""
        template = dict(node_template)
        template.setdefault("name", "template-node")
        template.setdefault(
            "conditions", [{"type": "Ready", "status": "True"}]
        )
        fixture = {"nodes": [template], "pods": []}
        snap = snapshot_from_fixture(
            fixture, semantics="strict",
            extended_resources=tuple(sorted(self.snapshot.extended)),
        )
        return CapacityModel(
            snap, mode="strict", fixture=fixture, device=self.device
        )

    def nodes_needed(
        self, spec: PodSpec, node_template: dict
    ) -> CapacityPlan:
        """Scale-up planning: how many ``node_template`` nodes must be
        added so ``spec.replicas`` fit? — the cluster-autoscaler what-if.

        ``node_template`` is a fixture-schema node dict (``allocatable``
        plus optional ``labels``/``taints``/``conditions``).  Closed form:
        the deficit over current capacity divided by one empty template
        node's fit for this spec (ceil); constraints bind both sides (a
        selector the template's labels miss, or a template taint the spec
        does not tolerate, makes the plan unsatisfiable).  Strict
        semantics only.
        """
        self._require_strict("capacity planning")
        current = int(self.evaluate(spec).total)
        template = self._template_model(node_template)
        per_node = int(template.evaluate(spec).total)
        deficit = spec.replicas - current
        if deficit <= 0:
            needed = 0
        elif per_node <= 0:
            needed = None
        else:
            needed = -(-deficit // per_node)  # ceil
        return CapacityPlan(
            replicas_requested=spec.replicas,
            current_total=current,
            per_node_fit=per_node,
            nodes_needed=needed,
        )

    def nodes_needed_grid(
        self,
        grid: ScenarioGrid,
        node_template: dict,
        *,
        tolerations: tuple = (),
        node_selector: dict | None = None,
    ) -> np.ndarray:
        """Vectorized :meth:`nodes_needed` over a scenario grid.

        Returns ``needed[S]`` int64: ``0`` = already fits, ``-1`` =
        unsatisfiable with this template, else the node count.  Two
        :meth:`sweep` calls (the cluster and the one-node template, each
        kernel B1 when eligible), then elementwise closed form.  The
        shared constraints bind both sweeps.
        """
        self._require_strict("capacity planning")
        shared = dict(tolerations=tolerations, node_selector=node_selector)
        totals, _ = self.sweep(grid, **shared)
        per_node, _ = self._template_model(node_template).sweep(grid, **shared)
        deficit = grid.replicas.astype(np.int64) - totals
        ceil_div = -(-deficit // np.maximum(per_node, 1))
        return np.where(
            deficit <= 0,
            np.int64(0),
            np.where(per_node > 0, ceil_div, np.int64(-1)),
        )

    def _shared_mask(self, tolerations, node_selector, extended=()):
        """The one mask a sweep's shared constraints give every scenario."""
        shared_spec = PodSpec(
            cpu_request_milli=1,
            mem_request_bytes=1,
            tolerations=tolerations,
            node_selector=node_selector or {},
            extended_requests=dict.fromkeys(extended, 1),
        )
        self._check_extensions(
            shared_spec.constrained or bool(shared_spec.extended_requests)
        )
        return self._masks_for(shared_spec)

    def sweep(
        self,
        grid: ScenarioGrid,
        *,
        tolerations: tuple = (),
        node_selector: dict | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Grid sweep with optional shared constraints.

        Dispatches through :func:`..ops.fused_fit.sweep_auto`: eligible
        sweeps — either mode, masked or not — run kernel B1, the rest the
        exact int64 program; both are bit-exact.  The shared mask (the
        same for every scenario) is applied inside the kernel.  Returns
        numpy ``(totals[S], schedulable[S])``.
        """
        grid.validate()
        mask = self._shared_mask(tolerations, node_selector)
        totals, sched, _ = sweep_auto(
            self.snapshot,
            grid.cpu_request_milli,
            grid.mem_request_bytes,
            grid.replicas,
            mode=self.mode,
            node_mask=mask,
            device=self.device,
        )
        return totals, sched

    def sweep_preemption(
        self,
        grid: ScenarioGrid,
        priorities,
        *,
        tolerations: tuple = (),
        node_selector: dict | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Preemption-aware grid sweep: scenario ``s`` evicts pods of
        priority below ``priorities[s]``.

        The ``[S]`` priority vector rides the scenario axis — one
        ``searchsorted`` over the table's levels plus one column gather
        (:func:`..ops.preemption.sweep_preemption`, the exact program on
        the model's device); strict semantics only, needs the model's
        ``fixture``.  Shared constraints compose like :meth:`sweep`.
        """
        grid.validate()
        priorities = np.asarray(priorities, dtype=np.int64)
        if priorities.shape != (grid.size,):
            raise ValueError(
                f"priorities: expected shape ({grid.size},), got "
                f"{priorities.shape}"
            )
        # Reuse the spec gate with a minimal carrier spec: same errors,
        # one wording.
        self._check_preemption(
            PodSpec(cpu_request_milli=1, mem_request_bytes=1, priority=0)
        )
        snap = self.snapshot
        mask = self._shared_mask(tolerations, node_selector)
        t = self._priority_table()
        return _preemption.sweep_preemption(
            snap.alloc_cpu_milli,
            snap.alloc_mem_bytes,
            snap.alloc_pods,
            snap.healthy,
            t.levels,
            t.used_cpu_ge,
            t.used_mem_ge,
            t.pods_ge,
            grid.cpu_request_milli,
            grid.mem_request_bytes,
            priorities,
            grid.replicas,
            mode=self.mode,
            node_mask=mask,
            device=self.device,
        )

    def sweep_multi(
        self,
        grid: MultiResourceGrid,
        *,
        tolerations: tuple = (),
        node_selector: dict | None = None,
        spread: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """R-resource grid sweep (BASELINE config 4) with shared constraints.

        ``grid.resources`` selects snapshot columns (``cpu``/``memory``
        plus any :attr:`ClusterSnapshot.extended` names); dispatch goes
        through :func:`..ops.fused_multi.sweep_multi_auto` — kernel B2 when
        eligibility is proven, the exact int64 program otherwise,
        bit-exact either way.  The shared mask composes as in
        :meth:`sweep`; ``spread`` caps per-node replicas (and takes the
        exact program).  Returns numpy ``(totals[S], schedulable[S])``.
        """
        grid.validate()
        mask = self._shared_mask(
            tolerations, node_selector,
            [r for r in grid.resources if r not in ("cpu", "memory")],
        )
        alloc_rn, used_rn = self.snapshot.resource_matrix(grid.resources)
        totals, sched, _ = sweep_multi_auto(
            alloc_rn,
            used_rn,
            self.snapshot.alloc_pods,
            self.snapshot.pods_count,
            self.snapshot.healthy,
            grid.requests,
            grid.replicas,
            mode=self.mode,
            node_masks=mask,
            max_per_node=spread,
            device=self.device,
        )
        return totals, sched
