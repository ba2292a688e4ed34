"""The capacity model: one object answering "will it schedule?".

Counterpart of ``kubernetesclustercapacity_tpu/models/capacity.py``
(``PodSpec``, ``CapacityResult``, and ``CapacityModel``'s mask assembly,
``evaluate``, ``sweep`` and ``sweep_multi``).  :class:`CapacityModel`
composes the layers below it — snapshot columns, constraint masks and the
device programs.  A :class:`PodSpec` describes the what-if pod (resources
AND scheduling constraints, everything the reference's six flags could not
express); ``evaluate`` answers one spec on the exact int64 program,
``sweep`` a grid through :func:`..ops.fused_fit.sweep_auto` (kernel B1
when eligible) and ``sweep_multi`` an R-resource grid through
:func:`..ops.fused_multi.sweep_multi_auto` (kernel B2 when eligible).

The reference equivalent is the whole of ``main`` (``ClusterCapacity.go:
48-150``) minus flag parsing and printing; the constraint families have no
reference equivalent.  Not ported yet: placement, drain, topology spread,
scale-up planning and preemption (``PodSpec.priority``), which need the
placement, preemption, disruption-budget and topology programs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from kubernetesclustercapacity_tpu_torch import masks as _masks
from kubernetesclustercapacity_tpu_torch.ops.fit import (
    fit_snapshot,
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
from kubernetesclustercapacity_tpu_torch.snapshot import ClusterSnapshot
from kubernetesclustercapacity_tpu_torch.utils.quantity import int64_bits

__all__ = ["PodSpec", "CapacityModel", "CapacityResult"]


@dataclass(frozen=True)
class PodSpec:
    """A what-if pod: resources plus the scheduling constraints it carries.

    ``extended_requests`` maps extra resource names (which must exist in
    the snapshot's ``extended`` columns) to per-replica requests.
    Constraint fields mirror the pod-spec fields kube-scheduler filters on;
    all are optional and default to unconstrained.  ``spread`` caps
    replicas per node (self-anti-affinity over the hostname topology; 1 is
    one-per-node spread, ``None`` unlimited; must be >= 1 when set).
    ``priority`` (preemption-aware capacity) is not ported yet: a spec that
    sets it raises ``ValueError``.
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
        if self.priority is not None:
            raise ValueError(
                "PodSpec.priority: preemption-aware capacity is not yet "
                "ported to the PyTorch package"
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
    against existing pods (pod labels are not in the snapshot columns).
    ``device`` is where every program runs: ``"cuda"`` by default, which
    raises without a card; ``"cpu"`` runs on the host.
    """

    def __init__(
        self,
        snapshot: ClusterSnapshot,
        *,
        mode: str = "strict",
        fixture: dict | None = None,
        allow_extensions: bool = True,
        device="cuda",
    ) -> None:
        self.snapshot = snapshot
        self.mode = mode
        self.fixture = fixture
        self.allow_extensions = allow_extensions
        self.device = device

    # -- mask assembly -----------------------------------------------------
    def _mask_parts(
        self, spec: PodSpec
    ) -> tuple[np.ndarray | None, np.ndarray | None, np.ndarray | None]:
        """``(taint, node_affinity, pod_anti_affinity)`` masks, split the
        way topology-spread domain discovery will need them."""
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

    def _multi_fit_args(self, spec: PodSpec):
        """The R-resource operands for a spec with extended requests: rows
        ``cpu``, ``memory``, then the extended names sorted, and the
        matching request vector."""
        resources = ("cpu", "memory", *sorted(spec.extended_requests))
        alloc_rn, used_rn = self.snapshot.resource_matrix(resources)
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
    def evaluate(self, spec: PodSpec) -> CapacityResult:
        """One spec → per-node fits + verdict.

        The exact 2-resource program (:func:`..ops.fit.fit_per_node`)
        unless the spec requests extended resources, which take the
        R-resource program (:func:`..ops.fit.fit_per_node_multi`).
        Constraint masks and the spread clamp compose around either.
        """
        snap = self.snapshot
        self._check_extensions(spec.constrained or bool(spec.extended_requests))
        mask = self._masks_for(spec)
        if not spec.extended_requests:
            fits = fit_snapshot(
                snap,
                spec.cpu_request_milli,
                spec.mem_request_bytes,
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
            fits = sweep_grid_multi_staged(
                alloc_rn,
                used_rn,
                snap.alloc_pods,
                snap.pods_count,
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
