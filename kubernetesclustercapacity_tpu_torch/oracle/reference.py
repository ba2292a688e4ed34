"""The reference CLI's node and pod semantics, bug-for-bug.

Counterpart of ``kubernetesclustercapacity_tpu/oracle/reference.py``: the
pure-Python walk of the reference's ``main`` (``src/KubeAPI/
ClusterCapacity.go:48-150``) over an offline fixture.  The reference packer
in :mod:`..snapshot` is built on its node and pod half (the allocatable
codecs, the first-four-conditions health check, the Running-only field
selector and the per-node pod walk of ``getHealthyNodes`` /
``getPodCPUMemoryRequestsLimits``, ``:166-299``); :func:`reference_run` and
:func:`fit_arrays_python` are the sequential ground truth the CLI's
``-backend cpu`` prints from and :mod:`..explain`'s marginal analysis
verifies against.

Reproduced quirks (SURVEY.md §2.4):

* Q1  conditional pod cap: applied only when ``fit >= allocatablePods``
      (``:134-136``), and it then OVERWRITES the min with
      ``allocatablePods - len(pods)``, which can be negative.
* Q3  "healthy" = the first FOUR conditions all have ``status == "False"``;
      fewer than four conditions is the reference's index panic.
* Q4  unhealthy nodes stay as zero-valued phantom rows, and their pod
      query matches pods with an empty ``nodeName``; the
      ``make([]node, n, 3)`` crash for n > 3 (``:176``) is reproducible
      with ``emulate_slice_bug=True``.
* Q5  node memory that ``bytefmt`` rejects becomes 0; CPU strings that
      ``Atoi`` rejects become 0.
* Q7  only ``Running`` (or unknown-phase) pods consume capacity, regular
      containers only.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field

from kubernetesclustercapacity_tpu_torch.scenario import Scenario
from kubernetesclustercapacity_tpu_torch.utils.quantity import (
    QuantityParseError,
    cpu_parse_error_payload,
    cpu_to_milli_reference,
    parse_quantity,
    to_bytes_reference,
)

__all__ = [
    "ReferencePanic",
    "NodeView",
    "PerNodeResult",
    "OracleResult",
    "healthy_nodes",
    "node_allocatable_values",
    "node_is_healthy_reference",
    "non_terminated_pods_for_node",
    "pods_by_node_index",
    "pod_requests_limits",
    "reference_run",
    "fit_arrays_python",
]

_UINT64_MOD = 1 << 64
_INT64_MOD = 1 << 63

# The four phases the field selector excludes (ClusterCapacity.go:236); only
# "Running" — or any novel phase string — survives it.
_EXCLUDED_PHASES = frozenset({"Pending", "Succeeded", "Failed", "Unknown"})


class ReferencePanic(RuntimeError):
    """The analog of a Go runtime panic in the reference."""


def _to_go_int(u: int) -> int:
    """Reinterpret an arbitrary Python int as a Go 64-bit signed int."""
    u %= _UINT64_MOD
    return u - _UINT64_MOD if u >= _INT64_MOD else u


def _go_div(num: int, den: int) -> int:
    """Go int64 division: truncates toward zero (Python ``//`` floors) and
    WRAPS the one overflowing quotient, ``INT64_MIN / -1 == INT64_MIN``."""
    q = abs(num) // abs(den)
    q = -q if (num < 0) != (den < 0) else q
    return _to_go_int(q)


def _go_float_div(num: float, den: float) -> float:
    """Go float64 division: x/0 is ±Inf, 0/0 is NaN — never a trap."""
    if den == 0.0:
        if num == 0.0:
            return math.nan
        return math.inf if num > 0 else -math.inf
    return num / den


@dataclass
class NodeView:
    """The reference's ``type node`` (``ClusterCapacity.go:41-46``).

    A phantom (skipped-unhealthy) node is the zero value: empty name, zero
    allocatables — exactly what the reference leaves in its slice.
    """

    name: str = ""
    allocatable_cpu: int = 0  # uint64 millicores
    allocatable_memory: int = 0  # int64 bytes
    allocatable_pods: int = 0


@dataclass
class PerNodeResult:
    """Everything the reference prints/accumulates per node (``:105-140``)."""

    node: NodeView
    pods_count: int
    cpu_limits_milli: int
    cpu_requests_milli: int
    mem_limits_bytes: int
    mem_requests_bytes: int
    cpu_request_used_percent: float
    mem_request_used_percent: float
    cpu_limit_used_percent: float
    mem_limit_used_percent: float
    max_replicas: int


@dataclass
class OracleResult:
    """Aggregate outcome of one reference-semantics run."""

    per_node: list[PerNodeResult] = field(default_factory=list)
    total_possible_replicas: int = 0
    replicas_requested: int = 0

    @property
    def schedulable(self) -> bool:
        # ClusterCapacity.go:144
        return self.total_possible_replicas >= self.replicas_requested

    @property
    def fits(self) -> list[int]:
        return [r.max_replicas for r in self.per_node]


def healthy_nodes(
    fixture: dict, *, emulate_slice_bug: bool = False
) -> list[NodeView]:
    """Replicates ``getHealthyNodes`` (``ClusterCapacity.go:166-230``):
    allocatables through the reference codecs, the first-four-conditions
    health check, and a zero-valued phantom entry for each unhealthy node.
    With ``emulate_slice_bug=True``, clusters of more than 3 nodes hit the
    ``make([]node, n, 3)`` len > cap crash (``:176``); the default diverges
    and succeeds.
    """
    raw_nodes = fixture.get("nodes", [])
    if emulate_slice_bug and len(raw_nodes) > 3:
        raise ReferencePanic(
            f"makeslice: len out of range (len {len(raw_nodes)} > cap 3, "
            "ClusterCapacity.go:176)"
        )
    result = [NodeView() for _ in raw_nodes]
    for i, raw in enumerate(raw_nodes):
        allocatable = raw.get("allocatable", {})
        cpu_milli, mem_bytes, alloc_pods, _ = node_allocatable_values(
            allocatable.get("cpu", "0"),
            allocatable.get("memory", ""),
            allocatable.get("pods", "0"),
        )
        if node_is_healthy_reference(raw):
            result[i] = NodeView(
                name=raw.get("name", ""),
                allocatable_cpu=cpu_milli,
                allocatable_memory=mem_bytes,
                allocatable_pods=alloc_pods,
            )
    return result


def node_allocatable_values(
    cpu_str, mem_str, pods_str
) -> tuple[int, int, int, str | None]:
    """One node's allocatable parses with ``getHealthyNodes``' exact error
    semantics: CPU codec errors raise through (``:196-197``), memory
    parse failure is a silent zero (``:202-206``), pods parse failure is
    zero (``.Pods().Value()`` of a missing/invalid quantity, ``:208``).
    The fourth element is the CPU codec's error-line payload (the
    suffix-stripped string ``convertCPUToMilis`` prints, ``:314-317``)
    or ``None``.
    """
    cpu_milli = cpu_to_milli_reference(cpu_str)
    try:
        mem_bytes = to_bytes_reference(mem_str)
    except QuantityParseError:
        mem_bytes = 0  # :202-206 — silent zero
    try:
        alloc_pods = parse_quantity(pods_str).value()
    except QuantityParseError:
        alloc_pods = 0
    return cpu_milli, mem_bytes, alloc_pods, cpu_parse_error_payload(cpu_str)


def node_is_healthy_reference(raw: dict) -> bool:
    """The first-four-conditions health check, bug-for-bug (``:212-219``):
    any of the first 4 conditions not ``"False"`` → unhealthy; fewer than
    4 conditions → the reference's index-out-of-range panic."""
    conditions = raw.get("conditions", [])
    for j in range(4):  # :212 — hardcoded first four
        if j >= len(conditions):
            raise ReferencePanic(
                f"index out of range [{j}] with length {len(conditions)} "
                f"(node {raw.get('name', '?')!r}, ClusterCapacity.go:213)"
            )
        if conditions[j].get("status") != "False":
            return False
    return True


def _survives_field_selector(pod: dict) -> bool:
    """The phase half of the field selector (``ClusterCapacity.go:236``)."""
    return pod.get("phase") not in _EXCLUDED_PHASES


def non_terminated_pods_for_node(fixture: dict, node_name: str) -> list[dict]:
    """The field-selector pod list (``ClusterCapacity.go:232-253``): pods
    whose ``nodeName`` is ``node_name`` and whose phase survives the
    selector, across all namespaces.  For a phantom node (``node_name ==
    ""``) it matches unscheduled pods (Q4)."""
    return [
        p
        for p in fixture.get("pods", [])
        if p.get("nodeName", "") == node_name and _survives_field_selector(p)
    ]


def pods_by_node_index(fixture: dict) -> dict[str, list[dict]]:
    """Field-selector-surviving pods grouped by ``nodeName`` in one pass,
    each list in fixture order (the reference re-lists per node, ``:238``).
    """
    index: dict[str, list[dict]] = {}
    for p in fixture.get("pods", []):
        if _survives_field_selector(p):
            index.setdefault(p.get("nodeName", ""), []).append(p)
    return index


def pod_requests_limits(pods: list[dict]) -> tuple[int, int, int, int]:
    """Replicates ``getPodCPUMemoryRequestsLimits`` (``:255-299``).

    Sums over regular containers only: CPU through the reference codec,
    memory through ``Quantity.Value()`` with absent → 0.  Returns
    ``(cpu_limits, cpu_requests, mem_limits, mem_requests)`` with Go's
    uint64 / int64 wrapping on the running sums.
    """
    cpu_req_total = cpu_lim_total = 0  # uint64 in Go
    mem_req_total = mem_lim_total = 0  # int64 in Go
    for pod in pods:
        for container in pod.get("containers", []):
            resources = container.get("resources", {})
            limits = resources.get("limits", {})
            requests = resources.get("requests", {})
            cpu_lim_total = (
                cpu_lim_total + cpu_to_milli_reference(limits.get("cpu", "0"))
            ) % _UINT64_MOD
            cpu_req_total = (
                cpu_req_total + cpu_to_milli_reference(requests.get("cpu", "0"))
            ) % _UINT64_MOD
            mem_lim_total = _to_go_int(
                mem_lim_total + _mem_value(limits.get("memory"))
            )
            mem_req_total = _to_go_int(
                mem_req_total + _mem_value(requests.get("memory"))
            )
    return cpu_lim_total, cpu_req_total, mem_lim_total, mem_req_total


@functools.lru_cache(maxsize=1 << 16)
def _mem_value(s: str | None) -> int:
    """``Quantity.Value()`` of a container memory string; absent/invalid → 0
    (memoized: pod memory strings repeat across a cluster)."""
    if s is None:
        return 0
    try:
        return parse_quantity(s).value()
    except QuantityParseError:
        return 0


def fit_arrays_python(
    alloc_cpu,
    alloc_mem,
    alloc_pods,
    used_cpu,
    used_mem,
    pods_count,
    cpu_req: int,
    mem_req: int,
    *,
    mode: str = "reference",
    healthy=None,
) -> list[int]:
    """Sequential fit over raw int64 arrays — the array-level ground truth.

    ``mode="reference"`` is the same arithmetic as :func:`reference_run`'s
    per-node loop (CPU values are uint64 views of the bit patterns, and a
    zero request panics at the division exactly where Go would);
    ``mode="strict"`` is the corrected 3-way min with the remaining pod
    slots, clamped at 0, unhealthy nodes contributing nothing (``healthy``
    defaults to all healthy).
    """
    if mode not in ("reference", "strict"):
        raise ValueError(f"unknown mode {mode!r}")
    fits = []
    cr = int(cpu_req) % _UINT64_MOD
    mr = int(mem_req)
    for i in range(len(alloc_cpu)):
        ac = int(alloc_cpu[i]) % _UINT64_MOD  # uint64 view of the bit pattern
        uc = int(used_cpu[i]) % _UINT64_MOD
        if ac <= uc:
            cpu_fit = 0
        else:
            if cr == 0:
                raise ReferencePanic(
                    "integer divide by zero (ClusterCapacity.go:123)"
                )
            cpu_fit = _to_go_int((ac - uc) // cr)
        am, um = int(alloc_mem[i]), int(used_mem[i])
        if am <= um:
            mem_fit = 0
        else:
            if mr == 0:
                raise ReferencePanic(
                    "integer divide by zero (ClusterCapacity.go:129)"
                )
            mem_fit = _go_div(_to_go_int(am - um), mr)
        fit = cpu_fit if cpu_fit <= mem_fit else mem_fit
        ap = int(alloc_pods[i])
        if mode == "reference":
            if fit >= ap:
                fit = ap - int(pods_count[i])
        else:
            slots = max(ap - int(pods_count[i]), 0)
            fit = max(min(fit, slots), 0)
            if healthy is not None and not bool(healthy[i]):
                fit = 0
        fits.append(fit)
    return fits


def reference_run(
    fixture: dict,
    scenario: Scenario,
    *,
    emulate_slice_bug: bool = False,
) -> OracleResult:
    """Full bug-for-bug run of the reference ``main`` over a fixture.

    The per-node loop (``ClusterCapacity.go:105-140``)::

        cpuFit = 0 if allocCPU <= usedCPUreq else (allocCPU - usedCPUreq) / cpuReq
        memFit = 0 if allocMem <= usedMemReq else (allocMem - usedMemReq) / memReq
        fit    = min(cpuFit, memFit)
        if fit >= allocatablePods: fit = allocatablePods - len(pods)   # Q1
        total += fit

    ``cpuReq == 0`` panics exactly where the reference does (``:123``).
    """
    nodes = healthy_nodes(fixture, emulate_slice_bug=emulate_slice_bug)
    result = OracleResult(replicas_requested=scenario.replicas)
    pods_by_node = pods_by_node_index(fixture)
    for node in nodes:
        pods = pods_by_node.get(node.name, [])
        cpu_lim, cpu_req_used, mem_lim, mem_req_used = pod_requests_limits(pods)
        per = PerNodeResult(
            node=node,
            pods_count=len(pods),
            cpu_limits_milli=cpu_lim,
            cpu_requests_milli=cpu_req_used,
            mem_limits_bytes=mem_lim,
            mem_requests_bytes=mem_req_used,
            cpu_request_used_percent=_go_float_div(
                float(cpu_req_used) * 100, float(node.allocatable_cpu)
            ),
            mem_request_used_percent=_go_float_div(
                float(mem_req_used) * 100, float(node.allocatable_memory)
            ),
            cpu_limit_used_percent=_go_float_div(
                float(cpu_lim) * 100, float(node.allocatable_cpu)
            ),
            mem_limit_used_percent=_go_float_div(
                float(mem_lim) * 100, float(node.allocatable_memory)
            ),
            max_replicas=0,
        )
        if node.allocatable_cpu <= cpu_req_used:
            cpu_fit = 0  # :119-121
        else:
            if scenario.cpu_request_milli == 0:
                raise ReferencePanic(
                    "integer divide by zero (ClusterCapacity.go:123)"
                )
            cpu_fit = _to_go_int(
                (node.allocatable_cpu - cpu_req_used)
                // scenario.cpu_request_milli
            )
        if node.allocatable_memory <= mem_req_used:
            mem_fit = 0  # :125-127
        else:
            if scenario.mem_request_bytes == 0:
                raise ReferencePanic(
                    "integer divide by zero (ClusterCapacity.go:129)"
                )
            # int64 subtraction wraps (a wrapped usage sum can be
            # negative), and Go division truncates toward zero.
            mem_fit = _go_div(
                _to_go_int(node.allocatable_memory - mem_req_used),
                scenario.mem_request_bytes,
            )
        max_replicas = cpu_fit if cpu_fit <= mem_fit else mem_fit  # :159-164
        if max_replicas >= node.allocatable_pods:  # Q1, :134-136
            max_replicas = node.allocatable_pods - len(pods)
        per.max_replicas = max_replicas
        result.per_node.append(per)
        result.total_possible_replicas += max_replicas
    return result
