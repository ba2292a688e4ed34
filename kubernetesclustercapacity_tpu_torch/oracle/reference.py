"""The reference CLI's node and pod semantics, bug-for-bug.

Counterpart of ``kubernetesclustercapacity_tpu/oracle/reference.py``,
carrying only what the reference packer in :mod:`..snapshot` is built on:
the allocatable codecs, the first-four-conditions health check, the
Running-only field selector and the per-node pod walk of the reference's
``getHealthyNodes`` / ``getPodCPUMemoryRequestsLimits``
(``src/KubeAPI/ClusterCapacity.go:166-299``).  The whole-run oracle
(``reference_run``, ``fit_arrays_python``) is not ported yet.

Reproduced quirks (SURVEY.md §2.4):

* Q3  "healthy" = the first FOUR conditions all have ``status == "False"``;
      fewer than four conditions is the reference's index panic.
* Q4  unhealthy nodes stay as zero-valued phantom rows, and their pod
      query matches pods with an empty ``nodeName``.
* Q5  node memory that ``bytefmt`` rejects becomes 0; CPU strings that
      ``Atoi`` rejects become 0.
* Q7  only ``Running`` (or unknown-phase) pods consume capacity, regular
      containers only.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

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
    "healthy_nodes",
    "node_allocatable_values",
    "node_is_healthy_reference",
    "pods_by_node_index",
    "pod_requests_limits",
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


def healthy_nodes(fixture: dict) -> list[NodeView]:
    """Replicates ``getHealthyNodes`` (``ClusterCapacity.go:166-230``):
    allocatables through the reference codecs, the first-four-conditions
    health check, and a zero-valued phantom entry for each unhealthy node.
    """
    raw_nodes = fixture.get("nodes", [])
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
