"""The plain reference's view of a cluster: node columns from a fixture.

Written from the semantics, not from the program: a walk over the
fixture's nodes and pods, one row per node, in the order the fixture
lists them.  Imports numpy and the standard library only.

``reference`` is the Go CLI's reading (``ClusterCapacity.go``):

* a node counts only when its first four conditions all read
  ``"False"``; any other node becomes a row with an empty name and zero
  allocatables;
* cpu through ``convertCPUToMilis``, a node's memory through
  ``bytefmt.ToBytes`` (a failure reads 0), pods through
  ``Quantity.Value()``;
* pods in phase Pending, Succeeded, Failed or Unknown are left out; the
  rest add their containers' requests (init containers are ignored) to
  every row whose name equals their ``nodeName``.

``strict`` is the scheduler's reading: health is ``Ready`` true and no
other condition true, quantities in Kubernetes' grammar, pods on a
known node that have not Succeeded or Failed add
``max(sum(containers), max(initContainers))`` of each request, and a
node with a NoSchedule or NoExecute taint is masked out of an answer.
"""

from __future__ import annotations

import numpy as np

from kccap_bench.reference.quantity import (
    bytefmt_reference,
    cpu_milli_reference,
    quantity_milli,
    quantity_value,
)

__all__ = ["pack_reference", "pack_strict", "strict_healthy", "Columns"]

_REFERENCE_LEFT_OUT = {"Pending", "Succeeded", "Failed", "Unknown"}
_STRICT_LEFT_OUT = {"Succeeded", "Failed"}
_HARD_EFFECTS = {"NoSchedule", "NoExecute"}


class Columns:
    """Node columns, all int64 ``[N]`` but ``healthy`` and ``mask`` (bool):
    ``alloc[r]`` and ``used[r]`` per resource name, ``alloc_pods``,
    ``pods_count``."""

    def __init__(self, semantics, alloc, used, alloc_pods, pods_count,
                 healthy, mask):
        self.semantics = semantics
        self.alloc = alloc
        self.used = used
        self.alloc_pods = alloc_pods
        self.pods_count = pods_count
        self.healthy = healthy
        self.mask = mask

    @property
    def n_nodes(self) -> int:
        return int(self.alloc_pods.shape[0])

    def live_nodes(self) -> int:
        """Nodes whose every fit an answer has to compute: all of them
        under the reference (a phantom row is computed too), the healthy
        and unmasked ones under strict."""
        if self.semantics == "reference":
            return self.n_nodes
        return int(np.count_nonzero(self.healthy & self.mask))


def _reference_healthy(node: dict) -> bool:
    conditions = node.get("conditions", [])
    if len(conditions) < 4:
        raise ValueError(f"node {node.get('name')!r} has fewer than four "
                         f"conditions: the Go CLI panics on it")
    return all(c.get("status") == "False" for c in conditions[:4])


def pack_reference(fixture: dict) -> Columns:
    nodes = fixture["nodes"]
    n = len(nodes)
    names = []
    alloc_cpu = np.zeros(n, dtype=np.int64)
    alloc_mem = np.zeros(n, dtype=np.int64)
    alloc_pods = np.zeros(n, dtype=np.int64)
    healthy = np.zeros(n, dtype=bool)
    for i, node in enumerate(nodes):
        if not _reference_healthy(node):
            names.append("")
            continue
        names.append(node.get("name", ""))
        healthy[i] = True
        allocatable = node.get("allocatable", {})
        alloc_cpu[i] = cpu_milli_reference(allocatable.get("cpu", "0"))
        alloc_mem[i] = bytefmt_reference(allocatable.get("memory", "")) or 0
        alloc_pods[i] = quantity_value(allocatable.get("pods", "0"))
    per_name: dict[str, list[int]] = {}
    for pod in fixture["pods"]:
        if pod.get("phase") in _REFERENCE_LEFT_OUT:
            continue
        acc = per_name.setdefault(pod.get("nodeName", ""), [0, 0, 0])
        acc[2] += 1
        for c in pod.get("containers", []):
            req = c.get("resources", {}).get("requests", {})
            acc[0] += cpu_milli_reference(req.get("cpu", "0"))
            acc[1] += quantity_value(req.get("memory"))
    used_cpu = np.zeros(n, dtype=np.int64)
    used_mem = np.zeros(n, dtype=np.int64)
    pods_count = np.zeros(n, dtype=np.int64)
    for i, name in enumerate(names):
        acc = per_name.get(name)
        if acc is not None:
            used_cpu[i], used_mem[i], pods_count[i] = acc
    return Columns(
        "reference",
        {"cpu": alloc_cpu, "memory": alloc_mem},
        {"cpu": used_cpu, "memory": used_mem},
        alloc_pods, pods_count, healthy, np.ones(n, dtype=bool),
    )


def strict_healthy(node: dict) -> bool:
    ready = False
    for c in node.get("conditions", []):
        if c.get("type") == "Ready":
            ready = c.get("status") == "True"
        elif c.get("status") == "True":
            return False
    return ready


def _strict_requests(pod: dict, resources: tuple[str, ...]) -> list[int]:
    """A pod's effective request of each resource."""
    reads = [quantity_milli if r == "cpu" else quantity_value
             for r in resources]
    totals = [0] * len(resources)
    for c in pod.get("containers", []):
        req = c.get("resources", {}).get("requests", {})
        for k, r in enumerate(resources):
            totals[k] += reads[k](req.get(r))
    for c in pod.get("initContainers", []):
        req = c.get("resources", {}).get("requests", {})
        for k, r in enumerate(resources):
            totals[k] = max(totals[k], reads[k](req.get(r)))
    return totals


def pack_strict(fixture: dict, extended: tuple[str, ...] = ()) -> Columns:
    nodes = fixture["nodes"]
    n = len(nodes)
    resources = ("cpu", "memory", *extended)
    alloc = {r: np.zeros(n, dtype=np.int64) for r in resources}
    used = {r: np.zeros(n, dtype=np.int64) for r in resources}
    alloc_pods = np.zeros(n, dtype=np.int64)
    pods_count = np.zeros(n, dtype=np.int64)
    healthy = np.zeros(n, dtype=bool)
    mask = np.ones(n, dtype=bool)
    row = {}
    for i, node in enumerate(nodes):
        row[node.get("name", "")] = i
        allocatable = node.get("allocatable", {})
        for r in resources:
            read = quantity_milli if r == "cpu" else quantity_value
            alloc[r][i] = read(allocatable.get(r))
        alloc_pods[i] = quantity_value(allocatable.get("pods"))
        healthy[i] = strict_healthy(node)
        mask[i] = not any(t.get("effect") in _HARD_EFFECTS
                          for t in node.get("taints") or [])
    for pod in fixture["pods"]:
        i = row.get(pod.get("nodeName", ""))
        if not pod.get("nodeName") or i is None:
            continue
        if pod.get("phase") in _STRICT_LEFT_OUT:
            continue
        pods_count[i] += 1
        for r, v in zip(resources, _strict_requests(pod, resources)):
            used[r][i] += v
    return Columns("strict", alloc, used, alloc_pods, pods_count, healthy,
                   mask)
