"""A cluster's state under watch events, kept plainly.

Nodes by name and pods by ``(namespace, name)``; ``ADDED`` and
``MODIFIED`` put the event's object in place, ``DELETED`` takes it out.
A pod stays when its node goes, as in Kubernetes, and then counts on no
node.  :class:`StrictCluster` also keeps, per node name, the sums the
strict semantics reads: the effective requests and the number of the
non-terminated pods bound to that name, added and taken away pod by pod,
so that a generation's columns cost one pass over the nodes.  Imports
numpy and the standard library only.
"""

from __future__ import annotations

import numpy as np

from kccap_bench.reference.pack import (
    Columns,
    _HARD_EFFECTS,
    _STRICT_LEFT_OUT,
    _strict_requests,
    quantity_milli,
    quantity_value,
    strict_healthy,
)

__all__ = ["StrictCluster"]


class StrictCluster:
    def __init__(self, fixture: dict, extended: tuple[str, ...] = ()) -> None:
        self.resources = ("cpu", "memory", *extended)
        self.nodes: dict[str, dict] = {}
        self.pods: dict[tuple[str, str], dict] = {}
        # node name -> [sum of each resource's requests, pod count]
        self.usage: dict[str, list[int]] = {}
        for node in fixture["nodes"]:
            self.nodes[node["name"]] = node
        for pod in fixture["pods"]:
            self._put_pod(pod)

    def _counted(self, pod: dict):
        if not pod.get("nodeName") or pod.get("phase") in _STRICT_LEFT_OUT:
            return None
        return _strict_requests(pod, self.resources)

    def _add_usage(self, pod: dict, sign: int) -> None:
        req = self._counted(pod)
        if req is None:
            return
        acc = self.usage.setdefault(pod["nodeName"],
                                    [0] * (len(self.resources) + 1))
        for k, v in enumerate(req):
            acc[k] += sign * v
        acc[-1] += sign

    def _put_pod(self, pod: dict) -> None:
        key = (pod.get("namespace", ""), pod["name"])
        old = self.pods.get(key)
        if old is not None:
            self._add_usage(old, -1)
        self.pods[key] = pod
        self._add_usage(pod, +1)

    def apply(self, events: list[dict]) -> None:
        for event in events:
            obj, etype = event["object"], event["type"]
            if event["kind"] == "Node":
                present = obj["name"] in self.nodes
                if etype == "DELETED" and present:
                    del self.nodes[obj["name"]]
                elif (etype == "ADDED") != present:
                    self.nodes[obj["name"]] = obj
                else:
                    raise ValueError(f"{etype} of node {obj['name']!r}")
            elif event["kind"] == "Pod":
                key = (obj.get("namespace", ""), obj["name"])
                present = key in self.pods
                if etype == "DELETED" and present:
                    self._add_usage(self.pods.pop(key), -1)
                elif (etype == "ADDED") != present:
                    self._put_pod(obj)
                else:
                    raise ValueError(f"{etype} of pod {key!r}")
            else:
                raise ValueError(f"event kind {event['kind']!r}")

    def healthy_nodes(self) -> int:
        return sum(1 for n in self.nodes.values() if strict_healthy(n))

    def columns(self) -> Columns:
        """The strict columns of the state as it stands, one row per node
        in the order the nodes were first seen."""
        nodes = list(self.nodes.values())
        n = len(nodes)
        alloc = {r: np.zeros(n, dtype=np.int64) for r in self.resources}
        used = {r: np.zeros(n, dtype=np.int64) for r in self.resources}
        alloc_pods = np.zeros(n, dtype=np.int64)
        pods_count = np.zeros(n, dtype=np.int64)
        healthy = np.zeros(n, dtype=bool)
        mask = np.ones(n, dtype=bool)
        zero = [0] * (len(self.resources) + 1)
        for i, node in enumerate(nodes):
            allocatable = node.get("allocatable", {})
            acc = self.usage.get(node["name"], zero)
            for k, r in enumerate(self.resources):
                read = quantity_milli if r == "cpu" else quantity_value
                alloc[r][i] = read(allocatable.get(r))
                used[r][i] = acc[k]
            alloc_pods[i] = quantity_value(allocatable.get("pods"))
            pods_count[i] = acc[-1]
            healthy[i] = strict_healthy(node)
            mask[i] = not any(t.get("effect") in _HARD_EFFECTS
                              for t in node.get("taints") or [])
        return Columns("strict", alloc, used, alloc_pods, pods_count,
                       healthy, mask)
