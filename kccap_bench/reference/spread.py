"""Capacity under a zone spread constraint, written plainly.

How many more replicas of each spec fit while the Deployment stays
spread over a topology key with at most ``max_skew`` replicas between
its fullest and its emptiest domain (PodTopologySpread with
``whenUnsatisfiable: DoNotSchedule``; kubernetes.io, "Pod Topology
Spread Constraints").  Written from that page's rule and from the
definition of the grid spread in the JAX package's
``CapacityModel.topology_spread_grid``, and not from the program:

* a node's fit is the strict one (:mod:`.fit`), and 0 on a node with a
  NoSchedule or NoExecute taint, since the spec tolerates none;
* the domains are the values of the key on the healthy nodes that carry
  it, tainted nodes included (``nodeTaintsPolicy: Ignore``, Kubernetes'
  default; with no node selector, ``nodeAffinityPolicy: Honor`` keeps
  every node);
* a domain's capacity ``c_z`` is the sum of its members' fits; a spec's
  answer is ``sum_z min(c_z, min_z c_z + max_skew)``, and it is
  schedulable when that reaches its replicas; with no domain it is 0.

Where this departs from the scheduler (the configuration's
``guarantees`` say the same): the Deployment's existing pods are not
counted, every zone starts at 0; a node under pressure or not Ready
belongs to no domain, where the scheduler keeps it under
``nodeTaintsPolicy: Ignore`` (the node lifecycle controller's taints do
not drop it), so a zone of such nodes only would anchor the skew at 0
there and drops out here; the answer is the most replicas any order of
placement reaches, not what one-at-a-time scoring places; ``minDomains``
and ``matchLabelKeys`` are not modelled.

Plain PyTorch in ``dtype`` (``torch.int64``, or a precision below it for
the control), one block of specs at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from kccap_bench.reference.fit import _fits

__all__ = ["zone_members", "spread_totals"]

_BLOCK = 256  # specs per block: [256, N] intermediates


def zone_members(fixture: dict, cols, topology_key: str):
    """``(member[N], zones)``: each node's domain index, -1 for a node of
    no domain (unhealthy, or without the key), and how many domains."""
    index: dict = {}
    member = np.full(cols.n_nodes, -1, dtype=np.int64)
    for i, node in enumerate(fixture["nodes"]):
        value = (node.get("labels") or {}).get(topology_key)
        if value is None or not cols.healthy[i]:
            continue
        member[i] = index.setdefault(value, len(index))
    return member, len(index)


def spread_totals(cols, fixture, topology_key, max_skew, requests, replicas,
                  *, dtype=torch.int64, device="cpu"):
    """``(totals[S] int64, schedulable[S] bool)``, numpy, of an ``[S, 2]``
    cpu and memory request matrix on ``cols`` (a strict
    :class:`~.pack.Columns` of ``fixture``)."""
    requests = np.asarray(requests, dtype=np.int64)
    replicas = np.asarray(replicas, dtype=np.int64)
    if (requests <= 0).any():
        raise ValueError("a request of 0 or less")
    member, zones = zone_members(fixture, cols, topology_key)
    if zones == 0:
        return np.zeros(len(replicas), dtype=np.int64), replicas <= 0

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    headroom = [t(cols.alloc[r] - cols.used[r]) for r in ("cpu", "memory")]
    slots = torch.clamp_min(t(cols.alloc_pods - cols.pods_count), 0).to(dtype)
    live = t(cols.healthy & cols.mask)
    keyed = t(member >= 0)
    zone = t(np.maximum(member, 0))
    req = t(requests)
    totals = []
    for lo in range(0, req.shape[0], _BLOCK):
        block = req[lo:lo + _BLOCK]
        fit = torch.minimum(_fits(headroom[0], block[:, 0], dtype).to(dtype),
                            _fits(headroom[1], block[:, 1], dtype).to(dtype))
        fit = torch.clamp_min(torch.minimum(fit, slots[None, :]), 0)
        fit = torch.where(live[None, :] & keyed[None, :], fit,
                          torch.zeros_like(fit))
        c = torch.zeros((block.shape[0], zones), dtype=dtype,
                        device=device).index_add_(1, zone, fit)
        floor = c.min(dim=1, keepdim=True).values
        totals.append(torch.minimum(c, floor + max_skew).sum(dim=1,
                                                             dtype=dtype))
    totals = torch.cat(totals).to(torch.int64).cpu().numpy()
    return totals, totals >= replicas
