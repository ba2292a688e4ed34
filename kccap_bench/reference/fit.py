"""How many replicas of each what-if spec a cluster takes, written plainly.

Per node, per resource: nothing fits when the node has no headroom,
else the headroom over the request, rounded down.  The node's fit is the
least over the resources.  The reference semantics then replaces a fit
of at least the node's pod allowance by the allowance less the pods it
runs (``ClusterCapacity.go:134-136``); strict clamps the fit to the free
pod slots, and gives 0 on an unhealthy or masked node.  A spec's answer
is the sum over the nodes, and it is schedulable when that reaches its
replicas.  In the R-resource question a request of 0 does not consume
its resource.

Plain PyTorch operations, on the card once the server process has
ended (or on the host), one block of specs at a time.  ``dtype`` is
``torch.int64``, the exact arithmetic the answers are held to, or a
precision below it for the control, which the benchmark's comparison
has to reject: ``torch.int32`` (byte quantities wrap) or
``torch.float32`` (quotients round).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["sweep_totals"]

_BLOCK = 256  # specs per block: [256, N] intermediates


def _fits(headroom, reqs, dtype):
    """``[B, N]`` fits of one resource from ``[N]`` headroom and ``[B]``
    requests (a request of 0 is divided as 1; the caller drops it)."""
    den = torch.clamp_min(reqs, 1)[:, None]
    if dtype == torch.int64:
        q = torch.div(headroom[None, :], den, rounding_mode="floor")
    else:
        q = torch.floor(headroom.to(dtype)[None, :] / den.to(dtype))
    return torch.where(headroom[None, :] > 0, q, torch.zeros_like(q))


def sweep_totals(cols, resources, requests, replicas, *, dtype=torch.int64,
                 device="cpu"):
    """``(totals[S] int64, schedulable[S] bool)``, numpy, of an ``[S, R]``
    request matrix over ``resources`` on ``cols`` (a
    :class:`~.pack.Columns`)."""
    requests = np.asarray(requests, dtype=np.int64)
    replicas = np.asarray(replicas, dtype=np.int64)
    if (requests < 0).any():
        raise ValueError("negative request")
    for k, r in enumerate(resources):
        if r in ("cpu", "memory") and (requests[:, k] == 0).any():
            raise ValueError(f"a {r} request of 0")

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    headroom = [t(cols.alloc[r] - cols.used[r]) for r in resources]
    alloc_pods = t(cols.alloc_pods).to(dtype)
    left = t(cols.alloc_pods - cols.pods_count).to(dtype)
    slots = torch.clamp_min(left, 0)
    live = t(cols.healthy & cols.mask)
    req = t(requests)
    big = torch.tensor(torch.finfo(dtype).max if dtype.is_floating_point
                       else torch.iinfo(dtype).max, dtype=dtype,
                       device=device)
    totals = []
    for lo in range(0, req.shape[0], _BLOCK):
        block = req[lo:lo + _BLOCK]
        fit = None
        for k in range(len(resources)):
            q = _fits(headroom[k], block[:, k], dtype).to(dtype)
            q = torch.where((block[:, k] == 0)[:, None], big, q)
            fit = q if fit is None else torch.minimum(fit, q)
        if cols.semantics == "reference":
            fit = torch.where(fit >= alloc_pods[None, :], left[None, :], fit)
        else:
            fit = torch.clamp_min(torch.minimum(fit, slots[None, :]), 0)
            fit = torch.where(live[None, :], fit, torch.zeros_like(fit))
        totals.append(fit.sum(dim=1, dtype=dtype))
    totals = torch.cat(totals).to(torch.int64).cpu().numpy()
    return totals, totals >= replicas
