"""Runtime value guards: the fit with explicit validity checks.

Counterpart of ``kubernetesclustercapacity_tpu/utils/guards.py``, whose
checks run in-graph through ``jax.experimental.checkify``.  Here they are
plain torch checks in the same order, raising :class:`GuardError` (a
``ValueError``, as checkify's error is) with the same messages, so a
violation surfaces as a Python error instead of a silently wrong total.
For tests and debugging sessions; no main path calls it.

Checks:

* nonzero requests (the reference integer-divide-by-zero panic sites,
  ``ClusterCapacity.go:123,129``);
* no negative snapshot values (wrapped uint64 bit patterns reaching a mode
  that assumes non-negativity);
* the sum-of-fits wrap guard: accepted only when ``n * max|fit|`` proves
  the int64 total cannot have wrapped (a data-derived bound — huge but
  legitimate per-node fits are not false positives).
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetesclustercapacity_tpu_torch.devcache import (
    resolve_device,
    to_device,
)
from kubernetesclustercapacity_tpu_torch.ops.fit import (
    fit_per_node,
    fit_per_node_multi,
)

__all__ = ["GuardError", "checked_fit_totals", "checked_fit_totals_multi"]


class GuardError(ValueError):
    """A failed guard (the message names the violated check)."""


def _check(ok, message: str) -> None:
    if not bool(ok):
        raise GuardError(f"{message} (`check` failed)")


def _int64(a, device) -> torch.Tensor:
    return to_device(np.asarray(a, dtype=np.int64), device)


def _check_sum_headroom(fits: torch.Tensor) -> None:
    """Sum-of-fits wrap guard with a bound derived from the DATA.

    ``n * max|fit|`` bounds ``|sum|`` exactly; when that product (taken
    in float64) stays under 2^62, the true sum is under 2^62·(1+ε) —
    far inside int64 — so the computed total cannot have wrapped and is
    accepted.  (The 2^62-vs-2^63 slack IS the margin absorbing the
    float64 rounding of the product.)
    """
    n = fits.shape[0]
    max_abs = int(fits.abs().max()) if n else 0
    _check(
        float(n) * float(max_abs) < 2.0**62,
        "total replica count unverifiable: n * max|fit| reaches int64 "
        "wrap range, the sum may have wrapped",
    )


def checked_fit_totals(
    alloc_cpu, alloc_mem, alloc_pods, used_cpu, used_mem, pods_count,
    healthy, cpu_req, mem_req, *, device="cuda",
) -> int:
    """Fit total (reference semantics) with validity checks; raises
    :class:`GuardError` on the first violated check."""
    device = resolve_device(device)
    alloc_cpu, alloc_mem, alloc_pods, used_cpu, used_mem, pods_count = (
        _int64(a, device)
        for a in (alloc_cpu, alloc_mem, alloc_pods, used_cpu, used_mem,
                  pods_count)
    )
    cpu_req, mem_req = _int64(cpu_req, device), _int64(mem_req, device)
    _check(cpu_req != 0, "cpuRequests is zero: the reference panics "
           "with integer divide by zero (ClusterCapacity.go:123)")
    _check(mem_req != 0, "memRequests is zero: the reference panics "
           "with integer divide by zero (ClusterCapacity.go:129)")
    _check(
        torch.all(alloc_cpu >= 0) & torch.all(used_cpu >= 0),
        "negative CPU values in snapshot (wrapped uint64 bit pattern)",
    )
    _check(
        torch.all(alloc_mem >= 0) & torch.all(used_mem >= 0),
        "negative memory values in snapshot (wrapped int64 sum)",
    )
    _check(
        torch.all(alloc_pods >= 0) & torch.all(pods_count >= 0),
        "negative pod counts in snapshot",
    )
    fits = fit_per_node(
        alloc_cpu, alloc_mem, alloc_pods, used_cpu, used_mem, pods_count,
        to_device(np.asarray(healthy, dtype=bool), device), cpu_req,
        mem_req, mode="reference",
    )
    _check_sum_headroom(fits)
    return int(fits.sum())


def checked_fit_totals_multi(
    alloc_rn, used_rn, alloc_pods, pods_count, healthy, reqs_r, *,
    device="cuda",
) -> int:
    """R-dim (strict) fit total with validity checks."""
    device = resolve_device(device)
    alloc_rn, used_rn, alloc_pods, pods_count, reqs_r = (
        _int64(a, device)
        for a in (alloc_rn, used_rn, alloc_pods, pods_count, reqs_r)
    )
    _check(
        torch.all(reqs_r >= 0),
        "negative resource request in the R-dim grid (zero means "
        "does-not-consume; negative has no defined semantics)",
    )
    _check(
        torch.all(alloc_rn >= 0) & torch.all(used_rn >= 0),
        "negative values in the [R, N] resource matrix",
    )
    _check(
        torch.all(alloc_pods >= 0) & torch.all(pods_count >= 0),
        "negative pod counts in snapshot",
    )
    fits = fit_per_node_multi(
        alloc_rn, used_rn, alloc_pods, pods_count,
        to_device(np.asarray(healthy, dtype=bool), device), reqs_r,
        mode="strict",
    )
    _check_sum_headroom(fits)
    return int(fits.sum())
