"""The exact int64 capacity fit: the reference's per-node loop as tensor math.

Counterpart of ``kubernetesclustercapacity_tpu/ops/fit.py`` (``_trunc_div``,
``fit_per_node``, ``fit_totals``, ``_apply_mode``, ``sweep_grid``,
``sweep_grid_grouped``, the grouped expansion, the R-resource
``fit_per_node_multi`` / ``sweep_grid_multi``, and the fused sweep+explain
and sweep+quantile programs), as plain PyTorch on whatever device the
tensors live on.  The reference computes one scenario with a sequential Go
loop (``ClusterCapacity.go:105-140``); here the scenario axis is a batch
dimension written out, processed in ``[S_chunk, N]`` blocks so memory stays
bounded at any S.

Bit-exactness notes:

* CPU math is Go ``uint64`` on int64 bit patterns.  PyTorch has no usable
  unsigned 64-bit ``//``, ``<=`` or ``-``, so they are emulated: unsigned
  compare flips the sign bit and compares signed, subtraction wraps
  identically, and unsigned division splits on the top bits
  (:func:`_u64_div`).
* Memory math is Go ``int64``: subtraction wraps, and division truncates
  toward zero where ``//`` floors (:func:`_trunc_div`).
* The reference's pod cap (Q1) OVERWRITES the fit with
  ``alloc_pods - pods_count`` (possibly negative) only when
  ``fit >= alloc_pods``.
* Sums wrap mod 2^64, as in Go and XLA.

Modes: ``"reference"`` is bug-compatible; ``"strict"`` is the corrected
3-way min with remaining pod slots, clamped at 0, unhealthy nodes zeroed.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from kubernetesclustercapacity_tpu_torch import devcache as _devcache
from kubernetesclustercapacity_tpu_torch.snapshot import grouped_for_dispatch
from kubernetesclustercapacity_tpu_torch.telemetry import (
    compilewatch as _compilewatch,
)
from kubernetesclustercapacity_tpu_torch.telemetry import phases as _phases
from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
    enabled as _telemetry_enabled,
)

__all__ = [
    "AsyncFetch",
    "fetch",
    "observed_fetch",
    "fit_per_node",
    "fit_per_node_multi",
    "fit_snapshot",
    "fit_totals",
    "sweep_explain_grid",
    "sweep_explain_grouped",
    "sweep_quantiles_grid",
    "sweep_quantiles_grouped",
    "sweep_quantiles_snapshot",
    "sweep_grid",
    "sweep_grid_grouped",
    "sweep_grid_multi",
    "sweep_grid_multi_staged",
    "sweep_grid_staged",
    "sweep_grouped_staged",
    "sweep_snapshot",
]

_INT64_MIN = -(1 << 63)
_INT64_MAX = (1 << 63) - 1

#: Cells per ``[S_chunk, N]`` block of the scenario batch (int64: 32 MiB a
#: temporary).
BLOCK_CELLS = 1 << 22


def _u64_le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a <= b`` on the uint64 values of int64 bit patterns."""
    return (a ^ _INT64_MIN) <= (b ^ _INT64_MIN)


def _u64_div(a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``a / d`` on uint64 values of int64 bit patterns, ``d != 0``.

    * ``d``'s top bit set: the quotient is ``a >=u d`` (0 or 1);
    * ``a``'s top bit clear: both are non-negative, so ``//`` is exact;
    * otherwise ``q = ((a >>> 1) // d) << 1`` leaves a remainder in
      ``[0, 2d)``, and one fixup adds the last unit.

    Every branch divides by a positive divisor, so no branch can trap.
    """
    d_top = d < 0
    d_pos = torch.where(d_top, 1, d)
    q_low = a // d_pos
    q_high = (((a >> 1) & _INT64_MAX) // d_pos) << 1
    q_high = q_high + _u64_le(d_pos, a - q_high * d_pos).to(torch.int64)
    q = torch.where(a < 0, q_high, q_low)
    return torch.where(d_top, _u64_le(d, a).to(torch.int64), q)


def _trunc_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """Go int64 division: truncate toward zero (``//`` floors negatives).

    Floor-division plus a remainder correction rather than ``abs``:
    ``abs(INT64_MIN)`` wraps back to INT64_MIN, and wrapped memory
    headrooms can land exactly there.
    """
    q = num // den
    r = num - q * den
    fixup = ((r != 0) & ((num < 0) != (den < 0))).to(q.dtype)
    return q + fixup


def fit_per_node(
    alloc_cpu: torch.Tensor,
    alloc_mem: torch.Tensor,
    alloc_pods: torch.Tensor,
    used_cpu: torch.Tensor,
    used_mem: torch.Tensor,
    pods_count: torch.Tensor,
    healthy: torch.Tensor,
    cpu_req: torch.Tensor,
    mem_req: torch.Tensor,
    *,
    mode: str = "reference",
    node_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-node replica fit, int64.

    Node columns are ``[N]`` int64 (``healthy`` bool); ``cpu_req`` and
    ``mem_req`` are int64 tensors that broadcast against them — a scalar
    for one scenario, ``[S, 1]`` for a batch (giving ``[S, N]``).  A zero
    request divides by 1 (the grid layer rejects zeros first, as the
    reference would panic).  ``node_mask`` (``[N]`` bool) zeroes
    constraint-infeasible nodes after the mode epilogue.
    """
    cpu_fit, mem_fit = _resource_fits(
        alloc_cpu, alloc_mem, used_cpu, used_mem, cpu_req, mem_req
    )
    fit = torch.minimum(cpu_fit, mem_fit)  # findMin (:159-164)
    fit = _apply_mode(fit, alloc_pods, pods_count, healthy, mode)
    if node_mask is not None:
        fit = torch.where(node_mask, fit, 0)
    return fit


def _resource_fits(alloc_cpu, alloc_mem, used_cpu, used_mem, cpu_req,
                   mem_req):
    """``(cpu_fit, mem_fit)``, the per-resource quotients on their int64
    carriers — the one prologue :func:`fit_per_node` and
    :func:`..explain.explain_per_node` share, so their fits are the same
    bits."""
    # CPU: Go uint64 compare/divide on the raw bit patterns (:119-123).
    cpu_fit = torch.where(
        _u64_le(alloc_cpu, used_cpu),
        0,
        _u64_div(alloc_cpu - used_cpu, torch.where(cpu_req == 0, 1, cpu_req)),
    )
    # Memory: Go int64 wrap-around subtraction + truncating div (:125-129).
    mem_fit = torch.where(
        alloc_mem <= used_mem,
        0,
        _trunc_div(alloc_mem - used_mem, torch.where(mem_req == 0, 1, mem_req)),
    )
    return cpu_fit, mem_fit


def fit_totals(
    alloc_cpu, alloc_mem, alloc_pods, used_cpu, used_mem, pods_count, healthy,
    cpu_req, mem_req, *,
    mode: str = "reference",
) -> torch.Tensor:
    """Cluster total for one scenario: ``sum_n fit[n]``, a 0-dim int64
    tensor."""
    return fit_per_node(
        alloc_cpu, alloc_mem, alloc_pods, used_cpu, used_mem, pods_count,
        healthy, cpu_req, mem_req, mode=mode,
    ).sum()


def fit_snapshot(
    snapshot,
    cpu_req: int,
    mem_req: int,
    *,
    mode: str = "reference",
    node_mask=None,
    device="cuda",
) -> np.ndarray:
    """:func:`fit_per_node` for one spec against a snapshot's
    device-resident columns: numpy ``fits[N]``.  ``cpu_req`` is the int64
    bit pattern of the uint64 request."""
    device = _devcache.resolve_device(device)
    cols = _devcache.CACHE.exact_tensors(snapshot, device)
    mask = None
    if node_mask is not None:
        mask = _devcache.to_device(np.asarray(node_mask, dtype=bool), device)
    fits = fit_per_node(
        *cols,
        torch.tensor(cpu_req, dtype=torch.int64, device=device),
        torch.tensor(mem_req, dtype=torch.int64, device=device),
        mode=mode,
        node_mask=mask,
    )
    return fits.cpu().numpy()


def _apply_mode(fit, alloc_pods, pods_count, healthy, mode: str):
    """The pod-count epilogue."""
    if mode == "reference":
        # Q1: conditional overwrite — only when fit >= allocatablePods, and
        # the replacement ignores that cpu/mem may bind tighter (:134-136).
        return torch.where(fit >= alloc_pods, alloc_pods - pods_count, fit)
    if mode == "strict":
        slots = torch.clamp_min(alloc_pods - pods_count, 0)
        fit = torch.clamp_min(torch.minimum(fit, slots), 0)
        return torch.where(healthy, fit, 0)
    raise ValueError(f"unknown mode {mode!r}")


def fit_per_node_multi(
    alloc_rn: torch.Tensor,
    used_rn: torch.Tensor,
    alloc_pods: torch.Tensor,
    pods_count: torch.Tensor,
    healthy: torch.Tensor,
    reqs: torch.Tensor,
    *,
    mode: str = "strict",
    node_mask: torch.Tensor | None = None,
    max_per_node: torch.Tensor | int | None = None,
) -> torch.Tensor:
    """R-resource fit (BASELINE config 4): ``min`` over resource rows, int64.

    ``alloc_rn``/``used_rn`` are ``[R, N]`` int64 (rows in the caller's
    resource order); ``reqs`` is ``[R]`` for one scenario (giving ``[N]``)
    or ``[S, R]`` for a batch (giving ``[S, N]``).  A zero request means
    "does not consume this resource": the row gives ``INT64_MAX`` and drops
    out of the min.  Every row is plain int64 (not the uint64 CPU quirk of
    :func:`fit_per_node`): subtraction wraps, division truncates, and a
    negative request divides as-is.  The min is taken row by row, so the
    batch never holds an ``[S, R, N]`` tensor.

    ``node_mask`` (``[N]`` or ``[S, N]`` bool) zeroes constraint-infeasible
    nodes; ``max_per_node`` (a scalar, or ``[S, 1]`` for a batch) clamps
    per-node replicas, both after the mode epilogue.
    """
    fit = None
    for r in range(alloc_rn.shape[0]):
        req = reqs[..., r, None]
        alloc, used = alloc_rn[r], used_rn[r]
        fit_r = torch.where(
            req == 0,
            _INT64_MAX,
            torch.where(
                alloc <= used,
                0,
                _trunc_div(alloc - used, torch.where(req == 0, 1, req)),
            ),
        )
        fit = fit_r if fit is None else torch.minimum(fit, fit_r)
    fit = _apply_mode(fit, alloc_pods, pods_count, healthy, mode)
    if max_per_node is not None:
        fit = torch.minimum(fit, torch.as_tensor(
            max_per_node, dtype=torch.int64, device=fit.device
        ))
    if node_mask is not None:
        fit = torch.where(node_mask, fit, 0)
    return fit


def sweep_grid_multi(
    alloc_rn, used_rn, alloc_pods, pods_count, healthy, reqs_sr, replicas, *,
    mode: str = "strict",
    node_masks: torch.Tensor | None = None,
    max_per_node: torch.Tensor | int | None = None,
    return_per_node: bool = False,
):
    """S scenarios × R resources: ``reqs_sr`` is ``[S, R]`` int64.

    ``node_masks`` may be ``None``, a shared ``[N]`` or a per-scenario
    ``[S, N]`` bool mask; ``max_per_node`` may be ``None``, a scalar or an
    ``[S]`` int64 tensor.  Computed over ``[S_chunk, N]`` blocks; returns
    ``(totals[S], schedulable[S])`` tensors, plus ``fits[S, N]`` with
    ``return_per_node``.
    """
    n = int(alloc_rn.shape[1])
    s = int(reqs_sr.shape[0])
    step = max(1, BLOCK_CELLS // max(n, 1))
    per_scenario_mask = node_masks is not None and node_masks.dim() == 2
    per_scenario_cap = isinstance(max_per_node, torch.Tensor) and \
        max_per_node.dim() == 1
    totals, fits_out = [], []
    for lo in range(0, s, step):
        hi = lo + step
        mask = node_masks[lo:hi] if per_scenario_mask else node_masks
        cap = max_per_node[lo:hi, None] if per_scenario_cap else max_per_node
        fits = fit_per_node_multi(
            alloc_rn, used_rn, alloc_pods, pods_count, healthy,
            reqs_sr[lo:hi], mode=mode, node_mask=mask, max_per_node=cap,
        )
        totals.append(fits.sum(dim=1))
        if return_per_node:
            fits_out.append(fits)
    device = alloc_rn.device
    totals = torch.cat(totals) if totals else torch.zeros(
        0, dtype=torch.int64, device=device
    )
    schedulable = totals >= replicas
    if not return_per_node:
        return totals, schedulable
    fits = torch.cat(fits_out) if fits_out else torch.zeros(
        (0, n), dtype=torch.int64, device=device
    )
    return totals, schedulable, fits


def sweep_grid_multi_staged(
    alloc_rn, used_rn, alloc_pods, pods_count, healthy, reqs_sr, replicas, *,
    mode: str = "strict",
    node_masks=None,
    max_per_node=None,
    return_per_node: bool = False,
    device="cuda",
):
    """:func:`sweep_grid_multi` on numpy inputs, numpy results; every
    operand is staged to ``device`` per call."""
    device = _devcache.resolve_device(device)

    def put(a, dtype=np.int64):
        return _devcache.to_device(np.asarray(a, dtype=dtype), device)

    if max_per_node is not None:
        cap = np.asarray(max_per_node, dtype=np.int64)
        max_per_node = int(cap) if cap.ndim == 0 else put(cap)
    t0 = time.perf_counter()
    with _phases.current().live("device_exec"):
        out = sweep_grid_multi(
            put(alloc_rn), put(used_rn), put(alloc_pods), put(pods_count),
            put(healthy, bool), put(reqs_sr), put(replicas),
            mode=mode,
            node_masks=None if node_masks is None else put(node_masks, bool),
            max_per_node=max_per_node,
            return_per_node=return_per_node,
        )
    return observed_fetch("torch_int64_multi", t0, out)


def _sweep(cols, counts, cpu_reqs, mem_reqs, replicas, *, mode, node_mask,
           return_fits):
    n = int(cols[0].shape[0])
    s = int(cpu_reqs.shape[0])
    step = max(1, BLOCK_CELLS // max(n, 1))
    totals, fits_out = [], []
    for lo in range(0, s, step):
        fits = fit_per_node(
            *cols,
            cpu_reqs[lo:lo + step, None],
            mem_reqs[lo:lo + step, None],
            mode=mode,
            node_mask=node_mask,
        )
        totals.append((fits if counts is None else fits * counts).sum(dim=1))
        if return_fits:
            fits_out.append(fits)
    device = cols[0].device
    if totals:
        totals = torch.cat(totals)
    else:
        totals = torch.zeros(0, dtype=torch.int64, device=device)
    schedulable = totals >= replicas
    if not return_fits:
        return totals, schedulable
    if fits_out:
        fits = torch.cat(fits_out)
    else:
        fits = torch.zeros((0, n), dtype=torch.int64, device=device)
    return totals, schedulable, fits


def sweep_grid(
    alloc_cpu, alloc_mem, alloc_pods, used_cpu, used_mem, pods_count, healthy,
    cpu_reqs, mem_reqs, replicas, *,
    mode: str = "reference",
    node_mask: torch.Tensor | None = None,
    return_per_node: bool = False,
):
    """S scenarios against N nodes: ``(totals[S], schedulable[S])`` tensors,
    plus ``fits[S, N]`` with ``return_per_node``.  Inputs are tensors on
    one device: the seven ``[N]`` node columns, ``[S]`` int64 requests and
    replicas, and an optional shared ``[N]`` bool ``node_mask``."""
    return _sweep(
        (alloc_cpu, alloc_mem, alloc_pods, used_cpu, used_mem, pods_count,
         healthy),
        None, cpu_reqs, mem_reqs, replicas,
        mode=mode, node_mask=node_mask, return_fits=return_per_node,
    )


def sweep_grid_grouped(
    alloc_cpu, alloc_mem, alloc_pods, used_cpu, used_mem, pods_count, healthy,
    counts, cpu_reqs, mem_reqs, replicas, *,
    mode: str = "reference",
    return_per_group: bool = False,
):
    """S scenarios against G node-shape GROUPS weighted by ``counts[G]``.

    A group's fit is every member's fit (identical inputs), so the
    cluster total is ``Σ_g count_g · fit_g`` — bit-exact against the
    per-node sum even on wrapped carriers, since int64 multiply and add
    are both mod 2^64.  Returns ``(totals[S], schedulable[S])`` and, with
    ``return_per_group``, ``fits[S, G]``.
    """
    return _sweep(
        (alloc_cpu, alloc_mem, alloc_pods, used_cpu, used_mem, pods_count,
         healthy),
        counts, cpu_reqs, mem_reqs, replicas,
        mode=mode, node_mask=None, return_fits=return_per_group,
    )


def _scenario_tensors(cpu_reqs, mem_reqs, replicas, device):
    return tuple(
        _devcache.to_device(np.asarray(a, dtype=np.int64), device)
        for a in (cpu_reqs, mem_reqs, replicas)
    )


def sweep_grid_staged(
    alloc_cpu, alloc_mem, alloc_pods, used_cpu, used_mem, pods_count, healthy,
    cpu_reqs, mem_reqs, replicas, *,
    mode: str = "reference",
    node_mask=None,
    return_per_node: bool = False,
    snapshot=None,
    device="cuda",
    sync: bool = True,
):
    """:func:`sweep_grid` on numpy inputs, numpy results.

    When ``snapshot`` is given the node columns come device-resident from
    :mod:`..devcache` (no per-request upload); the positional arrays are
    then not re-staged.  ``sync=False`` returns :class:`AsyncFetch` views
    instead of numpy arrays (see :func:`fetch`).
    """
    device = _devcache.resolve_device(device)
    if snapshot is not None:
        cols = _devcache.CACHE.exact_tensors(snapshot, device)
    else:
        cols = _devcache.stage_exact(
            (alloc_cpu, alloc_mem, alloc_pods, used_cpu, used_mem,
             pods_count, healthy),
            device,
        )
    mask = None
    if node_mask is not None:
        mask = _devcache.to_device(np.asarray(node_mask, dtype=bool), device)
    t0 = time.perf_counter()
    with _phases.current().live("device_exec"):
        out = sweep_grid(
            *cols, *_scenario_tensors(cpu_reqs, mem_reqs, replicas, device),
            mode=mode, node_mask=mask, return_per_node=return_per_node,
        )
    return observed_fetch("torch_int64", t0, out, sync=sync)


def sweep_grouped_staged(
    grouped,
    cpu_reqs,
    mem_reqs,
    replicas,
    *,
    mode: str = "reference",
    node_mask=None,
    return_per_node: bool = False,
    device="cuda",
    sync: bool = True,
):
    """The exact sweep over ``G`` group rows instead of ``N`` node rows,
    numpy in and out, with per-node fits expanded back through the
    group index where asked.

    ``node_mask`` folds into the per-group counts (a masked node's fit is
    zero in every mode, so dropping it from its group's count is the same
    sum); per-group fits stay mask-independent and the per-node expansion
    re-applies the mask.  ``sync=False`` returns :class:`AsyncFetch`
    views of the totals; the per-node expansion is host work, so
    ``return_per_node`` always materializes.
    """
    device = _devcache.resolve_device(device)
    cols = _devcache.CACHE.grouped_exact_tensors(grouped, device)
    counts = _devcache.to_device(grouped.effective_counts(node_mask), device)
    t0 = time.perf_counter()
    with _phases.current().live("device_exec"):
        out = sweep_grid_grouped(
            *cols, counts,
            *_scenario_tensors(cpu_reqs, mem_reqs, replicas, device),
            mode=mode, return_per_group=return_per_node,
        )
    out = observed_fetch("torch_int64_grouped", t0, out,
                         sync=sync or return_per_node)
    if not return_per_node:
        return out
    fits = grouped.expand(out[2])
    if node_mask is not None:
        fits = np.where(np.asarray(node_mask, dtype=bool)[None, :], fits, 0)
    return out[0], out[1], fits


class AsyncFetch:
    """Device results on their way to the host, without a wait.

    The tensors (int64 or bool, one device) are packed into one int64
    device buffer and copied into one pinned host buffer with
    ``non_blocking=True`` on the current stream; a CUDA event recorded
    after the copy is the only thing :meth:`arrays` waits on, so the
    caller blocks when it reads the result, never when it launches, and
    never on the whole device.  On the CPU the values are already there
    and nothing is waited on.  Thread-safe: the first reader pays the
    wait, later readers get the cached numpy arrays.
    """

    def __init__(self, tensors) -> None:
        tensors = tuple(tensors)
        self._meta = [(t.dtype, tuple(t.shape)) for t in tensors]
        self._lock = threading.Lock()
        self._np: tuple | None = None
        self._event = None
        #: The packed device buffer, held until the copy is read (the
        #: service books it in the device-memory ledger meanwhile).
        self.staged: torch.Tensor | None = None
        device = tensors[0].device if tensors else torch.device("cpu")
        if device.type == "cuda":
            packed = torch.cat(
                [t.reshape(-1).to(torch.int64) for t in tensors]
            )
            host = torch.empty(
                packed.shape, dtype=torch.int64, pin_memory=True
            )
            host.copy_(packed, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device))
            self.staged = packed
            self._host = host
        else:
            self._host = tensors

    def arrays(self) -> tuple:
        """The results as numpy arrays of their own dtypes and shapes."""
        with self._lock:
            if self._np is None:
                if self._event is None:
                    self._np = tuple(t.numpy() for t in self._host)
                else:
                    self._event.synchronize()
                    flat = self._host.numpy()
                    out, lo = [], 0
                    for dtype, shape in self._meta:
                        size = int(np.prod(shape, dtype=np.int64))
                        a = flat[lo:lo + size].reshape(shape)
                        out.append(a.astype(bool) if dtype == torch.bool
                                   else a.copy())
                        lo += size
                    self._np = tuple(out)
                self._event = self._host = self.staged = None
            return self._np


class _AsyncView:
    """One result of an :class:`AsyncFetch`, sliced on the host when it
    materializes (the numpy ``__array__`` protocol, so the caller's
    ``np.asarray`` is the sync point)."""

    __slots__ = ("fetch", "_which", "_key")

    def __init__(self, fetch, which: int, key=slice(None)) -> None:
        self.fetch = fetch
        self._which = which
        self._key = key

    def __array__(self, dtype=None, copy=None):
        host = self.fetch.arrays()[self._which][self._key]
        return host if dtype is None else np.asarray(host, dtype)


def fetch(tensors, *, sync: bool = True) -> tuple:
    """Bring results to the host: numpy arrays under ``sync``, else
    :class:`_AsyncView` objects over one :class:`AsyncFetch` (one pinned
    copy and one event for all of them)."""
    if sync:
        return tuple(t.cpu().numpy() for t in tensors)
    pending = AsyncFetch(tensors)
    return tuple(_AsyncView(pending, i) for i in range(len(pending._meta)))


def observed_fetch(label: str, t0: float, tensors, *, sync: bool = True):
    """:func:`fetch` for a dispatch launched at ``t0``, accounted for.

    The request's phase clock gets ``device_exec`` (``t0`` until now, the
    launch) and ``fetch`` (the copy and its wait), and compilewatch files
    the whole host-timed interval under ``label``; a label's first
    dispatch (the kernel build or library load on the card) is filed,
    and clocked, as ``compile``.  An asynchronous fetch is neither timed
    nor observed: its host interval excludes the device wait.
    """
    clk = _phases.current()
    t_launch = time.perf_counter()
    with clk.live("fetch"):
        out = fetch(tensors, sync=sync)
    if not sync:
        return out
    t_done = time.perf_counter()
    kind = None
    if _telemetry_enabled():
        kind = _compilewatch.observe_dispatch(label, t_done - t0)
    if clk:
        if kind == "compile":
            clk.record("compile", t_done - t0)
        else:
            clk.record("device_exec", t_launch - t0)
            clk.record("fetch", t_done - t_launch)
    return out


def sweep_snapshot(
    snapshot,
    grid,
    *,
    mode: str = "reference",
    return_per_node: bool = False,
    node_mask=None,
    sync: bool = True,
    device="cuda",
):
    """The exact program's snapshot entry: ``ClusterSnapshot`` ×
    ``ScenarioGrid`` → ``(totals[S], schedulable[S][, fits[S, N]])``.

    Counterpart of the JAX package's ``ops/fit.sweep_snapshot``.
    Validates the grid the way the reference's flag layer would (nonzero
    requests), then runs the int64 program on the snapshot's
    device-resident columns (:mod:`..devcache`).  ``node_mask`` (``[N]``
    bool) zeroes constraint-infeasible nodes for every scenario.
    Degenerate fleets run over node-shape groups
    (:func:`..snapshot.grouped_for_dispatch`).  Returns numpy arrays, or,
    with ``sync=False``, views whose ``np.asarray`` waits for the pinned
    copy (the grouped route's per-node expansion always materializes).
    Values are identical either way.  ``device`` defaults to ``"cuda"``
    and raises when no card is present.
    """
    grid.validate()
    grouped = grouped_for_dispatch(snapshot)
    if grouped is not None:
        return sweep_grouped_staged(
            grouped, grid.cpu_request_milli, grid.mem_request_bytes,
            grid.replicas, mode=mode, node_mask=node_mask,
            return_per_node=return_per_node, device=device, sync=sync,
        )
    return sweep_grid_staged(
        None, None, None, None, None, None, None,
        grid.cpu_request_milli, grid.mem_request_bytes, grid.replicas,
        mode=mode, node_mask=node_mask, return_per_node=return_per_node,
        snapshot=snapshot, device=device, sync=sync,
    )


# The fused programs: one call answers a sweep AND its explanation or its
# order statistics.  The explain attribution needs the full int64
# per-resource quotients, which the fused int32 kernels do not carry, so
# these ride the exact program's arithmetic: their totals are the explain
# fits summed on the device, bit-exact against a solo sweep by
# construction (the fits ARE fit_per_node's).


def sweep_explain_grid(
    alloc_cpu, alloc_mem, alloc_pods, used_cpu, used_mem, pods_count, healthy,
    cpu_reqs, mem_reqs, replicas, *,
    mode: str = "reference",
    node_mask: torch.Tensor | None = None,
):
    """Fused sweep+explain: ``(totals[S], schedulable[S], fits[S, N],
    code[S, N], cpu_fit[S, N], mem_fit[S, N], slots[S, N])`` tensors — the
    first two :func:`sweep_grid`'s outputs, the rest
    :func:`..explain.explain_grid`'s.  (The late import keeps the
    ``explain → ops.fit`` dependency acyclic.)"""
    from kubernetesclustercapacity_tpu_torch.explain import explain_grid

    per_node = explain_grid(
        alloc_cpu, alloc_mem, alloc_pods, used_cpu, used_mem, pods_count,
        healthy, cpu_reqs, mem_reqs, mode=mode, node_mask=node_mask,
    )
    totals = per_node[0].sum(dim=1)
    return (totals, totals >= replicas, *per_node)


def sweep_explain_grouped(
    alloc_cpu, alloc_mem, alloc_pods, used_cpu, used_mem, pods_count, healthy,
    counts, cpu_reqs, mem_reqs, replicas, *,
    mode: str = "reference",
):
    """Grouped fused sweep+explain: attribution over ``G`` node-shape
    groups with count-weighted totals (a node mask folds into ``counts``
    upstream and re-applies per node after expansion).  Outputs are
    ``[S]`` / ``[S, G]``."""
    from kubernetesclustercapacity_tpu_torch.explain import explain_grid

    per_node = explain_grid(
        alloc_cpu, alloc_mem, alloc_pods, used_cpu, used_mem, pods_count,
        healthy, cpu_reqs, mem_reqs, mode=mode,
    )
    totals = (per_node[0] * counts).sum(dim=1)
    return (totals, totals >= replicas, *per_node)


def _order_statistics(totals: torch.Tensor, q_indices: tuple):
    """``(qvals, qidx)`` at ``q_indices`` of the stable ascending order: a
    stable sort has one permutation, so ties resolve as numpy's
    ``argsort(kind="stable")`` and ``jnp.argsort(stable=True)`` resolve
    them."""
    order = torch.argsort(totals, stable=True)
    qi = torch.tensor(q_indices, dtype=torch.int64, device=totals.device)
    return totals[order][qi], order[qi]


def sweep_quantiles_grid(
    alloc_cpu, alloc_mem, alloc_pods, used_cpu, used_mem, pods_count, healthy,
    cpu_reqs, mem_reqs, replicas, *,
    mode: str = "reference",
    q_indices: tuple = (),
    node_mask: torch.Tensor | None = None,
):
    """Fused sweep+quantile: ``(totals[S], schedulable[S], qvals[Q],
    qidx[Q])``, the order statistics at the sorted-ascending indices
    ``q_indices`` taken on the device (the capacity-at-risk hot path)."""
    totals, schedulable = sweep_grid(
        alloc_cpu, alloc_mem, alloc_pods, used_cpu, used_mem, pods_count,
        healthy, cpu_reqs, mem_reqs, replicas,
        mode=mode, node_mask=node_mask,
    )
    return (totals, schedulable, *_order_statistics(totals, q_indices))


def sweep_quantiles_grouped(
    alloc_cpu, alloc_mem, alloc_pods, used_cpu, used_mem, pods_count, healthy,
    counts, cpu_reqs, mem_reqs, replicas, *,
    mode: str = "reference",
    q_indices: tuple = (),
):
    """Grouped twin of :func:`sweep_quantiles_grid` (count-weighted
    totals; a node mask folds into ``counts`` upstream)."""
    totals, schedulable = sweep_grid_grouped(
        alloc_cpu, alloc_mem, alloc_pods, used_cpu, used_mem, pods_count,
        healthy, counts, cpu_reqs, mem_reqs, replicas, mode=mode,
    )
    return (totals, schedulable, *_order_statistics(totals, q_indices))


def sweep_quantiles_snapshot(
    snapshot,
    grid,
    *,
    mode: str | None = None,
    node_mask=None,
    q_indices: tuple = (),
    device="cuda",
):
    """Dispatch entry for the fused sweep+quantile program: the
    snapshot's device-resident columns, the grouped route when it pays, no
    scenario padding (pad probes would enter the sort).  ``mode`` defaults
    to the snapshot's packing semantics.  Returns numpy ``(totals[S],
    schedulable[S], qvals, qidx, kernel_name)``, the name
    ``torch_int64_sweep_qtile`` or ``torch_int64_sweep_qtile_grouped``.
    """
    mode = mode or snapshot.semantics
    grid.validate()
    device = _devcache.resolve_device(device)
    q_indices = tuple(int(i) for i in q_indices)
    scen = _scenario_tensors(
        grid.cpu_request_milli, grid.mem_request_bytes, grid.replicas, device
    )
    grouped = grouped_for_dispatch(snapshot)
    clk = _phases.current()
    if grouped is not None:
        cols = _devcache.CACHE.grouped_exact_tensors(grouped, device)
        counts = _devcache.to_device(
            grouped.effective_counts(node_mask), device
        )
        t0 = time.perf_counter()
        with clk.live("device_exec"):
            out = sweep_quantiles_grouped(
                *cols, counts, *scen, mode=mode, q_indices=q_indices,
            )
        kernel = "torch_int64_sweep_qtile_grouped"
    else:
        mask = None
        if node_mask is not None:
            mask = _devcache.to_device(
                np.asarray(node_mask, dtype=bool), device
            )
        cols = _devcache.CACHE.exact_tensors(snapshot, device)
        t0 = time.perf_counter()
        with clk.live("device_exec"):
            out = sweep_quantiles_grid(
                *cols, *scen, mode=mode, q_indices=q_indices,
                node_mask=mask,
            )
        kernel = "torch_int64_sweep_qtile"
    return (*observed_fetch(kernel, t0, out), kernel)
