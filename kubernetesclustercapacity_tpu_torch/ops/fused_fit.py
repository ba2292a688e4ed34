"""The fused int32 sweep: eligibility proofs, the CUDA kernel's wrapper, its
plain PyTorch version, and the sweep dispatchers.

Counterpart of ``kubernetesclustercapacity_tpu/ops/pallas_fit.py``.  The
exact program (:mod:`.fit`) is int64 because memory is tracked in bytes
(node memory ≈ 2^34).  Kubelets report memory in ``Ki`` and realistic pod
requests are MiB-granular, so on real snapshots every memory quantity is a
multiple of 1024, and under that precondition (checked, never assumed) the
whole fit is exact in int32:

    (alloc − used) // req  ==  ((alloc/1024) − (used/1024)) // (req/1024)

The fused kernel (``csrc/sweep_fit.cu``, replacing the TPU kernel
``pallas_fit._make_sweep_kernel``) evaluates every (scenario, node) cell
and reduces over nodes on the card, so the ``[S, N]`` fit matrix never
exists in device memory.

Routing is by eligibility, as in the JAX package: an eligible sweep takes
the fused kernel; an ineligible one, or ``kernel="exact"``, takes the exact
int64 program on the same device.  There is no fallback that hides the
kernel: on a CUDA tensor the wrapper launches the kernel or raises, and a
build or launch failure propagates to the caller.  On a CPU tensor the
wrapper runs the kernel's plain version instead (``plain_*`` labels).
"""

from __future__ import annotations

import ctypes
import threading
import time

import numpy as np
import torch

from kubernetesclustercapacity_tpu_torch import devcache as _devcache
from kubernetesclustercapacity_tpu_torch.ops import _build
from kubernetesclustercapacity_tpu_torch.ops.fit import (
    BLOCK_CELLS,
    observed_fetch,
    sweep_grid_staged,
    sweep_grouped_staged,
)
from kubernetesclustercapacity_tpu_torch.snapshot import grouped_for_dispatch
from kubernetesclustercapacity_tpu_torch.telemetry import phases as _phases

__all__ = [
    "LAUNCHES",
    "PLAIN_CALLS",
    "fast_sweep_eligible",
    "rcp_division_eligible",
    "scenario_reciprocals",
    "sweep_fused",
    "sweep_fused_plain",
    "sweep_auto",
    "sweep_explain_snapshot_auto",
    "sweep_snapshot_auto",
]

#: Launches of the CUDA sweep kernel in this process (one per launch,
#: counted nowhere else).
LAUNCHES = 0
#: Calls of :func:`sweep_fused` that ran the plain version (CPU tensors):
#: the host twin of :data:`LAUNCHES`, so a CPU run can count the
#: dispatches that would launch the kernel on the card.
PLAIN_CALLS = 0
#: Guards both counters: the service's handler threads launch
#: concurrently, and ``+=`` on a module global is not atomic.
_COUNT_LOCK = threading.Lock()


def _count(name: str) -> None:
    with _COUNT_LOCK:
        globals()[name] += 1

#: Threads per block of the CUDA kernels (``kThreads`` in the sources), and
#: the scenarios each thread owns (``kSpt``): a block covers
#: ``SCENARIOS_PER_BLOCK`` scenarios.  B2 above 8 resource rows takes one
#: scenario per thread; its grid is sized in its C entry.
THREADS_PER_BLOCK = 128
SCENARIOS_PER_THREAD = 2
SCENARIOS_PER_BLOCK = THREADS_PER_BLOCK * SCENARIOS_PER_THREAD
#: Blocks the wrapper aims for on each SM, and the fewest nodes a block
#: takes (so a block's staging is worth its launch); measured choices, see
#: PERF.md.  At 10,000 nodes a block takes 76, so the minimum acts only on
#: small node counts, such as the grouped sweep's 48 groups.
BLOCKS_PER_SM = 4
MIN_NODES_PER_BLOCK = 16

_I32_MAX = np.iinfo(np.int32).max


def fast_sweep_eligible(
    alloc_cpu,
    alloc_mem,
    alloc_pods,
    used_cpu,
    used_mem,
    pods_count,
    cpu_reqs,
    mem_reqs,
    *,
    counts=None,
) -> bool:
    """True iff the int32 KiB-rescaled kernel is bit-exact for these inputs.

    Three conditions, all checked — never assumed:

    1. every value non-negative and int32-range (memory after /1024), with
       memory KiB-quantized (the rescale bijection);
    2. every request strictly positive (the fast kernel divides without the
       exact kernel's divisor clamp; zero requests are invalid upstream but
       must not become undefined behavior here);
    3. the worst-case per-scenario TOTAL fits in int32: per node the fit is
       bounded by ``max(alloc_cpu // min_cpu_req, alloc_pods, pods_count)``
       (resource bound, the Q1 cap value, and its negative magnitude), and
       the sum of those bounds must stay under 2^31.  The CUDA kernel sums
       in int64 and needs less: on the card this condition covers the
       per-node int32 product ``fit · count``.  It is kept whole so that
       routing, and so the kernel labels, match the JAX package.

    ``counts`` (grouped dispatch) weights condition 3: the rows are node
    GROUPS and each contributes ``count_g`` times, so the bound is
    ``Σ count_g · bound_g``; the counts themselves must also be
    non-negative int32 (they multiply inside the kernel).
    """
    for a in (alloc_cpu, used_cpu, cpu_reqs, alloc_pods, pods_count):
        a = np.asarray(a)
        if a.size and (a.min() < 0 or a.max() > _I32_MAX):
            return False
    if counts is not None:
        c = np.asarray(counts)
        if c.size and (c.min() < 0 or c.max() > _I32_MAX):
            return False
    for a in (alloc_mem, used_mem, mem_reqs):
        a = np.asarray(a)
        if a.size == 0:
            continue
        if a.min() < 0 or (a % 1024).any() or (a // 1024).max() > _I32_MAX:
            return False
    cpu_reqs = np.asarray(cpu_reqs)
    mem_reqs = np.asarray(mem_reqs)
    if cpu_reqs.size == 0 or mem_reqs.size == 0:
        return True
    if cpu_reqs.min() < 1 or mem_reqs.min() < 1024:
        return False
    per_node_bound = np.maximum(
        np.asarray(alloc_cpu, dtype=np.int64) // int(cpu_reqs.min()),
        np.maximum(
            np.asarray(alloc_pods, dtype=np.int64),
            np.asarray(pods_count, dtype=np.int64),
        ),
    )
    if counts is not None:
        per_node_bound = per_node_bound * np.asarray(counts, dtype=np.int64)
    return int(per_node_bound.sum()) <= _I32_MAX


def rcp_division_eligible(
    alloc_cpu,
    alloc_mem,
    used_cpu,
    used_mem,
    cpu_reqs,
    mem_reqs,
) -> bool:
    """True iff f32-reciprocal division is provably exact for these inputs.

    The rcp kernel replaces each int32 ``//`` (a multi-instruction
    software routine on the device) with ``floor(float32(a) *
    float32(1/d))`` plus ONE integer fixup round.  That is bit-exact when
    the initial estimate lands within ±1 of the true quotient, which
    holds under (callers must already have passed
    :func:`fast_sweep_eligible`, so values are non-negative int32 and
    memory is KiB-quantized; KiB units are used below):

    1. quotient bound: ``max(dividend)/min(divisor) <= 2**20``.  Relative
       f32 error stacks to at most ``5*2^-24 < 2^-21.6`` (one conversion
       each for a and d, one IEEE divide for 1/d, one multiply), so the
       absolute error is ``<= 2^20 * 2^-21.6 < 0.5`` — after ``floor`` the
       estimate is in ``{q-1, q, q+1}``, and one fixup round is EXACT for
       that whole set: est = q-1 gives ``rem = (a - q*d) + d ∈ [d, 2d)``
       (the ``>= d`` branch adds 1), est = q+1 gives ``rem ∈ [-d, 0)``
       (the ``< 0`` branch subtracts 1), est = q gives ``rem ∈ [0, d)``
       (both branches off).  The single round therefore relies on the
       reciprocal being correctly rounded — :func:`scenario_reciprocals`
       is the one sanctioned producer.
    2. divisor bound ``<= 2**29``: keeps the fixup intermediate
       ``a - q*d`` in ``(-d, 2d)`` ⊂ int32 range.

    Dividends are ``alloc - used`` clamped at 0 (negative headrooms are
    where'd out of the result), so ``max(alloc)`` bounds them.
    """
    qmax = np.int64(1) << 20
    dmax = np.int64(1) << 29
    for alloc, reqs, scale in (
        (alloc_cpu, cpu_reqs, 1),
        (alloc_mem, mem_reqs, 1024),
    ):
        alloc = np.asarray(alloc, dtype=np.int64) // scale
        reqs = np.asarray(reqs, dtype=np.int64) // scale
        if alloc.size == 0 or reqs.size == 0:
            continue
        if reqs.min() < 1 or reqs.max() > dmax:
            return False
        if alloc.max() // reqs.min() > qmax:
            return False
    return True


def scenario_reciprocals(padded_requests: np.ndarray) -> np.ndarray:
    """The rcp kernel's proof-bearing reciprocal: f64 divide halved to f32.

    This exact computation (correctly rounded, <= 1/2 ulp) is what the
    reciprocal-division exactness proof assumes; every caller of the rcp
    kernel must stage divisor reciprocals through here.
    """
    return (1.0 / np.asarray(padded_requests).astype(np.float64)).astype(
        np.float32
    )


def _check_operands(nodes, cr, mr, crr, mrr, mask, counts) -> torch.device:
    """Validate the fused sweep's operands; returns their common device."""
    if (crr is None) != (mrr is None):
        raise ValueError("crr and mrr must be given together")
    n = int(nodes[0].shape[0]) if nodes[0].dim() == 1 else -1
    s = int(cr.shape[0]) if cr.dim() == 1 else -1
    expected = [(t, torch.int32, n) for t in nodes]
    expected += [(cr, torch.int32, s), (mr, torch.int32, s)]
    if crr is not None:
        expected += [(crr, torch.float32, s), (mrr, torch.float32, s)]
    for t in (mask, counts):
        if t is not None:
            expected.append((t, torch.int32, n))
    device = nodes[0].device
    for t, dtype, length in expected:
        if t.device != device:
            raise ValueError(
                f"fused sweep operands span devices ({t.device} vs {device})"
            )
        if t.dtype != dtype:
            raise TypeError(f"fused sweep operand is {t.dtype}, want {dtype}")
        if t.dim() != 1 or length < 0 or t.shape[0] != length:
            raise ValueError(
                f"fused sweep operand has shape {tuple(t.shape)}, want "
                f"({length},)"
            )
        if not t.is_contiguous():
            raise ValueError("fused sweep operands must be contiguous")
    return device


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


_SWEEP_ARGTYPES = (ctypes.c_void_p,) * 13 + (
    ctypes.c_longlong,  # n
    ctypes.c_int,  # s
    ctypes.c_longlong,  # chunk
    ctypes.c_int,  # strict
    ctypes.c_void_p,  # stream
)


def _sweep_fn():
    """The bound C entry point, built and declared on first use (without
    ``argtypes`` ctypes would pass each pointer as a 32-bit int)."""
    fn = _build.library("sweep_fit").kccap_sweep_fit
    if fn.argtypes != _SWEEP_ARGTYPES:
        fn.argtypes = _SWEEP_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def node_chunk(n: int, s: int, sm_count: int) -> int:
    """Nodes per block along the grid's y axis: enough blocks to give every
    SM ``BLOCKS_PER_SM`` of them, no block under ``MIN_NODES_PER_BLOCK``
    nodes, and at most 65535 chunks."""
    scenario_blocks = -(-s // SCENARIOS_PER_BLOCK)
    want_chunks = max(1, -(-BLOCKS_PER_SM * sm_count // scenario_blocks))
    chunk = max(MIN_NODES_PER_BLOCK, -(-n // want_chunks))
    return max(chunk, -(-n // 65535))


def sweep_fused(
    ac, am, ap, uc, um, pc, cr, mr, crr=None, mrr=None, mask=None,
    counts=None, *, strict: bool = False,
) -> torch.Tensor:
    """Per-scenario totals of the fused int32 sweep, int64 ``[S]``.

    Operands are 1-D contiguous tensors on one device: six int32 node
    columns ``[N]`` (memory in KiB), int32 requests ``cr``/``mr`` ``[S]``,
    optional float32 reciprocals ``crr``/``mrr`` ``[S]`` from
    :func:`scenario_reciprocals` (selecting the rcp variant), an optional
    int32 0/1 ``mask`` ``[N]`` and optional int32 group ``counts`` ``[N]``.
    Callers prove the inputs eligible first.  On CUDA tensors this launches
    ``csrc/sweep_fit.cu`` (and raises if it cannot); on CPU tensors it runs
    :func:`sweep_fused_plain`.
    """
    device = _check_operands(
        (ac, am, ap, uc, um, pc), cr, mr, crr, mrr, mask, counts
    )
    if device.type == "cpu":
        _count("PLAIN_CALLS")
        return sweep_fused_plain(
            ac, am, ap, uc, um, pc, cr, mr, crr, mrr, mask, counts,
            strict=strict,
        )
    if device.type != "cuda":
        raise ValueError(f"fused sweep runs on cuda or cpu, not {device}")
    n, s = int(ac.shape[0]), int(cr.shape[0])
    totals = torch.zeros(s, dtype=torch.int64, device=device)
    if n == 0 or s == 0:
        return totals
    with torch.cuda.device(device):
        sm_count = torch.cuda.get_device_properties(device).multi_processor_count
        rc = _sweep_fn()(
            _ptr(ac), _ptr(am), _ptr(ap), _ptr(uc), _ptr(um), _ptr(pc),
            _ptr(mask), _ptr(counts), _ptr(cr), _ptr(mr), _ptr(crr),
            _ptr(mrr), _ptr(totals),
            n, s, node_chunk(n, s, sm_count), int(bool(strict)),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"sweep_fit kernel launch failed: CUDA error {rc}")
    _count("LAUNCHES")
    return totals


def sweep_fused_plain(
    ac, am, ap, uc, um, pc, cr, mr, crr=None, mrr=None, mask=None,
    counts=None, *, strict: bool = False,
) -> torch.Tensor:
    """The fused kernel's plain PyTorch version: the same int32 arithmetic
    (the rcp estimate and fixup in float32 included) over ``[S_chunk, N]``
    blocks, summed to int64.  Same operands and result as
    :func:`sweep_fused`; runs on any device."""
    n, s = int(ac.shape[0]), int(cr.shape[0])
    step = max(1, BLOCK_CELLS // max(n, 1))
    out = [torch.zeros(0, dtype=torch.int64, device=ac.device)]
    for lo in range(0, s, step):
        c = cr[lo:lo + step, None]
        m = mr[lo:lo + step, None]
        if crr is not None:
            hc = torch.clamp_min(ac - uc, 0)
            hm = torch.clamp_min(am - um, 0)
            est = torch.minimum(
                hc.to(torch.float32) * crr[lo:lo + step, None],
                hm.to(torch.float32) * mrr[lo:lo + step, None],
            )
            f = torch.floor(est).to(torch.int32)
            r1 = hc - f * c
            r2 = hm - f * m
            up = ((r1 >= c) & (r2 >= m)).to(torch.int32)
            down = ((r1 < 0) | (r2 < 0)).to(torch.int32)
            fit = f + up - down
        else:
            fit = torch.minimum(
                torch.where(ac <= uc, 0, (ac - uc) // c),
                torch.where(am <= um, 0, (am - um) // m),
            )
        fit = plain_epilogue(fit, ap, pc, mask, strict)
        if counts is not None:
            fit = fit * counts
        out.append(fit.sum(dim=1, dtype=torch.int64))
    return torch.cat(out)


def plain_epilogue(fit, ap, pc, mask, strict: bool) -> torch.Tensor:
    """The mode epilogue and 0/1 lane mask on int32 ``[S_chunk, N]`` fits
    (``pallas_fit._epilogue``): reference is the Q1 overwrite (may go
    negative), strict clamps to the free pod slots and to 0."""
    if strict:
        slots = torch.clamp_min(ap - pc, 0)
        fit = torch.clamp_min(torch.minimum(fit, slots), 0)
    else:
        fit = torch.where(fit >= ap, ap - pc, fit)
    if mask is not None:
        fit = fit * mask
    return fit


def _fused_label(device: torch.device, use_rcp: bool) -> str:
    prefix = "cuda" if device.type == "cuda" else "plain"
    return f"{prefix}_i32_rcp_fused" if use_rcp else f"{prefix}_i32_fused"


def _fused_sweep(
    node_cols, cpu_reqs, mem_reqs, replicas, mask, counts, *, use_rcp,
    strict, device, sync, label,
):
    """Stage the scenario operands, run :func:`sweep_fused` and bring
    ``(totals, schedulable)`` to the host: at once under ``sync``, else as
    views over one pending copy (:func:`..fit.fetch`), the comparison
    with ``replicas`` then made on the device so that one copy carries
    both.  A synchronous dispatch is clocked and observed under ``label``
    (:func:`..fit.observed_fetch`)."""
    t0 = time.perf_counter()
    cr = np.asarray(cpu_reqs, dtype=np.int64).astype(np.int32)
    mr = (np.asarray(mem_reqs, dtype=np.int64) // 1024).astype(np.int32)
    crr = mrr = None
    if use_rcp:
        crr = _devcache.to_device(scenario_reciprocals(cr), device)
        mrr = _devcache.to_device(scenario_reciprocals(mr), device)
    if mask is not None:
        # The kernel takes any non-zero lane as 1; the plain version
        # multiplies by it.  Staging the mask as 0/1 keeps them equal.
        mask = _devcache.to_device(
            np.asarray(mask, dtype=bool).astype(np.int32), device
        )
    if counts is not None:
        counts = _devcache.to_device(
            np.asarray(counts, dtype=np.int64).astype(np.int32), device
        )
    cr, mr = _devcache.to_device(cr, device), _devcache.to_device(mr, device)
    with _phases.current().live("device_exec"):
        totals = sweep_fused(
            *node_cols, cr, mr, crr, mrr, mask, counts, strict=strict,
        )
    if sync:
        (totals,) = observed_fetch(label, t0, (totals,))
        return totals, totals >= np.asarray(replicas, dtype=np.int64)
    replicas = _devcache.to_device(
        np.asarray(replicas, dtype=np.int64), device
    )
    return observed_fetch(label, t0, (totals, totals >= replicas), sync=False)


def sweep_auto(
    snapshot,
    cpu_reqs,
    mem_reqs,
    replicas,
    *,
    mode: str = "reference",
    node_mask=None,
    force_exact: bool = False,
    device="cuda",
    sync: bool = True,
):
    """Fused kernel when eligible, exact int64 program otherwise — always
    bit-exact.

    Both modes take the fused kernel when eligible: reference with the Q1
    epilogue, strict with the clamped epilogue and ``healthy`` folded into
    the kernel's lane mask (reference mode ignores ``healthy``: its
    phantom nodes are zero rows from packing).  The snapshot's node
    columns come device-resident from :mod:`..devcache`.  Returns numpy
    ``(totals[S], schedulable[S], kernel_name)``, the name one of
    ``{cuda,plain}_i32_rcp_fused``, ``{cuda,plain}_i32_fused`` or
    ``torch_int64``; with ``sync=False`` the two arrays are views over one
    pending pinned copy (:func:`..fit.fetch`).
    """
    device = _devcache.resolve_device(device)
    nodes = (
        snapshot.alloc_cpu_milli, snapshot.alloc_mem_bytes,
        snapshot.alloc_pods, snapshot.used_cpu_req_milli,
        snapshot.used_mem_req_bytes, snapshot.pods_count,
    )
    alloc_cpu, alloc_mem, _, used_cpu, used_mem, _ = nodes
    if mode == "strict":
        healthy_arr = np.asarray(snapshot.healthy, dtype=bool)
        kernel_mask = (
            healthy_arr
            if node_mask is None
            else healthy_arr & np.asarray(node_mask, dtype=bool)
        )
    else:
        kernel_mask = node_mask
    if not force_exact and fast_sweep_eligible(*nodes, cpu_reqs, mem_reqs):
        use_rcp = rcp_division_eligible(
            alloc_cpu, alloc_mem, used_cpu, used_mem, cpu_reqs, mem_reqs
        )
        label = _fused_label(device, use_rcp)
        totals, schedulable = _fused_sweep(
            _devcache.CACHE.kernel_tensors(snapshot, device), cpu_reqs,
            mem_reqs, replicas, kernel_mask, None,
            use_rcp=use_rcp, strict=mode == "strict", device=device,
            sync=sync, label=label,
        )
        return totals, schedulable, label
    totals, schedulable = sweep_grid_staged(
        *nodes, snapshot.healthy, cpu_reqs, mem_reqs, replicas, mode=mode,
        node_mask=node_mask, snapshot=snapshot, device=device, sync=sync,
    )
    return totals, schedulable, "torch_int64"


def _sweep_auto_grouped(
    grouped,
    grid,
    *,
    mode: str = "reference",
    node_mask=None,
    force_exact: bool = False,
    device="cuda",
    sync: bool = True,
):
    """:func:`sweep_auto` over node-shape groups with count weighting.

    ``node_mask`` folds into the per-group effective counts (a masked
    node's fit is zero in every mode, so removing it from its group's
    multiplicity is the identical sum); strict mode's ``healthy`` rides as
    the kernel lane mask.  Kernel names carry a ``_grouped`` suffix.
    """
    device = _devcache.resolve_device(device)
    counts = grouped.effective_counts(node_mask)
    cpu_reqs = grid.cpu_request_milli
    mem_reqs = grid.mem_request_bytes
    if not force_exact and fast_sweep_eligible(
        grouped.alloc_cpu_milli, grouped.alloc_mem_bytes,
        grouped.alloc_pods, grouped.used_cpu_req_milli,
        grouped.used_mem_req_bytes, grouped.pods_count,
        cpu_reqs, mem_reqs, counts=counts,
    ):
        use_rcp = rcp_division_eligible(
            grouped.alloc_cpu_milli, grouped.alloc_mem_bytes,
            grouped.used_cpu_req_milli, grouped.used_mem_req_bytes,
            cpu_reqs, mem_reqs,
        )
        kernel_mask = (
            np.asarray(grouped.healthy, dtype=bool)
            if mode == "strict" else None
        )
        label = _fused_label(device, use_rcp) + "_grouped"
        totals, schedulable = _fused_sweep(
            _devcache.CACHE.grouped_kernel_tensors(grouped, device),
            cpu_reqs, mem_reqs, grid.replicas, kernel_mask, counts,
            use_rcp=use_rcp, strict=mode == "strict", device=device,
            sync=sync, label=label,
        )
        return totals, schedulable, label
    totals, schedulable = sweep_grouped_staged(
        grouped, cpu_reqs, mem_reqs, grid.replicas,
        mode=mode, node_mask=node_mask, device=device, sync=sync,
    )
    return totals, schedulable, "torch_int64_grouped"


def sweep_snapshot_auto(
    snapshot,
    grid,
    *,
    mode: str = "reference",
    kernel: str = "auto",
    node_mask=None,
    device="cuda",
    sync: bool = True,
):
    """The sweep entry point: the fastest route that is provably bit-exact.

    The dispatch the CLI ``-grid`` path uses (the reference evaluates its
    one scenario with the loop at ``ClusterCapacity.go:105-140``; a sweep
    is that loop over S what-if specs).  Degenerate fleets
    (:func:`..snapshot.grouped_for_dispatch`) sweep node-shape groups.
    ``node_mask`` (``[N]`` bool) zeroes constraint-infeasible nodes, e.g.
    the implicit hard-taint mask of strict surfaces.  ``kernel="exact"``
    forces the int64 program.  ``device`` defaults to ``"cuda"`` and
    raises when no card is present; pass ``"cpu"`` to run on the host.
    Returns ``(totals[S], schedulable[S], kernel_name)`` numpy arrays and
    the route actually taken.

    ``sync=False`` returns the two arrays as views over one pending
    device→host copy into pinned memory, with a CUDA event recorded after
    it (:class:`..fit.AsyncFetch`): the caller blocks only when it reads
    them (``np.asarray``), on that event alone — the service's folded
    sweeps answer this way.  Every route honours it; values are identical
    either way.  (The JAX package's async dispatch covers only its exact
    program; its Pallas routes stay synchronous.)
    """
    device = _devcache.resolve_device(device)
    if kernel not in ("auto", "exact"):
        raise ValueError(f"unknown kernel {kernel!r}")
    if mode not in ("reference", "strict"):
        raise ValueError(f"unknown mode {mode!r}")
    grid.validate()
    grouped = grouped_for_dispatch(snapshot)
    if grouped is not None:
        return _sweep_auto_grouped(
            grouped, grid, mode=mode, node_mask=node_mask,
            force_exact=(kernel == "exact"), device=device, sync=sync,
        )
    return sweep_auto(
        snapshot,
        grid.cpu_request_milli,
        grid.mem_request_bytes,
        grid.replicas,
        mode=mode,
        node_mask=node_mask,
        force_exact=(kernel == "exact"),
        device=device,
        sync=sync,
    )


def sweep_explain_snapshot_auto(
    snapshot,
    grid,
    *,
    mode: str = "reference",
    node_mask=None,
    device="cuda",
    rows=None,
):
    """The fused sweep+explain entry, beside :func:`sweep_snapshot_auto`
    so that the service's folded dispatcher can route a batch that mixes
    sweeps and explains through one call.

    There is no kernel route here, as in the JAX package: the explain
    attribution carries the full int64 per-resource quotients
    (``cpu_fit``/``mem_fit``/``slots``), which B1 does not produce, so
    every call is the exact program and its label says so.  Delegates to
    :func:`..explain.sweep_explain_snapshot`; ``rows`` (scenario indices)
    limits the per-node outputs brought to the host to the rows a caller
    reads.  Returns ``(totals[S], schedulable[S], ExplainResult,
    kernel_name)``.
    """
    from kubernetesclustercapacity_tpu_torch.explain import (
        sweep_explain_snapshot,
    )

    return sweep_explain_snapshot(
        snapshot, grid, mode=mode, node_mask=node_mask, device=device,
        rows=rows,
    )
