"""The fused R-resource sweep (BASELINE config 4): exactness proofs, the CUDA
kernel's wrapper, its plain PyTorch version, and the dispatcher.

Counterpart of ``kubernetesclustercapacity_tpu/ops/pallas_multi.py``.  It
generalizes the 2-resource fused sweep (:mod:`.fused_fit`) to R resource
rows — the reference's 2-way min at ``ClusterCapacity.go:133`` extended to
the min over R rows that :func:`.fit.fit_per_node_multi` defines.  The
kernel (``csrc/sweep_multi.cu``, replacing the TPU kernel
``pallas_multi._make_multi_kernel``) evaluates every (scenario, node) cell
and reduces over nodes on the card, so neither the ``[S, N]`` fit matrix nor
an ``[R, N]`` row per scenario ever exists in device memory.

Eligibility generalizes the KiB-rescale proof per row: each resource row
gets the smallest power-of-1024 scale that keeps alloc, used and requests
int32-range while dividing all of them exactly, so the int32 quotient
equals the int64 one.  A zero request means "does not consume this
resource": the row drops out of the min.

Routing is by eligibility, as in the JAX package: an eligible sweep with a
shared (or no) node mask and no per-node cap takes the fused kernel;
``[S, N]`` masks, ``max_per_node``, ``force_exact`` or failed eligibility
take the exact int64 program on the same device.  On a CUDA tensor the
wrapper launches the kernel or raises; only a CPU tensor runs the plain
version (``plain_*`` labels).
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
    sweep_grid_multi_staged,
)
from kubernetesclustercapacity_tpu_torch.ops.fused_fit import (
    node_chunk,
    plain_epilogue,
    scenario_reciprocals,
)
from kubernetesclustercapacity_tpu_torch.telemetry import phases as _phases

__all__ = [
    "LAUNCHES",
    "PLAIN_CALLS",
    "multi_row_scales",
    "fast_multi_eligible",
    "rcp_multi_eligible",
    "stage_multi_operands",
    "sweep_multi",
    "sweep_multi_plain",
    "sweep_multi_auto",
]

#: Launches of the CUDA R-resource kernel in this process (one per launch,
#: counted nowhere else).
LAUNCHES = 0
#: Calls of :func:`sweep_multi` that ran the plain version (CPU tensors).
PLAIN_CALLS = 0
#: Guards both counters against concurrent handler threads.
_COUNT_LOCK = threading.Lock()


def _count(name: str) -> None:
    with _COUNT_LOCK:
        globals()[name] += 1

_I32_MAX = np.iinfo(np.int32).max
_SCALES = (1, 1024, 1024**2, 1024**3)


def _positive_reqs(reqs_col: np.ndarray) -> np.ndarray:
    reqs_col = np.asarray(reqs_col)
    return reqs_col[reqs_col > 0]


def multi_row_scales(alloc_rn, used_rn, reqs_sr) -> list[int] | None:
    """Per-row rescale factors proving int32 exactness, or None.

    For each resource row r: the smallest ``s ∈ {1, 1024, 1024², 1024³}``
    such that ``alloc[r]``, ``used[r]`` and every POSITIVE request in
    ``reqs_sr[:, r]`` are all non-negative multiples of ``s`` with
    quotients in int32 range.  Divisibility by a larger power of 1024
    implies divisibility by the smaller ones, so the first divisibility
    failure ends the row's search.
    """
    alloc_rn = np.asarray(alloc_rn, dtype=np.int64)
    used_rn = np.asarray(used_rn, dtype=np.int64)
    reqs_sr = np.asarray(reqs_sr, dtype=np.int64)
    if reqs_sr.ndim != 2 or alloc_rn.shape[0] != reqs_sr.shape[1]:
        return None
    if reqs_sr.size and reqs_sr.min() < 0:
        # The exact program divides negative requests as-is; the kernel's
        # "active = req > 0" test would silently exclude them.
        return None
    scales: list[int] = []
    for r in range(alloc_rn.shape[0]):
        row_arrays = (alloc_rn[r], used_rn[r], _positive_reqs(reqs_sr[:, r]))
        if any(a.size and a.min() < 0 for a in row_arrays):
            return None
        chosen = None
        for s in _SCALES:
            if s > 1 and any(
                a.size and (a % s).any() for a in row_arrays
            ):
                break  # no larger scale can divide either
            if all(
                (not a.size) or (a // s).max() <= _I32_MAX
                for a in row_arrays
            ):
                chosen = s
                break
        if chosen is None:
            return None
        scales.append(chosen)
    return scales


def fast_multi_eligible(
    alloc_rn, used_rn, alloc_pods, pods_count, reqs_sr
) -> tuple[list[int] | None, bool]:
    """``(row_scales, ok)`` — ok iff the fused int32 R-resource kernel is
    exact.

    Beyond the per-row rescale (:func:`multi_row_scales`): pod columns in
    int32 range, and the int32 accumulator sum bound.  The per-node fit
    after the epilogue is ``<=`` the fit of ANY active row, and which rows
    a scenario activates is per-scenario, so the per-node bound takes the
    MAX over rows of ``alloc[r] // min_positive_req[r]`` (rows with no
    positive request anywhere in the grid never bind and are skipped),
    joined with the pod-cap values ``alloc_pods`` / ``pods_count`` that
    the epilogue can emit.  The CUDA kernel sums in int64 and needs less;
    the bound is kept whole so that routing, and so the kernel labels,
    match the JAX package.
    """
    scales = multi_row_scales(alloc_rn, used_rn, reqs_sr)
    if scales is None:
        return None, False
    alloc_pods = np.asarray(alloc_pods, dtype=np.int64)
    pods_count = np.asarray(pods_count, dtype=np.int64)
    for a in (alloc_pods, pods_count):
        if a.size and (a.min() < 0 or a.max() > _I32_MAX):
            return scales, False
    alloc_rn = np.asarray(alloc_rn, dtype=np.int64)
    reqs_sr = np.asarray(reqs_sr, dtype=np.int64)
    bound = np.maximum(alloc_pods, pods_count)
    for r in range(alloc_rn.shape[0]):
        pos = _positive_reqs(reqs_sr[:, r])
        if pos.size:
            bound = np.maximum(bound, alloc_rn[r] // int(pos.min()))
    return scales, int(bound.sum()) <= _I32_MAX


def rcp_multi_eligible(alloc_rn, used_rn, reqs_sr, scales) -> bool:
    """Per-row reciprocal-division exactness, on the SCALED values.

    Same two bounds as the 2-resource proof
    (:func:`.fused_fit.rcp_division_eligible`): quotient ``<= 2^20`` and
    divisor ``<= 2^29``, per row, with dividends clamped to
    ``[0, max(alloc)]``.  Zero requests never divide (the kernel drops the
    row from the min), so only positive requests bound the row.
    """
    qmax = np.int64(1) << 20
    dmax = np.int64(1) << 29
    alloc_rn = np.asarray(alloc_rn, dtype=np.int64)
    reqs_sr = np.asarray(reqs_sr, dtype=np.int64)
    for r, s in enumerate(scales):
        alloc = alloc_rn[r] // s
        pos = _positive_reqs(reqs_sr[:, r]) // s
        if not pos.size:
            continue
        if pos.max() > dmax:
            return False
        if alloc.size and alloc.max() // pos.min() > qmax:
            return False
    return True


def stage_multi_operands(
    alloc_rn, used_rn, alloc_pods, pods_count, reqs_sr, scales,
    node_mask=None, *, use_rcp: bool, device,
) -> tuple:
    """The kernel's operands on ``device``, staged per call (the row scales
    depend on the requests as well as the snapshot).

    Returns ``(alloc[R, N], used[R, N], ap[N], pc[N], reqs[R, S],
    rcps[R, S] | None, mask[N] | None)``: contiguous int32 tensors, each
    resource row divided by its scale (exact: the eligibility contract),
    float32 reciprocals of ``max(req, 1)`` from :func:`scenario_reciprocals`
    when ``use_rcp``, and the 0/1 mask as int32.  No padding.
    """
    scale = np.asarray(scales, dtype=np.int64)[:, None]
    alloc = (np.asarray(alloc_rn, dtype=np.int64) // scale).astype(np.int32)
    used = (np.asarray(used_rn, dtype=np.int64) // scale).astype(np.int32)
    reqs = (np.asarray(reqs_sr, dtype=np.int64).T // scale).astype(np.int32)
    host = [
        alloc, used,
        np.asarray(alloc_pods, dtype=np.int64).astype(np.int32),
        np.asarray(pods_count, dtype=np.int64).astype(np.int32),
        reqs,
        scenario_reciprocals(np.maximum(reqs, 1)) if use_rcp else None,
        None if node_mask is None
        else np.asarray(node_mask, dtype=bool).astype(np.int32),
    ]
    return tuple(
        None if a is None else _devcache.to_device(a, device) for a in host
    )


def _check_operands(alloc, used, ap, pc, reqs, rcps, mask) -> torch.device:
    """Validate the R-resource sweep's operands; returns their device."""
    if alloc.dim() != 2 or reqs.dim() != 2:
        raise ValueError("alloc, used and reqs must be 2-D ([R, N], [R, S])")
    r, n = (int(d) for d in alloc.shape)
    s = int(reqs.shape[1])
    if r < 1 or int(reqs.shape[0]) != r:
        raise ValueError(
            f"reqs has {int(reqs.shape[0])} rows for {r} resource rows"
        )
    expected = [(alloc, torch.int32, (r, n)), (used, torch.int32, (r, n)),
                (ap, torch.int32, (n,)), (pc, torch.int32, (n,)),
                (reqs, torch.int32, (r, s))]
    if rcps is not None:
        expected.append((rcps, torch.float32, (r, s)))
    if mask is not None:
        expected.append((mask, torch.int32, (n,)))
    device = alloc.device
    for t, dtype, shape in expected:
        if t.device != device:
            raise ValueError(
                f"multi sweep operands span devices ({t.device} vs {device})"
            )
        if t.dtype != dtype:
            raise TypeError(f"multi sweep operand is {t.dtype}, want {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"multi sweep operand has shape {tuple(t.shape)}, want {shape}"
            )
        if not t.is_contiguous():
            raise ValueError("multi sweep operands must be contiguous")
    return device


_MULTI_ARGTYPES = (ctypes.c_void_p,) * 8 + (
    ctypes.c_longlong,  # n
    ctypes.c_int,  # s
    ctypes.c_int,  # r
    ctypes.c_longlong,  # chunk
    ctypes.c_int,  # strict
    ctypes.c_void_p,  # stream
)


def _multi_fn():
    """The bound C entry point, built and declared on first use (without
    ``argtypes`` ctypes would pass each pointer as a 32-bit int)."""
    fn = _build.library("sweep_multi").kccap_sweep_multi
    if fn.argtypes != _MULTI_ARGTYPES:
        fn.argtypes = _MULTI_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def sweep_multi(
    alloc, used, ap, pc, reqs, rcps=None, mask=None, *, strict: bool = True,
) -> torch.Tensor:
    """Per-scenario totals of the fused R-resource sweep, int64 ``[S]``.

    Operands as :func:`stage_multi_operands` returns them, on one device;
    ``rcps`` selects the reciprocal-division variant and ``mask`` (0/1) the
    lane mask.  Callers prove the inputs eligible first.  On CUDA tensors this
    launches ``csrc/sweep_multi.cu`` (and raises if it cannot); on CPU
    tensors it runs :func:`sweep_multi_plain`.
    """
    device = _check_operands(alloc, used, ap, pc, reqs, rcps, mask)
    if device.type == "cpu":
        _count("PLAIN_CALLS")
        return sweep_multi_plain(
            alloc, used, ap, pc, reqs, rcps, mask, strict=strict
        )
    if device.type != "cuda":
        raise ValueError(f"multi sweep runs on cuda or cpu, not {device}")
    r, n = (int(d) for d in alloc.shape)
    s = int(reqs.shape[1])
    totals = torch.zeros(s, dtype=torch.int64, device=device)
    if n == 0 or s == 0:
        return totals
    with torch.cuda.device(device):
        sm_count = torch.cuda.get_device_properties(device).multi_processor_count
        rc = _multi_fn()(
            _ptr(alloc), _ptr(used), _ptr(ap), _ptr(pc), _ptr(mask),
            _ptr(reqs), _ptr(rcps), _ptr(totals),
            n, s, r, node_chunk(n, s, sm_count), int(bool(strict)),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"sweep_multi kernel launch failed: CUDA error {rc}")
    _count("LAUNCHES")
    return totals


def sweep_multi_plain(
    alloc, used, ap, pc, reqs, rcps=None, mask=None, *, strict: bool = True,
) -> torch.Tensor:
    """The R-resource kernel's plain PyTorch version: the same int32
    function over ``[S_chunk, N]`` blocks, summed to int64.  Per row, an
    active request (``> 0``) gives the quotient ``(alloc − used) // req``
    (or the float32 reciprocal estimate with its own one-round fixup), 0
    where ``alloc <= used``; an inactive row gives ``INT32_MAX``.  Then
    the R-way min, the epilogue and the mask.  Same operands and result
    as :func:`sweep_multi`; runs on any device."""
    n, s = int(alloc.shape[1]), int(reqs.shape[1])
    step = max(1, BLOCK_CELLS // max(n, 1))
    out = [torch.zeros(0, dtype=torch.int64, device=alloc.device)]
    for lo in range(0, s, step):
        fit = None
        for r in range(int(alloc.shape[0])):
            a, u = alloc[r], used[r]
            req = reqs[r, lo:lo + step, None]
            safe = torch.clamp_min(req, 1)
            if rcps is not None:
                # _rcp_div: one f32 estimate, one fixup round, per row.
                h = torch.clamp_min(a - u, 0)
                est = torch.floor(
                    h.to(torch.float32) * rcps[r, lo:lo + step, None]
                ).to(torch.int32)
                rem = h - est * safe
                quo = est + (rem >= safe).to(torch.int32) \
                    - (rem < 0).to(torch.int32)
            else:
                quo = (a - u) // safe
            fit_r = torch.where(req > 0, torch.where(a <= u, 0, quo), _I32_MAX)
            fit = fit_r if fit is None else torch.minimum(fit, fit_r)
        fit = plain_epilogue(fit, ap, pc, mask, strict)
        out.append(fit.sum(dim=1, dtype=torch.int64))
    return torch.cat(out)


def _multi_label(device: torch.device, use_rcp: bool) -> str:
    prefix = "cuda" if device.type == "cuda" else "plain"
    return f"{prefix}_multi_i32_rcp_fused" if use_rcp else \
        f"{prefix}_multi_i32_fused"


def sweep_multi_auto(
    alloc_rn,
    used_rn,
    alloc_pods,
    pods_count,
    healthy,
    reqs_sr,
    replicas,
    *,
    mode: str = "strict",
    node_masks=None,
    max_per_node=None,
    force_exact: bool = False,
    device="cuda",
):
    """R-resource sweep on the fastest provably exact route.

    Eligible sweeps with a shared (or absent) ``[N]`` node mask and no
    per-node cap take the fused kernel, strict mode with ``healthy`` ANDed
    into the kernel's lane mask; per-scenario ``[S, N]`` masks,
    ``max_per_node``, ``force_exact`` or failed eligibility take the exact
    int64 program (:func:`.fit.sweep_grid_multi`) on the same device.
    Numpy in; returns numpy ``(totals[S], schedulable[S], kernel_name)``,
    the name one of ``{cuda,plain}_multi_i32_rcp_fused``,
    ``{cuda,plain}_multi_i32_fused`` or ``torch_int64_multi``.
    ``device`` defaults to ``"cuda"`` and raises when no card is present.
    """
    device = _devcache.resolve_device(device)
    if mode not in ("reference", "strict"):
        raise ValueError(f"unknown mode {mode!r}")
    shared_mask = None
    fused_ok = max_per_node is None and not force_exact
    if node_masks is not None:
        nm = np.asarray(node_masks)
        if nm.ndim == 1:
            shared_mask = nm.astype(bool)
        else:
            fused_ok = False
    if fused_ok:
        scales, ok = fast_multi_eligible(
            alloc_rn, used_rn, alloc_pods, pods_count, reqs_sr
        )
        if ok:
            if mode == "strict":
                healthy_arr = np.asarray(healthy, dtype=bool)
                kernel_mask = (
                    healthy_arr if shared_mask is None
                    else healthy_arr & shared_mask
                )
            else:
                kernel_mask = shared_mask
            use_rcp = rcp_multi_eligible(alloc_rn, used_rn, reqs_sr, scales)
            label = _multi_label(device, use_rcp)
            t0 = time.perf_counter()
            ops = stage_multi_operands(
                alloc_rn, used_rn, alloc_pods, pods_count, reqs_sr, scales,
                kernel_mask, use_rcp=use_rcp, device=device,
            )
            with _phases.current().live("device_exec"):
                totals = sweep_multi(*ops, strict=mode == "strict")
            (totals,) = observed_fetch(label, t0, (totals,))
            schedulable = totals >= np.asarray(replicas, dtype=np.int64)
            return totals, schedulable, label
    totals, schedulable = sweep_grid_multi_staged(
        alloc_rn, used_rn, alloc_pods, pods_count, healthy, reqs_sr,
        replicas, mode=mode, node_masks=node_masks,
        max_per_node=max_per_node, device=device,
    )
    return totals, schedulable, "torch_int64_multi"
