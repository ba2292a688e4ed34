"""Multi-process sweeps over ``torch.distributed``.

Counterpart of ``kubernetesclustercapacity_tpu/parallel/multihost.py``.
The scenario axis splits across processes: each process owns a
contiguous :func:`scenario_block` of the what-if grid and computes
complete results for it on its own device, with zero cross-process
traffic in the compute; one optional all-gather at the end gives every
process the full result.  The node axis stays inside a process
(:mod:`.sweep`), where its reduction belongs.

Launch recipe (one process per host or per card, the same program)::

    from kubernetesclustercapacity_tpu_torch.parallel import multihost
    multihost.initialize(coordinator_address="host0:29500",
                         num_processes=H, process_id=h,
                         backend="nccl")          # no-op when H == 1
    totals, sched = multihost.sweep_multihost(snapshot_arrays, cpu, mem,
                                              replicas, device="cuda")

The collective backend is the caller's choice: ``gloo`` on the host,
``nccl`` (one card per process) or ``gloo`` on CUDA.  NCCL puts no two
ranks on one card, so ranks sharing a card use gloo, whose all-gather
takes the CUDA tensors as they are.  Everything degrades to
single-process semantics when no process group is initialised.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from kubernetesclustercapacity_tpu_torch import devcache as _devcache
from kubernetesclustercapacity_tpu_torch.ops.fit import (
    sweep_grid,
    sweep_grid_multi,
)

__all__ = [
    "initialize",
    "sweep_multihost",
    "sweep_multihost_multi",
    "scenario_block",
]


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    **kwargs,
) -> bool:
    """Join the process group.  Returns True when distributed mode was
    initialised; call once per process before any sweep.

    * ``num_processes=1`` → a clean no-op returning False, whatever else
      is set (the same launch recipe runs unchanged on one machine).
    * no arguments at all → also a no-op.
    * anything else → ``torch.distributed.init_process_group`` with
      ``backend`` (required: ``"gloo"`` or ``"nccl"``), ``world_size`` and
      ``rank``; ``coordinator_address`` (``host:port``) becomes its
      ``tcp://`` init method (without it, the ``env://`` variables).
    """
    if num_processes == 1:
        return False
    if (
        num_processes is None
        and coordinator_address is None
        and process_id is None
        and backend is None
        and not kwargs
    ):
        return False
    if backend is None:
        raise ValueError(
            "initialize: name the collective backend (backend='gloo', or "
            "'nccl' with one CUDA device per process)"
        )
    init_method = None
    if coordinator_address is not None:
        init_method = (
            coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}"
        )
    dist.init_process_group(
        backend=backend,
        init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
        **kwargs,
    )
    return True


def _process() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def scenario_block(total: int, process_id: int, process_count: int) -> tuple[int, int]:
    """The [start, stop) scenario rows process ``process_id`` owns.

    Blocks are contiguous and cover ``total`` exactly; the last block may
    be short.  Every process computes the SAME split (pure arithmetic on
    the global size).
    """
    per = -(-total // process_count)  # ceil
    start = min(process_id * per, total)
    return start, min(start + per, total)


def _local_block_stager(s: int, device: torch.device):
    """Shared front half of both multi-process sweeps: this process's
    :func:`scenario_block` of the global grid, padded to at least one row
    and staged on ``device``.  Returns ``(stage, width, pcount)`` where
    ``stage(a, fill)`` slices, pads and stages one grid array (1-D, or
    2-D with its scenario axis first)."""
    pid, pcount = _process()
    start, stop = scenario_block(s, pid, pcount)
    width = stop - start
    pad = max(width, 1) - width

    def stage(a, fill):
        block = a[start:stop]
        if pad:
            widths = ((0, pad),) + ((0, 0),) * (block.ndim - 1)
            block = np.pad(block, widths, constant_values=fill)
        return _devcache.to_device(block, device)

    return stage, width, pcount


def sweep_multihost(
    snapshot_arrays: tuple,
    cpu_reqs,
    mem_reqs,
    replicas,
    *,
    mode: str = "reference",
    gather: bool = True,
    device="cuda",
):
    """Sweep a globally partitioned scenario grid across all processes.

    Every process passes the FULL grid (three int64 vectors) and the
    snapshot's seven node columns (numpy or tensors); each computes only
    its :func:`scenario_block` with the exact program on ``device``.
    With ``gather`` (default) the blocks are all-gathered so every process
    returns the full ``(totals[S], schedulable[S])``; with
    ``gather=False`` each returns only its own block.
    """
    device = _devcache.resolve_device(device)
    cpu_reqs = np.asarray(cpu_reqs, dtype=np.int64)
    mem_reqs = np.asarray(mem_reqs, dtype=np.int64)
    replicas = np.asarray(replicas, dtype=np.int64)
    s = cpu_reqs.shape[0]
    stage, width, pcount = _local_block_stager(s, device)
    cpu_d = stage(cpu_reqs, 1)  # pad with harmless 1-milli probes
    mem_d = stage(mem_reqs, 1)
    rep_d = stage(replicas, 0)
    if all(isinstance(a, torch.Tensor) for a in snapshot_arrays):
        cols = tuple(a.to(device) for a in snapshot_arrays)
    else:
        cols = _devcache.stage_exact(snapshot_arrays, device)
    totals_p, sched_p = sweep_grid(*cols, cpu_d, mem_d, rep_d, mode=mode)
    return _finish(totals_p, sched_p, s, width, pcount, gather)


def sweep_multihost_multi(
    alloc_rn,
    used_rn,
    alloc_pods,
    pods_count,
    healthy,
    reqs_sr,
    replicas,
    *,
    mode: str = "strict",
    gather: bool = True,
    device="cuda",
):
    """R-resource variant of :func:`sweep_multihost` (BASELINE config 4).

    Same partition scheme: every process passes the full ``[S, R]``
    request grid and owns its contiguous :func:`scenario_block`; the
    ``[R, N]`` resource matrix is replicated per process.
    """
    device = _devcache.resolve_device(device)
    reqs_sr = np.asarray(reqs_sr, dtype=np.int64)
    replicas = np.asarray(replicas, dtype=np.int64)
    s = reqs_sr.shape[0]
    stage, width, pcount = _local_block_stager(s, device)
    # 1-probes: valid (nonzero) requests whose outputs are sliced off.
    reqs_d = stage(reqs_sr, 1)
    rep_d = stage(replicas, 0)
    node_d = tuple(
        _devcache.to_device(np.asarray(a, dtype=dtype), device)
        for a, dtype in ((alloc_rn, np.int64), (used_rn, np.int64),
                         (alloc_pods, np.int64), (pods_count, np.int64),
                         (healthy, np.bool_))
    )
    totals_p, sched_p = sweep_grid_multi(*node_d, reqs_d, rep_d, mode=mode)
    return _finish(totals_p, sched_p, s, width, pcount, gather)


def _finish(totals_p, sched_p, s, width, pcount, gather):
    """Slice off probe padding, then (optionally) all-gather the blocks."""
    totals_local = totals_p[:width]
    sched_local = sched_p[:width]
    if not gather or pcount == 1:
        return totals_local.cpu().numpy(), sched_local.cpu().numpy()
    # Fixed-width blocks so the gather is dense; short tails are padded
    # then sliced off after concatenation.
    per = -(-s // pcount)
    out = []
    for local in (totals_local, sched_local.to(torch.int64)):
        block = torch.zeros(per, dtype=torch.int64, device=local.device)
        block[:width] = local
        parts = [torch.empty_like(block) for _ in range(pcount)]
        dist.all_gather(parts, block)
        out.append(_stitch(torch.stack(parts).cpu().numpy(), s, pcount))
    return out[0], out[1].astype(bool)


def _stitch(gathered: np.ndarray, s: int, pcount: int) -> np.ndarray:
    """``[pcount, per]`` gathered blocks → the ``[s]`` global result
    (drops each block's tail padding)."""
    blocks = []
    for p in range(pcount):
        b0, b1 = scenario_block(s, p, pcount)
        blocks.append(np.asarray(gathered[p])[: b1 - b0])
    return np.concatenate(blocks)
