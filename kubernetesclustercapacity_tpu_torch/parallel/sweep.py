"""Sharded capacity sweeps: the exact program laid out over a device mesh.

Counterpart of ``kubernetesclustercapacity_tpu/parallel/sweep.py``.  One
controller drives every cell of a :class:`~.mesh.MeshPlan`: cell ``(i,
j)`` sweeps scenario shard ``i`` against node shard ``j`` on its device
with the exact int64 program (:func:`..ops.fit.sweep_grid`, or
:func:`..ops.fit.sweep_grid_grouped` over node-shape groups), and the
partial per-scenario totals of a row are summed in int64 on the mesh's
first device — the JAX package's ``psum`` over the node axis, written
out.  Both paths equal the single-device sweep bit for bit:

* :func:`sweep_shard_map` stages every shard per call, as the JAX path
  hands a jitted ``shard_map`` fresh arrays;
* :func:`sweep_gspmd` takes the node columns from the device cache when
  given the ``snapshot`` they came from (staged once per snapshot and
  mesh), as the JAX path keeps its ``NamedSharding``-placed arrays, and
  is :func:`sweep_shard_map` without it.

Padding: node arrays pad with zero rows — a zero row fits 0 in both modes
(alloc ≤ used guards to 0, then the Q1 cap rewrites ``0 ≥ 0`` to
``0 − 0``) — and scenario arrays pad with a harmless ``(1 milli, 1 byte)``
probe whose outputs are sliced off.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetesclustercapacity_tpu_torch import devcache as _devcache
from kubernetesclustercapacity_tpu_torch.ops.fit import (
    sweep_grid,
    sweep_grid_grouped,
)
from kubernetesclustercapacity_tpu_torch.parallel.mesh import MeshPlan

__all__ = [
    "sweep_gspmd",
    "sweep_gspmd_grouped",
    "sweep_shard_map",
    "stage_gspmd_arrays",
    "stage_gspmd_grouped_arrays",
]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _pad_node_arrays(arrays: tuple, n_padded: int) -> tuple:
    """Zero-pad the snapshot arrays along the node axis."""
    out = []
    for a in arrays:
        a = _host(a)
        pad = n_padded - a.shape[0]
        out.append(np.pad(a, (0, pad)) if pad else a)
    return tuple(out)


def _pad_scenarios(cpu_reqs, mem_reqs, replicas, s_padded: int):
    cpu_reqs = np.asarray(cpu_reqs, dtype=np.int64)
    mem_reqs = np.asarray(mem_reqs, dtype=np.int64)
    replicas = np.asarray(replicas, dtype=np.int64)
    pad = s_padded - cpu_reqs.shape[0]
    if pad:
        cpu_reqs = np.pad(cpu_reqs, (0, pad), constant_values=1)
        mem_reqs = np.pad(mem_reqs, (0, pad), constant_values=1)
        replicas = np.pad(replicas, (0, pad), constant_values=0)
    return cpu_reqs, mem_reqs, replicas


def _stage_node_shards(plan: MeshPlan, arrays: tuple) -> tuple:
    """``cells[i][j]``: node shard ``j`` of the padded host ``arrays`` as
    tensors on ``plan.devices[i][j]`` (``healthy``, 7th, as bool; an 8th
    column, the group counts, int64).  Every cell gets its own copy, as
    every device of a real mesh holds its own, even where the list names
    one device for several cells."""
    per = arrays[0].shape[0] // plan.node_shards

    def put(dev: torch.device, j: int) -> tuple:
        shard = [a[j * per:(j + 1) * per] for a in arrays]
        cols = _devcache.exact_columns(shard[:7]) + [
            np.asarray(a, dtype=np.int64) for a in shard[7:]
        ]
        return tuple(_devcache.to_device(a, dev) for a in cols)

    return tuple(
        tuple(put(dev, j) for j, dev in enumerate(row))
        for row in plan.devices
    )


def _scenario_shards(plan: MeshPlan, cpu_reqs, mem_reqs, replicas, s):
    """Scenario shard ``i`` of the padded grid on each device of row
    ``i``: ``blocks[i][j] = (cpu, mem, replicas)`` tensors."""
    cpu_p, mem_p, rep_p = _pad_scenarios(
        cpu_reqs, mem_reqs, replicas, plan.pad_scenarios(s)
    )
    per = cpu_p.shape[0] // plan.scenario_shards
    blocks = []
    for i, row in enumerate(plan.devices):
        sl = slice(i * per, (i + 1) * per)
        blocks.append(tuple(
            # kccap: lint-ok[device-purity] staging: one upload per shard and device, before any launch
            tuple(_devcache.to_device(a[sl], dev)
                  for a in (cpu_p, mem_p, rep_p))
            for dev in row
        ))
    # kccap: lint-ok[device-purity] staging: one upload per shard and device, before any launch
    return blocks, _devcache.to_device(rep_p, plan.first_device)


def _run_cells(plan: MeshPlan, node_cells, cpu_reqs, mem_reqs, replicas, *,
               mode: str):
    """Every cell sweeps its shards with the exact program (over groups
    when its node columns carry counts); each row's node-shard partials
    sum in int64 on the first device.  ``(totals[S], schedulable[S])`` as
    numpy."""
    s = np.asarray(cpu_reqs).shape[0]
    blocks, rep = _scenario_shards(plan, cpu_reqs, mem_reqs, replicas, s)
    first = plan.first_device
    rows = []
    for cells, scen in zip(node_cells, blocks):
        acc = None
        for cols, (cpu, mem, reps) in zip(cells, scen):
            sweep = sweep_grid_grouped if len(cols) == 8 else sweep_grid
            part = sweep(*cols, cpu, mem, reps, mode=mode)[0].to(first)
            # int64 adds wrap mod 2^64, as the JAX package's psum does.
            acc = part if acc is None else acc + part
        rows.append(acc)
    totals = torch.cat(rows)
    return totals[:s].cpu().numpy(), (totals >= rep)[:s].cpu().numpy()


def stage_gspmd_arrays(plan: MeshPlan, snapshot) -> tuple:
    """A snapshot's seven node columns, padded to the plan and placed
    shard by shard on the mesh — cached in the device cache per
    ``(snapshot, mesh, padded-N)`` so repeat sharded sweeps skip the
    host→device scatter (the sharded analog of the single-device resident
    cache)."""
    n_padded = plan.pad_nodes(snapshot.n_nodes)

    def build() -> tuple:
        return _stage_node_shards(plan, _pad_node_arrays(
            (
                snapshot.alloc_cpu_milli,
                snapshot.alloc_mem_bytes,
                snapshot.alloc_pods,
                snapshot.used_cpu_req_milli,
                snapshot.used_mem_req_bytes,
                snapshot.pods_count,
                snapshot.healthy,
            ),
            n_padded,
        ))

    return _devcache.CACHE.get(snapshot, ("gspmd", plan, n_padded), build)


def stage_gspmd_grouped_arrays(plan: MeshPlan, grouped) -> tuple:
    """A grouped snapshot's seven shape columns and counts, padded to the
    plan and placed shard by shard — cached per ``(snapshot, mesh,
    padded-G)`` under the ``"gspmd_grouped"`` form (zero-count padded
    rows contribute nothing to the weighted sum)."""
    g_padded = plan.pad_nodes(grouped.n_groups)

    def build() -> tuple:
        return _stage_node_shards(plan, _pad_node_arrays(
            (
                grouped.alloc_cpu_milli,
                grouped.alloc_mem_bytes,
                grouped.alloc_pods,
                grouped.used_cpu_req_milli,
                grouped.used_mem_req_bytes,
                grouped.pods_count,
                grouped.healthy,
                grouped.count,
            ),
            g_padded,
        ))

    return _devcache.CACHE.get(
        grouped.snapshot, ("gspmd_grouped", plan, g_padded), build
    )


def sweep_gspmd_grouped(
    plan: MeshPlan,
    grouped,
    cpu_reqs,
    mem_reqs,
    replicas,
    *,
    mode: str = "reference",
    node_mask=None,
):
    """Sharded sweep over node-shape groups: the ``[G]`` shape columns
    shard over the node axis, scenarios over the scenario axis, and each
    cell's count-weighted partial sums reduce on the first device.
    ``node_mask`` (``[N]`` bool over the PARENT snapshot's nodes) folds
    into per-group effective counts, which replace the staged counts for
    this call.  Bit-exact against the unsharded grouped sweep.
    """
    node_cells = stage_gspmd_grouped_arrays(plan, grouped)
    if node_mask is not None:
        counts = grouped.effective_counts(node_mask)
        g_padded = plan.pad_nodes(grouped.n_groups)
        counts = np.pad(counts, (0, g_padded - grouped.n_groups))
        per = g_padded // plan.node_shards
        node_cells = tuple(
            tuple(
                cols[:7] + (_devcache.to_device(
                    np.ascontiguousarray(counts[j * per:(j + 1) * per]),
                    dev),)
                for j, (cols, dev) in enumerate(zip(row, devs))
            )
            for row, devs in zip(node_cells, plan.devices)
        )
    return _run_cells(plan, node_cells, cpu_reqs, mem_reqs, replicas,
                      mode=mode)


def sweep_gspmd(
    plan: MeshPlan,
    snapshot_arrays: tuple,
    cpu_reqs,
    mem_reqs,
    replicas,
    *,
    mode: str = "reference",
    snapshot=None,
):
    """Sharded sweep with the node columns placed once per snapshot.

    ``snapshot`` (optional) names the ClusterSnapshot the arrays came
    from; when given, the padded and sharded node columns come from the
    device cache (:func:`stage_gspmd_arrays`) instead of being scattered
    host→device per call.
    """
    if snapshot is None:
        return sweep_shard_map(plan, snapshot_arrays, cpu_reqs, mem_reqs,
                               replicas, mode=mode)
    return _run_cells(plan, stage_gspmd_arrays(plan, snapshot), cpu_reqs,
                      mem_reqs, replicas, mode=mode)


def sweep_shard_map(
    plan: MeshPlan,
    snapshot_arrays: tuple,
    cpu_reqs,
    mem_reqs,
    replicas,
    *,
    mode: str = "reference",
):
    """Explicit per-shard sweep: local partial sums, then their int64 sum
    over the node axis.

    Each cell holds a ``[N/node_shards]`` slice of every snapshot array
    and a ``[S/scenario_shards]`` slice of the grid, computes its
    ``fits[s_local, n_local]`` and reduces them over its node slice; the
    partials of a row sum on the first device into that row's totals.
    """
    n = _host(snapshot_arrays[0]).shape[0]
    node_cells = _stage_node_shards(
        plan, _pad_node_arrays(snapshot_arrays, plan.pad_nodes(n))
    )
    return _run_cells(plan, node_cells, cpu_reqs, mem_reqs, replicas,
                      mode=mode)
