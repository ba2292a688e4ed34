"""Mesh construction: how devices are arranged for capacity sweeps.

Counterpart of ``kubernetesclustercapacity_tpu/parallel/mesh.py``.  A
:class:`MeshPlan` is a ``(scenario, node)`` grid of ``torch.device``\\ s:

* ``"scenario"`` — shards the what-if grid.  Each row of the grid owns
  complete results for its scenarios; no cross-device traffic.
* ``"node"`` — shards the cluster's node axis.  Each device computes
  partial per-scenario replica sums over its node shard, and one int64 sum
  of the partials on the first device reduces them (the port's form of
  the JAX package's ``psum``).

The device list may name a device more than once (``["cuda:0"] * 8``): the
cells then run one after another on that device, each with its own shard
and partial, and the reduction is the same.  That lays the 1×8 and 2×4
meshes of a multi-chip deployment out on one card or on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kubernetesclustercapacity_tpu_torch.devcache import resolve_device

__all__ = ["MeshPlan", "make_mesh"]


@dataclass(frozen=True)
class MeshPlan:
    """A device grid plus the padding arithmetic sweeps need to fit on it.

    ``devices[i][j]`` runs scenario shard ``i`` against node shard ``j``.
    """

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def scenario_shards(self) -> int:
        return len(self.devices)

    @property
    def node_shards(self) -> int:
        return len(self.devices[0])

    @property
    def first_device(self) -> torch.device:
        """Where the partial sums are reduced and the result assembled."""
        return self.devices[0][0]

    def pad_scenarios(self, s: int) -> int:
        """Padded scenario count (next multiple of the scenario axis)."""
        k = self.scenario_shards
        return -(-s // k) * k

    def pad_nodes(self, n: int) -> int:
        k = self.node_shards
        return -(-n // k) * k


def make_mesh(
    scenario_parallel: int | None = None,
    node_parallel: int = 1,
    *,
    devices: list | None = None,
) -> MeshPlan:
    """Build a ``(scenario, node)`` mesh over ``devices``.

    ``devices`` defaults to every visible CUDA device (raising when there
    is none); each entry is a ``torch.device`` or its name (``"cpu"`` for
    the host).  All devices go on the scenario axis by default (the
    reduction-free layout).  ``scenario_parallel × node_parallel`` must
    cover the device count exactly.
    """
    if devices is None:
        resolve_device("cuda")  # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    n_dev = len(devices)
    if node_parallel < 1:
        raise ValueError(f"node_parallel must be >= 1, got {node_parallel}")
    if scenario_parallel is None:
        scenario_parallel = n_dev // node_parallel
    if scenario_parallel < 1 or scenario_parallel * node_parallel != n_dev:
        raise ValueError(
            f"mesh {scenario_parallel}x{node_parallel} != {n_dev} devices"
        )
    grid = tuple(
        tuple(devices[i * node_parallel:(i + 1) * node_parallel])
        for i in range(scenario_parallel)
    )
    return MeshPlan(devices=grid)
