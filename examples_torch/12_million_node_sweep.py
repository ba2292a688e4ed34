"""A true million-node capacity sweep via node-shape compression.

Real fleets are degenerate: a handful of machine shapes × thousands of
replicas.  Capacity is a *sum* over nodes, so deduplicating identical
``(allocatable, usage, pods, health, extended)`` rows into
``(shape, count)`` groups is exact — the kernel sweeps the ~100s of
distinct shapes and weights each fit by its multiplicity
(``Σ count_g · fit_g``), shrinking a 1,000,000-row problem to a few
hundred device rows.  This example:

* builds a degenerate 1M-node snapshot (``synthetic_snapshot(shapes=K)``);
* shows the grouped form (``ClusterSnapshot.grouped()``): group count,
  compression ratio, and the invertible group→node index map;
* sweeps it through the production auto dispatch (which engages the
  grouped kernels on its own) and proves bit-exact parity against the
  ungrouped exact kernel on a scenario sample;
* demonstrates the ``KCCAP_GROUPING=0`` escape hatch.

PyTorch port: on ``device`` (the card by default) the auto dispatch
sweeps the groups with kernel B1 (``csrc/sweep_fit.cu``) in its grouped
form, and the parity check runs the ungrouped exact int64 program over
all the staged rows; with ``--device cpu`` B1's plain PyTorch version
stands in.  The build and grouping steps are host numpy.

Tuning: ``kccap-torch-server -group-min-count K`` / ``KCCAP_GROUP_MIN_COUNT``
set the mean-occupancy gate; ``KCC_EXAMPLE_NODES`` scales this demo.

Run:  python examples_torch/12_million_node_sweep.py [--device cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))  # noqa: E402 - run-by-path support

import numpy as np

import torch

from kubernetesclustercapacity_tpu_torch.ops.fit import sweep_grid, snapshot_device_arrays
from kubernetesclustercapacity_tpu_torch.ops.fused_fit import sweep_snapshot_auto
from kubernetesclustercapacity_tpu_torch.scenario import random_scenario_grid
from kubernetesclustercapacity_tpu_torch.snapshot import (
    grouped_for_dispatch,
    synthetic_snapshot,
)


def main(device: str = "cuda") -> None:
    n_nodes = int(os.environ.get("KCC_EXAMPLE_NODES", 1_000_000))

    # --- a degenerate fleet: 384 machine shapes × ~2,600 replicas each.
    t0 = time.perf_counter()
    snap = synthetic_snapshot(n_nodes, seed=21, shapes=384)
    build_ms = (time.perf_counter() - t0) * 1e3
    print(f"snapshot: {snap.n_nodes:,} nodes built in {build_ms:.0f} ms")

    # --- the compressed form: (shape, count) groups + invertible map.
    t0 = time.perf_counter()
    grouped = snap.grouped()
    group_ms = (time.perf_counter() - t0) * 1e3
    print(
        f"grouped:  {grouped.n_groups} shape groups "
        f"({grouped.compression_ratio:,.0f}x compression) in "
        f"{group_ms:.0f} ms"
    )
    biggest = int(np.argmax(grouped.count))
    print(
        f"  largest group: {int(grouped.count[biggest]):,} nodes shaped "
        f"like {grouped.representative_names()[biggest]}"
    )
    # The index map inverts the compression: every node knows its group.
    assert grouped.group_index.shape == (snap.n_nodes,)
    assert int(grouped.count.sum()) == snap.n_nodes

    # --- sweep all million nodes through the production dispatch (the
    # grouped kernels engage automatically above the occupancy gate).
    assert grouped_for_dispatch(snap) is not None
    grid = random_scenario_grid(64, seed=5)
    # warm/compile
    totals, sched, kernel = sweep_snapshot_auto(snap, grid, device=device)
    t0 = time.perf_counter()
    totals, sched, kernel = sweep_snapshot_auto(snap, grid, device=device)
    sweep_ms = (time.perf_counter() - t0) * 1e3
    print(
        f"sweep:    {grid.size} scenarios x {snap.n_nodes:,} nodes in "
        f"{sweep_ms:.1f} ms via {kernel}"
    )

    # --- parity: the grouped answer IS the ungrouped answer (sampled
    # scenarios through the exact int64 kernel over all 1M rows).
    arrays = snapshot_device_arrays(snap, device)
    sample = slice(0, 8)

    def on_device(col):
        return torch.from_numpy(col[sample].copy()).to(arrays[0].device)

    exact = (
        sweep_grid(
            *arrays,
            on_device(grid.cpu_request_milli),
            on_device(grid.mem_request_bytes),
            on_device(grid.replicas),
        )[0]
        .cpu()
        .numpy()
    )
    diffs = int((totals[sample] != exact).sum())
    print(f"parity:   grouped vs ungrouped diffs = {diffs}")
    assert diffs == 0

    # --- escape hatch: KCCAP_GROUPING=0 restores the ungrouped path.
    saved = os.environ.get("KCCAP_GROUPING")
    os.environ["KCCAP_GROUPING"] = "0"
    try:
        assert grouped_for_dispatch(snap) is None
        print("escape:   KCCAP_GROUPING=0 -> grouped dispatch disengaged")
    finally:
        if saved is None:
            del os.environ["KCCAP_GROUPING"]
        else:
            os.environ["KCCAP_GROUPING"] = saved


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(device=ap.parse_args().device)
