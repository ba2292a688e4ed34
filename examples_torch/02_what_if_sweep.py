"""What-if sweeps — the workload the reference cannot express.

The reference evaluates ONE (cpuRequests, memRequests, replicas) triple
per multi-minute apiserver walk.  The device-shaped question is a *grid*:
thousands of what-if pod shapes against one snapshot, answered in
milliseconds by the fused kernel, plus the R-resource generalization
(GPUs, ephemeral-storage).

PyTorch port: on the card the 1k-scenario sweep runs kernel B1
(``csrc/sweep_fit.cu``), the GPU-column sweep kernel B2
(``csrc/sweep_multi.cu``), the scale-up plan two B1 sweeps, and the
spread search the exact int64 program; with ``--device cpu`` each
kernel's plain PyTorch version stands in (labels ``plain_...``).

Run:  python examples_torch/02_what_if_sweep.py [--device cpu]
"""

import numpy as np

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))  # noqa: E402 - run-by-path support

import kubernetesclustercapacity_tpu_torch as kcc
from kubernetesclustercapacity_tpu_torch.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu_torch.models import CapacityModel, PodSpec
from kubernetesclustercapacity_tpu_torch.ops.fused_fit import sweep_snapshot_auto


def main(device: str = "cuda") -> None:
    snap = kcc.synthetic_snapshot(10_000, seed=7)

    # 1k random pod shapes, evaluated in one kernel launch.
    grid = kcc.random_scenario_grid(1_000, seed=8)
    totals, schedulable, kernel = sweep_snapshot_auto(
        snap, grid, device=device
    )
    print(f"kernel: {kernel}")
    print(f"p50 cluster headroom over 1k scenarios: "
          f"{int(np.median(totals))} replicas")
    print(f"schedulable fraction: {schedulable.mean():.1%}")

    # The R-resource axis: the same sweep with a GPU request column.
    rng = np.random.default_rng(9)
    fx = synthetic_fixture(2_000, seed=9)
    for node in fx["nodes"]:
        node["allocatable"]["nvidia.com/gpu"] = str(int(rng.integers(0, 9)))
    gsnap = kcc.snapshot_from_fixture(
        fx, semantics="strict", extended_resources=("nvidia.com/gpu",)
    )
    base = kcc.random_scenario_grid(256, seed=10)
    mgrid = kcc.MultiResourceGrid.from_grid(
        base, {"nvidia.com/gpu": rng.integers(0, 3, 256)}
    )
    model = CapacityModel(gsnap, mode="strict", device=device)
    mtotals, msched = model.sweep_multi(mgrid)
    gpu_rows = mgrid.requests[:, list(mgrid.resources).index("nvidia.com/gpu")]
    print(f"\nGPU-requesting scenarios: {(gpu_rows > 0).sum()} / 256")
    print(f"p50 headroom with GPU constraint: {int(np.median(mtotals))}")

    # Capacity planning over the same scenario axis: how many nodes of a
    # given shape must be ADDED per scenario (0 = fits already, -1 = the
    # shape can never help)?
    template = {"allocatable": {"cpu": "16", "memory": "67108864Ki",
                                "pods": "110"}}
    demand = kcc.ScenarioGrid(
        cpu_request_milli=base.cpu_request_milli,
        mem_request_bytes=base.mem_request_bytes,
        replicas=base.replicas + 500_000,  # demand beyond today's cluster
    )
    needed = model.nodes_needed_grid(demand, template)
    growth = needed[needed > 0]
    print(f"\nscale-up plan over 256 scenarios vs a 16-core template: "
          f"{int((needed == 0).sum())} fit already; the rest need "
          f"p50 {int(np.median(growth)) if growth.size else 0} more nodes")

    # And the zone axis: capacity under a maxSkew spread constraint.
    zoned = synthetic_fixture(120, seed=11)
    for i, node in enumerate(zoned["nodes"]):
        node.setdefault("labels", {})["zone"] = f"z{i % 3}"
    zmodel = CapacityModel(
        kcc.snapshot_from_fixture(zoned, semantics="strict"), mode="strict",
        device=device,
    )
    spread = zmodel.topology_spread(
        PodSpec(cpu_request_milli=500, mem_request_bytes=512 << 20,
                replicas=100),
        topology_key="zone", max_skew=5,
    )
    print(f"zone capacities {spread.zones} -> allowed {spread.allowed} "
          f"(total {spread.total} under maxSkew=5)")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(device=ap.parse_args().device)
