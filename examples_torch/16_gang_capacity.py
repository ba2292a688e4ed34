"""Gang & topology-aware capacity: whole-gang counting over the
zone/rack/host hierarchy.

Every other surface counts independent pods; a training job or MPI gang
is all-or-nothing — 63 of 64 co-scheduled ranks is ZERO usable gangs —
and placement is rank-aware ("all ranks within one rack", "at most 2
ranks per host").  The `topology/` subsystem parses the hierarchy from
node labels into dense code columns and counts whole gangs as device
segmented reductions over the existing per-node fit column.

Four stops:

1. the topology model — labels → nested zone/rack/host code columns,
   with the missing-label policy explicit (own-domain vs excluded);
2. offline `gang_capacity` — whole gangs under co-location, rank-aware
   spread, and per-host anti-affinity, pinned bit-exact against a pure
   numpy/Python oracle on every dispatch path;
3. `gang_explain` — WHICH topology level binds ("binds at rack: largest
   rack holds 48/64 ranks"), not just how many;
4. the `gang` service op / `CapacityClient.gang()` — the same answer
   over the wire, plus the gang-watch status form.

PyTorch port: the per-node fits (exact int64), the gang reductions,
``gang_explain`` and the server's ``gang`` op run on ``device`` (the
card by default); the topology model and the gang oracle are host
code.

Run:  python examples_torch/16_gang_capacity.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))  # noqa: E402 - run-by-path support

import numpy as np

from kubernetesclustercapacity_tpu_torch.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu_torch.ops.fit import sweep_snapshot
from kubernetesclustercapacity_tpu_torch.report import gang_table_report
from kubernetesclustercapacity_tpu_torch.scenario import ScenarioGrid, scenario_from_flags
from kubernetesclustercapacity_tpu_torch.service import CapacityClient, CapacityServer
from kubernetesclustercapacity_tpu_torch.snapshot import snapshot_from_fixture
from kubernetesclustercapacity_tpu_torch.topology import (
    GangSpec,
    GangSpecError,
    gang_capacity,
    gang_explain,
    gang_oracle,
    topology_from_snapshot,
)


def main(device: str = "cuda") -> None:
    # A hierarchical fleet: 3 zones x 4 racks, built columnar (the
    # topology knob adds the well-known zone/rack labels; rack label
    # VALUES repeat across zones — the model nests them into distinct
    # domains).
    fixture = synthetic_fixture(
        120, seed=5, unhealthy_frac=0.05, taint_frac=0.1,
        topology=(3, 4),
    )
    snap = snapshot_from_fixture(fixture, semantics="strict")

    # --- 1. the hierarchy as array data.
    topo = topology_from_snapshot(snap)
    print(
        f"hierarchy: {len(topo.zone_domains)} zone(s), "
        f"{len(topo.rack_domains)} rack(s), "
        f"{len(topo.host_domains)} host(s); "
        f"host_singleton={topo.host_singleton}"
    )

    # --- 2. whole gangs, three constraint shapes.
    scenario = scenario_from_flags(cpuRequests="2", memRequests="4gb")
    grid = ScenarioGrid.from_scenarios([scenario])
    specs = {
        "co-located (rack)": GangSpec(ranks=24, count=2, colocate="rack"),
        "spread (<=8/rack in a zone)": GangSpec(
            ranks=24, count=2, colocate="zone",
            spread_level="rack", max_ranks_per_domain=8,
        ),
        "anti-affinity (1/host)": GangSpec(
            ranks=24, count=2, anti_affinity_host=True
        ),
    }
    fits = np.asarray(
        sweep_snapshot(
            snap, grid, mode="strict", return_per_node=True, device=device
        )[2]
    )
    for label, spec in specs.items():
        result = gang_capacity(snap, grid, spec, mode="strict", device=device)
        oracle = gang_oracle(fits, topo, spec)
        assert result.gangs.tolist() == oracle, (label, oracle)
        print(
            f"{label:<30} {int(result.gangs[0]):>4} whole gang(s) "
            f"(pod capacity {int(result.pod_totals[0])})"
        )

    # Constraint fields without their level are typed rejections, never
    # a silently-unconstrained evaluation.
    try:
        GangSpec(ranks=8, max_ranks_per_domain=2)
    except GangSpecError as e:
        print(f"rejected: {e}")

    # --- 3. the binding LEVEL, not just the count.
    detail = gang_explain(
        snap, grid, GangSpec(ranks=64, colocate="rack"), mode="strict",
        device=device,
    )
    print(detail["summary"])

    # --- 4. over the wire.
    server = CapacityServer(snap, port=0, device=device)
    server.start()
    try:
        with CapacityClient(*server.address) as client:
            wire = client.gang(
                ranks=24, count=2, colocate="rack",
                cpuRequests="2", memRequests="4gb",
            )
            # The server applies the implicit strict-mode taint mask —
            # same mask, same answer, any surface.
            from kubernetesclustercapacity_tpu_torch.masks import (
                implicit_taint_mask,
            )

            offline = gang_capacity(
                snap, grid, GangSpec(ranks=24, count=2, colocate="rack"),
                mode="strict", node_mask=implicit_taint_mask(snap),
                device=device,
            )
            assert wire["gangs"] == offline.gangs.tolist()
            print(gang_table_report(wire))
            status = client.gang()  # no gang watches on this server
            assert status == {"enabled": False, "watches": {}, "breached": []}
    finally:
        server.shutdown()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(device=ap.parse_args().device)
