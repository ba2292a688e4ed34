"""The capacity service: device-resident snapshot, watch-fed updates.

The reference re-walks the whole apiserver per question.  The service
holds the packed snapshot on-device and answers over a framed-JSON
protocol; watch-style events mutate it incrementally (the informer
analog), so capacity answers track the cluster without ever re-walking
it.  (For a real cluster, run the server with ``-follow``.)

PyTorch port: the server holds the snapshot on ``device`` (the
card by default).  There the single-spec ``fit`` runs the exact int64
program, the wire ``sweep`` kernel B1 (``csrc/sweep_fit.cu``; its plain
PyTorch version with ``--device cpu``), and ``drain`` the device
placement scan; the disruption-budget gate is host code.

Run:  python examples_torch/04_service_and_watch.py [--device cpu]
"""

import os

import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))  # noqa: E402 - run-by-path support

from kubernetesclustercapacity_tpu_torch.fixtures import load_fixture
from kubernetesclustercapacity_tpu_torch.service import CapacityClient, CapacityServer
from kubernetesclustercapacity_tpu_torch.snapshot import snapshot_from_fixture

FIXTURE = os.path.join(
    os.path.dirname(__file__), "..", "tests", "fixtures", "kind-3node.json"
)


def main(device: str = "cuda") -> None:
    fixture = load_fixture(FIXTURE)
    snap = snapshot_from_fixture(fixture, semantics="reference")
    server = CapacityServer(snap, port=0, fixture=fixture, device=device)
    server.start()
    try:
        with CapacityClient(*server.address) as client:
            fit = client.fit(cpuRequests="200m", memRequests="250mb",
                             replicas="10")
            print(f"capacity now: {fit['total']} replicas "
                  f"(schedulable={fit['schedulable']})")

            # A pod lands on the cluster (watch event) — capacity shrinks,
            # no repack, no re-walk:
            hog = {
                "name": "hog", "namespace": "default",
                "nodeName": fixture["nodes"][1]["name"], "phase": "Running",
                "containers": [{"resources": {"requests":
                    {"cpu": "4", "memory": "8Gi"}}}],
            }
            client.update([{"type": "ADDED", "kind": "Pod", "object": hog}])
            squeezed = client.fit(cpuRequests="200m", memRequests="250mb",
                                  replicas="10")
            print(f"after a 4-core pod lands: {squeezed['total']} replicas")
            assert squeezed["total"] < fit["total"]

            # Grid sweeps over the wire ride the same fused kernel:
            sweep = client.sweep(random={"n": 64, "seed": 1})
            print(f"64-scenario sweep via {sweep['kernel']}: "
                  f"{sum(sweep['schedulable'])}/64 schedulable")
    finally:
        server.shutdown()

    # Strict-mode server: the drain op (kubectl drain dry-run) with a
    # PodDisruptionBudget gating evictions the way the eviction API would.
    # Empty selector = every pod in the namespace; default holds exactly
    # the two web replicas, so minAvailable=2 leaves zero disruption
    # allowance.
    fixture["pdbs"] = [{
        "name": "default-pdb", "namespace": "default",
        "selector": {},
        "minAvailable": 2,
    }]
    strict = CapacityServer(
        snapshot_from_fixture(fixture, semantics="strict"),
        port=0, fixture=fixture,
        device=device,
    )
    strict.start()
    try:
        with CapacityClient(*strict.address) as client:
            worker2 = fixture["nodes"][2]["name"]
            plan = client.drain(worker2)
            print(f"\ndrain {worker2}: evictable={plan['evictable']}")
            for pod, target in plan["by_pod"].items():
                note = (f"  [BLOCKED by {', '.join(plan['blocked'][pod])}]"
                        if pod in plan["blocked"] else "")
                print(f"  {pod:<40} -> {target}{note}")
            # The worker2 web replica is part of the exhausted budget.
            assert any("web" in p for p in plan["blocked"])
            # Relax the budget via a watch-style event; the verdict flips.
            client.update([{"type": "MODIFIED", "kind": "PodDisruptionBudget",
                            "object": dict(fixture["pdbs"][0],
                                           minAvailable=1)}])
            assert client.drain(worker2)["evictable"]
            print("after relaxing the budget: evictable")
    finally:
        strict.shutdown()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(device=ap.parse_args().device)
