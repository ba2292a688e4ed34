"""Federated multi-cluster capacity: one query plane over a fleet.

Three cluster leaders (each a PR-10 ``PlanePublisher`` — in production,
``kccap-torch-server -plane-port`` per cluster) publish their digest-chained
generation streams into one ``FederationServer``, which answers
fleet-global queries as ONE batched kernel dispatch over the
concatenated clusters:

* ``fed_sweep``  — across all clusters, how many replicas fit, and
  where (per-cluster split, every reply annotated with the
  per-cluster ``{generation, age_s, state}`` degradation vector);
* ``fed_rank``   — most-headroom / cheapest placement ranking;
* ``spillover``  — drain cluster X: where does its load land?

Then a PARTITION: one leader dies.  Its cluster keeps serving its last
verified snapshot explicitly marked ``stale`` (bounded age on an
injectable clock), flips to ``lost`` past the eviction horizon —
EXCLUDED from totals and named in the reply — and the fleet totals are
exactly the survivors' sum.  Explicitly stale, never silently wrong.

Deployment shape::

    leader:  kccap-torch-server -snapshot east.json -plane-port 7100
    fed:     kccap-torch-fed -cluster east=h1:7100 -cluster west=h2:7100 \\
                       -port 7177 -metrics-port 9100
    client:  kccap-torch -fed-status 127.0.0.1:7177
             kccap-torch -fed-sweep 127.0.0.1:7177 -cpuRequests 500m

PyTorch port: the three leaders and the federation run on
``device`` (the card by default): ``fed_sweep``, ``fed_rank`` and
``spillover`` evaluate the concatenated clusters there with the exact
int64 program.  The plane streams and the injected clock are host
code.

Run:  python examples_torch/15_federated_fleet.py [--device cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))  # noqa: E402 - run-by-path support

from kubernetesclustercapacity_tpu_torch.federation import FederationServer
from kubernetesclustercapacity_tpu_torch.report import fed_status_table_report
from kubernetesclustercapacity_tpu_torch.service.client import CapacityClient
from kubernetesclustercapacity_tpu_torch.service.plane import PlanePublisher
from kubernetesclustercapacity_tpu_torch.service.server import CapacityServer
from kubernetesclustercapacity_tpu_torch.snapshot import synthetic_snapshot


def _wait(predicate, timeout_s=15.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError("timed out")


def main(device: str = "cuda") -> None:
    n = int(os.environ.get("KCC_EXAMPLE_NODES", 128))
    # The injected clock: partition ages are DRIVEN, not slept for.
    now = [0.0]

    # --- three cluster leaders, each publishing its own plane stream.
    names = ("east", "west", "north")
    leaders, pubs = {}, {}
    for i, name in enumerate(names):
        pub = PlanePublisher(heartbeat_s=0.1)
        server = CapacityServer(
            synthetic_snapshot(n, seed=10 + i), port=0, plane=pub,
            batch_window_ms=0.0,
            device=device,
        )
        server.start()
        leaders[name], pubs[name] = server, pub

    # --- the federation tier subscribes to every leader's stream.
    fed = FederationServer(
        {name: pubs[name].address for name in names},
        stale_after_s=5.0,
        evict_after_s=15.0,
        clock=lambda: now[0],
        device=device,
    ).start()
    _wait(lambda: all(
        c["state"] == "fresh" for c in fed.status()["clusters"].values()
    ))
    print(fed_status_table_report(fed.dispatch({"op": "fed_status"})))

    # --- fleet queries over the wire (the same client the CLI uses).
    client = CapacityClient(*fed.address)
    sweep = client.fed_sweep(
        cpu_request_milli=[100, 500], mem_request_bytes=[10 ** 8, 10 ** 9],
        replicas=[1, 64],
    )
    print(f"\nfed_sweep totals={sweep['totals']} "
          f"per_cluster={sweep['per_cluster']}")
    rank = client.fed_rank(cpuRequests="500m", memRequests="1gb",
                           replicas="64")
    print("fed_rank    :",
          [(r["rank"], r["cluster"], r["total"]) for r in rank["ranking"]])
    spill = client.spillover("east", cpuRequests="500m", memRequests="1gb")
    print(f"spillover   : drain east (load={spill['demand']} pods) -> "
          f"{[(p['cluster'], p['replicas']) for p in spill['placements']]} "
          f"absorbed={spill['absorbed']}")

    # --- PARTITION: the east leader dies; its stream goes silent.
    pubs["east"].close()
    leaders["east"].shutdown()
    now[0] = 8.0  # past stale_after_s (5), inside evict_after_s (15)
    # The survivors' heartbeats re-verify them at the advanced clock;
    # east's verified age can only grow.
    _wait(lambda: (
        fed.status()["clusters"]["east"]["state"] == "stale"
        and all(
            fed.status()["clusters"][m]["state"] == "fresh"
            for m in ("west", "north")
        )
    ))
    stale = client.fed_sweep(cpu_request_milli=[100],
                             mem_request_bytes=[10 ** 8])
    east = stale["clusters"]["east"]
    print(f"\npartitioned : east explicitly stale "
          f"(age={east['age_s']}s > 5s), still counted: "
          f"totals={stale['totals']}")
    assert stale["totals"] == sweep["totals"][:1]  # same verified views
    assert east["state"] == "stale" and stale["degraded"]

    # --- past the eviction horizon: lost, excluded BY NAME.
    now[0] = 20.0
    _wait(lambda: fed.status()["clusters"]["east"]["state"] == "lost")
    lost = client.fed_sweep(cpu_request_milli=[100],
                            mem_request_bytes=[10 ** 8])
    survivors = sum(
        t[0] for name, t in lost["per_cluster"].items() if name != "east"
    )
    assert lost["excluded"] == ["east"]
    assert "east" not in lost["per_cluster"]
    assert lost["totals"][0] == survivors
    print(f"evicted     : east LOST -> excluded={lost['excluded']}, "
          f"totals={lost['totals']} (= survivors' sum, never a silent "
          f"hole)")

    client.close()
    fed.close()
    for name in names:
        if name != "east":
            pubs[name].close()
            leaders[name].shutdown()
    print("fleet down.")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(device=ap.parse_args().device)
