"""The replicated serving plane: one leader, N replicas, zero wrong answers.

One ``CapacityServer`` is a single point of failure.  This example runs
the whole replicated plane in one process:

* a **leader** publishing every snapshot generation over the plane
  pub-sub stream (digest-chained checkpoint/diff frames — the audit
  log's record vocabulary, live);
* two **replicas** staging each digest-VERIFIED generation into their
  own server, serving reads stamped with the leader's generation
  numbers, each protected by **admission control** (concurrency gate +
  rps token bucket, shedding with the retryable-elsewhere
  ``overloaded`` code);
* a **ReplicaSet** client enforcing read-your-generation monotonicity
  across endpoints (the watermark), failing over past a killed replica,
  and gracefully **draining** one server via the ``drain_server`` op.

Deployment shape (``kccap-torch-server`` flags)::

    leader:   kccap-torch-server -snapshot c.json -plane-port 7100 \\
                           -admission-rps 500
    replica:  kccap-torch-server -snapshot c.json -port 7078 \\
                           -plane-leader leader:7100
    client:   kccap-torch -plane-status replica:7078
    drain:    kccap-torch -drain-server replica:7078

PyTorch port: the leader and both replicas serve on ``device``
(the card by default); a replica stages each verified generation there
as it swaps it in.  The plane stream, admission and the ``ReplicaSet``
are host code.

Run:  python examples_torch/13_replicated_plane.py [--device cpu]
"""

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))  # noqa: E402 - run-by-path support

import numpy as np

from kubernetesclustercapacity_tpu_torch.service.plane import (
    AdmissionController,
    PlanePublisher,
    PlaneSubscriber,
)
from kubernetesclustercapacity_tpu_torch.service.replicaset import ReplicaSet
from kubernetesclustercapacity_tpu_torch.service.server import CapacityServer
from kubernetesclustercapacity_tpu_torch.snapshot import synthetic_snapshot


def _wait(predicate, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.01)
    raise AssertionError("timed out")


def main(device: str = "cuda") -> None:
    snap = synthetic_snapshot(int(os.environ.get("KCC_EXAMPLE_NODES", 256)),
                              seed=13)

    # --- the leader: its replace_snapshot funnel feeds the plane.
    pub = PlanePublisher()
    leader = CapacityServer(
        snap, port=0, plane=pub, batch_window_ms=0.0, device=device
    )
    leader.start()

    # --- two replicas, each admission-controlled and plane-fed.
    replicas, subs = [], []
    for _ in range(2):
        server = CapacityServer(
            snap, port=0, batch_window_ms=0.0,
            admission=AdmissionController(max_concurrent=8, rps=500.0),
            device=device,
        )
        server.start()
        subs.append(PlaneSubscriber(pub.address, server, stale_after_s=10.0))
        replicas.append(server)
    _wait(lambda: all(s.applied_generation >= 1 for s in subs))
    print(f"plane up: leader gen {leader.generation}, "
          f"{pub.stats()['subscribers']} replicas synced")

    # --- a multi-endpoint client: failover + generation watermark.
    rs = ReplicaSet([r.address for r in replicas])
    r = rs.sweep(cpu_request_milli=[100, 500], mem_request_bytes=[10**8, 10**9],
                 replicas=[1, 4])
    print(f"sweep @ gen {rs.last_generation}: totals={r['totals']} "
          f"(watermark {rs.watermark})")

    # --- churn: the leader publishes a new generation; replicas verify
    # its digest chain before serving it, stamped with the new number.
    snap2 = dataclasses.replace(
        snap,
        used_cpu_req_milli=snap.used_cpu_req_milli
        + np.full(snap.n_nodes, 500, dtype=np.int64),
    )
    leader.replace_snapshot(snap2)
    _wait(lambda: all(s.applied_generation >= 2 for s in subs))
    r2 = rs.sweep(cpu_request_milli=[100, 500],
                  mem_request_bytes=[10**8, 10**9], replicas=[1, 4])
    print(f"after churn @ gen {rs.last_generation}: totals={r2['totals']} "
          f"(capacity moved: {r['totals'] != r2['totals']})")
    assert rs.watermark == 2  # the session can never regress below this

    # --- chaos: kill replica 0 outright; the set fails over.
    subs[0].stop()
    replicas[0].shutdown()
    r3 = rs.sweep(cpu_request_milli=[100], mem_request_bytes=[10**8],
                  replicas=[1])
    assert r3["totals"] == r2["totals"][:1]
    print(f"replica killed → failover served gen {rs.last_generation} "
          f"identically")

    # --- graceful drain of the survivor: in-flight finishes, new work
    # is refused with the retryable-elsewhere 'draining' code.
    ep = f"{replicas[1].address[0]}:{replicas[1].address[1]}"
    record = rs.drain_server(endpoint=ep)
    print(f"drained {ep}: drained={record['drained']} "
          f"waited_s={record['waited_s']}")

    rs.close()
    for s in subs:
        s.stop()
    for server in replicas:
        server.shutdown()
    pub.close()
    leader.shutdown()
    print("plane down.")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(device=ap.parse_args().device)
