"""Capacity timeline: per-generation history, drift attribution, alerts.

A live ``kccap-torch-server -follow`` answers "how many replicas fit NOW";
the timeline answers the question that follows it into every incident
review: *what changed, when, and why did my headroom move?*  A
``-watch`` file names the scenarios an operator cares about; every
snapshot publish re-evaluates them (on the coalescer's thread, off the
request path), records a generation entry, and diffs it against the
previous one — nodes added/removed/mutated, per-watch capacity deltas,
and the binding-constraint shift that explains them.

This example plays synthetic follower: it drives a server through four
generations (baseline → node added → node drained → allocatable
shrink) via the same ``replace_snapshot`` publish path the coalescer
uses, then reads the attributed history back over the wire with
``client.timeline()`` — the programmatic form of ``kccap-torch -timeline
HOST:PORT``.

PyTorch port: the timeline evaluates its watches, and the server
stages each published generation, on ``device`` (the card by default),
with the exact int64 program; the diffs and alerts are host code.

Run:  python examples_torch/08_capacity_timeline.py [--device cpu]
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))  # noqa: E402 - run-by-path support

import numpy as np

from kubernetesclustercapacity_tpu_torch.report import timeline_table_report
from kubernetesclustercapacity_tpu_torch.service import CapacityClient, CapacityServer
from kubernetesclustercapacity_tpu_torch.snapshot import synthetic_snapshot
from kubernetesclustercapacity_tpu_torch.timeline import CapacityTimeline
from kubernetesclustercapacity_tpu_torch.timeline.watchlist import parse_watchlist


def drop_node(snap, i):
    keep = [j for j in range(snap.n_nodes) if j != i]
    sel = np.asarray(keep)
    return dataclasses.replace(
        snap,
        names=[snap.names[j] for j in keep],
        **{
            f: np.asarray(getattr(snap, f))[sel]
            for f in (
                "alloc_cpu_milli", "alloc_mem_bytes", "alloc_pods",
                "used_cpu_req_milli", "used_cpu_lim_milli",
                "used_mem_req_bytes", "used_mem_lim_bytes",
                "pods_count", "healthy",
            )
        },
        labels=[], taints=[], node_log=[], pod_cpu_errs=[],
    )


def shrink_cpu(snap, i, factor):
    cpu = np.asarray(snap.alloc_cpu_milli).copy()
    cpu[i] = int(cpu[i] * factor)
    return dataclasses.replace(snap, alloc_cpu_milli=cpu)


def main(device: str = "cuda") -> None:
    # The watchlist an operator would put in
    # `kccap-torch-server -watch web.yaml`:
    # reference-flag grammar, optional min_replicas alert thresholds.
    watches = parse_watchlist(
        {
            "watches": [
                {
                    "name": "web-tier",
                    "pod": {
                        "cpuRequests": "500m",
                        "memRequests": "1gb",
                        "replicas": "10",
                    },
                    "min_replicas": 120,
                },
                {
                    "name": "batch",
                    "pod": {"cpuRequests": "2", "memRequests": "4gb"},
                },
            ]
        }
    )
    timeline = CapacityTimeline(watches, depth=16, device=device)
    base = synthetic_snapshot(24, seed=42)
    server = CapacityServer(base, port=0, timeline=timeline, device=device)
    server.start()
    try:
        # --- synthetic follower: four generations of cluster churn,
        # published exactly as the coalescer publishes them (warm=True
        # pre-stages the device cache AND evaluates the watchlist on
        # this thread — a query never pays for either).
        grown = dataclasses.replace(
            synthetic_snapshot(25, seed=42),
            names=base.names + ["pool-b-7"],
        )
        drained = drop_node(grown, 7)
        shrunk = shrink_cpu(drained, 3, 0.1)
        for snap in (grown, drained, shrunk):
            server.replace_snapshot(snap, warm=True)

        with CapacityClient(*server.address) as client:
            t = client.timeline()
            print(timeline_table_report(t))

            print("\nattributed deltas, the long form:")
            for delta in t["deltas"]:
                for name, w in sorted(delta["watches"].items()):
                    print(f"  {w['summary']}")
                    if w["binding_shift"]:
                        print(f"    binding shift: {w['binding_shift']}")

            # A watch dipping below min_replicas flips its alert from
            # ok to breached (and later to recovered, which is sticky —
            # "it dipped while you were asleep" stays visible).
            alerts = t["alerts"]
            print("\nalert states:", {
                name: a["state"] for name, a in alerts.items()
            })

            # Incremental polling: a dashboard asks only for news.
            news = client.timeline(since_generation=3)
            print(
                "records after generation 3:",
                [r["generation"] for r in news["records"]],
            )
    finally:
        server.shutdown()
        timeline.close()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(device=ap.parse_args().device)
