"""Distributed tracing: one slow request, explained across processes.

A three-process serving topology — a leader publishing its plane
stream, a replica staging it, and a client-side ``ReplicaSet`` — each
writing spans to its OWN trace log (in production: three machines,
three files).  The envelope threads ``trace_id`` / ``parent_span_id``
through every hop, so the logs can be stitched back into one tree
without any clock agreement between the processes.

Sampling is TAIL-BASED (``-trace-sample p99-breach``): every request
mints IDs (cheap, always), but span bodies buffer in a bounded ring
and are only flushed when the END of the request shows it mattered —
here, when its latency breaches the op's running p99.  150 routine
sweeps leave nothing behind; the one pathological sweep (a new, much
heavier grid shape) breaches and its WHOLE tree survives.

Then the offline analyzer answers the on-call question ("p99 breached
— what was slow?") from the logs alone::

    kccap-torch -trace-tree TRACE_ID -trace-logs LOGDIR

stitching client attempt, server request and phase spans into one
tree, computing the critical path, and naming the dominating phase in
the same vocabulary the ``kccap_phase_seconds`` histogram uses.

PyTorch port: the leader and the replica serve on ``device`` (the
card by default), the heavy sweep's ``device_exec`` phase included;
the trace logs and the analyzer are host code.  On the card a sweep's
latency hardly grows with its scenario count, so the heavy shape is
65,536 scenarios where the JAX example sends 2,048, and the device path
is warmed before the servers start, so that the first sweep's one-off
cost is not in the cohort the p99 is estimated from.

Run:  python examples_torch/21_distributed_tracing.py [--device cpu]
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))  # noqa: E402 - run-by-path support

import numpy as np

from kubernetesclustercapacity_tpu_torch.ops.fused_fit import sweep_snapshot_auto
from kubernetesclustercapacity_tpu_torch.report import trace_table_report
from kubernetesclustercapacity_tpu_torch.scenario import ScenarioGrid
from kubernetesclustercapacity_tpu_torch.service.plane import (
    PlanePublisher,
    PlaneSubscriber,
)
from kubernetesclustercapacity_tpu_torch.service.replicaset import ReplicaSet
from kubernetesclustercapacity_tpu_torch.service.server import CapacityServer
from kubernetesclustercapacity_tpu_torch.snapshot import synthetic_snapshot
from kubernetesclustercapacity_tpu_torch.telemetry.traceview import analyze_trace


def _wait(predicate, timeout_s=15.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError("timed out")


def main(device: str = "cuda") -> None:
    n = int(os.environ.get("KCC_EXAMPLE_NODES", 128))
    snap = synthetic_snapshot(n, seed=5)
    cpu, mem = [100], [10 ** 8]
    # Warm the device path first, outside any server: a process's first
    # sweep on the card pays one-off costs (CUDA's lazy load of the
    # program's kernels, the first staging of its operands) that take up
    # to seconds.  Inside the routine cohort below, two such outliers
    # would lift the p99 estimate above the heavy sweep.
    sweep_snapshot_auto(
        snap,
        ScenarioGrid(
            cpu_request_milli=np.array(cpu, dtype=np.int64),
            mem_request_bytes=np.array(mem, dtype=np.int64),
            replicas=np.ones(1, dtype=np.int64),
        ),
        device=device,
    )

    with tempfile.TemporaryDirectory() as logdir:
        # --- the topology: leader -> plane -> replica, client in front.
        # Each process owns one JSONL trace log in `logdir`.
        pub = PlanePublisher(
            heartbeat_s=0.1, trace_log=os.path.join(logdir, "plane.jsonl")
        )
        leader = CapacityServer(
            snap, port=0, plane=pub, batch_window_ms=0.0,
            trace_log=os.path.join(logdir, "leader.jsonl"),
            trace_sample="p99-breach",
            device=device,
        )
        leader.start()
        replica = CapacityServer(
            snap, port=0, batch_window_ms=0.0,
            trace_log=os.path.join(logdir, "replica.jsonl"),
            trace_sample="p99-breach",
            device=device,
        )
        replica.start()
        sub = PlaneSubscriber(
            pub.address, replica, stale_after_s=30.0,
            trace_log=os.path.join(logdir, "replica.jsonl"),
        )
        _wait(lambda: replica.generation >= leader.generation)
        rs = ReplicaSet(
            [replica.address],
            connect_timeout_s=5.0, timeout_s=60.0, rounds=3,
            trace_log=os.path.join(logdir, "client.jsonl"),
        )

        try:
            # --- 150 routine sweeps: IDs mint and propagate on every
            # one, but p99-breach keeps NO bodies (first the estimator
            # warms, then nothing is slower than its own cohort's p99).
            for _ in range(150):
                rs.sweep(cpu_request_milli=cpu, mem_request_bytes=mem)
            routine_ids = {
                json.loads(line)["trace_id"]
                for line in open(os.path.join(logdir, "client.jsonl"))
            }
            server_log = os.path.join(logdir, "replica.jsonl")
            kept_server = (
                open(server_log).read() if os.path.exists(server_log) else ""
            )
            dropped = sum(
                1 for t in routine_ids if t and t in kept_server
            )
            print(f"routine     : 150 sweeps traced, {dropped} kept "
                  f"server-side (tail sampling dropped the boring ones)")
            assert dropped == 0

            # --- the breach: a new, much heavier grid shape.  Its
            # end-of-request latency crosses the op's p99 estimate, so
            # the sampler flushes the WHOLE buffered tree.  On the card a
            # 2,048-scenario sweep of 128 nodes answers about as fast as a
            # routine one and breaches nothing, so the heavy shape here is
            # 65,536 scenarios: its host work (the eligibility proofs, the
            # reply's JSON) outlasts the routine p99 on either device.
            grid = int(os.environ.get("KCC_EXAMPLE_SCENARIOS", 65536))
            slow = rs.sweep(
                cpu_request_milli=cpu * grid,
                mem_request_bytes=mem * grid,
                replicas=[1] * grid,
            )
            print(f"breach      : {grid}-scenario sweep answered "
                  f"(totals[0]={slow['totals'][0]}) — latency breached "
                  f"p99, trace kept")

            # --- offline: stitch the per-process logs into one tree.
            # (CLI form: kccap-torch -trace-tree TRACE_ID -trace-logs LOGDIR)
            breach_id = [
                json.loads(line)["trace_id"]
                for line in open(os.path.join(logdir, "client.jsonl"))
                if json.loads(line).get("op") == "rs:sweep"
            ][-1]
            tree = analyze_trace([logdir], breach_id)
            print()
            print(trace_table_report(tree))

            assert tree["found"]

            def _nodes(node):
                yield node
                for child in node.get("children", ()):
                    yield from _nodes(child)

            flat = [s for root in tree["roots"] for s in _nodes(root)]
            ops = {s["op"] for s in flat}
            assert "rs:sweep" in ops and "rs:attempt" in ops  # client side
            assert any(s.get("service") == "server" for s in flat)
            cp = tree["critical_path"]
            assert not cp.get("refused") and cp["dominant"]
        finally:
            rs.close()
            sub.stop()
            pub.close()
            replica.shutdown()
            leader.shutdown()
    print("traced, breached, explained.")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(device=ap.parse_args().device)
