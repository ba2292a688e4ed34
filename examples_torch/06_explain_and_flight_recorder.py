"""Explainability + flight recorder: WHY the fit stops, WHAT just ran.

Part 1 — explain: the vectorized attribution pass names the binding
constraint for every node (cpu / memory / pods / unhealthy), and the
marginal analysis answers "what is the smallest capacity increment that
buys one more replica?" — every reported delta verified against the
bug-compatible sequential evaluator before it is shown.

Part 2 — flight recorder: the capacity server remembers its last K
requests (op, args digest, snapshot generation, latency, status) in a
thread-safe ring; the ``dump`` op reads it over the wire, and a dispatch
error appends the whole ring as JSONL to ``-flight-dump``-style paths.

PyTorch port: ``explain_snapshot`` and the server's ``explain``
run the fused sweep+explain program (exact int64) on ``device`` (the
card by default).  The marginal check re-evaluates with the host's
sequential oracle; the flight recorder is host code.

Run:  python examples_torch/06_explain_and_flight_recorder.py [--device cpu]
"""

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))  # noqa: E402 - run-by-path support

import kubernetesclustercapacity_tpu_torch as kcc
from kubernetesclustercapacity_tpu_torch.fixtures import load_fixture
from kubernetesclustercapacity_tpu_torch.oracle import fit_arrays_python
from kubernetesclustercapacity_tpu_torch.service import CapacityClient, CapacityServer
from kubernetesclustercapacity_tpu_torch.snapshot import snapshot_from_fixture

FIXTURE = os.path.join(
    os.path.dirname(__file__), "..", "tests", "fixtures", "kind-3node.json"
)


def main(device: str = "cuda") -> None:
    fixture = load_fixture(FIXTURE)
    snap = snapshot_from_fixture(fixture, semantics="reference")

    # --- Part 1: explain a scenario against the snapshot.
    scenario = kcc.scenario_from_flags(
        cpuRequests="200m", memRequests="250mb", replicas="10"
    )
    grid = kcc.ScenarioGrid.from_scenarios([scenario])
    result = kcc.explain_snapshot(snap, grid, device=device)

    counts = result.binding_counts(0)
    print(f"total replicas: {int(result.totals[0])}  binding: "
          + "  ".join(f"{k}={v}" for k, v in counts.items() if v))
    assert sum(counts.values()) == snap.n_nodes

    marginal = result.marginal(0)
    for resource, m in marginal.items():
        if m is None:
            print(f"  {resource}: no single-node increment yields +1")
        else:
            print(f"  {resource}: +{m['delta']} ({m['unit']}) on "
                  f"{m['node']} -> +1 replica")
    # Every reported marginal must actually deliver: re-evaluate the
    # named node with the increment applied and watch its fit go up.
    for resource, m in marginal.items():
        if m is None:
            continue
        i = m["node_index"]
        ac = int(snap.alloc_cpu_milli[i]) + (
            m["delta"] if resource == "cpu" else 0
        )
        am = int(snap.alloc_mem_bytes[i]) + (
            m["delta"] if resource == "memory" else 0
        )
        ap = int(snap.alloc_pods[i]) + (
            m["delta"] if resource == "pods" else 0
        )
        after = fit_arrays_python(
            [ac], [am], [ap],
            [int(snap.used_cpu_req_milli[i])],
            [int(snap.used_mem_req_bytes[i])],
            [int(snap.pods_count[i])],
            int(grid.cpu_request_milli[0]),
            int(grid.mem_request_bytes[0]),
            mode="reference",
        )[0]
        assert after > int(result.fits[0][i])

    # --- Part 2: the flight recorder over the wire.
    dump_path = os.path.join(tempfile.mkdtemp(), "flight.jsonl")
    server = CapacityServer(
        snap, port=0, fixture=fixture, flight_records=64,
        flight_dump_path=dump_path,
        device=device,
    )
    server.start()
    try:
        with CapacityClient(*server.address) as client:
            client.ping()
            client.fit(cpuRequests="200m", memRequests="250mb",
                       replicas="10")
            explained = client.explain(
                cpuRequests="200m", memRequests="250mb", replicas="10"
            )
            assert explained["total"] == int(result.totals[0])
            assert explained["binding_counts"] == counts
            # A failing request: the recorder captures it AND dumps the
            # ring as JSONL (the -flight-dump behavior).
            try:
                client.call("no_such_op")
            except RuntimeError:
                pass
            dump = client.dump()
        ops = [r["op"] for r in dump["records"]]
        print(f"flight recorder: {dump['count']}/{dump['capacity']} "
              f"records, generation {dump['generation']}, ops={ops}")
        assert ops == ["ping", "fit", "explain", "unknown"]
        assert dump["records"][-1]["status"] == "error"

        # The on-error JSONL dump round-trips:
        lines = [json.loads(ln) for ln in open(dump_path, encoding="utf-8")]
        assert lines[0]["flight_dump"] is True
        assert any(r.get("status") == "error" for r in lines[1:])
        print(f"on-error dump: {len(lines) - 1} records in {dump_path}")
    finally:
        server.shutdown()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(device=ap.parse_args().device)
