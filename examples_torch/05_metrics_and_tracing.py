"""Observability: metrics registry, Prometheus scrape, request tracing.

The service records per-op request counters and latency histograms into
a telemetry registry; an HTTP endpoint renders that registry as
Prometheus text format (what ``kccap-torch-server -metrics-port`` serves),
and a trace ID sent by the client lands in the server's JSONL trace
log (``-trace-log``), stitching a client call to its server-side span.

PyTorch port: the server runs on ``device`` (the card by
default); its ``fit`` and the ``kernel="exact"`` sweep run the exact
int64 program there.  The registry, the scrape endpoint and the trace
log are host code.

Run:  python examples_torch/05_metrics_and_tracing.py [--device cpu]
"""

import json
import os
import sys
import tempfile
import urllib.request

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))  # noqa: E402 - run-by-path support

from kubernetesclustercapacity_tpu_torch.fixtures import load_fixture
from kubernetesclustercapacity_tpu_torch.service import CapacityClient, CapacityServer
from kubernetesclustercapacity_tpu_torch.snapshot import snapshot_from_fixture
from kubernetesclustercapacity_tpu_torch.telemetry import (
    MetricsRegistry,
    new_trace_id,
    start_metrics_server,
)

FIXTURE = os.path.join(
    os.path.dirname(__file__), "..", "tests", "fixtures", "kind-3node.json"
)


def main(device: str = "cuda") -> None:
    fixture = load_fixture(FIXTURE)
    snap = snapshot_from_fixture(fixture, semantics="reference")

    # One registry feeds everything: server dispatch metrics, client
    # transport counters, and the scrape endpoint.
    registry = MetricsRegistry()
    trace_path = os.path.join(tempfile.mkdtemp(), "trace.jsonl")
    server = CapacityServer(
        snap, port=0, fixture=fixture, registry=registry,
        trace_log=trace_path,
        device=device,
    )
    server.start()
    metrics = start_metrics_server(registry)  # port 0 = auto-pick
    try:
        with CapacityClient(*server.address, registry=registry) as client:
            # Drive some load — each op counts and times itself.
            client.ping()
            for _ in range(3):
                client.fit(cpuRequests="200m", memRequests="250mb",
                           replicas="10")
            # A traced call: the ID we mint here shows up in the
            # server's trace log.
            trace_id = new_trace_id()
            client.sweep(random={"n": 32, "seed": 1}, kernel="exact",
                         trace_id=trace_id)

        # Scrape /metrics exactly like Prometheus would:
        text = urllib.request.urlopen(
            metrics.url + "/metrics"
        ).read().decode()
        fit_lines = [
            ln for ln in text.splitlines()
            if ln.startswith("kccap_requests_total")
        ]
        print("\n".join(fit_lines))
        assert 'kccap_requests_total{op="fit"} 3' in fit_lines

        health = json.loads(
            urllib.request.urlopen(metrics.url + "/healthz").read()
        )
        print(f"healthz: {health}")
        assert health == {"ok": True}

        # The latency histogram moved with the counters:
        hist = registry.snapshot()[
            "kccap_request_latency_seconds"
        ]["values"]['op="fit"']
        print(f"fit latency: count={hist['count']} "
              f"sum={hist['sum'] * 1e3:.2f} ms")
        assert hist["count"] == 3

        # And the traced sweep round-tripped into the JSONL span log.
        # The trace holds the request span plus its phase children
        # (op="phase:..."), so select the request span by op:
        spans = [
            json.loads(ln) for ln in open(trace_path, encoding="utf-8")
        ]
        mine = [s for s in spans if s["trace_id"] == trace_id]
        req = next(s for s in mine if s["op"] == "sweep")
        print(f"trace {trace_id[:8]}…: op={req['op']} "
              f"{req['duration_ms']} ms {req['status']} "
              f"(+{len(mine) - 1} phase span(s))")
        assert req["status"] == "ok"
    finally:
        metrics.shutdown()
        server.shutdown()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(device=ap.parse_args().device)
