"""Per-request latency decomposition and SLO burn-rate monitoring.

A request's latency is more than its kernel: every
answering request decomposes into a fixed phase vocabulary — where
inside the request did the time go — and the service's own latency/
availability ride SRE-style multi-window error-budget burn rates.
This example walks both:

1. a server dispatches sweeps with the per-request ``PhaseClock``
   active; the flight recorder's ``phases`` field and the
   ``kccap_phase_seconds{op,phase}`` histograms carry the breakdown
   (the same thing ``kccap-torch -dump HOST:PORT`` renders);
2. an ``SLOMonitor`` evaluates an availability objective over the
   server's own request counters; a burst of already-expired-deadline
   requests burns the error budget, the alert machine walks
   ok → breached → recovered, and ``kccap-torch -slo-status`` renders the
   verdict (exit 1 while breached).

PyTorch port: the server sweeps on ``device`` (the card by
default) with kernel B1 (``csrc/sweep_fit.cu``; its plain PyTorch
version with ``--device cpu``).  Its ``compile`` phase is the first
dispatch of a kernel label in the process: the ``nvcc`` build or the
load of the kernel's library, and CUDA's lazy module load.  The SLO
monitor is host code.

Run:  python examples_torch/10_latency_slo.py [--device cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))  # noqa: E402 - run-by-path support

from kubernetesclustercapacity_tpu_torch.report import (
    dump_table_report,
    slo_table_report,
)
from kubernetesclustercapacity_tpu_torch.resilience import Deadline
from kubernetesclustercapacity_tpu_torch.service import (
    CapacityClient,
    CapacityServer,
)
from kubernetesclustercapacity_tpu_torch.snapshot import synthetic_snapshot
from kubernetesclustercapacity_tpu_torch.telemetry.metrics import MetricsRegistry
from kubernetesclustercapacity_tpu_torch.telemetry.slo import SLOMonitor, parse_slos


def main(device: str = "cuda") -> None:
    registry = MetricsRegistry()
    # One availability objective with example-sized windows (production
    # would keep the 60 s / 600 s defaults and fast_burn 14).
    monitor = SLOMonitor(
        parse_slos([
            {
                "name": "availability",
                "availability": 0.9,
                "short_window_s": 0.3,
                "long_window_s": 30,
                "fast_burn": 1.5,
            }
        ]),
        registry=registry,
    )
    server = CapacityServer(
        synthetic_snapshot(32, seed=11), port=0, registry=registry,
        slo=monitor,
        device=device,
    )
    server.start()
    try:
        with CapacityClient(*server.address) as client:
            # --- 1. phase decomposition.  Two sweeps: the first pays
            # compile + devcache staging, the second is steady state.
            # The port traces and compiles nothing per shape; its
            # "compile" is a kernel label's first dispatch in the process
            # (the nvcc build or the library load), so it can only appear
            # on the first sweep, and the steady one never carries it.
            for _ in range(2):
                client.sweep(random={"n": 16, "seed": 4})
            dump = client.dump(op="sweep")
            print(dump_table_report(dump))
            steady = dump["records"][-1]["phases"]
            assert set(steady) and "compile" not in steady, steady
            assert "serialize" in steady, steady

            # --- 2. healthy traffic → the SLO is ok.
            for _ in range(6):
                client.ping()
            status = client.slo_status()
            assert status["status"]["availability"]["state"] == "ok"

            # --- 3. burn the budget: requests whose deadline already
            # expired are shed server-side (the same counter a stalled
            # network path would drive), spending availability budget.
            expired = Deadline.after(-1.0).to_wire()
            for _ in range(6):
                try:
                    client.call("sweep", random={"n": 4, "seed": 1},
                                deadline=expired)
                except Exception:
                    pass  # each shed IS the signal
            monitor.evaluate()
            time.sleep(0.05)
            monitor.evaluate()
            status = client.slo_status()
            print()
            print(slo_table_report(status))
            assert status["fast_burning"], status
            assert status["status"]["availability"]["state"] == "breached"

            # --- 4. recovery: clean traffic drains the short window —
            # the machine lands on "recovered" (NOT "ok": "it dipped
            # while you were asleep" is the point of the distinction).
            deadline = time.time() + 10
            while time.time() < deadline:
                for _ in range(4):
                    client.ping()
                status = client.slo_status()
                if not status["fast_burning"]:
                    break
                time.sleep(0.05)
            assert status["status"]["availability"]["state"] == "recovered"
            print()
            print(slo_table_report(status))
            burn = registry.snapshot()["kccap_slo_burn_rate"]["values"]
            print()
            print(
                "burn gauges:",
                {k: round(v, 2) for k, v in sorted(burn.items())},
            )
    finally:
        monitor.close()
        server.shutdown()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(device=ap.parse_args().device)
