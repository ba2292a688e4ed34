"""Stochastic capacity: capacity-at-risk under usage uncertainty.

Point requests are fiction in production — real pods have usage
*distributions*, and the question an operator actually needs answered
is "how many replicas fit with 95% confidence?".  The `stochastic/`
subsystem answers it with a Monte Carlo sample axis over the existing
fit kernels: draw S per-pod usage samples (deterministic, explicitly
seeded — every run replayable), sweep them as one [S]-scenario kernel
dispatch (devcache, shape buckets, and (shape, count) grouping apply
unchanged), and reduce host-side to capacity quantiles.

Four stops:

1. offline `capacity_at_risk` — the quantile ladder + per-quantile
   binding attribution, pinned bit-exact against a numpy seed-replay
   oracle;
2. the `car` service op / `CapacityClient.car()` — the same answer
   over the wire (and `kccap-torch -car-spec FILE -snapshot ...` on the CLI);
3. a `quantile:` watch — "alert when P95 capacity < N" drives the
   existing WatchAlert → gauges → /healthz → doctor funnel;
4. the empirical feed — per-pod usage extracted from an audit log's
   recorded generations into an empirical distribution.

PyTorch port: the seeded samples are drawn on ``device`` (the card
by default) and swept there as one ``[S]``-scenario exact int64
program, offline, over the wire and in the quantile watch; the numpy
oracle and the audit-log feed are host code.

Run:  python examples_torch/14_capacity_at_risk.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))  # noqa: E402 - run-by-path support

import numpy as np

from kubernetesclustercapacity_tpu_torch.report import car_table_report
from kubernetesclustercapacity_tpu_torch.service import CapacityClient, CapacityServer
from kubernetesclustercapacity_tpu_torch.snapshot import synthetic_snapshot
from kubernetesclustercapacity_tpu_torch.stochastic import (
    capacity_at_risk,
    car_oracle,
    parse_stochastic_spec,
)
from kubernetesclustercapacity_tpu_torch.timeline import CapacityTimeline
from kubernetesclustercapacity_tpu_torch.timeline.watchlist import parse_watchlist


def main(device: str = "cuda") -> None:
    snap = synthetic_snapshot(200, seed=11)

    # --- 1. offline: the what-if a deployment gate would script on.
    spec = parse_stochastic_spec(
        {
            "usage": {
                "cpu": {"dist": "normal", "mean": "500m", "std": "200m"},
                "memory": {"dist": "lognormal", "mean": "1gb", "sigma": 0.5},
            },
            "replicas": "200",
            "samples": 128,
            "seed": 7,
            "confidence": 0.95,
        }
    )
    result = capacity_at_risk(snap, spec, device=device)
    print(car_table_report(result.to_wire()))

    # Deterministic and oracle-pinned: the same seed re-draws the same
    # samples, and a pure-numpy replay reduces to identical quantiles.
    again = capacity_at_risk(snap, spec, device=device)
    oracle = car_oracle(snap, spec)
    assert result.quantiles == again.quantiles == oracle.quantiles
    assert np.array_equal(result.totals, oracle.totals)
    print("\nseed-replay: kernel == numpy oracle, bit for bit")

    # Which resource binds at P95 vs P50 — the per-quantile attribution.
    for q in (0.5, 0.95):
        counts = {k: v for k, v in result.bindings[q].items() if v}
        print(f"  binds at p{q * 100:g}: {counts}")

    # --- 2 + 3. a served quantile watch: "alert when P95 capacity < N".
    watches = parse_watchlist(
        {
            "watches": [
                {
                    "name": "web-p95",
                    "pod": {
                        "cpuRequests": "500m",
                        "memRequests": "1gb",
                        "replicas": "200",
                    },
                    "quantile": 0.95,
                    "usage": {
                        "cpu": {
                            "dist": "normal",
                            "mean": "500m",
                            "std": "200m",
                        }
                    },
                    "samples": 64,
                    "seed": 7,
                    "min_replicas": 150,
                }
            ]
        }
    )
    timeline = CapacityTimeline(watches, depth=8, device=device)
    server = CapacityServer(snap, port=0, timeline=timeline, device=device)
    server.start()
    try:
        with CapacityClient(*server.address) as client:
            # The wire evaluate form (kccap-torch -car-spec's big brother).
            wire = client.car(
                usage=spec.to_wire()["usage"], replicas=200, seed=7
            )
            print("\nover the wire:", wire["quantiles"])

            # The watch-status form (what `kccap-torch -car HOST:PORT`
            # exits by).
            status = client.car()
            w = status["watches"]["web-p95"]
            print(
                f"watch web-p95: p95 capacity {w['last_total']} "
                f"(min 150, state {w['alert']['state']})"
            )

            # Starve the cluster: P95 capacity dips below min_replicas,
            # the alert machine breaches, and /healthz would go 503.
            import dataclasses

            starved = dataclasses.replace(
                snap,
                alloc_cpu_milli=(
                    np.asarray(snap.alloc_cpu_milli) // 20
                ).astype(np.int64),
            )
            server.replace_snapshot(starved, warm=True)
            status = client.car()
            print(
                "after starvation:",
                status["breached"],
                "->", status["watches"]["web-p95"]["alert"]["state"],
            )
            assert status["breached"] == ["web-p95"]
            assert timeline.car_breached() == ["web-p95"]
    finally:
        server.shutdown()
        timeline.close()

    # --- 4. the empirical feed: usage observed in an audit log becomes
    # the distribution (forecasts derived from replayable history).
    import tempfile

    from kubernetesclustercapacity_tpu_torch.audit import AuditLog
    from kubernetesclustercapacity_tpu_torch.stochastic import (
        extract_usage_history,
    )

    with tempfile.TemporaryDirectory() as d:
        with AuditLog(d) as log:
            for gen in range(1, 4):
                log.record_generation(
                    synthetic_snapshot(40, seed=gen), gen
                )
        history = extract_usage_history(d, "cpu")
        emp = history.distribution()
        print(
            f"\nempirical cpu usage from the audit log: "
            f"{history.observations} pod-observations, "
            f"{len(emp.values)} distinct values"
        )
        emp_spec = parse_stochastic_spec(
            {
                "usage": {"cpu": emp.to_wire(), "memory": "1gb"},
                "replicas": 100,
                "samples": 64,
            }
        )
        emp_result = capacity_at_risk(snap, emp_spec, device=device)
        print("history-driven quantiles:", emp_result.to_wire()["quantiles"])


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(device=ap.parse_args().device)
