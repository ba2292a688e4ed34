"""Capacity forecasting & autoscaler planning: time-to-breach and a
certified "what to buy", derived from verified history.

Capacity-at-risk (example 14) answers "how many replicas fit *today*
with 95% confidence".  The `forecast/` subsystem answers the next two
operator questions: WHEN does that stop being enough, and WHAT exactly
do we buy?  Three layers, each oracle-pinned:

1. trend — robust Theil–Sen demand fits replayed from the audit log's
   digest-verified generations (record timestamps, never the wall
   clock: the same history always fits the same trend);
2. horizon — the trend composed with the counter-based sampler: the
   quantile capacity ladder over H steps as ONE batched [H×S] sweep
   through the production kernel path, reduced to time_to_breach_s;
3. planner — the cheapest catalog purchase restoring the quantile
   target, LP-bounded and cannot-lie certified, plus the scale-down
   dual ("which nodes drain for free") and apply_plan for closed-loop
   what-ifs.

PyTorch port: ``project_horizon`` draws and sweeps the ``[H×S]``
batch on ``device`` (the card by default) with the exact int64 program,
and ``plan_capacity`` certifies its purchase through the same fit path
there.  The trend fit, the numpy oracle and ``apply_plan`` are host
code.

Run:  python examples_torch/20_forecast_and_plan.py [--device cpu]
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))  # noqa: E402 - run-by-path support

import dataclasses

import numpy as np

from kubernetesclustercapacity_tpu_torch.audit import AuditLog
from kubernetesclustercapacity_tpu_torch.forecast import (
    apply_plan,
    horizon_oracle,
    parse_catalog,
    plan_capacity,
    project_horizon,
    trend_from_audit,
)
from kubernetesclustercapacity_tpu_torch.report import (
    forecast_table_report,
    plan_table_report,
)
from kubernetesclustercapacity_tpu_torch.snapshot import synthetic_snapshot
from kubernetesclustercapacity_tpu_torch.stochastic import parse_stochastic_spec


def main(device: str = "cuda") -> None:
    snap = synthetic_snapshot(200, seed=11)
    spec = parse_stochastic_spec(
        {
            "usage": {
                "cpu": {"dist": "normal", "mean": "500m", "std": "150m"},
                "memory": {"dist": "lognormal", "mean": "1gb", "sigma": 0.4},
            },
            "replicas": "200",
            "samples": 64,
            "seed": 7,
        }
    )

    # --- 1. trend: fit demand growth from a verified audit history.
    # Record four hourly generations with CPU demand ramping linearly;
    # trend_from_audit replays them (digest-verified) into a Theil–Sen
    # fit whose slope is exact on clean data and robust to outliers.
    with tempfile.TemporaryDirectory() as d:
        audit = AuditLog(d)
        for g in range(4):
            used = np.array(snap.used_cpu_req_milli)
            used[0] += 36_000 * g  # +36 cores/h on one node
            audit.record_generation(
                dataclasses.replace(snap, used_cpu_req_milli=used),
                g + 1,
                ts=1000.0 + 3600.0 * g,
            )
        fit, series = trend_from_audit(d, "cpu", "usage")
    print(
        f"trend: slope {fit.slope_per_s * 3600:.0f}m/h, "
        f"relative {fit.relative_slope_per_s * 3600:.4f}/h "
        f"over {len(series.ts)} generations "
        f"(degraded={series.degraded_time_axis})"
    )
    assert abs(fit.slope_per_s - 10.0) < 1e-6  # 36000m / 3600s, exactly

    # --- 2. horizon: project the quantile ladder 24 hours out, as one
    # batched [H×S] dispatch, and read off the time to breach.
    growth = max(fit.relative_slope_per_s, 0.0)
    result = project_horizon(
        snap,
        spec,
        steps=24,
        step_s=3600.0,
        growth_cpu_per_s=growth,
        growth_mem_per_s=0.0,
        mode="strict",
        node_mask=None,
        threshold=int(spec.replicas),
        device=device,
    )
    print()
    print(forecast_table_report(result.to_wire()))

    # Deterministic and oracle-pinned: a pure numpy replay of the same
    # seed and growth schedule reduces to identical ladders.
    oracle = horizon_oracle(
        snap,
        spec,
        steps=24,
        step_s=3600.0,
        growth_cpu_per_s=growth,
        growth_mem_per_s=0.0,
        mode="strict",
        node_mask=None,
        threshold=int(spec.replicas),
    )
    assert all(
        np.array_equal(result.quantiles[q], oracle.quantiles[q])
        for q in result.quantiles
    )
    assert result.time_to_breach_s == oracle.time_to_breach_s
    print("\nseed-replay: kernel == numpy oracle, bit for bit")

    # --- 3. planner: the certified cheapest purchase that restores the
    # P95 target, from a declarative shape catalog.
    catalog = parse_catalog(
        {
            "shapes": [
                {
                    "name": "small",
                    "cpu": "8",
                    "memory": "32gb",
                    "pods": 110,
                    "unit_cost": 2.0,
                },
                {
                    "name": "big",
                    "cpu": "32",
                    "memory": "128gb",
                    "pods": 250,
                    "unit_cost": 7.0,
                },
            ]
        }
    )
    target = int(result.quantiles[0.95][0]) + 500  # today's P95 + headroom
    plan = plan_capacity(
        snap, spec, catalog, target=target, quantile=0.95, drain=True,
        device=device,
    )
    print()
    print(plan_table_report(plan.to_wire()))
    assert plan.certified, plan.uncertified_reason

    # Closed loop: apply the plan and the target must actually hold —
    # the certification already re-proved it through the real kernels,
    # but seeing is believing.
    grown = apply_plan(snap, catalog, plan.buy)
    replan = plan_capacity(
        grown, spec, catalog, target=target, quantile=0.95, device=device
    )
    assert not replan.buy, replan.buy  # nothing left to purchase
    print(
        f"\napplied: {snap.n_nodes} -> {grown.n_nodes} nodes; "
        "re-plan buys nothing — the target holds"
    )


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(device=ap.parse_args().device)
