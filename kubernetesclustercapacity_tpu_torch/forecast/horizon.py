"""Forward capacity projection: ONE batched [H×S] sweep over a horizon.

Counterpart of ``kubernetesclustercapacity_tpu/forecast/horizon.py``: the
``[H·S]`` grid runs as one dispatch of the exact int64 program on the card
(:func:`..ops.fit.sweep_snapshot`, ``device=``, default ``"cuda"``); the
scaling rule, the reduction and the numpy oracle are the JAX module's.

"Capacity at risk" answers *how many fit now with 95% confidence*; this
module answers *when that stops being true*.  It composes the robust
trend (:mod:`.trend`) with the counter-based stochastic sampler
(:mod:`~..stochastic.distributions`): the trend's relative growth rate
scales the per-pod usage samples at each of ``H`` horizon steps, and the
whole ``[H, S]`` projection is flattened into ONE
:class:`~..scenario.ScenarioGrid` of ``H·S`` rows and dispatched as a
single ``sweep_snapshot`` call — the device cache and the (shape,
count) grouped route ride unchanged, so a 32-step × 64-sample forecast
costs one dispatch, not 2048.

Scaling rule (shared with the numpy oracle, documented so both sides
implement it independently): at step ``h`` (``h = 0`` is now) the growth
factor is ``g_h = max(0, 1 + rate·h·step_s)`` and each int64 usage
sample ``u`` becomes ``clip(rint(float64(u)·g_h), 1, MAX_USAGE)`` —
float64 multiply, round-half-even, clamp into the sampler's own domain.
Per step the capacity quantiles reduce with the exact order-statistic
rule capacity-at-risk documents (:func:`~..stochastic.car.
quantile_index`), and ``time_to_breach_s`` is the first step whose
quantile capacity falls below the threshold, in seconds (``0.0`` =
breached already, ``None`` = no breach within the horizon).

Determinism: samples are drawn once from the spec's explicit seed and
scaled host-side — the projection is a pure function of (snapshot, spec,
growth, steps, step_s), bit-exact across grouped/ungrouped/cached paths
because the underlying sweep is, and therefore audit-replayable.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np

from kubernetesclustercapacity_tpu_torch.ops.fit import sweep_snapshot
from kubernetesclustercapacity_tpu_torch.scenario import ScenarioGrid
from kubernetesclustercapacity_tpu_torch.snapshot import ClusterSnapshot
from kubernetesclustercapacity_tpu_torch.stochastic.car import (
    DEFAULT_QUANTILES,
    fit_totals_numpy,
    quantile_index,
    quantile_label,
)
from kubernetesclustercapacity_tpu_torch.stochastic.distributions import (
    MAX_USAGE,
    StochasticSpec,
    sample_key,
    sample_usage,
)

__all__ = [
    "DEFAULT_STEPS",
    "DEFAULT_STEP_S",
    "HorizonResult",
    "horizon_oracle",
    "max_steps",
    "project_horizon",
]

#: Default projection: 16 steps of one hour — a working day of warning
#: with the evening still ahead.
DEFAULT_STEPS = 16
DEFAULT_STEP_S = 3600.0


def max_steps() -> int:
    """Upper bound on horizon steps per projection (the [H·S] grid is
    one dispatch — H·S rows of device memory).  Overridable via
    ``KCCAP_FORECAST_MAX_STEPS`` for deliberate long-range studies."""
    try:
        return max(int(os.environ.get("KCCAP_FORECAST_MAX_STEPS", 512)), 1)
    except ValueError:
        return 512


def _growth_factors(rate_per_s: float, steps: int, step_s: float) -> np.ndarray:
    """``[H]`` float64 multiplicative factors, ``g_0 = 1`` exactly."""
    h = np.arange(steps, dtype=np.float64)
    return np.maximum(1.0 + float(rate_per_s) * h * float(step_s), 0.0)


def _scale_samples(samples: np.ndarray, factors: np.ndarray) -> np.ndarray:
    """Apply the documented scaling rule: ``[S]`` int64 × ``[H]``
    factors → ``[H, S]`` int64 (float64 multiply, rint, clamp to the
    sampler domain ``[1, MAX_USAGE]``)."""
    scaled = np.rint(
        samples.astype(np.float64)[None, :] * factors[:, None]
    )
    return np.clip(scaled, 1.0, float(MAX_USAGE)).astype(np.int64)


@dataclass
class HorizonResult:
    """One forward projection (numpy arrays throughout).

    ``totals`` is the ``[H, S]`` per-step per-sample capacity;
    ``quantiles`` maps confidence → ``[H]`` int64 capacity ladder;
    ``time_to_breach_s`` maps confidence → seconds until that quantile
    capacity first drops below ``threshold`` (``None``: never within
    the horizon).
    """

    spec: StochasticSpec
    mode: str
    steps: int
    step_s: float
    n_samples: int
    threshold: int
    growth_cpu_per_s: float
    growth_mem_per_s: float
    totals: np.ndarray  # [H, S] int64
    quantiles: dict[float, np.ndarray]  # q -> [H] int64
    time_to_breach_s: dict[float, float | None]
    degraded_time_axis: bool = False
    eval_ms: float = 0.0
    trend: dict = field(default_factory=dict)

    @property
    def horizon_s(self) -> float:
        return (self.steps - 1) * self.step_s

    def min_capacity(self, q: float) -> int:
        """The worst projected capacity at confidence ``q`` anywhere in
        the horizon — what a breach-within-horizon alert keys on."""
        return int(self.quantiles[q].min())

    def breached_within_horizon(self, q: float) -> bool:
        return self.time_to_breach_s[q] is not None

    def to_wire(self) -> dict:
        return {
            "mode": self.mode,
            "samples": self.n_samples,
            "seed": self.spec.seed,
            "replicas": self.spec.replicas,
            "threshold": self.threshold,
            "steps": self.steps,
            "step_s": self.step_s,
            "horizon_s": self.horizon_s,
            "growth": {
                "cpu_per_s": float(self.growth_cpu_per_s),
                "memory_per_s": float(self.growth_mem_per_s),
            },
            "degraded_time_axis": self.degraded_time_axis,
            "quantiles": {
                quantile_label(q): [int(v) for v in ladder]
                for q, ladder in sorted(self.quantiles.items())
            },
            "now": {
                quantile_label(q): int(ladder[0])
                for q, ladder in sorted(self.quantiles.items())
            },
            "time_to_breach_s": {
                quantile_label(q): (
                    None if ttb is None else round(float(ttb), 3)
                )
                for q, ttb in sorted(self.time_to_breach_s.items())
            },
            "breached_within_horizon": sorted(
                quantile_label(q)
                for q, ttb in self.time_to_breach_s.items()
                if ttb is not None
            ),
            **({"trend": self.trend} if self.trend else {}),
        }


def _validate_projection(steps: int, step_s: float) -> None:
    if isinstance(steps, bool) or not isinstance(steps, int) or steps < 1:
        raise ValueError(f"steps must be a positive int, got {steps!r}")
    cap = max_steps()
    if steps > cap:
        raise ValueError(
            f"steps={steps} exceeds the horizon cap {cap} "
            "(KCCAP_FORECAST_MAX_STEPS)"
        )
    if not isinstance(step_s, (int, float)) or isinstance(step_s, bool) or (
        not float(step_s) > 0.0
    ):
        raise ValueError(f"step_s must be > 0 seconds, got {step_s!r}")


def _reduce_ladders(
    totals: np.ndarray,
    quantiles: tuple[float, ...],
    threshold: int,
    step_s: float,
) -> tuple[dict[float, np.ndarray], dict[float, float | None]]:
    """Per-step order-statistic reduction + first-breach search.

    ``totals`` is ``[H, S]``; per step the samples sort ascending and
    each quantile picks its documented index.  Shared verbatim by the
    dispatch path and the oracle ON PURPOSE: the reduction is exact
    integer selection (nothing to diverge), while the sweeps it reduces
    are the independently-implemented halves under test.
    """
    h, s = totals.shape
    sorted_totals = np.sort(totals, axis=1)
    ladders: dict[float, np.ndarray] = {}
    ttb: dict[float, float | None] = {}
    for q in quantiles:
        ladder = sorted_totals[:, quantile_index(s, q)].astype(np.int64)
        ladders[q] = ladder
        below = np.flatnonzero(ladder < int(threshold))
        ttb[q] = float(below[0] * step_s) if below.size else None
    return ladders, ttb


def project_horizon(
    snapshot: ClusterSnapshot,
    spec: StochasticSpec,
    *,
    steps: int = DEFAULT_STEPS,
    step_s: float = DEFAULT_STEP_S,
    growth_cpu_per_s: float = 0.0,
    growth_mem_per_s: float = 0.0,
    mode: str | None = None,
    node_mask=None,
    quantiles: tuple[float, ...] = DEFAULT_QUANTILES,
    threshold: int | None = None,
    degraded_time_axis: bool = False,
    device="cuda",
) -> HorizonResult:
    """Project capacity quantiles ``steps`` steps forward.

    Draws the spec's ``S`` usage samples once (explicit seed, streams 0
    and 1 exactly like capacity-at-risk), scales them per step by the
    relative growth rates, and evaluates the whole ``[H, S]`` grid as
    ONE production sweep dispatch.  ``threshold`` defaults to the
    spec's requested replicas — "when does the q-quantile stop fitting
    what we asked for".
    """
    mode = mode or snapshot.semantics
    _validate_projection(steps, step_s)
    threshold = int(spec.replicas if threshold is None else threshold)
    n = spec.n_samples()
    t0 = time.perf_counter()
    cpu = sample_usage(spec.cpu, n, sample_key(spec.seed, 0), device=device)
    mem = sample_usage(spec.memory, n, sample_key(spec.seed, 1), device=device)
    cpu_grid = _scale_samples(cpu, _growth_factors(growth_cpu_per_s, steps, step_s))
    mem_grid = _scale_samples(mem, _growth_factors(growth_mem_per_s, steps, step_s))
    grid = ScenarioGrid(
        cpu_request_milli=cpu_grid.reshape(-1),
        mem_request_bytes=mem_grid.reshape(-1),
        replicas=np.full(steps * n, int(spec.replicas), dtype=np.int64),
    )
    totals = np.asarray(
        sweep_snapshot(
            snapshot, grid, mode=mode, node_mask=node_mask, device=device
        )[0],
        dtype=np.int64,
    ).reshape(steps, n)
    ladders, ttb = _reduce_ladders(totals, quantiles, threshold, step_s)
    return HorizonResult(
        spec=spec,
        mode=mode,
        steps=steps,
        step_s=float(step_s),
        n_samples=n,
        threshold=threshold,
        growth_cpu_per_s=float(growth_cpu_per_s),
        growth_mem_per_s=float(growth_mem_per_s),
        totals=totals,
        quantiles=ladders,
        time_to_breach_s=ttb,
        degraded_time_axis=degraded_time_axis,
        eval_ms=(time.perf_counter() - t0) * 1e3,
    )


def horizon_oracle(
    snapshot: ClusterSnapshot,
    spec: StochasticSpec,
    *,
    steps: int = DEFAULT_STEPS,
    step_s: float = DEFAULT_STEP_S,
    growth_cpu_per_s: float = 0.0,
    growth_mem_per_s: float = 0.0,
    mode: str | None = None,
    node_mask=None,
    quantiles: tuple[float, ...] = DEFAULT_QUANTILES,
    threshold: int | None = None,
) -> HorizonResult:
    """The pure-numpy seed-replay oracle: identical draws from the
    identical seed, the documented scaling rule re-applied, and every
    step's totals computed by :func:`~..stochastic.car.
    fit_totals_numpy` (ungrouped, plain numpy) — so
    ``forecast_parity_diffs == 0`` pins the one-dispatch path at any
    scale the kernels serve."""
    mode = mode or snapshot.semantics
    _validate_projection(steps, step_s)
    threshold = int(spec.replicas if threshold is None else threshold)
    n = spec.n_samples()
    cpu = sample_usage(spec.cpu, n, sample_key(spec.seed, 0), device="cpu")
    mem = sample_usage(spec.memory, n, sample_key(spec.seed, 1), device="cpu")
    totals = np.empty((steps, n), dtype=np.int64)
    for h in range(steps):
        g_cpu = max(1.0 + float(growth_cpu_per_s) * h * float(step_s), 0.0)
        g_mem = max(1.0 + float(growth_mem_per_s) * h * float(step_s), 0.0)
        cpu_h = np.clip(
            np.rint(cpu.astype(np.float64) * g_cpu), 1.0, float(MAX_USAGE)
        ).astype(np.int64)
        mem_h = np.clip(
            np.rint(mem.astype(np.float64) * g_mem), 1.0, float(MAX_USAGE)
        ).astype(np.int64)
        totals[h] = fit_totals_numpy(
            snapshot.alloc_cpu_milli,
            snapshot.alloc_mem_bytes,
            snapshot.alloc_pods,
            snapshot.used_cpu_req_milli,
            snapshot.used_mem_req_bytes,
            snapshot.pods_count,
            snapshot.healthy,
            cpu_h,
            mem_h,
            mode=mode,
            node_mask=node_mask,
        )
    ladders, ttb = _reduce_ladders(totals, quantiles, threshold, step_s)
    return HorizonResult(
        spec=spec,
        mode=mode,
        steps=steps,
        step_s=float(step_s),
        n_samples=n,
        threshold=threshold,
        growth_cpu_per_s=float(growth_cpu_per_s),
        growth_mem_per_s=float(growth_mem_per_s),
        totals=totals,
        quantiles=ladders,
        time_to_breach_s=ttb,
    )
