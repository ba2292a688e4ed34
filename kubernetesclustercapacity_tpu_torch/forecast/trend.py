"""Robust demand/supply trends (counterpart of
``kubernetesclustercapacity_tpu/forecast/trend.py``, verbatim: host numpy).

A capacity forecast starts with a trend, and a trend fitted by least
squares on operational telemetry is a footgun — one garbage-collected
node or one batch job spikes the slope and the pager.  This module fits
**Theil–Sen** instead: the slope is the median of all pairwise slopes,
the intercept the median of the slope-adjusted values, and the spread a
median absolute deviation — every statistic an order statistic, so the
fit has a 29% breakdown point AND is exactly reproducible (no float
accumulation order dependence beyond the pairwise quotients themselves,
which are computed identically everywhere).

Determinism contract: timestamps come from the records (the audit log's
generation stamps, or the timeline ring's observation stamps) — never
from the wall clock at fit time, and nothing here runs on a device.  The
same series always yields the same fit, and a fit recorded in the audit
log re-answers identically on replay.

:func:`fit_trend` is the production fit (vectorized numpy);
:func:`trend_oracle` re-derives the identical statistics with scalar
Python loops + :mod:`statistics` medians — the independent comparator
the randomized property tests pin every fit against.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from kubernetesclustercapacity_tpu_torch.stochastic.history import (
    InsufficientHistoryError,
    SeriesHistory,
    extract_series,
)

__all__ = [
    "TrendFit",
    "fit_trend",
    "trend_from_audit",
    "trend_oracle",
]

#: Pairwise-slope fitting is O(T^2); the audit log can hold far more
#: generations than a trend needs.  Series longer than this keep their
#: most recent _MAX_FIT_POINTS points (the recent past predicts the
#: near future; ancient history only dilutes the breakdown point).
_MAX_FIT_POINTS = 2048


@dataclass(frozen=True)
class TrendFit:
    """One robust linear fit ``y ≈ intercept + slope·(t - t0)``.

    ``slope_per_s`` is in series units per second (per record when the
    time axis is degraded), ``intercept`` the fitted value at ``t0``
    (the series' first timestamp), ``mad`` the median absolute residual
    (the fit's spread), and ``level`` the fitted value at the LAST
    timestamp — the trend's "now", which is what forward projection
    grows from.
    """

    slope_per_s: float
    intercept: float
    mad: float
    n: int
    t0: float
    span_s: float
    degraded_time_axis: bool = False

    @property
    def level(self) -> float:
        """The fitted value at the newest observation."""
        return self.intercept + self.slope_per_s * self.span_s

    @property
    def relative_slope_per_s(self) -> float:
        """Growth per second as a fraction of the current level — the
        multiplier the horizon projection applies to usage samples.
        Zero when the trend's level is non-positive (a series that fits
        to nothing has no meaningful relative growth)."""
        lvl = self.level
        if lvl <= 0.0:
            return 0.0
        return self.slope_per_s / lvl

    def value_at(self, t_s: float) -> float:
        """The fitted value ``t_s`` seconds after ``t0``."""
        return self.intercept + self.slope_per_s * t_s

    def to_wire(self) -> dict:
        return {
            "slope_per_s": float(self.slope_per_s),
            "intercept": float(self.intercept),
            "level": float(self.level),
            "mad": float(self.mad),
            "points": self.n,
            "span_s": float(self.span_s),
            "degraded_time_axis": self.degraded_time_axis,
        }


def _validated_series(ts, ys) -> tuple[np.ndarray, np.ndarray]:
    t = np.asarray(ts, dtype=np.float64)
    y = np.asarray(ys, dtype=np.float64)
    if t.ndim != 1 or y.ndim != 1 or t.shape[0] != y.shape[0]:
        raise ValueError(
            f"ts and ys must be equal-length 1-D series, got "
            f"{t.shape} vs {y.shape}"
        )
    if t.shape[0] > _MAX_FIT_POINTS:
        t = t[-_MAX_FIT_POINTS:]
        y = y[-_MAX_FIT_POINTS:]
    if t.shape[0] < 2:
        raise InsufficientHistoryError(
            f"a trend fit needs >= 2 observations, got {t.shape[0]}",
            observations=int(t.shape[0]),
        )
    if np.any(np.diff(t) < 0):
        raise ValueError("trend timestamps must be non-decreasing")
    if t[-1] <= t[0]:
        raise InsufficientHistoryError(
            "trend timestamps span zero seconds "
            "(every observation is simultaneous)",
            observations=int(t.shape[0]),
        )
    return t, y


def fit_trend(
    ts, ys, *, degraded_time_axis: bool = False
) -> TrendFit:
    """Theil–Sen fit of one series (vectorized numpy).

    ``ts``/``ys`` are equal-length 1-D arrays; timestamps must be
    non-decreasing with positive span (the series loaders guarantee
    both, degrading to record order when the recorded stamps cannot).
    Pairs with equal timestamps contribute no slope (their quotient is
    undefined, not infinite).  Raises
    :class:`~..stochastic.history.InsufficientHistoryError` on fewer
    than two observations or a zero-span axis.
    """
    t, y = _validated_series(ts, ys)
    n = int(t.shape[0])
    i, j = np.triu_indices(n, k=1)
    dt = t[j] - t[i]
    keep = dt > 0
    slopes = (y[j][keep] - y[i][keep]) / dt[keep]
    slope = float(np.median(slopes))
    t0 = float(t[0])
    intercept = float(np.median(y - slope * (t - t0)))
    residuals = y - (intercept + slope * (t - t0))
    mad = float(np.median(np.abs(residuals)))
    return TrendFit(
        slope_per_s=slope,
        intercept=intercept,
        mad=mad,
        n=n,
        t0=t0,
        span_s=float(t[-1] - t0),
        degraded_time_axis=degraded_time_axis,
    )


def trend_oracle(
    ts, ys, *, degraded_time_axis: bool = False
) -> TrendFit:
    """The independent comparator: the same statistics derived with
    scalar Python loops and :func:`statistics.median` — no shared
    vectorized code with :func:`fit_trend`, so agreement pins the
    production fit, not a common bug."""
    import statistics

    t, y = _validated_series(ts, ys)
    n = int(t.shape[0])
    slopes = []
    for a in range(n):
        for b in range(a + 1, n):
            dt = float(t[b]) - float(t[a])
            if dt > 0:
                slopes.append((float(y[b]) - float(y[a])) / dt)
    slope = statistics.median(slopes)
    t0 = float(t[0])
    intercept = statistics.median(
        float(y[k]) - slope * (float(t[k]) - t0) for k in range(n)
    )
    mad = statistics.median(
        abs(float(y[k]) - (intercept + slope * (float(t[k]) - t0)))
        for k in range(n)
    )
    return TrendFit(
        slope_per_s=slope,
        intercept=intercept,
        mad=mad,
        n=n,
        t0=t0,
        span_s=float(t[-1]) - t0,
        degraded_time_axis=degraded_time_axis,
    )


def trend_from_audit(
    source,
    resource: str = "cpu",
    kind: str = "usage",
    *,
    min_points: int = 3,
) -> tuple[TrendFit, SeriesHistory]:
    """Fit a trend straight off an audit log: walk the digest-verified
    generations into a :class:`~..stochastic.history.SeriesHistory`
    (demand or supply, see ``kind``) and Theil–Sen fit it.  Returns the
    fit alongside the series it was fitted on, so callers can report
    provenance ("fitted over N generations spanning S seconds")."""
    series = extract_series(
        source, resource, kind, min_points=min_points
    )
    fit = fit_trend(
        series.ts,
        series.totals,
        degraded_time_axis=series.degraded_time_axis,
    )
    return fit, series
