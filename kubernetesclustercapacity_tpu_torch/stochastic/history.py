"""Empirical usage from the audit log (counterpart of
``kubernetesclustercapacity_tpu/stochastic/history.py``, verbatim).

The audit log records every published snapshot generation as a
digest-chained checkpoint/diff stream.  Each reconstructed generation
carries per-node ``used_*`` totals and ``pods_count`` — so the observed
**per-pod** usage of a generation is ``used / pods`` per node, weighted
by how many pods produced it.  This module walks that history (through
:class:`~..audit.log.AuditReader`, digest-verifying every
reconstruction) and folds the observations into an empirical
:class:`~.distributions.UsageDistribution`, making capacity-at-risk
forecasts a *derived view of replayable history*: the same audit
directory always yields the same distribution, and ``kccap -replay``
can prove the inputs.

Robustness contract (the satellite): a directory with no segments, a
segment holding only a torn tail, or generations with zero usage
observations yields a typed :class:`InsufficientHistoryError` carrying
what WAS found — never an empty-array crash, and never a silent point
fallback that would quietly collapse every quantile to the plain fit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from kubernetesclustercapacity_tpu_torch.audit.log import AuditError, AuditReader
from kubernetesclustercapacity_tpu_torch.stochastic.distributions import (
    MAX_USAGE,
    UsageDistribution,
)

__all__ = [
    "InsufficientHistoryError",
    "SeriesHistory",
    "UsageHistory",
    "extract_series",
    "extract_usage_history",
]

_RESOURCES = ("cpu", "memory")

#: Series kinds :func:`extract_series` can walk out of the audit log:
#: ``usage`` is the demand side (cluster-wide requested totals), and
#: ``allocatable`` the supply side (what the fleet could hold) — a trend
#: fit needs both, because "when do we run out" is a question about the
#: gap, not either line alone.
_SERIES_KINDS = ("usage", "allocatable")

_SERIES_FIELDS = {
    ("cpu", "usage"): "used_cpu_req_milli",
    ("memory", "usage"): "used_mem_req_bytes",
    ("cpu", "allocatable"): "alloc_cpu_milli",
    ("memory", "allocatable"): "alloc_mem_bytes",
    ("pods", "usage"): "pods_count",
    ("pods", "allocatable"): "alloc_pods",
}


class InsufficientHistoryError(RuntimeError):
    """The audit history holds too little observed usage to build a
    distribution.  Typed so callers can branch on it (fall back to an
    explicit operator-provided distribution — never silently to a
    point); carries what the walk DID find."""

    def __init__(
        self, reason: str, *, generations: int = 0, observations: int = 0
    ) -> None:
        super().__init__(
            f"insufficient usage history: {reason} "
            f"(generations={generations}, observations={observations})"
        )
        self.reason = reason
        self.generations = generations
        self.observations = observations


@dataclass(frozen=True)
class UsageHistory:
    """Aggregated per-pod usage observations for one resource.

    ``values``/``weights`` are the distinct observed per-pod usage
    values and their pod-weighted multiplicities; ``observations`` is
    the total pod-weight, ``generations`` how many audit generations
    contributed.
    """

    resource: str
    values: np.ndarray  # [K] int64, ascending
    weights: np.ndarray  # [K] float64, > 0
    observations: int
    generations: int

    def distribution(self) -> UsageDistribution:
        """The empirical distribution the sampler consumes."""
        return UsageDistribution(
            kind="empirical",
            values=tuple(int(v) for v in self.values),
            weights=tuple(float(w) for w in self.weights),
        )

    def to_wire(self) -> dict:
        return {
            "resource": self.resource,
            "distinct_values": int(self.values.shape[0]),
            "observations": self.observations,
            "generations": self.generations,
        }


def _load_reader(source) -> AuditReader:
    if isinstance(source, AuditReader):
        return source
    try:
        return AuditReader.load(source)
    except AuditError as e:
        # No segments at all (empty/missing dir) IS an insufficient-
        # history outcome for a forecaster; mid-file corruption stays a
        # hard AuditError — a damaged log is an incident, not a lack of
        # data.
        if "no audit segments" in str(e) or "cannot read audit dir" in str(e):
            raise InsufficientHistoryError(str(e)) from e
        raise


def extract_usage_history(
    source,
    resource: str = "cpu",
    *,
    min_observations: int = 8,
) -> UsageHistory:
    """Walk an audit log (directory path or loaded
    :class:`~..audit.log.AuditReader`) into a :class:`UsageHistory`.

    Every recorded generation reconstructs through the digest-verified
    replay path; per node with ``pods_count > 0`` the observation is
    ``used // pods`` (one per pod, so a 40-pod node weighs 40× a 1-pod
    node).  Wrapped/degenerate carriers (negative usage, zero per-pod
    values) are excluded — they are codec artifacts, not usage.
    Raises :class:`InsufficientHistoryError` when fewer than
    ``min_observations`` pod-observations survive.
    """
    if resource not in _RESOURCES:
        raise ValueError(
            f"resource must be one of {_RESOURCES}, got {resource!r}"
        )
    reader = _load_reader(source)
    gens = reader.generations()
    if not gens:
        raise InsufficientHistoryError(
            "the audit log holds no generation records "
            "(segments empty or only a torn tail)",
        )
    used_field = (
        "used_cpu_req_milli" if resource == "cpu" else "used_mem_req_bytes"
    )
    tally: dict[int, float] = {}
    observations = 0
    contributing = 0
    for rec in gens:
        snap = reader.snapshot_at(rec["generation"])
        used = np.asarray(getattr(snap, used_field), dtype=np.int64)
        pods = np.asarray(snap.pods_count, dtype=np.int64)
        ok = (pods > 0) & (used > 0)
        if not ok.any():
            continue
        per_pod = used[ok] // pods[ok]
        weight = pods[ok]
        keep = (per_pod >= 1) & (per_pod <= MAX_USAGE)
        if not keep.any():
            continue
        contributing += 1
        for v, w in zip(per_pod[keep], weight[keep]):
            tally[int(v)] = tally.get(int(v), 0.0) + float(w)
            observations += int(w)
    if observations < max(min_observations, 1):
        raise InsufficientHistoryError(
            f"only {observations} pod-usage observation(s) across "
            f"{len(gens)} generation(s); need >= {min_observations}",
            generations=len(gens),
            observations=observations,
        )
    values = np.array(sorted(tally), dtype=np.int64)
    weights = np.array([tally[int(v)] for v in values], dtype=np.float64)
    return UsageHistory(
        resource=resource,
        values=values,
        weights=weights,
        observations=observations,
        generations=contributing,
    )


@dataclass(frozen=True)
class SeriesHistory:
    """A per-generation cluster-wide total as a time series.

    ``ts`` is the time axis in seconds (the generation records' own
    wall-clock stamps — never re-sampled at load time, so the same audit
    directory always yields the same series); ``totals`` the cluster-wide
    sum of the selected column per generation, as float64 (sums of int64
    columns can exceed the int64 range on wrapped carriers — the trend
    fit is statistical, not bit-exact arithmetic).

    ``degraded_time_axis`` is True when the recorded timestamps were
    unusable (non-monotone, missing, or zero-span): the series falls
    back to RECORD ORDER (``ts = 0, 1, 2, ...``) rather than crashing or
    silently mis-ordering — a trend fitted on a degraded axis is still a
    trend per *generation*, just not per second, and every downstream
    surface carries the flag.
    """

    resource: str
    kind: str
    ts: np.ndarray  # [T] float64 seconds
    totals: np.ndarray  # [T] float64 cluster-wide totals
    generations: np.ndarray  # [T] int64 generation numbers
    degraded_time_axis: bool

    def to_wire(self) -> dict:
        return {
            "resource": self.resource,
            "kind": self.kind,
            "points": int(self.ts.shape[0]),
            "span_s": float(self.ts[-1] - self.ts[0])
            if self.ts.shape[0]
            else 0.0,
            "degraded_time_axis": self.degraded_time_axis,
        }


def extract_series(
    source,
    resource: str = "cpu",
    kind: str = "usage",
    *,
    min_points: int = 2,
) -> SeriesHistory:
    """Walk an audit log into a per-generation total time series.

    ``resource`` is ``cpu``/``memory``/``pods``; ``kind`` selects the
    demand column (``usage``: the ``used_*`` requested totals) or the
    supply column (``allocatable``).  Every generation reconstructs
    through the digest-verified replay path; totals are summed with
    Python ints (no int64 overflow on wrapped carriers) and returned as
    float64.

    Timestamps are verified monotone non-decreasing with a positive
    span; otherwise the series degrades to record order with
    ``degraded_time_axis=True`` (see :class:`SeriesHistory`).  Raises
    :class:`InsufficientHistoryError` with what WAS found when fewer
    than ``min_points`` generations exist.
    """
    field_name = _SERIES_FIELDS.get((resource, kind))
    if field_name is None:
        raise ValueError(
            f"unknown series ({resource!r}, {kind!r}); resource must be "
            "cpu/memory/pods and kind one of "
            f"{_SERIES_KINDS}"
        )
    reader = _load_reader(source)
    gens = reader.generations()
    if len(gens) < max(min_points, 1):
        raise InsufficientHistoryError(
            f"only {len(gens)} generation record(s); a series needs "
            f">= {min_points}",
            generations=len(gens),
        )
    ts: list[float] = []
    totals: list[float] = []
    numbers: list[int] = []
    for rec in gens:
        snap = reader.snapshot_at(rec["generation"])
        col = np.asarray(getattr(snap, field_name), dtype=np.int64)
        totals.append(float(sum(int(v) for v in col)))
        raw_ts = rec.get("ts")
        ts.append(float(raw_ts) if isinstance(raw_ts, (int, float)) else -1.0)
        numbers.append(int(rec["generation"]))
    axis = np.asarray(ts, dtype=np.float64)
    degraded = bool(
        np.any(axis < 0)
        or np.any(np.diff(axis) < 0)
        or axis[-1] <= axis[0]
    )
    if degraded:
        axis = np.arange(len(ts), dtype=np.float64)
    return SeriesHistory(
        resource=resource,
        kind=kind,
        ts=axis,
        totals=np.asarray(totals, dtype=np.float64),
        generations=np.asarray(numbers, dtype=np.int64),
        degraded_time_axis=degraded,
    )
