"""The capacity timeline: a bounded ring of per-generation records.

Counterpart of ``kubernetesclustercapacity_tpu/timeline/history.py``.  The
records, deltas, alerts, gauges and log lines are the JAX package's; every
watch evaluation runs the port's exact programs on the timeline's
``device`` (the card by default).

:class:`CapacityTimeline` is fed one call per snapshot publish —
``observe(snapshot, generation)`` — by the server's swap paths, which
for a live ``-follow`` deployment means the COALESCER'S worker thread
(the same off-request-path thread that pre-warms the device cache, so a
watchlist evaluation rides a warm cache and never adds latency to a
dispatched query).  Each observation captures:

* the snapshot digest and per-node summary (:mod:`.diff`'s vocabulary);
* the evaluated capacity of every watchlist scenario, through
  :func:`~..explain.explain_snapshot` — whose fit column is pinned
  bit-identical to :func:`~..ops.fit.fit_per_node`, so a timeline
  capacity IS a cold ``fit`` of that generation — plus the binding
  histogram the drift attribution consumes;
* alert transitions (:mod:`.alerts`), appended to the ``-timeline-log``
  JSONL alongside one line per generation.

``deltas()`` joins consecutive records into attributed transitions: the
node-set diff, per-watch capacity movement, the binding-constraint shift
(:func:`~..explain.binding_shift`), and the per-node fit contributions
that say WHICH nodes moved the total.

Telemetry honors the process switch exactly like every other layer:
with ``KCCAP_TELEMETRY=0`` (or no registry) an observation makes zero
registry calls.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from kubernetesclustercapacity_tpu_torch.scenario import ScenarioGrid
from kubernetesclustercapacity_tpu_torch.snapshot import ClusterSnapshot
from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
    enabled as _telemetry_enabled,
)
from kubernetesclustercapacity_tpu_torch.timeline.alerts import WatchAlert
from kubernetesclustercapacity_tpu_torch.timeline.diff import (
    diff_summaries,
    node_summary,
    shape_key,
    snapshot_digest,
)
from kubernetesclustercapacity_tpu_torch.timeline.watchlist import WatchSpec

__all__ = ["CapacityTimeline", "GenerationRecord", "WatchResult"]

#: Per-watch node contributions reported per delta (the full diff rides
#: alongside; the contributor list is the "which nodes moved it" headline
#: and stays readable at 10k-node scale).
_MAX_CONTRIBUTORS = 8


def _shift_phrase(shift: dict[str, int]) -> str:
    """Human rendering of a binding shift.  The common drift — nodes
    moving from one binding constraint to exactly one other — reads as
    ``memory→pods on 12 nodes``; anything messier falls back to signed
    per-constraint counts."""
    losers = {k: -v for k, v in shift.items() if v < 0}
    gainers = {k: v for k, v in shift.items() if v > 0}
    if len(losers) == 1 and len(gainers) == 1:
        (src, n_src), (dst, n_dst) = losers.popitem(), gainers.popitem()
        if n_src == n_dst:
            return f"binding constraint shifted {src}→{dst} on {n_src} node(s)"
    parts = ", ".join(f"{k}{v:+d}" for k, v in sorted(shift.items()))
    return f"binding counts moved: {parts}"


def _delta_summary(
    name: str, before: int, after: int, diff, shift, contributions,
    shape_joins: dict[str, str] | None = None,
) -> str:
    """The one-line attribution an operator reads first, e.g.
    ``capacity 41→37: node pool-b-7 removed (-4); binding constraint
    shifted memory→pods on 12 node(s)``.

    ``shape_joins`` maps added node keys to the :func:`..diff.shape_key`
    of an EXISTING shape group they joined — those render as
    ``(+1 shape <key>)`` drift lines even when the node's capacity
    contribution is zero, so a replica landing in an existing group is
    never a silent no-op.
    """
    head = f"{name}: capacity {before}→{after}"
    if before == after and diff.empty:
        return head + " (no change)"
    shape_joins = shape_joins or {}
    clauses: list[str] = []
    seen_added: set[str] = set()
    kind_verb = {"added": "added", "removed": "removed", "mutated": "changed"}
    for key, c, kind in contributions[:3]:
        sk = shape_joins.get(key) if kind == "added" else None
        if sk is not None:
            seen_added.add(key)
            clauses.append(
                f"node {key or '<phantom>'} added ({c:+d}, +1 shape {sk})"
            )
        else:
            clauses.append(
                f"node {key or '<phantom>'} {kind_verb[kind]} ({c:+d})"
            )
    extra = len(contributions) - 3
    if extra > 0:
        clauses.append(f"{extra} more node(s)")
    # Shape joins whose capacity contribution was zero still drift the
    # group census — name them (bounded, like the contributor list).
    silent = [k for k in shape_joins if k not in seen_added][:3]
    for key in silent:
        clauses.append(
            f"node {key or '<phantom>'} added (+1 shape {shape_joins[key]})"
        )
    if shift:
        clauses.append(_shift_phrase(shift))
    if not clauses:
        clauses.append(
            f"{len(diff.added)} node(s) added, "
            f"{len(diff.removed)} removed, {len(diff.changed)} changed"
        )
    return head + ": " + "; ".join(clauses)


@dataclass
class WatchResult:
    """One watch evaluated against one generation.

    For a capacity-at-risk watch (``quantile`` set) ``total`` is the
    Monte Carlo capacity quantile — the fit of the quantile-realizing
    usage sample, so ``fits``/``binding_counts`` stay node-granular and
    the delta attribution works unchanged; ``prob_fit`` is the fraction
    of samples that fit the spec's replicas.
    """

    name: str
    mode: str
    total: int
    schedulable: bool
    breached: bool
    min_replicas: int | None
    binding_counts: dict[str, int]
    fits: np.ndarray  # [N] per-node, aligned with the record's node keys
    quantile: float | None = None
    prob_fit: float | None = None
    samples: int = 0
    car_eval_ms: float = 0.0
    #: Gang watch fields (``gang_ranks > 0`` marks one): ``total`` is
    #: then WHOLE GANGS, ``gang_binding`` the binding topology level.
    gang_ranks: int = 0
    gang_count: int = 0
    gang_binding: str | None = None
    gang_summary: str = ""
    #: Forecast watch fields (``horizon_s`` non-None marks one):
    #: ``total`` stays the NOW (h=0) quantile capacity, while
    #: ``horizon_min_capacity`` is the minimum projected capacity
    #: across the horizon (what the alert machine thresholds) and
    #: ``time_to_breach_s`` the projected seconds until the quantile
    #: first crosses the threshold — ``None`` when the trend is flat
    #: or the ring's history is insufficient to fit one.
    horizon_s: float | None = None
    time_to_breach_s: float | None = None
    horizon_min_capacity: int | None = None
    degraded_time_axis: bool = False

    def to_wire(self) -> dict:
        out = {
            "total": self.total,
            "schedulable": self.schedulable,
            "breached": self.breached,
            "mode": self.mode,
            "min_replicas": self.min_replicas,
            "binding_counts": dict(self.binding_counts),
        }
        if self.quantile is not None:
            out["quantile"] = self.quantile
            out["prob_fit"] = self.prob_fit
            out["samples"] = self.samples
        if self.gang_ranks:
            out["gang"] = {
                "ranks": self.gang_ranks,
                "count": self.gang_count,
                "binding": self.gang_binding,
                "summary": self.gang_summary,
            }
        if self.horizon_s is not None:
            out["horizon_s"] = self.horizon_s
            out["time_to_breach_s"] = self.time_to_breach_s
            out["horizon_min_capacity"] = self.horizon_min_capacity
            out["degraded_time_axis"] = self.degraded_time_axis
        return out


@dataclass
class GenerationRecord:
    """Everything the timeline remembers about one published generation."""

    generation: int
    ts: float
    digest: str
    semantics: str
    n_nodes: int
    healthy_nodes: int
    summary: dict[str, tuple[int, ...]]
    watches: dict[str, WatchResult] = field(default_factory=dict)
    eval_ms: float = 0.0

    @property
    def keys(self) -> list[str]:
        """Node keys in snapshot row order (summary insertion order)."""
        return list(self.summary)

    def to_wire(self, watch: str | None = None) -> dict:
        """JSON-able record (no per-node payloads — those feed ``deltas``)."""
        return {
            "generation": self.generation,
            "ts": self.ts,
            "digest": self.digest,
            "semantics": self.semantics,
            "nodes": self.n_nodes,
            "healthy_nodes": self.healthy_nodes,
            "eval_ms": round(self.eval_ms, 3),
            "watches": {
                name: r.to_wire()
                for name, r in self.watches.items()
                if watch is None or name == watch
            },
        }


class CapacityTimeline:
    """Thread-safe bounded capacity history + watchlist alerting.

    ``observe`` is serialized by an internal lock (snapshot publishes are
    already serialized upstream; the lock makes direct embedding safe
    too) and never raises into its caller's publish path by CONTRACT of
    the caller — the server wraps it best-effort, same as every other
    observability hook.

    ``registry`` wires the ``kccap_generation`` / ``kccap_watch_*``
    metric families; ``None`` (or ``KCCAP_TELEMETRY=0`` at construction)
    keeps the timeline registry-silent.  ``log`` is an optional JSONL
    appender — a path or a :class:`~..telemetry.tracing.TraceLog` — that
    receives one line per observed generation and one per alert
    transition (the flight-recorder-style durable record).  ``device``
    (default ``"cuda"``) is where every watch evaluation runs; a failed
    launch there raises out of :meth:`observe`.
    """

    def __init__(
        self,
        watches: tuple[WatchSpec, ...] = (),
        *,
        depth: int = 64,
        registry=None,
        log=None,
        device="cuda",
    ) -> None:
        from kubernetesclustercapacity_tpu_torch.devcache import resolve_device
        from kubernetesclustercapacity_tpu_torch.telemetry.tracing import TraceLog

        if depth < 2:
            # One record cannot diff against anything; the whole point
            # of a timeline is the transition.
            raise ValueError(f"timeline depth must be >= 2, got {depth}")
        names = [w.name for w in watches]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate watch names: {names}")
        self.watches: tuple[WatchSpec, ...] = tuple(watches)
        self.depth = int(depth)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._ring: deque[GenerationRecord] = deque(maxlen=self.depth)
        self._alerts = {
            w.name: WatchAlert(w.name, w.min_replicas) for w in self.watches
        }
        #: Names of the forecast (horizon) watches — quantile watches
        #: that project forward; they report under the
        #: ``kccap_forecast_*`` family, NOT the CaR one (each watch
        #: belongs to exactly one alert funnel).
        self._horizon_names = frozenset(
            w.name for w in self.watches if w.horizon_steps is not None
        )
        #: Names of the capacity-at-risk (quantile) watches — the slice
        #: whose breaches additionally flip ``/healthz`` and the
        #: ``kccap_car_*`` gauges.
        self._car_names = (
            frozenset(
                w.name for w in self.watches if w.quantile is not None
            )
            - self._horizon_names
        )
        #: Names of the gang watches — the slice whose breaches (like
        #: the CaR slice's) flip ``/healthz`` and the ``kccap_gang_*``
        #: gauges: a breached gang watch says "fewer than N whole
        #: gangs fit", which a training-job admission plane must see.
        self._gang_names = frozenset(
            w.name for w in self.watches if w.gang is not None
        )
        self._log = TraceLog(log) if isinstance(log, str) else log
        self._m = None
        if registry is not None and _telemetry_enabled():
            self._m = {
                "generation": registry.gauge(
                    "kccap_generation",
                    "Served snapshot generation last observed.",
                ),
                "records": registry.gauge(
                    "kccap_timeline_records",
                    "Generation records currently held in the timeline.",
                ),
                "replicas": registry.gauge(
                    "kccap_watch_replicas",
                    "Evaluated capacity of a watchlist scenario.",
                    ("watch",),
                ),
                "headroom": registry.gauge(
                    "kccap_watch_headroom_pct",
                    "Capacity headroom above the watch threshold "
                    "(min_replicas, else the spec's replicas), percent.",
                    ("watch",),
                ),
                "alert_state": registry.gauge(
                    "kccap_watch_alert_state",
                    "Watch alert state (0=ok, 1=recovered, 2=breached).",
                    ("watch",),
                ),
                "breaches": registry.counter(
                    "kccap_watch_breaches_total",
                    "min_replicas breaches entered, by watch.",
                    ("watch",),
                ),
                "changes": registry.counter(
                    "kccap_watch_capacity_changes_total",
                    "Generation-to-generation capacity moves, by watch "
                    "and direction.",
                    ("watch", "direction"),
                ),
                "eval": registry.histogram(
                    "kccap_timeline_eval_seconds",
                    "Wall time of one whole-watchlist evaluation "
                    "(coalescer thread, off the request path).",
                ),
            }
            if self._gang_names:
                # The gang family, registered only when a gang watch
                # exists (same shape policy as the CaR family below).
                self._m.update(
                    {
                        "gang_capacity": registry.gauge(
                            "kccap_gang_capacity",
                            "Whole gangs of the watch's gang spec "
                            "that currently fit.",
                            ("watch",),
                        ),
                        "gang_alert_state": registry.gauge(
                            "kccap_gang_alert_state",
                            "Gang watch alert state "
                            "(0=ok, 1=recovered, 2=breached).",
                            ("watch",),
                        ),
                    }
                )
            if self._car_names:
                # The capacity-at-risk family, registered only when a
                # quantile watch exists (a plain timeline's registry
                # shape stays byte-identical to the pre-CaR one).
                self._m.update(
                    {
                        "car_replicas": registry.gauge(
                            "kccap_car_replicas",
                            "Capacity at the watch's confidence "
                            "quantile (Monte Carlo, seed-deterministic).",
                            ("watch",),
                        ),
                        "car_prob_fit": registry.gauge(
                            "kccap_car_prob_fit",
                            "Fraction of usage samples whose capacity "
                            "fits the watch's replicas.",
                            ("watch",),
                        ),
                        "car_alert_state": registry.gauge(
                            "kccap_car_alert_state",
                            "Capacity-at-risk watch alert state "
                            "(0=ok, 1=recovered, 2=breached).",
                            ("watch",),
                        ),
                        "car_eval": registry.histogram(
                            "kccap_car_eval_seconds",
                            "Wall time of one capacity-at-risk watch "
                            "evaluation (sampling + sweep + reduction).",
                            ("watch",),
                        ),
                    }
                )
            if self._horizon_names:
                # The forecast family, registered only when a horizon
                # watch exists (same conditional-shape policy as the
                # CaR and gang families above).
                self._m.update(
                    {
                        "forecast_capacity": registry.gauge(
                            "kccap_forecast_capacity",
                            "Minimum projected quantile capacity "
                            "across the watch's forecast horizon.",
                            ("watch",),
                        ),
                        "forecast_ttb": registry.gauge(
                            "kccap_forecast_time_to_breach_seconds",
                            "Projected seconds until the quantile "
                            "capacity first crosses the watch "
                            "threshold (-1 = no breach inside the "
                            "horizon, or no usable trend).",
                            ("watch",),
                        ),
                        "forecast_alert_state": registry.gauge(
                            "kccap_forecast_alert_state",
                            "Forecast watch alert state "
                            "(0=ok, 1=recovered, 2=breached).",
                            ("watch",),
                        ),
                        "forecast_eval": registry.histogram(
                            "kccap_forecast_eval_seconds",
                            "Wall time of one forecast watch "
                            "evaluation (trend fit + one batched "
                            "horizon sweep).",
                            ("watch",),
                        ),
                    }
                )

    # -- observation -------------------------------------------------------
    def observe(
        self, snapshot: ClusterSnapshot, generation: int, *, ts=None
    ) -> GenerationRecord:
        """Evaluate the watchlist against one published generation and
        append the record.  Runs on the PUBLISHER'S thread (for a live
        server, the coalescer worker — never a request dispatcher)."""
        from kubernetesclustercapacity_tpu_torch.explain import explain_snapshot
        from kubernetesclustercapacity_tpu_torch.masks import implicit_taint_mask

        with self._lock:
            t0 = time.perf_counter()
            prev = self._ring[-1] if self._ring else None
            record = GenerationRecord(
                generation=int(generation),
                ts=time.time() if ts is None else float(ts),
                digest=snapshot_digest(snapshot),
                semantics=snapshot.semantics,
                n_nodes=snapshot.n_nodes,
                healthy_nodes=int(np.sum(snapshot.healthy)),
                summary=node_summary(snapshot),
            )
            transitions: list[tuple[str, WatchAlert]] = []
            for mode, specs in self._mode_groups(snapshot):
                plain = [
                    s for s in specs
                    if s.quantile is None and s.gang is None
                ]
                # The same implicit hard-taint mask every strict fit
                # surface applies (None unless the snapshot itself is
                # strict-packed) — so a timeline capacity equals the fit
                # op's answer for the identical spec, bit for bit.
                mask = (
                    implicit_taint_mask(snapshot)
                    if mode == "strict"
                    else None
                )
                if plain:
                    grid = ScenarioGrid.from_scenarios(
                        [s.scenario for s in plain]
                    )
                    result = explain_snapshot(
                        snapshot, grid, mode=mode, node_mask=mask,
                        device=self.device,
                    )
                    for s_i, spec in enumerate(plain):
                        total = int(result.totals[s_i])
                        alert = self._alerts[spec.name]
                        transition = alert.update(total, record.generation)
                        if transition is not None:
                            transitions.append((transition, alert))
                        record.watches[spec.name] = WatchResult(
                            name=spec.name,
                            mode=mode,
                            total=total,
                            schedulable=total >= spec.scenario.replicas,
                            breached=total < (spec.min_replicas or 0),
                            min_replicas=spec.min_replicas,
                            binding_counts=result.binding_counts(s_i),
                            fits=np.asarray(result.fits[s_i], dtype=np.int64),
                        )
                for spec in specs:
                    if spec.quantile is None and spec.gang is None:
                        continue
                    if spec.gang is not None:
                        r = self._evaluate_gang(snapshot, spec, mode, mask)
                    elif spec.horizon_steps is not None:
                        r = self._evaluate_horizon_locked(
                            snapshot, spec, mode, mask, record
                        )
                    else:
                        r = self._evaluate_car(snapshot, spec, mode, mask)
                    alert = self._alerts[spec.name]
                    # A forecast watch alerts on the horizon MINIMUM —
                    # "will breach" is the point of a forecast; plain
                    # watches alert on the evaluated total as before.
                    alert_total = (
                        r.horizon_min_capacity
                        if r.horizon_min_capacity is not None
                        else r.total
                    )
                    transition = alert.update(alert_total, record.generation)
                    if transition is not None:
                        transitions.append((transition, alert))
                    record.watches[spec.name] = r
            record.eval_ms = (time.perf_counter() - t0) * 1e3
            self._ring.append(record)
            self._publish_metrics_locked(record, prev)
            self._append_log(record, transitions)
            return record

    def _evaluate_car(
        self, snapshot: ClusterSnapshot, spec: WatchSpec, mode: str, mask
    ) -> WatchResult:
        """One capacity-at-risk watch against one generation.

        The Monte Carlo pass rides the production sweep path (grouped /
        bucketed / cached — seed-deterministic across all of them); the
        watch's "capacity" is the quantile, and the per-node fits /
        binding histogram come from explaining the quantile-realizing
        usage sample, so drift attribution stays node-granular and the
        quantile total equals that explain's fit sum by construction.
        """
        from kubernetesclustercapacity_tpu_torch.explain import explain_snapshot
        from kubernetesclustercapacity_tpu_torch.stochastic.car import (
            capacity_at_risk,
        )
        from kubernetesclustercapacity_tpu_torch.stochastic.distributions import (
            StochasticSpec,
        )

        s_spec = StochasticSpec(
            cpu=spec.usage_cpu,
            memory=spec.usage_mem,
            replicas=spec.scenario.replicas,
            samples=spec.samples,
            seed=spec.seed,
        )
        res = capacity_at_risk(
            snapshot,
            s_spec,
            mode=mode,
            node_mask=mask,
            quantiles=(spec.quantile,),
            bindings=False,
            device=self.device,
        )
        total = res.quantiles[spec.quantile]
        q_i = res.quantile_samples[spec.quantile]
        qgrid = ScenarioGrid(
            cpu_request_milli=res.samples_cpu[[q_i]],
            mem_request_bytes=res.samples_mem[[q_i]],
            replicas=np.array([spec.scenario.replicas], dtype=np.int64),
        )
        ex = explain_snapshot(
            snapshot, qgrid, mode=mode, node_mask=mask, device=self.device
        )
        return WatchResult(
            name=spec.name,
            mode=mode,
            total=total,
            schedulable=total >= spec.scenario.replicas,
            breached=total < (spec.min_replicas or 0),
            min_replicas=spec.min_replicas,
            binding_counts=ex.binding_counts(0),
            fits=np.asarray(ex.fits[0], dtype=np.int64),
            quantile=spec.quantile,
            prob_fit=res.prob_fit,
            samples=res.n_samples,
            car_eval_ms=res.eval_ms,
        )

    def _evaluate_horizon_locked(
        self,
        snapshot: ClusterSnapshot,
        spec: WatchSpec,
        mode: str,
        mask,
        record: GenerationRecord,
    ) -> WatchResult:
        """One forecast watch against one generation.

        Fits a Theil–Sen demand trend over the timeline's OWN ring
        (the records' observation stamps — never the wall clock at fit
        time, so re-observing the same history re-fits the same trend),
        then projects the watch's usage samples along it as ONE batched
        ``[H×S]`` sweep.  ``total`` stays the h=0 quantile capacity;
        the alert machine thresholds the horizon MINIMUM, and
        ``time_to_breach_s`` says when.  With fewer than 3 ring records
        or a flat/shrinking trend the watch degrades to a plain
        capacity-at-risk evaluation with ``time_to_breach_s = None`` —
        explicitly no forecast, never a fabricated one.
        """
        from kubernetesclustercapacity_tpu_torch.explain import explain_snapshot
        from kubernetesclustercapacity_tpu_torch.forecast.horizon import (
            project_horizon,
        )
        from kubernetesclustercapacity_tpu_torch.forecast.trend import fit_trend
        from kubernetesclustercapacity_tpu_torch.stochastic.distributions import (
            StochasticSpec,
        )
        from kubernetesclustercapacity_tpu_torch.stochastic.history import (
            InsufficientHistoryError,
        )

        horizon_s = (spec.horizon_steps - 1) * spec.horizon_step_s
        # The ring has not been appended yet — the series is the ring
        # plus the generation under observation.  Summary rows follow
        # diff.NODE_FIELDS order: index 3 = used_cpu_req_milli,
        # index 4 = used_mem_req_bytes.
        recs = list(self._ring) + [record]
        growth_cpu = growth_mem = 0.0
        degraded = False
        fitted = False
        if len(recs) >= 3:
            axis = np.asarray([r.ts for r in recs], dtype=np.float64)
            degraded = bool(
                np.any(np.diff(axis) < 0) or axis[-1] <= axis[0]
            )
            if degraded:
                axis = np.arange(len(recs), dtype=np.float64)
            cpu_tot = [
                float(sum(row[3] for row in r.summary.values()))
                for r in recs
            ]
            mem_tot = [
                float(sum(row[4] for row in r.summary.values()))
                for r in recs
            ]
            try:
                fit_cpu = fit_trend(
                    axis, cpu_tot, degraded_time_axis=degraded
                )
                fit_mem = fit_trend(
                    axis, mem_tot, degraded_time_axis=degraded
                )
                growth_cpu = max(fit_cpu.relative_slope_per_s, 0.0)
                growth_mem = max(fit_mem.relative_slope_per_s, 0.0)
                fitted = True
            except (InsufficientHistoryError, ValueError):
                fitted = False
        if not fitted or (growth_cpu == 0.0 and growth_mem == 0.0):
            # No trend (or a flat/shrinking one): the honest forecast
            # is "no projected breach" — a plain CaR evaluation with an
            # explicit null time-to-breach.
            r = self._evaluate_car(snapshot, spec, mode, mask)
            r.horizon_s = horizon_s
            r.time_to_breach_s = None
            r.horizon_min_capacity = None
            r.degraded_time_axis = degraded
            return r
        s_spec = StochasticSpec(
            cpu=spec.usage_cpu,
            memory=spec.usage_mem,
            replicas=spec.scenario.replicas,
            samples=spec.samples,
            seed=spec.seed,
        )
        threshold = (
            spec.min_replicas
            if spec.min_replicas is not None
            else spec.scenario.replicas
        )
        hr = project_horizon(
            snapshot,
            s_spec,
            steps=spec.horizon_steps,
            step_s=spec.horizon_step_s,
            growth_cpu_per_s=growth_cpu,
            growth_mem_per_s=growth_mem,
            mode=mode,
            node_mask=mask,
            quantiles=(spec.quantile,),
            threshold=threshold,
            degraded_time_axis=degraded,
            device=self.device,
        )
        total = int(hr.quantiles[spec.quantile][0])
        min_cap = hr.min_capacity(spec.quantile)
        # Node-granular fits/bindings come from the pod-level explain of
        # the watch's own scenario (the gang-watch convention) so delta
        # attribution works unchanged.
        grid = ScenarioGrid.from_scenarios([spec.scenario])
        ex = explain_snapshot(
            snapshot, grid, mode=mode, node_mask=mask, device=self.device
        )
        return WatchResult(
            name=spec.name,
            mode=mode,
            total=total,
            schedulable=total >= spec.scenario.replicas,
            breached=min_cap < (spec.min_replicas or 0),
            min_replicas=spec.min_replicas,
            binding_counts=ex.binding_counts(0),
            fits=np.asarray(ex.fits[0], dtype=np.int64),
            quantile=spec.quantile,
            prob_fit=None,
            samples=hr.n_samples,
            car_eval_ms=hr.eval_ms,
            horizon_s=horizon_s,
            time_to_breach_s=hr.time_to_breach_s[spec.quantile],
            horizon_min_capacity=min_cap,
            degraded_time_axis=degraded,
        )

    def _evaluate_gang(
        self, snapshot: ClusterSnapshot, spec: WatchSpec, mode: str, mask
    ) -> WatchResult:
        """One gang watch against one generation: the watch's capacity
        IS the whole-gang count (``min_replicas`` thresholds gangs).
        Per-node fits and the binding histogram come from the pod-level
        explain of the same scenario so delta attribution stays
        node-granular, exactly as CaR watches do."""
        from kubernetesclustercapacity_tpu_torch.explain import explain_snapshot
        from kubernetesclustercapacity_tpu_torch.topology.gang import gang_explain

        grid = ScenarioGrid.from_scenarios([spec.scenario])
        ex = explain_snapshot(
            snapshot, grid, mode=mode, node_mask=mask, device=self.device
        )
        detail = gang_explain(
            snapshot, grid, spec.gang, mode=mode, node_mask=mask,
            device=self.device,
        )
        total = int(detail["gangs"])
        return WatchResult(
            name=spec.name,
            mode=mode,
            total=total,
            schedulable=bool(detail["schedulable"]),
            breached=total < (spec.min_replicas or 0),
            min_replicas=spec.min_replicas,
            binding_counts=ex.binding_counts(0),
            fits=np.asarray(ex.fits[0], dtype=np.int64),
            gang_ranks=spec.gang.ranks,
            gang_count=spec.gang.count,
            gang_binding=detail["binding"],
            gang_summary=detail["summary"],
        )

    def _mode_groups(self, snapshot: ClusterSnapshot):
        """Watches grouped by effective kernel mode (one explain pass per
        mode, whole watchlist vectorized along the scenario axis)."""
        groups: dict[str, list[WatchSpec]] = {}
        for spec in self.watches:
            groups.setdefault(spec.mode or snapshot.semantics, []).append(
                spec
            )
        return groups.items()

    def _publish_metrics_locked(self, record, prev) -> None:
        if self._m is None or not _telemetry_enabled():
            return
        m = self._m
        m["generation"].labels().set(record.generation)
        m["records"].labels().set(len(self._ring))
        m["eval"].observe(record.eval_ms / 1e3)
        for spec in self.watches:
            r = record.watches.get(spec.name)
            if r is None:
                continue
            m["replicas"].labels(watch=spec.name).set(r.total)
            threshold = spec.min_replicas or spec.scenario.replicas
            if threshold > 0:
                m["headroom"].labels(watch=spec.name).set(
                    round(100.0 * (r.total - threshold) / threshold, 4)
                )
            m["alert_state"].labels(watch=spec.name).set(
                self._alerts[spec.name].state_code
            )
            if spec.gang is not None and "gang_capacity" in m:
                m["gang_capacity"].labels(watch=spec.name).set(r.total)
                m["gang_alert_state"].labels(watch=spec.name).set(
                    self._alerts[spec.name].state_code
                )
            if (
                spec.quantile is not None
                and spec.horizon_steps is None
                and "car_replicas" in m
            ):
                m["car_replicas"].labels(watch=spec.name).set(r.total)
                if r.prob_fit is not None:
                    m["car_prob_fit"].labels(watch=spec.name).set(
                        round(r.prob_fit, 6)
                    )
                m["car_alert_state"].labels(watch=spec.name).set(
                    self._alerts[spec.name].state_code
                )
                m["car_eval"].labels(watch=spec.name).observe(
                    r.car_eval_ms / 1e3
                )
            if spec.horizon_steps is not None and "forecast_capacity" in m:
                m["forecast_capacity"].labels(watch=spec.name).set(
                    r.horizon_min_capacity
                    if r.horizon_min_capacity is not None
                    else r.total
                )
                m["forecast_ttb"].labels(watch=spec.name).set(
                    round(r.time_to_breach_s, 3)
                    if r.time_to_breach_s is not None
                    else -1
                )
                m["forecast_alert_state"].labels(watch=spec.name).set(
                    self._alerts[spec.name].state_code
                )
                m["forecast_eval"].labels(watch=spec.name).observe(
                    r.car_eval_ms / 1e3
                )
            before = (
                prev.watches[spec.name].total
                if prev is not None and spec.name in prev.watches
                else None
            )
            if before is not None and r.total != before:
                m["changes"].labels(
                    watch=spec.name,
                    direction="up" if r.total > before else "down",
                ).inc()
        # Breach counters track the alert machine exactly (one source).
        for name, alert in self._alerts.items():
            if alert.breaches:
                c = m["breaches"].labels(watch=name)
                c.inc(alert.breaches - c.value)

    def _append_log(self, record, transitions) -> None:
        if self._log is None:
            return
        try:
            self._log.record(
                kind="generation",
                generation=record.generation,
                ts=record.ts,
                digest=record.digest,
                nodes=record.n_nodes,
                healthy_nodes=record.healthy_nodes,
                watches={
                    name: r.total for name, r in record.watches.items()
                },
                eval_ms=round(record.eval_ms, 3),
            )
            for transition, alert in transitions:
                self._log.record(
                    kind="alert",
                    ts=record.ts,
                    watch=alert.name,
                    transition=transition,
                    generation=record.generation,
                    total=alert.last_total,
                    min_replicas=alert.min_replicas,
                    breaches=alert.breaches,
                )
        except Exception:  # noqa: BLE001 - logging must not fail a publish
            pass

    # -- read surfaces -----------------------------------------------------
    def records(
        self, *, since_generation: int | None = None
    ) -> list[GenerationRecord]:
        """Oldest-to-newest copy of the ring (optionally only generations
        strictly after ``since_generation``)."""
        with self._lock:
            recs = list(self._ring)
        if since_generation is not None:
            recs = [r for r in recs if r.generation > since_generation]
        return recs

    def alerts(self) -> dict[str, dict]:
        """Current alert state per watch (wire shape)."""
        with self._lock:
            return {n: a.to_wire() for n, a in self._alerts.items()}

    def deltas(
        self,
        *,
        since_generation: int | None = None,
        watch: str | None = None,
    ) -> list[dict]:
        """Attributed generation transitions, oldest to newest.

        Each entry joins the node-set diff with per-watch capacity
        movement: binding-constraint shift plus the per-node fit
        contributions (added nodes contribute their new fit, removed
        nodes their lost fit, mutated nodes the difference).
        ``since_generation`` keeps transitions ENDING after it; ``watch``
        filters the per-watch sections.
        """
        with self._lock:
            recs = list(self._ring)
        out = []
        for prev, cur in zip(recs, recs[1:]):
            if (
                since_generation is not None
                and cur.generation <= since_generation
            ):
                continue
            out.append(self._delta(prev, cur, watch))
        return out

    def _delta(self, prev, cur, watch: str | None) -> dict:
        from kubernetesclustercapacity_tpu_torch.explain import binding_shift

        diff = diff_summaries(prev.summary, cur.summary)
        prev_idx = {k: i for i, k in enumerate(prev.summary)}
        cur_idx = {k: i for i, k in enumerate(cur.summary)}
        # Added nodes whose row matches an EXISTING shape: they joined a
        # (shape, count) group rather than introducing a new one — the
        # grouped-dispatch census moved, which the attribution must say
        # even when the node's own fit contribution is zero.
        prev_shapes = set(prev.summary.values())
        shape_joins = {
            key: shape_key(row)
            for key, row in diff.added.items()
            if row in prev_shapes
        }
        watches: dict[str, dict] = {}
        for name, r in cur.watches.items():
            if watch is not None and name != watch:
                continue
            old = prev.watches.get(name)
            if old is None:
                continue
            contributions: list[tuple[str, int, str]] = []
            for key in diff.removed:
                c = -int(old.fits[prev_idx[key]])
                if c:
                    contributions.append((key, c, "removed"))
            for key in diff.added:
                c = int(r.fits[cur_idx[key]])
                if c:
                    contributions.append((key, c, "added"))
            for key in diff.changed:
                c = int(r.fits[cur_idx[key]]) - int(old.fits[prev_idx[key]])
                if c:
                    contributions.append((key, c, "mutated"))
            contributions.sort(key=lambda t: (-abs(t[1]), t[0]))
            shift = binding_shift(old.binding_counts, r.binding_counts)
            watches[name] = {
                "before": old.total,
                "after": r.total,
                "delta": r.total - old.total,
                "binding_shift": shift,
                "contributors": [
                    {"node": k, "delta": c, "change": kind}
                    for k, c, kind in contributions[:_MAX_CONTRIBUTORS]
                ],
                "summary": _delta_summary(
                    name, old.total, r.total, diff, shift, contributions,
                    shape_joins,
                ),
            }
        return {
            "from_generation": prev.generation,
            "to_generation": cur.generation,
            "ts": cur.ts,
            "nodes_added": sorted(diff.added),
            "nodes_removed": sorted(diff.removed),
            "nodes_changed": len(diff.changed),
            "shape_joins": [
                {"node": k, "shape": sk}
                for k, sk in sorted(shape_joins.items())
            ],
            "diff": diff.to_wire(),
            "watches": watches,
        }

    # -- aggregate surfaces ------------------------------------------------
    def wire(
        self,
        *,
        since_generation: int | None = None,
        watch: str | None = None,
    ) -> dict:
        """The whole timeline as the ``timeline`` op's response body."""
        if watch is not None and watch not in self._alerts:
            raise ValueError(
                f"unknown watch {watch!r} "
                f"(have {sorted(self._alerts) or 'none'})"
            )
        records = self.records(since_generation=since_generation)
        with self._lock:
            count, last = len(self._ring), (
                self._ring[-1].generation if self._ring else 0
            )
        return {
            "enabled": True,
            "depth": self.depth,
            "count": count,
            "generation": last,
            "watchlist": [w.to_wire() for w in self.watches],
            "records": [r.to_wire(watch) for r in records],
            "deltas": self.deltas(
                since_generation=since_generation, watch=watch
            ),
            "alerts": (
                self.alerts()
                if watch is None
                else {watch: self.alerts()[watch]}
            ),
        }

    def car_breached(self) -> list[str]:
        """Capacity-at-risk watches currently breached — the slice of
        alert state that flips ``/healthz`` to 503 (a quantile watch
        breach is a confidence statement: "with 95% confidence fewer
        than N replicas fit", which a load balancer must see)."""
        if not self._car_names:
            return []
        with self._lock:
            return sorted(
                n
                for n, a in self._alerts.items()
                if n in self._car_names and a.state == "breached"
            )

    def gang_breached(self) -> list[str]:
        """Gang watches currently breached — the slice of alert state
        that flips ``/healthz`` to 503 (like :meth:`car_breached`: a
        breached gang watch says fewer than N whole gangs fit, which a
        gang-scheduling admission plane must see, not discover)."""
        if not self._gang_names:
            return []
        with self._lock:
            return sorted(
                n
                for n, a in self._alerts.items()
                if n in self._gang_names and a.state == "breached"
            )

    def forecast_breached(self) -> list[str]:
        """Forecast watches currently breached — the slice of alert
        state that flips ``/healthz`` to 503 (like :meth:`car_breached`:
        a breached forecast says the projected quantile capacity
        crosses the threshold INSIDE the horizon — the one alert whose
        whole value is arriving before the outage does)."""
        if not self._horizon_names:
            return []
        with self._lock:
            return sorted(
                n
                for n, a in self._alerts.items()
                if n in self._horizon_names and a.state == "breached"
            )

    def forecast_status(self) -> dict:
        """Per-forecast-watch status (the ``forecast`` op's watch view /
        the doctor's "capacity forecast" line): last h=0 and horizon-
        minimum quantile capacities, time to breach, alert state."""
        with self._lock:
            last = self._ring[-1] if self._ring else None
            out: dict[str, dict] = {}
            for spec in self.watches:
                if spec.horizon_steps is None:
                    continue
                r = last.watches.get(spec.name) if last else None
                out[spec.name] = {
                    "quantile": spec.quantile,
                    "min_replicas": spec.min_replicas,
                    "steps": spec.horizon_steps,
                    "step_s": spec.horizon_step_s,
                    "horizon_s": (spec.horizon_steps - 1)
                    * spec.horizon_step_s,
                    "last_total": r.total if r else None,
                    "horizon_min_capacity": (
                        r.horizon_min_capacity if r else None
                    ),
                    "time_to_breach_s": (
                        r.time_to_breach_s if r else None
                    ),
                    "degraded_time_axis": (
                        r.degraded_time_axis if r else False
                    ),
                    "samples": r.samples if r else 0,
                    "seed": spec.seed,
                    "alert": self._alerts[spec.name].to_wire(),
                }
            return out

    def gang_status(self) -> dict:
        """Per-gang-watch status (the ``gang`` op's watch view / the
        doctor's "gang capacity" line): last whole-gang count, the
        binding topology level, and alert state."""
        with self._lock:
            last = self._ring[-1] if self._ring else None
            out: dict[str, dict] = {}
            for spec in self.watches:
                if spec.gang is None:
                    continue
                r = last.watches.get(spec.name) if last else None
                out[spec.name] = {
                    "ranks": spec.gang.ranks,
                    "count": spec.gang.count,
                    "colocate": spec.gang.colocate,
                    "min_replicas": spec.min_replicas,
                    "last_gangs": r.total if r else None,
                    "binding": r.gang_binding if r else None,
                    "summary": r.gang_summary if r else "",
                    "alert": self._alerts[spec.name].to_wire(),
                }
            return out

    def car_status(self) -> dict:
        """Per-CaR-watch status (the ``car`` op's watch view / the
        doctor's "capacity at risk" line): last quantile capacity,
        probability-of-fit, sample count, alert state."""
        with self._lock:
            last = self._ring[-1] if self._ring else None
            out: dict[str, dict] = {}
            for spec in self.watches:
                if spec.quantile is None or spec.horizon_steps is not None:
                    # Horizon watches report under forecast_status —
                    # each watch belongs to exactly one funnel.
                    continue
                r = last.watches.get(spec.name) if last else None
                out[spec.name] = {
                    "quantile": spec.quantile,
                    "min_replicas": spec.min_replicas,
                    "last_total": r.total if r else None,
                    "prob_fit": (
                        round(r.prob_fit, 6)
                        if r and r.prob_fit is not None
                        else None
                    ),
                    "samples": r.samples if r else 0,
                    "seed": spec.seed,
                    "alert": self._alerts[spec.name].to_wire(),
                }
            return out

    def stats(self) -> dict:
        """Compact health view (doctor / ``/healthz``)."""
        with self._lock:
            count = len(self._ring)
            last = self._ring[-1] if self._ring else None
            alerts = {n: a.state for n, a in self._alerts.items()}
        out = {
            "records": count,
            "depth": self.depth,
            "generation": last.generation if last else 0,
            "watches": [w.name for w in self.watches],
            "alerts": alerts,
            "breached": sorted(
                n for n, s in alerts.items() if s == "breached"
            ),
            "last_eval_ms": round(last.eval_ms, 3) if last else None,
        }
        if self._car_names:
            # Present only when quantile watches exist, so a plain
            # timeline's stats shape stays byte-identical to pre-CaR.
            out["car_breached"] = sorted(
                n
                for n, s in alerts.items()
                if n in self._car_names and s == "breached"
            )
        if self._gang_names:
            # Same shape policy: the gang slice appears only when gang
            # watches exist.
            out["gang_breached"] = sorted(
                n
                for n, s in alerts.items()
                if n in self._gang_names and s == "breached"
            )
        if self._horizon_names:
            # And the forecast slice only when horizon watches exist.
            out["forecast_breached"] = sorted(
                n
                for n, s in alerts.items()
                if n in self._horizon_names and s == "breached"
            )
        return out

    def close(self) -> None:
        if self._log is not None:
            self._log.close()
