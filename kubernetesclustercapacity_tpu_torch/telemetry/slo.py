"""SLO objectives + multi-window error-budget burn rates for the service.

Counterpart of ``kubernetesclustercapacity_tpu/telemetry/slo.py``, verbatim
(host arithmetic over the registry's counters).  The serving stack watches
capacity (the timeline); this module watches the service's *own*
latency and availability — the first thing a fleet serving real traffic
needs alarmed.  The machinery is the SRE-workbook multi-window burn
rate:

* an **objective** defines what "bad" means — a latency objective
  (``p99 < 80ms``: a request slower than the threshold spends budget)
  or an availability objective (``99.9%``: an errored or shed request
  spends budget);
* the **error budget** is the allowed bad fraction (``1 − 0.99`` for a
  p99 objective, ``1 − target`` for availability);
* the **burn rate** over a window is ``bad_fraction / budget`` — 1.0
  burns the budget exactly at the sustainable rate, 14 burns a 30-day
  budget in ~2 days;
* an SLO is **fast-burning** when the burn rate exceeds its threshold
  over BOTH the short and the long window: the long window proves the
  burn is significant, the short window proves it is still happening
  (so recovery un-pages promptly).

State comes from rolling snapshots of the server's OWN registry
counters (``kccap_request_latency_seconds`` buckets for latency,
``kccap_requests_total`` / ``kccap_request_errors_total`` /
``kccap_deadline_shed_total`` for availability) — no second measurement
path that could disagree with the scrape.  Each evaluation appends one
cumulative sample per SLO and differences it against the sample at the
window start; the window math itself (:func:`burn_rate`) is a pure
function pinned against a numpy oracle by the tests.

Fast burn drives the existing :class:`~..timeline.alerts.WatchAlert`
ok→breached→recovered machine, ``kccap_slo_*`` gauges, ``/healthz``
(503 while fast-burning), the ``slo`` protocol op /
``kccap -slo-status``, the doctor's "latency & SLO" line, and an
optional JSONL transition log.  ``KCCAP_TELEMETRY=0`` keeps the whole
module registry-silent, same contract as every telemetry layer.

The ``-slo`` file rides the watchlist flag grammar (YAML when PyYAML
exists, strict JSON otherwise)::

    slos:
      - name: sweep-latency
        op: sweep                 # omit to cover every op
        latency: "p99 < 100ms"
        short_window_s: 60        # optional (defaults below)
        long_window_s: 600
        fast_burn: 14
      - name: availability
        availability: "99.9%"     # or 0.999
"""

from __future__ import annotations

import json
import re
import threading
import time
from dataclasses import dataclass

from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
    enabled as _telemetry_enabled,
)
from kubernetesclustercapacity_tpu_torch.timeline.alerts import (
    ALERT_BREACHED,
    WatchAlert,
)

__all__ = [
    "SLOError",
    "SLOSpec",
    "SLOMonitor",
    "parse_slos",
    "load_slos",
    "burn_rate",
    "estimate_quantile",
]

#: Multi-window defaults: the workbook's page-worthy pairing scaled to a
#: service whose incidents are minutes, not days.
DEFAULT_SHORT_WINDOW_S = 60.0
DEFAULT_LONG_WINDOW_S = 600.0
DEFAULT_FAST_BURN = 14.0

_LATENCY_RE = re.compile(
    r"^\s*p(\d+(?:\.\d+)?)\s*<\s*(\d+(?:\.\d+)?)\s*(ms|s)\s*$"
)

_ENTRY_KEYS = frozenset(
    {
        "name", "op", "tenant", "latency", "availability",
        "short_window_s", "long_window_s", "fast_burn",
    }
)


class SLOError(ValueError):
    """Malformed SLO file/entry (bad grammar, bad numbers, dupes)."""


@dataclass(frozen=True)
class SLOSpec:
    """One objective: what counts as bad, and when burning it pages."""

    name: str
    kind: str  # "latency" | "availability"
    op: str | None = None  # None = every op
    #: Latency only: evaluate over ONE tenant's requests (the server's
    #: kccap_tenant_request_latency_seconds family) instead of per op.
    #: Use the map's names — unmapped traffic folds to "other".
    tenant: str | None = None
    quantile: float | None = None  # latency: 0.99 for p99
    threshold_s: float | None = None  # latency objective bound
    target: float | None = None  # availability: 0.999
    short_window_s: float = DEFAULT_SHORT_WINDOW_S
    long_window_s: float = DEFAULT_LONG_WINDOW_S
    fast_burn: float = DEFAULT_FAST_BURN

    @property
    def budget(self) -> float:
        """The allowed bad fraction (the error budget's size)."""
        if self.kind == "latency":
            return 1.0 - self.quantile
        return 1.0 - self.target

    @property
    def objective(self) -> str:
        """Human rendering (reports / doctor / wire)."""
        if self.kind == "latency":
            q = self.quantile * 100
            q_str = f"{q:g}"
            return f"p{q_str} < {self.threshold_s * 1e3:g}ms"
        return f"availability >= {self.target * 100:g}%"

    def to_wire(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "op": self.op,
            # Present only when set: tenantless specs keep their exact
            # pre-tenancy wire shape.
            **({"tenant": self.tenant} if self.tenant is not None else {}),
            "objective": self.objective,
            "budget": self.budget,
            "short_window_s": self.short_window_s,
            "long_window_s": self.long_window_s,
            "fast_burn": self.fast_burn,
        }


def _parse_fraction(name: str, field: str, v) -> float:
    """``0.999`` or ``"99.9%"`` → the fraction in (0, 1)."""
    if isinstance(v, str):
        s = v.strip()
        if s.endswith("%"):
            try:
                v = float(s[:-1]) / 100.0
            except ValueError as e:
                raise SLOError(
                    f"slo {name!r}: bad {field} {s!r}"
                ) from e
        else:
            try:
                v = float(s)
            except ValueError as e:
                raise SLOError(
                    f"slo {name!r}: bad {field} {s!r}"
                ) from e
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise SLOError(f"slo {name!r}: {field} must be a number or 'NN%'")
    v = float(v)
    if not 0.0 < v < 1.0:
        raise SLOError(
            f"slo {name!r}: {field} must be strictly between 0 and 1 "
            f"(got {v})"
        )
    return v


def _parse_entry(i: int, entry) -> SLOSpec:
    if not isinstance(entry, dict):
        raise SLOError(f"slo #{i}: expected a mapping, got {entry!r}")
    name = entry.get("name")
    if not isinstance(name, str) or not name:
        raise SLOError(f"slo #{i}: 'name' must be a non-empty string")
    unknown = set(entry) - _ENTRY_KEYS
    if unknown:
        raise SLOError(
            f"slo {name!r}: unknown field(s) {sorted(unknown)} "
            f"(want a subset of {sorted(_ENTRY_KEYS)})"
        )
    op = entry.get("op")
    if op is not None and (not isinstance(op, str) or not op):
        raise SLOError(f"slo {name!r}: 'op' must be a non-empty string")
    tenant = entry.get("tenant")
    if tenant is not None and (not isinstance(tenant, str) or not tenant):
        raise SLOError(
            f"slo {name!r}: 'tenant' must be a non-empty string"
        )
    if tenant is not None and op is not None:
        # Per-tenant latency reads the tenant-labeled family, which has
        # no op dimension — the combination would silently mean "ignore
        # op", so it errors instead.
        raise SLOError(
            f"slo {name!r}: 'tenant' and 'op' are mutually exclusive"
        )
    has_latency = "latency" in entry
    has_avail = "availability" in entry
    if has_latency == has_avail:
        raise SLOError(
            f"slo {name!r}: exactly one of 'latency' or 'availability' "
            "is required"
        )
    windows = {}
    for field, default in (
        ("short_window_s", DEFAULT_SHORT_WINDOW_S),
        ("long_window_s", DEFAULT_LONG_WINDOW_S),
        ("fast_burn", DEFAULT_FAST_BURN),
    ):
        v = entry.get(field, default)
        if isinstance(v, bool) or not isinstance(v, (int, float)) or v <= 0:
            raise SLOError(
                f"slo {name!r}: {field} must be a positive number"
            )
        windows[field] = float(v)
    if windows["short_window_s"] >= windows["long_window_s"]:
        raise SLOError(
            f"slo {name!r}: short_window_s must be < long_window_s"
        )
    if has_latency:
        spec_str = entry["latency"]
        if not isinstance(spec_str, str):
            raise SLOError(
                f"slo {name!r}: latency objective must be a string like "
                "'p99 < 80ms'"
            )
        m = _LATENCY_RE.match(spec_str)
        if m is None:
            raise SLOError(
                f"slo {name!r}: cannot parse latency objective "
                f"{spec_str!r} (want e.g. 'p99 < 80ms')"
            )
        q = float(m.group(1)) / 100.0
        if not 0.0 < q < 1.0:
            raise SLOError(
                f"slo {name!r}: latency quantile must be in (p0, p100)"
            )
        bound = float(m.group(2))
        threshold_s = bound / 1e3 if m.group(3) == "ms" else bound
        if threshold_s <= 0:
            raise SLOError(f"slo {name!r}: latency bound must be > 0")
        return SLOSpec(
            name=name, kind="latency", op=op, tenant=tenant, quantile=q,
            threshold_s=threshold_s, **windows,
        )
    if tenant is not None:
        # Availability is op-scoped (errors carry an op, not a tenant);
        # per-tenant availability would need a tenant-labeled error
        # family this server does not keep (bounded cardinality).
        raise SLOError(
            f"slo {name!r}: 'tenant' is only valid on latency objectives"
        )
    target = _parse_fraction(name, "availability", entry["availability"])
    return SLOSpec(name=name, kind="availability", op=op, target=target,
                   **windows)


def parse_slos(data) -> tuple[SLOSpec, ...]:
    """Parsed document (``{"slos": [...]}`` or a bare list) → specs."""
    if isinstance(data, dict):
        entries = data.get("slos")
        extra = set(data) - {"slos"}
        if extra:
            raise SLOError(f"unknown top-level field(s) {sorted(extra)}")
    else:
        entries = data
    if not isinstance(entries, list) or not entries:
        raise SLOError(
            "slo file wants a non-empty 'slos' list (or a bare list)"
        )
    specs = tuple(_parse_entry(i, e) for i, e in enumerate(entries))
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise SLOError(f"duplicate slo name(s): {dupes}")
    return specs


def load_slos(path: str) -> tuple[SLOSpec, ...]:
    """Load ``path`` — YAML when PyYAML is present, else strict JSON
    (the watchlist loader's exact gating)."""
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    try:
        import yaml  # type: ignore[import-untyped]

        data = yaml.safe_load(text)
    except ImportError:
        try:
            data = json.loads(text)
        except ValueError as e:
            raise SLOError(
                f"{path}: not valid JSON (and PyYAML is unavailable): {e}"
            ) from e
    except Exception as e:  # yaml.YAMLError — malformed document
        raise SLOError(f"{path}: cannot parse: {e}") from e
    return parse_slos(data)


# -- the window math (pure; numpy-oracle-pinned) ---------------------------
def burn_rate(samples, *, now: float, window_s: float, budget: float):
    """Burn rate over ``[now − window_s, now]`` from cumulative samples.

    ``samples`` is an ordered iterable of ``(ts, total, bad)`` with
    ``total``/``bad`` CUMULATIVE counts (monotone non-decreasing, ts
    ascending).  The window's baseline is the newest sample at or before
    the window start — or, when history is shorter than the window, the
    oldest sample available (a partial window is honest about the
    history it has; refusing to alert until a full long window elapsed
    would blind the first ten minutes of every deploy).  The head is the
    newest sample at or before ``now``.

    Returns ``bad_fraction / budget`` for the delta between baseline and
    head, ``0.0`` when the window saw no traffic, or ``None`` when there
    are fewer than two distinct samples to difference.
    """
    if budget <= 0:
        raise SLOError(f"budget must be > 0, got {budget}")
    head = None
    baseline = None
    first_in_history = None
    start = now - window_s
    for s in samples:
        ts = s[0]
        if ts > now:
            break
        if first_in_history is None:
            first_in_history = s
        if ts <= start:
            baseline = s
        head = s
    if baseline is None:
        baseline = first_in_history
    if head is None or baseline is None or head is baseline:
        return None
    d_total = head[1] - baseline[1]
    d_bad = head[2] - baseline[2]
    if d_total <= 0:
        return 0.0
    return (d_bad / d_total) / budget


def estimate_quantile(buckets: dict, count: int, q: float):
    """Quantile estimate from a cumulative bucket dict (the histogram
    snapshot's ``{le_str: cumulative}`` form), linearly interpolated
    inside the winning bucket.  ``None`` when the histogram is empty.
    The doctor's latency line and the reports use this — an estimate
    bounded by bucket resolution, which is why kernel/phase histograms
    carry the sub-millisecond ladder."""
    if count <= 0:
        return None
    rank = q * count
    lo = 0.0
    prev_cum = 0
    last_finite = 0.0
    for le_str, cum in buckets.items():
        if le_str == "+Inf":
            break
        le = float(le_str)
        if cum >= rank and cum > prev_cum:
            frac = (rank - prev_cum) / (cum - prev_cum)
            return lo + (le - lo) * max(0.0, min(1.0, frac))
        lo = le
        prev_cum = cum
        last_finite = le
    return last_finite  # the quantile lives in the +Inf bucket


def _hist_bad_count(child, threshold_s: float) -> int:
    """Observations provably above ``threshold_s`` in a histogram child:
    ``count − cumulative(first boundary ≥ threshold)``.  Thresholds
    should sit on bucket boundaries (the sub-ms ladder makes that easy);
    otherwise the next boundary up is used, undercounting within one
    bucket — conservative, never a false page."""
    snap = child.snapshot()
    count = snap["count"]
    cum_at = None
    for le_str, cum in snap["buckets"].items():
        if le_str == "+Inf":
            continue
        if float(le_str) >= threshold_s - 1e-12:
            cum_at = cum
            break
    if cum_at is None:
        # Threshold beyond the last finite boundary: everything in the
        # +Inf region violates it (a wedged request must spend budget).
        last = 0
        for le_str, cum in snap["buckets"].items():
            if le_str != "+Inf":
                last = cum
        cum_at = last
    return int(count - cum_at)


def registry_source(registry):
    """The default counter source: reads (total, bad) cumulative counts
    per spec straight from the server's own request metrics, so the SLO
    verdict and the scrape can never disagree.  Families are created
    idempotently with the server's exact declarations."""
    lat = registry.histogram(
        "kccap_request_latency_seconds",
        "End-to-end dispatch latency, by op.",
        ("op",),
    )
    req = registry.counter(
        "kccap_requests_total", "Requests dispatched, by op.", ("op",)
    )
    err = registry.counter(
        "kccap_request_errors_total",
        "Requests that raised, by op and exception type.",
        ("op", "error"),
    )
    shed = registry.counter(
        "kccap_deadline_shed_total",
        "Requests shed because their deadline had already expired.",
    )

    def read(spec: SLOSpec) -> tuple[int, int]:
        if spec.kind == "latency":
            fam = lat
            if spec.tenant is not None:
                # Created idempotently with the server's exact
                # declaration; lazily, so tenantless deployments never
                # grow the family in their registry snapshot.
                fam = registry.histogram(
                    "kccap_tenant_request_latency_seconds",
                    "End-to-end dispatch latency, by tenant (bounded "
                    "cardinality; feeds per-tenant SLO specs).",
                    ("tenant",),
                )
            total = bad = 0
            for key, child in fam._items():
                if spec.tenant is not None:
                    if key[0] != spec.tenant:
                        continue
                elif spec.op is not None and key[0] != spec.op:
                    continue
                total += child.count
                bad += _hist_bad_count(child, spec.threshold_s)
            return total, bad
        total = 0
        for key, child in req._items():
            if spec.op is not None and key[0] != spec.op:
                continue
            total += int(child.value)
        bad = 0
        for key, child in err._items():
            if spec.op is not None and key[0] != spec.op:
                continue
            bad += int(child.value)
        # Shed requests are unavailability too (the caller got no
        # answer); the shed counter is op-less, so it spends every
        # availability objective's budget.
        bad += int(shed.labels().value)
        return total, bad

    return read


class SLOMonitor:
    """Rolling burn-rate evaluation + the ok→breached→recovered machine.

    ``source`` is a callable ``spec → (total, bad)`` cumulative counts
    (default: :func:`registry_source` over ``registry``).  ``evaluate``
    appends one sample per spec and recomputes both windows; it is
    called by the ``slo`` op and ``/healthz`` on read (state is always
    fresh when queried) and optionally by :meth:`start`'s background
    thread (gauges stay fresh for scrapers that never query).

    Telemetry: ``kccap_slo_burn_rate{slo,window}``,
    ``kccap_slo_alert_state{slo}`` (0 ok / 1 recovered / 2 breached),
    ``kccap_slo_breaches_total{slo}`` — registered only when a registry
    is given AND telemetry is enabled (``KCCAP_TELEMETRY=0`` = zero
    registry calls, pinned by test).  ``log`` (path or
    :class:`~.tracing.TraceLog`) receives one JSONL line per alert
    transition.
    """

    def __init__(
        self,
        specs,
        *,
        registry=None,
        source=None,
        log=None,
        time_fn=time.time,
    ) -> None:
        from kubernetesclustercapacity_tpu_torch.telemetry.tracing import TraceLog

        specs = tuple(specs)
        if not specs:
            raise SLOError("SLOMonitor wants at least one SLOSpec")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise SLOError(f"duplicate slo names: {names}")
        if source is None:
            if registry is None:
                raise SLOError(
                    "SLOMonitor needs a registry (for the default "
                    "counter source) or an explicit source"
                )
            source = registry_source(registry)
        self.specs = specs
        self._source = source
        self._time = time_fn
        self._lock = threading.Lock()
        # Ring depth: enough samples to always bracket the long window
        # at the fastest plausible evaluation cadence (~1/s) — bounded,
        # and the window math only reads the bracketing two anyway.
        self._samples = {
            s.name: [] for s in specs
        }
        self._max_samples = {
            s.name: max(int(s.long_window_s) * 2 + 16, 64) for s in specs
        }
        # min_replicas=1 re-uses the timeline's machine verbatim: the
        # monitor feeds 0 while fast-burning and 1 while not, so
        # "capacity below threshold" IS "budget burning too fast".
        self._alerts = {s.name: WatchAlert(s.name, 1) for s in specs}
        self._burns: dict[str, dict] = {
            s.name: {"short": None, "long": None} for s in specs
        }
        self._evals = 0
        self._log = TraceLog(log) if isinstance(log, str) else log
        self._m = None
        if registry is not None and _telemetry_enabled():
            self._m = {
                "burn": registry.gauge(
                    "kccap_slo_burn_rate",
                    "Error-budget burn rate (1.0 = exactly sustainable), "
                    "by SLO and window.",
                    ("slo", "window"),
                ),
                "state": registry.gauge(
                    "kccap_slo_alert_state",
                    "SLO alert state (0=ok, 1=recovered, 2=breached).",
                    ("slo",),
                ),
                "breaches": registry.counter(
                    "kccap_slo_breaches_total",
                    "Fast-burn breaches entered, by SLO.",
                    ("slo",),
                ),
            }
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- evaluation --------------------------------------------------------
    def evaluate(self, now: float | None = None) -> dict:
        """Sample every objective's counters and advance the machine.

        Returns ``{name: {"short_burn", "long_burn", "fast_burning",
        "state", "transition"}}`` for this evaluation.  Deterministic
        under an injected ``now`` (tests drive synthetic series through
        an injected ``source``)."""
        now = self._time() if now is None else float(now)
        out: dict[str, dict] = {}
        with self._lock:
            self._evals += 1
            seq = self._evals
            for spec in self.specs:
                total, bad = self._source(spec)
                ring = self._samples[spec.name]
                ring.append((now, int(total), int(bad)))
                if len(ring) > self._max_samples[spec.name]:
                    del ring[: len(ring) - self._max_samples[spec.name]]
                short = burn_rate(
                    ring, now=now, window_s=spec.short_window_s,
                    budget=spec.budget,
                )
                long_ = burn_rate(
                    ring, now=now, window_s=spec.long_window_s,
                    budget=spec.budget,
                )
                self._burns[spec.name] = {"short": short, "long": long_}
                fast = (
                    short is not None
                    and long_ is not None
                    and short > spec.fast_burn
                    and long_ > spec.fast_burn
                )
                alert = self._alerts[spec.name]
                transition = alert.update(0 if fast else 1, seq)
                if transition is not None:
                    self._append_log(spec, transition, short, long_, now)
                self._publish_metrics(spec, short, long_, alert)
                out[spec.name] = {
                    "short_burn": short,
                    "long_burn": long_,
                    "fast_burning": fast,
                    "state": alert.state,
                    "transition": transition,
                }
        return out

    def _publish_metrics(self, spec, short, long_, alert) -> None:
        if self._m is None or not _telemetry_enabled():
            return
        m = self._m
        for window, value in (("short", short), ("long", long_)):
            m["burn"].labels(slo=spec.name, window=window).set(
                value if value is not None else 0.0
            )
        m["state"].labels(slo=spec.name).set(alert.state_code)
        if alert.breaches:
            c = m["breaches"].labels(slo=spec.name)
            c.inc(alert.breaches - c.value)

    def _append_log(self, spec, transition, short, long_, now) -> None:
        if self._log is None:
            return
        try:
            self._log.record(
                kind="slo_alert",
                ts=now,
                slo=spec.name,
                objective=spec.objective,
                transition=transition,
                short_burn=short,
                long_burn=long_,
                fast_burn=spec.fast_burn,
            )
        except Exception:  # noqa: BLE001 - logging must not fail an eval
            pass

    # -- read surfaces -----------------------------------------------------
    @property
    def fast_burning(self) -> bool:
        """True while ANY objective's alert is breached — the
        ``/healthz`` 503 condition."""
        with self._lock:
            return any(
                a.state == ALERT_BREACHED for a in self._alerts.values()
            )

    def status(self) -> dict:
        """Per-SLO state (``slo`` op body, ``kccap -slo-status``)."""
        with self._lock:
            out = {}
            for spec in self.specs:
                alert = self._alerts[spec.name]
                burns = self._burns[spec.name]
                ring = self._samples[spec.name]
                head = ring[-1] if ring else None
                out[spec.name] = {
                    "objective": spec.objective,
                    "op": spec.op,
                    "state": alert.state,
                    "breaches": alert.breaches,
                    "recoveries": alert.recoveries,
                    "short_burn": burns["short"],
                    "long_burn": burns["long"],
                    "fast_burn": spec.fast_burn,
                    "fast_burning": alert.state == ALERT_BREACHED,
                    "total": head[1] if head else 0,
                    "bad": head[2] if head else 0,
                }
            return out

    def wire(self) -> dict:
        """The ``slo`` op's response body."""
        with self._lock:
            # _evals is incremented under the lock by evaluate(); read
            # it the same way so the wire view is a consistent count.
            evals = self._evals
        return {
            "enabled": True,
            "specs": [s.to_wire() for s in self.specs],
            "status": self.status(),
            "fast_burning": self.fast_burning,
            "evaluations": evals,
        }

    def stats(self) -> dict:
        """Compact health view (``/healthz``, doctor)."""
        with self._lock:
            states = {n: a.state for n, a in self._alerts.items()}
            evals = self._evals
        return {
            "slos": [s.name for s in self.specs],
            "states": states,
            "breached": sorted(
                n for n, s in states.items() if s == ALERT_BREACHED
            ),
            "evaluations": evals,
        }

    # -- lifecycle ---------------------------------------------------------
    def start(self, interval_s: float = 5.0) -> "SLOMonitor":
        """Background evaluation so gauges/healthz stay fresh without a
        querier (the server's main starts this; tests call
        :meth:`evaluate` directly)."""
        if interval_s <= 0:
            raise SLOError("interval_s must be > 0")

        def loop() -> None:
            while not self._stop.wait(interval_s):
                try:
                    self.evaluate()
                except Exception:  # noqa: BLE001 - monitor must outlive blips
                    pass

        from kubernetesclustercapacity_tpu_torch.utils.threads import supervised

        self._thread = threading.Thread(
            target=supervised(loop, name="kccap-slo-eval"),
            name="kccap-slo-eval",
            daemon=True,
        )
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._log is not None:
            self._log.close()
