"""Process-wide, thread-safe metrics registry (Prometheus data model).

Three instrument types — :class:`Counter` (monotonic), :class:`Gauge`
(settable, optionally callback-backed), :class:`Histogram` (cumulative
buckets + sum + count) — each a *family* keyed by metric name with
labeled children.  Families are created idempotently through a
:class:`MetricsRegistry`: asking twice for the same name returns the one
family (so a server, a follower and the fused-kernel path can all wire
themselves against the same registry without coordination), while a
re-registration that *disagrees* (different type or label names) raises
— two subsystems silently sharing a name with different meanings is a
corruption, not a convenience.

Label ordering is fixed at family declaration (``labelnames``) and every
child/exposition renders in exactly that order, so scrape output is
deterministic regardless of keyword-argument order at the call site.

Concurrency: each family holds one lock guarding both its child table
and every child's value, so a counter hammered from many threads counts
exactly.  Nothing here ever calls out
under a lock except gauge callbacks at *collection* time.

The module-level :data:`REGISTRY` is the process-wide default (the
server's ``main`` and the device-memory ledger use it).  Embedders that need
isolation — every server/follower instance, every test — construct their
own ``MetricsRegistry``.
"""

from __future__ import annotations

import os
import re
import threading

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MetricsError",
    "DEFAULT_LATENCY_BUCKETS_S",
    "SUB_MS_LATENCY_BUCKETS_S",
    "REGISTRY",
    "enabled",
]

#: Fixed latency buckets (seconds) shared by every request/kernel
#: histogram in the stack: sub-millisecond resolution where the fused
#: kernel lives (~0.5-1 ms per sweep), stretching to 10 s so a wedged
#: dispatch is still binned, then +Inf (implicit).
DEFAULT_LATENCY_BUCKETS_S = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

#: Fine-grained buckets for kernel/phase histograms.  The default
#: ladder's first boundary is 0.5 ms, which flattens the ~0.7 ms
#: fused-path p50 (and every sub-phase of it) into one bucket — useless
#: for phase p50/p99 estimation.  This ladder resolves 10 µs – 1 ms in
#: sub-bucket steps and still reaches 10 s so a wedged phase bins.
SUB_MS_LATENCY_BUCKETS_S = (
    0.00001, 0.000025, 0.00005, 0.0001, 0.00025, 0.0005, 0.00075,
    0.001, 0.0015, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class MetricsError(ValueError):
    """Invalid metric/label declaration or conflicting re-registration."""


def enabled() -> bool:
    """Process-wide telemetry switch (``KCCAP_TELEMETRY=0`` disables).

    Checked by the *dispatch-side hooks* (e.g. the fused-kernel path) so
    that with telemetry off the hot sweep path makes zero registry
    calls; the registry itself always works — a disabled process can
    still snapshot an (empty) registry.
    """
    return os.environ.get("KCCAP_TELEMETRY", "1") != "0"


def _format_value(v: float) -> str:
    """Prometheus sample formatting: integers bare, floats as repr."""
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 2**63 else repr(f)


class _Family:
    """Shared family machinery: label validation + child table."""

    type: str = ""

    def __init__(self, name: str, help: str, labelnames=()) -> None:
        if not _NAME_RE.match(name):
            raise MetricsError(f"invalid metric name {name!r}")
        labelnames = tuple(labelnames)
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise MetricsError(f"invalid label name {ln!r}")
        if len(set(labelnames)) != len(labelnames):
            raise MetricsError(f"duplicate label names in {labelnames}")
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], object] = {}

    def _child_key(self, labels: dict) -> tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise MetricsError(
                f"{self.name} wants labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}"
            )
        # Values in DECLARATION order — the one ordering every child key,
        # snapshot entry and exposition line shares.
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def labels(self, **labels):
        """The child for this label-value combination (created once)."""
        key = self._child_key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
            return child

    def _make_child(self):  # pragma: no cover - overridden
        raise NotImplementedError

    def _items(self) -> list[tuple[tuple[str, ...], object]]:
        """Children in insertion order, as a stable copy."""
        with self._lock:
            return list(self._children.items())


class _CounterChild:
    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.Lock) -> None:
        self._lock = lock
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise MetricsError(f"counters only go up, got inc({amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Counter(_Family):
    """Monotonic counter family (``_total`` naming is the caller's)."""

    type = "counter"

    def _make_child(self) -> _CounterChild:
        return _CounterChild(self._lock)

    def inc(self, amount: float = 1.0, **labels) -> None:
        self.labels(**labels).inc(amount)

    @property
    def value(self) -> float:
        """Unlabeled convenience (only valid for label-less families)."""
        return self.labels().value


class _GaugeChild:
    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self, lock: threading.Lock) -> None:
        self._lock = lock
        self._value = 0.0
        self._fn = None

    def set(self, value: float) -> None:
        with self._lock:
            self._fn = None
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_function(self, fn) -> None:
        """Collect the value by calling ``fn()`` at read time — for state
        that already lives elsewhere (breaker state, queue depths), so
        the gauge can never go stale."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        # Callback runs OUTSIDE the lock: it may itself take locks
        # (e.g. CircuitBreaker.state) and must not nest under ours.
        return float(fn())


class Gauge(_Family):
    type = "gauge"

    def _make_child(self) -> _GaugeChild:
        return _GaugeChild(self._lock)

    def set(self, value: float, **labels) -> None:
        self.labels(**labels).set(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        self.labels(**labels).inc(amount)

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.labels(**labels).dec(amount)

    @property
    def value(self) -> float:
        return self.labels().value


class _HistogramChild:
    __slots__ = (
        "_lock", "_buckets", "_counts", "_sum", "_count", "_exemplars",
    )

    def __init__(self, lock: threading.Lock, buckets: tuple) -> None:
        self._lock = lock
        self._buckets = buckets
        self._counts = [0] * len(buckets)
        self._sum = 0.0
        self._count = 0
        # Lazily-allocated per-bucket exemplars: bucket index (len(
        # buckets) = the +Inf bucket) -> (trace_id, value, ts).  Memory
        # is bounded by the bucket count — LAST exemplar wins, which is
        # exactly the metrics→traces join an operator wants ("show me a
        # recent trace that landed in this latency bucket").
        self._exemplars: dict | None = None

    def observe(self, value: float, exemplar: str | None = None) -> None:
        value = float(value)
        idx = len(self._buckets)  # +Inf unless a finite bucket matches
        with self._lock:
            self._sum += value
            self._count += 1
            for i, b in enumerate(self._buckets):
                if value <= b:
                    self._counts[i] += 1
                    # Non-cumulative internally; exposition/snapshot
                    # cumulate so one observe is one increment.
                    idx = i
                    break
            if exemplar:
                if self._exemplars is None:
                    self._exemplars = {}
                import time as _time

                self._exemplars[idx] = (
                    str(exemplar), value, _time.time()
                )

    def snapshot(self) -> dict:
        """``{"buckets": {le: cumulative}, "sum": s, "count": n}`` with
        the ``+Inf`` bucket explicit (== count, by construction).  When
        any observation carried an exemplar, an ``"exemplars"`` entry
        maps the bucket's ``le`` string to
        ``{"trace_id", "value", "ts"}``."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
            ex = dict(self._exemplars) if self._exemplars else None
        out, acc = {}, 0
        for b, c in zip(self._buckets, counts):
            acc += c
            out[_format_value(b)] = acc
        out["+Inf"] = total
        snap = {"buckets": out, "sum": s, "count": total}
        if ex:
            les = [_format_value(b) for b in self._buckets] + ["+Inf"]
            snap["exemplars"] = {
                les[i]: {"trace_id": t, "value": v, "ts": ts}
                for i, (t, v, ts) in ex.items()
            }
        return snap

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum


def _normalize_buckets(buckets) -> tuple:
    """Canonical bucket tuple: sorted floats, dupes rejected, the
    implicit ``+Inf`` stripped (rendered from count; storing it would
    double-book every observation)."""
    buckets = tuple(sorted(float(b) for b in buckets))
    if not buckets:
        raise MetricsError("histogram needs at least one bucket")
    if buckets != tuple(dict.fromkeys(buckets)):
        raise MetricsError(f"duplicate buckets in {buckets}")
    if buckets[-1] == float("inf"):
        buckets = buckets[:-1]
    return buckets


class Histogram(_Family):
    type = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames=(),
        buckets=DEFAULT_LATENCY_BUCKETS_S,
    ) -> None:
        super().__init__(name, help, labelnames)
        if "le" in self.labelnames:
            raise MetricsError("'le' is reserved for histogram buckets")
        self.buckets = _normalize_buckets(buckets)

    def _make_child(self) -> _HistogramChild:
        return _HistogramChild(self._lock, self.buckets)

    def observe(
        self, value: float, exemplar: str | None = None, **labels
    ) -> None:
        self.labels(**labels).observe(value, exemplar=exemplar)


class MetricsRegistry:
    """Thread-safe family registry: create-or-get by name, snapshot all.

    ``counter``/``gauge``/``histogram`` are idempotent per name; a type
    or label-name disagreement raises :class:`MetricsError`.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _register(self, cls, name, help, labelnames, **kw) -> _Family:
        labelnames = tuple(labelnames)
        with self._lock:
            existing = self._families.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or (
                    existing.labelnames != labelnames
                ):
                    raise MetricsError(
                        f"metric {name!r} already registered as "
                        f"{existing.type}{existing.labelnames}, cannot "
                        f"re-register as {cls.type}{labelnames}"
                    )
                if isinstance(existing, Histogram) and "buckets" in kw:
                    # Custom bucket boundaries are part of the metric's
                    # meaning: two subsystems silently sharing a name
                    # with different ladders would make every p50/p99
                    # estimate a lie about one of them.
                    wanted = _normalize_buckets(kw["buckets"])
                    if wanted != existing.buckets:
                        raise MetricsError(
                            f"histogram {name!r} already registered with "
                            f"buckets {existing.buckets}, cannot "
                            f"re-register with {wanted}"
                        )
                return existing
            fam = cls(name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", labelnames=()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(
        self,
        name: str,
        help: str = "",
        labelnames=(),
        buckets=DEFAULT_LATENCY_BUCKETS_S,
    ) -> Histogram:
        return self._register(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def collect(self) -> list[_Family]:
        """Families in registration order (stable copy)."""
        with self._lock:
            return list(self._families.values())

    def snapshot(self) -> dict:
        """JSON-able view of every family: the ``info``-op / bench form.

        ``{name: {"type": t, "values": {label_str: value_or_histdict}}}``
        where ``label_str`` is the exposition label block (``""`` for an
        unlabeled child) — so the snapshot and the scrape agree on
        identity.
        """
        out: dict = {}
        for fam in self.collect():
            values: dict = {}
            for key, child in fam._items():
                label_str = ",".join(
                    f'{ln}="{escape_label_value(v)}"'
                    for ln, v in zip(fam.labelnames, key)
                )
                if isinstance(child, _HistogramChild):
                    values[label_str] = child.snapshot()
                else:
                    values[label_str] = child.value
            out[fam.name] = {"type": fam.type, "values": values}
        return out


def escape_label_value(v: str) -> str:
    """Prometheus label-value escaping: backslash, quote, newline."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


#: The process-wide default registry (CLI, bench, fused-kernel path).
REGISTRY = MetricsRegistry()
