"""Continuous sampling profiler: host flamegraphs joined to the phase
vocabulary.

Counterpart of ``kubernetesclustercapacity_tpu/telemetry/profiler.py``,
verbatim apart from its imports: it samples Python stacks on the host, so
nothing in it touches the card.  A supervised background thread samples
every live thread's Python stack (``sys._current_frames()``) at :data:`DEFAULT_HZ` (``-profile-hz`` /
``KCCAP_PROFILE_HZ``), folds each stack into a collapsed-flamegraph
line (Brendan Gregg's ``frame;frame;frame count`` format, root first),
and prefixes each line with the sampled thread's live ``(op, tenant,
phase)`` attribution from :func:`~.phases.live_snapshot` — so "which
frames inside ``serialize``?" is one grep, and the dominant phase of a
profile can be reconciled against the ``kccap_phase_seconds`` histogram.

Surfaces:

* ``/debug/profile?seconds=N`` on the exposition server (the server
  wires :meth:`SamplingProfiler.debug_handler`);
* ``kccap -profile HOST:PORT -profile-out FILE.collapsed`` (cli.py);
* ``kccap_profiler_samples_total{phase}`` — samples per attributed
  phase (label ``-`` for samples landing outside any phase block);
* a doctor "profiler" line (:func:`profiler_status`).

Hot-path rule: ``KCCAP_PROFILER=0`` (or ``KCCAP_TELEMETRY=0``) pins the
profiler to **zero threads and zero registry calls** — :meth:`start`
returns without spawning anything, pinned by test.  The sampler holds
the GIL only for the ``sys._current_frames()`` snapshot and the fold of
a handful of stacks.  29 is deliberately prime: a sampler phase-locked
to a 10 ms scheduler tick or a 50-per-second batch window would alias,
sampling the same instant of every period.
"""

from __future__ import annotations

import os
import sys
import threading
import time

from kubernetesclustercapacity_tpu_torch.telemetry import (
    phases as _phases,
)

__all__ = [
    "DEFAULT_HZ",
    "SamplingProfiler",
    "enabled",
    "get_profiler",
    "start_profiler",
    "stop_profiler",
    "attribution_counts",
    "phase_counts",
    "dominant_phase",
    "top_frame",
    "profiler_status",
]

#: Default sampling rate (Hz); prime, see module docstring.
DEFAULT_HZ = 29

#: Stack-depth cap per sample and unique-stack cap for the fold table —
#: both bound the profiler's own memory so a pathological workload
#: (deep recursion, codegen'd frames) cannot turn the observer into the
#: leak.  Overflow is counted, never silent.
MAX_DEPTH = 64
MAX_STACKS = 50_000


def enabled() -> bool:
    """Profiler armed?  ``KCCAP_PROFILER=0`` is the dedicated hatch;
    ``KCCAP_TELEMETRY=0`` disables it too (the profiler's metrics and
    attribution both ride the telemetry substrate)."""
    if os.environ.get("KCCAP_PROFILER", "1") == "0":
        return False
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
        enabled as _telemetry_enabled,
    )

    return _telemetry_enabled()


def _env_hz() -> float:
    raw = os.environ.get("KCCAP_PROFILE_HZ", "")
    try:
        hz = float(raw)
    except ValueError:
        return float(DEFAULT_HZ)
    return hz if hz > 0 else float(DEFAULT_HZ)


def _frame_name(frame) -> str:
    """One collapsed-stack element: ``file:function`` with the path
    reduced to its basename (the fold must stay greppable and the
    separator characters must not appear inside an element)."""
    code = frame.f_code
    base = os.path.basename(code.co_filename)
    if base.endswith(".py"):
        base = base[:-3]
    name = f"{base}:{code.co_name}"
    return name.replace(";", ",").replace(" ", "_")


def _fold(frame, attribution) -> str:
    """Fold one thread's stack (innermost ``frame``) into a collapsed
    line, root first, prefixed with synthetic attribution frames
    (``op=...;tenant=...;phase=...``) when the thread is mid-request."""
    names: list[str] = []
    depth = 0
    while frame is not None and depth < MAX_DEPTH:
        names.append(_frame_name(frame))
        frame = frame.f_back
        depth += 1
    names.reverse()
    prefix: list[str] = []
    if attribution is not None:
        op, tenant, phase = attribution
        if op:
            prefix.append(f"op={op}")
        if tenant:
            prefix.append(f"tenant={tenant}")
        if phase:
            prefix.append(f"phase={phase}")
    return ";".join(prefix + names)


class SamplingProfiler:
    """The always-on wall-clock sampler.

    One instance per process (module singleton via :func:`get_profiler`)
    — but the class is self-contained and testable standalone.  All
    mutable state lives under ``self._lock``; the sampler thread writes,
    snapshot/collect readers copy.
    """

    def __init__(self, hz: float | None = None) -> None:
        self._lock = threading.Lock()
        self._hz = float(hz) if hz and hz > 0 else _env_hz()
        self._counts: dict[str, int] = {}
        self._samples = 0
        self._dropped = 0
        self._started_at: float | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._metric = None

    @property
    def hz(self) -> float:
        return self._hz

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    # -- lifecycle ---------------------------------------------------

    def start(self) -> "SamplingProfiler":
        """Spawn the sampler thread; a no-op (zero threads, zero
        registry calls) when :func:`enabled` says off or when already
        running."""
        if not enabled() or self.running():
            return self
        from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
            REGISTRY,
        )
        from kubernetesclustercapacity_tpu_torch.utils.threads import (
            supervised,
        )

        self._metric = REGISTRY.counter(
            "kccap_profiler_samples_total",
            "Profiler samples taken, by attributed phase ('-' when the "
            "sampled thread was outside any phase block).",
            ("phase",),
        )
        self._stop.clear()
        with self._lock:
            self._started_at = time.time()
        self._thread = threading.Thread(
            target=supervised(self._loop, name="profiler-sampler"),
            name="kccap-profiler",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
        self._thread = None

    # -- sampling ----------------------------------------------------

    def _loop(self) -> None:
        period = 1.0 / self._hz
        while not self._stop.wait(period):
            self.sample_once()

    def sample_once(self) -> None:
        """Take one sample of every live thread (except the sampler
        itself) and fold it into the table.  Public so tests can drive
        the fold deterministically without a thread."""
        me = threading.get_ident()
        live = _phases.live_snapshot()
        frames = sys._current_frames()
        folded: list[tuple[str, str]] = []
        for ident, frame in frames.items():
            if ident == me:
                continue
            attribution = live.get(ident)
            phase = attribution[2] if attribution else None
            folded.append((_fold(frame, attribution), phase or "-"))
        del frames
        metric = self._metric
        with self._lock:
            self._samples += 1
            for stack, _ in folded:
                if stack in self._counts:
                    self._counts[stack] += 1
                elif len(self._counts) < MAX_STACKS:
                    self._counts[stack] = 1
                else:
                    self._dropped += 1
        if metric is not None:
            for _, phase in folded:
                metric.labels(phase=phase).inc()

    # -- read side ---------------------------------------------------

    def snapshot(self) -> tuple[int, dict[str, int]]:
        """``(samples_so_far, {stack: count})`` — a point-in-time copy."""
        with self._lock:
            return self._samples, dict(self._counts)

    def stats(self) -> dict:
        with self._lock:
            return {
                "hz": self._hz,
                "samples": self._samples,
                "stacks": len(self._counts),
                "dropped_stacks": self._dropped,
                "running": self.running(),
                "uptime_s": (
                    round(time.time() - self._started_at, 1)
                    if self._started_at
                    else 0.0
                ),
            }

    def collect(self, seconds: float) -> str:
        """Profile a window: snapshot, wait ``seconds`` while the
        sampler runs, snapshot again, render the difference as collapsed
        text (most-sampled stack first).  Runs on the CALLER's thread —
        the ``/debug/profile`` handler blocks its own HTTP thread, never
        the sampler."""
        seconds = max(0.0, min(float(seconds), 300.0))
        _, before = self.snapshot()
        if seconds:
            time.sleep(seconds)
        _, after = self.snapshot()
        diff = {
            stack: n - before.get(stack, 0)
            for stack, n in after.items()
            if n - before.get(stack, 0) > 0
        }
        return render_collapsed(diff)

    def debug_handler(self, query: str) -> tuple[str, bytes]:
        """The exposition server's ``/debug/profile`` handler:
        ``query`` is the raw query string; returns ``(content_type,
        body)``.  ``seconds`` defaults to 5."""
        from urllib.parse import parse_qs

        try:
            seconds = float(
                (parse_qs(query).get("seconds") or ["5"])[0]
            )
        except ValueError:
            seconds = 5.0
        if not self.running():
            return (
                "text/plain; charset=utf-8",
                b"# profiler disabled (KCCAP_PROFILER=0 or "
                b"KCCAP_TELEMETRY=0)\n",
            )
        return (
            "text/plain; charset=utf-8",
            self.collect(seconds).encode(),
        )


def render_collapsed(counts: dict[str, int]) -> str:
    """``{stack: count}`` → collapsed-flamegraph text, most-sampled
    first (``flamegraph.pl`` and speedscope both ingest this)."""
    lines = [
        f"{stack} {n}"
        for stack, n in sorted(
            counts.items(), key=lambda kv: (-kv[1], kv[0])
        )
    ]
    return "\n".join(lines) + ("\n" if lines else "")


# -- collapsed-text analysis (shared by cli -profile and bench) --------


def _parse_collapsed(text: str) -> list[tuple[list[str], int]]:
    out: list[tuple[list[str], int]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        stack, _, count = line.rpartition(" ")
        try:
            n = int(count)
        except ValueError:
            continue
        out.append((stack.split(";"), n))
    return out


def attribution_counts(text: str, key: str = "phase") -> dict[str, int]:
    """Samples per attributed ``key`` (``op``/``tenant``/``phase``) in a
    collapsed profile; ``-`` collects the unattributed remainder.  The
    attribution prefixes live in the first three frames of a stack, so
    only those are inspected."""
    prefix = key + "="
    shares: dict[str, int] = {}
    for frames, n in _parse_collapsed(text):
        value = "-"
        for f in frames[:3]:
            if f.startswith(prefix):
                value = f[len(prefix):]
                break
        shares[value] = shares.get(value, 0) + n
    return shares


def phase_counts(text: str) -> dict[str, int]:
    """Samples per attributed phase in a collapsed profile (``-`` =
    unattributed) — the reconciliation surface against the
    ``kccap_phase_seconds`` histogram."""
    return attribution_counts(text, "phase")


def dominant_phase(text: str) -> tuple[str | None, float]:
    """The most-sampled ATTRIBUTED phase and its share of attributed
    samples — ``(None, 0.0)`` when nothing was attributed."""
    shares = phase_counts(text)
    shares.pop("-", None)
    total = sum(shares.values())
    if not total:
        return None, 0.0
    phase = max(shares, key=lambda p: shares[p])
    return phase, shares[phase] / total


def top_frame(text: str, phase: str | None = None) -> str | None:
    """The hottest REAL frame (attribution prefixes skipped), optionally
    restricted to samples attributed to ``phase`` — bench's
    ``serving_top_host_frame`` field."""
    weights: dict[str, int] = {}
    for frames, n in _parse_collapsed(text):
        real = [f for f in frames if "=" not in f.split(":", 1)[0]]
        if phase is not None and f"phase={phase}" not in frames[:3]:
            continue
        if not real:
            continue
        leaf = real[-1]
        weights[leaf] = weights.get(leaf, 0) + n
    if not weights:
        return None
    return max(weights, key=lambda f: weights[f])


# -- module singleton --------------------------------------------------

_singleton_lock = threading.Lock()
_singleton: SamplingProfiler | None = None


def get_profiler() -> SamplingProfiler | None:
    """The process profiler, or ``None`` when never started."""
    return _singleton


def start_profiler(hz: float | None = None) -> SamplingProfiler | None:
    """Start (or return) the process-wide profiler; ``None`` without a
    thread or registry call when :func:`enabled` says off."""
    global _singleton
    if not enabled():
        return None
    with _singleton_lock:
        if _singleton is None:
            _singleton = SamplingProfiler(hz)
    return _singleton.start()


def stop_profiler() -> None:
    global _singleton
    with _singleton_lock:
        prof, _singleton = _singleton, None
    if prof is not None:
        prof.stop()


def profiler_status() -> str:
    """The doctor's "profiler" line (soft when off — an unprofiled
    process is a configuration, not a failure)."""
    if not enabled():
        return (
            "off (KCCAP_PROFILER=0 or KCCAP_TELEMETRY=0) — zero "
            "sampler threads"
        )
    prof = get_profiler()
    if prof is None or not prof.running():
        return (
            f"armed (hz={_env_hz():g}): sampler starts with the "
            "server; /debug/profile on the metrics port"
        )
    st = prof.stats()
    return (
        f"ok: sampling at {st['hz']:g} Hz, {st['samples']} sample(s), "
        f"{st['stacks']} unique stack(s), uptime {st['uptime_s']}s"
    )
