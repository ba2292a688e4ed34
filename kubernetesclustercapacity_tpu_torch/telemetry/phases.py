"""Per-request latency decomposition: the phase clock.

The JAX package's ``telemetry/phases.py`` for the PyTorch port's server,
extended.  Every answering request is split into a FIXED phase
vocabulary (:data:`PHASES`): the JAX package's nine, so the two servers'
``kccap_phase_seconds`` series line up, and then the port's own eight.
Each phase is a named sub-interval of the request:

``admission``
    waiting in the admission controller's bounded concurrency queue
    (``service/plane.py``; a request shed at admission records nothing —
    it never became work);
``queue_wait``
    waiting for a compute-inflight slot (``CapacityServer``'s semaphore);
``batch_wait``
    the micro-batch window — the leader's wait for followers, or a
    follower's wait for its leader's combined dispatch
    (``service/batching.py``);
``devcache``
    staging snapshot arrays host→device on a device-cache miss
    (``devcache.py``; a hit records nothing — that is the point of the
    cache);
``compile``
    a first dispatch that compiled its kernel (kept for the shared
    vocabulary; the port builds its kernels once per process, outside
    any request's clock);
``device_exec``
    the kernel call itself: the launch.  On the kernel routes the
    per-call operand staging before it is ``stage``; the exact programs'
    own host packing before the sync point stays in ``device_exec``;
``fetch``
    the device→host materialization of a synchronous dispatch;
``fetch_overlap``
    the deferred materialization of an async dispatch: the sweep
    returned views over a pending pinned copy and the request waited on
    its event only at response-build time, so this wait OVERLAPPED the
    next batch's window/dispatch instead of serializing behind it
    (``service/server.py``'s folded sweep path);
``serialize``
    building the wire response (``tolist`` and report rendering).

The port's own:

``decode``
    the ``json.loads`` of a request body already read off the socket
    (the server's connection handler; the wait for the frame is not in
    it);
``reply``
    the reply's ``json.dumps`` and its send;
``lock_wait``
    waiting for the server's dispatch lock (every acquire on the dispatch
    path: the snapshot capture, ``update``, ``reload``);
``proof``
    the kernels' eligibility proofs (``fast_*_eligible`` and
    ``rcp_*_eligible``, ``ops/fused_fit.py``, ``ops/fused_multi.py``);
``stage``
    a kernel dispatch's per-call operands: their host build and their
    host→device copies;
``apply``
    ``update``'s ``ClusterStore.apply`` of the request's events;
``repack``
    ``update``'s ``ClusterStore.snapshot()`` and implicit taint mask;
``domains``
    the grid ``topology_spread``'s masks and topology-domain discovery
    on the host (``CapacityModel.topology_spread_grid``), before its
    per-node program.

``decode`` and ``reply`` happen outside the dispatch: the handler times
them on a clock of its own and files them under the dispatch's op label,
so a dispatch clock's phases still sum to at most the request's
``kccap_request_latency_seconds``.

Threading model: the clock rides a **thread-local** (:func:`activate` /
:func:`restore` / :func:`current`), not a parameter — the phases land
deep inside layers (devcache, the kernel wrappers) whose signatures must
not grow a telemetry argument.  The server's dispatch activates one
clock per request; a micro-batch leader's kernel phases therefore land
on the LEADER's clock while each follower records only its own
``batch_wait`` — per-request attribution stays honest.

Device-trace clock: while a ``torch.profiler`` records, every
:meth:`PhaseClock.phase` and :meth:`PhaseClock.live` block also opens
``torch.profiler.record_function("kccap.<phase>")``, so the block lands
as a ``user_annotation`` in the same trace as the kernels and copies, on
the thread that did the work.  With no profiler the gate is one module
attribute read (``torch.autograd.profiler._is_profiler_enabled``).

Hot-path rule (the package's): with ``KCCAP_TELEMETRY=0``,
:func:`new_clock` returns the process-wide :data:`NULL_CLOCK` singleton
— **zero allocations**, and every instrumentation site gates its
``perf_counter`` pair on the clock's truthiness, so the disabled
dispatch path is byte-identical to the pre-phases one.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from torch.autograd import profiler as _autograd_profiler

__all__ = [
    "PHASES",
    "PhaseError",
    "PhaseClock",
    "NULL_CLOCK",
    "new_clock",
    "current",
    "activate",
    "restore",
    "live_set",
    "live_clear",
    "live_snapshot",
    "annotation",
]

#: The fixed phase vocabulary: the JAX package's nine, then the port's
#: own.  Every phase name recorded anywhere in the package MUST appear
#: here (and in the README's phase tables), so the
#: ``kccap_phase_seconds{phase=...}`` label set cannot grow by typo.
PHASES = (
    "admission",
    "queue_wait",
    "batch_wait",
    "devcache",
    "compile",
    "device_exec",
    "fetch",
    "fetch_overlap",
    "serialize",
    "decode",
    "reply",
    "lock_wait",
    "proof",
    "stage",
    "apply",
    "repack",
    "domains",
)

_PHASE_SET = frozenset(PHASES)

#: Each phase's name in a profiler trace.
_ANNOTATIONS = {p: f"kccap.{p}" for p in PHASES}


def annotation(name: str):
    """An entered ``record_function`` named ``name`` while a
    ``torch.profiler`` records, else None (one attribute read); the
    caller exits it with ``__exit__(None, None, None)``."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    rf = _autograd_profiler.record_function(name)
    rf.__enter__()
    return rf


class PhaseError(ValueError):
    """A phase name outside the fixed vocabulary."""


class _NullCtx:
    """A reusable no-op context manager (module singleton) — so
    ``with clk.phase(...):`` on the null clock allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


class _NullClock:
    """The disabled clock: a process-wide singleton whose every method
    is a no-op and whose truth value is False, so instrumentation sites
    can gate their ``perf_counter`` pairs with a plain ``if clk:`` —
    zero allocations, zero timing syscalls, zero registry calls."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def record(self, phase: str, seconds: float) -> None:
        pass

    def move(self, src: str, dst: str) -> None:
        pass

    def items(self):
        return ()

    def counts(self) -> dict:
        return {}

    def to_ms(self) -> dict:
        return {}

    def total_s(self) -> float:
        return 0.0

    def phase(self, name: str):
        return _NULL_CTX

    def live(self, name: str):
        return _NULL_CTX


#: The one instance every disabled dispatch shares (``new_clock`` under
#: ``KCCAP_TELEMETRY=0``, and :func:`current` on a thread with no active
#: clock).
NULL_CLOCK = _NullClock()


# ---------------------------------------------------------------------------
# Live cross-thread attribution: the sampling profiler's join point.
#
# The phase clock accumulates *post hoc* — by the time ``items()`` is
# readable the request is over.  The profiler needs the opposite view:
# "what is thread T doing RIGHT NOW?".  This table publishes, per thread
# ident, the ``(op, tenant, phase)`` triple currently in flight, written
# by the dispatch (``live_set``) and by :meth:`PhaseClock.phase` on
# enter/exit, and read by the sampler thread (``live_snapshot``).  It is
# deliberately tiny: one dict under one lock, entries removed when the
# request finishes, and NEVER touched on the ``KCCAP_TELEMETRY=0`` path
# (every writer is gated on clock truthiness, same as the clocks
# themselves).
# ---------------------------------------------------------------------------

_live_lock = threading.Lock()
_live: dict[int, tuple] = {}


def live_set(op=None, tenant=None) -> None:
    """Publish ``(op, tenant)`` as the calling thread's in-flight work
    (phase starts unset; :meth:`PhaseClock.phase` fills it)."""
    with _live_lock:
        _live[threading.get_ident()] = (op, tenant, None)


def live_clear() -> None:
    """Retire the calling thread's attribution entry (request done)."""
    with _live_lock:
        _live.pop(threading.get_ident(), None)


def live_snapshot() -> dict:
    """A point-in-time copy ``{thread_ident: (op, tenant, phase)}`` —
    the sampler's read side."""
    with _live_lock:
        return dict(_live)


def _live_enter_phase(ident: int, name: str):
    """Mark ``name`` as ``ident``'s current phase; returns the previous
    entry (or ``None``) for :func:`_live_exit_phase`."""
    with _live_lock:
        prev = _live.get(ident)
        if prev is None:
            _live[ident] = (None, None, name)
        else:
            _live[ident] = (prev[0], prev[1], name)
        return prev


def _live_exit_phase(ident: int, prev) -> None:
    """Undo :func:`_live_enter_phase` (phases nest — restore the outer
    entry, or remove the one we created)."""
    with _live_lock:
        if prev is None:
            cur = _live.get(ident)
            if cur is not None and cur[0] is None and cur[1] is None:
                del _live[ident]
        else:
            _live[ident] = prev


class PhaseClock:
    """Per-request phase accumulator, safe for concurrent recorders.

    One clock is one request's decomposition: ``record`` adds a timed
    sub-interval to a phase (phases may be recorded more than once —
    e.g. two devcache stagings — and accumulate), ``move`` reattributes
    one phase's whole accumulation to another (the compile join:
    :func:`~.compilewatch.observe_dispatch` only classifies a dispatch
    *after* it ran, so ``device_exec``/``fetch`` recorded during a
    first-call dispatch move into ``compile``).  The lock exists because
    a request's phases can be recorded from more than one thread (the
    micro-batch leader's dispatch callback), and counts must stay exact
    under that concurrency.
    """

    __slots__ = ("_lock", "_acc", "_counts")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._acc: dict[str, float] = {}
        self._counts: dict[str, int] = {}

    def __bool__(self) -> bool:
        return True

    def record(self, phase: str, seconds: float) -> None:
        """Add one timed sub-interval to ``phase`` (vocabulary-checked)."""
        if phase not in _PHASE_SET:
            raise PhaseError(
                f"unknown phase {phase!r} (vocabulary: {PHASES})"
            )
        seconds = float(seconds)
        with self._lock:
            self._acc[phase] = self._acc.get(phase, 0.0) + seconds
            self._counts[phase] = self._counts.get(phase, 0) + 1

    def move(self, src: str, dst: str) -> None:
        """Reattribute all of ``src``'s accumulation to ``dst``."""
        for p in (src, dst):
            if p not in _PHASE_SET:
                raise PhaseError(
                    f"unknown phase {p!r} (vocabulary: {PHASES})"
                )
        with self._lock:
            s = self._acc.pop(src, None)
            if s is None:
                return
            c = self._counts.pop(src, 0)
            self._acc[dst] = self._acc.get(dst, 0.0) + s
            self._counts[dst] = self._counts.get(dst, 0) + c

    @contextmanager
    def phase(self, name: str):
        """Time a block into ``name`` (host-side convenience).  Also
        publishes ``name`` to the live attribution table so a profiler
        sample landing inside the block carries the phase, and, under a
        ``torch.profiler``, annotates the block ``kccap.<name>``."""
        if name not in _PHASE_SET:
            raise PhaseError(
                f"unknown phase {name!r} (vocabulary: {PHASES})"
            )
        ident = threading.get_ident()
        prev = _live_enter_phase(ident, name)
        rf = annotation(_ANNOTATIONS[name])
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if rf is not None:
                rf.__exit__(None, None, None)
            _live_exit_phase(ident, prev)
            self.record(name, dt)

    @contextmanager
    def live(self, name: str):
        """Publish ``name`` as the calling thread's live phase for the
        block WITHOUT timing or recording anything — for sites that
        measure with explicit ``perf_counter`` pairs and classify the
        window post hoc (the kernel wrappers' compile/device_exec
        split), so a profiler sample landing inside still carries a
        phase.  The accounting stays with the site's own ``record``
        calls; this is attribution only (and, under a profiler, the
        block's ``kccap.<phase>`` annotation)."""
        if name not in _PHASE_SET:
            raise PhaseError(
                f"unknown phase {name!r} (vocabulary: {PHASES})"
            )
        ident = threading.get_ident()
        prev = _live_enter_phase(ident, name)
        rf = annotation(_ANNOTATIONS[name])
        try:
            yield
        finally:
            if rf is not None:
                rf.__exit__(None, None, None)
            _live_exit_phase(ident, prev)

    def items(self) -> list[tuple[str, float]]:
        """``(phase, accumulated_seconds)`` pairs in vocabulary order
        (only phases actually recorded — an absent phase never emits a
        zero sample into the histograms)."""
        with self._lock:
            acc = dict(self._acc)
        return [(p, acc[p]) for p in PHASES if p in acc]

    def counts(self) -> dict[str, int]:
        """Recorded-interval count per phase (hammer-test surface)."""
        with self._lock:
            return dict(self._counts)

    def to_ms(self) -> dict[str, float]:
        """``{phase: milliseconds}`` rounded to µs — the compact form
        the flight recorder carries per record."""
        return {p: round(s * 1e3, 3) for p, s in self.items()}

    def total_s(self) -> float:
        """Sum of all recorded phases (reconciliation surface)."""
        with self._lock:
            return sum(self._acc.values())


def new_clock():
    """A fresh :class:`PhaseClock` — or :data:`NULL_CLOCK` when
    telemetry is off (``KCCAP_TELEMETRY=0`` means zero phase-clock
    allocations on the dispatch path, pinned by test)."""
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import enabled

    if not enabled():
        return NULL_CLOCK
    return PhaseClock()


_tls = threading.local()


def current():
    """The calling thread's active clock (``NULL_CLOCK`` when none) —
    what the deep instrumentation sites (devcache, batching, the kernel
    wrappers) consult without a threading-through parameter."""
    return getattr(_tls, "clock", None) or NULL_CLOCK


def activate(clock):
    """Install ``clock`` as this thread's active clock; returns the
    previous one for :func:`restore` (dispatchers nest — a reload op's
    internal work must not leak onto a stale clock)."""
    prev = getattr(_tls, "clock", None)
    _tls.clock = clock
    return prev


def restore(prev) -> None:
    """Undo :func:`activate` (pass its return value)."""
    _tls.clock = prev
