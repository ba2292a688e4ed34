"""Resilience primitives shared by every network boundary.

The service stack has three places where a transient failure must not
become a wrong answer or a thundering herd: the client's socket (retry
idempotent ops with backoff, never retry mutations), the server's
dispatch (shed requests whose caller already gave up), and long-lived
degradation decisions (stop re-paying a deterministic failure on every
request).  This module is the ONE implementation of those three shapes —
:class:`RetryPolicy`, :class:`Deadline`, :class:`CircuitBreaker` — so
every caller backs off and trips the same way.  (The PyTorch port keeps
a host-only copy of the JAX package's module for its client and server;
its kernel dispatch has no breaker: a failed build or launch raises.)

Backoff is exponential with *decorrelated jitter* (the AWS architecture
blog's variant): each delay is drawn uniformly from ``[base, prev * 3]``
and capped, so a fleet of clients re-syncing after a shared outage
spreads out instead of stampeding in lockstep — the failure mode
constraint-packing services hit when many frontends relist against one
scheduler endpoint.
"""

from __future__ import annotations

import random
import threading
import time

__all__ = [
    "RetryPolicy",
    "Deadline",
    "DeadlineExpired",
    "CircuitBreaker",
    "CircuitOpenError",
    "RetryableElsewhere",
    "OverloadedError",
    "DrainingError",
    "NotLeaderError",
    "ClusterLostError",
    "TenantQuotaError",
    "TokenBucket",
    "WIRE_CODES",
    "decorrelated_jitter",
]


class DeadlineExpired(TimeoutError):
    """The caller's time budget ran out before the operation completed."""


class CircuitOpenError(ConnectionError):
    """Fail-fast refusal: the breaker is open and the cooldown has not
    elapsed — the protected operation was not attempted at all."""


class RetryableElsewhere(RuntimeError):
    """The server REFUSED this request before doing any work on it.

    The defining property: the operation provably did not execute, so a
    retry — even of a mutation — cannot double-apply it.  A multi-
    endpoint client (:class:`~.service.replicaset.ReplicaSet`) treats
    every subclass as "try the next replica"; a single-endpoint client
    surfaces it unchanged (retrying the same refusing server would just
    add load to whatever made it refuse).  Deliberately NOT an
    ``OSError``/``ConnectionError`` subclass: the transport worked fine,
    so :meth:`RetryPolicy.is_transport_error` must not classify it as a
    broken socket and re-send on the same connection.

    ``wire_code`` is the machine-readable refusal class the server
    stamps into the error envelope (``{"ok": false, "code": ...}``) so
    clients dispatch on a stable token, never on error prose.
    """

    wire_code = "refused"


class OverloadedError(RetryableElsewhere):
    """503-style admission refusal: the server's admission controller
    (concurrency limit or rps token bucket) shed the request before any
    dispatch work."""

    wire_code = "overloaded"


class DrainingError(RetryableElsewhere):
    """The server is draining (SIGTERM / ``drain_server`` op): it is
    finishing in-flight work but accepting no new compute or mutation
    requests.  Route to another replica."""

    wire_code = "draining"


class NotLeaderError(RetryableElsewhere):
    """A mutation (``update``/``reload``) reached a plane REPLICA, which
    serves a read-only view of the leader's snapshot stream.  Route the
    mutation to the leader."""

    wire_code = "not_leader"


class ClusterLostError(RetryableElsewhere):
    """A federation endpoint reports the queried cluster as ``lost``:
    its stream has been silent past the eviction horizon, so this
    endpoint holds no servable view of it — not even an explicitly-stale
    one.  The refusal happened before any work, so another federation
    endpoint (which may still hold a within-horizon view) is safe to
    try; multi-endpoint clients demote the refusing endpoint the way
    they demote a draining one."""

    wire_code = "cluster_lost"


class TenantQuotaError(RetryableElsewhere):
    """The calling tenant exceeded ITS OWN quota (per-tenant rps cap or
    concurrency share) at admission.  The refusal happened before any
    work — but unlike ``overloaded`` it is AUTHORITATIVE, not a symptom
    of one hot replica: every replica enforces the same quota map, so a
    multi-endpoint client must NOT fail over (it would just burn the
    other replicas' admission budget re-refusing the same tenant).
    Back off and retry later, or shed load at the source."""

    wire_code = "tenant_quota"


#: wire code → exception class, for the client side of the envelope.
WIRE_CODES = {
    cls.wire_code: cls
    for cls in (RetryableElsewhere, OverloadedError, DrainingError,
                NotLeaderError, ClusterLostError, TenantQuotaError)
}


def decorrelated_jitter(
    rng: random.Random, base: float, prev: float | None, cap: float
) -> float:
    """One step of capped decorrelated-jitter backoff.

    ``prev=None`` (first failure) yields a delay in ``[base, base * 3]``;
    afterwards ``[base, prev * 3]``, always clamped to ``[base, cap]``.
    """
    upper = max(base, (base if prev is None else prev) * 3.0)
    return min(cap, rng.uniform(base, upper))


class RetryPolicy:
    """Bounded retries with capped decorrelated-jitter backoff.

    Pure decision object: it computes delays and classifies errors but
    never sleeps or catches anything itself, so callers keep control of
    their deadline accounting (see :meth:`CapacityClient.call
    <..service.client.CapacityClient.call>`).  Thread-safe: concurrent
    callers share the seeded RNG under a lock.
    """

    #: Error families that indicate a broken transport (worth a retry on
    #: an idempotent op) rather than a deterministic application error.
    TRANSPORT_ERRORS: tuple[type[BaseException], ...] = (OSError,)

    def __init__(
        self,
        *,
        max_attempts: int = 3,
        base_delay_s: float = 0.05,
        max_delay_s: float = 2.0,
        seed: int | None = None,
    ) -> None:
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        if base_delay_s <= 0 or max_delay_s < base_delay_s:
            raise ValueError(
                "need 0 < base_delay_s <= max_delay_s, got "
                f"{base_delay_s}/{max_delay_s}"
            )
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def next_delay(self, prev: float | None = None) -> float:
        """The delay before the next attempt, given the previous delay
        (``None`` for the first retry)."""
        with self._lock:
            return decorrelated_jitter(
                self._rng, self.base_delay_s, prev, self.max_delay_s
            )

    @staticmethod
    def is_transport_error(exc: BaseException) -> bool:
        """Retryable = the transport broke (socket/OS-level, or the
        protocol layer's framing error).  Application errors — the server
        answered ``ok: false`` — are deterministic and never retryable."""
        from kubernetesclustercapacity_tpu_torch.service.protocol import (
            ProtocolError,
        )

        if isinstance(exc, DeadlineExpired):
            # A spent budget is the CALLER's condition, not the wire's —
            # retrying cannot un-spend it (and TimeoutError would
            # otherwise ride the OSError branch).
            return False
        return isinstance(exc, (OSError, ProtocolError))


class Deadline:
    """An absolute time budget, threaded through protocol messages.

    Carried on the wire as an absolute unix timestamp (``time.time()``
    epoch seconds) so the server can shed requests whose caller already
    gave up instead of burning a kernel dispatch on them.  Same-host
    deployments (the localhost-bench default) share a clock exactly;
    cross-host callers should keep budgets comfortably above their NTP
    skew — a shed is an *optimization*, the client's own budget check is
    authoritative either way.
    """

    __slots__ = ("_at",)

    def __init__(self, at: float) -> None:
        self._at = float(at)

    @classmethod
    def after(cls, timeout_s: float) -> "Deadline":
        """A deadline ``timeout_s`` seconds from now."""
        return cls(time.time() + float(timeout_s))

    @classmethod
    def from_wire(cls, value) -> "Deadline":
        """Parse the wire form (a JSON number); raises ValueError on
        anything else so a malformed field is a request error, not a
        silent no-deadline."""
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ValueError(
                f"deadline must be a unix timestamp number, got {value!r}"
            )
        return cls(float(value))

    def to_wire(self) -> float:
        return self._at

    def remaining(self) -> float:
        """Seconds left (negative once expired)."""
        return self._at - time.time()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def __repr__(self) -> str:  # debugging/log lines
        return f"Deadline(remaining={self.remaining():.3f}s)"


class CircuitBreaker:
    """Thread-safe closed / open / half-open circuit breaker.

    * **closed** — calls flow; ``failure_threshold`` *consecutive*
      failures trip it open.
    * **open** — :meth:`allow` refuses everything until
      ``recovery_timeout_s`` has elapsed.  ``recovery_timeout_s=None``
      means the breaker stays open until an explicit :meth:`reset` —
      the right shape for deterministic per-process failures like a
      kernel that will not compile on this chip.
    * **half-open** — after the cooldown, up to ``half_open_max_calls``
      probe calls are admitted; one success closes the breaker, one
      failure re-opens it (and restarts the cooldown).

    All transitions happen under one lock; ``clock`` is injectable for
    tests (monotonic seconds).  ``on_state_change(old, new)`` is an
    optional observer fired AFTER the lock is released on every state
    transition (telemetry counters hang here); a raising observer is
    swallowed, since a
    metrics hook must never change breaker behavior.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(
        self,
        *,
        failure_threshold: int = 5,
        recovery_timeout_s: float | None = 30.0,
        half_open_max_calls: int = 1,
        name: str = "",
        clock=time.monotonic,
        on_state_change=None,
    ) -> None:
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}"
            )
        if half_open_max_calls < 1:
            raise ValueError(
                f"half_open_max_calls must be >= 1, got {half_open_max_calls}"
            )
        self.name = name
        self._on_state_change = on_state_change
        self._threshold = int(failure_threshold)
        self._recovery = (
            None if recovery_timeout_s is None else float(recovery_timeout_s)
        )
        self._half_open_max = int(half_open_max_calls)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._opened_at: float | None = None
        self._half_open_inflight = 0
        self._last_error: str | None = None
        # Lifetime counters (monotonic; surfaced via snapshot()).
        self._trips = 0
        self._successes = 0
        self._failures = 0
        self._rejected = 0

    # -- decisions ---------------------------------------------------------
    def allow(self) -> bool:
        """May a call proceed right now?  (Open→half-open transitions
        happen here, when the cooldown elapses.)"""
        transition = None
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if (
                    self._recovery is not None
                    and self._opened_at is not None
                    and self._clock() - self._opened_at >= self._recovery
                ):
                    self._state = self.HALF_OPEN
                    self._half_open_inflight = 0
                    transition = (self.OPEN, self.HALF_OPEN)
                else:
                    self._rejected += 1
                    return False
            # HALF_OPEN: admit a bounded number of probes.
            if self._half_open_inflight < self._half_open_max:
                self._half_open_inflight += 1
                admitted = True
            else:
                self._rejected += 1
                admitted = False
        if transition is not None:
            self._notify(*transition)
        return admitted

    def call(self, fn, *args, **kwargs):
        """Run ``fn`` under the breaker: refuse with
        :class:`CircuitOpenError` when open, record the outcome
        otherwise.  Exceptions from ``fn`` count as failures and
        propagate unchanged."""
        if not self.allow():
            with self._lock:
                # Snapshot once, under the lock: two lock-free reads
                # could see different values (checked one error, printed
                # another) when a probe thread races record_success.
                last_error = self._last_error
            raise CircuitOpenError(
                f"circuit breaker {self.name or id(self)} is open"
                + (f" (last error: {last_error})" if last_error else "")
            )
        try:
            result = fn(*args, **kwargs)
        except Exception as e:
            self.record_failure(f"{type(e).__name__}: {e}")
            raise
        self.record_success()
        return result

    # -- outcomes ----------------------------------------------------------
    def record_success(self) -> None:
        transition = None
        with self._lock:
            self._successes += 1
            self._consecutive_failures = 0
            self._last_error = None
            if self._state == self.HALF_OPEN:
                # One healthy probe closes the circuit.
                self._state = self.CLOSED
                self._half_open_inflight = 0
                self._opened_at = None
                transition = (self.HALF_OPEN, self.CLOSED)
            elif self._state == self.OPEN:
                # A success recorded while open (caller raced the trip):
                # evidence the dependency works — close.
                self._state = self.CLOSED
                self._opened_at = None
                transition = (self.OPEN, self.CLOSED)
        if transition is not None:
            self._notify(*transition)

    def record_failure(self, error: str | None = None) -> None:
        transition = None
        with self._lock:
            self._failures += 1
            self._consecutive_failures += 1
            if error is not None:
                self._last_error = error
            if self._state == self.HALF_OPEN:
                # The probe failed: straight back to open, cooldown restarts.
                transition = (self.HALF_OPEN, self.OPEN)
                self._trip_locked()
            elif (
                self._state == self.CLOSED
                and self._consecutive_failures >= self._threshold
            ):
                transition = (self.CLOSED, self.OPEN)
                self._trip_locked()
        if transition is not None:
            self._notify(*transition)

    def _trip_locked(self) -> None:
        self._state = self.OPEN
        self._opened_at = self._clock()
        self._half_open_inflight = 0
        self._trips += 1

    def _notify(self, old: str, new: str) -> None:
        """Fire the transition observer — outside the lock (it may take
        its own, e.g. a metrics registry's), never allowed to raise."""
        if self._on_state_change is None:
            return
        try:
            self._on_state_change(old, new)
        except Exception:  # noqa: BLE001 - observers must not change behavior
            pass

    def reset(self) -> None:
        """Force-close and clear the error (operator/tests re-arm)."""
        with self._lock:
            old = self._state
            self._state = self.CLOSED
            self._consecutive_failures = 0
            self._opened_at = None
            self._half_open_inflight = 0
            self._last_error = None
        if old != self.CLOSED:
            self._notify(old, self.CLOSED)

    # -- observability -----------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            # Report half-open once the cooldown has lapsed even if no
            # probe has arrived yet — observers see what the next call
            # would experience.
            if (
                self._state == self.OPEN
                and self._recovery is not None
                and self._opened_at is not None
                and self._clock() - self._opened_at >= self._recovery
            ):
                return self.HALF_OPEN
            return self._state

    @property
    def last_error(self) -> str | None:
        with self._lock:
            return self._last_error

    def snapshot(self) -> dict:
        """Counters for the ``info`` op / doctor: pure data, no locks
        held by the caller afterwards."""
        state = self.state  # takes the lock; computes lapsed-cooldown view
        with self._lock:
            return {
                "state": state,
                "consecutive_failures": self._consecutive_failures,
                "failures": self._failures,
                "successes": self._successes,
                "trips": self._trips,
                "rejected": self._rejected,
                "last_error": self._last_error,
            }


class TokenBucket:
    """Thread-safe token bucket: ``rate_per_s`` tokens/second of refill
    up to ``capacity`` (the burst bound), starting full.

    The rps half of server admission control: one :meth:`try_acquire`
    per request; a request that finds the bucket empty is shed with
    :class:`OverloadedError` instead of queued (the concurrency limiter
    owns the queue; stacking a second queue here would just hide the
    overload behind latency).  Non-blocking by design — the refill is
    computed lazily from the injectable monotonic ``clock``, so there is
    no filler thread to leak and the arithmetic is exactly testable
    against an offline oracle (``tests/test_plane.py`` pins it against
    a numpy recurrence).
    """

    def __init__(
        self,
        rate_per_s: float,
        capacity: float | None = None,
        *,
        clock=time.monotonic,
    ) -> None:
        if rate_per_s <= 0:
            raise ValueError(f"rate_per_s must be > 0, got {rate_per_s}")
        if capacity is None:
            capacity = max(float(rate_per_s), 1.0)
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.rate_per_s = float(rate_per_s)
        self.capacity = float(capacity)
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = self.capacity
        self._last = clock()

    def _refill_locked(self) -> None:
        now = self._clock()
        elapsed = now - self._last
        self._last = now
        if elapsed > 0:
            self._tokens = min(
                self.capacity, self._tokens + elapsed * self.rate_per_s
            )

    def try_acquire(self, tokens: float = 1.0) -> bool:
        """Take ``tokens`` if available right now; never blocks."""
        if tokens <= 0:
            raise ValueError(f"tokens must be > 0, got {tokens}")
        with self._lock:
            self._refill_locked()
            if self._tokens >= tokens:
                self._tokens -= tokens
                return True
            return False

    def available(self) -> float:
        """Current token count after refill (observability/tests)."""
        with self._lock:
            self._refill_locked()
            return self._tokens
