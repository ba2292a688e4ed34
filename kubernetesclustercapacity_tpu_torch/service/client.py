"""Python client for the capacity service (same protocol as the C++ CLI).

Hardened transport: connect/read timeouts, automatic reconnect, bounded
jittered retry of *idempotent* ops, optional per-call deadlines threaded
to the server, and an optional circuit breaker.  The retry boundary is
the op table below — ``update`` and ``reload`` mutate served state and
are NEVER auto-retried (a lost reply does not prove the op was lost:
the server may have executed it before the transport died).

==============  =======================================================
op              auto-retry on transport failure?
==============  =======================================================
ping, info      yes (read-only)
fit, sweep,     yes (pure queries against an immutable snapshot — a
sweep_multi,    duplicate execution returns the identical result;
place, drain,   ``car`` included: its Monte Carlo draw is seeded, so a
topology_spread, retry re-draws the identical samples)
plan, explain,
car
dump,           yes (read-only views of the flight recorder / capacity
timeline, slo   timeline / SLO burn rates; a retry re-reads the ring,
                which may have advanced — acceptable for a diagnostic
                surface)
drain_server    yes (graceful drain is idempotent BY CONTRACT: the
                second call returns the first drain's record)
update, reload  NO (state mutations; at-most-once from this client)
==============  =======================================================

Reply envelopes additionally carry ``generation`` (the snapshot
generation that answered — kept on :attr:`CapacityClient.last_generation`
for the plane's read-your-generation monotonicity) and, on refusals, a
``code`` (``overloaded`` / ``draining`` / ``not_leader``) that maps to
the typed :class:`~..resilience.RetryableElsewhere` exceptions — the
server provably did no work, so a multi-endpoint client retries
elsewhere; this client surfaces them unchanged.
"""

from __future__ import annotations

import socket
import threading
import time

from kubernetesclustercapacity_tpu_torch.resilience import (
    WIRE_CODES,
    CircuitBreaker,
    CircuitOpenError,
    Deadline,
    DeadlineExpired,
    RetryPolicy,
)
from kubernetesclustercapacity_tpu_torch.service import protocol

__all__ = ["CapacityClient", "IDEMPOTENT_OPS"]

#: Ops safe to re-send after a transport failure: they never mutate
#: served state (or, for drain_server, are idempotent by contract), so
#: duplicate execution is invisible.  Anything not in this set
#: (update/reload, future unknown ops) is at-most-once.
IDEMPOTENT_OPS = frozenset(
    {
        "ping", "info", "fit", "sweep", "sweep_multi", "place", "drain",
        "topology_spread", "plan", "explain", "car", "gang", "optimize",
        "forecast", "dump", "timeline", "slo", "drain_server",
        # Federation ops are pure reads over the federation tier's held
        # snapshots — a retry re-reads the fleet view, which may have
        # advanced; acceptable for the same reason dump/timeline are.
        "fed_status", "fed_sweep", "fed_rank", "spillover",
    }
)


class CapacityClient:
    """Connect once, issue many requests (context-manager friendly).

    ``retry`` (a :class:`~..resilience.RetryPolicy`) governs idempotent
    ops only; ``None`` disables auto-retry entirely.  ``deadline_s``
    sets a default per-call time budget, overridable per call
    (``client.fit(deadline_s=0.5)``); the absolute deadline rides the
    request so the server sheds it once expired.  ``breaker`` (a
    :class:`~..resilience.CircuitBreaker`) fail-fasts every call while
    open.  ``stats`` counts retries/reconnects/deadline hits for the
    ``info``-op style of observability — a dict view over the client's
    ``registry`` counters (default: a fresh private
    :class:`~..telemetry.MetricsRegistry`; pass a shared one to fold
    client transport health into a process scrape).  ``trace`` adds a
    fresh ``trace_id`` to every call (kept on :attr:`last_trace_id`) so
    client attempts correlate with server-side trace-log spans; an
    explicit ``trace_id=...`` per call always wins.

    ``trace_log`` (a path or :class:`~..telemetry.TraceLog`) records
    the client's side of every call as JSONL spans: one span per CALL
    plus one child span per transport ATTEMPT (attempt index, the
    backoff delay slept before it, status) — a retry storm is visible
    as a fan of attempt spans under one call, where a single call-level
    span would hide it entirely.
    """

    #: stats() keys → (metric name, help) — one table so the dict view
    #: and the registry can never drift.
    _STAT_METRICS = (
        ("calls", "kccap_client_calls_total", "Ops issued."),
        ("retries", "kccap_client_retries_total",
         "Transport-failure retries of idempotent ops."),
        ("reconnects", "kccap_client_reconnects_total",
         "Socket reconnects after teardown."),
        ("deadline_expired", "kccap_client_deadline_expired_total",
         "Calls abandoned because their budget ran out."),
        ("breaker_rejected", "kccap_client_breaker_rejected_total",
         "Calls refused fail-fast by an open circuit breaker."),
    )

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 7077,
        *,
        token: str | None = None,
        tenant: str | None = None,
        tenant_token: str | None = None,
        connect_timeout_s: float = 10.0,
        timeout_s: float | None = 120.0,
        retry: RetryPolicy | None = None,
        deadline_s: float | None = None,
        breaker: CircuitBreaker | None = None,
        registry=None,
        trace: bool = False,
        trace_log=None,
    ) -> None:
        """``tenant`` / ``tenant_token`` ride every call's envelope for
        multi-tenant servers (``kccap-server -tenants``): a per-tenant
        ``tenant_token`` both authenticates and attributes; a bare
        ``tenant`` is a label only (quota attribution without secrets).
        A per-tenant token may equally be passed as ``token=`` — the
        server derives identity from either field.  Both are ignored by
        tenantless servers, so a tenant-configured client stays
        compatible with old deployments.  Tenant-quota refusals raise
        :class:`~...resilience.TenantQuotaError` — authoritative (every
        replica enforces the same map): back off, don't fail over."""
        from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
            MetricsRegistry,
        )
        from kubernetesclustercapacity_tpu_torch.telemetry.tracing import TraceLog

        self._addr = (host, port)
        self._token = token
        self._tenant = tenant
        self._tenant_token = tenant_token
        self._connect_timeout = connect_timeout_s
        self._timeout = timeout_s
        self._retry = retry if retry is not None else RetryPolicy()
        self._deadline_s = deadline_s
        self._breaker = breaker
        # Guards the socket FIELD (swap in/out), not socket I/O: close()
        # must be idempotent and safe against a concurrent in-flight
        # call, which owns whatever socket object it already read.
        self._sock_lock = threading.Lock()
        self._sock: socket.socket | None = None
        #: Generation watermark from the last reply envelope (None until
        #: a reply carries one — pre-plane servers never stamp it).
        self.last_generation: int | None = None
        self.registry = registry if registry is not None else MetricsRegistry()
        self._m = {
            key: self.registry.counter(name, help_)
            for key, name, help_ in self._STAT_METRICS
        }
        if breaker is not None:
            # Callback gauge: reads the breaker's CURRENT state at
            # collection time (0 closed / 1 half-open / 2 open), so the
            # scrape can never show a stale transition.
            self.registry.gauge(
                "kccap_client_breaker_state",
                "Circuit breaker state (0=closed, 1=half_open, 2=open).",
            ).labels().set_function(
                lambda: {"closed": 0, "half_open": 1, "open": 2}.get(
                    breaker.state, -1
                )
            )
        self._trace = bool(trace)
        self._trace_log = (
            TraceLog(trace_log) if isinstance(trace_log, str) else trace_log
        )
        self.last_trace_id: str | None = None
        self._connect()  # fail fast, like the original one-shot client

    @property
    def stats(self) -> dict:
        """Transport-health counters (the historical dict shape), read
        straight from the registry — one source of truth."""
        return {key: int(c.value) for key, c in self._m.items()}

    def __enter__(self) -> "CapacityClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Idempotent and thread-safe: the socket is swapped out under
        the lock exactly once, so concurrent closers (or a close racing
        an in-flight call's teardown) each see a consistent field and
        ``socket.close`` is never double-invoked on a replaced socket."""
        with self._sock_lock:
            sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:  # already torn down by the peer: closed is closed
                pass

    # -- transport ---------------------------------------------------------
    def _connect(self) -> socket.socket:
        sock = socket.create_connection(
            self._addr, timeout=self._connect_timeout
        )
        sock.settimeout(self._timeout)
        with self._sock_lock:
            self._sock = sock
        return sock

    def _ensure_connected(self) -> socket.socket:
        with self._sock_lock:
            sock = self._sock
        if sock is None:
            self._m["reconnects"].inc()
            return self._connect()
        return sock

    def _attempt(self, msg: dict, deadline: Deadline | None):
        """One send/recv round trip.  Transport failures tear the socket
        down (the stream may be desynced mid-frame) so the next attempt
        reconnects cleanly."""
        if deadline is not None and deadline.expired():
            self._m["deadline_expired"].inc()
            raise DeadlineExpired(
                f"deadline expired before sending {msg.get('op')!r}"
            )
        sock = self._ensure_connected()
        if deadline is not None:
            # The read must give up when the budget does, even if the
            # configured read timeout is longer (or unset).
            remaining = max(deadline.remaining(), 0.001)
            sock.settimeout(
                remaining
                if self._timeout is None
                else min(self._timeout, remaining)
            )
        try:
            protocol.send_msg(sock, msg)
            resp = protocol.recv_msg(sock)
        except (protocol.ProtocolError, OSError):
            self.close()
            raise
        finally:
            if deadline is not None:
                try:
                    sock.settimeout(self._timeout)
                except OSError:
                    pass  # socket already torn down by close()
        if resp is None:
            self.close()
            raise protocol.ProtocolError("server closed connection")
        gen = resp.get("generation")
        if isinstance(gen, int) and not isinstance(gen, bool):
            # The reply's generation watermark (success or refusal) —
            # the plane client compares it across endpoints to enforce
            # read-your-generation monotonicity.
            self.last_generation = gen
        if not resp.get("ok"):
            err = resp.get("error", "unknown server error")
            cls = WIRE_CODES.get(resp.get("code"))
            if cls is not None:
                # Typed refusal (overloaded/draining/not_leader): the
                # server provably did no work — retryable elsewhere.
                raise cls(err)
            raise RuntimeError(err)
        return resp["result"]

    # -- the call loop -----------------------------------------------------
    def call(self, op: str, deadline_s: float | None = None, **params):
        """Issue one op.  ``deadline_s`` overrides the client default
        for this call only.  Idempotent ops retry transport failures
        under the retry policy (within the deadline); ``update`` /
        ``reload`` surface the first transport failure unchanged.  A
        ``trace_id=...`` param rides the envelope to the server's trace
        log; with ``trace=True`` one is generated per call (every retry
        attempt reuses it — the retries ARE the story a trace tells)."""
        if self._token is not None:
            params.setdefault("token", self._token)
        if self._tenant_token is not None:
            params.setdefault("tenant_token", self._tenant_token)
        if self._tenant is not None:
            params.setdefault("tenant", self._tenant)
        if self._trace and "trace_id" not in params:
            from kubernetesclustercapacity_tpu_torch.telemetry.tracing import (
                new_trace_id,
            )

            params["trace_id"] = new_trace_id()
        self.last_trace_id = params.get("trace_id", self.last_trace_id)
        budget = self._deadline_s if deadline_s is None else deadline_s
        deadline = Deadline.after(budget) if budget is not None else None
        msg = {"op": op, **params}
        if deadline is not None:
            msg["deadline"] = deadline.to_wire()
        retryable_op = op in IDEMPOTENT_OPS
        self._m["calls"].inc()
        call_span_id = None
        _new_span = None
        # A caller-supplied ``parent_span_id`` (the ReplicaSet's attempt
        # span, the fed's member span) becomes the CALL span's parent;
        # the envelope's own parent is rewritten per attempt below so
        # the server's request span hangs under the attempt that
        # actually reached it.
        caller_parent = params.get("parent_span_id")
        if not isinstance(caller_parent, str) or not caller_parent:
            caller_parent = None
        if self._trace_log is not None:
            from kubernetesclustercapacity_tpu_torch.telemetry.tracing import (
                new_span_id as _new_span,
            )

            call_span_id = _new_span()
        trace_id = params.get("trace_id") or ""
        t_call0 = time.perf_counter()
        wall_call0 = time.time()
        call_error: str | None = None
        prev_delay: float | None = None
        attempt = 0
        backoff_before = 0.0  # seconds slept before the CURRENT attempt
        try:
            while True:
                attempt += 1
                if self._breaker is not None and not self._breaker.allow():
                    self._m["breaker_rejected"].inc()
                    raise CircuitOpenError(
                        f"circuit breaker open for {self._addr[0]}:"
                        f"{self._addr[1]}"
                        + (
                            f" (last error: {self._breaker.last_error})"
                            if self._breaker.last_error
                            else ""
                        )
                    )
                attempt_span_id = None
                if _new_span is not None and trace_id:
                    # The server's request span parents to THIS attempt:
                    # retries (and the ReplicaSet's hedges) become
                    # sibling subtrees, each owning the server-side
                    # children of the wire call it actually made.
                    attempt_span_id = _new_span()
                    msg["parent_span_id"] = attempt_span_id
                    msg.setdefault("trace_hops", 1)
                t_attempt0 = time.perf_counter()
                wall_attempt0 = time.time()
                try:
                    result = self._attempt(msg, deadline)
                except Exception as e:
                    self._record_attempt_span(
                        op, trace_id, call_span_id, attempt,
                        backoff_before,
                        time.perf_counter() - t_attempt0,
                        error=f"{type(e).__name__}: {e}",
                        span_id=attempt_span_id,
                        start_ts=wall_attempt0,
                    )
                    transport = RetryPolicy.is_transport_error(e)
                    if transport and self._breaker is not None:
                        self._breaker.record_failure(
                            f"{type(e).__name__}: {e}"
                        )
                    if (
                        deadline is not None
                        and deadline.expired()
                        and transport
                    ):
                        # The budget, not the transport, is what gave
                        # out: surface that (retrying cannot un-spend
                        # it).
                        self._m["deadline_expired"].inc()
                        raise DeadlineExpired(
                            f"deadline expired after {attempt} attempt(s) "
                            f"of {op!r}; last transport error: "
                            f"{type(e).__name__}: {e}"
                        ) from e
                    if (
                        not transport  # app error/deadline: deterministic
                        or not retryable_op  # update/reload: at-most-once
                        or attempt >= self._retry.max_attempts
                    ):
                        raise
                    prev_delay = self._retry.next_delay(prev_delay)
                    if deadline is not None:
                        prev_delay = min(
                            prev_delay, max(deadline.remaining(), 0.0)
                        )
                    time.sleep(prev_delay)
                    backoff_before = prev_delay
                    self._m["retries"].inc()
                    continue
                self._record_attempt_span(
                    op, trace_id, call_span_id, attempt, backoff_before,
                    time.perf_counter() - t_attempt0, error=None,
                    span_id=attempt_span_id, start_ts=wall_attempt0,
                )
                if self._breaker is not None:
                    self._breaker.record_success()
                return result
        except Exception as e:
            call_error = f"{type(e).__name__}: {e}"
            raise
        finally:
            self._record_call_span(
                op, trace_id, call_span_id, attempt,
                time.perf_counter() - t_call0, call_error,
                parent_span_id=caller_parent, start_ts=wall_call0,
            )

    def _record_attempt_span(
        self, op, trace_id, call_span_id, attempt, backoff_s, duration_s,
        *, error, span_id=None, start_ts=None,
    ) -> None:
        """One child span per transport attempt (parent: the call span)
        — the satellite that makes retry storms visible: attempt index,
        the backoff slept before this attempt, and what failed.
        ``span_id`` is the id the attempt's wire envelope already
        announced as the server's parent (minted up front), so the
        server's request span hangs under this one.  Spans are
        observability: they never fail the call they observe."""
        if self._trace_log is None:
            return
        from kubernetesclustercapacity_tpu_torch.telemetry.tracing import (
            new_span_id,
        )

        try:
            self._trace_log.record(
                ts=time.time(),
                **({"start_ts": start_ts} if start_ts is not None else {}),
                trace_id=trace_id,
                span_id=span_id or new_span_id(),
                parent_span_id=call_span_id,
                op=f"{op}:attempt",
                service="client",
                attempt=attempt,
                backoff_ms=round(backoff_s * 1e3, 3),
                duration_ms=round(duration_s * 1e3, 3),
                status="error" if error else "ok",
                **({"error": error} if error else {}),
            )
        except Exception:  # noqa: BLE001 - tracing must not fail calls
            pass

    def _record_call_span(
        self, op, trace_id, call_span_id, attempts, duration_s, error,
        parent_span_id=None, start_ts=None,
    ) -> None:
        """The call-level span the attempt spans parent to (its
        ``attempts`` field is the retry count at a glance).
        ``parent_span_id`` links it under the caller's own span when
        one rode in on the params (ReplicaSet attempt, fed member)."""
        if self._trace_log is None:
            return
        try:
            self._trace_log.record(
                ts=time.time(),
                **({"start_ts": start_ts} if start_ts is not None else {}),
                trace_id=trace_id,
                span_id=call_span_id,
                **(
                    {"parent_span_id": parent_span_id}
                    if parent_span_id
                    else {}
                ),
                op=f"client:{op}",
                service="client",
                attempts=attempts,
                duration_ms=round(duration_s * 1e3, 3),
                status="error" if error else "ok",
                **({"error": error} if error else {}),
            )
        except Exception:  # noqa: BLE001 - tracing must not fail calls
            pass

    # Convenience wrappers -------------------------------------------------
    # (each forwards **kwargs through ``call``, so every wrapper accepts
    # a per-call ``deadline_s=...`` override for free)
    def ping(self, **kw) -> str:
        return self.call("ping", **kw)

    def info(self, **kw) -> dict:
        return self.call("info", **kw)

    def fit(self, **flags) -> dict:
        return self.call("fit", **flags)

    def sweep(self, **params) -> dict:
        """Grid sweep.  Scenario arrays may be numpy (coerced to JSON
        lists here, so ScenarioGrid columns pass straight through)."""
        for key in ("cpu_request_milli", "mem_request_bytes", "replicas"):
            v = params.get(key)
            if v is not None and hasattr(v, "tolist"):
                params[key] = v.tolist()
        return self.call("sweep", **params)

    def sweep_multi(self, resources, requests, **params) -> dict:
        """R-resource grid sweep: ``resources`` row names, ``requests``
        an ``[S][R]`` matrix in each resource's native unit."""
        return self.call(
            "sweep_multi",
            resources=list(resources),
            requests=[list(map(int, row)) for row in requests],
            **params,
        )

    def reload(self, path: str, **params) -> dict:
        return self.call("reload", path=path, **params)

    def update(self, events: list[dict], **kw) -> dict:
        """Apply watch-style node/pod events to the served snapshot."""
        return self.call("update", events=events, **kw)

    def place(self, **flags) -> dict:
        """Simulate where each replica lands (greedy scheduler)."""
        return self.call("place", **flags)

    def drain(self, node: str, **flags) -> dict:
        """Simulate draining a node: a rehoming target per evicted pod."""
        return self.call("drain", node=node, **flags)

    def topology_spread(self, topology_key: str, **flags) -> dict:
        """Capacity under a maxSkew topology spread constraint."""
        return self.call("topology_spread", topology_key=topology_key, **flags)

    def plan(
        self,
        node_template: dict | None = None,
        *,
        catalog=None,
        **flags,
    ) -> dict:
        """Scale-up plan.  With ``catalog`` (a node-shape list/mapping
        plus ``usage`` and optional ``target``/``quantile``/``drain``),
        runs the certified shape planner — cheapest catalog purchase
        restoring the quantile capacity, with LP bound and cannot-lie
        certification.  With ``node_template``, the legacy homogeneous
        ``nodes_needed`` count.  Exactly one of the two is required."""
        if (node_template is None) == (catalog is None):
            raise TypeError(
                "plan() wants exactly one of node_template= or catalog="
            )
        if catalog is not None:
            flags["catalog"] = catalog
        else:
            flags["node_template"] = node_template
        return self.call("plan", **flags)

    def explain(self, **flags) -> dict:
        """Why the fit stops where it does: binding constraint per node,
        binding histogram, saturation summary, marginal (+1) analysis."""
        return self.call("explain", **flags)

    def car(self, usage: dict | None = None, **params) -> dict:
        """Capacity-at-risk.  With ``usage`` (per-pod distribution
        block ``{"cpu": {...}, "memory": {...}}`` plus optional
        ``replicas``/``samples``/``seed``/``quantiles``), evaluates the
        stochastic spec against the served snapshot and returns the
        capacity quantiles, mean, probability-of-fit, and per-quantile
        binding attribution — seed-deterministic, so a transport retry
        re-draws the identical samples.  Without ``usage``, returns the
        server's quantile-watch status (last quantile capacities and
        alert states)."""
        if usage is not None:
            params["usage"] = usage
        return self.call("car", **params)

    def forecast(self, usage: dict | None = None, **params) -> dict:
        """Capacity forecast.  With ``usage`` (the capacity-at-risk
        distribution block) plus ``steps``/``step_s`` and an explicit
        ``growth={"cpu_per_s": ..., "memory_per_s": ...}`` relative-
        rate block, projects the capacity quantiles over the horizon
        and returns per-step ladders plus ``time_to_breach_s`` —
        seed-deterministic and a pure function of the served snapshot,
        so transport retries (and audit replays) re-answer
        identically.  Without ``usage``, returns the server's forecast-
        watch status (projected minima, time to breach, alert
        states)."""
        if usage is not None:
            params["usage"] = usage
        return self.call("forecast", **params)

    def gang(self, ranks: int | None = None, **params) -> dict:
        """Gang capacity.  With ``ranks`` (plus the six per-rank flag
        fields or scenario arrays, and optional ``count``/``colocate``/
        ``spread_level``/``max_ranks_per_domain``/
        ``anti_affinity_host``), evaluates whole-gang capacity against
        the served snapshot — all-or-nothing groups of co-scheduled
        ranks under the topology hierarchy, with the binding-level
        explanation on single-scenario requests.  Without ``ranks``,
        returns the server's gang-watch status (last whole-gang counts
        and alert states)."""
        if ranks is not None:
            # Passed verbatim: the server owns validation (its typed
            # errors are the contract the tests pin).
            params["ranks"] = ranks
        for key in ("cpu_request_milli", "mem_request_bytes", "replicas"):
            v = params.get(key)
            if v is not None and hasattr(v, "tolist"):
                params[key] = v.tolist()
        return self.call("gang", **params)

    def optimize(self, backend: str | None = None, **params) -> dict:
        """Optimization-based packing.  Takes the sweep grammar
        (scenario arrays or the six flag fields) plus optional
        ``backend`` (``"lp"`` — the certified LP solve with duality
        certificate, shadow prices, rounded integral packing and FFD
        baseline — or ``"ffd"`` for the bug-compatible first-fit
        reference alone), ``iters``/``tol`` solver knobs, and
        ``verify`` (re-check the rounded packing against the
        sequential oracle; default True).  Deterministic given the
        snapshot, so transport retries are safe; every answer is
        either certified or explicitly marked ``uncertified``."""
        if backend is not None:
            params["backend"] = backend
        for key in ("cpu_request_milli", "mem_request_bytes", "replicas"):
            v = params.get(key)
            if v is not None and hasattr(v, "tolist"):
                params[key] = v.tolist()
        return self.call("optimize", **params)

    def dump(self, op: str | None = None, status: str | None = None,
             limit: int | None = None, tenant: str | None = None,
             sampled: bool | None = None, **kw) -> dict:
        """The server's flight recorder: its last K dispatched requests.

        Filters apply SERVER-side: ``op`` keeps records of one op (sent
        as ``filter_op`` — the envelope's own ``op`` field names this
        request), ``status`` keeps ``"ok"``/``"error"`` records,
        ``tenant`` keeps one tenant's records (sent as
        ``filter_tenant`` — the envelope's own ``tenant`` field is this
        request's attribution), ``sampled`` keeps records by the tail
        sampler's verdict (``True`` = a retained trace tree backs the
        record, so ``kccap -trace-tree`` will find it), and ``limit``
        returns only the N most recent matches.
        """
        if op is not None:
            kw["filter_op"] = op
        if status is not None:
            kw["status"] = status
        if limit is not None:
            kw["limit"] = limit
        if tenant is not None:
            kw["filter_tenant"] = tenant
        if sampled is not None:
            kw["sampled"] = sampled
        return self.call("dump", **kw)

    def audit_status(self, **kw) -> dict:
        """The server's audit-log and shadow-oracle status (the
        ``info {audit: true}`` section): segment/record counts, last
        recorded generation, shadow checked/divergence counters and
        alert state.  ``{"enabled": false, ...}``-shaped when the
        server runs without ``-audit-dir``/``-shadow-sample-rate``."""
        return self.call("info", audit=True, **kw).get(
            "audit", {"enabled": False, "log": None, "shadow": None}
        )

    def drain_server(self, timeout_s: float | None = None, **kw) -> dict:
        """Gracefully drain the server: it stops accepting compute and
        mutation ops (refusing them with the retryable-elsewhere
        ``draining`` code), finishes in-flight work (bounded by
        ``timeout_s``), emits its final drain record, and deregisters
        from the plane.  Returns the drain record; idempotent — a
        repeat call returns the first record with ``already: true``."""
        if timeout_s is not None:
            kw["timeout_s"] = timeout_s
        return self.call("drain_server", **kw)

    # Federation surface (a kccap-fed endpoint; see federation/) -----------
    def fed_status(self, **kw) -> dict:
        """The federation tier's per-cluster degradation vector: every
        cluster's ``{generation, age_s, state: fresh|stale|lost}``,
        state counts, the stale/evict horizons, and the named exclusion
        list.  ``{"enabled": false, ...}``-shaped when the endpoint
        federates no clusters."""
        return self.call("fed_status", **kw)

    def fed_sweep(self, **params) -> dict:
        """Fleet-global sweep: grand totals over every non-lost cluster
        plus the per-cluster split, each reply annotated with the
        degradation vector (lost clusters are EXCLUDED from totals and
        named in ``excluded`` — never silently summed).  Accepts the
        sweep op's array grammar or the six reference flags."""
        for key in ("cpu_request_milli", "mem_request_bytes", "replicas"):
            v = params.get(key)
            if v is not None and hasattr(v, "tolist"):
                params[key] = v.tolist()
        return self.call("fed_sweep", **params)

    def fed_rank(self, **flags) -> dict:
        """Placement ranking per cluster for one scenario: fitting
        clusters first (cheapest first when a ``costs`` map is given,
        most headroom otherwise), lost clusters never ranked."""
        return self.call("fed_rank", **flags)

    def spillover(self, cluster: str, **flags) -> dict:
        """Drain-cluster what-if: where does cluster X's load land?
        Demand defaults to X's current pod count (override with
        ``demand=``); the rest of the fleet absorbs greedily, most
        headroom first.  A LOST X refuses with the typed
        ``cluster_lost`` code — its load is unknowable."""
        return self.call("spillover", cluster=cluster, **flags)

    def plane_status(self, **kw) -> dict | None:
        """The server's serving-plane section (``info {plane: true}``):
        leader fan-out stats or replica sync/staleness state; ``None``
        when the server is not part of a plane."""
        return self.call("info", plane=True, **kw).get("plane")

    def capabilities(self, **kw) -> dict:
        """The server's protocol feature handshake (``info`` →
        ``capabilities``).  Pre-plane servers advertise nothing — an
        empty dict, which feature gates treat as "assume not supported"
        (degrade, don't error)."""
        caps = self.call("info", **kw).get("capabilities")
        return caps if isinstance(caps, dict) else {}

    def slo_status(self, **kw) -> dict:
        """The server's SLO burn-rate status: every objective's
        short/long-window burn rate, alert state
        (ok/breached/recovered), and the fast-burning verdict.
        ``{"enabled": false}``-shaped when the server runs without
        ``-slo``."""
        return self.call("slo", **kw)

    def timeline(self, since_generation: int | None = None,
                 watch: str | None = None, **kw) -> dict:
        """The server's capacity timeline: per-generation watchlist
        capacities, attributed deltas (node-set diff + binding-constraint
        shift), and alert states.  ``since_generation`` returns only
        records/deltas strictly after that generation; ``watch`` narrows
        the per-watch sections to one name.  ``{"enabled": false}`` when
        the server runs without a timeline."""
        if since_generation is not None:
            kw["since_generation"] = since_generation
        if watch is not None:
            kw["watch"] = watch
        return self.call("timeline", **kw)
