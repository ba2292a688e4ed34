"""Multi-endpoint capacity client: failover, hedging, monotonic reads.

Counterpart of ``kubernetesclustercapacity_tpu/service/replicaset.py``
(verbatim apart from imports).

A :class:`~.client.CapacityClient` talks to ONE server; this module
talks to the replicated serving plane (:mod:`.plane`): N endpoints —
typically one leader plus its replicas — behind one call surface.

* **Failover** — each endpoint has its own
  :class:`~..resilience.CircuitBreaker` and health state.  A transport
  failure, an open breaker, or a refuse-before-work error
  (:class:`~..resilience.RetryableElsewhere`: overloaded / draining /
  not-leader) moves the call to the next endpoint.  Refusals are safe
  to retry ANYWHERE — the server provably did no work — so even
  mutations fail over across refusals; a mutation whose transport died
  *mid-call* is never resent (at-most-once, same rule as the
  single-endpoint client).
* **Read-your-generation monotonicity** — every server reply envelope
  carries the generation that answered.  The set keeps a high-water
  mark per client session; an answer stamped OLDER than the watermark
  is discarded (the endpoint is marked stale and the call fails over)
  — a client that has seen generation G never regresses to a replica
  still serving G-1, no matter how routing lands.
* **Hedged reads** — optional, idempotent ops only (mutations are
  NEVER hedged).  If the primary attempt has not answered within the
  hedge delay — adaptive: the p95 of recent call latencies, clamped to
  ``[hedge_min_delay_s, hedge_max_delay_s]`` — a second attempt fires
  on the next healthy endpoint and the first verified answer wins.
  Tail latency becomes min(two samples) at the cost of bounded extra
  load.
* **Capability handshake** — :meth:`probe` reads each endpoint's
  ``info.capabilities``; plane-era features degrade cleanly against
  pre-plane servers (no generation watermark → monotonicity not
  enforced there; :meth:`drain_server` refuses locally instead of
  sending an op the server would not recognize).
"""

from __future__ import annotations

import queue as _queue
import threading
import time

from kubernetesclustercapacity_tpu_torch.resilience import (
    CircuitBreaker,
    CircuitOpenError,
    Deadline,
    DeadlineExpired,
    RetryableElsewhere,
    RetryPolicy,
)
from kubernetesclustercapacity_tpu_torch.service.client import (
    IDEMPOTENT_OPS,
    CapacityClient,
)

__all__ = ["ReplicaSet", "ReplicaSetError", "StaleReadError", "parse_endpoints"]


class ReplicaSetError(ConnectionError):
    """Every endpoint was tried and none produced a valid answer."""


class StaleReadError(RuntimeError):
    """Every reachable endpoint answered with a generation older than
    the session watermark — the set as a whole has regressed (e.g. the
    only fresh replica died).  Retrying later is reasonable; returning
    the stale answer would violate read-your-generation monotonicity,
    so it is never done."""


def parse_endpoints(spec) -> list[tuple[str, int]]:
    """``"h1:p1,h2:p2"`` / iterable of ``"h:p"`` / ``(h, p)`` pairs →
    endpoint list (the ``kccap -server`` flag grammar)."""
    if isinstance(spec, str):
        spec = [s for s in spec.split(",") if s.strip()]
    out: list[tuple[str, int]] = []
    for item in spec:
        if isinstance(item, str):
            host, _, port_s = item.strip().rpartition(":")
            if not host or not port_s.isdigit():
                raise ValueError(
                    f"bad endpoint {item!r} (want HOST:PORT)"
                )
            out.append((host, int(port_s)))
        else:
            host, port = item
            out.append((str(host), int(port)))
    if not out:
        raise ValueError("ReplicaSet needs at least one endpoint")
    return out


class _Endpoint:
    """One replica: its lazy client, breaker, and health bookkeeping.
    ``lock`` serializes use of the underlying single-connection client
    (concurrent ReplicaSet calls hedge across DIFFERENT endpoints, never
    share one socket)."""

    def __init__(self, addr: tuple[str, int], breaker: CircuitBreaker) -> None:
        self.addr = addr
        self.breaker = breaker
        self.lock = threading.Lock()
        self.client: CapacityClient | None = None
        self.stale = False
        self.draining = False
        # A federation endpoint reporting the set's queried cluster as
        # ``lost`` — demoted like a draining endpoint (it holds no
        # servable view of that cluster, not even a stale one) but still
        # tried last, since it may have resynced.
        self.lost = False
        self.role: str | None = None
        self.capabilities: dict = {}
        self.last_generation: int | None = None

    @property
    def name(self) -> str:
        return f"{self.addr[0]}:{self.addr[1]}"


class ReplicaSet:
    """Call the replicated serving plane as if it were one server.

    ``endpoints`` accepts the :func:`parse_endpoints` grammar.  Each
    call walks the healthy endpoints (sticky: the last endpoint that
    answered goes first) under an overall ``deadline_s`` budget;
    ``rounds`` bounds how many full passes over the set a call may make
    before giving up.  ``hedge=True`` arms hedged reads for idempotent
    ops.  Thread-safe: concurrent calls are serialized per endpoint,
    not per set.
    """

    def __init__(
        self,
        endpoints,
        *,
        token: str | None = None,
        tenant: str | None = None,
        tenant_token: str | None = None,
        deadline_s: float | None = None,
        connect_timeout_s: float = 5.0,
        timeout_s: float | None = 120.0,
        rounds: int = 3,
        retry_backoff: RetryPolicy | None = None,
        breaker_factory=None,
        hedge: bool = False,
        hedge_min_delay_s: float = 0.01,
        hedge_max_delay_s: float = 1.0,
        registry=None,
        trace: bool = False,
        trace_log=None,
        cluster: str | None = None,
    ) -> None:
        """``cluster`` names the federation cluster this set's queries
        concern (endpoints being ``kccap-fed`` servers): :meth:`probe`
        then demotes any endpoint whose federation status reports that
        cluster ``lost`` — the way it demotes a draining endpoint —
        and a typed ``cluster_lost`` refusal mid-call marks it the same
        way while the call retries elsewhere.

        ``tenant``/``tenant_token`` ride every per-endpoint client (see
        :class:`~.client.CapacityClient`).  A ``tenant_quota`` refusal
        is AUTHORITATIVE — every replica enforces the same map — so the
        set surfaces it immediately instead of failing over.

        ``trace_log`` (a path or :class:`~..telemetry.TraceLog`) records
        the set's own spans: one ``rs:{op}`` span per call, with one
        ``rs:attempt`` child per endpoint try carrying the endpoint,
        the hedge/winner flags, and the failover reason — the trace
        form of the failover story the metrics only count."""
        from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
            MetricsRegistry,
        )

        addrs = parse_endpoints(endpoints)
        if breaker_factory is None:
            def breaker_factory(addr):
                return CircuitBreaker(
                    failure_threshold=3,
                    recovery_timeout_s=1.0,
                    name=f"{addr[0]}:{addr[1]}",
                )
        self._endpoints = [_Endpoint(a, breaker_factory(a)) for a in addrs]
        self._token = token
        self._tenant = tenant
        self._tenant_token = tenant_token
        self._deadline_s = deadline_s
        self._connect_timeout = connect_timeout_s
        self._timeout = timeout_s
        self._rounds = max(1, int(rounds))
        self._backoff = (
            retry_backoff
            if retry_backoff is not None
            else RetryPolicy(max_attempts=1, base_delay_s=0.01,
                             max_delay_s=0.25)
        )
        self._hedge = bool(hedge)
        self._hedge_min = float(hedge_min_delay_s)
        self._hedge_max = float(hedge_max_delay_s)
        self._trace = bool(trace)
        if isinstance(trace_log, str):
            from kubernetesclustercapacity_tpu_torch.telemetry.tracing import (
                TraceLog,
            )

            trace_log = TraceLog(trace_log)
        self._trace_log = trace_log
        self._cluster = cluster
        self._lock = threading.Lock()
        self._watermark = 0
        #: Generation stamped on the last successful answer (None until
        #: one arrives) — the chaos suite joins answers to their oracle
        #: snapshot through it.
        self.last_generation: int | None = None
        self._preferred = 0
        self._latencies: list[float] = []  # bounded sample window
        self._closed = False
        self.registry = registry if registry is not None else MetricsRegistry()
        m = self.registry
        self._m_calls = m.counter(
            "kccap_replicaset_calls_total",
            "ReplicaSet calls issued, by op.",
            ("op",),
        )
        self._m_failover = m.counter(
            "kccap_replicaset_failovers_total",
            "Endpoint-to-endpoint failovers, by cause.",
            ("cause",),
        )
        self._m_hedges = m.counter(
            "kccap_replicaset_hedges_total",
            "Hedged (secondary) attempts launched.",
        )
        self._m_hedge_wins = m.counter(
            "kccap_replicaset_hedge_wins_total",
            "Calls won by the hedged attempt.",
        )
        self._m_stale = m.counter(
            "kccap_replicaset_stale_rejected_total",
            "Answers discarded for regressing the generation watermark.",
        )

    # -- introspection -----------------------------------------------------
    @property
    def watermark(self) -> int:
        """The highest generation this session has observed."""
        with self._lock:
            return self._watermark

    @property
    def endpoints(self) -> list[str]:
        return [ep.name for ep in self._endpoints]

    def stats(self) -> dict:
        with self._lock:
            watermark = self._watermark
        return {
            "watermark": watermark,
            "endpoints": [
                {
                    "endpoint": ep.name,
                    "breaker": ep.breaker.state,
                    "stale": ep.stale,
                    "draining": ep.draining,
                    "lost": ep.lost,
                    "role": ep.role,
                    "last_generation": ep.last_generation,
                }
                for ep in self._endpoints
            ],
            "hedge_delay_s": round(self._hedge_delay(), 6),
        }

    def probe(self, *, deadline_s: float = 2.0) -> list[dict]:
        """One ``info`` round over every endpoint: refresh role,
        draining, capability, and plane-staleness state (used by the
        rotation order and by feature gating).  Never raises — an
        unreachable endpoint is reported, not fatal."""
        out = []
        for ep in self._endpoints:
            entry: dict = {"endpoint": ep.name}
            try:
                info = self._call_endpoint(
                    ep, "info", {"plane": True},
                    Deadline.after(deadline_s),
                )
            except Exception as e:  # noqa: BLE001 - probe summarizes, never raises
                entry["error"] = f"{type(e).__name__}: {e}"
                out.append(entry)
                continue
            caps = info.get("capabilities") or {}
            plane = info.get("plane") or {}
            ep.capabilities = caps if isinstance(caps, dict) else {}
            ep.role = plane.get("role") if isinstance(plane, dict) else None
            ep.draining = bool(info.get("draining"))
            if isinstance(plane, dict) and plane.get("stale"):
                ep.stale = True
            # Federation endpoints: one reporting the set's queried
            # cluster as ``lost`` holds NO servable view of it — demote
            # it exactly like a draining endpoint (tried last, never
            # first) until a later probe sees the cluster resynced.
            fed = info.get("federation")
            cluster_state = None
            if self._cluster is not None and isinstance(fed, dict):
                cl = (fed.get("clusters") or {}).get(self._cluster)
                if isinstance(cl, dict):
                    cluster_state = cl.get("state")
                ep.lost = cluster_state == "lost"
            entry.update(
                capabilities=ep.capabilities,
                role=ep.role,
                draining=ep.draining,
                generation=ep.last_generation,
                **(
                    {"cluster_state": cluster_state}
                    if cluster_state is not None
                    else {}
                ),
            )
            out.append(entry)
        return out

    def capability(self, name: str) -> bool:
        """True when ANY probed endpoint advertises the capability
        (``probe()`` refreshes; unknown until then)."""
        return any(
            bool(ep.capabilities.get(name)) for ep in self._endpoints
        )

    # -- the call loop -----------------------------------------------------
    def call(self, op: str, deadline_s: float | None = None, **params):
        """Issue one op against the healthiest endpoint, failing over /
        hedging as configured.  Raises :class:`ReplicaSetError` when
        every endpoint fails, :class:`StaleReadError` when only
        watermark-regressing answers exist."""
        with self._lock:
            if self._closed:
                raise ReplicaSetError("ReplicaSet is closed")
        budget = self._deadline_s if deadline_s is None else deadline_s
        deadline = Deadline.after(budget) if budget is not None else None
        self._m_calls.labels(op=op).inc()
        hedgeable = self._hedge and op in IDEMPOTENT_OPS
        # Trace context: adopt the caller's (params carried a
        # trace_id) or originate one.  Every endpoint try below gets an
        # "rs:attempt" child span; the wire envelope each try sends
        # names THAT attempt as the server's parent, so failovers and
        # hedges become sibling subtrees under this call's span.
        rs_ctx = None
        caller_parent = params.get("parent_span_id")
        if not isinstance(caller_parent, str) or not caller_parent:
            caller_parent = None
        if self._trace_log is not None:
            from kubernetesclustercapacity_tpu_torch.telemetry import (
                tracectx as _tracectx,
            )

            rs_ctx = _tracectx.from_wire(params) or _tracectx.TraceContext()
            params = dict(params, trace_id=rs_ctx.trace_id)
        wall_call0 = time.time()
        t_call0 = time.perf_counter()
        call_error: str | None = None
        try:
            return self._call_loop(
                op, params, deadline, hedgeable, rs_ctx
            )
        except Exception as e:
            call_error = f"{type(e).__name__}: {e}"
            raise
        finally:
            if rs_ctx is not None:
                from kubernetesclustercapacity_tpu_torch.telemetry import (
                    tracectx as _tracectx,
                )

                _tracectx.span(
                    self._trace_log,
                    ts=time.time(),
                    start_ts=wall_call0,
                    trace_id=rs_ctx.trace_id,
                    span_id=rs_ctx.span_id,
                    **(
                        {"parent_span_id": caller_parent}
                        if caller_parent
                        else {}
                    ),
                    op=f"rs:{op}",
                    service="replicaset",
                    duration_ms=round(
                        (time.perf_counter() - t_call0) * 1e3, 3
                    ),
                    status="error" if call_error else "ok",
                    **({"error": call_error} if call_error else {}),
                )

    def _call_loop(self, op, params, deadline, hedgeable, rs_ctx):
        """The failover/hedging loop behind :meth:`call` (split out so
        the call span wraps every exit path exactly once)."""
        errors: list[str] = []
        stale_seen = 0
        prev_delay: float | None = None
        for round_i in range(self._rounds):
            for ep in self._rotation():
                if deadline is not None and deadline.expired():
                    raise DeadlineExpired(
                        f"deadline expired after {len(errors)} endpoint "
                        f"attempt(s) of {op!r}"
                        + (f"; last: {errors[-1]}" if errors else "")
                    )
                if not ep.breaker.allow():
                    errors.append(f"{ep.name}: breaker open")
                    self._m_failover.labels(cause="breaker_open").inc()
                    self._attempt_span(
                        rs_ctx, None, ep, time.time(), 0.0,
                        reason="breaker_open", error="breaker open",
                    )
                    continue
                att_id, att_params = self._attempt_params(rs_ctx, params)
                wall_att0 = time.time()
                t0 = time.perf_counter()
                try:
                    if hedgeable:
                        result, gen, won_by_hedge = self._attempt_hedged(
                            ep, op, params, deadline, rs_ctx
                        )
                        if won_by_hedge:
                            self._m_hedge_wins.inc()
                    else:
                        result = self._call_endpoint(
                            ep, op, att_params, deadline
                        )
                        self._note_latency(time.perf_counter() - t0)
                        gen = ep.last_generation
                        self._attempt_span(
                            rs_ctx, att_id, ep, wall_att0,
                            time.perf_counter() - t0, winner=True,
                        )
                except DeadlineExpired:
                    raise
                except RetryableElsewhere as e:
                    if e.wire_code == "tenant_quota":
                        # AUTHORITATIVE refusal: every replica enforces
                        # the same tenant map, so failing over would
                        # just spend the other replicas' admission
                        # budget re-refusing.  The quota error IS the
                        # answer — surface it.
                        raise
                    # The server refused before doing work: safe to try
                    # the next replica, mutations included.
                    errors.append(f"{ep.name}: {e}")
                    ep.draining = e.wire_code == "draining"
                    if e.wire_code == "cluster_lost":
                        # A federation endpoint with no view of the
                        # queried cluster: demote like draining.
                        ep.lost = True
                    self._m_failover.labels(cause=e.wire_code).inc()
                    if not hedgeable:  # hedged legs record their own
                        self._attempt_span(
                            rs_ctx, att_id, ep, wall_att0,
                            time.perf_counter() - t0,
                            reason=e.wire_code, error=str(e),
                        )
                    continue
                except CircuitOpenError as e:
                    errors.append(f"{ep.name}: {e}")
                    self._m_failover.labels(cause="breaker_open").inc()
                    if not hedgeable:
                        self._attempt_span(
                            rs_ctx, att_id, ep, wall_att0,
                            time.perf_counter() - t0,
                            reason="breaker_open", error=str(e),
                        )
                    continue
                except Exception as e:
                    transport = RetryPolicy.is_transport_error(e)
                    if not transport:
                        raise  # deterministic app error: the answer
                    ep.breaker.record_failure(f"{type(e).__name__}: {e}")
                    errors.append(f"{ep.name}: {type(e).__name__}: {e}")
                    self._m_failover.labels(cause="transport").inc()
                    if not hedgeable:
                        self._attempt_span(
                            rs_ctx, att_id, ep, wall_att0,
                            time.perf_counter() - t0,
                            reason="transport",
                            error=f"{type(e).__name__}: {e}",
                        )
                    if op not in IDEMPOTENT_OPS:
                        # The mutation may have executed before the
                        # transport died: at-most-once forbids resending
                        # it anywhere.
                        raise
                    continue
                ep.breaker.record_success()
                ok, verdict = self._advance_watermark(ep, gen)
                if ok:
                    with self._lock:
                        self._preferred = self._endpoints.index(ep)
                        if gen is not None:
                            self.last_generation = int(gen)
                    return result
                # Stale answer: discard, mark, move on.
                stale_seen += 1
                errors.append(f"{ep.name}: {verdict}")
                self._m_stale.inc()
                self._m_failover.labels(cause="stale").inc()
                self._attempt_span(
                    rs_ctx, None, ep, wall_att0, 0.0,
                    reason="stale", error=verdict,
                )
            if round_i + 1 < self._rounds:
                prev_delay = self._backoff.next_delay(prev_delay)
                if deadline is not None:
                    prev_delay = min(
                        prev_delay, max(deadline.remaining(), 0.0)
                    )
                time.sleep(prev_delay)
        if stale_seen:
            # Data WAS available — but only below the session watermark.
            # Refusing it is the monotonicity contract; say so instead
            # of a generic all-endpoints-failed error.
            raise StaleReadError(
                f"every reachable endpoint answered below watermark "
                f"{self.watermark} for {op!r}: {'; '.join(errors)}"
            )
        raise ReplicaSetError(
            f"all {len(self._endpoints)} endpoint(s) failed for {op!r} "
            f"after {len(errors)} attempt(s): {'; '.join(errors[-4:])}"
        )

    # -- attempt tracing ---------------------------------------------------
    def _attempt_params(self, rs_ctx, params):
        """``(attempt_span_id, params_for_the_wire)`` for one endpoint
        try: the envelope announces the ATTEMPT span as the server's
        parent (hops advanced), so each failover/hedge leg owns its own
        server-side subtree.  ``(None, params)`` untraced."""
        if rs_ctx is None:
            return None, params
        from kubernetesclustercapacity_tpu_torch.telemetry.tracing import (
            new_span_id,
        )

        att_id = new_span_id()
        wire = rs_ctx.to_wire()
        wire["parent_span_id"] = att_id
        return att_id, dict(params, **wire)

    def _attempt_span(
        self, rs_ctx, span_id, ep, start_ts, duration_s, *,
        hedge=False, winner=False, reason=None, error=None,
    ) -> None:
        """One "rs:attempt" child span under the call span: which
        endpoint, whether it was the hedged leg, whether it won the
        race, and — on failure — the failover cause (the same
        vocabulary as ``kccap_replicaset_failovers_total``)."""
        if rs_ctx is None or self._trace_log is None:
            return
        from kubernetesclustercapacity_tpu_torch.telemetry import (
            tracectx as _tracectx,
        )
        from kubernetesclustercapacity_tpu_torch.telemetry.tracing import (
            new_span_id,
        )

        _tracectx.span(
            self._trace_log,
            ts=time.time(),
            start_ts=start_ts,
            trace_id=rs_ctx.trace_id,
            span_id=span_id or new_span_id(),
            parent_span_id=rs_ctx.span_id,
            op="rs:attempt",
            service="replicaset",
            endpoint=ep.name,
            hedge=bool(hedge),
            winner=bool(winner),
            **({"failover_reason": reason} if reason else {}),
            duration_ms=round(duration_s * 1e3, 3),
            status="error" if (error or reason) else "ok",
            **({"error": error} if error else {}),
        )

    def _rotation(self) -> list[_Endpoint]:
        """Endpoints in try order: sticky-preferred first, then the
        rest; known-stale/draining/cluster-lost endpoints demoted to the
        back (still tried — they may have recovered, and a lone endpoint
        is better than none)."""
        with self._lock:
            start = self._preferred
        eps = self._endpoints
        ordered = [eps[(start + i) % len(eps)] for i in range(len(eps))]
        healthy = [
            ep for ep in ordered if not (ep.stale or ep.draining or ep.lost)
        ]
        demoted = [
            ep for ep in ordered if ep.stale or ep.draining or ep.lost
        ]
        return healthy + demoted

    def _client_for(self, ep: _Endpoint) -> CapacityClient:
        """The endpoint's lazy client (caller holds ``ep.lock``)."""
        if ep.client is None:
            ep.client = CapacityClient(
                ep.addr[0],
                ep.addr[1],
                token=self._token,
                tenant=self._tenant,
                tenant_token=self._tenant_token,
                connect_timeout_s=self._connect_timeout,
                timeout_s=self._timeout,
                # The set owns cross-endpoint retry; the per-endpoint
                # client must surface the FIRST transport failure so
                # failover is immediate, not after a local retry storm.
                retry=RetryPolicy(max_attempts=1),
                trace=self._trace,
            )
        return ep.client

    def _call_endpoint(self, ep: _Endpoint, op, params, deadline):
        """One op on one endpoint (its lock serializes the socket).
        Records the endpoint's reply generation on success."""
        with ep.lock:
            client = self._client_for(ep)
            result = client.call(
                op,
                deadline_s=(
                    max(deadline.remaining(), 0.001)
                    if deadline is not None
                    else None
                ),
                **params,
            )
            gen = client.last_generation
        if gen is not None:
            ep.last_generation = gen
        return result

    # -- hedging -----------------------------------------------------------
    def _hedge_delay(self) -> float:
        """p95 of the recent successful-call latencies, clamped — the
        'this attempt is taking suspiciously long' threshold."""
        with self._lock:
            samples = sorted(self._latencies)
        if len(samples) < 8:
            return self._hedge_max / 4
        idx = min(len(samples) - 1, int(0.95 * len(samples)))
        return min(self._hedge_max, max(self._hedge_min, samples[idx]))

    def _note_latency(self, seconds: float) -> None:
        with self._lock:
            self._latencies.append(seconds)
            if len(self._latencies) > 64:
                del self._latencies[0]

    def _attempt_hedged(
        self, primary: _Endpoint, op, params, deadline, rs_ctx=None
    ):
        """Primary attempt plus (after the hedge delay) one secondary on
        the next healthy endpoint; first answer wins.  Returns
        ``(result, generation, won_by_hedge)``; raises the primary's
        error when both fail.

        Each leg records its own "rs:attempt" span (``hedge`` flags the
        secondary); the race's winner — the first leg to SUCCEED, which
        is the leg whose answer the caller gets — carries ``winner:
        true``, so a hedged read always shows exactly two sibling
        attempt spans with one winner."""
        results: _queue.Queue = _queue.Queue()
        race_lock = threading.Lock()
        race = {"won": False}

        def attempt(ep: _Endpoint, tag: str) -> None:
            att_id = None
            wall0 = None
            t0 = None
            try:
                att_id, att_params = self._attempt_params(rs_ctx, params)
                wall0 = time.time()
                t0 = time.perf_counter()
                r = self._call_endpoint(ep, op, att_params, deadline)
                self._note_latency(time.perf_counter() - t0)
                with race_lock:
                    won = not race["won"]
                    race["won"] = True
                self._attempt_span(
                    rs_ctx, att_id, ep, wall0,
                    time.perf_counter() - t0,
                    hedge=tag == "hedge", winner=won,
                )
                results.put((tag, ep, r, None))
            except Exception as e:  # noqa: BLE001 - reported via the queue
                self._attempt_span(
                    rs_ctx, att_id, ep, wall0 or 0.0,
                    (time.perf_counter() - t0) if t0 is not None else 0.0,
                    hedge=tag == "hedge",
                    reason=(
                        "transport"
                        if RetryPolicy.is_transport_error(e)
                        else getattr(e, "wire_code", None)
                    ),
                    error=f"{type(e).__name__}: {e}",
                )
                # EVERY exit posts to the queue: a silently-dead attempt
                # would leave the hedged read blocked on results.get().
                results.put((tag, ep, None, e))

        t_primary = threading.Thread(
            target=attempt, args=(primary, "primary"), daemon=True
        )
        t_primary.start()
        delay = self._hedge_delay()
        if deadline is not None:
            delay = min(delay, max(deadline.remaining(), 0.0))
        try:
            tag, ep, result, err = results.get(timeout=delay)
        except _queue.Empty:
            secondary = self._hedge_candidate(primary)
            if secondary is None:
                tag, ep, result, err = results.get()
            else:
                self._m_hedges.inc()
                threading.Thread(
                    target=attempt, args=(secondary, "hedge"), daemon=True
                ).start()
                tag, ep, result, err = results.get()
                if err is not None:
                    # First finisher failed; give the other leg its
                    # chance before surfacing anything.
                    tag, ep, result, err = results.get()
        if err is not None:
            if isinstance(err, Exception):
                raise err
            raise ReplicaSetError(str(err))
        if ep is not primary:
            ep.breaker.record_success()
        return result, ep.last_generation, tag == "hedge"

    def _hedge_candidate(self, primary: _Endpoint) -> _Endpoint | None:
        for ep in self._rotation():
            if ep is primary:
                continue
            if ep.breaker.allow():
                return ep
        return None

    # -- monotonicity ------------------------------------------------------
    def _advance_watermark(self, ep: _Endpoint, gen) -> tuple[bool, str]:
        """Enforce read-your-generation: an answer older than the
        watermark is rejected (never returned).  Servers that stamp no
        generation (pre-plane) cannot be checked — degrade to
        best-effort, documented in the handshake contract."""
        if gen is None:
            return True, ""
        gen = int(gen)
        with self._lock:
            if gen < self._watermark:
                ep.stale = True
                return False, (
                    f"stale answer: generation {gen} < session "
                    f"watermark {self._watermark}"
                )
            self._watermark = gen
        ep.stale = False
        return True, ""

    # -- convenience wrappers (the single-client surface) ------------------
    def ping(self, **kw) -> str:
        return self.call("ping", **kw)

    def info(self, **kw) -> dict:
        return self.call("info", **kw)

    def fit(self, **flags) -> dict:
        return self.call("fit", **flags)

    def sweep(self, **params) -> dict:
        for key in ("cpu_request_milli", "mem_request_bytes", "replicas"):
            v = params.get(key)
            if v is not None and hasattr(v, "tolist"):
                params[key] = v.tolist()
        return self.call("sweep", **params)

    def explain(self, **flags) -> dict:
        return self.call("explain", **flags)

    def dump(self, **kw) -> dict:
        return self.call("dump", **kw)

    def update(self, events: list[dict], **kw) -> dict:
        """Mutation: routed with failover ONLY across refuse-before-work
        errors (draining / not-leader / overloaded); never hedged,
        never resent after a mid-call transport failure."""
        return self.call("update", events=events, **kw)

    def reload(self, path: str, **kw) -> dict:
        return self.call("reload", path=path, **kw)

    def drain_server(self, endpoint: str | None = None, **kw) -> dict:
        """Gracefully drain ONE endpoint (default: the first).  Checks
        the capability handshake first so a pre-plane server gets a
        clean local refusal instead of an unknown-op error."""
        targets = (
            [ep for ep in self._endpoints if ep.name == endpoint]
            if endpoint is not None
            else self._endpoints[:1]
        )
        if not targets:
            raise ValueError(f"unknown endpoint {endpoint!r}")
        ep = targets[0]
        if not ep.capabilities:
            # Capabilities unknown (never probed, or a pre-plane server
            # that advertises none): one info round settles it before we
            # risk an op the server may not recognize.
            try:
                info = self._call_endpoint(
                    ep, "info", {}, Deadline.after(5.0)
                )
                caps = info.get("capabilities")
                ep.capabilities = caps if isinstance(caps, dict) else {}
            except Exception:  # noqa: BLE001 - unreachable = not capable
                ep.capabilities = {}
        if not ep.capabilities.get("drain"):
            raise ReplicaSetError(
                f"{ep.name} does not advertise the drain capability "
                "(pre-plane server?)"
            )
        deadline = Deadline.after(
            kw.pop("deadline_s", None) or 30.0
        )
        result = self._call_endpoint(ep, "drain_server", kw, deadline)
        ep.draining = True
        return result

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Idempotent, thread-safe (same contract as the single
        client's close — pinned by test)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for ep in self._endpoints:
            with ep.lock:
                client, ep.client = ep.client, None
            if client is not None:
                client.close()

    def __enter__(self) -> "ReplicaSet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
