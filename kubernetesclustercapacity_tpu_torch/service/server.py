"""The capacity service on PyTorch / CUDA: a long-lived server that keeps
the snapshot on the card.

Counterpart of ``kubernetesclustercapacity_tpu/service/server.py``.  One
server serves one cluster snapshot (reloadable).  The snapshot's columns
stay device-resident between requests (:mod:`..devcache`), so a ``sweep``
costs one launch of kernel B1 (``csrc/sweep_fit.cu``) and a
``sweep_multi`` one launch of kernel B2 (``csrc/sweep_multi.cu``), behind
the same eligibility routing as the library.  Concurrent sweeps of one
generation fold into one launch (:mod:`.batching`).

Ported ops: ``ping``, ``info``, ``fit`` (with every ``PodSpec`` field,
``priority`` included), ``sweep`` (solo and folded, or with
``priorities``), ``sweep_multi``, ``explain``, the scheduler-fidelity ops
``place``, ``drain``, ``topology_spread`` and ``plan`` (its
``node_template`` form and its ``catalog`` form, the certified planner of
:mod:`..forecast.planner`), the stochastic ops ``car`` (capacity-at-risk)
and ``forecast`` (the horizon projection), ``gang`` (whole gangs over
the zone/rack/host hierarchy) and ``optimize`` (the certified LP packing,
or the first-fit baseline), ``reload``, ``update``
(watch-style events applied through :class:`..store.ClusterStore`) and
``drain_server``, and the operator's ops ``dump`` (the flight
recorder), ``timeline`` (the capacity timeline of ``-watch``) and ``slo``
(burn rates of ``-slo``), behind the auth token, the compute-slot bound
and deadline shedding.  ``car`` and ``forecast`` without a ``usage``
block, and ``gang`` without ``ranks`` (their watch-status forms), answer
from the timeline's quantile, forecast and gang watches.
``-follow`` keeps the served snapshot synced to a live cluster
(:class:`..follower.ClusterFollower` → :class:`.coalesce.
SnapshotCoalescer` → a publish that pre-stages the new generation on the
card).  Replies equal the JAX server's apart from kernel labels
(``cuda_``/``plain_``/``torch_int64`` for ``pallas_``/``xla_int64``) and
volatile fields (latencies, ids, ``eval_ms``).  ``-metrics-port`` serves
the registry as Prometheus text with ``/healthz``
(:func:`healthz_probes`).  ``-audit-dir`` and ``-shadow-sample-rate`` keep
the audit trail and the shadow oracle, ``-tenants`` and ``-admission-*``
attribute and gate requests, and ``-plane-port`` / ``-plane-leader`` make
the server a leader or a replica of the replicated serving plane.
``-profile-hz`` sets the sampling profiler's rate; it serves collapsed
flamegraphs at ``/debug/profile`` on the metrics port.  The
port has no fast-path breaker (a kernel that fails to build or launch
raises); ``info`` reports one that never opens, in the JAX snapshot's
shape, for clients that read it.

    python -m kubernetesclustercapacity_tpu_torch.service.server \\
        -snapshot tests/fixtures/kind-3node.json -port 7077 -device cpu
    python -m kubernetesclustercapacity_tpu_torch.service.server \\
        -follow -kubeconfig ~/.kube/config -port 7077
"""

from __future__ import annotations

import os
import socketserver
import threading
import time
from contextlib import ExitStack, contextmanager, nullcontext

import numpy as np

from kubernetesclustercapacity_tpu_torch import devcache as _devcache
from kubernetesclustercapacity_tpu_torch.masks import (
    implicit_taint_mask as _implicit_taint_mask,
)
from kubernetesclustercapacity_tpu_torch.report import (
    json_report,
    reference_report,
    table_report,
)
from kubernetesclustercapacity_tpu_torch.resilience import (
    CircuitBreaker,
    Deadline,
    DeadlineExpired,
    DrainingError,
    NotLeaderError,
)
from kubernetesclustercapacity_tpu_torch.scenario import (
    ScenarioError,
    ScenarioGrid,
    random_scenario_grid,
    scenario_from_flags,
)
from kubernetesclustercapacity_tpu_torch.service import protocol
from kubernetesclustercapacity_tpu_torch.snapshot import ClusterSnapshot
from kubernetesclustercapacity_tpu_torch.snapshot import (
    publish_group_metrics as _snapshot_publish_group_metrics,
)
from kubernetesclustercapacity_tpu_torch.sources import resolve_source
from kubernetesclustercapacity_tpu_torch.telemetry import (
    hostmem as _hostmem,
)
from kubernetesclustercapacity_tpu_torch.telemetry import (
    memledger as _memledger,
)
from kubernetesclustercapacity_tpu_torch.telemetry import phases as _phases
from kubernetesclustercapacity_tpu_torch.telemetry import (
    process as _process,
)
from kubernetesclustercapacity_tpu_torch.telemetry import (
    tracectx as _tracectx,
)

__all__ = [
    "CapacityServer",
    "UNPORTED_OPS",
    "follow_publisher",
    "healthz_probes",
    "main",
]

#: Ops of the protocol this server does not answer yet (each would get an
#: error reply saying so): none is left.
UNPORTED_OPS: frozenset = frozenset()

#: ``info``'s ``fast_path_breaker``: the port has no breaker (a failed
#: build or launch raises), so it reports one that is never used and so
#: never opens, in the JAX package's snapshot shape.
_NEVER_OPEN = CircuitBreaker(
    name="cuda_fused_sweep", failure_threshold=1, recovery_timeout_s=None
)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:  # one connection, many frames
        server: "CapacityServer" = self.server.capacity_server  # type: ignore[attr-defined]
        while True:
            try:
                body = protocol.recv_frame(self.request)
                if body is None:
                    return
                # The handler's own clock: decode and reply lie outside
                # the dispatch, so they are filed apart from its phases.
                clk = _phases.new_clock()
                with clk.phase("decode"):
                    msg = protocol.decode_frame(body)
            except (protocol.ProtocolError, OSError):
                # Mid-frame resets/aborts are routine client behavior, not
                # server errors — drop the connection quietly.
                return
            try:
                reply = {"ok": True, "result": server.dispatch(msg)}
            except Exception as e:  # noqa: BLE001 - service boundary
                reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                # Machine-readable refusal class (draining): clients
                # dispatch on this token, never on error prose.
                code = getattr(e, "wire_code", None)
                if isinstance(code, str):
                    reply["code"] = code
            # The generation watermark: every reply says WHICH snapshot
            # generation answered.  Same thread as the dispatch, so the
            # thread-local read is race-free.
            gen = server.last_dispatch_generation()
            if gen is not None:
                reply["generation"] = gen
            try:
                with clk.phase("reply"):
                    protocol.send_msg(self.request, reply)
            except OSError:
                return  # peer went away while we answered
            finally:
                server.observe_handler_phases(msg, clk)


class _ThreadingServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True

    # Track live per-connection sockets so shutdown can SEVER them: a
    # stopped server must look dead to connected clients, not keep
    # answering on old connections.
    def __init__(self, *args, **kwargs) -> None:
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        super().__init__(*args, **kwargs)

    def get_request(self):
        sock, addr = super().get_request()
        with self._conns_lock:
            self._conns.add(sock)
        return sock, addr

    def shutdown_request(self, request) -> None:
        with self._conns_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def close_all_connections(self) -> None:
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for sock in conns:
            try:
                sock.close()
            except OSError:
                pass


#: :func:`_lock_wait` with no clock: nothing to time.
_NO_WAIT = nullcontext(lambda: None)


def _lock_wait():
    """The request's ``lock_wait`` for the lock that follows in the same
    ``with`` statement: the block's first statement calls the yielded
    ``acquired()``, and an acquire that raises closes the phase on the
    way out.  The lock stays lexical at each site, where the
    lock-discipline rule reads which fields it guards."""
    clk = _phases.current()
    return _timed_wait(clk) if clk else _NO_WAIT


@contextmanager
def _timed_wait(clk):
    with ExitStack() as waiting:
        waiting.enter_context(clk.phase("lock_wait"))
        yield waiting.close


class CapacityServer:
    """Serve capacity queries for one snapshot over the framed-JSON protocol.

    Guardrails (all opt-in, preserving the localhost default):

    * ``auth_token`` — when set, every op except ``ping`` must carry a
      matching ``token`` field (compared constant-time); required before
      exposing the port beyond localhost, since ``reload`` mutates served
      state.
    * ``max_inflight`` — cap on concurrently-executing compute ops
      (fit/sweep/sweep_multi/explain); excess requests wait up to
      ``inflight_wait_s`` then fail with "server busy".
    * ``reload_roots`` — when non-empty, ``reload`` paths must resolve
      (symlinks followed) under one of these directories.

    ``registry`` is the metrics registry this server instruments (default
    a fresh private one).  ``trace_log`` (a path or
    :class:`~..telemetry.tracing.TraceLog`) records one JSONL span tree
    per dispatched request, kept or dropped by ``trace_sample``
    (``always | p99-breach | errors | rate:N``).  ``flight_records``
    sizes the ring of the last dispatched requests; ``flight_dump_path``
    appends it as JSONL whenever a dispatch raises.

    ``batch_window_ms`` arms micro-batching: concurrent sweeps and
    explains of one snapshot generation collect for up to this window
    (``batch_max`` requests at most) and dispatch as ONE launch, each
    response scattered back.  ``0`` dispatches every request solo.

    ``device`` is where the snapshot's tensors live and the kernels run:
    ``"cuda"`` (the default) raises at construction where there is no
    card; ``"cpu"`` runs the kernels' plain versions on the host.

    ``timeline`` (a :class:`~..timeline.history.CapacityTimeline`) is
    fed every generation this server publishes — construction,
    ``replace_snapshot`` (the coalescer's thread under ``-follow``, after
    the warm pre-stage), ``reload`` and ``update`` — and served by the
    ``timeline`` op and the watch-status forms of ``car``, ``forecast``
    and ``gang``.  ``request_log`` (a path or
    :class:`~..telemetry.tracing.TraceLog`) takes one JSON line per
    dispatched request.  ``slo`` (a :class:`~..telemetry.slo.SLOMonitor`)
    is served by the ``slo`` op.

    ``stats_source`` is an optional zero-arg callable returning a
    JSON-able dict (the ``-follow`` wiring passes the follower's
    :meth:`~..follower.ClusterFollower.stats`); it is surfaced under
    ``info.resilience.follower``.

    ``audit_log`` (an :class:`~..audit.AuditLog`) records every published
    generation and every answering or mutating request with its stripped
    args and result digest (flight records then carry an ``audit_ref``);
    ``shadow`` (an :class:`~..audit.ShadowSampler`) re-checks sampled
    sweep replies against the pure-Python oracle on its own thread.
    ``tenants`` (a :class:`~.tenancy.TenantMap`) attributes each request
    to a tenant (per-tenant token, then an explicit ``tenant`` label,
    else ``"default"``) for admission, metrics, logs, the audit trail and
    the flight recorder; ``admission`` (a
    :class:`~.plane.AdmissionController`) gates every compute op before
    any work and takes the certified shadow price of each ``lp``
    ``optimize``.  ``plane`` (a :class:`~.plane.PlanePublisher`) makes
    this server a plane leader: every published generation fans out to
    its replicas; a :class:`~.plane.PlaneSubscriber` makes a server a
    replica, which refuses mutations with the ``not_leader`` code.
    """

    def __init__(
        self,
        snapshot: ClusterSnapshot,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        fixture: dict | None = None,
        auth_token: str | None = None,
        max_inflight: int = 8,
        inflight_wait_s: float = 30.0,
        reload_roots: tuple[str, ...] = (),
        registry=None,
        trace_log=None,
        trace_sample: str = "always",
        flight_records: int = 256,
        flight_dump_path: str | None = None,
        batch_window_ms: float = 1.0,
        batch_max: int = 32,
        drain_timeout_s: float = 10.0,
        device="cuda",
        stats_source=None,
        timeline=None,
        request_log=None,
        slo=None,
        audit_log=None,
        shadow=None,
        admission=None,
        plane=None,
        tenants=None,
    ) -> None:
        from kubernetesclustercapacity_tpu_torch.telemetry.flightrec import (
            FlightRecorder,
        )
        from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
            SUB_MS_LATENCY_BUCKETS_S,
            MetricsRegistry,
        )
        from kubernetesclustercapacity_tpu_torch.telemetry.tracing import (
            TraceLog,
        )

        self._device = _devcache.resolve_device(device)
        self.snapshot = snapshot
        self.fixture = fixture
        self._stats_source = stats_source
        self.registry = registry if registry is not None else MetricsRegistry()
        self._trace_log = (
            TraceLog(trace_log) if isinstance(trace_log, str) else trace_log
        )
        self._request_log = (
            TraceLog(request_log)
            if isinstance(request_log, str)
            else request_log
        )
        self._timeline = timeline
        self._slo = slo
        self._audit = audit_log
        self._shadow = shadow
        self._admission = admission
        self._plane = plane
        self._plane_role = "leader" if plane is not None else None
        self._plane_stats_source = (
            plane.stats if plane is not None else None
        )
        self._drain_hooks: list = []
        # Graceful-drain state: _draining flips once and never back;
        # _active_gated counts in-flight drain-gated ops (compute +
        # mutations) so begin_drain can wait for quiesce.
        self._drain_timeout_s = float(drain_timeout_s)
        self._drain_cv = threading.Condition()
        self._draining = False
        self._active_gated = 0
        self._drain_lock = threading.Lock()
        self._drain_result: dict | None = None
        #: Optional observer fired (with the drain record) after a
        #: completed drain — ``main`` uses it to stop the serve loop.
        self.on_drained = None
        m = self.registry
        self._m_requests = m.counter(
            "kccap_requests_total", "Requests dispatched, by op.", ("op",)
        )
        self._m_errors = m.counter(
            "kccap_request_errors_total",
            "Requests that raised, by op and exception type.",
            ("op", "error"),
        )
        self._m_latency = m.histogram(
            "kccap_request_latency_seconds",
            "End-to-end dispatch latency, by op.",
            ("op",),
        )
        self._m_inflight = m.gauge(
            "kccap_requests_in_flight",
            "Requests currently being dispatched.",
        )
        self._m_slot_wait = m.gauge(
            "kccap_compute_slot_waiting",
            "Compute requests currently waiting for an inflight slot.",
        )
        self._m_shed = m.counter(
            "kccap_deadline_shed_total",
            "Requests shed because their deadline had already expired.",
        )
        self._m_draining = m.gauge(
            "kccap_server_draining",
            "1 while the server is draining (graceful shutdown), else 0.",
        )
        # Per-phase latency decomposition of every dispatched request
        # (telemetry/phases.py), on sub-millisecond buckets.
        self._m_phase = m.histogram(
            "kccap_phase_seconds",
            "Per-request phase latency decomposition, by op and phase.",
            ("op", "phase"),
            buckets=SUB_MS_LATENCY_BUCKETS_S,
        )
        # Tenancy: None is the exact tenantless dispatch path (no
        # attribution, no per-tenant metrics, unchanged record shapes).
        # Every label passes TenantMap.label(), so the cardinality is
        # bounded by the map (unmapped names fold to "other").
        self._tenants = tenants
        self._m_tenant_requests = None
        self._m_tenant_latency = None
        if tenants is not None:
            self._m_tenant_requests = m.counter(
                "kccap_tenant_requests_total",
                "Requests dispatched, by tenant (bounded: mapped names "
                "+ default + other).",
                ("tenant",),
            )
            self._m_tenant_latency = m.histogram(
                "kccap_tenant_request_latency_seconds",
                "End-to-end dispatch latency, by tenant (bounded "
                "cardinality; feeds per-tenant SLO specs).",
                ("tenant",),
            )
        self._flight = FlightRecorder(flight_records)
        self._flight_dump_path = flight_dump_path
        # Tail-based sampling: span ids are always minted; span bodies
        # route through the sampler, which keeps or drops each request's
        # whole tree once its latency and error are known.
        self._trace_sink = None
        if self._trace_log is not None:
            self._trace_sink = _tracectx.TailSampler(
                self._trace_log,
                trace_sample,
                latency=self._m_latency,
                registry=m,
            )
        self._batcher = None
        if batch_window_ms and batch_window_ms > 0:
            from kubernetesclustercapacity_tpu_torch.service.batching import (
                MicroBatcher,
            )

            fold_hook = None
            if self._tenants is not None:
                from kubernetesclustercapacity_tpu_torch.service import (
                    tenancy as _tenancy,
                )

                if _tenancy.enabled():
                    # Cross-tenant fold attribution: the batcher reports
                    # each multi-request launch's member tenants.
                    fold_hook = _tenancy.FoldAccounting(self._tenants, m)
            self._batcher = MicroBatcher(
                self._dispatch_sweep_batch,
                window_s=float(batch_window_ms) / 1e3,
                max_batch=batch_max,
                registry=m,
                trace_sink=self._trace_sink,
                fold_hook=fold_hook,
            )
        # Per-dispatch-thread context: the snapshot generation captured
        # under the dispatch lock, so replies and flight records say
        # which generation ANSWERED.
        self._dispatch_tls = threading.local()
        # Served-state generation: bumped on every snapshot swap
        # (reload, update, replace_snapshot).
        self._generation = 1
        self._store = None  # lazy ClusterStore, built on first update op
        self._fixture_dirty = False  # fixture lags the store until needed
        self._fixture_source = None  # lazy fixture provider (follower feed)
        self._ptable_cache = None  # (fixture, snapshot, PriorityTable)
        self._implicit_mask = _implicit_taint_mask(snapshot)
        self._auth_token = auth_token
        self._max_inflight = max(1, int(max_inflight))
        self._inflight = threading.Semaphore(self._max_inflight)
        self._inflight_wait_s = float(inflight_wait_s)
        self._reload_roots = tuple(
            os.path.realpath(r) for r in reload_roots
        )
        self._lock = threading.Lock()
        self._tcp = _ThreadingServer((host, port), _Handler)
        self._tcp.capacity_server = self  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None
        self._serving = False
        # Generation 1 is a generation too: the timeline's baseline
        # record, so the first publish already has something to diff
        # (and the audit log's first checkpoint).
        self._observe_timeline(snapshot, self._generation)
        self._audit_generation(snapshot, self._generation)

    @property
    def address(self) -> tuple[str, int]:
        return self._tcp.server_address  # type: ignore[return-value]

    @property
    def device(self):
        """The ``torch.device`` the snapshot's tensors live on."""
        return self._device

    @property
    def generation(self) -> int:
        """Monotonic served-snapshot generation (1 at construction)."""
        with self._lock:
            return self._generation

    @property
    def flight_recorder(self):
        """The server's request flight recorder (read-mostly surface)."""
        return self._flight

    @property
    def batching_stats(self) -> dict | None:
        """The micro-batcher's counters (None when batching is off)."""
        return self._batcher.stats if self._batcher is not None else None

    def tracing_stats(self) -> dict:
        """Distributed-tracing status (the ``info {tracing: true}``
        section): whether span recording is armed, the sampling policy,
        and the kept/dropped ledger."""
        out: dict = {
            "armed": self._trace_sink is not None,
            "request_log": self._request_log is not None,
        }
        if self._trace_sink is not None:
            out.update(self._trace_sink.stats())
        return out

    @property
    def timeline(self):
        """The capacity timeline this server feeds (``None`` unless
        configured)."""
        return self._timeline

    @property
    def draining(self) -> bool:
        """True once a graceful drain has begun (it never un-begins)."""
        with self._drain_cv:
            return self._draining

    def last_dispatch_generation(self) -> int | None:
        """The generation that answered the CURRENT thread's most recent
        dispatch (thread-local; the reply-envelope watermark)."""
        return getattr(self._dispatch_tls, "last_generation", None)

    def set_plane_role(self, role: str, stats_source=None) -> None:
        """Declare this server's plane membership (``"leader"`` /
        ``"replica"``).  A replica serves a read-only view — mutations
        are refused with the ``not_leader`` wire code.  ``stats_source``
        (zero-arg, JSON-able) feeds the ``info {plane: true}`` section."""
        if role not in ("leader", "replica"):
            raise ValueError(f"plane role must be leader/replica, got {role!r}")
        self._plane_role = role
        if stats_source is not None:
            self._plane_stats_source = stats_source

    def add_drain_hook(self, hook) -> None:
        """Register a zero-arg callable run at the START of a graceful
        drain (plane deregistration: the replica's subscriber stop).
        Best-effort, run in registration order."""
        self._drain_hooks.append(hook)

    def begin_drain(self, *, timeout_s=None, reason: str = "") -> dict:
        """Gracefully drain this server: stop accepting compute and
        mutation ops (refused with the ``draining`` wire code — retryable
        elsewhere), deregister from the plane (drain hooks and the
        leader's drain announcement), wait up to ``timeout_s`` for
        in-flight gated ops to finish, then write ONE drain record to the
        audit log and the request log and fire :attr:`on_drained`.

        Idempotent and thread-safe: the second and later callers get the
        first drain's record back with ``"already": true``.  Diagnostics
        (ping/info/dump) keep answering throughout.
        """
        timeout_s = (
            self._drain_timeout_s if timeout_s is None else float(timeout_s)
        )
        with self._drain_cv:
            inflight0 = self._active_gated
            self._draining = True
        self._m_draining.set(1)
        with self._drain_lock:
            if self._drain_result is not None:
                return {**self._drain_result, "already": True}
            for hook in list(self._drain_hooks):
                try:
                    hook()
                except Exception:  # noqa: BLE001 - hooks never block a drain
                    pass
            if self._plane is not None:
                try:
                    self._plane.announce_drain()
                except Exception:  # noqa: BLE001 - fan-out never blocks a drain
                    pass
            t0 = time.monotonic()
            with self._drain_cv:
                while self._active_gated > 0:
                    left = timeout_s - (time.monotonic() - t0)
                    if left <= 0:
                        break
                    self._drain_cv.wait(min(left, 0.1))
                remaining = self._active_gated
            waited = time.monotonic() - t0
            record = {
                "kind": "drain",
                "ts": time.time(),
                "reason": reason,
                "generation": self.generation,
                "inflight_at_start": inflight0,
                "inflight_remaining": remaining,
                "waited_s": round(waited, 3),
                "drained": remaining == 0,
            }
            # The final drain record, durable in the audit log and the
            # request log: this exit was intentional, and here is what it
            # waited for.
            if self._audit is not None:
                try:
                    self._audit.append_raw(record)
                except Exception:  # noqa: BLE001 - best-effort by contract
                    pass
            if self._request_log is not None:
                try:
                    self._request_log.record(**record)
                except Exception:  # noqa: BLE001 - best-effort by contract
                    pass
            self._drain_result = record
        if self.on_drained is not None:
            try:
                self.on_drained(record)
            except Exception:  # noqa: BLE001 - observers never fail a drain
                pass
        return dict(record)

    def _op_drain_server(self, msg: dict) -> dict:
        """Graceful drain over the wire (auth-gated like every mutation).
        ``timeout_s`` overrides the server's ``drain_timeout_s``; the
        reply is the drain record, sent after in-flight work finished
        (or the timeout lapsed)."""
        timeout = msg.get("timeout_s")
        if timeout is not None and (
            isinstance(timeout, bool) or not isinstance(timeout, (int, float))
        ):
            raise ValueError(
                f"timeout_s must be a number, got {timeout!r}"
            )
        reason = msg.get("reason")
        if reason is not None and not isinstance(reason, str):
            raise ValueError(f"reason must be a string, got {reason!r}")
        return self.begin_drain(
            timeout_s=timeout, reason=reason or "drain_server op"
        )

    def _observe_timeline(self, snapshot, generation: int) -> None:
        """Record one published generation in the timeline.  Best-effort
        by the JAX server's rule: a failed watchlist evaluation must never
        fail the publish it observes (the coalescer would treat that as a
        fatal publish error).  A missing generation in the timeline is
        how such a failure shows."""
        # Every publish path funnels here, so the node-shape-compression
        # gauges update on the same publisher thread.
        _snapshot_publish_group_metrics(snapshot)
        # Plane fan-out rides the same publisher thread, BEFORE the
        # timeline's O(N) watchlist evaluation: replicas hear about a
        # generation as early as possible, and a failed fan-out never
        # fails the swap it observes.
        if self._plane is not None:
            try:
                self._plane.publish(snapshot, generation)
            except Exception:  # noqa: BLE001 - fan-out never fails a swap
                pass
        if self._timeline is None:
            return
        try:
            self._timeline.observe(snapshot, generation)
        except Exception:  # noqa: BLE001 - observability never fails a swap
            pass

    def _audit_generation(self, snapshot, generation: int) -> None:
        """Record one published generation in the audit log.  Same
        best-effort contract as the timeline hook: auditing never fails
        the publish it records."""
        if self._audit is None:
            return
        try:
            self._audit.record_generation(snapshot, generation)
        except Exception:  # noqa: BLE001 - auditing never fails a swap
            pass

    # Ops worth a durable audit record: everything that answers from or
    # mutates served state.  Pure diagnostics (ping/info/dump/timeline)
    # would only bury the forensic record under its own readers.
    _AUDITED_OPS = frozenset(
        {
            "fit", "sweep", "sweep_multi", "place", "drain",
            "topology_spread", "plan", "explain", "car", "gang",
            "optimize", "forecast", "update", "reload",
        }
    )

    def _audit_request(
        self, msg, op_label, gen, error, result, tenant=None,
        trace_sampled=None,
    ):
        """One audit-log request record; returns its audit ref (or
        ``None``).  Best-effort: the audit trail observes dispatch, it
        never fails it.  When tenancy is armed the DERIVED tenant rides
        the stripped args (tokens never do), so a replay can filter one
        tenant's traffic.  ``trace_sampled`` is the tail sampler's
        verdict for this request (``None`` = no sampler)."""
        if self._audit is None or op_label not in self._AUDITED_OPS:
            return None
        from kubernetesclustercapacity_tpu_torch.audit.log import strip_args

        try:
            args = strip_args(msg)
            if tenant is not None:
                args = dict(args, tenant=tenant)
            return self._audit.record_request(
                op=op_label,
                args=args,
                generation=gen,
                status="error" if error else "ok",
                result=result,
                error=error,
                trace_sampled=trace_sampled,
            )
        except Exception:  # noqa: BLE001 - auditing never fails an op
            return None

    def _tenant_of(self, msg: dict) -> str:
        """Attribute one request to a tenant (tenancy armed only).  The
        dedicated ``tenant_token`` field wins, then the ``token`` field
        doubling as a per-tenant token, then an explicit ``tenant``
        label (trusted only as a LABEL — quotas, not secrets), then the
        ``"default"`` identity every tenantless client gets.
        Attribution never authenticates; `_dispatch_routed` does."""
        t = self._tenants.tenant_of(msg.get("tenant_token"))
        if t is None:
            t = self._tenants.tenant_of(msg.get("token"))
        if t is None:
            explicit = msg.get("tenant")
            if isinstance(explicit, str) and explicit:
                t = explicit
        return t or "default"

    def start(self) -> None:
        _process.annotate_collections()
        self._serving = True
        self._thread = threading.Thread(
            target=self._tcp.serve_forever, daemon=True
        )
        self._thread.start()
        _hostmem.milestone("served")

    def serve_forever(self) -> None:
        _process.annotate_collections()
        self._serving = True
        _hostmem.milestone("served")
        self._tcp.serve_forever()

    def shutdown(self) -> None:
        # socketserver.shutdown() handshakes with a running serve_forever
        # loop and would block forever without one.
        if self._serving:
            self._tcp.shutdown()
            self._serving = False
        self._tcp.server_close()
        # Sever live connections too: a shut-down server must be DEAD to
        # its connected clients, not keep answering on old sockets.
        self._tcp.close_all_connections()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- dispatch ----------------------------------------------------------
    def _check_deadline(self, msg: dict, *, shed: bool = True):
        """Parse the optional absolute ``deadline`` riding the request;
        raise :class:`~..resilience.DeadlineExpired` (→ a normal error
        response) when the caller's budget is already spent — never burn
        a kernel dispatch on an answer nobody is waiting for."""
        wire = msg.get("deadline")
        if wire is None:
            return None
        deadline = Deadline.from_wire(wire)  # ValueError on junk
        if shed and deadline.expired():
            self._m_shed.inc()
            raise DeadlineExpired(
                f"request deadline expired {-deadline.remaining():.3f}s "
                "ago; shedding without dispatch"
            )
        return deadline

    # Every op the protocol routes — the request-metrics label set.
    # Anything else is labeled "unknown" so a misbehaving client cannot
    # mint unbounded label cardinality through the op field.
    _KNOWN_OPS = frozenset(
        {
            "ping", "info", "fit", "sweep", "sweep_multi", "place",
            "drain", "topology_spread", "plan", "explain", "car",
            "gang", "optimize", "forecast", "dump", "timeline", "slo",
            "reload", "update", "drain_server",
        }
    )

    # The compute ops: bounded by the inflight slots (the JAX server's set:
    # ``forecast`` and ``optimize`` are drain-gated but take no slot there
    # either).
    _COMPUTE_OPS = frozenset({
        "fit", "sweep", "sweep_multi", "place", "drain", "topology_spread",
        "plan", "explain", "car", "gang",
    })

    # The ops admission control governs: everything that dispatches
    # device work.  Diagnostics (ping/info/dump/...) always pass — an
    # overloaded replica must still answer health probes.
    _ADMISSION_OPS = _COMPUTE_OPS | {"optimize", "forecast"}

    # The ops a graceful drain refuses and waits out: compute work plus
    # mutations.  ping/info/dump/timeline/slo stay answerable so load
    # balancers and operators can watch the drain; drain_server itself
    # must pass.
    _DRAIN_GATED_OPS = _ADMISSION_OPS | {"update", "reload"}

    def dispatch(self, msg: dict) -> dict | str:
        """Instrumented entry: count/time every request (by op), record a
        trace span when a log is wired, then route.  Every dispatch also
        activates a per-request :class:`~..telemetry.phases.PhaseClock`
        (thread-local, so the slot wait, the micro-batcher and the fetch
        attribute their sub-intervals to THIS request); the
        decomposition lands in ``kccap_phase_seconds{op,phase}``, as
        child spans of the request's trace span, and as the flight
        record's ``phases`` field.  With a ``request_log`` each request
        also writes one JSON line (op, trace_id, span_id, generation,
        latency, status); its ``span_id`` joins the line to the trace
        log's span."""
        op = msg.get("op")
        op_label = op if op in self._KNOWN_OPS else "unknown"
        trace_id = msg.get("trace_id")
        if trace_id is not None and not isinstance(trace_id, str):
            raise ValueError(
                f"trace_id must be a string, got {trace_id!r}"
            )
        trace_armed = (
            self._trace_sink is not None or self._request_log is not None
        )
        span_ctx = _tracectx.from_wire(msg) if trace_armed else None
        parent_span_id = msg.get("parent_span_id")
        if not isinstance(parent_span_id, str) or not parent_span_id:
            parent_span_id = None
        self._dispatch_tls.trace_ctx = (
            span_ctx if self._trace_sink is not None else None
        )
        wall0 = time.time()
        # Tenant attribution happens ONCE, up front, and rides the whole
        # dispatch: admission quotas, the micro-batcher (through the
        # dispatch TLS), per-tenant metrics, the request log, the audit
        # trail and the flight record.  None ⇔ tenancy off.
        tenant = self._tenant_of(msg) if self._tenants is not None else None
        self._dispatch_tls.tenant = tenant
        self._m_requests.labels(op=op_label).inc()
        if self._m_tenant_requests is not None:
            self._m_tenant_requests.labels(
                tenant=self._tenants.label(tenant)
            ).inc()
        self._m_inflight.inc()
        clk = _phases.new_clock()
        prev_clk = _phases.activate(clk)
        if clk:
            # Live (op, tenant) attribution for the sampling profiler: a
            # sample landing anywhere in this dispatch carries the op and
            # tenant; phase blocks add the third coordinate.
            _phases.live_set(op=op_label, tenant=tenant)
        t0 = time.perf_counter()
        error: str | None = None
        result = None
        release = None
        gated = False
        try:
            if op_label in self._DRAIN_GATED_OPS:
                with self._drain_cv:
                    draining = self._draining
                    if not draining:
                        self._active_gated += 1
                        gated = True
                if draining:
                    # Refused BEFORE any work: safe to retry elsewhere
                    # (the wire code says so), mutations included.
                    if self._admission is not None:
                        self._admission.count_shed(op_label, "draining")
                    raise DrainingError(
                        "server is draining; retry another replica"
                    )
            if (
                self._admission is not None
                and op_label in self._ADMISSION_OPS
            ):
                # Admission gates BEFORE routing: a shed request never
                # parses a grid, waits for a compute slot or touches the
                # device.
                release = self._admission.admit(
                    op_label,
                    self._check_deadline(msg, shed=False),
                    # optimize refreshes the shadow-price signal, so it
                    # is never gated by it (see AdmissionController).
                    priced=op_label != "optimize",
                    tenant=tenant,
                )
            result = self._dispatch_routed(msg)
            return result
        except Exception as e:
            self._m_errors.labels(op=op_label, error=type(e).__name__).inc()
            error = f"{type(e).__name__}: {e}"
            raise
        finally:
            if release is not None:
                release()
            if gated:
                with self._drain_cv:
                    self._active_gated -= 1
                    self._drain_cv.notify_all()
            if clk:
                _phases.live_clear()
            _phases.restore(prev_clk)
            dur = time.perf_counter() - t0
            self._m_inflight.dec()
            self._m_latency.labels(op=op_label).observe(
                dur,
                exemplar=(
                    span_ctx.trace_id if span_ctx is not None else None
                ),
            )
            self._dispatch_tls.tenant = None
            if self._m_tenant_latency is not None:
                self._m_tenant_latency.labels(
                    tenant=self._tenants.label(tenant)
                ).observe(dur)
            phase_items = clk.items() if clk else ()
            for ph, secs in phase_items:
                self._m_phase.labels(op=op_label, phase=ph).observe(secs)
            # The generation that ANSWERED (captured under the dispatch
            # lock); ops that never captured one (ping, shed requests)
            # fall back to the current generation.
            gen = getattr(self._dispatch_tls, "generation", None)
            self._dispatch_tls.generation = None
            gen = self.generation if gen is None else gen
            # Persisted for the reply envelope: the handler thread reads
            # it right after dispatch returns.
            self._dispatch_tls.last_generation = gen
            sampled = None
            if span_ctx is not None and self._trace_sink is not None:
                sampled = self._trace_sink.decide(
                    op_label, dur, error, forced=span_ctx.sampled
                )
            self._dispatch_tls.trace_ctx = None
            # One span id joins the trace-log span with the request-log
            # line; minted only when something records it.
            span_id = None
            if trace_armed:
                span_id = (
                    span_ctx.span_id
                    if span_ctx is not None
                    else _tracectx.new_span_id()
                )
            if self._trace_sink is not None:
                self._emit_spans(
                    span_ctx, span_id, parent_span_id, op_label, wall0,
                    dur, error, phase_items, sampled,
                )
            if self._request_log is not None:
                try:
                    self._request_log.record(
                        ts=time.time(),
                        op=op_label,
                        trace_id=trace_id or "",
                        span_id=span_id,
                        generation=gen,
                        latency_ms=round(dur * 1e3, 3),
                        status="error" if error else "ok",
                        **({"tenant": tenant} if tenant is not None else {}),
                        **({"error": error} if error else {}),
                    )
                except Exception:  # noqa: BLE001 - logging must not fail ops
                    pass
            audit_ref = self._audit_request(
                msg, op_label, gen, error, result, tenant=tenant,
                trace_sampled=sampled,
            )
            self._flight_record(
                msg, op_label, trace_id, dur, error, result, gen, audit_ref,
                phases=(clk.to_ms() if clk else None), tenant=tenant,
                trace_sampled=sampled,
            )

    def observe_handler_phases(self, msg, clk) -> None:
        """File a connection handler's own phases (``decode``,
        ``reply``) under the op label :meth:`dispatch` gave the request;
        they lie outside its clock, so its phases still sum to at most
        its latency."""
        if not clk:
            return
        op = msg.get("op") if isinstance(msg, dict) else None
        op_label = op if op in self._KNOWN_OPS else "unknown"
        for ph, secs in clk.items():
            self._m_phase.labels(op=op_label, phase=ph).observe(secs)

    def _emit_spans(self, span_ctx, span_id, parent_span_id, op_label,
                    wall0, dur, error, phase_items, sampled) -> None:
        """The request span and one child span per recorded phase, then
        the tail sampler's keep/drop of the request's tree."""
        trace = span_ctx.trace_id if span_ctx is not None else ""
        _tracectx.span(
            self._trace_sink,
            ts=time.time(),
            start_ts=wall0,
            trace_id=trace,
            span_id=span_id,
            **(
                {"parent_span_id": parent_span_id}
                if span_ctx is not None and parent_span_id
                else {}
            ),
            op=op_label,
            service="server",
            **({"hops": span_ctx.hops} if span_ctx else {}),
            duration_ms=round(dur * 1e3, 3),
            status="error" if error else "ok",
            **({"error": error} if error else {}),
        )
        for ph, secs in phase_items:
            _tracectx.span(
                self._trace_sink,
                ts=time.time(),
                trace_id=trace,
                span_id=_tracectx.new_span_id(),
                parent_span_id=span_id,
                op=f"phase:{ph}",
                phase=ph,
                service="server",
                duration_ms=round(secs * 1e3, 3),
                status="ok",
            )
        if span_ctx is not None:
            self._trace_sink.finish(span_ctx.trace_id, keep=bool(sampled))

    def _flight_record(
        self, msg, op_label, trace_id, dur, error, result, gen,
        audit_ref=None, phases=None, tenant=None, trace_sampled=None,
    ) -> None:
        """One flight-recorder entry per dispatch (the failing request
        included), then — on error, when configured — the whole ring
        dumped as JSONL.  Strictly best-effort: observability never
        fails the op it observes."""
        from kubernetesclustercapacity_tpu_torch.telemetry import flightrec

        try:
            self._flight.record(
                op=op_label,
                args_digest=flightrec.args_digest(msg),
                generation=gen,
                trace_id=(trace_id or "") if isinstance(trace_id, str) else "",
                latency_ms=dur * 1e3,
                status="error" if error else "ok",
                result_digest=(
                    "" if result is None else flightrec.result_digest(result)
                ),
                error=error,
                audit_ref=audit_ref,
                phases=phases,
                tenant=tenant or "",
                trace_sampled=trace_sampled,
            )
            if error and self._flight_dump_path:
                self._flight.dump_jsonl(self._flight_dump_path)
        except Exception:  # noqa: BLE001 - recorder must not fail ops
            pass

    def _dispatch_routed(self, msg: dict) -> dict | str:
        op = msg.get("op")
        deadline = self._check_deadline(msg)
        if op == "ping":
            return "pong"
        if self._auth_token is not None:
            import hmac

            token = msg.get("token")
            # Compare as bytes: compare_digest on str raises TypeError for
            # non-ASCII, which would lock out a correct non-ASCII token.
            ok = isinstance(token, str) and hmac.compare_digest(
                token.encode(), self._auth_token.encode()
            )
            if not ok and self._tenants is not None:
                # A mapped per-tenant token authenticates too (looked up
                # by SHA-256 digest, no data-dependent scan over secrets),
                # in the ``token`` field or the dedicated
                # ``tenant_token`` field.
                ok = (
                    self._tenants.tenant_of(token) is not None
                    or self._tenants.tenant_of(msg.get("tenant_token"))
                    is not None
                )
            if not ok:
                raise PermissionError("missing or invalid auth token")
        if op in UNPORTED_OPS:
            raise NotImplementedError(
                f"op {op!r} is not yet ported to the PyTorch package"
            )
        if op == "drain_server":
            return self._op_drain_server(msg)
        if op in self._COMPUTE_OPS:
            # Bounded concurrency for the compute ops; a request carrying
            # a deadline never waits past it for a slot.
            wait_s = self._inflight_wait_s
            if deadline is not None:
                wait_s = max(0.0, min(wait_s, deadline.remaining()))
            self._m_slot_wait.inc()
            clk = _phases.current()
            t0 = time.perf_counter() if clk else 0.0
            try:
                with clk.live("queue_wait"):
                    acquired = self._inflight.acquire(timeout=wait_s)
            finally:
                self._m_slot_wait.dec()
                if clk:
                    clk.record("queue_wait", time.perf_counter() - t0)
            if not acquired:
                raise RuntimeError(
                    f"server busy: {self._max_inflight} compute requests "
                    "already in flight"
                )
            try:
                # The slot wait may have consumed the caller's budget:
                # shed now rather than dispatch a kernel nobody awaits.
                self._check_deadline(msg)
                return self._dispatch_inner(op, msg)
            finally:
                self._inflight.release()
        return self._dispatch_inner(op, msg)

    def _dispatch_inner(self, op: str, msg: dict) -> dict | str:
        # Capture the (snapshot, fixture, mask) triple once under the lock
        # so a concurrent reload/update can never produce a torn read.  The
        # raw fixture is rebuilt from the store lazily — only when an op
        # actually consumes it, not on every watch-event batch.
        with _lock_wait() as acquired, self._lock:
            acquired()
            snap = self.snapshot
            self._dispatch_tls.generation = self._generation
            needs_fixture = (
                op == "drain"  # always reads per-pod requests
                # A sweep reads the fixture only on the priorities path
                # (strict-only; no point rematerializing for a request the
                # strict gate will refuse anyway).
                or (
                    op == "sweep"
                    and "priorities" in msg
                    and snap.semantics == "strict"
                )
                or (
                    op in ("fit", "place", "topology_spread", "plan")
                    and self._fit_consumes_fixture(msg, snap.semantics)
                )
            )
            if needs_fixture and self._fixture_dirty and self._store is not None:
                # Store-fed staleness rematerializes under the same lock
                # hold that captured the snapshot: exact pairing (the
                # fixture rebuilds from the state the snapshot came from).
                self.fixture = self._store.fixture_view()
                self._fixture_dirty = False
            # A dirty fixture is NEVER served: consumers see None (and
            # fall back to packed-array walks) rather than stale objects.
            fixture = None if self._fixture_dirty else self.fixture
            # Follower-fed publishes swap snapshots without a fixture;
            # pull one lazily — but only for consumers that correlate
            # fixture to snapshot BY NODE NAME (drain, anti-affinity, the
            # priority table), which tolerate the follower moving a little
            # ahead of the published snapshot.  The reference cpu
            # cross-check pairs fits to rows POSITIONALLY, so it keeps the
            # packed-array fallback.
            source = None
            if (
                needs_fixture
                and fixture is None
                and self._fixture_source is not None
                and (
                    op == "drain"
                    or "anti_affinity_labels" in msg
                    or "priority" in msg
                    or "priorities" in msg
                )
            ):
                source = self._fixture_source
            implicit_mask = self._implicit_mask
        if source is not None:
            # The O(N) deep copy runs OUTSIDE the dispatch lock (it also
            # takes the follower's lock — holding both would stall every
            # concurrent request AND watch-event application).
            fixture = source()
            with _lock_wait() as acquired, self._lock:
                acquired()
                if self.snapshot is snap and self.fixture is None:
                    self.fixture = fixture  # cache until the next publish
        if op == "info":
            return self._op_info(msg, snap)
        if op == "fit":
            return self._op_fit(msg, snap, fixture, implicit_mask)
        if op == "sweep":
            return self._op_sweep(msg, snap, implicit_mask, fixture)
        if op == "sweep_multi":
            return self._op_sweep_multi(msg, snap, implicit_mask)
        if op == "place":
            return self._op_place(msg, snap, fixture)
        if op == "drain":
            return self._op_drain(msg, snap, fixture)
        if op == "topology_spread":
            return self._op_topology_spread(msg, snap, fixture)
        if op == "plan":
            return self._op_plan(msg, snap, fixture, implicit_mask)
        if op == "explain":
            return self._op_explain(msg, snap, implicit_mask)
        if op == "car":
            return self._op_car(msg, snap, implicit_mask)
        if op == "forecast":
            return self._op_forecast(msg, snap, implicit_mask)
        if op == "gang":
            return self._op_gang(msg, snap, implicit_mask)
        if op == "optimize":
            return self._op_optimize(msg, snap, implicit_mask)
        if op == "dump":
            return self._op_dump(msg)
        if op == "timeline":
            return self._op_timeline(msg)
        if op == "slo":
            return self._op_slo(msg)
        if op == "reload":
            return self._op_reload(msg, snap)
        if op == "update":
            return self._op_update(msg)
        raise ValueError(f"unknown op {op!r}")

    @staticmethod
    def _fit_consumes_fixture(msg: dict, semantics: str) -> bool:
        """The fit paths that read raw objects, not just packed arrays:
        the reference cpu cross-check walk, anti-affinity masks (pod
        labels are not in the arrays) and preemption (the priority table
        is built from raw pod objects).  Dispatch uses this to decide
        whether a store-dirty fixture must be rematerialized."""
        return (
            (msg.get("backend") == "cpu" and semantics == "reference")
            or "anti_affinity_labels" in msg
            or "priority" in msg
        )

    def _resilience_info(self) -> dict:
        """``info``'s resilience section: deadline sheds, the (never
        used) fast-path breaker, and — when a follower feeds this server —
        its retry/backoff counters."""
        out = {
            "deadline_shed": int(self._m_shed.value),
            "fast_path_breaker": _NEVER_OPEN.snapshot(),
        }
        if self._stats_source is not None:
            try:
                out["follower"] = self._stats_source()
            except Exception as e:  # noqa: BLE001 - info must not fail
                out["follower"] = {"error": f"{type(e).__name__}: {e}"}
        return out

    def _op_info(self, msg: dict, snap: ClusterSnapshot) -> dict:
        out = {
            "nodes": snap.n_nodes,
            "semantics": snap.semantics,
            "healthy_nodes": int(np.sum(snap.healthy)),
            "extended_resources": sorted(snap.extended),
            "resilience": self._resilience_info(),
            # The protocol feature handshake: what THIS server speaks.
            "capabilities": {
                "protocol": 2,
                "plane": self._plane_role is not None,
                "admission": self._admission is not None,
                "drain": True,
                "tenancy": self._tenants is not None,
            },
            "draining": self.draining,
        }
        # Opt-in sections (the default shape is pinned by clients that
        # diff it).  ``plane``: the leader's fan-out stats or the
        # replica's sync and staleness state.
        if msg.get("plane"):
            if self._plane_stats_source is None:
                out["plane"] = None
            else:
                try:
                    out["plane"] = self._plane_stats_source()
                except Exception as e:  # noqa: BLE001 - info must not fail
                    out["plane"] = {"error": f"{type(e).__name__}: {e}"}
        if msg.get("metrics"):
            out["metrics"] = self.registry.snapshot()
        if msg.get("hot_path"):
            from kubernetesclustercapacity_tpu_torch import (
                snapshot as _snapshot_mod,
            )

            grouped = _snapshot_mod.grouped_for_dispatch(snap)
            out["hot_path"] = {
                "devcache": _devcache.CACHE.stats(),
                "node_bucket_floor": None,  # no bucket ladder in the port
                "batching": self.batching_stats,
                "grouping": {
                    "enabled": _snapshot_mod.grouping_enabled(),
                    "engaged": grouped is not None,
                    "group_min_count": _snapshot_mod.group_min_count(),
                    **(
                        {
                            "groups": grouped.n_groups,
                            "compression_ratio": round(
                                grouped.compression_ratio, 4
                            ),
                        }
                        if grouped is not None
                        else {}
                    ),
                },
            }
        # ``tenancy``: the tenant map's shape (never tokens) and the
        # per-tenant admission counters.
        if msg.get("tenancy"):
            if self._tenants is None:
                out["tenancy"] = None
            else:
                out["tenancy"] = {
                    "tenants": self._tenants.to_wire(),
                    "admission": (
                        self._admission.tenant_stats()
                        if self._admission is not None
                        else None
                    ),
                }
        if msg.get("tracing"):
            out["tracing"] = self.tracing_stats()
        # ``audit``: the audit log's and the shadow sampler's status.
        if msg.get("audit"):
            out["audit"] = {
                "enabled": (
                    self._audit is not None or self._shadow is not None
                ),
                "log": (
                    self._audit.stats() if self._audit is not None else None
                ),
                "shadow": (
                    self._shadow.stats()
                    if self._shadow is not None
                    else None
                ),
            }
        return out

    # PodSpec extension fields a fit message may carry beyond the
    # reference's six flags (kube-scheduler constraint families).
    _SPEC_FIELDS = (
        "tolerations",
        "node_selector",
        "affinity_terms",
        "anti_affinity_labels",
        "spread",
        "extended_requests",
        "priority",
    )

    @staticmethod
    def _scenario_from_msg(msg: dict):
        """The six reference flags (shared defaults for every op)."""
        try:
            scenario = scenario_from_flags(
                cpuRequests=msg.get("cpuRequests", "100m"),
                cpuLimits=msg.get("cpuLimits", "200m"),
                memRequests=msg.get("memRequests", "100mb"),
                memLimits=msg.get("memLimits", "200mb"),
                replicas=msg.get("replicas", "1"),
            )
            scenario.validate()
        except ScenarioError as e:
            raise ValueError(str(e)) from e
        return scenario

    @staticmethod
    def _spec_from_msg(msg: dict, scenario):
        """msg → PodSpec: one copy of the spec-field wiring for fit, place,
        topology_spread and plan.  ``spread`` follows the protocol's
        string-flag convention (``spread="2"`` and ``spread=2`` both
        work)."""
        from kubernetesclustercapacity_tpu_torch.models import PodSpec

        spread = msg.get("spread")
        priority = msg.get("priority")
        try:
            return PodSpec(
                cpu_request_milli=scenario.cpu_request_milli,
                mem_request_bytes=scenario.mem_request_bytes,
                replicas=scenario.replicas,
                cpu_limit_milli=scenario.cpu_limit_milli,
                mem_limit_bytes=scenario.mem_limit_bytes,
                tolerations=tuple(msg.get("tolerations") or ()),
                node_selector=dict(msg.get("node_selector") or {}),
                affinity_terms=tuple(msg.get("affinity_terms") or ()),
                anti_affinity_labels=dict(
                    msg.get("anti_affinity_labels") or {}
                ),
                namespace=msg.get("namespace"),
                spread=int(spread) if spread is not None else None,
                priority=int(priority) if priority is not None else None,
                extended_requests={
                    k: int(v)
                    for k, v in (msg.get("extended_requests") or {}).items()
                },
            )
        except (TypeError, KeyError, ValueError) as e:
            raise ValueError(f"bad pod spec: {e}") from e

    def _priority_table_for(self, fixture: dict, snap: ClusterSnapshot):
        """The preemption table, cached across dispatches.

        Self-validating by ``(fixture, snapshot)`` object identity: both
        are REPLACED, never mutated, on reload/update rematerialization,
        so a stale pair cannot match and no invalidation hook is needed.
        Concurrent misses may build twice; the atomic tuple swap keeps the
        cache coherent either way.
        """
        from kubernetesclustercapacity_tpu_torch.ops.preemption import (
            build_priority_table,
        )

        cached = self._ptable_cache
        if (
            cached is not None
            and cached[0] is fixture
            and cached[1] is snap
        ):
            return cached[2]
        table = build_priority_table(
            fixture, snap, tuple(sorted(snap.extended))
        )
        self._ptable_cache = (fixture, snap, table)
        return table

    def _model_for(self, spec, snap: ClusterSnapshot, fixture: dict | None):
        """``CapacityModel`` on the server's device, with the cached
        preemption table seeded when the spec needs one (and the fixture
        exists to build it — a missing fixture keeps the model's own
        error)."""
        from kubernetesclustercapacity_tpu_torch.models import CapacityModel

        table = None
        if spec.priority is not None and fixture is not None:
            table = self._priority_table_for(fixture, snap)
        return CapacityModel(
            snap, mode=snap.semantics, fixture=fixture, priority_table=table,
            device=self._device,
        )

    def _op_fit(
        self,
        msg: dict,
        snap: ClusterSnapshot,
        fixture: dict | None,
        implicit_mask=None,
    ) -> dict:
        scenario = self._scenario_from_msg(msg)
        if any(k in msg for k in self._SPEC_FIELDS):
            return self._op_fit_spec(msg, snap, fixture, scenario)
        from kubernetesclustercapacity_tpu_torch.utils.quantity import (
            int64_bits,
        )

        # The implicit strict-mode taint mask (computed per snapshot
        # swap) — the same mask CapacityModel applies, so the plain-flags
        # and PodSpec surfaces agree.
        node_mask = implicit_mask
        # "cpu" walks the oracle; any other value (the JAX clients'
        # "tpu", or "torch") runs the device program.
        backend = msg.get("backend", "torch")
        if backend == "cpu":
            from kubernetesclustercapacity_tpu_torch.oracle import (
                fit_arrays_python,
                reference_run,
            )

            if fixture is not None and snap.semantics == "reference":
                fits = reference_run(fixture, scenario).fits
            else:
                # No fixture (.npz source) or strict packing: sequential
                # walk over the packed arrays, as the CLI does.
                fits = fit_arrays_python(
                    snap.alloc_cpu_milli,
                    snap.alloc_mem_bytes,
                    snap.alloc_pods,
                    snap.used_cpu_req_milli,
                    snap.used_mem_req_bytes,
                    snap.pods_count,
                    scenario.cpu_request_milli,
                    scenario.mem_request_bytes,
                    mode=snap.semantics,
                    healthy=(
                        snap.healthy
                        if node_mask is None
                        else snap.healthy & node_mask
                    ),
                )
            fits = np.array(fits, dtype=np.int64)
        else:
            from kubernetesclustercapacity_tpu_torch.ops.fit import (
                fit_snapshot,
            )

            fits = fit_snapshot(
                snap,
                # raw uint64 request -> the tensors' int64 bit pattern
                int64_bits(scenario.cpu_request_milli),
                scenario.mem_request_bytes,
                mode=snap.semantics,
                node_mask=node_mask,
                device=self._device,
            )
        clk = _phases.current()
        with clk.phase("serialize"):
            report = self._render_report(msg, snap, fits, scenario)
            total = int(fits.sum())
            return {
                "total": total,
                "schedulable": total >= scenario.replicas,
                "fits": fits.tolist(),
                "report": report,
            }

    @staticmethod
    def _render_report(msg: dict, snap: ClusterSnapshot, fits, scenario):
        """One place maps the wire ``output`` flag to a report renderer —
        every fit path honors the same formats."""
        output = msg.get("output", "reference")
        if output == "json":
            return json_report(snap, fits, scenario)
        if output == "table":
            return table_report(snap, fits, scenario)
        return reference_report(snap, fits, scenario)

    def _op_fit_spec(
        self,
        msg: dict,
        snap: ClusterSnapshot,
        fixture: dict | None,
        scenario,
    ) -> dict:
        """Constrained / multi-resource / preemptive fit through
        ``CapacityModel``: taint tolerations, nodeSelector, node
        (anti-)affinity, spread, extended resources and priority."""
        spec = self._spec_from_msg(msg, scenario)
        try:
            result = self._model_for(spec, snap, fixture).evaluate(spec)
        except (TypeError, KeyError, ValueError) as e:
            raise ValueError(f"bad pod spec: {e}") from e
        return {
            "total": result.total,
            "schedulable": result.schedulable,
            "fits": result.fits.tolist(),
            "report": self._render_report(msg, snap, result.fits, scenario),
        }

    def _op_place(
        self, msg: dict, snap: ClusterSnapshot, fixture: dict | None
    ) -> dict:
        """Placement simulation over the wire: which node gets replica k.

        Takes the same spec fields as fit (one shared msg→PodSpec parser),
        so (anti-)affinity constraints bind placements too.
        """
        scenario = self._scenario_from_msg(msg)
        spec = self._spec_from_msg(msg, scenario)
        # Wire flag ``assignments``: false = counts only (the bulk engine).
        # Absent/true = the scan WITH the per-replica order, at every R, so
        # clients keep the reply shape they were built against.
        want_order = msg.get("assignments", True)
        if not isinstance(want_order, bool):
            raise ValueError(
                f"assignments must be a JSON bool, got {want_order!r}"
            )
        try:
            result = self._model_for(spec, snap, fixture).place(
                spec,
                policy=msg.get("policy", "first-fit"),
                assignments=want_order,
            )
        except (TypeError, KeyError, ValueError) as e:
            # KeyError: an extended request naming a column the snapshot
            # does not carry.
            raise ValueError(f"bad pod spec: {e}") from e
        return {
            "assignments": (
                None
                if result.assignments is None
                else [
                    snap.names[i] if i >= 0 else None
                    for i in result.assignments.tolist()
                ]
            ),
            "by_node": result.by_node(),
            "placed": result.placed,
            "all_placed": result.all_placed,
            "policy": result.policy,
            "engine": result.engine,
        }

    def _op_drain(
        self, msg: dict, snap: ClusterSnapshot, fixture: dict | None
    ) -> dict:
        """Drain simulation over the wire: a rehoming target per pod on
        the named node, and the evictable verdict."""
        from kubernetesclustercapacity_tpu_torch.models import CapacityModel

        node = msg.get("node")
        if not isinstance(node, str) or not node:
            raise ValueError("drain wants a non-empty node name string")
        if fixture is None:
            raise ValueError(
                "drain needs a fixture-backed source (.json); an .npz "
                "checkpoint carries no per-pod requests"
            )
        try:
            model = CapacityModel(
                snap, mode=snap.semantics, fixture=fixture,
                device=self._device,
            )
            result = model.drain(node, policy=msg.get("policy", "best-fit"))
        except (TypeError, KeyError, ValueError) as e:
            raise ValueError(f"bad drain request: {e}") from e
        return {
            "node": result.node,
            "pods": result.pods,
            "assignments": result.assignments,
            "by_pod": result.by_pod(),
            "blocked": result.blocked,
            "evictable": result.evictable,
            "policy": result.policy,
        }

    def _op_topology_spread(
        self, msg: dict, snap: ClusterSnapshot, fixture: dict | None
    ) -> dict:
        """Capacity under a PodTopologySpread maxSkew constraint —
        :meth:`CapacityModel.topology_spread` over the wire; a message
        carrying scenario ARRAYS instead of the six flags takes the grid
        path (``topology_spread_grid``)."""
        from kubernetesclustercapacity_tpu_torch.models import CapacityModel

        key = msg.get("topology_key")
        if not isinstance(key, str) or not key:
            raise ValueError(
                "topology_spread wants a non-empty topology_key string"
            )
        if "cpu_request_milli" in msg:
            try:
                grid = ScenarioGrid(
                    cpu_request_milli=np.asarray(msg["cpu_request_milli"]),
                    mem_request_bytes=np.asarray(msg["mem_request_bytes"]),
                    replicas=np.asarray(msg.get("replicas", [1])),
                )
                model = CapacityModel(
                    snap, mode=snap.semantics, fixture=fixture,
                    device=self._device,
                )
                totals, sched = model.topology_spread_grid(
                    grid,
                    topology_key=key,
                    max_skew=int(msg.get("max_skew", 1)),
                    node_taints_policy=msg.get(
                        "node_taints_policy", "ignore"
                    ),
                    # The shared constraints the scalar branch honors via
                    # the spec must not silently drop on the grid form.
                    tolerations=tuple(msg.get("tolerations") or ()),
                    node_selector=dict(msg.get("node_selector") or {}),
                )
            except (ScenarioError, KeyError, TypeError, ValueError) as e:
                raise ValueError(
                    f"bad topology_spread request: {e}"
                ) from e
            return {
                "topology_key": key,
                "max_skew": int(msg.get("max_skew", 1)),
                "totals": totals.tolist(),
                "schedulable": sched.tolist(),
                "scenarios": grid.size,
            }
        scenario = self._scenario_from_msg(msg)
        spec = self._spec_from_msg(msg, scenario)
        try:
            r = self._model_for(spec, snap, fixture).topology_spread(
                spec,
                topology_key=key,
                max_skew=int(msg.get("max_skew", 1)),
                node_taints_policy=msg.get("node_taints_policy", "ignore"),
            )
        except (TypeError, KeyError, ValueError) as e:
            raise ValueError(f"bad topology_spread request: {e}") from e
        return {
            "topology_key": r.topology_key,
            "max_skew": r.max_skew,
            "zones": r.zones,
            "allowed": r.allowed,
            "total": r.total,
            "schedulable": r.schedulable,
            "unkeyed_nodes": r.unkeyed_nodes,
        }

    def _op_plan(
        self,
        msg: dict,
        snap: ClusterSnapshot,
        fixture: dict | None,
        implicit_mask=None,
    ) -> dict:
        """Scale-up planning over the wire, two forms:

        * **catalog** (``catalog`` present): the certified planner —
          :func:`~..forecast.planner.plan_capacity` over a declarative
          node-shape catalog, answering "cheapest node set restoring
          the quantile capacity to ``target``" with the LP lower
          bound, cannot-lie certification, shadow prices, and (with
          ``drain: true``) the scale-down dual;
        * **node_template**: homogeneous
          :meth:`CapacityModel.nodes_needed` (``nodes_needed`` is null
          when unsatisfiable).
        """
        if "catalog" in msg:
            return self._op_plan_catalog(msg, snap, implicit_mask)
        template = msg.get("node_template")
        if not isinstance(template, dict):
            raise ValueError(
                "plan wants a node_template object (or a 'catalog' "
                "for the certified shape planner)"
            )
        scenario = self._scenario_from_msg(msg)
        spec = self._spec_from_msg(msg, scenario)
        try:
            plan = self._model_for(spec, snap, fixture).nodes_needed(
                spec, template
            )
        except (TypeError, KeyError, ValueError) as e:
            raise ValueError(f"bad plan request: {e}") from e
        return {
            "replicas_requested": plan.replicas_requested,
            "current_total": plan.current_total,
            "per_node_fit": plan.per_node_fit,
            "nodes_needed": plan.nodes_needed,
            "satisfiable": plan.satisfiable,
        }

    @staticmethod
    def _stochastic_spec(msg: dict):
        """The stochastic usage spec riding a ``car``/``forecast``/``plan``
        request (``usage`` plus the optional spec fields), validated; a
        grammar error is a bad request."""
        from kubernetesclustercapacity_tpu_torch.stochastic.distributions import (  # noqa: E501
            DistributionError,
            parse_stochastic_spec,
        )

        data = {"usage": msg["usage"]}
        for field in ("replicas", "samples", "seed", "confidence"):
            if field in msg:
                data[field] = msg[field]
        try:
            return parse_stochastic_spec(data)
        except DistributionError as e:
            raise ValueError(str(e)) from e

    @staticmethod
    def _quantiles_from_msg(msg: dict):
        """The optional ``quantiles`` list, validated (``None`` when
        absent)."""
        quantiles = msg.get("quantiles")
        if quantiles is None:
            return None
        if not isinstance(quantiles, list) or not quantiles:
            raise ValueError("quantiles must be a non-empty list")
        for q in quantiles:
            if (
                isinstance(q, bool)
                or not isinstance(q, (int, float))
                or not 0.0 < float(q) < 1.0
            ):
                raise ValueError(
                    f"quantiles must lie strictly inside (0, 1), got {q!r}"
                )
        return tuple(float(q) for q in quantiles)

    def _op_plan_catalog(
        self, msg: dict, snap: ClusterSnapshot, implicit_mask=None
    ) -> dict:
        """The catalog form of the ``plan`` op: a stochastic usage spec
        plus a node-shape catalog → the certified cheapest purchase.
        The served semantics and implicit strict-mode taint mask apply
        exactly as they do to ``car``, so the plan restores the same
        capacity that op reports."""
        from kubernetesclustercapacity_tpu_torch.forecast.planner import (
            PlannerError,
            parse_catalog,
            plan_capacity,
        )

        if "usage" not in msg:
            raise ValueError(
                "plan with a catalog wants a 'usage' distribution "
                "block (the demand the purchase must hold)"
            )
        spec = self._stochastic_spec(msg)
        try:
            catalog = parse_catalog(msg["catalog"])
        except PlannerError as e:
            raise ValueError(str(e)) from e
        target = msg.get("target")
        if target is not None and (
            isinstance(target, bool) or not isinstance(target, int)
        ):
            raise ValueError("plan target must be an integer")
        quantile = msg.get("quantile", 0.95)
        if isinstance(quantile, bool) or not isinstance(
            quantile, (int, float)
        ):
            raise ValueError("plan quantile must be a number in (0, 1)")
        drain = msg.get("drain", False)
        if not isinstance(drain, bool):
            raise ValueError("plan drain must be a boolean")
        try:
            result = plan_capacity(
                snap, spec, catalog,
                target=target,
                quantile=float(quantile),
                mode=snap.semantics,
                node_mask=implicit_mask,
                drain=drain,
                device=self._device,
            )
        except PlannerError as e:
            raise ValueError(str(e)) from e
        out = result.to_wire()
        output = msg.get("output")
        if output in ("table", "json"):
            from kubernetesclustercapacity_tpu_torch.report import (
                plan_json_report,
                plan_table_report,
            )

            out["report"] = (
                plan_table_report(out)
                if output == "table"
                else plan_json_report(out)
            )
        return out

    def _op_car(
        self, msg: dict, snap: ClusterSnapshot, implicit_mask=None
    ) -> dict:
        """Capacity-at-risk over the wire, two forms:

        * **evaluate** (``usage`` present): parse the stochastic spec
          (``usage``/``replicas``/``samples``/``seed``/``confidence``,
          optional ``quantiles`` list), draw the seed-deterministic
          Monte Carlo samples, sweep them on the card (same semantics
          and implicit taint mask as fit/sweep), and return capacity
          quantiles + mean + probability-of-fit + per-quantile binding
          attribution;
        * **watch status** (no ``usage``): the capacity-at-risk slice
          of the timeline — per quantile watch the last quantile
          capacity, probability-of-fit, and alert state (what
          ``kccap-torch -car HOST:PORT`` renders and exits by).
        """
        from kubernetesclustercapacity_tpu_torch.stochastic.car import (
            DEFAULT_QUANTILES,
            capacity_at_risk,
        )

        if "usage" not in msg:
            tl = self._timeline
            watches = tl.car_status() if tl is not None else {}
            if not watches:
                return {"enabled": False, "watches": {}, "breached": []}
            return {
                "enabled": True,
                "generation": self.generation,
                "watches": watches,
                "breached": tl.car_breached(),
            }
        spec = self._stochastic_spec(msg)
        quantiles = self._quantiles_from_msg(msg)
        result = capacity_at_risk(
            snap, spec,
            mode=snap.semantics,
            node_mask=implicit_mask,
            quantiles=quantiles or DEFAULT_QUANTILES,
            device=self._device,
        )
        clk = _phases.current()
        with clk.phase("serialize"):
            out = result.to_wire()
            output = msg.get("output")
            if output in ("table", "json"):
                from kubernetesclustercapacity_tpu_torch.report import (
                    car_json_report,
                    car_table_report,
                )

                out["report"] = (
                    car_table_report(out)
                    if output == "table"
                    else car_json_report(out)
                )
        return out

    def _op_forecast(
        self, msg: dict, snap: ClusterSnapshot, implicit_mask=None
    ) -> dict:
        """Capacity forecasting over the wire, two forms:

        * **evaluate** (``usage`` present): the capacity-at-risk spec
          plus a projection — ``steps``/``step_s`` and an EXPLICIT
          ``growth`` block (``{cpu_per_s, memory_per_s}`` relative
          rates) — answered with per-step capacity quantile ladders and
          ``time_to_breach_s``, one ``[steps·samples]`` sweep on the
          card.  Growth is explicit by design: the op stays a pure
          function of the served snapshot (trend fitting from history
          lives client-side in :func:`~..forecast.trend.
          trend_from_audit`);
        * **watch status** (no ``usage``): the forecast slice of the
          timeline — per horizon watch the projected minimum, time to
          breach, and alert state (what ``kccap-torch -forecast
          HOST:PORT`` renders and exits by).
        """
        from kubernetesclustercapacity_tpu_torch.forecast.horizon import (
            DEFAULT_STEP_S,
            DEFAULT_STEPS,
            project_horizon,
        )

        if "usage" not in msg:
            tl = self._timeline
            watches = tl.forecast_status() if tl is not None else {}
            if not watches:
                return {"enabled": False, "watches": {}, "breached": []}
            return {
                "enabled": True,
                "generation": self.generation,
                "watches": watches,
                "breached": tl.forecast_breached(),
            }
        spec = self._stochastic_spec(msg)
        steps = msg.get("steps", DEFAULT_STEPS)
        if isinstance(steps, bool) or not isinstance(steps, int):
            raise ValueError("forecast steps must be an integer")
        step_s = msg.get("step_s", DEFAULT_STEP_S)
        if isinstance(step_s, bool) or not isinstance(step_s, (int, float)):
            raise ValueError("forecast step_s must be a number")
        growth = msg.get("growth", {})
        if not isinstance(growth, dict):
            raise ValueError(
                "forecast growth must be an object like "
                '{"cpu_per_s": 1e-6, "memory_per_s": 0}'
            )
        unknown = set(growth) - {"cpu_per_s", "memory_per_s"}
        if unknown:
            raise ValueError(
                f"unknown growth field(s) {sorted(unknown)} "
                "(want cpu_per_s/memory_per_s)"
            )
        rates = {}
        for key in ("cpu_per_s", "memory_per_s"):
            v = growth.get(key, 0.0)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ValueError(f"growth.{key} must be a number")
            rates[key] = float(v)
        threshold = msg.get("threshold")
        if threshold is not None and (
            isinstance(threshold, bool) or not isinstance(threshold, int)
        ):
            raise ValueError("forecast threshold must be an integer")
        quantiles = self._quantiles_from_msg(msg)
        try:
            result = project_horizon(
                snap, spec,
                steps=steps,
                step_s=float(step_s),
                growth_cpu_per_s=rates["cpu_per_s"],
                growth_mem_per_s=rates["memory_per_s"],
                mode=snap.semantics,
                node_mask=implicit_mask,
                **({"quantiles": quantiles} if quantiles else {}),
                threshold=threshold,
                device=self._device,
            )
        except ValueError as e:
            raise ValueError(f"bad forecast request: {e}") from e
        out = result.to_wire()
        output = msg.get("output")
        if output in ("table", "json"):
            from kubernetesclustercapacity_tpu_torch.report import (
                forecast_json_report,
                forecast_table_report,
            )

            out["report"] = (
                forecast_table_report(out)
                if output == "table"
                else forecast_json_report(out)
            )
        return out

    def _op_dump(self, msg: dict) -> dict:
        """The flight recorder over the wire: the last K dispatched
        requests (this ``dump`` itself lands in the ring only after its
        own dispatch finishes, so the returned records end at the
        request before it).

        Server-side filters — ``op`` (exact op name), ``status``
        (``"ok"``/``"error"``), ``filter_tenant`` (exact derived tenant;
        the port has no tenancy yet, so it matches nothing, as on a JAX
        server without ``-tenants``), ``limit`` (the N MOST
        RECENT matches) — so a triage client chasing "the last 5 errors" pulls
        5 records, not the whole ring.  ``count`` is the post-filter
        record count; ``matched`` the pre-``limit`` match count, so a
        reader knows how much history the filter found beyond what it
        was handed.  Once an ``update`` has built the store,
        ``store_pods`` counts its pods by form
        (:meth:`..store.ClusterStore.pod_forms`).
        """
        # ``op`` names THIS request's op on the envelope, so the filter
        # rides as ``filter_op`` (the client's ``dump(op=...)`` maps it).
        op_f = msg.get("filter_op")
        if op_f is not None and not isinstance(op_f, str):
            raise ValueError(f"filter_op must be a string, got {op_f!r}")
        status = msg.get("status")
        if status is not None and status not in ("ok", "error"):
            raise ValueError(
                f"status filter must be 'ok' or 'error', got {status!r}"
            )
        # ``tenant`` on the envelope is this request's own attribution
        # (tenant-configured clients stamp it on every call), so the
        # filter rides as ``filter_tenant`` — the ``filter_op`` move.
        tenant_f = msg.get("filter_tenant")
        if tenant_f is not None and not isinstance(tenant_f, str):
            raise ValueError(
                f"filter_tenant must be a string, got {tenant_f!r}"
            )
        # ``sampled`` filters on the tail sampler's recorded verdict:
        # True = records whose trace tree was retained (a ``-trace-tree``
        # will find them), False = records whose tree was dropped.
        # Records with no verdict (no sampler armed) match neither.
        sampled_f = msg.get("sampled")
        if sampled_f is not None and not isinstance(sampled_f, bool):
            raise ValueError(
                f"sampled filter must be a boolean, got {sampled_f!r}"
            )
        limit = msg.get("limit")
        if limit is not None:
            if isinstance(limit, bool) or not isinstance(limit, int):
                raise ValueError(f"limit must be an integer, got {limit!r}")
            if limit < 1:
                raise ValueError(f"limit must be >= 1, got {limit}")
        records = self._flight.records()
        if op_f is not None:
            records = [r for r in records if r.get("op") == op_f]
        if status is not None:
            records = [r for r in records if r.get("status") == status]
        if tenant_f is not None:
            records = [r for r in records if r.get("tenant") == tenant_f]
        if sampled_f is not None:
            records = [
                r for r in records if r.get("trace_sampled") is sampled_f
            ]
        matched = len(records)
        if limit is not None:
            records = records[-limit:]
        out = {
            "records": records,
            "count": len(records),
            "matched": matched,
            "capacity": self._flight.capacity,
            "dropped": self._flight.dropped,
            "generation": self.generation,
        }
        with _lock_wait() as acquired, self._lock:
            acquired()
            if self._store is not None:  # built by the first update op
                out["store_pods"] = self._store.pod_forms()
        return out

    def _op_slo(self, msg: dict) -> dict:
        """SLO burn-rate status over the wire: every objective's current
        short/long-window burn, alert state, and the fast-burning
        verdict.  Evaluated ON READ (one fresh counter sample per
        query), so a poller always sees current burn — the background
        evaluator only exists for scrape-only deployments."""
        if self._slo is None:
            return {"enabled": False}
        self._slo.evaluate()
        return self._slo.wire()

    def _op_timeline(self, msg: dict) -> dict:
        """The capacity timeline over the wire: per-generation records,
        attributed deltas, and alert states — filtered server-side by
        ``since_generation`` (strictly-after) and ``watch`` (one name),
        so a follower polling for news pulls only the transitions it has
        not seen."""
        if self._timeline is None:
            return {"enabled": False}
        since = msg.get("since_generation")
        if since is not None:
            if isinstance(since, bool) or not isinstance(since, int):
                raise ValueError(
                    f"since_generation must be an integer, got {since!r}"
                )
        watch = msg.get("watch")
        if watch is not None and not isinstance(watch, str):
            raise ValueError(f"watch must be a string, got {watch!r}")
        return self._timeline.wire(since_generation=since, watch=watch)

    def _batch_key(self, snap, kernel_req: str):
        """The micro-batch key: the generation ``_dispatch_inner``
        captured WITH this snapshot (a direct caller that bypassed
        dispatch keys by snapshot identity), the served semantics and the
        kernel family — only requests whose combined dispatch equals
        their solo ones share a launch."""
        generation = getattr(self._dispatch_tls, "generation", None)
        if generation is None:
            generation = ("snap-id", id(snap))
        return (generation, snap.semantics, kernel_req)

    def _op_gang(
        self, msg: dict, snap: ClusterSnapshot, implicit_mask=None
    ) -> dict:
        """Gang capacity over the wire, two forms:

        * **evaluate** (``ranks`` present): the six per-rank flag fields
          (or the sweep op's scenario-array grammar) plus the gang
          constraint fields (``ranks``/``count``/``colocate``/
          ``spread_level``/``max_ranks_per_domain``/
          ``anti_affinity_host``), answered with whole-gang counts per
          scenario on the card — same semantics and implicit taint mask
          as fit/sweep.  Single-scenario requests (and any request with
          ``explain: true``) also carry the binding-level explanation.
        * **watch status** (no ``ranks``): the gang slice of the
          timeline — per gang watch the last whole-gang count, binding
          level, and alert state (what ``kccap-torch -gang HOST:PORT``
          renders and exits by).
        """
        from kubernetesclustercapacity_tpu_torch.topology.gang import (
            GangSpecError,
            gang_capacity,
            gang_explain,
            gang_spec_from_msg,
        )

        if "ranks" not in msg:
            tl = self._timeline
            watches = tl.gang_status() if tl is not None else {}
            if not watches:
                return {"enabled": False, "watches": {}, "breached": []}
            return {
                "enabled": True,
                "generation": self.generation,
                "watches": watches,
                "breached": tl.gang_breached(),
            }
        grid = self._grid_from_msg(msg, "gang")
        try:
            spec = gang_spec_from_msg(msg)
            result = gang_capacity(
                snap, grid, spec,
                mode=snap.semantics, node_mask=implicit_mask,
                device=self._device,
            )
        except (GangSpecError, ScenarioError, ValueError) as e:
            raise ValueError(f"bad gang request: {e}") from e
        out = result.to_wire()
        if grid.size == 1 or msg.get("explain"):
            out["explain"] = gang_explain(
                snap, grid, spec,
                mode=snap.semantics, node_mask=implicit_mask,
                device=self._device,
            )
        return out

    def _grid_from_msg(self, msg: dict, op: str) -> ScenarioGrid:
        """The sweep grammar of ``gang`` and ``optimize``: scenario arrays,
        or the six flag fields as one scenario."""
        if "cpu_request_milli" not in msg:
            return ScenarioGrid.from_scenarios([self._scenario_from_msg(msg)])
        try:
            return ScenarioGrid(
                cpu_request_milli=np.asarray(msg["cpu_request_milli"]),
                mem_request_bytes=np.asarray(msg["mem_request_bytes"]),
                replicas=np.asarray(msg.get("replicas", [1])),
            )
        except (ScenarioError, KeyError, TypeError, ValueError) as e:
            raise ValueError(f"bad {op} request: {e}") from e

    def _op_optimize(
        self, msg: dict, snap: ClusterSnapshot, implicit_mask=None
    ) -> dict:
        """Optimization-based packing over the wire: the sweep grammar
        (scenario arrays or the six flags), answered by the chosen
        ``backend``:

        * ``"lp"`` (default) — the certified LP solve on the card
          (:func:`~..optimize.optimize_snapshot`): certified dual
          bound, integral rounded packing, FFD baseline, per-resource
          shadow prices, and the duality certificate;
        * ``"ffd"`` — the bug-compatible first-fit reference alone
          (the production fit path's placed counts).

        Same semantics and implicit strict-mode taint mask as fit/sweep.
        A certified ``lp`` solve feeds its worst scenario's capacity
        share to the admission controller's shadow-price gate.
        """
        from kubernetesclustercapacity_tpu_torch.ops.fit import sweep_snapshot
        from kubernetesclustercapacity_tpu_torch.optimize import (
            OptimizeError,
            optimize_snapshot,
        )

        backend = msg.get("backend", "lp")
        if backend not in ("lp", "ffd"):
            raise ValueError(
                f"optimize backend must be 'lp' or 'ffd', got {backend!r}"
            )
        grid = self._grid_from_msg(msg, "optimize")
        if backend == "ffd":
            grid.validate()
            totals, _ = sweep_snapshot(
                snap, grid, mode=snap.semantics, node_mask=implicit_mask,
                device=self._device,
            )[:2]
            totals = np.asarray(totals, dtype=np.int64)
            demand = np.asarray(grid.replicas, dtype=np.int64)
            out = {
                "backend": "ffd",
                "mode": snap.semantics,
                "scenarios": grid.size,
                "demand": demand.tolist(),
                "ffd": np.clip(totals, 0, demand).tolist(),
                "totals": totals.tolist(),
                "schedulable": (totals >= demand).tolist(),
            }
        else:
            kwargs = {}
            for key, cast in (("iters", int), ("tol", float)):
                if key in msg:
                    v = msg[key]
                    if isinstance(v, bool) or not isinstance(
                        v, (int, float)
                    ):
                        raise ValueError(
                            f"{key} must be a number, got {v!r}"
                        )
                    kwargs["max_iters" if key == "iters" else key] = cast(v)
            verify = msg.get("verify", True)
            if not isinstance(verify, bool):
                raise ValueError(f"verify must be a bool, got {verify!r}")
            try:
                result = optimize_snapshot(
                    snap,
                    grid,
                    mode=snap.semantics,
                    node_mask=implicit_mask,
                    verify=verify,
                    device=self._device,
                    **kwargs,
                )
            except (OptimizeError, ScenarioError) as e:
                raise ValueError(f"bad optimize request: {e}") from e
            out = result.to_wire()
            if self._admission is not None and result.all_certified:
                # The dual prices the capacity this server serves: feed
                # the worst (most scarce) scenario's capacity share to
                # the shed-by-shadow-price gate.
                share = max(
                    (s["capacity_share"] for s in result.shadow),
                    default=0.0,
                )
                self._admission.observe_shadow_price(
                    share, certified=True
                )
        output = msg.get("output")
        if output in ("table", "json"):
            from kubernetesclustercapacity_tpu_torch.report import (
                optimize_json_report,
                optimize_table_report,
            )

            out["report"] = (
                optimize_table_report(out)
                if output == "table"
                else optimize_json_report(out)
            )
        return out

    def _op_explain(
        self, msg: dict, snap: ClusterSnapshot, implicit_mask=None
    ) -> dict:
        """Bottleneck attribution over the wire: the same six flag fields
        as fit, answered with WHY — the binding constraint per node, the
        binding histogram, the saturation summary, and the marginal
        ("+1 replica") analysis, under the served semantics and the same
        implicit taint mask the fit and sweep ops apply.  Only the one
        scenario's per-node rows come to the host."""
        from kubernetesclustercapacity_tpu_torch.explain import (
            explain_snapshot,
        )
        from kubernetesclustercapacity_tpu_torch.report import (
            explain_json_report,
            explain_table_report,
        )

        scenario = self._scenario_from_msg(msg)
        grid = ScenarioGrid.from_scenarios([scenario])
        if self._batcher is not None:
            # Explain folds into the SAME queue as "auto" sweeps; a mixed
            # batch rides the fused sweep+explain program.
            grid.validate()
            result, _kernel = self._batcher.submit(
                self._batch_key(snap, "auto"),
                ("explain", snap, implicit_mask, grid),
                deadline=self._check_deadline(msg),
                tenant=getattr(self._dispatch_tls, "tenant", None),
                trace=getattr(self._dispatch_tls, "trace_ctx", None),
                weight=grid.size,
            )
        else:
            result = explain_snapshot(
                snap, grid, mode=snap.semantics, node_mask=implicit_mask,
                device=self._device,
            )
        total = int(result.totals[0])
        out = {
            "total": total,
            "schedulable": total >= scenario.replicas,
            "mode": result.mode,
            "binding": result.binding_names(0),
            "binding_counts": result.binding_counts(0),
            "marginal": result.marginal(0),
            "saturation": result.saturation(0),
        }
        output = msg.get("output")
        if output == "table":
            out["report"] = explain_table_report(result)
        elif output == "json":
            out["report"] = explain_json_report(result)
        return out

    def _op_sweep(
        self,
        msg: dict,
        snap: ClusterSnapshot,
        implicit_mask=None,
        fixture: dict | None = None,
    ) -> dict:
        if "random" in msg:
            grid = random_scenario_grid(
                int(msg["random"]["n"]), seed=int(msg["random"].get("seed", 0))
            )
        else:
            grid = ScenarioGrid(
                cpu_request_milli=np.asarray(msg["cpu_request_milli"]),
                mem_request_bytes=np.asarray(msg["mem_request_bytes"]),
                replicas=np.asarray(msg.get("replicas", [1])),
            )
        if "priorities" in msg:
            return self._sweep_with_priorities(msg, snap, grid, fixture)
        kernel_req = msg.get("kernel", "auto")
        key = self._batch_key(snap, kernel_req)
        if self._batcher is not None:
            # Validate BEFORE joining a batch: a bad grid must fail its
            # own request, never a batch it rode into.
            grid.validate()
            totals, sched, kernel = self._batcher.submit(
                key,
                ("sweep", snap, implicit_mask, grid),
                deadline=self._check_deadline(msg),
                tenant=getattr(self._dispatch_tls, "tenant", None),
                trace=getattr(self._dispatch_tls, "trace_ctx", None),
                weight=grid.size,
            )
        else:
            from kubernetesclustercapacity_tpu_torch.ops.fused_fit import (
                sweep_snapshot_auto,
            )

            # The same implicit taint mask the fit op applies: a strict
            # sweep over a tainted snapshot must not report higher totals
            # than fit does for the identical spec.
            totals, sched, kernel = sweep_snapshot_auto(
                snap,
                grid,
                mode=snap.semantics,
                kernel=kernel_req,
                node_mask=implicit_mask,
                device=self._device,
            )
        clk = _phases.current()
        if not isinstance(totals, np.ndarray):
            # A folded batch answers with views over one pending pinned
            # copy: wait for it at the last moment, under its own phase.
            t0 = time.perf_counter() if clk else 0.0
            with clk.live("fetch_overlap"):
                totals = np.asarray(totals)
                sched = np.asarray(sched)
            if clk:
                clk.record("fetch_overlap", time.perf_counter() - t0)
        # Shadow-oracle sampling: the decision and a queue append of the
        # host arrays the reply is built from (the oracle walk runs on
        # the sampler's worker thread).  Best-effort by the
        # observability contract.
        if self._shadow is not None:
            try:
                ctx = getattr(self._dispatch_tls, "trace_ctx", None)
                self._shadow.maybe_submit(
                    snap, key[0], grid, totals, sched,
                    node_mask=implicit_mask,
                    trace_id=ctx.trace_id if ctx is not None else None,
                )
            except Exception:  # noqa: BLE001 - monitoring never fails ops
                pass
        with clk.phase("serialize"):
            return {
                "totals": totals.tolist(),
                "schedulable": sched.tolist(),
                "scenarios": grid.size,
                "kernel": kernel,
            }

    def _sweep_with_priorities(
        self, msg, snap, grid, fixture: dict | None
    ) -> dict:
        """The preemption axis over the wire: scenario ``s`` evicts pods
        below ``priorities[s]`` — :meth:`CapacityModel.sweep_preemption`
        with the server's cached table seeded (the model's bare-spec taint
        mask equals the implicit mask the plain sweep applies)."""
        from kubernetesclustercapacity_tpu_torch.models import CapacityModel

        if snap.semantics != "strict":
            raise ValueError(
                "priorities require strict semantics (the reference has "
                "no priority concept)"
            )
        if fixture is None:
            raise ValueError(
                "priorities need a fixture-backed source (pod priorities "
                "are not part of the dense snapshot)"
            )
        model = CapacityModel(
            snap, mode="strict", fixture=fixture,
            priority_table=self._priority_table_for(fixture, snap),
            device=self._device,
        )
        totals, sched = model.sweep_preemption(grid, msg["priorities"])
        return {
            "totals": totals.tolist(),
            "schedulable": sched.tolist(),
            "scenarios": grid.size,
            "kernel": "exact-preemption",
        }

    def _dispatch_sweep_batch(self, key, items) -> list:
        """One launch for a micro-batch of folded requests.

        ``items`` are ``(op, snap, implicit_mask, grid)`` tuples sharing
        one snapshot generation, served semantics and kernel family;
        ``op`` is ``"sweep"`` or ``"explain"``.  Scenario rows from ALL
        members concatenate along the scenario axis, launch once, and
        scatter back per request.  A batch of one takes EXACTLY the solo
        path.

        * all-sweep batches dispatch with ``sync=False``: one launch of
          B1 (or the exact program) on the concatenated grid, one pinned
          device→host copy and one event, shared by every member through
          one :class:`..ops.fit.AsyncFetch`; each member slices the host
          array;
        * batches containing an explain ride the fused sweep+explain
          program, which brings to the host only the explain members'
          per-node rows.
        """
        from kubernetesclustercapacity_tpu_torch.ops.fit import _AsyncView
        from kubernetesclustercapacity_tpu_torch.ops.fused_fit import (
            sweep_explain_snapshot_auto,
            sweep_snapshot_auto,
        )

        _generation, _semantics, kernel_req = key
        _op0, snap, mask, _grid0 = items[0]
        if len(items) == 1:
            op, _, _, grid = items[0]
            if op == "explain":
                from kubernetesclustercapacity_tpu_torch.explain import (
                    explain_snapshot,
                )

                result = explain_snapshot(
                    snap, grid, mode=snap.semantics, node_mask=mask,
                    device=self._device,
                )
                return [(result, "explain")]
            return [sweep_snapshot_auto(
                snap, grid, mode=snap.semantics, kernel=kernel_req,
                node_mask=mask, device=self._device,
            )]
        grids = [item[3] for item in items]
        combined = ScenarioGrid(
            cpu_request_milli=np.concatenate(
                [g.cpu_request_milli for g in grids]
            ),
            mem_request_bytes=np.concatenate(
                [g.mem_request_bytes for g in grids]
            ),
            replicas=np.concatenate([g.replicas for g in grids]),
        )
        bounds = np.cumsum([0] + [g.size for g in grids])
        fetch = full = None
        if any(item[0] == "explain" for item in items):
            rows = np.concatenate([
                np.arange(bounds[i], bounds[i + 1])
                for i, item in enumerate(items) if item[0] == "explain"
            ])
            totals, sched, full, kernel = sweep_explain_snapshot_auto(
                snap, combined, mode=snap.semantics, node_mask=mask,
                device=self._device, rows=rows,
            )
        else:
            totals, sched, kernel = sweep_snapshot_auto(
                snap, combined, mode=snap.semantics, kernel=kernel_req,
                node_mask=mask, device=self._device, sync=False,
            )
            if not isinstance(totals, np.ndarray):
                fetch = totals.fetch
        out, explain_at = [], 0
        for i, (op, _, _, g) in enumerate(items):
            offset, end = int(bounds[i]), int(bounds[i + 1])
            if op == "explain":
                from kubernetesclustercapacity_tpu_torch.explain import (
                    ExplainResult,
                )

                lo, hi = explain_at, explain_at + g.size
                explain_at = hi
                out.append((
                    ExplainResult(
                        snapshot=snap,
                        mode=full.mode,
                        cpu_request_milli=full.cpu_request_milli[lo:hi],
                        mem_request_bytes=full.mem_request_bytes[lo:hi],
                        replicas=full.replicas[lo:hi],
                        fits=full.fits[lo:hi],
                        binding=full.binding[lo:hi],
                        cpu_fit=full.cpu_fit[lo:hi],
                        mem_fit=full.mem_fit[lo:hi],
                        slots=full.slots[lo:hi],
                        node_mask=full.node_mask,
                    ),
                    kernel,
                ))
            elif fetch is not None:
                out.append((
                    _AsyncView(fetch, 0, slice(offset, end)),
                    _AsyncView(fetch, 1, slice(offset, end)),
                    kernel,
                ))
            else:
                out.append((totals[offset:end], sched[offset:end], kernel))
        return out

    def _op_sweep_multi(
        self, msg: dict, snap: ClusterSnapshot, implicit_mask=None
    ) -> dict:
        """R-resource grid sweep (config 4): ``resources`` names the rows
        (cpu milli / memory bytes / extended columns), ``requests`` is the
        ``[S][R]`` request matrix, ``replicas`` the ``[S]`` targets.  Same
        implicit-taint-mask policy as the 2-resource sweep."""
        from kubernetesclustercapacity_tpu_torch.ops.fused_multi import (
            sweep_multi_auto,
        )
        from kubernetesclustercapacity_tpu_torch.scenario import (
            MultiResourceGrid,
        )

        try:
            grid = MultiResourceGrid(
                resources=tuple(msg["resources"]),
                requests=np.asarray(msg["requests"]),
                replicas=np.asarray(
                    msg.get("replicas", [1] * len(msg["requests"]))
                ),
            )
            grid.validate()
            alloc_rn, used_rn = snap.resource_matrix(grid.resources)
        except (ScenarioError, KeyError, TypeError, ValueError) as e:
            raise ValueError(f"bad multi-resource grid: {e}") from e
        totals, sched, kernel = sweep_multi_auto(
            alloc_rn,
            used_rn,
            snap.alloc_pods,
            snap.pods_count,
            snap.healthy,
            grid.requests,
            grid.replicas,
            mode=snap.semantics,
            node_masks=implicit_mask,
            force_exact=(msg.get("kernel", "auto") == "exact"),
            device=self._device,
        )
        with _phases.current().phase("serialize"):
            return {
                "totals": totals.tolist(),
                "schedulable": sched.tolist(),
                "scenarios": grid.size,
                "resources": list(grid.resources),
                "kernel": kernel,
            }

    def replace_snapshot(
        self,
        snapshot: ClusterSnapshot,
        fixture: dict | None = None,
        *,
        fixture_source=None,
        warm: bool = False,
        generation: int | None = None,
    ) -> None:
        """Atomically swap the served snapshot (e.g. from a live follower).

        ``fixture_source`` is an optional zero-arg callable yielding the
        raw fixture for THIS snapshot on demand (the follower's
        ``fixture_view``): publishers that swap snapshots at watch-event
        rates pass the source instead of a materialized fixture, so the
        O(N) deep copy is paid only when a fixture-consuming request
        (anti-affinity) arrives.  Such a fixture reflects the follower's
        CURRENT state, which may lead the served snapshot by the events
        of one coalescer window.

        ``warm=True`` pre-stages the new snapshot's tensors AFTER the
        swap, on the caller's thread (the coalescer's worker under
        ``-follow``), through :meth:`..devcache.DeviceCache.stage_replace`
        and :meth:`~..devcache.DeviceCache.warm` unless ``KCCAP_DONATE=0``:
        columns equal to the retired snapshot's carry over, changed ones
        are copied in place into its tensors where that is safe, and a
        request arriving next finds them staged.  The retired snapshot's
        cache entries are dropped either way, so its device memory frees
        promptly.  The timeline, the plane and the audit log then observe
        the new generation on the same thread, after the warm pre-stage.

        ``generation`` (plane replicas only) ADOPTS the given generation
        number instead of incrementing the local counter, so a replica
        stamps its replies with the LEADER's generation.  A regressing
        generation is refused: the plane stream is ordered, and serving
        it would let watermarked clients see time run backwards.
        """
        mask = _implicit_taint_mask(snapshot)
        with _lock_wait() as acquired, self._lock:
            acquired()
            if generation is not None:
                generation = int(generation)
                if generation < self._generation:
                    raise ValueError(
                        f"generation must not regress: {generation} < "
                        f"served {self._generation}"
                    )
            old = self.snapshot
            self.snapshot = snapshot
            self.fixture = fixture
            self._fixture_source = fixture_source
            self._store = None  # stale after a wholesale replace
            self._fixture_dirty = False
            self._implicit_mask = mask
            if generation is None:
                self._generation += 1
                generation = self._generation
            else:
                self._generation = generation
        if old is not snapshot:
            if warm and _devcache.donate_enabled():
                _devcache.CACHE.stage_replace(old, snapshot, self._device)
                _devcache.CACHE.warm(snapshot, self._device)
            else:
                _devcache.CACHE.invalidate(old)
                if warm:
                    _devcache.CACHE.warm(snapshot, self._device)
        # Timeline observation rides the publisher's thread (the
        # coalescer's worker under -follow) AFTER warming: a query
        # dispatcher never pays for it.  The audit record follows for the
        # same reason (the diff walk is O(N) host work).
        self._observe_timeline(snapshot, generation)
        self._audit_generation(snapshot, generation)

    def _require_leader(self) -> None:
        """Mutations against a plane REPLICA are refused before any
        work: the replica's state is the leader's stream, and a local
        mutation would silently fork it (and be clobbered by the next
        frame).  The ``not_leader`` wire code tells multi-endpoint
        clients to re-route, not to fail."""
        if self._plane_role == "replica":
            raise NotLeaderError(
                "this server is a plane replica (read-only view of the "
                "leader's snapshot stream); send mutations to the leader"
            )

    def _op_reload(self, msg: dict, snap: ClusterSnapshot) -> dict:
        """``snap`` is the dispatch's lock-captured snapshot — reading
        ``self.snapshot`` here could tear against a concurrent reload."""
        self._require_leader()
        with _lock_wait() as acquired, self._lock:
            acquired()
            if self._fixture_source is not None:
                # Same rule as update: the next coalesced publish would
                # silently clobber the reloaded state.
                raise ValueError(
                    "this server follows a live cluster (-follow); "
                    "reload is only for file-backed servers"
                )
        path = msg["path"]
        # An unspecified semantics keeps the CURRENTLY-SERVED packing; the
        # extended columns default to the served set under the SAME
        # resolved semantics — an explicit switch to reference drops
        # them, and an explicit extended_resources list always wins.
        semantics = msg.get("semantics") or snap.semantics
        if msg.get("extended_resources") is not None:
            extended = tuple(msg["extended_resources"])
        elif semantics == "strict":
            extended = tuple(sorted(snap.extended))
        else:
            extended = ()
        if self._reload_roots:
            real = os.path.realpath(path)
            inside = False
            for root in self._reload_roots:
                try:
                    inside = os.path.commonpath([real, root]) == root
                except ValueError:  # mixed absolute/relative or drives
                    inside = False
                if inside:
                    break
            if not inside:
                raise PermissionError(
                    f"reload path {path!r} outside the allowed roots"
                )
            path = real
        new_fixture, new_snap, _ = resolve_source(
            path, semantics, extended_resources=extended
        )
        # The port re-stages on reload (the JAX server's reload only
        # drops the old staging): the next request finds the new
        # snapshot on the card.
        self.replace_snapshot(new_snap, new_fixture, warm=True)
        return {"nodes": new_snap.n_nodes, "semantics": new_snap.semantics}

    def _op_update(self, msg: dict) -> dict:
        """Apply watch-style node/pod events to the served snapshot.

        Incremental (per-row recompute via :class:`..store.ClusterStore`)
        — the informer analog of the reference's full re-walk.  Events
        apply in order; on a bad event the ops before it stay applied and
        the served snapshot is re-synced to the store before the error
        surfaces.  The retired snapshot's staging is dropped; the next
        sweep stages the new generation.
        """
        from kubernetesclustercapacity_tpu_torch.store import ClusterStore

        self._require_leader()
        events = msg.get("events")
        if not isinstance(events, list):
            raise ValueError("update needs an 'events' list")
        clk = _phases.current()
        with _lock_wait() as acquired, self._lock:
            acquired()
            if self._fixture_source is not None:
                # A follower feeds this server: an op-side store would be
                # clobbered by the next coalesced publish, silently
                # discarding the client's events.  The cluster itself is
                # the write surface here.
                raise ValueError(
                    "this server follows a live cluster (-follow); "
                    "update events must go to the cluster, not the server"
                )
            if self._store is None:
                if self.fixture is None:
                    raise ValueError(
                        "update needs a fixture-backed source (.json); "
                        ".npz checkpoints carry no raw objects to update"
                    )
                _hostmem.milestone("store_start")
                self._store = ClusterStore(
                    self.fixture,
                    semantics=self.snapshot.semantics,
                    extended_resources=tuple(sorted(self.snapshot.extended)),
                )
                _hostmem.milestone("store_built")
            old = self.snapshot
            try:
                with clk.phase("apply"):
                    self._store.apply(events)
            finally:
                with clk.phase("repack"):
                    snap = self.snapshot = self._store.snapshot()
                    self._implicit_mask = _implicit_taint_mask(snap)
                self._fixture_dirty = True  # rebuilt on demand (cpu fit)
                self._generation += 1
                generation = self._generation
                # Registered with the first store, so a server that never
                # takes an update exposes the JAX server's families alone.
                gauge = self.registry.gauge(
                    "kccap_store_pods",
                    "Pods the update store holds, by form: an encoded "
                    "record or a deep copy (the encoder's fallback).",
                    ("form",),
                )
                for form, count in self._store.pod_forms().items():
                    gauge.set(count, form=form)
        if old is not snap:
            _devcache.CACHE.invalidate(old)
        # update is a mutation op (never the query hot path): observing
        # on its dispatch thread keeps the record synchronous with the
        # event batch that produced the generation.
        self._observe_timeline(snap, generation)
        self._audit_generation(snap, generation)
        return {
            "nodes": snap.n_nodes,
            "healthy_nodes": int(np.sum(snap.healthy)),
            "applied": len(events),
        }


def follow_publisher(server: CapacityServer, follower, *,
                     coalesce_ms: int = 100):
    """Wire a listed follower (``start(watch=False)``) to ``server``, then
    start its watches.

    Watch events are applied to the follower's store per row; snapshot
    PUBLICATION (a repack and a swap into the server) is coalesced: the
    first event flushes at once, bursts collapse to one trailing publish
    per ``coalesce_ms`` window.  Each publish hands the server the
    follower's snapshot with ``fixture_source=follower.fixture_view``
    and ``warm=True``, so the new generation is pre-staged on the card on
    the coalescer's worker thread.  A failing publish is fatal: it is
    recorded in the returned list and stops the follower — answering from
    a silently frozen snapshot is the one unacceptable outcome.  Returns
    ``(coalescer, publish_fatal)``.
    """
    from kubernetesclustercapacity_tpu_torch.service.coalesce import (
        SnapshotCoalescer,
    )

    publish_fatal: list[str] = []

    def _publish_failed(err: str) -> None:
        publish_fatal.append(err)
        follower.stop()

    coalescer = SnapshotCoalescer(
        lambda: server.replace_snapshot(
            follower.snapshot(),
            fixture_source=follower.fixture_view,
            warm=True,
        ),
        min_interval_s=max(coalesce_ms, 0) / 1e3,
        on_error=_publish_failed,
    )
    follower.on_event = coalescer.notify
    follower.start_watches()  # after wiring: no event can be missed
    return coalescer, publish_fatal


def healthz_probes(server: CapacityServer, *, follower=None, coalescers=(),
                   timeline=None, slo=None, audit_log=None, shadow=None,
                   plane=None, subscriber=None, profiler=None):
    """``(healthy, status)``: the two callables a
    :class:`~..telemetry.exposition.MetricsServer` takes for ``/healthz``,
    as the JAX server's ``main`` wires them.

    ``status`` is the freshness evidence merged into the body: the served
    generation; the follower's last-relist age and fatal error; the
    coalescer's counters (``coalescers`` is read at probe time, so a
    caller may fill it after the endpoint starts); the timeline's stats;
    the audit log's and the shadow sampler's; the SLO monitor's
    (evaluated on read); the plane's (the leader's ``plane`` publisher or
    the replica's ``subscriber``); ``draining``; the device ledger,
    reconciled on every probe; and the sampling ``profiler``'s stats.
    ``healthy`` is False — a 503 — while the
    follower is dead, the shadow oracle has caught a divergence, an SLO
    fast-burns, a capacity-at-risk, gang or forecast watch is breached,
    the replica is stale, a drain has begun, or the device ledger sees a
    sustained leak or a breached budget.  Plain watch breaches stay
    advisory: they describe the cluster, not the promise this server
    makes.
    """

    def status() -> dict:
        out = {"snapshot_generation": server.generation}
        if follower is not None:
            out["follower"] = {
                "last_relist_age_s": follower.last_relist_age_s(),
                "fatal": follower.fatal,
            }
        if coalescers:
            out["coalescer"] = coalescers[0].stats()
        if timeline is not None:
            out["timeline"] = timeline.stats()
        if audit_log is not None:
            out["audit"] = audit_log.stats()
        if shadow is not None:
            # A diverged shadow oracle is a correctness incident, and the
            # scraper must see it.
            out["shadow"] = shadow.stats()
        if slo is not None:
            slo.evaluate()
            out["slo"] = slo.stats()
        if plane is not None:
            out["plane"] = plane.stats()
        elif subscriber is not None:
            out["plane"] = subscriber.stats()
        if server.draining:
            out["draining"] = True
        if _memledger.enabled():
            try:
                _memledger.LEDGER.reconcile()
            except Exception:  # noqa: BLE001 - audit != liveness
                pass
            out["device_memory"] = _memledger.LEDGER.stats()
        if profiler is not None:
            out["profiler"] = profiler.stats()
        return out

    def healthy() -> bool:
        if follower is not None and follower.fatal is not None:
            return False
        if shadow is not None and shadow.diverged:
            return False
        if slo is not None and slo.fast_burning:
            return False
        if timeline is not None and (
            timeline.car_breached()
            or timeline.gang_breached()
            or timeline.forecast_breached()
        ):
            return False
        if subscriber is not None and subscriber.stale:
            return False
        if server.draining:
            return False
        if _memledger.enabled() and (
            _memledger.LEDGER.leaking()
            or _memledger.LEDGER.budget_breached()
        ):
            return False
        return True

    return healthy, status


# The JAX server's flags for subsystems not ported yet (see the CLI's
# table): each would be declared, so that using it exits 1 with "not yet
# ported".  None is left.
_UNPORTED_SERVER_FLAGS: tuple = ()


def build_parser():
    import argparse

    from kubernetesclustercapacity_tpu_torch.cli import add_unported_flags

    p = argparse.ArgumentParser(prog="kccap-torch-server")
    p.add_argument("-snapshot", default=None,
                   help="fixture .json / checkpoint .npz to serve")
    p.add_argument("-follow", action="store_true",
                   help="serve a live cluster and stay synced (list+watch)")
    p.add_argument("-kubeconfig", default=None,
                   help="kubeconfig for -follow (default: $KUBECONFIG or "
                        "$HOME/.kube/config)")
    p.add_argument("-port", type=int, default=7077)
    p.add_argument("-host", default="127.0.0.1")
    p.add_argument("-semantics", choices=("reference", "strict"),
                   default=None)
    p.add_argument("-extended-resources", default="",
                   dest="extended_resources", metavar="NAMES",
                   help="comma-separated extra resource columns to pack "
                        "(strict semantics; e.g. nvidia.com/gpu,"
                        "ephemeral-storage) — enables sweep_multi over them")
    p.add_argument("-coalesce-ms", type=int, default=100, dest="coalesce_ms",
                   help="min interval between snapshot repacks under "
                        "-follow churn (0 = repack on every event)")
    p.add_argument("-auth-token-file", default=None, dest="auth_token_file",
                   help="file holding the shared bearer token; when set (or "
                        "$KCCAP_AUTH_TOKEN is), every op except ping must "
                        "carry it")
    p.add_argument("-max-inflight", type=int, default=8, dest="max_inflight",
                   help="max concurrently-executing compute requests")
    p.add_argument("-reload-root", action="append", default=[],
                   dest="reload_roots", metavar="DIR",
                   help="restrict reload paths to this directory "
                        "(repeatable; default: unrestricted)")
    p.add_argument("-metrics-port", type=int, default=0, dest="metrics_port",
                   metavar="PORT",
                   help="serve Prometheus /metrics and /healthz on this "
                        "port (0 = disabled); binds the -host address")
    p.add_argument("-profile-hz", type=float, default=0.0,
                   dest="profile_hz", metavar="HZ",
                   help="continuous-profiler sampling rate (0 = "
                        "KCCAP_PROFILE_HZ or the 29 Hz default); the "
                        "profiler itself arms with the server unless "
                        "KCCAP_PROFILER=0, and serves collapsed "
                        "flamegraphs at /debug/profile?seconds=N on "
                        "the metrics port")
    p.add_argument("-device-budget-bytes", type=int, default=0,
                   dest="device_budget_bytes", metavar="BYTES",
                   help="device-memory budget: when the ledger's live "
                        "staged bytes exceed this, /healthz carries a "
                        "budget_breached signal and answers 503 "
                        "(0 = no budget)")
    p.add_argument("-trace-log", default=None, dest="trace_log",
                   metavar="PATH",
                   help="append one JSONL span per dispatched request "
                        "(trace_id, op, duration, status) to PATH")
    p.add_argument("-trace-log-max-bytes", type=int, default=0,
                   dest="trace_log_max_bytes", metavar="N",
                   help="rotate the -trace-log file to PATH.1 once it "
                        "exceeds N bytes (0 = unbounded)")
    p.add_argument("-trace-sample", default="always", dest="trace_sample",
                   metavar="SPEC",
                   help="tail-based sampling policy for -trace-log span "
                        "bodies: always | p99-breach | errors | rate:N "
                        "(ids still propagate for every request; the "
                        "keep/drop decision happens at request END so "
                        "breaching requests keep their whole span tree)")
    p.add_argument("-flight-records", type=int, default=256,
                   dest="flight_records", metavar="K",
                   help="flight-recorder depth: remember the last K "
                        "dispatched requests (served by the dump op)")
    p.add_argument("-flight-dump", default=None, dest="flight_dump",
                   metavar="PATH",
                   help="append the flight recorder as JSONL to PATH "
                        "whenever a dispatch raises")
    p.add_argument("-batch-window-ms", type=float, default=1.0,
                   dest="batch_window_ms", metavar="MS",
                   help="micro-batch concurrent sweeps of one snapshot "
                        "generation for up to MS milliseconds into one "
                        "kernel launch (0 = dispatch every sweep solo)")
    p.add_argument("-batch-max", type=int, default=32, dest="batch_max",
                   metavar="N",
                   help="max requests per micro-batch (a full batch "
                        "dispatches before the window closes)")
    p.add_argument("-node-bucket-floor", type=int, default=0,
                   dest="node_bucket_floor", metavar="N",
                   help="accepted for the JAX server's sake and ignored: "
                        "the PyTorch package has no shape-bucket ladder")
    p.add_argument("-group-min-count", type=int, default=0,
                   dest="group_min_count", metavar="K",
                   help="minimum mean nodes per node shape for sweeps to "
                        "run over node-shape groups (0 = keep the "
                        "default/KCCAP_GROUP_MIN_COUNT setting)")
    p.add_argument("-watch", default=None, metavar="FILE",
                   help="watchlist (YAML/JSON) of named scenarios the "
                        "capacity timeline re-evaluates on every snapshot "
                        "publish; entries with min_replicas arm the "
                        "ok/breached/recovered alert machine (enables the "
                        "timeline op and kccap_watch_* gauges)")
    p.add_argument("-timeline-depth", type=int, default=0,
                   dest="timeline_depth", metavar="K",
                   help="keep a capacity timeline of the last K snapshot "
                        "generations (served by the timeline op; 0 = "
                        "disabled unless -watch is given, which implies 64)")
    p.add_argument("-timeline-log", default=None, dest="timeline_log",
                   metavar="PATH",
                   help="append one JSONL line per observed generation "
                        "and per watch alert transition to PATH")
    p.add_argument("-log-json", default=None, dest="log_json",
                   metavar="PATH",
                   help="structured request logging: append one JSON "
                        "line per dispatched request (op, trace_id, "
                        "span_id, generation, latency_ms, status) to "
                        "PATH; span_id joins these lines to -trace-log "
                        "spans")
    p.add_argument("-log-json-max-bytes", type=int, default=0,
                   dest="log_json_max_bytes", metavar="N",
                   help="rotate the -log-json file to PATH.1 once it "
                        "exceeds N bytes (0 = unbounded)")
    p.add_argument("-audit-dir", default=None, dest="audit_dir",
                   metavar="DIR",
                   help="durable audit log: append JSONL segments to "
                        "DIR recording every snapshot generation "
                        "(invertible diffs + periodic checkpoints, "
                        "digest-chained) and every answering/mutating "
                        "request (full args + result digest) — replay "
                        "offline with kccap-torch -replay DIR")
    p.add_argument("-audit-max-bytes", type=int, default=8 << 20,
                   dest="audit_max_bytes", metavar="N",
                   help="rotate audit segments once they exceed N "
                        "bytes (default 8 MiB)")
    p.add_argument("-audit-checkpoint-every", type=int, default=16,
                   dest="audit_checkpoint_every", metavar="K",
                   help="write a full-snapshot checkpoint every K "
                        "generations (bounds replay cost; default 16)")
    p.add_argument("-shadow-sample-rate", type=float, default=0.0,
                   dest="shadow_sample_rate", metavar="FRACTION",
                   help="re-check this fraction of live sweep "
                        "responses against the pure-Python oracle, off "
                        "the request path (0 = off); a divergence "
                        "flips /healthz, trips the shadow alert, and "
                        "writes a repro bundle")
    p.add_argument("-shadow-bundle", default=None, dest="shadow_bundle",
                   metavar="PATH",
                   help="append shadow-divergence repro bundles as "
                        "JSONL to PATH (default: "
                        "<audit-dir>/shadow-divergence.jsonl when "
                        "-audit-dir is set)")
    p.add_argument("-slo", default=None, metavar="FILE",
                   help="SLO file (YAML/JSON): latency objectives "
                        "('p99 < 80ms', per op or all ops) and "
                        "availability objectives ('99.9%%') evaluated "
                        "as multi-window error-budget burn rates over "
                        "the server's own request metrics; a fast burn "
                        "flips /healthz to 503 and the kccap_slo_* "
                        "gauges (enables the slo op / -slo-status)")
    p.add_argument("-slo-log", default=None, dest="slo_log",
                   metavar="PATH",
                   help="append one JSONL line per SLO alert "
                        "transition (ok→breached→recovered) to PATH")
    p.add_argument("-slo-eval-s", type=float, default=5.0,
                   dest="slo_eval_s", metavar="SECONDS",
                   help="background SLO evaluation cadence (the slo op "
                        "and /healthz also evaluate on read)")
    p.add_argument("-plane-port", type=int, default=0, dest="plane_port",
                   metavar="PORT",
                   help="serve the replication plane on this port "
                        "(LEADER mode): every published snapshot "
                        "generation fans out to subscribed replica "
                        "servers as digest-chained checkpoint/diff "
                        "frames (0 = no plane)")
    p.add_argument("-plane-leader", default=None, dest="plane_leader",
                   metavar="HOST:PORT",
                   help="follow another server's replication plane "
                        "(REPLICA mode): stage each digest-verified "
                        "generation from the leader's stream and serve "
                        "it read-only, stamped with the leader's "
                        "generation numbers")
    p.add_argument("-plane-stale-after-s", type=float, default=10.0,
                   dest="plane_stale_after_s", metavar="SECONDS",
                   help="replica staleness bound: with no plane frame "
                        "(heartbeats included) for this long, the "
                        "replica reports itself stale via info/healthz "
                        "so clients route around it")
    p.add_argument("-admission-max-concurrent", type=int, default=0,
                   dest="admission_max_concurrent", metavar="N",
                   help="admission control: at most N compute requests "
                        "admitted at once; excess queues briefly then "
                        "sheds with the retryable-elsewhere "
                        "'overloaded' error (0 = no concurrency gate)")
    p.add_argument("-admission-rps", type=float, default=0.0,
                   dest="admission_rps", metavar="RPS",
                   help="admission control: token-bucket cap on "
                        "admitted compute requests per second "
                        "(0 = no rps cap)")
    p.add_argument("-admission-burst", type=float, default=0.0,
                   dest="admission_burst", metavar="N",
                   help="token-bucket burst capacity for -admission-rps "
                        "(0 = max(rps, 1))")
    p.add_argument("-admission-price-budget", type=float, default=0.0,
                   dest="admission_price_budget", metavar="SHARE",
                   help="shed-by-shadow-price: while the last CERTIFIED "
                        "optimize solve prices more than this share of "
                        "capacity (its shadow-price capacity_share in "
                        "(0, 1]), compute requests shed with the "
                        "retryable-elsewhere 'overloaded' error "
                        "(0 = no price gate; the optimize op itself is "
                        "never price-gated)")
    p.add_argument("-tenants", default=None, metavar="FILE",
                   help="tenant map (YAML/JSON): named tenants with "
                        "per-tenant auth tokens, rps caps, concurrency "
                        "quotas, and weighted-fair admission weights; "
                        "requests are attributed by token (old "
                        "tenantless clients become 'default'), quota "
                        "overage sheds with the authoritative "
                        "'tenant_quota' error, and kccap_tenant_* "
                        "metrics follow the identity with bounded "
                        "cardinality (KCCAP_TENANCY=0 disables)")
    p.add_argument("-drain-timeout-s", type=float, default=10.0,
                   dest="drain_timeout_s", metavar="SECONDS",
                   help="graceful drain bound (SIGTERM/SIGINT or the "
                        "drain_server op): stop accepting compute/"
                        "mutation ops, wait up to this long for "
                        "in-flight work, emit the final drain record, "
                        "then exit")
    p.add_argument("-device", choices=("cuda", "cpu"), default="cuda",
                   help="keep the snapshot on the GPU (default) or the host")
    add_unported_flags(p, _UNPORTED_SERVER_FLAGS)
    return p


def main(argv=None) -> int:
    """``python -m kubernetesclustercapacity_tpu_torch.service.server
    -snapshot ... -port N`` (or ``-follow [-kubeconfig PATH]``)"""
    import signal
    import sys

    from kubernetesclustercapacity_tpu_torch.cli import (
        NO_BUCKET_LADDER,
        unported_flags_used,
    )

    args = build_parser().parse_args(argv)
    unported = unported_flags_used(args, _UNPORTED_SERVER_FLAGS)
    if unported:
        print(f"ERROR : {', '.join(unported)}: not yet ported to the "
              "PyTorch package ...exiting", file=sys.stderr)
        return 1
    # `or None`: an empty-but-set env var must not enable auth with an
    # empty token (which would lock out every client).
    auth_token = os.environ.get("KCCAP_AUTH_TOKEN") or None
    if args.auth_token_file:
        try:
            with open(args.auth_token_file, encoding="utf-8") as fh:
                auth_token = fh.read().strip()
        except OSError as e:
            print(f"ERROR : cannot read auth token file: {e}",
                  file=sys.stderr)
            return 1
        if not auth_token:
            print("ERROR : auth token file is empty", file=sys.stderr)
            return 1
    if args.node_bucket_floor > 0:
        print(NO_BUCKET_LADDER, file=sys.stderr)
    if args.group_min_count > 0:
        from kubernetesclustercapacity_tpu_torch import (
            snapshot as _snapshot_mod,
        )

        _snapshot_mod.set_group_min_count(args.group_min_count)
    extended = tuple(
        r.strip() for r in args.extended_resources.split(",") if r.strip()
    )
    # One process registry feeds every layer — follower sync counters and
    # server request metrics — so info {metrics: true} is the whole story.
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import REGISTRY

    follower = None
    try:
        if args.follow:
            # The packers enforce the strict-only extended-columns rule as
            # the backstop; checking argv here too avoids paying a full
            # live-cluster LIST before a config error knowable up front.
            if extended and (args.semantics or "reference") != "strict":
                raise ValueError(
                    "-extended-resources requires -semantics strict "
                    "(reference semantics has no extended-column concept)"
                )
            from kubernetesclustercapacity_tpu_torch.follower import (
                ClusterFollower,
            )

            follower = ClusterFollower(
                args.kubeconfig,
                semantics=args.semantics or "reference",
                extended_resources=extended,
                registry=REGISTRY,
            ).start(watch=False)
            snap, fixture = follower.snapshot(), follower.fixture_view()
        elif args.snapshot:
            fixture, snap, _ = resolve_source(
                args.snapshot, args.semantics, extended_resources=extended
            )
        else:
            raise ValueError("one of -snapshot or -follow is required")
    except Exception as e:  # noqa: BLE001 - one error line, exit 1
        print(f"ERROR : {e}", file=sys.stderr)
        return 1

    def _fail(line: str) -> int:
        print(line, file=sys.stderr)
        if follower is not None:
            follower.stop()
        stop_profiler()
        return 1

    from kubernetesclustercapacity_tpu_torch.telemetry.profiler import (
        start_profiler,
        stop_profiler,
    )
    from kubernetesclustercapacity_tpu_torch.telemetry.tracing import TraceLog

    trace_log = None
    if args.trace_log:
        trace_log = TraceLog(
            args.trace_log, max_bytes=max(args.trace_log_max_bytes, 0)
        )
    try:
        _tracectx.parse_sample_spec(args.trace_sample)
    except ValueError as e:
        return _fail(f"ERROR : {e}")
    # Process self-telemetry (RSS/fds/threads/GC + build info) on the
    # registry the scrape serves — a no-op under KCCAP_TELEMETRY=0.
    from kubernetesclustercapacity_tpu_torch.telemetry.process import (
        register_process_metrics,
    )

    register_process_metrics(REGISTRY)
    # The continuous profiler rides the whole serve (KCCAP_PROFILER=0
    # pins it to zero threads + zero registry calls).
    profiler = start_profiler(
        args.profile_hz if args.profile_hz > 0 else None
    )
    if args.device_budget_bytes > 0:
        _memledger.LEDGER.set_budget(args.device_budget_bytes)
    timeline = None
    if args.watch or args.timeline_depth > 0 or args.timeline_log:
        from kubernetesclustercapacity_tpu_torch.timeline.history import (
            CapacityTimeline,
        )
        from kubernetesclustercapacity_tpu_torch.timeline.watchlist import (
            WatchError,
            load_watchlist,
        )

        watches = ()
        if args.watch:
            try:
                watches = load_watchlist(args.watch)
            except (OSError, WatchError) as e:
                return _fail(f"ERROR : bad watchlist: {e}")
        timeline = CapacityTimeline(
            watches,
            depth=args.timeline_depth if args.timeline_depth > 0 else 64,
            registry=REGISTRY,
            log=args.timeline_log,
            device=args.device,
        )
    request_log = None
    if args.log_json:
        request_log = TraceLog(
            args.log_json, max_bytes=max(args.log_json_max_bytes, 0)
        )
    audit_log = None
    if args.audit_dir:
        from kubernetesclustercapacity_tpu_torch.audit import AuditLog

        try:
            audit_log = AuditLog(
                args.audit_dir,
                segment_max_bytes=max(args.audit_max_bytes, 1),
                checkpoint_every=max(args.audit_checkpoint_every, 1),
                registry=REGISTRY,
            )
        except OSError as e:
            return _fail(f"ERROR : cannot open audit dir: {e}")
    shadow = None
    if args.shadow_sample_rate > 0:
        from kubernetesclustercapacity_tpu_torch.audit import ShadowSampler

        bundle = args.shadow_bundle
        if bundle is None and args.audit_dir:
            bundle = os.path.join(args.audit_dir, "shadow-divergence.jsonl")
        try:
            shadow = ShadowSampler(
                args.shadow_sample_rate,
                registry=REGISTRY,
                bundle_path=bundle,
                audit_log=audit_log,
            )
        except ValueError as e:
            return _fail(f"ERROR : {e}")
    slo_monitor = None
    if args.slo:
        from kubernetesclustercapacity_tpu_torch.telemetry.slo import (
            SLOError,
            SLOMonitor,
            load_slos,
        )

        try:
            slo_monitor = SLOMonitor(
                load_slos(args.slo),
                registry=REGISTRY,
                log=args.slo_log,
            ).start(max(args.slo_eval_s, 0.5))
        except (OSError, SLOError) as e:
            return _fail(f"ERROR : bad SLO file: {e}")
    tenants = None
    if args.tenants:
        from kubernetesclustercapacity_tpu_torch.service import tenancy

        if not tenancy.enabled():
            # The escape hatch beats the flag: KCCAP_TENANCY=0 keeps the
            # tenantless single-queue admission path.
            print("WARN  : -tenants ignored (KCCAP_TENANCY=0)",
                  file=sys.stderr)
        else:
            try:
                tenants = tenancy.load_tenants(args.tenants)
            except (OSError, tenancy.TenancyError) as e:
                return _fail(f"ERROR : bad tenant map: {e}")
    admission = None
    if (
        args.admission_max_concurrent > 0
        or args.admission_rps > 0
        or args.admission_price_budget > 0
        or tenants is not None
    ):
        from kubernetesclustercapacity_tpu_torch.service.plane import (
            AdmissionController,
        )

        if not 0.0 <= args.admission_price_budget <= 1.0:
            return _fail("ERROR : -admission-price-budget must be in [0, 1]")
        admission = AdmissionController(
            max_concurrent=max(args.admission_max_concurrent, 0),
            rps=max(args.admission_rps, 0.0),
            burst=args.admission_burst if args.admission_burst > 0 else None,
            price_budget=args.admission_price_budget,
            registry=REGISTRY,
            tenants=tenants,
        )
    plane_pub = None
    if args.plane_port:
        if args.plane_leader:
            return _fail("ERROR : -plane-port (leader) and -plane-leader "
                         "(replica) are mutually exclusive")
        from kubernetesclustercapacity_tpu_torch.service.plane import (
            PlanePublisher,
        )

        try:
            plane_pub = PlanePublisher(
                host=args.host, port=args.plane_port,
                token=auth_token, registry=REGISTRY,
                trace_log=trace_log,
            )
        except OSError as e:
            return _fail(f"ERROR : cannot bind plane port: {e}")

    server = CapacityServer(
        snap,
        host=args.host,
        port=args.port,
        fixture=fixture,
        auth_token=auth_token,
        max_inflight=args.max_inflight,
        reload_roots=tuple(args.reload_roots),
        registry=REGISTRY,
        trace_log=trace_log,
        trace_sample=args.trace_sample,
        flight_records=max(args.flight_records, 1),
        flight_dump_path=args.flight_dump,
        batch_window_ms=max(args.batch_window_ms, 0.0),
        batch_max=max(args.batch_max, 1),
        drain_timeout_s=max(args.drain_timeout_s, 0.0),
        device=args.device,
        # -follow: the follower's retry/backoff/degradation counters ride
        # info's resilience section.
        stats_source=follower.stats if follower is not None else None,
        timeline=timeline,
        request_log=request_log,
        slo=slo_monitor,
        audit_log=audit_log,
        shadow=shadow,
        admission=admission,
        plane=plane_pub,
        tenants=tenants,
    )
    subscriber = None
    if args.plane_leader:
        if args.follow:
            server.shutdown()
            return _fail("ERROR : a plane replica (-plane-leader) cannot "
                         "also -follow a cluster (its state IS the "
                         "leader's stream)")
        from kubernetesclustercapacity_tpu_torch.service.plane import (
            PlaneSubscriber,
        )

        host_s, _, port_s = args.plane_leader.rpartition(":")
        if not host_s or not port_s.isdigit():
            server.shutdown()
            return _fail(f"ERROR : bad -plane-leader {args.plane_leader!r} "
                         "(want HOST:PORT)")
        subscriber = PlaneSubscriber(
            (host_s, int(port_s)),
            server,
            token=auth_token,
            stale_after_s=max(args.plane_stale_after_s, 0.1),
            registry=REGISTRY,
            trace_log=trace_log,
        )
    metrics_server = None
    coalescers: list = []  # filled below; /healthz reads it per probe
    if args.metrics_port:
        from kubernetesclustercapacity_tpu_torch.telemetry.exposition import (
            start_metrics_server,
        )

        healthy, status = healthz_probes(
            server, follower=follower, coalescers=coalescers,
            timeline=timeline, slo=slo_monitor, audit_log=audit_log,
            shadow=shadow, plane=plane_pub, subscriber=subscriber,
            profiler=profiler,
        )
        try:
            metrics_server = start_metrics_server(
                REGISTRY,
                host=args.host,
                port=args.metrics_port,
                healthy=healthy,
                status=status,
                debug=(
                    {"/debug/profile": profiler.debug_handler}
                    if profiler is not None
                    else None
                ),
            )
        except OSError as e:
            server.shutdown()
            return _fail(f"ERROR : cannot bind metrics port: {e}")
        print(
            f"metrics on http://{metrics_server.address[0]}:"
            f"{metrics_server.address[1]}/metrics",
            file=sys.stderr,
        )
    coalescer = None
    publish_fatal: list[str] = []
    if follower is not None:
        coalescer, publish_fatal = follow_publisher(
            server, follower, coalesce_ms=args.coalesce_ms
        )
        coalescers.append(coalescer)

    # Graceful shutdown: SIGTERM/SIGINT and the drain_server op all route
    # through begin_drain, then stop the serve loop on its own thread
    # after a short grace so the drain op's reply flushes first.
    def _stop_serving(record: dict) -> None:
        def _stop() -> None:
            try:
                time.sleep(0.25)  # let replies flush before teardown
                if follower is not None:
                    follower.stop()
            except Exception as e:  # noqa: BLE001 - shutdown must follow
                print(f"drain teardown: {type(e).__name__}: {e}",
                      file=sys.stderr)
            try:
                server.shutdown()
            except Exception as e:  # noqa: BLE001 - last resort is loud
                print(f"drain shutdown: {type(e).__name__}: {e}",
                      file=sys.stderr)

        print(
            f"drain complete: inflight_at_start="
            f"{record.get('inflight_at_start')} "
            f"drained={record.get('drained')} "
            f"waited_s={record.get('waited_s')}",
            file=sys.stderr,
        )
        threading.Thread(target=_stop, daemon=True).start()

    server.on_drained = _stop_serving

    def _graceful_exit(signum, frame) -> None:
        print(f"draining on signal {signum} ...", file=sys.stderr)
        threading.Thread(
            target=server.begin_drain,
            kwargs={"reason": f"signal {signum}"},
            daemon=True,
        ).start()

    try:
        signal.signal(signal.SIGTERM, _graceful_exit)
        signal.signal(signal.SIGINT, _graceful_exit)
    except ValueError:
        pass  # not the main thread (embedded/test use): signals stay default
    print(
        f"serving {snap.n_nodes} nodes ({snap.semantics}) on "
        f"{server.address[0]}:{server.address[1]} ({server.device})",
        file=sys.stderr,
    )
    try:
        if follower is None:
            server.serve_forever()
        else:
            # Supervised serve: if the follower dies (fatal watch-thread
            # failure, a failed publish, or a drain's teardown), the
            # service stops WITH it — silently answering every query from
            # a snapshot frozen at the failure instant is the one
            # unacceptable outcome.
            server.start()
            while not follower.wait_stopped(1.0):
                pass
            if follower.fatal is not None:
                print(f"ERROR : follower died: {follower.fatal}",
                      file=sys.stderr)
                return 2
            if publish_fatal:
                print(f"ERROR : snapshot publish failed: {publish_fatal[0]}",
                      file=sys.stderr)
                return 2
    except KeyboardInterrupt:
        pass
    finally:
        if subscriber is not None:
            subscriber.stop()
        if plane_pub is not None:
            plane_pub.close()
        if follower is not None:
            follower.stop()
        if coalescer is not None:
            coalescer.stop()
        if metrics_server is not None:
            metrics_server.shutdown()
        if timeline is not None:
            timeline.close()  # flush the -timeline-log JSONL
        if slo_monitor is not None:
            slo_monitor.close()  # stop the evaluator, flush -slo-log
        if shadow is not None:
            shadow.close()
        if audit_log is not None:
            audit_log.close()
        stop_profiler()
        server.shutdown()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
