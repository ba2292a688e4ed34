"""The federation tier: partition-tolerant fleet queries over N clusters.

Counterpart of ``kubernetesclustercapacity_tpu/federation/server.py``: the
host logic (the feeds, the degradation states, ``_survey``, the
``fed_rank`` sort key, the ``spillover`` greedy fill, the wire handler and
``main``) is the JAX module's, verbatim.  The one difference is where the
batched evaluation runs: :class:`FederationServer` takes ``device=``
(default ``"cuda"``, raising without a card) and hands it to the port's
exact program, :func:`..ops.fit.sweep_snapshot`, and ``kccap-torch-fed``
takes ``-device cuda|cpu``.

Topology: each member cluster runs its own plane leader (a
``kccap-torch-server -plane-port`` fed by its own follower); the
:class:`FederationServer` subscribes to every leader's plane stream
through the SAME :class:`~..service.plane.PlaneSubscriber` machinery a
replica uses — every staged generation is digest-verified against its
frame, diffs must chain from the held digest, and a garbled, gapped, or
regressing stream is refused and resynced through a fresh checkpoint,
never mis-applied.  Each cluster's verified snapshot lands in a
:class:`ClusterFeed` (the subscriber's staging target) with a
per-cluster generation watermark that is monotone by construction.

Queries (``fed_sweep`` / ``fed_rank`` / ``spillover``) evaluate as ONE
batched kernel dispatch per semantics group: the non-lost clusters'
node arrays concatenate into a single :class:`~..snapshot
.ClusterSnapshot` (memoized per member-generation vector, so repeated
queries reuse the device-resident staging), ride the existing
devcache/bucketing/grouped stack unchanged — (shape, count) grouping
dedups shapes ACROSS clusters for free — and per-cluster totals fall
out of the per-node fit matrix by segment sums at the cluster
boundaries, bit-exact per cluster against ``fit_arrays_python`` at each
cluster's stamped generation (fit is per-node independent, so the
concatenated dispatch IS the per-cluster dispatch).

The degradation contract (the point of the module): every reply carries
a per-cluster ``{generation, age_s, state}`` vector driven by the
subscriber's :meth:`~..service.plane.PlaneSubscriber
.last_verified_age_s` clock —

* ``fresh``  — verified within ``stale_after_s``;
* ``stale``  — silent past ``stale_after_s``: the last VERIFIED
  snapshot keeps serving, explicitly annotated with its bounded age;
* ``lost``   — silent past ``evict_after_s`` (or never synced): the
  cluster is EXCLUDED from totals and NAMED in the reply's
  ``excluded`` list; cluster-scoped queries against it refuse with the
  typed ``cluster_lost`` wire code
  (:class:`~..resilience.ClusterLostError`).

``/healthz`` (the ``fed:`` watch in ``main``) goes 503 while any
cluster is lost, and heal is automatic: the subscriber resumes through
digest-match or a fresh checkpoint exactly like a plane replica, and
the next verified frame flips the cluster back to ``fresh``.
"""

from __future__ import annotations

import os
import socketserver
import threading
import time

import numpy as np

from kubernetesclustercapacity_tpu_torch.devcache import resolve_device
from kubernetesclustercapacity_tpu_torch.masks import implicit_taint_mask
from kubernetesclustercapacity_tpu_torch.ops.fit import sweep_snapshot
from kubernetesclustercapacity_tpu_torch.resilience import ClusterLostError
from kubernetesclustercapacity_tpu_torch.scenario import (
    ScenarioError,
    ScenarioGrid,
    scenario_from_flags,
)
from kubernetesclustercapacity_tpu_torch.service import protocol
from kubernetesclustercapacity_tpu_torch.snapshot import ClusterSnapshot

__all__ = [
    "CLUSTER_STATES",
    "ClusterFeed",
    "FederationError",
    "FederationServer",
    "concat_snapshots",
]

#: The degradation-contract vocabulary, in health order.
CLUSTER_STATES = ("fresh", "stale", "lost")

#: Env defaults for the staleness/eviction horizons (the ``kccap-torch-fed``
#: flags override; both in seconds on the injectable monotonic clock).
_STALE_ENV = "KCCAP_FED_STALE_AFTER_S"
_EVICT_ENV = "KCCAP_FED_EVICT_AFTER_S"


class FederationError(RuntimeError):
    """Federation-tier configuration/query violation (bad cluster name,
    regressing generation injection, malformed query)."""


class ClusterFeed:
    """A :class:`~..service.plane.PlaneSubscriber` staging target that
    is NOT a server: it holds one cluster's last verified snapshot and
    generation watermark under a lock.

    Quacks exactly enough like a :class:`~..service.server
    .CapacityServer` for the subscriber to stage into it
    (``replace_snapshot(snapshot, generation=...)`` /
    ``set_plane_role`` / ``add_drain_hook``), so the federation tier
    inherits the replica's entire verification story — digest chains,
    checkpoint resync, regression refusal — without duplicating a line
    of it.  The generation watermark is monotone by construction: a
    regressing stage raises (the subscriber already refuses to send
    one; this guard keeps direct injectors honest too).
    """

    def __init__(self, name: str, *, clock=time.monotonic) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._clock = clock
        self._snapshot: ClusterSnapshot | None = None
        self._generation = 0
        self._verified_at: float | None = None
        self._applied = 0
        self._plane_stats_source = None

    # -- the stage funnel (PlaneSubscriber's server surface) ---------------
    def replace_snapshot(
        self,
        snapshot: ClusterSnapshot,
        fixture=None,
        *,
        fixture_source=None,
        warm: bool = False,
        generation: int | None = None,
    ) -> None:
        with self._lock:
            gen = (
                self._generation + 1 if generation is None else int(generation)
            )
            if gen < self._generation:
                raise ValueError(
                    f"cluster {self.name!r}: generation must not regress: "
                    f"{gen} < held {self._generation}"
                )
            self._snapshot = snapshot
            self._generation = gen
            self._verified_at = self._clock()
            self._applied += 1

    def set_plane_role(self, role: str, stats_source=None) -> None:
        """The subscriber declares this feed a replica-side stage; keep
        its stats source so fed status can surface stream health."""
        with self._lock:
            if stats_source is not None:
                self._plane_stats_source = stats_source

    def add_drain_hook(self, hook) -> None:
        """Feeds have no drain lifecycle of their own (the federation
        server stops its subscribers directly)."""

    # -- read side ---------------------------------------------------------
    def view(self) -> tuple[ClusterSnapshot | None, int]:
        """The held (snapshot, generation) pair, atomically."""
        with self._lock:
            return self._snapshot, self._generation

    def last_verified_age_s(self) -> float | None:
        """Seconds since the feed last staged a verified generation
        (``None`` before the first) — the OFFLINE-injection freshness
        clock; wire-fed clusters read the subscriber's
        ``last_verified_age_s`` instead, which heartbeats also advance."""
        with self._lock:
            if self._verified_at is None:
                return None
            return self._clock() - self._verified_at

    def stream_stats(self) -> dict | None:
        """The subscriber's stats dict (via the stats source it handed
        ``set_plane_role``), or ``None`` for offline-injected feeds."""
        with self._lock:
            source = self._plane_stats_source
        if source is None:
            return None
        try:
            return source()
        except Exception as e:  # noqa: BLE001 - status must not fail reads
            return {"error": f"{type(e).__name__}: {e}"}


class _Cluster:
    """One federation member: its feed and (for wire-fed members) the
    plane subscriber following its leader."""

    def __init__(self, name: str, feed: ClusterFeed, subscriber=None) -> None:
        self.name = name
        self.feed = feed
        self.subscriber = subscriber

    def age_s(self) -> float | None:
        """The ONE staleness clock: the subscriber's verified age for
        wire-fed clusters (heartbeats keep a quiet-but-live leader
        fresh), the feed's stage age for offline-injected ones."""
        if self.subscriber is not None:
            return self.subscriber.last_verified_age_s()
        return self.feed.last_verified_age_s()


# ---------------------------------------------------------------------------
# Snapshot concatenation (the one-dispatch trick)
# ---------------------------------------------------------------------------
def concat_snapshots(snaps: list[ClusterSnapshot]) -> ClusterSnapshot:
    """Concatenate same-semantics cluster snapshots along the node axis.

    The combined snapshot is a first-class :class:`ClusterSnapshot`, so
    the whole dispatch stack — device cache, shape buckets, (shape,
    count) grouping (which now dedups shapes ACROSS clusters) — applies
    unchanged.  Row order is the member order, so per-cluster results
    are contiguous slices of any per-node output.  Extended columns are
    dropped: the plane's wire vocabulary never carries them, and the
    federation surface is the 2-resource fit (documented in the README).
    """
    if len(snaps) == 1:
        return snaps[0]
    any_taints = any(any(s.taints or []) for s in snaps)
    taints: list[list] = []
    if any_taints:
        for s in snaps:
            t = list(s.taints or [])
            if len(t) != s.n_nodes:
                t = [[] for _ in range(s.n_nodes)]
            taints.extend(t)
    return ClusterSnapshot(
        names=[n for s in snaps for n in s.names],
        alloc_cpu_milli=np.concatenate([s.alloc_cpu_milli for s in snaps]),
        alloc_mem_bytes=np.concatenate([s.alloc_mem_bytes for s in snaps]),
        alloc_pods=np.concatenate([s.alloc_pods for s in snaps]),
        used_cpu_req_milli=np.concatenate(
            [s.used_cpu_req_milli for s in snaps]
        ),
        used_cpu_lim_milli=np.concatenate(
            [s.used_cpu_lim_milli for s in snaps]
        ),
        used_mem_req_bytes=np.concatenate(
            [s.used_mem_req_bytes for s in snaps]
        ),
        used_mem_lim_bytes=np.concatenate(
            [s.used_mem_lim_bytes for s in snaps]
        ),
        pods_count=np.concatenate([s.pods_count for s in snaps]),
        healthy=np.concatenate([s.healthy for s in snaps]),
        semantics=snaps[0].semantics,
        taints=taints,
    )


# ---------------------------------------------------------------------------
# Wire plumbing (same framed-JSON protocol as the capacity service)
# ---------------------------------------------------------------------------
class _FedHandler(socketserver.BaseRequestHandler):
    def handle(self) -> None:  # one connection, many frames
        fed: "FederationServer" = self.server.federation_server  # type: ignore[attr-defined]
        while True:
            try:
                msg = protocol.recv_msg(self.request)
            except (protocol.ProtocolError, OSError):
                return
            if msg is None:
                return
            try:
                reply = {"ok": True, "result": fed.dispatch(msg)}
            except Exception as e:  # noqa: BLE001 - service boundary
                reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                code = getattr(e, "wire_code", None)
                if isinstance(code, str):
                    reply["code"] = code
            try:
                protocol.send_msg(self.request, reply)
            except OSError:
                return


class _FedTCPServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class FederationServer:
    """Hold N clusters' verified snapshots; answer fleet-global queries.

    ``clusters`` maps cluster name → plane ``(host, port)`` (each a
    plane leader's ``-plane-port``); a :class:`~..service.plane
    .PlaneSubscriber` follows each stream into that cluster's
    :class:`ClusterFeed`.  :meth:`inject` feeds a cluster WITHOUT a
    wire (offline what-ifs, the bench's simulated fleet, tests).

    ``stale_after_s`` / ``evict_after_s`` are the degradation horizons
    (defaults: ``KCCAP_FED_STALE_AFTER_S`` / ``KCCAP_FED_EVICT_AFTER_S``
    env, then 10 s / 60 s); ``clock`` injects the monotonic clock those
    horizons are measured on, so chaos tests pin exact transitions.
    ``device`` is where the batched evaluation runs (``"cuda"``, the
    default, raises when no card is present; ``"cpu"`` runs on the host).
    """

    _KNOWN_OPS = frozenset(
        {"ping", "info", "fed_status", "fed_sweep", "fed_rank", "spillover"}
    )

    def __init__(
        self,
        clusters: dict[str, tuple[str, int]] | None = None,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        stale_after_s: float | None = None,
        evict_after_s: float | None = None,
        auth_token: str | None = None,
        plane_token: str | None = None,
        registry=None,
        clock=time.monotonic,
        seed: int | None = None,
        trace_log=None,
        trace_sample: str = "always",
        device="cuda",
    ) -> None:
        """``trace_log`` (a path or :class:`~..telemetry.TraceLog`)
        records one span tree per federation query: a ``fed:{op}``
        request span plus one ``fed:member`` child per cluster in the
        fleet — lost clusters included, marked ``state: "lost"``, so a
        trace of a degraded query SHOWS the hole instead of silently
        omitting it.  ``trace_sample`` follows the ``-trace-sample``
        grammar (see :func:`~..telemetry.tracectx.parse_sample_spec`)."""
        if stale_after_s is None:
            stale_after_s = float(os.environ.get(_STALE_ENV, 10.0))
        if evict_after_s is None:
            evict_after_s = float(os.environ.get(_EVICT_ENV, 60.0))
        if not stale_after_s > 0:
            raise ValueError(
                f"stale_after_s must be > 0, got {stale_after_s}"
            )
        if not evict_after_s > stale_after_s:
            raise ValueError(
                f"evict_after_s ({evict_after_s}) must exceed "
                f"stale_after_s ({stale_after_s}): a cluster must pass "
                "through explicit staleness before it can be lost"
            )
        self._device = resolve_device(device)
        self.stale_after_s = float(stale_after_s)
        self.evict_after_s = float(evict_after_s)
        self._clock = clock
        self._auth_token = auth_token
        self._plane_token = plane_token
        self._seed = seed
        self._lock = threading.Lock()
        self._clusters: dict[str, _Cluster] = {}
        # Per-semantics memo of the last concatenated snapshot, keyed by
        # the member (name, generation) vector — repeated queries of an
        # unchanged fleet reuse one device-resident staging.
        self._combined_cache: dict[str, tuple[tuple, ClusterSnapshot]] = {}
        self._m_up = None
        self._m_stale = None
        self._m_gen = None
        self._m_sweeps = None
        if isinstance(trace_log, str):
            from kubernetesclustercapacity_tpu_torch.telemetry.tracing import (
                TraceLog,
            )

            trace_log = TraceLog(trace_log)
        self._trace_sink = None
        if trace_log is not None:
            from kubernetesclustercapacity_tpu_torch.telemetry.tracectx import (
                TailSampler,
            )

            self._trace_sink = TailSampler(
                trace_log, trace_sample, registry=registry
            )
        # Per-dispatch-thread scratch: the survey vector the handler
        # saw (and how long evaluation took), read back by dispatch()
        # to emit the fed:member child spans.
        self._dispatch_tls = threading.local()
        self.registry = registry
        if registry is not None:
            from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
                enabled as _telemetry_enabled,
            )

            if _telemetry_enabled():
                self._m_up = registry.gauge(
                    "kccap_fed_cluster_up",
                    "1 while the cluster's view is fresh, else 0.",
                    ("cluster",),
                )
                self._m_stale = registry.gauge(
                    "kccap_fed_staleness_seconds",
                    "Seconds since the cluster's view was last verified "
                    "(-1 before the first verification).",
                    ("cluster",),
                )
                self._m_gen = registry.gauge(
                    "kccap_fed_generation",
                    "The cluster's verified generation watermark.",
                    ("cluster",),
                )
                self._m_sweeps = registry.counter(
                    "kccap_fed_sweep_total",
                    "Batched federation kernel dispatches "
                    "(fed_sweep/fed_rank/spillover evaluations).",
                )
        for name, addr in (clusters or {}).items():
            self.attach(name, addr)
        self._tcp = _FedTCPServer((host, port), _FedHandler)
        self._tcp.federation_server = self  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None

    # -- membership --------------------------------------------------------
    def attach(self, name: str, plane_addr: tuple[str, int]) -> None:
        """Subscribe to one cluster leader's plane stream.  The
        subscriber resyncs through digest-match or a fresh checkpoint on
        every reconnect — exactly the replica contract."""
        from kubernetesclustercapacity_tpu_torch.service.plane import (
            PlaneSubscriber,
        )

        feed = ClusterFeed(name, clock=self._clock)
        # Register BEFORE the subscriber starts staging, so no generation
        # can ever land in a feed with no cluster to answer for it.
        order = self._register(name, feed, None)
        sub = PlaneSubscriber(
            tuple(plane_addr),
            feed,
            token=self._plane_token,
            stale_after_s=self.stale_after_s,
            clock=self._clock,
            seed=None if self._seed is None else self._seed + len(order),
        )
        with self._lock:
            self._clusters[name].subscriber = sub

    def _register(self, name: str, feed: ClusterFeed, subscriber):
        """Insert one cluster record (refusing duplicates) and bind its
        callback gauges; returns the post-insert cluster list (the
        deterministic per-cluster seed derives from its length)."""
        cluster = _Cluster(name, feed, subscriber)
        with self._lock:
            if name in self._clusters:
                raise FederationError(f"duplicate cluster name {name!r}")
            self._clusters[name] = cluster
            out = list(self._clusters)
        if self._m_up is not None:
            # Callback gauges: the scrape reads the CURRENT state, so a
            # cluster going stale between queries is visible without a
            # background ticker.
            self._m_up.labels(cluster=name).set_function(
                lambda c=cluster: (
                    1.0 if self._cluster_state(c)[0] == "fresh" else 0.0
                )
            )
            self._m_stale.labels(cluster=name).set_function(
                lambda c=cluster: (
                    -1.0 if c.age_s() is None else round(c.age_s(), 3)
                )
            )
            self._m_gen.labels(cluster=name).set_function(
                lambda c=cluster: float(c.feed.view()[1])
            )
        return out

    def inject(
        self,
        name: str,
        snapshot: ClusterSnapshot,
        *,
        generation: int | None = None,
    ) -> None:
        """Feed one cluster's verified snapshot WITHOUT a wire (offline
        what-ifs, the bench's simulated fleet).  Creates the cluster on
        first use; the feed's monotone-generation guard still applies."""
        with self._lock:
            cluster = self._clusters.get(name)
        if cluster is None:
            feed = ClusterFeed(name, clock=self._clock)
            try:
                self._register(name, feed, None)
            except FederationError:
                pass  # a concurrent injector created it first
            with self._lock:
                cluster = self._clusters[name]
        cluster.feed.replace_snapshot(snapshot, generation=generation)

    def _clusters_snapshot(self) -> list[_Cluster]:
        with self._lock:
            return list(self._clusters.values())

    # -- the degradation state machine -------------------------------------
    def _cluster_state(self, cluster: _Cluster) -> tuple[str, float | None]:
        """(state, age_s) for one cluster, from the ONE verified-age
        clock.  Never-synced clusters are ``lost`` (there is no view to
        serve, stale or otherwise)."""
        snap, _gen = cluster.feed.view()
        age = cluster.age_s()
        if snap is None or age is None:
            return "lost", age
        if age <= self.stale_after_s:
            return "fresh", age
        if age <= self.evict_after_s:
            return "stale", age
        return "lost", age

    def _survey(self):
        """One consistent pass over the fleet: the per-cluster
        degradation vector, the non-lost members (with their snapshots
        at their stamped generations), and the named exclusions."""
        vector: dict[str, dict] = {}
        included: list[tuple[str, ClusterSnapshot, int]] = []
        excluded: list[str] = []
        for cluster in self._clusters_snapshot():
            snap, gen = cluster.feed.view()
            state, age = self._cluster_state(cluster)
            vector[cluster.name] = {
                "generation": gen,
                "age_s": None if age is None else round(age, 3),
                "state": state,
            }
            if state == "lost":
                excluded.append(cluster.name)
            else:
                included.append((cluster.name, snap, gen))
        return vector, included, excluded

    # -- the batched evaluation core ---------------------------------------
    def _combined_for(self, semantics: str, members) -> ClusterSnapshot:
        key = tuple((name, gen) for name, _snap, gen in members)
        with self._lock:
            cached = self._combined_cache.get(semantics)
        if cached is not None and cached[0] == key:
            return cached[1]
        combined = concat_snapshots([snap for _name, snap, _gen in members])
        with self._lock:
            self._combined_cache[semantics] = (key, combined)
        return combined

    def _per_cluster_totals(self, included, grid: ScenarioGrid) -> dict:
        """``{cluster: totals[S]}`` over the non-lost members — one
        batched dispatch per semantics group (normally one), per-cluster
        totals recovered as segment sums of the per-node fit matrix at
        the cluster boundaries."""
        groups: dict[str, list] = {}
        for member in included:
            groups.setdefault(member[1].semantics, []).append(member)
        per_cluster: dict[str, np.ndarray] = {}
        for semantics, members in groups.items():
            combined = self._combined_for(semantics, members)
            _totals, _sched, fits = sweep_snapshot(
                combined,
                grid,
                mode=semantics,
                return_per_node=True,
                node_mask=implicit_taint_mask(combined),
                device=self._device,
            )
            if self._m_sweeps is not None:
                self._m_sweeps.inc()
            fits = np.asarray(fits)
            offset = 0
            for name, snap, _gen in members:
                n = snap.n_nodes
                per_cluster[name] = np.asarray(
                    fits[:, offset : offset + n].sum(axis=1), dtype=np.int64
                )
                offset += n
        return per_cluster

    # -- ops ----------------------------------------------------------------
    def dispatch(self, msg: dict) -> dict | str:
        op = msg.get("op")
        if op == "ping":
            return "pong"
        if self._auth_token is not None:
            import hmac

            token = msg.get("token")
            if not isinstance(token, str) or not hmac.compare_digest(
                token.encode(), self._auth_token.encode()
            ):
                raise PermissionError("missing or invalid auth token")
        if self._trace_sink is None:
            return self._route(op, msg)
        # Traced dispatch: the fed:{op} request span plus one
        # fed:member child per cluster (from the survey vector the
        # handler stashed) — emitted at request END so the whole tree
        # rides one tail-sampling verdict.
        from kubernetesclustercapacity_tpu_torch.telemetry import (
            tracectx as _tracectx,
        )

        ctx = _tracectx.from_wire(msg)
        parent = msg.get("parent_span_id")
        if not isinstance(parent, str) or not parent:
            parent = None
        self._dispatch_tls.survey = None
        wall0 = time.time()
        t0 = time.perf_counter()
        error: str | None = None
        try:
            return self._route(op, msg)
        except Exception as e:
            error = f"{type(e).__name__}: {e}"
            raise
        finally:
            survey = getattr(self._dispatch_tls, "survey", None)
            self._dispatch_tls.survey = None
            if ctx is not None:
                dur = time.perf_counter() - t0
                op_label = op if op in self._KNOWN_OPS else "unknown"
                if survey is not None:
                    vector, eval_s = survey
                    for name, entry in sorted(vector.items()):
                        lost = entry.get("state") == "lost"
                        _tracectx.span(
                            self._trace_sink,
                            ts=time.time(),
                            trace_id=ctx.trace_id,
                            span_id=_tracectx.new_span_id(),
                            parent_span_id=ctx.span_id,
                            op="fed:member",
                            service="fed",
                            cluster=name,
                            state=entry.get("state"),
                            generation=entry.get("generation"),
                            # Included members shared ONE batched
                            # evaluation; a lost member costs nothing
                            # (and contributes nothing).
                            duration_ms=(
                                0.0 if lost else round(eval_s * 1e3, 3)
                            ),
                            status="error" if lost else "ok",
                            **({"error": "cluster lost"} if lost else {}),
                        )
                _tracectx.span(
                    self._trace_sink,
                    ts=time.time(),
                    start_ts=wall0,
                    trace_id=ctx.trace_id,
                    span_id=ctx.span_id,
                    **({"parent_span_id": parent} if parent else {}),
                    op=f"fed:{op_label}",
                    service="fed",
                    hops=ctx.hops,
                    duration_ms=round(dur * 1e3, 3),
                    status="error" if error else "ok",
                    **({"error": error} if error else {}),
                )
                keep = self._trace_sink.decide(
                    op_label, dur, error, forced=ctx.sampled
                )
                self._trace_sink.finish(ctx.trace_id, keep=keep)

    def _route(self, op, msg: dict) -> dict | str:
        if op == "info":
            return self._op_info()
        if op == "fed_status":
            return self.status()
        if op == "fed_sweep":
            return self._op_fed_sweep(msg)
        if op == "fed_rank":
            return self._op_fed_rank(msg)
        if op == "spillover":
            return self._op_spillover(msg)
        raise ValueError(f"unknown op {op!r}")

    def tracing_stats(self) -> dict:
        """Tracing posture for doctor: is the fed endpoint emitting
        spans, and what is the tail sampler holding/dropping."""
        out: dict = {"armed": self._trace_sink is not None}
        if self._trace_sink is not None:
            out.update(self._trace_sink.stats())
        return out

    def _op_info(self) -> dict:
        status = self.status()
        return {
            "clusters": status["counts"]["total"],
            "federation": status,
            "tracing": self.tracing_stats(),
            # The handshake vocabulary multi-endpoint clients gate on:
            # this endpoint speaks federation ops, not the single-server
            # compute surface.
            "capabilities": {"protocol": 2, "federation": True},
            "draining": False,
        }

    def status(self) -> dict:
        """The ``fed_status`` answer: the degradation vector, state
        counts, the horizons, and per-cluster stream health."""
        vector, _included, excluded = self._survey()
        counts = {s: 0 for s in CLUSTER_STATES}
        for entry in vector.values():
            counts[entry["state"]] += 1
        counts["total"] = len(vector)
        streams = {}
        for cluster in self._clusters_snapshot():
            stats = cluster.feed.stream_stats()
            if stats is not None:
                streams[cluster.name] = stats
        return {
            "enabled": bool(vector),
            "clusters": vector,
            "counts": counts,
            "excluded": excluded,
            "stale_after_s": self.stale_after_s,
            "evict_after_s": self.evict_after_s,
            "healthy": counts["lost"] == 0,
            **({"streams": streams} if streams else {}),
        }

    def healthy(self) -> bool:
        """The ``fed:`` health verdict: False while ANY cluster is lost
        (``main`` wires it to ``/healthz`` 503)."""
        _vector, _included, excluded = self._survey()
        return not excluded

    @staticmethod
    def _grid_from_msg(msg: dict) -> ScenarioGrid:
        """Array form (the sweep op's grammar) or the six reference
        flags as a single-scenario grid — one query vocabulary for the
        CLI and programmatic callers."""
        if "cpu_request_milli" in msg:
            try:
                grid = ScenarioGrid(
                    cpu_request_milli=np.asarray(msg["cpu_request_milli"]),
                    mem_request_bytes=np.asarray(msg["mem_request_bytes"]),
                    replicas=np.asarray(msg.get("replicas", [1])),
                )
                grid.validate()
            except (ScenarioError, KeyError, TypeError, ValueError) as e:
                raise ValueError(f"bad federation grid: {e}") from e
            return grid
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
        return ScenarioGrid.from_scenarios([scenario])

    def _op_fed_sweep(self, msg: dict) -> dict:
        """"Across all clusters, how many replicas fit, and where?" —
        grand totals over the non-lost clusters plus the per-cluster
        split, every row annotated by the degradation vector."""
        grid = self._grid_from_msg(msg)
        vector, included, excluded = self._survey()
        self._dispatch_tls.survey = (vector, 0.0)
        t_eval0 = time.perf_counter()
        per_cluster = self._per_cluster_totals(included, grid)
        self._dispatch_tls.survey = (
            vector,
            time.perf_counter() - t_eval0,
        )
        s = grid.size
        totals = np.zeros(s, dtype=np.int64)
        for t in per_cluster.values():
            totals = totals + t
        replicas = np.asarray(grid.replicas, dtype=np.int64)
        return {
            "totals": totals.tolist(),
            "schedulable": (totals >= replicas).tolist(),
            "scenarios": s,
            "per_cluster": {
                name: t.tolist() for name, t in per_cluster.items()
            },
            "clusters": vector,
            "excluded": excluded,
            "degraded": any(
                entry["state"] != "fresh" for entry in vector.values()
            ),
        }

    def _op_fed_rank(self, msg: dict) -> dict:
        """Placement ranking per cluster for ONE scenario: fitting
        clusters first — cheapest first when a ``costs`` map rides the
        request, most-headroom otherwise — then the rest by headroom.
        Lost clusters never rank (they are named in ``excluded``)."""
        grid = self._grid_from_msg(msg)
        if grid.size != 1:
            raise ValueError(
                f"fed_rank ranks one scenario, got {grid.size}"
            )
        costs = msg.get("costs") or {}
        if not isinstance(costs, dict):
            raise ValueError(f"costs must be an object, got {costs!r}")
        vector, included, excluded = self._survey()
        self._dispatch_tls.survey = (vector, 0.0)
        t_eval0 = time.perf_counter()
        per_cluster = self._per_cluster_totals(included, grid)
        self._dispatch_tls.survey = (
            vector,
            time.perf_counter() - t_eval0,
        )
        replicas = int(np.asarray(grid.replicas)[0])
        rows = []
        for name, _snap, gen in included:
            total = int(per_cluster[name][0])
            rows.append(
                {
                    "cluster": name,
                    "total": total,
                    "schedulable": total >= replicas,
                    "cost": costs.get(name),
                    "generation": gen,
                    "state": vector[name]["state"],
                    "age_s": vector[name]["age_s"],
                }
            )
        rows.sort(
            key=lambda r: (
                not r["schedulable"],  # fitting clusters first
                r["cost"] is None,  # known cost beats unknown cost
                r["cost"] if r["cost"] is not None else 0.0,
                -r["total"],
                r["cluster"],
            )
        )
        for i, row in enumerate(rows):
            row["rank"] = i + 1
        return {
            "ranking": rows,
            "replicas": replicas,
            "clusters": vector,
            "excluded": excluded,
        }

    def _op_spillover(self, msg: dict) -> dict:
        """"Drain cluster X — where does its load land?"  Demand
        defaults to X's current pod count (its load, modeled as
        scenario-shaped replicas; override with ``demand``); the rest of
        the fleet absorbs it greedily, most headroom first.  A LOST X
        refuses with the typed ``cluster_lost`` code — there is no view
        of its load to drain, not even a stale one."""
        target = msg.get("cluster")
        if not isinstance(target, str) or not target:
            raise ValueError("spillover wants a non-empty cluster name")
        grid = self._grid_from_msg(msg)
        if grid.size != 1:
            raise ValueError(
                f"spillover evaluates one scenario, got {grid.size}"
            )
        vector, included, excluded = self._survey()
        self._dispatch_tls.survey = (vector, 0.0)
        if target not in vector:
            raise FederationError(f"unknown cluster {target!r}")
        if vector[target]["state"] == "lost":
            raise ClusterLostError(
                f"cluster {target!r} is lost (generation "
                f"{vector[target]['generation']}, age "
                f"{vector[target]['age_s']}s past the "
                f"{self.evict_after_s:g}s eviction horizon); its load is "
                "unknowable — resync it or query another federation "
                "endpoint"
            )
        t_eval0 = time.perf_counter()
        per_cluster = self._per_cluster_totals(included, grid)
        self._dispatch_tls.survey = (
            vector,
            time.perf_counter() - t_eval0,
        )
        target_snap = next(s for n, s, _g in included if n == target)
        demand = msg.get("demand")
        if demand is None:
            demand = int(np.asarray(target_snap.pods_count).sum())
        elif isinstance(demand, bool) or not isinstance(demand, int):
            raise ValueError(f"demand must be an integer, got {demand!r}")
        elif demand < 0:
            raise ValueError(f"demand must be >= 0, got {demand}")
        candidates = sorted(
            (
                (int(per_cluster[name][0]), name)
                for name, _snap, _gen in included
                if name != target
            ),
            key=lambda t: (-t[0], t[1]),
        )
        remaining = int(demand)
        placements = []
        for headroom, name in candidates:
            take = min(remaining, max(headroom, 0))
            placements.append(
                {"cluster": name, "replicas": take, "headroom": headroom,
                 "state": vector[name]["state"]}
            )
            remaining -= take
        return {
            "cluster": target,
            "demand": int(demand),
            "placements": placements,
            "unplaced": remaining,
            "absorbed": remaining == 0,
            "clusters": vector,
            "excluded": excluded,
        }

    # -- lifecycle ---------------------------------------------------------
    @property
    def address(self) -> tuple[str, int]:
        return self._tcp.server_address  # type: ignore[return-value]

    def start(self) -> "FederationServer":
        self._serving = True
        self._thread = threading.Thread(
            target=self._tcp.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._serving = True
        self._tcp.serve_forever()

    def close(self) -> None:
        """Stop every cluster subscriber, then the query listener."""
        for cluster in self._clusters_snapshot():
            if cluster.subscriber is not None:
                cluster.subscriber.stop()
        if getattr(self, "_serving", False):
            self._tcp.shutdown()
        self._tcp.server_close()

    def __enter__(self) -> "FederationServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def main(argv=None) -> int:
    """``kccap-torch-fed -cluster east=h1:7100 -cluster west=h2:7100 -port
    7177`` (add ``-device cpu`` on a host without a card)"""
    import argparse
    import sys

    p = argparse.ArgumentParser(prog="kccap-torch-fed")
    p.add_argument("-cluster", action="append", default=[], metavar="NAME=HOST:PORT",
                   help="subscribe to one cluster leader's plane stream "
                        "(its kccap-server -plane-port); repeatable, at "
                        "least one required")
    p.add_argument("-port", type=int, default=7177,
                   help="serve federation queries (fed_sweep/fed_rank/"
                        "spillover/fed_status) on this port")
    p.add_argument("-host", default="127.0.0.1")
    p.add_argument("-fed-stale-after-s", type=float, default=None,
                   dest="fed_stale_after_s", metavar="SECONDS",
                   help="staleness bound: a cluster silent past this "
                        "serves its last verified snapshot explicitly "
                        "marked stale (default: $KCCAP_FED_STALE_AFTER_S "
                        "or 10)")
    p.add_argument("-fed-evict-after-s", type=float, default=None,
                   dest="fed_evict_after_s", metavar="SECONDS",
                   help="eviction horizon: a cluster silent past this "
                        "flips to lost — excluded from totals, named in "
                        "every reply, /healthz 503 (default: "
                        "$KCCAP_FED_EVICT_AFTER_S or 60)")
    p.add_argument("-metrics-port", type=int, default=0, dest="metrics_port",
                   metavar="PORT",
                   help="serve Prometheus /metrics and /healthz (the "
                        "fed: watch — 503 while any cluster is lost) on "
                        "this port (0 = disabled)")
    p.add_argument("-auth-token-file", default=None, dest="auth_token_file",
                   help="file holding the shared bearer token; when set "
                        "(or $KCCAP_AUTH_TOKEN is), every op except ping "
                        "must carry it, and plane subscriptions present "
                        "it to the cluster leaders")
    p.add_argument("-trace-log", default=None, dest="trace_log",
                   metavar="PATH",
                   help="append fed:{op} request spans and fed:member "
                        "per-cluster child spans as JSONL here (feeds "
                        "kccap -trace-tree)")
    p.add_argument("-trace-log-max-bytes", type=int, default=16 * 2**20,
                   dest="trace_log_max_bytes", metavar="BYTES",
                   help="rotate the trace log at this size (one .1 "
                        "rollover, default 16MiB)")
    p.add_argument("-trace-sample", default="always", dest="trace_sample",
                   metavar="SPEC",
                   help="tail-sampling policy for span bodies: always | "
                        "p99-breach | errors | rate:N (span IDs still "
                        "propagate when bodies are dropped)")
    p.add_argument("-device", choices=("cuda", "cpu"), default="cuda",
                   help="evaluate fleet queries on the GPU (default) or "
                        "the host")
    args = p.parse_args(argv)

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
    clusters: dict[str, tuple[str, int]] = {}
    for spec in args.cluster:
        name, eq, addr = spec.partition("=")
        host_s, _, port_s = addr.rpartition(":")
        if not name or not eq or not host_s or not port_s.isdigit():
            print(
                f"ERROR : bad -cluster {spec!r} (want NAME=HOST:PORT)",
                file=sys.stderr,
            )
            return 1
        if name in clusters:
            print(f"ERROR : duplicate cluster name {name!r}",
                  file=sys.stderr)
            return 1
        clusters[name] = (host_s, int(port_s))
    if not clusters:
        print("ERROR : at least one -cluster NAME=HOST:PORT is required",
              file=sys.stderr)
        return 1
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import REGISTRY
    from kubernetesclustercapacity_tpu_torch.telemetry.process import (
        register_process_metrics,
    )
    from kubernetesclustercapacity_tpu_torch.telemetry.tracectx import (
        parse_sample_spec,
    )

    try:
        parse_sample_spec(args.trace_sample)
    except ValueError as e:
        print(f"ERROR : {e}", file=sys.stderr)
        return 1
    trace_log = None
    if args.trace_log:
        from kubernetesclustercapacity_tpu_torch.telemetry.tracing import (
            TraceLog,
        )

        trace_log = TraceLog(
            args.trace_log, max_bytes=args.trace_log_max_bytes
        )
    register_process_metrics(REGISTRY)

    try:
        fed = FederationServer(
            clusters,
            host=args.host,
            port=args.port,
            stale_after_s=args.fed_stale_after_s,
            evict_after_s=args.fed_evict_after_s,
            auth_token=auth_token,
            plane_token=auth_token,
            registry=REGISTRY,
            trace_log=trace_log,
            trace_sample=args.trace_sample,
            device=args.device,
        )
    except (OSError, ValueError, FederationError) as e:
        print(f"ERROR : {e}", file=sys.stderr)
        return 1
    metrics_server = None
    if args.metrics_port:
        from kubernetesclustercapacity_tpu_torch.telemetry.exposition import (
            start_metrics_server,
        )

        try:
            metrics_server = start_metrics_server(
                REGISTRY,
                host=args.host,
                port=args.metrics_port,
                healthy=fed.healthy,
                status=lambda: {"federation": fed.status()},
            )
        except OSError as e:
            print(f"ERROR : cannot bind metrics port: {e}", file=sys.stderr)
            fed.close()
            return 1
        print(
            f"metrics on http://{metrics_server.address[0]}:"
            f"{metrics_server.address[1]}/metrics",
            file=sys.stderr,
        )
    print(
        f"federating {len(clusters)} cluster(s) on "
        f"{fed.address[0]}:{fed.address[1]} "
        f"(stale>{fed.stale_after_s:g}s, lost>{fed.evict_after_s:g}s)",
        file=sys.stderr,
    )
    try:
        fed.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if metrics_server is not None:
            metrics_server.shutdown()
        fed.close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
