"""Live cluster follower — the full list+watch informer loop.

Counterpart of ``kubernetesclustercapacity_tpu/follower.py``: the
port's ``kccap-torch-server -follow`` keeps its served snapshot synced
through it.

The reference re-walks the whole apiserver (``1 + 2N + ΣP`` requests,
SURVEY.md §3.4) every time it runs.  This module is the end state of the
TPU-native redesign's ingestion side: list once (two paginated Lists,
:mod:`.kubeapi`), pack once (:class:`~.store.ClusterStore`), then stay
synced through the Kubernetes *watch* protocol — each cluster change costs
one streamed event and one per-row array update, and every
:meth:`ClusterFollower.snapshot` call is a consistent packed snapshot ready
for the fit kernels.

Watch-protocol handling follows the standard informer contract:

* resume each re-watch from the last seen ``metadata.resourceVersion``;
* ``BOOKMARK`` events only advance the resume version;
* ``ERROR`` events (e.g. 410 Gone — version expired) and any transport
  failure trigger a full relist+repack;
* ``ADDED``/``MODIFIED`` are applied as upserts (a relist race can replay
  either for an object the store already has), ``DELETED`` of an unknown
  object is ignored.
"""

from __future__ import annotations

import collections
import random
import threading
import time

from kubernetesclustercapacity_tpu_torch.resilience import decorrelated_jitter

from kubernetesclustercapacity_tpu_torch.kubeapi import (
    PDB_PATH,
    KubeAPIError,
    KubeClient,
    KubeConfig,
    KubeConfigError,
    node_to_fixture,
    pdb_to_fixture,
    pod_to_fixture,
)
from kubernetesclustercapacity_tpu_torch.snapshot import ClusterSnapshot
from kubernetesclustercapacity_tpu_torch.store import ClusterStore, StoreError

__all__ = ["ClusterFollower"]

_RESOURCES = {
    "/api/v1/nodes": ("Node", node_to_fixture),
    "/api/v1/pods": ("Pod", pod_to_fixture),
    # PDBs feed drain's eviction gate.  Optional: a 403/404 on the policy
    # API at relist marks them unavailable and their watch thread exits
    # (the other streams are unaffected); RBAC granted mid-run takes
    # effect at the next relist, streaming again after a restart.
    PDB_PATH: ("PodDisruptionBudget", pdb_to_fixture),
}

_FIXTURE_KEYS = {"Node": "nodes", "Pod": "pods", "PodDisruptionBudget": "pdbs"}

# Ceiling on the jittered failure backoff (client-go reflector's cap).
_BACKOFF_CAP_S = 30.0


class ClusterFollower:
    """Keep a packed :class:`ClusterStore` synced to a live cluster."""

    def __init__(
        self,
        kubeconfig: str | None = None,
        *,
        semantics: str = "reference",
        extended_resources: tuple[str, ...] = (),
        context: str | None = None,
        client_factory=None,
        on_event=None,
        stop_on_idle_window: bool = False,
        idle_rewatch_backoff: float = 1.0,
        resync_failure_deadline: float = 900.0,
        backoff_seed: int | None = None,
        registry=None,
        clock=time.monotonic,
    ) -> None:
        """``client_factory() -> KubeClient`` builds one client per stream
        (each watch occupies a connection); defaults to clients over the
        given kubeconfig.  ``on_event(kind, type, obj)`` is an optional
        observer called after each applied event — and with
        ``("*", "RELIST", {})`` after every error-path relist swaps in a
        fresh store, so consumers republish state that arrived without
        per-object events.

        A real apiserver regularly ends watch windows with no events and no
        version progress; the follower re-watches after
        ``idle_rewatch_backoff`` seconds (also the BASE of the exponential
        failure backoff, capped at 30 s).  Failure backoff uses
        decorrelated jitter (:mod:`..resilience`) so a fleet of followers
        recovering from a shared apiserver outage spreads its relists out
        instead of stampeding in lockstep; ``backoff_seed`` pins the
        jitter RNG for deterministic tests.  ``stop_on_idle_window=True``
        instead ends that resource's watch loop — ONLY for tests driving
        finite mock streams; in production it would silently stop syncing.

        ``resync_failure_deadline``: when BOTH the watch and the relist
        keep failing for this many seconds straight (expired unrefreshable
        credentials, revoked RBAC, dead apiserver), the follower goes
        fatal and stops — the served snapshot is visibly stale at that
        point, and the module contract is that staleness is never silent.

        ``registry`` is the :class:`~.telemetry.MetricsRegistry` holding
        this follower's sync counters — the single source of truth
        :meth:`stats` is a view over.  Default: a fresh private registry
        (per-follower counts, as before); the serve path passes the
        process registry so the scrape includes them.

        ``clock`` (monotonic seconds, injectable for deterministic
        staleness tests) feeds :meth:`last_relist_age_s` and
        :meth:`last_verified_age_s` — consumers computing freshness
        bounds read the follower's clock, never a second wall-clock of
        their own.
        """
        from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
            MetricsRegistry,
        )
        if client_factory is None:
            # Validate the kubeconfig up front (fail fast on a bad file)...
            KubeConfig.load(kubeconfig, context=context)

            def client_factory() -> KubeClient:  # noqa: F811 - default
                # ...but re-resolve credentials per client: exec-plugin /
                # OIDC / tokenFile tokens expire (EKS: ~15 min), and a
                # factory pinned to the startup token would 401 on every
                # reconnect forever after expiry.
                return KubeClient(KubeConfig.load(kubeconfig, context=context))

        self._factory = client_factory
        self._resync_deadline = resync_failure_deadline
        self._semantics = semantics
        self._extended = tuple(extended_resources)
        self.on_event = on_event
        self._stop_on_idle_window = stop_on_idle_window
        self._idle_backoff = idle_rewatch_backoff
        self._lock = threading.Lock()
        self._store: ClusterStore | None = None
        self._synced = threading.Event()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # _versions, _epoch and _store share _lock: every read or write of
        # any of them happens under it (two watch threads + callers race).
        self._versions: dict[str, str] = {}
        self._epoch = 0  # bumped by every relist; stale streams stop applying
        self._clock = clock
        self._last_relist_t: float | None = None  # monotonic; /healthz age
        # Last instant the store was verifiably synced to the apiserver:
        # a completed relist OR an applied watch event (both prove the
        # stream was live then).  Guarded by _lock like the relist stamp.
        self._last_verified_t: float | None = None
        self._fatal: str | None = None
        self._pdb_unavailable = False  # policy API 403/404 at relist
        self._errors: collections.deque = collections.deque(maxlen=100)
        # Jittered-backoff RNG (seedable) + resilience counters, all
        # guarded by _lock.  _backoff_s tracks each stream's CURRENT
        # retry delay (0 = healthy) so info/doctor can see a struggling
        # sync loop, not just its final failure.
        self._backoff_rng = random.Random(backoff_seed)
        self._backoff_s: dict[str, float] = {}
        # The sync counters live in the registry (stats() and the
        # Prometheus scrape read the same cells); counter names keep the
        # stats()-dict keys as their last path segment so the two views
        # are visibly the same quantity.
        self.registry = registry if registry is not None else MetricsRegistry()
        self._counters = {
            name: self.registry.counter(
                f"kccap_follower_{name}_total", help_
            )
            for name, help_ in (
                ("relists", "Full list+repack cycles completed."),
                ("relist_failures", "Relist attempts that failed."),
                ("watch_failures", "Watch streams that failed/expired."),
                ("events_applied", "Watch events applied to the store."),
            )
        }
        self._m_backoff = self.registry.gauge(
            "kccap_follower_backoff_seconds",
            "Current retry backoff per watch stream (0 = healthy).",
            ("stream",),
        )
        # Live clients (watch streams mid-read, in-flight relists), guarded
        # by _lock: stop() severs their sockets so a reader parked in
        # readline() unblocks now, not after the watch watchdog.
        self._active_clients: set[KubeClient] = set()

    # -- lifecycle ---------------------------------------------------------
    def start(self, *, watch: bool = True) -> "ClusterFollower":
        """List+pack, then follow both watch streams in daemon threads.

        ``watch=False`` stops after the initial list+pack (synchronous);
        call :meth:`start_watches` to begin streaming — useful to install
        :attr:`on_event` consumers race-free between the two phases.
        """
        self._relist()
        if watch:
            self.start_watches()
        return self

    def start_watches(self) -> None:
        for path in _RESOURCES:
            t = threading.Thread(
                target=self._watch_loop, args=(path,), daemon=True
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        # Sever in-flight streams: a watch reader blocked in readline()
        # would otherwise hold join() for up to the watch watchdog
        # (timeoutSeconds + grace, minutes).  The reader surfaces the
        # closed socket as a KubeAPIError, sees _stop, and exits.
        with self._lock:
            clients = list(self._active_clients)
        for c in clients:
            try:
                c.close()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass

    def wait_stopped(self, timeout: float | None = None) -> bool:
        """Block until :meth:`stop` is called (by a user or by a fatal
        watch-thread death — check :attr:`fatal` afterwards).  Supervisors
        serving this follower's snapshots wait on this: a stopped follower
        means the served state will only grow staler."""
        return self._stop.wait(timeout)

    def join(self, timeout: float | None = None) -> None:
        """Wait for the watch streams to end (tests: finite mock streams)."""
        for t in self._threads:
            t.join(timeout)

    def wait_synced(self, timeout: float | None = None) -> bool:
        return self._synced.wait(timeout)

    # -- state -------------------------------------------------------------
    def snapshot(self) -> ClusterSnapshot:
        """A consistent packed snapshot of the followed cluster."""
        with self._lock:
            if self._store is None:
                raise RuntimeError("follower not started")
            return self._store.snapshot()

    def fixture_view(self) -> dict:
        with self._lock:
            if self._store is None:
                raise RuntimeError("follower not started")
            return self._store.fixture_view()

    @property
    def errors(self) -> list[str]:
        """Recent transport/apply errors (each followed by a relist;
        bounded to the last 100)."""
        return list(self._errors)

    def stats(self) -> dict:
        """Retry/backoff/degradation counters (JSON-able), surfaced by
        the capacity service's ``info`` op and ``-doctor``: relist and
        watch failure totals, events applied, each stream's current
        backoff delay (0 when healthy), and the fatal state."""
        with self._lock:
            backoff = {
                p: round(d, 3)
                for p, d in self._backoff_s.items()
                if d > 0
            }
            recent, pdb_un, fatal = (
                len(self._errors), self._pdb_unavailable, self._fatal
            )
        return {
            # Views over the registry counters (same cells the scrape
            # renders); the dict shape is pinned by test_telemetry.py.
            **{name: int(c.value) for name, c in self._counters.items()},
            "backoff_s": backoff,
            "recent_errors": recent,
            "pdb_unavailable": pdb_un,
            "fatal": fatal,
        }

    def last_relist_age_s(self) -> float | None:
        """Seconds since the last successful full relist (``None`` before
        the first).  The ``/healthz`` freshness signal: a follower whose
        watches died can keep serving a stale snapshot indefinitely —
        this number is how a load balancer notices (the stats() dict
        shape is pinned, so the age rides its own accessor)."""
        with self._lock:
            t = self._last_relist_t
        return None if t is None else round(self._clock() - t, 3)

    def last_verified_age_s(self) -> float | None:
        """Seconds (on the injectable ``clock``) since the store was last
        verifiably synced — a completed relist or an applied watch event;
        ``None`` before the first relist.  The freshness input federation
        staleness math reads, so a bound like "stale after 10 s" is
        always computed against THIS clock (the stats() dict shape is
        pinned, so the age rides its own accessor, exactly like
        :meth:`last_relist_age_s`)."""
        with self._lock:
            t = self._last_verified_t
        return None if t is None else round(self._clock() - t, 3)

    def _bump(self, counter: str, n: int = 1) -> None:
        self._counters[counter].inc(n)

    def _next_backoff(self, path: str, prev: float | None) -> float:
        """One capped decorrelated-jitter backoff step, recorded so
        :meth:`stats` (and the backoff gauge) show the stream as
        backing off."""
        with self._lock:
            delay = decorrelated_jitter(
                self._backoff_rng, self._idle_backoff, prev, _BACKOFF_CAP_S
            )
            self._backoff_s[path] = delay
        self._m_backoff.set(delay, stream=path)
        return delay

    def _clear_backoff(self, path: str) -> None:
        with self._lock:
            self._backoff_s[path] = 0.0
        self._m_backoff.set(0.0, stream=path)

    @property
    def fatal(self) -> str | None:
        """Non-``None`` when a watch thread died on an unexpected error.

        Transport and apply failures relist-and-continue; anything else
        (notably :class:`~.oracle.ReferencePanic`, which reference mode
        deliberately re-raises where the Go process would have died) stops
        the follower and is recorded here — a dead sync loop must be
        *visible*, never a silently stale snapshot."""
        with self._lock:
            return self._fatal

    # -- internals ---------------------------------------------------------
    def _relist(self) -> None:
        """Full list of both resources → fresh store, under one lock hold."""
        client = self._factory()
        with self._lock:
            self._active_clients.add(client)
        try:
            # Registration races stop(): a client created after stop()
            # snapshotted the set would never be severed — re-check now
            # that we're visible, so either stop() closes us or we abort.
            if self._stop.is_set():
                raise KubeAPIError("follower stopping")
            fixture: dict = {"nodes": [], "pods": []}
            versions = {}
            for path, (kind, convert) in _RESOURCES.items():
                try:
                    items, version = client.list_with_version(path)
                except KubeAPIError as e:
                    if (
                        kind == "PodDisruptionBudget"
                        and e.status in (403, 404)
                    ):
                        # Policy API unreadable for this principal —
                        # degrade to a budget-less fixture (list_pdbs's
                        # rule); transport/5xx still fails the relist.
                        self._pdb_unavailable = True
                        continue
                    raise
                if kind == "PodDisruptionBudget":
                    self._pdb_unavailable = False
                fixture[_FIXTURE_KEYS[kind]] = [convert(o) for o in items]
                versions[path] = version
            store = ClusterStore(
                fixture,
                semantics=self._semantics,
                extended_resources=self._extended,
            )
        finally:
            with self._lock:
                self._active_clients.discard(client)
            client.close()
        with self._lock:
            self._store = store
            self._versions = versions
            self._epoch += 1
            self._last_relist_t = self._clock()
            self._last_verified_t = self._last_relist_t
        self._counters["relists"].inc()
        self._synced.set()
        # The swapped-in store may hold changes that never flowed through
        # per-object events (that's what a relist is FOR) — consumers
        # (e.g. the serve path's coalescer) must republish.
        if self.on_event is not None:
            self.on_event("*", "RELIST", {})

    def _watch_loop(self, path: str) -> None:
        try:
            self._watch_loop_inner(path)
        except Exception as e:  # noqa: BLE001 - a dead watch must be visible
            # Unexpected failure — notably ReferencePanic, which reference
            # mode re-raises where the Go process would have died, or a bug
            # in convert/apply.  Record it, mark the follower fatal, and
            # stop BOTH streams: serving ever-staler snapshots behind a
            # silently dead thread is the one unacceptable outcome.
            self._errors.append(f"{path}: fatal {type(e).__name__}: {e}")
            with self._lock:
                self._fatal = f"{path}: {type(e).__name__}: {e}"
            self.stop()

    def _watch_loop_inner(self, path: str) -> None:
        kind, convert = _RESOURCES[path]
        prev_delay: float | None = None
        failing_since: float | None = None
        while not self._stop.is_set():
            if kind == "PodDisruptionBudget" and self._pdb_unavailable:
                # The optional stream stands down instead of hammering a
                # 403-ing endpoint; relists keep retrying the list side.
                return
            with self._lock:
                version = self._versions.get(path)
                epoch = self._epoch
            try:
                stream_ended = self._consume_stream(
                    path, kind, convert, version, epoch
                )
            except (KubeAPIError, KubeConfigError, StoreError) as e:
                self._errors.append(f"{path}: {e}")
                self._bump("watch_failures")
                # Back off (client-go reflector cadence: base
                # idle_backoff, growing, capped at 30 s) with
                # decorrelated jitter — many followers recovering from
                # one outage must not relist in lockstep against the
                # shared apiserver — then relist (410 Gone / transport
                # loss / bad apply).  A failing relist retries forever
                # within the resync deadline — a transient outage must
                # never permanently stop the sync loop — and a
                # persistently rejected watch (e.g. RBAC grants list but
                # not watch) keeps the capped cadence, not one LIST per
                # second.
                if failing_since is None:
                    failing_since = time.monotonic()
                delay = self._next_backoff(path, prev_delay)
                prev_delay = delay
                while not self._stop.is_set():
                    self._stop.wait(delay)
                    if self._stop.is_set():
                        return
                    try:
                        self._relist()
                        # Data is fresh again (even if the WATCH is still
                        # being rejected) — the staleness clock resets.
                        failing_since = None
                        break
                    except (KubeAPIError, KubeConfigError) as e2:
                        self._errors.append(f"relist {path}: {e2}")
                        self._bump("relist_failures")
                        stale_for = time.monotonic() - failing_since
                        if stale_for > self._resync_deadline:
                            # Watch AND relist failing past the deadline:
                            # credentials expired unrefreshably, RBAC
                            # revoked, apiserver gone.  The served
                            # snapshot is stale and getting staler —
                            # go fatal (via _watch_loop) rather than
                            # retry silently forever.
                            raise RuntimeError(
                                f"resync failing for {stale_for:.0f}s "
                                f"(deadline {self._resync_deadline:.0f}s); "
                                f"last error: {e2}"
                            ) from e2
                        delay = self._next_backoff(path, delay)
                        prev_delay = delay
                continue
            prev_delay = None
            failing_since = None
            self._clear_backoff(path)
            if stream_ended:
                with self._lock:
                    unchanged = version == self._versions.get(path)
                if unchanged:
                    # Window ended with no progress (idle cluster, or a
                    # finite mock stream under test).
                    if self._stop_on_idle_window:
                        return
                    # Back off before re-watching so a server that closes
                    # instantly cannot drive a hot loop; interruptible.
                    self._stop.wait(self._idle_backoff)
                continue  # re-watch from the latest seen version

    def _consume_stream(self, path, kind, convert, version, epoch) -> bool:
        """Stream one watch window.  ``epoch`` is the relist generation this
        stream was started against: if a peer thread relists mid-flight
        (swapping in a store listed at a NEWER resourceVersion), this
        stream's remaining events are older than the store and must not be
        applied — the epoch check drops them and ends the stream, and the
        loop re-watches from the post-relist version."""
        client = self._factory()
        with self._lock:
            self._active_clients.add(client)
        try:
            if self._stop.is_set():  # registration/stop() race — see _relist
                return False
            for event in client.watch_events(
                path, resource_version=version or None
            ):
                if self._stop.is_set():
                    return False
                etype = event.get("type", "")
                obj = event.get("object") or {}
                if etype == "BOOKMARK":
                    rv = (obj.get("metadata") or {}).get("resourceVersion")
                    if rv and not self._set_version(path, rv, epoch):
                        return False  # stale epoch: abandon this stream
                    continue
                if etype == "ERROR":
                    code = obj.get("code")
                    raise KubeAPIError(
                        f"watch error event: {obj.get('message', obj)}",
                        status=code if isinstance(code, int) else None,
                    )
                rv = (obj.get("metadata") or {}).get("resourceVersion")
                if not self._apply(kind, etype, convert(obj), epoch):
                    return False  # stale epoch: abandon this stream
                if rv and not self._set_version(path, rv, epoch):
                    return False
            return True
        finally:
            with self._lock:
                self._active_clients.discard(client)
            client.close()

    def _set_version(self, path: str, rv: str, epoch: int) -> bool:
        """Advance the resume version — only if this stream is current."""
        with self._lock:
            if epoch != self._epoch:
                return False
            self._versions[path] = rv
        return True

    def _apply(self, kind: str, etype: str, obj: dict, epoch: int) -> bool:
        """Apply one event; False (no-op) if the stream's epoch is stale."""
        with self._lock:
            if epoch != self._epoch:
                return False
            store = self._store
            if kind == "Node":
                exists = store.has_node(obj.get("name", ""))
            elif kind == "PodDisruptionBudget":
                exists = store.has_pdb(
                    obj.get("namespace", ""), obj.get("name", "")
                )
            else:
                exists = store.has_pod(
                    obj.get("namespace", ""), obj.get("name", "")
                )
            # Upsert translation: relist races can replay ADDED for known
            # objects or DELETED for unknown ones; both are benign.
            if etype in ("ADDED", "MODIFIED"):
                etype = "MODIFIED" if exists else "ADDED"
            elif etype == "DELETED" and not exists:
                return True
            store.apply_event({"type": etype, "kind": kind, "object": obj})
            self._last_verified_t = self._clock()
        self._counters["events_applied"].inc()
        if self.on_event is not None:
            self.on_event(kind, etype, obj)
        return True
