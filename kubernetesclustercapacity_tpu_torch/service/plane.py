"""The replicated serving plane: snapshot pub-sub fan-out + admission.

Counterpart of ``kubernetesclustercapacity_tpu/service/plane.py``
(verbatim apart from imports and three changes: the leader sends a
checkpoint, not a diff, for a generation whose taints changed (a diff
frame carries none, so the JAX replica of a tainted node added by a diff
serves it untainted); each verified generation is pre-staged on the
replica server's device as it is swapped in, so a replica built on the
card answers its next sweep from tensors already on the card; and
:meth:`PlaneSubscriber.stop` shuts its socket down, so the stream thread
ends at once instead of at its read timeout).

One :class:`~.server.CapacityServer` is a single point of failure — a
killed process, a stalled socket, or an overload burst takes the whole
capacity plane down with it.  This module multiplies it:

* :class:`PlanePublisher` — the **leader** side.  Every published
  snapshot generation (the same ``replace_snapshot`` funnel the
  timeline and audit log observe) fans out over a dedicated TCP stream
  to N subscribed replicas as the invertible checkpoint/diff record
  vocabulary the audit log pioneered: a fresh subscriber gets one
  full **checkpoint** of the current generation, every generation after
  rides as a **diff** against the previous one, and every frame carries
  the generation's :func:`~..timeline.diff.snapshot_digest` plus its
  parent's — a digest chain, so a replica can prove each reconstruction
  before serving it.  A subscriber that cannot keep up (bounded send
  queue overflows) is **ejected** — visibly behind, never silently
  wrong.
* :class:`PlaneSubscriber` — the **replica** side.  Follows the
  leader's stream, reconstructs each generation
  (:func:`~..audit.log.snapshot_from_summary`), verifies its digest,
  and stages it into the local server via
  ``replace_snapshot(generation=...)`` so the replica serves the
  LEADER's generation numbering — the watermark clients use for
  read-your-generation monotonicity.  A garbled or broken stream is
  dropped and resynced from a fresh checkpoint; an unverifiable frame
  is never applied.  A stream silent past ``stale_after_s`` marks the
  replica stale (surfaced via ``info``/``/healthz``) so load balancers
  route around bounded-staleness violations instead of discovering
  them.
* :class:`AdmissionController` — per-replica overload protection in
  the dispatch path: a bounded concurrency limiter (excess waits in a
  gauged queue, never unboundedly), a token-bucket rps cap
  (:class:`~..resilience.TokenBucket`), and deadline-slack shedding —
  a request whose budget is already spent (or below ``min_slack_s``)
  is refused before any work.  Refusals raise the 503-style
  :class:`~..resilience.OverloadedError`, which multi-endpoint clients
  treat as retryable-elsewhere.

The coordination-under-failure discipline mirrors gang-scheduled MPI
workers (PAPERS.md, "Rank-Aware Resource Scheduling for Tightly-Coupled
MPI Workloads"): every member serves a consistent view or is visibly
ejected — never silently wrong.
"""

from __future__ import annotations

import threading
import time

from kubernetesclustercapacity_tpu_torch.resilience import (
    DeadlineExpired,
    OverloadedError,
    TenantQuotaError,
    TokenBucket,
    decorrelated_jitter,
)
from kubernetesclustercapacity_tpu_torch.audit.log import taints_changed
from kubernetesclustercapacity_tpu_torch.service import protocol
from kubernetesclustercapacity_tpu_torch.utils.threads import supervised
from kubernetesclustercapacity_tpu_torch.timeline.diff import (
    SnapshotDiff,
    diff_summaries,
    node_summary,
    snapshot_digest,
)

__all__ = [
    "PLANE_PROTOCOL_VERSION",
    "AdmissionController",
    "PlaneError",
    "PlanePublisher",
    "PlaneSubscriber",
]

#: Version stamped into the subscriber hello and checked by the
#: publisher: a frame-vocabulary change bumps it, and a mismatched pair
#: refuses cleanly at attach instead of mis-applying frames.
PLANE_PROTOCOL_VERSION = 1


class PlaneError(RuntimeError):
    """Plane stream violation: bad hello, digest mismatch, unsupported
    version."""


def _disambiguate(names: list[str]) -> list[str]:
    """Row keys for a names list — the same rule
    :func:`~..timeline.diff.node_summary` applies (repeated names get
    ``#<occurrence>`` from their second occurrence on)."""
    seen: dict[str, int] = {}
    keys = []
    for name in names:
        n = seen.get(name, 0)
        seen[name] = n + 1
        keys.append(name if n == 0 else f"{name}#{n}")
    return keys


# ---------------------------------------------------------------------------
# Leader side
# ---------------------------------------------------------------------------
class _Subscriber:
    """One attached replica: its socket, bounded frame queue, and writer
    thread (sends must never run on the publisher thread — one slow
    replica must not stall the leader's publish funnel)."""

    def __init__(self, sock, peer: str, max_queue: int) -> None:
        self.sock = sock
        self.peer = peer
        self.max_queue = max_queue
        self.cv = threading.Condition()
        self.queue: list[dict] = []
        self.dead = False
        self.sent = 0
        self.thread: threading.Thread | None = None

    def offer(self, frame: dict) -> bool:
        """Enqueue one frame; False = queue full (caller ejects us)."""
        with self.cv:
            if self.dead:
                return False
            if len(self.queue) >= self.max_queue:
                return False
            self.queue.append(frame)
            self.cv.notify()
        return True

    def kill(self) -> None:
        with self.cv:
            self.dead = True
            self.cv.notify()
        try:
            self.sock.close()
        except OSError:
            pass

    def run(self) -> None:
        """Writer loop: drain the queue onto the socket until killed or
        the peer vanishes."""
        while True:
            with self.cv:
                while not self.dead and not self.queue:
                    self.cv.wait()
                if self.dead and not self.queue:
                    return
                frame = self.queue.pop(0)
            try:
                protocol.send_msg(self.sock, frame)
                self.sent += 1
            except (OSError, protocol.ProtocolError):
                self.kill()
                return


class PlanePublisher:
    """Leader-side snapshot fan-out over a dedicated plane port.

    Wire shape: a replica connects, sends one hello frame
    ``{"plane": PLANE_PROTOCOL_VERSION, "generation": G, "digest": d,
    "token": ...}`` (``generation``/``digest`` describe what it already
    holds; 0/"" for a cold start), and the publisher answers with either
    a ``resume`` ack (the replica's digest matches the current
    generation — no state transfer needed) or a full ``checkpoint``
    frame.  From then on every published generation arrives as a
    ``diff`` frame (same record vocabulary as the audit log), and a
    ``heartbeat`` rides every ``heartbeat_s`` of publish silence so
    subscribers can bound staleness.  A draining leader sends a
    ``drain`` frame before closing, so replicas distinguish "leader
    going away on purpose" from a cut link.

    ``publish`` is called on the server's publisher thread (the
    ``replace_snapshot`` funnel); it takes one lock shared with
    subscriber attach, so no generation is ever skipped or double-sent
    around an attach.
    """

    def __init__(
        self,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        token: str | None = None,
        max_queue: int = 128,
        heartbeat_s: float = 2.0,
        registry=None,
        trace_log=None,
    ) -> None:
        import socket as _socket

        if isinstance(trace_log, str):
            from kubernetesclustercapacity_tpu_torch.telemetry.tracing import (
                TraceLog,
            )

            trace_log = TraceLog(trace_log)
        # ``plane:publish`` spans: each published generation mints a
        # fresh trace, and the frame carries (trace_id, span_id) as
        # additive fields so every subscriber's ``plane:stage`` span
        # joins the SAME tree.  The digest covers the snapshot, not the
        # frame, so the trace fields never perturb verification.
        self._trace_log = trace_log
        self._token = token
        self._max_queue = int(max_queue)
        self._heartbeat_s = float(heartbeat_s)
        self._lock = threading.Lock()
        self._subs: list[_Subscriber] = []
        # Retained state of the last published generation: what a fresh
        # subscriber's checkpoint is built from, and what the next
        # publish diffs against.
        self._summary: dict[str, tuple[int, ...]] | None = None
        self._names: list[str] = []
        self._taints: list = []
        self._labels: list = []
        self._semantics = ""
        self._generation = 0
        self._digest = ""
        self._published = 0
        self._ejected = 0
        self._draining = False
        self._m_frames = None
        self._m_subs = None
        self._m_ejected = None
        if registry is not None:
            from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
                enabled as _telemetry_enabled,
            )

            if _telemetry_enabled():
                self._m_frames = registry.counter(
                    "kccap_plane_frames_total",
                    "Plane frames fanned out to subscribers, by kind.",
                    ("kind",),
                )
                self._m_subs = registry.gauge(
                    "kccap_plane_subscribers",
                    "Replicas currently subscribed to the plane stream.",
                )
                self._m_ejected = registry.counter(
                    "kccap_plane_ejected_total",
                    "Subscribers ejected for falling behind the stream.",
                )
        self._listener = _socket.create_server((host, port))
        self._listener.settimeout(0.2)
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(
            target=supervised(self._accept_loop, name="kccap-plane-accept"),
            daemon=True,
        )
        self._accept_thread.start()
        self._hb_thread = threading.Thread(
            target=supervised(
                self._heartbeat_loop, name="kccap-plane-heartbeat"
            ),
            daemon=True,
        )
        self._hb_thread.start()

    @property
    def address(self) -> tuple[str, int]:
        return self._listener.getsockname()

    # -- publish (leader's replace_snapshot funnel) ------------------------
    def publish(self, snapshot, generation: int) -> None:
        """Fan one published generation out to every subscriber.  Called
        in publish order on the publisher thread; best-effort per
        subscriber (a full queue ejects that subscriber, never fails the
        publish)."""
        t0 = time.perf_counter()
        wall0 = time.time()
        summary = node_summary(snapshot)
        digest = snapshot_digest(snapshot)
        with self._lock:
            # Taints ride checkpoints only (a diff frame has no word for
            # them, and the digest does not cover them): a generation
            # whose taints moved, a tainted node added among them, goes
            # out as a checkpoint, so a replica masks what the leader
            # masks.
            if (
                self._summary is None
                or snapshot.semantics != self._semantics
                or taints_changed(self._summary, self._taints, summary,
                                  snapshot.taints)
            ):
                frame = self._checkpoint_frame_locked(
                    summary, snapshot, generation, digest
                )
            else:
                frame = self._diff_frame_locked(
                    summary, snapshot, generation, digest
                )
            if self._trace_log is not None:
                from kubernetesclustercapacity_tpu_torch.telemetry.tracing import (
                    new_span_id,
                    new_trace_id,
                )

                frame["trace_id"] = new_trace_id()
                frame["span_id"] = new_span_id()
            self._summary = summary
            self._names = list(snapshot.names)
            self._taints = list(snapshot.taints or [])
            self._labels = list(getattr(snapshot, "labels", None) or [])
            self._semantics = snapshot.semantics
            self._generation = int(generation)
            self._digest = digest
            self._published += 1
            self._offer_all_locked(frame)
        if self._trace_log is not None:
            from kubernetesclustercapacity_tpu_torch.telemetry import (
                tracectx as _tracectx,
            )

            _tracectx.span(
                self._trace_log,
                ts=time.time(),
                start_ts=wall0,
                trace_id=frame["trace_id"],
                span_id=frame["span_id"],
                op="plane:publish",
                service="plane",
                kind=frame["kind"],
                generation=int(generation),
                duration_ms=round((time.perf_counter() - t0) * 1e3, 3),
                status="ok",
            )

    def _checkpoint_frame_locked(
        self, summary, snapshot, generation, digest
    ) -> dict:
        frame = {
            "kind": "checkpoint",
            "generation": int(generation),
            "digest": digest,
            "parent": "",
            "semantics": snapshot.semantics,
            "nodes": snapshot.n_nodes,
            "names": list(snapshot.names),
            "rows": [list(v) for v in summary.values()],
            "ts": time.time(),
        }
        if any(snapshot.taints or []):
            frame["taints"] = list(snapshot.taints)
        labels = getattr(snapshot, "labels", None) or []
        if any(labels):
            # Labels ride checkpoints (like taints) so replicas answer
            # topology/gang ops against the leader's hierarchy.
            frame["labels"] = list(labels)
        return frame

    def _diff_frame_locked(self, summary, snapshot, generation, digest) -> dict:
        diff = diff_summaries(self._summary, summary)
        names_by_key = dict(zip(summary.keys(), snapshot.names))
        frame = {
            "kind": "diff",
            "generation": int(generation),
            "digest": digest,
            "parent": self._digest,
            "semantics": snapshot.semantics,
            "nodes": snapshot.n_nodes,
            "added": {k: list(v) for k, v in diff.added.items()},
            "removed": {k: list(v) for k, v in diff.removed.items()},
            "changed": {k: dict(d) for k, d in diff.changed.items()},
            "ts": time.time(),
        }
        added_names = {
            k: names_by_key[k] for k in diff.added if names_by_key[k] != k
        }
        if added_names:
            frame["added_names"] = added_names
        labels = getattr(snapshot, "labels", None) or []
        if diff.added and any(labels):
            labels_by_key = dict(zip(summary.keys(), labels))
            added_labels = {
                k: labels_by_key[k]
                for k in diff.added
                if labels_by_key.get(k)
            }
            if added_labels:
                frame["added_labels"] = added_labels
        # apply() yields old-order-minus-removed then added; when the
        # true row order differs (a mid-list insert), the frame must say
        # so — the digest covers row order, so the replica must too.
        expected = list(diff.apply(self._summary))
        if expected != list(summary):
            frame["order"] = list(summary)
        return frame

    def _offer_all_locked(self, frame: dict) -> None:
        kind = frame.get("kind", "?")
        dead = []
        for sub in self._subs:
            if not sub.offer(frame):
                dead.append(sub)
            elif self._m_frames is not None:
                self._m_frames.labels(kind=kind).inc()
        for sub in dead:
            self._eject_locked(sub)

    def _eject_locked(self, sub: _Subscriber) -> None:
        sub.kill()
        if sub in self._subs:
            self._subs.remove(sub)
            self._ejected += 1
            if self._m_ejected is not None:
                self._m_ejected.inc()
            if self._m_subs is not None:
                self._m_subs.set(len(self._subs))

    # -- attach ------------------------------------------------------------
    def _accept_loop(self) -> None:
        import socket as _socket

        while not self._stop.is_set():
            try:
                conn, addr = self._listener.accept()
            except _socket.timeout:
                continue
            except OSError:
                return  # listener closed
            threading.Thread(
                target=supervised(self._attach, name="kccap-plane-attach"),
                args=(conn, addr),
                daemon=True,
            ).start()

    def _attach(self, conn, addr) -> None:
        peer = f"{addr[0]}:{addr[1]}"
        try:
            conn.settimeout(10.0)
            hello = protocol.recv_msg(conn)
        except (OSError, protocol.ProtocolError):
            self._close_quietly(conn)
            return
        try:
            self._validate_hello(hello)
        except PlaneError as e:
            try:
                protocol.send_msg(
                    conn, {"kind": "reject", "error": str(e)}
                )
            except (OSError, protocol.ProtocolError):
                pass
            self._close_quietly(conn)
            return
        conn.settimeout(None)
        sub = _Subscriber(conn, peer, self._max_queue)
        with self._lock:
            if self._draining or self._stop.is_set():
                self._close_quietly(conn)
                return
            if (
                self._summary is not None
                and hello.get("digest") == self._digest
                and hello.get("generation") == self._generation
            ):
                # The replica already holds the current generation
                # bit-for-bit (digest-proven): resume with diffs only.
                first = {
                    "kind": "resume",
                    "generation": self._generation,
                    "digest": self._digest,
                    "ts": time.time(),
                }
            elif self._summary is not None:
                first = self._checkpoint_frame_locked(
                    self._summary,
                    _RetainedView(
                        self._names, self._taints, self._semantics,
                        self._summary, self._labels,
                    ),
                    self._generation,
                    self._digest,
                )
            else:
                first = {"kind": "resume", "generation": 0, "digest": "",
                         "ts": time.time()}
            sub.offer(first)
            if self._m_frames is not None:
                self._m_frames.labels(kind=first["kind"]).inc()
            self._subs.append(sub)
            if self._m_subs is not None:
                self._m_subs.set(len(self._subs))
        sub.thread = threading.Thread(target=sub.run, daemon=True)
        sub.thread.start()
        # Reader side of the subscriber socket: the only thing a replica
        # ever sends after hello is EOF (disconnect) — watch for it so a
        # vanished replica deregisters promptly instead of at next send.
        try:
            while protocol.recv_msg(conn) is not None:
                pass
        except (OSError, protocol.ProtocolError):
            pass
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)
                if self._m_subs is not None:
                    self._m_subs.set(len(self._subs))
        sub.kill()

    def _validate_hello(self, hello) -> None:
        if not isinstance(hello, dict) or "plane" not in hello:
            raise PlaneError("expected a plane hello frame")
        if hello.get("plane") != PLANE_PROTOCOL_VERSION:
            raise PlaneError(
                f"unsupported plane protocol {hello.get('plane')!r} "
                f"(speaking {PLANE_PROTOCOL_VERSION})"
            )
        if self._token is not None:
            import hmac

            token = hello.get("token")
            if not isinstance(token, str) or not hmac.compare_digest(
                token.encode(), self._token.encode()
            ):
                raise PlaneError("missing or invalid plane token")

    @staticmethod
    def _close_quietly(conn) -> None:
        try:
            conn.close()
        except OSError:
            pass

    # -- heartbeats / drain / teardown -------------------------------------
    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self._heartbeat_s):
            with self._lock:
                if self._draining:
                    return
                self._offer_all_locked(
                    {
                        "kind": "heartbeat",
                        "generation": self._generation,
                        "ts": time.time(),
                    }
                )

    def announce_drain(self) -> None:
        """Tell every subscriber the leader is draining (they keep
        serving their current generation and poll for a successor),
        then stop accepting new subscribers."""
        with self._lock:
            if self._draining:
                return
            self._draining = True
            self._offer_all_locked(
                {
                    "kind": "drain",
                    "generation": self._generation,
                    "ts": time.time(),
                }
            )

    def stats(self) -> dict:
        """JSON-able leader-plane health (info op / healthz / doctor)."""
        with self._lock:
            return {
                "role": "leader",
                "address": list(self.address),
                "subscribers": len(self._subs),
                "generation": self._generation,
                "digest": self._digest,
                "published": self._published,
                "ejected": self._ejected,
                "draining": self._draining,
            }

    def close(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            subs = list(self._subs)
            self._subs.clear()
            if self._m_subs is not None:
                self._m_subs.set(0)
        for sub in subs:
            sub.kill()
        self._accept_thread.join(timeout=5)


class _RetainedView:
    """Duck-typed snapshot stand-in for checkpoint frames built from the
    publisher's retained state (a fresh subscriber attaching between
    publishes must get the CURRENT generation without the publisher
    holding a reference to the full snapshot object)."""

    def __init__(self, names, taints, semantics, summary, labels=()) -> None:
        self.names = names
        self.taints = taints
        self.labels = list(labels)
        self.semantics = semantics
        self.n_nodes = len(names)


# ---------------------------------------------------------------------------
# Replica side
# ---------------------------------------------------------------------------
class PlaneSubscriber:
    """Replica-side stream follower: stage each verified generation into
    the local server.

    Every frame is digest-verified before it is served: a checkpoint
    reconstructs a snapshot and must hash to the frame's digest; a diff
    must chain from the replica's current digest (``parent``) and its
    application must hash to the frame's digest.  Any violation — a
    garbled frame, a broken chain, invalid JSON — drops the connection
    and resyncs from a fresh checkpoint.  **An unverified generation is
    never staged**; under arbitrary link corruption the replica serves
    a stale-but-correct generation, not a wrong one.

    ``clock`` is injectable (monotonic seconds) so staleness tests are
    deterministic.  ``on_apply(generation)`` is an optional observer
    fired after each staged generation (tests synchronize on it).
    """

    def __init__(
        self,
        leader: tuple[str, int],
        server,
        *,
        token: str | None = None,
        stale_after_s: float = 10.0,
        reconnect_base_s: float = 0.05,
        reconnect_max_s: float = 2.0,
        seed: int | None = None,
        registry=None,
        clock=time.monotonic,
        on_apply=None,
        trace_log=None,
    ) -> None:
        import random as _random

        if isinstance(trace_log, str):
            from kubernetesclustercapacity_tpu_torch.telemetry.tracing import (
                TraceLog,
            )

            trace_log = TraceLog(trace_log)
        # ``plane:stage`` spans, parented to the publisher's
        # ``plane:publish`` span via the (trace_id, span_id) the frame
        # carries — the cross-process replication link of the trace
        # tree.
        self._trace_log = trace_log
        self._leader = tuple(leader)
        self._server = server
        self._token = token
        self._stale_after = float(stale_after_s)
        self._base = float(reconnect_base_s)
        self._cap = float(reconnect_max_s)
        self._rng = _random.Random(seed)
        self._clock = clock
        self._on_apply = on_apply
        self._lock = threading.Lock()
        self._sock = None
        self._stop = threading.Event()
        # Held replica state: the summary vocabulary of the staged
        # generation (what diffs apply against).
        self._summary: dict[str, tuple[int, ...]] | None = None
        self._name_of: dict[str, str] = {}
        self._taints_of: dict[str, list] = {}
        self._labels_of: dict[str, dict] = {}
        self._generation = 0
        self._digest = ""
        self._last_frame_at: float | None = None
        # The VERIFIED clock: last instant the held generation was
        # digest-proven current — a staged frame, an idempotent
        # re-delivery of the held generation, a digest-match resume, or
        # a heartbeat stamped with the held generation.  Garbled frames
        # and heartbeats announcing a NEWER generation (frames were
        # missed) do not advance it, so federation staleness math reads
        # ONE clock instead of re-deriving wall-clock in two places.
        self._last_verified_at: float | None = None
        self._applied = 0
        self._skipped = 0
        self._resyncs = 0
        self._errors = 0
        self._leader_draining = False
        self._last_error: str | None = None
        self._m_generation = None
        self._m_applied = None
        self._m_age = None
        if registry is not None:
            from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
                enabled as _telemetry_enabled,
            )

            if _telemetry_enabled():
                self._m_generation = registry.gauge(
                    "kccap_plane_generation",
                    "Last plane generation applied by this replica.",
                )
                self._m_applied = registry.counter(
                    "kccap_plane_applied_total",
                    "Plane generations staged into the local server, "
                    "by result.",
                    ("result",),
                )
                self._m_age = registry.gauge(
                    "kccap_plane_sync_age_seconds",
                    "Seconds since the last frame arrived from the "
                    "leader.",
                )
                self._m_age.labels().set_function(
                    lambda: -1.0 if self._last_frame_at is None
                    else round(self._clock() - self._last_frame_at, 3)
                )
        # The replica is read-only: mutations must go to the leader.
        # Its plane stats feed the server's ``info {plane: true}``
        # section, and a server drain stops the stream first
        # (deregistration from the plane).
        server.set_plane_role("replica", stats_source=self.stats)
        server.add_drain_hook(self.stop)
        self._thread = threading.Thread(
            target=supervised(self._run, name="kccap-plane-subscriber"),
            daemon=True,
        )
        self._thread.start()

    # -- observability -----------------------------------------------------
    @property
    def applied_generation(self) -> int:
        with self._lock:
            return self._generation

    def sync_age_s(self) -> float | None:
        with self._lock:
            if self._last_frame_at is None:
                return None
            return self._clock() - self._last_frame_at

    def last_verified_age_s(self) -> float | None:
        """Seconds (on the injectable monotonic ``clock``) since the held
        generation was last digest-proven current; ``None`` before the
        first verification.  Stricter than :meth:`sync_age_s`: a frame
        that arrives but does not verify (garbage, a heartbeat stamped
        with a generation this replica missed) resets nothing — the
        federation tier's fresh/stale/lost state machine reads exactly
        this accessor, so staleness is never computed from two clocks."""
        with self._lock:
            if self._last_verified_at is None:
                return None
            return self._clock() - self._last_verified_at

    @property
    def stale(self) -> bool:
        """True once the stream has been silent past ``stale_after_s``
        (heartbeats reset it) — the bounded-staleness detector."""
        age = self.sync_age_s()
        return age is None or age > self._stale_after

    def stats(self) -> dict:
        age = self.sync_age_s()
        with self._lock:
            return {
                "role": "replica",
                "leader": list(self._leader),
                "generation": self._generation,
                "digest": self._digest,
                "applied": self._applied,
                "skipped": self._skipped,
                "resyncs": self._resyncs,
                "errors": self._errors,
                "leader_draining": self._leader_draining,
                "sync_age_s": None if age is None else round(age, 3),
                "stale": age is None or age > self._stale_after,
                "stale_after_s": self._stale_after,
                "last_error": self._last_error,
            }

    # -- stream loop -------------------------------------------------------
    def _run(self) -> None:
        import socket as _socket

        delay = None
        while not self._stop.is_set():
            try:
                sock = _socket.create_connection(self._leader, timeout=5.0)
            except OSError as e:
                self._note_error(f"connect: {type(e).__name__}: {e}")
                delay = decorrelated_jitter(
                    self._rng, self._base, delay, self._cap
                )
                self._stop.wait(delay)
                continue
            delay = None
            with self._lock:
                self._sock = sock
            try:
                self._follow(sock)
            except (OSError, protocol.ProtocolError, PlaneError) as e:
                self._note_error(f"{type(e).__name__}: {e}")
                with self._lock:
                    self._resyncs += 1
            finally:
                with self._lock:
                    if self._sock is sock:
                        self._sock = None
                try:
                    sock.close()
                except OSError:
                    pass
            # Brief jittered pause before resync so a flapping link
            # cannot spin this thread hot.
            delay = decorrelated_jitter(self._rng, self._base, delay, self._cap)
            self._stop.wait(delay)

    def _follow(self, sock) -> None:
        with self._lock:
            hello = {
                "plane": PLANE_PROTOCOL_VERSION,
                "generation": self._generation,
                "digest": self._digest,
            }
        if self._token is not None:
            hello["token"] = self._token
        sock.settimeout(10.0)
        protocol.send_msg(sock, hello)
        # Frame read timeout: generous vs the heartbeat cadence, so a
        # live-but-quiet leader never times the replica out, while a
        # dead TCP peer is noticed without an OS-default multi-minute
        # wait.  Staleness itself is judged by stale_after_s.
        sock.settimeout(max(self._stale_after, 1.0))
        while not self._stop.is_set():
            frame = protocol.recv_msg(sock)
            if frame is None:
                raise PlaneError("leader closed the plane stream")
            if not isinstance(frame, dict):
                raise PlaneError(f"non-object plane frame: {frame!r}")
            self._handle_frame(frame)

    def _handle_frame(self, frame: dict) -> None:
        kind = frame.get("kind")
        now = self._clock()
        with self._lock:
            self._last_frame_at = now
        if kind == "reject":
            raise PlaneError(f"leader rejected us: {frame.get('error')}")
        if kind in ("heartbeat", "resume"):
            # A heartbeat/resume stamped with the generation we HOLD is
            # proof the held snapshot is still the leader's current one.
            with self._lock:
                held = self._generation
                if self._summary is not None and (
                    frame.get("generation") == held
                ):
                    self._last_verified_at = now
            if kind == "heartbeat":
                gen = frame.get("generation")
                if isinstance(gen, int) and gen > held:
                    # The leader is ahead of us but the connection is
                    # "live": frames were dropped on this link (e.g. a
                    # partition that healed before our read timed out).
                    # Waiting for the next diff to break the digest
                    # chain could wait forever on a quiet leader — the
                    # heartbeat itself is the gap evidence, so resync
                    # NOW through a fresh checkpoint.
                    raise PlaneError(
                        f"heartbeat announces generation {gen} ahead of "
                        f"held {held}: frames were missed on this "
                        "stream; resyncing"
                    )
            return
        if kind == "drain":
            with self._lock:
                self._leader_draining = True
            return
        if kind == "checkpoint":
            self._apply_checkpoint(frame)
            return
        if kind == "diff":
            self._apply_diff(frame)
            return
        raise PlaneError(f"unknown plane frame kind {kind!r}")

    def _apply_checkpoint(self, frame: dict) -> None:
        names = [str(n) for n in frame["names"]]
        keys = _disambiguate(names)
        rows = {
            k: tuple(int(x) for x in row)
            for k, row in zip(keys, frame["rows"])
        }
        name_of = dict(zip(keys, names))
        taints_of = {k: t for k, t in zip(keys, frame.get("taints") or [])}
        labels_of = {
            k: lb for k, lb in zip(keys, frame.get("labels") or [])
        }
        self._stage(
            rows, name_of, taints_of, labels_of, frame, chain_parent=False
        )

    def _apply_diff(self, frame: dict) -> None:
        with self._lock:
            if self._summary is None:
                raise PlaneError("diff frame before any checkpoint")
            if frame.get("parent") != self._digest:
                raise PlaneError(
                    f"digest chain broken: frame parent "
                    f"{frame.get('parent')!r} != held {self._digest!r}"
                )
            held = dict(self._summary)
            name_of = dict(self._name_of)
            taints_of = dict(self._taints_of)
            labels_of = dict(self._labels_of)
        diff = SnapshotDiff(
            added={
                k: tuple(int(x) for x in v)
                for k, v in frame.get("added", {}).items()
            },
            removed={
                k: tuple(int(x) for x in v)
                for k, v in frame.get("removed", {}).items()
            },
            changed={
                k: {f: int(d) for f, d in ch.items()}
                for k, ch in frame.get("changed", {}).items()
            },
        )
        rows = diff.apply(held)
        order = frame.get("order")
        if order is not None:
            try:
                rows = {k: rows[k] for k in order}
            except KeyError as e:
                raise PlaneError(f"order references unknown row {e}")
        added_names = frame.get("added_names", {})
        added_labels = frame.get("added_labels", {})
        for k in diff.removed:
            name_of.pop(k, None)
            taints_of.pop(k, None)
            labels_of.pop(k, None)
        for k in diff.added:
            name_of[k] = added_names.get(k, k)
            if k in added_labels:
                labels_of[k] = added_labels[k]
        self._stage(
            rows, name_of, taints_of, labels_of, frame, chain_parent=True
        )

    def _stage(
        self, rows, name_of, taints_of, labels_of, frame, *, chain_parent
    ) -> None:
        """Reconstruct, digest-verify, and stage one generation.  The
        digest check is the whole safety story: a frame that does not
        reconstruct bit-identically is a :class:`PlaneError` (→ resync),
        never a served snapshot."""
        from kubernetesclustercapacity_tpu_torch.audit.log import (
            snapshot_from_summary,
        )

        t_stage0 = time.perf_counter()
        wall_stage0 = time.time()
        generation = int(frame["generation"])
        with self._lock:
            current = self._generation
            current_digest = self._digest
        if generation < current:
            with self._lock:
                self._skipped += 1
            if self._m_applied is not None:
                self._m_applied.labels(result="skipped").inc()
            return
        snap = snapshot_from_summary(
            rows, name_of, taints_of, frame["semantics"],
            labels_of=labels_of,
        )
        actual = snapshot_digest(snap)
        if actual != frame["digest"]:
            if self._m_applied is not None:
                self._m_applied.labels(result="digest_mismatch").inc()
            raise PlaneError(
                f"generation {generation} reconstruction digest "
                f"{actual!r} != frame digest {frame['digest']!r}"
            )
        if generation == current and actual == current_digest:
            # Idempotent re-delivery (reconnect checkpoint of the held
            # generation): nothing to stage, but the held generation was
            # just digest-proven current again.
            with self._lock:
                self._skipped += 1
                self._last_verified_at = self._clock()
            return
        # warm=True: stage the verified generation on the server's device
        # now, on this thread, not on the next request's.
        self._server.replace_snapshot(snap, generation=generation, warm=True)
        with self._lock:
            self._summary = rows
            self._name_of = name_of
            self._taints_of = taints_of
            self._labels_of = labels_of
            self._generation = generation
            self._digest = actual
            self._applied += 1
            self._last_verified_at = self._clock()
            self._leader_draining = False
        if self._m_generation is not None:
            self._m_generation.set(generation)
        if self._m_applied is not None:
            self._m_applied.labels(result="applied").inc()
        if self._trace_log is not None:
            tid = frame.get("trace_id")
            pid = frame.get("span_id")
            if isinstance(tid, str) and tid:
                from kubernetesclustercapacity_tpu_torch.telemetry import (
                    tracectx as _tracectx,
                )
                from kubernetesclustercapacity_tpu_torch.telemetry.tracing import (
                    new_span_id,
                )

                _tracectx.span(
                    self._trace_log,
                    ts=time.time(),
                    start_ts=wall_stage0,
                    trace_id=tid,
                    span_id=new_span_id(),
                    **(
                        {"parent_span_id": pid}
                        if isinstance(pid, str) and pid
                        else {}
                    ),
                    op="plane:stage",
                    service="plane",
                    kind=str(frame.get("kind", "")),
                    generation=generation,
                    duration_ms=round(
                        (time.perf_counter() - t_stage0) * 1e3, 3
                    ),
                    status="ok",
                )
        if self._on_apply is not None:
            try:
                self._on_apply(generation)
            except Exception:  # noqa: BLE001 - observers never break the stream
                pass

    def _note_error(self, err: str) -> None:
        with self._lock:
            self._errors += 1
            self._last_error = err

    def stop(self) -> None:
        """Stop following (idempotent; also the server's drain hook)."""
        import socket as _socket

        self._stop.set()
        with self._lock:
            sock = self._sock
            self._sock = None
        if sock is not None:
            # shutdown() wakes the stream thread's blocking read at once;
            # close() alone leaves it to its read timeout.
            try:
                sock.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=5)

    def __enter__(self) -> "PlaneSubscriber":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------
class AdmissionController:
    """Refuse-before-work overload protection for the dispatch path.

    Three gates, cheapest first, each with its own shed reason:

    1. **deadline slack** — a request whose budget is already spent (or
       below ``min_slack_s``) sheds with
       :class:`~..resilience.DeadlineExpired` *before* any queueing or
       token accounting: no kernel, no device touch, no bucket debit
       for an answer nobody is waiting for.
    2. **rps token bucket** — sustained arrival rate above ``rps``
       sheds with :class:`~..resilience.OverloadedError` (burst up to
       ``burst`` rides the bucket capacity).
    3. **concurrency** — at most ``max_concurrent`` admitted requests
       at once; excess waits in a bounded, gauged queue
       (``kccap_admission_queue_depth``) up to
       ``min(max_queue_wait_s, deadline slack)``, recording the wait as
       the ``admission`` phase, then sheds with
       :class:`~..resilience.OverloadedError`.

    An optional **shadow-price budget** (``price_budget`` in ``(0, 1]``)
    adds a scarcity gate between 1 and 2: the optimizer's certified
    dual solution prices served capacity (the ``capacity_share`` of its
    shadow prices — 0 when demand-bound, 1 when every requested replica
    is priced by a scarce resource), and while the last *certified*
    observation exceeds the budget, governed compute requests shed with
    :class:`~..resilience.OverloadedError` — "this request is worth
    shedding: its shadow price exceeds budget".  Only certified solves
    move the signal (an uncertified dual is a loose bound, not a
    price), so the gate can never act on a lie.

    A :class:`~.tenancy.TenantMap` (``tenants=...``) arms **per-tenant
    quotas** between 2 and 3: each mapped tenant's own
    :class:`~..resilience.TokenBucket` rps cap and concurrency quota,
    shed with the AUTHORITATIVE
    :class:`~..resilience.TenantQuotaError` (reason ``tenant_quota`` —
    every replica enforces the same map, so clients must not fail
    over), and the concurrency gate becomes a
    :class:`~.tenancy.FairSlotQueue` — deficit round-robin across
    per-tenant sub-queues instead of the global FIFO semaphore, so a
    hot tenant's backlog cannot starve an idle tenant's first request.
    Without a map the controller is byte-identical to the pre-tenancy
    single-queue path (``tenant=`` is accepted and ignored).

    Counters are exact under concurrency (pinned by a 16-thread hammer
    in ``tests/test_plane.py``): every governed request is counted
    exactly once as admitted or shed.
    """

    def __init__(
        self,
        *,
        max_concurrent: int = 0,
        rps: float = 0.0,
        burst: float | None = None,
        max_queue_wait_s: float = 0.5,
        min_slack_s: float = 0.0,
        price_budget: float = 0.0,
        registry=None,
        clock=time.monotonic,
        tenants=None,
    ) -> None:
        if max_concurrent < 0:
            raise ValueError(
                f"max_concurrent must be >= 0, got {max_concurrent}"
            )
        if rps < 0:
            raise ValueError(f"rps must be >= 0, got {rps}")
        if not 0.0 <= price_budget <= 1.0:
            raise ValueError(
                f"price_budget must be in [0, 1], got {price_budget}"
            )
        self.price_budget = float(price_budget)
        self._shadow_price: float | None = None
        self.max_concurrent = int(max_concurrent)
        self.rps = float(rps)
        self.max_queue_wait_s = float(max_queue_wait_s)
        self.min_slack_s = float(min_slack_s)
        self._tenants = tenants
        self._fair = None
        if tenants is not None and self.max_concurrent > 0:
            from kubernetesclustercapacity_tpu_torch.service.tenancy import (
                FairSlotQueue,
            )

            self._fair = FairSlotQueue(
                self.max_concurrent, weight_of=tenants.weight
            )
        self._sem = (
            threading.Semaphore(self.max_concurrent)
            if self.max_concurrent > 0 and self._fair is None
            else None
        )
        self._bucket = (
            TokenBucket(self.rps, burst, clock=clock) if self.rps > 0 else None
        )
        self._tenant_buckets: dict = {}
        self._tenant_quota: dict = {}
        if tenants is not None:
            for spec in tenants.specs:
                if spec.rps > 0:
                    self._tenant_buckets[spec.name] = TokenBucket(
                        spec.rps, spec.burst, clock=clock
                    )
                if spec.max_concurrent > 0:
                    self._tenant_quota[spec.name] = int(spec.max_concurrent)
        self._lock = threading.Lock()
        self._queue_depth = 0
        self._admitted = 0
        self._shed: dict[str, int] = {}
        self._tenant_active: dict[str, int] = {}
        self._tenant_queued: dict[str, int] = {}
        self._m_admitted = None
        self._m_shed = None
        self._m_queue = None
        self._m_tenant_admitted = None
        self._m_tenant_shed = None
        self._m_tenant_queue = None
        if registry is not None:
            from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
                enabled as _telemetry_enabled,
            )

            if _telemetry_enabled():
                self._m_admitted = registry.counter(
                    "kccap_admission_admitted_total",
                    "Requests admitted past admission control, by op.",
                    ("op",),
                )
                self._m_shed = registry.counter(
                    "kccap_admission_shed_total",
                    "Requests shed at admission, by op and reason.",
                    ("op", "reason"),
                )
                self._m_queue = registry.gauge(
                    "kccap_admission_queue_depth",
                    "Requests currently queued at the admission "
                    "concurrency gate.",
                )
                if tenants is not None:
                    # Bounded cardinality: labels come from
                    # TenantMap.label (map-named tenants + "default" +
                    # the "other" fold), never raw request identity.
                    self._m_tenant_admitted = registry.counter(
                        "kccap_tenant_admitted_total",
                        "Requests admitted, by tenant (map-named "
                        "tenants only; everything else folds to "
                        "'other').",
                        ("tenant",),
                    )
                    self._m_tenant_shed = registry.counter(
                        "kccap_tenant_shed_total",
                        "Requests shed at admission, by tenant and "
                        "reason.",
                        ("tenant", "reason"),
                    )
                    self._m_tenant_queue = registry.gauge(
                        "kccap_tenant_queue_depth",
                        "Requests queued at the weighted-fair "
                        "admission gate, by tenant.",
                        ("tenant",),
                    )

    def observe_shadow_price(
        self, capacity_share: float, *, certified: bool
    ) -> None:
        """Record one optimize solve's capacity-price signal.

        Uncertified observations are DISCARDED — the budget gate only
        ever acts on a certified dual solution.  Called by the server
        after each ``optimize`` dispatch; harmless without a budget.
        """
        if not certified:
            return
        with self._lock:
            self._shadow_price = float(capacity_share)

    def shadow_price(self) -> float | None:
        """The last certified capacity-price observation (None before
        any certified solve)."""
        with self._lock:
            return self._shadow_price

    def count_shed(self, op: str, reason: str) -> None:
        """Record one shed decided OUTSIDE this controller's gates (the
        server's draining refusal uses it, so every refusal lands in the
        same ``kccap_admission_shed_total`` story)."""
        with self._lock:
            self._shed[reason] = self._shed.get(reason, 0) + 1
        if self._m_shed is not None:
            self._m_shed.labels(op=op, reason=reason).inc()

    def admit(self, op: str, deadline=None, *, priced: bool = True,
              tenant: str | None = None):
        """Gate one governed request: returns a zero-arg ``release``
        callable on admission, raises on shed.  Callers MUST invoke the
        release in a ``finally`` (the server's dispatch does).
        ``priced=False`` skips the shadow-price gate — the server
        exempts the ``optimize`` op itself, since that is the dispatch
        that refreshes the price (a price-gated refresher could latch
        the gate shut forever).  ``tenant`` names the calling tenant
        for the per-tenant quota gates and the weighted-fair queue
        (``None`` folds to ``"default"``); without a tenant map it is
        accepted and ignored — the pre-tenancy path, byte-identical."""
        # Gate 1: deadline slack — cheapest, and shedding here must not
        # debit the token bucket (the request consumed no capacity).
        if deadline is not None:
            remaining = deadline.remaining()
            if remaining <= self.min_slack_s:
                self.count_shed(op, "deadline")
                raise DeadlineExpired(
                    f"deadline slack {remaining:.3f}s <= "
                    f"{self.min_slack_s:.3f}s at admission; shedding "
                    "without dispatch"
                )
        # Gate 1.5: shadow-price budget — a pure read, before the token
        # bucket (a priced-out request consumed no capacity).
        if priced and self.price_budget > 0.0:
            with self._lock:
                price = self._shadow_price
            if price is not None and price > self.price_budget:
                self.count_shed(op, "shadow_price")
                raise OverloadedError(
                    f"capacity shadow price {price:.3f} exceeds budget "
                    f"{self.price_budget:.3f}; shedding — retry another "
                    "replica"
                )
        # Gate 2: rps.
        if self._bucket is not None and not self._bucket.try_acquire():
            self.count_shed(op, "rps")
            raise OverloadedError(
                f"admission rps cap {self.rps:g}/s exceeded; "
                "retry another replica"
            )
        # Gate 2.5: per-tenant quotas (rps cap + concurrency share).
        # These refusals are AUTHORITATIVE — every replica enforces the
        # same map — so the typed tenant_quota code tells multi-endpoint
        # clients not to fail over.
        reserved = False
        if self._tenants is not None:
            tenant = tenant or "default"
            bucket = self._tenant_buckets.get(tenant)
            if bucket is not None and not bucket.try_acquire():
                self._shed_tenant(op, tenant, "tenant_quota")
                spec = self._tenants.spec(tenant)
                raise TenantQuotaError(
                    f"tenant {tenant!r} rps cap {spec.rps:g}/s "
                    "exceeded; back off (authoritative refusal — do "
                    "not fail over)"
                )
            quota = self._tenant_quota.get(tenant, 0)
            if quota > 0:
                with self._lock:
                    active = self._tenant_active.get(tenant, 0)
                    if active < quota:
                        self._tenant_active[tenant] = active + 1
                        reserved = True
                if not reserved:
                    self._shed_tenant(op, tenant, "tenant_quota")
                    raise TenantQuotaError(
                        f"tenant {tenant!r} concurrency quota {quota} "
                        "saturated; back off (authoritative refusal — "
                        "do not fail over)"
                    )
        # Gate 3: concurrency (bounded queue; deficit round-robin
        # across tenant sub-queues when a tenant map armed it).
        if self._fair is not None:
            try:
                self._admit_fair(op, tenant, deadline)
            except BaseException:
                if reserved:
                    self._unreserve(tenant)
                raise
        elif self._sem is not None:
            acquired = self._sem.acquire(blocking=False)
            if not acquired:
                wait_s = self.max_queue_wait_s
                if deadline is not None:
                    wait_s = max(
                        0.0, min(wait_s, deadline.remaining())
                    )
                with self._lock:
                    self._queue_depth += 1
                    if self._m_queue is not None:
                        self._m_queue.set(self._queue_depth)
                from kubernetesclustercapacity_tpu_torch.telemetry import (
                    phases as _phases,
                )

                clk = _phases.current()
                t0 = time.perf_counter() if clk else 0.0
                try:
                    acquired = self._sem.acquire(timeout=wait_s)
                finally:
                    with self._lock:
                        self._queue_depth -= 1
                        if self._m_queue is not None:
                            self._m_queue.set(self._queue_depth)
                    if clk:
                        clk.record(
                            "admission", time.perf_counter() - t0
                        )
                if not acquired:
                    self.count_shed(op, "concurrency")
                    raise OverloadedError(
                        f"admission concurrency cap "
                        f"{self.max_concurrent} saturated after "
                        f"{wait_s:.3f}s queue wait; retry another "
                        "replica"
                    )
        with self._lock:
            self._admitted += 1
        if self._m_admitted is not None:
            self._m_admitted.labels(op=op).inc()
        if self._tenants is not None:
            if self._m_tenant_admitted is not None:
                self._m_tenant_admitted.labels(
                    tenant=self._tenants.label(tenant)
                ).inc()
            return self._release_tenant(tenant, reserved)
        if self._sem is not None:
            return self._sem.release
        return _noop

    def _admit_fair(self, op: str, tenant: str, deadline) -> None:
        """Tenancy's Gate 3: the deficit-round-robin concurrency gate,
        with the exact bounded-wait / ``admission``-phase contract of
        the semaphore path it replaces."""
        if self._fair.try_acquire(tenant):
            return
        wait_s = self.max_queue_wait_s
        if deadline is not None:
            wait_s = max(0.0, min(wait_s, deadline.remaining()))
        label = self._tenants.label(tenant)
        with self._lock:
            self._queue_depth += 1
            if self._m_queue is not None:
                self._m_queue.set(self._queue_depth)
            depth = self._tenant_queued.get(label, 0) + 1
            self._tenant_queued[label] = depth
            if self._m_tenant_queue is not None:
                self._m_tenant_queue.labels(tenant=label).set(depth)
        from kubernetesclustercapacity_tpu_torch.telemetry import (
            phases as _phases,
        )

        clk = _phases.current()
        t0 = time.perf_counter() if clk else 0.0
        try:
            acquired = self._fair.acquire(tenant, timeout=wait_s)
        finally:
            with self._lock:
                self._queue_depth -= 1
                if self._m_queue is not None:
                    self._m_queue.set(self._queue_depth)
                depth = max(0, self._tenant_queued.get(label, 0) - 1)
                if depth:
                    self._tenant_queued[label] = depth
                else:
                    self._tenant_queued.pop(label, None)
                if self._m_tenant_queue is not None:
                    self._m_tenant_queue.labels(tenant=label).set(depth)
            if clk:
                clk.record(
                    "admission", time.perf_counter() - t0
                )
        if not acquired:
            self._shed_tenant(op, tenant, "concurrency")
            raise OverloadedError(
                f"admission concurrency cap {self.max_concurrent} "
                f"saturated after {wait_s:.3f}s weighted-fair queue "
                f"wait (tenant {tenant!r}); retry another replica"
            )

    def _shed_tenant(self, op: str, tenant: str, reason: str) -> None:
        """One tenant-attributed shed: the shared op/reason counter
        plus the bounded-cardinality per-tenant family."""
        self.count_shed(op, reason)
        if self._m_tenant_shed is not None:
            self._m_tenant_shed.labels(
                tenant=self._tenants.label(tenant), reason=reason
            ).inc()

    def _unreserve(self, tenant: str) -> None:
        with self._lock:
            n = self._tenant_active.get(tenant, 0)
            if n <= 1:
                self._tenant_active.pop(tenant, None)
            else:
                self._tenant_active[tenant] = n - 1

    def _release_tenant(self, tenant: str, reserved: bool):
        """The release callable for a tenancy-armed admission: frees
        the DRR slot (when one was held) and the tenant's quota
        reservation, exactly once (dispatch calls it in a finally)."""
        fair = self._fair

        def release() -> None:
            if fair is not None:
                fair.release(tenant)
            if reserved:
                self._unreserve(tenant)

        return release

    def tenant_stats(self) -> dict | None:
        """The ``info``/doctor tenancy section: per-tenant in-flight
        quota reservations, shed counts by reason, and the fair
        queue's live occupancy.  ``None`` without a tenant map."""
        if self._tenants is None:
            return None
        with self._lock:
            active = dict(self._tenant_active)
            shed = dict(self._shed)
        return {
            "tenants": len(self._tenants),
            "active": active,
            "shed": shed,
            "fair_queue": (
                self._fair.stats() if self._fair is not None else None
            ),
        }


def _noop() -> None:
    pass
