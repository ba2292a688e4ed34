"""Deterministic fault injection at the service protocol boundary.

Counterpart of ``kubernetesclustercapacity_tpu/testing_faults.py``
(verbatim apart from imports).

An in-process TCP proxy that sits between a :class:`~.service.client
.CapacityClient` and a :class:`~.service.server.CapacityServer` and
injects transport faults *per request frame*: connection drops, partial
writes, garbage frames, and stalls past the caller's deadline.  The
chaos suite (``tests/test_resilience.py``) drives a scripted op
sequence through it and asserts the results are bit-identical to a
fault-free run — the resilience layer's acceptance bar.

Faults are scripted, not sampled at injection time: a :class:`FaultPlan`
is either an explicit per-request sequence (exhausted → pass-through)
or generated up front from a seed, so every chaos run is exactly
reproducible.  The plan consumes one decision per *client request
frame* observed, across all connections, in arrival order.

Fault vocabulary (``FAULTS``):

``drop_pre``
    Close the client connection *without* forwarding the request — the
    server never sees it (safe to inject on non-idempotent ops; used to
    prove ``update``/``reload`` are never auto-retried).
``drop_post``
    Forward the request, read the server's reply, then close without
    sending any of it — the op executed but the client cannot know.
``partial``
    Forward, then send only the first half of the reply frame and close
    (a mid-frame transport loss).
``garbage``
    Forward, discard the real reply, send a well-framed body that is not
    valid JSON, and close.
``stall``
    Sleep ``stall_s`` before forwarding — long enough for the client's
    read timeout or deadline to fire first.

Stream mode (``FaultProxy(..., stream=True)``) adapts the proxy to
one-request-many-replies protocols — the serving plane's pub-sub stream
(:mod:`.service.plane`), where a subscriber sends one hello frame and
then receives an unbounded frame stream.  The client's first frame is
always forwarded intact; the plan then consumes one decision per
SERVER frame, in arrival order: ``drop_pre`` silently swallows the
frame (the subscriber sees a gap — its digest chain breaks and it must
resync), ``garbage``/``partial`` corrupt it, ``stall`` delays it, and
``drop_post`` cuts the connection after delivering it.

Runtime partition control (:meth:`FaultProxy.partition` /
:meth:`FaultProxy.heal`) models a network partition ORTHOGONALLY to the
scripted plan: while partitioned, every frame crossing the cut
direction(s) is silently swallowed — connections stay up, bytes just
never arrive, exactly what a partition looks like from an endpoint.
``direction`` selects symmetric (``"both"``) or asymmetric one-way
drops (``"to_server"`` / ``"to_client"``); both methods are safe to
call from the test thread mid-traffic without restarting the proxy, and
partitioned frames consume NO plan decisions (a scripted fault schedule
stays aligned to the frames that actually cross).
"""

from __future__ import annotations

import random
import socket
import struct
import threading

from kubernetesclustercapacity_tpu_torch.utils.threads import supervised
import time

__all__ = ["FAULTS", "PARTITION_DIRECTIONS", "FaultPlan", "FaultProxy"]

FAULTS = ("drop_pre", "drop_post", "partial", "garbage", "stall")

#: Valid :meth:`FaultProxy.partition` directions: symmetric, or the two
#: asymmetric one-way cuts (frames dropped only on the named leg).
PARTITION_DIRECTIONS = ("both", "to_server", "to_client")

_GARBAGE_BODY = b"\x00\xff\xfe{not json"


class FaultPlan:
    """A deterministic per-request fault schedule.

    ``sequence`` entries are fault names from :data:`FAULTS` or ``None``
    (pass through).  Once exhausted every further request passes through
    — so a finite burst of faults always lets the run complete.
    Thread-safe (connections are handled concurrently).
    """

    def __init__(self, sequence=()) -> None:
        seq = list(sequence)
        for f in seq:
            if f is not None and f not in FAULTS:
                raise ValueError(f"unknown fault {f!r} (known: {FAULTS})")
        self._seq = seq
        self._i = 0
        self._lock = threading.Lock()
        #: injected-fault counts, by fault name (observability for tests).
        self.injected: dict[str, int] = {f: 0 for f in FAULTS}
        #: requests forwarded to the upstream server.
        self.forwarded = 0

    @classmethod
    def seeded(
        cls,
        seed: int,
        n: int,
        *,
        fault_rate: float = 0.3,
        faults: tuple[str, ...] = ("drop_pre", "partial", "garbage"),
    ) -> "FaultPlan":
        """``n`` decisions drawn up front from ``random.Random(seed)`` —
        the schedule is fixed before any traffic flows, so a seeded
        chaos run replays exactly."""
        rng = random.Random(seed)
        seq = [
            rng.choice(faults) if rng.random() < fault_rate else None
            for _ in range(n)
        ]
        return cls(seq)

    def next_fault(self) -> str | None:
        with self._lock:
            if self._i >= len(self._seq):
                return None
            fault = self._seq[self._i]
            self._i += 1
            return fault

    def count(self, fault: str) -> None:
        with self._lock:
            self.injected[fault] += 1

    def count_forwarded(self) -> None:
        with self._lock:
            self.forwarded += 1


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    """``n`` bytes or ``None`` on EOF/reset at any point (the proxy
    treats a vanished peer as end-of-conversation, never an error)."""
    chunks = []
    while n:
        try:
            chunk = sock.recv(min(n, 1 << 20))
        except OSError:
            return None
        if not chunk:
            return None
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _read_frame(sock: socket.socket) -> bytes | None:
    """One length-prefixed frame (header + body), or None on EOF."""
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    (length,) = struct.unpack(">I", header)
    body = _recv_exact(sock, length)
    if body is None:
        return None
    return header + body


class FaultProxy:
    """An in-process TCP proxy injecting :class:`FaultPlan` faults.

    Usage::

        plan = FaultPlan(["drop_pre", None, "garbage", None])
        with FaultProxy(server.address, plan) as proxy:
            client = CapacityClient(*proxy.address, retry=RetryPolicy())
            ...

    Each accepted client connection gets its own upstream connection and
    handler thread; frames are forwarded one request/response pair at a
    time so the plan maps 1:1 onto client calls.
    """

    def __init__(
        self,
        upstream: tuple[str, int],
        plan: FaultPlan,
        *,
        host: str = "127.0.0.1",
        stall_s: float = 1.0,
        stream: bool = False,
    ) -> None:
        self._upstream = upstream
        self.plan = plan
        self._stall_s = float(stall_s)
        self._stream = bool(stream)
        # Runtime partition state (None = healed), toggled from the test
        # thread; _partition_dropped counts swallowed frames so a test
        # can assert the cut actually intercepted traffic.
        self._state_lock = threading.Lock()
        self._partition_dir: str | None = None
        self._partition_dropped = 0
        self._stop = threading.Event()
        self._listener = socket.create_server((host, 0))
        self._listener.settimeout(0.2)
        self._threads: list[threading.Thread] = []
        self._conns_lock = threading.Lock()
        self._conns: set[socket.socket] = set()
        self._accept_thread: threading.Thread | None = None

    @property
    def address(self) -> tuple[str, int]:
        return self._listener.getsockname()

    # -- runtime partition control (test-thread API) -----------------------
    def partition(self, direction: str = "both") -> None:
        """Cut the link mid-run (no proxy restart): frames crossing the
        named direction(s) are silently swallowed from now until
        :meth:`heal`.  Connections stay up — endpoints observe silence,
        not resets — and the scripted :class:`FaultPlan` is NOT consumed
        by swallowed frames, so a seeded fault schedule replays
        identically around the partition window."""
        if direction not in PARTITION_DIRECTIONS:
            raise ValueError(
                f"unknown partition direction {direction!r} "
                f"(known: {PARTITION_DIRECTIONS})"
            )
        with self._state_lock:
            self._partition_dir = direction

    def heal(self) -> None:
        """End the partition: traffic flows (and the plan resumes
        deciding) from the next frame on.  Idempotent."""
        with self._state_lock:
            self._partition_dir = None

    @property
    def partitioned(self) -> str | None:
        """The active partition direction, or ``None`` when healed."""
        with self._state_lock:
            return self._partition_dir

    @property
    def partition_dropped(self) -> int:
        """Frames swallowed by the partition so far (both directions)."""
        with self._state_lock:
            return self._partition_dropped

    def _cut(self, direction: str) -> bool:
        """True (and counted) when the active partition swallows a frame
        headed ``direction``."""
        with self._state_lock:
            p = self._partition_dir
            hit = p is not None and (p == "both" or p == direction)
            if hit:
                self._partition_dropped += 1
            return hit

    def start(self) -> "FaultProxy":
        self._accept_thread = threading.Thread(
            target=supervised(self._accept_loop, name="kccap-proxy-accept"),
            daemon=True,
        )
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
        for t in self._threads:
            t.join(timeout=5)

    def __enter__(self) -> "FaultProxy":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- internals ---------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed by stop()
            t = threading.Thread(
                target=supervised(self._handle, name="kccap-proxy-conn"),
                args=(conn,),
                daemon=True,
            )
            t.start()
            self._threads.append(t)

    def _track(self, sock: socket.socket) -> None:
        with self._conns_lock:
            self._conns.add(sock)

    def _untrack(self, sock: socket.socket) -> None:
        with self._conns_lock:
            self._conns.discard(sock)
        try:
            # shutdown BEFORE close: another proxy thread may be blocked
            # in recv on this socket, and CPython defers the real fd
            # close until that recv returns — without the shutdown no
            # FIN ever reaches the peer and a half-delivered fault
            # becomes an accidental stall instead of a cut link.
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass

    def _handle(self, client: socket.socket) -> None:
        if self._stream:
            self._handle_stream(client)
            return
        self._track(client)
        up: socket.socket | None = None
        try:
            while not self._stop.is_set():
                frame = _read_frame(client)
                if frame is None:
                    return
                # Partition check BEFORE the plan decision: swallowed
                # frames must not shift a seeded fault schedule.
                if self._cut("to_server"):
                    continue  # request never crosses; client times out
                fault = self.plan.next_fault()
                if fault == "drop_pre":
                    self.plan.count(fault)
                    return  # close WITHOUT forwarding
                if fault == "stall":
                    self.plan.count(fault)
                    # Interruptible sleep: stop() must not hang on us.
                    self._stop.wait(self._stall_s)
                    # Fall through: forward late (the client has usually
                    # timed out and gone; send errors are swallowed).
                if up is None:
                    try:
                        up = socket.create_connection(self._upstream)
                    except OSError:
                        return  # upstream dead (killed server): drop client
                    self._track(up)
                try:
                    up.sendall(frame)
                except OSError:
                    return
                self.plan.count_forwarded()
                reply = _read_frame(up)
                if reply is None:
                    return  # upstream died; drop the client too
                if self._cut("to_client"):
                    # Asymmetric cut: the server executed, the reply
                    # never arrives — the client cannot distinguish this
                    # from drop_post except that it is runtime-driven.
                    continue
                if fault == "drop_post":
                    self.plan.count(fault)
                    return  # executed upstream, reply withheld
                if fault == "partial":
                    self.plan.count(fault)
                    try:
                        client.sendall(reply[: max(5, len(reply) // 2)])
                    except OSError:
                        pass
                    return
                if fault == "garbage":
                    self.plan.count(fault)
                    try:
                        client.sendall(
                            struct.pack(">I", len(_GARBAGE_BODY))
                            + _GARBAGE_BODY
                        )
                    except OSError:
                        pass
                    return
                try:
                    client.sendall(reply)
                except OSError:
                    return
                if fault == "stall":
                    # Stalled but the client was still there: it got a
                    # late (correct) reply; nothing more to do.
                    continue
        finally:
            self._untrack(client)
            if up is not None:
                self._untrack(up)

    def _handle_stream(self, client: socket.socket) -> None:
        """Stream mode: forward the client's hello intact, then pump
        SERVER frames client-ward with one plan decision each.  Client→
        server frames after the hello (there are none in the plane
        protocol, but EOF matters) are pumped transparently on a side
        thread so a vanished subscriber is noticed upstream."""
        self._track(client)
        up: socket.socket | None = None
        try:
            while True:
                hello = _read_frame(client)
                if hello is None:
                    return
                # A partitioned hello never reaches the upstream: the
                # subscriber observes silence and retries after heal.
                if not self._cut("to_server"):
                    break
            up = socket.create_connection(self._upstream)
            self._track(up)
            up.sendall(hello)
            self.plan.count_forwarded()

            upstream = up  # for the closure below

            def _pump_client_to_up() -> None:
                while not self._stop.is_set():
                    frame = _read_frame(client)
                    if frame is None:
                        # Subscriber went away: propagate the EOF so the
                        # publisher deregisters it.
                        try:
                            upstream.shutdown(socket.SHUT_WR)
                        except OSError:
                            pass
                        return
                    if self._cut("to_server"):
                        continue  # one-way cut: the frame never crosses
                    try:
                        upstream.sendall(frame)
                    except OSError:
                        return

            side = threading.Thread(
                target=supervised(
                    _pump_client_to_up, name="kccap-proxy-pump"
                ),
                daemon=True,
            )
            side.start()
            while not self._stop.is_set():
                frame = _read_frame(up)
                if frame is None:
                    return  # upstream closed; drop the client too
                # Partition check BEFORE the plan decision (same rule as
                # request mode): a cut must not shift the seeded
                # schedule for the frames that flow after heal.
                if self._cut("to_client"):
                    continue  # stream gaps; the digest chain will say so
                fault = self.plan.next_fault()
                if fault == "drop_pre":
                    self.plan.count(fault)
                    continue  # swallow this frame: the stream gaps
                if fault == "stall":
                    self.plan.count(fault)
                    self._stop.wait(self._stall_s)
                if fault == "garbage":
                    self.plan.count(fault)
                    try:
                        client.sendall(
                            struct.pack(">I", len(_GARBAGE_BODY))
                            + _GARBAGE_BODY
                        )
                    except OSError:
                        return
                    continue
                if fault == "partial":
                    self.plan.count(fault)
                    try:
                        client.sendall(frame[: max(5, len(frame) // 2)])
                    except OSError:
                        pass
                    return  # a torn frame desyncs the stream: cut it
                try:
                    client.sendall(frame)
                except OSError:
                    return
                self.plan.count_forwarded()
                if fault == "drop_post":
                    self.plan.count(fault)
                    return  # delivered, then cut
        except OSError:
            return
        finally:
            self._untrack(client)
            if up is not None:
                self._untrack(up)

    # Convenience for assertions ------------------------------------------
    def wait_quiesced(self, timeout_s: float = 5.0) -> None:
        """Best-effort wait for in-flight handler threads to finish."""
        deadline = time.monotonic() + timeout_s
        for t in list(self._threads):
            t.join(timeout=max(0.0, deadline - time.monotonic()))
