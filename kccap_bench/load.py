"""The open-loop load: streams of requests with fixed due times, sent
through a pool of the program's own clients.

A traffic kind (``gen/<kind>.py``) turns a traffic file and a seed into
a :class:`Plan`.  Each :class:`Stream` has its due times, measured from
the start of the window, and every request already built, in set-up:
the window only hands them to the program's client.  A ``pool`` stream's requests go to whichever of the
pool's connections is free (open loop: a request waits for a
connection, and its latency counts from when it was due).  A ``writer``
stream has one connection of its own and sends in order; its ``then``
request follows each of its requests on that connection at once.

Every request records when it was due, when it was sent, when its reply
was decoded, the generation that answered and, for the requests the
plan keeps for the check, the reply itself.  A request that raises, is
refused, or has no reply by the deadline counts as failed.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
import numpy as np

__all__ = ["Stream", "Plan", "Records", "drive", "send_all"]


@dataclasses.dataclass
class Stream:
    name: str
    lane: str  # "pool" or "writer"
    due: np.ndarray  # seconds from the window's start, ascending
    requests: list  # (op, params) of each due time
    then: list | None = None  # (op, params) sent after each request
    keep: frozenset = frozenset()  # requests whose replies are kept
    then_keep: frozenset = frozenset()  # the same, of the ``then`` replies


@dataclasses.dataclass
class Plan:
    streams: list
    # Set-up: groups of requests; the requests of a group are sent at
    # once, each on its own connection, and the next group waits for them.
    warm: list
    query_op: str
    # Anything the kind's check needs beyond the records (the stream of
    # events, the specs of the kept requests).
    extra: dict = dataclasses.field(default_factory=dict)


class Records:
    """Per request of one stream: ``due``, ``sent``, ``done`` (host clock,
    seconds from the window's start; NaN until set), ``ok``,
    ``generation``; the same with a ``then_`` prefix for the follow-up;
    ``replies`` and ``then_replies`` for kept requests."""

    def __init__(self, stream: Stream) -> None:
        n = len(stream.due)
        self.stream = stream
        self.due = np.asarray(stream.due, dtype=np.float64)
        for prefix in ("", "then_"):
            setattr(self, prefix + "sent", np.full(n, np.nan))
            setattr(self, prefix + "done", np.full(n, np.nan))
            setattr(self, prefix + "ok", np.zeros(n, dtype=bool))
            setattr(self, prefix + "generation", np.full(n, -1,
                                                         dtype=np.int64))
            setattr(self, prefix + "replies", {})
        self.errors: dict[int, str] = {}
        self.released = np.full(n, np.nan)

    @property
    def has_then(self) -> bool:
        return self.stream.then is not None


def _compact(reply):
    """A kept reply with its lists as arrays (a few KB, not a few hundred
    Python objects, each)."""
    if not isinstance(reply, dict):
        return reply
    return {k: np.asarray(v) if isinstance(v, list) else v
            for k, v in reply.items()}


def _call(client, op: str, params: dict):
    return client.call(op, **params)


def send_all(clients, requests) -> list:
    """Send ``requests`` at once, request ``i`` on ``clients[i]``; returns
    the replies (set-up's warm groups)."""
    out = [None] * len(requests)
    errors = []

    def one(i):
        try:
            out[i] = _call(clients[i], *requests[i])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"{requests[i][0]}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("warm request failed: " + "; ".join(errors))
    return out


def drive(plan: Plan, pool, writer, t0: float,
          deadline: float) -> list[Records]:
    """Send every request of ``plan`` at its due time after ``t0``
    (``time.perf_counter()``); wait for replies until ``deadline``.
    ``pool`` is a list of clients, ``writer`` one client or None.
    Returns one :class:`Records` per stream."""
    records = [Records(s) for s in plan.streams]
    pool_q: queue.Queue = queue.Queue()
    writer_q: queue.Queue = queue.Queue()
    lock = threading.Lock()

    def run(client, rec: Records, i: int) -> None:
        s = rec.stream
        for prefix, built, keep in (("", s.requests, s.keep),
                                    ("then_", s.then, s.then_keep)):
            if built is None:
                return
            op, params = built[i]
            getattr(rec, prefix + "sent")[i] = time.perf_counter() - t0
            try:
                reply = _call(client, op, params)
            except Exception as e:  # noqa: BLE001 - a failed request
                with lock:
                    rec.errors[i] = f"{op}: {type(e).__name__}: {e}"
                getattr(rec, prefix + "done")[i] = time.perf_counter() - t0
                return
            getattr(rec, prefix + "done")[i] = time.perf_counter() - t0
            getattr(rec, prefix + "ok")[i] = True
            gen = client.last_generation
            getattr(rec, prefix + "generation")[i] = -1 if gen is None else gen
            if i in keep:
                getattr(rec, prefix + "replies")[i] = _compact(reply)

    def worker(client, q: queue.Queue) -> None:
        while True:
            item = q.get()
            if item is None:
                return
            run(client, *item)

    threads = [threading.Thread(target=worker, args=(c, pool_q), daemon=True)
               for c in pool]
    if writer is not None:
        threads.append(threading.Thread(target=worker,
                                        args=(writer, writer_q), daemon=True))
    for t in threads:
        t.start()

    order = sorted(
        (float(d), k, i)
        for k, rec in enumerate(records) for i, d in enumerate(rec.due))
    for due, k, i in order:
        delay = t0 + due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        rec = records[k]
        rec.released[i] = time.perf_counter() - t0
        (writer_q if rec.stream.lane == "writer" else pool_q).put((rec, i))
    for _ in pool:
        pool_q.put(None)
    writer_q.put(None)
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.perf_counter()))
    return records
