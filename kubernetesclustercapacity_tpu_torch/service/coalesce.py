"""Coalesce watch-event bursts into bounded snapshot pushes.

Counterpart of ``kubernetesclustercapacity_tpu/service/coalesce.py``.
On the card, the flush's pre-warm is :meth:`..devcache.DeviceCache.
stage_replace` plus :meth:`~..devcache.DeviceCache.warm`, run on the
coalescer's worker thread.

The live-serve wiring (``server.main -follow``) turns every applied watch
event into a full snapshot repack+swap — O(N) array materialization under
the store lock.  At 10k nodes with routine churn (kubelet status updates
arrive per node, per sync period) that made the repack the hot path: the
reference's analog failure is its per-run ``1 + 2N + ΣP`` apiserver walk
(SURVEY.md §3.4) — work proportional to cluster size on every freshness
tick.

:class:`SnapshotCoalescer` decouples event application (cheap per-row
store upserts, already O(1)) from snapshot publication (O(N) repack):

* **leading edge** — the first event after an idle period flushes
  immediately (an isolated change is visible at once);
* **suppression window** — further events within ``min_interval_s``
  accumulate; at window end one trailing flush publishes the final state;
* **backlog bound** — if pending events reach ``max_pending`` before the
  window ends, flush early (a huge relist-scale burst is not held back
  for the full window);
* **no lost finale** — :meth:`stop` drains: the last pending state is
  always flushed before the worker exits.

Because ``flush`` runs on the coalescer's own worker thread, the serve
wiring also uses it to PRE-WARM the device cache for the just-published
snapshot (``server.main`` passes ``warm=True`` to ``replace_snapshot``
inside the flush callback): the O(N) host→device upload for the next
generation is paid here, off the request path, so a relist never stalls
a reader on a cold cache.

So a churn storm of E events costs ``min(E, 2 + duration/min_interval_s
+ E/max_pending)`` repacks instead of E, while staleness stays bounded by
``min_interval_s``.
"""

from __future__ import annotations

import threading
import time

from kubernetesclustercapacity_tpu_torch.utils.threads import supervised

__all__ = ["SnapshotCoalescer"]


class SnapshotCoalescer:
    """Run ``flush()`` at a bounded rate in response to ``notify()`` bursts.

    ``flush`` runs on the coalescer's own worker thread (never on the
    notifier's — watch threads must not pay repack latency).  A raising
    ``flush`` is recorded in :attr:`last_error` and reported to
    ``on_error`` (if given); the worker itself keeps running — the
    EMBEDDER decides whether a failed publish is fatal.  A supervised
    server must treat it as such (see ``server.main``): before
    coalescing, a publish failure killed the watch thread and the serve
    loop with it; silently serving a frozen snapshot is the one
    unacceptable outcome.
    """

    def __init__(
        self,
        flush,
        *,
        min_interval_s: float = 0.1,
        max_pending: int = 256,
        on_error=None,
    ) -> None:
        if min_interval_s < 0:
            raise ValueError("min_interval_s must be >= 0")
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self._flush = flush
        self._on_error = on_error
        self._min_interval = float(min_interval_s)
        self._max_pending = int(max_pending)
        self._cv = threading.Condition()
        self._pending = 0
        self._stopping = False
        self.events = 0  # total notify() calls
        self.flushes = 0  # total flush() completions
        self.last_error: str | None = None
        # Publish freshness evidence (read by /healthz via stats()):
        # when the last flush finished and how long it took — the
        # coalescer-side witness that publishes (and whatever rides
        # them: cache warming, timeline observation) are still flowing.
        self.last_flush_ts: float | None = None
        self.last_flush_s: float | None = None
        self._thread = threading.Thread(
            target=supervised(self._run, name="kccap-coalescer"),
            daemon=True,
        )
        self._thread.start()

    def stats(self) -> dict:
        """JSON-able counters + freshness (no lock: single-writer fields
        read for display only)."""
        return {
            # kccap: lint-ok[lock-discipline] single-writer counter, torn display read is acceptable
            "events": self.events,
            "flushes": self.flushes,
            # kccap: lint-ok[lock-discipline] single-writer gauge, display-only read
            "pending": self._pending,
            "last_error": self.last_error,
            "last_flush_s": self.last_flush_s,
            "last_flush_age_s": (
                None
                if self.last_flush_ts is None
                else round(time.monotonic() - self.last_flush_ts, 3)
            ),
        }

    def notify(self, *_args, **_kw) -> None:
        """Signal one applied event.  Signature-compatible with the
        follower's ``on_event(kind, etype, obj)`` so it can be installed
        directly as the observer."""
        with self._cv:
            if self._stopping:
                return
            self._pending += 1
            self.events += 1
            self._cv.notify()

    def stop(self, timeout: float | None = 10.0) -> bool:
        """Drain (flush any pending state) and stop the worker.

        Returns True when the worker exited (drain complete).  A False
        return means the drain timed out — a wedged flush callback — and
        the final pending state may never publish; that broken contract
        is recorded in :attr:`last_error` and reported to ``on_error``
        exactly like a raising flush, so a supervised server treats it
        as the publish failure it is.
        """
        with self._cv:
            self._stopping = True
            self._cv.notify()
        self._thread.join(timeout)
        if self._thread.is_alive():
            err = (
                f"coalescer drain timed out after {timeout}s "
                "(flush callback wedged); final state may be unpublished"
            )
            self.last_error = err
            if self._on_error is not None:
                try:
                    self._on_error(err)
                except Exception:  # noqa: BLE001 - observer must not kill us
                    pass
            return False
        return True

    # -- worker ------------------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._stopping and self._pending == 0:
                    self._cv.wait()
                if self._pending == 0:  # stopping with nothing to drain
                    return
                self._pending = 0
            self._do_flush()
            # Suppression window: absorb the burst.  Wake early only for
            # stop (drain) or a backlog at max_pending.
            deadline = time.monotonic() + self._min_interval
            with self._cv:
                while (
                    not self._stopping
                    and self._pending < self._max_pending
                ):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)

    def _do_flush(self) -> None:
        t0 = time.monotonic()
        try:
            self._flush()
        except Exception as e:  # noqa: BLE001 - embedder decides fatality
            self.last_error = f"{type(e).__name__}: {e}"
            if self._on_error is not None:
                try:
                    self._on_error(self.last_error)
                except Exception:  # noqa: BLE001 - observer must not kill us
                    pass
        else:
            self.flushes += 1
            self.last_flush_ts = time.monotonic()
            self.last_flush_s = round(self.last_flush_ts - t0, 6)
