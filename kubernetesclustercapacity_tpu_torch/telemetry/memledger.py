"""Device-memory ledger: device-memory accounting that cannot leak silently.

Counterpart of the JAX package's ``telemetry/memledger.py``.  The device
cache and the service's folded fetches hold CUDA tensors whose total size
would otherwise be unknown and unaudited: staged snapshot tuples (the
exact, kernel and grouped forms), re-staged columns after a snapshot swap,
and the pending device→host copies of async folded sweeps.  This module
is the single book those sites write:

* **register/retire by identity** — every staging site registers the
  container it stores (a tuple of tensors) with its form label;
  retirement happens at the exact point the container leaves the cache
  (``invalidate``, ``stage_replace``'s pop, fold materialization).  The
  ledger holds NO strong references — being observed must not extend a
  tensor's life — so entries are keyed on container id with per-leaf
  ``(id, nbytes, weakref, device type)`` records captured at
  registration.
* **gauges** — ``kccap_device_bytes{form}`` (live bytes per form) and
  ``kccap_device_peak_bytes`` (high-watermark), both callback gauges so
  a scrape always reads the current book.
* **reconciliation** — :meth:`DeviceLedger.reconcile` checks every
  tracked leaf is still alive (its weak reference resolves, or, when the
  caller passes ``live_arrays``, it is identity-present among them) and
  that the booked live CUDA bytes do not exceed what the caching
  allocator holds (``torch.cuda.memory_allocated()``).  A booked tensor
  that died without being retired, or a book claiming more device bytes
  than are allocated, is how a leak in the book hides.  A discrepancy
  must be SUSTAINED (seen on two consecutive reconciles) before it trips
  the leak :class:`~..timeline.alerts.WatchAlert`.
* **budget** — :meth:`set_budget` arms a byte budget; live bytes above
  it flip ``budget_breached`` (a signal, not an admission gate).

Hot-path rule: when telemetry is off (``KCCAP_TELEMETRY=0``) or the
dedicated hatch is thrown (``KCCAP_MEMLEDGER=0``), :func:`enabled` is
False, every hook site skips the ledger entirely, and this module makes
zero registry calls.
"""

from __future__ import annotations

import os
import threading
import weakref

from kubernetesclustercapacity_tpu_torch.timeline.alerts import WatchAlert

__all__ = [
    "DeviceLedger",
    "LEDGER",
    "enabled",
    "register",
    "retire",
    "device_memory_status",
]


def enabled() -> bool:
    """Ledger armed?  ``KCCAP_MEMLEDGER=0`` is the dedicated hatch;
    ``KCCAP_TELEMETRY=0`` disables it too (the book rides the telemetry
    substrate and must cost nothing when that is off)."""
    if os.environ.get("KCCAP_MEMLEDGER", "1") == "0":
        return False
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
        enabled as _telemetry_enabled,
    )

    return _telemetry_enabled()


def _leaves(value) -> list:
    """Flatten a staged container into its tensor leaves (tuples/lists
    nest; anything with ``nbytes`` is a leaf; the rest is ignored —
    staging sites store tuples of tensors by construction)."""
    out: list = []
    stack = [value]
    while stack:
        v = stack.pop()
        if isinstance(v, (tuple, list)):
            stack.extend(v)
        elif hasattr(v, "nbytes"):
            out.append(v)
    return out


def _leaf_record(a) -> tuple:
    """``(id, nbytes, weakref or None, device type)`` of one leaf."""
    try:
        ref = weakref.ref(a)
    except TypeError:  # numpy arrays and scalars take no weak reference
        ref = None
    device = getattr(a, "device", None)
    return (id(a), int(a.nbytes), ref, getattr(device, "type", "cpu"))


class DeviceLedger:
    """The process-wide device-byte book (thread-safe; all mutable state
    under ``self._lock``).

    Entries are keyed on the *container's* id: the same object a cache
    stores is the same object it later evicts, so identity is exact.
    Per-leaf records are captured at registration for the reconciler; no
    strong references are taken (see module docstring).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # container id -> (form, total_nbytes,
        #                  ((leaf_id, nbytes, weakref, device_type), ...))
        self._entries: dict[int, tuple] = {}
        self._by_form: dict[str, int] = {}
        self._total = 0
        self._peak = 0
        self._registered = 0
        self._retired = 0
        self._budget: int | None = None
        self._suspects: set[int] = set()
        self._excess_suspect = False
        self._leaked_bytes = 0
        self._reconciles = 0
        self._alert = WatchAlert(name="device_memory", min_replicas=0)
        self._gauge_forms: set[str] = set()

    # -- write side (the staging sites) ------------------------------

    def register(self, value, form: str) -> int:
        """Book ``value`` (a staged container) under ``form``; returns
        the byte count booked.  Re-registering the same container id
        replaces the previous entry (double-build races in the devcache
        store last-wins — so does the book)."""
        form = str(form)
        leaves = _leaves(value)
        pairs = tuple(_leaf_record(a) for a in leaves)
        nbytes = sum(rec[1] for rec in pairs)
        key = id(value)
        with self._lock:
            prev = self._entries.get(key)
            if prev is not None:
                self._by_form[prev[0]] -= prev[1]
                self._total -= prev[1]
                self._retired += 1
            self._entries[key] = (form, nbytes, pairs)
            self._by_form[form] = self._by_form.get(form, 0) + nbytes
            self._total += nbytes
            self._registered += 1
            if self._total > self._peak:
                self._peak = self._total
        self._ensure_gauges(form)
        return nbytes

    def retire(self, value) -> int:
        """Unbook a container at the moment it leaves its cache;
        returns the bytes released (0 for a container never booked —
        retiring twice is harmless, staying booked forever is the bug
        the reconciler exists to catch)."""
        key = id(value)
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                return 0
            form, nbytes, _ = entry
            self._by_form[form] -= nbytes
            self._total -= nbytes
            self._retired += 1
            return nbytes

    def set_budget(self, nbytes: int | None) -> None:
        with self._lock:
            self._budget = int(nbytes) if nbytes else None

    def reset(self) -> None:
        """Forget everything (tests)."""
        with self._lock:
            self._entries.clear()
            self._by_form.clear()
            self._total = 0
            self._peak = 0
            self._registered = 0
            self._retired = 0
            self._suspects = set()
            self._excess_suspect = False
            self._leaked_bytes = 0
            self._reconciles = 0
            self._alert = WatchAlert(name="device_memory", min_replicas=0)

    # -- read side ---------------------------------------------------

    def total_bytes(self) -> int:
        with self._lock:
            return self._total

    def form_bytes(self, form: str) -> int:
        with self._lock:
            return self._by_form.get(form, 0)

    def peak_bytes(self) -> int:
        with self._lock:
            return self._peak

    def budget_breached(self) -> bool:
        with self._lock:
            return self._budget is not None and self._total > self._budget

    def leaking(self) -> bool:
        """True while the last reconcile found a SUSTAINED discrepancy
        (the alert is in its breached state)."""
        with self._lock:
            return self._alert.state == "breached"

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": enabled(),
                "total_bytes": self._total,
                "peak_bytes": self._peak,
                "by_form": dict(self._by_form),
                "entries": len(self._entries),
                "registered": self._registered,
                "retired": self._retired,
                "budget_bytes": self._budget,
                "budget_breached": (
                    self._budget is not None and self._total > self._budget
                ),
                "reconciles": self._reconciles,
                "leaked_bytes": self._leaked_bytes,
                "leak_alert": self._alert.to_wire(),
            }

    # -- reconciliation ----------------------------------------------

    def reconcile(self, live_arrays=None, allocated_bytes=None) -> dict:
        """Audit the book against what is really alive.

        A tracked leaf is alive when its weak reference still resolves
        (or, when ``live_arrays`` is given, when it is identity-present
        among them — tests inject their own).  The booked live CUDA bytes
        are also held against ``allocated_bytes``, by default
        ``torch.cuda.memory_allocated()`` summed over the visible cards
        (0 where there is none): the book may never claim more device
        memory than the allocator holds.  A leaf missing, or an excess,
        on TWO consecutive reconciles is counted as leaked bytes and
        trips the leak alert (one miss is a suspect only — a concurrent
        eviction between the book's snapshot and the walk must not page
        anyone).  Returns the audit dict.
        """
        live_ids = (
            None if live_arrays is None else {id(a) for a in live_arrays}
        )

        def alive(rec) -> bool:
            leaf_id, _, ref, _ = rec
            if live_ids is not None:
                return leaf_id in live_ids
            return ref is None or ref() is not None

        # The walk runs outside the lock (a weak reference resolved here
        # may drop the last strong one, and its finalizer retires under
        # the lock); the suspects are read and replaced in ONE locked
        # block, so concurrent reconciles never judge against a set the
        # other has just replaced.
        with self._lock:
            entries = list(self._entries.values())
        missing: list[tuple[int, int]] = []
        cuda_bytes = 0
        for _form, _nbytes, pairs in entries:
            for rec in pairs:
                if alive(rec):
                    if rec[3] == "cuda":
                        cuda_bytes += rec[1]
                    continue
                missing.append((rec[0], rec[1]))
        missing_bytes = sum(nbytes for _, nbytes in missing)
        if allocated_bytes is None:
            allocated_bytes = _cuda_allocated_bytes()
        excess = max(0, cuda_bytes - int(allocated_bytes))
        with self._lock:
            sustained_bytes = sum(
                nbytes for leaf_id, nbytes in missing
                if leaf_id in self._suspects
            )
            if excess and self._excess_suspect:
                sustained_bytes += excess
            self._excess_suspect = excess > 0
            self._reconciles += 1
            self._suspects = {leaf_id for leaf_id, _ in missing}
            self._leaked_bytes = sustained_bytes
            # WatchAlert breaches on total < min_replicas: feed the
            # negated discrepancy so "any sustained leaked byte" is the
            # breach and zero is healthy.
            transition = self._alert.update(
                -sustained_bytes, self._reconciles
            )
            return {
                "tracked_entries": len(self._entries),
                "tracked_bytes": self._total,
                "tracked_cuda_bytes": cuda_bytes,
                "allocated_bytes": int(allocated_bytes),
                "missing_bytes": missing_bytes + excess,
                "sustained_missing_bytes": sustained_bytes,
                "leaking": self._alert.state == "breached",
                "transition": transition,
            }

    # -- gauges ------------------------------------------------------

    def _ensure_gauges(self, form: str) -> None:
        """Idempotently attach the callback gauges (per-form on first
        sight of the form; peak once).  Outside the lock — registry
        callbacks must never nest under ledger state."""
        if not enabled():
            return
        with self._lock:
            if form in self._gauge_forms:
                return
            first = not self._gauge_forms
            self._gauge_forms.add(form)
        from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
            REGISTRY,
        )

        g = REGISTRY.gauge(
            "kccap_device_bytes",
            "Live device bytes booked by the memory ledger, by staged "
            "form.",
            ("form",),
        )
        g.labels(form=form).set_function(
            lambda f=form: float(self.form_bytes(f))
        )
        if first:
            REGISTRY.gauge(
                "kccap_device_peak_bytes",
                "High-watermark of ledger-booked device bytes since "
                "process start.",
            ).labels().set_function(lambda: float(self.peak_bytes()))


def _cuda_allocated_bytes() -> int:
    """Bytes the CUDA caching allocator holds for tensors, over every
    visible card (0 without one)."""
    import torch

    if not torch.cuda.is_available():
        return 0
    return sum(
        torch.cuda.memory_allocated(i)
        for i in range(torch.cuda.device_count())
    )


#: The process-wide book every staging site writes.
LEDGER = DeviceLedger()


def register(value, form: str) -> None:
    """Module-level hook the staging sites call (no-op when the ledger
    is off — the zero-registry-call rule)."""
    if enabled():
        LEDGER.register(value, form)


def retire(value) -> None:
    """Unconditional, unlike :func:`register` — a buffer booked while
    the ledger was armed must come OFF the book even if the hatch has
    since been thrown (a hatch flip mid-process would otherwise turn
    every retirement into a stale leaf, i.e. a false sustained leak).
    Pure bookkeeping: touches no registry, so the zero-registry-call
    pin for the off state still holds."""
    LEDGER.retire(value)


def device_memory_status() -> str:
    """The doctor's "device memory" line: FAILED on a sustained leak or
    a breached budget, soft otherwise."""
    if not enabled():
        return (
            "off (KCCAP_MEMLEDGER=0 or KCCAP_TELEMETRY=0) — device "
            "bytes unaudited"
        )
    st = LEDGER.stats()
    mib = st["total_bytes"] / (1 << 20)
    peak = st["peak_bytes"] / (1 << 20)
    forms = " ".join(
        f"{f}={b / (1 << 20):.1f}MiB"
        for f, b in sorted(st["by_form"].items())
        if b
    )
    if st["leak_alert"]["state"] == "breached":
        return (
            f"FAILED: device-memory leak — {st['leaked_bytes']} "
            "booked byte(s) dead or beyond the CUDA allocator on "
            "consecutive reconciles; "
            f"live={mib:.1f}MiB peak={peak:.1f}MiB"
        )
    if st["budget_breached"]:
        return (
            f"FAILED: device budget breached — live {mib:.1f}MiB over "
            f"budget {st['budget_bytes'] / (1 << 20):.1f}MiB"
        )
    return (
        f"ok: live={mib:.1f}MiB peak={peak:.1f}MiB "
        f"entries={st['entries']} "
        f"registered={st['registered']} retired={st['retired']}"
        + (f" [{forms}]" if forms else "")
    )
