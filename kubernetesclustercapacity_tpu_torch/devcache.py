"""Device-resident snapshot tensors, cached per snapshot.

Counterpart of ``kubernetesclustercapacity_tpu/devcache.py`` (the
``DeviceCache`` staged forms, ``:221-470``).  A sweep used to upload the
snapshot's node columns host→device on every request; snapshots are
immutable by contract, so their device tensors are staged once and reused
until the snapshot object dies.  The cache holds snapshots only by weak
reference: an entry is dropped when its snapshot is collected.

Staged forms, per (snapshot, device):

* ``exact`` — the seven int64/bool columns the exact program reads;
* ``kernel`` — the six int32 columns the fused kernel reads, memory
  rescaled to KiB (built only after eligibility has proven the values fit);
* ``grouped_exact`` / ``grouped_kernel`` — the same over node-shape groups,
  keyed on the parent snapshot.

Every staged tuple is booked in the device-memory ledger
(:mod:`.telemetry.memledger`) while the cache holds it.  A served snapshot
swap re-stages through :meth:`DeviceCache.stage_replace`: unchanged
columns carry over, changed ones are copied in place into the retired
snapshot's CUDA tensors when the shapes match and nothing else holds them
(the port's form of the JAX package's ``donate_argnums`` re-stage), and
everything else is staged fresh.  ``KCCAP_DONATE=0`` turns that off: the
retired snapshot's tensors are dropped and the new ones staged cold.  The
values are identical either way.

The JAX package's pow2 bucket ladder is not ported: it exists so XLA can
reuse a compiled executable across nearby shapes, and eager PyTorch has no
compile cache to protect.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import weakref

import numpy as np
import torch

from kubernetesclustercapacity_tpu_torch.telemetry import memledger as _memledger
from kubernetesclustercapacity_tpu_torch.telemetry import phases as _phases

__all__ = [
    "DeviceCache",
    "CACHE",
    "donate_enabled",
    "resolve_device",
    "to_device",
    "int64_putter",
    "stage_exact",
    "stage_kernel",
]

_EXACT_COLUMNS = (
    "alloc_cpu_milli",
    "alloc_mem_bytes",
    "alloc_pods",
    "used_cpu_req_milli",
    "used_mem_req_bytes",
    "pods_count",
    "healthy",
)

# The fused kernel's six node columns and whether each is memory (KiB).
_KERNEL_COLUMNS = (
    ("alloc_cpu_milli", False),
    ("alloc_mem_bytes", True),
    ("alloc_pods", False),
    ("used_cpu_req_milli", False),
    ("used_mem_req_bytes", True),
    ("pods_count", False),
)


def donate_enabled() -> bool:
    """In-place re-staging switch for snapshot swaps (``KCCAP_DONATE=0``
    disables), read on every swap."""
    return os.environ.get("KCCAP_DONATE", "1") != "0"


def resolve_device(device) -> torch.device:
    """The ``torch.device`` to run on; raises when CUDA is asked for and
    absent — a sweep never carries on quietly on the host."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the host"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (want cuda or cpu)")
    return dev


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array as a contiguous tensor on ``device`` (read-only arrays,
    such as a snapshot's memoized resource matrix, are copied first)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def int64_putter(device):
    """``(device, put)`` for a program staged per call: ``device``
    resolved (:func:`resolve_device`), and ``put(a, dtype=torch.int64)``
    giving numpy or a tensor as an int64 tensor on it (``torch.bool`` for
    masks)."""
    dev = resolve_device(device)

    def put(a, dtype=torch.int64):
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=dtype)
        a = np.asarray(a).astype(
            np.bool_ if dtype == torch.bool else np.int64, copy=False)
        return to_device(a, dev)

    return dev, put


def exact_columns(arrays) -> list[np.ndarray]:
    """The exact program's seven node columns on the host, in their staged
    dtypes (six int64, ``healthy`` last as bool)."""
    *ints, healthy = arrays
    return [np.asarray(a, dtype=np.int64) for a in ints] + [
        np.asarray(healthy, dtype=bool)
    ]


def kernel_columns(arrays) -> list[np.ndarray]:
    """The fused kernel's six int32 node columns on the host, memory
    rescaled to KiB.

    Callers prove the values in range first (``fast_sweep_eligible``):
    the rescale is exact only on KiB-quantized, int32-range inputs.
    """
    return [
        (np.asarray(a, dtype=np.int64) // (1024 if kib else 1)).astype(
            np.int32
        )
        for a, (_, kib) in zip(arrays, _KERNEL_COLUMNS)
    ]


def stage_exact(arrays, device: torch.device) -> tuple[torch.Tensor, ...]:
    """The exact program's seven node columns (``healthy`` last, bool)."""
    return tuple(to_device(a, device) for a in exact_columns(arrays))


def stage_kernel(arrays, device: torch.device) -> tuple[torch.Tensor, ...]:
    """The fused kernel's six int32 node columns, memory rescaled to KiB
    (see :func:`kernel_columns`)."""
    return tuple(to_device(a, device) for a in kernel_columns(arrays))


def _snapshot_columns(snapshot, form: str) -> list[np.ndarray]:
    """A snapshot's host columns in the staged layout of ``form``
    (``"exact"`` or ``"kernel"``)."""
    if form == "exact":
        return exact_columns([getattr(snapshot, f) for f in _EXACT_COLUMNS])
    return kernel_columns([getattr(snapshot, f) for f, _ in _KERNEL_COLUMNS])


def _kernel_form_exact(snapshot) -> bool:
    """True iff the snapshot's node columns rescale to the kernel form
    exactly (the node half of ``fast_sweep_eligible``)."""
    from kubernetesclustercapacity_tpu_torch.ops.fused_fit import (
        fast_sweep_eligible,
    )

    empty = np.zeros(0, dtype=np.int64)
    return fast_sweep_eligible(
        *(getattr(snapshot, f) for f, _ in _KERNEL_COLUMNS), empty, empty
    )


def _sole_holder(staged: tuple) -> bool:
    """True iff nothing but the caller's one name holds the staged tuple
    and its tensors: a dispatch that fetched it before the swap still
    holds a reference, and writing into tensors a running request reads
    would change its answer.  (Expected counts: 3 for the tuple — the
    caller's name, this parameter, ``getrefcount``'s argument — and 3
    for each tensor — the tuple, the generator's name, the argument.)"""
    return sys.getrefcount(staged) <= 3 and all(
        sys.getrefcount(t) <= 3 for t in staged
    )


class DeviceCache:
    """Thread-safe map (snapshot, form, device) → staged tensors.

    Snapshots are immutable by contract, so object identity is content
    identity.  Entries are keyed by ``id(snapshot)`` and removed by a
    ``weakref.finalize`` on the snapshot, so the cache never keeps a
    snapshot (or its device memory) alive; :meth:`invalidate` drops them
    at once when the service retires a snapshot.  A concurrent first
    request may build a form twice; both values are equal and the first
    stored wins.
    """

    def __init__(self) -> None:
        # Reentrant: a finalizer can run on this thread, from a garbage
        # collection triggered while the lock is held.
        self._lock = threading.RLock()
        self._entries: dict[int, dict[tuple, tuple]] = {}
        self._hits = 0
        self._misses = 0
        # Column dispositions of every stage_replace, for stats().
        self._replaced = {"reused": 0, "copied": 0, "restaged": 0}

    def _drop(self, key: int) -> None:
        with self._lock:
            per = self._entries.pop(key, None)
        for value in (per or {}).values():
            _memledger.retire(value)

    def _per_locked(self, snapshot) -> dict:
        """The snapshot's entry dict, created (with its finalizer) on
        first use; callers hold the lock (the ``*_locked`` convention)."""
        sid = id(snapshot)
        per = self._entries.get(sid)
        if per is None:
            per = self._entries[sid] = {}
            weakref.finalize(snapshot, self._drop, sid)
        return per

    def get(self, snapshot, key: tuple, build):
        with self._lock:
            hit = self._per_locked(snapshot).get(key)
            if hit is not None:
                self._hits += 1
                return hit
        clk = _phases.current()
        if clk:
            # A miss stages a host→device upload — the request-visible
            # cost the cache exists to remove — recorded as the answering
            # request's ``devcache`` phase (a hit records nothing).
            t0 = time.perf_counter()
            with clk.live("devcache"):
                value = build()
            clk.record("devcache", time.perf_counter() - t0)
        else:
            value = build()
        # Book before the value becomes poppable: a retire racing ahead
        # of a late register would leave a stale entry in the ledger.
        _memledger.register(value, key[0])
        with self._lock:
            self._misses += 1
            stored = self._per_locked(snapshot).setdefault(key, value)
        if stored is not value:
            _memledger.retire(value)
        return stored

    def exact_tensors(self, snapshot, device: torch.device) -> tuple:
        return self.get(
            snapshot, ("exact", device),
            lambda: stage_exact(
                [getattr(snapshot, f) for f in _EXACT_COLUMNS], device
            ),
        )

    def kernel_tensors(self, snapshot, device: torch.device) -> tuple:
        return self.get(
            snapshot, ("kernel", device),
            lambda: stage_kernel(
                [getattr(snapshot, f) for f, _ in _KERNEL_COLUMNS], device
            ),
        )

    def grouped_exact_tensors(self, grouped, device: torch.device) -> tuple:
        return self.get(
            grouped.snapshot, ("grouped_exact", device),
            lambda: stage_exact(
                [getattr(grouped, f) for f in _EXACT_COLUMNS], device
            ),
        )

    def grouped_kernel_tensors(self, grouped, device: torch.device) -> tuple:
        return self.get(
            grouped.snapshot, ("grouped_kernel", device),
            lambda: stage_kernel(
                [getattr(grouped, f) for f, _ in _KERNEL_COLUMNS], device
            ),
        )

    def invalidate(self, snapshot) -> None:
        """Drop a snapshot's entries — called on a snapshot swap so
        retired device tensors free at once instead of waiting for the
        snapshot to be collected."""
        with self._lock:
            per = self._entries.get(id(snapshot)) or {}
            dropped = list(per.values())
            per.clear()
        for value in dropped:
            _memledger.retire(value)

    def warm(self, snapshot, device: torch.device) -> None:
        """Stage a snapshot's exact form, and its kernel form where the
        columns rescale exactly, before the first request needs them."""
        self.exact_tensors(snapshot, device)
        if _kernel_form_exact(snapshot):
            self.kernel_tensors(snapshot, device)

    def stage_replace(self, old, new, device: torch.device) -> dict:
        """Re-stage on a snapshot swap, moving only what changed.

        ``old``'s entries are popped under the lock first, so no new
        dispatch can fetch them after this point.  Then, for each of the
        exact and kernel forms ``new`` takes, column by column against
        ``old``'s staged tuple of the same form and device:

        * equal on the host → ``old``'s tensor is carried into ``new``'s
          tuple (no transfer);
        * changed → copied in place into ``old``'s tensor when the node
          count matches, the device is a card, and nothing else holds
          the retired tuple (:func:`_sole_holder`) — a dispatch that
          fetched it before the pop must keep reading ``old``'s values.
          The copy is ordered on the stream after every kernel already
          enqueued on those tensors.  On the host a staged tensor shares
          the snapshot's numpy memory, so the host never copies in place;
        * otherwise → staged fresh, as :meth:`get` would.

        The values are identical to a cold stage in every case.  Callers
        gate on :func:`donate_enabled`.  Returns the per-column counts
        ``{"reused", "copied", "restaged"}``.
        """
        counts = {"reused": 0, "copied": 0, "restaged": 0}
        retired: dict = {}
        with self._lock:
            per = self._entries.get(id(old))
            if per is not None and old is not new:
                retired = dict(per)
                per.clear()
        # By key, so that no loop name is left holding a retired tuple
        # (_sole_holder counts references).
        for key in list(retired):
            _memledger.retire(retired[key])
        forms = ("exact", "kernel") if _kernel_form_exact(new) else ("exact",)
        for form in forms:
            prior = retired.pop((form, device), None)
            if prior is not None and old.n_nodes != new.n_nodes:
                prior = None
            in_place = (
                prior is not None and device.type == "cuda"
                and _sole_holder(prior)
            )
            old_cols = _snapshot_columns(old, form) if prior else None
            staged = []
            for i, col in enumerate(_snapshot_columns(new, form)):
                if prior is not None and np.array_equal(col, old_cols[i]):
                    staged.append(prior[i])
                    counts["reused"] += 1
                elif in_place:
                    prior[i].copy_(torch.from_numpy(np.ascontiguousarray(col)))
                    staged.append(prior[i])
                    counts["copied"] += 1
                else:
                    staged.append(to_device(col, device))
                    counts["restaged"] += 1
            staged = tuple(staged)
            _memledger.register(staged, form)
            with self._lock:
                per = self._per_locked(new)
                overwritten = per.get((form, device))
                per[(form, device)] = staged
            # A request between the server's swap and this re-stage may
            # have staged ``new`` already: its tuple leaves the cache
            # here, so it leaves the book too.
            if overwritten is not None and overwritten is not staged:
                _memledger.retire(overwritten)
        with self._lock:
            for disposition, n in counts.items():
                self._replaced[disposition] += n
        return counts

    def stats(self) -> dict:
        """JSON-able counters for the service's ``info`` op."""
        with self._lock:
            hits, misses = self._hits, self._misses
            entries = sum(len(per) for per in self._entries.values())
            replaced = dict(self._replaced)
        total = hits + misses
        return {
            "enabled": True,
            "entries": entries,
            "hits": hits,
            "misses": misses,
            "hit_rate": (hits / total) if total else 0.0,
            "stage_replace": replaced,
        }


#: The process-wide cache the dispatchers use.
CACHE = DeviceCache()
