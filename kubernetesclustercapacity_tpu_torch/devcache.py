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

The JAX package's pow2 bucket ladder is not ported: it exists so XLA can
reuse a compiled executable across nearby shapes, and eager PyTorch has no
compile cache to protect.  Donated re-staging and the device-memory ledger
are not ported yet.
"""

from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

__all__ = [
    "DeviceCache",
    "CACHE",
    "resolve_device",
    "to_device",
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


def stage_exact(arrays, device: torch.device) -> tuple[torch.Tensor, ...]:
    """The exact program's seven node columns (``healthy`` last, bool)."""
    *ints, healthy = arrays
    return tuple(
        to_device(np.asarray(a, dtype=np.int64), device) for a in ints
    ) + (to_device(np.asarray(healthy, dtype=bool), device),)


def stage_kernel(arrays, device: torch.device) -> tuple[torch.Tensor, ...]:
    """The fused kernel's six int32 node columns, memory rescaled to KiB.

    Callers prove the values in range first (``fast_sweep_eligible``):
    the rescale is exact only on KiB-quantized, int32-range inputs.
    """
    return tuple(
        to_device(
            (np.asarray(a, dtype=np.int64) // (1024 if kib else 1)).astype(
                np.int32
            ),
            device,
        )
        for a, (_, kib) in zip(arrays, _KERNEL_COLUMNS)
    )


class DeviceCache:
    """Thread-safe map (snapshot, form, device) → staged tensors.

    Snapshots are immutable by contract, so object identity is content
    identity.  Entries are keyed by ``id(snapshot)`` and removed by a
    ``weakref.finalize`` on the snapshot, so the cache never keeps a
    snapshot (or its device memory) alive.  A concurrent first request may
    build a form twice; both values are equal and the first stored wins.
    """

    def __init__(self) -> None:
        # Reentrant: a finalizer can run on this thread, from a garbage
        # collection triggered while the lock is held.
        self._lock = threading.RLock()
        self._entries: dict[int, dict[tuple, tuple]] = {}

    def _drop(self, key: int) -> None:
        with self._lock:
            self._entries.pop(key, None)

    def get(self, snapshot, key: tuple, build):
        sid = id(snapshot)
        with self._lock:
            per = self._entries.get(sid)
            if per is None:
                per = self._entries[sid] = {}
                weakref.finalize(snapshot, self._drop, sid)
            hit = per.get(key)
        if hit is not None:
            return hit
        value = build()
        with self._lock:
            return per.setdefault(key, value)

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


#: The process-wide cache the dispatchers use.
CACHE = DeviceCache()
