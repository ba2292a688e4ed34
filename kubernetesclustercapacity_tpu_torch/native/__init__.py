"""Native CPU backend: ctypes bindings over the C++ capacity library.

Counterpart of ``kubernetesclustercapacity_tpu/native/__init__.py``.
``capacity.cc`` (a copy of the JAX package's source) builds on first use
with the system ``g++`` (plain C ABI, no pybind11) into the package's
git-ignored ``_build/``, keyed by source mtime.  It is the compiled
sequential reference, the role the reference's Go binary plays: the
CLI's ``-backend native`` runs it, and a device sweep can be held against
a real compiled CPU loop rather than interpreted Python.

Every entry point raises :class:`NativeUnavailable` when no C++
toolchain exists or the build fails; callers then use the pure-Python
oracle.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from kubernetesclustercapacity_tpu_torch.native import _build_util

__all__ = [
    "NativeUnavailable",
    "NativePanic",
    "available",
    "cpu_to_milli",
    "to_bytes",
    "fit_arrays",
    "sweep",
]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "capacity.cc")
_SO_NAME = "libkcccapacity.so"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_BUILD_ERROR: str | None = None

_I64P = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")


class NativeUnavailable(RuntimeError):
    """No toolchain / build failed — use the pure-Python oracle instead."""


class NativePanic(RuntimeError):
    """The native kernel hit the reference's divide-by-zero panic point."""


def _build_and_open() -> ctypes.CDLL:
    so = _build_util.build_so(_SRC, _SO_NAME, link_args=("-lpthread",))
    try:
        return ctypes.CDLL(so)  # OSError on a bad/unloadable .so
    except OSError:
        # A cached object that no longer loads (corrupt file, foreign
        # arch): rebuild once from scratch, like the ingest loader.
        try:
            os.unlink(so)
        except OSError:
            pass
        return ctypes.CDLL(
            _build_util.build_so(_SRC, _SO_NAME, link_args=("-lpthread",))
        )


def _load() -> ctypes.CDLL:
    global _LIB, _BUILD_ERROR
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _BUILD_ERROR is not None:
            raise NativeUnavailable(_BUILD_ERROR)
        try:
            lib = _build_and_open()
        except (RuntimeError, OSError) as e:
            _BUILD_ERROR = f"native build failed: {e}"
            raise NativeUnavailable(_BUILD_ERROR) from e
        lib.kcc_cpu_to_milli_n.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.kcc_cpu_to_milli_n.restype = ctypes.c_uint64
        lib.kcc_to_bytes_n.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
        ]
        lib.kcc_to_bytes_n.restype = ctypes.c_int
        lib.kcc_fit_arrays.argtypes = [
            ctypes.c_int64, _I64P, _I64P, _I64P, _I64P, _I64P, _I64P, _U8P,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, _I64P,
        ]
        lib.kcc_fit_arrays.restype = ctypes.c_int
        lib.kcc_sweep.argtypes = [
            ctypes.c_int64, ctypes.c_int64, _I64P, _I64P, _I64P, _I64P,
            _I64P, _I64P, _U8P, _I64P, _I64P, ctypes.c_int, ctypes.c_int,
            _I64P,
        ]
        lib.kcc_sweep.restype = ctypes.c_int
        _LIB = lib
        return lib


def available() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def cpu_to_milli(s: str) -> int:
    """Native ``convertCPUToMilis`` — returns the uint64 value.

    The length passes explicitly, so an embedded NUL rejects exactly like
    the Python codec instead of truncating the string.
    """
    b = s.encode()
    return int(_load().kcc_cpu_to_milli_n(b, len(b)))


def to_bytes(s: str) -> int:
    """Native ``bytefmt.ToBytes``; raises ValueError on the reference error."""
    out = ctypes.c_int64()
    b = s.encode()
    if _load().kcc_to_bytes_n(b, len(b), ctypes.byref(out)) != 0:
        raise ValueError(
            "byte quantity must be a positive integer with a unit of "
            "measurement like M, MB, MiB, G, GiB, or GB"
        )
    return out.value


_MODES = {"reference": 0, "strict": 1}
_PANIC = "integer divide by zero (ClusterCapacity.go:123/129)"


def _prep(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.int64))


def _healthy(healthy, n: int) -> np.ndarray:
    if healthy is None:
        return np.ones(n, dtype=np.uint8)
    return np.ascontiguousarray(np.asarray(healthy, dtype=np.uint8))


def fit_arrays(
    alloc_cpu,
    alloc_mem,
    alloc_pods,
    used_cpu,
    used_mem,
    pods_count,
    cpu_req: int,
    mem_req: int,
    *,
    mode: str = "reference",
    healthy=None,
) -> np.ndarray:
    """Native per-node fits — same signature family as the Python oracle."""
    lib = _load()
    alloc_cpu = _prep(alloc_cpu)
    n = alloc_cpu.shape[0]
    fits = np.empty(n, dtype=np.int64)
    rc = lib.kcc_fit_arrays(
        n, alloc_cpu, _prep(alloc_mem), _prep(alloc_pods), _prep(used_cpu),
        _prep(used_mem), _prep(pods_count), _healthy(healthy, n),
        int(cpu_req), int(mem_req), _MODES[mode], fits,
    )
    if rc != 0:
        raise NativePanic(_PANIC)
    return fits


def sweep(
    alloc_cpu,
    alloc_mem,
    alloc_pods,
    used_cpu,
    used_mem,
    pods_count,
    cpu_reqs,
    mem_reqs,
    *,
    mode: str = "reference",
    healthy=None,
    n_threads: int = 0,
) -> np.ndarray:
    """Native multi-threaded scenario sweep — ``totals[S]``."""
    lib = _load()
    alloc_cpu = _prep(alloc_cpu)
    cpu_reqs = _prep(cpu_reqs)
    n, s = alloc_cpu.shape[0], cpu_reqs.shape[0]
    totals = np.empty(s, dtype=np.int64)
    rc = lib.kcc_sweep(
        n, s, alloc_cpu, _prep(alloc_mem), _prep(alloc_pods),
        _prep(used_cpu), _prep(used_mem), _prep(pods_count),
        _healthy(healthy, n), cpu_reqs, _prep(mem_reqs), _MODES[mode],
        int(n_threads), totals,
    )
    if rc != 0:
        raise NativePanic(_PANIC)
    return totals
