"""Host memory, attributed: where a server process's resident memory went.

A capacity server on a card's host holds gigabytes of resident memory,
and one reading at the end (``ru_maxrss``) cannot say which part is the
interpreter, torch and the CUDA context, which the cluster and the store,
and which the kernel images a route loads on its first dispatch.  Four
families of the process registry keep the parts apart:

``kccap_hostmem_rss_bytes{at}`` and ``kccap_hostmem_peak_bytes{at}``
    the resident set (``VmRSS``, :func:`.process.rss_bytes`) and the peak
    resident set so far (``ru_maxrss``), each set once, at the process's
    set-up milestones: ``import`` (the end of the package's
    ``__init__``), ``pack_start`` and ``pack_end`` (around the first
    :func:`..snapshot.snapshot_from_fixture`), ``served`` (a
    ``CapacityServer`` is serving) and ``store_start`` and
    ``store_built`` (around the first ``ClusterStore`` an ``update``
    builds); and ``at="now"``, read whenever the registry is;
``kccap_hostmem_first_dispatch_bytes{kernel}``
    the resident set's growth across the first dispatch of each route
    label (from once the proof has chosen the label to once the launch
    has its fetch queued): the module images and kernel libraries that
    route pulls in (CUDA loads each lazily, on first use), the grid
    ``topology_spread``'s per-node route (``torch_int64_per_node``) among
    them;
``kccap_hostmem_malloc_bytes{kind}``
    glibc's ``mallinfo2()``, read whenever the registry is: ``arena``
    (heap taken from the system), ``mmap`` (chunks mapped on their own),
    ``in_use`` and ``free_held`` (freed, kept by the allocator); -1
    where the C library has no ``mallinfo2`` (``mallinfo``'s ``int``
    fields wrap past 2 GiB, so it is no stand-in).

Only ``/proc/self/statm`` and ``getrusage`` are read: some hosts' ``/proc``
has no ``RssAnon``/``RssFile`` split.  The families stay out of the
Prometheus text (``scrape=False``), like the route counters
(:mod:`.routes`); the registry's snapshot holds them.  Importing the
package touches no registry: its reading waits in :data:`_import_reading`
until the first milestone registers the families.  With
``KCCAP_TELEMETRY=0`` nothing is read and nothing registered.
"""

from __future__ import annotations

import ctypes
import functools
import resource
import threading

from kubernetesclustercapacity_tpu_torch.telemetry.metrics import enabled
from kubernetesclustercapacity_tpu_torch.telemetry.process import rss_bytes

__all__ = ["dispatch_end", "dispatch_start", "malloc_bytes", "milestone",
           "note_import", "peak_bytes"]

MALLOC_KINDS = {"arena": "arena", "mmap": "hblkhd", "in_use": "uordblks",
                "free_held": "fordblks"}

_lock = threading.Lock()
_MET: dict | None = None
#: ``(rss, peak)`` at the end of the package's ``__init__``.
_import_reading: tuple[float, float] | None = None
_milestones: set[str] = set()
_dispatched: set[str] = set()


def peak_bytes() -> float:
    """The process's peak resident set so far, in bytes (``ru_maxrss``,
    which Linux gives in KiB)."""
    return float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)


class _Mallinfo2(ctypes.Structure):
    _fields_ = [(name, ctypes.c_size_t) for name in (
        "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks",
        "fsmblks", "uordblks", "fordblks", "keepcost")]


@functools.cache
def _mallinfo2():
    """glibc's ``mallinfo2``, or None where the C library lacks it."""
    try:
        fn = ctypes.CDLL(None).mallinfo2
    except (AttributeError, OSError):
        return None
    fn.argtypes = []
    fn.restype = _Mallinfo2
    return fn


def malloc_bytes(kind: str) -> float:
    """One of :data:`MALLOC_KINDS` from ``mallinfo2()``, in bytes; -1.0
    where the C library has no ``mallinfo2``."""
    fn = _mallinfo2()
    if fn is None:
        return -1.0
    return float(getattr(fn(), MALLOC_KINDS[kind]))


def note_import() -> None:
    """Keep the reading at the end of the package's import, for the first
    milestone to register."""
    global _import_reading
    if enabled() and _import_reading is None:
        _import_reading = (rss_bytes(), peak_bytes())


def _metrics() -> dict:
    global _MET
    with _lock:
        if _MET is not None:
            return _MET
        from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
            REGISTRY,
        )

        met = {
            "rss": REGISTRY.gauge(
                "kccap_hostmem_rss_bytes",
                "Resident set size at each set-up milestone, and now "
                "(bytes).", ("at",), scrape=False),
            "peak": REGISTRY.gauge(
                "kccap_hostmem_peak_bytes",
                "Peak resident set size so far at each set-up milestone, "
                "and now (bytes).", ("at",), scrape=False),
            "first_dispatch": REGISTRY.gauge(
                "kccap_hostmem_first_dispatch_bytes",
                "Resident set growth across the first dispatch of each "
                "route label (bytes).", ("kernel",), scrape=False),
            "malloc": REGISTRY.gauge(
                "kccap_hostmem_malloc_bytes",
                "glibc mallinfo2() by kind: arena, mmap, in_use, "
                "free_held (bytes; -1 = no mallinfo2).", ("kind",),
                scrape=False),
        }
        met["rss"].labels(at="now").set_function(rss_bytes)
        met["peak"].labels(at="now").set_function(peak_bytes)
        for kind in MALLOC_KINDS:
            met["malloc"].labels(kind=kind).set_function(
                lambda kind=kind: malloc_bytes(kind))
        if _import_reading is not None:
            _milestones.add("import")
            met["rss"].labels(at="import").set(_import_reading[0])
            met["peak"].labels(at="import").set(_import_reading[1])
        _MET = met
        return met


def milestone(at: str) -> None:
    """Set ``rss{at}`` and ``peak{at}`` to now's readings, the first time
    the process reaches ``at``."""
    if at in _milestones or not enabled():
        return
    m = _metrics()
    with _lock:
        if at in _milestones:
            return
        _milestones.add(at)
    m["rss"].labels(at=at).set(rss_bytes())
    m["peak"].labels(at=at).set(peak_bytes())


def dispatch_start(kernel: str) -> float | None:
    """The resident set before the first dispatch of ``kernel``, for
    :func:`dispatch_end`; None for every later one (one set lookup)."""
    if kernel in _dispatched or not enabled():
        return None
    return rss_bytes()


def dispatch_end(kernel: str, before: float | None) -> None:
    """File the growth since ``before`` as ``kernel``'s first dispatch;
    of two first dispatches of one label that overlap, the first to end."""
    if before is None:
        return
    m = _metrics()
    with _lock:
        if kernel in _dispatched:
            return
        _dispatched.add(kernel)
    m["first_dispatch"].labels(kernel=kernel).set(rss_bytes() - before)
