"""Process self-telemetry: RSS, fds, threads, GC work, build identity.

Counterpart of ``kubernetesclustercapacity_tpu/telemetry/process.py``.
Long-running serving processes (``kccap-torch-server``, and the CLI
under ``-metrics-port``) register these once at start so every scrape answers the
first questions of any incident review — is the process leaking
memory, leaking file descriptors, or spawning threads — plus *which
build* is answering, without shelling into the box:

* ``kccap_process_rss_bytes``           resident set size
* ``kccap_process_open_fds``            open file descriptors
* ``kccap_process_threads``             live Python threads
* ``kccap_process_gc_collections_total`` cumulative GC collections
* ``kccap_build_info``                  constant 1, ``version`` label

All five are CALLBACK gauges: the scrape reads the current value, no
background ticker, no per-request cost.  Registration is idempotent
(same registry semantics as every other family) and a no-op under
``KCCAP_TELEMETRY=0`` — a silenced process must stay silent.

Sources are stdlib-only with graceful degradation: ``/proc/self`` where
it exists (Linux), ``resource.getrusage`` fallback for RSS, ``-1`` for
genuinely unknowable values (a gauge that lies with 0 would read as "no
leak" — ``-1`` reads as "cannot tell").
"""

from __future__ import annotations

import gc
import os
import threading

__all__ = ["register_process_metrics", "rss_bytes", "open_fds"]


def rss_bytes() -> float:
    """Resident set size in bytes, or -1.0 when unknowable."""
    try:
        with open("/proc/self/statm", encoding="ascii") as fh:
            pages = int(fh.read().split()[1])
        return float(pages * os.sysconf("SC_PAGE_SIZE"))
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # Linux reports KiB; macOS reports bytes.  Either way it is the
        # peak, not current — an acceptable degraded answer.
        import sys

        return float(ru if sys.platform == "darwin" else ru * 1024)
    except Exception:  # noqa: BLE001 - telemetry degrades, never raises
        return -1.0


def open_fds() -> float:
    """Open file-descriptor count, or -1.0 when unknowable."""
    try:
        return float(len(os.listdir("/proc/self/fd")))
    except OSError:
        return -1.0


def _gc_collections() -> float:
    try:
        return float(sum(s.get("collections", 0) for s in gc.get_stats()))
    except Exception:  # noqa: BLE001 - telemetry degrades, never raises
        return -1.0


def register_process_metrics(registry, *, version: str | None = None):
    """Bind the process gauges onto ``registry``.  Returns the registry
    (chaining convenience) — or unchanged, untouched, when telemetry is
    globally off.  ``version`` defaults to the package version; it lands
    as the ``kccap_build_info`` info-gauge's label, the Prometheus
    idiom for joining every other series to a build."""
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
        enabled as _telemetry_enabled,
    )

    if not _telemetry_enabled() or registry is None:
        return registry
    if version is None:
        from kubernetesclustercapacity_tpu_torch import __version__ as version

    registry.gauge(
        "kccap_process_rss_bytes",
        "Resident set size of this process (bytes; -1 = unknowable).",
    ).labels().set_function(rss_bytes)
    registry.gauge(
        "kccap_process_open_fds",
        "Open file descriptors held by this process (-1 = unknowable).",
    ).labels().set_function(open_fds)
    registry.gauge(
        "kccap_process_threads",
        "Live Python threads in this process.",
    ).labels().set_function(lambda: float(threading.active_count()))
    registry.gauge(
        "kccap_process_gc_collections_total",
        "Cumulative garbage-collector collections (all generations).",
    ).labels().set_function(_gc_collections)
    registry.gauge(
        "kccap_build_info",
        "Constant 1; the version label identifies the running build.",
        ("version",),
    ).labels(version=str(version)).set(1)
    return registry
