"""Compile visibility: first-call (compile) vs steady-state latency.

Counterpart of ``kubernetesclustercapacity_tpu/telemetry/compilewatch.py``.
Eager PyTorch traces and compiles nothing per shape, but a kernel label's
first dispatch on the card still pays a one-off cost the steady state
does not: the ``nvcc`` build of the kernel's CUDA source, or the load of
its cached shared library (:mod:`..ops._build`), plus CUDA's lazy module
load.  That first dispatch is the port's "compile", and a build that
regresses (or repeats) must not read as a latency regression.  Every
auto-dispatch entry point (:func:`..ops.fit.sweep_snapshot`,
:func:`..ops.fused_fit.sweep_auto`, :func:`..ops.fused_multi.
sweep_multi_auto`, the fused sweep+explain and sweep+quantile programs)
reports its host-timed dispatch here; the FIRST observation per kernel
label is recorded as the compile (gauge + counter) and the rest feed a
steady-state histogram.

Hot-path rule: everything here is host-side, after the device sync, and
every entry checks :func:`~.metrics.enabled` — ``KCCAP_TELEMETRY=0``
means zero registry calls.
"""

from __future__ import annotations

import threading

from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
    SUB_MS_LATENCY_BUCKETS_S,
    enabled,
)

__all__ = ["observe_dispatch", "seen_kernels", "reset"]

_lock = threading.Lock()
_seen: set[str] = set()
_MET: dict | None = None


def _metrics() -> dict:
    global _MET
    if _MET is None:
        from kubernetesclustercapacity_tpu_torch.telemetry.metrics import REGISTRY

        _MET = {
            "compiles": REGISTRY.counter(
                "kccap_kernel_compiles_total",
                "First-call (build/load) dispatches observed, by kernel.",
                ("kernel",),
            ),
            "first_call": REGISTRY.gauge(
                "kccap_kernel_first_call_seconds",
                "Host-timed duration of the kernel's first dispatch "
                "(includes the kernel build or load), by kernel.",
                ("kernel",),
            ),
            "steady": REGISTRY.histogram(
                "kccap_kernel_steady_seconds",
                "Host-timed steady-state (post-build) dispatch "
                "latency, by kernel.",
                ("kernel",),
                # Sub-ms ladder (metrics.SUB_MS_LATENCY_BUCKETS_S): the
                # fixed default buckets flatten a sub-millisecond
                # dispatch into one bin, making steady-state p50/p99
                # useless.
                buckets=SUB_MS_LATENCY_BUCKETS_S,
            ),
        }
    return _MET


def observe_dispatch(kernel: str, seconds: float) -> str:
    """Record one host-timed dispatch of ``kernel``.

    Returns ``"compile"`` for the first observation of this kernel label
    in the process, ``"steady"`` after, ``"disabled"`` when telemetry is
    off (in which case nothing touches the registry).
    """
    if not enabled():
        return "disabled"
    with _lock:
        first = kernel not in _seen
        if first:
            _seen.add(kernel)
    m = _metrics()
    if first:
        m["compiles"].labels(kernel=kernel).inc()
        m["first_call"].labels(kernel=kernel).set(float(seconds))
        return "compile"
    m["steady"].labels(kernel=kernel).observe(float(seconds))
    return "steady"


def seen_kernels() -> tuple[str, ...]:
    """Kernel labels that have dispatched at least once (sorted)."""
    with _lock:
        return tuple(sorted(_seen))


def reset() -> None:
    """Forget which kernels have compiled (tests / operators re-arming
    after a deliberate cache flush).  Registry values are left alone —
    counters are monotonic by contract."""
    with _lock:
        _seen.clear()
