"""Timing / profiling harness.

Counterpart of ``kubernetesclustercapacity_tpu/utils/timing.py``:
phase-scoped wall-clock timers (snapshot → pack → kernel → report),
latency statistics (scenarios/sec, p50 sweep latency), and a
``torch.profiler`` trace hook.

Device-timing note: CUDA launches are asynchronous — a phase that launches
a kernel returns before the kernel finishes.  :meth:`_PhaseHandle.block`
registers the phase's results; when the phase closes it waits for the
CUDA devices those tensors live on (nothing is waited on for CPU tensors
or host arrays), so kernel phases measure completion, not the enqueue.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field

import numpy as np

__all__ = ["PhaseTimer", "LatencyStats", "measure_latency", "trace", "wait_for"]


def _cuda_devices(result) -> set:
    """The CUDA devices of every tensor inside ``result`` (tuples, lists
    and dict values nest; anything else is ignored)."""
    import torch

    out: set = set()
    stack = [result]
    while stack:
        v = stack.pop()
        if isinstance(v, (tuple, list)):
            stack.extend(v)
        elif isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, torch.Tensor) and v.device.type == "cuda":
            out.add(v.device)
    return out


def wait_for(result):
    """Block until the device work producing ``result`` has finished
    (``torch.cuda.synchronize`` of each CUDA device its tensors live on);
    returns ``result`` unchanged.  CPU tensors and host arrays are
    already complete, so nothing is waited on for them."""
    devices = _cuda_devices(result)
    if devices:
        import torch

        for device in devices:
            torch.cuda.synchronize(device)
    return result


class _PhaseHandle:
    """Yielded by :meth:`PhaseTimer.phase`; lets the body register device
    results the phase must wait for (CUDA launches are asynchronous)."""

    def __init__(self) -> None:
        self._blockers: list = []

    def block(self, result):
        """Register a result to wait for (:func:`wait_for`) before the
        phase closes; returns it unchanged so it can be used inline."""
        self._blockers.append(result)
        return result


@dataclass
class PhaseTimer:
    """Accumulates named phase durations; renders a report or JSON.

    >>> t = PhaseTimer()
    >>> with t.phase("pack"):
    ...     snapshot = snapshot_from_fixture(fx)
    >>> with t.phase("kernel") as ph:
    ...     totals = ph.block(sweep(...))  # phase waits for the device
    >>> print(t.report())
    """

    phases: dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        handle = _PhaseHandle()
        t0 = time.perf_counter()
        try:
            yield handle
        finally:
            if handle._blockers:
                wait_for(handle._blockers)
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self) -> str:
        total = sum(self.phases.values())
        lines = [f"{'PHASE':<24} {'SECONDS':>10} {'SHARE':>8}"]
        for name, secs in self.phases.items():
            share = (secs / total * 100) if total else 0.0
            lines.append(f"{name:<24} {secs:>10.4f} {share:>7.1f}%")
        lines.append(f"{'total':<24} {total:>10.4f}")
        return "\n".join(lines)

    def json(self) -> str:
        return json.dumps(
            {k: round(v, 6) for k, v in self.phases.items()}
        )


@dataclass(frozen=True)
class LatencyStats:
    """Latency distribution of repeated runs, in milliseconds.

    Rejects empty samples at construction: every accessor percentiles
    over ``samples_ms``, and ``np.percentile([])`` raises an opaque
    IndexError long after the real mistake (a zero-rep measurement).
    """

    samples_ms: tuple

    def __post_init__(self) -> None:
        if not self.samples_ms:
            raise ValueError(
                "LatencyStats needs at least one sample; an empty "
                "samples_ms usually means the measurement ran 0 reps"
            )

    @property
    def p50(self) -> float:
        return float(np.percentile(self.samples_ms, 50))

    @property
    def p10(self) -> float:
        return float(np.percentile(self.samples_ms, 10))

    @property
    def p90(self) -> float:
        return float(np.percentile(self.samples_ms, 90))

    def throughput(self, items_per_run: int) -> float:
        """items/sec at p50 — e.g. scenarios/sec for a sweep."""
        return items_per_run / (self.p50 / 1e3)

    def json(self) -> str:
        return json.dumps(
            {
                "p10_ms": round(self.p10, 3),
                "p50_ms": round(self.p50, 3),
                "p90_ms": round(self.p90, 3),
                "runs": len(self.samples_ms),
            }
        )


def measure_latency(fn, *, reps: int = 30, warmup: int = 1) -> LatencyStats:
    """Time ``fn()`` (which must block on its own result) ``reps`` times.

    ``reps`` must be >= 1 and ``warmup`` >= 0 — validated here, because
    ``reps=0`` would otherwise produce an empty sample set that only
    explodes later, inside a percentile deep in reporting code.
    """
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    if warmup < 0:
        raise ValueError(f"warmup must be >= 0, got {warmup}")
    for _ in range(warmup):
        fn()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    return LatencyStats(samples_ms=tuple(samples))


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace scope (CPU and, where present, CUDA
    activity), written as a Chrome trace to ``log_dir/trace.json``::

        with trace("/tmp/kcc-trace"):
            sweep_snapshot(snap, grid, device="cuda")
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
