"""The Python collector's pauses in one process, through ``gc.callbacks``.

Every collection is timed on the host's clock.  :meth:`GcWatch.mark`
returns the counts and seconds so far, by generation, and the longest
collection since the previous mark; collections of ``LONG_S`` or more
are kept with when they started.  A collection holds the GIL, so it
stalls every thread of its process.
"""

from __future__ import annotations

import gc
import time

__all__ = ["GcWatch", "LONG_S"]

LONG_S = 0.005


class GcWatch:
    def __init__(self) -> None:
        self.count = [0, 0, 0]
        self.total_s = [0.0, 0.0, 0.0]
        self.long: list[tuple[float, int, float]] = []
        self._max_s = 0.0
        self._t = None
        gc.callbacks.append(self._callback)

    def _callback(self, phase: str, info: dict) -> None:
        now = time.perf_counter()
        if phase == "start":
            self._t = now
            return
        if self._t is None:
            return
        took, gen = now - self._t, int(info["generation"])
        self.count[gen] += 1
        self.total_s[gen] += took
        self._max_s = max(self._max_s, took)
        if took >= LONG_S:
            self.long.append((self._t, gen, took))
        self._t = None

    def mark(self) -> dict:
        out = {"count": list(self.count), "total_s": list(self.total_s),
               "max_s": self._max_s}
        self._max_s = 0.0
        return out

    def long_between(self, t0: float, t1: float) -> list:
        """``[generation, seconds]`` of the long collections that started
        in ``[t0, t1]``."""
        return [[g, s] for t, g, s in self.long if t0 <= t <= t1]

    def stop(self) -> None:
        if self._callback in gc.callbacks:
            gc.callbacks.remove(self._callback)
