"""Seeded arrival schedules and spec draws shared by the traffic kinds."""

from __future__ import annotations

import numpy as np

__all__ = ["poisson_due", "draw", "sample"]

# The gaps of every schedule come from this one stream; a run's seed only
# orders them.  So every seed offers the same number of requests over the
# same total time, in another order, and runs with different seeds differ
# no more than runs of one seed do for that reason.
_GAP_STREAM = 20240601


def poisson_due(rate_per_s: float, seconds: float, seed: int) -> np.ndarray:
    """Due times in ``[0, seconds)`` of a Poisson stream at ``rate_per_s``:
    ``round(rate * seconds)`` exponential gaps, scaled to fill the window
    exactly, in an order drawn from ``seed``."""
    n = max(int(round(rate_per_s * seconds)), 1)
    gaps = np.random.default_rng(_GAP_STREAM).exponential(1.0, n)
    gaps *= seconds / gaps.sum()
    gaps = np.random.default_rng([seed, 7]).permutation(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])


def draw(rng, lo_hi, shape, dtype=np.int32) -> np.ndarray:
    """Integers in ``[lo, hi)``."""
    return rng.integers(int(lo_hi[0]), int(lo_hi[1]), size=shape, dtype=dtype)


def sample(seed: int, population: int, k) -> frozenset:
    """``k`` of ``range(population)``, drawn from ``seed``: the requests
    whose replies the check compares (``k`` ``"all"``: every one)."""
    k = population if k == "all" else min(int(k), population)
    rng = np.random.default_rng([seed, 11])
    return frozenset(int(i) for i in rng.choice(population, k, replace=False))
