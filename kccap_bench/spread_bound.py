"""The least time an H100 needs for a zone-spread sweep, from the table of
peaks in ``roofline.py``.

A spread sweep of ``specs`` specs does the 2-resource strict sweep's
per-node work, as :func:`roofline.sweep_bound_s` counts it (the two
quotients and their min, the epilogue and the accumulate, on each live
cell), plus one add per live cell for the zone sums; its output is the
``[S]`` int64 totals, never ``fits[S, N]``.  So a later kernel that sums
fits by zone on the card, and writes no per-node fits, is held to the
same work as the per-node program.  Imports the standard library and
``roofline.py`` only.
"""

from __future__ import annotations

from kccap_bench.roofline import (
    CLOCK_HZ,
    EPILOGUE_OPS,
    FIT_OPS,
    HBM_BYTES_PER_S,
    LANES_PER_SM,
    SMS,
)

__all__ = ["ZONE_SUM_OPS", "spread_bound_s"]

ZONE_SUM_OPS = 1


def spread_bound_s(n_nodes: int, live_nodes: int, specs: int) -> float:
    """Least seconds for one strict zone-spread sweep of ``specs`` specs
    over ``n_nodes`` nodes, ``live_nodes`` of which need per-cell work: the
    larger of the operations over the lanes' peak rate and the bytes (the strict
    sweep's seven int32 node columns and each node's zone code, the two
    request rows read once and the int64 totals written once) over the
    memory rate."""
    cell_ops = FIT_OPS + EPILOGUE_OPS["strict"] + 1 + ZONE_SUM_OPS
    ops = cell_ops * live_nodes * specs
    nbytes = n_nodes * (7 + 1) * 4 + specs * 4 * 2 + specs * 8
    return max(ops / (SMS * LANES_PER_SM * CLOCK_HZ),
               nbytes / HBM_BYTES_PER_S)
