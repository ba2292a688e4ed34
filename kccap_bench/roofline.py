"""The least time an H100 needs for a capacity sweep: the table of peaks
and the bound arithmetic, frozen.

A copy of the bound in ``chip_smoke.py`` (``Variant.bound`` for kernel
B1, ``MultiVariant.bound`` for B2) that PERF.md's kernel table uses,
with the peaks fixed here instead of read from the card: the published
boost clock of an H100 SXM (1,980 MHz) and its memory rate (3.35 TB/s,
NVIDIA's data sheet).  The work is counted from what the requests ask,
not from the launches that answered them, so a folded launch, B1, the
exact program or a later kernel all read the same least time.  Each
input is read once and each output written once.  Imports nothing but
the standard library.
"""

from __future__ import annotations

__all__ = ["SMS", "LANES_PER_SM", "CLOCK_HZ", "HBM_BYTES_PER_S",
           "sweep_bound_s", "multi_cell_ops", "multi_bound_s"]

SMS = 132
# Every operation takes at least one lane of an issued instruction, and
# an SM issues at most four 32-lane warp instructions a clock.
LANES_PER_SM = 128
CLOCK_HZ = 1.98e9
HBM_BYTES_PER_S = 3.35e12
_OPS_S = SMS * LANES_PER_SM * CLOCK_HZ

# Per (spec, node) cell: two quotients and their min (3), the epilogue
# (reference 2, strict 1) and the accumulate (1).
FIT_OPS = 3
EPILOGUE_OPS = {"reference": 2, "strict": 1}


def sweep_bound_s(n_nodes: int, live_nodes: int, specs: int,
                  semantics: str) -> float:
    """Least seconds for one 2-resource sweep of ``specs`` specs over
    ``n_nodes`` nodes, ``live_nodes`` of which need per-cell work: the
    larger of the operations over the issue rate and the bytes (six int32
    node columns, plus the mask under strict, the two request rows read
    once and the int64 totals written once) over the memory rate."""
    ops = (FIT_OPS + EPILOGUE_OPS[semantics] + 1) * live_nodes * specs
    cols = 6 + (semantics == "strict")
    nbytes = n_nodes * cols * 4 + specs * 4 * 2 + specs * 8
    return max(ops / _OPS_S, nbytes / HBM_BYTES_PER_S)


def multi_cell_ops(active_rows, semantics: str) -> int:
    """Operations per node of one R-resource sweep: ``active_rows`` holds,
    per spec, how many of its requests are not 0; a spec with ``a`` of
    them costs ``max(2a - 1, 0)`` for the quotients and their mins, the
    epilogue and the accumulate."""
    return sum(max(2 * int(a) - 1, 0) + EPILOGUE_OPS[semantics] + 1
               for a in active_rows)


def multi_bound_s(n_nodes: int, live_nodes: int, cell_ops: float,
                  specs: int, resources: int, semantics: str) -> float:
    """Least seconds for one R-resource sweep of ``specs`` specs whose
    :func:`multi_cell_ops` is ``cell_ops``: the larger of the operations
    on the live nodes over the issue rate and the bytes (``2R + 2`` int32
    node columns, and the mask under strict, the request rows, the int64
    totals) over the memory rate."""
    nbytes = ((2 * resources + 2 + (semantics == "strict")) * 4 * n_nodes
              + resources * 4 * specs + 8 * specs)
    return max(live_nodes * cell_ops / _OPS_S, nbytes / HBM_BYTES_PER_S)
