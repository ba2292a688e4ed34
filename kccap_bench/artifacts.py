"""Readings out of a run's artifacts, for the metric readers.

``artifacts["marks"][name][source]`` is a registry snapshot (``source``
``server``: the server's registry; ``process``: the process registry,
where the kernel wrappers file their dispatches; ``gc``: the server
process's collector, ``gcwatch.GcWatch.mark``), taken at the mark
``name``: ``start`` (the window opens), ``trace_start``,
``trace_stop`` and ``end`` (every reply in, before the server stops).
``artifacts["gc_long"]`` lists the window's long collections,
``artifacts["maxrss_kib"]`` is the server process's peak resident memory,
``artifacts["load"]`` holds the client side, ``artifacts["trace"]`` the
reduced profiler trace, ``artifacts["cell"]`` the sizes of the work.
"""

from __future__ import annotations

__all__ = ["hist", "hist_delta", "mean_ms"]


def _labels(labels: dict) -> str:
    return ",".join(f'{k}="{v}"' for k, v in labels.items())


def hist(artifacts: dict, mark: str, source: str, family: str,
         **labels) -> tuple[float, int]:
    """``(sum, count)`` of a histogram at a mark; with no labels given,
    summed over every child of the family."""
    fam = artifacts["marks"][mark][source].get(family, {}).get("values", {})
    if labels:
        child = fam.get(_labels(labels))
        return (child["sum"], child["count"]) if child else (0.0, 0)
    return (sum(c["sum"] for c in fam.values()),
            sum(c["count"] for c in fam.values()))


def hist_delta(artifacts: dict, a: str, b: str, source: str, family: str,
               **labels) -> tuple[float, int]:
    s0, n0 = hist(artifacts, a, source, family, **labels)
    s1, n1 = hist(artifacts, b, source, family, **labels)
    return s1 - s0, n1 - n0


def mean_ms(total_s: float, count: int):
    """Milliseconds per item, or None where there was nothing."""
    return total_s / count * 1e3 if count > 0 else None
