"""The program's host-memory gauges out of a run's artifacts, for the
metric readers of the layer "Server process host memory".

The program files them in its process registry (the ``process`` source of
each mark, ``artifacts.py``): ``kccap_hostmem_rss_bytes{at}`` and
``kccap_hostmem_peak_bytes{at}`` at its set-up milestones and ``at="now"``,
``kccap_hostmem_first_dispatch_bytes{kernel}`` and
``kccap_hostmem_malloc_bytes{kind}``.  Each function returns None where
the gauge is not there, as on a program without them.  Imports the
standard library only.
"""

from __future__ import annotations

from kccap_bench.counters import labels_of

__all__ = ["MIB", "family", "gauge", "milestone", "growth_mib"]

MIB = float(1 << 20)


def family(artifacts: dict, mark: str, name: str) -> dict | None:
    """``{label block: value}`` of the family ``name`` at ``mark``, or
    None."""
    fam = artifacts["marks"].get(mark, {}).get("process", {}).get(name)
    return None if fam is None else fam.get("values", {})


def gauge(artifacts: dict, mark: str, name: str, **labels) -> float | None:
    """The child of ``name`` with ``labels`` at ``mark``, or None."""
    values = family(artifacts, mark, name) or {}
    for block, value in values.items():
        if labels_of(block) == labels:
            return value
    return None


def milestone(artifacts: dict, kind: str, at: str) -> float | None:
    """``kccap_hostmem_<kind>_bytes{at}`` (``kind`` ``rss`` or ``peak``) of
    a set-up milestone, as the run's last mark holds it."""
    return gauge(artifacts, "end", f"kccap_hostmem_{kind}_bytes", at=at)


def growth_mib(before: float | None, after: float | None) -> float | None:
    """``after - before`` in MiB, or None where either is missing."""
    if before is None or after is None:
        return None
    return (after - before) / MIB
