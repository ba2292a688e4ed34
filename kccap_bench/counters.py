"""Counter readings out of a run's artifacts, for the metric readers.

A counter family's snapshot (``artifacts.py`` says where the marks are)
keeps each child's value under its exposition label block,
``kernel="torch_int64",reason="mem_not_kib"``.  Imports the standard
library only.
"""

from __future__ import annotations

import re

__all__ = ["labels_of", "counter_delta"]

_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def labels_of(block: str) -> dict:
    """``{name: value}`` of an exposition label block."""
    return dict(_LABEL.findall(block))


def counter_delta(artifacts: dict, a: str, b: str, source: str,
                  family: str, keep) -> float:
    """The sum, over the children of a counter family whose labels
    ``keep(labels)`` accepts, of the value at mark ``b`` less that at mark
    ``a``; 0 where the family is not there."""
    def total(mark):
        fam = artifacts["marks"][mark].get(source, {}).get(family, {})
        return sum(v for block, v in fam.get("values", {}).items()
                   if keep(labels_of(block)))

    return total(b) - total(a)
