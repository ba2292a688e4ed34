"""Quantity strings as the two semantics read them, written out plainly.

Only the forms a benchmark cluster or stream carries are accepted: an
unsigned integer with an optional suffix.  Anything else raises
:class:`Unsupported`, so that input this reference was not written for
fails loudly instead of being read some other way.  Imports nothing but
the standard library.
"""

from __future__ import annotations

import functools
import re
from fractions import Fraction

__all__ = [
    "Unsupported",
    "quantity_value",
    "quantity_milli",
    "cpu_milli_reference",
    "bytefmt_reference",
]


class Unsupported(ValueError):
    """A quantity form this reference does not read."""


_SUFFIX = {
    "": 1, "m": Fraction(1, 1000),
    "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15,
    "E": 10**18,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50,
    "Ei": 2**60,
}
_QTY = re.compile(r"^([0-9]+)([a-zA-Z]*)$")


def _exact(s: str) -> Fraction:
    m = _QTY.match(s)
    if m is None or m.group(2) not in _SUFFIX:
        raise Unsupported(f"quantity {s!r}")
    return int(m.group(1)) * Fraction(_SUFFIX[m.group(2)])


def _ceil(q: Fraction) -> int:
    return -((-q.numerator) // q.denominator)


@functools.lru_cache(maxsize=None)
def quantity_value(s: str | None) -> int:
    """Kubernetes ``Quantity.Value()``: the amount rounded up to a whole
    unit; an absent quantity is 0."""
    return 0 if s is None else _ceil(_exact(s))


@functools.lru_cache(maxsize=None)
def quantity_milli(s: str | None) -> int:
    """Kubernetes ``Quantity.MilliValue()``; an absent quantity is 0."""
    return 0 if s is None else _ceil(_exact(s) * 1000)


@functools.lru_cache(maxsize=None)
def cpu_milli_reference(s: str) -> int:
    """The Go CLI's ``convertCPUToMilis``: ``"250m"`` is 250, ``"2"`` is
    2000, and a string that is not an integer after the ``m`` is cut
    off reads 0."""
    has_m = s.endswith("m")
    digits = s[:-1] if has_m else s
    if not re.fullmatch(r"[0-9]+", digits):
        return 0
    return int(digits) if has_m else int(digits) * 1000


_BYTEFMT = {
    "T": 2**40, "TB": 2**40, "TIB": 2**40,
    "G": 2**30, "GB": 2**30, "GIB": 2**30,
    "M": 2**20, "MB": 2**20, "MIB": 2**20, "MI": 2**20,
    "K": 2**10, "KB": 2**10, "KIB": 2**10, "KI": 2**10,
    "B": 1,
}


@functools.lru_cache(maxsize=None)
def bytefmt_reference(s: str) -> int:
    """``bytefmt.ToBytes`` as the Go CLI reads a node's memory: upper-cased,
    split at the first letter, every unit base 2, and ``GI``/``TI`` not
    in its table.  Returns None where it fails (the CLI then reads 0)."""
    s = s.strip().upper()
    m = re.fullmatch(r"([0-9]+)([A-Z]+)", s)
    if m is None or m.group(2) not in _BYTEFMT:
        return None
    # Go multiplies a float64; the values a cluster carries stay below
    # 2**53, where that product is exact.
    return int(float(m.group(1)) * _BYTEFMT[m.group(2)])
