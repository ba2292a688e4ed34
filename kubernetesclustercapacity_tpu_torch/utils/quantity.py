"""Quantity codecs (L3): CPU-millicore and byte-quantity parsing.

The PyTorch port's own copy of ``kubernetesclustercapacity_tpu/utils/
quantity.py`` (stdlib only, kept verbatim so both packages parse every
string identically; the port never imports the JAX package).

Two families of codecs live here:

* **Reference-exact codecs** reproduce the reference's parsing bit-for-bit,
  including its quirks, so bit-exact parity against the reference CPU path is
  possible (SURVEY.md §2.2):

  - :func:`cpu_to_milli_reference` — semantics of ``convertCPUToMilis``
    (reference ``src/KubeAPI/ClusterCapacity.go:301-319``): trailing ``m``
    stripped and value used as-is, otherwise integer × 1000; *any* parse
    failure yields 0 (not an error).
  - :func:`to_bytes_reference` — semantics of ``bytefmt.ToBytes`` (reference
    ``src/bytefmt/bytes.go:75-105``): ALL prefixes are base-2 (``MB == MiB ==
    1024·1024``), a plain number with no unit is an error, value ≤ 0 is an
    error, and ``GI``/``TI`` are rejected while ``MI``/``KI`` parse (the
    upstream suffix-table asymmetry).
  - :func:`byte_size` / :func:`to_megabytes` — the reference's formatting
    helpers (``bytes.go:32-68``; dead code there, kept for API parity).

* **Strict codecs** implement the real Kubernetes ``resource.Quantity``
  grammar (``<signedNumber><suffix>`` with binary ``Ki..Ei``, decimal SI
  ``n..E`` and scientific ``e``/``E`` exponents) with exact decimal
  arithmetic, matching ``Quantity.Value()`` / ``Quantity.MilliValue()``
  round-up semantics.  The reference itself uses this API for **pod memory**
  (``ClusterCapacity.go:285-286`` calls ``Resources...Memory().Value()``), so
  even bug-compatible mode needs the strict parser.

All functions are pure Python on scalars — parsing happens once at snapshot
ingestion, never inside the device hot loop.
"""

from __future__ import annotations

import functools
import unicodedata
from dataclasses import dataclass
from fractions import Fraction

# Quantity strings repeat massively across a cluster (every node of a
# machine type advertises the same "8" / "16Gi" / "110"; most pods share a
# handful of request shapes), so the pure string→value codecs are memoized.
# 10k-node ingestion is dominated by exact-Fraction parsing without this
# (SURVEY.md §7 "snapshot ingestion at 10k nodes").  Bounded so hostile
# streams of distinct strings cannot grow memory; failures raise and are
# deliberately NOT cached (lru_cache does not cache exceptions).
_PARSE_CACHE_SIZE = 1 << 16

__all__ = [
    "QuantityParseError",
    "go_atoi",
    "go_atoi_clamped",
    "int64_bits",
    "cpu_to_milli_reference",
    "cpu_parse_error_payload",
    "to_bytes_reference",
    "byte_size",
    "to_megabytes",
    "Quantity",
    "parse_quantity",
    "cpu_to_milli_strict",
    "mem_to_bytes_strict",
]

_UINT64_MOD = 1 << 64

# Base-2 multipliers of the reference byte codec (bytes.go:15-21).
_KIB = 1024
_MIB = 1024 * _KIB
_GIB = 1024 * _MIB
_TIB = 1024 * _GIB

_INVALID_BYTE_QUANTITY_MSG = (
    "byte quantity must be a positive integer with a unit of measurement like "
    "M, MB, MiB, G, GiB, or GB"
)


class QuantityParseError(ValueError):
    """Raised when a quantity string cannot be parsed."""


def go_atoi(s: str) -> int | None:
    """Base-10 integer parse with Go ``strconv.Atoi`` acceptance rules.

    Optional single leading ``+``/``-``, then one or more ASCII digits.  No
    whitespace, no underscores, no empty string, and — like Go — values
    outside int64 range are a range error.  Returns ``None`` on failure
    (callers decide the failure semantics).
    """
    if not s:
        return None
    body = s[1:] if s[0] in "+-" else s
    if not body or not body.isascii() or not body.isdigit():
        return None
    value = int(s, 10)
    if not (-(1 << 63) <= value < (1 << 63)):
        return None
    return value


def go_atoi_clamped(s: str) -> int:
    """The VALUE Go ``strconv.Atoi`` returns alongside a failed parse.

    Syntax errors return 0, but range errors return the int64-CLAMPED
    value (``strconv.ParseInt`` semantics) — and the reference's fatal
    replicas line prints that value (``fmt.Println(..., replicas, ...)``
    at ``ClusterCapacity.go:81``), so byte parity needs it.
    """
    body = s[1:] if s[:1] in "+-" else s
    if body and body.isascii() and body.isdigit():
        value = int(s, 10)
        if value >= 1 << 63:
            return (1 << 63) - 1
        if value < -(1 << 63):
            return -(1 << 63)
        return value
    return 0


def int64_bits(u: int) -> int:
    """Reinterpret an arbitrary integer as its int64 bit pattern
    (mod 2^64, two's complement) — the carrier the kernels/native code
    use for Go's uint64 values."""
    u %= 1 << 64
    return u - (1 << 64) if u >= 1 << 63 else u


@functools.lru_cache(maxsize=_PARSE_CACHE_SIZE)
def cpu_parse_error_payload(cpu: str) -> str | None:
    """The ``%s`` of the reference codec's error line, or ``None``.

    ``convertCPUToMilis`` prints ``"\\nError converting string to int for
    %s\\n"`` with the SUFFIX-STRIPPED string whenever ``Atoi`` fails
    (``ClusterCapacity.go:314-317``) — transcript parity replays these.
    """
    body = cpu[:-1] if cpu.endswith("m") else cpu
    return None if go_atoi(body) is not None else body


# Go ``unicode.IsSpace`` == the Unicode White_Space property — the exact
# set ``strings.TrimSpace`` trims (``bytes.go:76``).  Python's bare
# ``str.strip()`` trims a SUPERSET (U+001C–U+001F, the ASCII separator
# controls, are Python-space but not Go-space), so the reference codec
# trims with this explicit set to stay byte-compatible: ``"\x1c100MB"``
# must FAIL to parse, as it does in Go.
_GO_SPACE_CHARS = (
    "\t\n\v\f\r \x85\xa0\u1680"
    "\u2000\u2001\u2002\u2003\u2004\u2005\u2006\u2007\u2008"
    "\u2009\u200a\u2028\u2029\u202f\u205f\u3000"
)


_GO_QUOTE_ESCAPES = {
    "\a": "\\a", "\b": "\\b", "\f": "\\f", "\n": "\\n",
    "\r": "\\r", "\t": "\\t", "\v": "\\v",
    "\\": "\\\\", '"': '\\"',
}


def _go_is_print(ch: str) -> bool:
    """Go ``unicode.IsPrint``: letters, marks, numbers, punctuation,
    symbols, and the ASCII space — category classes L/M/N/P/S plus
    U+0020 (doc of ``unicode.IsPrint``; graphic minus the other spaces).
    """
    if ch == " ":
        return True
    return unicodedata.category(ch)[0] in "LMNPS"


def go_quote(s: str) -> str:
    """Go ``strconv.Quote`` — the ``%q`` verb's quoting, byte-exact.

    The reference's fatal replicas line embeds ``strconv.Atoi``'s error,
    whose ``parsing %q`` quotes the input: double-quote wrapping, the
    standard single-char escapes, ``\\xhh`` for other non-printable
    ASCII, ``\\uhhhh`` / ``\\Uhhhhhhhh`` for non-printable non-ASCII
    (``unicode.IsPrint`` decides).  Invalid UTF-8 bytes in argv arrive
    here as surrogate escapes (PEP 383) and print as ``\\xhh`` of the
    original byte, exactly as Go quotes invalid bytes.
    """
    out = ['"']
    for ch in s:
        if ch in _GO_QUOTE_ESCAPES:
            out.append(_GO_QUOTE_ESCAPES[ch])
        elif _go_is_print(ch):
            out.append(ch)
        else:
            cp = ord(ch)
            if 0xDC80 <= cp <= 0xDCFF:  # PEP 383 surrogate: a raw byte
                out.append(f"\\x{cp - 0xDC00:02x}")
            elif cp < 0x80:
                out.append(f"\\x{cp:02x}")
            elif cp < 0x10000:
                out.append(f"\\u{cp:04x}")
            else:
                out.append(f"\\U{cp:08x}")
    out.append('"')
    return "".join(out)


def go_atoi_error(s: str) -> str:
    """The ``strconv.Atoi`` error text Go prints for a failed parse.

    Byte-parity helper for the reference's fatal replicas line
    (``ClusterCapacity.go:81``): syntactically-valid digits that overflow
    int64 are a range error, anything else is a syntax error.  The input
    is quoted with full ``%q`` semantics (:func:`go_quote`), so control
    characters and non-printables in flag values match Go byte-for-byte.
    """
    body = s[1:] if s[:1] in "+-" else s
    if body and body.isascii() and body.isdigit():
        return f"strconv.Atoi: parsing {go_quote(s)}: value out of range"
    return f"strconv.Atoi: parsing {go_quote(s)}: invalid syntax"


@functools.lru_cache(maxsize=_PARSE_CACHE_SIZE)
def cpu_to_milli_reference(cpu: str) -> int:
    """CPU quantity string → millicores, reference semantics.

    Mirrors ``convertCPUToMilis`` (``ClusterCapacity.go:301-319``):

    * ``"250m"`` → 250 (trailing ``m`` stripped, value as-is)
    * ``"2"``    → 2000 (no suffix → cores × 1000)
    * any parse failure (``"0.5"``, ``"100Mi"``, ``""``, ``"1e2"``) → **0**
      — the reference prints an error and carries on with zero.
    * negative inputs wrap through Go's ``uint64(int(...))`` conversion —
      ``"-5"`` → 2**64 − 5000.  Reproduced so the codec is total on the same
      domain as the reference.
    """
    has_m = cpu.endswith("m")
    if has_m:
        cpu = cpu[:-1]
    value = go_atoi(cpu)
    if value is None:
        return 0
    if not has_m:
        value *= 1000
    return value % _UINT64_MOD


def _go_parse_float(s: str) -> float | None:
    """Approximation of Go ``strconv.ParseFloat(s, 64)`` for the codec's use.

    Accepts decimal and exponent forms (and underscore digit separators, as
    both languages do).  Whitespace is rejected (Python ``float()`` would
    strip it; Go does not), non-ASCII input is rejected (Go parses ASCII
    only; Python ``float()`` would transform Unicode decimal digits like
    ``"١٥"``), and overflow-to-infinity is a range error like Go's
    ``ErrRange``.  Divergence (documented): Go also accepts ``inf`` /
    ``nan`` / hex-float spellings, for which the reference's downstream
    ``int64(float * mult)`` conversion is unspecified — those spellings are
    rejected here instead of reproducing undefined behavior.
    """
    if s != s.strip() or not s.isascii():
        return None
    t = s.lower().lstrip("+-")
    if t.startswith(("inf", "nan")) or t.startswith("0x"):
        return None
    try:
        value = float(s)
    except ValueError:
        return None
    if value in (float("inf"), float("-inf")):
        return None
    return value


@functools.lru_cache(maxsize=_PARSE_CACHE_SIZE)
def to_bytes_reference(s: str) -> int:
    """Byte quantity string → bytes, reference ``bytefmt.ToBytes`` semantics.

    Mirrors ``bytes.go:75-105`` exactly:

    * input is whitespace-trimmed and uppercased, then split at the first
      letter; **no letter → error** (plain ``"1073741824"`` fails);
    * numeric part parsed as float; parse failure or value ≤ 0 → error;
    * suffix table (ALL base-2): ``T|TB|TIB``, ``G|GB|GIB``, ``M|MB|MIB|MI``,
      ``K|KB|KIB|KI``, ``B``; anything else → error.  Note ``MI``/``KI`` are
      accepted but ``GI``/``TI`` are **not** — so a node advertising
      ``"16Gi"`` fails to parse (and the reference then zeroes that node's
      memory, ``ClusterCapacity.go:202-206``);
    * result truncates toward zero: ``int64(value * multiplier)``.

    Raises :class:`QuantityParseError` with the reference's error message.
    """
    # Go's TrimSpace set exactly — not Python's broader str.strip() set.
    s = s.strip(_GO_SPACE_CHARS).upper()

    letter_idx = -1
    for i, ch in enumerate(s):
        if ch.isalpha():
            letter_idx = i
            break
    if letter_idx == -1:
        raise QuantityParseError(_INVALID_BYTE_QUANTITY_MSG)

    num_part, suffix = s[:letter_idx], s[letter_idx:]
    value = _go_parse_float(num_part)
    if value is None or value <= 0:
        raise QuantityParseError(_INVALID_BYTE_QUANTITY_MSG)

    if suffix in ("T", "TB", "TIB"):
        mult = _TIB
    elif suffix in ("G", "GB", "GIB"):
        mult = _GIB
    elif suffix in ("M", "MB", "MIB", "MI"):
        mult = _MIB
    elif suffix in ("K", "KB", "KIB", "KI"):
        mult = _KIB
    elif suffix == "B":
        mult = 1
    else:
        raise QuantityParseError(_INVALID_BYTE_QUANTITY_MSG)

    result = int(value * mult)
    # Go's int64(float64) conversion is unspecified when out of range; on
    # amd64/arm64 it produces math.MinInt64, which is what a node advertising
    # absurd memory would get in the reference.
    if not (-(1 << 63) <= result < (1 << 63)):
        result = -(1 << 63)
    return result


def byte_size(n_bytes: int) -> str:
    """Human-readable byte string, reference ``bytefmt.ByteSize`` semantics.

    Mirrors ``bytes.go:32-58``: largest base-2 unit with value ≥ 1, one
    decimal place with a trailing ``.0`` stripped; ``0`` → ``"0"``.  (Dead
    code in the reference — kept for component-inventory parity, SURVEY §2.1
    C7.)
    """
    value = float(n_bytes)
    if n_bytes >= _TIB:
        unit, value = "T", value / _TIB
    elif n_bytes >= _GIB:
        unit, value = "G", value / _GIB
    elif n_bytes >= _MIB:
        unit, value = "M", value / _MIB
    elif n_bytes >= _KIB:
        unit, value = "K", value / _KIB
    elif n_bytes >= 1:
        unit = "B"
    elif n_bytes == 0:
        return "0"
    else:
        unit = ""
    result = f"{value:.1f}"
    result = result.removesuffix(".0")
    return result + unit


def to_megabytes(s: str) -> int:
    """Parse a byte string and floor-divide to (base-2) megabytes (``bytes.go:61-68``)."""
    return to_bytes_reference(s) // _MIB


# ---------------------------------------------------------------------------
# Strict Kubernetes resource.Quantity grammar
# ---------------------------------------------------------------------------

_BINARY_SUFFIXES = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}

_DECIMAL_SUFFIXES = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 10**3),
    "": Fraction(1),
    "k": Fraction(10**3),
    "M": Fraction(10**6),
    "G": Fraction(10**9),
    "T": Fraction(10**12),
    "P": Fraction(10**15),
    "E": Fraction(10**18),
}


@dataclass(frozen=True)
class Quantity:
    """Exact decimal quantity with Kubernetes round-up integer views.

    ``amount`` is the exact rational value (no float drift).  ``value()`` and
    ``milli_value()`` round **toward +∞** like Kubernetes ``Quantity.Value()``
    / ``MilliValue()`` (e.g. ``"100m".Value() == 1``, ``"1.5Gi".Value() ==
    1610612736``).
    """

    amount: Fraction
    original: str

    def value(self) -> int:
        return _int64_capped(_round_away_from_zero(self.amount))

    def milli_value(self) -> int:
        return _int64_capped(_round_away_from_zero(self.amount * 1000))

    def __float__(self) -> float:
        return float(self.amount)


def _round_away_from_zero(f: Fraction) -> int:
    """Upstream ``Quantity.Value()`` rounding: AWAY from zero, not toward
    +inf — ``"-100m".Value() == -1`` (ceil would give 0)."""
    if f.numerator >= 0:
        return -((-f.numerator) // f.denominator)
    return f.numerator // f.denominator


def _int64_capped(v: int) -> int:
    """Upstream caps values the int64 cannot hold (quantity.go: numbers
    larger than the format represents are capped at MaxInt64) instead of
    erroring — a 16E node serves max capacity, never a crash."""
    if v > _INT64_MAX_Q:
        return _INT64_MAX_Q
    if v < _INT64_MIN_Q:
        return _INT64_MIN_Q
    return v


_INT64_MAX_Q = (1 << 63) - 1
_INT64_MIN_Q = -(1 << 63)


@functools.lru_cache(maxsize=_PARSE_CACHE_SIZE)
def parse_quantity(s: str) -> Quantity:
    """Parse a Kubernetes ``resource.Quantity`` string exactly.

    Grammar: ``<signedNumber><suffix>`` where suffix is a binary SI unit
    (``Ki``..``Ei``, base-2), a decimal SI unit (``n u m k M G T P E`` or
    empty, base-10 — note lowercase ``k``, uppercase ``K`` is invalid), or a
    scientific exponent (``e``/``E`` with optional sign).  Arithmetic is exact
    (:class:`fractions.Fraction`), so ``"0.1"`` is one-tenth, not a float.

    This is the grammar behind ``Quantity.Value()`` that the reference relies
    on for pod memory (``ClusterCapacity.go:285-286``) and allocatable pods
    (``:208``).
    """
    original = s
    # No whitespace trim: upstream ParseQuantity rejects ' 1Gi' outright
    # (first byte must be a sign or digit).
    if not s:
        raise QuantityParseError("empty quantity string")

    sign = 1
    if s[0] in "+-":
        if s[0] == "-":
            sign = -1
        s = s[1:]

    i = 0
    while i < len(s) and (s[i].isdigit() or s[i] == "."):
        i += 1
    num_part, suffix = s[:i], s[i:]
    if not num_part or num_part == "." or num_part.count(".") > 1:
        raise QuantityParseError(f"invalid quantity number: {original!r}")
    if not num_part.replace(".", "").isascii():
        raise QuantityParseError(f"invalid quantity number: {original!r}")

    base = Fraction(num_part)

    if suffix in _BINARY_SUFFIXES:
        mult = Fraction(_BINARY_SUFFIXES[suffix])
    elif suffix in _DECIMAL_SUFFIXES:
        mult = _DECIMAL_SUFFIXES[suffix]
    elif suffix and suffix[0] in "eE":
        exp_str = suffix[1:]
        exp_body = exp_str[1:] if exp_str[:1] in "+-" else exp_str
        if not exp_body.isdigit() or not exp_body.isascii():
            # isascii: int()/isdigit would accept Unicode decimal digits
            # upstream's ASCII scanner rejects.
            raise QuantityParseError(f"invalid quantity exponent: {original!r}")
        exp = int(exp_str)
        # Real quantities span n (1e-9) to E (1e18), but the exponent must
        # not materialize 10**exp for hostile magnitudes.  Clamping is
        # only sound once the MANTISSA's own decimal magnitude is
        # accounted for (len(num_part) bounds it in both directions): with
        # |exp| <= 64 + len the value computes exactly in input-linear
        # space; beyond that bound the true value is provably > int64 max
        # (caps) or < 1 (rounds away from zero to +-1) — the clamped
        # multiplier lands in the same regime, so value()/milli_value()
        # return exactly what upstream's uncapped arithmetic would.
        bound = 64 + len(num_part)
        mult = Fraction(10) ** max(min(exp, bound), -bound)
    else:
        raise QuantityParseError(f"invalid quantity suffix: {original!r}")

    return Quantity(amount=sign * base * mult, original=original)


def cpu_to_milli_strict(s: str) -> int:
    """CPU quantity → millicores with full Kubernetes grammar (``"0.5"`` → 500)."""
    return parse_quantity(s).milli_value()


def mem_to_bytes_strict(s: str) -> int:
    """Memory quantity → bytes with full Kubernetes grammar (``"16Gi"`` parses)."""
    return parse_quantity(s).value()
