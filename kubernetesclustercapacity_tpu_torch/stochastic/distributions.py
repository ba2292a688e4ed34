"""Per-pod usage distributions: the vocabulary behind capacity-at-risk.

Counterpart of ``kubernetesclustercapacity_tpu/stochastic/distributions.py``:
the grammar is the JAX module's, verbatim, and the sampler is rewritten in
PyTorch on an explicit device, drawing the JAX package's samples bit for
bit.

Point requests are fiction in production — a pod's *request* is a
planning number, its *usage* a random variable.  This module gives that
variable a small, validated vocabulary:

* ``point``     — the degenerate distribution (the classic fixed request);
* ``normal``    — ``round(mean + std·Z)``, clamped to the sane usage
  domain ``[1, 2^62]`` (a usage sample must be a valid kernel divisor);
* ``lognormal`` — ``round(exp(ln(mean) + sigma·Z))``, the heavy-tailed
  shape real CPU usage exhibits, same clamp;
* ``empirical`` — an explicit value/weight histogram, e.g. extracted
  from the audit log's recorded generations (:mod:`.history`).

Specs load through the same YAML/JSON grammar as every other operator
file, with quantity strings parsed by the reference codecs (``500m`` CPU,
``1gb`` memory).

Sampling is deterministic and counter-based: threefry-2x32 keyed by an
explicit integer seed, never wall-clock state, so a run replays bit for
bit.  The draws equal ``jax.random``'s under the partitionable bit layout
(the JAX package's), sample for sample:

* the threefry rounds run in int64 arithmetic masked to 32 bits (torch has
  no uint32 arithmetic on every op), on ``device``;
* the f64 uniform is the bit construction ``jax.random.uniform`` uses
  (52 random mantissa bits under the exponent of 1.0, minus 1), exact;
* normal and lognormal replay, operation for operation, the program XLA's
  CPU compiler emits for ``sqrt(2)·erf_inv(u)`` (Giles' three-branch
  polynomial), ``mean + std·z`` and ``exp``: the same constants, the same
  order, and a fused multiply-add wherever that compiler fuses one.  Torch
  has no FMA op, so :func:`_fma` emulates one exactly (Dekker's product and
  a sum rounded to odd, Boldo and Melquiond 2008) from additions and
  products, which round the same on the CPU and the card;
* the one libm call of that program, ``log`` in ``log1p``'s far branch, is
  the C library's: it runs on the host (``math.log``) whatever ``device``
  is, because the card's ``log`` is not glibc's and a seeded answer must
  replay on either.  Everything else runs on ``device``.

``torch.special.erfinv``, ``torch.log1p`` and ``torch.exp`` are not used:
each rounds differently from the program above in a fraction of the draws,
and one differing sample can move a capacity quantile.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from kubernetesclustercapacity_tpu_torch import devcache as _devcache
from kubernetesclustercapacity_tpu_torch.utils.quantity import (
    QuantityParseError,
    cpu_parse_error_payload,
    cpu_to_milli_reference,
    to_bytes_reference,
)

__all__ = [
    "DIST_KINDS",
    "DistributionError",
    "MAX_USAGE",
    "StochasticSpec",
    "UsageDistribution",
    "default_samples",
    "load_stochastic_spec",
    "parse_distribution",
    "parse_stochastic_spec",
    "sample_key",
    "sample_usage",
]

DIST_KINDS = ("point", "normal", "lognormal", "empirical")

#: Usage samples live in ``[1, MAX_USAGE]``: 0 would divide-by-zero the
#: reference kernel (SURVEY.md §2.4 Q8) and anything past 2^62 pushes
#: the int64 carrier into wrap territory — not a usage observation.
MAX_USAGE = 1 << 62

#: Default Monte Carlo sample count when a spec does not pin one
#: (``KCCAP_CAR_SAMPLES`` overrides process-wide).
DEFAULT_SAMPLES = 64

_MAX_SAMPLES = 1 << 16


class DistributionError(ValueError):
    """Malformed usage-distribution spec (bad kind, bad quantity, bad
    weights) — the watchlist-grammar analog of ``WatchError``."""


def default_samples() -> int:
    """The process default sample count (``KCCAP_CAR_SAMPLES``, else 64).

    Read per evaluation (host-side only — never inside jitted code) so
    the escape hatch works without a restart; junk values fall back to
    the built-in default rather than failing an evaluation.
    """
    try:
        env = int(os.environ.get("KCCAP_CAR_SAMPLES", "0"))
    except ValueError:
        env = 0
    return env if 2 <= env <= _MAX_SAMPLES else DEFAULT_SAMPLES


@dataclass(frozen=True)
class UsageDistribution:
    """One resource's per-pod usage distribution (validated, immutable).

    Only the fields of the active ``kind`` are meaningful; units are
    the kernel's native integers (millicores / bytes).
    """

    kind: str
    value: int = 0  # point
    mean: float = 0.0  # normal / lognormal (native units)
    std: float = 0.0  # normal
    sigma: float = 0.0  # lognormal (log-space std)
    values: tuple[int, ...] = ()  # empirical
    weights: tuple[float, ...] = ()  # empirical (same length as values)

    @property
    def degenerate(self) -> bool:
        """True when every sample is the same value — a point request in
        disguise, for which every capacity quantile equals the plain fit."""
        if self.kind == "point":
            return True
        if self.kind == "normal":
            return self.std == 0.0
        if self.kind == "lognormal":
            return self.sigma == 0.0
        return len(set(self.values)) <= 1

    def to_wire(self) -> dict:
        """JSON-able description (rides watch/op wire shapes)."""
        out: dict = {"dist": self.kind}
        if self.kind == "point":
            out["value"] = self.value
        elif self.kind == "normal":
            out.update(mean=self.mean, std=self.std)
        elif self.kind == "lognormal":
            out.update(mean=self.mean, sigma=self.sigma)
        else:
            out.update(values=list(self.values), weights=list(self.weights))
        return out


@dataclass(frozen=True)
class StochasticSpec:
    """A full capacity-at-risk question: usage distributions + target.

    ``samples=0`` means "the process default" (:func:`default_samples`),
    resolved at evaluation time; ``confidence`` is the schedulability
    bar ``kccap -car-spec`` exits by (``P(fit) >= confidence``).
    """

    cpu: UsageDistribution
    memory: UsageDistribution
    replicas: int = 1
    samples: int = 0
    seed: int = 0
    confidence: float = 0.95

    def n_samples(self) -> int:
        return self.samples if self.samples else default_samples()

    def to_wire(self) -> dict:
        return {
            "usage": {"cpu": self.cpu.to_wire(), "memory": self.memory.to_wire()},
            "replicas": self.replicas,
            "samples": self.n_samples(),
            "seed": self.seed,
            "confidence": self.confidence,
        }


# -- grammar ---------------------------------------------------------------

def _quantity(resource: str, v, *, field: str) -> int:
    """One quantity: a string through the reference codecs (``500m`` /
    ``1gb``) or a plain number in native units (millicores / bytes)."""
    if isinstance(v, bool):
        raise DistributionError(f"{field}: expected a quantity, got {v!r}")
    if isinstance(v, (int, float)):
        if isinstance(v, float) and not v.is_integer():
            raise DistributionError(
                f"{field}: native-unit quantities must be integers, got {v!r}"
            )
        return int(v)
    if not isinstance(v, str):
        raise DistributionError(f"{field}: expected a quantity, got {v!r}")
    if resource == "cpu":
        # The reference codec zeroes unparseable values (printing a
        # payload); a distribution parameter must fail loudly instead.
        if cpu_parse_error_payload(v) is not None:
            raise DistributionError(f"{field}: bad cpu quantity {v!r}")
        return cpu_to_milli_reference(v)
    try:
        return to_bytes_reference(v)
    except QuantityParseError as e:
        raise DistributionError(f"{field}: bad memory quantity {v!r}: {e}") from e


def _usage_value(resource: str, v, *, field: str) -> int:
    q = _quantity(resource, v, field=field)
    if not 1 <= q <= MAX_USAGE:
        raise DistributionError(
            f"{field}: usage must be in [1, 2^62], got {q}"
        )
    return q


def _number(v, *, field: str, minimum: float | None = None) -> float:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise DistributionError(f"{field}: expected a number, got {v!r}")
    f = float(v)
    if not math.isfinite(f):
        raise DistributionError(f"{field}: must be finite, got {v!r}")
    if minimum is not None and f < minimum:
        raise DistributionError(f"{field}: must be >= {minimum:g}, got {v!r}")
    return f


def parse_distribution(resource: str, data) -> UsageDistribution:
    """One ``{dist: ..., ...}`` block → a validated distribution.

    ``resource`` (``"cpu"``/``"memory"``) selects the quantity codec.
    A bare quantity (string or int) is shorthand for a point
    distribution at that value.
    """
    field = f"usage.{resource}"
    if isinstance(data, (str, int)) and not isinstance(data, bool):
        return UsageDistribution(
            kind="point", value=_usage_value(resource, data, field=field)
        )
    if not isinstance(data, dict):
        raise DistributionError(
            f"{field}: expected a distribution mapping, got {data!r}"
        )
    kind = data.get("dist")
    if kind not in DIST_KINDS:
        raise DistributionError(
            f"{field}: dist must be one of {DIST_KINDS}, got {kind!r}"
        )
    known = {"point": {"dist", "value"},
             "normal": {"dist", "mean", "std"},
             "lognormal": {"dist", "mean", "sigma"},
             "empirical": {"dist", "values", "weights"}}[kind]
    extra = set(data) - known
    if extra:
        raise DistributionError(
            f"{field}: unknown field(s) {sorted(extra)} for dist "
            f"{kind!r} (want {sorted(known - {'dist'})})"
        )
    if kind == "point":
        if "value" not in data:
            raise DistributionError(f"{field}: point needs 'value'")
        return UsageDistribution(
            kind="point",
            value=_usage_value(resource, data["value"], field=f"{field}.value"),
        )
    if kind == "normal":
        if "mean" not in data:
            raise DistributionError(f"{field}: normal needs 'mean'")
        mean = float(
            _usage_value(resource, data["mean"], field=f"{field}.mean")
        )
        std = (
            float(_quantity(resource, data["std"], field=f"{field}.std"))
            if isinstance(data.get("std"), str)
            else _number(data.get("std", 0), field=f"{field}.std", minimum=0.0)
        )
        return UsageDistribution(kind="normal", mean=mean, std=std)
    if kind == "lognormal":
        if "mean" not in data:
            raise DistributionError(f"{field}: lognormal needs 'mean'")
        mean = float(
            _usage_value(resource, data["mean"], field=f"{field}.mean")
        )
        sigma = _number(
            data.get("sigma", 0), field=f"{field}.sigma", minimum=0.0
        )
        if sigma > 4.0:
            raise DistributionError(
                f"{field}.sigma: must be <= 4 (exp(4σ) already exceeds "
                f"any sane usage spread), got {sigma:g}"
            )
        return UsageDistribution(kind="lognormal", mean=mean, sigma=sigma)
    # empirical
    raw_values = data.get("values")
    if not isinstance(raw_values, list) or not raw_values:
        raise DistributionError(
            f"{field}: empirical needs a non-empty 'values' list"
        )
    values = tuple(
        _usage_value(resource, v, field=f"{field}.values[{i}]")
        for i, v in enumerate(raw_values)
    )
    raw_weights = data.get("weights")
    if raw_weights is None:
        weights = tuple(1.0 for _ in values)
    else:
        if not isinstance(raw_weights, list) or len(raw_weights) != len(values):
            raise DistributionError(
                f"{field}: weights must be a list the length of values"
            )
        weights = tuple(
            _number(w, field=f"{field}.weights[{i}]")
            for i, w in enumerate(raw_weights)
        )
        if any(w <= 0 for w in weights):
            raise DistributionError(f"{field}: weights must be > 0")
    return UsageDistribution(kind="empirical", values=values, weights=weights)


def parse_stochastic_spec(data) -> StochasticSpec:
    """A spec document/wire body → :class:`StochasticSpec`.

    Shape::

        usage:
          cpu:    {dist: normal, mean: 500m, std: 150m}
          memory: {dist: lognormal, mean: 1gb, sigma: 0.4}
        replicas: "40"        # reference grammar (or a plain int)
        samples: 256          # optional; default KCCAP_CAR_SAMPLES/64
        seed: 7               # optional; explicit, never wall-clock
        confidence: 0.95      # optional; the -car-spec exit bar
    """
    if not isinstance(data, dict):
        raise DistributionError(f"spec: expected a mapping, got {data!r}")
    extra = set(data) - {"usage", "replicas", "samples", "seed", "confidence"}
    if extra:
        raise DistributionError(f"spec: unknown field(s) {sorted(extra)}")
    usage = data.get("usage")
    if not isinstance(usage, dict):
        raise DistributionError("spec: needs a 'usage' mapping")
    extra = set(usage) - {"cpu", "memory"}
    if extra:
        raise DistributionError(
            f"usage: unknown resource(s) {sorted(extra)} (want cpu/memory)"
        )
    if "cpu" not in usage or "memory" not in usage:
        raise DistributionError("usage: needs both 'cpu' and 'memory'")
    cpu = parse_distribution("cpu", usage["cpu"])
    memory = parse_distribution("memory", usage["memory"])
    replicas = data.get("replicas", 1)
    if isinstance(replicas, str):
        try:
            replicas = int(replicas)
        except ValueError:
            raise DistributionError(f"spec: bad replicas {data['replicas']!r}")
    if isinstance(replicas, bool) or not isinstance(replicas, int):
        raise DistributionError(f"spec: bad replicas {data['replicas']!r}")
    samples = data.get("samples", 0)
    if isinstance(samples, bool) or not isinstance(samples, int):
        raise DistributionError("spec: samples must be an integer")
    if samples and not 2 <= samples <= _MAX_SAMPLES:
        raise DistributionError(
            f"spec: samples must be in [2, {_MAX_SAMPLES}], got {samples}"
        )
    seed = data.get("seed", 0)
    if isinstance(seed, bool) or not isinstance(seed, int):
        raise DistributionError("spec: seed must be an integer")
    confidence = _number(
        data.get("confidence", 0.95), field="spec.confidence"
    )
    if not 0.0 < confidence < 1.0:
        raise DistributionError(
            f"spec: confidence must be in (0, 1), got {confidence:g}"
        )
    return StochasticSpec(
        cpu=cpu,
        memory=memory,
        replicas=replicas,
        samples=samples,
        seed=seed,
        confidence=confidence,
    )


def load_stochastic_spec(path: str) -> StochasticSpec:
    """Load ``path`` (YAML when PyYAML is present, else strict JSON) —
    the same loader split as the watchlist's."""
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    try:
        import yaml  # type: ignore[import-untyped]

        data = yaml.safe_load(text)
    except ImportError:
        try:
            data = json.loads(text)
        except ValueError as e:
            raise DistributionError(
                f"{path}: not valid JSON (and PyYAML is unavailable): {e}"
            ) from e
    except Exception as e:  # yaml.YAMLError — malformed document
        raise DistributionError(f"{path}: cannot parse: {e}") from e
    return parse_stochastic_spec(data)


# -- the deterministic sampler ---------------------------------------------
#
# Keys are ``(k0, k1)`` pairs of uint32 values held in Python ints (or any
# 2-element array of them).  Tensors of uint32 values are int64, masked to
# 32 bits after every addition and shift.

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3FF0000000000000  # the bit pattern of 1.0


def _threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pair ``(x0, x1)`` — Python
    ints or int64 tensors of uint32 values — under the key ``(k0, k1)``."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _key_pair(key) -> tuple[int, int]:
    k0, k1 = (int(k) for k in key)
    if not (0 <= k0 <= _M32 and 0 <= k1 <= _M32):
        raise ValueError(f"a key is two uint32 values, got {key!r}")
    return k0, k1


def sample_key(seed: int, stream: int) -> tuple[int, int]:
    """The counter-based key for one (seed, stream) draw: an explicit
    integer seed folded with the stream index (cpu=0, memory=1), so two
    resources of one spec never share a sample sequence and every run
    with the same seed replays the identical draws.

    ``jax.random.fold_in(jax.random.PRNGKey(seed), stream)``: the seed's
    int64 bits split into (high, low) words, then one threefry hash of the
    counter ``(0, stream)``.
    """
    seed = int(seed)
    if not -(1 << 63) <= seed < (1 << 63):
        raise OverflowError(f"seed {seed} does not fit in int64")
    bits = seed & ((1 << 64) - 1)
    return _threefry2x32(bits >> 32, bits & _M32, 0, int(stream) & _M32)


def _uniform01(key, n: int, device: torch.device) -> torch.Tensor:
    """``[n]`` float64 in ``[0, 1)``: ``jax.random.uniform``'s construction
    over the partitionable 64-bit stream (counter ``(0, i)``, high word
    first), the top 52 bits under the exponent of 1.0, minus 1."""
    k0, k1 = _key_pair(key)
    count = torch.arange(n, dtype=torch.int64, device=device)
    hi, lo = _threefry2x32(k0, k1, torch.zeros_like(count), count)
    bits = (hi << 20) | (lo >> 12) | _ONE_BITS
    return bits.view(torch.float64) - 1.0


# Exact fused multiply-add from correctly rounded additions and products.

_SPLITTER = 134217729.0  # 2^27 + 1, Veltkamp's splitting constant


def _two_sum(a, b):
    """``(s, e)`` with ``s = RN(a + b)`` and ``a + b == s + e`` exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    c = a * _SPLITTER
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """``(p, e)`` with ``p = RN(a·b)`` and ``a·b == p + e`` exactly (Dekker;
    exact away from overflow and underflow, which these operands never
    approach)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _round_odd_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` rounded to odd: the exact sum when it is a double, else
    whichever neighbour of it has an odd last mantissa bit."""
    s, e = _two_sum(a, b)
    inexact_even = (e != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(e > 0, torch.full_like(s, math.inf), -math.inf)
    return torch.where(inexact_even, torch.nextafter(s, toward), s)


def _fma(a, b, c) -> torch.Tensor:
    """``RN(a·b + c)`` with one rounding (Boldo and Melquiond's emulated FMA:
    the exact product, two exact sums, the low parts rounded to odd, one
    final rounding to nearest).  At least one operand is a tensor."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, ul)
    vh, vl = _two_sum(uh, th)
    return vh + _round_odd_sum(tl, vl)


def _hex(s: str) -> float:
    return float.fromhex(s)


# XLA's f64 log1p: a rational approximation near 0, log(1 + y) beyond.
_LOG1P_SMALL = _hex("0x1.a827999fcef32p-2")  # sqrt(2) - 1
_LOG1P_NUM = tuple(map(_hex, (
    "0x1.e20359e903e37p+3", "0x1.4c30b52213498p+6", "0x1.bb86590fcfb56p+7",
    "0x1.351945dc908a5p+8", "0x1.b0db13e48e066p+7", "0x1.e0f304466448ep+5",
)))
_LOG1P_DEN_LEAD = _hex("0x1.7bc0962b395cap-15")
_LOG1P_DEN = tuple(map(_hex, (
    "0x1.fe818a0fe1a83p-2", "0x1.a509f46f4fa53p+2", "0x1.de9738b8cb9c9p+4",
    "0x1.e798eb86c3351p+5", "0x1.c8e7597479a10p+5", "0x1.40a202d99830ap+4",
)))

# XLA's f64 erf_inv (Giles): per coefficient, its value for w < 6.25, for
# w < 16 and beyond; the last six have fewer branches.
_ERFINV_COEF = tuple(
    tuple(map(_hex, row)) for row in (
        ("-0x1.135d2e746e627p-68", "0x1.3040f87dbd932p-29", "-0x1.dcec3a7785389p-36"),
        ("-0x1.8ddf93324d327p-63", "0x1.85cbe52878635p-24", "-0x1.18feec0e38727p-32"),
        ("0x1.7b83eef0b7c9fp-60", "-0x1.2777453dd3955p-22", "0x1.9e6bf2dda45e3p-30"),
        ("0x1.9ba72cd589b91p-57", "0x1.395abcd554c6cp-26", "-0x1.0468fb24e2f5fp-28"),
        ("-0x1.33689090a6b96p-53", "0x1.936388a3790adp-20", "0x1.05ac6a8fba182p-27"),
        ("0x1.82e11898132e0p-56", "-0x1.0d5db812b5083p-18", "-0x1.0102e495fb9c0p-26"),
        ("0x1.de4acfd9e26bap-48", "0x1.8860cd5d652f6p-19", "0x1.f4c20e1334af8p-26"),
        ("-0x1.6d33eed66c487p-45", "0x1.a29a0cacdfb23p-17", "-0x1.22d220fdf9c3ep-24"),
        ("-0x1.6f2167040d8e2p-44", "-0x1.8cef1f80281f2p-15", "0x1.ebc8bb824cb54p-23"),
        ("0x1.72a22c2d77e20p-39", "0x1.1e684d0b9188ap-14", "-0x1.0a8d40ea372ccp-20"),
        ("-0x1.c8859c4e5c0afp-37", "0x1.932cd54c8a222p-16", "0x1.2fbd29d093d2bp-18"),
        ("-0x1.dc583d118a561p-35", "-0x1.7448a89ef8aa3p-12", "-0x1.4a3497e1e0facp-16"),
        ("0x1.20f47ccf46b3cp-30", "0x1.f3cc55ad40c25p-11", "0x1.3ebf4eb00938fp-14"),
        ("-0x1.1a9e38dc84d60p-28", "-0x1.ba924132f38b1p-10", "-0x1.c2f36a8fc5d53p-13"),
        ("-0x1.f36cd6d3d46a9p-26", "0x1.468eeca533cf8p-9", "-0x1.22ea5df04047cp-13"),
        ("0x1.c6b4f5d03b787p-22", "-0x1.ebadabb891bbdp-9", "0x1.02a30d1fba0dcp+0"),
        ("-0x1.6e8a5434ae8a2p-20", "0x1.5ffcfe5b76afcp-8", "0x1.3664ddd1ad7fbp+2"),
        ("-0x1.d1d1f7b8736f6p-17", "0x1.0158a6d641d39p+0"),
        ("0x1.879c2a212f024p-13", "0x1.8abcc380d5a48p+1"),
        ("-0x1.845769484fca8p-11",),
        ("-0x1.8b6c33114f909p-8",),
        ("0x1.ebd80d9b13e28p-3",),
        ("0x1.a755e7c99ae86p+0",),
    )
)

# XLA's f64 exp: clamp, n = floor(x·log2(e) + 1/2), a two-part Cody-Waite
# reduction, a Padé-style rational on g², and a three-step scale by 2^n.
_EXP_LO = _hex("-0x1.6232bdd7abcd2p+9")
_EXP_HI = _hex("0x1.62e42fefa39efp+9")
_LOG2E = _hex("0x1.71547652b82fep+0")
_LN2_HI = _hex("0x1.62e4000000000p-1")
_LN2_LO = _hex("0x1.7f7d1cf79abcap-20")
_EXP_P = (_hex("0x1.089cdd5e44be8p-13"), _hex("0x1.f06d10cca2c7ep-6"))
_EXP_Q = (
    _hex("0x1.92eb6bc365fa0p-19"), _hex("0x1.4ae39b508b6c0p-9"),
    _hex("0x1.d17099887e074p-3"),
)
_SQRT2 = _hex("0x1.6a09e667f3bcdp+0")
_LIMIT = float(1 << 62)


def _host_log(t: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """The C library's ``log`` of ``t`` on ``lanes`` (0 elsewhere), computed
    on the host one value at a time: the libm call XLA's program makes."""
    t_host = t.cpu()
    lanes_host = lanes.cpu()
    out = torch.zeros_like(t_host)
    out[lanes_host] = torch.tensor(
        [math.log(v) for v in t_host[lanes_host].tolist()],
        dtype=torch.float64,
    )
    return out.to(t.device)


def _log1p(y: torch.Tensor) -> torch.Tensor:
    far = y.abs() >= _LOG1P_SMALL
    one_plus = y + 1.0
    big = _host_log(one_plus, far)
    y2 = y * y
    y0 = y * 0.0
    num = y0 + 1.0
    for c in _LOG1P_NUM:
        num = _fma(num, y, c)
    den = y0 + _LOG1P_DEN_LEAD
    for c in _LOG1P_DEN:
        den = _fma(den, y, c)
    small = y + _fma(y2, -0.5, (y * y2) * (den / num))
    return torch.where(far, big, small)


def _erfinv_times(x: torch.Tensor) -> torch.Tensor:
    """``erf_inv(x)`` as XLA computes it, for ``x`` in ``(-1, 1)``."""
    neg_w = _log1p(x * (-x))  # -w
    lt_625 = neg_w > -6.25
    lt_16 = neg_w > -16.0
    w = torch.where(
        lt_625,
        -3.125 - neg_w,
        torch.sqrt(-neg_w) - torch.where(lt_16, torch.full_like(x, 3.25), 5.0),
    )

    def coef(row):
        c = torch.where(lt_625, torch.full_like(x, row[0]), row[1])
        return torch.where(lt_16, c, row[2]) if len(row) > 2 else c

    p = coef(_ERFINV_COEF[0])
    for row in _ERFINV_COEF[1:17]:
        p = _fma(p, w, coef(row))
    tail = p
    for row in _ERFINV_COEF[17:19]:
        p = torch.where(lt_16, _fma(p, w, coef(row)), tail)
    mid = p
    for row in _ERFINV_COEF[19:]:
        p = torch.where(lt_625, _fma(p, w, row[0]), mid)
    p = torch.where(x.abs() == 1.0, math.inf, p)
    return x * p


def _exp(v: torch.Tensor) -> torch.Tensor:
    """``exp(v)`` as XLA's CPU program computes it (finite ``v``; the
    caller handles the clamped tails)."""
    xc = torch.clamp(v, _EXP_LO, _EXP_HI)
    n = torch.floor(_fma(xc, _LOG2E, 0.5))
    g = _fma(n, -_LN2_HI, xc)
    g = _fma(n, -_LN2_LO, g)
    g2 = g * g
    pg = _fma(_fma(g2, _EXP_P[0], _EXP_P[1]), g2, 1.0) * g
    q = _fma(g2, _EXP_Q[0], _EXP_Q[1])
    q = _fma(q, g2, _EXP_Q[2])
    q = _fma(q, g2, 2.0)
    e = (pg / (q - pg)) * 2.0 + 1.0
    ni = n.to(torch.int64).clamp(-2099, 2099)
    b = ni >> 2
    s1 = ((b + 1023) << 52).view(torch.float64)
    s2 = ((ni - 3 * b + 1023) << 52).view(torch.float64)
    return e * s1 * s1 * s1 * s2


def _normal01_scaled(key, n: int, scale: float, shift: float, device):
    """``shift + scale·sqrt(2)·erf_inv(u)`` for ``u`` uniform on
    ``[nextafter(-1, 0), 1)``, with XLA's roundings: the product
    ``scale·sqrt(2)`` first, then one fused multiply-add."""
    lo = math.nextafter(-1.0, 0.0)
    u = torch.clamp(_uniform01(key, n, device) * 2.0 + lo, min=lo)
    return _fma(float(scale) * _SQRT2, _erfinv_times(u), float(shift))


def _to_usage(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(v), 1.0, _LIMIT).to(torch.int64)


def sample_usage(
    dist: UsageDistribution, n: int, key, *, device="cuda"
) -> np.ndarray:
    """Draw ``n`` usage samples — ``[n]`` int64 in ``[1, 2^62]`` — equal to
    the JAX package's ``sample_usage(dist, n, key)`` for the same key.

    Deterministic in ``(dist, n, key)`` and the same on every device; the
    draws run on ``device`` (default ``"cuda"``, which raises when no card
    is present) apart from the one ``log`` the module docstring names.
    Returns numpy (one device→host copy).
    """
    if n < 1:
        raise ValueError(f"need at least 1 sample, got {n}")
    device = _devcache.resolve_device(device)
    if dist.kind == "point":
        return np.full(n, dist.value, dtype=np.int64)
    if dist.kind == "normal":
        out = _to_usage(_normal01_scaled(key, n, dist.std, dist.mean, device))
    elif dist.kind == "lognormal":
        v = _normal01_scaled(key, n, dist.sigma, math.log(dist.mean), device)
        out = _to_usage(_exp(v))
        out = torch.where(v < _EXP_LO, 1, out)
        out = torch.where(v > _EXP_HI, 1 << 62, out)
    else:
        weights = np.asarray(dist.weights, dtype=np.float64)
        cdf = torch.from_numpy(np.cumsum(weights) / weights.sum()).to(device)
        values = torch.tensor(dist.values, dtype=torch.int64, device=device)
        idx = torch.searchsorted(cdf, _uniform01(key, n, device), right=True)
        out = values[idx.clamp(0, values.shape[0] - 1)]
    return out.cpu().numpy()
