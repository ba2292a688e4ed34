"""Adversarial inputs of the exact int64 sweep, numpy only (no JAX), for
the CPU tests (``test_torch_fit.py``: the plain version against the JAX
package, and the kernel's per-cell functions compiled as host code) and
the card tests (``test_torch_gpu.py``: the kernel against the plain
version).

The node columns mix ordinary values with hostile bit patterns: CPU
values with the top bit set, memory headrooms that wrap (to INT64_MIN
among others), and pod counts past the allocatable pods, so that the
reference epilogue's Q1 overwrite goes negative.  The requests hold a CPU
request past INT64_MAX, zero, negative and one-unit requests, and
INT64_MIN memory headroom against a memory request of -1.
"""

import numpy as np

INT64_MIN = -(2**63)
INT64_MAX = 2**63 - 1
MIB = 1 << 20

# (column index, value) rows written over the first nodes, by row.
_ROWS = (
    # CPU: the top bit set on either side of the unsigned compare.
    {0: -1, 3: INT64_MIN},
    {0: INT64_MIN, 3: -1},
    {0: 5, 3: INT64_MAX},
    {0: INT64_MAX, 3: 0},
    {0: -1, 3: 0},
    # Memory headrooms that wrap: to INT64_MIN twice, and past it.
    {1: 0, 4: INT64_MIN},
    {1: INT64_MAX, 4: -1},
    {1: 2**62, 4: -(2**62) - 5},
    {1: INT64_MAX, 4: 0},
    # A fit past the allocatable pods: Q1 overwrites it with ap - pc < 0.
    {0: 10**9, 3: 0, 1: 2**50, 4: 0, 2: 10, 5: 200},
    # ap - pc wraps both ways.
    {2: INT64_MIN, 5: 1},
    {2: INT64_MAX, 5: -1},
)

# (cpu, mem) request pairs every set starts with.
_PAIRS = (
    (100, MIB), (1, 1), (0, 0), (-1, -1), (INT64_MIN, -7),
    (2**62 + 1, 2**62), (-5, INT64_MIN), (123457, 987654321),
    (INT64_MAX, 3), (7, 512 * 10**6), (3, INT64_MAX), (250, -1),
)


def columns(n: int, seed: int) -> list[np.ndarray]:
    """The seven node columns (six int64, ``healthy`` bool) of ``n``
    nodes, the hostile rows first."""
    rng = np.random.default_rng(seed)

    def mixed(lo, hi):
        vals = rng.integers(lo, hi, size=n, dtype=np.int64)
        hostile = rng.random(n) < 0.1
        return np.where(
            hostile, rng.integers(-(2**62), 2**62, size=n, dtype=np.int64),
            vals,
        )

    cols = [
        mixed(0, 10**6), mixed(0, 2**45), rng.integers(0, 200, n),
        mixed(0, 10**6), mixed(0, 2**45), rng.integers(0, 300, n),
        rng.random(n) < 0.8,
    ]
    for i, row in enumerate(_ROWS[:n]):
        for c, v in row.items():
            cols[c][i] = v
    return cols


def requests(s: int, seed: int) -> tuple[np.ndarray, ...]:
    """``(cpu, mem, replicas)`` int64 for ``s`` scenarios: the edge pairs
    first, then requests drawn with one in ten an edge value."""
    rng = np.random.default_rng(seed)
    edge_cpu = np.array([p[0] for p in _PAIRS], np.int64)
    edge_mem = np.array([p[1] for p in _PAIRS], np.int64)
    cpu = rng.integers(1, 5000, s, dtype=np.int64)
    mem = rng.integers(64, 8192, s, dtype=np.int64) * 10**6
    pick = rng.random(s) < 0.1
    cpu = np.where(pick, rng.choice(edge_cpu, s), cpu)
    mem = np.where(pick, rng.choice(edge_mem, s), mem)
    k = min(s, len(_PAIRS))
    cpu[:k], mem[:k] = edge_cpu[:k], edge_mem[:k]
    reps = rng.integers(-5, 3000, s, dtype=np.int64)
    return cpu, mem, reps


def counts(n: int, seed: int) -> np.ndarray:
    """Node-shape multiplicities: zeros, ones, a weight whose products
    wrap and a negative one, among draws up to 2^40."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 2**40, n, dtype=np.int64)
    out[rng.random(n) < 0.2] = 0
    out[:4] = [0, 1, 2**62, -3][:n]
    return out


def mask(n: int, seed: int, *, every_masked: bool = False) -> np.ndarray:
    """A bool node mask, about 70% True, or every node masked out."""
    if every_masked:
        return np.zeros(n, dtype=bool)
    return np.random.default_rng(seed).random(n) < 0.7


def zones(n: int, n_zones: int, seed: int, *,
          empty_zone: bool = False) -> np.ndarray:
    """Int64 topology-domain codes of ``n`` nodes for the zone spread:
    ``1..n_zones`` round-robin as a zoned cluster labels them, and about
    one node in eight in no domain (0); with ``empty_zone`` the last
    domain keeps no node."""
    rng = np.random.default_rng(seed)
    out = np.arange(n, dtype=np.int64) % n_zones + 1
    out[rng.random(n) < 0.125] = 0
    if empty_zone:
        out[out == n_zones] = 0
    return out


#: ``max_skew`` values of the zone spread: the usual 1 and 2, and one
#: whose add to a domain's sum wraps.
SKEWS = (1, 2, 2**62)

#: The sweep's variants: no mask, a mask, every node masked, and counts.
VARIANTS = ("flat", "masked", "every-masked", "grouped")
#: ``(N, S)`` of the card tests: a scenario alone, a block and one more,
#: a fold of 32 requests of 1,000, no nodes and no scenarios.
KERNEL_SHAPES = ((4099, 1), (4099, 257), (600, 32_000), (0, 7), (300, 0))


def case(variant: str, n: int, s: int, seed: int):
    """``(cols, cpu, mem, reps, mask, counts)`` of one sweep: ``mask`` is
    None but for the masked variants, ``counts`` None but for
    ``grouped``."""
    cols = columns(n, seed)
    cpu, mem, reps = requests(s, seed + 1)
    node_mask = node_counts = None
    if variant in ("masked", "every-masked"):
        node_mask = mask(n, seed + 2, every_masked=variant == "every-masked")
    if variant == "grouped":
        node_counts = counts(n, seed + 3)
    return cols, cpu, mem, reps, node_mask, node_counts
