"""The per-cell arithmetic of the rcp variants of kernels B1 and B2
(``csrc/sweep_fit.cu``, ``csrc/sweep_multi.cu``), emulated bit for bit in
numpy float32 and wrapping int32, against exact ``//``.

numpy's float32 multiply and add round to nearest even, as ``__fmul_rn``
and ``__fadd_rn`` do on the card, and ``astype(float32)`` rounds an int32 to
nearest as ``__int2float_rn`` does, so the emulation computes what the
kernels compute.  Per cell and scenario: ``m = min_r RN(hf_r * rc_r)`` with
inactive rows (request 0) carrying a NaN reciprocal that ``fmin`` ignores,
and row 0 a reciprocal of 0 where no row is active; ``f`` = the bits of
``RN(m + 0x1.8p23)`` minus 0x4B400000 (or minus the all-inactive bias,
which gives INT32_MAX); then ``f - 1`` where the OR of the wrapping rems
``h_r - f * q_r`` is negative.  B1 is the R = 2 case with both rows
active.  No GPU and no JAX.
"""

import numpy as np
import pytest
import torch

from kubernetesclustercapacity_tpu_torch.ops import fused_fit as ff
from kubernetesclustercapacity_tpu_torch.ops import fused_multi as fm

I32_MAX = np.iinfo(np.int32).max
MAGIC = np.float32(12582912.0)  # 0x1.8p23
MAGIC_BITS = np.int32(0x4B400000)
# 0x4B400000 minus INT32_MAX, wrapped: the bias of a scenario with no
# active row (its m is 0).
NONE_BIAS = np.array([0x4B400000 - I32_MAX], dtype=np.int64).astype(np.int32)[0]


def staged(alloc, used):
    """What a block stages per node: h = max(alloc - used, 0) (wrapping
    int32) and its float32."""
    h = np.maximum(np.asarray(alloc, np.int32) - np.asarray(used, np.int32), 0)
    return h, h.astype(np.float32)


def kernel_fits(h, hf, q, rc):
    """The rcp fit of every (scenario, node) cell, ``[S, N]`` int32, as the
    kernels compute it.  ``h``/``hf`` ``[R, N]``; ``q`` int32 ``[R, S]``;
    ``rc`` float32 ``[R, S]`` (reciprocals of ``max(q, 1)``)."""
    active = q > 0
    qa = np.where(active, q, 0).astype(np.int32)
    rca = np.where(active, rc, np.float32(np.nan)).astype(np.float32)
    rca[0] = np.where(active.any(axis=0), rca[0], np.float32(0))
    m = hf[0][None, :] * rca[0][:, None]
    for r in range(1, h.shape[0]):
        m = np.fmin(m, hf[r][None, :] * rca[r][:, None])
    assert m.dtype == np.float32
    bias = np.where(active.any(axis=0), MAGIC_BITS, NONE_BIAS).astype(np.int32)
    f = (m + MAGIC).view(np.int32) - bias[:, None]
    rems = np.zeros_like(f)
    for r in range(h.shape[0]):
        rems |= h[r][None, :] - f * qa[r][:, None]
    return f - (rems < 0).astype(np.int32), m


def exact_fits(h, q):
    """min over active rows of h // q, INT32_MAX with no active row."""
    h64, q64 = h.astype(np.int64), q.astype(np.int64)
    fit = np.full((q.shape[1], h.shape[1]), I32_MAX, dtype=np.int64)
    for r in range(h.shape[0]):
        quo = h64[r][None, :] // np.maximum(q64[r], 1)[:, None]
        fit = np.where((q64[r] > 0)[:, None], np.minimum(fit, quo), fit)
    return fit


def check(alloc, used, q):
    """The emulated kernel equals exact ``//`` in every cell, and its
    rounded estimate is the fit or one above it (never below)."""
    q = np.asarray(q, dtype=np.int32)
    h, hf = staged(alloc, used)
    rc = ff.scenario_reciprocals(np.maximum(q, 1))
    got, m = kernel_fits(h, hf, q, rc)
    want = exact_fits(h, q)
    np.testing.assert_array_equal(got.astype(np.int64), want)
    some = (q > 0).any(axis=0)
    step = np.rint(m[some]).astype(np.int64) - want[some]
    assert set(np.unique(step)) <= {0, 1}


def _b1_edges():
    """chip_smoke.py's rcp_edge_data, as [2, N] rows: dividends on and one
    off multiples of the divisor at the largest eligible quotient (2^20),
    and the wrapping fixup product (dividend INT32_MAX, divisor 2^29)."""
    q, d_cpu, d_mem, n = 1 << 20, 997, 1031, 64
    boundary = np.stack([
        [q * d_cpu, q * d_cpu - 1, q * d_cpu + 1, (q - 1) * d_cpu] * (n // 4),
        [q * d_mem, q * d_mem - 1, q * d_mem + 1, (q - 1) * d_mem] * (n // 4),
    ])
    wrap = np.stack([np.full(n, I32_MAX), np.full(n, 1 << 20)])
    return [(boundary, [[d_cpu], [d_mem]]), (wrap, [[1 << 29], [1]])]


def _b2_edges():
    """chip_smoke.py's multi_edge_rows: the same dividends on two rows with
    inactive rows and all-inactive scenarios among the requests."""
    (boundary, _), (wrap, _) = _b1_edges()
    d0, d1 = 997, 1031
    return [
        (boundary, np.array([[d0, d1], [d0 + 1, d1], [d0, 0], [0, d1],
                             [0, 0]]).T),
        (wrap, np.array([[1 << 29, 1], [(1 << 29) - 1, 1], [1 << 29, 0],
                         [0, 0]]).T),
    ]


@pytest.mark.parametrize(
    "case", range(4), ids=["b1-boundary", "b1-wrap", "b2-boundary", "b2-wrap"])
def test_edge_inputs(case):
    alloc, q = (_b1_edges() + _b2_edges())[case]
    alloc = np.asarray(alloc, dtype=np.int64).astype(np.int32)
    check(alloc, np.zeros_like(alloc), q)


def _wrap_beside_boundary(n_res):
    """R rows: row 0 the wrapping edge (INT32_MAX over 2^29, 2^29 - 1),
    every other row dividends at and one off quotient 2^20 of its divisor;
    scenarios with each row inactive in turn, and one with none active."""
    n = 64
    q = 1 << 20
    divisors = [997 + 34 * r for r in range(n_res)]
    rows = [np.full(n, I32_MAX)]
    for d in divisors[1:]:
        rows.append(np.array([q * d, q * d - 1, q * d + 1, (q - 1) * d,
                              d - 1, 0, d, 2 * d - 1] * (n // 8)))
    alloc = np.stack(rows).astype(np.int32)
    base = [1 << 29] + divisors[1:]
    reqs = [base, [(1 << 29) - 1] + divisors[1:]]
    for r in range(n_res):
        off = list(base)
        off[r] = 0
        reqs.append(off)
    reqs.append([0] * n_res)
    return alloc, np.array(reqs).T


@pytest.mark.parametrize("n_res", range(1, 9))
def test_wrap_edge_beside_largest_quotients(n_res):
    alloc, q = _wrap_beside_boundary(n_res)
    check(alloc, np.zeros_like(alloc), q)


def _seeded(n_res, seed, n=2000, s=300):
    """Eligible R-row inputs: headrooms up to INT32_MAX, divisors at most
    2^29 and no quotient above 2^20, nodes over-committed, a third of the
    requests inactive, scenario 0 all inactive, and dividends on and one
    off multiples of some scenarios' requests."""
    rng = np.random.default_rng(seed)
    top = rng.integers(1 << 20, I32_MAX, n_res, endpoint=True)
    alloc = (rng.random((n_res, n)) * top[:, None]).astype(np.int64)
    alloc[:, 0] = top
    used = (alloc * rng.random((n_res, n)) * 1.1).astype(np.int64)
    qmin = -(-top // (1 << 20))
    logq = rng.uniform(np.log2(qmin)[:, None], 29, (n_res, s))
    q = np.minimum(np.exp2(logq).astype(np.int64), 1 << 29)
    q[rng.random((n_res, s)) < 0.33] = 0
    q[:, 0] = 0
    for r in range(n_res):
        cols = rng.integers(1, s, 40)
        mult = rng.integers(0, top[r] // np.maximum(q[r, cols], 1) + 1)
        near = q[r, cols] * mult + rng.integers(-1, 2, cols.size)
        alloc[r, 1:41] = np.clip(near, 0, top[r])
        used[r, 1:41] = 0
    assert fm.rcp_multi_eligible(alloc, used, q.T, [1] * n_res)
    return (alloc.astype(np.int32), np.minimum(used, I32_MAX).astype(np.int32),
            q)


@pytest.mark.parametrize("n_res", [1, 2, 3, 4, 5, 6, 7, 8])
def test_seeded_eligible_inputs(n_res):
    check(*_seeded(n_res, seed=100 + n_res))


@pytest.mark.parametrize("strict", [False, True], ids=["reference", "strict"])
@pytest.mark.parametrize("n_res", [2, 4])
def test_totals_equal_the_plain_version(n_res, strict):
    """Summed through the kernels' epilogue on staged terms (strict: the
    min with the free slots; reference: the overwrite by ap - pc) and a
    0/1 mask applied by leaving masked nodes out, the emulated totals equal
    ``sweep_multi_plain``'s."""
    alloc, used, q = _seeded(n_res, seed=7 + n_res, n=700, s=90)
    rng = np.random.default_rng(n_res)
    n = alloc.shape[1]
    ap = np.full(n, 110, np.int32)
    pc = rng.integers(0, 130, n).astype(np.int32)
    mask = (rng.random(n) < 0.8).astype(np.int32)
    h, hf = staged(alloc, used)
    rc = ff.scenario_reciprocals(np.maximum(q, 1).astype(np.int32))
    fit, _ = kernel_fits(h, hf, q.astype(np.int32), rc)
    live = mask != 0
    fit = fit[:, live]
    if strict:
        fit = np.minimum(fit, np.maximum(ap - pc, 0)[live])
    else:
        fit = np.where(fit >= ap[live], (ap - pc)[live], fit)
    want = fm.sweep_multi_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (
            alloc, used, ap, pc, q.astype(np.int32), rc, mask)),
        strict=strict)
    np.testing.assert_array_equal(fit.astype(np.int64).sum(axis=1),
                                  want.numpy())
