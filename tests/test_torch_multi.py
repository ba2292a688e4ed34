"""The R-resource sweep of the port against the JAX package's.

* ``sweep_multi_plain`` against ``_sweep_pallas_multi_padded(...,
  interpret=True)`` in all 8 variants (rcp x strict x mask) at R in
  {1, 2, 4, 5}, ragged in N and in S, with Q1-negative nodes, used above
  alloc, zero (inactive) requests and an all-inactive scenario; and on the
  reciprocal-division edge inputs.  Only the JAX side is padded, with the
  JAX package's own ``pad_multi_operands``; each interpret call is one
  grid step (N <= 2048, S <= 256).
* The exactness proofs (``multi_row_scales``, ``fast_multi_eligible``,
  ``rcp_multi_eligible``) against the JAX package's.
* ``sweep_multi_auto(device="cpu")`` against the JAX ``sweep_multi_auto(
  interpret=True)``: totals, schedulable flags and kernel labels
  (``pallas_`` -> ``plain_``, ``xla_int64`` -> ``torch_int64``).
* The exact int64 ``fit_per_node_multi`` / ``sweep_grid_multi`` against
  the JAX ones.

Inputs are made from a seed with numpy.  Tolerance: none — totals are
integers, and the one float step (the rcp estimate) feeds an integer that
must be exact.
"""

import itertools

import numpy as np
import pytest
import torch

from kubernetesclustercapacity_tpu.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu.ops import fit as j_fit
from kubernetesclustercapacity_tpu.ops import pallas_multi as jm
from kubernetesclustercapacity_tpu.snapshot import (
    snapshot_from_fixture,
    synthetic_snapshot,
)
from kubernetesclustercapacity_tpu_torch.ops import fit as t_fit
from kubernetesclustercapacity_tpu_torch.ops import fused_multi as tm

GIB = 1 << 30
MIB = 1 << 20
VARIANTS = list(itertools.product((False, True), repeat=3))  # rcp, strict, mask
RESOURCES = [1, 2, 4, 5]
# Every interpret call here pads to one grid step of 2048 nodes x 256
# scenarios on the JAX side, so each (variant, R) compiles its kernel once.
SHAPES = [(2000, 200), (1, 1)]


def _variant_id(v):
    rcp, strict, mask = v
    return "-".join(("rcp" if rcp else "div", "strict" if strict else "ref",
                     "mask" if mask else "nomask"))


def _rows(n, s, n_res, seed):
    """``n_res`` resource rows in their native units (cpu milli, memory
    bytes, ephemeral-storage bytes, GPUs, 2 MiB hugepages): alloc, used
    (some nodes over-committed) and requests (rows past cpu and memory
    draw zeros, and scenario 0 requests nothing), plus Q1-negative pod
    columns and a random mask.  rcp-eligible by construction."""
    rng = np.random.default_rng(seed)
    cores = rng.choice(np.array([2, 4, 8, 16, 32, 64]), size=n)
    units = [
        (cores * 1000, lambda k: rng.integers(50, 4000, k)),
        ((cores * 4096 - rng.integers(0, 256, n)) * MIB,
         lambda k: rng.integers(64, 8192, k) * MIB),
        (rng.integers(50, 500, n) * GIB,
         lambda k: rng.integers(0, 20, k) * GIB),
        (rng.integers(0, 9, n), lambda k: rng.integers(0, 3, k)),
        (rng.integers(0, 64, n) * 2 * MIB,
         lambda k: rng.integers(0, 4, k) * 2 * MIB),
    ][:n_res]
    alloc = np.stack([a for a, _ in units]).astype(np.int64)
    used = (alloc * rng.random(alloc.shape) * 1.1).astype(np.int64)
    used -= used % np.array([1, 1024, 1024, 1, 1024][:n_res])[:, None]
    reqs = np.stack([draw(s) for _, draw in units], axis=1).astype(np.int64)
    reqs[0, :] = 0
    return {
        "alloc": alloc, "used": used, "reqs": reqs,
        "ap": np.full(n, 110, dtype=np.int64),
        "pc": rng.integers(0, 130, n).astype(np.int64),
        "mask": rng.random(n) < 0.8,
    }


def _edge_rows():
    """Reciprocal-division edge inputs on two rows: dividends on and one
    off multiples of the divisor at the largest eligible quotient (2^20),
    and a divisor at 2^29 with the wrapping fixup product (dividend at
    int32 max); both with zero (inactive) requests."""
    q, d0, d1, n = 1 << 20, 997, 1031, 64
    boundary = np.stack([
        np.array([q * d0, q * d0 - 1, q * d0 + 1, (q - 1) * d0] * (n // 4)),
        np.array([q * d1, q * d1 - 1, q * d1 + 1, (q - 1) * d1] * (n // 4)),
    ]).astype(np.int64)
    wrap = np.stack([np.full(n, (1 << 31) - 1), np.full(n, 1 << 20)])
    cases = [
        (boundary, [[d0, d1], [d0 + 1, d1], [d0, 0], [0, d1], [0, 0]]),
        (wrap, [[1 << 29, 1], [(1 << 29) - 1, 1], [1 << 29, 0], [0, 1]]),
    ]
    return [{
        "alloc": alloc, "used": np.zeros_like(alloc),
        "reqs": np.array(reqs, dtype=np.int64),
        "ap": np.full(n, 1 << 30, dtype=np.int64),
        "pc": np.zeros(n, dtype=np.int64), "mask": np.ones(n, dtype=bool),
    } for alloc, reqs in cases]


def _plain(data, variant, scales):
    rcp, strict, mask = variant
    ops = tm.stage_multi_operands(
        data["alloc"], data["used"], data["ap"], data["pc"], data["reqs"],
        scales, data["mask"] if mask else None, use_rcp=rcp,
        device=torch.device("cpu"),
    )
    return tm.sweep_multi_plain(*ops, strict=strict).numpy()


def _pallas(data, variant, scales):
    rcp, strict, mask = variant
    return jm.sweep_pallas_multi(
        data["alloc"], data["used"], data["ap"], data["pc"], data["reqs"],
        np.zeros(data["reqs"].shape[0], dtype=np.int64), scales,
        mode="strict" if strict else "reference",
        node_mask=data["mask"] if mask else None, use_rcp=rcp,
        interpret=True,
    )[0]


@pytest.mark.parametrize("n_res", RESOURCES)
@pytest.mark.parametrize("variant", VARIANTS, ids=_variant_id)
def test_plain_matches_pallas_interpret(variant, n_res):
    for n, s in SHAPES:
        data = _rows(n, s, n_res, seed=10 * n_res + s)
        scales = tm.multi_row_scales(data["alloc"], data["used"], data["reqs"])
        assert scales == jm.multi_row_scales(
            data["alloc"], data["used"], data["reqs"]
        )
        assert tm.rcp_multi_eligible(
            data["alloc"], data["used"], data["reqs"], scales
        )
        np.testing.assert_array_equal(
            _plain(data, variant, scales), _pallas(data, variant, scales)
        )


@pytest.mark.parametrize("edge", [0, 1], ids=["quotient-2^20", "wrap-2^29"])
@pytest.mark.parametrize("variant", VARIANTS, ids=_variant_id)
def test_rcp_edge_inputs(variant, edge):
    data = _edge_rows()[edge]
    scales = [1, 1]
    assert tm.rcp_multi_eligible(
        data["alloc"], data["used"], data["reqs"], scales
    )
    got = _plain(data, variant, scales)
    np.testing.assert_array_equal(got, _pallas(data, variant, scales))
    # The reciprocal path agrees with the int32 divide.
    np.testing.assert_array_equal(got, _plain(data, (False, *variant[1:]),
                                              scales))


def _workload(n, s, seed, *, gpu_zeros=True):
    """Config-4-shaped inputs (``tests/test_pallas_multi.py``): cpu,
    memory, ephemeral-storage and GPU rows."""
    rng = np.random.default_rng(seed)
    snap = synthetic_snapshot(n, seed=seed)
    alloc_rn = np.stack([
        snap.alloc_cpu_milli, snap.alloc_mem_bytes,
        rng.integers(50, 500, n) * GIB, rng.integers(0, 9, n),
    ])
    used_rn = np.stack([
        snap.used_cpu_req_milli, snap.used_mem_req_bytes,
        rng.integers(0, 50, n) * GIB, np.zeros(n, dtype=np.int64),
    ])
    reqs_sr = np.stack([
        rng.integers(1, 10, s) * 100,
        rng.integers(1, 16, s) * (64 << 20),
        rng.integers(1, 20, s) * GIB,
        rng.integers(0, 3, s) if gpu_zeros else rng.integers(1, 3, s),
    ], axis=1).astype(np.int64)
    reps = rng.integers(1, 500, s).astype(np.int64)
    return snap, alloc_rn, used_rn, reqs_sr, reps


def _eligibility_cases():
    cases = []
    snap, a, u, r, _ = _workload(500, 32, seed=1)
    cases.append(("config4", a, u, snap.alloc_pods, snap.pods_count, r))
    snap, a, u, r, _ = _workload(50, 8, seed=2)
    a = a.copy()
    a[1, 0] += 1
    cases.append(("unquantized", a, u, snap.alloc_pods, snap.pods_count, r))
    snap, a, u, r, _ = _workload(50, 8, seed=3)
    r = r.copy()
    r[0, 3] = -1
    cases.append(("negative-request", a, u, snap.alloc_pods,
                  snap.pods_count, r))
    snap, a, u, r, _ = _workload(50, 8, seed=4)
    a, r = a.copy(), r.copy()
    a[0, :] = 2_000_000_000
    r[:, 0] = 1
    cases.append(("sum-overflow", a, u, snap.alloc_pods, snap.pods_count, r))
    snap, a, u, r, _ = _workload(50, 8, seed=5)
    r = r.copy()
    r[:, 2] = ((1 << 29) + 1) * 1024
    cases.append(("divisor-2^29", a, u, snap.alloc_pods, snap.pods_count, r))
    r = np.array([[3, MIB]], dtype=np.int64)
    a2 = np.array([[(1 << 20) * 3 + 3] * 4, [GIB] * 4], dtype=np.int64)
    cases.append(("quotient-2^20+1", a2, np.zeros_like(a2),
                  np.full(4, 110), np.zeros(4, dtype=np.int64), r))
    snap, a, u, r, _ = _workload(50, 8, seed=6)
    cases.append(("zero-column", a, u, snap.alloc_pods, snap.pods_count,
                  np.concatenate([r[:, :3], np.zeros((8, 1), np.int64)], 1)))
    cases.append(("bad-shape", a, u, snap.alloc_pods, snap.pods_count,
                  r[:, :3]))
    return cases


@pytest.mark.parametrize("case", _eligibility_cases(), ids=lambda c: c[0])
def test_eligibility_proofs_match(case):
    _, alloc_rn, used_rn, ap, pc, reqs_sr = case
    assert tm.multi_row_scales(alloc_rn, used_rn, reqs_sr) == \
        jm.multi_row_scales(alloc_rn, used_rn, reqs_sr)
    t_scales, t_ok = tm.fast_multi_eligible(alloc_rn, used_rn, ap, pc, reqs_sr)
    j_scales, j_ok = jm.fast_multi_eligible(alloc_rn, used_rn, ap, pc, reqs_sr)
    assert (t_scales, t_ok) == (j_scales, j_ok)
    if t_scales is not None:
        assert tm.rcp_multi_eligible(alloc_rn, used_rn, reqs_sr, t_scales) \
            == jm.rcp_multi_eligible(alloc_rn, used_rn, reqs_sr, j_scales)


def test_eligibility_verdicts_are_the_expected_ones():
    verdicts = {c[0]: tm.fast_multi_eligible(*c[1:])[1]
                for c in _eligibility_cases()}
    assert verdicts["config4"] and not verdicts["unquantized"]
    assert not verdicts["negative-request"] and not verdicts["sum-overflow"]


def _label(name):
    return name.replace("pallas_", "plain_").replace("xla_int64", "torch_int64")


def _auto_cases():
    rng = np.random.default_rng(13)
    masks = rng.random((24, 400)) < 0.6
    zero = _workload(150, 8, seed=7)
    zero[3][3, :] = 0
    inel = _workload(100, 8, seed=17)
    inel[1][1, 0] += 1
    return [
        ("fused", _workload(400, 24, seed=11), {}),
        ("shared-mask", _workload(400, 24, seed=12),
         {"node_masks": masks[0]}),
        ("per-scenario-masks", _workload(400, 24, seed=14),
         {"node_masks": masks}),
        ("max-per-node", _workload(100, 8, seed=16), {"max_per_node": 2}),
        ("max-per-node-per-scenario", _workload(100, 8, seed=16),
         {"max_per_node": np.arange(8)}),
        ("ineligible", inel, {}),
        ("force-exact", _workload(100, 8, seed=18), {"force_exact": True}),
        ("all-zero-scenario", zero, {}),
        ("no-gpu-zeros", _workload(300, 16, seed=19, gpu_zeros=False), {}),
    ]


@pytest.mark.parametrize("mode", ["strict", "reference"])
@pytest.mark.parametrize("case", _auto_cases(), ids=lambda c: c[0])
def test_sweep_multi_auto_matches_jax(case, mode):
    name, (snap, alloc_rn, used_rn, reqs_sr, reps), kw = case
    healthy = snap.healthy.copy()
    healthy[::5] = False
    args = (alloc_rn, used_rn, snap.alloc_pods, snap.pods_count, healthy,
            reqs_sr, reps)
    jt, js, jname = jm.sweep_multi_auto(*args, mode=mode, interpret=True, **kw)
    tt, ts, tname = tm.sweep_multi_auto(*args, mode=mode, device="cpu", **kw)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    np.testing.assert_array_equal(ts, np.asarray(js))
    assert tt.dtype == np.int64 and ts.dtype == np.bool_
    assert tname == _label(jname)
    fused = name in ("fused", "shared-mask", "all-zero-scenario",
                     "no-gpu-zeros")
    assert tname == ("plain_multi_i32_rcp_fused" if fused
                     else "torch_int64_multi")


def test_sweep_multi_auto_rejects_bad_arguments():
    snap, alloc_rn, used_rn, reqs_sr, reps = _workload(20, 4, seed=1)
    args = (alloc_rn, used_rn, snap.alloc_pods, snap.pods_count,
            snap.healthy, reqs_sr, reps)
    with pytest.raises(ValueError):
        tm.sweep_multi_auto(*args, mode="lenient", device="cpu")
    with pytest.raises(ValueError):
        tm.sweep_multi_auto(*args, device="mps")


def _gpu_fixture():
    return {"nodes": [
        {"name": "gpu-a", "allocatable": {
            "cpu": "16", "memory": "64Gi", "pods": "110",
            "nvidia.com/gpu": "8", "ephemeral-storage": "200Gi"},
         "conditions": [{"type": "Ready", "status": "True"}]},
        {"name": "cpu-b", "allocatable": {
            "cpu": "64", "memory": "256Gi", "pods": "110",
            "ephemeral-storage": "500Gi"},
         "conditions": [{"type": "Ready", "status": "True"}]}],
        "pods": []}


def _node_tensors(snap, resources):
    alloc, used = snap.resource_matrix(resources)
    return [torch.from_numpy(np.array(a)) for a in
            (alloc, used, snap.alloc_pods, snap.pods_count, snap.healthy)]


@pytest.mark.parametrize("mode", ["strict", "reference"])
@pytest.mark.parametrize(
    "resources,reqs",
    [
        (("cpu", "memory", "nvidia.com/gpu"), [1000, GIB, 2]),
        (("cpu", "memory", "nvidia.com/gpu"), [1000, GIB, 0]),
        (("ephemeral-storage", "cpu"), [10 * GIB, 3000]),
        (("cpu", "memory"), [150, 200 * MIB]),
    ],
    ids=["gpu-binds", "zero-request", "storage", "two-resource"],
)
def test_fit_per_node_multi_matches_jax(resources, reqs, mode):
    fx = _gpu_fixture()
    ext = ("ephemeral-storage", "nvidia.com/gpu")
    snap = snapshot_from_fixture(fx, semantics="strict",
                                 extended_resources=ext)
    reqs = np.array(reqs, dtype=np.int64)
    want = np.asarray(j_fit.fit_per_node_multi(
        *snap.resource_matrix(resources), snap.alloc_pods, snap.pods_count,
        snap.healthy, reqs, mode=mode))
    got = t_fit.fit_per_node_multi(
        *_node_tensors(snap, resources), torch.from_numpy(reqs), mode=mode
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_fit_per_node_multi_two_resource_fixture():
    snap = snapshot_from_fixture(synthetic_fixture(50, seed=13),
                                 semantics="strict")
    reqs = np.array([150, 200 * MIB], dtype=np.int64)
    want = np.asarray(j_fit.fit_per_node_multi(
        *snap.resource_matrix(), snap.alloc_pods, snap.pods_count,
        snap.healthy, reqs, mode="strict"))
    got = t_fit.fit_per_node_multi(
        *_node_tensors(snap, ("cpu", "memory")), torch.from_numpy(reqs)
    ).numpy()
    np.testing.assert_array_equal(got, want)


def _adversarial(n, s, seed):
    """int64 rows with wrapped headrooms (alloc > used but alloc - used
    overflows), INT64 extremes, negative and zero requests."""
    rng = np.random.default_rng(seed)
    big = rng.integers(-(2**62), 2**62, size=(3, n), dtype=np.int64)
    alloc = np.where(rng.random((3, n)) < 0.2, big,
                     rng.integers(0, 10**9, size=(3, n)))
    used = np.where(rng.random((3, n)) < 0.2, -big,
                    rng.integers(0, 10**9, size=(3, n)))
    alloc[0, :3] = [2**63 - 1, -(2**63), 5]
    used[0, :3] = [-(2**63), 2**63 - 1, 5]
    reqs = rng.integers(-50, 10**6, size=(s, 3))
    reqs[rng.random((s, 3)) < 0.2] = 0
    reqs[0] = [-1, 7, 0]
    return alloc, used, reqs


@pytest.mark.parametrize("mode", ["strict", "reference"])
@pytest.mark.parametrize(
    "extra",
    ["none", "shared-mask", "per-scenario-masks", "cap", "cap-per-scenario"],
)
def test_sweep_grid_multi_matches_jax(mode, extra, monkeypatch):
    # Small blocks, so the scenario batch is cut into several chunks.
    monkeypatch.setattr(t_fit, "BLOCK_CELLS", 700)
    n, s = 257, 13
    alloc, used, reqs = _adversarial(n, s, seed=3)
    rng = np.random.default_rng(4)
    ap = rng.integers(0, 120, n)
    pc = rng.integers(0, 150, n)
    healthy = rng.random(n) < 0.8
    reps = rng.integers(0, 2000, s)
    kw = {}
    if extra == "shared-mask":
        kw["node_masks"] = rng.random(n) < 0.7
    elif extra == "per-scenario-masks":
        kw["node_masks"] = rng.random((s, n)) < 0.7
    elif extra == "cap":
        kw["max_per_node"] = 3
    elif extra == "cap-per-scenario":
        kw["max_per_node"] = rng.integers(0, 5, s)
    want = [np.asarray(x) for x in j_fit.sweep_grid_multi(
        alloc, used, ap, pc, healthy, reqs, reps, mode=mode,
        return_per_node=True, **kw)]
    got = t_fit.sweep_grid_multi_staged(
        alloc, used, ap, pc, healthy, reqs, reps, mode=mode,
        return_per_node=True, device="cpu", **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_sweep_grid_multi_per_scenario_masks():
    snap = snapshot_from_fixture(synthetic_fixture(30, seed=14),
                                 semantics="strict")
    alloc, used = snap.resource_matrix(("cpu", "memory"))
    reqs = np.tile(np.array([[100, MIB]], dtype=np.int64), (4, 1))
    masks = np.ones((4, 30), dtype=bool)
    masks[1, :] = False
    masks[2, ::2] = False
    args = (alloc, used, snap.alloc_pods, snap.pods_count, snap.healthy,
            reqs, np.ones(4, dtype=np.int64))
    want = j_fit.sweep_grid_multi(*args, mode="strict", node_masks=masks)
    got = t_fit.sweep_grid_multi_staged(*args, mode="strict",
                                        node_masks=masks, device="cpu")
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert got[0][1] == 0 and got[0][0] == got[0][3] and got[0][2] < got[0][0]


def test_empty_grid():
    snap, alloc_rn, used_rn, _, _ = _workload(40, 1, seed=2)
    empty = np.zeros((0, 4), dtype=np.int64)
    for force in (False, True):
        tt, ts, name = tm.sweep_multi_auto(
            alloc_rn, used_rn, snap.alloc_pods, snap.pods_count,
            snap.healthy, empty, np.zeros(0, np.int64), force_exact=force,
            device="cpu",
        )
        assert tt.shape == ts.shape == (0,)


def _operands(n=16, s=3, n_res=2):
    data = _rows(n, s, n_res, seed=1)
    return list(tm.stage_multi_operands(
        data["alloc"], data["used"], data["ap"], data["pc"], data["reqs"],
        [1] * n_res, data["mask"], use_rcp=True, device=torch.device("cpu"),
    ))


@pytest.mark.parametrize("strict", [False, True], ids=["ref", "strict"])
def test_staging_makes_an_int_node_mask_0_1(strict):
    """The kernel takes any non-zero lane as 1 and the plain version
    multiplies by it, so ``stage_multi_operands`` stages ``mask != 0``."""
    data = _rows(64, 9, 4, seed=3)
    weights = np.random.default_rng(4).choice(
        np.array([0, 1, 2, 7, -3], np.int32), size=64)
    staged = [tm.stage_multi_operands(
        data["alloc"], data["used"], data["ap"], data["pc"], data["reqs"],
        [1] * 4, m, use_rcp=True, device=torch.device("cpu"),
    ) for m in (weights, weights != 0)]
    assert torch.equal(staged[0][6], torch.from_numpy(
        (weights != 0).astype(np.int32)))
    assert torch.equal(tm.sweep_multi(*staged[0], strict=strict),
                       tm.sweep_multi(*staged[1], strict=strict))


def test_wrapper_runs_plain_on_cpu_without_counting_a_launch():
    ops = _operands()
    before = tm.LAUNCHES
    got = tm.sweep_multi(*ops)
    assert tm.LAUNCHES == before
    assert torch.equal(got, tm.sweep_multi_plain(*ops))
    assert got.dtype == torch.int64 and got.shape == (3,)


@pytest.mark.parametrize(
    "mutate",
    [
        lambda ops: ops.__setitem__(0, ops[0].to(torch.int64)),
        lambda ops: ops.__setitem__(1, ops[1][:, :-1]),
        lambda ops: ops.__setitem__(4, ops[4][:, :-1]),
        lambda ops: ops.__setitem__(4, ops[4][:1]),
        lambda ops: ops.__setitem__(2, ops[2].reshape(4, 4)),
        lambda ops: ops.__setitem__(0, ops[0].t().contiguous().t()),
        lambda ops: ops.__setitem__(3, ops[3].to("meta")),
        lambda ops: ops.__setitem__(5, ops[5].to(torch.float64)),
        lambda ops: ops.__setitem__(6, ops[6].to(torch.bool)),
        lambda ops: ops.__setitem__(0, ops[0].reshape(-1)),
    ],
    ids=["dtype", "node-length", "scenario-length", "row-count", "rank",
         "non-contiguous", "device", "reciprocal-dtype", "mask-dtype",
         "flat-rows"],
)
def test_wrapper_rejects_bad_operands(mutate):
    ops = _operands()
    mutate(ops)
    with pytest.raises((TypeError, ValueError)):
        tm.sweep_multi(*ops)
