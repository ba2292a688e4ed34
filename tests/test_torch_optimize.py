"""The port's certified LP/PDHG optimizer against ``kubernetesclustercapacity_tpu.
optimize``, on the CPU.

* one ``_pdhg_chunk`` from the same seeded state in both packages;
* ``optimize_snapshot`` on the instances of the JAX package's
  ``tests/test_optimize.py`` (both modes, grouped and ungrouped, taint and
  random masks, the uncertified solve, the shadow-price story, the empty
  fleet), with ``scipy.optimize.linprog`` and ``lp_bound_oracle`` as
  extra oracles;
* the knobs, their environment fallbacks and ``verify_rounded_packing``.

Tolerances.  Integer fields (``demand``, ``rounded``, ``ffd``,
``ffd_totals``, ``schedulable``) are equal, and so are ``certified``,
``iterations`` and ``canonical_result_digest("optimize", ...)``.
``lp_bound`` and ``primal_value`` are within a relative 1e-9 of the JAX
package's, and, where certified, within a relative ``4·tol`` of
``lp_bound_oracle`` (a certified gap of at most ``tol·(1+|D|+|P|)``
leaves about ``2·tol`` between either and the optimum).  The
certificate's own small numbers (``duality_gap``, the residuals) are
within an absolute 1e-9; the shadow report within an absolute 1e-6 (its
wire form rounds to 6 decimals).  The PDHG's step sizes are powers of two,
so fused and unfused multiply-adds round alike; what can move a last bit
is the order of the f64 sums over groups.
"""

import numpy as np
import pytest
import torch

from kubernetesclustercapacity_tpu import optimize as j_opt
from kubernetesclustercapacity_tpu.audit.log import (
    canonical_result_digest as j_digest,
)
from kubernetesclustercapacity_tpu.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu.masks import implicit_taint_mask
from kubernetesclustercapacity_tpu.optimize import lp as j_lp
from kubernetesclustercapacity_tpu.scenario import ScenarioGrid as JGrid
from kubernetesclustercapacity_tpu.snapshot import (
    snapshot_from_fixture as j_from_fixture,
)
from kubernetesclustercapacity_tpu.snapshot import (
    synthetic_snapshot as j_synthetic,
)
from kubernetesclustercapacity_tpu_torch import optimize as t_opt
from kubernetesclustercapacity_tpu_torch.audit.log import (
    canonical_result_digest as t_digest,
)
from kubernetesclustercapacity_tpu_torch.optimize import lp as t_lp
from kubernetesclustercapacity_tpu_torch.scenario import ScenarioGrid as TGrid
from kubernetesclustercapacity_tpu_torch.snapshot import (
    snapshot_from_fixture as t_from_fixture,
)
from kubernetesclustercapacity_tpu_torch.snapshot import (
    synthetic_snapshot as t_synthetic,
)

try:
    from scipy.optimize import linprog as _linprog
except Exception:  # pragma: no cover - image without scipy
    _linprog = None

MIB = 1 << 20
GIB = 1 << 30
INTEGER_FIELDS = ("demand", "rounded", "ffd", "ffd_totals", "schedulable")


def _grids(cpu, mem, replicas):
    cols = dict(cpu_request_milli=np.asarray(cpu, dtype=np.int64),
                mem_request_bytes=np.asarray(mem, dtype=np.int64),
                replicas=np.asarray(replicas, dtype=np.int64))
    return JGrid(**cols), TGrid(**cols)


def _random_grids(rng, s, demand_hi):
    return _grids(rng.integers(50, 4000, s),
                  rng.integers(32 * MIB, 4 * GIB, s),
                  rng.integers(1, demand_hi, s))


def _solve_both(j_snap, t_snap, grids, **kw):
    j = j_opt.optimize_snapshot(j_snap, grids[0], **kw)
    t = t_opt.optimize_snapshot(t_snap, grids[1], device="cpu", **kw)
    return j, t


def _assert_matches(t, j, label=""):
    for name in INTEGER_FIELDS:
        assert np.array_equal(getattr(t, name), getattr(j, name)), (
            name, label)
    assert t.certified.tolist() == j.certified.tolist(), label
    assert t.iterations == j.iterations, label
    assert (t.mode, t.tol, t.groups, t.nodes, t.grouping_engaged,
            t.backend) == (j.mode, j.tol, j.groups, j.nodes,
                           j.grouping_engaged, j.backend), label
    np.testing.assert_allclose(t.lp_bound, j.lp_bound, rtol=1e-9, atol=0,
                               err_msg=label)
    np.testing.assert_allclose(t.primal_value, j.primal_value, rtol=1e-9,
                               atol=0, err_msg=label)
    for name in ("duality_gap", "primal_residual", "dual_residual"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name),
                                   rtol=0, atol=1e-9, err_msg=(name, label))
    assert (t.verified is None) == (j.verified is None), label
    if t.verified is not None:
        assert t.verified.tolist() == j.verified.tolist(), label
    assert len(t.shadow) == len(j.shadow)
    for ts_, js_ in zip(t.shadow, j.shadow):
        for key in ("shares", "priced_out"):
            for r in t_lp.OPT_RESOURCES:
                assert abs(ts_[key][r] - js_[key][r]) <= 1e-6, (key, label)
        for key in ("demand_price", "capacity_share"):
            assert abs(ts_[key] - js_[key]) <= 1e-6, (key, label)
    tw, jw = t.to_wire(), j.to_wire()
    assert t_digest("optimize", tw) == j_digest("optimize", jw), label
    assert tw["status"] == jw["status"] and tw.keys() == jw.keys()


def _assert_oracle(res, snap, grid, mode, mask=None, label=""):
    want = t_opt.lp_bound_oracle(snap, grid, mode=mode, node_mask=mask)
    scale = np.maximum(np.abs(want), 1.0)
    for name in ("lp_bound", "primal_value"):
        got = getattr(res, name)
        assert (np.abs(got - want) <= res.tol * 4 * scale).all(), (
            name, label, got, want)


# --- the PDHG chunk -----------------------------------------------------


@pytest.mark.parametrize("g,s,iters", [(8, 8, 1), (64, 8, 37),
                                       (256, 16, 500)])
def test_pdhg_chunk_matches_jax(g, s, iters):
    """One chunk from the same seeded (warm) state: every iterate within
    an absolute 1e-12 of the JAX package's (the state is O(1))."""
    rng = np.random.default_rng(g + s + iters)
    caps = rng.random((s, g, 3)) * rng.integers(1, 10**6, (s, 1, 1))
    caps[:, g // 2:] = 0.0  # padded groups
    demand = rng.integers(1, 10**7, s).astype(np.float64)
    scale = np.maximum(1.0, np.minimum(demand, caps.min(axis=2).sum(axis=1)))
    x = rng.random((s, g))
    lam = rng.random((s, g, 3)) * 0.1
    mu = rng.random(s)
    want = j_lp._pdhg_chunk(caps, demand, scale, x, lam, mu, iters=iters)
    got = t_lp._pdhg_chunk(*(torch.from_numpy(a) for a in (
        caps, demand, scale, x, lam, mu)), iters=iters)
    for w, gt in zip(want, got):
        assert gt.dtype == torch.float64
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)


# --- optimize_snapshot over the JAX tests' instances ---------------------


@pytest.mark.parametrize("mode", ["reference", "strict"])
def test_lp_bound_matches_jax_and_scipy(mode):
    rng = np.random.default_rng(11)
    fx = synthetic_fixture(128, seed=7, unhealthy_frac=0.2)
    j_snap = j_from_fixture(fx, semantics=mode)
    t_snap = t_from_fixture(fx, semantics=mode)
    grids = _random_grids(rng, 12, 10**7)
    j, t = _solve_both(j_snap, t_snap, grids, mode=mode)
    _assert_matches(t, j, mode)
    assert t.all_certified
    _assert_oracle(t, t_snap, grids[1], mode)
    if _linprog is not None:
        head, counts, _ = t_lp._packing_operands(t_snap, mode=mode)
        caps = t_lp._float_caps(head, counts, t_lp._req_matrix(grids[1]))
        for s in range(grids[1].size):
            g = head.shape[0]
            res = _linprog(c=-np.ones(g), A_ub=np.ones((1, g)),
                           b_ub=[float(grids[1].replicas[s])],
                           bounds=list(zip(np.zeros(g), caps[s].min(axis=1))),
                           method="highs")
            assert res.status == 0
            np.testing.assert_allclose(t.lp_bound[s], -res.fun, rtol=5e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("mode", ["reference", "strict"])
@pytest.mark.parametrize("grouping", ["1", "0"])
def test_randomized_certified_solves_match_jax(mode, grouping, monkeypatch):
    monkeypatch.setenv("KCCAP_GROUPING", grouping)
    rng = np.random.default_rng(17)
    for trial in range(4):
        fx = synthetic_fixture(int(rng.integers(48, 256)),
                               seed=int(rng.integers(10**6)),
                               unhealthy_frac=0.15, taint_frac=0.2)
        j_snap = j_from_fixture(fx, semantics=mode)
        t_snap = t_from_fixture(fx, semantics=mode)
        grids = _random_grids(rng, int(rng.integers(1, 9)), 10**7)
        mask = implicit_taint_mask(j_snap)
        if mask is not None and rng.random() < 0.5:
            mask = mask & (rng.random(j_snap.n_nodes) < 0.8)
        j, t = _solve_both(j_snap, t_snap, grids, mode=mode, node_mask=mask)
        label = f"trial {trial} mode {mode} grouping {grouping}"
        _assert_matches(t, j, label)
        assert t.all_certified and t.verified.all(), label
        _assert_oracle(t, t_snap, grids[1], mode, mask, label)
        if mode == "strict":
            assert np.array_equal(t.rounded, t.ffd), label


def test_grouped_and_ungrouped_match_jax(monkeypatch):
    j_snap = j_synthetic(2048, seed=9, shapes=4)
    t_snap = t_synthetic(2048, seed=9, shapes=4)
    grids = _random_grids(np.random.default_rng(2), 6, 10**7)
    results = {}
    for grouping in ("1", "0"):
        monkeypatch.setenv("KCCAP_GROUPING", grouping)
        j, t = _solve_both(j_snap, t_snap, grids, mode="strict")
        _assert_matches(t, j, grouping)
        results[grouping] = t
    assert results["1"].grouping_engaged and not results["0"].grouping_engaged
    assert results["1"].groups == 4 and results["0"].groups == 2048
    assert np.array_equal(results["1"].rounded, results["0"].rounded)


def test_uncertified_bound_is_still_valid_like_jax():
    j_snap = j_synthetic(512, seed=21, shapes=6)
    t_snap = t_synthetic(512, seed=21, shapes=6)
    grids = _grids([1500], [GIB], [10**8])
    j, t = _solve_both(j_snap, t_snap, grids, mode="strict", max_iters=1)
    _assert_matches(t, j)
    assert t.iterations == 1 and not t.all_certified
    assert t.to_wire()["status"] == ["uncertified"]
    truth = t_opt.lp_bound_oracle(t_snap, grids[1], mode="strict")
    assert (t.lp_bound >= truth - 1e-6).all()
    assert (t.rounded.astype(float) <= t.lp_bound + 1e-6).all()


def test_shadow_prices_match_jax():
    j_snap = j_synthetic(256, seed=13, shapes=4)
    t_snap = t_synthetic(256, seed=13, shapes=4)
    grids = _grids([1, 1, 500], [8 * GIB, 1, 256 * MIB], [10**9, 1, 1])
    j, t = _solve_both(j_snap, t_snap, grids, mode="strict")
    _assert_matches(t, j)
    assert t.shadow[0]["priced_out"]["memory"] > 0.99
    assert t.shadow[1]["capacity_share"] == 0.0


def test_empty_fleet_matches_jax():
    grids = _grids([100], [MIB], [5])
    j, t = _solve_both(j_synthetic(0, seed=1), t_synthetic(0, seed=1), grids,
                       mode="strict")
    _assert_matches(t, j)
    assert t.all_certified and t.lp_bound[0] == 0.0 and t.rounded[0] == 0


def test_wrapped_request_carriers_match_jax():
    """A negative int64 cpu request (a wrapped uint64 carrier) prices as
    zero capacity in both packages."""
    j_snap = j_synthetic(300, seed=3)
    t_snap = t_synthetic(300, seed=3)
    grids = _grids([-5, 250], [512 * MIB, GIB], [10, 10])
    j, t = _solve_both(j_snap, t_snap, grids, mode="reference",
                       verify=True)
    _assert_matches(t, j)
    assert t.rounded.tolist() == [0, 10] and t.verified.all()


# --- knobs, fallbacks, the verifier -------------------------------------


@pytest.mark.parametrize("kw", [dict(max_iters=0), dict(max_iters=1 << 21),
                                dict(tol=0.5), dict(tol=0.0)])
def test_knob_validation_matches_jax(kw):
    errors = []
    for mod, snap, grid in ((j_opt, j_synthetic(16, seed=1), _grids(
            [100], [MIB], [1])[0]), (t_opt, t_synthetic(16, seed=1), _grids(
            [100], [MIB], [1])[1])):
        extra = {} if mod is j_opt else {"device": "cpu"}
        with pytest.raises(mod.OptimizeError) as info:
            mod.optimize_snapshot(snap, grid, **kw, **extra)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("iters,tol", [("junk", "junk"), ("100", "0"),
                                       ("4000", "1e-4"), ("2000000", "0.5"),
                                       ("", "")])
def test_env_knob_fallbacks_match_jax(iters, tol, monkeypatch):
    monkeypatch.setenv("KCCAP_OPT_ITERS", iters)
    monkeypatch.setenv("KCCAP_OPT_TOL", tol)
    assert t_opt.opt_max_iters() == j_opt.opt_max_iters()
    assert t_opt.opt_tol() == j_opt.opt_tol()


def test_env_iteration_budget_reaches_the_solve(monkeypatch):
    monkeypatch.setenv("KCCAP_OPT_ITERS", "500")
    grids = _grids([1500], [GIB], [10**8])
    j, t = _solve_both(j_synthetic(300, seed=21), t_synthetic(300, seed=21),
                       grids, mode="strict")
    _assert_matches(t, j)
    assert t.iterations <= 500


def test_verify_rejects_an_infeasible_packing():
    snap = t_synthetic(64, seed=5, shapes=3)
    grid = _grids([500], [256 * MIB], [10**7])[1]
    res = t_opt.optimize_snapshot(snap, grid, mode="strict", device="cpu")
    assert res.verified.all()
    assert t_opt.verify_rounded_packing(snap, grid, res).all()
    res.rounded_alloc = res.rounded_alloc.copy()
    res.rounded_alloc[0, 0] += 10**9
    assert not t_opt.verify_rounded_packing(snap, grid, res).all()


def test_packing_operands_match_jax():
    fx = synthetic_fixture(90, seed=2, unhealthy_frac=0.2, taint_frac=0.3)
    for mode in ("reference", "strict"):
        j_snap = j_from_fixture(fx, semantics=mode)
        t_snap = t_from_fixture(fx, semantics=mode)
        mask = np.arange(90) % 3 != 0
        for m in (None, mask):
            jh, jc, _ = j_lp._packing_operands(j_snap, mode=mode, node_mask=m)
            th, tc, _ = t_lp._packing_operands(t_snap, mode=mode, node_mask=m)
            assert np.array_equal(th, jh) and np.array_equal(tc, jc)
    with pytest.raises(ValueError, match="node_mask"):
        t_lp._packing_operands(t_snap, mode="strict", node_mask=mask[:5])
    with pytest.raises(ValueError, match="unknown mode"):
        t_lp._packing_operands(t_snap, mode="lenient")


def test_metrics_funnel_uses_the_jax_names(monkeypatch):
    from kubernetesclustercapacity_tpu_torch.telemetry import compilewatch
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
        REGISTRY,
    )

    snap = t_synthetic(64, seed=5, shapes=3)
    grid = _grids([500], [256 * MIB], [100])[1]
    t_opt.optimize_snapshot(snap, grid, mode="strict", device="cpu")
    names = REGISTRY.snapshot()
    assert any(k.startswith("kccap_opt_certified_total") for k in names)
    for name in ("kccap_opt_iterations", "kccap_opt_duality_gap"):
        assert name in names
    assert "opt_pdhg" in compilewatch.seen_kernels()
    monkeypatch.setenv("KCCAP_TELEMETRY", "0")
    monkeypatch.setattr(t_lp, "_OPT_MET", None)
    t_opt.optimize_snapshot(snap, grid, mode="strict", device="cpu")
    assert t_lp._OPT_MET is None


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    snap = t_synthetic(16, seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_opt.optimize_snapshot(snap, _grids([100], [MIB], [1])[1])
