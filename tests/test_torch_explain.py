"""The port's explain programs against ``kubernetesclustercapacity_tpu.
explain`` and the JAX package's fused sweep+explain / sweep+quantile
programs, on the CPU.

The same seeded numpy inputs go through both packages: the per-node
attribution (``explain_per_node`` / ``explain_grid``), ``explain_snapshot``
grouped and ungrouped, masked and unmasked, in both modes, the host-side
analyses (headroom, saturation, the verified +1 marginals), the fused
``sweep_explain_snapshot`` and ``sweep_quantiles_snapshot`` (a ties case
included), and the ``-explain`` CLI.  Tolerance: none — every result is an
integer, a code, or a rendered string compared byte for byte.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import kubernetesclustercapacity_tpu as kcc
from kubernetesclustercapacity_tpu import cli as j_cli
from kubernetesclustercapacity_tpu import explain as j_explain
from kubernetesclustercapacity_tpu.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu.ops import fit as j_fit
from kubernetesclustercapacity_tpu.report import (
    explain_json_report as j_explain_json,
    explain_table_report as j_explain_table,
)
from kubernetesclustercapacity_tpu.stochastic.car import quantile_index
from kubernetesclustercapacity_tpu_torch import cli as t_cli
from kubernetesclustercapacity_tpu_torch import explain as t_explain
from kubernetesclustercapacity_tpu_torch import scenario as t_scenario
from kubernetesclustercapacity_tpu_torch import snapshot as t_snapshot
from kubernetesclustercapacity_tpu_torch.ops import fit as t_fit
from kubernetesclustercapacity_tpu_torch.ops import fused_fit as t_fused
from kubernetesclustercapacity_tpu_torch.report import (
    explain_json_report as t_explain_json,
    explain_table_report as t_explain_table,
)

KIND = "tests/fixtures/kind-3node.json"
MODES = ["reference", "strict"]
COLS = (
    "alloc_cpu_milli", "alloc_mem_bytes", "alloc_pods", "used_cpu_req_milli",
    "used_mem_req_bytes", "pods_count", "healthy",
)
PER_NODE = ("fits", "binding", "cpu_fit", "mem_fit", "slots")


def _pair(jsnap):
    """The port's snapshot over the same numpy columns and metadata."""
    return t_snapshot.ClusterSnapshot.from_columns(
        {f: getattr(jsnap, f) for f in t_snapshot.COLUMNS + ("healthy",)},
        names=list(jsnap.names), semantics=jsnap.semantics,
        taints=jsnap.taints, labels=jsnap.labels,
    )


def _grid_pair(grid):
    return t_scenario.ScenarioGrid(
        cpu_request_milli=grid.cpu_request_milli,
        mem_request_bytes=grid.mem_request_bytes,
        replicas=grid.replicas,
    )


def random_snapshot(n, seed, *, q1_heavy=False):
    """``tests/test_explain.py``'s snapshot: unhealthy nodes, memory-
    saturated rows, and (``q1_heavy``) tiny pod caps so the Q1 overwrite
    fires, negative replacement included."""
    rng = np.random.default_rng(seed)
    snap = kcc.synthetic_snapshot(n, seed=seed)
    unhealthy = rng.random(n) < 0.1
    snap.healthy[unhealthy] = False
    sat = rng.random(n) < 0.15
    snap.used_mem_req_bytes[sat] = snap.alloc_mem_bytes[sat] + rng.integers(
        0, 1 << 20, size=int(sat.sum())
    )
    if q1_heavy:
        few = rng.random(n) < 0.5
        snap.alloc_pods[few] = rng.integers(0, 4, size=int(few.sum()))
        snap.pods_count[few] = rng.integers(0, 6, size=int(few.sum()))
    return snap


def _fused_snap(mode, grouped):
    """``tests/test_fused_ops.py``'s snapshots (a grouped 2048-node fleet
    of 23 shapes, or 300 distinct nodes)."""
    snap = (
        kcc.synthetic_snapshot(2048, seed=3, shapes=23)
        if grouped
        else kcc.synthetic_snapshot(300, seed=3)
    )
    if mode == "strict":
        healthy = snap.healthy.copy()
        healthy[::5] = False
        snap = dataclasses.replace(snap, semantics="strict", healthy=healthy)
    return snap


def _mask(n, masked):
    if not masked:
        return None
    mask = np.ones(n, dtype=bool)
    mask[::3] = False
    return mask


def _assert_same_result(t_res, j_res):
    for name in PER_NODE:
        got, want = getattr(t_res, name), np.asarray(getattr(j_res, name))
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert got.dtype == want.dtype, name
    np.testing.assert_array_equal(t_res.totals, j_res.totals)
    assert t_res.mode == j_res.mode
    if j_res.node_mask is None:
        assert t_res.node_mask is None
    else:
        np.testing.assert_array_equal(t_res.node_mask, j_res.node_mask)


# -- the device program ----------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("masked", [False, True])
def test_explain_grid_matches_jax(mode, masked):
    jsnap = random_snapshot(600, 4, q1_heavy=True)
    grid = kcc.random_scenario_grid(16, seed=40)
    cols = [getattr(jsnap, c) for c in COLS]
    mask = _mask(jsnap.n_nodes, masked)
    want = j_explain.explain_grid(
        *cols, grid.cpu_request_milli, grid.mem_request_bytes, mode=mode,
        node_mask=mask,
    )
    got = t_explain.explain_grid(
        *(torch.from_numpy(np.ascontiguousarray(c)) for c in cols),
        torch.from_numpy(grid.cpu_request_milli),
        torch.from_numpy(grid.mem_request_bytes),
        mode=mode,
        node_mask=None if mask is None else torch.from_numpy(mask),
    )
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("mode", MODES)
def test_explain_per_node_matches_jax_on_wrapped_patterns(mode):
    # tests/test_torch_fit.py's hostile columns: full-range uint64 CPU,
    # INT64_MIN memory headroom, and wrapped CPU requests.
    rng = np.random.default_rng(21)
    n = 257

    def mixed(lo, hi):
        v = rng.integers(lo, hi, size=n, dtype=np.int64)
        return np.where(rng.random(n) < 0.1,
                        rng.integers(-(2**62), 2**62, size=n), v)

    cols = [mixed(0, 10**6), mixed(0, 2**45), rng.integers(0, 200, n),
            mixed(0, 10**6), mixed(0, 2**45), rng.integers(0, 300, n),
            rng.random(n) < 0.8]
    cols[0][:4] = [-1, -(2**63), 5, 2**63 - 1]
    cols[3][:4] = [-(2**63), -1, 2**63 - 1, 0]
    cols[1][4], cols[4][4] = 0, -(2**63)
    mask = rng.random(n) < 0.7
    for cpu, mem in ((100, 1 << 20), (1, 1), (-5, 7), (-(2**63), 1024),
                     (2**62 + 1, 3)):
        want = j_explain.explain_per_node(
            *cols, cpu, mem, mode=mode, node_mask=mask
        )
        got = t_explain.explain_per_node(
            *(torch.from_numpy(c) for c in cols),
            torch.tensor(cpu), torch.tensor(mem), mode=mode,
            node_mask=torch.from_numpy(mask),
        )
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", MODES)
def test_fits_bit_identical_to_fit_per_node(mode):
    # Twin of tests/test_explain.py::test_fits_bit_identical_to_fit_kernel
    # on the port: the explain fit IS fit_per_node's.
    jsnap = random_snapshot(257, 7, q1_heavy=True)
    tsnap = _pair(jsnap)
    grid = kcc.random_scenario_grid(8, seed=9)
    result = t_explain.explain_snapshot(
        tsnap, _grid_pair(grid), mode=mode, device="cpu"
    )
    for s in range(grid.size):
        want = t_fit.fit_snapshot(
            tsnap, int(grid.cpu_request_milli[s]),
            int(grid.mem_request_bytes[s]), mode=mode, device="cpu",
        )
        np.testing.assert_array_equal(result.fits[s], want)


@pytest.mark.parametrize("mode", MODES)
def test_fit_totals_matches_jax(mode):
    jsnap = random_snapshot(300, 5, q1_heavy=True)
    cols = [getattr(jsnap, c) for c in COLS]
    for cpu, mem in ((150, 200 << 20), (-5, 1 << 20), (1, 1)):
        want = int(j_fit.fit_totals(*cols, cpu, mem, mode=mode))
        got = t_fit.fit_totals(
            *(torch.from_numpy(np.ascontiguousarray(c)) for c in cols),
            torch.tensor(cpu), torch.tensor(mem), mode=mode,
        )
        assert got.dim() == 0 and int(got) == want


def test_unknown_mode_is_refused():
    tsnap = _pair(kcc.synthetic_snapshot(8, seed=1))
    grid = t_scenario.random_scenario_grid(2, seed=1)
    with pytest.raises(ValueError, match="unknown mode"):
        t_explain.explain_snapshot(tsnap, grid, mode="lenient", device="cpu")


# -- explain_snapshot and the host-side analyses ---------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_explain_snapshot_matches_jax(mode, seed):
    jsnap = random_snapshot(1000, seed, q1_heavy=(seed % 2 == 0))
    grid = kcc.random_scenario_grid(4, seed=seed + 100)
    want = j_explain.explain_snapshot(jsnap, grid, mode=mode)
    got = t_explain.explain_snapshot(
        _pair(jsnap), _grid_pair(grid), mode=mode, device="cpu"
    )
    _assert_same_result(got, want)
    for s in range(grid.size):
        assert got.binding_names(s) == want.binding_names(s)
        assert got.binding_counts(s) == want.binding_counts(s)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_explain_snapshot_grouped_and_masked_matches_jax(mode, grouped,
                                                         masked):
    jsnap = _fused_snap(mode, grouped)
    grid = kcc.random_scenario_grid(7, seed=11)
    mask = _mask(jsnap.n_nodes, masked)
    tsnap = _pair(jsnap)
    want = j_explain.explain_snapshot(jsnap, grid, mode=mode, node_mask=mask)
    got = t_explain.explain_snapshot(
        tsnap, _grid_pair(grid), mode=mode, node_mask=mask, device="cpu"
    )
    _assert_same_result(got, want)
    assert (t_snapshot.grouped_for_dispatch(tsnap) is not None) == grouped


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 1])
def test_marginal_headroom_saturation_match_jax(mode, seed):
    jsnap = random_snapshot(200, seed, q1_heavy=True)
    grid = kcc.random_scenario_grid(2, seed=seed + 50)
    want = j_explain.explain_snapshot(jsnap, grid, mode=mode)
    got = t_explain.explain_snapshot(
        _pair(jsnap), _grid_pair(grid), mode=mode, device="cpu"
    )
    for s in range(grid.size):
        assert got.marginal(s, verify_limit=None) == want.marginal(
            s, verify_limit=None)
        assert got.marginal(s) == want.marginal(s)
        assert got.saturation(s) == want.saturation(s)
        head_t, head_j = got.headroom(s), want.headroom(s)
        assert head_t.keys() == head_j.keys()
        for k in head_t:
            np.testing.assert_array_equal(head_t[k], head_j[k])


def test_reference_q1_pods_marginal_is_one_slot():
    # Twin of tests/test_explain.py's one-node case: cpu/mem allow 10, the
    # cap is 3 with 1 pod running, so fit = 3 - 1 = 2 and only +1 pod slot
    # buys the next replica.
    snap = t_snapshot.ClusterSnapshot(
        names=["n0"], alloc_cpu_milli=[10_000], alloc_mem_bytes=[10 << 30],
        alloc_pods=[3], used_cpu_req_milli=[0], used_cpu_lim_milli=[0],
        used_mem_req_bytes=[0], used_mem_lim_bytes=[0], pods_count=[1],
        healthy=[True],
    )
    grid = t_scenario.ScenarioGrid(
        cpu_request_milli=[1000], mem_request_bytes=[1 << 30], replicas=[1],
    )
    result = t_explain.explain_snapshot(
        snap, grid, mode="reference", device="cpu"
    )
    assert int(result.fits[0][0]) == 2
    m = result.marginal(0)
    assert m["pods"] == {
        "delta": 1, "node": "n0", "node_index": 0, "unit": "slots",
    }
    assert m["cpu"] is None and m["memory"] is None


def test_binding_shift_matches_jax():
    old = {"cpu": 3, "memory": 5, "pods": 0, "unhealthy": 1, "masked": 0}
    new = {"cpu": 1, "memory": 5, "pods": 2, "unhealthy": 1}
    assert t_explain.binding_shift(old, new) == j_explain.binding_shift(
        old, new) == {"cpu": -2, "pods": 2}


@pytest.mark.parametrize("mode", MODES)
def test_explain_reports_match_jax(mode):
    jsnap = random_snapshot(40, 3, q1_heavy=True)
    mask = _mask(jsnap.n_nodes, True)
    grid = kcc.random_scenario_grid(3, seed=8)
    want = j_explain.explain_snapshot(jsnap, grid, mode=mode, node_mask=mask)
    got = t_explain.explain_snapshot(
        _pair(jsnap), _grid_pair(grid), mode=mode, node_mask=mask,
        device="cpu",
    )
    for s in range(grid.size):
        assert t_explain_table(got, s) == j_explain_table(want, s)
        assert t_explain_json(got, s) == j_explain_json(want, s)


# -- the fused programs ----------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_sweep_explain_snapshot_matches_jax(mode, grouped, masked):
    # Twin of tests/test_fused_ops.py::TestFusedSweepExplain.
    jsnap = _fused_snap(mode, grouped)
    grid = kcc.random_scenario_grid(7, seed=11)
    mask = _mask(jsnap.n_nodes, masked)
    tsnap, tgrid = _pair(jsnap), _grid_pair(grid)
    jt, js, jres, jname = j_explain.sweep_explain_snapshot(
        jsnap, grid, mode=mode, node_mask=mask
    )
    tt, ts, tres, tname = t_explain.sweep_explain_snapshot(
        tsnap, tgrid, mode=mode, node_mask=mask, device="cpu"
    )
    np.testing.assert_array_equal(tt, np.asarray(jt))
    np.testing.assert_array_equal(ts, np.asarray(js))
    assert tt.dtype == np.int64 and ts.dtype == np.bool_
    _assert_same_result(tres, jres)
    assert tname == jname.split("@")[0].replace("xla_int64", "torch_int64")
    assert tname == "torch_int64_sweep_explain" + (
        "_grouped" if grouped else "")
    # The totals are the exact sweep's, and the per-node outputs are
    # explain_snapshot's.
    exact, exact_sched, _ = t_fused.sweep_snapshot_auto(
        tsnap, tgrid, mode=mode, kernel="exact", node_mask=mask,
        device="cpu",
    )
    np.testing.assert_array_equal(tt, exact)
    np.testing.assert_array_equal(ts, exact_sched)
    solo = t_explain.explain_snapshot(
        tsnap, tgrid, mode=mode, node_mask=mask, device="cpu"
    )
    for name in PER_NODE:
        np.testing.assert_array_equal(getattr(tres, name),
                                      getattr(solo, name))
    np.testing.assert_array_equal(tt, tres.fits.sum(axis=1))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_sweep_quantiles_snapshot_matches_jax(mode, grouped, masked):
    # Twin of tests/test_fused_ops.py::TestFusedQuantiles.
    jsnap = _fused_snap(mode, grouped)
    grid = kcc.random_scenario_grid(64, seed=13)
    mask = _mask(jsnap.n_nodes, masked)
    q_indices = tuple(sorted({quantile_index(64, q)
                              for q in (0.5, 0.9, 0.95, 0.99)})) + (0, 63)
    jout = j_fit.sweep_quantiles_snapshot(
        jsnap, grid, mode=mode, node_mask=mask, q_indices=q_indices
    )
    tout = t_fit.sweep_quantiles_snapshot(
        _pair(jsnap), _grid_pair(grid), mode=mode, node_mask=mask,
        q_indices=q_indices, device="cpu",
    )
    for got, want in zip(tout[:4], jout[:4]):
        want = np.asarray(want)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    assert tout[4] == jout[4].split("@")[0].replace("xla_int64",
                                                    "torch_int64")
    order = np.argsort(tout[0], kind="stable")
    np.testing.assert_array_equal(tout[3], order[list(q_indices)])
    np.testing.assert_array_equal(tout[2], tout[0][order][list(q_indices)])
    if grouped and mask is None:
        assert tout[4] == "torch_int64_sweep_qtile_grouped"


def test_quantile_ties_resolve_like_jax():
    # Many samples with IDENTICAL totals: the stable sort must gather the
    # same realizing indices as numpy's stable argsort and the JAX program.
    jsnap = _fused_snap("reference", False)
    g = kcc.random_scenario_grid(8, seed=4)
    grid = kcc.ScenarioGrid(
        cpu_request_milli=np.tile(g.cpu_request_milli[:2], 16),
        mem_request_bytes=np.tile(g.mem_request_bytes[:2], 16),
        replicas=np.tile(g.replicas[:2], 16),
    )
    q_indices = tuple(range(0, 32, 5))
    totals, _, qvals, qidx, _ = t_fit.sweep_quantiles_snapshot(
        _pair(jsnap), _grid_pair(grid), q_indices=q_indices, device="cpu"
    )
    _, _, jvals, jidx, _ = j_fit.sweep_quantiles_snapshot(
        jsnap, grid, q_indices=q_indices
    )
    order = np.argsort(totals, kind="stable")
    np.testing.assert_array_equal(qidx, order[list(q_indices)])
    np.testing.assert_array_equal(qvals, totals[order][list(q_indices)])
    np.testing.assert_array_equal(qidx, np.asarray(jidx))
    np.testing.assert_array_equal(qvals, np.asarray(jvals))
    assert len(set(totals.tolist())) == 2  # the ties are real


# -- the CLI's -explain ----------------------------------------------------


@pytest.fixture(scope="module")
def tainted_fixture(tmp_path_factory):
    path = tmp_path_factory.mktemp("explain") / "tainted.json"
    fx = synthetic_fixture(60, seed=14, taint_frac=0.3, unhealthy_frac=0.1)
    path.write_text(json.dumps(fx))
    return str(path)


@pytest.mark.parametrize(
    "extra",
    [
        [],
        ["-output", "json"],
        ["-output", "table", "-semantics", "strict"],
        ["-cpuRequests=200m", "-memRequests=250mb", "-replicas=10"],
        ["-cpuRequests=200m", "-memRequests=250mb", "-replicas=10",
         "-output", "json"],
        ["-cpuRequests=-5", "-replicas=500"],
    ],
    ids=["table", "json", "strict", "sample-table", "sample-json",
         "wrapped-cpu"],
)
@pytest.mark.parametrize("source", ["kind", "tainted"])
def test_cli_explain_matches_jax(source, extra, tainted_fixture, capsys):
    path = KIND if source == "kind" else tainted_fixture
    argv = ["-snapshot", path, "-explain", *extra]
    if source == "tainted" and "-semantics" not in argv:
        argv += ["-semantics", "strict"]
    j_rc = j_cli.main(argv)
    j_out = capsys.readouterr().out
    t_rc = t_cli.main(argv + ["-device", "cpu"])
    t_out = capsys.readouterr().out
    assert j_rc == t_rc == 0
    assert t_out == j_out


def test_cli_explain_total_matches_the_fit(capsys):
    # tests/test_explain.py::test_cli_explain_flag on the port: explain
    # explains the numbers the fit returns.
    argv = ["-snapshot", KIND, "-cpuRequests=200m", "-memRequests=250mb",
            "-replicas=10", "-device", "cpu"]
    assert t_cli.main(argv + ["-explain", "-output", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert t_cli.main(argv + ["-output", "json"]) == 0
    fit = json.loads(capsys.readouterr().out)
    assert doc["total_possible_replicas"] == fit[
        "total_possible_replicas"] == 109
    assert set(doc["marginal"]) == {"cpu", "memory", "pods"}


def test_cli_explain_rejects_cpu_backend(capsys):
    rc = t_cli.main(["-snapshot", KIND, "-explain", "-backend", "cpu",
                     "-device", "cpu"])
    assert rc == 1
    out = capsys.readouterr().out
    assert out.startswith("ERROR : -explain runs on the device programs")
    assert "-backend torch" in out
