"""The port's single-spec surface against the JAX package's, on the CPU:
the oracle (``reference_run``, ``fit_arrays_python``), the renderers, and
the CLI's transcript, JSON and table, byte for byte.

The CLI cases are those of ``tests/test_cli_report.py``
(``TestReferenceReport``, ``TestOtherFormats``, ``TestTranscriptSideEffects``
and the single-spec ``TestCli`` / ``TestExtendedRequestsCLI`` cases) on
``tests/fixtures/kind-3node.json`` and their inline fixtures.  The port
runs with ``-device cpu``; its ``-backend torch`` is the JAX CLI's
``-backend tpu``.  Tolerance: none — integers compare exactly and every
rendered string byte for byte.
"""

import dataclasses
import json
import math

import numpy as np
import pytest

from kubernetesclustercapacity_tpu import cli as j_cli
from kubernetesclustercapacity_tpu import oracle as j_oracle
from kubernetesclustercapacity_tpu import report as j_report
from kubernetesclustercapacity_tpu import snapshot as j_snapshot
from kubernetesclustercapacity_tpu.fixtures import (
    load_fixture,
    synthetic_fixture,
)
from kubernetesclustercapacity_tpu.scenario import Scenario as JScenario
from kubernetesclustercapacity_tpu.scenario import scenario_from_flags
from kubernetesclustercapacity_tpu_torch import cli as t_cli
from kubernetesclustercapacity_tpu_torch import oracle as t_oracle
from kubernetesclustercapacity_tpu_torch import report as t_report
from kubernetesclustercapacity_tpu_torch import scenario as t_scenario
from kubernetesclustercapacity_tpu_torch import snapshot as t_snapshot

KIND = "tests/fixtures/kind-3node.json"
MIB = 1024 * 1024


def _conds():
    return [{"type": t, "status": "False"} for t in "abcd"]


def _node(name, *, cpu="4", mem="8388608Ki", pods="110", unhealthy=False):
    conds = _conds()
    if unhealthy:
        conds[0] = {"type": "c", "status": "True"}
    return {"name": name, "conditions": conds,
            "allocatable": {"cpu": cpu, "memory": mem, "pods": pods}}


def _pod(name, node, containers, phase="Running"):
    return {"name": name, "namespace": "d", "nodeName": node, "phase": phase,
            "containers": containers}


def _gpu_fixture():
    fx = synthetic_fixture(8, seed=13)
    for n in fx["nodes"]:
        n["allocatable"]["nvidia.com/gpu"] = "4"
    return fx


# -- the oracle ------------------------------------------------------------

# tests/test_oracle.py::TestReferenceRun's fixtures and scenarios.
ORACLE_CASES = {
    "kind-sample": (lambda: load_fixture(KIND), (200, 250 * MIB, 10, 400,
                                                 500 * MIB)),
    "pod-cap-quirk": (lambda: {"nodes": [_node("n", cpu="8", mem="1048576Ki",
                                               pods="5")], "pods": []},
                      (100, MIB, 1)),
    "pod-cap-below-threshold": (lambda: {
        "nodes": [_node("n", cpu="10", mem="104857600Ki")],
        "pods": [_pod(f"p{i}", "n", [{"resources": {}}]) for i in range(50)],
    }, (100, MIB, 1)),
    "negative-fit-from-cap": (lambda: {
        "nodes": [_node("n", cpu="64", mem="104857600Ki", pods="2")],
        "pods": [_pod(f"p{i}", "n", [{"resources": {}}]) for i in range(5)],
    }, (100, MIB, 1)),
    "phantom-orphans": (lambda: synthetic_fixture(
        3, seed=7, unhealthy_frac=1.0, unscheduled_running_pods=4),
        (100, MIB, 1)),
    "full-node-zero-request": (lambda: {
        "nodes": [_node("n", cpu="1", mem="1024Ki")],
        "pods": [_pod("p", "n", [{"resources": {"requests": {
            "cpu": "2", "memory": "1Gi"}}}])],
    }, (0, 0, 1)),
    "phantom-percentages": (lambda: synthetic_fixture(
        2, seed=9, unhealthy_frac=1.0), (100, MIB, 1)),
    "verdict-short": (lambda: load_fixture(KIND), (200, 250 * MIB, 110)),
    "verdict-edge": (lambda: load_fixture(KIND), (200, 250 * MIB, 109)),
    "synthetic-unhealthy": (lambda: synthetic_fixture(
        40, seed=3, unhealthy_frac=0.2, unscheduled_running_pods=3),
        (150, 200 * 1000 * 1000, 7)),
    "wrapped-cpu-request": (lambda: load_fixture(KIND),
                            ((1 << 64) - 5000, 250 * MIB, 1)),
}


def _rows(result):
    """Every field of every per-node row, NaN made comparable."""
    def norm(v):
        return "NaN" if isinstance(v, float) and math.isnan(v) else v

    return [tuple(norm(v) for v in dataclasses.astuple(r))
            for r in result.per_node]


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_reference_run_matches_jax(case):
    build, spec = ORACLE_CASES[case]
    fx = build()
    want = j_oracle.reference_run(fx, JScenario(*spec))
    got = t_oracle.reference_run(fx, t_scenario.Scenario(*spec))
    assert _rows(got) == _rows(want)
    assert got.fits == want.fits
    assert got.total_possible_replicas == want.total_possible_replicas
    assert got.schedulable == want.schedulable


def test_reference_run_kind_sample_by_hand():
    # Hand-computed in tests/test_oracle.py: cpu (8000-650)//200 = 36 on
    # both first nodes, (8000-600)//200 = 37 on the last.
    r = t_oracle.reference_run(
        load_fixture(KIND), t_scenario.Scenario(200, 250 * MIB, 10, 400,
                                                500 * MIB))
    assert r.fits == [36, 36, 37]
    assert r.total_possible_replicas == 109 and r.schedulable
    assert math.isnan(t_oracle.reference_run(
        synthetic_fixture(2, seed=9, unhealthy_frac=1.0),
        t_scenario.Scenario(100, MIB, 1),
    ).per_node[0].cpu_request_used_percent)


def test_reference_run_panics_like_jax():
    fx = load_fixture(KIND)
    with pytest.raises(j_oracle.ReferencePanic) as want:
        j_oracle.reference_run(fx, JScenario(0, MIB, 1))
    with pytest.raises(t_oracle.ReferencePanic) as got:
        t_oracle.reference_run(fx, t_scenario.Scenario(0, MIB, 1))
    assert str(got.value) == str(want.value)
    big = synthetic_fixture(4, seed=1)
    with pytest.raises(t_oracle.ReferencePanic, match="makeslice"):
        t_oracle.reference_run(big, t_scenario.Scenario(100, MIB, 1),
                               emulate_slice_bug=True)
    assert len(t_oracle.healthy_nodes(big)) == 4


def test_non_terminated_pods_match_jax():
    fx = synthetic_fixture(6, seed=3, unscheduled_running_pods=2)
    for name in [n["name"] for n in fx["nodes"]] + [""]:
        assert t_oracle.non_terminated_pods_for_node(fx, name) == \
            j_oracle.non_terminated_pods_for_node(fx, name)


@pytest.mark.parametrize("mode", ["reference", "strict"])
@pytest.mark.parametrize("seed", [30, 31])
def test_fit_arrays_python_matches_jax(mode, seed):
    rng = np.random.default_rng(seed)
    n = 300

    def mixed(lo, hi):
        v = rng.integers(lo, hi, size=n, dtype=np.int64)
        return np.where(rng.random(n) < 0.1,
                        rng.integers(-(2**62), 2**62, size=n), v)

    cols = [mixed(0, 10**6), mixed(0, 2**45), rng.integers(0, 200, n),
            mixed(0, 10**6), mixed(0, 2**45), rng.integers(0, 300, n)]
    cols[0][:3] = [-1, -(2**63), 2**63 - 1]
    cols[3][:3] = [-(2**63), -1, 0]
    cols[1][3], cols[4][3] = 0, -(2**63)  # headroom wraps to INT64_MIN
    healthy = rng.random(n) < 0.8
    for cpu, mem in ((100, MIB), (1, 1), ((1 << 64) - 5000, 7), (-3, 1024)):
        got = t_oracle.fit_arrays_python(*cols, cpu, mem, mode=mode,
                                         healthy=healthy)
        want = j_oracle.fit_arrays_python(*cols, cpu, mem, mode=mode,
                                          healthy=healthy)
        assert got == want


def test_fit_arrays_python_refuses_what_jax_refuses():
    cols = [[1000], [MIB], [10], [0], [0], [0]]
    with pytest.raises(t_oracle.ReferencePanic, match="divide by zero"):
        t_oracle.fit_arrays_python(*cols, 0, MIB)
    with pytest.raises(ValueError, match="unknown mode"):
        t_oracle.fit_arrays_python(*cols, 1, 1, mode="lenient")


# -- the renderers ---------------------------------------------------------


@pytest.mark.parametrize("semantics", ["reference", "strict"])
@pytest.mark.parametrize("flags", [
    {"cpuRequests": "200m", "cpuLimits": "400m", "memRequests": "250mb",
     "memLimits": "500mb", "replicas": "10"},
    {"cpuRequests": "200m", "memRequests": "250mb", "replicas": "500"},
    {"cpuRequests": "-5", "cpuLimits": "2.5", "replicas": "-5"},
], ids=["sample", "unschedulable", "codec-errors"])
def test_renderers_match_jax(semantics, flags):
    fx = synthetic_fixture(12, seed=7, unhealthy_frac=0.3,
                           unscheduled_running_pods=2)
    jsnap = j_snapshot.snapshot_from_fixture(fx, semantics=semantics)
    tsnap = t_snapshot.snapshot_from_fixture(fx, semantics=semantics)
    js = scenario_from_flags(**flags)
    ts = t_scenario.scenario_from_flags(**flags)
    fits = np.random.default_rng(5).integers(-3, 40, jsnap.n_nodes)
    for name in ("reference_report", "json_report", "table_report"):
        assert getattr(t_report, name)(tsnap, fits, ts) == getattr(
            j_report, name)(jsnap, fits, js), name


# -- the CLI ---------------------------------------------------------------


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """Every fixture the CLI cases read, written once."""
    d = tmp_path_factory.mktemp("report")
    huge = "9223372036854775807m"
    fixtures = {
        "phantom": synthetic_fixture(3, seed=7, unhealthy_frac=1.0,
                                     unscheduled_running_pods=1),
        "cross": synthetic_fixture(25, seed=3, unhealthy_frac=0.2),
        "tainted": synthetic_fixture(40, seed=4, taint_frac=0.3,
                                     unhealthy_frac=0.1),
        "gpu": _gpu_fixture(),
        "skip": {"nodes": [_node("good-1"), _node("sick", unhealthy=True),
                           _node("good-2")], "pods": []},
        "codec-node": {"nodes": [_node("weird", cpu="4.5")], "pods": []},
        "codec-pod": {"nodes": [_node("n0")], "pods": [_pod("p", "n0", [
            {"resources": {"requests": {"cpu": "0.25"},
                           "limits": {"cpu": "bogus"}}}])]},
        "wrapped-sums": {"nodes": [_node("n0")], "pods": [_pod("p", "n0", [
            {"resources": {"requests": {"cpu": huge}}},
            {"resources": {"requests": {"cpu": huge}}}])]},
    }
    out = {"kind": KIND}
    for name, fx in fixtures.items():
        path = d / f"{name}.json"
        path.write_text(json.dumps(fx))
        out[name] = str(path)
    for semantics in ("reference", "strict"):
        path = str(d / f"kind-{semantics}.npz")
        j_snapshot.snapshot_from_fixture(
            load_fixture(KIND), semantics=semantics).save(path)
        out[f"kind-{semantics}.npz"] = path
    return out


SAMPLE = ["-cpuRequests=200m", "-cpuLimits=400m", "-memRequests=250mb",
          "-memLimits=500mb", "-replicas=10"]
_BOTH = ("torch", "cpu")

# (id, source, flags, port backends).  Each runs the JAX CLI (-backend tpu
# for torch) and the port's CLI (-device cpu) with the same flags.
CLI_CASES = [
    # TestReferenceReport
    ("transcript-content", "kind", SAMPLE, _BOTH),
    ("unschedulable-typo", "kind",
     ["-cpuRequests=200m", "-memRequests=250mb", "-replicas=500"], _BOTH),
    ("phantom-percentages", "phantom", [], _BOTH),
    ("cpu-backend-cross-check", "cross",
     ["-cpuRequests=150m", "-memRequests=200mb"], _BOTH),
    # TestOtherFormats
    ("json-report", "kind", ["-replicas=10", "-output", "json"], _BOTH),
    ("table-report", "kind", ["-replicas=200", "-output", "table"], _BOTH),
    # TestCli
    ("sample-run", "kind", SAMPLE, _BOTH),
    ("all-backends-agree", "kind", [], _BOTH),
    ("json-output", "kind", ["-output", "json", "-replicas=10",
                             "-cpuRequests=200m", "-memRequests=250mb"],
     _BOTH),
    ("strict-semantics-table", "kind", ["-semantics", "strict", "-output",
                                        "table"], _BOTH),
    ("npz-stored-semantics", "kind-strict.npz", ["-replicas=10"], _BOTH),
    ("npz-reference", "kind-reference.npz", ["-replicas=10"], _BOTH),
    ("tainted-strict", "tainted", ["-semantics", "strict"], _BOTH),
    ("tainted-strict-json", "tainted", ["-semantics", "strict", "-output",
                                        "json", "-replicas=3000"], _BOTH),
    # TestTranscriptSideEffects
    ("skip-lines", "skip", [], _BOTH),
    ("node-codec-error", "codec-node", [], _BOTH),
    ("pod-codec-errors", "codec-pod", [], _BOTH),
    ("flag-codec-errors", "kind", ["-cpuRequests=250m", "-cpuLimits=2.5"],
     _BOTH),
    ("wrapped-cpu-request", "kind", ["-cpuRequests=-5"], _BOTH),
    ("wrapped-cpu-request-strict", "kind", ["-cpuRequests=-5", "-semantics",
                                            "strict"], _BOTH),
    ("negative-replicas", "kind", ["-replicas=-5"], _BOTH),
    ("wrapped-cpu-sums", "wrapped-sums", [], _BOTH),
    # TestExtendedRequestsCLI (single spec)
    ("gpu-request-binds", "gpu",
     ["-semantics", "strict", "-extended-request", "nvidia.com/gpu=2",
      "-cpuRequests=100m", "-memRequests=64mb", "-output", "json"],
     ("torch",)),
    ("gpu-unlimited", "gpu",
     ["-semantics", "strict", "-cpuRequests=100m", "-memRequests=64mb",
      "-output", "json"], _BOTH),
    ("gpu-matches-model", "gpu",
     ["-semantics", "strict", "-extended-request", "nvidia.com/gpu=1",
      "-output", "json"], ("torch",)),
    ("gpu-transcript", "gpu",
     ["-semantics", "strict", "-extended-request", "nvidia.com/gpu=1"],
     ("torch",)),
    ("gpu-table", "gpu",
     ["-semantics", "strict", "-extended-request", "nvidia.com/gpu=3",
      "-output", "table"], ("torch",)),
]


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("case", CLI_CASES, ids=lambda c: c[0])
def test_single_spec_cli_matches_jax(case, sources, capsys):
    _, source, flags, backends = case
    for backend in backends:
        argv = ["-snapshot", sources[source], *flags]
        j_rc, j_out = _run(
            j_cli.main,
            argv + ["-backend", "tpu" if backend == "torch" else backend],
            capsys,
        )
        t_rc, t_out = _run(
            t_cli.main, argv + ["-backend", backend, "-device", "cpu"],
            capsys,
        )
        assert j_rc == t_rc == 0, (backend, t_out[-300:])
        assert t_out == j_out, backend
        assert t_out


def test_backends_and_fits_agree(sources, capsys):
    # test_all_backends_agree and test_cpu_backend_cross_check on the port:
    # the transcript from the device program equals the oracle's.
    for source in ("kind", "cross", "phantom", "tainted"):
        outs = {
            b: _run(t_cli.main, ["-snapshot", sources[source], "-backend", b,
                                 "-device", "cpu"], capsys)
            for b in _BOTH
        }
        assert outs["torch"] == outs["cpu"], source
    _, out = _run(t_cli.main, ["-snapshot", KIND, *SAMPLE, "-device", "cpu"],
                  capsys)
    assert ("Total possible replicas for the pod with required input specs "
            ": 109") in out
    assert "go ahead with deployment of 10 pod replicas" in out


@pytest.mark.parametrize(
    "flags",
    [
        ["-memRequests=garbage"],
        ["-memLimits=12"],
        ["-replicas=ten"],
        ["-replicas=\x01en"],
        ["-replicas=99999999999999999999"],
        ["-replicas=-99999999999999999999"],
        ["-cpuRequests=half"],
        ["-memRequests=0.5B"],
    ],
    ids=["bad-mem", "bad-mem-limits", "bad-replicas", "control-char",
         "replicas-range", "replicas-negative-range", "zero-cpu-request",
         "zero-mem-request"],
)
def test_single_spec_error_lines_match_jax(flags, capsys):
    argv = ["-snapshot", KIND, *flags]
    j_rc, j_out = _run(j_cli.main, argv, capsys)
    t_rc, t_out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
    assert j_rc == t_rc == 1
    assert t_out == j_out


@pytest.mark.parametrize(
    "source,flags",
    [
        ("missing", []),
        ("kind-strict.npz", ["-semantics", "reference"]),
        ("gpu", ["-semantics", "strict",
                 "-extended-request", "nvidia.com/gpu=not-a-qty"]),
        ("gpu", ["-extended-request", "nvidia.com/gpu=1"]),
        ("gpu", ["-semantics", "strict",
                 "-extended-request", "nvidia.com/gpu"]),
        ("kind-strict.npz", ["-extended-request", "nvidia.com/gpu=1"]),
    ],
    ids=["missing-file", "npz-semantics-conflict", "extended-bad-quantity",
         "extended-reference-semantics", "extended-no-equals",
         "extended-npz-missing-column"],
)
def test_single_spec_source_errors_match_jax(source, flags, sources, capsys):
    path = sources.get(source, "tests/fixtures/missing.json")
    argv = ["-snapshot", path, *flags]
    j_rc, j_out = _run(j_cli.main, argv, capsys)
    t_rc, t_out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
    assert j_rc == t_rc == 1
    assert t_out == j_out
    assert t_out.startswith("ERROR")


def test_extended_request_needs_the_torch_backend(sources, capsys):
    argv = ["-snapshot", sources["gpu"], "-semantics", "strict",
            "-extended-request", "nvidia.com/gpu=1", "-backend", "cpu"]
    j_rc, j_out = _run(j_cli.main, argv, capsys)
    t_rc, t_out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
    assert j_rc == t_rc == 1
    assert t_out == j_out.replace("-backend tpu", "-backend torch")


# The stochastic family's renderers: the wire shapes of real JAX results
# and hand-made status forms (watches on, breached, cells missing), each
# through both packages' renderers.

def _stochastic_wires():
    from kubernetesclustercapacity_tpu import forecast as jf
    from kubernetesclustercapacity_tpu import stochastic as js

    snap = j_snapshot.synthetic_snapshot(30, seed=12)
    spec = js.parse_stochastic_spec({
        "usage": {"cpu": {"dist": "normal", "mean": "500m", "std": "150m"},
                  "memory": {"dist": "lognormal", "mean": "1gb",
                             "sigma": 0.4}},
        "replicas": 50, "samples": 24, "seed": 5})
    catalog = jf.parse_catalog([
        {"name": "small", "cpu": "4", "memory": "16gb", "pods": 110,
         "unit_cost": 1.0},
        {"name": "big", "cpu": "16", "memory": "128gb", "pods": 250,
         "unit_cost": 6.5}])
    car = js.capacity_at_risk(snap, spec).to_wire()
    horizon = jf.project_horizon(snap, spec, steps=5, step_s=7200.0,
                                 growth_cpu_per_s=1e-4, threshold=800)
    horizon.trend = {"source": "audit", "cpu": {"slope_per_s": 1.0}}
    fc = horizon.to_wire()
    fc_degraded = dict(fc, degraded_time_axis=True,
                       time_to_breach_s={"p50": None, "p90": 1800.0,
                                         "p95": 0.0, "p99": 1e5})
    plan = jf.plan_capacity(snap, spec, catalog, target=900,
                            drain=True).to_wire()
    holds = jf.plan_capacity(snap, spec, catalog, target=1).to_wire()
    stuck = jf.plan_capacity(snap, spec, jf.parse_catalog([
        {"name": "t", "cpu": 1000, "memory": 1 << 30, "pods": 4,
         "unit_cost": 1.0, "max_count": 1}]), target=10 ** 6).to_wire()
    car_status = {
        "enabled": True, "generation": 7, "breached": ["tight"],
        "watches": {
            "tight": {"quantile": 0.95, "last_total": 12, "min_replicas": 40,
                      "prob_fit": 0.25, "samples": 64,
                      "alert": {"state": "breached"}},
            "loose": {"quantile": 0.5, "last_total": None,
                      "min_replicas": None, "prob_fit": None,
                      "samples": 32, "alert": {"state": "ok"}},
        },
    }
    fc_status = {
        "enabled": True, "generation": 9, "breached": [],
        "watches": {
            "horizon": {"quantile": 0.99, "last_total": 300,
                        "horizon_min_capacity": 120, "min_replicas": 100,
                        "time_to_breach_s": 7200.0,
                        "alert": {"state": "ok"}},
            "short": {"quantile": 0.9, "last_total": None,
                      "horizon_min_capacity": None, "min_replicas": 5,
                      "time_to_breach_s": None,
                      "alert": {"state": "recovered"}},
        },
    }
    off = {"enabled": False, "watches": {}, "breached": []}
    return [
        ("car", car), ("forecast", fc), ("forecast", fc_degraded),
        ("plan", plan), ("plan", holds), ("plan", stuck),
        ("car_status", car_status), ("car_status", off),
        ("forecast_status", fc_status), ("forecast_status", off),
    ]


STOCHASTIC_WIRES = _stochastic_wires()


@pytest.mark.parametrize("kind,wire", STOCHASTIC_WIRES,
                         ids=[f"{k}{i}" for i, (k, _) in
                              enumerate(STOCHASTIC_WIRES)])
@pytest.mark.parametrize("form", ["table", "json"])
def test_stochastic_renderers_match_jax(kind, wire, form):
    name = f"{kind}_{form}_report"
    assert getattr(t_report, name)(wire) == getattr(j_report, name)(wire)
    assert name in t_report.__all__


# The gang and optimize renderers: the wire shapes of real JAX results (gang
# with and without its explanation, every constraint spelling; the LP solve
# certified, uncertified and over-bound, and the first-fit form) and
# hand-made status forms, each through both packages' renderers.

def _gang_optimize_wires():
    from kubernetesclustercapacity_tpu import optimize as jo
    from kubernetesclustercapacity_tpu import topology as jt
    from kubernetesclustercapacity_tpu.fixtures import synthetic_fixture
    from kubernetesclustercapacity_tpu.scenario import (
        ScenarioGrid,
        random_scenario_grid,
    )

    fx = synthetic_fixture(40, seed=8, topology=(2, 2))
    for node in fx["nodes"][:4]:
        del node["labels"]["topology.kubernetes.io/rack"]
    snap = j_snapshot.snapshot_from_fixture(fx, semantics="strict")
    one = ScenarioGrid(cpu_request_milli=np.array([500]),
                       mem_request_bytes=np.array([1 << 30]),
                       replicas=np.array([1]))
    grid = random_scenario_grid(3, seed=2)
    wires = []
    for kw in (dict(ranks=8, colocate="rack", count=2),
               dict(ranks=12, colocate="zone", spread_level="rack",
                    max_ranks_per_domain=4),
               dict(ranks=6, anti_affinity_host=True, count=100),
               dict(ranks=3)):
        spec = jt.GangSpec(**kw)
        wire = jt.gang_capacity(snap, one, spec, missing="exclude").to_wire()
        wire["explain"] = jt.gang_explain(snap, one, spec, missing="exclude")
        wires.append(("gang", wire))
    wires.append(("gang", jt.gang_capacity(
        snap, grid, jt.GangSpec(ranks=5, colocate="rack")).to_wire()))
    opt_snap = j_snapshot.synthetic_snapshot(64, seed=6, shapes=4)
    wires.append(("optimize", jo.optimize_snapshot(
        opt_snap, random_scenario_grid(4, seed=3)).to_wire()))
    uncertified = jo.optimize_snapshot(
        opt_snap, ScenarioGrid(cpu_request_milli=np.array([1500]),
                               mem_request_bytes=np.array([1 << 30]),
                               replicas=np.array([10**8])),
        mode="strict", max_iters=1).to_wire()
    wires.append(("optimize", uncertified))
    wires.append(("optimize", dict(uncertified, verified=[False],
                                   ffd_exceeds_bound=[True])))
    wires.append(("optimize", {
        "backend": "ffd", "mode": "reference", "scenarios": 2,
        "demand": [5, 900], "ffd": [5, 640], "totals": [1200, 640],
        "schedulable": [True, False]}))
    status = {
        "enabled": True, "generation": 4, "breached": ["train-64"],
        "watches": {
            "train-64": {"ranks": 64, "count": 4, "last_gangs": 2,
                         "min_replicas": 4, "binding": "rack",
                         "alert": {"state": "breached"}},
            "infer-8": {"ranks": 8, "count": 1, "last_gangs": None,
                        "min_replicas": None, "binding": None,
                        "alert": {"state": "ok"}},
        },
    }
    off = {"enabled": False, "watches": {}, "breached": []}
    wires += [("gang_status", status), ("gang_status", off),
              ("gang_status", dict(status, breached=[]))]
    return wires


GANG_OPTIMIZE_WIRES = _gang_optimize_wires()


@pytest.mark.parametrize("kind,wire", GANG_OPTIMIZE_WIRES,
                         ids=[f"{k}{i}" for i, (k, _) in
                              enumerate(GANG_OPTIMIZE_WIRES)])
@pytest.mark.parametrize("form", ["table", "json"])
def test_gang_and_optimize_renderers_match_jax(kind, wire, form):
    name = f"{kind}_{form}_report"
    assert getattr(t_report, name)(wire) == getattr(j_report, name)(wire)
    assert name in t_report.__all__


# The operator's renderers: the timeline, SLO and flight-recorder views
# over wire shapes of every form their servers answer.
_WATCH = {"total": 12, "schedulable": True, "breached": False,
          "mode": "reference", "min_replicas": None,
          "binding_counts": {"cpu": 2, "memory": 1}}
TIMELINE_WIRES = {
    "disabled": {"enabled": False},
    "empty": {"enabled": True, "depth": 64, "count": 0, "generation": 0,
              "watchlist": [], "records": [], "deltas": [], "alerts": {}},
    "watches": {
        "enabled": True, "depth": 8, "count": 2, "generation": 2,
        "watchlist": [{"name": "web-tier-with-a-long-name"}, {"name": "fc"},
                      {"name": "absent"}],
        "records": [
            {"generation": 1, "nodes": 3, "healthy_nodes": 3,
             "digest": "ab" * 8, "watches": {
                 "web-tier-with-a-long-name": dict(_WATCH),
                 "fc": dict(_WATCH, horizon_s=7200.0, time_to_breach_s=None,
                            horizon_min_capacity=None,
                            degraded_time_axis=True)}},
            {"generation": 2, "nodes": 2, "healthy_nodes": 1,
             "digest": "cd" * 8, "watches": {
                 "web-tier-with-a-long-name": dict(_WATCH, total=3,
                                                   breached=True),
                 "fc": dict(_WATCH, horizon_s=7200.0,
                            time_to_breach_s=5400.5,
                            horizon_min_capacity=4)}},
        ],
        "deltas": [{"from_generation": 1, "to_generation": 2,
                    "nodes_added": [], "nodes_removed": ["n1"],
                    "nodes_changed": 1, "watches": {
                        "fc": {"summary": "fc: capacity 12→12 (no change)"},
                        "web-tier-with-a-long-name": {
                            "summary": "capacity 12→3: node n1 removed"}}}],
        "alerts": {"web-tier-with-a-long-name": {
            "state": "breached", "min_replicas": 5, "last_total": 3,
            "breaches": 1},
            "fc": {"state": "ok", "min_replicas": None, "last_total": 12,
                   "breaches": 0}},
    },
}
_SLO_STATUS = {"objective": "p99 < 80ms", "op": "sweep", "state": "ok",
               "short_burn": None, "long_burn": 0.25, "fast_burn": 14.0}
SLO_WIRES = {
    "disabled": {"enabled": False},
    "ok": {"enabled": True, "evaluations": 3, "status": {
        "lat": dict(_SLO_STATUS),
        "availability": dict(_SLO_STATUS, objective="availability >= 99%",
                             op=None, short_burn=0.0)}},
    "breached": {"enabled": True, "evaluations": 9, "status": {
        "lat": dict(_SLO_STATUS, state="breached", short_burn=31.5,
                    long_burn=15.25),
        "z": dict(_SLO_STATUS, state="recovered", short_burn=1.0)}},
}
DUMP_WIRES = {
    "empty": {"records": [], "count": 0, "matched": 0, "capacity": 256,
              "dropped": 0, "generation": 1},
    "records": {"count": 2, "capacity": 4, "dropped": 3, "generation": 7,
                "records": [
                    {"seq": 4, "op": "sweep", "generation": 6,
                     "latency_ms": 1.25, "status": "ok",
                     "phases": {"device_exec": 0.5, "fetch": 0.5,
                                "queue_wait": 0.125}},
                    {"seq": 5, "op": "fit", "generation": 7,
                     "latency_ms": 0.5, "status": "error",
                     "error": "ScenarioError: bad"}]},
}


@pytest.mark.parametrize("kind,wire,form", [
    (kind, name, form)
    for kind, wires in (("timeline", TIMELINE_WIRES), ("slo", SLO_WIRES),
                        ("dump", DUMP_WIRES))
    for name in wires
    for form in ("table", "json")
])
def test_operator_renderers_match_jax(kind, wire, form):
    wires = {"timeline": TIMELINE_WIRES, "slo": SLO_WIRES,
             "dump": DUMP_WIRES}[kind]
    fn = f"{kind}_{form}_report"
    assert (getattr(t_report, fn)(wires[wire])
            == getattr(j_report, fn)(wires[wire]))
