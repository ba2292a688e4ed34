"""The port's forecast family against ``kubernetesclustercapacity_tpu.forecast``
and ``stochastic.history``, on the CPU.

* ``fit_trend`` and ``trend_oracle`` on seeded series (linear, noisy, with
  outliers, repeated timestamps), their typed errors;
* ``extract_series``, ``extract_usage_history`` and ``trend_from_audit``
  on audit logs the JAX package wrote (time axis sound and degraded);
* ``project_horizon`` (the one ``[H·S]`` exact sweep) and
  ``horizon_oracle`` in both modes, masked, grouped, with growth,
  thresholds and quantile ladders, and their validation errors;
* ``plan_capacity`` (certified, with the drain dual, unsatisfiable and so
  uncertified, a grouped fleet), ``apply_plan``, the catalog grammar.

Tolerance: none.  Trend fits are numpy and ``statistics`` arithmetic on
equal inputs, so their floats are compared with ``==``; ladders,
``time_to_breach_s``, plans, ``certified``, ``lp_bound``, costs and shadow
prices are equal; ``eval_ms`` (a wall time) is left out.
"""

import dataclasses

import numpy as np
import pytest
import torch

from kubernetesclustercapacity_tpu import forecast as jf
from kubernetesclustercapacity_tpu import stochastic as js
from kubernetesclustercapacity_tpu.audit.log import AuditLog
from kubernetesclustercapacity_tpu.masks import implicit_taint_mask
from kubernetesclustercapacity_tpu.snapshot import (
    synthetic_snapshot as j_synthetic,
)
from kubernetesclustercapacity_tpu_torch import forecast as tf
from kubernetesclustercapacity_tpu_torch import stochastic as ts
from kubernetesclustercapacity_tpu_torch.snapshot import (
    ClusterSnapshot as TorchSnapshot,
)

USAGE = {
    "cpu": {"dist": "normal", "mean": "500m", "std": "150m"},
    "memory": {"dist": "lognormal", "mean": "1gb", "sigma": 0.4},
}
CATALOG = {
    "shapes": [
        {"name": "small", "cpu": "4", "memory": "16gb", "pods": 110,
         "unit_cost": 1.0},
        {"name": "big", "cpu": "16", "memory": "128gb", "pods": 250,
         "unit_cost": 6.5},
        {"name": "mem", "cpu": "8", "memory": "64gb", "pods": 110,
         "unit_cost": 3.0, "max_count": 3},
    ]
}


def _port(snap):
    return TorchSnapshot(**{
        f.name: getattr(snap, f.name)
        for f in dataclasses.fields(TorchSnapshot)
    })


def _specs(**over):
    doc = {"usage": USAGE, "replicas": 40, "samples": 32, "seed": 7,
           **over}
    return js.parse_stochastic_spec(doc), ts.parse_stochastic_spec(doc)


def _same_fit(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.level == want.level
    assert got.relative_slope_per_s == want.relative_slope_per_s
    assert got.to_wire() == want.to_wire()


# -- trends ------------------------------------------------------------------

def _series(kind, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 60))
    t = np.cumsum(rng.uniform(1.0, 120.0, size=n)) + 1_000.0
    if kind == "repeated":
        t[1::3] = t[0::3][: len(t[1::3])]
        t = np.sort(t)
    y = 5_000.0 + 3.5 * (t - t[0])
    if kind in ("noisy", "outliers", "repeated"):
        y = y + rng.normal(0.0, 200.0, size=n)
    if kind == "outliers":
        y[rng.integers(0, n, size=max(1, n // 6))] *= 7.0
    if kind == "falling":
        y = 1e9 - 1e4 * (t - t[0]) + rng.normal(0.0, 5.0, size=n)
    return t, y


@pytest.mark.parametrize("kind", ["linear", "noisy", "outliers", "repeated",
                                  "falling"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_trend_fits_equal_jax(kind, seed):
    t, y = _series(kind, seed)
    for degraded in (False, True):
        _same_fit(tf.fit_trend(t, y, degraded_time_axis=degraded),
                  jf.fit_trend(t, y, degraded_time_axis=degraded))
        _same_fit(tf.trend_oracle(t, y, degraded_time_axis=degraded),
                  jf.trend_oracle(t, y, degraded_time_axis=degraded))
    for s in (0.0, 30.0, 1e6):
        assert tf.fit_trend(t, y).value_at(s) == jf.fit_trend(t, y).value_at(s)


@pytest.mark.parametrize("ts_, ys", [
    ([1.0], [2.0]),
    ([5.0, 5.0, 5.0], [1.0, 2.0, 3.0]),
    ([3.0, 2.0, 4.0], [1.0, 2.0, 3.0]),
    ([[1.0, 2.0]], [1.0, 2.0]),
])
def test_trend_errors_equal_jax(ts_, ys):
    for fit in ("fit_trend", "trend_oracle"):
        # ValueError, or the typed InsufficientHistoryError (a RuntimeError)
        with pytest.raises((ValueError, RuntimeError)) as want:
            getattr(jf, fit)(ts_, ys)
        with pytest.raises((ValueError, RuntimeError)) as got:
            getattr(tf, fit)(ts_, ys)
        assert type(got.value).__name__ == type(want.value).__name__
        assert str(got.value) == str(want.value)


def _audit_dir(tmp_path, *, ts_of=lambda g: 1000.0 + g * 60.0, gens=20,
               name="audit"):
    """An audit log of ``gens`` generations the JAX package wrote: cpu and
    memory usage grow, the pods spread over more nodes."""
    d = str(tmp_path / name)
    base = j_synthetic(10, seed=4)
    rng = np.random.default_rng(gens)
    with AuditLog(d, checkpoint_every=3) as log:
        for g in range(1, gens + 1):
            snap = dataclasses.replace(
                base,
                used_cpu_req_milli=(np.asarray(base.used_cpu_req_milli)
                                    + 50 * g + rng.integers(0, 40, 10)
                                    ).astype(np.int64),
                used_mem_req_bytes=(np.asarray(base.used_mem_req_bytes)
                                    + (g << 22)).astype(np.int64),
                pods_count=(np.asarray(base.pods_count)
                            + g // 3).astype(np.int64),
            )
            log.record_generation(snap, g, ts=ts_of(g))
    return d


@pytest.mark.parametrize("axis", ["timestamps", "degraded"])
@pytest.mark.parametrize("resource,kind", [
    ("cpu", "usage"), ("memory", "usage"), ("pods", "usage"),
    ("cpu", "allocatable"), ("memory", "allocatable"),
    ("pods", "allocatable"),
])
def test_series_and_trend_from_jax_written_audit(tmp_path, axis, resource,
                                                 kind):
    ts_of = (lambda g: 1000.0 + g * 60.0) if axis == "timestamps" else (
        lambda g: 777.0)
    d = _audit_dir(tmp_path, ts_of=ts_of)
    want = js.extract_series(d, resource, kind)
    got = ts.extract_series(d, resource, kind)
    for f in ("ts", "totals", "generations"):
        assert np.array_equal(getattr(got, f), getattr(want, f))
    assert got.degraded_time_axis is want.degraded_time_axis
    assert got.to_wire() == want.to_wire()
    if resource != "pods":
        j_fit, _ = jf.trend_from_audit(d, resource, kind)
        t_fit, t_series = tf.trend_from_audit(d, resource, kind)
        _same_fit(t_fit, j_fit)
        assert t_series.degraded_time_axis is (axis == "degraded")


@pytest.mark.parametrize("resource", ["cpu", "memory"])
def test_usage_history_from_jax_written_audit(tmp_path, resource):
    d = _audit_dir(tmp_path, gens=7)
    want = js.extract_usage_history(d, resource)
    got = ts.extract_usage_history(d, resource)
    assert np.array_equal(got.values, want.values)
    assert np.array_equal(got.weights, want.weights)
    assert (got.observations, got.generations) == (want.observations,
                                                   want.generations)
    assert got.distribution() == ts.UsageDistribution(
        **dataclasses.asdict(want.distribution()))
    assert got.to_wire() == want.to_wire()


def test_too_little_history_is_typed_like_jax(tmp_path):
    d = _audit_dir(tmp_path, gens=2)
    empty = tmp_path / "empty"
    empty.mkdir()
    calls = [
        lambda m, f: f.trend_from_audit(d, "cpu", "usage"),
        lambda m, f: m.extract_usage_history(d, "cpu", min_observations=10**9),
        lambda m, f: m.extract_series(str(empty), "cpu"),
        lambda m, f: m.extract_usage_history(str(tmp_path / "missing")),
    ]
    for call in calls:
        with pytest.raises(js.InsufficientHistoryError) as want:
            call(js, jf)
        with pytest.raises(ts.InsufficientHistoryError) as got:
            call(ts, tf)
        assert str(got.value) == str(want.value)
        assert (got.value.generations, got.value.observations) == (
            want.value.generations, want.value.observations)
    for bad in (("gpu", "usage"), ("cpu", "limits")):
        with pytest.raises(ValueError) as want:
            js.extract_series(d, *bad)
        with pytest.raises(ValueError) as got:
            ts.extract_series(d, *bad)
        assert str(got.value) == str(want.value)


# -- the horizon -------------------------------------------------------------

@pytest.fixture(scope="module")
def fleets():
    out = {}
    for name, n, kw in (("small", 24, {}), ("grouped", 1280, {"shapes": 6})):
        jsnap = j_synthetic(n, seed=9, **kw)
        out[name] = (jsnap, _port(jsnap))
    return out


def _same_horizon(got, want):
    assert np.array_equal(got.totals, want.totals)
    assert got.quantiles.keys() == want.quantiles.keys()
    for q in want.quantiles:
        assert np.array_equal(got.quantiles[q], want.quantiles[q])
    assert got.time_to_breach_s == want.time_to_breach_s
    assert got.to_wire() == want.to_wire()


@pytest.mark.parametrize("fleet", ["small", "grouped"])
@pytest.mark.parametrize("mode", ["reference", "strict"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_project_horizon_equals_jax(fleets, fleet, mode, masked):
    jsnap, tsnap = fleets[fleet]
    mask = implicit_taint_mask(jsnap) if not masked else (
        np.random.default_rng(3).random(jsnap.n_nodes) > 0.3)
    jspec, tspec = _specs(samples=24, seed=3, replicas=60)
    kw = dict(steps=6, step_s=1800.0, growth_cpu_per_s=2e-5,
              growth_mem_per_s=1e-5, mode=mode, node_mask=mask)
    want = jf.project_horizon(jsnap, jspec, **kw)
    got = tf.project_horizon(tsnap, tspec, device="cpu", **kw)
    _same_horizon(got, want)
    _same_horizon(tf.horizon_oracle(tsnap, tspec, **kw),
                  jf.horizon_oracle(jsnap, jspec, **kw))
    assert np.array_equal(tf.horizon_oracle(tsnap, tspec, **kw).totals,
                          got.totals)


@pytest.mark.parametrize("kw", [
    dict(steps=12, step_s=3600.0, growth_cpu_per_s=1e-4, threshold=300),
    dict(steps=5, step_s=60.0, growth_cpu_per_s=-3e-3, threshold=10),
    dict(steps=8, step_s=900.0, growth_mem_per_s=5e-5,
         quantiles=(0.5, 0.8, 0.999)),
    dict(steps=1),
], ids=["breach", "shrinking", "ladders", "one-step"])
def test_horizon_forms_equal_jax(fleets, kw):
    jsnap, tsnap = fleets["small"]
    jspec, tspec = _specs(samples=40, seed=12, replicas=200)
    want = jf.project_horizon(jsnap, jspec, degraded_time_axis=True, **kw)
    got = tf.project_horizon(tsnap, tspec, degraded_time_axis=True,
                             device="cpu", **kw)
    _same_horizon(got, want)
    assert got.min_capacity(0.5 if "quantiles" in kw else 0.95) == \
        want.min_capacity(0.5 if "quantiles" in kw else 0.95)


def test_horizon_validation_equals_jax(fleets, monkeypatch):
    jsnap, tsnap = fleets["small"]
    jspec, tspec = _specs(samples=4)
    bad = [dict(steps=0), dict(steps=-1), dict(steps=True), dict(steps=1.5),
           dict(steps=2, step_s=0.0), dict(steps=2, step_s="60")]
    monkeypatch.setenv("KCCAP_FORECAST_MAX_STEPS", "3")
    bad.append(dict(steps=4))
    for kw in bad:
        with pytest.raises(ValueError) as want:
            jf.project_horizon(jsnap, jspec, **kw)
        with pytest.raises(ValueError) as got:
            tf.project_horizon(tsnap, tspec, device="cpu", **kw)
        assert str(got.value) == str(want.value)
    for env in ("3", "junk", "0", ""):
        monkeypatch.setenv("KCCAP_FORECAST_MAX_STEPS", env)
        assert tf.max_steps() == jf.max_steps()
    assert (tf.DEFAULT_STEPS, tf.DEFAULT_STEP_S) == (jf.DEFAULT_STEPS,
                                                      jf.DEFAULT_STEP_S)


# -- the planner -------------------------------------------------------------

def _plan_wire(result):
    wire = result.to_wire()
    assert result.eval_ms >= 0.0
    return wire


@pytest.mark.parametrize("case", [
    dict(n=20, seed=6, spec=dict(replicas=300, samples=32, seed=11),
         target=300, quantile=0.9),
    dict(n=30, seed=12, spec=dict(replicas=50, samples=24, seed=5),
         target=50, drain=True),
    dict(n=30, seed=12, spec=dict(replicas=50, samples=24, seed=5),
         target=900, drain=True, mode="strict"),
    dict(n=1280, seed=2, shapes=6, spec=dict(replicas=100, samples=16,
                                             seed=3),
         target=40_000, quantile=0.95),
    dict(n=12, seed=1, spec=dict(replicas=10, samples=8, seed=2),
         target=5),
], ids=["certified", "drain", "strict-drain", "grouped", "already-holds"])
def test_plan_capacity_equals_jax(case):
    kw = {"shapes": case["shapes"]} if "shapes" in case else {}
    jsnap = j_synthetic(case["n"], seed=case["seed"], **kw)
    tsnap = _port(jsnap)
    jspec, tspec = _specs(**case["spec"])
    opts = {k: case[k] for k in ("target", "quantile", "drain", "mode")
            if k in case}
    mask = implicit_taint_mask(jsnap)
    want = jf.plan_capacity(jsnap, jspec, jf.parse_catalog(CATALOG),
                            node_mask=mask, **opts)
    got = tf.plan_capacity(tsnap, tspec, tf.parse_catalog(CATALOG),
                           node_mask=mask, device="cpu", **opts)
    assert _plan_wire(got) == _plan_wire(want)
    assert (got.certified, got.satisfiable, got.buy) == (
        want.certified, want.satisfiable, want.buy)
    if got.buy:
        grown_t = tf.apply_plan(tsnap, tf.parse_catalog(CATALOG), got.buy)
        grown_j = jf.apply_plan(jsnap, jf.parse_catalog(CATALOG), want.buy)
        assert list(grown_t.names) == list(grown_j.names)
        for f in ("alloc_cpu_milli", "alloc_mem_bytes", "alloc_pods",
                  "pods_count", "healthy", "used_cpu_req_milli"):
            assert np.array_equal(getattr(grown_t, f), getattr(grown_j, f))
        assert grown_t.labels == grown_j.labels
        assert grown_t.taints == grown_j.taints


def test_unsatisfiable_plan_is_uncertified_like_jax():
    jsnap = j_synthetic(4, seed=3)
    tiny = [{"name": "t", "cpu": 1000, "memory": 1 << 30, "pods": 4,
             "unit_cost": 1.0, "max_count": 2}]
    jspec, tspec = _specs(replicas=10 ** 6)
    want = jf.plan_capacity(jsnap, jspec, jf.parse_catalog(tiny),
                            target=10 ** 6)
    got = tf.plan_capacity(_port(jsnap), tspec, tf.parse_catalog(tiny),
                           target=10 ** 6, device="cpu")
    assert _plan_wire(got) == _plan_wire(want)
    assert not got.certified and got.status == "uncertified"
    assert got.uncertified_reason == want.uncertified_reason


BAD_CATALOGS = [
    [],
    {"shapes": "x"},
    [CATALOG["shapes"][0]] * 2,
    [{**CATALOG["shapes"][0], "bogus": 1}],
    [{**CATALOG["shapes"][0], "unit_cost": 0}],
    [{**CATALOG["shapes"][0], "cpu": "4x"}],
    [{**CATALOG["shapes"][0], "memory": "12wat"}],
    [{**CATALOG["shapes"][0], "pods": 0}],
    [{**CATALOG["shapes"][0], "max_count": -1}],
    [{**CATALOG["shapes"][0], "name": ""}],
    [{**CATALOG["shapes"][0], "cpu": 0.5}],
    ["not-an-object"],
]


@pytest.mark.parametrize("bad", BAD_CATALOGS,
                         ids=[f"bad{i}" for i in range(len(BAD_CATALOGS))])
def test_catalog_errors_equal_jax(bad):
    with pytest.raises(jf.PlannerError) as want:
        jf.parse_catalog(bad)
    with pytest.raises(tf.PlannerError) as got:
        tf.parse_catalog(bad)
    assert str(got.value) == str(want.value)


def test_catalog_files_and_plan_errors_equal_jax(tmp_path):
    path = tmp_path / "catalog.yaml"
    path.write_text("shapes:\n  - {name: a, cpu: '8', memory: 32gb, "
                    "pods: 110, unit_cost: 2}\n")
    assert [dataclasses.asdict(s) for s in tf.load_catalog(str(path))] == [
        dataclasses.asdict(s) for s in jf.load_catalog(str(path))]
    jsnap = j_synthetic(4, seed=3)
    jspec, tspec = _specs()
    for kw in (dict(quantile=1.0), dict(target=0), dict(catalog=())):
        catalog = kw.pop("catalog", None)
        with pytest.raises(jf.PlannerError) as want:
            jf.plan_capacity(jsnap, jspec, jf.parse_catalog(CATALOG)
                             if catalog is None else catalog, **kw)
        with pytest.raises(tf.PlannerError) as got:
            tf.plan_capacity(_port(jsnap), tspec, tf.parse_catalog(CATALOG)
                             if catalog is None else catalog, device="cpu",
                             **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(tf.PlannerError, match="unknown catalog shape"):
        tf.apply_plan(_port(jsnap), tf.parse_catalog(CATALOG), {"nope": 1})


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_forecast_default_device_raises_without_cuda(no_cuda, fleets):
    _, tsnap = fleets["small"]
    _, tspec = _specs(samples=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tf.project_horizon(tsnap, tspec, steps=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tf.plan_capacity(tsnap, tspec, tf.parse_catalog(CATALOG), target=5)
    # The oracles and the host closed forms stay usable, as in the JAX
    # package.
    assert tf.horizon_oracle(tsnap, tspec, steps=2).totals.shape == (2, 4)
