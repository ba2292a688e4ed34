"""The port's ``CapacityModel`` and ``PodSpec`` against
``kubernetesclustercapacity_tpu.models``, on the CPU.

``evaluate`` (2-resource, extended, constrained, spread), ``sweep`` (the
B1 dispatcher) and ``sweep_multi`` (the B2 dispatcher) get the same
snapshots and specs in both packages — the cases of
``tests/test_masks_multi.py`` plus seeded synthetic fleets — in both
modes.  Tolerance: none — every fit and total is an integer.
"""

import dataclasses

import numpy as np
import pytest

from kubernetesclustercapacity_tpu import masks as j_masks
from kubernetesclustercapacity_tpu import models as j_models
from kubernetesclustercapacity_tpu import snapshot as j_snapshot
from kubernetesclustercapacity_tpu.fixtures import (
    load_fixture,
    synthetic_fixture,
)
from kubernetesclustercapacity_tpu.ops import pallas_fit as j_pallas
from kubernetesclustercapacity_tpu.ops import pallas_multi as j_pallas_multi
from kubernetesclustercapacity_tpu.scenario import (
    MultiResourceGrid,
    ScenarioGrid,
    random_scenario_grid,
)
from kubernetesclustercapacity_tpu_torch import masks as t_masks
from kubernetesclustercapacity_tpu_torch import models as t_models
from kubernetesclustercapacity_tpu_torch import scenario as t_scenario
from kubernetesclustercapacity_tpu_torch import snapshot as t_snapshot
from kubernetesclustercapacity_tpu_torch.models import capacity as t_capacity
from kubernetesclustercapacity_tpu_torch.ops import fused_fit as t_fused
from kubernetesclustercapacity_tpu_torch.ops import fused_multi as t_multi

MIB = 1024 * 1024
GIB = 1024 * MIB
KIND = "tests/fixtures/kind-3node.json"


def _label(name):
    return name.replace("pallas_", "plain_").replace("xla_int64", "torch_int64")


def _kind_fixture():
    fx = load_fixture(KIND)
    fx["pods"][8]["labels"] = {"app": "web"}  # the web pod on kind-worker
    return fx


def _scoped_fixture():
    """tests/test_masks_multi.py::TestSchedulerFidelity's fleet: zones and
    two labelled db pods in two namespaces."""
    return {
        "nodes": [
            {"name": f"n{i}",
             "allocatable": {"cpu": "4", "memory": "8388608Ki", "pods": "110"},
             "conditions": [{"type": t, "status": "False"} for t in (
                 "OutOfDisk", "MemoryPressure", "DiskPressure",
                 "PIDPressure")] + [{"type": "Ready", "status": "True"}],
             "labels": {"zone": f"z{i % 2}"}}
            for i in range(3)
        ],
        "pods": [
            {"name": "db-web", "namespace": "web", "nodeName": "n0",
             "phase": "Running", "labels": {"app": "db"}, "containers": []},
            {"name": "db-staging", "namespace": "staging", "nodeName": "n1",
             "phase": "Running", "labels": {"app": "db"}, "containers": []},
        ],
    }


def _gpu_fixture(n=300, seed=41):
    fx = synthetic_fixture(n, seed=seed, taint_frac=0.2, unhealthy_frac=0.1)
    rng = np.random.default_rng(seed)
    for node in fx["nodes"]:
        node["allocatable"]["nvidia.com/gpu"] = str(int(rng.integers(0, 9)))
        node["allocatable"]["ephemeral-storage"] = \
            f"{int(rng.integers(50, 501))}Gi"
    for pod in fx["pods"][::3]:
        pod["containers"] = [{"resources": {"requests": {
            "cpu": "250m", "memory": "256Mi",
            "nvidia.com/gpu": str(int(rng.integers(0, 3))),
            "ephemeral-storage": f"{int(rng.integers(1, 20))}Gi"}}}]
    return fx


EXTENDED = ("ephemeral-storage", "nvidia.com/gpu")

FIXTURES = {
    "kind": _kind_fixture,
    "scoped": _scoped_fixture,
    "gpu": _gpu_fixture,
    "synthetic": lambda: synthetic_fixture(
        500, seed=17, taint_frac=0.3, unhealthy_frac=0.2),
}


def _pack(name, semantics):
    """The fixture, and each package's snapshot of it."""
    fx = FIXTURES[name]()
    extended = EXTENDED if name == "gpu" and semantics == "strict" else ()
    return (
        fx,
        j_snapshot.snapshot_from_fixture(
            fx, semantics=semantics, extended_resources=extended),
        t_snapshot.snapshot_from_fixture(
            fx, semantics=semantics, extended_resources=extended),
    )


def _specs(j, t, **kw):
    return j.PodSpec(**kw), t.PodSpec(**kw)


# -- PodSpec ---------------------------------------------------------------


@pytest.mark.parametrize(
    "kw,match",
    [
        ({"spread": 0}, "spread"),
        ({"replicas": -1}, "replicas"),
        ({"namespace": 7}, "namespace"),
        ({"extended_requests": {"cpu": 2}}, "aliases a core resource"),
        ({"extended_requests": {"nvidia.com/gpu": -1}}, "must be >= 0"),
    ],
    ids=["spread-zero", "negative-replicas", "namespace-type",
         "core-alias", "negative-extended"],
)
def test_podspec_refuses_what_jax_refuses(kw, match):
    base = {"cpu_request_milli": 100, "mem_request_bytes": MIB}
    with pytest.raises(ValueError, match=match) as want:
        j_models.PodSpec(**base, **kw)
    with pytest.raises(ValueError, match=match) as got:
        t_models.PodSpec(**base, **kw)
    assert str(got.value) == str(want.value)


def test_podspec_normalizes_like_jax():
    kw = {"cpu_request_milli": (1 << 64) - 5000, "mem_request_bytes": MIB,
          "cpu_limit_milli": 1 << 63, "replicas": 3, "spread": 2,
          "tolerations": ({"operator": "Exists"},)}
    j, t = _specs(j_models, t_models, **kw)
    assert dataclasses.astuple(t) == dataclasses.astuple(j)
    assert t.cpu_request_milli == -5000 and t.constrained == j.constrained
    s = t_scenario.Scenario(200, MIB, 4, 400, 2 * MIB)
    assert dataclasses.astuple(t_models.PodSpec.from_scenario(s)) == \
        dataclasses.astuple(j_models.PodSpec.from_scenario(s))


def test_podspec_priority_matches_jax():
    """``PodSpec(priority=5)`` is a spec in both packages, and a strict
    model over the kind fixture evaluates it to the same fits."""
    j, t = _specs(j_models, t_models, cpu_request_milli=1,
                  mem_request_bytes=1, priority=5)
    assert dataclasses.astuple(t) == dataclasses.astuple(j)
    fx = _kind_fixture()
    want = j_models.CapacityModel(
        j_snapshot.snapshot_from_fixture(fx, semantics="strict"),
        fixture=fx).evaluate(j)
    got = t_models.CapacityModel(
        t_snapshot.snapshot_from_fixture(fx, semantics="strict"),
        fixture=fx, device="cpu").evaluate(t)
    np.testing.assert_array_equal(got.fits, want.fits)
    assert got.total == want.total > 0


# -- evaluate --------------------------------------------------------------

# (id, fixture, model keywords, spec keywords)
EVALUATE_CASES = [
    ("plain", "kind", {}, {"cpu_request_milli": 200,
                           "mem_request_bytes": 250 * MIB, "replicas": 10}),
    ("wrapped-cpu", "kind", {}, {"cpu_request_milli": (1 << 64) - 5000,
                                 "mem_request_bytes": MIB}),
    ("spread", "kind", {}, {"cpu_request_milli": 100,
                            "mem_request_bytes": MIB, "replicas": 2,
                            "spread": 1}),
    ("spread-tolerated", "kind", {}, {
        "cpu_request_milli": 100, "mem_request_bytes": MIB, "replicas": 3,
        "spread": 1, "tolerations": ({"operator": "Exists"},)}),
    ("anti-affinity", "kind", {"fixture": True}, {
        "cpu_request_milli": 100, "mem_request_bytes": MIB, "replicas": 2,
        "anti_affinity_labels": {"app": "web"}}),
    ("node-selector", "kind", {}, {
        "cpu_request_milli": 100, "mem_request_bytes": MIB,
        "node_selector": {"kubernetes.io/hostname": "kind-worker"}}),
    ("affinity-terms", "scoped", {}, {
        "cpu_request_milli": 100, "mem_request_bytes": MIB,
        "affinity_terms": ({"matchExpressions": [
            {"key": "zone", "operator": "In", "values": ["z0"]}]},)}),
    ("anti-affinity-namespace", "scoped", {"fixture": True}, {
        "cpu_request_milli": 100, "mem_request_bytes": MIB,
        "anti_affinity_labels": {"app": "db"}, "namespace": "web"}),
    ("anti-affinity-cluster-wide", "scoped", {"fixture": True}, {
        "cpu_request_milli": 100, "mem_request_bytes": MIB,
        "anti_affinity_labels": {"app": "db"}}),
    ("synthetic", "synthetic", {}, {"cpu_request_milli": 150,
                                    "mem_request_bytes": 200 * MIB}),
    ("synthetic-constrained", "synthetic", {}, {
        "cpu_request_milli": 150, "mem_request_bytes": 200 * MIB,
        "tolerations": ({"key": "dedicated", "operator": "Exists"},),
        "spread": 3}),
]

EXTENDED_CASES = [
    ("gpu", {"nvidia.com/gpu": 2}, None),
    ("gpu-storage", {"nvidia.com/gpu": 1, "ephemeral-storage": 10 * GIB},
     None),
    ("gpu-zero", {"nvidia.com/gpu": 0}, None),
    ("gpu-spread", {"nvidia.com/gpu": 1}, 2),
]


def _models(fx, jsnap, tsnap, mode, model_kw):
    kw = dict(model_kw)
    if kw.pop("fixture", False):
        kw["fixture"] = fx
    return (j_models.CapacityModel(jsnap, mode=mode, **kw),
            t_models.CapacityModel(tsnap, mode=mode, device="cpu", **kw))


def _same_result(got, want):
    np.testing.assert_array_equal(got.fits, np.asarray(want.fits))
    assert got.fits.dtype == np.asarray(want.fits).dtype
    assert (got.total, got.replicas_requested, got.mode, got.schedulable) \
        == (want.total, want.replicas_requested, want.mode, want.schedulable)


@pytest.mark.parametrize("mode", ["reference", "strict"])
@pytest.mark.parametrize("case", EVALUATE_CASES, ids=lambda c: c[0])
def test_evaluate_matches_jax(case, mode):
    _, source, model_kw, spec_kw = case
    fx, jsnap, tsnap = _pack(source, mode)
    jm, tm = _models(fx, jsnap, tsnap, mode, model_kw)
    js, ts = _specs(j_models, t_models, **spec_kw)
    _same_result(tm.evaluate(ts), jm.evaluate(js))


@pytest.mark.parametrize("case", EXTENDED_CASES, ids=lambda c: c[0])
def test_evaluate_extended_matches_jax(case):
    _, requests, spread = case
    fx, jsnap, tsnap = _pack("gpu", "strict")
    jm, tm = _models(fx, jsnap, tsnap, "strict", {})
    js, ts = _specs(j_models, t_models, cpu_request_milli=300,
                    mem_request_bytes=512 * MIB, replicas=50,
                    extended_requests=requests, spread=spread)
    _same_result(tm.evaluate(ts), jm.evaluate(js))


def test_evaluate_reference_bit_exact_on_wrapped_usage():
    # tests/test_masks_multi.py: a used CPU of -1 is uint64 max, so the
    # node fits 0 replicas, not a huge int64 fit.
    n = 4
    cols = dict(
        alloc_cpu_milli=np.array([5000, 8000, 100, 700]),
        alloc_mem_bytes=np.full(n, 64 * GIB), alloc_pods=np.full(n, 110),
        used_cpu_req_milli=np.array([-1, 650, 0, 0]),
        used_cpu_lim_milli=np.zeros(n), used_mem_req_bytes=np.zeros(n),
        used_mem_lim_bytes=np.zeros(n), pods_count=np.zeros(n),
        healthy=np.ones(n, dtype=bool),
    )
    names = [f"n{i}" for i in range(n)]
    jm = j_models.CapacityModel(
        j_snapshot.ClusterSnapshot(names=names, **cols), mode="reference")
    tm = t_models.CapacityModel(
        t_snapshot.ClusterSnapshot(names=names, **cols), mode="reference",
        device="cpu")
    js, ts = _specs(j_models, t_models, cpu_request_milli=100,
                    mem_request_bytes=MIB)
    got = tm.evaluate(ts)
    _same_result(got, jm.evaluate(js))
    assert got.fits[0] == 0
    grid = ScenarioGrid(np.array([100]), np.array([MIB]), np.array([1]))
    tgrid = t_scenario.ScenarioGrid(grid.cpu_request_milli,
                                    grid.mem_request_bytes, grid.replicas)
    assert tm.sweep(tgrid)[0][0] == jm.sweep(grid)[0][0] == got.total


def test_constraints_need_allow_extensions_like_jax():
    fx, jsnap, tsnap = _pack("kind", "reference")
    jm = j_models.CapacityModel(jsnap, mode="reference",
                                allow_extensions=False)
    tm = t_models.CapacityModel(tsnap, mode="reference",
                                allow_extensions=False, device="cpu")
    js, ts = _specs(j_models, t_models, cpu_request_milli=100,
                    mem_request_bytes=MIB, node_selector={"zone": "zone-0"})
    with pytest.raises(ValueError, match="extensions"):
        jm.evaluate(js)
    with pytest.raises(ValueError, match="extensions"):
        tm.evaluate(ts)
    grid = t_scenario.ScenarioGrid(np.array([100]), np.array([MIB]),
                                   np.array([1]))
    with pytest.raises(ValueError, match="extensions"):
        tm.sweep(grid, node_selector={"zone": "zone-0"})
    assert tm.sweep(grid)[0][0] > 0  # unconstrained reference: no taint mask


def test_anti_affinity_without_fixture_is_refused():
    _, _, tsnap = _pack("kind", "strict")
    spec = t_models.PodSpec(cpu_request_milli=100, mem_request_bytes=MIB,
                            anti_affinity_labels={"app": "web"})
    with pytest.raises(ValueError, match="needs the source fixture"):
        t_models.CapacityModel(tsnap, device="cpu").evaluate(spec)


@pytest.mark.parametrize("namespace", [None, "web", "staging", "other"])
def test_anti_affinity_mask_matches_jax(namespace):
    fx, jsnap, tsnap = _pack("scoped", "strict")
    want = j_masks.anti_affinity_existing_mask(
        jsnap, fx, {"app": "db"}, namespace=namespace)
    got = t_masks.anti_affinity_existing_mask(
        tsnap, fx, {"app": "db"}, namespace=namespace)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


# -- sweep and sweep_multi -------------------------------------------------

SWEEP_CASES = [
    ("kind-strict", "kind", "strict", {}),
    ("kind-strict-tolerated", "kind", "strict",
     {"tolerations": ({"operator": "Exists"},)}),
    ("kind-reference", "kind", "reference", {}),
    ("synthetic-reference", "synthetic", "reference", {}),
    ("synthetic-strict", "synthetic", "strict", {}),
    ("synthetic-strict-selector", "synthetic", "strict",
     {"node_selector": {"zone": "zone-1"}}),
]


@pytest.mark.parametrize("case", SWEEP_CASES, ids=lambda c: c[0])
def test_sweep_matches_jax(case, monkeypatch):
    _, source, mode, kw = case
    fx, jsnap, tsnap = _pack(source, mode)
    grid = random_scenario_grid(48, seed=21)
    tgrid = t_scenario.random_scenario_grid(48, seed=21)
    labels = []

    def recording(*args, **kwargs):
        out = t_fused.sweep_auto(*args, **kwargs)
        labels.append(out[2])
        return out

    monkeypatch.setattr(t_capacity, "sweep_auto", recording)
    jt, js = j_models.CapacityModel(jsnap, mode=mode).sweep(grid, **kw)
    tt, ts = t_models.CapacityModel(tsnap, mode=mode, device="cpu").sweep(
        tgrid, **kw)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(ts, js)
    assert tt.dtype == np.int64 and ts.dtype == np.bool_
    # The route the model took is the JAX model's, renamed: the fused
    # kernel (B1 on the card) on these eligible inputs.
    mask = j_models.CapacityModel(jsnap, mode=mode)._masks_for(
        j_models.PodSpec(cpu_request_milli=1, mem_request_bytes=1,
                         tolerations=kw.get("tolerations", ()),
                         node_selector=kw.get("node_selector", {})))
    _, _, jname = j_pallas.sweep_auto(
        jsnap.alloc_cpu_milli, jsnap.alloc_mem_bytes, jsnap.alloc_pods,
        jsnap.used_cpu_req_milli, jsnap.used_mem_req_bytes,
        jsnap.pods_count, jsnap.healthy, grid.cpu_request_milli,
        grid.mem_request_bytes, grid.replicas, mode=mode, node_mask=mask,
    )
    assert labels == [_label(jname)] == ["plain_i32_rcp_fused"]


def _multi_grid(s=24, seed=42, resources=EXTENDED):
    rng = np.random.default_rng(seed)
    base = random_scenario_grid(s, seed=seed)
    extra = {"nvidia.com/gpu": rng.integers(0, 3, s),
             "ephemeral-storage": rng.integers(1, 20, s) * GIB}
    j = MultiResourceGrid.from_grid(base, {r: extra[r] for r in resources})
    t = t_scenario.MultiResourceGrid(
        resources=j.resources, requests=j.requests, replicas=j.replicas)
    return j, t


@pytest.mark.parametrize(
    "resources,kw",
    [
        (EXTENDED, {}),
        (("nvidia.com/gpu",), {}),
        (EXTENDED, {"spread": 2}),
        (EXTENDED, {"tolerations": ({"operator": "Exists"},)}),
        ((), {"node_selector": {"zone": "zone-0"}}),
    ],
    ids=["gpu-storage", "gpu", "spread", "tolerated", "selector"],
)
def test_sweep_multi_matches_jax(resources, kw, monkeypatch):
    fx, jsnap, tsnap = _pack("gpu", "strict")
    jgrid, tgrid = _multi_grid(resources=resources)
    labels = []

    def recording(*args, **kwargs):
        out = t_multi.sweep_multi_auto(*args, **kwargs)
        labels.append(out[2])
        return out

    monkeypatch.setattr(t_capacity, "sweep_multi_auto", recording)
    jt, js = j_models.CapacityModel(jsnap, mode="strict").sweep_multi(
        jgrid, **kw)
    tt, ts = t_models.CapacityModel(
        tsnap, mode="strict", device="cpu").sweep_multi(tgrid, **kw)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(ts, js)
    jm = j_models.CapacityModel(jsnap, mode="strict")
    mask = jm._masks_for(j_models.PodSpec(
        cpu_request_milli=1, mem_request_bytes=1,
        tolerations=kw.get("tolerations", ()),
        node_selector=kw.get("node_selector", {})))
    alloc_rn, used_rn = jsnap.resource_matrix(jgrid.resources)
    _, _, jname = j_pallas_multi.sweep_multi_auto(
        alloc_rn, used_rn, jsnap.alloc_pods, jsnap.pods_count, jsnap.healthy,
        jgrid.requests, jgrid.replicas, mode="strict", node_masks=mask,
        max_per_node=kw.get("spread"),
    )
    assert labels == [_label(jname)]
    assert labels[0] == ("torch_int64_multi" if "spread" in kw
                         else "plain_multi_i32_rcp_fused")


def test_sweep_multi_refuses_reference_extensions():
    _, _, tsnap = _pack("kind", "reference")
    grid = t_scenario.MultiResourceGrid(
        resources=("cpu", "memory"),
        requests=np.array([[100, 64 * MIB]], dtype=np.int64),
        replicas=np.array([1], dtype=np.int64),
    )
    model = t_models.CapacityModel(tsnap, mode="reference",
                                   allow_extensions=False, device="cpu")
    with pytest.raises(ValueError, match="extensions"):
        model.sweep_multi(grid, spread=None,
                          node_selector={"kubernetes.io/hostname": "x"})
    totals, _ = model.sweep_multi(grid)
    assert totals[0] > 0


@pytest.fixture
def no_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_model_defaults_to_the_card(no_cuda):
    _, _, tsnap = _pack("kind", "strict")
    model = t_models.CapacityModel(tsnap)
    spec = t_models.PodSpec(cpu_request_milli=100, mem_request_bytes=MIB)
    grid = t_scenario.random_scenario_grid(4, seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.evaluate(spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.sweep(grid)
