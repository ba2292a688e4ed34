"""The port's scheduler-fidelity surface against the JAX package's, both on
the CPU, with tolerance 0: ``CapacityModel.place`` / ``drain`` /
``topology_spread(_grid)`` / ``nodes_needed(_grid)`` /
``sweep_preemption`` / ``evaluate`` with a priority, the disruption-budget
gate (``pdb.blocked_evictions``), ``topology.model.label_codes``, and the
CLI's ``-drain`` text byte for byte.

The fixture is seeded: a tainted synthetic cluster whose pods carry a
priority from {0, 1000, 100000} and an ``app`` label, with 12 PDBs over
those labels (zero allowances, slack, and pods covered twice), and a copy
with GPU and storage columns.
"""

import dataclasses
import json

import numpy as np
import pytest

from kubernetesclustercapacity_tpu import cli as j_cli
from kubernetesclustercapacity_tpu import models as j_models
from kubernetesclustercapacity_tpu import pdb as j_pdb
from kubernetesclustercapacity_tpu import snapshot as j_snapshot
from kubernetesclustercapacity_tpu.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu.scenario import (
    random_scenario_grid as j_grid,
)
from kubernetesclustercapacity_tpu.topology import model as j_topology
from kubernetesclustercapacity_tpu_torch import cli as t_cli
from kubernetesclustercapacity_tpu_torch import models as t_models
from kubernetesclustercapacity_tpu_torch import pdb as t_pdb
from kubernetesclustercapacity_tpu_torch import snapshot as t_snapshot
from kubernetesclustercapacity_tpu_torch.scenario import (
    random_scenario_grid as t_grid,
)
from kubernetesclustercapacity_tpu_torch.topology import model as t_topology

MIB = 1 << 20
GIB = 1 << 30
EXTENDED = ("ephemeral-storage", "nvidia.com/gpu")
APPS = [f"app-{i}" for i in range(8)]


def scheduling_fixture(n=48, seed=3, extended=False):
    fx = synthetic_fixture(n, seed=seed, taint_frac=0.1, unhealthy_frac=0.05)
    rng = np.random.default_rng(seed + 7)
    for pod in fx["pods"]:
        pod["priority"] = int(rng.choice([0, 1000, 100000]))
        pod["labels"] = {"app": str(rng.choice(APPS))}
    namespaces = sorted({p.get("namespace", "") for p in fx["pods"]})
    pdbs = []
    for k in range(12):
        pdb = {"name": f"pdb-{k}",
               "namespace": namespaces[k % len(namespaces)],
               "selector": {"matchLabels": {"app": APPS[k % len(APPS)]}}}
        # zero allowance / one disruption / slack; apps 0-3 are covered
        # twice (k and k + 8).
        pdb[("minAvailable", "maxUnavailable", "minAvailable")[k % 3]] = (
            "100%", 1, 1)[k % 3]
        pdbs.append(pdb)
    fx["pdbs"] = pdbs
    if extended:
        for node in fx["nodes"]:
            node["allocatable"]["nvidia.com/gpu"] = str(rng.integers(0, 9))
            node["allocatable"]["ephemeral-storage"] = \
                f"{rng.integers(50, 501)}Gi"
        for pod in fx["pods"][::4]:
            pod["containers"] = [{"resources": {"requests": {
                "cpu": "250m", "memory": "256Mi",
                "nvidia.com/gpu": str(rng.integers(0, 2)),
                "ephemeral-storage": f"{rng.integers(1, 10)}Gi",
            }}}]
    return fx


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, extended in (("plain", False), ("gpu", True)):
        fx = scheduling_fixture(extended=extended)
        ext = EXTENDED if extended else ()
        js = j_snapshot.snapshot_from_fixture(fx, semantics="strict",
                                              extended_resources=ext)
        ts = t_snapshot.snapshot_from_fixture(fx, semantics="strict",
                                              extended_resources=ext)
        out[name] = (
            fx,
            j_models.CapacityModel(js, mode="strict", fixture=fx),
            t_models.CapacityModel(ts, mode="strict", fixture=fx,
                                   device="cpu"),
        )
    return out


def _specs(spec_kw):
    return j_models.PodSpec(**spec_kw), t_models.PodSpec(**spec_kw)


def _same(got, want):
    a, b = dataclasses.asdict(got), dataclasses.asdict(want)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(b[k], np.ndarray) or isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        else:
            assert a[k] == b[k], k


BASE = {"cpu_request_milli": 500, "mem_request_bytes": 512 * MIB}
# (id, model, spec keywords)
PLACE_SPECS = [
    ("plain", "plain", {}),
    ("spread-2", "plain", {"spread": 2}),
    ("selector", "plain", {"node_selector": {"zone": "zone-1"}}),
    ("tolerated", "plain", {"tolerations": ({"operator": "Exists"},)}),
    ("anti-affinity", "plain", {"anti_affinity_labels": {"app": "app-1"}}),
    ("priority", "plain", {"priority": 1000}),
    ("gpu", "gpu", {"extended_requests": {"nvidia.com/gpu": 1}}),
    ("gpu-priority", "gpu", {"extended_requests": {"nvidia.com/gpu": 1},
                             "priority": 100000}),
    ("zero-cpu", "plain", {"cpu_request_milli": 0}),
]


@pytest.mark.parametrize("replicas", [40, 300])
@pytest.mark.parametrize("assignments", [True, "trace", False, "auto"])
@pytest.mark.parametrize("spec", PLACE_SPECS, ids=lambda s: s[0])
@pytest.mark.parametrize("policy", ["first-fit", "best-fit", "spread"])
def test_place_matches_jax(models, policy, spec, assignments, replicas):
    _, jm, tm = models[spec[1]]
    js, ts = _specs({**BASE, **spec[2], "replicas": replicas})
    if spec[0] == "zero-cpu" and assignments == "trace":
        with pytest.raises(ValueError) as j_err:
            jm.place(js, policy=policy, assignments=assignments)
        with pytest.raises(ValueError) as t_err:
            tm.place(ts, policy=policy, assignments=assignments)
        assert str(t_err.value) == str(j_err.value)
        return
    want = jm.place(js, policy=policy, assignments=assignments)
    got = tm.place(ts, policy=policy, assignments=assignments)
    _same(got, want)
    assert got.engine == want.engine
    if spec[0] == "zero-cpu":
        assert got.engine in ("scan", "bulk") and (
            got.engine == "scan" or assignments is False)
    if got.engine == "scan" and assignments is not False:
        assert got.placed > 0


@pytest.mark.parametrize("spec", [("plain", {}), ("priority",
                                                {"priority": 1000}),
                                  ("selector", {"node_selector": {
                                      "pool": "default"}})],
                         ids=lambda s: s[0])
@pytest.mark.parametrize("taints", ["ignore", "honor"])
@pytest.mark.parametrize("max_skew", [1, 3])
@pytest.mark.parametrize("policy", ["first-fit", "best-fit", "spread"])
def test_place_with_topology_spread_matches_jax(models, policy, max_skew,
                                                taints, spec):
    _, jm, tm = models["plain"]
    js, ts = _specs({**BASE, **spec[1], "replicas": 120})
    kw = dict(policy=policy, topology_key="zone", max_skew=max_skew,
              node_taints_policy=taints)
    want = jm.place(js, **kw)
    got = tm.place(ts, **kw)
    _same(got, want)
    # The gate's closed form: it places what topology_spread reports.
    cap = tm.topology_spread(ts, topology_key="zone", max_skew=max_skew,
                             node_taints_policy=taints).total
    assert got.placed == min(120, cap)


def test_place_errors_match_jax(models):
    _, jm, tm = models["plain"]
    js, ts = _specs({**BASE, "replicas": 3})
    for kw in ({"max_skew": 2}, {"topology_key": "zone", "assignments":
                                 "trace"},
               {"topology_key": "zone", "policy": "worst-fit"},
               {"topology_key": "zone", "max_skew": 0}):
        with pytest.raises(ValueError) as j_err:
            jm.place(js, **kw)
        with pytest.raises(ValueError) as t_err:
            tm.place(ts, **kw)
        assert str(t_err.value) == str(j_err.value)
    # No domain carries the key: nothing places.
    _same(tm.place(ts, topology_key="rack"), jm.place(js, topology_key="rack"))


def _busiest(fx, k):
    counts = {}
    for p in fx["pods"]:
        if p.get("nodeName") and p.get("phase") not in ("Succeeded",
                                                        "Failed"):
            counts[p["nodeName"]] = counts.get(p["nodeName"], 0) + 1
    return sorted(counts, key=lambda n: (-counts[n], n))[:k]


@pytest.mark.parametrize("model", ["plain", "gpu"])
@pytest.mark.parametrize("policy", ["first-fit", "best-fit", "spread"])
def test_drain_matches_jax(models, policy, model):
    fx, jm, tm = models[model]
    nodes = _busiest(fx, 4) + [fx["nodes"][-1]["name"]]
    blocked = 0
    for node in nodes:
        want = jm.drain(node, policy=policy)
        got = tm.drain(node, policy=policy)
        _same(got, want)
        assert got.evictable == want.evictable
        blocked += len(got.blocked)
    assert blocked > 0  # the budget gate is exercised


def test_drain_errors_match_jax(models):
    fx, jm, tm = models["plain"]
    for node in ("no-such-node",):
        with pytest.raises(ValueError) as j_err:
            jm.drain(node)
        with pytest.raises(ValueError) as t_err:
            tm.drain(node)
        assert str(t_err.value) == str(j_err.value)
    # A GPU pod against a snapshot packed without the GPU column.
    gfx = models["gpu"][0]
    js = j_snapshot.snapshot_from_fixture(gfx, semantics="strict")
    ts = t_snapshot.snapshot_from_fixture(gfx, semantics="strict")
    node = next(p["nodeName"] for p in gfx["pods"][::4]
                if p["containers"][0]["resources"]["requests"][
                    "nvidia.com/gpu"] != "0" and p.get("nodeName"))
    with pytest.raises(ValueError) as j_err:
        j_models.CapacityModel(js, fixture=gfx).drain(node)
    with pytest.raises(ValueError) as t_err:
        t_models.CapacityModel(ts, fixture=gfx, device="cpu").drain(node)
    assert str(t_err.value) == str(j_err.value)


def test_blocked_evictions_match_jax(models):
    fx = models["plain"][0]
    keys = [f"{p.get('namespace', '')}/{p.get('name', '')}"
            for p in fx["pods"]] + ["nowhere/none"]
    got = t_pdb.blocked_evictions(fx, keys)
    assert got == j_pdb.blocked_evictions(fx, keys)
    assert any(len(v) >= 2 for v in got.values())  # double coverage
    assert any(len(v) == 1 for v in got.values())  # zero allowance
    assert t_pdb.blocked_evictions({"pods": fx["pods"]}, keys) == {}


@pytest.mark.parametrize("spec", [("plain", "plain", {}),
                                  ("priority", "plain", {"priority": 1000}),
                                  ("spread", "plain", {"spread": 1}),
                                  ("gpu", "gpu", {"extended_requests": {
                                      "nvidia.com/gpu": 1}})],
                         ids=lambda s: s[0])
@pytest.mark.parametrize("taints", ["ignore", "honor"])
@pytest.mark.parametrize("max_skew", [1, 5])
def test_topology_spread_matches_jax(models, max_skew, taints, spec):
    _, jm, tm = models[spec[1]]
    js, ts = _specs({**BASE, **spec[2], "replicas": 200})
    kw = dict(topology_key="zone", max_skew=max_skew,
              node_taints_policy=taints)
    _same(tm.topology_spread(ts, **kw), jm.topology_spread(js, **kw))


@pytest.mark.parametrize("kw", [
    {"topology_key": "zone"},
    {"topology_key": "zone", "max_skew": 2, "node_taints_policy": "honor"},
    {"topology_key": "zone", "tolerations": ({"operator": "Exists"},)},
    {"topology_key": "zone", "node_selector": {"pool": "highmem"}},
    {"topology_key": "rack"},
], ids=["zone", "skew-2-honor", "tolerated", "selector", "no-domain"])
def test_topology_spread_grid_matches_jax(models, kw):
    _, jm, tm = models["plain"]
    want = jm.topology_spread_grid(j_grid(96, seed=4), **kw)
    got = tm.topology_spread_grid(t_grid(96, seed=4), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


# An m5.xlarge-shaped template (4 vCPU, 16 GiB), one tainted, one labelled.
TEMPLATES = {
    "m5.xlarge": {"allocatable": {"cpu": "4", "memory": "16Gi",
                                  "pods": "58"}},
    "tainted": {"allocatable": {"cpu": "4", "memory": "16Gi", "pods": "58"},
                "taints": [{"key": "dedicated", "value": "gpu",
                            "effect": "NoSchedule"}]},
    "labelled": {"allocatable": {"cpu": "8", "memory": "32Gi",
                                 "pods": "110"},
                 "labels": {"zone": "zone-1"}},
}


@pytest.mark.parametrize("spec", [("plain", {}), ("priority",
                                                {"priority": 100000}),
                                  ("selector", {"node_selector": {
                                      "zone": "zone-1"}}),
                                  ("huge", {"cpu_request_milli": 64000})],
                         ids=lambda s: s[0])
@pytest.mark.parametrize("template", sorted(TEMPLATES))
@pytest.mark.parametrize("replicas", [10, 5000])
def test_nodes_needed_matches_jax(models, replicas, template, spec):
    _, jm, tm = models["plain"]
    js, ts = _specs({**BASE, **spec[1], "replicas": replicas})
    _same(tm.nodes_needed(ts, TEMPLATES[template]),
          jm.nodes_needed(js, TEMPLATES[template]))


@pytest.mark.parametrize("template", sorted(TEMPLATES))
def test_nodes_needed_grid_matches_jax(models, template):
    _, jm, tm = models["plain"]
    jg, tg = j_grid(128, seed=5), t_grid(128, seed=5)
    jg.replicas[:] = tg.replicas[:] = np.random.default_rng(6).integers(
        0, 20000, 128)
    for kw in ({}, {"node_selector": {"zone": "zone-1"}},
               {"tolerations": ({"operator": "Exists"},)}):
        got = tm.nodes_needed_grid(tg, TEMPLATES[template], **kw)
        want = jm.nodes_needed_grid(jg, TEMPLATES[template], **kw)
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("kw", [{}, {"tolerations": (
    {"operator": "Exists"},)}, {"node_selector": {"pool": "default"}}],
    ids=["plain", "tolerated", "selector"])
def test_model_sweep_preemption_matches_jax(models, kw):
    _, jm, tm = models["plain"]
    prio = np.random.default_rng(9).choice([0, 5, 1000, 100000, 10**6], 96)
    got = tm.sweep_preemption(t_grid(96, seed=8), prio, **kw)
    want = jm.sweep_preemption(j_grid(96, seed=8), prio, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("priority", [None, 0, 1000, 100000, 100001])
@pytest.mark.parametrize("model", ["plain", "gpu"])
def test_evaluate_with_priority_matches_jax(models, model, priority):
    _, jm, tm = models[model]
    extra = ({"extended_requests": {"nvidia.com/gpu": 1,
                                    "ephemeral-storage": GIB}}
             if model == "gpu" else {"spread": 3})
    js, ts = _specs({**BASE, **extra, "priority": priority,
                     "replicas": 100})
    _same(tm.evaluate(ts), jm.evaluate(js))


def test_priority_gates_match_jax(models):
    fx, jm, tm = models["plain"]
    js, ts = _specs({**BASE, "priority": 5})
    cases = [
        (j_models.CapacityModel(jm.snapshot, mode="strict"),
         t_models.CapacityModel(tm.snapshot, mode="strict", device="cpu")),
        (j_models.CapacityModel(jm.snapshot, mode="reference", fixture=fx),
         t_models.CapacityModel(tm.snapshot, mode="reference", fixture=fx,
                                device="cpu")),
    ]
    for jmod, tmod in cases:
        with pytest.raises(ValueError) as j_err:
            jmod.evaluate(js)
        with pytest.raises(ValueError) as t_err:
            tmod.evaluate(ts)
        assert str(t_err.value) == str(j_err.value)
    for bad in ("high", 1.5):
        with pytest.raises(ValueError) as j_err:
            j_models.PodSpec(1, 1, priority=bad)
        with pytest.raises(ValueError) as t_err:
            t_models.PodSpec(1, 1, priority=bad)
        assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("missing", ["own", "exclude"])
def test_label_codes_match_jax(models, missing):
    snap = models["plain"][1].snapshot
    eligible = np.arange(snap.n_nodes + 2) % 5 != 0
    labels = [dict(row) for row in snap.labels]
    for row in labels[::7]:
        row.pop("zone")
    for key in ("zone", "pool", "rack"):
        for elig in (None, eligible):
            got = t_topology.label_codes(labels, key, missing=missing,
                                         eligible=elig,
                                         n_nodes=snap.n_nodes + 2)
            want = j_topology.label_codes(labels, key, missing=missing,
                                          eligible=elig,
                                          n_nodes=snap.n_nodes + 2)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]
    assert t_topology.node_name_index(snap) == \
        j_topology.node_name_index(snap)


# -- the CLI's -drain, byte for byte ----------------------------------------

def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.fixture(scope="module")
def drain_sources(tmp_path_factory, models):
    d = tmp_path_factory.mktemp("drain")
    out = {}
    for name in ("plain", "gpu"):
        path = str(d / f"{name}.json")
        with open(path, "w") as f:
            json.dump(models[name][0], f)
        out[name] = path
    npz = str(d / "plain.npz")
    models["plain"][1].snapshot.save(npz)
    out["npz"] = npz
    return out


@pytest.mark.parametrize("policy", ["first-fit", "best-fit", "spread"])
@pytest.mark.parametrize("rank", [0, 1, 2])
def test_cli_drain_text_matches_jax(models, drain_sources, rank, policy,
                                    capsys):
    node = _busiest(models["plain"][0], 3)[rank]
    argv = ["-snapshot", drain_sources["plain"], "-semantics", "strict",
            "-drain", node, "-drain-policy", policy]
    j_rc, j_out = _run(j_cli.main, argv, capsys)
    t_rc, t_out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
    assert t_out == j_out
    assert t_rc == j_rc
    assert t_out.startswith(f"drain {node}: ")


@pytest.mark.parametrize("argv", [
    ["-semantics", "strict", "-extended-resources",
     "nvidia.com/gpu,ephemeral-storage"],
    ["-semantics", "strict"],  # GPU pods, no GPU column: refused
    ["-semantics", "reference"],
], ids=["gpu-columns", "gpu-unpacked", "reference"])
def test_cli_drain_gpu_and_errors_match_jax(models, drain_sources, argv,
                                            capsys):
    gfx = models["gpu"][0]
    node = next(p["nodeName"] for p in gfx["pods"][::4]
                if p["containers"][0]["resources"]["requests"][
                    "nvidia.com/gpu"] != "0" and p.get("nodeName"))
    argv = ["-snapshot", drain_sources["gpu"], "-drain", node, *argv]
    j_rc, j_out = _run(j_cli.main, argv, capsys)
    t_rc, t_out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
    assert (t_rc, t_out) == (j_rc, j_out)


def test_cli_drain_needs_a_fixture_like_jax(drain_sources, models, capsys):
    node = _busiest(models["plain"][0], 1)[0]
    argv = ["-snapshot", drain_sources["npz"], "-drain", node]
    j_rc, j_out = _run(j_cli.main, argv, capsys)
    t_rc, t_out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
    assert (t_rc, t_out) == (j_rc, j_out) == (1, j_out)
    assert "drain needs the source fixture" in t_out


def test_cli_drain_server_matches_jax(capsys):
    from kubernetesclustercapacity_tpu.service.server import (
        CapacityServer as JaxServer,
    )
    from kubernetesclustercapacity_tpu_torch.service.server import (
        CapacityServer as TorchServer,
    )

    fx = synthetic_fixture(8, seed=1)
    out = []
    for main, server in (
        (j_cli.main, JaxServer(j_snapshot.snapshot_from_fixture(fx))),
        (t_cli.main, TorchServer(t_snapshot.snapshot_from_fixture(fx),
                                 device="cpu")),
    ):
        server.start()
        try:
            host, port = server.address
            for extra in (["-output", "json"], []):
                rc, text = _run(main, ["-drain-server", f"{host}:{port}",
                                       "-drain-timeout-s", "5", *extra],
                                capsys)
                out.append((rc, text))
        finally:
            server.shutdown()
    (j_rc, j_json), (j_rc2, j_text), (t_rc, t_json), (t_rc2, t_text) = out
    assert j_rc == t_rc == 0 and j_rc2 == t_rc2 == 0
    j_doc, t_doc = json.loads(j_json), json.loads(t_json)
    for doc in (j_doc, t_doc):
        doc["ts"] = doc["waited_s"] = None
    assert t_doc == j_doc and t_doc["drained"] is True
    assert "already draining" in t_text and "already draining" in j_text
