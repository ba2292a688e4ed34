"""The port's ClusterStore against the JAX package's, event by event.

The same seeded streams of watch-style events (pods and nodes joining,
moving, finishing and leaving, nodes flipping health, PDBs coming and
going, and malformed events mixed in) go into both stores.  After every
event the two snapshots are equal field for field (tolerance 0), the
port's store equals the port's own full repack of its raw state (the
store's invariant), and a rejected event raises :class:`StoreError` with
the same message in both, leaving both states as they were.
"""

import copy
import random

import numpy as np
import pytest

from kubernetesclustercapacity_tpu.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu.oracle import ReferencePanic as JPanic
from kubernetesclustercapacity_tpu.store import ClusterStore as JStore
from kubernetesclustercapacity_tpu.store import StoreError as JStoreError
from kubernetesclustercapacity_tpu_torch.oracle import (
    ReferencePanic as TPanic,
)
from kubernetesclustercapacity_tpu_torch.snapshot import (
    COLUMNS,
    snapshot_from_fixture,
)
from kubernetesclustercapacity_tpu_torch.store import ClusterStore as TStore
from kubernetesclustercapacity_tpu_torch.store import StoreError as TStoreError

from test_store import _mk_node, _mk_pod

GPU = "nvidia.com/gpu"


def assert_same_snapshot(t_snap, j_snap):
    assert t_snap.names == j_snap.names
    assert t_snap.semantics == j_snap.semantics
    assert t_snap.node_log == j_snap.node_log
    assert t_snap.pod_cpu_errs == j_snap.pod_cpu_errs
    assert t_snap.labels == j_snap.labels
    assert t_snap.taints == j_snap.taints
    for col in (*COLUMNS, "healthy"):
        a, b = getattr(t_snap, col), getattr(j_snap, col)
        assert a.dtype == b.dtype, col
        np.testing.assert_array_equal(a, b, err_msg=col)
    assert sorted(t_snap.extended) == sorted(j_snap.extended)
    for r, (alloc, used) in t_snap.extended.items():
        np.testing.assert_array_equal(alloc, j_snap.extended[r][0])
        np.testing.assert_array_equal(used, j_snap.extended[r][1])


def assert_port_matches_repack(store: TStore):
    assert_same_snapshot(
        store.snapshot(),
        snapshot_from_fixture(
            store.fixture_view(),
            semantics=store.semantics,
            extended_resources=store.extended_resources,
        ),
    )


def _both(fixture, **kw):
    return TStore(fixture, **kw), JStore(fixture, **kw)


def _apply_both(t, j, event):
    """Apply one event to both stores: either both accept it, or both
    refuse it with the same error class and message."""
    errors = []
    for store in (t, j):
        try:
            store.apply_event(copy.deepcopy(event))
            errors.append(None)
        except (TStoreError, JStoreError) as e:
            errors.append(("StoreError", str(e)))
        except (TPanic, JPanic) as e:
            errors.append(("ReferencePanic", str(e)))
    assert errors[0] == errors[1], event
    return errors[0]


def _gpu_pod(name, node, rng):
    pod = _mk_pod(name, node, cpu=rng.choice(["100m", "1", "2"]),
                  mem=rng.choice(["128Mi", "1Gi"]))
    pod["containers"][0]["resources"]["requests"][GPU] = str(rng.randint(0, 2))
    pod["initContainers"] = [{"resources": {"requests": {
        "cpu": rng.choice(["50m", "3"]), GPU: str(rng.randint(0, 3))}}}]
    return pod


def _gpu_node(name, rng, healthy=True):
    node = _mk_node(name, cpu=rng.choice(["4", "16"]), healthy=healthy)
    node["allocatable"][GPU] = str(rng.choice([0, 4, 8]))
    return node


def _event(rng, live, serial, step, seed, extended):
    node_names = [n["name"] for n in live["nodes"]]
    roll = rng.random()
    if roll < 0.05:
        # Malformed or inapplicable: both stores must refuse it.
        return rng.choice([
            {"type": "BOGUS", "kind": "Pod", "object": _mk_pod("x", "")},
            {"type": "ADDED", "kind": "Gizmo", "object": {}},
            {"type": "DELETED", "kind": "Pod",
             "object": _mk_pod("ghost", node_names[0] if node_names else "")},
            {"type": "MODIFIED", "kind": "Node", "object": _mk_node("ghost")},
            {"type": "ADDED", "kind": "Pod",
             "object": {"name": "bad", "namespace": "d", "nodeName": "",
                        "phase": "Running", "containers": "oops"}},
            {"type": "ADDED", "kind": "PodDisruptionBudget",
             "object": {"name": "b", "namespace": "default",
                        "minAvailable": 1, "maxUnavailable": 1}},
            {"type": "ADDED", "kind": "Pod", "object": "not-a-dict"},
        ])
    if roll < 0.35 or not live["pods"]:
        target = rng.choice(node_names + ["", "nowhere"])
        if extended:
            pod = _gpu_pod(f"r{seed}-{serial}", target, rng)
        else:
            pod = _mk_pod(f"r{seed}-{serial}", target,
                          phase=rng.choice(["Running", "Pending",
                                            "Succeeded"]),
                          cpu=rng.choice(["100m", "1", "2", "bogus"]),
                          mem=rng.choice(["128Mi", "1Gi"]))
        return {"type": "ADDED", "kind": "Pod", "object": pod}
    if roll < 0.5:
        victim = copy.deepcopy(rng.choice(live["pods"]))
        return {"type": "DELETED", "kind": "Pod", "object": victim}
    if roll < 0.7:
        victim = copy.deepcopy(rng.choice(live["pods"]))
        victim["nodeName"] = rng.choice(node_names + [""])
        victim["phase"] = rng.choice(["Running", "Failed", "Unknown",
                                      "Succeeded"])
        return {"type": "MODIFIED", "kind": "Pod", "object": victim}
    if roll < 0.78:
        name = f"join-{seed}-{step}"
        healthy = rng.random() > 0.3
        node = (_gpu_node(name, rng, healthy) if extended
                else _mk_node(name, healthy=healthy))
        return {"type": "ADDED", "kind": "Node", "object": node}
    if roll < 0.88 and node_names:
        name = rng.choice(node_names)
        healthy = rng.random() > 0.3
        node = (_gpu_node(name, rng, healthy) if extended
                else _mk_node(name, cpu=rng.choice(["4", "16", "1.5"]),
                              healthy=healthy))
        return {"type": "MODIFIED", "kind": "Node", "object": node}
    if roll < 0.94:
        pdb = {"name": f"pdb-{rng.randint(0, 2)}", "namespace": "default",
               "selector": {"matchLabels": {}},
               rng.choice(["minAvailable", "maxUnavailable"]):
                   rng.choice([0, 1, "50%"])}
        return {"type": rng.choice(["ADDED", "MODIFIED", "DELETED"]),
                "kind": "PodDisruptionBudget", "object": pdb}
    return {"type": "DELETED", "kind": "Node",
            "object": {"name": rng.choice(node_names)}}


@pytest.mark.parametrize("semantics,extended", [
    ("reference", ()), ("strict", ()), ("strict", (GPU,)),
], ids=["reference", "strict", "strict-gpu"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_event_streams_match_jax_after_every_event(
    semantics, extended, seed
):
    rng = random.Random(seed)
    fx = synthetic_fixture(10, seed=seed, unhealthy_frac=0.2,
                           unscheduled_running_pods=2)
    if extended:
        for i, node in enumerate(fx["nodes"]):
            node["allocatable"][GPU] = str(4 * (i % 3))
    t, j = _both(fx, semantics=semantics, extended_resources=extended)
    assert_same_snapshot(t.snapshot(), j.snapshot())
    refused = 0
    for step in range(70):
        event = _event(rng, t.fixture_view(), step, step, seed, extended)
        refused += _apply_both(t, j, event) is not None
        assert_same_snapshot(t.snapshot(), j.snapshot())
        assert t.fixture_view() == j.fixture_view()
        assert_port_matches_repack(t)
    assert refused >= 1  # the stream did exercise the refusal path


def test_bad_events_raise_the_same_errors():
    fx = synthetic_fixture(3, seed=7)
    t, j = _both(fx, semantics="reference")
    node0 = fx["nodes"][0]["name"]
    existing = t.fixture_view()["pods"][0]
    short = _mk_node("short-conds")
    short["conditions"] = short["conditions"][:2]  # <4: the reference panics
    events = [
        {"type": "BOGUS", "kind": "Pod", "object": _mk_pod("x", node0)},
        {"type": "ADDED", "kind": "Gizmo", "object": {}},
        {"type": "ADDED", "kind": "Pod", "object": existing},
        {"type": "DELETED", "kind": "Pod", "object": _mk_pod("ghost", node0)},
        {"type": "MODIFIED", "kind": "Node", "object": _mk_node("ghost")},
        {"type": "ADDED", "kind": "Node", "object": fx["nodes"][0]},
        {"type": "ADDED", "kind": "Node",
         "object": {"name": "badnode", "allocatable": "oops",
                    "conditions": []}},
        {"type": "ADDED", "kind": "Node", "object": short},
        {"type": "ADDED", "kind": "Pod", "object": None},
        {"type": "ADDED", "kind": "PodDisruptionBudget",
         "object": {"name": "p", "selector": {"matchExpressions": [
             {"key": "a", "operator": "Near"}]}, "minAvailable": 1}},
    ]
    outcomes = [_apply_both(t, j, ev) for ev in events]
    assert all(o is not None for o in outcomes)
    assert outcomes[7][0] == "ReferencePanic"
    assert_same_snapshot(t.snapshot(), j.snapshot())
    assert_port_matches_repack(t)


@pytest.mark.parametrize("semantics", ["reference", "strict"])
def test_constructor_refusals_match_jax(semantics):
    fx = synthetic_fixture(4, seed=3)
    dup = copy.deepcopy(fx)
    dup["nodes"].append(copy.deepcopy(dup["nodes"][0]))
    dup_pod = copy.deepcopy(fx)
    dup_pod["pods"].append(copy.deepcopy(dup_pod["pods"][0]))
    cases = [
        (dup, {}),
        (dup_pod, {}),
        (fx, {"extended_resources": (GPU,)}),
    ]
    for fixture, kw in cases:
        errors = []
        for cls, err in ((TStore, TStoreError), (JStore, JStoreError)):
            try:
                cls(fixture, semantics=semantics, **kw)
                errors.append(None)
            except err as e:
                errors.append(str(e))
        assert errors[0] == errors[1]


def test_phantom_rows_and_transcript_provenance_match_jax():
    fx = synthetic_fixture(8, seed=5, unhealthy_frac=0.4)
    fx["nodes"][1]["allocatable"]["cpu"] = "12x"  # a codec error line
    t, j = _both(fx, semantics="reference")
    orphan = _mk_pod("orphan", "", cpu="3.5.1")
    for event in (
        {"type": "ADDED", "kind": "Pod", "object": orphan},
        {"type": "MODIFIED", "kind": "Node",
         "object": _mk_node(fx["nodes"][2]["name"], healthy=False)},
        {"type": "DELETED", "kind": "Node",
         "object": {"name": fx["nodes"][3]["name"]}},
    ):
        assert _apply_both(t, j, event) is None
        snap = t.snapshot()
        assert_same_snapshot(snap, j.snapshot())
        assert_port_matches_repack(t)
    assert any(kind == "cpu_err" for kind, _ in snap.node_log)
    assert any(errs for errs in snap.pod_cpu_errs)


def test_events_do_not_alias_caller_objects_in_either_store():
    fx = synthetic_fixture(3, seed=9)
    t, j = _both(fx, semantics="strict")
    pod = _mk_pod("aliased", fx["nodes"][0]["name"])
    for store in (t, j):
        store.apply_event({"type": "ADDED", "kind": "Pod", "object": pod})
    pod["containers"][0]["resources"]["requests"]["cpu"] = "4000"
    fx["nodes"][0]["allocatable"]["cpu"] = "999"
    assert_same_snapshot(t.snapshot(), j.snapshot())
    assert_port_matches_repack(t)
