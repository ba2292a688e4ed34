"""The port's ClusterStore against the JAX package's, event by event.

The same seeded streams of watch-style events (pods and nodes joining,
moving, finishing and leaving, nodes flipping health, PDBs coming and
going, and malformed events mixed in) go into both stores.  After every
event the two snapshots are equal field for field (tolerance 0), the
port's store equals the port's own full repack of its raw state (the
store's invariant), and a rejected event raises :class:`StoreError` with
the same message in both, leaving both states as they were.
"""

import collections
import copy
import json
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


def _event(rng, live, serial, step, seed, extended, extra_cpu=(),
           extra_mem=()):
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
                          cpu=rng.choice(["100m", "1", "2", "bogus",
                                          *extra_cpu]),
                          mem=rng.choice(["128Mi", "1Gi", *extra_mem]))
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


# Quantities whose row sums wrap: the reference's uint64 CPU and int64
# memory running sums (a negative CPU string is 2**64 - 5000 on its own).
# The fixture's pods take them too, so rows hold several at once.  Strict
# sums are exact int64, so its stream takes negative quantities only.
WRAP_CPU = ("-5", "18446744073709551")
WRAP_MEM = ("7Ei", "5Ei", "-6Ei", "-1Gi")


def _row_sum_wraps(store) -> bool:
    """Whether some reference row's memory requests leave int64 as a
    plain sum of its pods' terms (so the row holds the wrapped sum)."""
    from kubernetesclustercapacity_tpu_torch.oracle import reference

    if store.semantics != "reference":
        return False
    sums = collections.Counter()
    for pod in store.fixture_view()["pods"]:
        if reference._survives_field_selector(pod):
            sums[pod["nodeName"]] += reference.pod_requests_limits([pod])[3]
    return any(not -2**63 <= v < 2**63 for v in sums.values())


@pytest.mark.parametrize("semantics,extended,extra_cpu,extra_mem", [
    ("reference", (), (), ()), ("strict", (), (), ()),
    ("strict", (GPU,), (), ()),
    ("reference", (), WRAP_CPU, WRAP_MEM), ("strict", (), ("-5",), ("-1Gi",)),
], ids=["reference", "strict", "strict-gpu", "reference-wrap",
        "strict-negative"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_event_streams_match_jax_after_every_event(
    semantics, extended, extra_cpu, extra_mem, seed
):
    rng = random.Random(seed)
    fx = synthetic_fixture(10, seed=seed, unhealthy_frac=0.2,
                           unscheduled_running_pods=2)
    if extended:
        for i, node in enumerate(fx["nodes"]):
            node["allocatable"][GPU] = str(4 * (i % 3))
    quantities = random.Random(~seed)  # leaves the event stream as it is
    for pod in fx["pods"] if extra_cpu else ():
        for c in pod.get("containers", []):
            requests = c.setdefault("resources", {}).setdefault(
                "requests", {})
            requests["cpu"] = quantities.choice(extra_cpu)
            requests["memory"] = quantities.choice(extra_mem)
    t, j = _both(fx, semantics=semantics, extended_resources=extended)
    assert_same_snapshot(t.snapshot(), j.snapshot())
    refused = 0
    wrapped = False
    for step in range(70):
        event = _event(rng, t.fixture_view(), step, step, seed, extended,
                       extra_cpu, extra_mem)
        refused += _apply_both(t, j, event) is not None
        assert_same_snapshot(t.snapshot(), j.snapshot())
        assert t.fixture_view() == j.fixture_view()
        assert_port_matches_repack(t)
        wrapped = wrapped or _row_sum_wraps(t)
    assert refused >= 1  # the stream did exercise the refusal path
    # The wrap streams did wrap a row's memory requests at some step.
    assert wrapped or not (semantics == "reference" and extra_mem)


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


# -- the record form: each pod one immutable encoded record -----------------

def _immutable(value):
    if isinstance(value, tuple):
        return all(_immutable(v) for v in value)
    return value is None or type(value) in (bytes, str, int, bool)


def _held(store):
    """What the store holds of each pod: its encoding, and its row
    contribution."""
    return list(store._pods.values()), [
        c for row in store._pods_by_node.values() for c in row.values()
    ]


@pytest.mark.parametrize("semantics", ["reference", "strict"])
def test_held_pods_are_immutable_records(semantics):
    rng = random.Random(4)
    fx = synthetic_fixture(12, seed=4, unhealthy_frac=0.2,
                           unscheduled_running_pods=2)
    t, j = _both(fx, semantics=semantics)
    for step in range(60):
        _apply_both(t, j, _event(rng, t.fixture_view(), step, step, 4, ()))
        if step % 20 == 0 or step == 59:
            encoded, contribs = _held(t)
            assert encoded and len(contribs) == len(encoded)
            assert all(type(raw) is bytes for raw in encoded)
            assert all(_immutable(c) for c in contribs)
            # Pods of one shape, from the fixture or an event, share one.
            assert len({id(c) for c in contribs}) == len(set(contribs))
    assert t.pod_forms() == {"encoded": len(t.fixture_view()["pods"]),
                             "copied": 0}


@pytest.mark.parametrize("semantics", ["reference", "strict"])
def test_mutating_inputs_after_the_fact_changes_nothing(semantics):
    fx = synthetic_fixture(6, seed=8, unscheduled_running_pods=1)
    t, j = _both(fx, semantics=semantics)
    node = fx["nodes"][0]["name"]
    pod = _mk_pod("late", node)
    event = {"type": "ADDED", "kind": "Pod", "object": pod}
    moved = copy.deepcopy(fx["pods"][1])
    moved["nodeName"] = node
    for store in (t, j):
        store.apply_event(event)
        store.apply_event({"type": "MODIFIED", "kind": "Pod",
                           "object": moved})
    snap, view = t.snapshot(), t.fixture_view()
    # Scribble over everything the callers still hold.
    for p in (*fx["pods"], pod, moved):
        p["nodeName"] = fx["nodes"][-1]["name"]
        p["phase"] = "Succeeded"
        p["containers"][0].setdefault("resources", {})["requests"] = {
            "cpu": "64"}
        p["containers"].append({"resources": {}})
    event["type"] = "DELETED"
    fx["pods"].clear()
    assert_same_snapshot(t.snapshot(), snap)
    assert_same_snapshot(t.snapshot(), j.snapshot())
    assert t.fixture_view() == view == j.fixture_view()
    # And what the store hands out does not reach back into it.
    view["pods"][0]["containers"].clear()
    view["pods"].clear()
    assert t.fixture_view() == j.fixture_view()
    assert_port_matches_repack(t)


class _Tag(str):
    """A str subclass: the record encoder cannot hold it exactly."""


@pytest.mark.parametrize("semantics", ["reference", "strict"])
def test_unencodable_pod_takes_the_deep_copy_fallback(semantics):
    fx = synthetic_fixture(4, seed=6)
    fx["pods"][0]["labels"] = {"team": _Tag("infra")}
    t, j = _both(fx, semantics=semantics)
    assert t.pod_forms()["copied"] == 1
    node = fx["nodes"][1]["name"]
    odd = _mk_pod("odd", node)
    odd["priority"] = np.int64(7)  # a buffer: must not become bytes
    assert _apply_both(t, j, {"type": "ADDED", "kind": "Pod",
                              "object": odd}) is None
    assert t.pod_forms() == {"encoded": len(fx["pods"]) - 1, "copied": 2}
    view = t.fixture_view()
    assert view == j.fixture_view()
    held = {p["name"]: p for p in view["pods"]}
    assert type(held["odd"]["priority"]) is np.int64
    assert type(held[fx["pods"][0]["name"]]["labels"]["team"]) is _Tag
    assert_same_snapshot(t.snapshot(), j.snapshot())
    assert_port_matches_repack(t)
    for name in ("odd", fx["pods"][0]["name"]):
        assert _apply_both(t, j, {"type": "DELETED", "kind": "Pod",
                                  "object": held[name]}) is None
    assert t.pod_forms() == {"encoded": len(fx["pods"]) - 1, "copied": 0}
    assert_same_snapshot(t.snapshot(), j.snapshot())


def test_cyclic_pod_event_is_refused_like_jax():
    fx = synthetic_fixture(3, seed=2)
    t, j = _both(fx, semantics="strict")
    before = t.pod_forms()
    cyclic = _mk_pod("loop", fx["nodes"][0]["name"])
    cyclic["self"] = cyclic
    outcome = _apply_both(t, j, {"type": "ADDED", "kind": "Pod",
                                 "object": cyclic})
    assert outcome[0] == "StoreError"
    assert outcome[1].startswith("cyclic event object: ")
    assert t.pod_forms() == before
    assert_same_snapshot(t.snapshot(), j.snapshot())


def test_strict_pod_event_parses_only_its_own_pod(monkeypatch):
    from kubernetesclustercapacity_tpu_torch import store as store_mod

    fx = synthetic_fixture(3, seed=11, pods_per_node=40)
    t = TStore(fx, semantics="strict")
    row = max(range(3), key=lambda i: len(
        t._pods_by_node.get(fx["nodes"][i]["name"], ())))
    node = fx["nodes"][row]["name"]
    assert len(t._pods_by_node[node]) > 20
    calls = []
    real = store_mod._effective_pod_resources

    def counting(pod, extended):
        calls.append(pod.get("name"))
        return real(pod, extended)

    monkeypatch.setattr(store_mod, "_effective_pod_resources", counting)
    pod = _mk_pod("counted", node)
    moved = dict(pod, nodeName=fx["nodes"][1]["name"])
    events = [
        {"type": "ADDED", "kind": "Pod", "object": pod},
        {"type": "MODIFIED", "kind": "Pod", "object": moved},
        {"type": "DELETED", "kind": "Pod", "object": moved},
    ]
    for k, event in enumerate(events, start=1):
        t.apply_event(event)
        assert calls == ["counted"] * k
    # A node event re-sums the row's cached contributions: no parse.
    t.apply_event({"type": "MODIFIED", "kind": "Node",
                   "object": copy.deepcopy(fx["nodes"][row])})
    assert len(calls) == 3
    monkeypatch.undo()
    assert_port_matches_repack(t)


def test_wrapped_row_sums_match_jax_and_the_oracle():
    from kubernetesclustercapacity_tpu_torch.oracle import reference as oracle

    fx = synthetic_fixture(3, seed=1, unhealthy_frac=0.0)
    t, j = _both(fx, semantics="reference")
    node = fx["nodes"][2]["name"]
    huge = [_mk_pod(f"huge-{k}", node, cpu="18446744073709551", mem="7Ei")
            for k in range(3)]
    for pod in huge:
        assert _apply_both(t, j, {"type": "ADDED", "kind": "Pod",
                                  "object": pod}) is None
    snap = t.snapshot()
    assert_same_snapshot(snap, j.snapshot())
    assert_port_matches_repack(t)
    row = snap.names.index(node)
    on_row = [p for p in t.fixture_view()["pods"] if p["nodeName"] == node
              and oracle._survives_field_selector(p)]
    cpu_lim, cpu_req, mem_lim, mem_req = oracle.pod_requests_limits(on_row)
    assert mem_req == oracle._to_go_int(sum(
        oracle.pod_requests_limits([p])[3] for p in on_row))
    assert int(snap.used_mem_req_bytes[row]) == mem_req
    assert int(snap.used_cpu_req_milli[row]) == oracle._to_go_int(cpu_req)
    # The sums did wrap: three 7Ei requests overflow int64.
    assert mem_req != sum(oracle._mem_value(p["containers"][0]["resources"]
                                            ["requests"]["memory"])
                          for p in on_row)


# -- the footprint: smaller than the fixture, near-invisible to the collector

def _footprint_fixture(form):
    """300 nodes, 30 pods a node.  ``shared`` is the generator's own
    output, whose pods share their container subtrees; ``loaded`` is the
    same fixture as a file or an apiserver list gives it, every pod its
    own objects (what a file-backed server and a follower hold)."""
    from kubernetesclustercapacity_tpu_torch.fixtures import (
        synthetic_fixture as t_fixture,
    )

    fx = t_fixture(300, seed=5, pods_per_node=30)
    return fx if form == "shared" else json.loads(json.dumps(fx))


# Measured with tracemalloc on the fixtures above (seeds 5 and 6, both
# semantics): the store's bytes over the fixture's are 0.29 loaded and
# 1.55 shared (0.86 and 4.57 when the store deep-copied every pod), and
# the store adds 0.19-0.20 tracked objects a pod (5.2 before): the
# nodes' copies and publication rows, about six a node.
STORE_TO_FIXTURE_BYTES = {"loaded": 0.5, "shared": 2.5}
TRACKED_PER_POD = 0.5


@pytest.mark.parametrize("form", ["loaded", "shared"])
@pytest.mark.parametrize("semantics", ["reference", "strict"])
def test_store_is_smaller_than_before_against_its_fixture(semantics, form):
    import gc
    import tracemalloc

    TStore(_footprint_fixture(form), semantics=semantics)  # warm caches
    gc.collect()
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        fx = _footprint_fixture(form)
        gc.collect()
        fixture_bytes = tracemalloc.get_traced_memory()[0] - base
        store = TStore(fx, semantics=semantics)
        gc.collect()
        store_bytes = (tracemalloc.get_traced_memory()[0] - base
                       - fixture_bytes)
    finally:
        tracemalloc.stop()
    assert store.pod_forms()["copied"] == 0
    assert store_bytes < STORE_TO_FIXTURE_BYTES[form] * fixture_bytes, (
        store_bytes, fixture_bytes)


@pytest.mark.parametrize("semantics", ["reference", "strict"])
def test_store_adds_under_one_tracked_object_per_pod(semantics):
    import gc

    TStore(_footprint_fixture("shared"), semantics=semantics)  # warm caches
    fx = _footprint_fixture("shared")
    gc.collect()
    before = len(gc.get_objects())
    store = TStore(fx, semantics=semantics)
    gc.collect()
    grown = len(gc.get_objects()) - before
    assert grown < TRACKED_PER_POD * len(fx["pods"]), (
        grown, len(fx["pods"]))
    assert store.pod_forms()["copied"] == 0


def test_store_pods_gauge_and_dump_after_update():
    from kubernetesclustercapacity_tpu_torch.service.server import (
        CapacityServer,
    )
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
        MetricsRegistry,
    )

    fx = synthetic_fixture(4, seed=3)
    fx["pods"][0]["labels"] = {"team": _Tag("infra")}
    snap = snapshot_from_fixture(copy.deepcopy(fx), semantics="strict")
    registry = MetricsRegistry()
    server = CapacityServer(snap, fixture=fx, device="cpu", port=0,
                            batch_window_ms=0.0, registry=registry)
    try:
        assert "kccap_store_pods" not in registry.snapshot()
        assert "store_pods" not in server.dispatch({"op": "dump"})
        reply = server.dispatch({"op": "update", "events": [
            {"type": "ADDED", "kind": "Pod",
             "object": _mk_pod("gauged", fx["nodes"][0]["name"])}]})
        assert reply["applied"] == 1, reply
        n_pods = len(fx["pods"]) + 1
        values = registry.snapshot()["kccap_store_pods"]["values"]
        assert values == {'form="encoded"': n_pods - 1,
                          'form="copied"': 1}
        dump = server.dispatch({"op": "dump"})
        assert dump["store_pods"] == {"encoded": n_pods - 1, "copied": 1}
    finally:
        server.shutdown()
