"""The port's federation tier against ``kubernetesclustercapacity_tpu.
federation``, on the CPU.

Both packages' ``FederationServer`` take the same seeded fleets (three
clusters of ``synthetic_snapshot``, strict ones with an unhealthy row and
a taint) on one driven clock, and their ``fed_sweep``, ``fed_rank``,
``spillover``, ``fed_status`` and ``info`` replies are equal, key for key,
in both semantics and with mixed semantics; every per-cluster row equals
the sequential oracle at the cluster's stamped generation.  The
degradation states flip at the same exact bounds.  Over the wire, three
port leaders behind port ``FaultProxy``s feed a port federation through a
partition (stale, lost, healed), a one-way drop and seeded garbled
streams, and every reply stays exact; a JAX federation and a port
federation attached to the same leaders (of both packages) answer alike.
The ``ReplicaSet`` federation cases, the auth token, the gauges, the CLI's
``-fed-status``/``-fed-sweep`` (byte-equal to the JAX CLI's against either
federation, with equal exit codes) and ``kccap-torch-fed``'s ``main``
(its flag errors equal to ``kccap-fed``'s, and one real run) complete it.

Tolerance: none (integers, states and report bytes are equal; ``age_s``
is equal because both packages read the one driven clock).
"""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from kubernetesclustercapacity_tpu import cli as j_cli
from kubernetesclustercapacity_tpu import federation as j_fed
from kubernetesclustercapacity_tpu import snapshot as j_snapshot
from kubernetesclustercapacity_tpu.federation import server as j_fed_server
from kubernetesclustercapacity_tpu.masks import (
    implicit_taint_mask as j_taint_mask,
)
from kubernetesclustercapacity_tpu.oracle import fit_arrays_python
from kubernetesclustercapacity_tpu.service import plane as j_plane
from kubernetesclustercapacity_tpu.service.server import (
    CapacityServer as JaxServer,
)
from kubernetesclustercapacity_tpu.telemetry.metrics import (
    MetricsRegistry as JaxRegistry,
)
from kubernetesclustercapacity_tpu_torch import cli as t_cli
from kubernetesclustercapacity_tpu_torch import federation as t_fed
from kubernetesclustercapacity_tpu_torch import snapshot as t_snapshot
from kubernetesclustercapacity_tpu_torch.federation import (
    server as t_fed_server,
)
from kubernetesclustercapacity_tpu_torch.resilience import ClusterLostError
from kubernetesclustercapacity_tpu_torch.service import plane as t_plane
from kubernetesclustercapacity_tpu_torch.service.client import (
    CapacityClient as TorchClient,
)
from kubernetesclustercapacity_tpu_torch.service.replicaset import ReplicaSet
from kubernetesclustercapacity_tpu_torch.service.server import (
    CapacityServer as TorchServer,
)
from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
    MetricsRegistry as TorchRegistry,
)
from kubernetesclustercapacity_tpu_torch.testing_faults import (
    FaultPlan,
    FaultProxy,
)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CPU = [100, 500, 900]
MEM = [10 ** 8, 5 * 10 ** 8, 10 ** 9]
REPS = [1, 8, 64]
GRID = {"cpu_request_milli": CPU, "mem_request_bytes": MEM, "replicas": REPS}
NAMES = ("east", "west", "north")
ONE = {"cpuRequests": "500m", "memRequests": "500mb", "replicas": "4"}

SIDES = {
    "jax": (j_fed, j_snapshot, {}),
    "torch": (t_fed, t_snapshot, {"device": "cpu"}),
}


def _wait_for(predicate, timeout_s=20.0, interval_s=0.01, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(interval_s)
    raise AssertionError(f"timed out waiting for {what}")


def _mutate(snap, seed):
    """A derived generation: usage churn on the same nodes (no node is
    added, so no taint rides a diff — fault C5 of the JAX leader stays out
    of the cross pairs)."""
    rng = np.random.default_rng(seed)
    used = snap.used_cpu_req_milli + rng.integers(
        0, 200, size=snap.n_nodes, dtype=np.int64
    )
    return dataclasses.replace(snap, used_cpu_req_milli=used)


def _cluster_snaps(snapshot_mod, semantics, n=48):
    """Three deterministic, distinct cluster snapshots of one package;
    strict ones get an unhealthy row and a taint, so the mask path is not
    vacuous."""
    snaps = {}
    for i, name in enumerate(NAMES):
        snap = snapshot_mod.synthetic_snapshot(n + 8 * i, seed=30 + i)
        if semantics == "strict":
            healthy = snap.healthy.copy()
            healthy[i] = False
            taints = [[] for _ in range(snap.n_nodes)]
            taints[2 * i + 1] = [
                {"key": "dedicated", "value": "x", "effect": "NoSchedule"}
            ]
            snap = dataclasses.replace(
                snap, semantics="strict", healthy=healthy, taints=taints
            )
        snaps[name] = snap
    return snaps


def _oracle_totals(snap, cpu=CPU, mem=MEM):
    """The sequential oracle of the JAX package: [S] totals for one
    snapshot (either package's; the columns are numpy), with the implicit
    taint mask every serving surface applies."""
    mask = j_taint_mask(snap)
    healthy = snap.healthy if mask is None else snap.healthy & mask
    return [
        sum(fit_arrays_python(
            snap.alloc_cpu_milli, snap.alloc_mem_bytes, snap.alloc_pods,
            snap.used_cpu_req_milli, snap.used_mem_req_bytes,
            snap.pods_count, int(c), int(m), mode=snap.semantics,
            healthy=healthy,
        ))
        for c, m in zip(cpu, mem)
    ]


class _Pair:
    """One federation of each package on one driven clock, each holding
    the same fleet (injected, numbered generations)."""

    def __init__(self, semantics="reference", *, stale=5.0, evict=20.0,
                 start=False, **kw):
        self.now = [0.0]
        self.feds = {}
        self.snaps = {}
        for side, (fed_mod, snapshot_mod, extra) in SIDES.items():
            fed = fed_mod.FederationServer(
                stale_after_s=stale, evict_after_s=evict,
                clock=lambda: self.now[0], **kw, **extra,
            )
            self.snaps[side] = _cluster_snaps(snapshot_mod, semantics)
            for i, (name, snap) in enumerate(self.snaps[side].items()):
                fed.inject(name, snap, generation=i + 1)
            self.feds[side] = fed.start() if start else fed

    def both(self, msg):
        """The two replies (or the two errors' type names and texts)."""
        out = []
        for side in SIDES:
            try:
                out.append(self.feds[side].dispatch(dict(msg)))
            except Exception as e:  # noqa: BLE001 - compared below
                out.append((type(e).__name__, str(e)))
        return out

    def reinject_but(self, lost, generation0=10):
        for side in SIDES:
            for i, (name, snap) in enumerate(self.snaps[side].items()):
                if name != lost:
                    self.feds[side].inject(name, snap,
                                           generation=generation0 + i)

    def close(self):
        for fed in self.feds.values():
            fed.close()


@pytest.fixture
def pair():
    made = []

    def make(*a, **kw):
        made.append(_Pair(*a, **kw))
        return made[-1]

    yield make
    for p in made:
        p.close()


# ---------------------------------------------------------------------------
# ClusterFeed and the state machine (offline, driven clock)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("side", list(SIDES))
def test_feed_generation_watermark_monotone(side):
    fed_mod, snapshot_mod, _ = SIDES[side]
    feed = fed_mod.ClusterFeed("c", clock=lambda: 0.0)
    snap = snapshot_mod.synthetic_snapshot(8, seed=1)
    feed.replace_snapshot(snap, generation=5)
    assert feed.view() == (snap, 5)
    with pytest.raises(ValueError, match="must not regress: 3 < held 5"):
        feed.replace_snapshot(snap, generation=3)
    feed.replace_snapshot(snap, generation=5)  # idempotent redelivery
    feed.replace_snapshot(snap)  # un-numbered stages increment locally
    assert feed.view()[1] == 6


def test_feed_verified_age_tracks_the_driven_clock():
    ages = []
    for fed_mod, snapshot_mod, _ in SIDES.values():
        now = [100.0]
        feed = fed_mod.ClusterFeed("c", clock=lambda: now[0])
        seen = [feed.last_verified_age_s(), feed.stream_stats()]
        feed.replace_snapshot(snapshot_mod.synthetic_snapshot(4, seed=2))
        now[0] = 107.5
        ages.append(seen + [feed.last_verified_age_s()])
    assert ages[0] == ages[1] == [None, None, 7.5]


def test_states_flip_at_the_same_exact_bounds(pair):
    p = pair()
    for t in (0.0, 5.0, 5.001, 20.0, 20.001):
        p.now[0] = t
        j, t_ = (fed.status() for fed in p.feds.values())
        assert j == t_, t
        assert [fed.healthy() for fed in p.feds.values()] == [t <= 20.0] * 2
    assert t_["clusters"]["east"]["state"] == "lost"
    p.reinject_but(None)  # heal: every cluster re-verified at t = 20.001
    j, t_ = (fed.status() for fed in p.feds.values())
    assert j == t_ and t_["healthy"] and t_["counts"]["fresh"] == 3


def test_never_synced_is_lost():
    statuses = []
    for fed_mod, _, extra in SIDES.values():
        with fed_mod.FederationServer(stale_after_s=5.0, evict_after_s=20.0,
                                      clock=lambda: 0.0, **extra) as fed:
            fed.attach("ghost", ("127.0.0.1", 1))  # nothing listens there
            statuses.append((fed.status()["clusters"], fed.status()["excluded"],
                             fed.healthy()))
    assert statuses[0] == statuses[1]
    assert statuses[1] == ({"ghost": {"generation": 0, "age_s": None,
                                      "state": "lost"}}, ["ghost"], False)


@pytest.mark.parametrize("kw", [
    {"stale_after_s": 10.0, "evict_after_s": 10.0},
    {"stale_after_s": 0.0, "evict_after_s": 1.0},
])
def test_horizon_validation_messages_match(kw):
    errors = []
    for fed_mod, _, extra in SIDES.values():
        with pytest.raises(ValueError) as info:
            fed_mod.FederationServer(**kw, **extra)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_env_defaults(monkeypatch):
    monkeypatch.setenv("KCCAP_FED_STALE_AFTER_S", "3.5")
    monkeypatch.setenv("KCCAP_FED_EVICT_AFTER_S", "7.25")
    with t_fed.FederationServer(device="cpu") as fed:
        assert (fed.stale_after_s, fed.evict_after_s) == (3.5, 7.25)


def test_duplicate_cluster_refused():
    with t_fed.FederationServer(device="cpu") as fed:
        fed.inject("c", t_snapshot.synthetic_snapshot(4, seed=4))
        with pytest.raises(t_fed.FederationError,
                           match="duplicate cluster name 'c'"):
            fed._register("c", t_fed.ClusterFeed("c"), None)


# ---------------------------------------------------------------------------
# The replies against the JAX federation and the oracle (offline)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("semantics", ["reference", "strict"])
def test_fed_sweep_equals_jax_and_the_oracle(pair, semantics):
    p = pair(semantics)
    j, t = p.both({"op": "fed_sweep", **GRID})
    assert t == j
    grand = [0] * len(CPU)
    for name, snap in p.snaps["torch"].items():
        want = _oracle_totals(snap)
        assert t["per_cluster"][name] == want, name
        grand = [g + w for g, w in zip(grand, want)]
    assert t["totals"] == grand
    assert t["schedulable"] == [g >= k for g, k in zip(grand, REPS)]
    assert t["excluded"] == [] and t["degraded"] is False


@pytest.mark.parametrize("semantics", ["reference", "strict"])
def test_fed_sweep_of_the_six_flags_equals_jax(pair, semantics):
    p = pair(semantics)
    for msg in ({"op": "fed_sweep", **ONE}, {"op": "fed_sweep"},
                {"op": "fed_sweep", "memRequests": "lots"},
                {"op": "fed_sweep", "cpu_request_milli": [1]}):
        j, t = p.both(msg)
        assert t == j, msg


def test_mixed_semantics_groups_stay_exact():
    replies = []
    for fed_mod, snapshot_mod, extra in SIDES.values():
        with fed_mod.FederationServer(stale_after_s=5.0, evict_after_s=20.0,
                                      clock=lambda: 0.0, **extra) as fed:
            ref = snapshot_mod.synthetic_snapshot(40, seed=50)
            strict = dataclasses.replace(
                snapshot_mod.synthetic_snapshot(52, seed=51),
                semantics="strict",
            )
            fed.inject("ref", ref)
            fed.inject("strict", strict)
            replies.append(fed.dispatch({"op": "fed_sweep", **GRID}))
    assert replies[0] == replies[1]
    assert replies[1]["per_cluster"]["ref"] == _oracle_totals(ref)
    assert replies[1]["per_cluster"]["strict"] == _oracle_totals(strict)


def test_stale_cluster_counted_and_annotated(pair):
    p = pair()
    p.now[0] = 8.0
    p.reinject_but("east")
    j, t = p.both({"op": "fed_sweep", **GRID})
    assert t == j
    assert t["clusters"]["east"] == {"generation": 1, "age_s": 8.0,
                                     "state": "stale"}
    assert t["degraded"] is True and t["excluded"] == []
    assert t["per_cluster"]["east"] == _oracle_totals(p.snaps["torch"]["east"])


def test_lost_cluster_excluded_and_named(pair):
    p = pair()
    p.now[0] = 30.0
    p.reinject_but("east")
    j, t = p.both({"op": "fed_sweep", **GRID})
    assert t == j
    assert t["excluded"] == ["east"] and "east" not in t["per_cluster"]
    assert t["totals"] == [
        sum(t["per_cluster"][n][s] for n in ("west", "north"))
        for s in range(len(CPU))
    ]


def test_fed_rank_equals_jax_with_and_without_costs(pair):
    p = pair()
    j, t = p.both({"op": "fed_rank", **ONE})
    assert t == j
    totals = [row["total"] for row in t["ranking"]]
    assert totals == sorted(totals, reverse=True)
    by_headroom = [row["cluster"] for row in t["ranking"]]
    costs = {by_headroom[0]: 9.0, by_headroom[2]: 0.1}
    j, t = p.both({"op": "fed_rank", **ONE, "costs": costs})
    assert t == j
    assert [row["cluster"] for row in t["ranking"]] == [
        by_headroom[2], by_headroom[0], by_headroom[1]]
    for bad in ({"op": "fed_rank", **GRID},
                {"op": "fed_rank", **ONE, "costs": [1]}):
        j, t = p.both(bad)
        assert t == j and t[0] == "ValueError"


def test_spillover_equals_jax(pair):
    p = pair()
    for msg in ({"op": "spillover", "cluster": "east", **ONE},
                {"op": "spillover", "cluster": "west", "demand": 1},
                {"op": "spillover", "cluster": "north", "demand": 10 ** 6},
                {"op": "spillover", "cluster": "nowhere"},
                {"op": "spillover", "cluster": ""},
                {"op": "spillover", "cluster": "east", "demand": -1},
                {"op": "spillover", "cluster": "east", "demand": True}):
        j, t = p.both(msg)
        assert t == j, msg
    r = p.feds["torch"].dispatch({"op": "spillover", "cluster": "east", **ONE})
    assert r["demand"] == int(p.snaps["torch"]["east"].pods_count.sum())
    placed = sum(x["replicas"] for x in r["placements"])
    assert placed + r["unplaced"] == r["demand"]
    headrooms = [x["headroom"] for x in r["placements"]]
    assert headrooms == sorted(headrooms, reverse=True)


def test_spillover_of_a_lost_cluster_is_the_same_typed_refusal(pair):
    p = pair()
    p.now[0] = 30.0
    p.reinject_but("east")
    j, t = p.both({"op": "spillover", "cluster": "east"})
    assert t == j and t[0] == "ClusterLostError"
    with pytest.raises(ClusterLostError, match="east"):
        p.feds["torch"].dispatch({"op": "spillover", "cluster": "east"})


def test_all_lost_fleet_answers_zero_with_everything_named(pair):
    p = pair(stale=1.0, evict=2.0)
    p.now[0] = 10.0
    j, t = p.both({"op": "fed_sweep", **GRID})
    assert t == j
    assert t["totals"] == [0] * len(CPU) and t["per_cluster"] == {}
    assert sorted(t["excluded"]) == sorted(NAMES)


@pytest.mark.parametrize("op", ["fed_status", "info", "ping", "bogus"])
def test_status_info_and_unknown_ops_equal_jax(pair, op):
    p = pair("strict")
    p.now[0] = 6.0
    p.reinject_but("north")
    j, t = p.both({"op": op})
    assert t == j


@pytest.mark.parametrize("semantics", ["reference", "strict"])
def test_concat_snapshots_equals_jax(semantics):
    combined = {}
    for side, (_, snapshot_mod, _) in SIDES.items():
        fed_server = j_fed_server if side == "jax" else t_fed_server
        snaps = list(_cluster_snaps(snapshot_mod, semantics).values())
        combined[side] = fed_server.concat_snapshots(snaps)
        assert fed_server.concat_snapshots([snaps[0]]) is snaps[0]
    j, t = combined["jax"], combined["torch"]
    for field in dataclasses.fields(j):
        a, b = getattr(j, field.name), getattr(t, field.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), field.name
        else:
            assert a == b, field.name
    assert t.n_nodes == 48 + 56 + 64 and t.semantics == semantics


# ---------------------------------------------------------------------------
# The wire: port leaders behind fault proxies, a port federation
# ---------------------------------------------------------------------------
class _Fleet:
    """Three port leaders on the CPU, each behind a stream-mode port fault
    proxy, and one port federation subscribed through the proxies on a
    driven clock; torn down in reverse."""

    def __init__(self, semantics, *, plans=None, stale=2.0, evict=6.0):
        self.now = [0.0]
        self.snaps = _cluster_snaps(t_snapshot, semantics)
        self.leaders, self.pubs, self.proxies = {}, {}, {}
        self.oracle = {}  # (cluster, generation) -> snapshot
        for name in NAMES:
            pub = t_plane.PlanePublisher(heartbeat_s=0.1)
            server = TorchServer(self.snaps[name], port=0, plane=pub,
                                 batch_window_ms=0.0, device="cpu")
            server.start()
            plan = (plans or {}).get(name) or FaultPlan([])
            self.proxies[name] = FaultProxy(pub.address, plan,
                                            stream=True).start()
            self.leaders[name], self.pubs[name] = server, pub
            self.oracle[(name, server.generation)] = self.snaps[name]
        self.fed = t_fed.FederationServer(
            {n: self.proxies[n].address for n in NAMES},
            stale_after_s=stale, evict_after_s=evict,
            clock=lambda: self.now[0], seed=7, device="cpu",
        ).start()
        self.client = TorchClient(*self.fed.address)

    def publish(self, name, snap):
        self.leaders[name].replace_snapshot(snap)
        self.oracle[(name, self.leaders[name].generation)] = snap

    def states(self):
        return {n: c["state"]
                for n, c in self.fed.status()["clusters"].items()}

    def wait_state(self, want, timeout_s=20.0):
        _wait_for(lambda: self.states() == want, timeout_s=timeout_s,
                  what=f"states {want}")

    def wait_generation(self, name, generation, timeout_s=20.0):
        _wait_for(
            lambda: self.fed.status()["clusters"][name]["generation"]
            >= generation,
            timeout_s=timeout_s, what=f"{name} at generation {generation}",
        )

    def close(self):
        self.client.close()
        self.fed.close()
        for name in NAMES:
            self.proxies[name].stop()
            self.pubs[name].close()
            self.leaders[name].shutdown()


def _assert_reply_exact(fleet, reply, *, exclude=()):
    """Every per-cluster row equals the oracle at its stamped generation,
    the grand totals their sum, lost clusters named."""
    grand = [0] * len(CPU)
    for name, totals in reply["per_cluster"].items():
        gen = reply["clusters"][name]["generation"]
        want = _oracle_totals(fleet.oracle[(name, gen)])
        assert totals == want, (name, gen)
        grand = [g + w for g, w in zip(grand, want)]
    assert reply["totals"] == grand
    assert sorted(reply["excluded"]) == sorted(exclude)


@pytest.mark.parametrize("semantics", ["reference", "strict"])
def test_partition_stale_lost_heal_contract(semantics):
    fleet = _Fleet(semantics)
    watermarks = {n: 0 for n in NAMES}

    def query():
        r = fleet.client.fed_sweep(**GRID)
        for n, entry in r["clusters"].items():
            assert entry["generation"] >= watermarks[n], n
            watermarks[n] = entry["generation"]
        return r

    try:
        fleet.wait_state({n: "fresh" for n in NAMES})
        _assert_reply_exact(fleet, query())
        for i, name in enumerate(NAMES):
            fleet.publish(name, _mutate(fleet.snaps[name], seed=60 + i))
        for name in NAMES:
            fleet.wait_generation(name, 2)
        _assert_reply_exact(fleet, query())

        fleet.proxies["east"].partition("both")
        fleet.now[0] = 3.0  # past stale (2), inside evict (6)
        fleet.wait_state({"east": "stale", "west": "fresh", "north": "fresh"})
        r = query()
        assert 2.0 < r["clusters"]["east"]["age_s"] <= 6.0
        assert r["degraded"] is True
        _assert_reply_exact(fleet, r)
        assert fleet.proxies["east"].partition_dropped > 0
        # A generation published during the partition appears nowhere.
        fleet.publish("east", _mutate(fleet.snaps["east"], seed=99))
        assert query()["clusters"]["east"]["generation"] == watermarks["east"]

        fleet.now[0] = 7.0
        fleet.wait_state({"east": "lost", "west": "fresh", "north": "fresh"})
        assert not fleet.fed.healthy()
        _assert_reply_exact(fleet, query(), exclude=["east"])
        with pytest.raises(ClusterLostError):
            fleet.client.spillover("east")

        fleet.proxies["east"].heal()
        fleet.wait_state({n: "fresh" for n in NAMES})
        fleet.wait_generation("east", 3)
        r = query()
        _assert_reply_exact(fleet, r)
        assert r["clusters"]["east"]["generation"] >= 3
        assert fleet.fed.healthy()
    finally:
        fleet.close()


def test_garbled_streams_never_misapply():
    plans = {
        name: FaultPlan.seeded(1000 + i, 40, fault_rate=0.3,
                               faults=("garbage", "drop_pre"))
        for i, name in enumerate(NAMES)
    }
    fleet = _Fleet("reference", plans=plans, stale=8.0, evict=30.0)
    try:
        fleet.wait_state({n: "fresh" for n in NAMES})
        for round_i in range(4):
            for i, name in enumerate(NAMES):
                fleet.publish(name, _mutate(fleet.snaps[name],
                                            seed=200 + 10 * round_i + i))
            for name in NAMES:
                fleet.wait_generation(name, 2 + round_i)
            _assert_reply_exact(fleet, fleet.client.fed_sweep(**GRID))
        injected = sum(sum(p.plan.injected.values())
                       for p in fleet.proxies.values())
        assert injected > 0, "the chaos plan never fired"
    finally:
        fleet.close()


def test_asymmetric_partition_one_way_drop():
    fleet = _Fleet("reference", stale=2.0, evict=30.0)
    try:
        fleet.wait_state({n: "fresh" for n in NAMES})
        fleet.proxies["west"].partition("to_client")
        fleet.now[0] = 3.0
        fleet.wait_state({"east": "fresh", "west": "stale", "north": "fresh"})
        assert fleet.proxies["west"].partition_dropped > 0
        fleet.proxies["west"].heal()
        fleet.wait_state({n: "fresh" for n in NAMES})
    finally:
        fleet.close()


@pytest.mark.parametrize("semantics", ["reference", "strict"])
def test_both_federations_on_leaders_of_both_packages_agree(semantics):
    """A JAX federation and a port federation follow the same three
    leaders (two port leaders, one JAX leader) on one driven clock; after
    every churn round their fed_sweep, fed_rank and status replies are
    equal and exact."""
    now = [0.0]
    j_snaps = _cluster_snaps(j_snapshot, semantics)
    t_snaps = _cluster_snaps(t_snapshot, semantics)
    leaders, pubs = {}, {}
    for name in NAMES:
        if name == "west":
            pub = j_plane.PlanePublisher(heartbeat_s=0.1)
            server = JaxServer(j_snaps[name], port=0, plane=pub,
                               batch_window_ms=0.0)
        else:
            pub = t_plane.PlanePublisher(heartbeat_s=0.1)
            server = TorchServer(t_snaps[name], port=0, plane=pub,
                                 batch_window_ms=0.0, device="cpu")
        leaders[name], pubs[name] = server.start() or server, pub
    addrs = {n: pubs[n].address for n in NAMES}
    feds = [
        j_fed.FederationServer(addrs, stale_after_s=30.0, evict_after_s=60.0,
                               clock=lambda: now[0], seed=3),
        t_fed.FederationServer(addrs, stale_after_s=30.0, evict_after_s=60.0,
                               clock=lambda: now[0], seed=3, device="cpu"),
    ]
    oracle = {(n, 1): t_snaps[n] for n in NAMES}
    try:
        for round_i in range(3):
            gen = 1 + round_i
            for fed in feds:
                _wait_for(lambda: all(
                    c["generation"] >= gen and c["state"] == "fresh"
                    for c in fed.status()["clusters"].values()),
                    what=f"generation {gen}")
            replies = [[fed.dispatch({"op": "fed_sweep", **GRID}),
                        fed.dispatch({"op": "fed_rank", **ONE}),
                        fed.dispatch({"op": "spillover", "cluster": "west"})]
                       for fed in feds]
            assert replies[0] == replies[1]
            sweep = replies[1][0]
            for name, totals in sweep["per_cluster"].items():
                g = sweep["clusters"][name]["generation"]
                assert totals == _oracle_totals(oracle[(name, g)]), name
            for i, name in enumerate(NAMES):
                side_snaps = j_snaps if name == "west" else t_snaps
                snap = _mutate(side_snaps[name], seed=300 + 10 * round_i + i)
                side_snaps[name] = snap
                leaders[name].replace_snapshot(snap)
                oracle[(name, leaders[name].generation)] = snap
    finally:
        for fed in feds:
            fed.close()
        for name in NAMES:
            pubs[name].close()
            leaders[name].shutdown()


def test_subscriber_stats_through_fed_status_match_jax_shape():
    pub = t_plane.PlanePublisher(heartbeat_s=0.05)
    leader = TorchServer(t_snapshot.synthetic_snapshot(8, seed=8), port=0,
                         plane=pub, batch_window_ms=0.0, device="cpu")
    leader.start()
    fed = t_fed.FederationServer({"c": pub.address}, stale_after_s=5.0,
                                 evict_after_s=20.0, device="cpu")
    try:
        _wait_for(lambda: fed.status()["counts"]["fresh"] == 1,
                  what="first verification")
        stream = fed.status()["streams"]["c"]
        assert set(stream) == {
            "role", "leader", "generation", "digest", "applied",
            "skipped", "resyncs", "errors", "leader_draining",
            "sync_age_s", "stale", "stale_after_s", "last_error",
        }
        assert stream["role"] == "replica" and stream["generation"] == 1
    finally:
        fed.close()
        pub.close()
        leader.shutdown()


# ---------------------------------------------------------------------------
# ReplicaSet over federation endpoints
# ---------------------------------------------------------------------------
def _two_feds():
    """fed_a holds 'east' lost (aged out); fed_b holds it fresh."""
    now_a = [100.0]
    fed_a = t_fed.FederationServer(stale_after_s=1.0, evict_after_s=2.0,
                                   clock=lambda: now_a[0], device="cpu")
    fed_b = t_fed.FederationServer(stale_after_s=30.0, evict_after_s=60.0,
                                   device="cpu")
    snap = t_snapshot.synthetic_snapshot(16, seed=70)
    fed_a.inject("east", snap, generation=4)
    now_a[0] = 110.0
    fed_b.inject("east", snap, generation=4)
    return fed_a.start(), fed_b.start()


def test_cluster_lost_wire_code_is_typed():
    fed_a, fed_b = _two_feds()
    try:
        with TorchClient(*fed_a.address) as c:
            with pytest.raises(ClusterLostError):
                c.spillover("east")
    finally:
        fed_a.close()
        fed_b.close()


def test_probe_demotes_the_lost_endpoint_and_a_call_fails_over():
    fed_a, fed_b = _two_feds()
    rs = ReplicaSet([fed_a.address, fed_b.address], cluster="east", rounds=2)
    try:
        probe = rs.probe()
        assert [p["cluster_state"] for p in probe] == ["lost", "fresh"]
        assert [e["lost"] for e in rs.stats()["endpoints"]] == [True, False]
        assert rs._rotation()[0].name == rs.endpoints[1]
        assert rs.call("spillover", cluster="east")["cluster"] == "east"
    finally:
        rs.close()
        fed_a.close()
        fed_b.close()


def test_midcall_cluster_lost_refusal_marks_the_endpoint():
    fed_a, fed_b = _two_feds()
    rs = ReplicaSet([fed_a.address, fed_b.address], cluster="east", rounds=2)
    try:
        assert rs.call("spillover", cluster="east")["cluster"] == "east"
        assert rs.stats()["endpoints"][0]["lost"] is True
    finally:
        rs.close()
        fed_a.close()
        fed_b.close()


# ---------------------------------------------------------------------------
# Surfaces: client wrappers, auth, gauges, the CLI, kccap-torch-fed
# ---------------------------------------------------------------------------
def test_client_wrappers_round_trip(pair):
    p = pair(start=True)
    fed = p.feds["torch"]
    with TorchClient(*fed.address) as c:
        status = c.fed_status()
        assert status["counts"] == {"fresh": 3, "stale": 0, "lost": 0,
                                    "total": 3}
        sweep = c.fed_sweep(cpu_request_milli=np.asarray(CPU),
                            mem_request_bytes=np.asarray(MEM),
                            replicas=np.asarray(REPS))
        assert sweep == p.feds["jax"].dispatch({"op": "fed_sweep", **GRID})
        assert len(c.fed_rank(cpuRequests="500m",
                              memRequests="500mb")["ranking"]) == 3
        assert c.spillover("west", demand=2)["demand"] == 2
        assert c.info()["capabilities"] == {"protocol": 2,
                                            "federation": True}


def test_auth_token_gates_every_op_but_ping():
    fed = t_fed.FederationServer(stale_after_s=5.0, evict_after_s=20.0,
                                 auth_token="sesame", device="cpu")
    fed.inject("c", t_snapshot.synthetic_snapshot(8, seed=11))
    fed.start()
    try:
        with TorchClient(*fed.address) as c:
            assert c.ping() == "pong"
            with pytest.raises(RuntimeError,
                               match="missing or invalid auth token"):
                c.fed_status()
        with TorchClient(*fed.address, token="sesame") as c:
            assert c.fed_status()["enabled"]
    finally:
        fed.close()


def test_gauges_and_sweep_counter_equal_jax():
    snaps = []
    for registry_cls, (fed_mod, snapshot_mod, extra) in zip(
        (JaxRegistry, TorchRegistry), SIDES.values()
    ):
        now = [0.0]
        registry = registry_cls()
        fed = fed_mod.FederationServer(stale_after_s=5.0, evict_after_s=20.0,
                                       clock=lambda: now[0],
                                       registry=registry, **extra)
        try:
            fed.inject("east", snapshot_mod.synthetic_snapshot(8, seed=12),
                       generation=3)
            fed.dispatch({"op": "fed_sweep", **GRID})
            fed.dispatch({"op": "fed_sweep", **GRID})
            first = registry.snapshot()
            now[0] = 8.0
            snaps.append((first, registry.snapshot()))
        finally:
            fed.close()
    assert snaps[0] == snaps[1]
    first, later = snaps[1]
    key = 'cluster="east"'
    assert first["kccap_fed_cluster_up"]["values"][key] == 1.0
    assert first["kccap_fed_generation"]["values"][key] == 3.0
    assert first["kccap_fed_sweep_total"]["values"][""] == 2
    assert later["kccap_fed_cluster_up"]["values"][key] == 0.0
    assert later["kccap_fed_staleness_seconds"]["values"][key] == 8.0


def _cli_both(argv, capsys):
    """Each CLI's (exit code, stdout, stderr) on one command line."""
    out = []
    for main, extra in ((j_cli.main, []), (t_cli.main, ["-device", "cpu"])):
        rc = main(argv + extra)
        o, e = capsys.readouterr()
        out.append((rc, o, e))
    return out


@pytest.mark.parametrize("output", ["table", "json"])
def test_cli_fed_status_equals_the_jax_cli(pair, capsys, output):
    p = pair(start=True)
    for step in ("fresh", "stale", "lost"):
        if step == "stale":
            p.now[0] = 8.0
            p.reinject_but("east")
        elif step == "lost":
            p.now[0] = 30.0
            p.reinject_but("east", generation0=20)
        runs = []
        for fed in p.feds.values():
            runs += _cli_both(["-fed-status", f"127.0.0.1:{fed.address[1]}",
                               "-output", output], capsys)
        assert runs[1:] == runs[:1] * 3, step
        assert runs[0][0] == (1 if step == "lost" else 0)
    assert "east" in runs[0][1]


@pytest.mark.parametrize("output", ["table", "json"])
def test_cli_fed_sweep_equals_the_jax_cli(pair, capsys, output):
    p = pair("strict", start=True)
    cases = [
        (["-cpuRequests", "100m", "-memRequests", "100mb",
          "-replicas", "1"], 0),
        (["-cpuRequests", "100m", "-memRequests", "100mb",
          "-replicas", "99999999"], 1),
    ]
    for argv, want in cases + [("lost", None)]:
        if argv == "lost":
            p.now[0] = 30.0
            p.reinject_but("east")
            argv, want = cases[0][0], 1
        runs = []
        for fed in p.feds.values():
            runs += _cli_both(["-fed-sweep", f"127.0.0.1:{fed.address[1]}",
                               *argv, "-output", output], capsys)
        assert runs[1:] == runs[:1] * 3, argv
        assert runs[0][0] == want
    assert "east" in runs[0][1]


@pytest.mark.parametrize("flag", ["-fed-status", "-fed-sweep"])
def test_cli_fed_flags_unreachable_and_malformed_match_jax(capsys, flag):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    for value in (f"127.0.0.1:{dead}", "nowhere"):
        runs = _cli_both([flag, value], capsys)
        assert runs[0] == runs[1] and runs[0][0] == 1


@pytest.mark.parametrize("argv", [
    [],
    ["-cluster", "east"],
    ["-cluster", "east=127.0.0.1:x"],
    ["-cluster", "a=127.0.0.1:1", "-cluster", "a=127.0.0.1:2"],
    ["-cluster", "a=127.0.0.1:1", "-trace-sample", "sometimes"],
    ["-cluster", "a=127.0.0.1:1", "-auth-token-file", "/nonexistent/tok"],
    ["-cluster", "a=127.0.0.1:1", "-fed-stale-after-s", "9",
     "-fed-evict-after-s", "3"],
])
def test_fed_main_flag_errors_equal_kccap_fed(argv, capsys):
    out = []
    for main, extra in ((j_fed_server.main, []),
                        (t_fed_server.main, ["-device", "cpu"])):
        rc = main(argv + ["-port", "0"] + extra)
        out.append((rc, *capsys.readouterr()))
    assert out[0] == out[1] and out[0][0] == 1 and out[0][2]


def test_fed_main_knows_every_kccap_fed_flag():
    import inspect
    import re

    src = inspect.getsource(j_fed_server.main)
    jax_flags = set(re.findall(r'p\.add_argument\(\s*"(-[a-z-]+)"', src))
    port_src = inspect.getsource(t_fed_server.main)
    port_flags = set(re.findall(r'p\.add_argument\(\s*"(-[a-z-]+)"',
                                port_src))
    assert len(jax_flags) == 10
    assert port_flags == jax_flags | {"-device"}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_kccap_torch_fed_serves_a_leader_until_interrupted(tmp_path):
    """The entry point as a user runs it: a process following one port
    leader, answering fed_status and /healthz, exiting 0 on SIGINT."""
    pub = t_plane.PlanePublisher(heartbeat_s=0.1)
    leader = TorchServer(t_snapshot.synthetic_snapshot(16, seed=5), port=0,
                         plane=pub, batch_window_ms=0.0, device="cpu")
    leader.start()
    port, mport = _free_port(), _free_port()
    trace = tmp_path / "fed.jsonl"
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "kubernetesclustercapacity_tpu_torch.federation.server",
         "-cluster", f"east=127.0.0.1:{pub.address[1]}",
         "-port", str(port), "-metrics-port", str(mport),
         "-fed-stale-after-s", "5", "-fed-evict-after-s", "20",
         "-trace-log", str(trace), "-device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        def fresh():
            try:
                with TorchClient("127.0.0.1", port, timeout_s=2.0,
                                 retry=None) as c:
                    return c.fed_status()["counts"]["fresh"] == 1
            except Exception:  # noqa: BLE001 - not up yet
                return False

        _wait_for(fresh, timeout_s=60.0, interval_s=0.2, what="kccap-torch-fed")
        with TorchClient("127.0.0.1", port) as c:
            r = c.call("fed_sweep", trace_id="cd" * 16, **GRID)
        assert r["per_cluster"]["east"] == _oracle_totals(
            t_snapshot.synthetic_snapshot(16, seed=5))
        with urllib.request.urlopen(
                f"http://127.0.0.1:{mport}/healthz", timeout=10) as resp:
            body = json.loads(resp.read())
        assert resp.status == 200
        assert body["federation"]["counts"]["fresh"] == 1
        proc.send_signal(signal.SIGINT)
        _, err = proc.communicate(timeout=30)
        assert proc.returncode == 0, err
        assert "federating 1 cluster(s) on 127.0.0.1:" in err
        spans = [json.loads(line) for line in trace.read_text().splitlines()]
        assert {s["op"] for s in spans} >= {"fed:fed_sweep", "fed:member"}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        pub.close()
        leader.shutdown()


def test_healthz_goes_503_while_a_cluster_is_lost():
    from kubernetesclustercapacity_tpu_torch.telemetry.exposition import (
        start_metrics_server,
    )

    now = [0.0]
    fed = t_fed.FederationServer(stale_after_s=1.0, evict_after_s=2.0,
                                 clock=lambda: now[0], device="cpu")
    fed.inject("a", t_snapshot.synthetic_snapshot(8, seed=2))
    ms = start_metrics_server(TorchRegistry(), port=0, healthy=fed.healthy,
                              status=lambda: {"federation": fed.status()})
    url = f"http://127.0.0.1:{ms.address[1]}/healthz"
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            assert resp.status == 200
        now[0] = 3.0
        with pytest.raises(urllib.error.HTTPError) as info:
            urllib.request.urlopen(url, timeout=10)
        assert info.value.code == 503
        body = json.loads(info.value.read())
        assert body["federation"]["excluded"] == ["a"]
    finally:
        ms.shutdown()
        fed.close()
