"""The port's multi-endpoint client against ``kubernetesclustercapacity_tpu.
service.replicaset``, on the CPU.

``parse_endpoints`` reads and refuses the same specs.  A ``ReplicaSet``
over a plane of each package (a leader and two replicas following it)
answers every sweep, fit and explain with what the leader answers, and
what the other package's set answers over its plane; it sends an
``update`` on to the leader past a replica's ``not_leader`` refusal, its
watermark follows the generations, and it reads from the replicas once
they caught up.  A set also fails over past a dead endpoint and past an
``overloaded`` (rps-shed) server, surfaces a ``tenant_quota`` refusal
without failing over, and raises ``ReplicaSetError`` when every endpoint
is down, as the JAX set does.  Sets run over either package's servers.

Tolerance: none (integers and verdicts are equal).
"""

import copy
import json
import socket
import time

import numpy as np
import pytest

from kubernetesclustercapacity_tpu.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu.service import plane as j_plane
from kubernetesclustercapacity_tpu.service import replicaset as j_rs
from kubernetesclustercapacity_tpu.service import tenancy as j_tenancy
from kubernetesclustercapacity_tpu.service.server import (
    CapacityServer as JaxServer,
)
from kubernetesclustercapacity_tpu.sources import (
    resolve_source as j_resolve_source,
)
from kubernetesclustercapacity_tpu_torch.service import plane as t_plane
from kubernetesclustercapacity_tpu_torch.service import replicaset as t_rs
from kubernetesclustercapacity_tpu_torch.service import tenancy as t_tenancy
from kubernetesclustercapacity_tpu_torch.service.server import (
    CapacityServer as TorchServer,
)
from kubernetesclustercapacity_tpu_torch.sources import (
    resolve_source as t_resolve_source,
)

SIDES = {
    "jax": (JaxServer, j_plane, j_rs, j_tenancy, j_resolve_source, {}),
    "torch": (TorchServer, t_plane, t_rs, t_tenancy, t_resolve_source,
              {"device": "cpu"}),
}


def _wait_for(pred, what: str, timeout_s: float = 20.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the error IS the outcome
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("spec", [
    "a:1,b:2", [("h", 9), "x:3"], " a:1 , b:2 ", "", "nocolon", "a:b",
    ["a:1", 5], "a:1,,b:2",
])
def test_parse_endpoints_like_jax(spec):
    assert (_outcome(lambda: t_rs.parse_endpoints(spec))
            == _outcome(lambda: j_rs.parse_endpoints(spec)))


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """A strict 250-node fixture with 3 batches of watch events."""
    fx = synthetic_fixture(250, seed=71, taint_frac=0.2, unhealthy_frac=0.05)
    path = str(tmp_path_factory.mktemp("rs") / "fleet.json")
    with open(path, "w") as f:
        json.dump(fx, f)
    rng = np.random.default_rng(72)
    names = [n["name"] for n in fx["nodes"]]
    batches = [[
        {"type": "ADDED", "kind": "Pod", "object": {
            "name": f"churn-{b}-{k}", "namespace": "churn",
            "nodeName": names[int(rng.integers(len(names)))],
            "phase": "Running", "containers": [{"resources": {"requests": {
                "cpu": f"{int(rng.integers(100, 3000))}m",
                "memory": f"{int(rng.integers(64, 4096))}Mi"}}}]}}
        for k in range(10)] for b in range(3)]
    return path, batches


def _serve(side, path, **kw):
    server_cls, *_, resolve, dev = SIDES[side]
    fixture, snap, _ = resolve(path, "strict")
    server = server_cls(snap, fixture=fixture, port=0, batch_window_ms=0.0,
                        **dev, **kw)
    server.start()
    return server


def _stop_sub(sub) -> None:
    with sub._lock:
        sock = sub._sock
    sub._stop.set()
    if sock is not None:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
    sub.stop()


QUERIES = (
    ("sweep", {"random": {"n": 48, "seed": 5}}),
    ("sweep", {"cpu_request_milli": [100, 2500, 7],
               "mem_request_bytes": [1 << 20, 3 << 30, 1],
               "replicas": [1, 40, 10 ** 6]}),
    ("fit", {"cpuRequests": "600m", "memRequests": "1gb",
             "replicas": "30"}),
    ("explain", {"cpuRequests": "1500m", "memRequests": "2gb"}),
)


def _ask(call) -> list:
    out = []
    for op, params in QUERIES:
        reply = call(op, **copy.deepcopy(params))
        out.append({k: v for k, v in reply.items()
                    if k not in ("kernel", "report")})
    return out


def _plane_run(side, path, batches):
    """A leader, two replicas following it, and a set over replica,
    replica, leader: after each update (sent through the set) the set's
    answers, the leader's, the watermark and the generation."""
    server_cls, plane, rs_mod, *_ = SIDES[side]
    pub = plane.PlanePublisher(heartbeat_s=3600.0)
    leader = _serve(side, path, plane=pub)
    replicas = [_serve(side, path) for _ in range(2)]
    subs = [plane.PlaneSubscriber(pub.address, r, stale_after_s=30.0)
            for r in replicas]
    rs = rs_mod.ReplicaSet([replicas[0].address, replicas[1].address,
                            leader.address], timeout_s=60.0)
    trail = []
    try:
        for s in subs:
            _wait_for(lambda s=s: s.applied_generation >= 1, "checkpoints")
        trail.append(_ask(rs.call))
        for events in batches:
            reply = rs.update(events)
            want = leader.generation
            for s in subs:
                _wait_for(lambda s=s: s.applied_generation == want,
                          f"generation {want}")
            answers = _ask(rs.call)
            assert answers == _ask(lambda op, **p: leader.dispatch(
                {"op": op, **p}))
            trail.append((reply, answers, rs.watermark))
        stats = rs.stats()
    finally:
        rs.close()
        pub.close()
        for s in subs:
            _stop_sub(s)
        leader.shutdown()
        for r in replicas:
            r.shutdown()
    return trail, stats


def test_set_over_a_plane_answers_as_the_leader_and_as_jax(fleet):
    path, batches = fleet
    j_trail, j_stats = _plane_run("jax", path, batches)
    t_trail, t_stats = _plane_run("torch", path, batches)
    assert t_trail == j_trail
    assert [w for *_, w in t_trail[1:]] == [2, 3, 4]
    assert len(t_stats["endpoints"]) == 3


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_port_set_over_either_servers(fleet, side):
    path, _ = fleet
    servers = [_serve(side, path) for _ in range(2)]
    rs = t_rs.ReplicaSet([("127.0.0.1", 1)] + [s.address for s in servers],
                         connect_timeout_s=0.5, timeout_s=60.0)
    try:
        got = _ask(rs.call)
        assert got == _ask(lambda op, **p: servers[0].dispatch(
            {"op": op, **p}))
        assert rs.ping() == "pong"
    finally:
        rs.close()
        for s in servers:
            s.shutdown()


def test_all_dead_raises_like_jax():
    got = []
    for rs_mod in (j_rs, t_rs):
        rs = rs_mod.ReplicaSet([("127.0.0.1", 1), ("127.0.0.1", 2)],
                               connect_timeout_s=0.2, rounds=1)
        try:
            got.append(_outcome(rs.ping)[0])
        finally:
            rs.close()
    assert got == ["ReplicaSetError", "ReplicaSetError"]


def _admission_pair(side, path, **tenant_kw):
    server_cls, plane, rs_mod, tenancy, _, dev = SIDES[side]
    if tenant_kw:
        tm = tenancy.parse_tenants({"tenants": [
            {"name": "capped", "token": "cap-tok", "rps": 0.001,
             "burst": 1.0}]})
        make = [lambda: plane.AdmissionController(tenants=tm)] * 2
        extra = {"tenants": tm}
    else:
        make = [lambda: plane.AdmissionController(rps=0.0001, burst=1.0),
                lambda: None]
        extra = {}
    return [_serve(side, path, admission=m(), **extra) for m in make]


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_overloaded_fails_over_and_quota_does_not(fleet, side):
    path, _ = fleet
    rs_mod = SIDES[side][2]
    servers = _admission_pair(side, path)
    rs = rs_mod.ReplicaSet([s.address for s in servers], timeout_s=60.0)
    try:
        a = rs.sweep(random={"n": 4, "seed": 1})
        b = rs.sweep(random={"n": 4, "seed": 1})
        assert a["totals"] == b["totals"]
        failovers = rs.registry.counter(
            "kccap_replicaset_failovers_total", "", ("cause",))
        assert failovers.labels(cause="overloaded").value >= 1
    finally:
        rs.close()
        for s in servers:
            s.shutdown()
    servers = _admission_pair(side, path, tenants=True)
    rs = rs_mod.ReplicaSet([s.address for s in servers],
                           tenant_token="cap-tok", timeout_s=5.0,
                           deadline_s=5.0)
    try:
        rs.sweep(random={"n": 2, "seed": 1})
        with pytest.raises(Exception) as info:
            rs.sweep(random={"n": 2, "seed": 1})
        assert type(info.value).__name__ == "TenantQuotaError"
    finally:
        rs.close()
        for s in servers:
            s.shutdown()
