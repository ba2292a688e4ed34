"""The port's replicated serving plane against ``kubernetesclustercapacity_tpu.
service.plane``, on the CPU.

A file-backed leader (``PlanePublisher``) takes seeded ``update`` batches,
and a replica (a ``CapacityServer`` fed by a ``PlaneSubscriber``) follows
it through a ``FaultProxy`` that cuts the stream once mid-way.  The leader
and the replica come from either package: a JAX leader feeds a port
replica, a port leader a JAX replica, and a port leader a port replica.
After every batch the replica holds the leader's generation and snapshot
digest, and its sweeps, fits and explains equal the leader's; the cut is
recorded as a resync.  A replica refuses mutations with the JAX wire code
and message; ``-plane-status`` prints what the JAX CLI prints (volatile
ages and ports aside); a drain is announced to the replicas and recorded
in the audit log; every server flag of this slice runs as the JAX
server's does on the same command line; a tainted node added by an
``update`` reaches the port leader's replicas masked (fault C5 of the JAX
leader, ROADMAP §C).  The SIGTERM path is driven in-process
(``begin_drain``), not through a signal.

Tolerance: none (digests, integers and bytes are equal).
"""

import json
import os
import socket
import time

import numpy as np
import pytest

from kubernetesclustercapacity_tpu import cli as j_cli
from kubernetesclustercapacity_tpu import testing_faults as j_faults
from kubernetesclustercapacity_tpu.audit import AuditLog as JaxLog
from kubernetesclustercapacity_tpu.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu.service import plane as j_plane
from kubernetesclustercapacity_tpu.service import server as j_server
from kubernetesclustercapacity_tpu.service.client import (
    CapacityClient as JaxClient,
)
from kubernetesclustercapacity_tpu.sources import (
    resolve_source as j_resolve_source,
)
from kubernetesclustercapacity_tpu.timeline.diff import (
    snapshot_digest as j_digest,
)
from kubernetesclustercapacity_tpu_torch import cli as t_cli
from kubernetesclustercapacity_tpu_torch import testing_faults as t_faults
from kubernetesclustercapacity_tpu_torch.audit import AuditLog as TorchLog
from kubernetesclustercapacity_tpu_torch.audit import AuditReader
from kubernetesclustercapacity_tpu_torch.service import plane as t_plane
from kubernetesclustercapacity_tpu_torch.service import server as t_server
from kubernetesclustercapacity_tpu_torch.service.client import (
    CapacityClient as TorchClient,
)
from kubernetesclustercapacity_tpu_torch.sources import (
    resolve_source as t_resolve_source,
)
from kubernetesclustercapacity_tpu_torch.timeline.diff import (
    snapshot_digest as t_digest,
)

EXTENDED = ("ephemeral-storage", "nvidia.com/gpu")
BATCHES = 4
TIMEOUT_S = 60.0

SIDES = {
    "jax": (j_server.CapacityServer, j_plane, j_resolve_source, j_digest,
            JaxClient, j_faults, {}),
    "torch": (t_server.CapacityServer, t_plane, t_resolve_source, t_digest,
              TorchClient, t_faults, {"device": "cpu"}),
}


def _wake(sub) -> None:
    """Shut the subscriber's stream socket down, so its thread wakes from
    a blocking read at once (the JAX subscriber's ``stop`` only closes
    it, and then waits out its read timeout)."""
    with sub._lock:
        sock = sub._sock
    if sock is not None:
        sub._stop.set()
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass


def _stop(sub) -> None:
    _wake(sub)
    sub.stop()


def _wait_for(pred, what: str, timeout_s: float = 20.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """A strict 300-node fixture (20% tainted, 0-8 GPUs and 50-500 Gi of
    storage a node) and four seeded batches of 12 watch events."""
    fx = synthetic_fixture(300, seed=51, taint_frac=0.2, unhealthy_frac=0.05,
                           topology=(3, 2))
    rng = np.random.default_rng(52)
    for node in fx["nodes"]:
        node["allocatable"]["nvidia.com/gpu"] = str(rng.integers(0, 9))
        node["allocatable"]["ephemeral-storage"] = \
            f"{rng.integers(50, 501)}Gi"
    path = str(tmp_path_factory.mktemp("plane") / "fleet.json")
    with open(path, "w") as f:
        json.dump(fx, f)
    names = [n["name"] for n in fx["nodes"]]
    running = [p for p in fx["pods"]
               if p["phase"] == "Running" and p.get("nodeName")]
    batches = []
    for b in range(BATCHES):
        events = []
        for k in range(8):
            events.append({"type": "ADDED", "kind": "Pod", "object": {
                "name": f"churn-{b}-{k}", "namespace": "churn",
                "nodeName": names[int(rng.integers(len(names)))],
                "phase": "Running", "containers": [{"resources": {
                    "requests": {"cpu": f"{int(rng.integers(50, 2000))}m",
                                 "memory": f"{int(rng.integers(64, 4096))}"
                                           "Mi"}}}]}})
        for i in rng.choice(len(running), 3, replace=False):
            events.append({"type": "DELETED", "kind": "Pod",
                           "object": running[int(i)]})
        node = json.loads(json.dumps(fx["nodes"][int(rng.integers(300))]))
        node["allocatable"]["cpu"] = str(int(rng.integers(4, 97)))
        events.append({"type": "MODIFIED", "kind": "Node", "object": node})
        batches.append(events)
    return path, batches


def _serve(side, path, **kw):
    server_cls, _, resolve, _, _, _, dev = SIDES[side]
    fixture, snap, _ = resolve(path, "strict", extended_resources=EXTENDED)
    server = server_cls(snap, fixture=fixture, port=0, batch_window_ms=0.0,
                        **dev, **kw)
    server.start()
    return server


QUERIES = (
    {"op": "sweep", "random": {"n": 64, "seed": 7}},
    {"op": "fit", "cpuRequests": "300m", "memRequests": "256mb",
     "replicas": "40", "output": "json"},
    {"op": "explain", "cpuRequests": "700m", "memRequests": "1gb"},
)
# The plane's frames carry the audit vocabulary, which has no extended
# columns: a replica of either package refuses this one alike.
GPU_SWEEP = {"op": "sweep_multi",
             "resources": ["cpu", "memory", "nvidia.com/gpu"],
             "requests": [[500, 1 << 30, 1], [250, 1 << 28, 0]],
             "replicas": [1, 2]}


def _answers(client) -> list:
    """The replies to ``QUERIES`` without the kernel label and the fit's
    rendered report: the report prints the used limits, which the plane's
    frames do not carry (a replica of either package renders them 0)."""
    out = []
    for q in QUERIES:
        reply = client.call(q["op"], **{k: v for k, v in q.items()
                                        if k != "op"})
        out.append({k: v for k, v in reply.items()
                    if k not in ("kernel", "report")})
    return out


@pytest.mark.parametrize("lead,follow", [("jax", "torch"), ("torch", "jax"),
                                         ("torch", "torch")])
def test_replica_follows_the_leader_through_a_cut(fleet, lead, follow):
    path, batches = fleet
    plane_mod = SIDES[lead][1]
    digest = SIDES[lead][3]
    faults = SIDES[follow][5]
    pub = plane_mod.PlanePublisher(heartbeat_s=3600.0)
    leader = _serve(lead, path, plane=pub)
    replica = _serve(follow, path)
    # The fourth server frame (a diff) is delivered, then the link is cut.
    plan = faults.FaultPlan([None, None, None, "drop_post"])
    proxy = faults.FaultProxy(pub.address, plan, stream=True).start()
    sub = SIDES[follow][1].PlaneSubscriber(
        proxy.address, replica, stale_after_s=30.0, seed=3,
        reconnect_base_s=0.01, reconnect_max_s=0.05)
    try:
        _wait_for(lambda: sub.applied_generation >= 1, "the checkpoint")
        with SIDES[lead][4](*leader.address, timeout_s=TIMEOUT_S) as lc, \
                SIDES[follow][4](*replica.address,
                                 timeout_s=TIMEOUT_S) as rc:
            for events in batches:
                lc.update(events)
                want = leader.generation
                _wait_for(lambda: sub.applied_generation == want,
                          f"generation {want}")
                assert sub.stats()["digest"] == digest(leader.snapshot)
                assert replica.generation == want
                assert _answers(rc) == _answers(lc)
                assert rc.last_generation == want
        stats = sub.stats()
        assert plan.injected["drop_post"] == 1
        assert stats["resyncs"] >= 1 and stats["errors"] >= 1
        assert leader.generation == BATCHES + 1
    finally:
        # The publisher and the proxy close first: the subscriber then
        # reads the end of its stream instead of waiting out its read
        # timeout.
        pub.close()
        proxy.stop()
        _stop(sub)
        leader.shutdown()
        replica.shutdown()


def _replica_pair(side, path):
    pub = SIDES[side][1].PlanePublisher(heartbeat_s=3600.0)
    leader = _serve(side, path, plane=pub)
    replica = _serve(side, path)
    sub = SIDES[side][1].PlaneSubscriber(pub.address, replica,
                                         stale_after_s=30.0)
    _wait_for(lambda: sub.applied_generation >= 1, "the checkpoint")
    return pub, leader, replica, sub


def _close(pub, leader, replica, sub):
    pub.close()
    _stop(sub)
    leader.shutdown()
    replica.shutdown()


def _raw(address, msg):
    from kubernetesclustercapacity_tpu_torch.service import protocol

    with socket.create_connection(address, timeout=TIMEOUT_S) as sock:
        protocol.send_msg(sock, msg)
        return protocol.recv_msg(sock)


def test_replica_refuses_mutations_like_jax(fleet):
    path, batches = fleet
    replies = {}
    for side in ("jax", "torch"):
        pair = _replica_pair(side, path)
        try:
            replica = pair[2]
            replies[side] = [
                _raw(replica.address, {"op": "update",
                                       "events": batches[0]}),
                _raw(replica.address, {"op": "reload", "path": path}),
                _raw(replica.address, GPU_SWEEP),
                _raw(replica.address, {"op": "info", "plane": True}),
            ]
        finally:
            _close(*pair)
    for side in replies:
        info = replies[side][3]["result"]
        assert info["capabilities"]["plane"] is True
        assert info["plane"]["role"] == "replica"
        replies[side][3] = sorted(info["plane"])
    assert replies["torch"] == replies["jax"]
    assert replies["torch"][0]["code"] == "not_leader"


def _plane_status(main, address, output, capsys):
    argv = ["-plane-status", f"{address[0]}:{address[1]}", "-output", output]
    rc = main(argv)
    out = capsys.readouterr().out
    if output == "json":
        doc = json.loads(out)
        plane = doc["plane"]
        # Ports and ages are the run's own.
        for key in ("address", "leader", "sync_age_s"):
            plane.pop(key, None)
        return rc, doc
    return rc, [line for line in out.splitlines()
                if not line.startswith("sync")]


@pytest.mark.parametrize("output", ["json", "table"])
def test_plane_status_matches_jax(fleet, output, capsys):
    path, _ = fleet
    got = {}
    for side, main in (("jax", j_cli.main), ("torch", t_cli.main)):
        pair = _replica_pair(side, path)
        try:
            got[side] = [_plane_status(main, pair[1].address, output, capsys),
                         _plane_status(main, pair[2].address, output,
                                       capsys)]
        finally:
            _close(*pair)
    assert got["torch"] == got["jax"]
    assert [rc for rc, _ in got["torch"]] == [0, 0]


def test_drain_is_announced_and_recorded(fleet, tmp_path):
    """``begin_drain`` on a leader announces the drain to its replicas and
    writes the drain record to the audit log, as the JAX leader does; on a
    replica it first stops the subscriber (its drain hook)."""
    path, _ = fleet
    records = {}
    for side, log_cls in (("jax", JaxLog), ("torch", TorchLog)):
        pub = SIDES[side][1].PlanePublisher(heartbeat_s=3600.0)
        log = log_cls(str(tmp_path / side))
        leader = _serve(side, path, plane=pub, audit_log=log)
        replica = _serve(side, path)
        sub = SIDES[side][1].PlaneSubscriber(pub.address, replica,
                                             stale_after_s=30.0)
        try:
            _wait_for(lambda: sub.applied_generation >= 1, "the checkpoint")
            record = leader.begin_drain(reason="test")
            _wait_for(lambda: sub.stats()["leader_draining"], "the drain")
            draining = pub.stats()["draining"]
            pub.close()
            _wake(sub)
            replica_record = replica.begin_drain(reason="test")
            assert sub._stop.is_set()
            records[side] = (record, replica_record, draining)
        finally:
            pub.close()
            _stop(sub)
            leader.shutdown()
            replica.shutdown()
            log.close()
    drains = [r for r in AuditReader.load(str(tmp_path / "torch")).records
              if r.get("kind") == "drain"]
    assert len(drains) == 1 and drains[0]["reason"] == "test"
    volatile = ("ts", "waited_s")
    for side in records:
        leader_rec, replica_rec, draining = records[side]
        records[side] = ([{k: v for k, v in r.items() if k not in volatile}
                          for r in (leader_rec, replica_rec)], draining)
    assert records["torch"] == records["jax"]


def test_generation_never_regresses_like_jax(fleet):
    path, _ = fleet
    errors = {}
    for side in ("jax", "torch"):
        server = _serve(side, path)
        try:
            snap = server.snapshot
            server.replace_snapshot(snap, generation=7)
            assert server.generation == 7
            with pytest.raises(ValueError) as info:
                server.replace_snapshot(snap, generation=3)
            errors[side] = str(info.value)
            server.replace_snapshot(snap, generation=7)
            assert server.generation == 7
        finally:
            server.shutdown()
    assert errors["torch"] == errors["jax"]


def test_healthz_reads_the_plane(fleet):
    path, _ = fleet
    pub, leader, replica, sub = _replica_pair("torch", path)
    try:
        healthy, status = t_server.healthz_probes(leader, plane=pub)
        assert healthy() and status()["plane"]["role"] == "leader"
        healthy, status = t_server.healthz_probes(replica, subscriber=sub)
        assert healthy() and status()["plane"]["role"] == "replica"
        sub._stale_after = 0.0  # no frame can be younger than that
        assert not healthy()
    finally:
        _close(pub, leader, replica, sub)


# Each server flag of the audit, plane, admission and tenancy surfaces, on a
# command line that exits at once in both servers (a bad value or a
# conflicting companion flag), so the port and the JAX server are held to
# the same exit code and error line.
def _flag_cases(tmp):
    not_a_dir = os.path.join(tmp, "file")
    with open(not_a_dir, "w") as f:
        f.write("x")
    bad_tenants = os.path.join(tmp, "tenants.json")
    with open(bad_tenants, "w") as f:
        json.dump({"tenants": [{"name": "a b"}]}, f)
    return {
        "-audit-dir": ["-audit-dir", os.path.join(not_a_dir, "audit")],
        "-audit-max-bytes": ["-audit-dir", os.path.join(not_a_dir, "a"),
                             "-audit-max-bytes", "4096"],
        "-audit-checkpoint-every": ["-audit-dir",
                                    os.path.join(not_a_dir, "a"),
                                    "-audit-checkpoint-every", "4"],
        "-shadow-sample-rate": ["-shadow-sample-rate", "1.5"],
        "-shadow-bundle": ["-shadow-sample-rate", "2",
                           "-shadow-bundle", os.path.join(tmp, "b.jsonl")],
        "-plane-port": ["-plane-port", "1", "-plane-leader",
                        "127.0.0.1:1"],
        "-plane-leader": ["-plane-leader", "nohostport", "-port", "0"],
        "-plane-stale-after-s": ["-plane-leader", "nohostport",
                                 "-plane-stale-after-s", "3", "-port", "0"],
        "-admission-max-concurrent": ["-admission-max-concurrent", "2",
                                      "-admission-price-budget", "2"],
        "-admission-rps": ["-admission-rps", "5",
                           "-admission-price-budget", "-1"],
        "-admission-burst": ["-admission-burst", "5",
                             "-admission-price-budget", "1.5"],
        "-admission-price-budget": ["-admission-price-budget", "3"],
        "-tenants": ["-tenants", bad_tenants],
    }


SERVER_FLAGS = ("-audit-dir", "-audit-max-bytes", "-audit-checkpoint-every",
                "-shadow-sample-rate", "-shadow-bundle", "-plane-port",
                "-plane-leader", "-plane-stale-after-s",
                "-admission-max-concurrent", "-admission-rps",
                "-admission-burst", "-admission-price-budget", "-tenants")


@pytest.mark.parametrize("flag", SERVER_FLAGS)
def test_server_flag_runs_as_in_jax(flag, tmp_path, capsys):
    argv = ["-snapshot", "tests/fixtures/kind-3node.json",
            *_flag_cases(str(tmp_path))[flag]]
    j_rc = j_server.main(argv)
    j_err = capsys.readouterr().err
    t_rc = t_server.main(argv + ["-device", "cpu"])
    t_err = capsys.readouterr().err
    assert t_rc == j_rc == 1
    assert "not yet ported" not in t_err
    assert t_err.splitlines()[-1] == j_err.splitlines()[-1]


def test_every_slice_server_flag_is_a_parser_option():
    options = {o for a in t_server.build_parser()._actions
               for o in a.option_strings}
    assert set(SERVER_FLAGS) <= options
    assert not set(SERVER_FLAGS) & {
        f for f, _ in t_server._UNPORTED_SERVER_FLAGS}


def _tainted_joiner(path):
    """An ``update`` adding a copy of the first tainted node, renamed."""
    fx = json.load(open(path))
    node = next(n for n in fx["nodes"] if n.get("taints"))
    node = dict(json.loads(json.dumps(node)), name="joiner-tainted")
    return [{"type": "ADDED", "kind": "Node", "object": node}]


@pytest.mark.parametrize("lead,follow", [("torch", "torch"),
                                         ("torch", "jax"), ("jax", "jax")])
def test_a_tainted_node_added_reaches_the_replica(fleet, lead, follow):
    """Fault C5 of the reference, fixed in the port: a diff frame carries
    no taints, so the JAX leader's replica serves a tainted node that a
    diff added untainted, and its strict sweep counts the node the leader
    masks.  The port's leader sends that generation as a checkpoint, so a
    replica of either package masks it."""
    path, _ = fleet
    pub = SIDES[lead][1].PlanePublisher(heartbeat_s=3600.0)
    leader = _serve(lead, path, plane=pub)
    replica = _serve(follow, path)
    sub = SIDES[follow][1].PlaneSubscriber(pub.address, replica,
                                           stale_after_s=30.0)
    try:
        _wait_for(lambda: sub.applied_generation >= 1, "the checkpoint")
        leader.dispatch({"op": "update", "events": _tainted_joiner(path)})
        _wait_for(lambda: sub.applied_generation == 2, "generation 2")
        msg = {"op": "sweep", "random": {"n": 64, "seed": 3}}
        want = leader.dispatch(dict(msg))["totals"]
        got = replica.dispatch(dict(msg))["totals"]
    finally:
        pub.close()
        _stop(sub)
        leader.shutdown()
        replica.shutdown()
    if lead == "torch":
        assert got == want
    else:
        assert got != want and all(g >= w for g, w in zip(got, want))
