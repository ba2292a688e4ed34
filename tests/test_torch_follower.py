"""The port's ClusterFollower and SnapshotCoalescer against the JAX
package's.

Each follower reads its own mock apiserver (``test_kubeapi.
MockApiserver``), both mocks serving the same cluster and the same watch
streams, so the two packages see identical traffic.  Their snapshots,
fixture views and ``stats()`` must be equal after the streams (tolerance
0): plain list+watch, the relist on a 410 ``ERROR`` event, the relist when
an event fails to apply, the decorrelated-jitter backoff under one
``backoff_seed``, the freshness ages on an injected clock, and the fatal
state once watch and relist keep failing past the resync deadline.  The
coalescers' flush and suppression counts are driven to fixed points (no
wall-clock threshold anywhere).
"""

import json
import re
import threading
import time

import pytest

from kubernetesclustercapacity_tpu import follower as j_follower
from kubernetesclustercapacity_tpu.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu.kubeapi import KubeClient as JClient
from kubernetesclustercapacity_tpu.kubeapi import KubeConfig as JConfig
from kubernetesclustercapacity_tpu.service.coalesce import (
    SnapshotCoalescer as JCoalescer,
)
from kubernetesclustercapacity_tpu_torch import follower as t_follower
from kubernetesclustercapacity_tpu_torch.kubeapi import KubeClient as TClient
from kubernetesclustercapacity_tpu_torch.kubeapi import KubeConfig as TConfig
from kubernetesclustercapacity_tpu_torch.service.coalesce import (
    SnapshotCoalescer as TCoalescer,
)

from test_kubeapi import MockApiserver, _k8s_node, _k8s_pod
from test_store import _mk_node, _mk_pod
from test_torch_store import assert_port_matches_repack, assert_same_snapshot

NODES, PODS = "/api/v1/nodes", "/api/v1/pods"
WAIT_S = 30  # generous liveness bound only; no assertion is about time


def _with_rv(obj: dict, rv: int) -> dict:
    obj = json.loads(json.dumps(obj))
    obj.setdefault("metadata", {})["resourceVersion"] = str(rv)
    return obj


@pytest.fixture()
def fixture():
    return synthetic_fixture(6, seed=21, unhealthy_frac=0.0)


@pytest.fixture()
def mocks(fixture):
    servers = [MockApiserver(fixture, require_token="tok") for _ in range(2)]
    yield servers
    for s in servers:
        s.close()


def _pair(mocks, **kw):
    """(JAX follower on mocks[0], port follower on mocks[1])."""
    kw.setdefault("stop_on_idle_window", True)  # finite mock streams
    out = []
    for mod, cfg_cls, client_cls, srv in (
        (j_follower, JConfig, JClient, mocks[0]),
        (t_follower, TConfig, TClient, mocks[1]),
    ):
        cfg = cfg_cls(f"http://127.0.0.1:{srv.port}", token="tok")
        out.append(mod.ClusterFollower(
            client_factory=lambda c=cfg, k=client_cls: k(c), **kw))
    return out


def _streams(mocks, streams):
    for srv in mocks:
        srv.watch_streams = json.loads(json.dumps(streams))


def _assert_same_state(j, t):
    assert_same_snapshot(t.snapshot(), j.snapshot())
    assert t.fixture_view() == j.fixture_view()
    with t._lock:
        assert_port_matches_repack(t._store)


@pytest.mark.parametrize("semantics", ["reference", "strict"])
def test_list_then_watch_matches_jax(mocks, fixture, semantics):
    moved = dict(fixture["pods"][1], phase="Succeeded")
    _streams(mocks, {
        NODES: [[
            {"type": "ADDED",
             "object": _with_rv(_k8s_node(_mk_node("late-joiner")), 501)},
            {"type": "BOOKMARK", "object": {"metadata":
                                            {"resourceVersion": "502"}}},
            {"type": "MODIFIED", "object": _with_rv(_k8s_node(
                _mk_node(fixture["nodes"][2]["name"], healthy=False)), 503)},
        ]],
        PODS: [[
            {"type": "ADDED", "object": _with_rv(
                _k8s_pod(_mk_pod("streamed", "late-joiner")), 601)},
            {"type": "DELETED",
             "object": _with_rv(_k8s_pod(fixture["pods"][0]), 602)},
            {"type": "MODIFIED", "object": _with_rv(_k8s_pod(moved), 603)},
            # Relist races replay ADDED for known objects and DELETED for
            # unknown ones: both are benign upserts.
            {"type": "ADDED", "object": _with_rv(_k8s_pod(moved), 604)},
            {"type": "DELETED", "object": _with_rv(
                _k8s_pod(_mk_pod("never-seen", "")), 605)},
        ]],
    })
    seen = ([], [])
    j, t = _pair(mocks, semantics=semantics)
    j.on_event = lambda *a: seen[0].append(a[:2])
    t.on_event = lambda *a: seen[1].append(a[:2])
    for f in (j, t):
        f.start()
        assert f.wait_synced(WAIT_S)
        f.join(WAIT_S)
    _assert_same_state(j, t)
    assert t.stats() == j.stats()
    # The benign DELETED of an unknown object is not counted as applied.
    assert t.stats()["events_applied"] == 6
    assert sorted(seen[1]) == sorted(seen[0])
    assert t.errors == j.errors == []
    assert t.fatal is None and j.fatal is None


def test_410_gone_and_bad_apply_relist_like_jax(mocks, fixture):
    bad = _k8s_pod(fixture["pods"][2])
    bad["status"]["phase"] = ["unhashable"]  # the store refuses it
    _streams(mocks, {
        PODS: [
            [{"type": "ADDED", "object": _with_rv(
                _k8s_pod(_mk_pod("before-410", "")), 701)},
             {"type": "ERROR",
              "object": {"code": 410, "message": "too old resource version"}}],
            [{"type": "MODIFIED", "object": _with_rv(bad, 702)}],
        ],
    })
    j, t = _pair(mocks, semantics="strict", idle_rewatch_backoff=0.01,
                 backoff_seed=5)
    for f in (j, t):
        f.start()
        assert f.wait_synced(WAIT_S)
        f.join(WAIT_S)
    _assert_same_state(j, t)
    stats_j, stats_t = j.stats(), t.stats()
    assert stats_t == stats_j
    # Two failed watches, each followed by a successful relist (the
    # initial list is the third).
    assert stats_t["watch_failures"] == 2 and stats_t["relists"] == 3
    assert t.errors == j.errors
    assert "too old resource version" in t.errors[0]
    assert "malformed pod object" in t.errors[1]
    assert t.fatal is None and j.fatal is None


def test_backoff_sequence_matches_jax_under_one_seed(mocks):
    j, t = _pair(mocks, idle_rewatch_backoff=0.5, backoff_seed=42)
    seqs = []
    for f in (j, t):
        prev, seq = None, []
        for _ in range(12):
            prev = f._next_backoff(PODS, prev)
            seq.append(prev)
        seqs.append(seq)
        assert f.stats()["backoff_s"] == {PODS: round(prev, 3)}
        f._clear_backoff(PODS)
        assert f.stats()["backoff_s"] == {}
    assert seqs[0] == seqs[1]
    assert all(0.5 <= d <= 30.0 for d in seqs[1])


def test_freshness_ages_read_the_injected_clock(mocks):
    now = [1000.0]
    j, t = _pair(mocks, clock=lambda: now[0])
    for f in (j, t):
        assert f.last_relist_age_s() is None
        assert f.last_verified_age_s() is None
        f.start(watch=False)
    now[0] += 12.3456
    assert t.last_relist_age_s() == j.last_relist_age_s() == 12.346
    assert t.last_verified_age_s() == j.last_verified_age_s() == 12.346


def test_resync_failure_goes_fatal_like_jax(mocks):
    j, t = _pair(mocks, stop_on_idle_window=False, idle_rewatch_backoff=0.02,
                 resync_failure_deadline=0.2, backoff_seed=1)
    for f in (j, t):
        f.start()
        assert f.wait_synced(WAIT_S)
    for srv in mocks:
        srv.close()  # apiserver gone: watch and relist now both fail
    for f in (j, t):
        assert f.wait_stopped(WAIT_S)
    assert j.fatal.startswith(f"{NODES}: RuntimeError: resync failing") or \
        j.fatal.startswith(f"{PODS}: RuntimeError: resync failing")
    # Which stream fails first, its stale time in whole seconds and the
    # last transport error vary from run to run: compare the rest.
    def form(fatal):
        return re.sub(r"\d+s", "Ns",
                      fatal.split(": ", 1)[1].split("; last error")[0])

    assert form(t.fatal) == form(j.fatal) == (
        "RuntimeError: resync failing for Ns (deadline Ns)")
    assert t.stats()["fatal"] == t.fatal


def test_reference_panic_is_fatal_like_jax(mocks):
    short = _mk_node("short-conds")
    short["conditions"] = short["conditions"][:2]
    _streams(mocks, {NODES: [[{"type": "ADDED",
                               "object": _with_rv(_k8s_node(short), 900)}]]})
    j, t = _pair(mocks, semantics="reference")
    for f in (j, t):
        f.start()
        assert f.wait_stopped(WAIT_S)
    assert t.fatal == j.fatal
    assert "ReferencePanic" in t.fatal


def test_extended_columns_follow_like_jax(mocks, fixture):
    pod = _mk_pod("gpu", fixture["nodes"][0]["name"])
    pod["containers"][0]["resources"]["requests"]["nvidia.com/gpu"] = "2"
    _streams(mocks, {PODS: [[{"type": "ADDED",
                              "object": _with_rv(_k8s_pod(pod), 11)}]]})
    j, t = _pair(mocks, semantics="strict",
                 extended_resources=("nvidia.com/gpu",))
    for f in (j, t):
        f.start()
        f.join(WAIT_S)
    _assert_same_state(j, t)
    assert int(t.snapshot().extended["nvidia.com/gpu"][1][0]) >= 2


def _wait(cond):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, "liveness bound exceeded"
        time.sleep(0.002)


@pytest.mark.parametrize("cls", [JCoalescer, TCoalescer], ids=["jax", "port"])
def test_coalescer_flush_and_suppression_counts(cls):
    """Leading edge, suppression, backlog flush and the draining stop,
    each driven to a fixed point; both packages' coalescers give the same
    counts (this test runs once per package)."""
    flushed = []
    c = cls(lambda: flushed.append(1), min_interval_s=60.0, max_pending=4)
    c.notify("Node", "ADDED", {})
    _wait(lambda: c.flushes == 1)  # leading edge: at once
    for _ in range(3):
        c.notify()
    assert c.flushes == 1  # suppressed inside the 60 s window
    c.notify()  # the 4th pending event reaches max_pending
    _wait(lambda: c.flushes == 2)
    for _ in range(2):
        c.notify()
    assert c.stop(timeout=WAIT_S)  # drains the 2 pending events
    assert (c.events, c.flushes, len(flushed)) == (7, 3, 3)
    c.notify()  # after stop: ignored
    stats = c.stats()
    assert (stats["events"], stats["flushes"], stats["pending"],
            stats["last_error"]) == (7, 3, 0, None)


def test_coalescer_errors_and_validation_match_jax():
    errors = ([], [])
    for cls, sink in ((JCoalescer, errors[0]), (TCoalescer, errors[1])):
        def boom():
            raise RuntimeError("publish failed")

        c = cls(boom, min_interval_s=0.0, on_error=sink.append)
        c.notify()
        _wait(lambda c=c: c.last_error is not None)
        assert c.stop(timeout=WAIT_S)
        assert c.flushes == 0
    assert errors[0] == errors[1] == ["RuntimeError: publish failed"]
    for kw in ({"min_interval_s": -1}, {"max_pending": 0}):
        messages = []
        for cls in (JCoalescer, TCoalescer):
            with pytest.raises(ValueError) as info:
                cls(lambda: None, **kw)
            messages.append(str(info.value))
        assert messages[0] == messages[1]


def test_coalescer_wedged_drain_reports_like_jax():
    errors = ([], [])
    release = threading.Event()
    for cls, sink in ((JCoalescer, errors[0]), (TCoalescer, errors[1])):
        c = cls(lambda: release.wait(WAIT_S), min_interval_s=0.0,
                on_error=sink.append)
        c.notify()
        _wait(lambda c=c: c._pending == 0)
        assert c.stop(timeout=0.05) is False
    release.set()
    assert errors[0] == errors[1] and "wedged" in errors[1][0]
