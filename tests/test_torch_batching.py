"""Micro-batching in the port's server: folded batches answer as solo.

Concurrent sweeps of one snapshot generation fold into one dispatch
(``service/batching.py``); a batch that holds an explain rides the fused
sweep+explain program.  Every member's reply must equal its solo reply
(from a server without a batcher) and the JAX server's, and an all-sweep
batch must run the fused sweep once.  The batcher's window is long and
``batch_max`` equals the number of concurrent requests, so a batch
closes when its last member joins: folding is tested by counting calls
of the fused sweep's plain route (``PLAIN_CALLS``, the CPU twin of the
kernel's launch counter), never by timing.
"""

import socket
import threading

import pytest

from kubernetesclustercapacity_tpu.service.server import (
    CapacityServer as JaxServer,
)
from kubernetesclustercapacity_tpu.sources import (
    resolve_source as j_resolve_source,
)
from kubernetesclustercapacity_tpu_torch.ops import fused_fit as tf
from kubernetesclustercapacity_tpu_torch.service import protocol
from kubernetesclustercapacity_tpu_torch.service.server import (
    CapacityServer as TorchServer,
)
from kubernetesclustercapacity_tpu_torch.snapshot import synthetic_snapshot
from kubernetesclustercapacity_tpu_torch.sources import (
    resolve_source as t_resolve_source,
)

TIMEOUT_S = 120.0
WINDOW_MS = 60_000.0  # a batch closes when full, long before this


def _raw(address, msg):
    with socket.create_connection(address, timeout=TIMEOUT_S) as sock:
        sock.settimeout(TIMEOUT_S)
        protocol.send_msg(sock, msg)
        return protocol.recv_msg(sock)


def _concurrently(address, msgs):
    """Send each message from its own thread; replies in order."""
    replies = [None] * len(msgs)

    def run(i):
        replies[i] = _raw(address, msgs[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in
               range(len(msgs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT_S)
    assert not any(t.is_alive() for t in threads)
    return replies


def _relabel(reply):
    res = reply.get("result")
    if isinstance(res, dict) and "kernel" in res:
        res = dict(res, kernel=res["kernel"].replace("pallas_", "plain_")
                   .replace("xla_int64", "torch_int64"))
        reply = dict(reply, result=res)
    return reply


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("batching") / "snap.npz")
    synthetic_snapshot(96, seed=21).save(path)
    return path


def _server(cls, path, semantics=None, **kw):
    resolve = t_resolve_source if cls is TorchServer else j_resolve_source
    fixture, snap, _ = resolve(path, semantics)
    if cls is TorchServer:
        kw["device"] = "cpu"
    server = cls(snap, fixture=fixture, **kw)
    server.start()
    return server


@pytest.fixture
def servers(source):
    made = []

    def make(cls, path=source, semantics=None, **kw):
        made.append(_server(cls, path, semantics, **kw))
        return made[-1]

    yield make
    for s in made:
        s.shutdown()


def _sweeps(n):
    return [{"op": "sweep", "random": {"n": 5 + i, "seed": 100 + i}}
            for i in range(n)]


def _explain(i):
    return {"op": "explain", "cpuRequests": f"{100 + 50 * i}m",
            "memRequests": f"{128 * (i + 1)}mb", "replicas": str(3 + i),
            "output": "json"}


@pytest.mark.parametrize("n", [2, 5, 8])
def test_folded_sweeps_equal_solo_and_run_the_sweep_once(n, servers):
    solo = servers(TorchServer, batch_window_ms=0)
    folded = servers(TorchServer, batch_window_ms=WINDOW_MS, batch_max=n,
                     max_inflight=n)
    msgs = _sweeps(n)
    want = [_raw(solo.address, m) for m in msgs]
    before = tf.PLAIN_CALLS
    got = _concurrently(folded.address, msgs)
    assert tf.PLAIN_CALLS - before == 1
    assert got == want
    assert all(r["ok"] and r["result"]["kernel"] == "plain_i32_rcp_fused"
               for r in got)
    stats = folded.batching_stats
    assert stats["dispatches"] == 1
    assert stats["batched_requests"] == n


def _sweep_as_explain(reply):
    """A solo sweep's reply as a mixed batch gives it: the same numbers,
    under the fused sweep+explain program's label."""
    res = reply["result"]
    if "kernel" not in res:
        return reply
    return dict(reply, result=dict(res, kernel="torch_int64_sweep_explain"))


@pytest.mark.parametrize("mix", ["one-explain", "half-explain",
                                 "all-explain"])
def test_mixed_batches_equal_solo_and_jax(mix, servers):
    n = 6
    sweeps = _sweeps(n)
    picks = {"one-explain": {3}, "half-explain": {0, 2, 4},
             "all-explain": set(range(n))}[mix]
    msgs = [_explain(i) if i in picks else sweeps[i] for i in range(n)]
    solo = servers(TorchServer, batch_window_ms=0)
    folded = servers(TorchServer, batch_window_ms=WINDOW_MS, batch_max=n,
                     max_inflight=n)
    jax_folded = servers(JaxServer, batch_window_ms=WINDOW_MS, batch_max=n,
                         max_inflight=n)
    want = [_raw(solo.address, m) for m in msgs]
    before = tf.PLAIN_CALLS
    got = _concurrently(folded.address, msgs)
    # The fused sweep+explain program serves the batch; B1 is not run.
    assert tf.PLAIN_CALLS == before
    assert [_sweep_as_explain(r) for r in want] == got
    assert folded.batching_stats["dispatches"] == 1
    jax_got = _concurrently(jax_folded.address, msgs)
    assert [_relabel(r) for r in jax_got] == got
    for i, reply in enumerate(got):
        assert reply["ok"]
        if i in picks:
            assert reply["result"]["report"].startswith("{")
        else:
            assert reply["result"]["kernel"] == "torch_int64_sweep_explain"


def test_a_batch_of_one_is_the_solo_path(servers):
    solo = servers(TorchServer, batch_window_ms=0)
    ones = servers(TorchServer, batch_window_ms=WINDOW_MS, batch_max=1)
    for msg in _sweeps(3) + [_explain(1), {"op": "sweep", "random": {
            "n": 4, "seed": 1}, "kernel": "exact"}]:
        before = tf.PLAIN_CALLS
        want = _raw(solo.address, msg)
        between = tf.PLAIN_CALLS
        got = _raw(ones.address, msg)
        assert got == want
        assert tf.PLAIN_CALLS - between == between - before
    assert ones.batching_stats["solo_requests"] == 5
    assert ones.batching_stats["batched_requests"] == 0


def test_strict_masked_folds_equal_solo(servers):
    path = "tests/fixtures/kind-3node.json"
    solo = servers(TorchServer, path, "strict", batch_window_ms=0)
    folded = servers(TorchServer, path, "strict",
                     batch_window_ms=WINDOW_MS, batch_max=4, max_inflight=4)
    msgs = _sweeps(3) + [_explain(2)]
    want = [_sweep_as_explain(_raw(solo.address, m)) for m in msgs]
    assert _concurrently(folded.address, msgs) == want


def test_folds_key_on_the_kernel_family(servers):
    """An exact sweep never shares a launch with an auto one: with two of
    each and batch_max 2, the four requests make two batches."""
    folded = servers(TorchServer, batch_window_ms=WINDOW_MS, batch_max=2,
                     max_inflight=4)
    solo = servers(TorchServer, batch_window_ms=0)
    msgs = _sweeps(2) + [dict(m, kernel="exact") for m in _sweeps(2)]
    want = [_raw(solo.address, m) for m in msgs]
    before = tf.PLAIN_CALLS
    got = _concurrently(folded.address, msgs)
    assert got == want
    assert tf.PLAIN_CALLS - before == 1  # the auto pair; exact is int64
    assert folded.batching_stats["dispatches"] == 2
    assert [r["result"]["kernel"] for r in got] == [
        "plain_i32_rcp_fused"] * 2 + ["torch_int64"] * 2


def test_a_bad_grid_fails_alone(servers):
    """A bad grid fails before it joins a batch: the two good sweeps still
    fill theirs and answer."""
    folded = servers(TorchServer, batch_window_ms=WINDOW_MS, batch_max=2,
                     max_inflight=3)
    bad = {"op": "sweep", "cpu_request_milli": [0],
           "mem_request_bytes": [1 << 20]}
    before = tf.PLAIN_CALLS
    replies = _concurrently(folded.address, [bad] + _sweeps(2))
    assert not replies[0]["ok"]
    assert replies[1]["ok"] and replies[2]["ok"]
    assert tf.PLAIN_CALLS - before == 1
