"""The traffic and cluster generators at fixed seeds."""

from __future__ import annotations

import numpy as np
import pytest

from kccap_bench import arrivals, spec
from kccap_bench.reference.state import StrictCluster


@pytest.fixture
def cell_of(full_root):
    def load(workload):
        cell = spec.load_cell(full_root, workload)
        kind = spec.load_module(full_root, "gen",
                                cell["traffic"]["kind"])
        cluster = spec.load_module(full_root, "clusters",
                                   cell["config"]["cluster"]["kind"])
        return cell, kind, cluster
    return load


def test_poisson_due_fills_the_window_with_the_same_gaps_in_another_order():
    a = arrivals.poisson_due(100.0, 5.0, seed=1)
    b = arrivals.poisson_due(100.0, 5.0, seed=2)
    assert len(a) == len(b) == 500
    assert a[0] == 0.0 and (np.diff(a) > 0).all() and a[-1] < 5.0
    assert not np.array_equal(a, b)
    assert np.allclose(np.sort(np.diff(np.append(a, 5.0))),
                       np.sort(np.diff(np.append(b, 5.0))))
    assert np.array_equal(a, arrivals.poisson_due(100.0, 5.0, seed=1))


def test_sample_is_seeded_and_all_takes_every_request():
    assert arrivals.sample(3, 100, 10) == arrivals.sample(3, 100, 10)
    assert len(arrivals.sample(3, 100, 10)) == 10
    assert arrivals.sample(3, 7, "all") == frozenset(range(7))


def test_cluster_counts_and_columns(cell_of):
    cell, _, cluster = cell_of("k5k-gpu.churn")
    cfg = dict(cell["config"]["cluster"], nodes=400)
    fx = cluster.build(cfg, 2**40 + 3)
    assert len(fx["nodes"]) == 400
    assert 400 * 20 < len(fx["pods"]) < 400 * 40
    gpus = [int(n["allocatable"]["nvidia.com/gpu"]) for n in fx["nodes"]]
    assert min(gpus) >= 0 and max(gpus) <= 8
    tainted = sum(bool(n["taints"]) for n in fx["nodes"])
    assert 10 < tainted < 80
    assert fx == cluster.build(cfg, 2**40 + 3)


@pytest.mark.parametrize("workload,unit,whole_kib", [
    ("k5k-ref.sweep1k", 1 << 20, True),
    ("k5k-ref.sweep1k-decimal", 10**6, False),
])
def test_sweep_requests_in_range(cell_of, workload, unit, whole_kib):
    cell, kind, cluster = cell_of(workload)
    traffic = cell["traffic"]
    fx = cluster.build(dict(cell["config"]["cluster"], nodes=50), 9)
    plan = kind.plan(traffic, cell["config"], 9, 2.0, fx)
    (stream,) = plan.streams
    assert len(stream.due) == round(traffic["rate_per_s"] * 2.0)
    op, body = stream.requests[0]
    assert op == "sweep"
    mem = np.asarray(body["mem_request_bytes"])
    cpu = np.asarray(body["cpu_request_milli"])
    rep = np.asarray(body["replicas"])
    assert len(mem) == len(cpu) == len(rep) == traffic["specs_per_request"]
    assert (mem % unit == 0).all()
    assert 64 * unit <= mem.min() and mem.max() < 8192 * unit
    assert 50 <= cpu.min() and cpu.max() < 4000
    assert 1 <= rep.min() and rep.max() < 500
    assert bool((mem % 1024 == 0).all()) == whole_kib


def test_multi_requests_in_range(cell_of):
    cell, kind, cluster = cell_of("k5k-gpu.multi1k")
    fx = cluster.build(dict(cell["config"]["cluster"], nodes=50), 9)
    plan = kind.plan(cell["traffic"], cell["config"], 9, 1.0, fx)
    op, body = plan.streams[0].requests[3]
    assert op == "sweep_multi"
    assert body["resources"] == ["cpu", "memory", "nvidia.com/gpu",
                                 "ephemeral-storage"]
    req = np.asarray(body["requests"])
    assert req.shape == (1000, 4)
    assert set(np.unique(req[:, 2])) <= {0, 1, 2}
    assert req[:, 3].min() >= 1 << 30 and req[:, 3].max() < 20 << 30
    assert plan.streams[0].keep == frozenset(range(len(plan.streams[0].due)))


def test_churn_plan_and_every_event_applies(cell_of):
    cell, kind, cluster = cell_of("k5k-gpu.churn")
    traffic = cell["traffic"]
    fx = cluster.build(dict(cell["config"]["cluster"], nodes=300), 5)
    plan = kind.plan(traffic, cell["config"], 5, 3.0, fx)
    polls, writes = plan.streams
    assert len(polls.due) == round(traffic["poll_rate_per_s"] * 3.0)
    assert len(writes.due) == 30 and writes.lane == "writer"
    batches = plan.extra["batches"]
    assert len(batches) == 31
    assert all(len(b) == traffic["events_per_batch"] for b in batches)
    state = StrictCluster(fx, ("ephemeral-storage", "nvidia.com/gpu"))
    for b in batches:
        state.apply(b)  # raises on an event that does not fit the state
    kinds = [e["kind"] + e["type"] for b in batches for e in b]
    assert kinds.count("PodADDED") > 50
    assert plan.warm[1] == [("update", {"events": batches[0]})]


def test_long_churn_stream_spans_chunks_and_stays_consistent(cell_of):
    _, kind, cluster = cell_of("k5k-gpu.churn")
    fx = cluster.build({"nodes": 300, "pods_per_node": 30,
                        "unhealthy_frac": 0.05, "unparseable_mem_frac": 0.02,
                        "taint_frac": 0.1}, 5)
    events = kind.event_stream(fx, 5, 1500)
    state = StrictCluster(fx)
    state.apply(events)
    names = [e["object"]["name"] for e in events if e["type"] == "ADDED"]
    assert len(names) == len(set(names))
