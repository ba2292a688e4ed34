"""The zone-spread cell ``k5k-zonal.spread1k``: its cluster kind, its
discovery by name, its plan, its bound and its four readers, and one
short run of it on the host."""

from __future__ import annotations

import copy
import io
import json
import os

import numpy as np
import pytest

from kccap_bench import roofline, run, spec, spread_bound
from kccap_bench.tests.conftest import REPO, TINY_NODES, copy_benchmark, \
    edit_json

with open(os.path.join(os.path.dirname(__file__), "data",
                       "artifacts.json")) as f:
    ARTIFACTS = json.load(f)

CELL = "k5k-zonal.spread1k"
KEY = "topology.kubernetes.io/zone"
NEW = ("spread_roofline", "domains_ms", "spread_exec_ms",
       "spread_first_dispatch_mib")
MARK_K = {"start": 1, "trace_start": 2, "trace_stop": 3, "end": 5}
MIB = 1 << 20
ROUTES = "kccap_route_scenarios_total"
PHASES = "kccap_phase_seconds"
LATENCY = "kccap_request_latency_seconds"


def read(name, artifacts):
    return spec.load_module(REPO, "metrics", name).read(artifacts)


def test_zoned_fixture_is_synthetic_fixture_with_zone_labels():
    cell = spec.load_cell(REPO, CELL)
    zoned = spec.load_module(REPO, "clusters", "zoned_fixture")
    plain = spec.load_module(REPO, "clusters", "synthetic_fixture")
    block = dict(cell["config"]["cluster"], nodes=200)
    assert block.pop("topology") == [3, 1]
    seed = 2**40 + 17
    mine = zoned.build(dict(block, topology=[3, 1]), seed)
    theirs = plain.build(block, seed)
    assert mine["pods"] == theirs["pods"]
    for a, b in zip(mine["nodes"], theirs["nodes"], strict=True):
        la, lb = a.pop("labels"), b.pop("labels")
        assert a == b
        assert {k: v for k, v in la.items() if not k.startswith(
            "topology.kubernetes.io/")} == lb
    zones = [n["labels"][KEY] for n in zoned.build(
        dict(block, topology=[3, 1]), seed)["nodes"]]
    assert zones[:4] == ["tz-0", "tz-1", "tz-2", "tz-0"]
    assert [zones.count(f"tz-{z}") for z in range(3)] == [67, 67, 66]


def test_the_cell_is_found_by_name_with_its_metrics():
    bench = spec.load_benchmark(REPO)
    cell = spec.load_cell(REPO, CELL)
    assert cell["workload"]["chips"] == 1
    assert cell["config"]["cluster"]["kind"] == "zoned_fixture"
    assert cell["config"]["semantics"] == "strict"
    assert cell["traffic"]["kind"] == "spread"
    assert cell["traffic"]["topology_key"] == KEY
    assert cell["traffic"]["max_skew"] == 1
    traced = {m["name"] for m in spec.cell_metrics(bench, CELL, True)}
    assert traced == {"wire_ms", "device_idle", "gc_ms_per_s", *NEW}
    assert {m["name"] for m in spec.cell_metrics(bench, CELL, False)} == {
        "server_rss_peak_mib", "setup_s"}
    by_name = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        assert by_name[name]["workloads"] == [CELL]
        assert by_name[name]["moves"] == "server_rss_peak_mib"
    assert by_name["spread_roofline"]["layer"] == "Kernels and exact program"
    assert by_name["spread_first_dispatch_mib"]["layer"] == \
        "Server process host memory"
    assert {by_name[n]["layer"] for n in ("domains_ms", "spread_exec_ms")} \
        == {"Topology spread"}


@pytest.fixture(scope="module")
def kind_and_fixture():
    cell = spec.load_cell(REPO, CELL)
    kind = spec.load_module(REPO, "gen", "spread")
    cluster = spec.load_module(REPO, "clusters", "zoned_fixture")
    fx = cluster.build(dict(cell["config"]["cluster"], nodes=60), 9)
    return cell, kind, fx


def test_the_plan_is_deterministic_from_the_seed(kind_and_fixture):
    cell, kind, fx = kind_and_fixture
    traffic, config = cell["traffic"], cell["config"]
    a = kind.plan(traffic, config, 2**41 + 5, 2.0, fx)
    b = kind.plan(traffic, config, 2**41 + 5, 2.0, fx)
    c = kind.plan(traffic, config, 2**41 + 6, 2.0, fx)
    (sa,), (sb,), (sc,) = a.streams, b.streams, c.streams
    assert a.query_op == "topology_spread"
    assert np.array_equal(sa.due, sb.due) and sa.requests == sb.requests
    assert sa.keep == sb.keep and a.warm == b.warm
    assert sa.requests != sc.requests
    assert len(sa.due) == round(traffic["rate_per_s"] * 2.0)
    op, body = sa.requests[0]
    assert op == "topology_spread"
    assert body["topology_key"] == KEY and body["max_skew"] == 1
    mem = np.asarray(body["mem_request_bytes"])
    cpu = np.asarray(body["cpu_request_milli"])
    rep = np.asarray(body["replicas"])
    assert len(mem) == len(cpu) == len(rep) == 1000
    assert (mem % MIB == 0).all()
    assert 64 * MIB <= mem.min() and mem.max() < 8192 * MIB
    assert 50 <= cpu.min() and cpu.max() < 4000
    assert 1 <= rep.min() and rep.max() < 500
    assert len(sa.keep) == min(traffic["check_requests"], len(sa.due))
    assert [len(g) for g in a.warm] == [1, traffic["warm_burst"]]


def test_the_reference_answers_the_kept_requests(kind_and_fixture):
    cell, kind, fx = kind_and_fixture
    import torch

    from kccap_bench.reference import pack

    traffic = dict(cell["traffic"], specs_per_request=50)
    plan = kind.plan(traffic, cell["config"], 3, 1.0, fx)
    cols = pack.pack_strict(fx)
    keys = [(0, "", i, 1) for i in sorted(plan.streams[0].keep)][:3]
    exact = kind.reference_answers(plan, traffic, cell["config"], fx, cols,
                                   keys, torch.int64, "cpu")
    lower = kind.reference_answers(plan, traffic, cell["config"], fx, cols,
                                   keys, torch.int32, "cpu")
    for key in keys:
        totals, sched = exact[key]
        assert totals.shape == sched.shape == (50,)
        assert (totals >= 0).all()
        # int32 wraps a node's memory headroom in bytes
        assert not np.array_equal(lower[key][0], totals)


def test_the_bound_adds_one_operation_a_live_cell_to_the_strict_sweeps():
    n, live, s = 5000, 4275, 1000
    sweep = roofline.sweep_bound_s(n, live, s, "strict")
    spread = spread_bound.spread_bound_s(n, live, s)
    # both bound by the operations at this size
    assert spread == pytest.approx(sweep * 6 / 5, rel=1e-12)
    assert spread == pytest.approx(
        6 * live * s / (roofline.SMS * roofline.LANES_PER_SM
                        * roofline.CLOCK_HZ))
    # a sweep of no live node is bound by its bytes
    assert spread_bound.spread_bound_s(n, 0, s) == pytest.approx(
        (n * 8 * 4 + s * 16) / roofline.HBM_BYTES_PER_S)


def with_spread(scenarios=1000.0, domains_s=0.003, exec_s=0.012,
                first_mib=210.0, other_routes=None):
    """The artifact file with what the program files for the cell: at the
    mark numbered k, ``k * scenarios`` per-node scenarios on the route
    counter, ``10k`` topology_spread requests with ``k * domains_s`` and
    ``k * exec_s`` (split 3:1 between device_exec and fetch) of phases,
    and the route's first-dispatch reading."""
    a = copy.deepcopy(ARTIFACTS)
    routes = {("torch_int64_per_node", "topology_spread"): scenarios,
              **(other_routes or {})}
    for mark, k in MARK_K.items():
        m = a["marks"][mark]
        m["process"][ROUTES] = {"type": "counter", "values": {
            f'kernel="{kn}",reason="{rs}"': base * k
            for (kn, rs), base in routes.items()}}
        if first_mib is not None:
            m["process"]["kccap_hostmem_first_dispatch_bytes"] = {
                "type": "gauge", "values": {
                    'kernel="torch_int64_per_node"': first_mib * MIB,
                    'kernel="cuda_i32_rcp_fused"': 1.3 * MIB}}
        phases = m["server"].setdefault(PHASES, {"type": "histogram",
                                                 "values": {}})["values"]
        split = () if exec_s is None else (("device_exec", exec_s * 0.75),
                                           ("fetch", exec_s * 0.25))
        for phase, s in (("domains", domains_s), *split):
            if s is not None:
                phases[f'op="topology_spread",phase="{phase}"'] = {
                    "sum": s * 10 * k, "count": 10 * k}
        m["server"].setdefault(LATENCY, {"type": "histogram",
                                         "values": {}})["values"][
            'op="topology_spread"'] = {"sum": 0.05 * 10 * k, "count": 10 * k}
    return a


def test_spread_roofline_reads_the_traced_windows_route_scenarios():
    a = with_spread(other_routes={("torch_int64", "mem_not_kib"): 9e5})
    a["cell"].update(n_nodes=5000, live_nodes=4275, specs_per_request=1000)
    # trace_stop - trace_start: 1,000 per-node scenarios, one request
    want = spread_bound.spread_bound_s(5000, 4275, 1000)
    assert read("spread_roofline", a) == pytest.approx(
        want / a["trace"]["kernel_s"] * 100.0)


@pytest.mark.parametrize("scenarios", [1.0, 999.0, 2.5e6])
def test_spread_roofline_is_never_zero(scenarios):
    assert read("spread_roofline", with_spread(scenarios=scenarios)) > 0.0


def test_the_phase_readers_divide_the_window_by_the_requests_answered():
    a = with_spread()
    # start..end: 40 requests, 4 x 10 x the per-request phase
    assert read("domains_ms", a) == pytest.approx(3.0)
    assert read("spread_exec_ms", a) == pytest.approx(12.0)
    assert read("spread_first_dispatch_mib", a) == pytest.approx(210.0)


@pytest.mark.parametrize("case", ["recorded", "no_route", "no_trace",
                                  "no_kernel_time", "other_route_only"])
def test_the_readers_read_nothing_where_the_run_left_nothing(case):
    if case == "recorded":
        a = copy.deepcopy(ARTIFACTS)  # a program without the route
    elif case == "other_route_only":
        a = with_spread(scenarios=0.0, domains_s=None, exec_s=None,
                        first_mib=None,
                        other_routes={("torch_int64", "mem_not_kib"): 5e3})
    else:
        a = with_spread(scenarios=0.0 if case == "no_route" else 1000.0)
        if case == "no_trace":
            a["trace"] = {}
        if case == "no_kernel_time":
            a["trace"]["kernel_s"] = 0.0
    assert read("spread_roofline", a) is None
    if case in ("recorded", "other_route_only"):
        for name in ("domains_ms", "spread_exec_ms",
                     "spread_first_dispatch_mib"):
            assert read(name, a) is None, name


def test_a_short_run_of_the_cell_on_the_host(tmp_path, monkeypatch):
    root = copy_benchmark(str(tmp_path))
    bench = os.path.join(root, "kccap_bench")
    edit_json(os.path.join(bench, "configs", "k5k-zonal.json"),
              cluster__nodes=TINY_NODES)
    edit_json(os.path.join(bench, "traffic", "spread1k.json"),
              rate_per_s=8, specs_per_request=200, check_requests="all")
    monkeypatch.setenv("PYTHONPATH", REPO)
    monkeypatch.chdir(root)
    out = io.StringIO()
    assert run.run_cell(root, CELL, 2**33 + 21, 2.0, True, device="cpu",
                        out=out) == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] == 16
    metrics = result["metrics"]
    # no kernel runs on the host: the roofline share has nothing to read
    assert set(metrics) == {"wire_ms", "device_idle", "gc_ms_per_s",
                            "domains_ms", "spread_exec_ms",
                            "spread_first_dispatch_mib"}
    assert metrics["domains_ms"]["value"] > 0
    assert metrics["spread_exec_ms"]["value"] > 0
