"""The port's trace analyzer against ``kubernetesclustercapacity_tpu.
telemetry.traceview``, on the CPU.

``load_spans``, ``assemble_tree``, ``critical_path`` and ``analyze_trace``
give equal answers in both packages on the same span logs: hand-written
ones (clock skew on and off the path, an in-flight span, an orphan, two
processes whose clocks disagree, a trace that is not there, request-log
lines mixed in) and logs that the port's own processes wrote — a
``ReplicaSet`` client, a port ``FederationServer`` over port leaders with
one cluster partitioned past its eviction horizon, and a port
``CapacityServer`` with its phase spans.  ``kccap-torch -trace-tree ID
-trace-logs DIRS`` prints what the JAX CLI prints, table and JSON, with
the same exit code.

Tolerance: none (trees, paths and report bytes are equal).
"""

import json
import time

import pytest

from kubernetesclustercapacity_tpu import cli as j_cli
from kubernetesclustercapacity_tpu.telemetry import traceview as j_tv
from kubernetesclustercapacity_tpu_torch import cli as t_cli
from kubernetesclustercapacity_tpu_torch.federation import FederationServer
from kubernetesclustercapacity_tpu_torch.service.client import CapacityClient
from kubernetesclustercapacity_tpu_torch.service.plane import PlanePublisher
from kubernetesclustercapacity_tpu_torch.service.replicaset import ReplicaSet
from kubernetesclustercapacity_tpu_torch.service.server import CapacityServer
from kubernetesclustercapacity_tpu_torch.snapshot import synthetic_snapshot
from kubernetesclustercapacity_tpu_torch.telemetry import traceview as t_tv
from kubernetesclustercapacity_tpu_torch.testing_faults import (
    FaultPlan,
    FaultProxy,
)

GRID = {"cpu_request_milli": [100, 500], "mem_request_bytes": [10 ** 8,
                                                               10 ** 9],
        "replicas": [1, 64]}
NAMES = ("east", "west", "north")


def _write(path, spans):
    with open(path, "w") as fh:
        for s in spans:
            fh.write((s if isinstance(s, str) else json.dumps(s)) + "\n")


ROOT = {"trace_id": "T", "span_id": "root", "op": "a", "service": "x",
        "duration_ms": 10.0}
CASES = {
    "skew_on_path": [ROOT, {"trace_id": "T", "span_id": "kid",
                            "parent_span_id": "root", "op": "b",
                            "service": "x", "duration_ms": -3.0}],
    "skew_off_path": [ROOT, {"trace_id": "T", "span_id": "fast",
                             "parent_span_id": "root", "op": "b",
                             "service": "x", "duration_ms": 9.0,
                             "phase": "device_exec"},
                      {"trace_id": "U", "span_id": "z", "op": "c",
                       "service": "x", "duration_ms": -1.0}],
    "in_flight": [ROOT, {"trace_id": "T", "span_id": "dead",
                         "parent_span_id": "root", "op": "b",
                         "service": "x", "duration_ms": None}],
    "orphan": [{"trace_id": "T", "span_id": "lonely",
                "parent_span_id": "never-arrived", "op": "a",
                "service": "x", "duration_ms": 1.0}],
    "skewed_root": [dict(ROOT, duration_ms=-1.0)],
    "mixed_lines": ["not json", "[1, 2]", {"trace_id": "T", "latency_ms": 3},
                    ROOT, {"trace_id": "T", "span_id": "s", "op": "x",
                           "parent_span_id": "root", "duration_ms": "soon"},
                    {"trace_id": "T", "span_id": "root", "op": "a2",
                     "service": "y", "duration_ms": 12.5,
                     "status": "error", "cluster": "east",
                     "state": "stale", "hedge": True}],
    "missing": [],
}


@pytest.mark.parametrize("case", list(CASES))
def test_analyze_trace_equals_jax_on_written_logs(tmp_path, case):
    _write(str(tmp_path / "p1.jsonl"), CASES[case])
    for paths in ([str(tmp_path)], str(tmp_path / "p1.jsonl"),
                  f"{tmp_path / 'p1.jsonl'},{tmp_path / 'none.jsonl'}"):
        assert t_tv.load_spans(paths) == j_tv.load_spans(paths)
        j = j_tv.analyze_trace(paths, "T")
        t = t_tv.analyze_trace(paths, "T")
        assert t == j


def test_refusals_and_flags_read_as_in_the_jax_package(tmp_path):
    _write(str(tmp_path / "a.jsonl"), CASES["skew_on_path"])
    tree = t_tv.analyze_trace([str(tmp_path)], "T")
    assert "kid" in tree["clock_skew_spans"]
    assert tree["critical_path"]["refused"] == "clock_skew"
    _write(str(tmp_path / "a.jsonl"), CASES["in_flight"])
    assert t_tv.analyze_trace([str(tmp_path)], "T")["in_flight"] == ["dead"]
    _write(str(tmp_path / "a.jsonl"), CASES["orphan"])
    tree = t_tv.assemble_tree(t_tv.load_spans([str(tmp_path)]), "T")
    assert tree["orphans"] == 1 and len(tree["roots"]) == 1


def test_multi_process_stitching_needs_no_clock_agreement(tmp_path):
    _write(str(tmp_path / "client.jsonl"), [
        {"trace_id": "T", "span_id": "c1", "op": "rs:sweep",
         "service": "replicaset", "duration_ms": 12.0, "ts": 2_000_000.0}])
    _write(str(tmp_path / "server.jsonl"), [
        {"trace_id": "T", "span_id": "s1", "parent_span_id": "c1",
         "op": "sweep", "service": "server", "duration_ms": 10.0,
         "ts": 1_000.0}])
    with open(tmp_path / "server.jsonl.1", "w") as fh:
        fh.write(json.dumps({"trace_id": "T", "span_id": "s0",
                             "parent_span_id": "s1", "op": "phase:fetch",
                             "phase": "fetch", "service": "server",
                             "duration_ms": 4.0}) + "\n")
    t = t_tv.analyze_trace([str(tmp_path)], "T")
    assert t == j_tv.analyze_trace([str(tmp_path)], "T")
    assert t["processes"] == ["replicaset", "server"]
    (root,) = t["roots"]
    assert [c["span_id"] for c in root["children"]] == ["s1"]
    assert [s["span_id"] for s in t["critical_path"]["path"]] == [
        "c1", "s1", "s0"]


def _nodes(node):
    yield node
    for child in node.get("children", ()):
        yield from _nodes(child)


@pytest.fixture(scope="module")
def fed_trace(tmp_path_factory):
    """A traced fed_sweep through a ReplicaSet client to a port federation
    over three port leaders, east partitioned past its eviction horizon;
    then a traced sweep on a port server.  Returns the log directory and
    both trace ids."""
    tmp = tmp_path_factory.mktemp("traces")
    now = [0.0]
    leaders, pubs, proxies = {}, {}, {}
    for i, name in enumerate(NAMES):
        pub = PlanePublisher(heartbeat_s=0.1)
        srv = CapacityServer(synthetic_snapshot(16, seed=20 + i), port=0,
                             plane=pub, batch_window_ms=0.0, device="cpu")
        srv.start()
        proxies[name] = FaultProxy(pub.address, FaultPlan([]),
                                   stream=True).start()
        leaders[name], pubs[name] = srv, pub
    fed = FederationServer(
        {n: proxies[n].address for n in NAMES}, stale_after_s=2.0,
        evict_after_s=6.0, clock=lambda: now[0], seed=11,
        trace_log=str(tmp / "fed.jsonl"), trace_sample="always",
        device="cpu",
    ).start()
    rs = ReplicaSet([fed.address], connect_timeout_s=5.0, timeout_s=30.0,
                    trace_log=str(tmp / "rs.jsonl"))
    server = CapacityServer(synthetic_snapshot(32, seed=3), port=0,
                            batch_window_ms=0.0, device="cpu",
                            trace_log=str(tmp / "server.jsonl"))
    server.start()

    def states():
        return {n: c["state"] for n, c in fed.status()["clusters"].items()}

    def wait(pred):
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and not pred():
            time.sleep(0.02)

    try:
        wait(lambda: set(states().values()) == {"fresh"})
        proxies["east"].partition("both")
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and states()["east"] != "lost":
            now[0] += 10.0
            time.sleep(0.05)
        wait(lambda: states()["west"] == states()["north"] == "fresh")
        reply = rs.call("fed_sweep", **GRID)
        assert reply["excluded"] == ["east"]
        with open(tmp / "rs.jsonl") as fh:
            fed_tid = json.loads(fh.readlines()[-1])["trace_id"]
        with CapacityClient(*server.address) as c:
            c.call("sweep", random={"n": 8}, trace_id="ef" * 16)
    finally:
        server.shutdown()
        rs.close()
        fed.close()
        for name in NAMES:
            proxies[name].stop()
            pubs[name].close()
            leaders[name].shutdown()
    return str(tmp), fed_tid, "ef" * 16


def test_port_federation_logs_assemble_with_a_member_per_cluster(fed_trace):
    logs, fed_tid, _ = fed_trace
    t = t_tv.analyze_trace([logs], fed_tid)
    assert t == j_tv.analyze_trace([logs], fed_tid)
    flat = [s for r in t["roots"] for s in _nodes(r)]
    members = {s["cluster"]: s for s in flat if s["op"] == "fed:member"}
    assert set(members) == set(NAMES)  # the lost cluster is present
    assert members["east"]["state"] == "lost"
    assert members["east"]["status"] == "error"
    assert members["east"]["duration_ms"] == 0.0
    assert {"rs:fed_sweep", "rs:attempt", "fed:fed_sweep"} <= {
        s["op"] for s in flat}
    assert not t["critical_path"].get("refused")


def test_port_server_logs_assemble_equal(fed_trace):
    logs, _, server_tid = fed_trace
    t = t_tv.analyze_trace([logs], server_tid)
    assert t == j_tv.analyze_trace([logs], server_tid)
    assert t["found"] and t["processes"] == ["server"]
    assert t["critical_path"]["dominant"] is not None


@pytest.mark.parametrize("which", ["fed", "server", "absent"])
@pytest.mark.parametrize("output", ["table", "json"])
def test_cli_trace_tree_equals_the_jax_cli(fed_trace, capsys, which, output):
    logs, fed_tid, server_tid = fed_trace
    tid = {"fed": fed_tid, "server": server_tid, "absent": "00" * 16}[which]
    outs = []
    for main in (j_cli.main, t_cli.main):
        rc = main(["-trace-tree", tid, "-trace-logs", logs,
                   "-output", output])
        outs.append((rc, *capsys.readouterr()))
    assert outs[0] == outs[1]
    assert outs[0][0] == (1 if which == "absent" else 0)
    if which == "fed" and output == "table":
        text = outs[1][1]
        assert text.count("- fed:member [fed]") == 3
        assert "ERROR cluster=east state=lost" in text


def test_cli_trace_tree_without_logs_matches_jax(capsys):
    outs = []
    for main in (j_cli.main, t_cli.main):
        rc = main(["-trace-tree", "ab" * 16])
        outs.append((rc, *capsys.readouterr()))
    assert outs[0] == outs[1] and outs[0][0] == 1
    assert "needs -trace-logs" in outs[0][2]
