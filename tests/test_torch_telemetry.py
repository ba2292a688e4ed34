"""The port's operator telemetry against the JAX package's, on the CPU.

* ``render_text`` byte for byte on two registries fed the same samples
  (labels in declaration order, escaping, histograms, exemplars).
* ``MetricsServer``: ``/metrics``, ``/healthz`` (its status merge and
  its 503s), ``HEAD``, 404, the scrape's self-reported duration.
* The scrape of both servers after the same requests: the port registers
  no ``kccap_*`` family the JAX server lacks, and every family both have
  carries the same type, label names and counter values (kernel labels
  mapped, timings excluded).
* The process and node-group gauges.
* The ``dump`` op with every filter, the request log (``-log-json``),
  :func:`healthz_probes` (the follower, the timeline's capacity-at-risk,
  forecast and gang watches, a drain and the device ledger each flip
  ``/healthz`` to 503; plain watch breaches do not).
* Both servers' ``main`` with ``-metrics-port``, and both CLIs'
  ``-dump``, ``-metrics-port`` and ``-trace-log``.

Tolerance: integers and rendered text equal; timings (latencies, scrape
durations, RSS) are excluded, never compared.
"""

import contextlib
import copy
import json
import os
import re
import socket
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from kubernetesclustercapacity_tpu import cli as j_cli
from kubernetesclustercapacity_tpu import report as j_report
from kubernetesclustercapacity_tpu import snapshot as j_snapshot
from kubernetesclustercapacity_tpu.service.server import (
    CapacityServer as JaxServer,
)
from kubernetesclustercapacity_tpu.telemetry import exposition as j_expo
from kubernetesclustercapacity_tpu.telemetry import process as j_process
from kubernetesclustercapacity_tpu.telemetry.metrics import (
    MetricsRegistry as JaxRegistry,
)
from kubernetesclustercapacity_tpu_torch import cli as t_cli
from kubernetesclustercapacity_tpu_torch import report as t_report
from kubernetesclustercapacity_tpu_torch import snapshot as t_snapshot
from kubernetesclustercapacity_tpu_torch.service.client import (
    CapacityClient as TorchClient,
)
from kubernetesclustercapacity_tpu_torch.service.server import (
    CapacityServer as TorchServer,
)
from kubernetesclustercapacity_tpu_torch.service.server import healthz_probes
from kubernetesclustercapacity_tpu_torch.telemetry import exposition as t_expo
from kubernetesclustercapacity_tpu_torch.telemetry import memledger
from kubernetesclustercapacity_tpu_torch.telemetry import process as t_process
from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
    MetricsRegistry as TorchRegistry,
)

TIMEOUT_S = 120.0
KIND = "tests/fixtures/kind-3node.json"


def _feed(reg, seed):
    """Seeded samples into counters, gauges and histograms, with labels
    that need escaping and exemplars on some observations."""
    rng = np.random.default_rng(seed)
    c = reg.counter("kccap_test_total", "A counter.\nWith a newline \\.",
                    ("op", "error"))
    g = reg.gauge("kccap_test_gauge", "A gauge.", ("watch",))
    h = reg.histogram("kccap_test_seconds", "A histogram.", ("op",))
    u = reg.gauge("kccap_test_unlabeled", "No labels.")
    names = ["sweep", 'q"uote', "back\\slash", "new\nline", "plain"]
    for _ in range(int(rng.integers(5, 60))):
        op = names[int(rng.integers(len(names)))]
        c.labels(error="ValueError", op=op).inc(int(rng.integers(1, 5)))
        g.labels(watch=op).set(float(rng.normal()))
        ex = f"{int(rng.integers(1 << 62)):032x}" if rng.random() < 0.3 \
            else None
        h.labels(op=op).observe(float(rng.exponential(0.02)), exemplar=ex)
    u.set(int(rng.integers(100)))


@pytest.mark.parametrize("seed", range(5))
def test_render_text_byte_for_byte(seed, monkeypatch):
    # Exemplar timestamps come from the clock: pin it for both packages.
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    regs = JaxRegistry(), TorchRegistry()
    for reg in regs:
        _feed(reg, seed)
    j_text = j_expo.render_text(regs[0])
    assert t_expo.render_text(regs[1]) == j_text
    assert "# TYPE kccap_test_seconds histogram" in j_text
    assert t_expo.render_text(TorchRegistry()) == ""


def _get(url, method="GET"):
    req = urllib.request.Request(url, method=method)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


ENDPOINT_CASES = {
    "healthy": dict(),
    "unhealthy": dict(healthy=lambda: False),
    "raising-check": dict(healthy=lambda: 1 / 0),
    "status": dict(status=lambda: {"snapshot_generation": 7,
                                   "follower": {"fatal": None}}),
    "raising-status": dict(status=lambda: 1 / 0),
}


@pytest.mark.parametrize("case", sorted(ENDPOINT_CASES))
@pytest.mark.parametrize("path,method", [("/healthz", "GET"),
                                         ("/healthz", "HEAD"),
                                         ("/nope", "GET"),
                                         ("/metrics", "HEAD")])
def test_metrics_server_answers_like_jax(case, path, method):
    outs = []
    for expo, reg in ((j_expo, JaxRegistry()), (t_expo, TorchRegistry())):
        reg.counter("kccap_x_total", "x").inc(3)
        server = expo.start_metrics_server(reg, **ENDPOINT_CASES[case])
        try:
            outs.append(_get(server.url + path, method))
        finally:
            server.shutdown()
    assert outs[1] == outs[0]


def test_scrape_and_its_self_reported_duration():
    reg = TorchRegistry()
    reg.counter("kccap_x_total", "x").inc(3)
    server = t_expo.start_metrics_server(reg)
    try:
        code, ctype, body = _get(server.url + "/metrics")
        assert code == 200
        assert ctype == "text/plain; version=0.0.4; charset=utf-8"
        assert b"kccap_x_total 3" in body
        _, _, body = _get(server.url + "/metrics")
        assert b"kccap_scrape_duration_seconds_count 1" in body
    finally:
        server.shutdown()


def test_scrape_duration_skipped_when_disabled(monkeypatch):
    monkeypatch.setenv("KCCAP_TELEMETRY", "0")
    reg = TorchRegistry()
    server = t_expo.start_metrics_server(reg)
    try:
        _get(server.url + "/metrics")
        assert reg.snapshot() == {}
    finally:
        server.shutdown()


_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)")


def parse_scrape(text: str) -> dict:
    """``{family: (type, {sample_name: {label_block: value}})}``, exemplar
    tails dropped."""
    families: dict = {}
    current = None
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            current = families.setdefault(name, (kind, {}))
        elif line and not line.startswith("#"):
            m = _SAMPLE.match(line.split(" # ", 1)[0])
            current[1].setdefault(m.group(1), {})[m.group(2) or ""] = \
                float(m.group(3))
    return families


def _labelnames(samples: dict) -> set:
    return {tuple(re.findall(r'([a-z_]+)="', block))
            for by_label in samples.values() for block in by_label}


def _relabel(text: str) -> str:
    return text.replace("pallas_", "plain_").replace("xla_int64",
                                                     "torch_int64")


REQUESTS = [
    {"op": "ping"},
    {"op": "info"},
    {"op": "sweep", "random": {"n": 16, "seed": 3}},
    {"op": "sweep", "random": {"n": 16, "seed": 4}, "kernel": "exact"},
    {"op": "fit", "cpuRequests": "200m", "memRequests": "250mb",
     "replicas": "10"},
    {"op": "fit", "cpuRequests": "200m", "memRequests": "lots"},
    {"op": "explain", "cpuRequests": "300m", "memRequests": "500mb"},
    {"op": "timeline"},
    {"op": "slo"},
    {"op": "dump", "limit": 2},
    {"op": "frobnicate"},
]


@pytest.fixture(scope="module")
def served_pair(tmp_path_factory):
    """Both servers on the kind fixture, each on its own registry and
    request log, after the same requests; the scrapes and the request logs
    are read right after them (the dump tests below add requests)."""
    d = tmp_path_factory.mktemp("telemetry")
    with _serve_pair(d) as out:
        out["scrape"] = {name: render(out["regs"][name]) for name, render
                         in (("jax", j_expo.render_text),
                             ("torch", t_expo.render_text))}
        out["request_log"] = {}
        for name, path in out["logs"].items():
            with open(path, encoding="utf-8") as f:
                out["request_log"][name] = [json.loads(x) for x in f]
        yield out


@contextlib.contextmanager
def _serve_pair(d):
    from kubernetesclustercapacity_tpu.sources import resolve_source as j_rs
    from kubernetesclustercapacity_tpu_torch.service import protocol
    from kubernetesclustercapacity_tpu_torch.sources import (
        resolve_source as t_rs,
    )

    jf, js, _ = j_rs(KIND, "reference")
    tf, ts, _ = t_rs(KIND, "reference")
    regs = {"jax": JaxRegistry(), "torch": TorchRegistry()}
    logs = {k: str(d / f"{k}-requests.jsonl") for k in regs}
    servers = {
        "jax": JaxServer(js, fixture=jf, registry=regs["jax"],
                         request_log=logs["jax"], batch_window_ms=0),
        "torch": TorchServer(ts, fixture=tf, registry=regs["torch"],
                             request_log=logs["torch"], device="cpu",
                             batch_window_ms=0),
    }
    replies = {}
    try:
        for name, server in servers.items():
            server.start()
            replies[name] = []
            for msg in REQUESTS:
                with socket.create_connection(server.address,
                                              timeout=TIMEOUT_S) as sock:
                    protocol.send_msg(sock, msg)
                    replies[name].append(protocol.recv_msg(sock))
        yield {"servers": servers, "regs": regs, "logs": logs,
               "replies": replies}
    finally:
        for server in servers.values():
            server.shutdown()


def test_scrape_families_match_jax(served_pair):
    j = parse_scrape(_relabel(served_pair["scrape"]["jax"]))
    t = parse_scrape(served_pair["scrape"]["torch"])
    assert set(t) <= set(j), sorted(set(t) - set(j))
    assert {"kccap_requests_total", "kccap_request_errors_total",
            "kccap_request_latency_seconds"} <= set(t)
    for name in t:
        assert t[name][0] == j[name][0], name
        assert _labelnames(t[name][1]) == _labelnames(j[name][1]), name


@pytest.mark.parametrize("family", [
    "kccap_requests_total",
    "kccap_request_errors_total",
    "kccap_deadline_shed_total",
    "kccap_requests_in_flight",
    "kccap_server_draining",
])
def test_scrape_counter_values_match_jax(family, served_pair):
    j = parse_scrape(served_pair["scrape"]["jax"])
    t = parse_scrape(served_pair["scrape"]["torch"])
    assert t[family] == j[family]


def test_scrape_latency_counts_match_jax(served_pair):
    j = parse_scrape(served_pair["scrape"]["jax"])
    t = parse_scrape(served_pair["scrape"]["torch"])
    name = "kccap_request_latency_seconds"
    assert (t[name][1][name + "_count"] == j[name][1][name + "_count"])
    assert sum(t[name][1][name + "_count"].values()) == len(REQUESTS)


def _dump_norm(reply):
    reply = copy.deepcopy(reply)
    res = reply.get("result")
    if isinstance(res, dict):
        for rec in res.get("records", []):
            for key in ("ts", "latency_ms", "phases", "result_digest"):
                rec.pop(key, None)
    return reply


DUMP_QUERIES = {
    "all": {},
    "op": {"filter_op": "sweep"},
    "op-none": {"filter_op": "nope"},
    "status-error": {"status": "error"},
    "status-ok": {"status": "ok"},
    "tenant": {"filter_tenant": "default"},
    "tenant-empty": {"filter_tenant": ""},
    "sampled": {"sampled": True},
    "not-sampled": {"sampled": False},
    "limit": {"limit": 3},
    "limit-op": {"filter_op": "fit", "limit": 1},
    "bad-op": {"filter_op": 3},
    "bad-status": {"status": "maybe"},
    "bad-tenant": {"filter_tenant": 7},
    "bad-sampled": {"sampled": "yes"},
    "bad-limit": {"limit": 0},
    "bad-limit-type": {"limit": True},
}


@pytest.mark.parametrize("name", sorted(DUMP_QUERIES))
def test_dump_filters_match_jax(name, served_pair):
    from kubernetesclustercapacity_tpu_torch.service import protocol

    replies = []
    for side in ("jax", "torch"):
        with socket.create_connection(served_pair["servers"][side].address,
                                      timeout=TIMEOUT_S) as sock:
            protocol.send_msg(sock, {"op": "dump", **DUMP_QUERIES[name]})
            replies.append(protocol.recv_msg(sock))
    assert _dump_norm(replies[1]) == _dump_norm(replies[0])
    if name == "all":
        ops = [r["op"] for r in replies[1]["result"]["records"]]
        assert ops[:len(REQUESTS)] == [
            m["op"] if m["op"] != "frobnicate" else "unknown"
            for m in REQUESTS]


@pytest.mark.parametrize("render", ["table", "json"])
def test_dump_renderers_match_jax(render, served_pair):
    wire = served_pair["replies"]["torch"][REQUESTS.index(
        {"op": "dump", "limit": 2})]["result"]
    assert (getattr(t_report, f"dump_{render}_report")(wire)
            == getattr(j_report, f"dump_{render}_report")(wire))


def test_request_log_matches_jax(served_pair):
    lines = copy.deepcopy(served_pair["request_log"])
    for side in lines:
        for rec in lines[side]:
            assert rec.pop("span_id")
            rec.pop("ts")
            rec.pop("latency_ms")
    assert lines["torch"] == lines["jax"]
    assert [r["op"] for r in lines["torch"]] == [
        m["op"] if m["op"] != "frobnicate" else "unknown"
        for m in REQUESTS]
    assert served_pair["servers"]["torch"].tracing_stats()[
        "request_log"] is True


def test_request_log_joins_the_trace_log(tmp_path):
    req_path = str(tmp_path / "requests.jsonl")
    trace_path = str(tmp_path / "trace.jsonl")
    server = TorchServer(t_snapshot.synthetic_snapshot(8, seed=1),
                         device="cpu", request_log=req_path,
                         trace_log=trace_path)
    server.start()
    try:
        with TorchClient(*server.address, trace=True) as c:
            c.ping()
            c.sweep(random={"n": 2, "seed": 0})
            server.replace_snapshot(t_snapshot.synthetic_snapshot(8, seed=2))
            c.sweep(random={"n": 2, "seed": 0})
            with pytest.raises(RuntimeError):
                c.call("fit", cpuRequests="0")
    finally:
        server.shutdown()
    recs = [json.loads(x) for x in open(req_path, encoding="utf-8")]
    assert [r["op"] for r in recs] == ["ping", "sweep", "sweep", "fit"]
    assert [r["generation"] for r in recs[:3]] == [1, 1, 2]
    assert recs[3]["status"] == "error" and recs[3]["error"]
    spans = {s["span_id"]: s for s in (
        json.loads(x) for x in open(trace_path, encoding="utf-8"))}
    for r in recs:
        assert len(r["trace_id"]) == 32
        assert spans[r["span_id"]]["op"] == r["op"]
        assert spans[r["span_id"]]["trace_id"] == r["trace_id"]


def test_request_log_rotates(tmp_path):
    from kubernetesclustercapacity_tpu_torch.telemetry.tracing import TraceLog

    req_path = str(tmp_path / "requests.jsonl")
    server = TorchServer(t_snapshot.synthetic_snapshot(4, seed=1),
                         device="cpu",
                         request_log=TraceLog(req_path, max_bytes=600))
    server.start()
    try:
        with TorchClient(*server.address) as c:
            for _ in range(24):
                c.ping()
    finally:
        server.shutdown()
    assert os.path.exists(req_path + ".1")
    assert not os.path.exists(req_path + ".2")
    assert os.path.getsize(req_path) <= 600


def test_process_gauges_match_jax():
    fams = []
    for module, reg in ((j_process, JaxRegistry()),
                        (t_process, TorchRegistry())):
        assert module.register_process_metrics(reg) is reg
        module.register_process_metrics(reg)  # idempotent
        snap = reg.snapshot()
        fams.append({name: (f["type"], sorted(f["values"]))
                     for name, f in snap.items()})
        assert snap["kccap_build_info"]["values"] == {'version="0.4.0"': 1}
        assert snap["kccap_process_threads"]["values"][""] >= 1
        assert snap["kccap_process_rss_bytes"]["values"][""] != 0
    assert fams[1] == fams[0]
    text = t_expo.render_text(reg)
    assert "# HELP kccap_process_open_fds" in text


def test_process_gauges_silent_when_disabled(monkeypatch):
    monkeypatch.setenv("KCCAP_TELEMETRY", "0")
    reg = TorchRegistry()
    t_process.register_process_metrics(reg)
    assert reg.snapshot() == {}


@pytest.mark.parametrize("shape", ["grouped", "ungrouped", "off"])
def test_group_gauges_match_jax(shape, monkeypatch):
    from kubernetesclustercapacity_tpu.telemetry.metrics import (
        REGISTRY as J_REGISTRY,
    )
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
        REGISTRY as T_REGISTRY,
    )

    if shape == "off":
        monkeypatch.setenv("KCCAP_GROUPING", "0")
    kw = {"shapes": 12} if shape == "grouped" else {}
    values = []
    for module, reg in ((j_snapshot, J_REGISTRY), (t_snapshot, T_REGISTRY)):
        module.publish_group_metrics(module.synthetic_snapshot(
            4096, seed=9, **kw))
        snap = reg.snapshot()
        values.append(tuple(
            snap[k]["values"][""] if k in snap else None
            for k in ("kccap_group_count", "kccap_compression_ratio")))
        if shape != "off":
            module.publish_group_metrics(module.synthetic_snapshot(
                64, seed=1))  # leave the ungrouped sentinel behind
    if shape == "off":
        return  # the gauges keep whatever an earlier publish set
    assert values[1] == values[0]
    if shape == "grouped":
        assert values[1][0] == 12
    else:
        assert values[1] == (0, 1.0)


def test_info_hot_path_on_a_grouped_fleet_matches_jax():
    """``info {hot_path: true}`` names the group count and compression
    ratio of a grouped fleet as the JAX server does (the port raised
    AttributeError here until its ``GroupedSnapshot`` gained
    ``compression_ratio``: fault C2)."""
    sections = []
    for server in (JaxServer(j_snapshot.synthetic_snapshot(4096, seed=9,
                                                           shapes=7)),
                   TorchServer(t_snapshot.synthetic_snapshot(
                       4096, seed=9, shapes=7), device="cpu")):
        try:
            sections.append(server.dispatch(
                {"op": "info", "hot_path": True})["hot_path"]["grouping"])
        finally:
            server.shutdown()
    assert sections[1] == sections[0]
    assert sections[1]["engaged"] is True
    assert sections[1]["compression_ratio"] == round(4096 / 7, 4)


def test_server_publishes_group_gauges_on_every_swap():
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
        REGISTRY as T_REGISTRY,
    )

    server = TorchServer(t_snapshot.synthetic_snapshot(4096, seed=9,
                                                       shapes=7),
                         device="cpu")
    try:
        assert T_REGISTRY.snapshot()["kccap_group_count"]["values"][""] == 7
        server.replace_snapshot(t_snapshot.synthetic_snapshot(4096, seed=9,
                                                              shapes=5))
        assert T_REGISTRY.snapshot()["kccap_group_count"]["values"][""] == 5
    finally:
        server.shutdown()


# -- healthz_probes -----------------------------------------------------------

class _StubTimeline:
    def __init__(self, **breached):
        self.breached = breached

    def stats(self):
        return {"breached": sorted(n for v in self.breached.values()
                                   for n in v)}

    def car_breached(self):
        return self.breached.get("car", [])

    def gang_breached(self):
        return self.breached.get("gang", [])

    def forecast_breached(self):
        return self.breached.get("forecast", [])


class _StubFollower:
    def __init__(self, fatal=None):
        self.fatal = fatal

    def last_relist_age_s(self):
        return 1.5


PROBE_CASES = {
    "plain": ({}, 200),
    "follower-ok": ({"follower": _StubFollower()}, 200),
    "follower-dead": ({"follower": _StubFollower("boom")}, 503),
    "plain-watch-breach": ({"timeline": _StubTimeline(plain=["web"])}, 200),
    "car-breach": ({"timeline": _StubTimeline(car=["p95"])}, 503),
    "gang-breach": ({"timeline": _StubTimeline(gang=["train"])}, 503),
    "forecast-breach": ({"timeline": _StubTimeline(forecast=["fc"])}, 503),
    "coalescer": ({"coalescers": [types.SimpleNamespace(
        stats=lambda: {"flushes": 3})]}, 200),
}


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_healthz_probes(case):
    kw, want = PROBE_CASES[case]
    server = TorchServer(t_snapshot.synthetic_snapshot(8, seed=1),
                         device="cpu")
    healthy, status = healthz_probes(server, **kw)
    metrics = t_expo.start_metrics_server(TorchRegistry(), healthy=healthy,
                                          status=status)
    try:
        code, _, body = _get(metrics.url + "/healthz")
    finally:
        metrics.shutdown()
        server.shutdown()
    doc = json.loads(body)
    assert code == want
    assert doc["ok"] is (want == 200)
    assert doc["snapshot_generation"] == 1
    assert "device_memory" in doc
    if "follower" in kw:
        assert doc["follower"] == {"last_relist_age_s": 1.5,
                                   "fatal": kw["follower"].fatal}
    if "coalescers" in kw:
        assert doc["coalescer"] == {"flushes": 3}


def test_healthz_probes_drain_and_ledger_budget():
    server = TorchServer(t_snapshot.synthetic_snapshot(8, seed=1),
                         device="cpu")
    healthy, status = healthz_probes(server)
    try:
        assert healthy() is True
        memledger.LEDGER.set_budget(1)
        booked = (np.zeros(64, dtype=np.int64),)
        memledger.LEDGER.register(booked, "test")
        try:
            assert healthy() is False
            assert status()["device_memory"]["budget_breached"] is True
        finally:
            memledger.LEDGER.retire(booked)
            memledger.LEDGER.set_budget(None)
        assert healthy() is True
        server.begin_drain(timeout_s=1.0)
        assert healthy() is False and status()["draining"] is True
    finally:
        server.shutdown()


# -- both servers' main with -metrics-port ------------------------------------

def _free_port():
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def _wait_ping(port):
    from kubernetesclustercapacity_tpu_torch.service import protocol

    deadline = time.time() + TIMEOUT_S
    while True:
        try:
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=5) as sock:
                protocol.send_msg(sock, {"op": "ping"})
                return protocol.recv_msg(sock)
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.05)


def _run_main(main, argv, tmp_path, name, extra=()):
    port, mport = _free_port(), _free_port()
    watch = tmp_path / "watch.json"
    watch.write_text(json.dumps({"watches": [
        {"name": "web", "pod": {"cpuRequests": "200m",
                                "memRequests": "250mb"},
         "min_replicas": 1},
        {"name": "p95", "pod": {"cpuRequests": "200m",
                                "memRequests": "250mb", "replicas": "5"},
         "quantile": 0.95, "samples": 32, "seed": 1,
         "usage": {"cpu": {"dist": "normal", "mean": "200m",
                           "std": "50m"}}}]}))
    slo = tmp_path / "slo.json"
    slo.write_text(json.dumps({"slos": [
        {"name": "availability", "availability": "99%"}]}))
    result = {}
    args = [*argv, "-snapshot", KIND, "-port", str(port), "-metrics-port",
            str(mport), "-watch", str(watch), "-slo", str(slo),
            "-timeline-log", str(tmp_path / f"{name}-timeline.jsonl"),
            "-log-json", str(tmp_path / f"{name}-requests.jsonl"),
            "-trace-log", str(tmp_path / f"{name}-trace.jsonl"),
            "-trace-sample", "errors", "-device-budget-bytes", str(1 << 40),
            "-batch-window-ms", "0", *extra]
    thread = threading.Thread(target=lambda: result.update(rc=main(args)))
    thread.start()
    try:
        _wait_ping(port)
        out = {"healthz": _get(f"http://127.0.0.1:{mport}/healthz"),
               "metrics": _get(f"http://127.0.0.1:{mport}/metrics")}
        from kubernetesclustercapacity_tpu_torch.service import protocol

        with socket.create_connection(("127.0.0.1", port),
                                      timeout=TIMEOUT_S) as sock:
            for msg in ({"op": "timeline"}, {"op": "slo"},
                        {"op": "drain_server"}):
                protocol.send_msg(sock, msg)
                out[msg["op"]] = protocol.recv_msg(sock)
    finally:
        thread.join(timeout=TIMEOUT_S)
    assert not thread.is_alive()
    out["rc"] = result.get("rc")
    return out


def test_server_main_metrics_port_matches_jax(tmp_path, monkeypatch):
    from kubernetesclustercapacity_tpu.service import server as j_server
    from kubernetesclustercapacity_tpu_torch.service import server as t_server

    monkeypatch.setenv("KCCAP_PROFILER", "0")
    j = _run_main(j_server.main, [], tmp_path, "jax")
    t = _run_main(t_server.main, ["-device", "cpu"], tmp_path, "torch")
    assert j["rc"] == t["rc"] == 0
    assert t["healthz"][0] == j["healthz"][0] == 200
    j_h, t_h = json.loads(j["healthz"][2]), json.loads(t["healthz"][2])
    assert set(t_h) == set(j_h) - {"profiler"}
    for doc in (j_h, t_h):
        doc["timeline"].pop("last_eval_ms")
    assert t_h["timeline"] == j_h["timeline"]
    assert t_h["slo"]["slos"] == j_h["slo"]["slos"] == ["availability"]
    j_m = parse_scrape(j["metrics"][2].decode())
    t_m = parse_scrape(t["metrics"][2].decode())
    assert set(t_m) <= set(j_m), sorted(set(t_m) - set(j_m))
    for family in ("kccap_watch_replicas", "kccap_car_replicas",
                   "kccap_slo_alert_state", "kccap_build_info",
                   "kccap_process_rss_bytes", "kccap_generation"):
        assert family in t_m, family
        assert t_m[family][0] == j_m[family][0]
    for key in ("kccap_watch_replicas", "kccap_car_replicas",
                "kccap_generation"):
        assert t_m[key][1] == j_m[key][1]
    tl_j, tl_t = j["timeline"]["result"], t["timeline"]["result"]
    for doc in (tl_j, tl_t):
        for rec in doc["records"]:
            rec.pop("eval_ms")
            rec.pop("ts")
    assert tl_t == tl_j
    assert t["slo"]["result"]["specs"] == j["slo"]["result"]["specs"]
    for name in ("timeline", "requests"):
        assert os.path.getsize(tmp_path / f"torch-{name}.jsonl") > 0


def test_server_main_bad_trace_sample_like_jax(capsys):
    from kubernetesclustercapacity_tpu.service import server as j_server
    from kubernetesclustercapacity_tpu_torch.service import server as t_server

    argv = ["-snapshot", KIND, "-trace-sample", "sometimes", "-port", "0"]
    assert j_server.main(argv) == 1
    j_err = capsys.readouterr().err
    assert t_server.main(argv + ["-device", "cpu"]) == 1
    assert capsys.readouterr().err == j_err


def test_server_main_metrics_port_in_use_like_jax(capsys):
    from kubernetesclustercapacity_tpu.service import server as j_server
    from kubernetesclustercapacity_tpu_torch.service import server as t_server

    with socket.socket() as held:
        held.bind(("127.0.0.1", 0))
        held.listen(1)
        port = held.getsockname()[1]
        argv = ["-snapshot", KIND, "-port", "0", "-metrics-port", str(port)]
        errs = []
        for main, extra in ((j_server.main, []),
                            (t_server.main, ["-device", "cpu"])):
            assert main(argv + extra) == 1
            errs.append(capsys.readouterr().err.splitlines()[-1])
    assert errs[1] == errs[0]
    assert errs[0].startswith("ERROR : cannot bind metrics port")


# -- the CLIs -----------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["-output", "json"],
                                   ["-dump-limit", "2"],
                                   ["-dump-tenant", "default"]])
def test_cli_dump_matches_jax(extra, tmp_path, capsys):
    """-dump renders both servers' flight records the same way (the
    records differ only in their volatile columns, which the table shows:
    latencies and phases are masked)."""
    outs = []
    with _serve_pair(tmp_path) as pair:
        for side in ("jax", "torch"):
            host, port = pair["servers"][side].address
            for main in (j_cli.main, t_cli.main):
                rc = main(["-dump", f"{host}:{port}", *extra])
                out = capsys.readouterr().out
                if "-output" in extra:
                    doc = _dump_norm({"result": json.loads(out)})["result"]
                    out = json.dumps(doc)
                else:
                    out = re.sub(r"\s+[0-9.]+ms", " Nms", out)
                    out = "\n".join(x for x in out.splitlines()
                                    if "phases:" not in x)
                outs.append((rc, out))
    # Each dump lands in the ring before the next one reads it, so a
    # server's two dumps differ by one record; the CLIs agree per read.
    assert outs[0][0] == 0
    assert outs[0] == outs[2] and outs[1] == outs[3]


def test_cli_dump_bad_address_like_jax(capsys):
    outs = []
    for main in (j_cli.main, t_cli.main):
        for addr in ("nonsense", "127.0.0.1:1"):
            rc = main(["-dump", addr])
            captured = capsys.readouterr()
            outs.append((rc, captured.out, captured.err))
    assert outs[:2] == outs[2:]
    assert all(o[0] == 1 and o[2].startswith("ERROR : ") for o in outs)


@pytest.mark.parametrize("argv,mode", [
    (["-cpuRequests=200m", "-memRequests=250mb", "-replicas=10"], "fit"),
    (["-grid", "8", "-output", "json"], "grid"),
    (["-explain", "-output", "json"], "explain"),
    (["-drain", "kind-worker", "-semantics", "strict"], "drain"),
    (["-memRequests=lots"], "fit"),
])
def test_cli_trace_log_span_matches_jax(argv, mode, tmp_path, capsys):
    spans, outs = [], []
    for name, main, extra in (("jax", j_cli.main, []),
                              ("torch", t_cli.main, ["-device", "cpu"])):
        path = tmp_path / f"{name}.jsonl"
        rc = main(["-snapshot", KIND, *argv, "-trace-log", str(path),
                   "-trace-log-max-bytes", "100000", *extra])
        outs.append((rc, capsys.readouterr().out))
        lines = [json.loads(x) for x in path.read_text().splitlines()] \
            if path.exists() else []
        spans.append([{k: v for k, v in s.items()
                       if k in ("op", "status", "exit_code")}
                      for s in lines])
    assert spans[1] == spans[0]
    assert outs[1][0] == outs[0][0]
    if spans[0]:
        assert spans[0][0]["op"] == f"kccap:{mode}"


def test_cli_metrics_port_matches_jax(capsys):
    errs = []
    for main, extra in ((j_cli.main, []), (t_cli.main, ["-device", "cpu"])):
        port = _free_port()
        rc = main(["-snapshot", KIND, "-grid", "4", "-output", "json",
                   "-metrics-port", str(port), *extra])
        captured = capsys.readouterr()
        assert rc == 0
        errs.append(captured.err.replace(str(port), "PORT"))
    assert errs[1] == errs[0]
    assert errs[0].startswith("metrics on http://127.0.0.1:PORT/metrics")


def test_cli_metrics_port_in_use_like_jax(capsys):
    with socket.socket() as held:
        held.bind(("127.0.0.1", 0))
        held.listen(1)
        port = held.getsockname()[1]
        outs = []
        for main, extra in ((j_cli.main, []),
                            (t_cli.main, ["-device", "cpu"])):
            rc = main(["-snapshot", KIND, "-grid", "4",
                       "-metrics-port", str(port), *extra])
            captured = capsys.readouterr()
            outs.append((rc, captured.err.splitlines()[-1]))
    assert outs[1] == outs[0]
    assert outs[0][0] == 1
