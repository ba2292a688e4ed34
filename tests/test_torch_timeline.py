"""The port's capacity timeline against the JAX package's, both on the CPU.

* The watchlist grammar: every document the JAX tests accept or reject
  (``tests/test_timeline.py``), plus the gang and forecast rules, parses
  to the same ``to_wire`` or fails with the same ``WatchError`` message.
* A seeded ``update`` stream over a 240-node strict fleet with zone/rack
  labels, served by the JAX server and the port's server side by side,
  each with a ``CapacityTimeline`` of eight watches: plain reference and
  strict, two plain watches whose ``min_replicas`` the stream breaches and
  recovers, two capacity-at-risk watches (cpu and memory), a forecast
  watch and a rack gang watch.  Generation by generation the ``timeline``
  op's records, deltas and alerts, the watch-status forms of ``car``,
  ``forecast`` and ``gang``, the timeline's gauges and its JSONL log are
  equal.  Both ``history`` modules read a driven clock, so the forecast's
  trend fit sees the same record timestamps on both sides.
* The JAX core cases (ring depth, cold-fit parity in both modes,
  attribution, gauges, silence under ``KCCAP_TELEMETRY=0``, the log), the
  renderers and the CLI's ``-timeline``.

Tolerance: integers and every float are equal (the same arithmetic on the
same inputs); ``eval_ms`` (a wall time) is excluded, and so are histogram
sums in the gauges.
"""

import copy
import dataclasses
import json
import threading
import types

import numpy as np
import pytest

from kubernetesclustercapacity_tpu import cli as j_cli
from kubernetesclustercapacity_tpu import report as j_report
from kubernetesclustercapacity_tpu.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu.service.client import (
    CapacityClient as JaxClient,
)
from kubernetesclustercapacity_tpu.service.server import (
    CapacityServer as JaxServer,
)
from kubernetesclustercapacity_tpu.snapshot import (
    snapshot_from_fixture as j_from_fixture,
)
from kubernetesclustercapacity_tpu.telemetry.metrics import (
    MetricsRegistry as JaxRegistry,
)
from kubernetesclustercapacity_tpu.timeline import history as j_history
from kubernetesclustercapacity_tpu.timeline import watchlist as j_watchlist
from kubernetesclustercapacity_tpu_torch import cli as t_cli
from kubernetesclustercapacity_tpu_torch import report as t_report
from kubernetesclustercapacity_tpu_torch.scenario import scenario_from_flags
from kubernetesclustercapacity_tpu_torch.service.client import (
    CapacityClient as TorchClient,
)
from kubernetesclustercapacity_tpu_torch.service.server import (
    CapacityServer as TorchServer,
)
from kubernetesclustercapacity_tpu_torch.snapshot import (
    snapshot_from_fixture as t_from_fixture,
)
from kubernetesclustercapacity_tpu_torch.snapshot import synthetic_snapshot
from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
    MetricsRegistry as TorchRegistry,
)
from kubernetesclustercapacity_tpu_torch.timeline import history as t_history
from kubernetesclustercapacity_tpu_torch.timeline import (
    watchlist as t_watchlist,
)
from kubernetesclustercapacity_tpu_torch.utils.quantity import int64_bits

TIMEOUT_S = 120.0

POD = {"cpuRequests": "500m", "memRequests": "1gb", "replicas": "40"}
CPU_USAGE = {"cpu": {"dist": "normal", "mean": "500m", "std": "200m"}}
MEM_USAGE = {"memory": {"dist": "lognormal", "mean": "1gb", "sigma": 0.5}}


# -- the watchlist grammar ----------------------------------------------------

_W = {"name": "w", "pod": {"cpuRequests": "1"}}
_NORMAL = {"cpu": {"dist": "normal", "mean": "1", "std": "1"}}
REJECTED = {
    # JAX tests/test_timeline.py: the quantile grammar.
    "q-zero": {"watches": [dict(_W, quantile=0.0)]},
    "q-one": {"watches": [dict(_W, quantile=1.0)]},
    "q-negative": {"watches": [dict(_W, quantile=-0.5)]},
    "q-above": {"watches": [dict(_W, quantile=1.5)]},
    "q-string": {"watches": [dict(_W, quantile="p95")]},
    "q-bool": {"watches": [dict(_W, quantile=True)]},
    "q-no-usage": {"watches": [dict(_W, quantile=0.95)]},
    "q-point-usage": {"watches": [dict(_W, quantile=0.95, usage={
        "cpu": {"dist": "point", "value": "1"}})]},
    "q-zero-std": {"watches": [dict(_W, quantile=0.95, usage={
        "cpu": {"dist": "normal", "mean": "1", "std": 0}})]},
    "usage-no-q": {"watches": [dict(_W, usage=_NORMAL)]},
    "samples-no-q": {"watches": [dict(_W, samples=64)]},
    "seed-no-q": {"watches": [dict(_W, seed=3)]},
    "usage-gpu": {"watches": [dict(_W, quantile=0.9, usage={"gpu": 1})]},
    "usage-gauss": {"watches": [dict(_W, quantile=0.9, usage={
        "cpu": {"dist": "gauss"}})]},
    "samples-one": {"watches": [dict(_W, quantile=0.9, usage=_NORMAL,
                                     samples=1)]},
    "seed-string": {"watches": [dict(_W, quantile=0.9, usage=_NORMAL,
                                     seed="x")]},
    # JAX tests/test_timeline.py: malformed documents.
    "empty": {},
    "no-watches": {"watches": []},
    "no-name": {"watches": [{"pod": {}}]},
    "pod-typo": {"watches": [{"name": "a", "pod": {"cpuLimit": "1"}}]},
    "pod-zero": {"watches": [{"name": "a", "pod": {"cpuRequests": "0"}}]},
    "min-negative": {"watches": [{"name": "a", "min_replicas": -1}]},
    "min-bool": {"watches": [{"name": "a", "min_replicas": True}]},
    "semantics": {"watches": [{"name": "a", "semantics": "fast"}]},
    "duplicate": {"watches": [{"name": "a"}, {"name": "a"}]},
    "unknown-field": {"watches": [{"name": "a", "alert": 1}]},
    "top-level": {"watchlist": []},
    # The gang and forecast rules.
    "gang-and-q": {"watches": [dict(_W, quantile=0.9, usage=_NORMAL,
                                    gang={"ranks": 4})]},
    "gang-and-horizon": {"watches": [dict(_W, gang={"ranks": 4},
                                          horizon={})]},
    "gang-bad": {"watches": [dict(_W, gang={"ranks": 0})]},
    "gang-level": {"watches": [dict(_W, gang={"ranks": 4,
                                              "colocate": "row"})]},
    "horizon-no-q": {"watches": [dict(_W, horizon={"steps": 4})]},
    "horizon-list": {"watches": [dict(_W, quantile=0.9, horizon=[1])]},
    "horizon-field": {"watches": [dict(_W, quantile=0.9,
                                       horizon={"step": 4})]},
    "horizon-steps": {"watches": [dict(_W, quantile=0.9,
                                       horizon={"steps": 0})]},
    "horizon-steps-float": {"watches": [dict(_W, quantile=0.9,
                                             horizon={"steps": 2.5})]},
    "horizon-step-s": {"watches": [dict(_W, quantile=0.9,
                                        horizon={"step_s": 0})]},
    "horizon-step-s-bool": {"watches": [dict(_W, quantile=0.9,
                                             horizon={"step_s": True})]},
    "not-a-mapping": {"watches": ["w"]},
    "pod-not-a-mapping": {"watches": [{"name": "a", "pod": [1]}]},
}

ACCEPTED = {
    "plain": {"watches": [{"name": "web", "pod": dict(POD),
                           "min_replicas": 3},
                          {"name": "batch", "pod": {"cpuRequests": "2"},
                           "semantics": "strict"}]},
    "bare-list": [{"name": "w", "pod": {"cpuRequests": "1"}}],
    "car": {"watches": [{"name": "p95", "pod": dict(POD), "quantile": 0.95,
                         "usage": CPU_USAGE, "samples": 128, "seed": 7,
                         "min_replicas": 30}]},
    "car-memory": {"watches": [{"name": "p90", "pod": dict(POD),
                                "quantile": 0.9, "usage": MEM_USAGE}]},
    "forecast": {"watches": [{"name": "fc", "pod": dict(POD),
                              "quantile": 0.95, "usage": CPU_USAGE,
                              "horizon": {"steps": 24, "step_s": 600}}]},
    "forecast-point": {"watches": [{"name": "fc", "pod": dict(POD),
                                    "quantile": 0.5, "horizon": None}]},
    "gang": {"watches": [{"name": "train", "pod": {"cpuRequests": "4",
                                                   "memRequests": "8gb"},
                          "gang": {"ranks": 64, "count": 2,
                                   "colocate": "rack"},
                          "min_replicas": 1}]},
    "gang-spread": {"watches": [{"name": "g", "pod": {"cpuRequests": "1"},
                                 "gang": {"ranks": 16, "colocate": "zone",
                                          "spread_level": "rack",
                                          "max_ranks_per_domain": 4}}]},
}


def _parse_outcome(module, doc):
    try:
        return "ok", [w.to_wire() for w in module.parse_watchlist(doc)]
    except module.WatchError as e:
        return "WatchError", str(e)


@pytest.mark.parametrize("name", sorted(REJECTED))
def test_watchlist_rejections_match_jax(name):
    doc = copy.deepcopy(REJECTED[name])
    want = _parse_outcome(j_watchlist, copy.deepcopy(doc))
    got = _parse_outcome(t_watchlist, doc)
    assert want[0] == "WatchError"
    assert got == want


@pytest.mark.parametrize("name", sorted(ACCEPTED))
def test_watchlist_accepted_matches_jax(name):
    want = _parse_outcome(j_watchlist, copy.deepcopy(ACCEPTED[name]))
    got = _parse_outcome(t_watchlist, copy.deepcopy(ACCEPTED[name]))
    assert want[0] == "ok"
    assert got == want


@pytest.mark.parametrize("suffix", [".yaml", ".json"])
def test_load_watchlist_files_match_jax(suffix, tmp_path):
    path = tmp_path / f"watch{suffix}"
    if suffix == ".json":
        path.write_text(json.dumps(ACCEPTED["car"]))
    else:
        path.write_text(
            "watches:\n"
            "  - name: web\n"
            "    pod: {cpuRequests: 500m, memRequests: 1gb, replicas: 7}\n"
            "    min_replicas: 3\n"
            "  - name: strict-batch\n"
            "    pod: {cpuRequests: '2', memRequests: 4gb}\n"
            "    semantics: strict\n"
        )
    want = [w.to_wire() for w in j_watchlist.load_watchlist(str(path))]
    got = [w.to_wire() for w in t_watchlist.load_watchlist(str(path))]
    assert got == want and got


def test_load_watchlist_bad_yaml_like_jax(tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text("watches: [unclosed")
    errors = []
    for module in (j_watchlist, t_watchlist):
        with pytest.raises(module.WatchError) as info:
            module.load_watchlist(str(path))
        errors.append(str(info.value))
    assert errors[0] == errors[1]


# -- the update stream on both servers ----------------------------------------

N_NODES = 240
TOPOLOGY = (2, 4)
T0 = 1_700_000_000.0
STEP_S = 900.0


def _drive_clocks(monkeypatch):
    """Both ``history`` modules read their own driven clock: the n-th
    ``time.time()`` of each is ``T0 + n * STEP_S``."""
    import time as _time

    for module in (j_history, t_history):
        counter = iter(range(1, 10**6))
        monkeypatch.setattr(module, "time", types.SimpleNamespace(
            time=lambda c=counter: T0 + next(c) * STEP_S,
            perf_counter=_time.perf_counter,
        ))


def _fleet():
    return synthetic_fixture(N_NODES, seed=71, topology=TOPOLOGY,
                             taint_frac=0.15)


def _node_event(node, kind="MODIFIED"):
    return {"type": kind, "kind": "Node", "object": node}


def _stream(fixture):
    """Seven seeded batches: the fleet starved of cpu (the threshold
    watches breach), restored (they recover), then four of churn — pods
    added (more than are deleted or finish, so the forecast's trend
    rises), deleted and finished, nodes modified, added and removed."""
    rng = np.random.default_rng(72)
    nodes = fixture["nodes"]
    starved = []
    for node in nodes[::2]:
        n = copy.deepcopy(node)
        n["allocatable"]["cpu"] = "1"
        starved.append(_node_event(n))
    batches = [starved,
               [_node_event(copy.deepcopy(n)) for n in nodes[::2]]]
    running = [p for p in fixture["pods"]
               if p["phase"] == "Running" and p.get("nodeName")]
    order = rng.permutation(len(running))
    taken = 0
    for b in range(5):
        events = []
        for i in range(24):
            cpu = f"{int(rng.integers(100, 1500))}m"
            mem = f"{int(rng.integers(128, 2048))}Mi"
            node = nodes[int(rng.integers(len(nodes)))]["name"]
            events.append({"type": "ADDED", "kind": "Pod", "object": {
                "name": f"churn-{b}-{i}", "namespace": "churn",
                "nodeName": node, "phase": "Running",
                "containers": [{"resources": {
                    "requests": {"cpu": cpu, "memory": mem},
                    "limits": {"cpu": cpu, "memory": mem}}}]}})
        for _ in range(4):
            pod = running[int(order[taken])]
            taken += 1
            events.append({"type": "DELETED", "kind": "Pod",
                           "object": pod})
        for _ in range(3):
            pod = running[int(order[taken])]
            taken += 1
            events.append({"type": "MODIFIED", "kind": "Pod",
                           "object": dict(pod, phase="Succeeded")})
        if b < 4:
            node = copy.deepcopy(nodes[int(rng.integers(len(nodes)))])
            node["allocatable"]["memory"] = "16Gi"
            events.append(_node_event(node))
            joiner = copy.deepcopy(nodes[int(rng.integers(len(nodes)))])
            joiner["name"] = f"joiner-{b}"
            joiner["labels"] = dict(joiner["labels"], **{
                "kubernetes.io/hostname": joiner["name"]})
            events.append(_node_event(joiner, "ADDED"))
        if b == 0:
            events.append(_node_event(nodes[1], "DELETED"))
        events = [events[int(i)] for i in rng.permutation(len(events))]
        batches.append(events)
    return batches


def _watchlist(fixture):
    """The eight watches, their thresholds at generation 1's totals (so
    the starved generation breaches them and the restored one
    recovers)."""
    snap = t_from_fixture(fixture, semantics="strict")
    base = t_watchlist.parse_watchlist(_watch_doc({}))
    probe = t_history.CapacityTimeline(base, device="cpu")
    rec = probe.observe(snap, 1, ts=T0)
    return _watch_doc({k: rec.watches[k].total for k in
                       ("web-min", "web-min-strict", "car-cpu", "gang")})


def _watch_doc(thresholds):
    def t(name):
        return ({"min_replicas": thresholds[name]}
                if name in thresholds else {})

    spec = {"cpuRequests": "200m", "memRequests": "250mb",
            "replicas": "5000"}
    return {"watches": [
        {"name": "spec-reference", "pod": spec, "semantics": "reference"},
        {"name": "spec-strict", "pod": spec, "semantics": "strict"},
        {"name": "web-min", "pod": dict(POD), **t("web-min")},
        {"name": "web-min-strict", "pod": {"cpuRequests": "1",
                                           "memRequests": "2gb"},
         "semantics": "strict", **t("web-min-strict")},
        {"name": "car-cpu", "pod": dict(POD), "quantile": 0.95,
         "usage": CPU_USAGE, "samples": 64, "seed": 11, **t("car-cpu")},
        {"name": "car-mem", "pod": dict(POD), "quantile": 0.9,
         "usage": MEM_USAGE, "samples": 48, "seed": 12},
        {"name": "forecast", "pod": dict(POD), "quantile": 0.95,
         "usage": CPU_USAGE, "samples": 32, "seed": 13,
         "horizon": {"steps": 8, "step_s": 3600}, "min_replicas": 1},
        {"name": "gang", "pod": {"cpuRequests": "2", "memRequests": "4gb"},
         "gang": {"ranks": 16, "colocate": "rack"}, **t("gang")},
    ]}


def _strip(value):
    """A reply with the wall times (``eval_ms``) removed."""
    value = copy.deepcopy(value)
    result = value.get("result", value)
    for rec in result.get("records", []):
        rec.pop("eval_ms", None)
    return value


def _timeline_families(registry) -> dict:
    out = {}
    for name, fam in registry.snapshot().items():
        if not name.startswith(("kccap_watch_", "kccap_car_",
                                "kccap_forecast_", "kccap_gang_",
                                "kccap_generation", "kccap_timeline_")):
            continue
        values = {}
        for labels, v in fam["values"].items():
            values[labels] = v["count"] if isinstance(v, dict) else v
        out[name] = (fam["type"], values)
    return out


@pytest.fixture(scope="module")
def stream_run(tmp_path_factory):
    """Both servers take the same update stream; after every batch the
    ``timeline`` op and the status forms are read from each."""
    mp = pytest.MonkeyPatch()
    _drive_clocks(mp)
    d = tmp_path_factory.mktemp("timeline")
    fixture = _fleet()
    doc = _watchlist(fixture)
    batches = _stream(fixture)
    regs = {"jax": JaxRegistry(), "torch": TorchRegistry()}
    logs = {k: str(d / f"{k}.jsonl") for k in regs}
    timelines = {
        "jax": j_history.CapacityTimeline(
            j_watchlist.parse_watchlist(doc), depth=16,
            registry=regs["jax"], log=logs["jax"]),
        "torch": t_history.CapacityTimeline(
            t_watchlist.parse_watchlist(doc), depth=16,
            registry=regs["torch"], log=logs["torch"], device="cpu"),
    }
    servers = {
        "jax": JaxServer(j_from_fixture(copy.deepcopy(fixture),
                                        semantics="strict"),
                         fixture=copy.deepcopy(fixture),
                         timeline=timelines["jax"], registry=regs["jax"],
                         batch_window_ms=0),
        "torch": TorchServer(t_from_fixture(copy.deepcopy(fixture),
                                            semantics="strict"),
                             fixture=copy.deepcopy(fixture),
                             timeline=timelines["torch"],
                             registry=regs["torch"], device="cpu",
                             batch_window_ms=0),
    }
    out = {"doc": doc, "batches": batches, "regs": regs, "logs": logs,
           "timelines": timelines, "servers": servers, "steps": []}
    try:
        for s in servers.values():
            s.start()
        clients = {
            "jax": JaxClient(*servers["jax"].address, timeout_s=TIMEOUT_S,
                             retry=None),
            "torch": TorchClient(*servers["torch"].address,
                                 timeout_s=TIMEOUT_S, retry=None),
        }
        for batch in [None] + batches:
            step = {}
            for side, client in clients.items():
                if batch is not None:
                    client.update(copy.deepcopy(batch))
                step[side] = {
                    "timeline": client.timeline(),
                    "car": client.car(),
                    "forecast": client.forecast(),
                    "gang": client.gang(),
                }
            out["steps"].append(step)
        out["clients"] = clients
        yield out
    finally:
        for s in servers.values():
            s.shutdown()
        for tl in timelines.values():
            tl.close()
        mp.undo()


GENERATIONS = list(range(1, 9))


@pytest.mark.parametrize("generation", GENERATIONS)
def test_each_generation_has_one_equal_record(generation, stream_run):
    step = stream_run["steps"][generation - 1]
    j = _strip(step["jax"]["timeline"])
    t = _strip(step["torch"]["timeline"])
    assert [r["generation"] for r in t["records"]] == list(
        range(1, generation + 1))
    assert t["records"] == j["records"]
    assert t == j


@pytest.mark.parametrize("generation", GENERATIONS[1:])
def test_each_delta_matches_jax(generation, stream_run):
    step = stream_run["steps"][generation - 1]
    j, t = step["jax"]["timeline"], step["torch"]["timeline"]
    assert t["deltas"][-1] == j["deltas"][-1]
    assert t["deltas"][-1]["to_generation"] == generation


@pytest.mark.parametrize("op", ["car", "forecast", "gang"])
def test_status_forms_match_jax_after_every_batch(op, stream_run):
    for step in stream_run["steps"]:
        assert step["torch"][op] == step["jax"][op]
    last = stream_run["steps"][-1]["torch"][op]
    assert last["enabled"] is True and last["watches"]


def test_the_stream_breaches_and_recovers(stream_run):
    """The comparison is not vacuous: the threshold watches breached on
    the starved generation and recovered on the restored one, the forecast
    fitted a trend, and the gang watch counts whole gangs."""
    records = stream_run["steps"][-1]["torch"]["timeline"]["records"]
    by_gen = {r["generation"]: r["watches"] for r in records}
    for name in ("web-min", "web-min-strict", "car-cpu", "gang"):
        assert not by_gen[1][name]["breached"]
        assert by_gen[2][name]["breached"], name
        assert not by_gen[3][name]["breached"]
    alerts = stream_run["steps"][-1]["torch"]["timeline"]["alerts"]
    for name in ("web-min", "car-cpu", "gang"):
        assert alerts[name]["breaches"] >= 1
        assert alerts[name]["recoveries"] >= 1
    fc = by_gen[8]["forecast"]
    assert fc["horizon_min_capacity"] is not None
    assert by_gen[8]["gang"]["gang"]["ranks"] == 16
    assert by_gen[8]["car-mem"]["quantile"] == 0.9


def test_plain_totals_equal_a_cold_fit(stream_run):
    """Each plain watch's total is the exact program's sweep of its
    generation's served snapshot and the host oracle's walk (the port's
    server, after the whole stream)."""
    from kubernetesclustercapacity_tpu_torch.masks import implicit_taint_mask
    from kubernetesclustercapacity_tpu_torch.ops.fit import sweep_snapshot
    from kubernetesclustercapacity_tpu_torch.oracle import fit_arrays_python
    from kubernetesclustercapacity_tpu_torch.scenario import ScenarioGrid

    snap = stream_run["servers"]["torch"].snapshot
    rec = stream_run["timelines"]["torch"].records()[-1]
    checked = 0
    for spec in stream_run["timelines"]["torch"].watches:
        if spec.quantile is not None or spec.gang is not None:
            continue
        mode = spec.mode or snap.semantics
        mask = implicit_taint_mask(snap) if mode == "strict" else None
        grid = ScenarioGrid.from_scenarios([spec.scenario])
        exact = sweep_snapshot(snap, grid, mode=mode, node_mask=mask,
                               device="cpu")[0]
        host = np.asarray(fit_arrays_python(
            snap.alloc_cpu_milli, snap.alloc_mem_bytes, snap.alloc_pods,
            snap.used_cpu_req_milli, snap.used_mem_req_bytes,
            snap.pods_count, int64_bits(spec.scenario.cpu_request_milli),
            spec.scenario.mem_request_bytes, mode=mode,
            healthy=snap.healthy), dtype=np.int64)
        if mask is not None:
            host = host * mask
        got = rec.watches[spec.name]
        assert got.total == int(exact[0]) == int(host.sum())
        np.testing.assert_array_equal(got.fits, host)
        checked += 1
    assert checked == 4


def test_gauges_match_jax(stream_run):
    j = _timeline_families(stream_run["regs"]["jax"])
    t = _timeline_families(stream_run["regs"]["torch"])
    assert set(j) >= {"kccap_watch_replicas", "kccap_car_replicas",
                      "kccap_forecast_capacity", "kccap_gang_capacity"}
    assert t == j


def test_timeline_log_matches_jax(stream_run):
    lines = {}
    for side, path in stream_run["logs"].items():
        stream_run["timelines"][side].close()
        with open(path) as f:
            lines[side] = [json.loads(x) for x in f]
        for line in lines[side]:
            line.pop("eval_ms", None)
    kinds = [line["kind"] for line in lines["torch"]]
    assert kinds.count("generation") == len(GENERATIONS)
    assert "alert" in kinds
    assert lines["torch"] == lines["jax"]


@pytest.mark.parametrize("query", [
    {"since_generation": 5},
    {"since_generation": 0},
    {"watch": "car-cpu"},
    {"watch": "gang", "since_generation": 6},
])
def test_filters_over_the_wire_match_jax(query, stream_run):
    c = stream_run["clients"]
    j = _strip(c["jax"].timeline(**query))
    t = _strip(c["torch"].timeline(**query))
    assert t == j


@pytest.mark.parametrize("msg", [
    {"watch": "nope"},
    {"since_generation": "x"},
    {"watch": 3},
])
def test_bad_timeline_requests_fail_like_jax(msg, stream_run):
    c = stream_run["clients"]
    errors = []
    for side in ("jax", "torch"):
        with pytest.raises(RuntimeError) as info:
            c[side].call("timeline", **msg)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("render", ["table", "json"])
def test_renderers_match_jax(render, stream_run):
    wire = stream_run["steps"][-1]["torch"]["timeline"]
    j = getattr(j_report, f"timeline_{render}_report")(wire)
    t = getattr(t_report, f"timeline_{render}_report")(wire)
    assert t == j
    if render == "table":
        assert "deltas:" in t and "alerts:" in t and "forecast" in t


def test_renderers_disabled_match_jax():
    wire = {"enabled": False}
    assert (t_report.timeline_table_report(wire)
            == j_report.timeline_table_report(wire))


@pytest.mark.parametrize("extra", [[], ["-output", "json"],
                                   ["-timeline-watch", "car-cpu"],
                                   ["-timeline-since", "6"]])
def test_cli_timeline_matches_jax(extra, stream_run, capsys):
    """-timeline HOST:PORT renders the same text from either server with
    either CLI (after the stream, a watch is breached: exit 1)."""
    outs = []
    for side in ("jax", "torch"):
        host, port = stream_run["servers"][side].address
        for main in (j_cli.main, t_cli.main):
            rc = main(["-timeline", f"{host}:{port}", *extra])
            out = capsys.readouterr().out
            if "-output" in extra:
                doc = json.loads(out)
                for rec in doc["records"]:
                    rec.pop("eval_ms")
                out = json.dumps(doc)
            else:
                out = "\n".join(
                    line for line in out.splitlines()
                    if "eval" not in line)
            outs.append((rc, out))
    assert all(o == outs[0] for o in outs)


def test_cli_timeline_bad_address_and_no_timeline(capsys):
    outs = []
    server = TorchServer(synthetic_snapshot(4, seed=1), device="cpu")
    jserver = JaxServer(j_from_fixture(synthetic_fixture(4, seed=1)))
    server.start()
    jserver.start()
    try:
        for main in (j_cli.main, t_cli.main):
            rc = main(["-timeline", "nonsense"])
            captured = capsys.readouterr()
            outs.append((rc, captured.out, captured.err))
            for s in (jserver, server):
                host, port = s.address
                rc = main(["-timeline", f"{host}:{port}"])
                outs.append((rc, capsys.readouterr().out))
    finally:
        server.shutdown()
        jserver.shutdown()
    assert outs[:3] == outs[3:]
    assert outs[0][0] == 1 and outs[0][2].startswith("ERROR : ")
    assert outs[1] == outs[2] == (1, "timeline: not enabled on this server "
                                     "(-watch/-timeline-depth)\n")


# -- the JAX core cases, on the port ------------------------------------------

def _plain_specs():
    return t_watchlist.parse_watchlist({"watches": [
        {"name": "web-tier", "pod": {"cpuRequests": "500m",
                                     "memRequests": "1gb",
                                     "replicas": "10"},
         "min_replicas": 120},
        {"name": "batch", "pod": {"cpuRequests": "2", "memRequests": "4gb"}},
    ]})


def _starve(snap):
    return dataclasses.replace(snap, alloc_cpu_milli=(
        np.asarray(snap.alloc_cpu_milli) // 50).astype(np.int64))


def test_depth_bounds_ring_and_validation():
    tl = t_history.CapacityTimeline(_plain_specs(), depth=3, device="cpu")
    for g in range(1, 6):
        tl.observe(synthetic_snapshot(8, seed=g), g)
    assert [r.generation for r in tl.records()] == [3, 4, 5]
    with pytest.raises(ValueError):
        t_history.CapacityTimeline((), depth=1, device="cpu")
    with pytest.raises(ValueError):
        t_history.CapacityTimeline(_plain_specs() * 2, depth=4, device="cpu")


@pytest.mark.parametrize("packing", ["reference", "strict"])
def test_capacities_equal_jax_cold_fits_both_modes(packing):
    from kubernetesclustercapacity_tpu.masks import implicit_taint_mask
    from kubernetesclustercapacity_tpu.ops.fit import (
        fit_per_node as j_fit_per_node,
    )

    fixture = synthetic_fixture(24, seed=31, taint_frac=0.3)
    specs = tuple(
        t_watchlist.WatchSpec(name=f"{mode}-{flags['cpuRequests']}",
                              scenario=scenario_from_flags(**flags),
                              mode=mode)
        for mode in ("reference", "strict")
        for flags in ({"cpuRequests": "250m", "memRequests": "200mb"},
                      {"cpuRequests": "1", "memRequests": "2gb"}))
    jsnap = j_from_fixture(fixture, semantics=packing)
    rec = t_history.CapacityTimeline(specs, device="cpu").observe(
        t_from_fixture(fixture, semantics=packing), 1)
    for spec in specs:
        mode = spec.mode
        mask = implicit_taint_mask(jsnap) if mode == "strict" else None
        want = np.asarray(j_fit_per_node(
            jsnap.alloc_cpu_milli, jsnap.alloc_mem_bytes, jsnap.alloc_pods,
            jsnap.used_cpu_req_milli, jsnap.used_mem_req_bytes,
            jsnap.pods_count, jsnap.healthy,
            int64_bits(spec.scenario.cpu_request_milli),
            spec.scenario.mem_request_bytes, mode=mode, node_mask=mask))
        got = rec.watches[spec.name]
        assert got.total == int(want.sum())
        np.testing.assert_array_equal(got.fits, want)


def test_attribution_names_node_like_jax():
    from kubernetesclustercapacity_tpu.snapshot import (
        synthetic_snapshot as j_synthetic,
    )

    deltas = []
    for history, watchlist, make, kw in (
        (j_history, j_watchlist, j_synthetic, {}),
        (t_history, t_watchlist, synthetic_snapshot, {"device": "cpu"}),
    ):
        specs = watchlist.parse_watchlist({"watches": [
            {"name": "web-tier", "pod": {"cpuRequests": "500m",
                                         "memRequests": "1gb"}},
            {"name": "batch", "pod": {"cpuRequests": "2"}}]})
        tl = history.CapacityTimeline(specs, depth=8, **kw)
        a = make(16, seed=3)
        keep = [i for i in range(16) if i != 5]
        b = dataclasses.replace(
            a, names=[a.names[i] for i in keep],
            **{f: np.asarray(getattr(a, f))[keep] for f in (
                "alloc_cpu_milli", "alloc_mem_bytes", "alloc_pods",
                "used_cpu_req_milli", "used_cpu_lim_milli",
                "used_mem_req_bytes", "used_mem_lim_bytes", "pods_count",
                "healthy")},
            labels=[a.labels[i] for i in keep] if a.labels else [],
            taints=[a.taints[i] for i in keep] if a.taints else [],
            node_log=[], pod_cpu_errs=[[] for _ in keep])
        tl.observe(a, 1, ts=T0)
        tl.observe(b, 2, ts=T0 + 1)
        deltas.append(tl.deltas())
        assert tl.deltas(since_generation=2) == []
        assert set(tl.deltas(watch="batch")[0]["watches"]) == {"batch"}
    assert deltas[1] == deltas[0]
    (delta,) = deltas[1]
    assert delta["nodes_removed"] == [synthetic_snapshot(16, seed=3).names[5]]


def test_metrics_gauges_and_counters_like_jax():
    from kubernetesclustercapacity_tpu.snapshot import (
        synthetic_snapshot as j_synthetic,
    )

    out = []
    for history, watchlist, make, reg, kw in (
        (j_history, j_watchlist, j_synthetic, JaxRegistry(), {}),
        (t_history, t_watchlist, synthetic_snapshot, TorchRegistry(),
         {"device": "cpu"}),
    ):
        specs = watchlist.parse_watchlist({"watches": [
            {"name": "web-tier", "pod": {"cpuRequests": "500m",
                                         "memRequests": "1gb",
                                         "replicas": "10"},
             "min_replicas": 120}]})
        tl = history.CapacityTimeline(specs, depth=8, registry=reg, **kw)
        a = make(24, seed=11)
        for g, snap in enumerate((a, _starve(a), a), start=1):
            tl.observe(snap, g, ts=T0 + g)
        out.append(_timeline_families(reg))
    assert out[1] == out[0]
    assert out[1]["kccap_watch_alert_state"][1]['watch="web-tier"'] == 1
    assert out[1]["kccap_watch_breaches_total"][1]['watch="web-tier"'] == 1


def test_disabled_telemetry_makes_zero_registry_calls(monkeypatch):
    monkeypatch.setenv("KCCAP_TELEMETRY", "0")
    reg = TorchRegistry()
    tl = t_history.CapacityTimeline(_plain_specs(), depth=4, registry=reg,
                                    device="cpu")
    tl.observe(synthetic_snapshot(8, seed=1), 1)
    tl.observe(synthetic_snapshot(8, seed=2), 2)
    assert reg.snapshot() == {}


def test_observation_never_runs_on_request_threads():
    """Watch evaluation happens on the publisher's thread, never on a
    dispatch thread serving queries."""
    tl = t_history.CapacityTimeline(_plain_specs(), depth=8, device="cpu")
    base = synthetic_snapshot(24, seed=42)
    server = TorchServer(base, device="cpu", timeline=tl)
    threads = set()
    orig = tl.observe

    def spy(snapshot, generation, **kw):
        threads.add(threading.current_thread().name)
        return orig(snapshot, generation, **kw)

    tl.observe = spy
    server.start()
    try:
        stop = threading.Event()
        errors = []

        def hammer():
            try:
                with TorchClient(*server.address, timeout_s=TIMEOUT_S,
                                 retry=None) as c:
                    while not stop.is_set():
                        c.sweep(random={"n": 2, "seed": 1})
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        hammers = [threading.Thread(target=hammer) for _ in range(4)]
        for th in hammers:
            th.start()
        publisher = threading.Thread(
            name="publisher-thread",
            target=lambda: server.replace_snapshot(_starve(base), warm=True))
        publisher.start()
        publisher.join(TIMEOUT_S)
        stop.set()
        for th in hammers:
            th.join(TIMEOUT_S)
        assert not errors
        assert threads == {"publisher-thread"}
        assert [r.generation for r in tl.records()] == [1, 2]
    finally:
        server.shutdown()


def test_a_failed_observation_leaves_its_generation_out():
    """The best-effort funnel: a failing watch evaluation never fails the
    publish, and the generation is missing from the timeline."""
    tl = t_history.CapacityTimeline(_plain_specs(), depth=8, device="cpu")
    base = synthetic_snapshot(24, seed=42)
    server = TorchServer(base, device="cpu", timeline=tl)
    try:
        orig = tl.observe

        def broken(snapshot, generation, **kw):
            raise RuntimeError("launch failed")

        tl.observe = broken
        server.replace_snapshot(_starve(base))
        tl.observe = orig
        server.replace_snapshot(base)
        assert server.generation == 3
        assert [r.generation for r in tl.records()] == [1, 3]
    finally:
        server.shutdown()


def test_timeline_disabled_server_answers_like_jax():
    from kubernetesclustercapacity_tpu.snapshot import (
        synthetic_snapshot as j_synthetic,
    )

    replies = []
    for server, client_cls in (
        (JaxServer(j_synthetic(4, seed=1)), JaxClient),
        (TorchServer(synthetic_snapshot(4, seed=1), device="cpu"),
         TorchClient),
    ):
        server.start()
        try:
            with client_cls(*server.address, timeout_s=TIMEOUT_S) as c:
                replies.append((c.timeline(), c.car(), c.forecast(),
                                c.gang()))
        finally:
            server.shutdown()
    assert replies[1] == replies[0]
    assert replies[1][0] == {"enabled": False}


def test_default_device_raises_without_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_history.CapacityTimeline(_plain_specs())


def test_server_main_watch_flag_like_jax(tmp_path, capsys):
    from kubernetesclustercapacity_tpu.service import server as j_server
    from kubernetesclustercapacity_tpu_torch.service import server as t_server

    bad = tmp_path / "bad.yaml"
    bad.write_text("watches: [{name: '', pod: {}}]")
    fixture = tmp_path / "f.json"
    fixture.write_text(json.dumps(synthetic_fixture(3, seed=1)))
    argv = ["-snapshot", str(fixture), "-watch", str(bad), "-port", "0"]
    assert j_server.main(argv) == 1
    j_err = capsys.readouterr().err
    assert t_server.main(argv + ["-device", "cpu"]) == 1
    t_err = capsys.readouterr().err
    assert t_err == j_err
    assert t_err.startswith("ERROR : bad watchlist: ")
