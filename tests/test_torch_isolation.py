"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to fall back to the host when CUDA is asked for
and absent."""

import ast
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from kubernetesclustercapacity_tpu_torch import cli as t_cli
from kubernetesclustercapacity_tpu_torch.ops import fused_fit as tf
from kubernetesclustercapacity_tpu_torch.ops import fused_multi as tm
from kubernetesclustercapacity_tpu_torch.scenario import random_scenario_grid
from kubernetesclustercapacity_tpu_torch.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu_torch.snapshot import synthetic_snapshot

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(REPO, "kubernetesclustercapacity_tpu_torch")
JAX_PACKAGE = "kubernetesclustercapacity_tpu"


def _forbidden(module: str) -> bool:
    # Exact name or dotted prefix: "kubernetesclustercapacity_tpu_torch"
    # also starts with "kubernetesclustercapacity_tpu".
    return any(
        module == banned or module.startswith(banned + ".")
        for banned in ("jax", "jaxlib", JAX_PACKAGE)
    )


def _imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_files():
    out = []
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out) + [os.path.join(REPO, "chip_smoke.py")]


def test_the_scan_is_not_vacuous():
    names = {os.path.relpath(p, REPO) for p in _port_files()}
    assert len(names) >= 15
    assert "kubernetesclustercapacity_tpu_torch/ops/fused_fit.py" in names
    assert "kubernetesclustercapacity_tpu_torch/ops/fused_multi.py" in names
    for module in ("service/server.py", "service/batching.py",
                   "service/client.py", "service/protocol.py",
                   "resilience.py", "telemetry/memledger.py",
                   "telemetry/phases.py", "utils/timing.py",
                   "utils/threads.py", "timeline/alerts.py", "store.py",
                   "kubeapi.py", "follower.py", "pdb.py",
                   "service/coalesce.py", "telemetry/compilewatch.py",
                   "utils/guards.py", "ops/placement.py",
                   "ops/preemption.py", "topology/model.py",
                   "stochastic/distributions.py", "stochastic/car.py",
                   "stochastic/history.py", "forecast/trend.py",
                   "forecast/horizon.py", "forecast/planner.py",
                   "audit/log.py", "timeline/diff.py",
                   "topology/gang.py", "topology/__init__.py",
                   "optimize/lp.py", "optimize/__init__.py",
                   "telemetry/exposition.py", "telemetry/process.py",
                   "telemetry/slo.py", "timeline/watchlist.py",
                   "timeline/history.py", "timeline/__init__.py",
                   "audit/replay.py", "audit/shadow.py",
                   "audit/__init__.py", "testing_faults.py",
                   "service/tenancy.py", "service/plane.py",
                   "service/replicaset.py", "federation/__init__.py",
                   "federation/server.py", "utils/doctor.py",
                   "telemetry/profiler.py", "telemetry/traceview.py",
                   "analysis/__init__.py", "analysis/benchdiff.py",
                   "analysis/engine.py", "analysis/callgraph.py",
                   "analysis/rules_jit.py", "analysis/rules_locks.py",
                   "analysis/rules_lockorder.py",
                   "analysis/rules_surface.py",
                   "analysis/rules_hygiene.py", "analysis/cli.py",
                   "analysis/sanitize.py", "analysis/sanitize_cli.py",
                   "analysis/hammer.py",
                   "native/__init__.py", "native/_build_util.py",
                   "native/ingest.py", "parallel/__init__.py",
                   "parallel/mesh.py", "parallel/sweep.py",
                   "parallel/multihost.py"):
        assert f"kubernetesclustercapacity_tpu_torch/{module}" in names


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, REPO)
)
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_forbidden_matcher_is_exact():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden(JAX_PACKAGE) and _forbidden(JAX_PACKAGE + ".ops.fit")
    assert not _forbidden("kubernetesclustercapacity_tpu_torch")
    assert not _forbidden("kubernetesclustercapacity_tpu_torch.ops")
    assert not _forbidden("jaxtyping_like")


_BLOCKED_RUN = textwrap.dedent(
    """
    import importlib.abc, io, contextlib, json, sys

    sys.modules["jax"] = None
    sys.modules["jaxlib"] = None

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "kubernetesclustercapacity_tpu" or name.startswith(
                "kubernetesclustercapacity_tpu."
            ):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())

    import kubernetesclustercapacity_tpu_torch as kt
    from kubernetesclustercapacity_tpu_torch import cli

    snap = kt.synthetic_snapshot(1500, seed=1, shapes=5)
    totals, sched, name = kt.sweep_snapshot_auto(
        snap, kt.random_scenario_grid(32, seed=2), device="cpu"
    )
    fx = kt.synthetic_fixture(20, seed=3, taint_frac=0.5)
    fx_path = sys.argv[1]
    kt.save_fixture(fx, fx_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["-snapshot", fx_path, "-semantics", "strict",
                       "-grid", "8", "-device", "cpu"])
    multi = io.StringIO()
    with contextlib.redirect_stdout(multi):
        rc += cli.main(["-snapshot", fx_path, "-semantics", "strict",
                        "-grid", "8", "-device", "cpu",
                        "-extended-request", "nvidia.com/gpu=0"])
    single = io.StringIO()
    with contextlib.redirect_stdout(single):
        rc += cli.main(["-snapshot", fx_path, "-semantics", "strict",
                        "-device", "cpu"])
        rc += cli.main(["-snapshot", fx_path, "-explain", "-output", "json",
                        "-device", "cpu"])
    model = kt.CapacityModel(snap, mode="strict", device="cpu")
    model_total = int(model.sweep(kt.random_scenario_grid(8, seed=4))[0].sum())
    from kubernetesclustercapacity_tpu_torch.service import (
        CapacityClient,
        CapacityServer,
    )

    server = CapacityServer(snap, device="cpu")
    server.start()
    try:
        with CapacityClient(*server.address, timeout_s=60) as client:
            service_kernel = client.sweep(random={"n": 8, "seed": 2})["kernel"]
            service_ping = client.ping()
    finally:
        server.shutdown()
    from kubernetesclustercapacity_tpu_torch import follower, kubeapi
    from kubernetesclustercapacity_tpu_torch.service import coalesce
    from kubernetesclustercapacity_tpu_torch.store import ClusterStore
    from kubernetesclustercapacity_tpu_torch.utils.guards import (
        checked_fit_totals,
    )

    store = ClusterStore(fx, semantics="strict")
    store.apply([{"type": "DELETED", "kind": "Node",
                  "object": {"name": fx["nodes"][0]["name"]}}])
    live = [store.n_nodes, kubeapi.node_to_fixture({})["name"],
            follower.ClusterFollower.__name__,
            coalesce.SnapshotCoalescer.__name__,
            checked_fit_totals(snap.alloc_cpu_milli, snap.alloc_mem_bytes,
                               snap.alloc_pods, snap.used_cpu_req_milli,
                               snap.used_mem_req_bytes, snap.pods_count,
                               snap.healthy, 100, 1 << 20,
                               device="cpu") > 0]
    from kubernetesclustercapacity_tpu_torch.ops import placement

    for pod in fx["pods"]:
        pod["priority"] = 1000 if len(pod["name"]) % 2 else 0
    fx_snap = kt.snapshot_from_fixture(fx, semantics="strict")
    sched_model = kt.CapacityModel(fx_snap, fixture=fx, device="cpu")
    spec = kt.PodSpec(cpu_request_milli=100, mem_request_bytes=1 << 20,
                      replicas=300)
    busiest = max(fx_snap.names, key=lambda n: sum(
        p.get("nodeName") == n for p in fx["pods"]))
    scheduling = [
        sched_model.place(spec, assignments=True).placed,
        sched_model.place(spec, topology_key="zone").engine,
        len(sched_model.drain(busiest).pods) > 0,
        sched_model.topology_spread(spec, topology_key="zone").total > 0,
        sched_model.nodes_needed(spec, {"allocatable": {
            "cpu": "4", "memory": "16Gi", "pods": "58"}}).nodes_needed,
        int(sched_model.sweep_preemption(
            kt.random_scenario_grid(8, seed=5), [0, 1000] * 4)[0].sum()) > 0,
        kt.CapacityModel(fx_snap, fixture=fx, device="cpu").evaluate(
            kt.PodSpec(100, 1 << 20, priority=1000)).total > 0,
        placement.POLICIES[0],
    ]
    from kubernetesclustercapacity_tpu_torch import audit, forecast, stochastic

    spec = stochastic.parse_stochastic_spec({
        "usage": {"cpu": {"dist": "normal", "mean": "300m", "std": "90m"},
                  "memory": {"dist": "lognormal", "mean": "512mb",
                             "sigma": 0.8}},
        "replicas": 40, "samples": 32, "seed": 3})
    car = stochastic.capacity_at_risk(snap, spec, device="cpu")
    horizon = forecast.project_horizon(snap, spec, steps=3,
                                       growth_cpu_per_s=1e-5, device="cpu")
    plan = forecast.plan_capacity(
        snap, spec, forecast.parse_catalog([
            {"name": "m5.xlarge", "cpu": "4", "memory": "16gb", "pods": 58,
             "unit_cost": 4}]),
        target=car.quantiles[0.95] + 100, device="cpu")
    audit_dir = fx_path + ".audit"
    with audit.AuditLog(audit_dir) as log:
        for g in range(1, 4):
            log.record_generation(snap, g, ts=float(g))
    car_cli = io.StringIO()
    spec_path = fx_path + ".car.json"
    with open(spec_path, "w") as f:
        json.dump({"usage": {"cpu": "200m", "memory": "256mb"},
                   "replicas": 5, "samples": 8}, f)
    with contextlib.redirect_stdout(car_cli):
        rc += cli.main(["-snapshot", fx_path, "-car-spec", spec_path,
                        "-device", "cpu", "-output", "json"])
    stochastic_results = [
        car.quantiles[0.95] > 0,
        horizon.totals.shape,
        plan.certified,
        audit.AuditReader.load(audit_dir).verify_chain(),
        json.loads(car_cli.getvalue())["samples"],
    ]
    from kubernetesclustercapacity_tpu_torch import optimize, topology

    topo_snap = kt.synthetic_snapshot(300, seed=6, topology=(2, 3))
    gang = topology.gang_capacity(
        topo_snap, kt.random_scenario_grid(4, seed=6),
        topology.GangSpec(ranks=8, colocate="zone", spread_level="rack",
                          max_ranks_per_domain=3), device="cpu")
    opt = optimize.optimize_snapshot(
        topo_snap, kt.random_scenario_grid(3, seed=7), device="cpu")
    gang_path = fx_path + ".gang.json"
    with open(gang_path, "w") as f:
        json.dump({"pod": {"cpuRequests": "100m"},
                   "gang": {"ranks": 2, "colocate": "zone"}}, f)
    gang_cli, opt_cli = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(gang_cli):
        rc += cli.main(["-snapshot", fx_path, "-gang-spec", gang_path,
                        "-device", "cpu", "-output", "json"])
    with contextlib.redirect_stdout(opt_cli):
        opt_rc = cli.main(["-snapshot", fx_path, "-optimize", "-output",
                           "json", "-device", "cpu", "-replicas", "3"])
    gang_opt = [gang.engine, int(gang.gangs.sum()) > 0, opt.all_certified,
                json.loads(gang_cli.getvalue())["engine"], opt_rc]
    import urllib.request

    from kubernetesclustercapacity_tpu_torch.service.server import (
        healthz_probes,
    )
    from kubernetesclustercapacity_tpu_torch.telemetry import slo
    from kubernetesclustercapacity_tpu_torch.telemetry.exposition import (
        start_metrics_server,
    )
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
        MetricsRegistry,
    )
    from kubernetesclustercapacity_tpu_torch.timeline import (
        CapacityTimeline,
        parse_watchlist,
    )

    reg = MetricsRegistry()
    timeline = CapacityTimeline(parse_watchlist([
        {"name": "web", "pod": {"cpuRequests": "100m"}},
        {"name": "p95", "pod": {"cpuRequests": "100m"}, "quantile": 0.95,
         "samples": 16, "usage": {"cpu": {"dist": "normal", "mean": "100m",
                                          "std": "20m"}}},
        {"name": "train", "pod": {"cpuRequests": "100m"},
         "gang": {"ranks": 2, "colocate": "zone"}}]),
        registry=reg, device="cpu")
    monitor = slo.SLOMonitor(slo.parse_slos([
        {"name": "a", "availability": "99%"}]), registry=reg)
    server = CapacityServer(topo_snap, device="cpu", registry=reg,
                            timeline=timeline, slo=monitor)
    healthy, status = healthz_probes(server, timeline=timeline, slo=monitor)
    metrics = start_metrics_server(reg, healthy=healthy, status=status)
    server.start()
    try:
        with CapacityClient(*server.address, timeout_s=60) as client:
            operator = [
                len(client.timeline()["records"]),
                client.slo_status()["enabled"],
                client.dump()["count"],
                client.gang()["enabled"],
            ]
        with urllib.request.urlopen(metrics.url + "/healthz") as r:
            operator.append(r.status)
        with urllib.request.urlopen(metrics.url + "/metrics") as r:
            operator.append(b"kccap_watch_replicas" in r.read())
    finally:
        metrics.shutdown()
        server.shutdown()
        monitor.close()
    from kubernetesclustercapacity_tpu_torch.analysis import benchdiff
    from kubernetesclustercapacity_tpu_torch.federation import (
        FederationServer,
    )
    from kubernetesclustercapacity_tpu_torch.telemetry import (
        profiler as _profiler,
        traceview,
    )
    from kubernetesclustercapacity_tpu_torch.utils import doctor

    with FederationServer(device="cpu") as fed:
        fed.inject("a", kt.synthetic_snapshot(40, seed=1))
        fed.inject("b", kt.synthetic_snapshot(30, seed=2))
        fed_reply = fed.dispatch({"op": "fed_sweep", "cpuRequests": "100m",
                                  "memRequests": "100mb"})
    checks = doctor.doctor_report(
        backend_timeout_s=60.0, probe_code="print('DEVICES 0s D x1')",
        device="cpu")
    prof = _profiler.start_profiler(50)
    prof_running = prof.running()
    _profiler.stop_profiler()
    fed_diag = [sorted(fed_reply["per_cluster"]), fed_reply["excluded"],
                doctor.healthy(checks), len(checks), prof_running,
                traceview.analyze_trace([], "x")["found"],
                benchdiff.infer_direction("x_ms")]
    from kubernetesclustercapacity_tpu_torch import native, parallel
    from kubernetesclustercapacity_tpu_torch import snapshot as _snapshot

    walks = dict(_snapshot.NATIVE_WALKS)
    kt.snapshot_from_fixture(fx, semantics="strict")
    with contextlib.redirect_stdout(io.StringIO()):
        native_rc = cli.main(["-snapshot", fx_path, "-backend", "native",
                              "-device", "cpu"])
    arrays = [getattr(snap, f) for f in (
        "alloc_cpu_milli", "alloc_mem_bytes", "alloc_pods",
        "used_cpu_req_milli", "used_mem_req_bytes", "pods_count",
        "healthy")]
    pgrid = kt.random_scenario_grid(8, seed=8)
    sharded = parallel.sweep_shard_map(
        parallel.make_mesh(2, 2, devices=["cpu"] * 4), arrays,
        pgrid.cpu_request_milli, pgrid.mem_request_bytes, pgrid.replicas)[0]
    native_parallel = [
        native.available(),
        _snapshot.NATIVE_WALKS["strict"] - walks["strict"],
        native_rc,
        sharded.tolist() == native.sweep(
            *arrays[:6], pgrid.cpu_request_milli,
            pgrid.mem_request_bytes).tolist(),
    ]
    import os, threading
    from kubernetesclustercapacity_tpu_torch.analysis import (
        Analyzer, Project, hammer, sanitize)
    os.environ[sanitize.ENV_SWITCH] = "1"
    hammer_found, hammer_stats = hammer.run(seed=0, threads=2, iters=2)
    del os.environ[sanitize.ENV_SWITCH]
    lint = Analyzer(Project(os.path.dirname(kt.__file__)),
                    rules=("device-purity", "lock-discipline")).run()
    analysis = [len(hammer_found), hammer_stats["instrumented_classes"],
                len(lint.findings), len(lint.suppressed) > 10,
                threading.Lock.__module__ in ("_thread", "threading")]
    loaded = sorted(
        m for m in sys.modules
        if m == "kubernetesclustercapacity_tpu"
        or m.startswith("kubernetesclustercapacity_tpu.")
        or (m.split(".")[0] in ("jax", "jaxlib")
            and sys.modules[m] is not None)
    )
    print(json.dumps({"name": name, "total": int(totals.sum()), "rc": rc,
                      "cli_kernel": json.loads(buf.getvalue())["kernel"],
                      "multi_kernel": json.loads(multi.getvalue())["kernel"],
                      "single_spec": "Total possible replicas" in
                      single.getvalue(),
                      "model_total": model_total,
                      "service": [service_ping, service_kernel],
                      "live": live,
                      "scheduling": scheduling,
                      "stochastic": stochastic_results,
                      "gang_opt": gang_opt,
                      "operator": operator,
                      "fed_diag": fed_diag,
                      "native_parallel": native_parallel,
                      "analysis": analysis,
                      "loaded": loaded}))
    """
)


def test_port_runs_with_jax_and_jax_package_blocked(tmp_path):
    script = tmp_path / "blocked.py"
    script.write_text(_BLOCKED_RUN)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, str(script), str(tmp_path / "fx.json")],
        capture_output=True, text=True, cwd=str(tmp_path), env=env,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert doc == {
        "name": "plain_i32_rcp_fused_grouped",
        "total": doc["total"],
        "rc": 0,
        "cli_kernel": "plain_i32_rcp_fused",
        "multi_kernel": "plain_multi_i32_rcp_fused",
        "single_spec": True,
        "model_total": doc["model_total"],
        "service": ["pong", "plain_i32_rcp_fused_grouped"],
        "live": [19, "", "ClusterFollower", "SnapshotCoalescer", True],
        "scheduling": [doc["scheduling"][0], "scan", True, True,
                       doc["scheduling"][4], True, True, "first-fit"],
        "stochastic": [True, [3, 32], True, [1, 2, 3], 8],
        "gang_opt": ["per-node", True, True, "per-node", 0],
        "operator": [1, True, 2, True, 200, True],
        "fed_diag": [["a", "b"], [], True, 13, True, False,
                     "lower_is_better"],
        "native_parallel": [True, 1, 0, True],
        "analysis": [0, 15, 0, True, True],
        "loaded": [],
    }
    assert doc["scheduling"][0] > 0
    assert doc["total"] > 0 and doc["model_total"] > 0


@pytest.fixture
def no_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    snap = synthetic_snapshot(50, seed=1)
    grid = random_scenario_grid(4, seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tf.sweep_snapshot_auto(snap, grid)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tf.sweep_auto(
            snap, grid.cpu_request_milli, grid.mem_request_bytes,
            grid.replicas,
        )


def test_multi_default_device_raises_without_cuda(no_cuda):
    snap = synthetic_snapshot(50, seed=1)
    alloc_rn, used_rn = snap.resource_matrix()
    args = (alloc_rn, used_rn, snap.alloc_pods, snap.pods_count,
            snap.healthy, np.array([[100, 1 << 20]]), np.ones(1, np.int64))
    for kw in ({}, {"force_exact": True}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tm.sweep_multi_auto(*args, **kw)


def test_cli_default_device_raises_without_cuda(no_cuda, capsys):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_cli.main(["-snapshot", "tests/fixtures/kind-3node.json",
                    "-grid", "4"])
    assert capsys.readouterr().out == ""


def test_scheduling_default_device_raises_without_cuda(no_cuda, capsys):
    """The device scans, the drain and the preemption sweep never carry on
    quietly on the host: without a card they raise (the closed-form host
    engines, which the JAX package also runs on the host, stay usable)."""
    from kubernetesclustercapacity_tpu_torch.models import (
        CapacityModel,
        PodSpec,
    )
    from kubernetesclustercapacity_tpu_torch.snapshot import (
        snapshot_from_fixture,
    )

    fx = synthetic_fixture(12, seed=2)
    model = CapacityModel(snapshot_from_fixture(fx, semantics="strict"),
                          fixture=fx)
    spec = PodSpec(cpu_request_milli=100, mem_request_bytes=1 << 20,
                   replicas=3)
    for call in (
        lambda: model.place(spec, assignments=True),
        lambda: model.place(spec, topology_key="zone"),
        lambda: model.drain(fx["nodes"][0]["name"]),
        lambda: model.sweep_preemption(random_scenario_grid(4, seed=1),
                                       [0, 1, 2, 3]),
        lambda: model.topology_spread_grid(random_scenario_grid(4, seed=1),
                                           topology_key="zone"),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert model.place(spec, assignments="trace").placed == 3
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_cli.main(["-snapshot", "tests/fixtures/kind-3node.json",
                    "-semantics", "strict", "-drain", "kind-worker"])
    assert capsys.readouterr().out == ""


def test_federation_default_device_raises_without_cuda(no_cuda):
    from kubernetesclustercapacity_tpu_torch.federation import (
        FederationServer,
    )

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FederationServer()
    with FederationServer(device="cpu") as fed:
        assert fed.status()["enabled"] is False


def test_fed_main_default_device_raises_without_cuda(no_cuda, capsys):
    from kubernetesclustercapacity_tpu_torch.federation import server

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server.main(["-cluster", "east=127.0.0.1:1", "-port", "0"])
    assert capsys.readouterr().out == ""


def test_doctor_default_device_fails_without_cuda(no_cuda, monkeypatch,
                                                  capsys):
    """``-doctor`` without ``-device cpu`` and without a card: the probe
    child (which sees no card either) is a FAILED line, the optimizer
    check refuses the missing card, and the exit code is 1."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert t_cli.main(["-doctor", "-doctor-timeout", "120"]) == 1
    lines = dict(
        (ln[:23].rstrip(), ln[25:])
        for ln in capsys.readouterr().out.splitlines()
    )
    assert lines["backend probe"] == (
        "FAILED: CUDA is not available (pass -device cpu to run on the host)")
    assert lines["optimizer"].startswith(
        "FAILED: RuntimeError: device 'cuda' requested but CUDA is not "
        "available")
