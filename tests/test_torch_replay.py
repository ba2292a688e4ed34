"""The port's audit replay against ``kubernetesclustercapacity_tpu.audit.
replay``, on the CPU: the whole-system parity check.

One seeded history goes to a JAX ``CapacityServer`` and to the port's, each
with an ``AuditLog``: three generations (two ``update`` batches between
them), and in each a request of every replayable op (``sweep`` twice,
``explain``, ``fit``, ``gang``, ``optimize``, ``forecast``, ``plan`` with a
catalog) plus a ``sweep_multi`` over the GPU column, each sent with one of
three tenants' tokens.  Then:

* both logs hold the same generation digests and, record by record, the
  same ops, args and result digests;
* the port's ``Replayer`` (on the CPU) re-answers the JAX-written log, and
  the JAX ``Replayer`` the port-written one, with 0 mismatches and 0
  errors; every replayable request is ``ok`` and the rest are ``skipped``
  with the JAX reason;
* ``replay_table_report`` / ``replay_json_report`` are byte-identical
  across the packages, and so is the CLI's ``-replay``, ``-replay-ref``,
  ``-replay-generation`` and ``-replay-tenant`` output on either log;
* ``replay_shadow_bundle`` confirms a healthy build does not reproduce a
  fake divergence, as the JAX one does;
* two faults of the JAX writer (ROADMAP §C, C4 and C5: nodes added out of
  key order, a tainted node added by a diff) break its log's replay; the
  port's log of the same history replays clean in both packages.

Tolerance: none (digests, integers and bytes are equal).
"""

import copy
import json
import os

import numpy as np
import pytest

from kubernetesclustercapacity_tpu import cli as j_cli
from kubernetesclustercapacity_tpu import report as j_report
from kubernetesclustercapacity_tpu.audit import AuditLog as JaxLog
from kubernetesclustercapacity_tpu.audit import AuditReader as JaxReader
from kubernetesclustercapacity_tpu.audit import Replayer as JaxReplayer
from kubernetesclustercapacity_tpu.audit import (
    replay_shadow_bundle as j_replay_bundle,
)
from kubernetesclustercapacity_tpu.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu.service import tenancy as j_tenancy
from kubernetesclustercapacity_tpu.service.server import (
    CapacityServer as JaxServer,
)
from kubernetesclustercapacity_tpu.sources import (
    resolve_source as j_resolve_source,
)
from kubernetesclustercapacity_tpu_torch import cli as t_cli
from kubernetesclustercapacity_tpu_torch import report as t_report
from kubernetesclustercapacity_tpu_torch.audit import AuditLog as TorchLog
from kubernetesclustercapacity_tpu_torch.audit import (
    AuditReader as TorchReader,
)
from kubernetesclustercapacity_tpu_torch.audit import (
    Replayer as TorchReplayer,
)
from kubernetesclustercapacity_tpu_torch.audit import (
    replay_shadow_bundle as t_replay_bundle,
)
from kubernetesclustercapacity_tpu_torch.service import tenancy as t_tenancy
from kubernetesclustercapacity_tpu_torch.service.server import (
    CapacityServer as TorchServer,
)
from kubernetesclustercapacity_tpu_torch.sources import (
    resolve_source as t_resolve_source,
)

EXTENDED = ("ephemeral-storage", "nvidia.com/gpu")
TENANTS = {"tenants": [
    {"name": "batch", "token": "tok-batch", "weight": 1},
    {"name": "web", "token": "tok-web", "weight": 2},
    {"name": "ml", "token": "tok-ml", "weight": 4},
]}
TOKENS = ("tok-batch", "tok-web", "tok-ml")
USAGE = {"cpu": {"dist": "normal", "mean": "500m", "std": "150m"},
         "memory": {"dist": "lognormal", "mean": "1gb", "sigma": 0.4}}
REPLAYABLE = ("sweep", "explain", "fit", "gang", "optimize", "forecast",
              "plan")
GENERATIONS = 3


def _fixture():
    """A strict 120-node fixture over 3 zones x 2 racks, 20% tainted, with
    0-8 GPUs and 50-500 Gi of storage per node."""
    fx = synthetic_fixture(120, seed=21, taint_frac=0.2, unhealthy_frac=0.05,
                           topology=(3, 2))
    rng = np.random.default_rng(22)
    for node in fx["nodes"]:
        node["allocatable"]["nvidia.com/gpu"] = str(rng.integers(0, 9))
        node["allocatable"]["ephemeral-storage"] = \
            f"{rng.integers(50, 501)}Gi"
    return fx


def _requests(g: int) -> list[dict]:
    """Generation ``g``'s requests: every replayable op and a
    ``sweep_multi``, from numpy seed ``100 + g``."""
    rng = np.random.default_rng(100 + g)
    return [
        {"op": "sweep", "random": {"n": 16, "seed": g}},
        {"op": "sweep",
         "cpu_request_milli": rng.integers(1, 4000, 8).tolist(),
         "mem_request_bytes": rng.integers(1 << 20, 8 << 30, 8).tolist(),
         "replicas": rng.integers(1, 500, 8).tolist()},
        {"op": "explain", "cpuRequests": f"{int(rng.integers(1, 9))}00m",
         "memRequests": "512mb", "replicas": "50", "output": "json"},
        {"op": "fit", "cpuRequests": "250m", "memRequests": "256mb",
         "replicas": "20", "output": "json"},
        {"op": "gang", "ranks": int(rng.integers(4, 12)),
         "colocate": "rack", "cpuRequests": "1", "memRequests": "2gb"},
        {"op": "optimize", "cpuRequests": "500m", "memRequests": "512mb",
         "replicas": str(int(rng.integers(100, 900)))},
        {"op": "forecast", "usage": USAGE, "replicas": 40, "samples": 16,
         "seed": g, "steps": 3, "growth": {"cpu_per_s": 2e-5}},
        {"op": "plan", "catalog": [{"name": "m", "cpu": "8",
                                    "memory": "32gb", "unit_cost": 2.0}],
         "usage": USAGE, "replicas": 50, "samples": 16, "seed": g,
         "target": 300},
        {"op": "sweep_multi",
         "resources": ["cpu", "memory", "nvidia.com/gpu"],
         "requests": [[500, 1 << 30, 1], [100, 1 << 28, 0]],
         "replicas": [1, 2]},
    ]


def _events(fx: dict, g: int) -> list[dict]:
    rng = np.random.default_rng(200 + g)
    names = [n["name"] for n in fx["nodes"]]
    return [
        {"type": "ADDED", "kind": "Pod", "object": {
            "name": f"churn-{g}-{k}", "namespace": "churn",
            "nodeName": names[int(rng.integers(len(names)))],
            "phase": "Running", "containers": [{"resources": {"requests": {
                "cpu": f"{int(rng.integers(100, 900))}m",
                "memory": f"{int(rng.integers(64, 900))}Mi"}}}]}}
        for k in range(6)
    ]


def _record(server_cls, log_cls, resolve, tenancy, path, directory, **kw):
    log = log_cls(directory, checkpoint_every=2, segment_max_bytes=16384)
    fixture, snap, _ = resolve(path, "strict", extended_resources=EXTENDED)
    server = server_cls(
        snap, fixture=fixture, port=0, batch_window_ms=0.0, audit_log=log,
        tenants=tenancy.parse_tenants(copy.deepcopy(TENANTS)), **kw,
    )
    fx = json.load(open(path))
    k = 0
    try:
        for g in range(GENERATIONS):
            for msg in _requests(g):
                server.dispatch(dict(msg, tenant_token=TOKENS[k % 3]))
                k += 1
            if g + 1 < GENERATIONS:
                server.dispatch({"op": "update", "events": _events(fx, g),
                                 "tenant_token": TOKENS[k % 3]})
                k += 1
    finally:
        server.shutdown()
        log.close()
    return directory


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    d = tmp_path_factory.mktemp("replay")
    path = str(d / "fleet.json")
    with open(path, "w") as f:
        json.dump(_fixture(), f)
    return {
        "jax": _record(JaxServer, JaxLog, j_resolve_source, j_tenancy, path,
                       str(d / "jax-audit")),
        "torch": _record(TorchServer, TorchLog, t_resolve_source, t_tenancy,
                         path, str(d / "torch-audit"), device="cpu"),
    }


def _replay(side: str, directory: str, **kw) -> dict:
    if side == "jax":
        with JaxReplayer(JaxReader.load(directory)) as rp:
            return rp.replay_all(**kw)
    with TorchReplayer(TorchReader.load(directory), device="cpu") as rp:
        return rp.replay_all(**kw)


def test_both_servers_record_the_same_history(logs):
    j, t = JaxReader.load(logs["jax"]), TorchReader.load(logs["torch"])
    j_gens = [(r["generation"], r["digest"]) for r in j.generations()]
    t_gens = [(r["generation"], r["digest"]) for r in t.generations()]
    assert j_gens == t_gens and len(j_gens) == GENERATIONS
    keys = ("op", "generation", "status", "args", "result_digest", "error")
    j_reqs = [{k: r.get(k) for k in keys} for r in j.requests()]
    t_reqs = [{k: r.get(k) for k in keys} for r in t.requests()]
    assert len(j_reqs) == GENERATIONS * 10 - 1
    assert t_reqs == j_reqs
    assert all(r["status"] == "ok" for r in t_reqs)
    # The derived tenant rides the audited args; the token never does.
    assert {r["args"]["tenant"] for r in t_reqs} == {"batch", "web", "ml"}
    assert not any("tenant_token" in r["args"] for r in t_reqs)


@pytest.mark.parametrize("writer,replayer", [("jax", "torch"),
                                             ("torch", "jax"),
                                             ("torch", "torch")])
def test_replay_across_packages_is_clean(logs, writer, replayer):
    result = _replay(replayer, logs[writer])
    assert result["chain_error"] is None and result["clean"]
    assert result["generations_verified"] == list(range(1, GENERATIONS + 1))
    by_op: dict = {}
    for o in result["outcomes"]:
        by_op.setdefault(o["op"], []).append(o)
    for op in REPLAYABLE:
        want = 2 * GENERATIONS if op == "sweep" else GENERATIONS
        assert [o["status"] for o in by_op[op]] == ["ok"] * want, op
    for op in ("sweep_multi", "update"):
        assert {o["reason"] for o in by_op[op]} == {
            f"op {op!r} is recorded but not replayable"}
    assert result["counts"] == {"ok": 8 * GENERATIONS, "mismatch": 0,
                                "skipped": 2 * GENERATIONS - 1, "error": 0}


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("tenant", [None, "batch", "web", "ml"])
def test_replay_reports_are_byte_identical(logs, writer, tenant):
    j_result = _replay("jax", logs[writer], tenant=tenant)
    t_result = _replay("torch", logs[writer], tenant=tenant)
    assert t_result == j_result
    assert (t_report.replay_json_report(t_result)
            == j_report.replay_json_report(j_result))
    assert (t_report.replay_table_report(t_result)
            == j_report.replay_table_report(j_result))


def _cli(main, argv, capsys):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


def _cli_cases(directory):
    reader = TorchReader.load(directory)
    last_sweep = [r for r in reader.requests() if r["op"] == "sweep"][-1]
    return [
        ["-replay", directory],
        ["-replay", directory, "-output", "json"],
        ["-replay", directory, "-replay-ref", last_sweep["_ref"]],
        ["-replay", directory, "-replay-generation", str(GENERATIONS)],
        ["-replay", directory, "-replay-generation", "1", "-output",
         "json"],
        ["-replay", directory, "-replay-tenant", "web", "-output", "json"],
        ["-replay", directory, "-replay-generation", "99"],
        ["-replay", directory + "-missing"],
    ]


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("case", range(8))
def test_cli_replay_matches_jax(logs, writer, case, capsys):
    argv = _cli_cases(logs[writer])[case]
    j_rc, j_out, j_err = _cli(j_cli.main, argv, capsys)
    t_rc, t_out, t_err = _cli(t_cli.main, argv + ["-device", "cpu"], capsys)
    assert (t_rc, t_out, t_err) == (j_rc, j_out, j_err)
    assert (t_rc == 0) == (case < 6)


def test_replay_ref_and_generation_answer_the_leaders_state(logs, capsys):
    reader = TorchReader.load(logs["jax"])
    last = [r for r in reader.requests() if r["op"] == "sweep"][-1]
    rc, out, _ = _cli(t_cli.main, ["-replay", logs["jax"], "-replay-ref",
                                   last["_ref"], "-output", "json",
                                   "-device", "cpu"], capsys)
    (outcome,) = json.loads(out)["outcomes"]
    assert rc == 0 and outcome["status"] == "ok"
    assert outcome["replayed_digest"] == last["result_digest"]
    rc, out, _ = _cli(t_cli.main, ["-replay", logs["jax"],
                                   "-replay-generation", str(GENERATIONS),
                                   "-output", "json", "-device", "cpu"],
                      capsys)
    gen = [r for r in reader.generations()
           if r["generation"] == GENERATIONS][0]
    assert rc == 0 and json.loads(out)["digest"] == gen["digest"]


def _bundle(directory: str) -> dict:
    """A divergence bundle as the shadow sampler writes one, for the last
    generation's 16-scenario random sweep, with the served totals moved by
    one."""
    from kubernetesclustercapacity_tpu_torch.scenario import (
        random_scenario_grid,
    )

    reader = TorchReader.load(directory)
    last = [r for r in reader.requests()
            if r["op"] == "sweep" and "random" in r["args"]][-1]
    grid = random_scenario_grid(16, seed=last["args"]["random"]["seed"])
    with TorchReplayer(reader, device="cpu") as rp:
        served = rp._dispatch(last["generation"], {
            "op": "sweep",
            "cpu_request_milli": grid.cpu_request_milli.tolist(),
            "mem_request_bytes": grid.mem_request_bytes.tolist(),
            "replicas": grid.replicas.tolist()})["totals"]
    served[3] += 1
    return {"kind": "shadow_divergence", "generation": last["generation"],
            "digest": "x", "cpu_request_milli":
                grid.cpu_request_milli.tolist(),
            "mem_request_bytes": grid.mem_request_bytes.tolist(),
            "replicas": grid.replicas.tolist(), "served_totals": served}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_shadow_bundle_replay_refutes_a_fake_divergence(logs, writer):
    bundle = _bundle(logs[writer])
    t_result = t_replay_bundle(TorchReader.load(logs[writer]), bundle,
                               device="cpu")
    j_result = j_replay_bundle(JaxReader.load(logs[writer]), bundle)
    assert t_result == j_result
    assert t_result["diverged"] is False
    assert t_result["served_matches_bundle"] is False
    assert t_result["scenarios"] == 16


def test_replayer_on_cuda_refuses_without_a_card(logs, monkeypatch):
    """A replay asked to run on the card never answers from the host."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rec = next(r for r in TorchReader.load(logs["jax"]).requests()
               if r["op"] == "sweep")
    with TorchReplayer(TorchReader.load(logs["jax"])) as rp:
        outcome = rp.replay_record(rec)
    assert outcome["status"] == "error"
    assert "CUDA is not available" in outcome["reason"]


def test_segments_rotate_in_both_logs(logs):
    for directory in logs.values():
        segments = [f for f in os.listdir(directory)
                    if f.endswith(".jsonl")]
        assert len(segments) > 1


def test_nodes_added_out_of_key_order_replay_clean(tmp_path):
    """Fault C4 of the reference, fixed in the port: a generation that adds
    two nodes out of key order (``joiner-2`` then ``joiner-0``) is written
    by the JAX log without its row order, and its own reader then fails
    the digest chain; the port's log records the order, and both packages'
    replayers verify it."""
    fx = _fixture()
    path = str(tmp_path / "fleet.json")
    with open(path, "w") as f:
        json.dump(fx, f)
    joiners = []
    for name, source in (("joiner-2", 5), ("joiner-0", 9)):
        node = json.loads(json.dumps(fx["nodes"][source]))
        node["name"] = name
        joiners.append({"type": "ADDED", "kind": "Node", "object": node})
    logs = {}
    for side, server_cls, log_cls, resolve, kw in (
            ("jax", JaxServer, JaxLog, j_resolve_source, {}),
            ("torch", TorchServer, TorchLog, t_resolve_source,
             {"device": "cpu"})):
        directory = str(tmp_path / side)
        log = log_cls(directory)
        fixture, snap, _ = resolve(path, "strict",
                                   extended_resources=EXTENDED)
        server = server_cls(snap, fixture=fixture, port=0,
                            batch_window_ms=0.0, audit_log=log, **kw)
        try:
            server.dispatch({"op": "update", "events": joiners})
            server.dispatch({"op": "sweep", "random": {"n": 8, "seed": 1}})
        finally:
            server.shutdown()
            log.close()
        logs[side] = directory
    j_gens = [r["digest"] for r in JaxReader.load(logs["jax"]).generations()]
    t_gens = [r["digest"] for r in
              TorchReader.load(logs["torch"]).generations()]
    assert t_gens == j_gens
    with pytest.raises(Exception, match="reconstruction digest"):
        JaxReader.load(logs["jax"]).verify_chain()
    for side in ("jax", "torch"):
        result = _replay(side, logs["torch"])
        assert result["clean"] and result["chain_error"] is None
        assert result["counts"]["ok"] == 1


def test_a_tainted_node_added_replays_clean(tmp_path):
    """Fault C5 of the reference, fixed in the port: a diff record carries
    no taints, so the JAX log replays a tainted node a diff added as
    untainted, and a strict sweep after it mismatches; the port's log
    writes that generation as a checkpoint, and both packages' replayers
    verify it."""
    fx = _fixture()
    path = str(tmp_path / "fleet.json")
    with open(path, "w") as f:
        json.dump(fx, f)
    node = next(n for n in fx["nodes"] if n.get("taints"))
    joiner = dict(json.loads(json.dumps(node)), name="joiner-tainted")
    results = {}
    for side, server_cls, log_cls, resolve, kw in (
            ("jax", JaxServer, JaxLog, j_resolve_source, {}),
            ("torch", TorchServer, TorchLog, t_resolve_source,
             {"device": "cpu"})):
        directory = str(tmp_path / side)
        log = log_cls(directory)
        fixture, snap, _ = resolve(path, "strict",
                                   extended_resources=EXTENDED)
        server = server_cls(snap, fixture=fixture, port=0,
                            batch_window_ms=0.0, audit_log=log, **kw)
        try:
            server.dispatch({"op": "update", "events": [
                {"type": "ADDED", "kind": "Node", "object": joiner}]})
            server.dispatch({"op": "sweep", "random": {"n": 64, "seed": 2}})
        finally:
            server.shutdown()
            log.close()
        kinds = [r["kind"] for r in
                 TorchReader.load(directory).generations()]
        results[side] = (kinds, _replay("jax", directory)["counts"],
                         _replay("torch", directory)["counts"])
    clean = {"ok": 1, "mismatch": 0, "skipped": 1, "error": 0}
    assert results["torch"] == (["checkpoint", "checkpoint"], clean, clean)
    broken = dict(clean, ok=0, mismatch=1)
    assert results["jax"] == (["checkpoint", "diff"], broken, broken)
