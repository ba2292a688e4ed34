"""The live-cluster surfaces of the port against the JAX package's, on the
CPU: the service's ``update`` op, ``-follow`` (follower → coalescer →
publish into the server), ``kccap-torch-server -follow`` through its
``main``, and the CLI's run without ``-snapshot``.

Both servers take the same seeded event batches (or follow identical mock
apiservers, ``test_kubeapi.MockApiserver``); every reply — the update's,
and the ``info``/``sweep``/``sweep_multi``/``fit`` replies after each
batch — must be equal apart from kernel labels (tolerance 0).  Both refuse
``reload`` and ``update`` under ``-follow`` with the same words.  The CLI
runs against a kubeconfig file and the mock, and its output (the error
and hint lines included) must equal the JAX CLI's byte for byte.
"""

import contextlib
import io
import json
import random
import socket
import threading
import time

import numpy as np
import pytest
import yaml

from kubernetesclustercapacity_tpu import cli as j_cli
from kubernetesclustercapacity_tpu import follower as j_follower
from kubernetesclustercapacity_tpu.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu.kubeapi import KubeClient as JClient
from kubernetesclustercapacity_tpu.kubeapi import KubeConfig as JConfig
from kubernetesclustercapacity_tpu.service.coalesce import (
    SnapshotCoalescer as JCoalescer,
)
from kubernetesclustercapacity_tpu.service.server import (
    CapacityServer as JaxServer,
)
from kubernetesclustercapacity_tpu.snapshot import (
    snapshot_from_fixture as j_snapshot_from_fixture,
)
from kubernetesclustercapacity_tpu_torch import cli as t_cli
from kubernetesclustercapacity_tpu_torch import follower as t_follower
from kubernetesclustercapacity_tpu_torch.kubeapi import KubeClient as TClient
from kubernetesclustercapacity_tpu_torch.kubeapi import KubeConfig as TConfig
from kubernetesclustercapacity_tpu_torch.service import server as t_server
from kubernetesclustercapacity_tpu_torch.service.server import (
    CapacityServer as TorchServer,
)
from kubernetesclustercapacity_tpu_torch.store import ClusterStore

from test_kubeapi import MockApiserver, _k8s_node, _k8s_pod
from test_torch_service import (
    EXTENDED,
    TIMEOUT_S,
    _gpu_fixture,
    fresh_jax_breaker,  # noqa: F401 - autouse here too
    _norm,
    _pair,
    _raw,
    _stop,
)
from test_torch_store import _event

NODES, PODS = "/api/v1/nodes", "/api/v1/pods"
GPU_SWEEP = {"op": "sweep_multi",
             "resources": ["cpu", "memory", "nvidia.com/gpu",
                           "ephemeral-storage"],
             "requests": [[250, 256 << 20, 1, 10 << 30],
                          [500, 1 << 30, 0, 1 << 30]],
             "replicas": [5, 50]}
AFTER_EACH_BATCH = [
    {"op": "info"},
    {"op": "sweep", "random": {"n": 16, "seed": 3}},
    {"op": "sweep", "random": {"n": 16, "seed": 4}, "kernel": "exact"},
    {"op": "fit", "cpuRequests": "200m", "memRequests": "250mb",
     "replicas": "10", "backend": "cpu"},
    {"op": "fit", "cpuRequests": "200m", "memRequests": "250mb",
     "replicas": "10", "output": "json"},
]
REFUSE_UPDATE = ("ValueError: this server follows a live cluster (-follow); "
                 "update events must go to the cluster, not the server")
REFUSE_RELOAD = ("ValueError: this server follows a live cluster (-follow); "
                 "reload is only for file-backed servers")


def _event_batches(fixture, semantics, extended, seed, n_batches, size):
    """Seeded watch-event batches, drawn against a mirror store so that
    most events apply (some are malformed on purpose)."""
    rng = random.Random(seed)
    mirror = ClusterStore(fixture, semantics=semantics,
                          extended_resources=extended)
    batches, serial = [], 0
    for _ in range(n_batches):
        batch = []
        for _ in range(size):
            serial += 1
            ev = _event(rng, mirror.fixture_view(), serial, serial, seed,
                        extended)
            try:
                mirror.apply_event(json.loads(json.dumps(ev)))
            except Exception:  # noqa: BLE001 - a refused event ends a batch
                batch.append(ev)
                break
            batch.append(ev)
        batches.append(batch)
    return batches


@pytest.mark.parametrize("source", ["reference", "strict", "strict-gpu"])
def test_update_batches_match_jax(source, tmp_path):
    if source == "strict-gpu":
        fixture, semantics, extended = _gpu_fixture(), "strict", EXTENDED
    else:
        fixture = synthetic_fixture(24, seed=5, taint_frac=0.3,
                                    unhealthy_frac=0.2,
                                    unscheduled_running_pods=2)
        semantics, extended = source, ()
    path = tmp_path / "cluster.json"
    path.write_text(json.dumps(fixture))
    pair = _pair(str(path), semantics, extended, batch_window_ms=0)
    try:
        for i, batch in enumerate(_event_batches(
                fixture, semantics, extended, seed=len(source), n_batches=6,
                size=12)):
            j_reply, t_reply = (_raw(s.address,
                                     {"op": "update", "events": batch})
                                for s in pair)
            assert _norm(t_reply) == _norm(j_reply), i
            assert t_reply["generation"] == i + 1
            follow = list(AFTER_EACH_BATCH)
            if extended:
                follow.append(GPU_SWEEP)
            for msg in follow:
                j_reply, t_reply = (_raw(s.address, msg) for s in pair)
                assert _norm(t_reply) == _norm(j_reply), (i, msg)
                assert t_reply["ok"], (i, msg)
                assert t_reply["generation"] == i + 2
    finally:
        _stop(*pair)


def test_update_refusals_match_jax(tmp_path):
    npz = tmp_path / "s.npz"
    from kubernetesclustercapacity_tpu_torch.snapshot import (
        synthetic_snapshot,
    )

    synthetic_snapshot(16, seed=2).save(str(npz))
    pair = _pair(str(npz), None, (), batch_window_ms=0)
    try:
        for msg in ({"op": "update", "events": []},
                    {"op": "update", "events": "nope"},
                    {"op": "update"}):
            j_reply, t_reply = (_raw(s.address, msg) for s in pair)
            assert t_reply == j_reply and not t_reply["ok"]
    finally:
        _stop(*pair)


def _with_rv(obj: dict, rv: int) -> dict:
    obj = json.loads(json.dumps(obj))
    obj.setdefault("metadata", {})["resourceVersion"] = str(rv)
    return obj


def _watch_streams(fixture, seed: int) -> dict:
    """One seeded stream per resource: pods added, finished and deleted,
    nodes flipping health, one node joining and one leaving."""
    rng = np.random.default_rng(seed)
    names = [n["name"] for n in fixture["nodes"]]
    pods, nodes, rv = [], [], 1000
    for i in range(30):
        rv += 1
        pod = dict(fixture["pods"][0], name=f"churn-{i}",
                   nodeName=names[int(rng.integers(len(names)))],
                   phase="Running")
        pods.append({"type": "ADDED", "object": _with_rv(_k8s_pod(pod), rv)})
    for i, pod in enumerate(fixture["pods"][1:21]):
        rv += 1
        if i % 2:
            pods.append({"type": "DELETED",
                         "object": _with_rv(_k8s_pod(pod), rv)})
        else:
            pods.append({"type": "MODIFIED", "object": _with_rv(
                _k8s_pod(dict(pod, phase="Succeeded")), rv)})
    for i, name in enumerate(names[:6]):
        rv += 1
        node = json.loads(json.dumps(fixture["nodes"][i]))
        node["conditions"][1]["status"] = "True"  # a pressure condition
        nodes.append({"type": "MODIFIED",
                      "object": _with_rv(_k8s_node(node), rv)})
    joiner = dict(json.loads(json.dumps(fixture["nodes"][0])), name="joiner")
    nodes.append({"type": "ADDED", "object": _with_rv(_k8s_node(joiner), 1)})
    nodes.append({"type": "DELETED",
                  "object": _with_rv(_k8s_node(fixture["nodes"][-1]), 2)})
    return {PODS: [pods], NODES: [nodes]}


def _follow_pair(mocks, semantics, extended):
    """Both packages' -follow wiring: the port's through
    ``follow_publisher``, the JAX package's as its ``main`` wires it."""
    out = []
    for side, srv in (("jax", mocks[0]), ("port", mocks[1])):
        cfg_cls, client_cls, mod = (
            (JConfig, JClient, j_follower) if side == "jax"
            else (TConfig, TClient, t_follower))
        cfg = cfg_cls(f"http://127.0.0.1:{srv.port}", token="tok")
        follower = mod.ClusterFollower(
            client_factory=lambda c=cfg, k=client_cls: k(c),
            semantics=semantics, extended_resources=extended,
            stop_on_idle_window=True,
        ).start(watch=False)
        if side == "jax":
            server = JaxServer(follower.snapshot(),
                               fixture=follower.fixture_view(),
                               batch_window_ms=0,
                               stats_source=follower.stats)
            coalescer = JCoalescer(
                lambda f=follower, s=server: s.replace_snapshot(
                    f.snapshot(), fixture_source=f.fixture_view, warm=True),
                min_interval_s=0.1,
            )
            follower.on_event = coalescer.notify
            follower.start_watches()
        else:
            server = TorchServer(follower.snapshot(),
                                 fixture=follower.fixture_view(),
                                 batch_window_ms=0, device="cpu",
                                 stats_source=follower.stats)
            coalescer, fatal = t_server.follow_publisher(
                server, follower, coalesce_ms=100)
            assert fatal == []
        server.start()
        out.append((follower, coalescer, server))
    return out


@pytest.mark.parametrize("semantics,extended", [
    ("reference", ()), ("strict", EXTENDED)], ids=["reference", "strict-gpu"])
def test_follow_publishes_match_jax(semantics, extended):
    fixture = _gpu_fixture()
    mocks = [MockApiserver(fixture, require_token="tok") for _ in range(2)]
    for srv in mocks:
        srv.watch_streams = _watch_streams(fixture, seed=9)
    sides = []
    try:
        sides = _follow_pair(mocks, semantics, extended)
        for follower, coalescer, _ in sides:
            follower.join(TIMEOUT_S)
            assert coalescer.stop(timeout=TIMEOUT_S)  # drains the finale
            assert coalescer.last_error is None and follower.fatal is None
        (jf, _, js), (tf, tc, ts) = sides
        assert tf.stats() == jf.stats()
        assert tf.stats()["events_applied"] == 58
        assert tc.flushes >= 1
        msgs = list(AFTER_EACH_BATCH)
        if extended:
            msgs.append(GPU_SWEEP)
        for msg in msgs:
            j_reply, t_reply = _raw(js.address, msg), _raw(ts.address, msg)
            # The generation counts publishes, which the coalescer's
            # windows set (timing): compare everything else.
            for reply in (j_reply, t_reply):
                reply.pop("generation")
            assert _norm(t_reply) == _norm(j_reply), msg
            assert t_reply["ok"]
        info = _raw(ts.address, {"op": "info"})["result"]
        assert info["nodes"] == len(fixture["nodes"])  # one in, one out
        assert info["resilience"]["follower"]["events_applied"] == 58
        for msg, words in (
            ({"op": "update", "events": []}, REFUSE_UPDATE),
            ({"op": "reload", "path": "tests/fixtures/kind-3node.json"},
             REFUSE_RELOAD),
        ):
            j_reply, t_reply = _raw(js.address, msg), _raw(ts.address, msg)
            for reply in (j_reply, t_reply):
                reply.pop("generation")
            assert t_reply == j_reply
            assert t_reply["error"] == words
    finally:
        for follower, coalescer, server in sides:
            follower.stop()
            coalescer.stop(timeout=TIMEOUT_S)
            server.shutdown()
        for srv in mocks:
            srv.close()


def test_anti_affinity_fit_pulls_the_followed_fixture():
    """A follower-fed server serves no materialized fixture; a fit that
    reads pod labels pulls one from the follower, like the JAX server."""
    fixture = synthetic_fixture(12, seed=4)
    for pod in fixture["pods"][::2]:
        pod["labels"] = {"app": "db"}
    mocks = [MockApiserver(fixture, require_token="tok") for _ in range(2)]
    for srv in mocks:
        srv.watch_streams = {PODS: [[{"type": "ADDED", "object": _with_rv(
            _k8s_pod(dict(fixture["pods"][0], name="late",
                          labels={"app": "db"})), 5)}]]}
    sides = []
    try:
        sides = _follow_pair(mocks, "strict", ())
        for follower, coalescer, _ in sides:
            follower.join(TIMEOUT_S)
            assert coalescer.stop(timeout=TIMEOUT_S)
        msg = {"op": "fit", "cpuRequests": "100m", "memRequests": "64mb",
               "replicas": "3", "anti_affinity_labels": {"app": "db"},
               "output": "json"}
        (_, _, js), (_, _, ts) = sides
        j_reply, t_reply = _raw(js.address, msg), _raw(ts.address, msg)
        for reply in (j_reply, t_reply):
            reply.pop("generation")
        assert t_reply["ok"] and _norm(t_reply) == _norm(j_reply)
    finally:
        for follower, coalescer, server in sides:
            follower.stop()
            coalescer.stop(timeout=TIMEOUT_S)
            server.shutdown()
        for srv in mocks:
            srv.close()


def _kubeconfig(tmp_path, srv, token="tok") -> str:
    doc = {
        "apiVersion": "v1", "kind": "Config", "current-context": "mock",
        "contexts": [{"name": "mock",
                      "context": {"cluster": "c", "user": "u"}}],
        "clusters": [{"name": "c", "cluster": {
            "server": f"http://127.0.0.1:{srv.port}"}}],
        "users": [{"name": "u", "user": {"token": token}}],
    }
    path = tmp_path / "kubeconfig"
    path.write_text(yaml.safe_dump(doc))
    return str(path)


def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def test_server_main_follows_a_cluster_until_drained(tmp_path):
    fixture = synthetic_fixture(16, seed=6)
    srv = MockApiserver(fixture, require_token="tok")
    port = _free_port()
    result = {}
    thread = threading.Thread(target=lambda: result.update(
        rc=t_server.main(["-follow", "-kubeconfig", _kubeconfig(tmp_path, srv),
                          "-port", str(port), "-device", "cpu",
                          "-coalesce-ms", "10", "-batch-window-ms", "0"])))
    thread.start()
    try:
        deadline = time.monotonic() + TIMEOUT_S
        while True:
            try:
                reply = _raw(("127.0.0.1", port), {"op": "info"})
                break
            except OSError:
                assert time.monotonic() < deadline
                time.sleep(0.05)
        assert reply["result"]["nodes"] == 16
        assert reply["result"]["resilience"]["follower"]["relists"] >= 1
        j = JaxServer(j_snapshot_from_fixture(fixture), batch_window_ms=0)
        j.start()
        try:
            msg = {"op": "sweep", "random": {"n": 8, "seed": 1}}
            assert _norm(_raw(("127.0.0.1", port), msg)) == _norm(
                _raw(j.address, msg))
        finally:
            j.shutdown()
        drained = _raw(("127.0.0.1", port), {"op": "drain_server"})
        assert drained["result"]["drained"] is True
        thread.join(timeout=TIMEOUT_S)
        assert not thread.is_alive()
        assert result == {"rc": 0}
    finally:
        srv.close()


@pytest.mark.parametrize("argv", [
    [],
    ["-follow", "-kubeconfig", "MISSING"],
    ["-follow", "-kubeconfig", "MISSING", "-extended-resources",
     "nvidia.com/gpu"],
], ids=["no-source", "missing-kubeconfig", "extended-needs-strict"])
def test_server_main_source_errors_match_jax(argv, tmp_path, capsys):
    from kubernetesclustercapacity_tpu.service import server as j_server

    argv = [str(tmp_path / a) if a == "MISSING" else a for a in argv]
    rcs, errs = [], []
    for main, extra in ((j_server.main, []),
                        (t_server.main, ["-device", "cpu"])):
        rcs.append(main(argv + ["-port", "0"] + extra))
        errs.append(capsys.readouterr().err)
    assert rcs == [1, 1] and errs[0] == errs[1]
    assert errs[1].startswith("ERROR : ")


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.fixture()
def live_cluster(tmp_path):
    fixture = synthetic_fixture(23, seed=7, unhealthy_frac=0.1,
                                taint_frac=0.2, unscheduled_running_pods=2)
    for i, node in enumerate(fixture["nodes"]):
        node["allocatable"]["nvidia.com/gpu"] = str(i % 5)
    srv = MockApiserver(fixture, require_token="sekrit")
    yield _kubeconfig(tmp_path, srv, token="sekrit"), srv
    srv.close()


SPEC = ["-cpuRequests=200m", "-cpuLimits=400m", "-memRequests=250mb",
        "-memLimits=500mb", "-replicas=40"]


@pytest.mark.parametrize("extra", [
    ["-grid", "16", "-seed", "3"],
    ["-grid", "16", "-semantics", "strict", "-output", "table"],
    ["-grid", "8", "-semantics", "strict",
     "-extended-request", "nvidia.com/gpu=1"],
    SPEC,
    SPEC + ["-semantics", "strict", "-output", "json"],
    SPEC + ["-backend", "cpu"],
    SPEC + ["-explain", "-output", "json"],
    ["-grid", "4", "-extended-request", "nvidia.com/gpu=1"],
    ["-grid", "4", "-kubeconfig", "MISSING"],
    ["-grid", "4", "-kubeconfig", "BADTOKEN"],
    ["-semantics", "strict", "-drain", "node-00017"],
    ["-semantics", "strict", "-drain", "node-00020", "-drain-policy",
     "spread"],
], ids=["grid", "grid-strict-table", "grid-extended", "transcript",
        "strict-json", "backend-cpu", "explain", "extended-needs-strict",
        "missing-kubeconfig", "refused-token", "drain", "drain-spread"])
def test_cli_live_run_matches_jax(extra, live_cluster, tmp_path, capsys):
    kubeconfig, srv = live_cluster
    argv = ["-kubeconfig", kubeconfig] + extra
    if "MISSING" in argv:
        argv = argv[2:]
        argv[argv.index("MISSING")] = str(tmp_path / "absent")
    if "BADTOKEN" in argv:
        argv = argv[2:]
        argv[argv.index("BADTOKEN")] = _kubeconfig(
            tmp_path, srv, token="wrong")
    j_rc, j_out = _run(j_cli.main, argv, capsys)
    t_rc, t_out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
    assert t_rc == j_rc
    assert t_out == j_out.replace("pallas_", "plain_").replace(
        "xla_int64", "torch_int64")
    assert "not yet ported" not in t_out
    refused = "MISSING" in extra or "BADTOKEN" in extra or (
        "-extended-request" in extra and "-semantics" not in extra)
    assert (t_rc == 1 and t_out.startswith("ERROR : ")) is refused


def test_cli_live_source_equals_the_snapshot_source(live_cluster, tmp_path,
                                                    capsys):
    """The live run answers exactly as ``-snapshot`` on the same cluster
    written to a file (the CLI's one source layer)."""
    kubeconfig, srv = live_cluster
    from kubernetesclustercapacity_tpu_torch.kubeapi import live_fixture

    path = tmp_path / "cluster.json"
    path.write_text(json.dumps(live_fixture(kubeconfig)))
    for extra in (["-grid", "32"], SPEC):
        live = _run(t_cli.main, ["-kubeconfig", kubeconfig, *extra,
                                 "-device", "cpu"], capsys)
        snap = _run(t_cli.main, ["-snapshot", str(path), *extra,
                                 "-device", "cpu"], capsys)
        assert live == snap and live[0] == 0


def test_cli_load_source_lists_through_a_given_client(live_cluster, capsys):
    """``load_source(client=)``: the CLI's source step on an explicit
    ``KubeClient`` (no kubeconfig file) gives the file route's snapshot."""
    kubeconfig, srv = live_cluster
    args = t_cli.build_parser().parse_args(["-kubeconfig", kubeconfig])
    _, via_file = t_cli.load_source(args)
    args = t_cli.build_parser().parse_args([])
    client = TClient(TConfig(f"http://127.0.0.1:{srv.port}", token="sekrit"))
    fixture, via_client = t_cli.load_source(args, client=client)
    assert fixture is None and args.semantics == "reference"
    for col in ("alloc_cpu_milli", "used_mem_req_bytes", "pods_count",
                "healthy"):
        np.testing.assert_array_equal(getattr(via_client, col),
                                      getattr(via_file, col))
    with contextlib.redirect_stdout(io.StringIO()) as out:
        bad = TClient(TConfig(f"http://127.0.0.1:{srv.port}", token="no"))
        assert t_cli.load_source(
            t_cli.build_parser().parse_args([]), client=bad) == (None, None)
    assert out.getvalue().startswith("ERROR : cannot snapshot live cluster")
    assert out.getvalue().splitlines()[1].startswith("hint: ")
