"""The port's live-cluster client against the JAX package's.

Both packages' ``KubeConfig``, ``KubeClient`` and ``live_fixture`` run
against the same in-process mock apiserver (``test_kubeapi.MockApiserver``:
paged Lists, newline-delimited watch streams, a bearer token) and the same
kubeconfig files.  Every resolved credential, listed page, watch event,
fixture, packed snapshot and error (class name and message) must be equal.
"""

import base64
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import yaml

from kubernetesclustercapacity_tpu import kubeapi as jk
from kubernetesclustercapacity_tpu import snapshot as j_snapshot
from kubernetesclustercapacity_tpu.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu_torch import kubeapi as tk
from kubernetesclustercapacity_tpu_torch import snapshot as t_snapshot

from test_kubeapi import MockApiserver, _k8s_node, _k8s_pod, _write_kubeconfig

NODES, PODS = "/api/v1/nodes", "/api/v1/pods"
_CONFIG_FIELDS = ("server", "ca_pem", "insecure", "client_cert_pem",
                  "client_key_pem", "token", "username", "password")


@pytest.fixture()
def cluster():
    fixture = synthetic_fixture(
        23, seed=7, unhealthy_frac=0.1, unscheduled_running_pods=2
    )
    fixture["pdbs"] = [{"name": "db", "namespace": "default",
                        "selector": {"matchLabels": {"app": "db"}},
                        "minAvailable": 1}]
    srv = MockApiserver(fixture, require_token="sekrit")
    yield fixture, srv
    srv.close()


def _config_view(cfg) -> dict:
    return {f: getattr(cfg, f) for f in _CONFIG_FIELDS} | {
        "auth_headers": cfg.auth_headers()
    }


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 - compared below
        return (type(e).__name__, str(e))


def _both_load(path, context=None):
    j = _outcome(jk.KubeConfig.load, path, context=context)
    t = _outcome(tk.KubeConfig.load, path, context=context)
    assert j[0] == t[0], (j, t)
    if j[0] == "ok":
        assert _config_view(t[1]) == _config_view(j[1])
        return t[1]
    assert t[1] == j[1]
    return None


def _exec_user(token: str) -> dict:
    return {"exec": {
        "apiVersion": "client.authentication.k8s.io/v1",
        "command": sys.executable,
        "args": ["-c", "import json, os; print(json.dumps({'kind': "
                 "'ExecCredential', 'status': {'token': "
                 f"'{token}' + os.environ['KCCAP_TEST_SUFFIX']}}}}))"],
        "env": [{"name": "KCCAP_TEST_SUFFIX", "value": "-plugin"}],
    }}


@pytest.mark.parametrize("user", [
    {"token": "abc"},
    {"username": "u", "password": "p"},
    {},
    _exec_user("exectok"),
    {"exec": {"command": sys.executable, "args": ["-c", "print('{}')"]}},
    {"exec": {"command": "/nonexistent/kccap-plugin"}},
    {"client-certificate-data": base64.b64encode(b"CERT").decode()},
    {"client-certificate-data": base64.b64encode(b"CERT").decode(),
     "client-key-data": base64.b64encode(b"KEY").decode()},
    {"client-certificate-data": "!!not base64!!"},
    {"auth-provider": {"name": "gcp"}},
    {"auth-provider": {"name": "oidc", "config": {}}},
], ids=["token", "basic", "anonymous", "exec", "exec-no-token",
        "exec-missing", "cert-without-key", "cert-and-key", "bad-base64",
        "legacy-provider", "oidc-no-refresh"])
def test_kubeconfig_users_resolve_like_jax(user, tmp_path):
    _both_load(_write_kubeconfig(tmp_path, "https://10.0.0.1:6443/", user))


def test_token_file_and_file_paths_resolve_like_jax(tmp_path):
    tok = tmp_path / "tok"
    tok.write_text("filetoken\n")
    crt, key, ca = (tmp_path / n for n in ("c.pem", "k.pem", "ca.pem"))
    crt.write_bytes(b"CERT")
    key.write_bytes(b"KEY")
    ca.write_bytes(b"CA")
    path = _write_kubeconfig(tmp_path, "https://x", {
        "tokenFile": str(tok), "client-certificate": str(crt),
        "client-key": str(key),
    })
    doc = yaml.safe_load(open(path))
    doc["clusters"][0]["cluster"]["certificate-authority"] = str(ca)
    doc["clusters"][0]["cluster"]["insecure-skip-tls-verify"] = True
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)
    cfg = _both_load(path)
    assert (cfg.token, cfg.ca_pem, cfg.insecure) == ("filetoken", b"CA", True)
    missing = _write_kubeconfig(tmp_path, "https://x",
                                {"tokenFile": str(tmp_path / "gone")})
    assert _both_load(missing) is None


def test_contexts_and_merged_kubeconfigs_resolve_like_jax(tmp_path,
                                                          monkeypatch):
    doc = {
        "current-context": "a",
        "contexts": [
            {"name": "a", "context": {"cluster": "ca", "user": "ua"}},
            {"name": "b", "context": {"cluster": "cb", "user": "ub"}},
            {"name": "c", "context": {"cluster": "cb"}},
            {"name": "d", "context": {"cluster": "nowhere", "user": "ua"}},
        ],
        "clusters": [{"name": "ca", "cluster": {"server": "https://a"}},
                     {"name": "cb", "cluster": {"server": "http://b:80"}}],
        "users": [{"name": "ua", "user": {"token": "ta"}},
                  {"name": "ub", "user": {"token": "tb"}}],
    }
    path = tmp_path / "kc"
    path.write_text(yaml.safe_dump(doc))
    for context in (None, "a", "b", "c", "d", "missing"):
        _both_load(str(path), context)
    assert _both_load(str(tmp_path / "nope")) is None
    second = tmp_path / "kc2"
    second.write_text(yaml.safe_dump({
        "current-context": "b",
        "users": [{"name": "ub", "user": {"token": "shadowed"}}],
    }))
    monkeypatch.setenv("KUBECONFIG", os.pathsep.join(
        [str(second), str(tmp_path / "absent"), str(path)]))
    cfg = _both_load(None)
    assert cfg.token == "shadowed" and cfg.server == "http://b:80"
    monkeypatch.delenv("KUBECONFIG")
    monkeypatch.setenv("HOME", str(tmp_path))
    assert tk.default_kubeconfig_paths() == jk.default_kubeconfig_paths()


@pytest.mark.skipif(shutil.which("openssl") is None, reason="needs openssl")
def test_ssl_contexts_load_the_same_certificates(tmp_path):
    key, crt = tmp_path / "k.pem", tmp_path / "c.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(crt), "-days", "1",
         "-subj", "/CN=kccap-test"],
        check=True, capture_output=True,
    )
    modes = []
    for mod in (jk, tk):
        ctx = mod.KubeConfig(
            "https://x", ca_pem=crt.read_bytes(),
            client_cert_pem=crt.read_bytes(), client_key_pem=key.read_bytes(),
        ).ssl_context()
        insecure = mod.KubeConfig("https://x", insecure=True).ssl_context()
        modes.append((ctx.verify_mode.name, ctx.check_hostname,
                      insecure.verify_mode.name, insecure.check_hostname))
    assert modes[0] == modes[1] == ("CERT_REQUIRED", True, "CERT_NONE", False)


def _clients(srv, token="sekrit"):
    server = f"http://127.0.0.1:{srv.port}"
    return (jk.KubeClient(jk.KubeConfig(server, token=token)),
            tk.KubeClient(tk.KubeConfig(server, token=token)))


@pytest.mark.parametrize("limit", [25, 500])
def test_pagination_lists_the_same_pages(cluster, limit):
    _, srv = cluster
    j, t = _clients(srv)
    for path in (NODES, PODS, jk.PDB_PATH):
        srv._rv = 100
        j_items, j_rv = j.list_with_version(path, limit=limit)
        srv._rv = 100
        t_items, t_rv = t.list_with_version(path, limit=limit)
        assert t_items == j_items and t_rv == j_rv
        assert list(t.list_all(path, limit=limit)) == j_items
    for c in (j, t):
        c.close()


def test_watch_events_stream_the_same_events(cluster):
    fixture, srv = cluster
    events = [
        {"type": "ADDED", "object": _k8s_pod(dict(fixture["pods"][0],
                                                  name="new"))},
        {"type": "BOOKMARK", "object": {"metadata": {"resourceVersion": "9"}}},
        {"type": "MODIFIED", "object": _k8s_node(fixture["nodes"][1])},
        {"type": "ERROR", "object": {"code": 410, "message": "gone"}},
    ]
    srv.watch_streams = {PODS: [list(events), list(events)]}
    j, t = _clients(srv)
    got = [list(c.watch_events(PODS, resource_version="5")) for c in (j, t)]
    assert got[0] == got[1] == events
    watches = [r for r in srv.requests if "watch=1" in r]
    assert len(watches) == 2 and watches[0] == watches[1]
    assert "resourceVersion=5" in watches[0]
    outcomes = [_outcome(lambda c=c: list(c.watch_events(NODES)))
                for c in _clients(srv, token="wrong")]
    assert outcomes[0] == outcomes[1] and outcomes[0][0] == "KubeAPIError"


@pytest.mark.parametrize("token,page_limit", [("sekrit", 40), ("wrong", 500)])
def test_live_fixture_and_packing_match_jax(cluster, tmp_path, token,
                                            page_limit):
    _, srv = cluster
    path = _write_kubeconfig(tmp_path, f"http://127.0.0.1:{srv.port}",
                             {"token": token})
    j = _outcome(jk.live_fixture, path, page_limit=page_limit)
    t = _outcome(tk.live_fixture, path, page_limit=page_limit)
    assert t == j
    if token != "sekrit":
        assert t[0] == "KubeAPIError"
        return
    assert t[1]["pdbs"] and len(t[1]["nodes"]) == 23
    for semantics in ("reference", "strict"):
        js = j_snapshot.snapshot_from_live_cluster(path, semantics=semantics)
        ts = t_snapshot.snapshot_from_live_cluster(path, semantics=semantics)
        assert ts.names == js.names and ts.node_log == js.node_log
        for col in (*t_snapshot.COLUMNS, "healthy"):
            np.testing.assert_array_equal(getattr(ts, col),
                                          getattr(js, col))


def test_live_fixture_through_a_given_client(cluster):
    _, srv = cluster
    j, t = _clients(srv)
    assert tk.live_fixture(client=t) == jk.live_fixture(client=j)
    # A 404 policy API degrades to a budget-less fixture in both.
    del srv.items[jk.PDB_PATH]
    got = [mod.live_fixture(client=c) for mod, c in ((jk, j), (tk, t))]
    assert got[0] == got[1] and "pdbs" not in got[1]
    for c in (j, t):
        c.close()


def test_object_conversions_match_jax():
    node = {"metadata": {"name": "n", "labels": {"a": "b"}},
            "spec": {"taints": [{"key": "k", "effect": "NoSchedule"}]},
            "status": {"allocatable": {"cpu": 4, "memory": "1Gi"},
                       "conditions": [{"type": "Ready", "status": "True",
                                       "reason": "x"}]}}
    pod = {"metadata": {"name": "p", "namespace": "ns"},
           "spec": {"nodeName": None, "priority": 7,
                    "containers": [{"resources": {"requests": {"cpu": "1"}}}],
                    "initContainers": None},
           "status": {}}
    pdb = {"metadata": {"name": "b"},
           "spec": {"maxUnavailable": "25%", "minAvailable": None}}
    assert tk.node_to_fixture(node) == jk.node_to_fixture(node)
    assert tk.pod_to_fixture(pod) == jk.pod_to_fixture(pod)
    assert tk.pdb_to_fixture(pdb) == jk.pdb_to_fixture(pdb)
    assert json.dumps(tk.pod_to_fixture({})) == json.dumps(
        jk.pod_to_fixture({}))


def test_bad_server_schemes_and_refused_connections_match_jax():
    for server in ("ftp://x", "http://127.0.0.1:1"):
        outcomes = []
        for mod in (jk, tk):
            outcomes.append(_outcome(
                lambda m=mod: m.KubeClient(m.KubeConfig(server))
                .get_json(NODES)))
        assert outcomes[0][0] == outcomes[1][0]
        assert outcomes[0][0] in ("KubeConfigError", "KubeAPIError")
