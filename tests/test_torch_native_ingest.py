"""The port's native columnar pod walk, and ``kccap-client`` against a
port server, on the CPU.

The walk (``native/ingest.cc``, built by the port's own loader) must be
invisible: the port's packers give the same columns with it and with
``KCC_DISABLE_NATIVE_INGEST=1``, and the JAX packer's columns, on the
randomized fixtures of ``tests/test_native_ingest.py``; malformed
fixtures raise the same exceptions either way (the walk reports input
that is not JSON-shaped and the packers rerun the pure loop).
``snapshot.NATIVE_WALKS`` says which loop ran.  The compiled front end
(``native/kccap_client.cc``) prints what the port's CLI prints, as
``tests/test_service.py::TestNativeClient`` holds it against the JAX
CLI.  Skipped only where ``g++`` is missing.

Tolerance: none (columns and text equal).
"""

import json
import os
import subprocess

import numpy as np
import pytest

from kubernetesclustercapacity_tpu.fixtures import (
    synthetic_fixture as j_fixture,
)
from kubernetesclustercapacity_tpu.snapshot import (
    snapshot_from_fixture as j_pack,
)
from kubernetesclustercapacity_tpu_torch import snapshot as t_snapshot
from kubernetesclustercapacity_tpu_torch.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu_torch.native import ingest
from kubernetesclustercapacity_tpu_torch.snapshot import snapshot_from_fixture

KIND = "tests/fixtures/kind-3node.json"
_FIELDS = (
    "alloc_cpu_milli", "alloc_mem_bytes", "alloc_pods",
    "used_cpu_req_milli", "used_cpu_lim_milli",
    "used_mem_req_bytes", "used_mem_lim_bytes",
    "pods_count", "healthy",
)
NODE = {
    "name": "n0",
    "allocatable": {"cpu": "4", "memory": "8388608Ki", "pods": "10"},
    "conditions": [{"type": "c", "status": "False"}] * 4,
}


@pytest.fixture(autouse=True)
def toolchain():
    if not ingest.available():
        pytest.skip("no C++ toolchain for the native walk")


def _walks():
    return dict(t_snapshot.NATIVE_WALKS)


def _pack_both(fixture, monkeypatch, **kw):
    """Pack with the native walk and with it disabled; returns the pair
    and the native walks each took."""
    before = _walks()
    native = snapshot_from_fixture(fixture, **kw)
    mid = _walks()
    with monkeypatch.context() as m:
        m.setenv("KCC_DISABLE_NATIVE_INGEST", "1")
        pure = snapshot_from_fixture(fixture, **kw)
    after = _walks()
    sem = kw.get("semantics", "reference")
    return native, pure, mid[sem] - before[sem], after[sem] - mid[sem]


def _assert_columns_equal(a, b):
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert set(a.extended) == set(b.extended)
    for r in a.extended:
        np.testing.assert_array_equal(a.extended[r][0], b.extended[r][0])
        np.testing.assert_array_equal(a.extended[r][1], b.extended[r][1])


def _assert_equal(fixture, monkeypatch, *, walked=1, **kw):
    native, pure, n_native, n_pure = _pack_both(fixture, monkeypatch, **kw)
    _assert_columns_equal(native, pure)
    _assert_columns_equal(native, j_pack(fixture, **kw))
    assert (n_native, n_pure) == (walked, 0)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("semantics", ["reference", "strict"])
def test_randomized(seed, semantics, monkeypatch):
    kw = dict(unhealthy_frac=0.2, unparseable_mem_frac=0.1,
              unscheduled_running_pods=3, taint_frac=0.1)
    fx = synthetic_fixture(40, seed=seed, **kw)
    assert fx == j_fixture(40, seed=seed, **kw)
    # De-intern so the native walk sees production-unique objects.
    _assert_equal(json.loads(json.dumps(fx)), monkeypatch,
                  semantics=semantics)


def test_extended_resources(monkeypatch):
    fx = synthetic_fixture(20, seed=7)
    fx["nodes"][0]["allocatable"]["nvidia.com/gpu"] = "8"
    pod = fx["pods"][0]
    fx["pods"][0] = dict(pod, containers=[
        {"resources": {"requests": {"cpu": "1", "nvidia.com/gpu": "2"}}}
    ])
    _assert_equal(fx, monkeypatch, semantics="strict",
                  extended_resources=("nvidia.com/gpu", "ephemeral-storage"))


def test_explicit_null_and_missing_fields(monkeypatch):
    fx = {
        "nodes": [NODE],
        "pods": [
            {"name": "a", "namespace": "d", "nodeName": "n0",
             "phase": "Running", "containers": [{}]},
            {"name": "b", "namespace": "d", "nodeName": "n0",
             "phase": "Running",
             "containers": [
                 {"resources": {}},
                 {"resources": {"requests": {"cpu": "100m"}}},
                 {"resources": {"limits": {"memory": "64Mi"}}},
             ]},
            {"name": "c", "namespace": "d", "nodeName": "n0",
             "containers": [{"resources": {"requests": {"memory": None}}}]},
            {"name": "d", "namespace": "d", "nodeName": "n0",
             "phase": "Running"},
        ],
    }
    _assert_equal(fx, monkeypatch, semantics="reference")
    _assert_equal(fx, monkeypatch, semantics="strict")


def test_phantom_grouping_and_duplicate_names(monkeypatch):
    """Orphan pods group under the phantom '' name; duplicate node names
    share one usage group — both survive the native walk."""
    def node(nm, unhealthy):
        return dict(NODE, name=nm, conditions=(
            [{"type": "c", "status": "True"}]
            + [{"type": "c", "status": "False"}] * 3
            if unhealthy else NODE["conditions"]))

    def pod(nm, node_name):
        return {"name": nm, "namespace": "d", "nodeName": node_name,
                "phase": "Running",
                "containers": [{"resources": {"requests": {"cpu": "250m"}}}]}

    fx = {"nodes": [node("dup", False), node("x", True), node("dup", False)],
          "pods": [pod("p1", "dup"), pod("p2", ""), pod("p3", "dup")]}
    _assert_equal(fx, monkeypatch, semantics="reference")


def test_non_list_containers_falls_back(monkeypatch):
    # containers as a tuple: the native walk reports None and the pure
    # loop (tuples iterate fine) packs it; the counter shows the fallback.
    fx = {"nodes": [NODE], "pods": [
        {"name": "a", "namespace": "d", "nodeName": "n0", "phase": "Running",
         "containers": ({"resources": {"requests": {"cpu": "1"}}},)}]}
    assert ingest.walk_reference(fx["pods"], frozenset()) is None
    _assert_equal(fx, monkeypatch, walked=0, semantics="reference")
    _assert_equal(fx, monkeypatch, walked=0, semantics="strict")


def test_non_string_node_name_skips_like_pure(monkeypatch):
    # The strict walk reports a non-string nodeName and the pure loop
    # skips the pod.
    fx = {"nodes": [NODE], "pods": [
        {"name": "a", "namespace": "d", "nodeName": 123, "phase": "Running",
         "containers": [{"resources": {"requests": {"cpu": "1"}}}]}]}
    _assert_equal(fx, monkeypatch, walked=0, semantics="strict")


@pytest.mark.parametrize("pod,exc", [
    ({"containers": [{"resources": None}]}, AttributeError),
    ({"phase": ["not-hashable"], "containers": []}, TypeError),
])
@pytest.mark.parametrize("disable", [False, True])
def test_malformed_fixtures_raise_as_the_jax_packer_does(pod, exc, disable,
                                                         monkeypatch):
    fx = {"nodes": [NODE], "pods": [dict(
        {"name": "a", "namespace": "d", "nodeName": "n0",
         "phase": "Running"}, **pod)]}
    if disable:
        monkeypatch.setenv("KCC_DISABLE_NATIVE_INGEST", "1")
    with pytest.raises(exc) as t_err:
        snapshot_from_fixture(fx, semantics="reference")
    with pytest.raises(exc) as j_err:
        j_pack(fx, semantics="reference")
    assert str(t_err.value) == str(j_err.value)


def test_disabled_walk_is_not_loaded(monkeypatch):
    monkeypatch.setenv("KCC_DISABLE_NATIVE_INGEST", "1")
    assert not ingest.available()


def test_extension_is_the_ports_own_build():
    from kubernetesclustercapacity_tpu.native import ingest as j_ingest
    from kubernetesclustercapacity_tpu_torch.native import _build_util

    mod = ingest._load()
    assert mod.__file__.startswith(_build_util.BUILD_DIR)
    assert mod.__file__.endswith(ingest._so_name())
    assert j_ingest._load() is not mod


# ---------------------------------------------------------------------------
# kccap-client against the port's server
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def client_bin(tmp_path_factory):
    src = os.path.join("kubernetesclustercapacity_tpu_torch", "native",
                       "kccap_client.cc")
    out = str(tmp_path_factory.mktemp("bin") / "kccap-client")
    try:
        subprocess.run(["g++", "-O2", "-std=c++17", "-o", out, src],
                       check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        pytest.skip("no C++ toolchain")
    return out


@pytest.fixture(scope="module")
def servers():
    """A port server and a JAX server on kind-3node, reference semantics."""
    from kubernetesclustercapacity_tpu.service.server import (
        CapacityServer as JaxServer,
    )
    from kubernetesclustercapacity_tpu_torch.fixtures import load_fixture
    from kubernetesclustercapacity_tpu_torch.service.server import (
        CapacityServer,
    )

    fixture = load_fixture(KIND)
    port = CapacityServer(snapshot_from_fixture(fixture), port=0,
                          fixture=fixture, device="cpu")
    jax = JaxServer(j_pack(fixture), port=0, fixture=fixture)
    port.start()
    jax.start()
    yield port, jax
    port.shutdown()
    jax.shutdown()


def _client(client_bin, server, flags):
    host, port = server.address
    return subprocess.run([client_bin, "-server", f"{host}:{port}", *flags],
                          capture_output=True, text=True, timeout=60)


@pytest.mark.parametrize("flags", [
    ["-replicas=5"],
    ["-cpuRequests=200m", "-cpuLimits=400m", "-memRequests=250mb",
     "-memLimits=500mb", "-replicas=10"],
    ["-cpuRequests=2", "-memRequests=1gb", "-replicas=1000", "-output",
     "json"],
    ["-replicas=3", "-output", "table"],
])
def test_kccap_client_matches_the_port_cli(flags, servers, client_bin,
                                           capsys):
    """The client prints the server's rendering verbatim: against the port
    server it prints what the JAX server sends it, and the port CLI's
    output (which ``print`` ends with a newline for json and table)."""
    from kubernetesclustercapacity_tpu_torch.cli import main

    port_server, jax_server = servers
    proc = _client(client_bin, port_server, flags)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == _client(client_bin, jax_server, flags).stdout
    assert main(["-snapshot", KIND, *flags, "-device", "cpu"]) == 0
    out = capsys.readouterr().out
    if "-output" in flags:
        out = out.removesuffix("\n")
    assert proc.stdout == out


def test_kccap_client_error_path(servers, client_bin):
    proc = _client(client_bin, servers[0], ["-memRequests=bogus"])
    assert proc.returncode == 1
    assert "ERROR" in proc.stderr
