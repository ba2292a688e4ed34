"""The port's ``-grid`` CLI against the JAX CLI: the same JSON and table
output, byte for byte apart from the kernel label, on a fixture and on
``.npz`` checkpoints in both semantics, with and without
``-extended-request`` (the R-resource sweep), and the same error lines."""

import dataclasses
import json
import re

import numpy as np
import pytest

from kubernetesclustercapacity_tpu import cli as j_cli
from kubernetesclustercapacity_tpu import snapshot as j_snapshot
from kubernetesclustercapacity_tpu.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu.telemetry import phases as j_phases
from kubernetesclustercapacity_tpu_torch import cli as t_cli
from kubernetesclustercapacity_tpu_torch.telemetry import phases as t_phases

KIND = "tests/fixtures/kind-3node.json"


def _label(name):
    return name.replace("pallas_", "plain_").replace("xla_int64", "torch_int64")


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.fixture(scope="module")
def npz_sources(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    ref = str(d / "synthetic.npz")
    j_snapshot.synthetic_snapshot(3000, seed=3).save(ref)
    strict = str(d / "tainted.npz")
    fx = synthetic_fixture(400, seed=4, taint_frac=0.3, unhealthy_frac=0.1)
    j_snapshot.snapshot_from_fixture(fx, semantics="strict").save(strict)
    inel = str(d / "unquantized.npz")
    j_snapshot.synthetic_snapshot(500, seed=5, kib_quantized=False).save(inel)
    gpu_fx = _with_extended(synthetic_fixture(300, seed=6, taint_frac=0.2,
                                              unhealthy_frac=0.1))
    gpu_json = str(d / "gpu.json")
    with open(gpu_json, "w") as f:
        json.dump(gpu_fx, f)
    gpu_npz = str(d / "gpu.npz")
    j_snapshot.snapshot_from_fixture(
        gpu_fx, semantics="strict", extended_resources=EXTENDED,
    ).save(gpu_npz)
    return {"synthetic": ref, "tainted": strict, "unquantized": inel,
            "gpu_json": gpu_json, "gpu_npz": gpu_npz}


EXTENDED = ("ephemeral-storage", "nvidia.com/gpu")


def _with_extended(fx):
    """GPUs (0-8) and ephemeral storage (50-500 Gi) on every node, and
    requests for them on some pods."""
    rng = np.random.default_rng(7)
    for node in fx["nodes"]:
        node["allocatable"]["nvidia.com/gpu"] = str(rng.integers(0, 9))
        node["allocatable"]["ephemeral-storage"] = \
            f"{rng.integers(50, 501)}Gi"
    for pod in fx["pods"][::3]:
        pod["containers"] = [{"resources": {"requests": {
            "cpu": "250m", "memory": "256Mi",
            "nvidia.com/gpu": str(rng.integers(0, 3)),
            "ephemeral-storage": f"{rng.integers(1, 20)}Gi",
        }}}]
    return fx


SOURCES = [
    ("kind", ["-semantics", "reference"]),
    ("kind", ["-semantics", "strict"]),
    ("kind", []),
    ("synthetic", []),
    ("synthetic", ["-semantics", "reference", "-kernel", "exact"]),
    ("tainted", ["-semantics", "strict"]),
    ("unquantized", ["-seed", "9"]),
]


def _path(name, npz_sources):
    return KIND if name == "kind" else npz_sources[name]


@pytest.mark.parametrize("source,extra", SOURCES)
def test_grid_json_matches_jax(source, extra, npz_sources, capsys):
    argv = ["-snapshot", _path(source, npz_sources), "-grid", "64",
            "-output", "json", *extra]
    j_rc, j_out = _run(j_cli.main, argv, capsys)
    t_rc, t_out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
    assert j_rc == t_rc == 0
    j_doc, t_doc = json.loads(j_out), json.loads(t_out)
    assert t_doc.pop("kernel") == _label(j_doc.pop("kernel"))
    assert t_doc == j_doc
    # Byte for byte once the label is aligned.
    assert t_out == j_out.replace(
        json.loads(j_out)["kernel"], json.loads(t_out)["kernel"]
    )


@pytest.mark.parametrize("source,extra", SOURCES[:2] + SOURCES[5:6])
def test_grid_table_matches_jax(source, extra, npz_sources, capsys):
    argv = ["-snapshot", _path(source, npz_sources), "-grid", "64",
            "-output", "table", *extra]
    j_rc, j_out = _run(j_cli.main, argv, capsys)
    t_rc, t_out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
    assert j_rc == t_rc == 0
    j_lines, t_lines = j_out.splitlines(), t_out.splitlines()
    assert t_lines[:-1] == j_lines[:-1]
    j_kernel = j_lines[-1].split()[1]
    assert t_lines[-1] == j_lines[-1].replace(j_kernel, _label(j_kernel))


@pytest.mark.parametrize(
    "argv",
    [
        ["-memRequests", "1073741824"],
        ["-memLimits", "16Gi"],
        ["-replicas", "ten"],
        ["-replicas=99999999999999999999"],
        ["-snapshot", "tests/fixtures/missing.json"],
    ],
)
def test_error_lines_match_jax(argv, capsys):
    argv = argv + ["-grid", "4"]
    if "-snapshot" not in argv:
        argv += ["-snapshot", KIND]
    j_rc, j_out = _run(j_cli.main, argv, capsys)
    t_rc, t_out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
    assert j_rc == t_rc == 1
    assert t_out == j_out


@pytest.mark.parametrize("backend", ["cpu", "native"])
@pytest.mark.parametrize("extra", [[], ["-extended-request",
                                       "nvidia.com/gpu=1"]])
def test_grid_rejects_the_cpu_backend_like_jax(extra, backend, npz_sources,
                                               capsys):
    # The sequential oracle and the C++ loop are single-spec cross-checks
    # in both packages; only the device backend's name differs.
    argv = ["-snapshot", npz_sources["gpu_npz"], "-grid", "4", *extra,
            "-backend", backend]
    j_rc, j_out = _run(j_cli.main, argv, capsys)
    t_rc, t_out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
    assert j_rc == t_rc == 1
    assert j_out.startswith("ERROR : -grid sweeps run on the TPU kernels")
    assert t_out == (
        "ERROR : -grid sweeps run on the device programs (-backend torch); "
        "cpu/native backends are single-spec cross-checks ...exiting\n"
    )


def test_semantics_conflict_matches_jax(npz_sources, capsys):
    argv = ["-snapshot", npz_sources["tainted"], "-semantics", "reference",
            "-grid", "4"]
    j_rc, j_out = _run(j_cli.main, argv, capsys)
    t_rc, t_out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
    assert j_rc == t_rc == 1
    assert t_out == j_out


@pytest.mark.parametrize(
    "argv,want_rc",
    [
        # -backend native, -trace-tree and -fed-status are ported: each
        # runs as the JAX CLI does on the same command line (the C++ loop's
        # transcript; the other two refuse with exit 1).
        (["-snapshot", KIND, "-backend", "native"], 0),
        (["-snapshot", KIND, "-trace-tree", "ab" * 16], 1),
        (["-snapshot", KIND, "-fed-status", "127.0.0.1:1", "-grid", "4"], 1),
    ],
)
def test_unported_surfaces_say_so(argv, want_rc, capsys):
    outs = []
    for main, extra in ((j_cli.main, []),
                        (t_cli.main, ["-device", "cpu"])):
        rc = main(argv + extra)
        outs.append((rc, *capsys.readouterr()))
    assert outs[0] == outs[1] and outs[0][0] == want_rc
    assert "not yet ported" not in str(outs[1])


def _comparable_dump(out, output):
    """A ``-dump`` rendering with what differs between two servers' rings
    taken out.  Each dump is the one before it in the next dump's ring;
    its latency, timestamp, phase times and result digest are volatile.
    The port's own phases (``lock_wait`` rides every dispatch) have no
    JAX twin, so they go, and then a phases field or line left empty;
    every phase name the two packages share is still compared."""
    port_only = set(t_phases.PHASES) - set(j_phases.PHASES)
    if output == "json":
        doc = json.loads(out)
        for rec in doc["records"]:
            for key in ("ts", "latency_ms", "result_digest"):
                rec.pop(key, None)
            shared = sorted(p for p in rec.pop("phases", {})
                            if p not in port_only)
            if shared:
                rec["phases"] = shared
        return json.dumps(doc, indent=2, sort_keys=True)
    lines = []
    for line in out.splitlines():
        head, sep, cell = line.partition("phases: ")
        if sep and not head.strip():
            shared = sorted(p for p in (f.partition("=")[0]
                                        for f in cell.split())
                            if p not in port_only)
            if not shared:
                continue
            line = head + sep + " ".join(shared)
        lines.append(re.sub(r"\s+[0-9.]+ms", "", line))
    return "\n".join(lines)


@pytest.mark.parametrize("flag", ["-slo-status", "-dump", "-timeline"])
@pytest.mark.parametrize("output", ["table", "json"])
def test_operator_surfaces_match_jax(flag, output, capsys):
    """-slo-status, -dump and -timeline (which answered "not yet ported"
    until they were) against a JAX and a port server without -slo or
    -watch: both CLIs render the same text and exit alike (1 for the
    disabled SLO and timeline views, 0 for the flight recorder)."""
    from kubernetesclustercapacity_tpu.service.server import (
        CapacityServer as JaxServer,
    )
    from kubernetesclustercapacity_tpu_torch.service.server import (
        CapacityServer as TorchServer,
    )
    from kubernetesclustercapacity_tpu_torch.snapshot import (
        synthetic_snapshot as t_synthetic,
    )

    servers = [JaxServer(j_snapshot.synthetic_snapshot(16, seed=1)),
               TorchServer(t_synthetic(16, seed=1), device="cpu")]
    for s in servers:
        s.start()
    try:
        outs = []
        for main in (j_cli.main, t_cli.main):
            for server in servers:
                addr = f"{server.address[0]}:{server.address[1]}"
                outs.append(_run(main, [flag, addr, "-output", output],
                                 capsys))
    finally:
        for s in servers:
            s.shutdown()
    if flag == "-dump":
        outs = [(rc, _comparable_dump(out, output)) for rc, out in outs]
        assert outs[0] == outs[1] and outs[2] == outs[3]
        assert outs[0][0] == 0
    else:
        assert all(o == outs[0] for o in outs)
        assert outs[0][0] == 1
    assert "not yet ported" not in outs[0][1]


@pytest.mark.parametrize("extra", [["-semantics", "strict"], []],
                         ids=["strict", "reference"])
def test_drain_is_ported(extra, capsys):
    """-drain answers as the JAX CLI does, byte for byte: the rehoming plan
    under strict semantics, the strict-only error line otherwise."""
    argv = ["-snapshot", KIND, "-drain", "kind-worker", *extra]
    j_rc, j_out = _run(j_cli.main, argv, capsys)
    t_rc, t_out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
    assert (t_rc, t_out) == (j_rc, j_out)
    assert "not yet ported" not in t_out


@pytest.mark.parametrize("extra", [[], ["-semantics", "strict"],
                                   ["-extended-request", "nvidia.com/gpu=1"]],
                         ids=["reference", "strict", "extended-reference"])
def test_live_source_without_snapshot_is_ported(extra, tmp_path, capsys):
    """No -snapshot: the port lists the live cluster of -kubeconfig as the
    JAX CLI does (here a missing file, so both print the same error and
    hint lines); it never answers "not yet ported"."""
    argv = ["-kubeconfig", str(tmp_path / "absent"), "-grid", "4", *extra]
    j_rc, j_out = _run(j_cli.main, argv, capsys)
    t_rc, t_out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
    assert j_rc == t_rc == 1
    assert t_out == j_out
    assert "not yet ported" not in t_out
    if extra[:1] == ["-extended-request"]:
        assert t_out.startswith("ERROR : extended resources require strict")
    else:
        assert t_out.startswith("ERROR : cannot snapshot live cluster: ")
        assert t_out.splitlines()[1].startswith("hint: ")


EXT_SOURCES = [
    ("gpu_json", ["-semantics", "strict",
                  "-extended-request", "nvidia.com/gpu=2"]),
    ("gpu_json", ["-semantics", "strict",
                  "-extended-request", "nvidia.com/gpu=1",
                  "-extended-request", "ephemeral-storage=10Gi"]),
    ("gpu_npz", ["-extended-request", "nvidia.com/gpu=1",
                 "-extended-request", "ephemeral-storage=10Gi"]),
    ("gpu_npz", ["-extended-request", "ephemeral-storage=10Gi",
                 "-kernel", "exact", "-seed", "4"]),
    ("gpu_npz", ["-extended-request", "nvidia.com/gpu=0"]),
    ("gpu_npz", ["-extended-resources", "nvidia.com/gpu"]),
]


@pytest.mark.parametrize("source,extra", EXT_SOURCES)
def test_grid_extended_json_matches_jax(source, extra, npz_sources, capsys):
    argv = ["-snapshot", npz_sources[source], "-grid", "64",
            "-output", "json", *extra]
    j_rc, j_out = _run(j_cli.main, argv, capsys)
    t_rc, t_out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
    assert j_rc == t_rc == 0
    j_doc, t_doc = json.loads(j_out), json.loads(t_out)
    assert t_doc.pop("kernel") == _label(j_doc.pop("kernel"))
    assert t_doc == j_doc
    assert t_out == j_out.replace(
        json.loads(j_out)["kernel"], json.loads(t_out)["kernel"]
    )


@pytest.mark.parametrize("source,extra", EXT_SOURCES[1:3])
def test_grid_extended_table_matches_jax(source, extra, npz_sources, capsys):
    argv = ["-snapshot", npz_sources[source], "-grid", "64",
            "-output", "table", *extra]
    j_rc, j_out = _run(j_cli.main, argv, capsys)
    t_rc, t_out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
    assert j_rc == t_rc == 0
    j_lines, t_lines = j_out.splitlines(), t_out.splitlines()
    assert t_lines[:-1] == j_lines[:-1]
    j_kernel = j_lines[-1].split()[1]
    assert j_kernel.startswith("pallas_multi_")
    assert t_lines[-1] == j_lines[-1].replace(j_kernel, _label(j_kernel))


def test_grid_extended_on_the_gpu_fixture(tmp_path, capsys):
    # tests/test_cli_report.py::TestExtendedRequestsCLI's fixture.
    fx = synthetic_fixture(8, seed=13)
    for n in fx["nodes"]:
        n["allocatable"]["nvidia.com/gpu"] = "4"
    path = str(tmp_path / "gpu.json")
    with open(path, "w") as f:
        json.dump(fx, f)
    for extra in (["-grid", "6"], ["-grid", "5", "-seed", "3"]):
        argv = ["-snapshot", path, "-semantics", "strict",
                "-extended-request", "nvidia.com/gpu=2", "-output", "json",
                *extra]
        j_rc, j_out = _run(j_cli.main, argv, capsys)
        t_rc, t_out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
        assert j_rc == t_rc == 0
        j_doc, t_doc = json.loads(j_out), json.loads(t_out)
        assert t_doc.pop("kernel") == _label(j_doc.pop("kernel"))
        assert t_doc == j_doc
        assert t_doc["extended_requests"] == {"nvidia.com/gpu": 2}


@pytest.mark.parametrize(
    "source,extra",
    [
        ("gpu_json", ["-semantics", "strict",
                      "-extended-request", "nvidia.com/gpu=not-a-qty"]),
        ("gpu_json", ["-semantics", "strict",
                      "-extended-request", "nvidia.com/gpu=-1"]),
        ("gpu_json", ["-semantics", "strict",
                      "-extended-request", "nvidia.com/gpu"]),
        ("gpu_json", ["-extended-request", "nvidia.com/gpu=1"]),
        ("tainted", ["-extended-request", "nvidia.com/gpu=1"]),
        ("gpu_npz", ["-extended-request", "example.com/fpga=1"]),
    ],
    ids=["bad-quantity", "negative-quantity", "no-equals",
         "reference-fixture", "npz-missing-column", "npz-unknown-column"],
)
def test_extended_error_lines_match_jax(source, extra, npz_sources, capsys):
    argv = ["-snapshot", npz_sources[source], "-grid", "4", *extra]
    j_rc, j_out = _run(j_cli.main, argv, capsys)
    t_rc, t_out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
    assert j_rc == t_rc == 1
    assert t_out == j_out
    assert t_out.startswith("ERROR")


def test_extended_request_without_grid_says_not_ported(npz_sources, capsys):
    # The single-spec extended-request report is ported now: it prints the
    # JAX CLI's report (through CapacityModel.evaluate) in every format.
    for output in ("reference", "json", "table"):
        argv = ["-snapshot", npz_sources["gpu_npz"],
                "-extended-request", "nvidia.com/gpu=1",
                "-extended-request", "ephemeral-storage=10Gi",
                "-output", output]
        j_rc, j_out = _run(j_cli.main, argv, capsys)
        t_rc, t_out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
        assert j_rc == t_rc == 0
        assert t_out == j_out
        assert "not yet ported" not in t_out


# Fault C1: every flag of the JAX CLI is known to the port's parser.  The
# port runs it (-save-snapshot, -group-min-count), notes it
# (-node-bucket-floor) or answers "not yet ported" with exit 1, never
# argparse's exit 2.

def _options(parser):
    return [
        (o, a) for a in parser._actions for o in a.option_strings
        if o not in ("-h", "--help")
    ]


JAX_FLAGS = _options(j_cli.build_parser())
PORTED_NEW = ("-save-snapshot", "-node-bucket-floor", "-group-min-count")
# The audit-replay and plane flags: each runs as in the JAX CLI (exit code
# and error line equal on the same command line).
PORTED_AUDIT_PLANE = ("-replay", "-replay-ref", "-replay-generation",
                      "-replay-tenant", "-plane-status")
# The federation and diagnostics flags: each runs as in the JAX CLI too,
# -doctor aside (its report describes this package and this host, so it is
# held to the JAX report's check names in tests/test_torch_doctor.py).
PORTED_FED_DIAG = ("-doctor-timeout", "-doctor-service", "-jax-profile",
                   "-fed-status", "-fed-sweep", "-doctor-federation",
                   "-trace-tree", "-trace-logs", "-profile",
                   "-profile-seconds", "-profile-out", "-bench-diff",
                   "-bench-thresholds")


@pytest.fixture
def restore_group_min_count():
    before = j_snapshot.group_min_count()
    yield
    j_snapshot.set_group_min_count(before)
    from kubernetesclustercapacity_tpu_torch import snapshot as t_snapshot

    t_snapshot.set_group_min_count(None)


def test_every_jax_cli_flag_is_known_to_the_port():
    known = {o for o, _ in _options(t_cli.build_parser())}
    assert len(JAX_FLAGS) >= 60
    assert [o for o, _ in JAX_FLAGS if o not in known] == []


def _flag_argv(flag, tmp_path):
    """The flag with a value the port's parser takes for it."""
    action = dict(_options(t_cli.build_parser()))[flag]
    if action.nargs == 0:
        return [flag]
    if action.nargs == "+":
        return [flag, "a", "b"]
    if action.choices:
        return [flag, list(action.choices)[0]]
    if action.type in (int, float):
        return [flag, "2"]
    if flag == "-save-snapshot":
        return [flag, str(tmp_path / "saved.npz")]
    if flag == "-trace-log":
        return [flag, str(tmp_path / "trace.jsonl")]
    if flag in ("-jax-profile", "-profile-out"):
        return [flag, str(tmp_path / flag.lstrip("-"))]
    if flag == "-extended-request":
        return [flag, "nvidia.com/gpu=0"]
    return [flag, "x"]


@pytest.mark.parametrize("flag", [o for o, _ in JAX_FLAGS])
def test_no_jax_cli_flag_gives_argparse_exit_2(
    flag, tmp_path, capsys, restore_group_min_count
):
    argv = ["-snapshot", KIND, *_flag_argv(flag, tmp_path), "-device", "cpu"]
    if flag == "-snapshot":
        argv = argv[2:]
    elif flag in ("-extended-request", "-extended-resources"):
        argv += ["-semantics", "strict"]
    rc, out = _run(t_cli.main, argv, capsys)  # SystemExit(2) would raise
    unported = flag in {f for f, _ in t_cli._UNPORTED_FLAGS}
    if unported:
        assert rc == 1
        assert out == (f"ERROR : {flag}: not yet ported to the PyTorch "
                       "package ...exiting\n")
    elif flag in PORTED_NEW:
        assert rc == 0
    elif flag == "-doctor":
        from kubernetesclustercapacity_tpu_torch import native

        assert rc == 0 and out.startswith("package ")
        lines = dict((ln[:23].rstrip(), ln[25:]) for ln in out.splitlines())
        assert lines["native kernel (C++)"] == (
            "ok: compiled" if native.available() else
            "unavailable (g++ missing or build failed) — -backend native off")
    elif flag in PORTED_AUDIT_PLANE + PORTED_FED_DIAG:
        outs = []
        for main, run_argv in ((t_cli.main, argv), (j_cli.main, argv[:-2])):
            run_rc = main(run_argv)
            run_out, run_err = capsys.readouterr()
            outs.append((run_rc, run_out, run_err.splitlines()[:1]))
        assert outs[0] == outs[1] and outs[0][0] == rc
        assert "not yet ported" not in str(outs[0])


def test_save_snapshot_writes_the_jax_clis_arrays(tmp_path, capsys):
    paths = {}
    for name, main in (("jax", j_cli.main), ("torch", t_cli.main)):
        paths[name] = str(tmp_path / f"{name}.npz")
        argv = ["-snapshot", KIND, "-cpuRequests=200m", "-memRequests=250mb",
                "-replicas=10", "-save-snapshot", paths[name]]
        if name == "torch":
            argv += ["-device", "cpu"]
        rc = main(argv)
        captured = capsys.readouterr()
        assert rc == 0
        assert f"snapshot checkpointed to {paths[name]}" in captured.err
        assert "Total possible replicas" in captured.out
    with np.load(paths["jax"]) as j, np.load(paths["torch"]) as t:
        assert sorted(j.files) == sorted(t.files)
        for key in j.files:
            assert j[key].dtype == t[key].dtype, key
            np.testing.assert_array_equal(j[key], t[key], err_msg=key)


@pytest.mark.parametrize("output", ["json", "table"])
def test_group_min_count_grid_matches_jax(output, capsys,
                                          restore_group_min_count):
    argv = ["-snapshot", KIND, "-group-min-count", "2", "-grid", "5",
            "-output", output]
    j_rc, j_out = _run(j_cli.main, argv, capsys)
    t_rc, t_out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
    assert j_rc == t_rc == 0
    if output == "json":
        j_doc, t_doc = json.loads(j_out), json.loads(t_out)
        assert t_doc["kernel"] == _label(j_doc["kernel"])
        j_doc["kernel"] = t_doc["kernel"]
        assert t_doc == j_doc
    else:
        assert t_out.splitlines()[:-1] == j_out.splitlines()[:-1]
    from kubernetesclustercapacity_tpu_torch import snapshot as t_snapshot

    assert t_snapshot.group_min_count() == 2


def test_group_min_count_gates_the_grouped_sweep(tmp_path, capsys,
                                                 restore_group_min_count):
    # 2,000 nodes of 8 shapes: grouped at the default gate of 2, and
    # ungrouped once the flag asks for 1,000 nodes per shape.
    path = str(tmp_path / "shapes.npz")
    j_snapshot.synthetic_snapshot(2000, seed=8, shapes=8).save(path)
    kernels = []
    for k in ("2", "1000"):
        argv = ["-snapshot", path, "-grid", "6", "-output", "json",
                "-group-min-count", k]
        j_rc, j_out = _run(j_cli.main, argv, capsys)
        t_rc, t_out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
        assert j_rc == t_rc == 0
        j_doc, t_doc = json.loads(j_out), json.loads(t_out)
        assert t_doc["totals"] == j_doc["totals"]
        kernels.append(t_doc["kernel"])
    assert kernels == ["plain_i32_rcp_fused_grouped", "plain_i32_rcp_fused"]


def test_node_bucket_floor_is_noted_and_ignored(capsys):
    argv = ["-snapshot", KIND, "-grid", "4", "-output", "json"]
    rc, plain = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
    rc2 = t_cli.main(argv + ["-node-bucket-floor", "512", "-device", "cpu"])
    captured = capsys.readouterr()
    assert rc == rc2 == 0
    assert captured.out == plain
    assert captured.err.strip() == t_cli.NO_BUCKET_LADDER


# The stochastic family: -car-spec, -forecast-spec (explicit growth or a
# trend fitted from an audit log), -plan -catalog, and -car / -forecast
# against running servers, byte for byte with the JAX CLI, exit codes
# included.  The port's -backend torch is the JAX CLI's -backend tpu.

CAR_SPEC = """usage:
  cpu: {dist: normal, mean: 200m, std: 80m}
  memory: {dist: lognormal, mean: 250mb, sigma: 0.6}
replicas: 10
samples: 128
seed: 7
"""
FORECAST_GROWTH = CAR_SPEC.replace("samples: 128", "samples: 64") + """\
horizon: {steps: 8, step_s: 3600}
growth: {cpu_per_s: 2.0e-5, memory_per_s: 1.0e-6}
threshold: 60
"""
PLAN_SPEC = CAR_SPEC.replace("samples: 128", "samples: 48") + """\
target: 400
drain: true
"""
CATALOG = """shapes:
  - {name: m5.xlarge, cpu: "4", memory: 16gb, pods: 58, unit_cost: 4}
  - {name: m5.2xlarge, cpu: "8", memory: 32gb, pods: 58, unit_cost: 8}
  - {name: c5.4xlarge, cpu: "16", memory: 32gb, pods: 234, unit_cost: 16}
"""


@pytest.fixture(scope="module")
def stochastic_files(tmp_path_factory):
    """The spec files, and an audit log of 20 generations the JAX package
    wrote (usage growing) for -forecast-spec's audit_dir form."""
    from kubernetesclustercapacity_tpu.audit.log import AuditLog

    d = tmp_path_factory.mktemp("stochastic")
    files = {}
    audit = str(d / "audit")
    base = j_snapshot.snapshot_from_fixture(
        json.load(open(KIND)), semantics="reference")
    with AuditLog(audit, checkpoint_every=4) as log:
        for g in range(1, 21):
            log.record_generation(dataclasses.replace(
                base,
                used_cpu_req_milli=(np.asarray(base.used_cpu_req_milli)
                                    * (1 + g / 10)).astype(np.int64),
                used_mem_req_bytes=(np.asarray(base.used_mem_req_bytes)
                                    * (1 + g / 20)).astype(np.int64),
            ), g, ts=1000.0 + 600.0 * g)
    docs = {
        "car": CAR_SPEC,
        "forecast": FORECAST_GROWTH,
        "forecast_audit": CAR_SPEC + "horizon: {steps: 6, step_s: 1800}\n"
                          f"audit_dir: {audit}\nquantiles: [0.5, 0.95]\n",
        "plan": PLAN_SPEC,
        "plan_uncertified": PLAN_SPEC.replace("target: 400",
                                              "target: 10000000"),
        "catalog": CATALOG,
        "car_unschedulable": CAR_SPEC.replace("replicas: 10",
                                              "replicas: 75"),
        "bad_car": "usage: {cpu: {dist: gauss}, memory: 1gb}\n",
        "not_mapping": "- 1\n- 2\n",
        "forecast_both": FORECAST_GROWTH + f"audit_dir: {audit}\n",
        "forecast_neither": CAR_SPEC,
        "forecast_bad_horizon": CAR_SPEC + "horizon: {steps: 2, bogus: 1}\n"
                                "growth: {cpu_per_s: 0}\n",
        "forecast_bad_threshold": CAR_SPEC + "threshold: many\n"
                                  "growth: {cpu_per_s: 0}\n",
        "forecast_bad_growth": CAR_SPEC + "growth: {gpu_per_s: 1}\n",
        "forecast_bad_rate": CAR_SPEC + "growth: {cpu_per_s: fast}\n",
        "forecast_long": CAR_SPEC + "horizon: {steps: 100000}\n"
                         "growth: {cpu_per_s: 0}\n",
        "forecast_thin_audit": CAR_SPEC + f"audit_dir: {d / 'nothing'}\n",
        "plan_bad_target": PLAN_SPEC.replace("target: 400", "target: lots"),
        "plan_bad_drain": PLAN_SPEC.replace("drain: true", "drain: maybe"),
        "bad_catalog": "shapes: [{name: x, cpu: '4'}]\n",
    }
    for name, text in docs.items():
        files[name] = str(d / f"{name}.yaml")
        with open(files[name], "w") as f:
            f.write(text)
    files["audit"] = audit
    files["missing"] = str(d / "missing.yaml")
    return files


STOCHASTIC_ARGV = {
    "car": ["-car-spec", "{car}"],
    "car-json": ["-car-spec", "{car}", "-output", "json"],
    "car-strict": ["-car-spec", "{car}", "-semantics", "strict"],
    "car-overrides": ["-car-spec", "{car}", "-car-samples", "33",
                      "-car-seed", "99", "-output", "json"],
    "car-unschedulable": ["-car-spec", "{car_unschedulable}",
                          "-car-samples", "16", "-car-seed", "1"],
    "forecast": ["-forecast-spec", "{forecast}"],
    "forecast-json": ["-forecast-spec", "{forecast}", "-output", "json"],
    "forecast-audit": ["-forecast-spec", "{forecast_audit}"],
    "forecast-audit-json": ["-forecast-spec", "{forecast_audit}", "-output",
                            "json", "-semantics", "strict"],
    "plan": ["-plan", "{plan}", "-catalog", "{catalog}"],
    "plan-json": ["-plan", "{plan}", "-catalog", "{catalog}", "-output",
                  "json"],
    "plan-uncertified": ["-plan", "{plan_uncertified}", "-catalog",
                         "{catalog}"],
    # Error lines and exit codes.
    "car-bad-spec": ["-car-spec", "{bad_car}"],
    "car-missing-spec": ["-car-spec", "{missing}"],
    "car-samples-1": ["-car-spec", "{car}", "-car-samples", "1"],
    "car-backend-cpu": ["-car-spec", "{car}", "-backend", "cpu"],
    "forecast-not-mapping": ["-forecast-spec", "{not_mapping}"],
    "forecast-both": ["-forecast-spec", "{forecast_both}"],
    "forecast-neither": ["-forecast-spec", "{forecast_neither}"],
    "forecast-bad-horizon": ["-forecast-spec", "{forecast_bad_horizon}"],
    "forecast-bad-threshold": ["-forecast-spec", "{forecast_bad_threshold}"],
    "forecast-bad-growth": ["-forecast-spec", "{forecast_bad_growth}"],
    "forecast-bad-rate": ["-forecast-spec", "{forecast_bad_rate}"],
    "forecast-too-long": ["-forecast-spec", "{forecast_long}"],
    "forecast-thin-audit": ["-forecast-spec", "{forecast_thin_audit}"],
    "forecast-backend-cpu": ["-forecast-spec", "{forecast}", "-backend",
                             "cpu"],
    "plan-no-catalog": ["-plan", "{plan}"],
    "plan-bad-catalog": ["-plan", "{plan}", "-catalog", "{bad_catalog}"],
    "plan-missing-catalog": ["-plan", "{plan}", "-catalog", "{missing}"],
    "plan-bad-target": ["-plan", "{plan_bad_target}", "-catalog",
                        "{catalog}"],
    "plan-bad-drain": ["-plan", "{plan_bad_drain}", "-catalog",
                       "{catalog}"],
    "plan-not-mapping": ["-plan", "{not_mapping}", "-catalog", "{catalog}"],
    "plan-backend-cpu": ["-plan", "{plan}", "-catalog", "{catalog}",
                         "-backend", "cpu"],
}
_BACKEND_LINE = {  # the JAX CLI names its own backend, the port its own
    "runs on the JAX kernels (-backend tpu); ":
        "runs on the device programs (-backend torch); ",
    "runs on the JAX kernels (-backend \ntpu); ":
        "runs on the device programs (-backend \ntorch); ",
}


@pytest.mark.parametrize("name", list(STOCHASTIC_ARGV))
def test_stochastic_surfaces_match_jax(name, stochastic_files, capsys):
    argv = ["-snapshot", KIND] + [a.format(**stochastic_files)
                                  for a in STOCHASTIC_ARGV[name]]
    j_rc, j_out = _run(j_cli.main, argv, capsys)
    t_rc, t_out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
    if name.endswith("backend-cpu"):
        assert "-backend tpu" in j_out and "-backend torch" in t_out
        j_out = (j_out.replace("the JAX kernels", "the device programs")
                 .replace("-backend tpu", "-backend torch")
                 .replace("(-backend tpu)", "(-backend torch)"))
    assert (t_rc, t_out) == (j_rc, j_out)
    ok = name in ("car", "car-json", "car-strict", "car-overrides",
                  "forecast-audit", "forecast-audit-json", "plan",
                  "plan-json")
    assert t_rc == (0 if ok else 1), t_out
    assert "not yet ported" not in t_out and t_out


def test_forecast_audit_dir_reads_port_written_logs(stochastic_files,
                                                    tmp_path, capsys):
    """The audit_dir form fits the same trend from a log the port's
    AuditLog wrote as from the JAX package's."""
    from kubernetesclustercapacity_tpu.audit.log import AuditReader
    from kubernetesclustercapacity_tpu_torch.audit import AuditLog
    from kubernetesclustercapacity_tpu_torch.snapshot import (
        ClusterSnapshot as TorchSnapshot,
    )

    reader = AuditReader.load(stochastic_files["audit"])
    port_dir = str(tmp_path / "port-audit")
    with AuditLog(port_dir, checkpoint_every=4) as log:
        for rec in reader.generations():
            snap = reader.snapshot_at(rec["generation"])
            log.record_generation(TorchSnapshot(**{
                f.name: getattr(snap, f.name)
                for f in dataclasses.fields(TorchSnapshot)
            }), rec["generation"], ts=rec["ts"])
    spec = tmp_path / "fc.yaml"
    with open(stochastic_files["forecast_audit"]) as f:
        spec.write_text(f.read().replace(stochastic_files["audit"],
                                         port_dir))
    argv = ["-snapshot", KIND, "-forecast-spec", str(spec), "-output",
            "json"]
    j_rc, j_out = _run(j_cli.main, argv, capsys)
    t_rc, t_out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
    assert (t_rc, t_out) == (j_rc, j_out)
    assert json.loads(t_out)["trend"]["source"] == port_dir


@pytest.mark.parametrize("flag", ["-car", "-forecast", "-gang"])
@pytest.mark.parametrize("output", ["table", "json"])
def test_status_flags_against_servers_match_jax(flag, output, capsys):
    """-car / -forecast / -gang HOST:PORT against the port's server and the
    JAX server: the same rendered status (no watches: the port has no
    timeline, the JAX server none without -watch) and exit 1."""
    from kubernetesclustercapacity_tpu.service.server import (
        CapacityServer as JaxServer,
    )
    from kubernetesclustercapacity_tpu_torch.service.server import (
        CapacityServer as TorchServer,
    )
    from kubernetesclustercapacity_tpu_torch.snapshot import (
        synthetic_snapshot as t_synthetic,
    )

    servers = [JaxServer(j_snapshot.synthetic_snapshot(16, seed=1)),
               TorchServer(t_synthetic(16, seed=1), device="cpu")]
    for s in servers:
        s.start()
    try:
        outs = []
        for server in servers:
            addr = f"{server.address[0]}:{server.address[1]}"
            argv = [flag, addr, "-output", output]
            outs.append(_run(j_cli.main, argv, capsys))
            outs.append(_run(t_cli.main, argv, capsys))
    finally:
        for s in servers:
            s.shutdown()
    assert all(o == outs[0] for o in outs)
    rc, out = outs[0]
    assert rc == 1
    assert ("no quantile watches" in out or "no horizon watches" in out
            or "no gang watches" in out or '"enabled": false' in out)


@pytest.mark.parametrize("flag", ["-car", "-forecast", "-gang"])
def test_status_flags_bad_address_like_jax(flag, capsys):
    outs = []
    for main in (j_cli.main, t_cli.main):
        for addr in ("nowhere", "127.0.0.1:1"):
            rc = main([flag, addr])
            captured = capsys.readouterr()
            outs.append((rc, captured.out, captured.err))
    assert outs[:2] == outs[2:]
    assert all(o[0] == 1 and o[2].startswith("ERROR : ") for o in outs)


# Gang capacity and the optimizer: -gang-spec (a zone/rack hierarchy from
# topology labels), -optimize with -opt-backend lp|ffd, and -gang.  The
# optimizer's float artifacts may differ from the JAX package's in their
# last bits (tests/test_torch_optimize.py states the tolerances): its JSON
# is compared on the canonical digest, equal integers and floats within a
# relative and absolute 1e-9, its table with the solve time left out.

@pytest.fixture(scope="module")
def gang_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gang")
    fx = synthetic_fixture(120, seed=21, topology=(2, 3), taint_frac=0.2)
    files = {"fleet": str(d / "fleet.json")}
    with open(files["fleet"], "w") as f:
        json.dump(fx, f)
    files["npz"] = str(d / "fleet.npz")
    j_snapshot.synthetic_snapshot(512, seed=6, shapes=4).save(files["npz"])
    docs = {
        "rack": {"pod": {"cpuRequests": "500m", "memRequests": "1gb"},
                 "gang": {"ranks": 8, "count": 2, "colocate": "rack"}},
        "spread": {"pod": {"cpuRequests": "250m", "memRequests": "512mb"},
                   "gang": {"ranks": 16, "colocate": "zone",
                            "spread_level": "rack",
                            "max_ranks_per_domain": 6}},
        # Three racks a zone hold at most 12 of 16 ranks: the rack binds.
        "spread-tight": {"pod": {"cpuRequests": "250m",
                                 "memRequests": "512mb"},
                         "gang": {"ranks": 16, "colocate": "zone",
                                  "spread_level": "rack",
                                  "max_ranks_per_domain": 4}},
        "anti": {"pod": {"cpuRequests": "1", "memRequests": "2gb"},
                 "gang": {"ranks": 12, "anti_affinity_host": True,
                          "count": 500}},
        "bad": {"pod": {"cpuRequests": "1"},
                "gang": {"ranks": 8, "max_ranks_per_domain": 2}},
        "no-gang": {"pod": {"cpuRequests": "1"}},
    }
    for name, doc in docs.items():
        files[name] = str(d / f"{name}.json")
        with open(files[name], "w") as f:
            json.dump(doc, f)
    files["missing"] = str(d / "missing.json")
    return files


GANG_ARGV = {
    "rack": ["-snapshot", "{fleet}", "-gang-spec", "{rack}"],
    "rack-json": ["-snapshot", "{fleet}", "-gang-spec", "{rack}", "-output",
                  "json"],
    "spread-strict": ["-snapshot", "{fleet}", "-gang-spec", "{spread}",
                      "-semantics", "strict"],
    "spread-json": ["-snapshot", "{fleet}", "-gang-spec", "{spread}",
                    "-output", "json", "-semantics", "strict"],
    "spread-tight": ["-snapshot", "{fleet}", "-gang-spec", "{spread-tight}",
                     "-semantics", "strict"],
    "anti-unschedulable": ["-snapshot", "{fleet}", "-gang-spec", "{anti}"],
    "npz-no-labels": ["-snapshot", "{npz}", "-gang-spec", "{spread}",
                      "-output", "json"],
    "bad-spec": ["-snapshot", "{fleet}", "-gang-spec", "{bad}"],
    "no-gang-block": ["-snapshot", "{fleet}", "-gang-spec", "{no-gang}"],
    "missing-spec": ["-snapshot", "{fleet}", "-gang-spec", "{missing}"],
    "gang-backend-cpu": ["-snapshot", "{fleet}", "-gang-spec", "{rack}",
                         "-backend", "cpu"],
    "optimize": ["-snapshot", "{npz}", "-optimize", "-cpuRequests=250m",
                 "-memRequests=128mb", "-replicas=5"],
    "optimize-json": ["-snapshot", "{npz}", "-optimize", "-output", "json",
                      "-cpuRequests=250m", "-memRequests=128mb",
                      "-replicas=5"],
    "optimize-unschedulable": ["-snapshot", "{npz}", "-optimize",
                               "-cpuRequests=250m", "-memRequests=128mb",
                               "-replicas=1000000000"],
    "optimize-grid": ["-snapshot", "{npz}", "-optimize", "-grid", "4",
                      "-seed", "3"],
    "optimize-grid-json": ["-snapshot", "{fleet}", "-optimize", "-grid", "6",
                           "-output", "json", "-semantics", "strict"],
    "optimize-fleet": ["-snapshot", "{fleet}", "-optimize",
                       "-cpuRequests=500m", "-memRequests=1gb",
                       "-replicas=40"],
    "ffd": ["-snapshot", "{npz}", "-optimize", "-opt-backend", "ffd",
            "-cpuRequests=250m", "-memRequests=128mb", "-replicas=5"],
    "ffd-json-grid": ["-snapshot", "{fleet}", "-optimize", "-opt-backend",
                      "ffd", "-grid", "5", "-output", "json"],
    "ffd-unschedulable": ["-snapshot", "{fleet}", "-optimize",
                          "-opt-backend", "ffd", "-replicas=100000"],
    "opt-backend-alone": ["-snapshot", "{fleet}", "-opt-backend", "ffd",
                          "-replicas=5", "-output", "json"],
    "optimize-backend-cpu": ["-snapshot", "{npz}", "-optimize", "-backend",
                             "cpu"],
    # The three command lines that answered "not yet ported" before.
    "gang-status-no-server": ["-snapshot", KIND, "-gang", "127.0.0.1:1"],
    "plan-then-optimize": ["-snapshot", KIND, "-plan", "spec.yaml",
                           "-optimize"],
    "gang-spec-grid": ["-snapshot", KIND, "-gang-spec", "gang.yaml",
                       "-grid", "4"],
}
# Without labels every node is its own zone and rack ("own" policy), so
# the spread gang cannot fit on the .npz fleet.
GANG_OK = {"rack", "rack-json", "spread-strict", "spread-json", "optimize", "optimize-json", "optimize-grid",
           "optimize-grid-json", "optimize-fleet", "ffd", "ffd-json-grid",
           "opt-backend-alone"}


def _close(a, b, path=""):
    """Equal, with floats within a relative and absolute 1e-9."""
    if isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= 1e-9 + 1e-9 * abs(b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def _same_optimize_output(t_out, j_out):
    import re

    from kubernetesclustercapacity_tpu.audit.log import (
        canonical_result_digest as j_digest,
    )
    from kubernetesclustercapacity_tpu_torch.audit.log import (
        canonical_result_digest as t_digest,
    )

    try:
        t_wire, j_wire = json.loads(t_out), json.loads(j_out)
    except ValueError:
        seconds = re.compile(r", [0-9.e-]+s$", re.M)
        assert seconds.sub(", Ns", t_out) == seconds.sub(", Ns", j_out)
        return
    assert t_digest("optimize", t_wire) == j_digest("optimize", j_wire)
    for wire in (t_wire, j_wire):
        wire.pop("solve_seconds", None)
    _close(t_wire, j_wire)


@pytest.mark.parametrize("name", list(GANG_ARGV))
def test_gang_and_optimize_surfaces_match_jax(name, gang_files, capsys):
    argv = [a.format(**gang_files) for a in GANG_ARGV[name]]
    j_rc, j_out = _run(j_cli.main, argv, capsys)
    t_rc, t_out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
    if name.endswith("backend-cpu"):
        assert "-backend tpu" in j_out and "-backend torch" in t_out
        j_out = (j_out.replace("the JAX kernels", "the device programs")
                 .replace("-backend tpu", "-backend torch"))
    assert t_rc == j_rc == (0 if name in GANG_OK else 1), t_out
    if name.startswith("optimize") and name in GANG_OK | {
            "optimize-unschedulable"}:
        _same_optimize_output(t_out, j_out)
    else:
        assert t_out == j_out
    assert "not yet ported" not in t_out
