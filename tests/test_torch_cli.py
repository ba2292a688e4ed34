"""The port's ``-grid`` CLI against the JAX CLI: the same JSON and table
output, byte for byte apart from the kernel label, on a fixture and on
``.npz`` checkpoints in both semantics, and the same error lines."""

import json

import pytest

from kubernetesclustercapacity_tpu import cli as j_cli
from kubernetesclustercapacity_tpu import snapshot as j_snapshot
from kubernetesclustercapacity_tpu.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu_torch import cli as t_cli

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
    return {"synthetic": ref, "tainted": strict, "unquantized": inel}


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


def test_semantics_conflict_matches_jax(npz_sources, capsys):
    argv = ["-snapshot", npz_sources["tainted"], "-semantics", "reference",
            "-grid", "4"]
    j_rc, j_out = _run(j_cli.main, argv, capsys)
    t_rc, t_out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
    assert j_rc == t_rc == 1
    assert t_out == j_out


@pytest.mark.parametrize(
    "argv,needle",
    [
        (["-snapshot", KIND], "single-spec report is not yet ported"),
        (["-grid", "4"], "live-cluster source is not yet ported"),
    ],
)
def test_unported_surfaces_say_so(argv, needle, capsys):
    rc, out = _run(t_cli.main, argv + ["-device", "cpu"], capsys)
    assert rc == 1
    assert needle in out and out.startswith("ERROR : ")
    assert out.rstrip().endswith("...exiting")
