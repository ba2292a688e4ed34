"""The port's native C++ backend against the JAX package's, on the CPU.

``kubernetesclustercapacity_tpu_torch.native`` builds its own copy of
``capacity.cc`` with ``g++`` into the port's ``_build/``; these tests hold
it against the JAX package's native library and the Python codecs and
oracles of both packages: the quantity codecs, the per-node fits on
fuzzed and hostile columns (INT64_MIN headroom, the wraps, the
zero-divisor panic), the threaded sweep against ``fit_arrays``, the
exact int64 sweep and kernel B1's plain version, ``-backend native``
transcripts byte for byte against the JAX CLI's, and the doctor's two
native lines.  Skipped only where ``g++`` is missing, as the JAX tests
are.

Tolerance: none (integers and text equal).
"""

import os

import numpy as np
import pytest
import torch

from kubernetesclustercapacity_tpu import cli as j_cli
from kubernetesclustercapacity_tpu import native as j_native
from kubernetesclustercapacity_tpu.scenario import Scenario as JScenario
from kubernetesclustercapacity_tpu.snapshot import (
    synthetic_snapshot as j_synthetic,
)
from kubernetesclustercapacity_tpu.utils import doctor as j_doc
from kubernetesclustercapacity_tpu_torch import cli as t_cli
from kubernetesclustercapacity_tpu_torch import native
from kubernetesclustercapacity_tpu_torch.oracle import fit_arrays_python
from kubernetesclustercapacity_tpu_torch.oracle import reference as t_oref
from kubernetesclustercapacity_tpu_torch.scenario import (
    Scenario,
    random_scenario_grid,
)
from kubernetesclustercapacity_tpu_torch.snapshot import synthetic_snapshot
from kubernetesclustercapacity_tpu_torch.utils import doctor as t_doc
from kubernetesclustercapacity_tpu_torch.utils.quantity import (
    QuantityParseError,
    cpu_to_milli_reference,
    to_bytes_reference,
)

MIB = 1024 * 1024
KIND = "tests/fixtures/kind-3node.json"
OK_PROBE = "print('DEVICES 0s D x1')"


@pytest.fixture(autouse=True)
def toolchain():
    if not native.available():
        pytest.skip("no C++ toolchain")


def _columns(snap):
    return (snap.alloc_cpu_milli, snap.alloc_mem_bytes, snap.alloc_pods,
            snap.used_cpu_req_milli, snap.used_mem_req_bytes,
            snap.pods_count)


# ---------------------------------------------------------------------------
# Loader and build
# ---------------------------------------------------------------------------
def test_builds_into_the_ports_own_build_dir():
    from kubernetesclustercapacity_tpu_torch.native import _build_util

    so = native._load()._name
    assert so.startswith(_build_util.BUILD_DIR)
    assert "kubernetesclustercapacity_tpu_torch" in so
    assert j_native._load()._name != so


def test_a_stale_object_is_rebuilt(tmp_path, monkeypatch):
    from kubernetesclustercapacity_tpu_torch.native import _build_util

    monkeypatch.setattr(_build_util, "BUILD_DIR", str(tmp_path))
    src = tmp_path / "one.cc"
    src.write_text('extern "C" int one() { return 1; }\n')
    first = _build_util.build_so(str(src), "libone.so")
    mtime = tmp_path.joinpath("libone.so").stat().st_mtime_ns
    assert _build_util.build_so(str(src), "libone.so") == first
    assert tmp_path.joinpath("libone.so").stat().st_mtime_ns == mtime
    src.write_text('extern "C" int one() { return 2; }\n')
    os.utime(src, ns=(mtime + 10**9, mtime + 10**9))
    _build_util.build_so(str(src), "libone.so")
    assert tmp_path.joinpath("libone.so").stat().st_mtime_ns != mtime
    assert [p.name for p in tmp_path.iterdir() if p.suffix == ".so"] == [
        "libone.so"]  # the temp file was renamed, not left behind


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    from kubernetesclustercapacity_tpu_torch.native import _build_util

    monkeypatch.setattr(_build_util, "BUILD_DIR", str(tmp_path))
    src = tmp_path / "bad.cc"
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="error"):
        _build_util.build_so(str(src), "libbad.so")
    assert not list(tmp_path.glob("*.so"))


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "s",
    ["100m", "250m", "2", "4", "0", "+3", "-5", "-5m", "0.5", "", "m",
     "5mm", "100Mi", "1e2", str(2**63), str(2**63 - 1), "9" * 30,
     "12\x003"],
)
def test_cpu_codec_parity(s):
    got = native.cpu_to_milli(s)
    assert got == j_native.cpu_to_milli(s) == cpu_to_milli_reference(s)


@pytest.mark.parametrize(
    "s",
    ["100mb", "100MB", "100Mi", "1k", "3500Ki", "2g", "1T", "5B",
     "  250mb  ", "0.5M", "1.5K", "9400000T", "1_5MB", " 100MB ",
     "　250mb　", "\x85 2g"],
)
def test_byte_codec_parity_valid(s):
    got = native.to_bytes(s)
    assert got == j_native.to_bytes(s) == to_bytes_reference(s)


@pytest.mark.parametrize(
    "s",
    ["16Gi", "1Ti", "1073741824", "0Ki", "-5M", "", "MB", "1XB",
     "2 GB", "9" * 400 + "M", "_15MB", "\x1c100MB", "​100MB"],
)
def test_byte_codec_parity_invalid(s):
    with pytest.raises(ValueError) as t_err:
        native.to_bytes(s)
    with pytest.raises(ValueError) as j_err:
        j_native.to_bytes(s)
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(QuantityParseError):
        to_bytes_reference(s)


# ---------------------------------------------------------------------------
# Per-node fits
# ---------------------------------------------------------------------------
def _hostile_columns(seed, n=311):
    rng = np.random.default_rng(seed)

    def mixed(lo, hi):
        vals = rng.integers(lo, hi, size=n, dtype=np.int64)
        hostile = rng.random(n) < 0.1
        return np.where(
            hostile, rng.integers(-(2**62), 2**62, size=n, dtype=np.int64),
            vals,
        )

    cols = (mixed(0, 10**6), mixed(0, 2**45),
            rng.integers(0, 200, size=n, dtype=np.int64),
            mixed(0, 10**6), mixed(0, 2**45),
            rng.integers(0, 300, size=n, dtype=np.int64))
    return cols, rng.random(n) > 0.2


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["reference", "strict"])
def test_fuzz_against_the_oracle_and_the_jax_native(seed, mode):
    cols, healthy = _hostile_columns(seed)
    for cpu_req, mem_req in [(100, MIB), (1, 1), (123457, 987654321)]:
        want = fit_arrays_python(*cols, cpu_req, mem_req, mode=mode,
                                 healthy=healthy)
        got = native.fit_arrays(*cols, cpu_req, mem_req, mode=mode,
                                healthy=healthy)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, j_native.fit_arrays(*cols, cpu_req, mem_req, mode=mode,
                                     healthy=healthy))


@pytest.mark.parametrize("args,req,want", [
    # INT64_MIN used memory: alloc - used must not overflow.
    (([10_000], [0], [10**12], [0], [-(2**63)], [0]), (100, 3), None),
    # alloc - used wraps to INT64_MIN; mem_req -1: Go defines the wrap.
    (([8000], [1 << 62], [110], [0], [-(1 << 62)], [0]), (100, -1),
     [-(1 << 63)]),
    # the pod cap's subtraction through INT64_MIN wraps as in Go.
    (([8000], [1 << 40], [-(1 << 62)], [0], [0], [1 << 62]), (1, 1), None),
])
def test_wrap_cases_against_the_oracle(args, req, want):
    got = native.fit_arrays(*args, *req, mode="reference")
    oracle = fit_arrays_python(*args, *req, mode="reference")
    assert got.tolist() == oracle
    assert got.tolist() == j_native.fit_arrays(*args, *req).tolist()
    if want is not None:
        assert oracle == want


def test_zero_divisor_panics_with_the_jax_message():
    cols = (np.array([8000]), np.array([2**30]), np.array([110]),
            np.array([0]), np.array([0]), np.array([0]))
    with pytest.raises(native.NativePanic) as t_err:
        native.fit_arrays(*cols, 0, MIB)
    with pytest.raises(j_native.NativePanic) as j_err:
        j_native.fit_arrays(*cols, 0, MIB)
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(native.NativePanic):
        native.sweep(*cols, [100, 0], [MIB, MIB])


def test_sweep_total_wraps_like_go():
    big = 1 << 62
    args = ([big, big], [big, big], [big, big], [0, 0], [0, 0], [0, 0])
    fits = fit_arrays_python(*args, 1, 1, mode="reference")
    assert fits == [big, big]
    want = t_oref._to_go_int(sum(fits))
    assert want == -(1 << 63)  # the sum really wrapped
    assert int(native.sweep(*args, [1], [1])[0]) == want


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------
def test_sweep_matches_fit_arrays():
    snap = synthetic_snapshot(200, seed=31)
    cpu_reqs = np.array([100, 250, 1000, 137], dtype=np.int64)
    mem_reqs = np.array([MIB, 250 * MIB, 7 * MIB + 13, MIB], dtype=np.int64)
    totals = native.sweep(*_columns(snap), cpu_reqs, mem_reqs, n_threads=3)
    for j in range(4):
        fits = native.fit_arrays(*_columns(snap), int(cpu_reqs[j]),
                                 int(mem_reqs[j]))
        assert totals[j] == fits.sum()


@pytest.mark.parametrize("mode", ["reference", "strict"])
def test_sweep_matches_b1_the_exact_program_and_jax(mode):
    """``native.sweep`` = kernel B1's plain version (``sweep_fused_plain``,
    what B1 computes on the card) = the exact int64 program = the JAX
    package's native sweep, on a fleet B1 is eligible for; strict with a
    taint-style lane mask folded into ``healthy``."""
    from kubernetesclustercapacity_tpu_torch import devcache
    from kubernetesclustercapacity_tpu_torch.ops.fit import sweep_snapshot
    from kubernetesclustercapacity_tpu_torch.ops.fused_fit import (
        fast_sweep_eligible,
        sweep_fused_plain,
    )

    snap = synthetic_snapshot(500, seed=33)
    grid = random_scenario_grid(64, seed=34)
    lane = np.arange(snap.n_nodes) % 7 != 3
    healthy = snap.healthy & lane if mode == "strict" else None
    got = native.sweep(*_columns(snap), grid.cpu_request_milli,
                       grid.mem_request_bytes, mode=mode, healthy=healthy)
    np.testing.assert_array_equal(got, j_native.sweep(
        *_columns(j_synthetic(500, seed=33)), grid.cpu_request_milli,
        grid.mem_request_bytes, mode=mode, healthy=healthy))

    node_mask = lane if mode == "strict" else None
    exact, _ = sweep_snapshot(snap, grid, mode=mode, node_mask=node_mask,
                              device="cpu")
    np.testing.assert_array_equal(got, exact)

    assert fast_sweep_eligible(*_columns(snap), grid.cpu_request_milli,
                               grid.mem_request_bytes)
    nodes = (torch.from_numpy(a) for a in devcache.kernel_columns(
        [getattr(snap, f) for f, _ in devcache._KERNEL_COLUMNS]))
    cr = torch.from_numpy(grid.cpu_request_milli.astype(np.int32))
    mr = torch.from_numpy((grid.mem_request_bytes // 1024).astype(np.int32))
    mask = None
    if mode == "strict":
        mask = torch.from_numpy(healthy.astype(np.int32))
    plain = sweep_fused_plain(*nodes, cr, mr, mask=mask,
                              strict=mode == "strict")
    np.testing.assert_array_equal(got, plain.numpy())


# ---------------------------------------------------------------------------
# -backend native
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("output", ["reference", "json", "table"])
@pytest.mark.parametrize("semantics", ["reference", "strict"])
@pytest.mark.parametrize("source", ["kind", "synthetic"])
def test_backend_native_transcripts_match_jax(source, semantics, output,
                                              tmp_path_factory, capsys):
    if source == "kind":
        path = KIND
    else:
        from kubernetesclustercapacity_tpu.fixtures import synthetic_fixture
        from kubernetesclustercapacity_tpu.fixtures import save_fixture

        path = str(tmp_path_factory.mktemp("native") / "fleet.json")
        save_fixture(synthetic_fixture(300, seed=6, taint_frac=0.2,
                                       unhealthy_frac=0.1), path)
    argv = ["-snapshot", path, "-cpuRequests=200m", "-cpuLimits=400m",
            "-memRequests=250mb", "-memLimits=500mb", "-replicas=5000",
            "-backend", "native", "-semantics", semantics, "-output", output]
    j_rc = j_cli.main(argv)
    j_out = capsys.readouterr().out
    t_rc = t_cli.main(argv + ["-device", "cpu"])
    t_out = capsys.readouterr().out
    assert j_rc == t_rc == 0
    assert t_out == j_out
    # ... and equal to the port's own device program's transcript.
    assert t_cli.main(argv[:-6] + ["-semantics", semantics, "-output",
                                   output, "-device", "cpu"]) == 0
    assert capsys.readouterr().out == t_out


def test_backend_native_panic_exits_2_like_jax(capsys):
    """The CLI's panic path: a spec that passes no ``validate`` (the
    flags cannot produce one) reaches the divide, as a library caller's
    could."""
    outs = []
    for cli, scen, extra in (
        (j_cli, JScenario(0, MIB, 5), []),
        (t_cli, Scenario(0, MIB, 5), ["-device", "cpu"]),
    ):
        args = cli.build_parser().parse_args(
            ["-backend", "native", "-semantics", "reference", *extra])
        snap = (j_synthetic if cli is j_cli else synthetic_snapshot)(
            8, seed=1)
        rc = cli._run_single(args, None, snap, scen)
        outs.append((rc, capsys.readouterr().out))
    assert outs[0] == outs[1]
    assert outs[1] == (
        2, "panic: integer divide by zero (ClusterCapacity.go:123/129)\n")


def test_backend_native_unavailable_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_BUILD_ERROR", "native build failed: no g++")
    rc = t_cli.main(["-snapshot", KIND, "-backend", "native", "-device",
                     "cpu"])
    assert rc == 1
    assert capsys.readouterr().out == (
        "ERROR : native backend unavailable: native build failed: no g++\n")


# ---------------------------------------------------------------------------
# The doctor
# ---------------------------------------------------------------------------
def test_doctor_native_lines_match_jax():
    j = dict(j_doc.doctor_report(backend_timeout_s=20.0, probe_code=OK_PROBE))
    t = dict(t_doc.doctor_report(backend_timeout_s=20.0, probe_code=OK_PROBE,
                                 device="cpu"))
    for name in ("native kernel (C++)", "native pod-walk (C ext)"):
        assert t[name] == j[name] == "ok: compiled"


def test_doctor_says_when_the_library_does_not_build(monkeypatch):
    from kubernetesclustercapacity_tpu_torch.native import ingest

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_BUILD_ERROR", "native build failed: x")
    monkeypatch.setenv("KCC_DISABLE_NATIVE_INGEST", "1")
    t = dict(t_doc.doctor_report(backend_timeout_s=20.0, probe_code=OK_PROBE,
                                 device="cpu"))
    assert t["native kernel (C++)"] == (
        "unavailable (g++ missing or build failed) — -backend native off")
    assert t["native pod-walk (C ext)"] == (
        "unavailable — packers use the pure-Python walk")
    assert not ingest.available()
