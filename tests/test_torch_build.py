"""The kernel build helper (``ops/_build.py``): what makes a library stale,
what the build reports, and how it fails.  Nothing is compiled here: a
stand-in ``nvcc`` script plays the compiler."""

import pytest

from kubernetesclustercapacity_tpu_torch.ops import _build

FAKE_NVCC_OK = """#!/bin/sh
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
: > "$out"
echo "ptxas info    : Used 40 registers, used 1 barriers, 8192 bytes smem" >&2
"""

FAKE_NVCC_FAIL = """#!/bin/sh
echo "sweep_fit.cu(1): error: expected a declaration" >&2
exit 2
"""


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return src


def _fake_nvcc(tmp_path, monkeypatch, script):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(script)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))


def test_digest_follows_source_headers_and_flags(csrc, monkeypatch):
    first = _build._digest("k")
    assert _build._digest("k") == first
    (csrc / "k.cu").write_text("// v2\n")
    edited = _build._digest("k")
    assert edited != first
    (csrc / "common.cuh").write_text("// shared header\n")
    with_header = _build._digest("k")
    assert with_header != edited
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._digest("k") != with_header


def test_build_writes_library_and_ptxas_report(csrc, tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch, FAKE_NVCC_OK)
    out = _build.build("k")
    assert out == _build.BUILD_DIR / f"libk-{_build._digest('k')}.so"
    assert out.exists()
    assert "Used 40 registers" in _build.ptxas_report("k")
    assert [p.name for p in _build.BUILD_DIR.iterdir() if ".tmp" in p.name] == []


def test_an_unchanged_source_is_not_rebuilt(csrc, tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch, FAKE_NVCC_OK)
    out = _build.build("k")
    _fake_nvcc(tmp_path, monkeypatch, FAKE_NVCC_FAIL)
    assert _build.build("k") == out
    (csrc / "k.cu").write_text("// v2\n")
    with pytest.raises(RuntimeError):
        _build.build("k")


def test_a_failed_build_raises_with_the_compiler_output(
    csrc, tmp_path, monkeypatch
):
    _fake_nvcc(tmp_path, monkeypatch, FAKE_NVCC_FAIL)
    with pytest.raises(RuntimeError, match="exit 2") as err:
        _build.build("k")
    assert "expected a declaration" in str(err.value)
    assert list(_build.BUILD_DIR.glob("*.so")) == []


def test_a_missing_toolkit_raises(csrc, tmp_path, monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-toolkit"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("k")


def test_flags_target_hopper_and_keep_f32_rounding_exact():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags
    assert "fast_math" not in flags and "-ftz=true" not in flags
