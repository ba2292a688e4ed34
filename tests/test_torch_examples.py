"""The examples_torch/ scripts must actually run, as the examples/ ones
do — each executes in-process with its asserts live.

Every file in ``examples/`` has a twin of the same name here.  A twin
that drives the library takes ``main(device="cuda")`` and raises without
a card; the tests run it with ``device="cpu"``.  The two host-only twins
(the analyzer and the sanitizer) take no device.  Where a script's
output is deterministic, the twin prints what the JAX script prints,
line for line, through one normaliser (:func:`_normalise`):

1. a line that carries a duration (a number followed by ``ms`` or
   ``s``) is dropped from both outputs;
2. the kernel labels map as ROADMAP.md's surface differences list them:
   ``pallas_`` becomes ``plain_`` (the CPU stands in for each kernel
   with its plain PyTorch version) and ``xla_int64`` becomes
   ``torch_int64``;
3. no other line is dropped: the lines a documented surface difference
   replaces (07's bucket ladder, 12's build and group times) are in
   scripts whose twin is not compared, or carry durations already.

Tolerance: 0 — every replica count, total, quantile, binding, plan and
digest is equal.  In 17 a line that still differs passes only where it
differs in float tokens, each within 3.6e-15 of the JAX value (the
PDHG's documented last-bit difference); its integers stay equal.
"""

import importlib.util
import inspect
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXAMPLES_DIR = os.path.join(ROOT, "examples_torch")
JAX_EXAMPLES_DIR = os.path.join(ROOT, "examples")
EXAMPLES = sorted(f for f in os.listdir(EXAMPLES_DIR) if f.endswith(".py"))
JAX_EXAMPLES = sorted(
    f for f in os.listdir(JAX_EXAMPLES_DIR) if f.endswith(".py")
)
HOST_ONLY = {"11_lint_and_invariants.py", "18_sanitize.py"}
DEVICE_TWINS = [name for name in EXAMPLES if name not in HOST_ONLY]
# The twins whose stdout is deterministic: equal to the JAX script's.
PARITY = [
    "01_reference_run.py", "02_what_if_sweep.py",
    "03_constraints_and_placement.py", "04_service_and_watch.py",
    "08_capacity_timeline.py", "12_million_node_sweep.py",
    "14_capacity_at_risk.py", "16_gang_capacity.py",
    "17_optimized_packing.py", "20_forecast_and_plan.py",
]
FLOAT_TOL = {"17_optimized_packing.py": 3.6e-15}

_DURATION = re.compile(r"\d(?:\.\d+)?\s?(?:ms|s)\b")
_LABELS = (("pallas_", "plain_"), ("xla_int64", "torch_int64"))
_NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")


def _load(directory, name, prefix):
    spec = importlib.util.spec_from_file_location(
        f"{prefix}_{name[:-3]}", os.path.join(directory, name)
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        sys.modules.pop(spec.name, None)
        raise
    return mod


def _run(directory, name, prefix, **kwargs):
    mod = _load(directory, name, prefix)
    try:
        mod.main(**kwargs)
    finally:
        sys.modules.pop(f"{prefix}_{name[:-3]}", None)


def _normalise(text: str) -> list[str]:
    lines = []
    for line in text.splitlines():
        if _DURATION.search(line):
            continue
        for old, new in _LABELS:
            line = line.replace(old, new)
        lines.append(line)
    return lines


def _floats_within(jax_line: str, twin_line: str, tol: float) -> bool:
    """Equal apart from float tokens each within ``tol``; integers and
    the text between the numbers equal."""
    if _NUMBER.split(jax_line) != _NUMBER.split(twin_line):
        return False
    for a, b in zip(_NUMBER.findall(jax_line), _NUMBER.findall(twin_line)):
        if a == b:
            continue
        if not any(c in a + b for c in ".eE"):
            return False  # an integer that differs
        if abs(float(a) - float(b)) > tol:
            return False
    return len(_NUMBER.findall(jax_line)) == len(_NUMBER.findall(twin_line))


def _takes_device(mod) -> bool:
    return "device" in inspect.signature(mod.main).parameters


def test_the_directory_is_not_empty():
    # A twin for every script of the JAX package's examples/.
    assert set(JAX_EXAMPLES) <= set(EXAMPLES)
    assert {"11_lint_and_invariants.py", "18_sanitize.py"} <= set(EXAMPLES)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs(name, capsys, monkeypatch):
    monkeypatch.delenv("KCCAP_SANITIZE", raising=False)
    mod = _load(EXAMPLES_DIR, name, "example_torch")
    try:
        if _takes_device(mod):
            mod.main(device="cpu")
        else:
            mod.main()
    finally:
        sys.modules.pop(f"example_torch_{name[:-3]}", None)
    out = capsys.readouterr().out
    assert out.strip()  # every example prints its result
    # The port's examples leave the process uninstrumented.
    assert "KCCAP_SANITIZE" not in os.environ


@pytest.mark.parametrize("name", DEVICE_TWINS)
def test_every_device_twin_takes_a_device(name):
    mod = _load(EXAMPLES_DIR, name, "example_torch_sig")
    sys.modules.pop(f"example_torch_sig_{name[:-3]}", None)
    param = inspect.signature(mod.main).parameters.get("device")
    assert param is not None, name
    assert param.default == "cuda"
    with open(os.path.join(EXAMPLES_DIR, name), encoding="utf-8") as fh:
        src = fh.read()
    # Run by path it takes --device cuda|cpu, defaulting to the card.
    assert 'ap.add_argument("--device", choices=("cuda", "cpu"), ' \
        'default="cuda")' in src


def test_a_device_twin_without_a_card_raises():
    """Without a card and without --device cpu, a twin raises before it
    prints a result: it never carries on on the host."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES_DIR, "01_reference_run.py")],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA is not available" in proc.stderr


@pytest.fixture
def fresh_jax_breaker(monkeypatch):
    """The JAX fused-path breaker is process-global; a test that tripped
    it earlier in this process would turn the JAX script's kernel label
    into the int64 route's.  Each parity case starts from a fresh one, as
    a new process would."""
    from kubernetesclustercapacity_tpu.ops import pallas_fit
    from kubernetesclustercapacity_tpu.resilience import CircuitBreaker

    monkeypatch.setattr(pallas_fit, "_breaker", CircuitBreaker(
        name="pallas_fused_sweep", failure_threshold=1,
        recovery_timeout_s=None,
        on_state_change=pallas_fit._breaker_transition))


@pytest.mark.parametrize("name", PARITY)
def test_twin_prints_the_jax_results(name, capsys, monkeypatch,
                                     fresh_jax_breaker):
    for var in ("KCCAP_SANITIZE", "KCCAP_GROUPING", "KCCAP_GROUP_MIN_COUNT",
                "KCC_EXAMPLE_NODES"):
        monkeypatch.delenv(var, raising=False)
    _run(JAX_EXAMPLES_DIR, name, "example_jax_parity")
    jax_out = _normalise(capsys.readouterr().out)
    _run(EXAMPLES_DIR, name, "example_torch_parity", device="cpu")
    twin_out = _normalise(capsys.readouterr().out)
    assert jax_out, name
    assert len(twin_out) == len(jax_out), (jax_out, twin_out)
    tol = FLOAT_TOL.get(name)
    for j, t in zip(jax_out, twin_out):
        if j != t and tol is not None and _floats_within(j, t, tol):
            continue
        assert t == j


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_no_jax(name):
    import ast

    with open(os.path.join(EXAMPLES_DIR, name), encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        mods = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        for m in mods:
            root = m.split(".")[0]
            assert root not in ("jax", "jaxlib", "kubernetesclustercapacity_tpu"), m
