"""The examples_torch/ scripts must actually run, as the examples/ ones
do — each executes in-process with its asserts live."""

import importlib.util
import os
import sys

import pytest

EXAMPLES_DIR = os.path.join(os.path.dirname(__file__), "..", "examples_torch")
EXAMPLES = sorted(f for f in os.listdir(EXAMPLES_DIR) if f.endswith(".py"))


def test_the_directory_is_not_empty():
    assert {"11_lint_and_invariants.py", "18_sanitize.py"} <= set(EXAMPLES)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs(name, capsys, monkeypatch):
    monkeypatch.delenv("KCCAP_SANITIZE", raising=False)
    path = os.path.join(EXAMPLES_DIR, name)
    spec = importlib.util.spec_from_file_location(
        f"example_torch_{name[:-3]}", path
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    try:
        spec.loader.exec_module(mod)
        mod.main()
    finally:
        sys.modules.pop(spec.name, None)
    out = capsys.readouterr().out
    assert out.strip()  # every example prints its result
    # The port's examples leave the process uninstrumented.
    assert "KCCAP_SANITIZE" not in os.environ


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
