"""Nothing the benchmark runs imports JAX or the JAX package, by whole
top-level names; the reference imports nothing of the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from kccap_bench import child
from kccap_bench.tests.conftest import REPO

BENCH = os.path.join(REPO, "kccap_bench")
PORT = "kubernetesclustercapacity_tpu_torch"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        if "tests" in dirpath.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_whole_top_level_names_decide(monkeypatch):
    for name in ("jax", "jaxlib.xla_client", "flax.linen",
                 "kubernetesclustercapacity_tpu.fit"):
        monkeypatch.setitem(sys.modules, name, object())
    for name in ("jaxtyping_like", "kubernetesclustercapacity_tpu_torch_x",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    found = child.forbidden_modules()
    assert "kubernetesclustercapacity_tpu.fit" in found
    assert {"jax", "jaxlib.xla_client", "flax.linen"} <= set(found)
    assert not any(f.startswith(("jaxtyping", "flaxen",
                                 "kubernetesclustercapacity_tpu_torch"))
                   for f in found)


def test_no_source_of_the_benchmark_names_jax():
    for path in _sources():
        for mod in _imports(path):
            assert mod.split(".")[0] not in child.FORBIDDEN, (path, mod)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for mod in _imports(path):
            assert mod.split(".")[0] in {"__future__", "functools", "re",
                                         "fractions", "numpy", "torch",
                                         "kccap_bench"}, (path, mod)
    code = ("import sys, kccap_bench.reference.fit, "
            "kccap_bench.reference.pack, kccap_bench.reference.state, "
            "kccap_bench.roofline; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    assert PORT not in out and "'jax'" not in out


@pytest.mark.parametrize("module", ["kccap_bench.run", "kccap_bench.child"])
def test_the_harness_and_the_server_process_load_no_jax(module):
    code = (f"import sys, {module}; "
            f"import kubernetesclustercapacity_tpu_torch.service; "
            f"from kccap_bench.child import forbidden_modules; "
            f"print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"
