"""The port's lint gate: ``kccap-torch-lint`` over the whole port package
reports zero findings with an empty ``LINT_BASELINE_TORCH.json``, the
unchanged JAX analyzer agrees on every shared family, and the
device-root table covers every jit root of the JAX package."""

import os
import re
import subprocess
import sys

import pytest

from kubernetesclustercapacity_tpu.analysis import engine as j_engine
from kubernetesclustercapacity_tpu.analysis.callgraph import (
    CallGraph as JCallGraph,
)
from kubernetesclustercapacity_tpu_torch.analysis import rules_jit
from kubernetesclustercapacity_tpu_torch.analysis.callgraph import (
    DEVICE_ROOTS,
    CallGraph,
    declared_roots,
)
from kubernetesclustercapacity_tpu_torch.analysis.engine import (
    Analyzer,
    Baseline,
    Project,
)

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_PKG = os.path.join(_REPO, "kubernetesclustercapacity_tpu_torch")
_JAX_PKG = os.path.join(_REPO, "kubernetesclustercapacity_tpu")
_PORT = "kubernetesclustercapacity_tpu_torch"

SHARED = ("lock-discipline", "lock-order", "surface", "hygiene")


@pytest.fixture(scope="module")
def project():
    return Project(_PKG)


@pytest.fixture(scope="module")
def result(project):
    baseline = Baseline.load(os.path.join(_REPO, "LINT_BASELINE_TORCH.json"))
    return Analyzer(project, baseline=baseline).run()


@pytest.fixture(scope="module")
def jax_result():
    """The JAX package's analyzer, unchanged, over the port package."""
    return j_engine.Analyzer(j_engine.Project(_PKG)).run()


@pytest.fixture(scope="module")
def graph(project):
    return CallGraph.build(project)


def test_package_has_zero_findings_and_an_empty_baseline(result):
    assert result.clean, (
        "kccap-torch-lint found new violations:\n"
        + "\n".join(f.render() for f in result.findings)
    )
    assert result.baselined == []
    bl = Baseline.load(os.path.join(_REPO, "LINT_BASELINE_TORCH.json"))
    assert bl.entries == set()


@pytest.mark.parametrize("family", SHARED)
def test_the_jax_analyzer_agrees_on_the_port(family, result, jax_result):
    def of_family(findings):
        return [f.to_json() for f in findings
                if f.rule == family or f.rule.startswith(family + "-")]

    assert of_family(jax_result.findings) == []
    assert of_family(result.findings) == []
    # The inline markers the two analyzers honour are the same sites.
    assert of_family(jax_result.suppressed) == of_family(result.suppressed)


@pytest.mark.parametrize("rule,path,symbol", [
    ("hygiene-thread-death", "service/server.py", "_stop"),
    ("lock-discipline", "telemetry/memledger.py",
     "DeviceLedger._suspects@reconcile"),
    ("lock-discipline", "devcache.py", "DeviceCache._entries@_per"),
    ("lock-discipline", "devcache.py", "DeviceCache._entries@_per_locked"),
])
def test_the_four_adoption_findings_stay_repaired(rule, path, symbol,
                                                  jax_result, result):
    for res in (jax_result, result):
        for f in res.findings + res.suppressed:
            assert not (
                f.rule == rule and f.path == f"{_PORT}/{path}"
                and f.symbol == symbol
            ), f.render()


def test_every_jax_jit_root_has_a_resolving_counterpart(graph):
    jgraph = JCallGraph.build(j_engine.Project(_JAX_PKG))
    jax_roots = {
        f.qname.split(".", 1)[1] for f in jgraph.roots()
    }
    assert len(jax_roots) >= 35
    covered = {j for js in DEVICE_ROOTS.values() for j in js}
    assert jax_roots <= covered, sorted(jax_roots - covered)
    # ... and the table names no JAX root that does not exist.
    assert covered <= jax_roots, sorted(covered - jax_roots)
    for name in DEVICE_ROOTS:
        assert f"{_PORT}.{name}" in graph.functions, name
    assert graph.unresolved_roots == []


def test_the_scan_is_not_vacuous(project, graph):
    assert len(project.files) >= 90
    roots = graph.roots()
    assert len(roots) >= 35 and len(roots) == len(DEVICE_ROOTS)
    reachable = graph.reachable()
    assert len(reachable) > len(roots)
    root_modules = {f.module.split(".", 1)[1] for f in roots}
    assert {
        "ops.fit", "ops.fused_fit", "ops.fused_multi", "ops.placement",
        "explain", "utils.guards", "topology.gang", "optimize.lp",
        "stochastic.distributions", "parallel.sweep",
    } <= root_modules


def test_the_table_is_read_from_the_source(project):
    """The rule reads the package's own ``DEVICE_ROOTS`` literal — the
    module constant and the AST read are the same list."""
    listed = [n for n, src, _ in declared_roots(project)]
    assert listed == list(DEVICE_ROOTS)
    assert {src.rel_path for _, src, _ in declared_roots(project)} == {
        f"{_PORT}/analysis/callgraph.py"
    }


def test_every_device_purity_marker_gives_its_reason(result):
    marked = [f for f in result.suppressed if f.rule == "device-purity"]
    assert len(marked) >= 10
    pat = re.compile(r"lint-ok\[device-purity\]\s+(\S.*)$")
    for f in marked:
        with open(os.path.join(_REPO, f.path), encoding="utf-8") as fh:
            lines = fh.read().splitlines()
        text = lines[f.line - 1] + "\n" + lines[f.line - 2]
        m = pat.search(text) or pat.search(lines[f.line - 2])
        assert m and len(m.group(1)) > 10, f.render()
    # The first-use nvcc build is decided once, where the kernel seam
    # binds a C entry; no wrapper declares a build of its own.
    sites = {(f.path.rsplit("/", 1)[-1], f.message.split(" ")[3])
             for f in marked}
    assert ("_build.py", "ops._build._entry") in sites
    assert [s for s in sites if "build" in s[1]] == [
        ("_build.py", "ops._build._entry")]


def test_no_host_sync_inside_a_step_loop(result):
    for f in result.findings + result.suppressed:
        assert not f.message.startswith("host-sync"), f.render()


def test_impure_subsystems_are_the_jax_rules():
    from kubernetesclustercapacity_tpu.analysis import rules_jit as j_rules

    assert rules_jit.IMPURE_SUBSYSTEMS == j_rules.IMPURE_SUBSYSTEMS


def test_known_threaded_classes_are_analyzed(project):
    from kubernetesclustercapacity_tpu_torch.analysis import rules_locks

    model = rules_locks.lock_model(project)
    names = {m.name for m in model.values()}
    assert {
        "DeviceCache", "MicroBatcher", "CapacityTimeline", "AuditLog",
        "CircuitBreaker", "MetricsRegistry", "DeviceLedger",
    } <= names


def test_cli_gate_exits_zero_on_the_package():
    proc = subprocess.run(
        [sys.executable, "-m", "kubernetesclustercapacity_tpu_torch.analysis.cli"],
        capture_output=True,
        text=True,
        cwd=_REPO,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("kccap-torch-lint: 0 finding(s)")
