"""Rule-sensitivity tests for the port's analyzer.

Two fixture packages, both read-only here:

* ``tests/lint_fixtures/fixture_pkg`` — the JAX analyzer's fixture.
  Every shared family (lock-discipline, lock-order, surface-*,
  hygiene-*) must fire at exactly its ``# expect:`` lines and nowhere
  else, with the JAX analyzer's findings — rule, file, line, column,
  severity and message.  Its ``jit-purity`` lines are the JAX rule's
  own; the port's device-purity has no jit roots to find there.
* ``tests/torch_lint_fixtures/torch_fixture_pkg`` — one planted
  ``device-purity`` violation per category, each at its marked line,
  and a clean control module that is flagged never.

The expected ``(rule, path, line)`` sets derive from the markers, so
fixture edits cannot drift from the assertions.
"""

import os
import re

import pytest

from kubernetesclustercapacity_tpu.analysis import engine as j_engine
from kubernetesclustercapacity_tpu_torch.analysis.callgraph import (
    CallGraph,
    declared_roots,
)
from kubernetesclustercapacity_tpu_torch.analysis.engine import (
    Analyzer,
    Baseline,
    Project,
)

_TESTS = os.path.dirname(os.path.abspath(__file__))
FIXTURE_ROOT = os.path.join(_TESTS, "lint_fixtures")
FIXTURE_PKG = os.path.join(FIXTURE_ROOT, "fixture_pkg")
TORCH_ROOT = os.path.join(_TESTS, "torch_lint_fixtures")
TORCH_PKG = os.path.join(TORCH_ROOT, "torch_fixture_pkg")

_EXPECT_RE = re.compile(r"#\s*expect:\s*([a-z0-9\-]+(?:\s*,\s*[a-z0-9\-]+)*)")

#: Every category the device-purity rule reports, each planted once.
CATEGORIES = (
    "host-subsystem", "lock", "io", "clock", "random", "host-sync",
    "host-detour", "unresolved-root",
)


def _expected(pkg: str, root: str) -> set[tuple[str, str, int]]:
    out: set[tuple[str, str, int]] = set()
    for dirpath, dirs, files in os.walk(pkg):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path, encoding="utf-8") as fh:
                for lineno, line in enumerate(fh, start=1):
                    m = _EXPECT_RE.search(line)
                    if not m:
                        continue
                    target = (
                        lineno + 1
                        if line.lstrip().startswith("#")
                        else lineno
                    )
                    for rule in m.group(1).split(","):
                        out.add((rule.strip(), rel, target))
    return out


def _shared_expected() -> set[tuple[str, str, int]]:
    return {e for e in _expected(FIXTURE_PKG, FIXTURE_ROOT)
            if e[0] != "jit-purity"}


def _site(f) -> tuple:
    return (f.rule, f.path, f.line)


@pytest.fixture(scope="module")
def shared():
    return Analyzer(Project(FIXTURE_PKG)).run()


@pytest.fixture(scope="module")
def jax_shared():
    return j_engine.Analyzer(j_engine.Project(FIXTURE_PKG)).run()


@pytest.fixture(scope="module")
def device():
    return Analyzer(Project(TORCH_PKG)).run()


# -- the JAX fixture: shared families ------------------------------------

def test_marker_scans_are_not_vacuous():
    assert len(_shared_expected()) >= 10
    torch_expected = _expected(TORCH_PKG, TORCH_ROOT)
    assert {r for r, _, _ in torch_expected} == {"device-purity"}
    assert len(torch_expected) >= len(CATEGORIES)


def test_every_marked_shared_line_fires(shared):
    got = {_site(f) for f in shared.findings}
    missing = _shared_expected() - got
    assert not missing, f"rules failed to fire at marked lines: {sorted(missing)}"


def test_no_unmarked_findings_on_the_jax_fixture(shared):
    """Precision: nothing the fixtures did not plant — and no
    device-purity finding at all, since the fixture declares no roots."""
    extra = {_site(f) for f in shared.findings} - _shared_expected()
    assert not extra, f"unexpected findings: {sorted(extra)}"


@pytest.mark.parametrize("prefix", [
    "lock-discipline", "lock-order", "surface-metric", "surface-env",
    "surface-op", "surface-flag", "hygiene-unused-import",
    "hygiene-thread-death",
])
def test_shared_rule_matches_the_jax_analyzer(prefix, shared, jax_shared):
    def pick(result):
        return [
            (f.rule, f.path, f.line, f.col, f.severity, f.message, f.symbol)
            for f in result.findings + result.suppressed
            if f.rule == prefix
        ]

    mine = pick(shared)
    assert mine, f"{prefix} never fired on the fixture"
    assert mine == pick(jax_shared)


def test_inline_suppression_admits_exactly_the_marked_line(shared):
    sup = [f for f in shared.suppressed if f.rule == "lock-discipline"]
    assert [f.symbol for f in sup] == ["Racy._errors@suppressed_read"]
    live = {f.symbol for f in shared.findings if f.rule == "lock-discipline"}
    assert sup[0].symbol not in live


def test_lock_order_cycle_reports_both_edges(shared):
    edges = [f for f in shared.findings if f.rule == "lock-order"]
    a = "fixture_pkg.bad_lockorder:_LOCK_A"
    b = "fixture_pkg.bad_lockorder:_LOCK_B"
    assert {f.symbol for f in edges} == {f"{a}->{b}", f"{b}->{a}"}
    [inter] = [f for f in edges if f.symbol == f"{a}->{b}"]
    assert "_grab_b" in inter.message
    assert "bad_lockorder.py:17" in inter.message


def test_thread_death_resolves_module_and_method_targets(shared):
    hits = {
        f.symbol for f in shared.findings if f.rule == "hygiene-thread-death"
    }
    assert {"fragile_worker", "Worker.self._run"} <= hits
    assert not any("safe_worker" in s for s in hits)


# -- the device-purity fixture -------------------------------------------

def test_every_marked_device_line_fires(device):
    got = {_site(f) for f in device.findings}
    missing = _expected(TORCH_PKG, TORCH_ROOT) - got
    assert not missing, f"device-purity missed marked lines: {sorted(missing)}"


def test_no_unmarked_device_findings(device):
    extra = {_site(f) for f in device.findings} - _expected(
        TORCH_PKG, TORCH_ROOT
    )
    assert not extra, f"unexpected findings: {sorted(extra)}"


def test_device_purity_covers_every_category(device):
    cats = {
        f.message.split(":", 1)[0]
        for f in device.findings + device.suppressed
        if f.rule == "device-purity"
    }
    assert cats == set(CATEGORIES)


@pytest.mark.parametrize("category", CATEGORIES)
def test_each_category_is_planted_once_in_bad_device(category, device):
    hits = [
        f for f in device.findings + device.suppressed
        if f.message.startswith(category + ":")
    ]
    assert hits, category
    assert all(
        f.path.endswith(("bad_device.py", "__init__.py")) for f in hits
    )


def test_clean_control_is_never_flagged(device):
    assert not any(
        f.path.endswith("clean_device.py")
        for f in device.findings + device.suppressed
    )
    # Its roots are real roots: the rule looked and found nothing.
    graph = CallGraph.build(Project(TORCH_PKG))
    roots = {f.qname for f in graph.roots()}
    assert {"torch_fixture_pkg.clean_device.clean_root",
            "torch_fixture_pkg.clean_device.one_sync_per_call"} <= roots


def test_detour_names_the_syncing_callee(device):
    [f] = [f for f in device.findings if f.message.startswith("host-detour")]
    assert "_twice" in f.message and "_peek" in f.message
    assert "once per iteration" in f.message


def test_declared_boundary_is_admitted_and_not_entered(device):
    [f] = [f for f in device.suppressed if f.rule == "device-purity"]
    assert f.message.startswith("host-detour: call into bad_device._cached_build")
    # The callee's open() is behind the boundary: never reported.
    assert not any("open()" in g.message for g in device.findings)


def test_unresolved_root_is_reported_at_the_table():
    [f] = [
        f for f in Analyzer(Project(TORCH_PKG)).run().findings
        if f.message.startswith("unresolved-root")
    ]
    assert f.path.endswith("torch_fixture_pkg/__init__.py")
    assert "bad_device.renamed_away" in f.message
    graph = CallGraph.build(Project(TORCH_PKG))
    assert [n for n, _, _ in graph.unresolved_roots] == [
        "bad_device.renamed_away"
    ]


def test_declared_roots_read_the_table_literal():
    names = [n for n, _, _ in declared_roots(Project(TORCH_PKG))]
    assert names[0] == "bad_device.subsystem_root"
    assert len(names) == 13


def test_host_sync_before_the_loop_is_one_sync_per_call(device):
    """``range(_steps(hi))`` evaluates once; ``int(iters)`` is an option
    (keyword-only); ``float(scale)`` has a constant default."""
    assert not any("clean_root" in f.message for f in device.findings)


def test_baseline_round_trip(tmp_path, device):
    path = os.path.join(tmp_path, "baseline.json")
    Baseline.from_findings(
        device.findings, history=["test: accept everything"]
    ).save(path)
    rerun = Analyzer(Project(TORCH_PKG), baseline=Baseline.load(path)).run()
    assert rerun.clean
    assert len(rerun.baselined) == len(device.findings)


def test_rules_subset_runs_only_named_families():
    result = Analyzer(Project(TORCH_PKG), rules=("device-purity",)).run()
    assert {f.rule for f in result.findings} == {"device-purity"}
    result = Analyzer(Project(FIXTURE_PKG), rules=("lock-discipline",)).run()
    assert {f.rule for f in result.findings} == {"lock-discipline"}


def test_unknown_rule_family_rejected():
    with pytest.raises(ValueError, match="unknown rule"):
        Analyzer(Project(FIXTURE_PKG), rules=("jit-purity",))


def test_diff_baseline_prints_only_new_findings(tmp_path, device, capsys):
    from kubernetesclustercapacity_tpu_torch.analysis import cli

    bl_path = os.path.join(tmp_path, "bl.json")
    Baseline.from_findings(device.findings).save(bl_path)
    rc = cli.run([TORCH_PKG, "--baseline", bl_path, "--diff-baseline"])
    assert rc == 0
    assert capsys.readouterr().out == ""

    victim = device.findings[0]
    Baseline.from_findings(device.findings[1:]).save(bl_path)
    rc = cli.run([TORCH_PKG, "--baseline", bl_path, "--diff-baseline"])
    out = capsys.readouterr().out
    assert rc == 1
    assert [ln for ln in out.splitlines() if ln] == [victim.render()]
