"""The port's analyzer engine: the same suppression grammar, baseline
file and finding rendering as the JAX engine's — byte for byte on the
same tree — and the ``kccap-torch-lint`` CLI contract (exit codes,
``--json`` artifact, ``--write-baseline`` round trip)."""

import json
import os
import subprocess
import sys

import pytest

from kubernetesclustercapacity_tpu.analysis import engine as j_engine
from kubernetesclustercapacity_tpu_torch.analysis import engine as t_engine
from kubernetesclustercapacity_tpu_torch.analysis.engine import (
    Analyzer,
    Baseline,
    Finding,
    Project,
    parse_suppressions,
)

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURE_PKG = os.path.join(_REPO, "tests", "lint_fixtures", "fixture_pkg")
TORCH_FIXTURE_PKG = os.path.join(
    _REPO, "tests", "torch_lint_fixtures", "torch_fixture_pkg"
)

#: The rule families both engines share (the JAX package's jit-purity
#: and the port's device-purity are each their own).
SHARED = ("lock-discipline", "lock-order", "surface", "hygiene")


# -- suppression grammar: the JAX engine's, case for case ---------------

@pytest.mark.parametrize("text", [
    "x = 1\ny = 2  # kccap: lint-ok[rule-a]\n",
    "x = 1\n# kccap: lint-ok[rule-a] reason prose\ny = 2\n",
    "z = 0  # kccap: lint-ok[a, b-c]\n",
    "z = 0  # kccap: lint-ok[*]\n",
    "# kccap: something-else\nx = 1\n",
    "a = 1  # kccap: lint-ok[device-purity] cached build\n",
    "    # kccap: lint-ok[ x ,y ]\n    pass\n",
])
def test_suppressions_parse_as_the_jax_engine_parses(text):
    assert parse_suppressions(text) == j_engine.parse_suppressions(text)


def test_standalone_suppression_applies_to_next_line():
    sup = parse_suppressions(
        "x = 1\n# kccap: lint-ok[rule-a] reason prose\ny = 2\n"
    )
    assert sup[2] == {"rule-a"} and sup[3] == {"rule-a"}


# -- baseline file -------------------------------------------------------

def _finding(**kw):
    base = dict(
        rule="r", severity="error", path="p.py", line=3, col=0,
        message="m", symbol="s",
    )
    base.update(kw)
    return Finding(**base)


def test_baseline_file_is_byte_identical_to_the_jax_engines(tmp_path):
    t_path = os.path.join(tmp_path, "t.json")
    j_path = os.path.join(tmp_path, "j.json")
    Baseline.from_findings([_finding(), _finding(symbol="z")],
                           history=["note one"]).save(t_path)
    j_engine.Baseline.from_findings(
        [j_engine.Finding(**_finding().to_json()),
         j_engine.Finding(**_finding(symbol="z").to_json())],
        history=["note one"],
    ).save(j_path)
    with open(t_path, "rb") as a, open(j_path, "rb") as b:
        assert a.read() == b.read()


def test_baseline_load_missing_file_is_empty(tmp_path):
    bl = Baseline.load(os.path.join(tmp_path, "absent.json"))
    assert bl.entries == set() and bl.history == []


def test_baseline_load_rejects_malformed(tmp_path):
    path = os.path.join(tmp_path, "bad.json")
    with open(path, "w") as fh:
        json.dump({"not": "a baseline"}, fh)
    with pytest.raises(ValueError):
        Baseline.load(path)


def test_repo_torch_baseline_is_empty_and_narrates_its_fixes():
    bl = Baseline.load(os.path.join(_REPO, "LINT_BASELINE_TORCH.json"))
    assert bl.entries == set()
    assert bl.history, "the checked-in baseline must narrate its fixes"
    text = " ".join(bl.history)
    for site in ("service/server.py", "telemetry/memledger.py",
                 "devcache.py"):
        assert site in text


def test_finding_render_and_key():
    f = _finding()
    assert f.render() == "p.py:3:0: error [r] m"
    assert f.key() == ("r", "p.py", "s")
    j = j_engine.Finding(**f.to_json())
    assert f.render() == j.render() and f.to_json() == j.to_json()


# -- the same tree, the same findings -------------------------------------

@pytest.mark.parametrize("family", SHARED)
def test_fixture_findings_are_byte_identical_per_family(family):
    t = Analyzer(Project(FIXTURE_PKG), rules=(family,)).run()
    j = j_engine.Analyzer(j_engine.Project(FIXTURE_PKG), rules=(family,)).run()
    assert t.findings, family  # non-vacuous: the fixture plants each family
    assert [f.render() for f in t.findings] == [
        f.render() for f in j.findings
    ]
    assert [f.to_json() for f in t.findings + t.suppressed] == [
        f.to_json() for f in j.findings + j.suppressed
    ]
    assert json.dumps(t.to_json(), indent=2) == json.dumps(
        j.to_json(), indent=2
    )


def test_project_walk_matches_the_jax_engines():
    t = Project(FIXTURE_PKG)
    j = j_engine.Project(FIXTURE_PKG)
    assert [f.rel_path for f in t.files] == [f.rel_path for f in j.files]
    assert t.package_name == j.package_name and t.repo_root == j.repo_root
    assert [f.suppressions for f in t.files] == [
        f.suppressions for f in j.files
    ]


def test_engine_module_differs_only_in_the_rule_registry():
    """The engine is a copy: apart from the package name and the one
    rule family swapped in, its source is the JAX engine's."""
    with open(t_engine.__file__, encoding="utf-8") as fh:
        t_src = fh.read()
    with open(j_engine.__file__, encoding="utf-8") as fh:
        j_src = fh.read()
    normalised = t_src.replace(
        "kubernetesclustercapacity_tpu_torch", "kubernetesclustercapacity_tpu"
    )
    t_lines = normalised.splitlines()
    j_lines = j_src.splitlines()
    assert len(t_lines) == len(j_lines)
    differing = [
        (a, b) for a, b in zip(t_lines, j_lines) if a != b
    ]
    assert len(differing) <= 4, differing
    assert all(
        "device-purity" in a or "kccap-torch-lint" in a or "GPU" in a
        for a, _ in differing
    ), differing


# -- CLI contract ----------------------------------------------------------

def _run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "kubernetesclustercapacity_tpu_torch.analysis.cli"]
        + list(args),
        capture_output=True,
        text=True,
        cwd=_REPO,
        timeout=120,
    )


def test_cli_on_fixture_exits_1_with_findings():
    proc = _run_cli(TORCH_FIXTURE_PKG, "--no-baseline")
    assert proc.returncode == 1
    assert "[device-purity]" in proc.stdout
    assert "finding(s)" in proc.stdout
    assert proc.stdout.splitlines()[-1].startswith("kccap-torch-lint: ")


def test_cli_json_artifact_is_machine_readable():
    proc = _run_cli(TORCH_FIXTURE_PKG, "--no-baseline", "--json")
    assert proc.returncode == 1
    data = json.loads(proc.stdout)
    assert data["version"] == 1 and data["clean"] is False
    assert data["counts"]["findings"] == len(data["findings"])
    assert data["counts"]["by_rule"]["device-purity"] >= 10
    assert data["counts"]["suppressed"] == 1
    sample = data["findings"][0]
    assert {"rule", "severity", "path", "line", "col", "message", "symbol"} \
        <= set(sample)


def test_cli_rules_filter():
    proc = _run_cli(
        FIXTURE_PKG, "--no-baseline", "--rules", "surface", "--json"
    )
    data = json.loads(proc.stdout)
    assert data["findings"]
    assert all(f["rule"].startswith("surface-") for f in data["findings"])


def test_cli_unknown_rule_is_usage_error():
    proc = _run_cli(FIXTURE_PKG, "--rules", "jit-purity")
    assert proc.returncode == 2
    assert "unknown rule" in proc.stderr and "device-purity" in proc.stderr


def test_cli_write_baseline_round_trip(tmp_path):
    bl_path = os.path.join(tmp_path, "bl.json")
    wrote = _run_cli(
        TORCH_FIXTURE_PKG, "--baseline", bl_path, "--write-baseline"
    )
    assert wrote.returncode == 0
    rerun = _run_cli(TORCH_FIXTURE_PKG, "--baseline", bl_path)
    assert rerun.returncode == 0, rerun.stdout
    assert "0 finding(s)" in rerun.stdout


def test_cli_missing_package_dir_is_usage_error(tmp_path):
    proc = _run_cli(os.path.join(tmp_path, "nowhere"))
    assert proc.returncode == 2


def test_cli_defaults_to_the_torch_baseline():
    from kubernetesclustercapacity_tpu_torch.analysis import cli

    assert cli.BASELINE_FILENAME == "LINT_BASELINE_TORCH.json"
    assert cli._default_package_dir() == os.path.join(
        _REPO, "kubernetesclustercapacity_tpu_torch"
    )
