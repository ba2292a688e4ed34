"""The port's ``-bench-diff`` against ``kubernetesclustercapacity_tpu.
analysis.benchdiff``, on the CPU.

Direction inference, the noise model (defaults, overrides, the committed
``BENCH_THRESHOLDS.json``), row verdicts with parity gates, degraded
artifacts, missing and added rows and trajectory mode give equal answers
in both packages on the same inputs.  ``kccap-torch -bench-diff`` prints
what the JAX CLI prints, byte for byte, with the same exit code: on the
committed ``BENCH_r04.json`` → ``BENCH_r05.json`` pair, on the trajectory
over a copy of the committed ``BENCH_r0*.json``, on planted regressions
and on usage errors, table and JSON.

Tolerance: none (verdicts, numbers and text are equal).
"""

import json
import pathlib
import shutil

import pytest

from kubernetesclustercapacity_tpu import cli as j_cli
from kubernetesclustercapacity_tpu.analysis import benchdiff as j_bd
from kubernetesclustercapacity_tpu_torch import cli as t_cli
from kubernetesclustercapacity_tpu_torch.analysis import benchdiff as t_bd

REPO = pathlib.Path(__file__).resolve().parents[1]
THRESHOLDS = {"default": {"direction": "auto", "rel_tol": 0.25,
                          "abs_tol": 0.05}, "rows": {}}


def _write(path, doc):
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return str(path)


def _both_cli(argv, capsys):
    out = []
    for main in (j_cli.main, t_cli.main):
        rc = main(list(argv))
        out.append((rc, *capsys.readouterr()))
    return out


@pytest.mark.parametrize("name", [
    "serving_p50_ms", "pack_seconds", "heap_bytes", "serving_rps",
    "ingest_per_sec", "fold_throughput", "serving_fold_requests", "n",
])
def test_direction_inference_equals_jax(name):
    assert t_bd.infer_direction(name) == j_bd.infer_direction(name)


@pytest.mark.parametrize("doc,row", [
    ({"default": {"rel_tol": 0.1},
      "rows": {"value": {"direction": "lower_is_better"}}}, "value"),
    (None, "x_ms"),
    (None, "x_rps"),
    ({"rows": {"p50_ms": {"gate": "parity_diffs"}}}, "p50_ms"),
])
def test_thresholds_resolve_as_jax(doc, row):
    assert t_bd.Thresholds(doc).for_row(row) == j_bd.Thresholds(doc).for_row(
        row)


def test_unknown_direction_rejected_with_the_same_message():
    errors = []
    for bd in (j_bd, t_bd):
        with pytest.raises(ValueError) as info:
            bd.Thresholds({"rows": {"x": {"direction": "up"}}})
        errors.append(str(info.value))
    assert errors[0] == errors[1] and "unknown direction" in errors[0]


def test_the_committed_thresholds_file_loads_equal(tmp_path):
    path = str(REPO / t_bd.THRESHOLDS_FILENAME)
    assert t_bd.THRESHOLDS_FILENAME == j_bd.THRESHOLDS_FILENAME
    for row in ("serving_p50_ms", "anything_ms", "x_rps"):
        assert (t_bd.load_thresholds(path).for_row(row)
                == j_bd.load_thresholds(path).for_row(row))
    missing = str(tmp_path / "nope.json")
    assert (t_bd.load_thresholds(missing).for_row("a_ms")
            == j_bd.load_thresholds(missing).for_row("a_ms"))


ROW_CASES = [
    ({"a_ms": 10.0, "b_ms": 10.0, "c_ms": 0.02},
     {"a_ms": 20.0, "b_ms": 11.0, "c_ms": 0.05}, None),
    ({"a_ms": 20.0, "tput_rps": 100.0}, {"a_ms": 10.0, "tput_rps": 50.0},
     None),
    ({"requests": 10.0}, {"requests": 1000.0}, None),
    ({"p50_ms": 10.0, "parity_diffs": 0.0},
     {"p50_ms": 20.0, "parity_diffs": 1.0},
     {"rows": {"p50_ms": {"gate": "parity_diffs",
                          "direction": "lower_is_better"}}}),
    ({"p50_ms": 10.0}, {"p50_ms": 20.0},
     {"rows": {"p50_ms": {"gate": "parity_diffs",
                          "direction": "lower_is_better"}}}),
    ({"kept_ms": 1.0, "dropped_ms": 2.0}, {"kept_ms": 1.0, "fresh_ms": 3.0},
     None),
    ({"a_ms": 0.0}, {"a_ms": 1.0}, None),
]


@pytest.mark.parametrize("old,new,doc", ROW_CASES)
def test_diff_rows_equal_jax(old, new, doc):
    j_rows, j_missing, j_added = j_bd.diff_rows(old, new, j_bd.Thresholds(doc))
    t_rows, t_missing, t_added = t_bd.diff_rows(old, new, t_bd.Thresholds(doc))
    assert [r.to_json() for r in t_rows] == [r.to_json() for r in j_rows]
    assert (t_missing, t_added) == (j_missing, j_added)


@pytest.mark.parametrize("doc", [
    {"x_ms": 1.5, "label": "str", "flag": True},
    {"n": 1, "cmd": ["bench"], "rc": 0, "parsed": {"x_ms": 2.0}},
    {"cmd": ["bench"], "parsed": None},
    {"cmd": ["bench"], "parsed": {"error": "OOM", "value": None}},
])
def test_artifact_shapes_classified_as_jax(tmp_path, doc):
    path = _write(tmp_path / "a.json", doc)
    assert t_bd.load_rows(path) == j_bd.load_rows(path)


def test_non_object_artifact_is_a_usage_error(tmp_path):
    path = _write(tmp_path / "a.json", [1, 2, 3])
    with pytest.raises(ValueError):
        t_bd.load_rows(path)


def test_degraded_pair_renders_as_jax(tmp_path):
    old = _write(tmp_path / "old.json", {"cmd": ["bench"], "parsed": None})
    new = _write(tmp_path / "new.json", {"x_ms": 1.0})
    j = j_bd.diff_files(old, new, j_bd.Thresholds())
    t = t_bd.diff_files(old, new, t_bd.Thresholds())
    assert t.to_json() == j.to_json() and not t.comparable
    assert t_bd.render(t) == j_bd.render(j)


def test_trajectory_equals_jax(tmp_path):
    for i, v in enumerate((1.0, 1.01, 9.0), start=1):
        _write(tmp_path / f"BENCH_r0{i}.json", {"a_ms": v})
    j = j_bd.trajectory(str(tmp_path), j_bd.Thresholds())
    t = t_bd.trajectory(str(tmp_path), t_bd.Thresholds())
    assert [d.to_json() for d in t] == [d.to_json() for d in j]
    assert t_bd.render_trajectory(t) == j_bd.render_trajectory(j)
    assert [len(d.regressions) for d in t] == [0, 1]


# ---------------------------------------------------------------------------
# The CLI, byte for byte
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("output", ["table", "json"])
def test_committed_r04_to_r05_equals_the_jax_cli(capsys, output):
    runs = _both_cli(["-bench-diff", str(REPO / "BENCH_r04.json"),
                      str(REPO / "BENCH_r05.json"), "-bench-thresholds",
                      str(REPO / "BENCH_THRESHOLDS.json"), "-output", output],
                     capsys)
    assert runs[0] == runs[1] and runs[0][0] == 0


@pytest.mark.parametrize("output", ["table", "json"])
def test_trajectory_over_the_committed_rounds_equals_the_jax_cli(
    tmp_path, capsys, output
):
    rounds = sorted(REPO.glob("BENCH_r0*.json"))
    assert len(rounds) >= 5
    for path in rounds + [REPO / "BENCH_THRESHOLDS.json"]:
        shutil.copy(path, tmp_path / path.name)
    runs = _both_cli(["-bench-diff", str(tmp_path), "-output", output],
                     capsys)
    assert runs[0] == runs[1]
    assert runs[0][1].replace(str(tmp_path), "")  # something was printed


@pytest.mark.parametrize("new,want", [({"a_ms": 10.5}, 0),
                                      ({"a_ms": 30.0, "fresh_ms": 2.0}, 1)])
@pytest.mark.parametrize("output", ["table", "json"])
def test_planted_pairs_equal_the_jax_cli(tmp_path, capsys, new, want,
                                         output):
    th = _write(tmp_path / "BENCH_THRESHOLDS.json", THRESHOLDS)
    old = _write(tmp_path / "old.json", {"a_ms": 10.0, "gone_ms": 1.0})
    new = _write(tmp_path / "new.json", new)
    runs = _both_cli(["-bench-diff", old, new, "-bench-thresholds", th,
                      "-output", output], capsys)
    assert runs[0] == runs[1] and runs[0][0] == want
    runs = _both_cli(["-bench-diff", old, new], capsys)  # found beside NEW
    assert runs[0] == runs[1] and runs[0][0] == want


def test_usage_errors_equal_the_jax_cli(tmp_path, capsys):
    bad = _write(tmp_path / "a.json", [1])
    good = _write(tmp_path / "b.json", {"x_ms": 1.0})
    bad_th = _write(tmp_path / "th.json", {"rows": {"x": {"direction": "?"}}})
    single = tmp_path / "one"
    single.mkdir()
    _write(single / "BENCH_r01.json", {"a_ms": 1.0})
    for argv in (["-bench-diff", "one-arg-not-a-dir"],
                 ["-bench-diff", bad, good],
                 ["-bench-diff", good, good, good],
                 ["-bench-diff", good, good, "-bench-thresholds", bad_th],
                 ["-bench-diff", str(single)],
                 ["-bench-diff", good, str(tmp_path / "missing.json")]):
        runs = _both_cli(argv, capsys)
        assert runs[0] == runs[1] and runs[0][0] == 2, argv
