"""``kccap -bench-diff``: the typed comparator over bench artifacts.

Counterpart of ``kubernetesclustercapacity_tpu/analysis/benchdiff.py``,
verbatim: pure host code over JSON files, so the port's ``-bench-diff``
prints what the JAX CLI prints, byte for byte, with the same exit code.

The repo carries its performance history as committed artifacts
(``BENCH_r01.json`` … ``BENCH_r05.json``, plus selfcheck runs), but
until now "did round N regress round N-1?" was a human eyeball over two
JSON blobs.  This module makes the comparison a typed, gated program:

* **artifact shapes are classified, not assumed** — a bench wrapper
  (``{n, cmd, rc, tail, parsed}``) whose ``parsed`` is ``None`` (no
  JSON tail survived) or an error dict (``{"error": ..., "value":
  null}``) is a DEGRADED round: it is *named* in the report but can
  never fail the gate, because "the harness fell over" is not "the
  code got slower".  A bare flat dict (the selfcheck artifacts) is
  rows directly.
* **per-row noise thresholds live in a committed file**
  (:data:`THRESHOLDS_FILENAME`) — each row carries ``direction``
  (``lower_is_better`` / ``higher_is_better`` / ``informational``),
  ``rel_tol`` and ``abs_tol``; unknown rows fall back to the
  ``default`` entry with direction inferred from the row name
  (``*_ms`` is latency, ``*per_sec``/``*_rps`` is throughput,
  anything else is informational).  A regression must clear BOTH
  tolerances — relative noise on a microsecond row and absolute
  noise on a milliseconds row both stay quiet.
* **gated rows respect their parity fields** — ``serving_p50_ms`` is
  only a valid number when ``serving_parity_diffs == 0`` on both
  sides (a fast wrong answer is not a fast answer); a row whose gate
  is nonzero or missing on either side is reported ``gated``, never
  compared.
* **missing and renamed rows are named, not ignored** — a row present
  in OLD but absent from NEW is exactly how a silently-dropped
  benchmark hides; it lands in ``missing`` (and new rows in
  ``added``) so the report says so, without failing the gate.
* **trajectory mode** walks every ``BENCH_r*.json`` in a directory in
  round order and diffs each consecutive comparable pair — the whole
  history audited in one command.

Exit codes mirror ``kccap-lint``: 0 clean, 1 at least one
threshold-breaching regression, 2 usage error.  ``--json`` emits the
full machine-readable artifact instead of the text report.
"""

from __future__ import annotations

import glob
import json
import math
import os
import re
from dataclasses import dataclass, field

__all__ = [
    "THRESHOLDS_FILENAME",
    "Thresholds",
    "RowDiff",
    "BenchDiff",
    "load_rows",
    "load_thresholds",
    "diff_files",
    "trajectory",
    "render",
    "render_trajectory",
]

#: The committed per-row noise-threshold file (repo root, next to the
#: BENCH_r*.json artifacts it governs).
THRESHOLDS_FILENAME = "BENCH_THRESHOLDS.json"

_DIRECTIONS = ("lower_is_better", "higher_is_better", "informational")

#: Direction inference for rows the thresholds file does not name:
#: latency-shaped names regress upward, throughput-shaped names regress
#: downward, anything else is informational (counts, config echoes).
_LOWER_PAT = re.compile(r"(_ms|_s|_seconds|_bytes)$")
_HIGHER_PAT = re.compile(r"(per_sec|_rps|_throughput)$")


def infer_direction(name: str) -> str:
    if _HIGHER_PAT.search(name):
        return "higher_is_better"
    if _LOWER_PAT.search(name):
        return "lower_is_better"
    return "informational"


class Thresholds:
    """The committed noise model: ``default`` entry + per-row
    overrides, each ``{direction?, rel_tol?, abs_tol?, gate?}``."""

    def __init__(self, spec: dict | None = None) -> None:
        spec = spec or {}
        self.default = {
            "direction": "auto",
            "rel_tol": 0.25,
            "abs_tol": 0.05,
        }
        self.default.update(spec.get("default", {}))
        self.rows: dict[str, dict] = {
            str(k): dict(v) for k, v in spec.get("rows", {}).items()
        }
        for name, row in self.rows.items():
            d = row.get("direction")
            if d is not None and d not in _DIRECTIONS:
                raise ValueError(
                    f"row {name!r}: unknown direction {d!r} "
                    f"(one of {_DIRECTIONS})"
                )

    def for_row(self, name: str) -> dict:
        """The effective ``{direction, rel_tol, abs_tol, gate}`` for a
        row — override merged over default, ``auto`` resolved by name."""
        eff = dict(self.default)
        eff.update(self.rows.get(name, {}))
        if eff.get("direction", "auto") == "auto":
            eff["direction"] = infer_direction(name)
        eff.setdefault("gate", None)
        return eff


def load_thresholds(path: str | None) -> Thresholds:
    """Load the committed thresholds file; a missing path means the
    built-in defaults (direction inference, 25%/0.05 tolerances)."""
    if path is None or not os.path.exists(path):
        return Thresholds()
    with open(path, encoding="utf-8") as f:
        return Thresholds(json.load(f))


def _numeric_rows(d: dict) -> dict[str, float]:
    out: dict[str, float] = {}
    for k, v in d.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        if isinstance(v, float) and not math.isfinite(v):
            continue
        out[str(k)] = float(v)
    return out


def load_rows(path: str) -> tuple[dict[str, float], str | None]:
    """Classify one artifact into ``(rows, degraded_reason)``.

    A wrapper artifact contributes its ``parsed`` dict; ``parsed`` of
    ``None`` or an error dict (``error`` set, ``value`` null) makes the
    round degraded — rows empty, reason named.  A bare flat dict (the
    selfcheck shape) is rows directly.  A file that is not JSON or not
    a dict raises ``ValueError`` (usage error, exit 2).
    """
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: bench artifact is not a JSON object")
    if "parsed" in doc and ("cmd" in doc or "tail" in doc):
        parsed = doc.get("parsed")
        if parsed is None:
            return {}, "no parsed JSON tail (harness emitted nothing)"
        if not isinstance(parsed, dict):
            return {}, f"parsed tail is {type(parsed).__name__}, not a dict"
        if parsed.get("error") is not None and parsed.get("value") is None:
            return {}, f"degraded run: {parsed['error']}"
        return _numeric_rows(parsed), None
    return _numeric_rows(doc), None


@dataclass
class RowDiff:
    """One row's comparison: the typed unit the gate sums over."""

    name: str
    old: float
    new: float
    direction: str
    rel_tol: float
    abs_tol: float
    gate: str | None
    #: ok | regression | improved | informational | gated
    verdict: str
    note: str = ""

    @property
    def delta(self) -> float:
        return self.new - self.old

    @property
    def rel_change(self) -> float:
        if self.old == 0.0:
            return math.inf if self.new != self.old else 0.0
        return (self.new - self.old) / abs(self.old)

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "old": self.old,
            "new": self.new,
            "delta": round(self.delta, 6),
            "rel_change": (
                None
                if math.isinf(self.rel_change)
                else round(self.rel_change, 6)
            ),
            "direction": self.direction,
            "rel_tol": self.rel_tol,
            "abs_tol": self.abs_tol,
            "gate": self.gate,
            "verdict": self.verdict,
            "note": self.note,
        }


@dataclass
class BenchDiff:
    """The full comparison of two artifacts."""

    old_path: str
    new_path: str
    old_degraded: str | None
    new_degraded: str | None
    rows: list[RowDiff] = field(default_factory=list)
    missing: list[str] = field(default_factory=list)
    added: list[str] = field(default_factory=list)

    @property
    def regressions(self) -> list[RowDiff]:
        return [r for r in self.rows if r.verdict == "regression"]

    @property
    def comparable(self) -> bool:
        return self.old_degraded is None and self.new_degraded is None

    def to_json(self) -> dict:
        return {
            "old": self.old_path,
            "new": self.new_path,
            "old_degraded": self.old_degraded,
            "new_degraded": self.new_degraded,
            "comparable": self.comparable,
            "rows": [r.to_json() for r in self.rows],
            "missing": list(self.missing),
            "added": list(self.added),
            "regressions": [r.name for r in self.regressions],
        }


def diff_rows(
    old: dict[str, float],
    new: dict[str, float],
    thresholds: Thresholds,
) -> tuple[list[RowDiff], list[str], list[str]]:
    """Compare two row dicts under the noise model; returns
    ``(row_diffs, missing_in_new, added_in_new)``."""
    out: list[RowDiff] = []
    for name in sorted(old):
        if name not in new:
            continue
        eff = thresholds.for_row(name)
        rd = RowDiff(
            name=name,
            old=old[name],
            new=new[name],
            direction=eff["direction"],
            rel_tol=float(eff["rel_tol"]),
            abs_tol=float(eff["abs_tol"]),
            gate=eff["gate"],
            verdict="ok",
        )
        gate = eff["gate"]
        if gate is not None:
            og, ng = old.get(gate), new.get(gate)
            if og is None or ng is None:
                rd.verdict = "gated"
                rd.note = f"gate row {gate!r} missing"
                out.append(rd)
                continue
            if og != 0 or ng != 0:
                rd.verdict = "gated"
                rd.note = (
                    f"gate {gate}={og:g}->{ng:g} nonzero — row not a "
                    "valid measurement"
                )
                out.append(rd)
                continue
        if rd.direction == "informational":
            rd.verdict = "informational"
            out.append(rd)
            continue
        worse = (
            rd.delta if rd.direction == "lower_is_better" else -rd.delta
        )
        rel = abs(rd.rel_change) if rd.old != 0.0 else math.inf
        if worse > 0 and rel > rd.rel_tol and abs(worse) > rd.abs_tol:
            rd.verdict = "regression"
            rd.note = (
                f"{rel * 100:.1f}% worse (tol {rd.rel_tol * 100:.0f}%, "
                f"abs {rd.abs_tol:g})"
            )
        elif worse < 0 and rel > rd.rel_tol and abs(worse) > rd.abs_tol:
            rd.verdict = "improved"
        out.append(rd)
    missing = sorted(k for k in old if k not in new)
    added = sorted(k for k in new if k not in old)
    return out, missing, added


def diff_files(
    old_path: str, new_path: str, thresholds: Thresholds
) -> BenchDiff:
    """Compare two artifacts on disk (the ``kccap -bench-diff OLD NEW``
    core).  Degraded artifacts produce a named, empty, never-failing
    comparison."""
    old_rows, old_deg = load_rows(old_path)
    new_rows, new_deg = load_rows(new_path)
    bd = BenchDiff(
        old_path=old_path,
        new_path=new_path,
        old_degraded=old_deg,
        new_degraded=new_deg,
    )
    if not bd.comparable:
        return bd
    bd.rows, bd.missing, bd.added = diff_rows(
        old_rows, new_rows, thresholds
    )
    return bd


_ROUND_PAT = re.compile(r"BENCH_r(\d+)\.json$")


def trajectory(
    directory: str, thresholds: Thresholds
) -> list[BenchDiff]:
    """Walk every ``BENCH_r*.json`` in ``directory`` in round order and
    diff each consecutive pair (degraded rounds stay in the walk — the
    pair is emitted, named degraded, and skipped by the gate)."""
    paths = []
    for p in glob.glob(os.path.join(directory, "BENCH_r*.json")):
        m = _ROUND_PAT.search(os.path.basename(p))
        if m:
            paths.append((int(m.group(1)), p))
    paths.sort()
    if len(paths) < 2:
        raise ValueError(
            f"{directory}: trajectory mode needs >= 2 BENCH_r*.json "
            f"rounds (found {len(paths)})"
        )
    return [
        diff_files(paths[i][1], paths[i + 1][1], thresholds)
        for i in range(len(paths) - 1)
    ]


# -- text rendering ---------------------------------------------------


def _fmt(v: float) -> str:
    return f"{v:g}"


def render(bd: BenchDiff) -> str:
    """The human report for one pair (regressions first, then the
    bookkeeping nobody may silently drop)."""
    lines = [f"bench-diff: {bd.old_path} -> {bd.new_path}"]
    if bd.old_degraded:
        lines.append(f"  OLD degraded: {bd.old_degraded}")
    if bd.new_degraded:
        lines.append(f"  NEW degraded: {bd.new_degraded}")
    if not bd.comparable:
        lines.append(
            "  not comparable — degraded rounds are named, never "
            "failed"
        )
        return "\n".join(lines)
    for r in bd.regressions:
        lines.append(
            f"  REGRESSION {r.name}: {_fmt(r.old)} -> {_fmt(r.new)} "
            f"({r.note})"
        )
    for r in bd.rows:
        if r.verdict == "improved":
            lines.append(
                f"  improved   {r.name}: {_fmt(r.old)} -> {_fmt(r.new)}"
            )
        elif r.verdict == "gated":
            lines.append(f"  gated      {r.name}: {r.note}")
    for name in bd.missing:
        lines.append(f"  missing    {name}: in OLD, absent from NEW")
    for name in bd.added:
        lines.append(f"  added      {name}: new in NEW")
    n_ok = sum(1 for r in bd.rows if r.verdict in ("ok", "informational"))
    lines.append(
        f"  {len(bd.regressions)} regression(s), "
        f"{sum(1 for r in bd.rows if r.verdict == 'improved')} "
        f"improved, {n_ok} within noise, "
        f"{sum(1 for r in bd.rows if r.verdict == 'gated')} gated, "
        f"{len(bd.missing)} missing, {len(bd.added)} added"
    )
    return "\n".join(lines)


def render_trajectory(diffs: list[BenchDiff]) -> str:
    out = [render(bd) for bd in diffs]
    total = sum(len(bd.regressions) for bd in diffs)
    out.append(
        f"trajectory: {len(diffs)} pair(s) walked, {total} "
        "regression(s) total"
    )
    return "\n\n".join(out)
