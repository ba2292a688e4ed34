"""Analyzer core: findings, suppressions, baseline, and the rule runner.

Design constraints that shaped this module:

* **Never import the analyzed code.**  Every rule works on ASTs and
  source text, so ``kccap-torch-lint`` runs identically with or without a
  GPU, and a module with an import-time bug still gets linted.
* **Line-independent baseline identity.**  A finding's baseline key is
  ``(rule, path, symbol)`` — the ``symbol`` is a stable semantic anchor
  (function qname, ``Class.field@method``, metric name) so an unrelated
  edit shifting line numbers does not resurrect baselined findings.
* **Suppression is visible at the offending line.**  ``# kccap:
  lint-ok[rule]`` (trailing on the flagged line, or a standalone
  comment on the line above) admits exactly the named rules —
  ``lint-ok[*]`` admits everything — so every accepted violation is
  greppable next to the code it excuses.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass

__all__ = [
    "Finding",
    "SourceFile",
    "Project",
    "Baseline",
    "Analyzer",
    "AnalysisResult",
    "parse_suppressions",
]

SEVERITIES = ("error", "warning")

#: ``# kccap: lint-ok[rule-a,rule-b]`` (optionally followed by prose).
_SUPPRESS_RE = re.compile(
    r"#\s*kccap:\s*lint-ok\[\s*([A-Za-z0-9_\-*]+(?:\s*,\s*[A-Za-z0-9_\-*]+)*)\s*\]"
)


@dataclass(frozen=True)
class Finding:
    """One analyzer verdict, anchored at ``path:line:col``."""

    rule: str
    severity: str
    path: str  # repo-relative, forward slashes
    line: int
    col: int
    message: str
    symbol: str = ""  # stable anchor used for baseline identity

    def key(self) -> tuple[str, str, str]:
        """Baseline identity — deliberately line-independent."""
        return (self.rule, self.path, self.symbol)

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: "
            f"{self.severity} [{self.rule}] {self.message}"
        )

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "symbol": self.symbol,
        }


def parse_suppressions(text: str) -> dict[int, set[str]]:
    """Map line number -> rule names admitted on that line.

    A trailing marker admits its own line; a standalone comment line
    admits the line below it (the only line a finding can anchor to).
    """
    out: dict[int, set[str]] = {}
    for lineno, line in enumerate(text.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        out.setdefault(lineno, set()).update(rules)
        if line.lstrip().startswith("#"):
            out.setdefault(lineno + 1, set()).update(rules)
    return out


class SourceFile:
    """One parsed package source: text, AST, and suppression map."""

    def __init__(self, abs_path: str, rel_path: str) -> None:
        self.abs_path = abs_path
        self.rel_path = rel_path.replace(os.sep, "/")
        with open(abs_path, encoding="utf-8") as fh:
            self.text = fh.read()
        self.tree = ast.parse(self.text, filename=rel_path)
        self.suppressions = parse_suppressions(self.text)

    def allows(self, rule: str, line: int) -> bool:
        admitted = self.suppressions.get(line, ())
        return "*" in admitted or rule in admitted


class Project:
    """The analyzed universe: a package directory plus repo context.

    ``package_dir`` is the python package to analyze (every ``*.py``
    under it, ``__pycache__`` pruned); ``repo_root`` (default: the
    package's parent) anchors relative paths and locates the README the
    surface rules check against.
    """

    def __init__(
        self,
        package_dir: str,
        repo_root: str | None = None,
        readme_path: str | None = None,
    ) -> None:
        self.package_dir = os.path.abspath(package_dir)
        if not os.path.isdir(self.package_dir):
            raise FileNotFoundError(f"not a directory: {package_dir}")
        self.repo_root = os.path.abspath(
            repo_root if repo_root else os.path.dirname(self.package_dir)
        )
        self.package_name = os.path.basename(self.package_dir.rstrip(os.sep))
        self.readme_path = readme_path or os.path.join(
            self.repo_root, "README.md"
        )
        self.files: list[SourceFile] = []
        for root, dirs, names in os.walk(self.package_dir):
            dirs[:] = sorted(d for d in dirs if d != "__pycache__")
            for name in sorted(names):
                if not name.endswith(".py"):
                    continue
                abs_path = os.path.join(root, name)
                rel = os.path.relpath(abs_path, self.repo_root)
                self.files.append(SourceFile(abs_path, rel))

    def readme_text(self) -> str:
        if not os.path.exists(self.readme_path):
            return ""
        with open(self.readme_path, encoding="utf-8") as fh:
            return fh.read()

    def file_by_module_tail(self, *tail: str) -> SourceFile | None:
        """The source whose path ends with ``tail`` (e.g. ``("service",
        "server.py")``), or ``None``."""
        suffix = "/".join(tail)
        for f in self.files:
            if f.rel_path.endswith(suffix):
                return f
        return None


class Baseline:
    """The checked-in set of accepted findings plus its history log.

    Shape on disk::

        {
          "version": 1,
          "history": ["<date> <PR>: <what was fixed/accepted and why>"],
          "findings": [{"rule": ..., "path": ..., "symbol": ...}, ...]
        }

    Matching is by :meth:`Finding.key` — line numbers are deliberately
    absent so the baseline survives unrelated edits.
    """

    def __init__(
        self,
        entries: set[tuple[str, str, str]] | None = None,
        history: list[str] | None = None,
    ) -> None:
        self.entries = set(entries or ())
        self.history = list(history or ())

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls()
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
        if not isinstance(data, dict) or "findings" not in data:
            raise ValueError(f"malformed baseline file: {path}")
        entries = {
            (e["rule"], e["path"], e.get("symbol", ""))
            for e in data["findings"]
        }
        return cls(entries, data.get("history", []))

    @classmethod
    def from_findings(
        cls, findings: list[Finding], history: list[str] | None = None
    ) -> "Baseline":
        return cls({f.key() for f in findings}, history)

    def save(self, path: str) -> None:
        data = {
            "version": 1,
            "history": self.history,
            "findings": [
                {"rule": r, "path": p, "symbol": s}
                for (r, p, s) in sorted(self.entries)
            ],
        }
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(data, fh, indent=2, sort_keys=False)
            fh.write("\n")

    def matches(self, finding: Finding) -> bool:
        return finding.key() in self.entries


@dataclass
class AnalysisResult:
    """Everything one analyzer run produced, pre-partitioned."""

    findings: list[Finding]  # live (not suppressed, not baselined)
    suppressed: list[Finding]  # admitted by an inline lint-ok marker
    baselined: list[Finding]  # admitted by the checked-in baseline

    @property
    def clean(self) -> bool:
        return not self.findings

    def to_json(self) -> dict:
        by_rule: dict[str, int] = {}
        for f in self.findings:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        return {
            "version": 1,
            "clean": self.clean,
            "counts": {
                "findings": len(self.findings),
                "suppressed": len(self.suppressed),
                "baselined": len(self.baselined),
                "by_rule": dict(sorted(by_rule.items())),
            },
            "findings": [f.to_json() for f in self.findings],
            "suppressed": [f.to_json() for f in self.suppressed],
        }


def _default_rules():
    # Local import: the rule modules import engine types, so the
    # registry lives behind a function to avoid a cycle at import time.
    from kubernetesclustercapacity_tpu_torch.analysis import (
        rules_hygiene,
        rules_jit,
        rules_lockorder,
        rules_locks,
        rules_surface,
    )

    return {
        "device-purity": rules_jit.check,
        "lock-discipline": rules_locks.check,
        "lock-order": rules_lockorder.check,
        "surface": rules_surface.check,
        "hygiene": rules_hygiene.check,
    }


class Analyzer:
    """Run rule families over a :class:`Project` and partition findings.

    ``rules`` restricts to a subset of family names (``device-purity``,
    ``lock-discipline``, ``surface``, ``hygiene``); the surface family
    emits per-walk rule ids (``surface-metric``, ``surface-env``, ...)
    which suppressions and baselines key on.
    """

    def __init__(
        self,
        project: Project,
        rules: tuple[str, ...] | None = None,
        baseline: Baseline | None = None,
    ) -> None:
        registry = _default_rules()
        unknown = set(rules or ()) - set(registry)
        if unknown:
            raise ValueError(
                f"unknown rule families {sorted(unknown)}; "
                f"available: {sorted(registry)}"
            )
        self.project = project
        self.rule_fns = {
            name: fn
            for name, fn in registry.items()
            if rules is None or name in rules
        }
        self.baseline = baseline or Baseline()

    def run(self) -> AnalysisResult:
        raw: list[Finding] = []
        for _, fn in sorted(self.rule_fns.items()):
            raw.extend(fn(self.project))
        raw.sort(key=lambda f: (f.path, f.line, f.col, f.rule, f.symbol))

        by_path = {f.rel_path: f for f in self.project.files}
        live: list[Finding] = []
        suppressed: list[Finding] = []
        baselined: list[Finding] = []
        for f in raw:
            src = by_path.get(f.path)
            if src is not None and src.allows(f.rule, f.line):
                suppressed.append(f)
            elif self.baseline.matches(f):
                baselined.append(f)
            else:
                live.append(f)
        return AnalysisResult(live, suppressed, baselined)
