"""Surface-conformance walks: every operator-visible name is documented.

The generalized, engine-native form of ``tests/test_metric_names.py``:
an operator greps the README for anything a scrape, an env, a wire op
or a CLI flag can surface — so everything the *code* can emit must be
in the README, and wire ops must be reachable from the bundled client.
Four walks, each its own rule id (suppressions/baselines key on them):

* ``surface-metric`` — every ``"kccap_..."`` string literal is
  ``kccap_``-prefixed snake_case AND matched by a README token (the
  README's ``kccap_client_*_total`` glob / ``{a,b}`` alternation
  shorthand is honored);
* ``surface-env`` — every ``KCCAP_*`` literal appears in the README's
  configuration table;
* ``surface-op`` — every op in the server's ``_KNOWN_OPS`` is
  README-documented and client-reachable (named in the client source);
* ``surface-flag`` — every ``add_argument("-flag")`` literal in the
  package is README-documented;
* ``surface-span`` — every field keyword a ``span(...)`` emission call
  passes (including ``**{...}`` dict-splat keys) is in the documented
  ``SPAN_FIELDS`` vocabulary, the same way phase names are pinned to
  ``phases.PHASES`` — trace consumers grep spans by field name, so an
  off-vocabulary field is a silently unqueryable one.
"""

from __future__ import annotations

import ast
import re

from kubernetesclustercapacity_tpu_torch.analysis.engine import Finding, Project

__all__ = ["check", "doc_patterns"]

_METRIC_RE = re.compile(r"""["'](kccap_[A-Za-z0-9_]+)["']""")
_SNAKE_RE = re.compile(r"kccap_[a-z0-9]+(_[a-z0-9]+)*")
_DOC_TOKEN_RE = re.compile(r"kccap_[A-Za-z0-9_*{},|]+")
_ENV_RE = re.compile(r"KCCAP_[A-Z][A-Z0-9_]*")


def doc_patterns(readme_text: str) -> list[re.Pattern]:
    """README ``kccap_*`` tokens -> matchers, honoring the observability
    table's glob (``*``) and alternation (``{a,b}``) shorthand.  Same
    grammar the metric-name test pinned; kept here so the engine and the
    test cannot drift apart."""
    patterns: list[re.Pattern] = []
    for tok in set(_DOC_TOKEN_RE.findall(readme_text)):
        plain = tok.split("{", 1)[0].rstrip("_*")
        if plain:
            patterns.append(re.compile(re.escape(plain)))
        out, i, ok = "", 0, True
        while i < len(tok):
            c = tok[i]
            if c == "*":
                out += "[a-z0-9_]*"
            elif c == "{":
                j = tok.find("}", i)
                if j == -1 or "," not in tok[i:j]:
                    ok = False
                    break
                alts = tok[i + 1 : j].split(",")
                out += "(" + "|".join(re.escape(a) for a in alts) + ")"
                i = j
            elif c in "},|":
                ok = False
                break
            else:
                out += re.escape(c)
            i += 1
        if ok:
            patterns.append(re.compile(out))
    return patterns


def _line_of(text: str, offset: int) -> int:
    return text.count("\n", 0, offset) + 1


def _word_in(text: str, word: str) -> bool:
    return re.search(
        rf"(?<![A-Za-z0-9_\-]){re.escape(word)}(?![A-Za-z0-9_\-])", text
    ) is not None


def _iter_string_sites(src, pattern: re.Pattern):
    for m in pattern.finditer(src.text):
        yield m.group(0) if m.lastindex is None else m.group(1), _line_of(
            src.text, m.start()
        )


def _check_metrics(project: Project, readme: str):
    patterns = doc_patterns(readme)
    for src in project.files:
        for name, line in _iter_string_sites(src, _METRIC_RE):
            if not _SNAKE_RE.fullmatch(name):
                yield Finding(
                    rule="surface-metric",
                    severity="error",
                    path=src.rel_path,
                    line=line,
                    col=0,
                    message=(
                        f"metric `{name}` is not kccap_-prefixed "
                        "snake_case"
                    ),
                    symbol=name,
                )
            elif not any(p.fullmatch(name) for p in patterns):
                yield Finding(
                    rule="surface-metric",
                    severity="error",
                    path=src.rel_path,
                    line=line,
                    col=0,
                    message=(
                        f"metric `{name}` is registered here but missing "
                        "from the README observability table"
                    ),
                    symbol=name,
                )


def _check_envs(project: Project, readme: str):
    for src in project.files:
        for name, line in _iter_string_sites(src, _ENV_RE):
            if not _word_in(readme, name):
                yield Finding(
                    rule="surface-env",
                    severity="error",
                    path=src.rel_path,
                    line=line,
                    col=0,
                    message=(
                        f"env var `{name}` is read here but missing from "
                        "the README configuration table"
                    ),
                    symbol=name,
                )


def _known_ops(src) -> list[tuple[str, int]]:
    """The ``_KNOWN_OPS = frozenset({...})`` literal in the server."""
    out: list[tuple[str, int]] = []
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Assign):
            continue
        names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if "_KNOWN_OPS" not in names:
            continue
        for sub in ast.walk(node.value):
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                out.append((sub.value, node.lineno))
    return out


def _check_ops(project: Project, readme: str):
    server = project.file_by_module_tail("service", "server.py")
    client = project.file_by_module_tail("service", "client.py")
    if server is None:
        return
    client_text = client.text if client is not None else ""
    for op, line in _known_ops(server):
        if not _word_in(readme, op):
            yield Finding(
                rule="surface-op",
                severity="error",
                path=server.rel_path,
                line=line,
                col=0,
                message=(
                    f"server op `{op}` is routed here but not documented "
                    "in the README"
                ),
                symbol=op,
            )
        reachable = (
            f'"{op}"' in client_text
            or f"'{op}'" in client_text
            or f"def {op}(" in client_text
        )
        if not reachable:
            yield Finding(
                rule="surface-op",
                severity="error",
                path=server.rel_path,
                line=line,
                col=0,
                message=(
                    f"server op `{op}` has no reachable client surface "
                    "(no literal or method in service/client.py)"
                ),
                symbol=f"{op}:client",
            )


def _check_flags(project: Project, readme: str):
    for src in project.files:
        for node in ast.walk(src.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
                and node.args[0].value.startswith("-")
            ):
                continue
            flag = node.args[0].value
            if not _word_in(readme, flag):
                yield Finding(
                    rule="surface-flag",
                    severity="error",
                    path=src.rel_path,
                    line=node.lineno,
                    col=node.col_offset,
                    message=(
                        f"CLI flag `{flag}` is declared here but not "
                        "documented in the README"
                    ),
                    symbol=flag,
                )


def _span_call_fields(node: ast.Call):
    """The field-name literals one ``span(...)`` call passes: explicit
    keywords plus every string key of a ``**{...}`` splat (the
    conditional-field idiom ``**({"error": e} if e else {})``)."""
    for kw in node.keywords:
        if kw.arg is not None:
            yield kw.arg, kw.value.lineno if hasattr(kw.value, "lineno") else node.lineno
        else:
            for sub in ast.walk(kw.value):
                if isinstance(sub, ast.Dict):
                    for key in sub.keys:
                        if isinstance(key, ast.Constant) and isinstance(
                            key.value, str
                        ):
                            yield key.value, key.lineno


def _check_spans(project: Project):
    from kubernetesclustercapacity_tpu_torch.telemetry.tracectx import SPAN_FIELDS

    for src in project.files:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            is_span = (
                isinstance(func, ast.Name) and func.id == "span"
            ) or (
                isinstance(func, ast.Attribute) and func.attr == "span"
            )
            if not is_span:
                continue
            for field, line in _span_call_fields(node):
                if field not in SPAN_FIELDS:
                    yield Finding(
                        rule="surface-span",
                        severity="error",
                        path=src.rel_path,
                        line=line,
                        col=node.col_offset,
                        message=(
                            f"span field `{field}` is outside the "
                            "documented SPAN_FIELDS vocabulary "
                            "(telemetry/tracectx.py) — emission would "
                            "silently drop it"
                        ),
                        symbol=field,
                    )


def check(project: Project):
    readme = project.readme_text()
    findings: list[Finding] = []
    findings.extend(_check_metrics(project, readme))
    findings.extend(_check_envs(project, readme))
    findings.extend(_check_ops(project, readme))
    findings.extend(_check_flags(project, readme))
    findings.extend(_check_spans(project))
    return findings
