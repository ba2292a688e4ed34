"""Hygiene walks that keep the tree clean without external tooling.

The satellite CI story wires ``ruff`` into ``pyproject.toml``, but the
analyzer must not *depend* on ruff existing (this environment bakes no
linter into the image).  This module carries the highest-value pyflakes
subset natively so the tier-1 gate enforces it everywhere:

* ``hygiene-unused-import`` — an imported name never referenced in the
  module.  ``__init__.py`` files are exempt (the re-export idiom), as
  are ``__future__`` imports and names listed in ``__all__``.
* ``hygiene-thread-death`` — a ``threading.Thread`` target whose body
  can raise outside any ``try``/``except``.  A worker that dies
  silently is how lockset gaps hide: the thread's absence looks like
  quiescence, its unjoined exception goes to a stderr hook nobody
  reads, and every invariant it maintained (heartbeats, queue drains,
  breaker resets) silently stops holding.  A target is *protected*
  when every statement that can raise sits inside a ``try`` with a
  handler (docstrings, constant assignments, ``return``/``pass`` are
  raise-free; loops and ``if``/``with`` bodies are checked
  recursively).  Deliberately-fragile workers suppress at the
  ``Thread(...)`` site with the usual ``lint-ok`` marker and a reason.
"""

from __future__ import annotations

import ast

from kubernetesclustercapacity_tpu_torch.analysis.callgraph import dotted
from kubernetesclustercapacity_tpu_torch.analysis.engine import Finding, Project

__all__ = ["check"]


def _used_names(tree: ast.Module) -> set[str]:
    used: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            # `a.b` usage of `import a.b` style bindings is covered by
            # the base Name; nothing extra needed here.
            pass
    return used


def _exported_names(tree: ast.Module) -> set[str]:
    out: set[str] = set()
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets
            )
            and isinstance(node.value, (ast.List, ast.Tuple))
        ):
            for elt in node.value.elts:
                if isinstance(elt, ast.Constant) and isinstance(
                    elt.value, str
                ):
                    out.add(elt.value)
    return out


def _is_trivial_expr(node) -> bool:
    """Expressions that cannot raise: constants, bare names, and
    attribute chains off them (``self.x`` can raise AttributeError in
    principle; in a worker body that is a programming error the rule
    should surface, so only Name/Constant are trivial)."""
    return isinstance(node, (ast.Constant, ast.Name))


def _protected_stmt(stmt) -> bool:
    """Can this statement raise outside a try/except?"""
    if isinstance(stmt, ast.Try):
        # A try with no handler (try/finally) protects nothing.
        return bool(stmt.handlers) and _protected_body(
            stmt.orelse
        ) and _protected_body(stmt.finalbody)
    if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
        return True  # docstring
    if isinstance(stmt, (ast.Pass, ast.Break, ast.Continue)):
        return True
    if isinstance(stmt, ast.Return):
        return stmt.value is None or _is_trivial_expr(stmt.value)
    if isinstance(stmt, ast.Assign):
        return _is_trivial_expr(stmt.value) and all(
            isinstance(t, ast.Name) for t in stmt.targets
        )
    if isinstance(stmt, ast.While):
        return _is_trivial_expr(stmt.test) and _protected_body(
            stmt.body
        ) and _protected_body(stmt.orelse)
    if isinstance(stmt, ast.If):
        return (
            _is_trivial_expr(stmt.test)
            and _protected_body(stmt.body)
            and _protected_body(stmt.orelse)
        )
    return False


def _protected_body(stmts) -> bool:
    return all(_protected_stmt(s) for s in stmts)


def _thread_targets(src) -> list:
    """``threading.Thread(target=X)`` sites -> (call node, target name,
    enclosing class name or None)."""
    out = []
    class_of: dict[int, str] = {}
    for cls in ast.walk(src.tree):
        if isinstance(cls, ast.ClassDef):
            for sub in ast.walk(cls):
                class_of.setdefault(id(sub), cls.name)
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        path = dotted(node.func)
        if path is None or path.rsplit(".", 1)[-1] != "Thread":
            continue
        target = None
        for kw in node.keywords:
            if kw.arg == "target":
                target = kw.value
        if target is None and len(node.args) >= 2:
            target = node.args[1]
        if target is None:
            continue
        tgt_path = dotted(target)
        if tgt_path is None:
            continue  # lambda/partial: unresolvable, skip
        out.append((node, tgt_path, class_of.get(id(node))))
    return out


def _resolve_target(src, tgt_path: str, cls_name: str | None):
    """The FunctionDef a thread target names, or None.

    ``self._run`` resolves inside the enclosing class (bases included
    by bare-name search across the file); a bare name resolves to any
    same-named def in the file (worker defs are locally unique in this
    package).
    """
    if tgt_path.startswith(("self.", "cls.")):
        meth = tgt_path.split(".", 1)[1]
        if "." in meth:
            return None
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(
                        sub, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ) and sub.name == meth:
                        return sub
        return None
    if "." in tgt_path:
        return None  # other-object method: not this file's to prove
    for node in ast.walk(src.tree):
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef)
        ) and node.name == tgt_path:
            return node
    return None


def _check_thread_death(src):
    for call, tgt_path, cls_name in _thread_targets(src):
        fn = _resolve_target(src, tgt_path, cls_name)
        if fn is None:
            continue
        body = fn.body
        if _protected_body(body):
            continue
        yield Finding(
            rule="hygiene-thread-death",
            severity="warning",
            path=src.rel_path,
            line=call.lineno,
            col=call.col_offset,
            message=(
                f"thread target `{tgt_path}` (def at line {fn.lineno}) "
                "can raise outside any try/except — the worker would "
                "die silently, and every invariant it maintains stops "
                "holding with no signal"
            ),
            symbol=f"{(cls_name + '.') if cls_name else ''}{tgt_path}",
        )


def check(project: Project):
    findings: list[Finding] = []
    for src in project.files:
        findings.extend(_check_thread_death(src))
        if src.rel_path.endswith("__init__.py"):
            continue
        used = _used_names(src.tree)
        exported = _exported_names(src.tree)
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Import):
                bindings = [
                    (
                        alias.asname
                        if alias.asname
                        else alias.name.split(".", 1)[0],
                        alias.name,
                    )
                    for alias in node.names
                ]
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                bindings = [
                    (alias.asname or alias.name, alias.name)
                    for alias in node.names
                    if alias.name != "*"
                ]
            else:
                continue
            for local, original in bindings:
                if local in used or local in exported:
                    continue
                findings.append(
                    Finding(
                        rule="hygiene-unused-import",
                        severity="warning",
                        path=src.rel_path,
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f"`{original}` is imported as `{local}` but "
                            "never used in this module"
                        ),
                        symbol=f"{local}",
                    )
                )
    return findings
