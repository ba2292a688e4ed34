"""Lock-discipline checker: guarded fields stay under their lock.

The threaded classes in this codebase (MetricsRegistry, DeviceCache,
MicroBatcher, CapacityTimeline, AuditLog, ...) are safe *by convention*:
each holds a ``self._lock`` and touches its mutable state inside ``with
self._lock:`` blocks.  This rule turns the convention into a check:

1. a class is *threaded* iff it acquires a ``self.<attr>`` lock
   anywhere (``with self._lock:``) or assigns ``threading.Lock/RLock/
   Condition/Semaphore`` to an attribute in ``__init__``;
2. its *guarded fields* are the ``self.X`` attributes **written** under
   the lock outside ``__init__`` — a field someone mutates under the
   lock is a field every reader must take the lock for;
3. every read or write of a guarded field outside a with-lock block
   (outside ``__init__``, which runs before the object is shared) is a
   finding.

Known-benign escapes use the inline marker — ``# kccap:
lint-ok[lock-discipline] <why the race is acceptable>`` — so every
deliberately racy read is greppable and justified at the site.  Methods
whose bodies run with the lock already held by their caller follow the
``*_locked`` naming convention and are treated as lock-held throughout.

Closures defined inside a method are analyzed as *outside* the lock
even when the ``def`` lexically sits in a ``with`` block: the closure
body runs when called, which is generally after the block exits.

The inference itself — which classes are threaded, which attrs are
their locks, which fields those locks guard — is exposed as
:func:`lock_model` so the *dynamic* sanitizer (:mod:`.sanitize`)
instruments exactly the set the static rule checks: one model, two
provers, cross-checked both directions by ``tests/test_torch_sanitize.py``.
Lock attrs proven by construction in a base class carry into every
subclass (resolved by base name project-wide), so ``class Sub(Base)``
methods acquiring an inherited ``self._mu`` are analyzed too.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass

from kubernetesclustercapacity_tpu_torch.analysis.callgraph import dotted
from kubernetesclustercapacity_tpu_torch.analysis.engine import Finding, Project

__all__ = ["check", "lock_model", "ClassLockModel", "RULE"]

RULE = "lock-discipline"

_LOCK_CTORS = (
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
    "threading.Semaphore",
    "threading.BoundedSemaphore",
)


def _self_attr(node) -> str | None:
    """``self.X`` -> ``"X"`` (one level only), else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _lock_items(node) -> set[str]:
    """Lock attrs acquired by this ``with`` statement's items."""
    out: set[str] = set()
    for item in node.items:
        attr = _self_attr(item.context_expr)
        if attr is not None:
            out.add(attr)
    return out


def _is_lock_ctor(call: ast.Call, lock_aliases: set[str]) -> bool:
    path = dotted(call.func)
    if path is None:
        return False
    if path in lock_aliases:
        return True
    # `threading.Lock()` under any module alias for threading.
    tail = path.rsplit(".", 1)[-1]
    return tail in ("Lock", "RLock", "Condition", "Semaphore",
                    "BoundedSemaphore") and "." in path


def _methods(cls: ast.ClassDef):
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _iter_classes(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            yield node


#: Method names that mutate their receiver in place: calling one on a
#: ``self.X`` container under the lock makes X guarded state exactly
#: like an attribute store would (``self._ring.append(...)``,
#: ``self._pending[key] = ...`` — the attr node's ctx is Load either
#: way, so the scanner must recognize the mutation shapes explicitly).
_MUTATORS = frozenset(
    {
        "append", "appendleft", "add", "clear", "discard", "extend",
        "insert", "move_to_end", "pop", "popitem", "popleft", "remove",
        "setdefault", "update",
    }
)


class _MethodScanner:
    """One pass over a method body tracking whether a self-lock is held
    lexically; collects under-lock writes/reads and out-of-lock
    accesses of candidate fields."""

    def __init__(self, lock_attrs: set[str]) -> None:
        self.lock_attrs = lock_attrs
        self.under_writes: set[str] = set()
        self.accesses: list[tuple[str, bool, bool, ast.AST]] = []
        # (field, is_write, under_lock, node)

    def scan(self, method, *, assume_held: bool) -> None:
        for stmt in method.body:
            self._visit(stmt, assume_held)

    def _container_write(self, node) -> str | None:
        """``self.X[k] = v`` / ``del self.X[k]`` / ``self.X.append(v)``
        -> ``"X"`` when the mutated container is a self attr."""
        if isinstance(node, ast.Subscript) and isinstance(
            node.ctx, (ast.Store, ast.Del)
        ):
            return _self_attr(node.value)
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _MUTATORS
        ):
            return _self_attr(node.func.value)
        return None

    def _visit(self, node, held: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            # Closure bodies run later, when the lock may not be held.
            body = node.body if isinstance(node.body, list) else [node.body]
            for child in body:
                self._visit(child, False)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = _lock_items(node) & self.lock_attrs
            for item in node.items:
                self._visit(item.context_expr, held)
            for child in node.body:
                self._visit(child, held or bool(acquired))
            return
        container = self._container_write(node)
        if (
            container is not None
            and container not in self.lock_attrs
            and held
        ):
            # In-place container mutation under the lock: guards the
            # field (the access itself is recorded when the inner
            # Attribute node is visited below).
            self.under_writes.add(container)
        attr = _self_attr(node)
        if attr is not None and attr not in self.lock_attrs:
            is_write = isinstance(node.ctx, (ast.Store, ast.Del))
            if held and is_write:
                self.under_writes.add(attr)
            self.accesses.append((attr, is_write, held, node))
        for child in ast.iter_child_nodes(node):
            self._visit(child, held)


def _module_lock_aliases(tree: ast.Module) -> set[str]:
    """Lock ctor names visible in this module (e.g. ``from threading
    import Lock``) on top of the canonical dotted forms."""
    lock_aliases: set[str] = set(_LOCK_CTORS)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "threading":
            for alias in node.names:
                if alias.name in (
                    "Lock", "RLock", "Condition", "Semaphore",
                    "BoundedSemaphore",
                ):
                    lock_aliases.add(alias.asname or alias.name)
    return lock_aliases


def _ctor_proven_attrs(cls: ast.ClassDef, lock_aliases: set[str]) -> set[str]:
    """``self.X = threading.Lock()``-style attrs in this class body."""
    out: set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(
            node.value, ast.Call
        ) and _is_lock_ctor(node.value, lock_aliases):
            for tgt in node.targets:
                attr = _self_attr(tgt)
                if attr is not None:
                    out.add(attr)
    return out


@dataclass(frozen=True)
class ClassLockModel:
    """One threaded class as the lock rule understands it."""

    name: str  # class name
    path: str  # repo-relative source path
    lineno: int
    lock_attrs: frozenset  # self attrs that ARE locks
    guarded: frozenset  # self attrs written under a lock outside __init__

    @property
    def key(self) -> tuple[str, str]:
        return (self.path, self.name)


def _class_lock_attrs(
    cls: ast.ClassDef,
    lock_aliases: set[str],
    inherited: set[str],
) -> set[str]:
    """Pass 1: which self attrs are locks in this class?

    ``with self._x:`` where _x is not lock-like (e.g. a client used as
    a context manager) would poison the analysis; keep only
    lock-looking names plus ctor-proven attrs (own or inherited).
    """
    acquired: set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired |= _lock_items(node)
    ctor_proven = _ctor_proven_attrs(cls, lock_aliases)
    proven = {
        a
        for a in acquired
        if "lock" in a.lower() or "cv" in a.lower()
        or "cond" in a.lower() or "sem" in a.lower()
        or a in inherited
    }
    return proven | ctor_proven


def _base_names(cls: ast.ClassDef) -> list[str]:
    """Base-class tail names (``service.server.CapacityServer`` ->
    ``CapacityServer``)."""
    out: list[str] = []
    for b in cls.bases:
        d = dotted(b)
        if d:
            out.append(d.rsplit(".", 1)[-1])
    return out


def _scan_methods(
    cls: ast.ClassDef, lock_attrs: set[str]
) -> dict[str, "_MethodScanner"]:
    scanners: dict[str, _MethodScanner] = {}
    for method in _methods(cls):
        scanner = _MethodScanner(lock_attrs)
        scanner.scan(method, assume_held=method.name.endswith("_locked"))
        scanners[method.name] = scanner
    return scanners


def _guarded_fields(scanners: dict[str, "_MethodScanner"]) -> set[str]:
    """Pass 2: fields written under lock outside __init__."""
    guarded: set[str] = set()
    for name, scanner in scanners.items():
        if name != "__init__":
            guarded |= scanner.under_writes
    return guarded


def _ctor_index(project: Project) -> dict[str, set[str]]:
    """Class name -> ctor-proven lock attrs, project-wide.  Base names
    resolve against this (conservatively by bare name: a subclass in
    another module still inherits its base's proven locks)."""
    index: dict[str, set[str]] = {}
    for src in project.files:
        aliases = _module_lock_aliases(src.tree)
        for cls in _iter_classes(src.tree):
            index.setdefault(cls.name, set()).update(
                _ctor_proven_attrs(cls, aliases)
            )
    return index


def _inherited_attrs(
    cls: ast.ClassDef, ctor_index: dict[str, set[str]]
) -> set[str]:
    out: set[str] = set()
    for base in _base_names(cls):
        out |= ctor_index.get(base, set())
    return out


def lock_model(project: Project) -> dict[tuple[str, str], ClassLockModel]:
    """Threaded-class inference as data: ``(path, class) -> model``.

    This is the single source of truth the static rule checks and the
    dynamic sanitizer instruments — the two provers cannot drift apart
    because they consume the same inference.
    """
    out: dict[tuple[str, str], ClassLockModel] = {}
    ctor_index = _ctor_index(project)
    for src in project.files:
        lock_aliases = _module_lock_aliases(src.tree)
        for cls in _iter_classes(src.tree):
            lock_attrs = _class_lock_attrs(
                cls, lock_aliases, _inherited_attrs(cls, ctor_index)
            )
            if not lock_attrs:
                continue
            guarded = _guarded_fields(_scan_methods(cls, lock_attrs))
            m = ClassLockModel(
                name=cls.name,
                path=src.rel_path,
                lineno=cls.lineno,
                lock_attrs=frozenset(lock_attrs),
                guarded=frozenset(guarded),
            )
            out[m.key] = m
    return out


def check(project: Project):
    findings: list[Finding] = []
    ctor_index = _ctor_index(project)
    for src in project.files:
        lock_aliases = _module_lock_aliases(src.tree)
        for cls in _iter_classes(src.tree):
            lock_attrs = _class_lock_attrs(
                cls, lock_aliases, _inherited_attrs(cls, ctor_index)
            )
            if not lock_attrs:
                continue
            scanners = _scan_methods(cls, lock_attrs)
            guarded = _guarded_fields(scanners)
            if not guarded:
                continue

            # -- pass 3: out-of-lock accesses of guarded fields.
            for name, scanner in scanners.items():
                if name == "__init__":
                    continue
                for field, is_write, held, node in scanner.accesses:
                    if held or field not in guarded:
                        continue
                    verb = "write to" if is_write else "read of"
                    findings.append(
                        Finding(
                            rule=RULE,
                            severity="error",
                            path=src.rel_path,
                            line=node.lineno,
                            col=node.col_offset,
                            message=(
                                f"unguarded {verb} `self.{field}` in "
                                f"`{cls.name}.{name}` — the field is "
                                f"mutated under `self.{sorted(lock_attrs)[0]}`"
                                " elsewhere, so lock-free access races"
                            ),
                            symbol=f"{cls.name}.{field}@{name}",
                        )
                    )
    return findings
