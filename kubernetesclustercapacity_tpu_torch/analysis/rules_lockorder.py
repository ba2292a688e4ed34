"""Static lock-order prover: no two locks are acquired in both orders.

A deadlock needs no bad luck, only a cycle in the lock-order graph:
thread 1 holds A and wants B while thread 2 holds B and wants A.  The
AST can build that graph without running anything — every ``with
self._lock:`` / ``with _MODULE_LOCK:`` acquisition site is visible, and
the call graph says which *other* acquisitions are reachable from
inside a held region.  This rule walks both:

* **lexical edges** — ``with A:`` containing ``with B:`` adds A→B at
  the inner acquisition's exact ``file:line``;
* **interprocedural edges** — a call to ``g()`` inside ``with A:``
  adds A→L for every lock L that ``g`` (transitively, over resolved
  intra-package call edges) acquires, anchored at the call site with
  the callee's own acquisition site named in the message.

Lock identity is ``Class.attr`` for ``self.X`` locks (one identity per
class — instances share the discipline) and ``module:NAME`` for
module-level locks.  Cycles are reported one finding per participating
edge, so each inversion shows up at BOTH acquisition orders' exact
sites; the baseline symbol is the edge (``A->B``), line-independent as
usual.  Self-edges (re-acquiring a held lock) are deliberately out of
scope: ``RLock`` makes them legal, and the ``*_locked`` convention
already marks the helpers that run lock-held.

The runtime sanitizer (:mod:`.sanitize`) builds the same graph from
*observed* acquisitions; this rule is the static half of that pair —
it sees orders no test schedule happened to execute.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from kubernetesclustercapacity_tpu_torch.analysis.callgraph import CallGraph
from kubernetesclustercapacity_tpu_torch.analysis.engine import Finding, Project
from kubernetesclustercapacity_tpu_torch.analysis.rules_locks import (
    _is_lock_ctor,
    _module_lock_aliases,
    _self_attr,
    lock_model,
)

__all__ = ["check", "build_order_graph", "RULE"]

RULE = "lock-order"


@dataclass
class _Site:
    path: str
    line: int
    col: int
    note: str = ""


@dataclass
class _OrderGraph:
    """Edges ``held -> acquired`` with first-seen acquisition sites."""

    edges: dict = field(default_factory=dict)  # (a, b) -> _Site

    def add(self, a: str, b: str, site: _Site) -> None:
        if a != b and (a, b) not in self.edges:
            self.edges[(a, b)] = site

    def successors(self) -> dict:
        out: dict[str, set[str]] = {}
        for a, b in self.edges:
            out.setdefault(a, set()).add(b)
            out.setdefault(b, set())
        return out

    def cycle_edges(self) -> list:
        """Edges that sit on a cycle: (a, b) where b reaches a."""
        succ = self.successors()
        reach_cache: dict[str, set[str]] = {}

        def reach(start: str) -> set[str]:
            hit = reach_cache.get(start)
            if hit is not None:
                return hit
            seen: set[str] = set()
            stack = [start]
            while stack:
                cur = stack.pop()
                for nxt in succ.get(cur, ()):
                    if nxt not in seen:
                        seen.add(nxt)
                        stack.append(nxt)
            reach_cache[start] = seen
            return seen

        return sorted(
            (a, b) for (a, b) in self.edges if a in reach(b)
        )


def _module_locks(tree: ast.Module, lock_aliases: set[str]) -> set[str]:
    """Module-level ``NAME = threading.Lock()`` bindings."""
    out: set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(
            node.value, ast.Call
        ) and _is_lock_ctor(node.value, lock_aliases):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
    return out


class _FnVisitor:
    """One function body: lexical acquisitions, nested edges, and call
    sites made while holding locks."""

    def __init__(self, lock_ids, module_locks: set[str], module: str) -> None:
        self._lock_ids = lock_ids  # self attr -> lock id (enclosing class)
        self._module_locks = module_locks
        self._module = module
        self.acquired: dict[str, _Site] = {}  # lock id -> first site
        self.nested: list[tuple[str, str, _Site]] = []
        self.held_calls: list[tuple[ast.Call, tuple[str, ...]]] = []

    def _lock_of(self, expr) -> str | None:
        attr = _self_attr(expr)
        if attr is not None:
            return self._lock_ids.get(attr)
        if isinstance(expr, ast.Name) and expr.id in self._module_locks:
            return f"{self._module}:{expr.id}"
        return None

    def visit_body(self, stmts, held: tuple[str, ...], path: str) -> None:
        for stmt in stmts:
            self._visit(stmt, held, path)

    def _visit(self, node, held: tuple[str, ...], path: str) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            # Closures run later — whatever is held now is not then.
            body = node.body if isinstance(node.body, list) else [node.body]
            for child in body:
                self._visit(child, (), path)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            taken: list[str] = []
            for item in node.items:
                self._visit(item.context_expr, held, path)
                lock = self._lock_of(item.context_expr)
                if lock is not None and lock not in held:
                    site = _Site(path, node.lineno, node.col_offset)
                    self.acquired.setdefault(lock, site)
                    for h in held:
                        self.nested.append((h, lock, site))
                    taken.append(lock)
            inner = held + tuple(taken)
            for child in node.body:
                self._visit(child, inner, path)
            return
        if isinstance(node, ast.Call) and held:
            self.held_calls.append((node, held))
        for child in ast.iter_child_nodes(node):
            self._visit(child, held, path)


def build_order_graph(project: Project, graph: CallGraph | None = None):
    """The package's static lock-order graph plus per-function data.

    Returns ``(order_graph, acquired_by_fn)`` where ``acquired_by_fn``
    maps function qname -> {lock id: acquisition site} including
    everything reachable through resolved call edges.
    """
    if graph is None:
        graph = CallGraph.build(project)
    model = lock_model(project)

    # Per-class lock-id maps and per-module lock names.
    class_locks: dict[tuple[str, str], dict[str, str]] = {}
    for (path, cls_name), m in model.items():
        class_locks[(path, cls_name)] = {
            attr: f"{cls_name}.{attr}" for attr in m.lock_attrs
        }
    module_locks: dict[str, set[str]] = {}
    for mod_name, idx in graph.modules.items():
        module_locks[mod_name] = _module_locks(
            idx.src.tree, _module_lock_aliases(idx.src.tree)
        )

    order = _OrderGraph()
    lexical: dict[str, dict[str, _Site]] = {}
    visitors: dict[str, _FnVisitor] = {}
    for qname, info in graph.functions.items():
        lock_ids = (
            class_locks.get((info.src.rel_path, info.cls), {})
            if info.cls is not None
            else {}
        )
        v = _FnVisitor(
            lock_ids, module_locks.get(info.module, set()), info.module
        )
        held: tuple[str, ...] = ()
        if info.name.endswith("_locked") and info.cls is not None:
            # Convention: body runs with the class lock already held.
            m = model.get((info.src.rel_path, info.cls))
            if m is not None and m.lock_attrs:
                held = (f"{info.cls}.{sorted(m.lock_attrs)[0]}",)
        v.visit_body(info.node.body, held, info.src.rel_path)
        visitors[qname] = v
        lexical[qname] = dict(v.acquired)
        for a, b, site in v.nested:
            order.add(a, b, site)

    # Transitive closure: locks acquired anywhere in/under each fn.
    closure: dict[str, dict[str, _Site]] = {}

    def close(qname: str, stack: frozenset) -> dict[str, _Site]:
        hit = closure.get(qname)
        if hit is not None:
            return hit
        if qname in stack:
            return lexical.get(qname, {})
        acc = dict(lexical.get(qname, {}))
        for edge in graph.edges.get(qname, ()):
            for lock, site in close(edge.target, stack | {qname}).items():
                acc.setdefault(lock, site)
        closure[qname] = acc
        return acc

    for qname in graph.functions:
        close(qname, frozenset())

    # Interprocedural edges: a call made while holding H reaches every
    # lock in the callee's closure.
    for qname, v in visitors.items():
        info = graph.functions[qname]
        idx = graph.modules[info.module]
        local_bound = graph._local_bindings(info.node)
        for call, held in v.held_calls:
            canon = graph._call_canon(idx, info, call, local_bound)
            if canon is None:
                continue
            target = canon if canon in graph.functions else (
                graph._class_inits.get(canon)
            )
            if target is None:
                continue
            for lock, inner_site in closure.get(target, {}).items():
                for h in held:
                    order.add(
                        h,
                        lock,
                        _Site(
                            info.src.rel_path,
                            call.lineno,
                            call.col_offset,
                            note=(
                                f"via `{target.split('.', 1)[-1]}`, which "
                                f"acquires `{lock}` at "
                                f"{inner_site.path}:{inner_site.line}"
                            ),
                        ),
                    )
    return order, closure


def _cycle_string(a: str, b: str, cyc_edges: set) -> str:
    """A readable ``a -> b -> ... -> a`` walk for the message."""
    succ: dict[str, set[str]] = {}
    for x, y in cyc_edges:
        succ.setdefault(x, set()).add(y)
    path = [a, b]
    seen = {a, b}
    cur = b
    while cur != a:
        nxts = sorted(n for n in succ.get(cur, ()) if n == a or n not in seen)
        if not nxts:
            break
        cur = nxts[0]
        path.append(cur)
        seen.add(cur)
    if path[-1] != a:
        path.append(a)
    return " -> ".join(path)


def check(project: Project):
    order, _ = build_order_graph(project)
    cyc = order.cycle_edges()
    cyc_set = set(cyc)
    findings: list[Finding] = []
    for a, b in cyc:
        site = order.edges[(a, b)]
        opposing = None
        for x, y in cyc:
            if x == b or y == a:
                opposing = order.edges[(x, y)]
                if (x, y) != (a, b):
                    break
        msg = (
            f"lock-order inversion: `{b}` is acquired while holding "
            f"`{a}`, closing the cycle {_cycle_string(a, b, cyc_set)}"
        )
        if site.note:
            msg += f" ({site.note})"
        if opposing is not None and opposing is not site:
            msg += (
                f"; the opposing order is taken at "
                f"{opposing.path}:{opposing.line}"
            )
        findings.append(
            Finding(
                rule=RULE,
                severity="error",
                path=site.path,
                line=site.line,
                col=site.col,
                message=msg,
                symbol=f"{a}->{b}",
            )
        )
    return findings
