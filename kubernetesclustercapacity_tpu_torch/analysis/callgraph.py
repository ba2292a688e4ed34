"""Intra-package call graph + device-root table (AST only, no imports).

The graph is deliberately *conservative in reachability* and *precise in
resolution*: an edge exists only when a call or bare function reference
resolves through the module's real import/def bindings (so ``time.time``
shadowed by a local never edges to stdlib ``time``), but every resolved
reference counts — including functions passed as values
(``_bisect(hi0, supply_at, r)``) — because a referenced function runs
with the caller's device program as surely as a called one.

Roots are the package's *device programs*: the functions whose bodies
are sequences of device launches, which must never take a lock, touch
the wall clock, do I/O or wait for the device once per step.  Eager
PyTorch has no syntactic marker for them (nothing like a ``jit``
decorator), so they are declared: a module-level ``DEVICE_ROOTS``
literal anywhere in the analyzed package lists them by package-relative
qualified name.  This package's own table is :data:`DEVICE_ROOTS`
below, read from the source like any other (the analyzer never imports
what it analyzes).  A listed name that resolves to no function is
recorded in :attr:`CallGraph.unresolved_roots` — the purity rule
reports it, so a renamed root cannot silently drop out of the proof.
Nested defs of a root are reachable unconditionally (the def statement
executes with the enclosing call).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from kubernetesclustercapacity_tpu_torch.analysis.engine import Project, SourceFile

__all__ = [
    "CallGraph",
    "DEVICE_ROOTS",
    "Edge",
    "FunctionInfo",
    "declared_roots",
    "dotted",
]

#: The package's device programs, package-relative, each with the JAX
#: package's jit/Pallas roots it stands for (tests hold the JAX call
#: graph's roots against this column, so no root of the reference goes
#: without a counterpart here).
DEVICE_ROOTS = {
    "explain.explain_grid": ("explain.explain_grid",),
    "explain.explain_per_node": ("explain.explain_per_node",),
    "ops.fit.fit_per_node": ("ops.fit.fit_per_node",),
    "ops.fit.fit_per_node_multi": ("ops.fit.fit_per_node_multi",),
    "ops.fit.fit_totals": ("ops.fit.fit_totals",),
    "ops.fit.sweep_explain_grid": ("ops.fit.sweep_explain_grid",),
    "ops.fit.sweep_explain_grouped": ("ops.fit.sweep_explain_grouped",),
    "ops.fit.sweep_grid": ("ops.fit.sweep_grid",),
    "ops.fit.sweep_grid_grouped": ("ops.fit.sweep_grid_grouped",),
    "ops.fit.sweep_grid_multi": ("ops.fit.sweep_grid_multi",),
    "ops.fit.sweep_quantiles_grid": ("ops.fit.sweep_quantiles_grid",),
    "ops.fit.sweep_quantiles_grouped": ("ops.fit.sweep_quantiles_grouped",),
    "ops.fused_fit.sweep_fused": (
        "ops.pallas_fit._make_sweep_kernel",
        "ops.pallas_fit._sweep_pallas_padded",
        "ops.pallas_fit._sweep_pallas_padded_rcp",
    ),
    "ops.fused_fit.sweep_fused_plain": (
        "ops.pallas_fit._sweep_pallas_padded",
        "ops.pallas_fit._sweep_pallas_padded_rcp",
    ),
    "ops.fused_multi.sweep_multi": (
        "ops.pallas_multi._make_multi_kernel",
        "ops.pallas_multi._sweep_pallas_multi_padded",
    ),
    "ops.fused_multi.sweep_multi_plain": (
        "ops.pallas_multi._sweep_pallas_multi_padded",
    ),
    "ops.placement._place_pods_scan": ("ops.placement._place_pods_scan",),
    "ops.placement.place_replicas": ("ops.placement.place_replicas",),
    "ops.placement.place_replicas_multi": (
        "ops.placement.place_replicas_multi",
    ),
    "ops.placement.place_replicas_spread": (
        "ops.placement.place_replicas_spread",
    ),
    "ops.preemption.sweep_preemption": ("ops.preemption.sweep_preemption",),
    "optimize.lp._pdhg_chunk": ("optimize.lp._pdhg_chunk",),
    "parallel.sweep._run_cells": (
        "parallel.sweep._compiled_shard_fn._shard_fn",
    ),
    "stochastic.distributions._normal01_scaled": (
        "stochastic.distributions._normal_samples",
        "stochastic.distributions._lognormal_samples",
    ),
    "stochastic.distributions._exp": (
        "stochastic.distributions._lognormal_samples",
    ),
    "stochastic.distributions._to_usage": (
        "stochastic.distributions._normal_samples",
        "stochastic.distributions._lognormal_samples",
    ),
    "stochastic.distributions._uniform01": (
        "stochastic.distributions._empirical_samples",
    ),
    "topology.gang._domain_caps": ("topology.gang._domain_caps",),
    "topology.gang._grouped_caps": ("topology.gang._grouped_caps",),
    "topology.gang._gangs_colocated": ("topology.gang._gangs_colocated",),
    "topology.gang._gangs_colocated_per_group": (
        "topology.gang._gangs_colocated_per_group",
    ),
    "topology.gang._gangs_spread": ("topology.gang._gangs_spread",),
    "topology.gang._gangs_spread_per_group": (
        "topology.gang._gangs_spread_per_group",
    ),
    "utils.guards.checked_fit_totals": ("utils.guards._checked_impl",),
    "utils.guards.checked_fit_totals_multi": (
        "utils.guards._checked_multi_impl",
    ),
}

#: The name a package declares its table under.
ROOT_TABLE = "DEVICE_ROOTS"


def dotted(node: ast.AST) -> str | None:
    """``a.b.c`` attribute chain -> ``"a.b.c"``, else ``None``."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclass
class Edge:
    """A resolved intra-package reference from one function to another."""

    target: str  # canonical qname
    line: int
    col: int
    kind: str  # "call" | "ref" | "nested"


@dataclass
class FunctionInfo:
    qname: str  # canonical dotted: module path + [Class.]name chain
    module: str
    src: SourceFile
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    cls: str | None = None
    root_reasons: list[str] = field(default_factory=list)

    @property
    def is_root(self) -> bool:
        return bool(self.root_reasons)

    @property
    def name(self) -> str:
        return self.qname.rsplit(".", 1)[-1]


class _ModuleIndex:
    """Per-module bindings: imports, top-level defs, classes."""

    def __init__(self, name: str, src: SourceFile, is_pkg: bool) -> None:
        self.name = name
        self.src = src
        # The package relative imports resolve against.
        self.package = name if is_pkg else name.rsplit(".", 1)[0]
        self.imports: dict[str, str] = {}  # local alias -> dotted target
        self.toplevel: dict[str, str] = {}  # local name -> canonical qname
        self.class_methods: dict[str, dict[str, str]] = {}
        self.class_bases: dict[str, list[str]] = {}

    def add_imports(self, tree: ast.Module) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:
                        self.imports[alias.asname] = alias.name
                    else:
                        top = alias.name.split(".", 1)[0]
                        self.imports[top] = top
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    up = self.package.split(".")
                    # level 1 = current package; each extra level pops one.
                    up = up[: len(up) - (node.level - 1)]
                    base = ".".join(up + ([node.module] if node.module else []))
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    self.imports[local] = f"{base}.{alias.name}"

    def resolve(self, name_path: str) -> str | None:
        """Local dotted reference -> canonical dotted name (or None)."""
        head, _, rest = name_path.partition(".")
        if head in self.toplevel:
            base = self.toplevel[head]
        elif head in self.imports:
            base = self.imports[head]
        else:
            return None
        return f"{base}.{rest}" if rest else base


class CallGraph:
    def __init__(self, project: Project) -> None:
        self.project = project
        self.functions: dict[str, FunctionInfo] = {}
        self.edges: dict[str, list[Edge]] = {}
        self.modules: dict[str, _ModuleIndex] = {}
        self._class_inits: dict[str, str] = {}  # class qname -> __init__ qname
        # (name, source, line) of table entries that name no function.
        self.unresolved_roots: list[tuple[str, SourceFile, int]] = []

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, project: Project) -> "CallGraph":
        g = cls(project)
        indexed: list[tuple[_ModuleIndex, SourceFile]] = []
        for src in project.files:
            mod_name = g._module_name(src)
            idx = _ModuleIndex(
                mod_name, src, is_pkg=src.rel_path.endswith("__init__.py")
            )
            idx.add_imports(src.tree)
            g.modules[mod_name] = idx
            g._collect_defs(idx, src.tree, prefix=mod_name, cls=None)
            indexed.append((idx, src))
        # Second pass: edges + roots need every module's defs known.
        for idx, src in indexed:
            g._scan_module(idx, src)
        for name, src, line in declared_roots(project):
            qname = f"{project.package_name}.{name}"
            if qname in g.functions:
                g._mark_root(
                    qname, f"listed in {ROOT_TABLE} ({src.rel_path}:{line})"
                )
            else:
                g.unresolved_roots.append((name, src, line))
        return g

    def _module_name(self, src: SourceFile) -> str:
        rel = src.rel_path
        # rel is repo-root relative; strip down to package-relative.
        pkg = self.project.package_name
        parts = rel[: -len(".py")].split("/")
        if pkg in parts:
            parts = parts[parts.index(pkg) :]
        if parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)

    # ------------------------------------------------------------------
    @staticmethod
    def _own_defs(scope_node):
        """Function/class defs belonging directly to this scope — defs
        under if/try/with/loops included, defs inside nested defs or
        classes excluded (those are their own scopes)."""
        compound = (
            ast.If, ast.For, ast.While, ast.With, ast.Try,
            ast.AsyncFor, ast.AsyncWith,
        )
        stack = [scope_node]
        while stack:
            item = stack.pop()
            for child in ast.iter_child_nodes(item):
                if isinstance(
                    child,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
                ):
                    yield child
                elif isinstance(child, compound):
                    stack.append(child)

    def _collect_defs(self, idx, scope_node, prefix: str, cls) -> None:
        for node in self._own_defs(scope_node):
            qname = f"{prefix}.{node.name}"
            if isinstance(node, ast.ClassDef):
                if prefix == idx.name:
                    idx.toplevel[node.name] = qname
                    idx.class_bases[node.name] = [
                        d for d in (dotted(b) for b in node.bases) if d
                    ]
                self._collect_defs(
                    idx, node, qname,
                    cls=node.name if prefix == idx.name else cls,
                )
                continue
            if qname in self.functions:
                # Same-named sibling (e.g. two `def _():` under pl.when):
                # uniquify so both bodies stay analyzable.
                qname = f"{qname}@{node.lineno}"
            info = FunctionInfo(
                qname=qname, module=idx.name, src=idx.src, node=node, cls=cls
            )
            self.functions[qname] = info
            if cls is None and prefix == idx.name:
                idx.toplevel[node.name] = qname
            if cls is not None and prefix == f"{idx.name}.{cls}":
                idx.class_methods.setdefault(cls, {})[node.name] = qname
                if node.name == "__init__":
                    self._class_inits[f"{idx.name}.{cls}"] = qname
            self._collect_defs(idx, node, qname, cls)

    # ------------------------------------------------------------------
    def _scan_module(self, idx: _ModuleIndex, src: SourceFile) -> None:
        for qname, info in list(self.functions.items()):
            if info.module != idx.name:
                continue
            self._scan_function(idx, info)

    @staticmethod
    def _params(args: ast.arguments) -> list[str]:
        out = [
            a.arg
            for a in (
                list(args.posonlyargs)
                + list(args.args)
                + list(args.kwonlyargs)
            )
        ]
        if args.vararg:
            out.append(args.vararg.arg)
        if args.kwarg:
            out.append(args.kwarg.arg)
        return out

    def _local_bindings(self, node) -> set[str]:
        """Names bound inside this function's scope (params, assignments,
        imports, nested def/class names, lambda params) — used to keep
        shadowed imports/globals from resolving."""
        bound: set[str] = set()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            bound.update(self._params(node.args))
        for sub in self._walk_scope(node):
            if isinstance(sub, ast.Name) and isinstance(
                sub.ctx, (ast.Store, ast.Del)
            ):
                bound.add(sub.id)
            elif isinstance(sub, (ast.Import, ast.ImportFrom)):
                for alias in sub.names:
                    bound.add((alias.asname or alias.name).split(".", 1)[0])
            elif isinstance(
                sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                bound.add(sub.name)
            elif isinstance(sub, ast.Lambda):
                # Lambda bodies are scanned inline (vmap callbacks);
                # their params must still shadow.
                bound.update(self._params(sub.args))
        return bound

    def _walk_scope(self, node):
        """Every AST node in ``node``'s own runtime scope.

        Annotations are skipped (never executed under ``from __future__
        import annotations``); a nested def is yielded *shallowly* (its
        def statement — name binding, decorators, defaults — executes
        here) but its body is a separate scope.  Lambda bodies stay
        inline: in this codebase they are vmap/callback bodies whose
        expressions trace with the enclosing function.
        """
        stack = [(node, True, True)]  # (node, expand, is_top)
        while stack:
            item, expand, is_top = stack.pop()
            if not is_top:
                yield item
            if not expand:
                # Shallow nested def: decorators + defaults run here.
                for dec in item.decorator_list:
                    stack.append((dec, True, False))
                for d in item.args.defaults:
                    stack.append((d, True, False))
                for kd in item.args.kw_defaults:
                    if kd is not None:
                        stack.append((kd, True, False))
                continue
            for name, value in ast.iter_fields(item):
                if name in ("annotation", "returns"):
                    continue
                if is_top and name == "decorator_list":
                    # The top node's own decorators execute in the
                    # ENCLOSING scope, not this one.
                    continue
                for child in value if isinstance(value, list) else [value]:
                    if not isinstance(child, ast.AST):
                        continue
                    if isinstance(
                        child, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        stack.append((child, False, False))
                    else:
                        stack.append((child, True, False))

    # ------------------------------------------------------------------
    def _resolve_in(self, idx, info: FunctionInfo | None, name_path: str,
                    local_bound: set[str]):
        """Resolve a dotted reference in a function/module scope to a
        canonical dotted name, or None."""
        head = name_path.split(".", 1)[0]
        if head in ("self", "cls") and info is not None and info.cls is not None:
            rest = name_path.split(".", 1)[1] if "." in name_path else ""
            if rest and "." not in rest:
                return self._resolve_method(idx, info.cls, rest)
            return None
        if head in local_bound:
            # Shadowed by a parameter/local — except locally nested defs,
            # which resolve to their canonical nested qname.
            if info is not None:
                nested = f"{info.qname}.{head}"
                if nested in self.functions and "." not in name_path:
                    return nested
            return None
        return idx.resolve(name_path)

    def _resolve_method(self, idx, cls: str, meth: str) -> str | None:
        seen: set[str] = set()
        stack = [cls]
        while stack:
            c = stack.pop()
            if c in seen:
                continue
            seen.add(c)
            hit = idx.class_methods.get(c, {}).get(meth)
            if hit:
                return hit
            for base in idx.class_bases.get(c, ()):
                if "." not in base:
                    stack.append(base)
        return None

    # ------------------------------------------------------------------
    def _call_canon(self, idx, info, call: ast.Call, local_bound):
        path = dotted(call.func)
        if path is None:
            return None
        return self._resolve_in(idx, info, path, local_bound)

    def _mark_root(self, qname: str, reason: str) -> None:
        info = self.functions.get(qname)
        if info is not None and reason not in info.root_reasons:
            info.root_reasons.append(reason)

    # ------------------------------------------------------------------
    def _scan_function(self, idx, info: FunctionInfo) -> None:
        edges = self.edges.setdefault(info.qname, [])
        seen_sites: set[tuple[str, int, int]] = set()

        def add_edge(target: str, line: int, col: int, kind: str) -> None:
            # A call's func Name is visited both as the Call and as a
            # bare Load — one site, one edge.
            site = (target, line, col)
            if site not in seen_sites:
                seen_sites.add(site)
                edges.append(Edge(target, line, col, kind))

        local_bound = self._local_bindings(info.node)
        # Nested defs execute (their def statement) in this scope — they
        # are reachable the moment the enclosing function runs.
        for child in self._walk_scope(info.node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                nested = f"{info.qname}.{child.name}"
                if nested not in self.functions:
                    nested = f"{nested}@{child.lineno}"
                if nested in self.functions:
                    add_edge(nested, child.lineno, child.col_offset, "nested")
        for node in self._walk_scope(info.node):
            if isinstance(node, ast.Call):
                canon = self._call_canon(idx, info, node, local_bound)
                if canon is not None:
                    target = self.functions.get(canon) and canon
                    if target is None and canon in self._class_inits:
                        target = self._class_inits[canon]
                    if target is not None:
                        add_edge(target, node.lineno, node.col_offset, "call")
                        continue
            elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                canon = self._resolve_in(idx, info, node.id, local_bound)
                if canon in self.functions:
                    add_edge(canon, node.lineno, node.col_offset, "ref")

    # ------------------------------------------------------------------
    def roots(self) -> list[FunctionInfo]:
        return [f for f in self.functions.values() if f.is_root]

    def reachable(self) -> dict[str, tuple[str, Edge | None]]:
        """BFS from every device root.

        Returns ``{qname: (predecessor_qname, entering_edge)}`` for every
        function reachable from a root; roots map to ``("", None)``.
        """
        pred: dict[str, tuple[str, Edge | None]] = {}
        queue: list[str] = []
        for f in self.roots():
            pred[f.qname] = ("", None)
            queue.append(f.qname)
        while queue:
            cur = queue.pop(0)
            for edge in self.edges.get(cur, ()):  # deterministic order
                if edge.target not in pred:
                    pred[edge.target] = (cur, edge)
                    queue.append(edge.target)
        return pred

    def chain(self, pred: dict, qname: str) -> list[str]:
        """Root -> ... -> qname, for finding messages."""
        out = [qname]
        seen = {qname}
        while True:
            p, _ = pred.get(out[-1], ("", None))
            if not p or p in seen:
                break
            out.append(p)
            seen.add(p)
        return list(reversed(out))


def declared_roots(project: Project) -> list[tuple[str, SourceFile, int]]:
    """Every ``(name, source, line)`` a module-level ``DEVICE_ROOTS``
    literal of the package lists: the string keys of a dict, or the
    string elements of a tuple/list/set, in source order."""
    out: list[tuple[str, SourceFile, int]] = []
    for src in project.files:
        for node in src.tree.body:
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target] if isinstance(node, ast.AnnAssign)
                else []
            )
            if not any(
                isinstance(t, ast.Name) and t.id == ROOT_TABLE
                for t in targets
            ):
                continue
            value = node.value
            if isinstance(value, ast.Dict):
                elts = [k for k in value.keys if k is not None]
            elif isinstance(value, (ast.Tuple, ast.List, ast.Set)):
                elts = list(value.elts)
            else:
                elts = []
            for e in elts:
                if isinstance(e, ast.Constant) and isinstance(e.value, str):
                    out.append((e.value, src, e.lineno))
    return out
