"""Device-purity prover: nothing host-side runs per step of a device program.

The counterpart of the JAX package's ``jit-purity`` rule (same file name,
so a reader finds it).  There the roots are traced functions, and
anything host-side inside them is a bug by construction.  Here the roots
are eager PyTorch functions — the :data:`..callgraph.DEVICE_ROOTS` table
— whose bodies queue device launches; the serving stack assumes they
never take locks, never touch wall clocks or I/O, never call into the
host subsystems, and wait for the device at most once per call, never
once per step.  This rule makes those promises theorems: build the
intra-package call graph rooted at every listed device program
(:mod:`.callgraph`), then flag — at the offending site, with the
root→...→callee chain in the message — anything in these categories:

* ``host-subsystem`` — a call edge into a host-side subsystem
  (telemetry, devcache, service, audit, timeline, resilience, ...);
* ``lock`` — ``with self._lock``-style acquisition, ``.acquire()``, or
  ``threading.*`` construction;
* ``io`` — ``open``/``print``/``input``, ``os.environ``/``os.getenv``;
* ``clock`` / ``random`` — stdlib ``time.*`` / ``random.*`` (NOT
  ``torch.*``/``numpy.random``, which resolve differently);
* ``host-sync`` — a device→host wait inside the body of a ``for`` or
  ``while`` loop (or a ``while`` test): ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``torch.cuda.synchronize()``,
  or ``int()/float()/bool()`` of a root's tensor parameter (one whose
  annotation names ``Tensor``, or an unannotated positional one with no
  default other than ``None``).  One wait per call is the design; one
  per step is what the device loops promise not to do;
* ``host-detour`` — a call inside such a loop into a function that
  (transitively) waits for the device, and every call site carrying a
  ``lint-ok[device-purity]`` marker: a marked call is a *declared*
  boundary (a cached build, a deliberate host computation) whose callee
  the scan does not enter — the marker's reason is the decision;
* ``unresolved-root`` — a ``DEVICE_ROOTS`` entry that names no function
  (a renamed root must fail the gate, not drop out of the proof).
"""

from __future__ import annotations

import ast

from kubernetesclustercapacity_tpu_torch.analysis.callgraph import (
    ROOT_TABLE,
    CallGraph,
    dotted,
)
from kubernetesclustercapacity_tpu_torch.analysis.engine import Finding, Project

__all__ = ["check", "RULE", "IMPURE_SUBSYSTEMS", "SYNC_METHODS"]

RULE = "device-purity"

#: Package-relative module heads that are host-side by construction: an
#: edge from a device program into any of these is a finding regardless
#: of what the callee does today.
IMPURE_SUBSYSTEMS = frozenset(
    {
        "telemetry",
        "devcache",
        "audit",
        "timeline",
        "service",
        "resilience",
        "testing_faults",
        "follower",
        "kubeapi",
        "sources",
        "native",
        "report",
        "cli",
        "analysis",
    }
)

_IMPURE_BUILTINS = frozenset({"print", "input", "open", "breakpoint"})
_COERCIONS = frozenset({"int", "float", "bool"})

#: Tensor methods that copy to the host and so wait for the stream.
SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_SYNC_CALLS = ("torch.cuda.synchronize",)


def _subsystem(graph: CallGraph, qname: str) -> str | None:
    """Package-relative first module segment of a function's module."""
    info = graph.functions.get(qname)
    if info is None:
        return None
    head = info.module.split(".")[1] if "." in info.module else info.module
    return head


def _short(qname: str) -> str:
    """Drop the package prefix for readable messages."""
    parts = qname.split(".")
    return ".".join(parts[1:]) if len(parts) > 1 else qname


def _tensor_params(node) -> frozenset:
    """The root's parameters that hold tensors, as far as the signature
    says: an annotation naming ``Tensor``, or no annotation and no
    default other than ``None``.  Keyword-only parameters are options."""
    args = node.args
    positional = list(args.posonlyargs) + list(args.args)
    defaults = [None] * (len(positional) - len(args.defaults)) + list(
        args.defaults
    )
    out = set()
    for a, d in zip(positional, defaults):
        if a.arg in ("self", "cls"):
            continue
        if a.annotation is not None:
            if "Tensor" in ast.unparse(a.annotation):
                out.add(a.arg)
        elif d is None or (isinstance(d, ast.Constant) and d.value is None):
            out.add(a.arg)
    return frozenset(out)


def _loop_nodes(graph: CallGraph, fn_node) -> set[int]:
    """``id`` of every node of ``fn_node``'s own scope that runs once per
    iteration of a ``for``/``while`` loop: loop bodies, ``else`` arms
    excluded, and ``while`` tests."""
    inside: set[int] = set()
    for node in graph._walk_scope(fn_node):
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            parts = list(node.body)
            if isinstance(node, ast.While):
                parts.append(node.test)
            for part in parts:
                for sub in _scope_walk(part):
                    inside.add(id(sub))
    return inside


def _scope_walk(node):
    """``node`` and its descendants, nested function bodies excluded."""
    stack = [node]
    while stack:
        cur = stack.pop()
        yield cur
        for child in ast.iter_child_nodes(cur):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stack.append(child)


def _sync_detail(graph, idx, info, node, local_bound, tensors) -> str | None:
    """What makes ``node`` a device→host wait, or ``None``."""
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    if isinstance(fn, ast.Attribute):
        if fn.attr in SYNC_METHODS and not node.args:
            return f"`.{fn.attr}()` copies to the host"
        if fn.attr == "to":
            targets = list(node.args[:1]) + [
                kw.value for kw in node.keywords if kw.arg == "device"
            ]
            for t in targets:
                if isinstance(t, ast.Constant) and t.value == "cpu":
                    return '`.to("cpu")` copies to the host'
    path = dotted(fn)
    canon = graph._resolve_in(idx, info, path, local_bound) if path else None
    if canon in _SYNC_CALLS:
        return f"`{canon}()` waits for the device"
    if (
        isinstance(fn, ast.Name)
        and fn.id in _COERCIONS
        and fn.id not in local_bound
        and tensors
    ):
        for arg in node.args:
            if isinstance(arg, ast.Name) and arg.id in tensors:
                return (
                    f"`{fn.id}({arg.id})` coerces a tensor parameter to a "
                    "Python scalar"
                )
    return None


def check(project: Project):
    graph = CallGraph.build(project)
    findings: list[Finding] = []

    for name, src, line in graph.unresolved_roots:
        findings.append(
            Finding(
                rule=RULE,
                severity="error",
                path=src.rel_path,
                line=line,
                col=0,
                message=(
                    f"unresolved-root: {ROOT_TABLE} lists `{name}`, which "
                    "names no function of the package"
                ),
                symbol=f"{ROOT_TABLE}::{name}",
            )
        )

    # --- reachability with boundary pruning: an edge into a host
    # subsystem, or a call site marked lint-ok[device-purity], is a
    # finding, and traversal stops there (flagging the callee's own
    # internals would bury the one actionable site).
    pred: dict[str, tuple[str, object]] = {}
    queue: list[str] = []
    for root in graph.roots():
        pred[root.qname] = ("", None)
        queue.append(root.qname)
    followed: dict[str, list] = {}
    while queue:
        cur = queue.pop(0)
        cur_info = graph.functions[cur]
        followed[cur] = []
        for edge in graph.edges.get(cur, ()):
            sub = _subsystem(graph, edge.target)
            chain = None
            if sub in IMPURE_SUBSYSTEMS:
                chain = " -> ".join(_short(q) for q in graph.chain(pred, cur))
                detail = (
                    f"host-subsystem: call into {_short(edge.target)}"
                    f" ({sub}/) is reachable from device root via {chain}"
                )
                symbol = f"{cur}->{edge.target}"
            elif cur_info.src.allows(RULE, edge.line):
                chain = " -> ".join(_short(q) for q in graph.chain(pred, cur))
                detail = (
                    f"host-detour: call into {_short(edge.target)} leaves "
                    f"the device program of {chain} (declared at the site)"
                )
                symbol = f"{cur}->{edge.target}::detour"
            if chain is not None:
                findings.append(
                    Finding(
                        rule=RULE,
                        severity="error",
                        path=cur_info.src.rel_path,
                        line=edge.line,
                        col=edge.col,
                        message=detail,
                        symbol=symbol,
                    )
                )
                continue
            followed[cur].append(edge)
            if edge.target not in pred:
                pred[edge.target] = (cur, edge)
                queue.append(edge.target)

    # --- which reachable functions wait for the device at all (their
    # own scope, or through a followed edge): a call into one of them
    # from inside a loop waits once per iteration.
    syncs: dict[str, str] = {}
    loops: dict[str, set[int]] = {}
    for qname in pred:
        info = graph.functions[qname]
        idx = graph.modules[info.module]
        local_bound = graph._local_bindings(info.node)
        tensors = _tensor_params(info.node) if info.is_root else frozenset()
        loops[qname] = _loop_nodes(graph, info.node)
        for node in graph._walk_scope(info.node):
            detail = _sync_detail(graph, idx, info, node, local_bound, tensors)
            if detail is not None:
                syncs.setdefault(qname, f"{_short(qname)}:{node.lineno}")
                break
    changed = True
    while changed:
        changed = False
        for qname, edges in followed.items():
            if qname in syncs:
                continue
            for edge in edges:
                if edge.target in syncs:
                    syncs[qname] = syncs[edge.target]
                    changed = True
                    break

    # --- per-function purity scan of everything reachable.
    for qname in sorted(pred):
        info = graph.functions[qname]
        idx = graph.modules[info.module]
        chain = " -> ".join(_short(q) for q in graph.chain(pred, qname))
        local_bound = graph._local_bindings(info.node)
        tensors = _tensor_params(info.node) if info.is_root else frozenset()
        in_loop = loops[qname]

        def emit(node, category: str, detail: str) -> None:
            findings.append(
                Finding(
                    rule=RULE,
                    severity="error",
                    path=info.src.rel_path,
                    line=node.lineno,
                    col=node.col_offset,
                    message=(
                        f"{category}: {detail} inside device program "
                        f"({chain})"
                    ),
                    symbol=f"{qname}::{category}::{detail}",
                )
            )

        loop_calls = {
            (e.line, e.col): e.target
            for e in followed.get(qname, ())
            if e.kind == "call"
        }
        for node in graph._walk_scope(info.node):
            if isinstance(node, ast.With) or isinstance(node, ast.AsyncWith):
                for item in node.items:
                    path = dotted(item.context_expr)
                    if path and "lock" in path.rsplit(".", 1)[-1].lower():
                        emit(node, "lock", f"`with {path}:` acquisition")
                continue
            if isinstance(node, ast.Attribute):
                path = dotted(node)
                canon = (
                    graph._resolve_in(idx, info, path, local_bound)
                    if path
                    else None
                )
                if canon == "os.environ":
                    # Every environ use (attribute call, subscript, or
                    # bare) contains exactly this inner attribute node,
                    # so flagging it once here covers all forms without
                    # double-reporting the enclosing call.
                    emit(node, "io", "os.environ access")
                continue
            if not isinstance(node, ast.Call):
                continue
            if id(node) in in_loop:
                detail = _sync_detail(
                    graph, idx, info, node, local_bound, tensors
                )
                if detail is not None:
                    emit(node, "host-sync", f"{detail} once per iteration")
                    continue
                target = loop_calls.get((node.lineno, node.col_offset))
                if target is not None and target in syncs:
                    emit(
                        node,
                        "host-detour",
                        f"call into {_short(target)} waits for the device "
                        f"(at {syncs[target]}) once per iteration",
                    )
                    continue
            fn = node.func
            fn_path = dotted(fn)
            canon = (
                graph._resolve_in(idx, info, fn_path, local_bound)
                if fn_path
                else None
            )
            if isinstance(fn, ast.Attribute) and fn.attr == "acquire":
                emit(node, "lock", f"`{fn_path or '<expr>.acquire'}()` call")
                continue
            if canon is None:
                if (
                    isinstance(fn, ast.Name)
                    and fn.id in _IMPURE_BUILTINS
                    and fn.id not in local_bound
                ):
                    emit(node, "io", f"`{fn.id}()` call")
                continue
            if canon == "time" or canon.startswith("time."):
                emit(node, "clock", f"`{canon}()` call")
            elif canon == "random" or canon.startswith("random."):
                emit(node, "random", f"`{canon}()` call")
            elif canon == "os.getenv":
                emit(node, "io", f"`{canon}()` call")
            elif canon.startswith("threading."):
                emit(node, "lock", f"`{canon}()` construction")
    return findings
