"""Trace assembly and critical-path analysis over per-process span logs.

Counterpart of ``kubernetesclustercapacity_tpu/telemetry/traceview.py``,
verbatim: the port's servers, federation and clients write the same span
records, so one analyzer reads logs of either package.

Every process in the topology (client, ReplicaSet, server, fed,
plane) appends its spans to its OWN JSONL trace log — there is no
collector.  This module is the read side: point it at the log
directories (``kccap -trace-tree TRACE_ID -trace-logs DIR[,DIR...]``)
and it stitches one trace back into a tree and names where the time
went.

Two rules make the assembly trustworthy across machines:

* **Clock-skew tolerance** — the tree is built from parent linkage
  (``parent_span_id``) ONLY.  Wall clocks on different hosts disagree;
  span ordering or nesting is never inferred from ``ts``.  Sibling
  order is log order, which is deterministic per process.
* **Negative durations are evidence, not data** — a span whose
  recorded ``duration_ms`` is negative was written by a wall-clock
  start/end pair that straddled a clock step.  It is flagged
  ``clock_skew`` and the critical path REFUSES to run through it:
  a critical path computed from a poisoned duration would confidently
  name the wrong contributor, which is worse than naming none.

The critical path itself is the classic greedy descent: from the
longest root, repeatedly step into the child with the largest
(monotonic) duration; each step's *self time* is its duration minus the
chosen child's.  Self times aggregate into the ``phases`` vocabulary
(``phase:*`` child spans name themselves; other ops count under their
op name), so the dominating contributor reads in the same terms as the
``kccap_phase_seconds`` histograms — the cross-hop half of the phase
decomposition.
"""

from __future__ import annotations

import json
import math
import os

__all__ = [
    "analyze_trace",
    "assemble_tree",
    "critical_path",
    "load_spans",
]

#: Children per node / spans per trace bound: a malicious or corrupt
#: log cannot make assembly quadratic-explode.
_MAX_SPANS = 100_000


def load_spans(paths) -> list[dict]:
    """Read span records from files and/or directories of JSONL logs.

    ``paths`` is an iterable of paths (or one comma-separated string).
    Directories contribute every ``*.jsonl`` file plus one-deep ``.1``
    rotations.  A *span* line is one carrying ``trace_id``, ``span_id``
    and ``duration_ms`` — request-log lines (``latency_ms``), flight
    dumps, and corrupt lines are skipped, never fatal: forensic readers
    must work on the logs that exist, not the logs one wishes existed.
    """
    if isinstance(paths, str):
        paths = [p for p in paths.split(",") if p.strip()]
    files: list[str] = []
    for p in paths:
        p = os.path.expanduser(str(p).strip())
        if os.path.isdir(p):
            for name in sorted(os.listdir(p)):
                if name.endswith(".jsonl") or name.endswith(".jsonl.1"):
                    files.append(os.path.join(p, name))
        elif os.path.exists(p):
            files.append(p)
    spans: list[dict] = []
    for path in files:
        try:
            with open(path, encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if (
                        isinstance(rec, dict)
                        and rec.get("trace_id")
                        and rec.get("span_id")
                        and "duration_ms" in rec
                    ):
                        spans.append(rec)
                        if len(spans) >= _MAX_SPANS:
                            return spans
        except OSError:
            continue
    return spans


def assemble_tree(spans: list[dict], trace_id: str) -> dict:
    """One trace's spans → a parent-linked tree.

    Returns ``{trace_id, found, spans, processes, roots, orphans,
    clock_skew_spans, in_flight}``.  Each node is the span record plus
    a ``children`` list (log order) and, where applicable, a
    ``clock_skew: True`` flag.  A span whose parent never appears in
    any log (the parent's process lost it, or its trace was dropped by
    tail sampling there) is promoted to a root and counted in
    ``orphans`` — present-but-unparented beats silently absent.

    A span carrying the ``duration_ms`` KEY but no usable number
    (``null``/string/NaN — a process that crashed mid-request wrote
    the start of its record but never the end) is an **in-flight**
    span: it is excluded from assembly and named in ``in_flight``.
    Before this rule such a span entered the tree with an implied
    duration of 0, silently zeroing its own step and inflating its
    parent's self time — a poisoned attribution with no warning.
    """
    mine: dict[str, dict] = {}
    in_flight: list[str] = []
    for rec in spans:
        if rec.get("trace_id") != trace_id:
            continue
        dur = rec.get("duration_ms")
        if (
            isinstance(dur, bool)
            or not isinstance(dur, (int, float))
            or not math.isfinite(dur)
        ):
            in_flight.append(str(rec.get("span_id")))
            continue
        node = dict(rec)
        node["children"] = []
        if isinstance(node.get("duration_ms"), (int, float)) and (
            node["duration_ms"] < 0
        ):
            node["clock_skew"] = True
        # Duplicate span ids (a replayed log segment) — last wins, but
        # children already attached survive.
        prev = mine.get(node["span_id"])
        if prev is not None:
            node["children"] = prev["children"]
        mine[node["span_id"]] = node
    roots: list[dict] = []
    orphans = 0
    for node in mine.values():
        parent_id = node.get("parent_span_id")
        parent = mine.get(parent_id) if parent_id else None
        if parent is node:
            parent = None  # self-parenting guard
        if parent is None:
            if parent_id:
                orphans += 1
            roots.append(node)
        else:
            parent["children"].append(node)
    return {
        "trace_id": trace_id,
        "found": bool(mine),
        "spans": len(mine),
        "processes": sorted(
            {
                str(n["service"])
                for n in mine.values()
                if n.get("service")
            }
        ),
        "roots": roots,
        "orphans": orphans,
        "clock_skew_spans": sorted(
            n["span_id"] for n in mine.values() if n.get("clock_skew")
        ),
        "in_flight": sorted(in_flight),
    }


def _dur(node: dict) -> float:
    v = node.get("duration_ms")
    return float(v) if isinstance(v, (int, float)) else 0.0


def _phase_name(node: dict) -> str:
    """The node's name in ``phases`` vocabulary: an explicit ``phase``
    field wins (the server's ``phase:*`` child spans carry one), else
    the op itself — so cross-hop contributors ("client:fed_sweep",
    "rs:attempt") stay distinguishable in the same breakdown."""
    phase = node.get("phase")
    if isinstance(phase, str) and phase:
        return phase
    return str(node.get("op") or "unknown")


def critical_path(tree: dict) -> dict:
    """The greedy longest-duration descent from the longest root.

    Returns ``{refused, path, total_ms, phase_ms, dominant}``.
    ``refused`` is ``"clock_skew"`` when the path would have to run
    through a negative-duration span — those spans are flagged, never
    trusted — and ``"empty"`` for a trace with no spans.  ``dominant``
    names the largest self-time contributor (phases vocabulary) and its
    share of the end-to-end root duration.
    """
    roots = tree.get("roots") or []
    if not roots:
        return {
            "refused": "empty", "path": [], "total_ms": 0.0,
            "phase_ms": {}, "dominant": None,
        }
    root = max(roots, key=_dur)
    if root.get("clock_skew"):
        return {
            "refused": "clock_skew", "path": [], "total_ms": 0.0,
            "phase_ms": {}, "dominant": None,
        }
    path: list[dict] = []
    phase_ms: dict[str, float] = {}
    node = root
    seen: set[int] = set()
    while node is not None and id(node) not in seen:
        seen.add(id(node))
        usable = [
            c for c in node.get("children", ()) if not c.get("clock_skew")
        ]
        if len(usable) != len(node.get("children", ())):
            # The path's honest continuation is unknowable: one of this
            # node's children carries a poisoned duration.  Refuse
            # rather than guess around it.
            return {
                "refused": "clock_skew", "path": [], "total_ms": 0.0,
                "phase_ms": {}, "dominant": None,
            }
        nxt = max(usable, key=_dur) if usable else None
        self_ms = max(0.0, _dur(node) - (_dur(nxt) if nxt else 0.0))
        path.append(
            {
                "span_id": node.get("span_id"),
                "op": node.get("op"),
                "service": node.get("service"),
                "duration_ms": round(_dur(node), 3),
                "self_ms": round(self_ms, 3),
                **(
                    {"status": node["status"]}
                    if node.get("status") not in (None, "ok")
                    else {}
                ),
            }
        )
        name = _phase_name(node)
        phase_ms[name] = phase_ms.get(name, 0.0) + self_ms
        node = nxt
    total = _dur(root)
    dominant = None
    if phase_ms:
        name = max(phase_ms, key=phase_ms.get)
        dominant = {
            "name": name,
            "ms": round(phase_ms[name], 3),
            "share": round(phase_ms[name] / total, 4) if total > 0 else 0.0,
        }
    return {
        "refused": None,
        "path": path,
        "total_ms": round(total, 3),
        "phase_ms": {k: round(v, 3) for k, v in phase_ms.items()},
        "dominant": dominant,
    }


def analyze_trace(paths, trace_id: str) -> dict:
    """Load → assemble → attribute: the ``-trace-tree`` answer.  The
    returned dict is what ``report.trace_{table,json}_report`` render."""
    tree = assemble_tree(load_spans(paths), trace_id)
    tree["critical_path"] = critical_path(tree)
    return tree
