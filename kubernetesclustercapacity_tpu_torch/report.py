"""Verdict reporting: the reference's transcript, byte for byte, and the
structured views.

Counterpart of ``kubernetesclustercapacity_tpu/report.py`` (its single-spec,
explain, capacity-at-risk, forecast, plan, gang and optimize renderers,
the operator's timeline, SLO and flight-recorder views, the federation's
status and sweep, the audit replay's and the trace tree's).  The
reference's whole observability story is
``fmt.Printf`` to stdout (SURVEY.md §5); :func:`reference_report`
reproduces that text exactly, the typos ("allocatbale", "scehdule") and Go's
NaN/±Inf float rendering included, and :func:`json_report`,
:func:`table_report` and the two explain renderers add the views the
reference lacks.  Host-side Python only: percentages are display-only in
the reference too (``ClusterCapacity.go:113-117``).
"""

from __future__ import annotations

import json
import math

import numpy as np

from kubernetesclustercapacity_tpu_torch.scenario import Scenario
from kubernetesclustercapacity_tpu_torch.snapshot import ClusterSnapshot

__all__ = [
    "reference_report",
    "json_report",
    "table_report",
    "explain_table_report",
    "explain_json_report",
    "timeline_table_report",
    "timeline_json_report",
    "slo_table_report",
    "slo_json_report",
    "dump_table_report",
    "dump_json_report",
    "car_table_report",
    "car_json_report",
    "car_status_table_report",
    "car_status_json_report",
    "forecast_table_report",
    "forecast_json_report",
    "forecast_status_table_report",
    "forecast_status_json_report",
    "plan_table_report",
    "plan_json_report",
    "gang_table_report",
    "gang_json_report",
    "optimize_table_report",
    "optimize_json_report",
    "gang_status_table_report",
    "gang_status_json_report",
    "fed_status_table_report",
    "fed_status_json_report",
    "fed_sweep_table_report",
    "fed_sweep_json_report",
    "replay_table_report",
    "replay_json_report",
    "trace_table_report",
    "trace_json_report",
]

_RULE = "=" * 110  # the reference prints 110 '=' (ClusterCapacity.go:142,149)


def _go_float(x: float) -> str:
    """Render a float the way Go ``%.2f`` does (NaN, ±Inf spellings)."""
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "+Inf" if x > 0 else "-Inf"
    return f"{x:.2f}"


def _go_percent(num: int, den: int) -> float:
    """Go float64 division semantics: x/0 → ±Inf, 0/0 → NaN."""
    if den == 0:
        if num == 0:
            return math.nan
        return math.inf if num > 0 else -math.inf
    return float(num) * 100 / float(den)


def _u64(v: int) -> int:
    """The unsigned view of an int64 bit pattern.

    Go keeps allocatable CPU and the CPU request/limit sums in uint64
    (``ClusterCapacity.go:41-46,255-258``) and prints/divides them as such;
    the snapshot arrays carry the same bits in int64, so wrapped sums
    (>= 2^63) must be reinterpreted before rendering.  Memory is int64 in
    Go too — it stays signed.
    """
    return v & ((1 << 64) - 1) if v < 0 else v


_CPU_CODEC_ERR = "\nError converting string to int for %s\n"


def reference_report(
    snapshot: ClusterSnapshot,
    fits: np.ndarray,
    scenario: Scenario,
    *,
    include_preamble: bool = True,
) -> str:
    """The reference's stdout transcript, reconstructed from arrays.

    Mirrors ``main``'s prints in order: the flag-codec error lines
    (``:64-65`` → ``:316``), the parsed-input line (``:85``), the node
    count (``:174``) followed by getHealthyNodes' codec-error/skip lines
    (``:215,316``), per-node blocks (``:107-137``) each preceded by its
    pods' codec-error lines (``:279-284``), and the final verdict
    (``:142-149``).  The per-node struct print matches Go's ``%v`` of the
    ``node`` struct: ``{name cpu mem pods}``.  CPU quantities render as
    uint64 (see :func:`_u64`).
    """
    out = []
    pod_errs = snapshot.pod_cpu_errs
    if include_preamble:
        for payload in getattr(scenario, "input_cpu_error_payloads", ()):
            out.append(_CPU_CODEC_ERR % payload)
        out.append(
            "\nCPU limits, requests, Memory limits, requests and replicas "
            f"parsed from input : {_u64(scenario.cpu_limit_milli)} "
            f"{_u64(scenario.cpu_request_milli)} {scenario.mem_limit_bytes} "
            f"{scenario.mem_request_bytes} {scenario.replicas}\n"
        )
        out.append(
            f"\nThere are total {snapshot.n_nodes} nodes in the cluster\n\n"
        )
        for kind, payload in snapshot.node_log:
            if kind == "cpu_err":
                out.append(_CPU_CODEC_ERR % payload)
            else:  # "skip" — Go prints the REAL name of the phantom row
                out.append(f"Skipping node {payload} as it is not healthy\n")

    total = 0
    for i in range(snapshot.n_nodes):
        name = snapshot.names[i]
        alloc_cpu = _u64(int(snapshot.alloc_cpu_milli[i]))
        alloc_mem = int(snapshot.alloc_mem_bytes[i])
        cpu_lim = _u64(int(snapshot.used_cpu_lim_milli[i]))
        cpu_req = _u64(int(snapshot.used_cpu_req_milli[i]))
        mem_lim = int(snapshot.used_mem_lim_bytes[i])
        mem_req = int(snapshot.used_mem_req_bytes[i])
        if i < len(pod_errs):  # the pod walk's codec errors print first
            for payload in pod_errs[i]:
                out.append(_CPU_CODEC_ERR % payload)
        out.append(
            f"\n{{{name} {alloc_cpu} {alloc_mem} "
            f"{int(snapshot.alloc_pods[i])}}} - "
            f"Current non-terminated pods : {int(snapshot.pods_count[i])}"
        )
        out.append(
            "\nSum of CPU Limits, Requests and Memory Limits, Requests for "
            f"all pods : {cpu_lim} {cpu_req} {mem_lim} {mem_req}"
        )
        out.append(
            f"\nTotal allocatbale CPU and Memory : {alloc_cpu}, {alloc_mem}"
        )
        out.append(
            "\nCPU Limits, Requests and Memory Limits, Requests used "
            "percentage till now : "
            f"{_go_float(_go_percent(cpu_lim, alloc_cpu))} "
            f"{_go_float(_go_percent(cpu_req, alloc_cpu))} "
            f"{_go_float(_go_percent(mem_lim, alloc_mem))} "
            f"{_go_float(_go_percent(mem_req, alloc_mem))}"
        )
        out.append(f"\nMax replicas : {int(fits[i])}\n")
        total += int(fits[i])

    out.append(_RULE + "\n")
    out.append(
        "\n\t Total possible replicas for the pod with required input specs "
        f": {total}"
    )
    if total >= scenario.replicas:
        out.append(
            f"\n\t So you can go ahead with deployment of {scenario.replicas} "
            "pod replicas in the Kubernetes cluster!!\n\n"
        )
    else:
        out.append(
            f"\n\t Unfortunately Kubernetes cluster can't scehdule "
            f"{scenario.replicas} replicas. Please try again by reducing the "
            "number of replicas or/and cpu/memory resource requests. "
            "Exiting!!\n\n"
        )
    out.append(_RULE + "\n")
    return "".join(out)


def json_report(
    snapshot: ClusterSnapshot, fits: np.ndarray, scenario: Scenario
) -> str:
    """Structured output: the same quantities the reference prints, as JSON."""
    total = int(np.sum(fits))
    nodes = []
    for i in range(snapshot.n_nodes):
        # CPU fields are uint64 in Go (see _u64); memory is int64.
        alloc_cpu = _u64(int(snapshot.alloc_cpu_milli[i]))
        alloc_mem = int(snapshot.alloc_mem_bytes[i])
        cpu_req = _u64(int(snapshot.used_cpu_req_milli[i]))
        mem_req = int(snapshot.used_mem_req_bytes[i])
        nodes.append(
            {
                "name": snapshot.names[i],
                "healthy": bool(snapshot.healthy[i]),
                "allocatable": {
                    "cpu_milli": alloc_cpu,
                    "memory_bytes": alloc_mem,
                    "pods": int(snapshot.alloc_pods[i]),
                },
                "used_requests": {
                    "cpu_milli": cpu_req,
                    "memory_bytes": mem_req,
                },
                "used_limits": {
                    "cpu_milli": _u64(int(snapshot.used_cpu_lim_milli[i])),
                    "memory_bytes": int(snapshot.used_mem_lim_bytes[i]),
                },
                "pods_count": int(snapshot.pods_count[i]),
                "utilization_pct": {
                    "cpu_requests": _nan_to_none(
                        _go_percent(cpu_req, alloc_cpu)
                    ),
                    "memory_requests": _nan_to_none(
                        _go_percent(mem_req, alloc_mem)
                    ),
                },
                "max_replicas": int(fits[i]),
            }
        )
    return json.dumps(
        {
            "scenario": {
                "cpu_request_milli": scenario.cpu_request_milli,
                "cpu_limit_milli": scenario.cpu_limit_milli,
                "mem_request_bytes": scenario.mem_request_bytes,
                "mem_limit_bytes": scenario.mem_limit_bytes,
                "replicas": scenario.replicas,
            },
            "nodes": nodes,
            "total_possible_replicas": total,
            "schedulable": total >= scenario.replicas,
        },
        indent=2,
    )


def _nan_to_none(x: float):
    if math.isnan(x) or math.isinf(x):
        return None
    return round(x, 2)


def _marginal_line(resource: str, m: dict | None) -> str:
    """One human line per resource of the marginal analysis."""
    if m is None:
        return f"  {resource:<8} no single-node increment yields +1"
    unit = {"milli": "m", "bytes": "B", "slots": " pod slot(s)"}.get(
        m["unit"], m["unit"]
    )
    return (
        f"  {resource:<8} +{m['delta']}{unit} on {m['node'] or '<phantom>'}"
        " -> +1 replica"
    )


def explain_table_report(result, s: int = 0) -> str:
    """Bottleneck attribution as a compact table + marginal summary.

    ``result`` is an :class:`~..explain.ExplainResult`; ``s`` selects the
    scenario.  The reference transcript is untouched by design — this is
    a NEW view (the reference's percentages never influence the fit,
    ``ClusterCapacity.go:113-117``); the summary block names the binding
    constraint per node, the binding histogram, and the smallest
    single-node capacity increment that buys one more replica.
    """
    snapshot = result.snapshot
    fits = result.fits[s]
    names = result.binding_names(s)
    header = (
        f"{'NODE':<24} {'HEALTHY':<8} {'BINDING':<10} {'FIT':>7} "
        f"{'CPU_FIT':>9} {'MEM_FIT':>9} {'POD_SLOTS':>10}"
    )
    lines = [header, "-" * len(header)]
    for i in range(snapshot.n_nodes):
        lines.append(
            f"{snapshot.names[i] or '<phantom>':<24} "
            f"{'yes' if snapshot.healthy[i] else 'NO':<8} "
            f"{names[i]:<10} "
            f"{int(fits[i]):>7} "
            f"{int(result.cpu_fit[s][i]):>9} "
            f"{int(result.mem_fit[s][i]):>9} "
            f"{int(result.slots[s][i]):>10}"
        )
    lines.append("-" * len(header))
    counts = result.binding_counts(s)
    lines.append(
        "binding: "
        + "  ".join(f"{k}={v}" for k, v in counts.items() if v)
    )
    total = int(np.sum(fits))
    replicas = int(result.replicas[s])
    verdict = "SCHEDULABLE" if total >= replicas else "NOT SCHEDULABLE"
    lines.append(
        f"total possible replicas: {total}   requested: {replicas}   "
        f"verdict: {verdict}"
    )
    lines.append("marginal (+1 replica):")
    for resource, m in result.marginal(s).items():
        lines.append(_marginal_line(resource, m))
    return "\n".join(lines)


def explain_json_report(result, s: int = 0) -> str:
    """The same explanation as structured JSON (machine surface)."""
    snapshot = result.snapshot
    fits = result.fits[s]
    names = result.binding_names(s)
    total = int(np.sum(fits))
    nodes = [
        {
            "name": snapshot.names[i],
            "healthy": bool(snapshot.healthy[i]),
            "binding": names[i],
            "fit": int(fits[i]),
            "cpu_fit": int(result.cpu_fit[s][i]),
            "mem_fit": int(result.mem_fit[s][i]),
            "pod_slots": int(result.slots[s][i]),
        }
        for i in range(snapshot.n_nodes)
    ]
    return json.dumps(
        {
            "mode": result.mode,
            "scenario": {
                "cpu_request_milli": int(result.cpu_request_milli[s]),
                "mem_request_bytes": int(result.mem_request_bytes[s]),
                "replicas": int(result.replicas[s]),
            },
            "nodes": nodes,
            "binding_counts": result.binding_counts(s),
            "marginal": result.marginal(s),
            "saturation": result.saturation(s),
            "total_possible_replicas": total,
            "schedulable": total >= int(result.replicas[s]),
        },
        indent=2,
    )


def table_report(
    snapshot: ClusterSnapshot, fits: np.ndarray, scenario: Scenario
) -> str:
    """Compact human-readable table (a view the reference never had)."""
    header = (
        f"{'NODE':<24} {'HEALTHY':<8} {'CPU USED/ALLOC (m)':<22} "
        f"{'MEM USED/ALLOC (MiB)':<24} {'PODS':<9} {'FIT':>6}"
    )
    lines = [header, "-" * len(header)]
    mib = 1024 * 1024
    for i in range(snapshot.n_nodes):
        lines.append(
            f"{snapshot.names[i] or '<phantom>':<24} "
            f"{'yes' if snapshot.healthy[i] else 'NO':<8} "
            f"{f'{int(snapshot.used_cpu_req_milli[i])}/{int(snapshot.alloc_cpu_milli[i])}':<22} "
            f"{f'{int(snapshot.used_mem_req_bytes[i]) // mib}/{int(snapshot.alloc_mem_bytes[i]) // mib}':<24} "
            f"{f'{int(snapshot.pods_count[i])}/{int(snapshot.alloc_pods[i])}':<9} "
            f"{int(fits[i]):>6}"
        )
    total = int(np.sum(fits))
    verdict = "SCHEDULABLE" if total >= scenario.replicas else "NOT SCHEDULABLE"
    lines.append("-" * len(header))
    lines.append(
        f"total possible replicas: {total}   requested: {scenario.replicas}   "
        f"verdict: {verdict}"
    )
    return "\n".join(lines)


# The stochastic family's renderers (the JAX module's, verbatim): each takes
# the op's wire shape, so the library result, the service reply and the
# CLI print the same text.


def timeline_table_report(timeline: dict) -> str:
    """The ``timeline`` op's response as operator-readable text.

    Three blocks: per-generation watch capacities (one row per
    generation, one column per watch — the drift at a glance), the
    attributed deltas (the "what changed and why" one-liners the diff
    engine + binding-shift analysis produce), and current alert states.
    """
    if not timeline.get("enabled", False):
        return "timeline: not enabled on this server (-watch/-timeline-depth)"
    watches = [w["name"] for w in timeline.get("watchlist", [])]
    lines = [
        f"capacity timeline: {timeline['count']} generation(s) held "
        f"(depth {timeline['depth']}), serving generation "
        f"{timeline['generation']}"
    ]
    records = timeline.get("records", [])
    if records:
        header = f"{'GEN':>5} {'NODES':>7} {'HEALTHY':>8} {'DIGEST':<18}"
        for w in watches:
            header += f" {w[:14]:>14}"
        lines += ["", header, "-" * len(header)]
        for rec in records:
            row = (
                f"{rec['generation']:>5} {rec['nodes']:>7} "
                f"{rec['healthy_nodes']:>8} {rec['digest']:<18}"
            )
            for w in watches:
                wr = rec["watches"].get(w)
                cell = "-" if wr is None else (
                    f"{wr['total']}{'!' if wr['breached'] else ''}"
                )
                row += f" {cell:>14}"
            lines.append(row)
        lines.append("-" * len(header))
        if any(
            r["watches"].get(w, {}).get("breached")
            for r in records
            for w in watches
        ):
            lines.append("('!' = below the watch's min_replicas)")
    deltas = timeline.get("deltas", [])
    if deltas:
        lines += ["", "deltas:"]
        for d in deltas:
            lines.append(
                f"  gen {d['from_generation']}→{d['to_generation']}: "
                f"+{len(d['nodes_added'])} node(s), "
                f"-{len(d['nodes_removed'])}, "
                f"{d['nodes_changed']} changed"
            )
            for w in sorted(d.get("watches", {})):
                lines.append(f"    {d['watches'][w]['summary']}")
    alerts = timeline.get("alerts", {})
    if alerts:
        lines += ["", "alerts:"]
        for name in sorted(alerts):
            a = alerts[name]
            line = f"  {name:<24} {a['state']}"
            if a["min_replicas"] is not None:
                line += (
                    f"  (min_replicas={a['min_replicas']}, "
                    f"last={a['last_total']}, breaches={a['breaches']})"
                )
            lines.append(line)
    if records:
        fc_rows = [
            (w, wr)
            for w, wr in sorted(records[-1].get("watches", {}).items())
            if wr is not None and wr.get("horizon_s") is not None
        ]
        if fc_rows:
            lines += ["", "forecast (latest generation):"]
            for w, wr in fc_rows:
                hmin = wr.get("horizon_min_capacity")
                line = (
                    f"  {w:<24} horizon {wr['horizon_s']:g}s  "
                    f"min {'-' if hmin is None else hmin}  "
                    f"ttb {_ttb_cell(wr.get('time_to_breach_s'))}"
                )
                if wr.get("degraded_time_axis"):
                    line += "  [degraded time axis]"
                lines.append(line)
    return "\n".join(lines)


def timeline_json_report(timeline: dict) -> str:
    """The ``timeline`` op's response, pretty-printed (machine surface —
    the wire shape verbatim, so scripts parse one schema)."""
    return json.dumps(timeline, indent=2)


def _burn_cell(v) -> str:
    """One burn-rate cell: '-' before two samples exist, else 'N.NNx'."""
    return "-" if v is None else f"{v:.2f}x"


def slo_table_report(status: dict) -> str:
    """The ``slo`` op's response as operator-readable text: one row per
    objective (state, short/long-window burn vs the fast-burn
    threshold), then the one-line verdict a pager would carry."""
    if not status.get("enabled", False):
        return "slo: not enabled on this server (-slo FILE)"
    header = (
        f"{'SLO':<20} {'OBJECTIVE':<26} {'OP':<8} {'STATE':<10} "
        f"{'BURN(short)':>12} {'BURN(long)':>11} {'THRESH':>7}"
    )
    lines = [header, "-" * len(header)]
    for name in sorted(status.get("status", {})):
        s = status["status"][name]
        lines.append(
            f"{name:<20} {s['objective']:<26} {s['op'] or '*':<8} "
            f"{s['state']:<10} "
            f"{_burn_cell(s['short_burn']):>12} "
            f"{_burn_cell(s['long_burn']):>11} "
            f"{s['fast_burn']:>6.1f}x"
        )
    lines.append("-" * len(header))
    breached = [
        n for n, s in status.get("status", {}).items()
        if s.get("state") == "breached"
    ]
    if breached:
        lines.append(
            "verdict: FAST BURN — error budget burning on "
            + ", ".join(sorted(breached))
        )
    else:
        lines.append(
            "verdict: ok — every objective within its error budget "
            f"({status.get('evaluations', 0)} evaluation(s))"
        )
    return "\n".join(lines)


def slo_json_report(status: dict) -> str:
    """``kccap -slo-status -output json``: the wire shape verbatim."""
    return json.dumps(status, indent=2, sort_keys=True)


def _phases_cell(phases: dict | None) -> str:
    """A record's per-phase breakdown as ``phase=ms`` pairs, largest
    first — the part that makes a pasted slow request self-explaining."""
    if not phases:
        return ""
    parts = sorted(phases.items(), key=lambda kv: (-kv[1], kv[0]))
    return " ".join(f"{k}={v:g}ms" for k, v in parts)


def dump_table_report(dump: dict) -> str:
    """The ``dump`` op's response as operator-readable text: one line
    per flight record (latency + status), each followed by its phase
    decomposition when the record carries one."""
    records = dump.get("records", [])
    lines = [
        f"flight recorder: {dump.get('count', len(records))} record(s) "
        f"(capacity {dump.get('capacity')}, dropped {dump.get('dropped')}), "
        f"serving generation {dump.get('generation')}"
    ]
    for r in records:
        line = (
            f"  #{r.get('seq'):<6} {r.get('op'):<16} "
            f"gen={r.get('generation'):<5} "
            f"{r.get('latency_ms'):>9}ms  {r.get('status')}"
        )
        if r.get("error"):
            line += f"  [{r['error']}]"
        lines.append(line)
        phases = _phases_cell(r.get("phases"))
        if phases:
            lines.append(f"          phases: {phases}")
    return "\n".join(lines)


def dump_json_report(dump: dict) -> str:
    """``kccap -dump -output json``: the wire shape verbatim."""
    return json.dumps(dump, indent=2, sort_keys=True)


def car_table_report(car: dict) -> str:
    """One capacity-at-risk evaluation (the ``car`` op's wire shape /
    ``CaRResult.to_wire()``) as operator-readable text: the quantile
    ladder with per-quantile binding attribution, then the
    probability-of-fit verdict a deployment gate would script on."""
    lines = [
        f"capacity at risk ({car.get('mode')} semantics, "
        f"{car.get('samples')} samples, seed {car.get('seed')})"
    ]
    binding = car.get("binding", {})
    header = f"{'QUANTILE':<10} {'CAPACITY':>10}  BINDING"
    lines += [header, "-" * len(header)]
    for label in sorted(
        car.get("quantiles", {}),
        key=lambda p: float(p[1:]),
    ):
        counts = binding.get(label, {})
        bind = "  ".join(
            f"{k}={v}" for k, v in counts.items() if v
        )
        lines.append(
            f"{label:<10} {car['quantiles'][label]:>10}  {bind}"
        )
    lines.append("-" * len(header))
    lines.append(
        f"mean capacity: {car.get('mean')}   sample range: "
        f"[{car.get('min_total')}, {car.get('max_total')}]"
    )
    replicas = car.get("replicas")
    prob = car.get("prob_fit")
    confidence = car.get("confidence")
    verdict = (
        "SCHEDULABLE" if car.get("schedulable") else "NOT SCHEDULABLE"
    )
    lines.append(
        f"P(fit {replicas} replicas) = {prob}   required confidence: "
        f"{confidence}   verdict: {verdict}"
    )
    return "\n".join(lines)


def car_json_report(car: dict) -> str:
    """``kccap -car-spec -output json``: the wire shape verbatim."""
    return json.dumps(car, indent=2, sort_keys=True)


def car_status_table_report(status: dict) -> str:
    """The ``car`` op's watch-status form as operator-readable text:
    one row per quantile watch (capacity at its confidence, the
    probability-of-fit, the alert state)."""
    if not status.get("enabled", False):
        return (
            "capacity at risk: no quantile watches on this server "
            "(-watch entries need a quantile: field)"
        )
    header = (
        f"{'WATCH':<24} {'QUANTILE':>9} {'CAPACITY':>9} {'MIN':>6} "
        f"{'P(FIT)':>8} {'SAMPLES':>8}  STATE"
    )
    lines = [
        f"capacity at risk: serving generation {status.get('generation')}",
        header,
        "-" * len(header),
    ]
    def _cell(v):
        return "-" if v is None else v

    for name in sorted(status.get("watches", {})):
        w = status["watches"][name]
        alert = w.get("alert", {})
        qlabel = f"p{w['quantile'] * 100:g}"
        lines.append(
            f"{name:<24} "
            f"{qlabel:>9} "
            f"{_cell(w.get('last_total')):>9} "
            f"{_cell(w.get('min_replicas')):>6} "
            f"{_cell(w.get('prob_fit')):>8} "
            f"{w.get('samples'):>8}  {alert.get('state')}"
        )
    lines.append("-" * len(header))
    breached = status.get("breached", [])
    lines.append(
        "verdict: "
        + (
            "BREACHED — " + ", ".join(breached)
            if breached
            else "ok — every quantile watch above its threshold"
        )
    )
    return "\n".join(lines)


def car_status_json_report(status: dict) -> str:
    """``kccap -car -output json``: the wire shape verbatim."""
    return json.dumps(status, indent=2, sort_keys=True)


def _ttb_cell(ttb) -> str:
    """Render a ``time_to_breach_s`` value: seconds (with an hour
    translation when it earns one) or ``-`` for "no breach within the
    horizon"."""
    if ttb is None:
        return "-"
    s = float(ttb)
    if s >= 3600.0:
        return f"{s:.0f}s (~{s / 3600.0:.1f}h)"
    return f"{s:.0f}s"


def forecast_table_report(fc: dict) -> str:
    """One horizon projection (the ``forecast`` op's wire shape /
    ``HorizonResult.to_wire()``) as operator-readable text: per
    quantile the current capacity, the horizon minimum, and the
    time-to-breach verdict an autoscaler would script on."""
    growth = fc.get("growth", {})
    lines = [
        f"capacity forecast ({fc.get('mode')} semantics, "
        f"{fc.get('samples')} samples, seed {fc.get('seed')}): "
        f"{fc.get('steps')} step(s) x {fc.get('step_s')}s = "
        f"{fc.get('horizon_s')}s horizon",
        f"growth: cpu {growth.get('cpu_per_s')}/s   "
        f"memory {growth.get('memory_per_s')}/s   "
        f"threshold: {fc.get('threshold')} replicas",
    ]
    if fc.get("degraded_time_axis"):
        lines.append(
            "WARNING: degraded time axis — trend fitted on record "
            "ordinals, not timestamps"
        )
    header = (
        f"{'QUANTILE':<10} {'NOW':>10} {'HORIZON MIN':>12}  "
        f"TIME TO BREACH"
    )
    lines += [header, "-" * len(header)]
    ttb = fc.get("time_to_breach_s", {})
    now = fc.get("now", {})
    for label in sorted(fc.get("quantiles", {}), key=lambda p: float(p[1:])):
        ladder = fc["quantiles"][label]
        lines.append(
            f"{label:<10} {now.get(label):>10} {min(ladder):>12}  "
            f"{_ttb_cell(ttb.get(label))}"
        )
    lines.append("-" * len(header))
    breached = fc.get("breached_within_horizon", [])
    lines.append(
        "verdict: "
        + (
            "BREACH WITHIN HORIZON — " + ", ".join(breached)
            if breached
            else "ok — no quantile crosses the threshold within the horizon"
        )
    )
    return "\n".join(lines)


def forecast_json_report(fc: dict) -> str:
    """``kccap -forecast-spec -output json``: the wire shape verbatim."""
    return json.dumps(fc, indent=2, sort_keys=True)


def forecast_status_table_report(status: dict) -> str:
    """The ``forecast`` op's watch-status form as operator-readable
    text: one row per horizon watch (current capacity at its quantile,
    the projected horizon minimum, time-to-breach, the alert state)."""
    if not status.get("enabled", False):
        return (
            "capacity forecast: no horizon watches on this server "
            "(-watch entries need a horizon: block)"
        )
    header = (
        f"{'WATCH':<24} {'QUANTILE':>9} {'NOW':>9} {'HMIN':>9} "
        f"{'MIN':>6} {'TTB':>14}  STATE"
    )
    lines = [
        f"capacity forecast: serving generation {status.get('generation')}",
        header,
        "-" * len(header),
    ]

    def _cell(v):
        return "-" if v is None else v

    for name in sorted(status.get("watches", {})):
        w = status["watches"][name]
        alert = w.get("alert", {})
        qlabel = f"p{w['quantile'] * 100:g}"
        ttb = w.get("time_to_breach_s")
        lines.append(
            f"{name:<24} "
            f"{qlabel:>9} "
            f"{_cell(w.get('last_total')):>9} "
            f"{_cell(w.get('horizon_min_capacity')):>9} "
            f"{_cell(w.get('min_replicas')):>6} "
            f"{_ttb_cell(ttb):>14}  {alert.get('state')}"
        )
    lines.append("-" * len(header))
    breached = status.get("breached", [])
    lines.append(
        "verdict: "
        + (
            "BREACHED — " + ", ".join(breached)
            if breached
            else "ok — every horizon watch above its threshold"
        )
    )
    return "\n".join(lines)


def forecast_status_json_report(status: dict) -> str:
    """``kccap -forecast -output json``: the wire shape verbatim."""
    return json.dumps(status, indent=2, sort_keys=True)


def plan_table_report(plan: dict) -> str:
    """One capacity plan (the ``plan`` op's catalog form /
    ``PlanResult.to_wire()``) as operator-readable text: the purchase
    list with the certified-vs-LP-bound gap, the shadow-price
    attribution, and the drain dual when requested."""
    lines = [
        f"capacity plan ({plan.get('mode')} semantics, "
        f"{plan.get('samples')} samples, seed {plan.get('seed')}): "
        f"target {plan.get('target')} replicas at "
        f"{plan.get('quantile')}",
        f"base {plan.get('quantile')} capacity: "
        f"{plan.get('base_quantile_capacity')}   projected: "
        f"{plan.get('projected_quantile_capacity')}",
    ]
    buy = plan.get("buy", [])
    if buy:
        header = f"{'SHAPE':<20} {'COUNT':>6} {'UNIT COST':>10} {'COST':>10}"
        lines += [header, "-" * len(header)]
        for row in buy:
            lines.append(
                f"{row.get('shape'):<20} {row.get('count'):>6} "
                f"{row.get('unit_cost'):>10} {row.get('cost'):>10}"
            )
        lines.append("-" * len(header))
    else:
        lines.append("buy: nothing — the target already holds")
    lp = plan.get("lp_bound")
    lines.append(
        f"total cost: {plan.get('total_cost')}   LP bound: "
        f"{'-' if lp is None else lp}   gap: {plan.get('gap_pct')}%"
    )
    shadow = plan.get("shadow_prices", {})
    if shadow:
        lines.append(
            "shadow prices: "
            + "  ".join(f"{k}={v}" for k, v in sorted(shadow.items()))
        )
    if plan.get("demand_price") is not None:
        lines.append(
            f"marginal replica price: {plan.get('demand_price')}"
        )
    drain = plan.get("drain")
    if drain:
        lines.append(
            f"drain: {drain.get('free_count')} node(s) free "
            f"(verified={drain.get('free_verified')}), "
            f"{drain.get('surplus_count')} more drainable holding "
            f"{plan.get('quantile')} >= target "
            f"(capacity after: {drain.get('quantile_after_drain')})"
        )
        if drain.get("free_nodes"):
            lines.append(f"  free: {', '.join(drain['free_nodes'])}")
        if drain.get("surplus_nodes"):
            lines.append(
                f"  surplus: {', '.join(drain['surplus_nodes'])}"
            )
    verdict = plan.get("status", "uncertified").upper()
    reason = plan.get("uncertified_reason")
    lines.append(
        f"verdict: {verdict}"
        + (f" — {reason}" if reason else "")
    )
    return "\n".join(lines)


def plan_json_report(plan: dict) -> str:
    """``kccap -plan ... -output json``: the wire shape verbatim."""
    return json.dumps(plan, indent=2, sort_keys=True)


def gang_table_report(gang: dict) -> str:
    """A gang evaluation (the ``gang`` op's wire shape / ``kccap
    -gang-spec``) as operator-readable text: the whole-gang verdict,
    the constraint vocabulary in force, and the binding-level
    explanation when present."""
    spread = (
        f"{gang.get('spread_level')}<={gang.get('max_ranks_per_domain')}"
        if gang.get("spread_level")
        else ("host<=1" if gang.get("anti_affinity_host") else "-")
    )
    gangs = gang.get("gangs", [])
    sched = gang.get("schedulable", [])
    lines = [
        f"gang capacity: {gang.get('ranks')} rank(s)/gang, "
        f"{gang.get('count')} gang(s) requested  "
        f"[colocate={gang.get('colocate') or 'cluster'} spread={spread} "
        f"mode={gang.get('mode')} engine={gang.get('engine')}]",
    ]
    for s, (g, ok) in enumerate(zip(gangs, sched)):
        pods = gang.get("pod_totals", [None] * len(gangs))[s]
        lines.append(
            f"  scenario {s}: {g} whole gang(s) fit "
            f"(pod capacity {pods}) — "
            + ("schedulable" if ok else "NOT schedulable")
        )
    ex = gang.get("explain")
    if ex:
        lines.append(f"  {ex.get('summary')}")
        largest = ex.get("largest_domain") or {}
        if largest.get("name") is not None:
            lines.append(
                f"  largest {ex.get('colocate') or 'domain'}: "
                f"{largest.get('name')} holds {largest.get('capacity')} "
                f"rank(s) = {largest.get('whole_gangs')} whole gang(s)"
            )
        if ex.get("excluded_nodes"):
            lines.append(
                f"  excluded nodes (missing topology labels): "
                f"{ex['excluded_nodes']}"
            )
    return "\n".join(lines)


def gang_json_report(gang: dict) -> str:
    """``-output json``: the wire shape verbatim."""
    return json.dumps(gang, indent=2, sort_keys=True)


def optimize_table_report(opt: dict) -> str:
    """An optimize evaluation (the ``optimize`` op's wire shape /
    ``kccap -optimize``) as operator-readable text: per scenario the
    certified LP bound vs the rounded integral packing vs the
    first-fit baseline, the certificate verdict, and the shadow-price
    story ("memory is the priced-out resource on 60% of capacity")."""
    if opt.get("backend") == "ffd":
        lines = [
            f"packing (first-fit reference, mode={opt.get('mode')}):",
        ]
        for s in range(opt.get("scenarios", 0)):
            lines.append(
                f"  scenario {s}: placed {opt['ffd'][s]} of "
                f"{opt['demand'][s]} requested (fit total "
                f"{opt['totals'][s]}) — "
                + (
                    "schedulable"
                    if opt["schedulable"][s]
                    else "NOT schedulable"
                )
            )
        return "\n".join(lines)
    header = (
        f"{'S':>3} {'DEMAND':>9} {'LP BOUND':>12} {'ROUNDED':>9} "
        f"{'FFD':>9} {'GAP%':>7}  STATUS"
    )
    lines = [
        f"optimized packing (LP/PDHG, mode={opt.get('mode')}): "
        f"{opt.get('groups')} group(s) over {opt.get('nodes')} node(s)"
        + (
            " [grouped]"
            if opt.get("grouping_engaged")
            else " [ungrouped]"
        ),
        f"solver: {opt.get('iterations')} iteration(s), tol "
        f"{opt.get('tol')}, {opt.get('solve_seconds')}s",
        header,
        "-" * len(header),
    ]
    for s in range(opt.get("scenarios", 0)):
        flags = ""
        if opt.get("ffd_exceeds_bound", [False] * (s + 1))[s]:
            flags = " (ffd exceeds sane bound: reference quirk)"
        verified = opt.get("verified")
        if verified is not None and not verified[s]:
            flags += " (ROUNDING UNVERIFIED)"
        lines.append(
            f"{s:>3} {opt['demand'][s]:>9} {opt['lp_bound'][s]:>12.2f} "
            f"{opt['rounded'][s]:>9} {opt['ffd'][s]:>9} "
            f"{opt['gap_pct'][s]:>7.3f}  {opt['status'][s]}" + flags
        )
    lines.append("-" * len(header))
    for s, shadow in enumerate(opt.get("shadow_prices", [])):
        priced = shadow.get("priced_out", {})
        top = max(priced, key=priced.get) if priced else None
        if top is not None and priced[top] > 0:
            lines.append(
                f"  scenario {s}: {top} is the priced-out resource on "
                f"{priced[top] * 100:.0f}% of capacity "
                f"(demand price {shadow.get('demand_price')})"
            )
        else:
            lines.append(
                f"  scenario {s}: demand-bound — no capacity is "
                f"priced (demand price {shadow.get('demand_price')})"
            )
    lines.append(
        "verdict: "
        + (
            "certified — every bound carries a duality certificate"
            if opt.get("certified")
            else "UNCERTIFIED — bound(s) valid but loose; raise "
            "KCCAP_OPT_ITERS or tol"
        )
    )
    return "\n".join(lines)


def optimize_json_report(opt: dict) -> str:
    """``-output json``: the wire shape verbatim."""
    return json.dumps(opt, indent=2, sort_keys=True)


def gang_status_table_report(status: dict) -> str:
    """The ``gang`` op's watch-status form (``kccap -gang HOST:PORT``):
    one row per gang watch — last whole-gang count, binding level,
    alert state — and the scriptable verdict line."""
    if not status.get("enabled", False):
        return (
            "gang capacity: no gang watches on this server "
            "(-watch entries need a gang: block)"
        )
    header = (
        f"{'WATCH':<24} {'RANKS':>6} {'WANT':>5} {'GANGS':>6} "
        f"{'MIN':>5} {'BINDS':>8}  STATE"
    )
    lines = [
        f"gang capacity: serving generation {status.get('generation')}",
        header,
        "-" * len(header),
    ]

    def _cell(v):
        return "-" if v is None else v

    for name in sorted(status.get("watches", {})):
        w = status["watches"][name]
        alert = w.get("alert", {})
        lines.append(
            f"{name:<24} "
            f"{w.get('ranks'):>6} "
            f"{w.get('count'):>5} "
            f"{_cell(w.get('last_gangs')):>6} "
            f"{_cell(w.get('min_replicas')):>5} "
            f"{_cell(w.get('binding')):>8}  {alert.get('state')}"
        )
    lines.append("-" * len(header))
    breached = status.get("breached", [])
    lines.append(
        "verdict: "
        + (
            "BREACHED — " + ", ".join(breached)
            if breached
            else "ok — every gang watch above its threshold"
        )
    )
    return "\n".join(lines)


def gang_status_json_report(status: dict) -> str:
    """``kccap -gang -output json``: the wire shape verbatim."""
    return json.dumps(status, indent=2, sort_keys=True)


def fed_status_table_report(status: dict) -> str:
    """``kccap -fed-status`` as operator-readable text: one row per
    cluster with its generation watermark, verified age, and
    fresh/stale/lost state — the degradation contract at a glance."""
    if not status.get("enabled", False):
        return "federation: no clusters attached to this endpoint"
    header = f"{'CLUSTER':<24} {'GENERATION':>11} {'AGE_S':>9}  STATE"
    lines = [
        (
            f"federation: {status['counts']['total']} cluster(s) "
            f"(stale>{status.get('stale_after_s'):g}s, "
            f"lost>{status.get('evict_after_s'):g}s)"
        ),
        header,
        "-" * len(header),
    ]
    for name in sorted(status.get("clusters", {})):
        c = status["clusters"][name]
        age = c.get("age_s")
        lines.append(
            f"{name:<24} {c.get('generation'):>11} "
            f"{'-' if age is None else age:>9}  {c.get('state')}"
        )
    lines.append("-" * len(header))
    excluded = status.get("excluded", [])
    lines.append(
        "verdict: "
        + (
            "DEGRADED — lost: " + ", ".join(excluded)
            if excluded
            else (
                "ok — every cluster within the staleness bound"
                if status["counts"].get("stale", 0) == 0
                else "STALE — "
                + str(status["counts"]["stale"])
                + " cluster(s) serving explicitly-stale views"
            )
        )
    )
    return "\n".join(lines)


def fed_status_json_report(status: dict) -> str:
    """``kccap -fed-status -output json``: the wire shape verbatim."""
    return json.dumps(status, indent=2, sort_keys=True)


def fed_sweep_table_report(result: dict) -> str:
    """``kccap -fed-sweep`` as operator-readable text: the fleet total
    per scenario, the per-cluster split (each row carrying its stamped
    generation and state), and the named exclusions — a lost cluster is
    never a silent hole in a sum."""
    header = f"{'CLUSTER':<24} {'GENERATION':>11}  {'STATE':<6}  TOTALS"
    lines = [header, "-" * len(header)]
    clusters = result.get("clusters", {})
    for name in sorted(result.get("per_cluster", {})):
        c = clusters.get(name, {})
        totals = result["per_cluster"][name]
        lines.append(
            f"{name:<24} {c.get('generation'):>11}  "
            f"{c.get('state'):<6}  {totals}"
        )
    for name in result.get("excluded", []):
        c = clusters.get(name, {})
        lines.append(
            f"{name:<24} {c.get('generation'):>11}  "
            f"{'lost':<6}  EXCLUDED from totals"
        )
    lines.append("-" * len(header))
    lines.append(f"fleet totals      : {result.get('totals')}")
    lines.append(f"schedulable       : {result.get('schedulable')}")
    excluded = result.get("excluded", [])
    lines.append(
        "verdict: "
        + (
            "DEGRADED — totals exclude lost cluster(s): "
            + ", ".join(excluded)
            if excluded
            else (
                "ok (some clusters explicitly stale)"
                if result.get("degraded")
                else "ok — every cluster fresh"
            )
        )
    )
    return "\n".join(lines)


def fed_sweep_json_report(result: dict) -> str:
    """``kccap -fed-sweep -output json``: the wire shape verbatim."""
    return json.dumps(result, indent=2, sort_keys=True)


def replay_table_report(result: dict) -> str:
    """``kccap-torch -replay`` as operator-readable text: the chain verdict,
    the request tallies, and one line per non-ok outcome (a clean
    replay stays terse — the verdict IS the product)."""
    lines = [
        f"audit replay: {result['directory']}",
        f"  generations verified: {len(result['generations_verified'])}"
        + (
            f" (chain BROKEN: {result['chain_error']})"
            if result.get("chain_error")
            else ""
        ),
    ]
    if result.get("recovered_tail_records"):
        lines.append(
            f"  recovered: {result['recovered_tail_records']} torn tail "
            "record(s) dropped (crash-consistent load)"
        )
    c = result["counts"]
    lines.append(
        f"  requests replayed: {result['requests']}  "
        f"ok={c.get('ok', 0)} mismatch={c.get('mismatch', 0)} "
        f"skipped={c.get('skipped', 0)} error={c.get('error', 0)}"
    )
    for o in result["outcomes"]:
        if o["status"] == "ok":
            continue
        line = (
            f"  {o['status'].upper():<8} {o.get('op')} "
            f"gen={o.get('generation')} ref={o.get('ref')}"
        )
        if o["status"] == "mismatch":
            line += (
                f"  recorded={o.get('recorded_digest')} "
                f"replayed={o.get('replayed_digest', o.get('replayed_error'))}"
            )
        elif o.get("reason"):
            line += f"  ({o['reason']})"
        lines.append(line)
    lines.append(
        "verdict: "
        + ("CLEAN — every replay re-answered identically"
           if result["clean"] else "MISMATCH — see lines above")
    )
    return "\n".join(lines)


def replay_json_report(result: dict) -> str:
    """``kccap-torch -replay -output json``: the replay summary verbatim."""
    return json.dumps(result, indent=2, sort_keys=True)


def trace_table_report(tree: dict) -> str:
    """``kccap -trace-tree`` as operator-readable text: the assembled
    span tree (parent linkage only — indentation IS causality), the
    greedy critical path with per-step self time, and the dominating
    contributor in the ``phases`` vocabulary.  A clock-skew refusal is
    reported as a refusal, never as a confident wrong answer."""
    tid = tree.get("trace_id", "")
    if not tree.get("found"):
        return (
            f"trace {tid}: no spans found in the given logs\n"
            "verdict: NOT FOUND — wrong -trace-logs directories, or the "
            "trace's bodies were dropped by tail sampling on every hop"
        )
    lines = [
        f"trace {tid}: {tree.get('spans', 0)} span(s) across "
        + (", ".join(tree.get("processes", [])) or "unknown processes")
        + (
            f"  (orphaned: {tree['orphans']})"
            if tree.get("orphans")
            else ""
        )
    ]
    skew = tree.get("clock_skew_spans", [])
    if skew:
        lines.append(
            f"clock skew: {len(skew)} span(s) with negative durations "
            "flagged (wall-clock stepped mid-span): " + ", ".join(skew)
        )
    in_flight = tree.get("in_flight", [])
    if in_flight:
        lines.append(
            f"in flight: {len(in_flight)} span(s) recorded without a "
            "usable duration (process died mid-request?) excluded "
            "from assembly: " + ", ".join(in_flight)
        )

    def _walk(node, depth, seen):
        if id(node) in seen or depth > 64:
            return
        seen.add(id(node))
        flags = []
        if node.get("clock_skew"):
            flags.append("CLOCK_SKEW")
        if node.get("status") not in (None, "ok"):
            flags.append(str(node.get("status")).upper())
        for key in ("hedge", "winner", "leader"):
            if node.get(key):
                flags.append(key)
        if node.get("failover_reason"):
            flags.append(f"failover={node['failover_reason']}")
        if node.get("cluster"):
            flags.append(f"cluster={node['cluster']}")
        if node.get("state") and node.get("state") != "fresh":
            flags.append(f"state={node['state']}")
        dur = node.get("duration_ms")
        lines.append(
            "  " * depth
            + f"- {node.get('op', '?')} [{node.get('service', '?')}] "
            + (f"{dur:g}ms" if isinstance(dur, (int, float)) else "?ms")
            + (("  " + " ".join(flags)) if flags else "")
        )
        for child in node.get("children", ()):
            _walk(child, depth + 1, seen)

    seen: set = set()
    for root in tree.get("roots", []):
        _walk(root, 1, seen)
    cp = tree.get("critical_path") or {}
    if cp.get("refused"):
        lines.append(
            "critical path: REFUSED ("
            + cp["refused"]
            + (
                ") — a poisoned (negative) duration is on the path; "
                "fix the host clock or read the raw spans"
                if cp["refused"] == "clock_skew"
                else ") — nothing to attribute"
            )
        )
        return "\n".join(lines)
    lines.append(f"critical path ({cp.get('total_ms', 0.0):g}ms end-to-end):")
    for step in cp.get("path", []):
        lines.append(
            f"  {step.get('op', '?'):<24} [{step.get('service', '?'):<10}] "
            f"{step.get('duration_ms', 0.0):>10g}ms  "
            f"self {step.get('self_ms', 0.0):g}ms"
            + (
                f"  {str(step.get('status')).upper()}"
                if step.get("status")
                else ""
            )
        )
    dom = cp.get("dominant")
    if dom:
        lines.append(
            f"verdict: dominated by {dom['name']} — {dom['ms']:g}ms "
            f"({dom['share'] * 100:.1f}% of end-to-end)"
        )
    return "\n".join(lines)


def trace_json_report(tree: dict) -> str:
    """``kccap -trace-tree -output json``: the assembled tree (nested
    ``children``) plus ``critical_path`` verbatim."""
    return json.dumps(tree, indent=2, sort_keys=True)
