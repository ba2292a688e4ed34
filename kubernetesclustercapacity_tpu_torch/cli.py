"""CLI (L4): the reference's question on PyTorch / CUDA — one pod spec, or
a sweep of them.

Counterpart of ``kubernetesclustercapacity_tpu/cli.py`` (its flag layer
and dispatch, ``:544-609``, ``_run_explain``, ``:1575-1604``,
``_extended_names`` / ``_parse_extended_requests`` / ``_run_single`` /
``_emit_report``, ``:1701-1873``, ``_run_grid``, ``:1876-1983``,
``_run_drain``, ``:1606-1641``, ``_run_drain_server``, ``:1217-1249``,
and the stochastic family, ``_run_car_status``, ``_run_car_spec``,
``_run_forecast_status``, ``_load_operator_doc``, ``_run_forecast_spec``
and ``_run_plan``, ``:675-1010``, and ``_run_gang_status``,
``_run_gang_spec`` and ``_run_optimize``, ``:1012-1148``, the operator's
``_run_timeline``, ``:612-647``, ``_run_slo_status`` and ``_run_dump``,
``:1158-1214``, ``_run_plane_status``, ``:1252-1290``, and
``_run_replay``, ``:1361-1430``, and the telemetry wrapper of ``main``,
``:466-541``).
The reference's six flags parse exactly as there
(``ClusterCapacity.go:50-83``), so an invalid memory or replicas value
prints the reference's fatal line.  Then, for one spec, it prints the
reference transcript (``-output reference``, the default), the JSON report
or the table, byte for byte as the JAX CLI does; ``-explain`` prints the
binding attribution and marginals instead; a random ``-grid N`` sweep runs
through :func:`..ops.fused_fit.sweep_snapshot_auto`, or, with
``-extended-request NAME=QTY``, through the R-resource
:func:`..ops.fused_multi.sweep_multi_auto`, and prints the same JSON or
table as the JAX CLI apart from the kernel label.  ``-drain NODE``
prints the rehoming plan of a ``kubectl drain`` (strict semantics, each
pod placed with its own requests, the disruption-budget gate; exit 1 when
the node is not evictable), and ``-drain-server HOST:PORT`` drains a
running capacity server.  ``-car-spec``, ``-forecast-spec`` (explicit
growth or a trend fitted from an audit log) and ``-plan -catalog`` answer
the stochastic questions offline; ``-gang-spec`` counts whole gangs over
the zone/rack/host hierarchy and ``-optimize`` (``-opt-backend lp|ffd``)
answers with the certified LP packing; ``-car``/``-forecast``/``-gang
HOST:PORT`` render a server's watch status, and ``-timeline``,
``-slo-status`` and ``-dump HOST:PORT`` its capacity timeline, SLO burn
rates and flight recorder.  ``-metrics-port`` serves the process
registry for the run's duration and ``-trace-log`` records one span for
it.

The source is ``-snapshot`` (a fixture ``.json`` or a checkpoint
``.npz``) or, without it, the live cluster of ``-kubeconfig`` (default
``$HOME/.kube/config``): two paginated Lists through the port's stdlib
client (:mod:`.kubeapi`), packed like a fixture.  ``-backend torch`` (the
default) runs the port's device programs on ``-device``; ``-backend cpu``
is the pure-Python oracle, the reference's sequential walk, as a
cross-check.  ``-save-snapshot`` checkpoints the loaded snapshot and
``-group-min-count`` sets the grouping gate, as in the JAX CLI.  Every
other flag of the JAX CLI runs; only the compiled C++ loop (``-backend
native``) is not ported yet and says so with exit 1.  ``-replay DIR``
(``-replay-ref``, ``-replay-generation``, ``-replay-tenant``) re-answers
a server's audit log on ``-device``, and ``-plane-status HOST:PORT``
prints an endpoint's place in the replicated serving plane.
``-fed-status``/``-fed-sweep HOST:PORT`` read a federation endpoint
(``kccap-torch-fed``); ``-doctor`` (``-doctor-timeout``,
``-doctor-service``, ``-doctor-federation``) diagnoses the environment
on ``-device``; ``-profile HOST:PORT`` fetches a server's sampling
profile; ``-trace-tree ID -trace-logs DIRS`` stitches a distributed
trace; ``-bench-diff`` compares bench artifacts; and ``-jax-profile DIR``
captures a ``torch.profiler`` Chrome trace of the run (the JAX CLI's
name, kept).

Examples::

    python -m kubernetesclustercapacity_tpu_torch.cli \\
        -snapshot tests/fixtures/kind-3node.json \\
        -cpuRequests=200m -memRequests=250mb -replicas=10
    python -m kubernetesclustercapacity_tpu_torch.cli \\
        -kubeconfig ~/.kube/config -grid 1000 -output json
    python -m kubernetesclustercapacity_tpu_torch.cli \\
        -snapshot cluster.npz -grid 1000 -semantics strict \\
        -extended-request nvidia.com/gpu=1 \\
        -extended-request ephemeral-storage=10Gi -output json
    python -m kubernetesclustercapacity_tpu_torch.cli \
        -snapshot cluster.json -semantics strict -drain node-7
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

__all__ = ["main", "build_parser", "load_source", "run"]

# The JAX CLI's flags for surfaces that are not ported yet, each with what
# it takes: a value, a switch, or one or more values.  Every one would be
# declared, so that using it prints a "not yet ported" line and exits 1
# (the JAX CLI would run; argparse would exit 2 on an unknown flag).  None
# is left: the one surface still missing is ``-backend native``, a value
# of a ported flag, which ``_run_command`` refuses.
_UNPORTED_FLAGS: tuple = ()

#: The one line a ``-node-bucket-floor`` run prints (to stderr) before it
#: goes on: the flag sizes the JAX package's shape-bucket ladder.
NO_BUCKET_LADDER = (
    "note : -node-bucket-floor is ignored: the PyTorch package has no "
    "shape-bucket ladder (eager PyTorch compiles nothing per shape)"
)


def add_unported_flags(p: argparse.ArgumentParser, flags) -> None:
    """Declare each ``(flag, kind)`` of ``flags``; a flag that is not used
    leaves no attribute (see :func:`unported_flags_used`)."""
    for flag, kind in flags:
        kw: dict = {"default": argparse.SUPPRESS,
                    "help": "not yet ported to the PyTorch package"}
        if kind == "switch":
            kw["action"] = "store_true"
        elif kind == "values":
            kw["nargs"] = "+"
        p.add_argument(flag, dest=_unported_dest(flag), **kw)


def _unported_dest(flag: str) -> str:
    return "unported_" + flag.lstrip("-").replace("-", "_")


def unported_flags_used(args, flags) -> list[str]:
    """The flags of ``flags`` that this command line used."""
    return [flag for flag, _ in flags if hasattr(args, _unported_dest(flag))]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kccap-torch",
        description="Kubernetes cluster-capacity simulator on PyTorch / CUDA",
    )
    home = os.environ.get("HOME", "") or os.environ.get("USERPROFILE", "")
    default_kubeconfig = os.path.join(home, ".kube", "config") if home else ""
    # The reference's six flags (same defaults, ClusterCapacity.go:50-62).
    p.add_argument("-kubeconfig", default=default_kubeconfig,
                   help="(optional) absolute path to the kubeconfig file")
    p.add_argument("-cpuRequests", default="100m",
                   help="CPU Requests either in cores(1) or milicores(250m)")
    p.add_argument("-cpuLimits", default="200m",
                   help="CPU Limits either in cores(2) or milicores(500m)")
    p.add_argument("-memRequests", default="100mb",
                   help="Memory requests either in GB(1) or megabytes(250mb)")
    p.add_argument("-memLimits", default="200mb",
                   help="Memory limits either in GB(2) or megabytes(500mb)")
    p.add_argument("-replicas", default="1", help="No of pod replicas")
    p.add_argument("-backend", choices=("torch", "cpu", "native"),
                   default="torch",
                   help="the device programs (torch, on -device), the "
                        "pure-Python sequential walk (cpu), or the compiled "
                        "C++ loop (native, not yet ported)")
    p.add_argument("-snapshot", default="",
                   help="offline source: fixture .json or checkpoint .npz")
    p.add_argument("-semantics", choices=("reference", "strict"),
                   default=None,
                   help="bug-compatible reference semantics or corrected mode "
                        "(default: reference; for .npz snapshots, the "
                        "semantics they were packed with)")
    p.add_argument("-output", choices=("reference", "json", "table"),
                   default="reference",
                   help="report format: the reference's transcript, "
                        "structured JSON, or a compact table (-grid and "
                        "-explain print JSON or a table)")
    p.add_argument("-grid", type=int, default=0, metavar="N",
                   help="evaluate a random N-scenario sweep instead of one "
                        "spec")
    p.add_argument("-seed", type=int, default=0, help="sweep RNG seed")
    p.add_argument("-kernel", choices=("auto", "exact"), default="auto",
                   help="sweep kernel: auto (the fused kernel when provably "
                        "bit-exact) or exact (force the int64 program)")
    p.add_argument("-extended-resources", default="",
                   dest="extended_resources", metavar="NAMES",
                   help="comma-separated extra resource columns to pack "
                        "(requires -semantics strict; e.g. nvidia.com/gpu)")
    p.add_argument("-extended-request", action="append", default=[],
                   dest="extended_requests", metavar="NAME=QTY",
                   help="per-replica request for an extended resource "
                        "(repeatable; strict quantity grammar, e.g. "
                        "nvidia.com/gpu=2, ephemeral-storage=10Gi)")
    p.add_argument("-metrics-port", type=int, default=0, dest="metrics_port",
                   metavar="PORT",
                   help="serve Prometheus /metrics (the process telemetry "
                        "registry: kernel dispatches, process gauges) on "
                        "localhost:PORT for the run's duration")
    p.add_argument("-trace-log", default=None, dest="trace_log",
                   metavar="PATH",
                   help="append a JSONL span for this invocation (op, "
                        "duration, status) to PATH")
    p.add_argument("-trace-log-max-bytes", type=int, default=0,
                   dest="trace_log_max_bytes", metavar="N",
                   help="rotate the -trace-log file to PATH.1 once it "
                        "exceeds N bytes (0 = unbounded)")
    p.add_argument("-explain", action="store_true",
                   help="print per-node bottleneck attribution (binding "
                        "constraint, per-resource fits, marginal '+1 "
                        "replica' analysis) for the spec instead of the "
                        "fit report; -output json selects the structured "
                        "form (-backend torch only)")
    p.add_argument("-save-snapshot", default="", metavar="PATH",
                   help="checkpoint the loaded snapshot to PATH (.npz)")
    p.add_argument("-node-bucket-floor", type=int, default=0,
                   dest="node_bucket_floor", metavar="N",
                   help="accepted for the JAX CLI's sake and ignored: the "
                        "PyTorch package has no shape-bucket ladder")
    p.add_argument("-group-min-count", type=int, default=0,
                   dest="group_min_count", metavar="K",
                   help="mean nodes per distinct node shape required before "
                        "sweeps run over node-shape groups (default 2, or "
                        "KCCAP_GROUP_MIN_COUNT)")
    p.add_argument("-timeline", default=None, metavar="HOST:PORT",
                   help="render a running capacity service's timeline "
                        "(per-generation watchlist capacities, attributed "
                        "deltas, alert states) and exit; -output json "
                        "selects the structured form")
    p.add_argument("-timeline-since", type=int, default=None,
                   dest="timeline_since", metavar="GEN",
                   help="with -timeline: only records/deltas strictly "
                        "after generation GEN")
    p.add_argument("-timeline-watch", default=None, dest="timeline_watch",
                   metavar="NAME",
                   help="with -timeline: narrow records/deltas/alerts to "
                        "one watch")
    p.add_argument("-slo-status", default=None, dest="slo_status",
                   metavar="HOST:PORT",
                   help="render a running capacity service's SLO "
                        "burn-rate status (objectives, short/long-"
                        "window burn rates, alert states) and exit; "
                        "-output json selects the structured form; "
                        "exit 1 while any SLO is breached (or the "
                        "server runs without -slo)")
    p.add_argument("-dump", default=None, metavar="HOST:PORT",
                   help="render a running capacity service's flight "
                        "recorder (its last K dispatched requests, "
                        "each with the per-phase latency breakdown) "
                        "and exit; -output json selects the "
                        "structured form")
    p.add_argument("-dump-limit", type=int, default=None,
                   dest="dump_limit", metavar="N",
                   help="with -dump: only the N most recent records")
    p.add_argument("-dump-tenant", default=None, dest="dump_tenant",
                   metavar="TENANT",
                   help="with -dump: only records the server attributed "
                        "to TENANT (matches nothing: the PyTorch "
                        "package's server has no tenancy yet)")
    p.add_argument("-drain", default="", metavar="NODE",
                   help="simulate kubectl drain: rehome NODE's pods (each "
                        "with its own requests) onto the remaining nodes "
                        "and print the plan; exit 1 if any pod cannot be "
                        "rehomed (strict semantics, fixture/live sources)")
    p.add_argument("-drain-policy", dest="drain_policy", default="best-fit",
                   choices=("first-fit", "best-fit", "spread"),
                   help="bin-packing policy for -drain rehoming")
    p.add_argument("-drain-server", default=None, dest="drain_server",
                   metavar="HOST:PORT",
                   help="gracefully drain a running capacity server: it "
                        "stops accepting compute/mutation ops, finishes "
                        "in-flight work and emits its final drain record; "
                        "prints the drain record and exits 1 if in-"
                        "flight work outlived the timeout")
    p.add_argument("-drain-timeout-s", type=float, default=None,
                   dest="drain_timeout_s", metavar="SECONDS",
                   help="with -drain-server: how long the server may "
                        "wait for in-flight work (default: the "
                        "server's own -drain-timeout-s)")
    p.add_argument("-car", default=None, metavar="HOST:PORT",
                   help="render a running capacity service's "
                        "capacity-at-risk status (per quantile watch: "
                        "capacity at its confidence, probability-of-fit, "
                        "alert state) and exit; -output json selects the "
                        "structured form; exit 1 while any quantile "
                        "watch is breached (or none are configured)")
    p.add_argument("-car-spec", default="", dest="car_spec", metavar="FILE",
                   help="offline capacity-at-risk: load a stochastic "
                        "usage spec (YAML/JSON: per-pod cpu/memory "
                        "distributions, replicas, samples, seed) and "
                        "report capacity quantiles for the -snapshot "
                        "source; deterministic in the seed; exit 1 when "
                        "the spec's replicas miss its confidence bar")
    p.add_argument("-car-samples", type=int, default=0, dest="car_samples",
                   metavar="S",
                   help="with -car-spec: override the spec's Monte "
                        "Carlo sample count (0 = keep the spec's / the "
                        "KCCAP_CAR_SAMPLES default)")
    p.add_argument("-car-seed", type=int, default=None, dest="car_seed",
                   metavar="N",
                   help="with -car-spec: override the spec's sampling "
                        "seed (explicit seeds make every run replayable)")
    p.add_argument("-forecast", default=None, metavar="HOST:PORT",
                   help="render a running capacity service's forecast "
                        "status (per horizon watch: current capacity at "
                        "its quantile, projected horizon minimum, "
                        "time-to-breach, alert state) and exit; -output "
                        "json selects the structured form; exit 1 while "
                        "any horizon watch is breached (or none are "
                        "configured)")
    p.add_argument("-forecast-spec", default="", dest="forecast_spec",
                   metavar="FILE",
                   help="offline capacity forecast: load a stochastic "
                        "usage spec extended with a horizon block "
                        "(steps, step_s) and either explicit growth "
                        "rates (growth: cpu_per_s/memory_per_s) or an "
                        "audit_dir to fit them from verified history, "
                        "then project the quantile ladder over the "
                        "horizon against the -snapshot source; exit 1 "
                        "when any projected quantile crosses the "
                        "threshold within the horizon")
    p.add_argument("-plan", default="", dest="plan_spec", metavar="FILE",
                   help="offline certified capacity plan: load a "
                        "stochastic usage spec (plus optional target, "
                        "quantile, drain fields) and answer 'cheapest "
                        "node set from -catalog that restores the "
                        "quantile to the target' for the -snapshot "
                        "source, with an LP lower bound and host-side "
                        "certification; exit 1 unless the plan is "
                        "certified")
    p.add_argument("-catalog", default="", metavar="FILE",
                   help="with -plan: the node-shape catalog (YAML/JSON: "
                        "shapes with name, cpu, memory, pods, "
                        "unit_cost, max_count)")
    p.add_argument("-gang", default=None, metavar="HOST:PORT",
                   help="render a running capacity service's gang-watch "
                        "status (per gang watch: last whole-gang count, "
                        "binding topology level, alert state) and exit; "
                        "-output json selects the structured form; exit "
                        "1 while any gang watch is breached (or none "
                        "are configured)")
    p.add_argument("-gang-spec", default="", dest="gang_spec",
                   metavar="FILE",
                   help="offline gang capacity: load a gang spec "
                        "(YAML/JSON: the watchlist pod-block grammar "
                        "plus a gang block — ranks, count, colocate, "
                        "spread_level, max_ranks_per_domain, "
                        "anti_affinity_host) and count whole gangs "
                        "against the -snapshot source's zone/rack/host "
                        "hierarchy; exit code by schedulability (1 when "
                        "fewer than 'count' gangs fit)")
    p.add_argument("-optimize", action="store_true",
                   help="answer the spec (or -grid sweep) with the "
                        "optimization backend instead of the fit "
                        "report: certified LP upper bound, rounded "
                        "integral packing, first-fit baseline, "
                        "optimality gap, and per-resource shadow "
                        "prices; every answer carries a duality "
                        "certificate or is marked uncertified; exit 1 "
                        "when unschedulable or any solve is "
                        "uncertified (-backend torch only)")
    p.add_argument("-opt-backend", dest="opt_backend",
                   choices=("ffd", "lp"), default="lp",
                   help="with -optimize: the certified LP/PDHG solver "
                        "(lp, default) or the bug-compatible first-fit "
                        "reference walk alone (ffd)")
    p.add_argument("-replay", default="", metavar="DIR",
                   help="replay a capacity server's audit log: verify "
                        "the generation digest chain, reconstruct every "
                        "recorded generation from the nearest "
                        "checkpoint, and re-answer every recorded "
                        "request bit-for-bit against its recorded "
                        "result digest, on -device; -output json "
                        "selects the structured form; exit 1 on any "
                        "mismatch")
    p.add_argument("-replay-ref", default=None, dest="replay_ref",
                   metavar="SEGMENT:OFFSET",
                   help="with -replay: replay only the request at this "
                        "audit ref (the audit_ref field flight-recorder "
                        "dump records carry)")
    p.add_argument("-replay-generation", type=int, default=None,
                   dest="replay_generation", metavar="GEN",
                   help="with -replay: reconstruct generation GEN and "
                        "verify its digest instead of replaying "
                        "requests")
    p.add_argument("-replay-tenant", default=None, dest="replay_tenant",
                   metavar="TENANT",
                   help="with -replay: replay only requests the server "
                        "attributed to TENANT (servers started with "
                        "-tenants stamp the derived tenant into each "
                        "audited request)")
    p.add_argument("-plane-status", default=None, dest="plane_status",
                   metavar="HOST:PORT",
                   help="print a running server's serving-plane status "
                        "(leader fan-out stats or replica sync/"
                        "staleness state, plus capabilities) and exit; "
                        "exit 1 when the replica is stale or the "
                        "server is draining")
    p.add_argument("-doctor", action="store_true",
                   help="diagnose the environment (backend probe with a "
                        "hang-proof timeout, native toolchain, fast-path "
                        "state) and exit; exit code 1 on any hard failure")
    p.add_argument("-doctor-timeout", type=float, default=30.0,
                   metavar="SECONDS",
                   help="how long -doctor waits for backend init before "
                        "declaring it wedged")
    p.add_argument("-doctor-service", dest="doctor_service", default=None,
                   metavar="HOST:PORT",
                   help="with -doctor: also probe a running capacity "
                        "service's resilience counters (deadline sheds, "
                        "fused-path breaker, follower backoff) over its "
                        "info op")
    p.add_argument("-jax-profile", default="", dest="jax_profile",
                   metavar="DIR",
                   help="capture a torch.profiler trace of the run (CPU "
                        "and, on -device cuda, CUDA activity) into DIR as "
                        "a Chrome trace (view with Perfetto or "
                        "TensorBoard); the flag keeps the JAX CLI's name")
    p.add_argument("-fed-status", default=None, dest="fed_status",
                   metavar="HOST:PORT",
                   help="print a federation endpoint's per-cluster "
                        "degradation vector (generation, verified age, "
                        "fresh/stale/lost) and exit; exit 1 when any "
                        "cluster is lost (excluded from fleet totals)")
    p.add_argument("-fed-sweep", default=None, dest="fed_sweep",
                   metavar="HOST:PORT",
                   help="fleet-global capacity for the six scenario "
                        "flags against a federation endpoint: grand "
                        "totals over non-lost clusters plus the "
                        "per-cluster split, every reply annotated with "
                        "the staleness vector; exit 1 when the scenario "
                        "does not fit or any cluster is lost")
    p.add_argument("-doctor-federation", dest="doctor_federation",
                   default=None, metavar="HOST:PORT",
                   help="with -doctor: also probe a federation "
                        "endpoint (cluster states, generations) — a "
                        "lost cluster is a hard FAILED line")
    p.add_argument("-trace-tree", default=None, dest="trace_tree",
                   metavar="TRACE_ID",
                   help="stitch one distributed trace back together "
                        "from per-process span logs (-trace-logs) and "
                        "print the tree, critical path, and dominating "
                        "phase; -output json selects the structured "
                        "form; exit 1 when the trace is not found or "
                        "the critical path is refused (clock skew)")
    p.add_argument("-trace-logs", default="", dest="trace_logs",
                   metavar="DIR[,DIR...]",
                   help="with -trace-tree: comma-separated trace-log "
                        "files or directories (directories contribute "
                        "every *.jsonl plus .1 rotations) — one per "
                        "process in the topology")
    p.add_argument("-profile", default=None, metavar="HOST:PORT",
                   help="collect a collapsed flamegraph window from a "
                        "running capacity service's sampling profiler "
                        "(/debug/profile on its metrics port), print "
                        "the phase-attribution summary, and exit; "
                        "-output json selects the structured form; "
                        "exit 1 when the server's profiler is off")
    p.add_argument("-profile-seconds", type=float, default=5.0,
                   dest="profile_seconds", metavar="SECONDS",
                   help="with -profile: how long the server samples "
                        "before replying (server caps at 300)")
    p.add_argument("-profile-out", default="", dest="profile_out",
                   metavar="FILE",
                   help="with -profile: write the collapsed profile "
                        "to FILE (flamegraph.pl/speedscope food) "
                        "instead of stdout")
    p.add_argument("-bench-diff", nargs="+", default=None,
                   dest="bench_diff", metavar="OLD_NEW_OR_DIR",
                   help="compare two bench artifacts (OLD.json "
                        "NEW.json) under the committed per-row noise "
                        "thresholds and exit 1 on any regression; a "
                        "single directory argument walks every "
                        "BENCH_r*.json round in order (trajectory "
                        "mode); degraded rounds and missing rows are "
                        "named, never failed; -output json selects "
                        "the structured artifact")
    p.add_argument("-bench-thresholds", default="",
                   dest="bench_thresholds", metavar="FILE",
                   help="with -bench-diff: the per-row noise model "
                        "(default: BENCH_THRESHOLDS.json next to the "
                        "inputs, else built-in defaults)")
    p.add_argument("-device", choices=("cuda", "cpu"), default="cuda",
                   help="run on the GPU (default) or the host")
    add_unported_flags(p, _UNPORTED_FLAGS)
    return p


def _split_single_dash_eq(argv: list[str]) -> list[str]:
    """Support Go-style ``-flag=value`` (argparse only splits ``--flag=``)."""
    out = []
    for a in argv:
        if a.startswith("-") and not a.startswith("--") and "=" in a:
            flag, _, val = a.partition("=")
            out += [flag, val]
        else:
            out.append(a)
    return out


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(
        _split_single_dash_eq(sys.argv[1:] if argv is None else list(argv))
    )
    unported = unported_flags_used(args, _UNPORTED_FLAGS)
    # The one-shot diagnostics, as in the JAX CLI: no spec, no source.
    if args.doctor and not unported:
        from kubernetesclustercapacity_tpu_torch.utils.doctor import run_doctor

        service_addr = None
        if args.doctor_service:
            host, _, port = args.doctor_service.rpartition(":")
            try:
                service_addr = (host or "127.0.0.1", int(port))
            except ValueError:
                print(f"ERROR : bad -doctor-service {args.doctor_service!r} "
                      "(want HOST:PORT)", file=sys.stderr)
                return 1
        federation_addr = None
        if args.doctor_federation:
            host, _, port = args.doctor_federation.rpartition(":")
            try:
                federation_addr = (host or "127.0.0.1", int(port))
            except ValueError:
                print(f"ERROR : bad -doctor-federation "
                      f"{args.doctor_federation!r} (want HOST:PORT)",
                      file=sys.stderr)
                return 1
        report, code = run_doctor(
            backend_timeout_s=args.doctor_timeout, service_addr=service_addr,
            federation_addr=federation_addr, device=args.device,
        )
        print(report)
        return code

    if args.timeline and not unported:
        return _run_timeline(args)
    if args.car and not unported:
        return _run_car_status(args)
    if args.forecast and not unported:
        return _run_forecast_status(args)
    if args.gang and not unported:
        return _run_gang_status(args)
    if args.slo_status and not unported:
        return _run_slo_status(args)
    if args.dump and not unported:
        return _run_dump(args)
    if args.drain_server and not unported:
        return _run_drain_server(args)
    if args.plane_status and not unported:
        return _run_plane_status(args)
    if args.fed_status and not unported:
        return _run_fed_status(args)
    if args.fed_sweep and not unported:
        return _run_fed_sweep(args)
    if args.replay and not unported:
        return _run_replay(args)
    if args.trace_tree and not unported:
        return _run_trace_tree(args)
    if args.profile and not unported:
        return _run_profile(args)
    if args.bench_diff and not unported:
        return _run_bench_diff(args)
    # Telemetry surfaces (both opt-in, zero cost otherwise): a scrape
    # endpoint over the process registry and a JSONL span for the whole
    # invocation, as in the JAX CLI.
    metrics_server = None
    trace_log = None
    if args.metrics_port:
        from kubernetesclustercapacity_tpu_torch.telemetry.exposition import (
            start_metrics_server,
        )
        from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
            REGISTRY,
        )
        from kubernetesclustercapacity_tpu_torch.telemetry.process import (
            register_process_metrics,
        )

        register_process_metrics(REGISTRY)
        try:
            metrics_server = start_metrics_server(
                REGISTRY, port=args.metrics_port
            )
        except OSError as e:
            print(f"ERROR : cannot bind metrics port: {e}", file=sys.stderr)
            return 1
        print(
            f"metrics on http://{metrics_server.address[0]}:"
            f"{metrics_server.address[1]}/metrics",
            file=sys.stderr,
        )
    if args.trace_log:
        from kubernetesclustercapacity_tpu_torch.telemetry.tracing import (
            Span,
            TraceLog,
        )

        trace_log = TraceLog(
            args.trace_log, max_bytes=max(args.trace_log_max_bytes, 0)
        )
    try:
        if trace_log is not None:
            mode = (
                "drain" if args.drain else
                "car" if args.car_spec else
                "forecast" if args.forecast_spec else
                "plan" if args.plan_spec else
                "gang" if args.gang_spec else
                "optimize" if args.optimize else
                "explain" if args.explain else
                "grid" if args.grid > 0 else "fit"
            )
            with Span(f"kccap:{mode}", trace_log=trace_log) as span:
                rc = _run_profiled(args, unported)
                span._extra["exit_code"] = rc
                return rc
        return _run_profiled(args, unported)
    finally:
        if trace_log is not None:
            trace_log.close()
        if metrics_server is not None:
            metrics_server.shutdown()


def _run_profiled(args, unported: list[str]) -> int:
    """:func:`_run_command`, inside a ``torch.profiler`` capture when
    ``-jax-profile DIR`` asks for one: the whole run's CPU activity and,
    on ``-device cuda``, its CUDA activity (kernels, copies), written into
    DIR as one Chrome trace (``HOST_PID.pt.trace.json``) when the run
    ends.  Like the JAX CLI's ``jax.profiler`` capture, it only
    observes."""
    if not args.jax_profile:
        return _run_command(args, unported)
    import socket

    import torch
    from torch.profiler import ProfilerActivity, profile

    from kubernetesclustercapacity_tpu_torch.devcache import resolve_device

    cuda = resolve_device(args.device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        with prof:
            try:
                return _run_command(args, unported)
            finally:
                if cuda:  # the run's device work ends inside the capture
                    torch.cuda.synchronize()
    finally:
        os.makedirs(args.jax_profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            args.jax_profile,
            f"{socket.gethostname()}_{os.getpid()}.pt.trace.json",
        ))


def _run_command(args, unported: list[str]) -> int:
    """Everything after flag parsing and the telemetry set-up: the spec,
    the flags that are not ported, the source, then :func:`run`."""
    from kubernetesclustercapacity_tpu_torch.scenario import (
        ScenarioError,
        scenario_from_flags,
    )

    try:
        scenario = scenario_from_flags(
            cpuRequests=args.cpuRequests,
            cpuLimits=args.cpuLimits,
            memRequests=args.memRequests,
            memLimits=args.memLimits,
            replicas=args.replicas,
        )
    except ScenarioError as e:
        # The reference prints an ERROR line and exits 1 (:68-83).
        print(e.reference_line or f"ERROR : {e} ...exiting")
        return 1
    if args.backend == "native":
        unported.append("-backend native")
    if unported:
        print(f"ERROR : {', '.join(unported)}: not yet ported to the "
              "PyTorch package ...exiting")
        return 1
    if args.node_bucket_floor > 0:
        print(NO_BUCKET_LADDER, file=sys.stderr)
    if args.group_min_count > 0:
        from kubernetesclustercapacity_tpu_torch import (
            snapshot as _snapshot_mod,
        )

        _snapshot_mod.set_group_min_count(args.group_min_count)
    if args.grid <= 0:
        try:
            scenario.validate()
        except ScenarioError as e:
            # No reference line exists here: the reference would NOT exit —
            # it would panic later at the division (Q8 divergence).
            print(f"ERROR : {e} ...exiting")
            return 1
    fixture, snapshot = load_source(args)
    if snapshot is None:
        return 1
    return run(args, fixture, snapshot, scenario)


def run(args, fixture, snapshot, scenario) -> int:
    """Everything after the source: the checkpoint, then the one surface
    the flags ask for (``-car-spec``, ``-forecast-spec``, ``-plan``,
    ``-gang-spec``, ``-optimize``, ``-drain``, ``-explain``, ``-grid`` or the single spec)."""
    if args.save_snapshot:
        snapshot.save(args.save_snapshot)
        print(f"snapshot checkpointed to {args.save_snapshot}",
              file=sys.stderr)
    if args.car_spec:
        return _run_car_spec(args, snapshot)
    if args.forecast_spec:
        return _run_forecast_spec(args, snapshot)
    if args.plan_spec:
        return _run_plan(args, snapshot)
    if args.gang_spec:
        return _run_gang_spec(args, snapshot)
    if args.optimize:
        return _run_optimize(args, snapshot, scenario)
    if args.drain:
        return _run_drain(args, fixture, snapshot)
    if args.explain:
        return _run_explain(args, snapshot, scenario)
    if args.grid > 0:
        return _run_grid(args, snapshot)
    return _run_single(args, fixture, snapshot, scenario)


def load_source(args, *, client=None):
    """Resolve the cluster source: fixture JSON, npz checkpoint, or live.

    Returns ``(fixture, snapshot)``, or ``(None, None)`` after printing
    the error line.  A live source lists through ``client`` (a
    :class:`~.kubeapi.KubeClient`) when one is given, else through the
    cluster of ``-kubeconfig``.  Only ``-drain`` reads a live source's
    fixture: then ONE listing gives both the fixture and the packed
    snapshot, so eviction candidates and target headroom are the same
    instant of the cluster; otherwise the fixture is not kept.
    """
    from kubernetesclustercapacity_tpu_torch.snapshot import (
        snapshot_from_fixture,
        snapshot_from_live_cluster,
    )

    if args.snapshot:
        from kubernetesclustercapacity_tpu_torch.sources import (
            SourceError,
            resolve_source,
        )

        try:
            fixture, snap, semantics = resolve_source(
                args.snapshot, args.semantics,
                extended_resources=_extended_names(args),
            )
        except SourceError as e:
            print(f"ERROR : {e}")
            return None, None
        args.semantics = semantics
        return fixture, snap
    if args.semantics is None:
        args.semantics = "reference"
    extended = _extended_names(args)
    if extended and args.semantics != "strict":
        # Same rule resolve_source owns for file sources: never silently
        # pack without the requested columns.
        print("ERROR : extended resources require strict semantics "
              "(reference semantics has no extended-column concept)")
        return None, None
    try:
        if client is not None or args.drain:
            from kubernetesclustercapacity_tpu_torch.kubeapi import (
                live_fixture,
            )

            fixture = live_fixture(args.kubeconfig or None, client=client)
            return fixture if args.drain else None, snapshot_from_fixture(
                fixture, semantics=args.semantics,
                extended_resources=extended,
            )
        return None, snapshot_from_live_cluster(
            args.kubeconfig or None, semantics=args.semantics,
            extended_resources=extended,
        )
    except Exception as e:  # mirrors the reference's panic on bad kubeconfig
        print(f"ERROR : cannot snapshot live cluster: {e}")
        print("hint: use -snapshot <fixture.json|checkpoint.npz> for "
              "offline runs")
        return None, None


def _extended_names(args) -> tuple[str, ...]:
    """Columns to pack: the -extended-resources list plus every
    -extended-request name (a requested resource must have a column)."""
    names = {
        r.strip() for r in args.extended_resources.split(",") if r.strip()
    }
    for spec in args.extended_requests:
        name = spec.partition("=")[0].strip()
        if name:
            names.add(name)
    return tuple(sorted(names))


def _parse_extended_requests(args) -> dict[str, int] | None:
    """``-extended-request name=qty`` pairs → {name: int} (strict grammar);
    None after printing the error line."""
    from kubernetesclustercapacity_tpu_torch.utils.quantity import (
        QuantityParseError,
        parse_quantity,
    )

    out: dict[str, int] = {}
    for spec in args.extended_requests:
        name, eq, qty = spec.partition("=")
        name = name.strip()
        if not name or not eq:
            print(f"ERROR : -extended-request wants NAME=QTY, got {spec!r} "
                  "...exiting")
            return None
        try:
            out[name] = parse_quantity(qty.strip()).value()
        except QuantityParseError as e:
            print(f"ERROR : -extended-request {name}: {e} ...exiting")
            return None
    return out


def _run_explain(args, snapshot, scenario) -> int:
    """-explain: WHY the fit stops — binding attribution + marginals, with
    the same implicit strict-mode taint mask as every other surface, so it
    explains the numbers the fit and the sweep return."""
    from kubernetesclustercapacity_tpu_torch.explain import explain_snapshot
    from kubernetesclustercapacity_tpu_torch.masks import implicit_taint_mask
    from kubernetesclustercapacity_tpu_torch.report import (
        explain_json_report,
        explain_table_report,
    )
    from kubernetesclustercapacity_tpu_torch.scenario import ScenarioGrid

    if args.backend != "torch":
        print("ERROR : -explain runs on the device programs (-backend "
              "torch); the cpu backend is a fit-only cross-check ...exiting")
        return 1
    result = explain_snapshot(
        snapshot, ScenarioGrid.from_scenarios([scenario]),
        mode=args.semantics, node_mask=implicit_taint_mask(snapshot),
        device=args.device,
    )
    if args.output == "json":
        print(explain_json_report(result))
    else:
        print(explain_table_report(result))
    return 0


def _run_drain(args, fixture, snapshot) -> int:
    """-drain NODE: print the rehoming plan; exit by the verdict."""
    from kubernetesclustercapacity_tpu_torch.models import CapacityModel

    if args.semantics != "strict":
        print("ERROR : -drain requires strict semantics "
              "(-semantics strict)")
        return 1
    # Live sources arrive WITH their fixture (load_source lists once for
    # both); only an .npz checkpoint leaves it None, and the model's own
    # error explains that limitation.
    try:
        model = CapacityModel(snapshot, mode="strict", fixture=fixture,
                              device=args.device)
        plan = model.drain(args.drain, policy=args.drain_policy)
    except ValueError as e:
        print(f"ERROR : {e}")
        return 1
    print(f"drain {plan.node}: {len(plan.pods)} pod(s) to rehome "
          f"(policy {plan.policy})")
    for pod, target in plan.by_pod().items():
        line = f"  {pod:<48} -> {target if target else 'UNPLACEABLE'}"
        if pod in plan.blocked:
            line += f"  [BLOCKED by PDB {', '.join(plan.blocked[pod])}]"
        print(line)
    if plan.evictable:
        print(f"verdict: {plan.node} is evictable")
        return 0
    stuck = sum(1 for a in plan.assignments if a is None)
    reasons = []
    if stuck:
        reasons.append(f"{stuck} pod(s) cannot be rehomed")
    if plan.blocked:
        reasons.append(
            f"{len(plan.blocked)} pod(s) blocked by disruption budgets"
        )
    print(f"verdict: {plan.node} is NOT evictable ({'; '.join(reasons)})")
    return 1


def _parse_addr(flag_name: str, value: str):
    """``HOST:PORT`` → ``(host, port)`` or ``None`` (error printed)."""
    host, _, port = value.rpartition(":")
    try:
        return (host or "127.0.0.1", int(port))
    except ValueError:
        print(f"ERROR : bad {flag_name} {value!r} (want HOST:PORT)",
              file=sys.stderr)
        return None


def _diag_client(addr):
    """The short-budget client every one-shot diagnostic flag uses."""
    from kubernetesclustercapacity_tpu_torch.resilience import RetryPolicy
    from kubernetesclustercapacity_tpu_torch.service.client import (
        CapacityClient,
    )

    return CapacityClient(
        *addr,
        connect_timeout_s=5.0,
        timeout_s=10.0,
        retry=RetryPolicy(max_attempts=2, base_delay_s=0.1),
        deadline_s=10.0,
    )


def _run_drain_server(args) -> int:
    """-drain-server HOST:PORT: trigger a graceful drain over the wire
    and print the server's drain record.  Exits by the verdict: 0 only
    when every in-flight request finished inside the timeout."""
    addr = _parse_addr("-drain-server", args.drain_server)
    if addr is None:
        return 1
    # The drain op waits for in-flight work server-side: the client
    # budget must comfortably outlive the server's wait.
    wait = args.drain_timeout_s if args.drain_timeout_s is not None else 30.0
    try:
        with _diag_client(addr) as c:
            record = c.drain_server(
                timeout_s=args.drain_timeout_s,
                deadline_s=wait + 10.0,
            )
    except Exception as e:  # noqa: BLE001 - a CLI reports, never tracebacks
        print(f"ERROR : cannot drain {addr[0]}:{addr[1]}: {e}",
              file=sys.stderr)
        return 1
    if args.output == "json":
        print(json.dumps(record, sort_keys=True))
    else:
        print(
            f"drain {'complete' if record.get('drained') else 'TIMED OUT'}"
            f" : inflight_at_start={record.get('inflight_at_start')}"
            f" remaining={record.get('inflight_remaining')}"
            f" waited_s={record.get('waited_s')}"
            + (" (already draining)" if record.get("already") else "")
        )
    return 0 if record.get("drained") else 1


def _run_plane_status(args) -> int:
    """-plane-status HOST:PORT: one look at an endpoint's place in the
    replicated serving plane — role, generation, fan-out or sync
    health, capabilities.  Exit 1 when the endpoint should be routed
    around (stale replica / draining server)."""
    addr = _parse_addr("-plane-status", args.plane_status)
    if addr is None:
        return 1
    try:
        with _diag_client(addr) as c:
            info = c.info(plane=True)
    except Exception as e:  # noqa: BLE001 - a CLI reports, never tracebacks
        print(f"ERROR : cannot reach {addr[0]}:{addr[1]}: {e}",
              file=sys.stderr)
        return 1
    plane = info.get("plane")
    caps = info.get("capabilities") or {}
    draining = bool(info.get("draining"))
    if args.output == "json":
        print(json.dumps(
            {"plane": plane, "capabilities": caps, "draining": draining},
            sort_keys=True,
        ))
    else:
        if plane is None:
            print("plane     : not a plane member")
        else:
            print(f"plane     : role={plane.get('role')} "
                  f"generation={plane.get('generation')}")
            if plane.get("role") == "replica":
                print(f"sync      : age_s={plane.get('sync_age_s')} "
                      f"stale={plane.get('stale')} "
                      f"applied={plane.get('applied')} "
                      f"resyncs={plane.get('resyncs')}")
            else:
                print(f"fan-out   : subscribers={plane.get('subscribers')} "
                      f"published={plane.get('published')} "
                      f"ejected={plane.get('ejected')}")
        print(f"caps      : {caps or '(pre-plane server)'}")
        print(f"draining  : {draining}")
    stale = bool(plane and plane.get("role") == "replica" and plane.get("stale"))
    return 1 if (stale or draining) else 0


def _run_fed_status(args) -> int:
    """-fed-status HOST:PORT: the federation tier's degradation vector.
    Exit by the verdict: 1 when any cluster is LOST — a fleet answer is
    provably incomplete then, and scripts must see that, not parse
    prose.  Stale clusters render explicitly but stay exit 0 (they are
    the contract working, not a failure of it)."""
    from kubernetesclustercapacity_tpu_torch.report import (
        fed_status_json_report,
        fed_status_table_report,
    )

    addr = _parse_addr("-fed-status", args.fed_status)
    if addr is None:
        return 1
    try:
        with _diag_client(addr) as c:
            result = c.fed_status()
    except Exception as e:  # noqa: BLE001 - a CLI reports, never tracebacks
        print(f"ERROR : cannot fetch federation status from "
              f"{addr[0]}:{addr[1]}: {e}", file=sys.stderr)
        return 1
    if args.output == "json":
        print(fed_status_json_report(result))
    else:
        print(fed_status_table_report(result))
    if not result.get("enabled", False):
        return 1
    return 1 if result.get("excluded") else 0


def _run_fed_sweep(args) -> int:
    """-fed-sweep HOST:PORT: fleet capacity for the six scenario flags.
    Exit 0 only when the scenario fits across the fleet AND no cluster
    is lost (a lost cluster makes every total an explicit lower bound)."""
    from kubernetesclustercapacity_tpu_torch.report import (
        fed_sweep_json_report,
        fed_sweep_table_report,
    )

    addr = _parse_addr("-fed-sweep", args.fed_sweep)
    if addr is None:
        return 1
    try:
        with _diag_client(addr) as c:
            result = c.fed_sweep(
                cpuRequests=args.cpuRequests,
                cpuLimits=args.cpuLimits,
                memRequests=args.memRequests,
                memLimits=args.memLimits,
                replicas=args.replicas,
            )
    except Exception as e:  # noqa: BLE001 - a CLI reports, never tracebacks
        print(f"ERROR : cannot fed-sweep {addr[0]}:{addr[1]}: {e}",
              file=sys.stderr)
        return 1
    if args.output == "json":
        print(fed_sweep_json_report(result))
    else:
        print(fed_sweep_table_report(result))
    schedulable = all(result.get("schedulable", []) or [False])
    return 0 if schedulable and not result.get("excluded") else 1


def _run_trace_tree(args) -> int:
    """-trace-tree TRACE_ID: the offline analyzer of the tracing
    subsystem — stitch one trace's spans from per-process JSONL logs
    into a tree (parent linkage only, never wall clock), compute the
    greedy critical path, and name the dominating contributor.  Exits
    by the verdict: 0 only when the trace was found and attribution
    was not refused."""
    from kubernetesclustercapacity_tpu_torch.report import (
        trace_json_report,
        trace_table_report,
    )
    from kubernetesclustercapacity_tpu_torch.telemetry.traceview import (
        analyze_trace,
    )

    if not args.trace_logs:
        print(
            "ERROR : -trace-tree needs -trace-logs DIR[,DIR...] "
            "(the per-process span logs to stitch)",
            file=sys.stderr,
        )
        return 1
    tree = analyze_trace(args.trace_logs, args.trace_tree)
    if args.output == "json":
        print(trace_json_report(tree))
    else:
        print(trace_table_report(tree))
    if not tree.get("found"):
        return 1
    return 0 if not tree["critical_path"].get("refused") else 1


def _run_profile(args) -> int:
    """-profile HOST:PORT: ask a running server's sampling profiler
    for a collapsed flamegraph window (``/debug/profile`` on its
    metrics port), write the fold, and summarize the phase attribution
    — the view that answers "WHICH frames inside serialize?"."""
    from urllib.request import urlopen

    from kubernetesclustercapacity_tpu_torch.telemetry.profiler import (
        dominant_phase,
        phase_counts,
        top_frame,
    )

    addr = _parse_addr("-profile", args.profile)
    if addr is None:
        return 1
    seconds = max(float(args.profile_seconds), 0.0)
    url = (f"http://{addr[0]}:{addr[1]}/debug/profile"
           f"?seconds={seconds:g}")
    try:
        with urlopen(url, timeout=seconds + 30.0) as resp:
            text = resp.read().decode("utf-8", "replace")
    except Exception as e:  # noqa: BLE001 - a CLI reports, never tracebacks
        print(f"ERROR : cannot fetch profile from "
              f"{addr[0]}:{addr[1]}: {e} (a server started with "
              "-metrics-port serves /debug/profile there)",
              file=sys.stderr)
        return 1
    if text.startswith("# profiler disabled"):
        print(text.strip(), file=sys.stderr)
        return 1
    counts = phase_counts(text)
    total = sum(counts.values())
    phase, share = dominant_phase(text)
    if args.profile_out:
        with open(args.profile_out, "w", encoding="utf-8") as f:
            f.write(text)
        print(f"collapsed profile ({total} sample(s)) written to "
              f"{args.profile_out}", file=sys.stderr)
    if args.output == "json":
        print(json.dumps({
            "seconds": seconds,
            "samples": total,
            "phase_samples": counts,
            "dominant_phase": phase,
            "dominant_share": round(share, 4),
            "top_frame": top_frame(text),
            "top_frame_dominant_phase": (
                top_frame(text, phase) if phase else None
            ),
        }, indent=2, sort_keys=True))
    else:
        if not args.profile_out:
            sys.stdout.write(text)
        for name in sorted(counts, key=lambda p: -counts[p]):
            print(f"# phase {name}: {counts[name]} sample(s)",
                  file=sys.stderr)
        if phase is not None:
            print(f"# dominant phase: {phase} "
                  f"({share * 100:.1f}% of attributed samples; top "
                  f"frame {top_frame(text, phase)})", file=sys.stderr)
    return 0


def _run_bench_diff(args) -> int:
    """-bench-diff OLD NEW (or DIR): the typed comparator over bench
    artifacts — exit 1 only on a threshold-breaching regression on a
    comparable, parity-clean row; exit 2 on usage errors (bad JSON,
    bad thresholds, wrong argument shape)."""
    from kubernetesclustercapacity_tpu_torch.analysis import benchdiff

    paths = args.bench_diff
    trajectory_dir = None
    if len(paths) == 1 and os.path.isdir(paths[0]):
        trajectory_dir = paths[0]
    elif len(paths) != 2:
        print("ERROR : -bench-diff wants OLD.json NEW.json (or one "
              "directory for trajectory mode)", file=sys.stderr)
        return 2
    th_path = args.bench_thresholds or None
    if th_path is None:
        anchor = trajectory_dir or os.path.dirname(
            os.path.abspath(paths[1])
        )
        cand = os.path.join(anchor, benchdiff.THRESHOLDS_FILENAME)
        if os.path.exists(cand):
            th_path = cand
    try:
        th = benchdiff.load_thresholds(th_path)
        if trajectory_dir is not None:
            diffs = benchdiff.trajectory(trajectory_dir, th)
        else:
            diffs = [benchdiff.diff_files(paths[0], paths[1], th)]
    except (OSError, ValueError) as e:
        print(f"ERROR : {e}", file=sys.stderr)
        return 2
    regressions = sum(len(d.regressions) for d in diffs)
    if args.output == "json":
        print(json.dumps({
            "thresholds": th_path,
            "pairs": [d.to_json() for d in diffs],
            "regressions": regressions,
            "clean": regressions == 0,
        }, indent=2))
    elif trajectory_dir is not None:
        print(benchdiff.render_trajectory(diffs))
    else:
        print(benchdiff.render(diffs[0]))
    return 1 if regressions else 0


def _run_replay(args) -> int:
    """-replay DIR: the offline half of the audit subsystem — turn a
    recorded history into a verified repro, re-answered on ``-device``.
    Exits by the verdict: 0 only when the digest chain holds and every
    replayed request re-answered identically."""
    from kubernetesclustercapacity_tpu_torch.audit import (
        AuditError,
        AuditReader,
        Replayer,
    )
    from kubernetesclustercapacity_tpu_torch.report import (
        replay_json_report,
        replay_table_report,
    )
    from kubernetesclustercapacity_tpu_torch.timeline.diff import (
        snapshot_digest,
    )

    try:
        reader = AuditReader.load(args.replay)
    except AuditError as e:
        print(f"ERROR : cannot load audit log: {e}", file=sys.stderr)
        return 1
    if args.replay_generation is not None:
        try:
            snap = reader.snapshot_at(args.replay_generation)
        except AuditError as e:
            print(f"ERROR : {e}", file=sys.stderr)
            return 1
        out = {
            "generation": args.replay_generation,
            "nodes": snap.n_nodes,
            "semantics": snap.semantics,
            "digest": snapshot_digest(snap),
            "verified": True,
        }
        if args.output == "json":
            print(json.dumps(out, sort_keys=True))
        else:
            print(
                f"generation {out['generation']}: {out['nodes']} node(s) "
                f"({out['semantics']}), digest {out['digest']} — "
                "reconstruction verified"
            )
        return 0
    with Replayer(reader, device=args.device) as replayer:
        if args.replay_ref:
            try:
                rec = reader.record_at(args.replay_ref)
            except AuditError as e:
                print(f"ERROR : {e}", file=sys.stderr)
                return 1
            outcome = replayer.replay_record(rec)
            result = {
                "directory": reader.directory,
                "generations_verified": [],
                "chain_error": None,
                "recovered_tail_records": reader.recovered_tail,
                "requests": 1,
                "counts": {outcome["status"]: 1},
                "outcomes": [outcome],
                "clean": outcome["status"] in ("ok", "skipped"),
            }
        else:
            result = replayer.replay_all(tenant=args.replay_tenant)
    if args.output == "json":
        print(replay_json_report(result))
    else:
        print(replay_table_report(result))
    return 0 if result["clean"] else 1


def _run_timeline(args) -> int:
    """-timeline HOST:PORT: fetch and render a service's capacity
    timeline (the drift view no offline snapshot can answer — it lives
    with the server that watched the generations go by)."""
    from kubernetesclustercapacity_tpu_torch.report import (
        timeline_json_report,
        timeline_table_report,
    )

    addr = _parse_addr("-timeline", args.timeline)
    if addr is None:
        return 1
    try:
        with _diag_client(addr) as c:
            result = c.timeline(
                since_generation=args.timeline_since,
                watch=args.timeline_watch,
            )
    except Exception as e:  # noqa: BLE001 - a CLI reports, never tracebacks
        print(f"ERROR : cannot fetch timeline from "
              f"{addr[0]}:{addr[1]}: {e}", file=sys.stderr)
        return 1
    if args.output == "json":
        print(timeline_json_report(result))
    else:
        print(timeline_table_report(result))
    if not result.get("enabled", False):
        return 1
    breached = [
        name
        for name, a in result.get("alerts", {}).items()
        if a.get("state") == "breached"
    ]
    # Exit by the verdict, like -drain does: a breached watchlist is a
    # scriptable signal, not just prose.
    return 1 if breached else 0


def _run_slo_status(args) -> int:
    """-slo-status HOST:PORT: fetch and render a service's SLO burn-rate
    status.  Exits by the verdict, like -timeline: a breached objective
    (or a server with no -slo at all) is a scriptable failure."""
    from kubernetesclustercapacity_tpu_torch.report import (
        slo_json_report,
        slo_table_report,
    )

    addr = _parse_addr("-slo-status", args.slo_status)
    if addr is None:
        return 1
    try:
        with _diag_client(addr) as c:
            result = c.slo_status()
    except Exception as e:  # noqa: BLE001 - a CLI reports, never tracebacks
        print(f"ERROR : cannot fetch SLO status from "
              f"{addr[0]}:{addr[1]}: {e}", file=sys.stderr)
        return 1
    if args.output == "json":
        print(slo_json_report(result))
    else:
        print(slo_table_report(result))
    if not result.get("enabled", False):
        return 1
    breached = [
        name
        for name, s in result.get("status", {}).items()
        if s.get("state") == "breached"
    ]
    return 1 if breached else 0


def _run_dump(args) -> int:
    """-dump HOST:PORT: fetch and render a service's flight recorder —
    the last K dispatched requests, each carrying its per-phase latency
    breakdown, so a slow request is self-explaining from the paste."""
    from kubernetesclustercapacity_tpu_torch.report import (
        dump_json_report,
        dump_table_report,
    )

    addr = _parse_addr("-dump", args.dump)
    if addr is None:
        return 1
    try:
        with _diag_client(addr) as c:
            result = c.dump(limit=args.dump_limit, tenant=args.dump_tenant)
    except Exception as e:  # noqa: BLE001 - a CLI reports, never tracebacks
        print(f"ERROR : cannot fetch flight records from "
              f"{addr[0]}:{addr[1]}: {e}", file=sys.stderr)
        return 1
    if args.output == "json":
        print(dump_json_report(result))
    else:
        print(dump_table_report(result))
    return 0


def _run_car_status(args) -> int:
    """-car HOST:PORT: fetch and render a service's capacity-at-risk
    watch status (the quantile-watch slice of the timeline).  Exits by
    the verdict: a breached quantile watch is a scriptable failure, and so
    is a server with no quantile watches at all."""
    from kubernetesclustercapacity_tpu_torch.report import (
        car_status_json_report,
        car_status_table_report,
    )

    addr = _parse_addr("-car", args.car)
    if addr is None:
        return 1
    try:
        with _diag_client(addr) as c:
            result = c.car()
    except Exception as e:  # noqa: BLE001 - a CLI reports, never tracebacks
        print(f"ERROR : cannot fetch capacity-at-risk status from "
              f"{addr[0]}:{addr[1]}: {e}", file=sys.stderr)
        return 1
    if args.output == "json":
        print(car_status_json_report(result))
    else:
        print(car_status_table_report(result))
    if not result.get("enabled", False):
        return 1
    return 1 if result.get("breached") else 0


def _run_car_spec(args, snapshot) -> int:
    """-car-spec FILE: offline capacity-at-risk against the -snapshot
    source.  Applies the same implicit strict-mode taint mask as every
    other surface, prints the quantile ladder (table or JSON), and
    exits by the spec's own confidence bar: 1 when
    ``P(fit replicas) < confidence``."""
    import dataclasses as _dc

    from kubernetesclustercapacity_tpu_torch.masks import implicit_taint_mask
    from kubernetesclustercapacity_tpu_torch.report import (
        car_json_report,
        car_table_report,
    )
    from kubernetesclustercapacity_tpu_torch.stochastic import (
        DistributionError,
        capacity_at_risk,
        load_stochastic_spec,
    )

    if args.backend != "torch":
        print("ERROR : -car-spec runs on the device programs (-backend "
              "torch); cpu/native backends are fit-only cross-checks "
              "...exiting")
        return 1
    try:
        spec = load_stochastic_spec(args.car_spec)
    except (OSError, DistributionError) as e:
        print(f"ERROR : bad -car-spec: {e}")
        return 1
    if args.car_samples:
        if args.car_samples < 2:
            print("ERROR : -car-samples must be >= 2 ...exiting")
            return 1
        spec = _dc.replace(spec, samples=args.car_samples)
    if args.car_seed is not None:
        spec = _dc.replace(spec, seed=args.car_seed)
    try:
        result = capacity_at_risk(
            snapshot, spec, mode=args.semantics,
            node_mask=implicit_taint_mask(snapshot), device=args.device,
        )
    except (DistributionError, ValueError) as e:
        print(f"ERROR : {e}")
        return 1
    if args.output == "json":
        print(car_json_report(result.to_wire()))
    else:
        print(car_table_report(result.to_wire()))
    return 0 if result.schedulable else 1


def _run_forecast_status(args) -> int:
    """-forecast HOST:PORT: fetch and render a service's forecast
    (horizon) watch status.  Exits by the verdict, like -car."""
    from kubernetesclustercapacity_tpu_torch.report import (
        forecast_status_json_report,
        forecast_status_table_report,
    )

    addr = _parse_addr("-forecast", args.forecast)
    if addr is None:
        return 1
    try:
        with _diag_client(addr) as c:
            result = c.forecast()
    except Exception as e:  # noqa: BLE001 - a CLI reports, never tracebacks
        print(f"ERROR : cannot fetch forecast status from "
              f"{addr[0]}:{addr[1]}: {e}", file=sys.stderr)
        return 1
    if args.output == "json":
        print(forecast_status_json_report(result))
    else:
        print(forecast_status_table_report(result))
    if not result.get("enabled", False):
        return 1
    return 1 if result.get("breached") else 0


def _load_operator_doc(path: str):
    """YAML-when-PyYAML-else-strict-JSON — the same loader split every
    operator file (stochastic spec, catalog) uses."""
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    try:
        import yaml  # type: ignore[import-untyped]

        data = yaml.safe_load(text)
    except ImportError:
        try:
            data = json.loads(text)
        except ValueError as e:
            raise ValueError(
                f"{path}: not valid JSON (and PyYAML is unavailable): {e}"
            ) from e
    except Exception as e:  # yaml.YAMLError — malformed document
        raise ValueError(f"{path}: cannot parse: {e}") from e
    return data


def _run_forecast_spec(args, snapshot) -> int:
    """-forecast-spec FILE: offline horizon projection against the
    -snapshot source.

    The file extends the stochastic usage-spec grammar with a
    ``horizon:`` block (steps, step_s), an optional ``threshold``, and
    growth provenance: either explicit ``growth: {cpu_per_s,
    memory_per_s}`` relative rates or ``audit_dir:`` pointing at an
    audit log (either package's), in which case the trend is Theil–Sen
    fitted from the digest-verified generations.  Exits 1 when any
    projected quantile crosses the threshold within the horizon."""
    from kubernetesclustercapacity_tpu_torch.forecast import (
        DEFAULT_STEP_S,
        DEFAULT_STEPS,
        max_steps,
        project_horizon,
        trend_from_audit,
    )
    from kubernetesclustercapacity_tpu_torch.masks import implicit_taint_mask
    from kubernetesclustercapacity_tpu_torch.report import (
        forecast_json_report,
        forecast_table_report,
    )
    from kubernetesclustercapacity_tpu_torch.stochastic import (
        DistributionError,
        InsufficientHistoryError,
        parse_stochastic_spec,
    )

    if args.backend != "torch":
        print("ERROR : -forecast-spec runs on the device programs (-backend "
              "torch); cpu/native backends are fit-only cross-checks "
              "...exiting")
        return 1
    try:
        doc = _load_operator_doc(args.forecast_spec)
    except (OSError, ValueError) as e:
        print(f"ERROR : bad -forecast-spec: {e}")
        return 1
    if not isinstance(doc, dict):
        print("ERROR : bad -forecast-spec: expected a mapping")
        return 1
    doc = dict(doc)
    horizon = doc.pop("horizon", None) or {}
    growth = doc.pop("growth", None)
    audit_dir = doc.pop("audit_dir", None)
    threshold = doc.pop("threshold", None)
    quantiles = doc.pop("quantiles", None)
    try:
        spec = parse_stochastic_spec(doc)
        if not isinstance(horizon, dict) or not set(horizon) <= {
            "steps", "step_s"
        }:
            raise ValueError(
                "horizon: wants a mapping with steps and/or step_s"
            )
        steps = horizon.get("steps", DEFAULT_STEPS)
        step_s = horizon.get("step_s", DEFAULT_STEP_S)
        if (growth is None) == (audit_dir is None):
            raise ValueError(
                "exactly one of growth: {cpu_per_s, memory_per_s} or "
                "audit_dir: is required"
            )
        if threshold is not None and (
            isinstance(threshold, bool) or not isinstance(threshold, int)
        ):
            raise ValueError(f"threshold: expected an int, got {threshold!r}")
        if quantiles is not None:
            if not isinstance(quantiles, list) or not quantiles:
                raise ValueError("quantiles: expected a non-empty list")
            quantiles = tuple(float(q) for q in quantiles)
    except (DistributionError, ValueError, TypeError) as e:
        print(f"ERROR : bad -forecast-spec: {e}")
        return 1

    trend_wire = {}
    degraded = False
    if audit_dir is not None:
        try:
            fit_cpu, series = trend_from_audit(audit_dir, "cpu", "usage")
            fit_mem, _ = trend_from_audit(audit_dir, "memory", "usage")
        except (OSError, InsufficientHistoryError, ValueError) as e:
            print(f"ERROR : cannot fit trend from {audit_dir}: {e}")
            return 1
        growth_cpu = max(fit_cpu.relative_slope_per_s, 0.0)
        growth_mem = max(fit_mem.relative_slope_per_s, 0.0)
        degraded = series.degraded_time_axis
        trend_wire = {
            "source": str(audit_dir),
            "cpu": fit_cpu.to_wire(),
            "memory": fit_mem.to_wire(),
        }
    else:
        if not isinstance(growth, dict) or not set(growth) <= {
            "cpu_per_s", "memory_per_s"
        }:
            print("ERROR : bad -forecast-spec: growth wants cpu_per_s "
                  "and/or memory_per_s")
            return 1
        try:
            growth_cpu = float(growth.get("cpu_per_s", 0.0))
            growth_mem = float(growth.get("memory_per_s", 0.0))
        except (TypeError, ValueError):
            print("ERROR : bad -forecast-spec: growth rates must be numbers")
            return 1
    try:
        result = project_horizon(
            snapshot, spec,
            steps=int(steps), step_s=float(step_s),
            growth_cpu_per_s=growth_cpu, growth_mem_per_s=growth_mem,
            mode=args.semantics or snapshot.semantics,
            node_mask=implicit_taint_mask(snapshot),
            **({"quantiles": quantiles} if quantiles else {}),
            threshold=threshold,
            degraded_time_axis=degraded,
            device=args.device,
        )
    except (DistributionError, ValueError, TypeError) as e:
        print(f"ERROR : {e} (steps must stay within "
              f"KCCAP_FORECAST_MAX_STEPS={max_steps()})")
        return 1
    result.trend = trend_wire
    wire = result.to_wire()
    if args.output == "json":
        print(forecast_json_report(wire))
    else:
        print(forecast_table_report(wire))
    return 1 if wire["breached_within_horizon"] else 0


def _run_plan(args, snapshot) -> int:
    """-plan FILE -catalog FILE: offline certified capacity planning
    against the -snapshot source.

    The plan file is the stochastic usage-spec grammar plus optional
    ``target`` (replicas to restore, default the spec's), ``quantile``
    (default 0.95) and ``drain: true`` (also compute the scale-down
    dual).  Exits 0 only when the plan is certified."""
    from kubernetesclustercapacity_tpu_torch.forecast import (
        PlannerError,
        load_catalog,
        plan_capacity,
    )
    from kubernetesclustercapacity_tpu_torch.masks import implicit_taint_mask
    from kubernetesclustercapacity_tpu_torch.report import (
        plan_json_report,
        plan_table_report,
    )
    from kubernetesclustercapacity_tpu_torch.stochastic import (
        DistributionError,
        parse_stochastic_spec,
    )

    if args.backend != "torch":
        print("ERROR : -plan runs on the device programs (-backend torch); "
              "cpu/native backends are fit-only cross-checks ...exiting")
        return 1
    if not args.catalog:
        print("ERROR : -plan needs -catalog FILE (the node-shape "
              "catalog to buy from) ...exiting")
        return 1
    try:
        catalog = load_catalog(args.catalog)
    except (OSError, PlannerError) as e:
        print(f"ERROR : bad -catalog: {e}")
        return 1
    try:
        doc = _load_operator_doc(args.plan_spec)
    except (OSError, ValueError) as e:
        print(f"ERROR : bad -plan: {e}")
        return 1
    if not isinstance(doc, dict):
        print("ERROR : bad -plan: expected a mapping")
        return 1
    doc = dict(doc)
    target = doc.pop("target", None)
    quantile = doc.pop("quantile", 0.95)
    drain = doc.pop("drain", False)
    try:
        spec = parse_stochastic_spec(doc)
        if target is not None and (
            isinstance(target, bool) or not isinstance(target, int)
        ):
            raise ValueError(f"target: expected an int, got {target!r}")
        if not isinstance(drain, bool):
            raise ValueError(f"drain: expected a bool, got {drain!r}")
        result = plan_capacity(
            snapshot, spec, catalog,
            target=target, quantile=float(quantile),
            mode=args.semantics or snapshot.semantics,
            node_mask=implicit_taint_mask(snapshot),
            drain=drain,
            device=args.device,
        )
    except (DistributionError, PlannerError, ValueError, TypeError) as e:
        print(f"ERROR : bad -plan: {e}")
        return 1
    wire = result.to_wire()
    if args.output == "json":
        print(plan_json_report(wire))
    else:
        print(plan_table_report(wire))
    return 0 if result.certified else 1


def _run_gang_status(args) -> int:
    """-gang HOST:PORT: fetch and render a service's gang-watch status
    (the gang slice of the timeline).  Exits by the verdict, like -car:
    a breached gang watch — fewer than N whole gangs fit — is a
    scriptable failure, and so is a server with no gang watches."""
    from kubernetesclustercapacity_tpu_torch.report import (
        gang_status_json_report,
        gang_status_table_report,
    )

    addr = _parse_addr("-gang", args.gang)
    if addr is None:
        return 1
    try:
        with _diag_client(addr) as c:
            result = c.gang()
    except Exception as e:  # noqa: BLE001 - a CLI reports, never tracebacks
        print(f"ERROR : cannot fetch gang status from "
              f"{addr[0]}:{addr[1]}: {e}", file=sys.stderr)
        return 1
    if args.output == "json":
        print(gang_status_json_report(result))
    else:
        print(gang_status_table_report(result))
    if not result.get("enabled", False):
        return 1
    return 1 if result.get("breached") else 0


def _run_gang_spec(args, snapshot) -> int:
    """-gang-spec FILE: offline whole-gang capacity against the
    -snapshot source's topology hierarchy.  Applies the same implicit
    strict-mode taint mask as every other surface, prints the gang
    verdict with its binding-level explanation, and exits by
    schedulability: 1 when fewer than the spec's ``count`` gangs fit."""
    from kubernetesclustercapacity_tpu_torch.masks import implicit_taint_mask
    from kubernetesclustercapacity_tpu_torch.report import (
        gang_json_report,
        gang_table_report,
    )
    from kubernetesclustercapacity_tpu_torch.scenario import ScenarioGrid
    from kubernetesclustercapacity_tpu_torch.topology import (
        GangSpecError,
        gang_capacity,
        gang_explain,
        load_gang_spec,
    )

    if args.backend != "torch":
        print("ERROR : -gang-spec runs on the device programs (-backend "
              "torch); cpu/native backends are fit-only cross-checks "
              "...exiting")
        return 1
    try:
        scenario, spec = load_gang_spec(args.gang_spec)
    except (OSError, GangSpecError) as e:
        print(f"ERROR : bad -gang-spec: {e}")
        return 1
    grid = ScenarioGrid.from_scenarios([scenario])
    mask = implicit_taint_mask(snapshot)
    try:
        result = gang_capacity(
            snapshot, grid, spec, mode=args.semantics, node_mask=mask,
            device=args.device,
        )
        wire = result.to_wire()
        wire["explain"] = gang_explain(
            snapshot, grid, spec, mode=args.semantics, node_mask=mask,
            device=args.device,
        )
    except (GangSpecError, ValueError) as e:
        print(f"ERROR : {e}")
        return 1
    if args.output == "json":
        print(gang_json_report(wire))
    else:
        print(gang_table_report(wire))
    return 0 if bool(result.schedulable[0]) else 1


def _run_optimize(args, snapshot, scenario) -> int:
    """-optimize: the optimization-based packing backend, offline.

    Answers the six-flag spec (or a ``-grid N`` random sweep) with the
    chosen ``-opt-backend`` against the -snapshot source, under the
    same implicit strict-mode taint mask as every other surface.
    Exits 1 when the spec is unschedulable by the integral packing, or
    when any LP solve failed to certify — an uncertified bound is a
    scriptable failure, not a silent one.
    """
    from kubernetesclustercapacity_tpu_torch.masks import implicit_taint_mask
    from kubernetesclustercapacity_tpu_torch.ops.fit import sweep_snapshot
    from kubernetesclustercapacity_tpu_torch.optimize import (
        OptimizeError,
        optimize_snapshot,
    )
    from kubernetesclustercapacity_tpu_torch.report import (
        optimize_json_report,
        optimize_table_report,
    )
    from kubernetesclustercapacity_tpu_torch.scenario import (
        ScenarioGrid,
        random_scenario_grid,
    )

    if args.backend != "torch":
        print("ERROR : -optimize runs on the device programs (-backend "
              "torch); cpu/native backends are fit-only cross-checks "
              "...exiting")
        return 1
    if args.grid > 0:
        grid = random_scenario_grid(args.grid, seed=args.seed)
    else:
        grid = ScenarioGrid.from_scenarios([scenario])
    mask = implicit_taint_mask(snapshot)
    mode = args.semantics or snapshot.semantics
    if args.opt_backend == "ffd":
        totals, _ = sweep_snapshot(snapshot, grid, mode=mode,
                                   node_mask=mask, device=args.device)[:2]
        totals = np.asarray(totals, dtype=np.int64)
        demand = np.asarray(grid.replicas, dtype=np.int64)
        wire = {
            "backend": "ffd",
            "mode": mode,
            "scenarios": grid.size,
            "demand": demand.tolist(),
            "ffd": np.clip(totals, 0, demand).tolist(),
            "totals": totals.tolist(),
            "schedulable": (totals >= demand).tolist(),
        }
        if args.output == "json":
            print(optimize_json_report(wire))
        else:
            print(optimize_table_report(wire))
        return 0 if all(wire["schedulable"]) else 1
    try:
        result = optimize_snapshot(snapshot, grid, mode=mode,
                                   node_mask=mask, device=args.device)
    except OptimizeError as e:
        print(f"ERROR : {e}")
        return 1
    wire = result.to_wire()
    if args.output == "json":
        print(optimize_json_report(wire))
    else:
        print(optimize_table_report(wire))
    ok = result.all_certified and bool(result.schedulable.all())
    return 0 if ok else 1


def _run_single(args, fixture, snapshot, scenario) -> int:
    """One spec: per-node fits from the device program (or the oracle
    under ``-backend cpu``), then the chosen report."""
    from kubernetesclustercapacity_tpu_torch.masks import implicit_taint_mask
    from kubernetesclustercapacity_tpu_torch.ops.fit import fit_snapshot
    from kubernetesclustercapacity_tpu_torch.oracle import (
        ReferencePanic,
        fit_arrays_python,
        reference_run,
    )
    from kubernetesclustercapacity_tpu_torch.utils.quantity import int64_bits

    ext_requests = _parse_extended_requests(args)
    if ext_requests is None:
        return 1
    if ext_requests:
        # The R-resource fit through the model facade (R-way min and the
        # implicit strict mask).  The cpu backend walks 2 resources only.
        if args.backend != "torch":
            print("ERROR : -extended-request needs -backend torch "
                  "...exiting")
            return 1
        from kubernetesclustercapacity_tpu_torch.models import (
            CapacityModel,
            PodSpec,
        )

        try:
            result = CapacityModel(
                snapshot, mode=args.semantics, fixture=fixture,
                device=args.device,
            ).evaluate(
                PodSpec(
                    cpu_request_milli=scenario.cpu_request_milli,
                    mem_request_bytes=scenario.mem_request_bytes,
                    replicas=scenario.replicas,
                    cpu_limit_milli=scenario.cpu_limit_milli,
                    mem_limit_bytes=scenario.mem_limit_bytes,
                    extended_requests=ext_requests,
                )
            )
        except (KeyError, ValueError) as e:
            print(f"ERROR : extended-resource fit failed: {e} ...exiting")
            return 1
        return _emit_report(args, snapshot, result.fits, scenario)

    if args.backend == "cpu":
        try:
            if fixture is not None and args.semantics == "reference":
                fits = reference_run(fixture, scenario).fits
            else:
                fits = fit_arrays_python(
                    snapshot.alloc_cpu_milli,
                    snapshot.alloc_mem_bytes,
                    snapshot.alloc_pods,
                    snapshot.used_cpu_req_milli,
                    snapshot.used_mem_req_bytes,
                    snapshot.pods_count,
                    scenario.cpu_request_milli,
                    scenario.mem_request_bytes,
                    mode=args.semantics,
                    healthy=snapshot.healthy,
                )
        except ReferencePanic as e:
            print(f"panic: {e}")
            return 2
        fits = np.array(fits, dtype=np.int64)
    else:
        # Scenario CPU values are raw uint64 (the codec wraps, and the
        # transcript prints them so); the tensors carry their bit patterns.
        fits = fit_snapshot(
            snapshot,
            int64_bits(scenario.cpu_request_milli),
            scenario.mem_request_bytes,
            mode=args.semantics,
            device=args.device,
        )
    # Strict semantics honors hard taints on every surface — the same
    # zeroing the fit program's node_mask performs, for both backends.
    # None (a no-op, keeping byte parity) under reference semantics; the
    # extended-request path above applied it inside CapacityModel.
    mask = implicit_taint_mask(snapshot)
    if mask is not None:
        fits = np.where(mask, fits, 0)
    return _emit_report(args, snapshot, fits, scenario)


def _emit_report(args, snapshot, fits, scenario) -> int:
    from kubernetesclustercapacity_tpu_torch.report import (
        json_report,
        reference_report,
        table_report,
    )

    if args.output == "json":
        print(json_report(snapshot, fits, scenario))
    elif args.output == "table":
        print(table_report(snapshot, fits, scenario))
    else:
        print(reference_report(snapshot, fits, scenario), end="")
    return 0


def _run_grid(args, snapshot) -> int:
    from kubernetesclustercapacity_tpu_torch.masks import implicit_taint_mask
    from kubernetesclustercapacity_tpu_torch.scenario import (
        random_scenario_grid,
    )

    if args.backend != "torch":
        # Running the device sweep under -backend cpu would defeat a
        # cross-check; the sequential backend is single-spec.
        print("ERROR : -grid sweeps run on the device programs (-backend "
              "torch); the cpu backend is a single-spec cross-check "
              "...exiting")
        return 1
    ext_requests = _parse_extended_requests(args)
    if ext_requests is None:
        return 1
    grid = random_scenario_grid(args.grid, seed=args.seed)
    # Strict grids honor hard taints exactly like every other strict
    # surface — one spec, one answer.
    mask = implicit_taint_mask(snapshot)
    if ext_requests:
        # The random cpu/mem grid with a CONSTANT extended request per name
        # on every scenario, through the R-resource dispatcher.
        from kubernetesclustercapacity_tpu_torch.ops.fused_multi import (
            sweep_multi_auto,
        )
        from kubernetesclustercapacity_tpu_torch.scenario import (
            MultiResourceGrid,
            ScenarioError,
        )

        mgrid = MultiResourceGrid.from_grid(
            grid,
            {
                name: np.full(grid.size, qty, dtype=np.int64)
                for name, qty in ext_requests.items()
            },
        )
        try:
            mgrid.validate()  # e.g. a negative -extended-request quantity
        except ScenarioError as e:
            print(f"ERROR : {e} ...exiting")
            return 1
        try:
            alloc_rn, used_rn = snapshot.resource_matrix(mgrid.resources)
        except KeyError as e:
            print(f"ERROR : snapshot has no extended column {e} ...exiting")
            return 1
        totals, sched, kernel = sweep_multi_auto(
            alloc_rn,
            used_rn,
            snapshot.alloc_pods,
            snapshot.pods_count,
            snapshot.healthy,
            mgrid.requests,
            mgrid.replicas,
            mode=args.semantics,
            node_masks=mask,
            force_exact=(args.kernel == "exact"),
            device=args.device,
        )
    else:
        from kubernetesclustercapacity_tpu_torch.ops.fused_fit import (
            sweep_snapshot_auto,
        )

        totals, sched, kernel = sweep_snapshot_auto(
            snapshot,
            grid,
            mode=args.semantics,
            kernel=args.kernel,
            node_mask=mask,
            device=args.device,
        )
    if args.output == "table":
        header = (
            f"{'CPU(m)':>8} {'MEM(MiB)':>10} {'REPLICAS':>9} "
            f"{'TOTAL':>8}  SCHED"
        )
        lines = [header, "-" * len(header)]
        mib = 1024 * 1024
        for i in range(grid.size):
            lines.append(
                f"{int(grid.cpu_request_milli[i]):>8} "
                f"{int(grid.mem_request_bytes[i]) // mib:>10} "
                f"{int(grid.replicas[i]):>9} "
                f"{int(totals[i]):>8}  "
                f"{'yes' if sched[i] else 'NO'}"
            )
        lines.append("-" * len(header))
        lines.append(
            f"kernel: {kernel}   schedulable: "
            f"{int(np.sum(sched))}/{grid.size}"
        )
        print("\n".join(lines))
        return 0
    summary = {
        "scenarios": args.grid,
        "seed": args.seed,
        "semantics": args.semantics,
        "kernel": kernel,
        **(
            {"extended_requests": ext_requests} if ext_requests else {}
        ),
        "totals": totals.tolist(),
        "schedulable": sched.tolist(),
        "totals_p50": float(np.percentile(totals, 50)),
        "schedulable_fraction": float(np.mean(sched)),
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
