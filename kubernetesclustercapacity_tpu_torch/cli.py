"""CLI (L4): the reference's question on PyTorch / CUDA — one pod spec, or
a sweep of them.

Counterpart of ``kubernetesclustercapacity_tpu/cli.py`` (its flag layer
and dispatch, ``:544-609``, ``_run_explain``, ``:1575-1604``,
``_extended_names`` / ``_parse_extended_requests`` / ``_run_single`` /
``_emit_report``, ``:1701-1873``, ``_run_grid``, ``:1876-1983``,
``_run_drain``, ``:1606-1641``, and ``_run_drain_server``,
``:1217-1249``).
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
running capacity server.

The source is ``-snapshot`` (a fixture ``.json`` or a checkpoint
``.npz``) or, without it, the live cluster of ``-kubeconfig`` (default
``$HOME/.kube/config``): two paginated Lists through the port's stdlib
client (:mod:`.kubeapi`), packed like a fixture.  ``-backend torch`` (the
default) runs the port's device programs on ``-device``; ``-backend cpu``
is the pure-Python oracle, the reference's sequential walk, as a
cross-check.  ``-save-snapshot`` checkpoints the loaded snapshot and
``-group-min-count`` sets the grouping gate, as in the JAX CLI.  Every
other flag of the JAX CLI is declared: the compiled C++ loop (``-backend
native``) and the CaR, forecast, plan, gang, optimize, timeline, replay,
doctor, profiling and federation surfaces are not ported yet and say so
with exit 1.

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
# it takes: a value, a switch, or one or more values.  Every one is
# declared, so using it prints a "not yet ported" line and exits 1 (the
# JAX CLI would run; argparse would exit 2 on an unknown flag).
_UNPORTED_FLAGS = (
    ("-doctor", "switch"),
    ("-doctor-timeout", "value"),
    ("-doctor-service", "value"),
    ("-metrics-port", "value"),
    ("-trace-log", "value"),
    ("-trace-log-max-bytes", "value"),
    ("-jax-profile", "value"),
    ("-timeline", "value"),
    ("-timeline-since", "value"),
    ("-timeline-watch", "value"),
    ("-car", "value"),
    ("-car-spec", "value"),
    ("-car-samples", "value"),
    ("-car-seed", "value"),
    ("-forecast", "value"),
    ("-forecast-spec", "value"),
    ("-plan", "value"),
    ("-catalog", "value"),
    ("-gang", "value"),
    ("-gang-spec", "value"),
    ("-optimize", "switch"),
    ("-opt-backend", "value"),
    ("-replay", "value"),
    ("-replay-ref", "value"),
    ("-replay-generation", "value"),
    ("-replay-tenant", "value"),
    ("-slo-status", "value"),
    ("-dump", "value"),
    ("-dump-limit", "value"),
    ("-dump-tenant", "value"),
    ("-plane-status", "value"),
    ("-fed-status", "value"),
    ("-fed-sweep", "value"),
    ("-doctor-federation", "value"),
    ("-trace-tree", "value"),
    ("-trace-logs", "value"),
    ("-profile", "value"),
    ("-profile-seconds", "value"),
    ("-profile-out", "value"),
    ("-bench-diff", "values"),
    ("-bench-thresholds", "value"),
)

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
    from kubernetesclustercapacity_tpu_torch.scenario import (
        ScenarioError,
        scenario_from_flags,
    )

    args = build_parser().parse_args(
        _split_single_dash_eq(sys.argv[1:] if argv is None else list(argv))
    )
    unported = unported_flags_used(args, _UNPORTED_FLAGS)
    if args.drain_server and not unported:
        # A one-shot diagnostic, as in the JAX CLI: no spec, no source.
        return _run_drain_server(args)
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
    the flags ask for (``-drain``, ``-explain``, ``-grid`` or the single
    spec)."""
    if args.save_snapshot:
        snapshot.save(args.save_snapshot)
        print(f"snapshot checkpointed to {args.save_snapshot}",
              file=sys.stderr)
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
