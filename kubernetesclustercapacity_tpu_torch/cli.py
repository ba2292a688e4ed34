"""CLI (L4): the ``-grid`` capacity sweep of the PyTorch port.

Counterpart of ``kubernetesclustercapacity_tpu/cli.py`` (its flag layer,
``:544-609``, ``_extended_names`` / ``_parse_extended_requests``,
``:1701-1734``, and ``_run_grid``, ``:1876-1983``).  The reference's six
flags parse exactly as there (``ClusterCapacity.go:50-83``), so an invalid
memory or replicas value prints the reference's fatal line; then a random
``-grid N`` sweep runs through :func:`..ops.fused_fit.sweep_snapshot_auto`,
or, with ``-extended-request NAME=QTY``, through the R-resource
:func:`..ops.fused_multi.sweep_multi_auto`, and prints the same JSON or
table as the JAX CLI, apart from the kernel label.  The single-spec
transcript and the live-cluster source are not ported yet.

Example (BASELINE config 4's four-resource sweep)::

    python -m kubernetesclustercapacity_tpu_torch.cli \\
        -snapshot cluster.npz -grid 1000 -semantics strict \\
        -extended-request nvidia.com/gpu=1 \\
        -extended-request ephemeral-storage=10Gi -output json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

__all__ = ["main", "build_parser"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kccap-torch",
        description="Kubernetes cluster-capacity sweep on PyTorch / CUDA",
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
    p.add_argument("-snapshot", default="",
                   help="offline source: fixture .json or checkpoint .npz")
    p.add_argument("-semantics", choices=("reference", "strict"),
                   default=None,
                   help="bug-compatible reference semantics or corrected mode "
                        "(default: reference; for .npz snapshots, the "
                        "semantics they were packed with)")
    p.add_argument("-output", choices=("json", "table"), default="json",
                   help="report format")
    p.add_argument("-grid", type=int, default=0, metavar="N",
                   help="evaluate a random N-scenario sweep")
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
    p.add_argument("-device", choices=("cuda", "cpu"), default="cuda",
                   help="run on the GPU (default) or the host")
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
    from kubernetesclustercapacity_tpu_torch.sources import (
        SourceError,
        resolve_source,
    )

    args = build_parser().parse_args(
        _split_single_dash_eq(sys.argv[1:] if argv is None else list(argv))
    )
    try:
        scenario_from_flags(
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
    if args.grid <= 0:
        print("ERROR : the single-spec report is not yet ported to the "
              "PyTorch package; use -grid N ...exiting")
        return 1
    if not args.snapshot:
        print("ERROR : the live-cluster source is not yet ported to the "
              "PyTorch package; use -snapshot <fixture.json|checkpoint.npz> "
              "...exiting")
        return 1
    try:
        _, snapshot, args.semantics = resolve_source(
            args.snapshot, args.semantics,
            extended_resources=_extended_names(args),
        )
    except SourceError as e:
        print(f"ERROR : {e}")
        return 1
    return _run_grid(args, snapshot)


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


def _run_grid(args, snapshot) -> int:
    from kubernetesclustercapacity_tpu_torch.masks import implicit_taint_mask
    from kubernetesclustercapacity_tpu_torch.scenario import (
        random_scenario_grid,
    )

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
