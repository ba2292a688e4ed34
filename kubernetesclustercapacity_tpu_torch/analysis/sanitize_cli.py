"""``kccap-torch-sanitize``: the console entry point for the dynamic sanitizer.

Usage::

    kccap-torch-sanitize                      # static lock-order + seeded hammer
    kccap-torch-sanitize --seeds 3            # hammer under 3 seeds (0,1,2)
    kccap-torch-sanitize --seed 42            # one specific seed (repro mode)
    kccap-torch-sanitize --threads 16 --iters 40
    kccap-torch-sanitize --static-only        # just the AST lock-order prover
    kccap-torch-sanitize --json               # machine-readable artifact
    kccap-torch-sanitize --no-baseline        # ignore LINT_BASELINE_TORCH.json

Exit codes mirror ``kccap-torch-lint``: ``0`` clean, ``1`` unsuppressed
findings, ``2`` usage/configuration error.  Every line of dynamic
output carries its seed — paste the seed back via ``--seed`` to replay
the exact perturbation decision sequence.

Unlike ``kccap-torch-lint``, this tool IMPORTS and RUNS the package (that is
the point); it arms the ``KCCAP_SANITIZE`` gate itself for the
duration of the run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

__all__ = ["main", "run"]

BASELINE_FILENAME = "LINT_BASELINE_TORCH.json"


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kccap-torch-sanitize",
        description=(
            "Runtime lockset race detector, lock-order deadlock prover "
            "and seeded schedule fuzzer over the package's threaded "
            "classes."
        ),
    )
    p.add_argument(
        "package",
        nargs="?",
        default=None,
        help="package directory to certify (default: the installed "
        "kubernetesclustercapacity_tpu_torch package)",
    )
    p.add_argument(
        "--seeds",
        type=int,
        default=3,
        help="number of hammer seeds to run (0..N-1; default 3)",
    )
    p.add_argument(
        "--seed",
        type=int,
        default=None,
        help="run exactly ONE seed (replay mode: the same seed replays "
        "the same schedule-perturbation decisions)",
    )
    p.add_argument(
        "--threads",
        type=int,
        default=16,
        help="concurrent workers per hammered class (default 16)",
    )
    p.add_argument(
        "--iters",
        type=int,
        default=40,
        help="ops per worker per class (default 40)",
    )
    p.add_argument(
        "--static-only",
        action="store_true",
        dest="static_only",
        help="run only the AST lock-order prover (no imports, no "
        "threads — the kccap-torch-lint subset)",
    )
    p.add_argument(
        "--no-fuzz",
        action="store_true",
        dest="no_fuzz",
        help="disable schedule perturbation (lockset analysis only)",
    )
    p.add_argument(
        "--baseline",
        default=None,
        help=f"baseline file (default: <repo-root>/{BASELINE_FILENAME})",
    )
    p.add_argument(
        "--no-baseline",
        action="store_true",
        help="report every finding, ignoring the baseline",
    )
    p.add_argument(
        "--json",
        action="store_true",
        dest="as_json",
        help="emit the machine-readable findings artifact on stdout",
    )
    return p


def run(argv=None) -> int:
    from kubernetesclustercapacity_tpu_torch.analysis import sanitize
    from kubernetesclustercapacity_tpu_torch.analysis.engine import (
        Analyzer,
        Baseline,
        Project,
    )

    args = _build_parser().parse_args(argv)
    if args.threads < 1 or args.iters < 1 or args.seeds < 1:
        print(
            "kccap-torch-sanitize: --threads/--iters/--seeds must be >= 1",
            file=sys.stderr,
        )
        return 2
    package_dir = os.path.abspath(
        args.package
        or os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    try:
        project = Project(package_dir)
    except (FileNotFoundError, SyntaxError) as e:
        print(f"kccap-torch-sanitize: {e}", file=sys.stderr)
        return 2
    baseline_path = args.baseline or os.path.join(
        project.repo_root, BASELINE_FILENAME
    )
    try:
        baseline = (
            Baseline() if args.no_baseline else Baseline.load(baseline_path)
        )
    except (ValueError, json.JSONDecodeError) as e:
        print(
            f"kccap-torch-sanitize: bad baseline {baseline_path}: {e}",
            file=sys.stderr,
        )
        return 2

    # -- static half: the AST lock-order prover (shared with kccap-torch-lint).
    static = Analyzer(project, rules=("lock-order",), baseline=baseline).run()

    # -- dynamic half: the seeded hammer.
    seeds = [args.seed] if args.seed is not None else list(range(args.seeds))
    runs = []
    dyn_live: list = []
    dyn_suppressed: list = []
    dyn_baselined: list = []
    if not args.static_only:
        from kubernetesclustercapacity_tpu_torch.analysis import hammer

        os.environ.setdefault(sanitize.ENV_SWITCH, "1")
        for seed in seeds:
            try:
                found, st = hammer.run(
                    seed=seed,
                    threads=args.threads,
                    iters=args.iters,
                    fuzz=not args.no_fuzz,
                    package_dir=package_dir,
                )
            except Exception as e:  # noqa: BLE001 - a crash is a verdict
                print(
                    f"kccap-torch-sanitize: hammer crashed under seed {seed}: "
                    f"{type(e).__name__}: {e}",
                    file=sys.stderr,
                )
                return 2
            part = sanitize.partition(found, baseline, project.repo_root)
            sanitize.publish_metrics(st, part)
            runs.append((seed, part, st))
            dyn_live.extend(part.findings)
            dyn_suppressed.extend(part.suppressed)
            dyn_baselined.extend(part.baselined)

    clean = static.clean and not dyn_live
    if args.as_json:
        artifact = {
            "version": 1,
            "clean": clean,
            "static": static.to_json(),
            "dynamic": {
                "seeds": seeds,
                "threads": args.threads,
                "iters": args.iters,
                "runs": [
                    {
                        "seed": seed,
                        "clean": part.clean,
                        "findings": [f.to_json() for f in part.findings],
                        "suppressed": [
                            f.to_json() for f in part.suppressed
                        ],
                        "stats": st,
                    }
                    for seed, part, st in runs
                ],
            },
        }
        print(json.dumps(artifact, indent=2))
    else:
        for f in static.findings:
            print(f.render())
        for f in dyn_live:
            print(f.render())
        classes = runs[0][2]["instrumented_classes"] if runs else 0
        print(
            f"kccap-torch-sanitize: static {len(static.findings)} finding(s); "
            f"dynamic {len(dyn_live)} finding(s), "
            f"{len(dyn_suppressed)} suppressed inline, "
            f"{len(dyn_baselined)} baselined over {len(runs)} seeded "
            f"run(s) x {classes} instrumented class(es), "
            f"seeds={seeds}"
        )
    return 0 if clean else 1


def main() -> None:  # console_scripts entry
    sys.exit(run())


if __name__ == "__main__":
    main()
