"""``kccap-torch-lint``: the console entry point for the static analyzer.

Usage::

    kccap-torch-lint                  # analyze the installed package
    kccap-torch-lint path/to/package  # analyze an arbitrary package dir
    kccap-torch-lint --json           # machine-readable findings artifact
    kccap-torch-lint --write-baseline # accept current findings as baseline
    kccap-torch-lint --rules device-purity,lock-discipline
    kccap-torch-lint --no-baseline    # ignore the checked-in baseline
    kccap-torch-lint --diff-baseline  # CI mode: ONLY new findings, no recap

Exit codes: ``0`` clean (no non-baselined findings), ``1`` findings,
``2`` usage/configuration error — so the tier-1 test, a pre-commit hook
and a CI job can all gate on the same invocation.  ``--diff-baseline``
prints nothing but the findings absent from the baseline (one per
line) and exits 1 on any — no re-listing of accepted history, so a CI
log is empty exactly when the gate passes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from kubernetesclustercapacity_tpu_torch.analysis.engine import (
    Analyzer,
    Baseline,
    Project,
)

__all__ = ["main", "run"]

BASELINE_FILENAME = "LINT_BASELINE_TORCH.json"


def _default_package_dir() -> str:
    # The package this module ships inside — works both from a checkout
    # and an installed wheel.
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kccap-torch-lint",
        description=(
            "Project-native static analysis: device-purity prover, "
            "lock-discipline checker, lock-order prover, "
            "surface-conformance walks."
        ),
    )
    p.add_argument(
        "package",
        nargs="?",
        default=None,
        help="package directory to analyze (default: the installed "
        "kubernetesclustercapacity_tpu_torch package)",
    )
    p.add_argument(
        "--readme",
        default=None,
        help="README the surface rules check against "
        "(default: <repo-root>/README.md)",
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
        "--diff-baseline",
        action="store_true",
        dest="diff_baseline",
        help="print only findings NOT in the baseline (no summary, no "
        "recap of accepted history) and exit 1 on any — the CI/tier-1 "
        "gate mode",
    )
    p.add_argument(
        "--write-baseline",
        action="store_true",
        help="accept the current findings into the baseline file and exit 0",
    )
    p.add_argument(
        "--rules",
        default=None,
        help="comma-separated rule families to run "
        "(device-purity,lock-discipline,lock-order,surface,hygiene; "
        "default: all)",
    )
    p.add_argument(
        "--json",
        action="store_true",
        dest="as_json",
        help="emit the machine-readable findings artifact on stdout",
    )
    return p


def run(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    package_dir = os.path.abspath(args.package or _default_package_dir())
    try:
        project = Project(package_dir, readme_path=args.readme)
    except (FileNotFoundError, SyntaxError) as e:
        print(f"kccap-torch-lint: {e}", file=sys.stderr)
        return 2

    baseline_path = args.baseline or os.path.join(
        project.repo_root, BASELINE_FILENAME
    )
    try:
        baseline = (
            Baseline() if args.no_baseline else Baseline.load(baseline_path)
        )
    except (ValueError, json.JSONDecodeError) as e:
        print(f"kccap-torch-lint: bad baseline {baseline_path}: {e}", file=sys.stderr)
        return 2

    rules = None
    if args.rules:
        rules = tuple(r.strip() for r in args.rules.split(",") if r.strip())
    try:
        analyzer = Analyzer(project, rules=rules, baseline=baseline)
    except ValueError as e:
        print(f"kccap-torch-lint: {e}", file=sys.stderr)
        return 2
    result = analyzer.run()

    if args.write_baseline:
        merged = Baseline.from_findings(
            result.findings, history=baseline.history
        )
        merged.entries |= baseline.entries
        merged.save(baseline_path)
        print(
            f"kccap-torch-lint: baseline updated ({len(result.findings)} finding(s) "
            f"accepted) -> {baseline_path}"
        )
        return 0

    if args.diff_baseline:
        # CI mode: the log is empty exactly when the gate passes.
        for f in result.findings:
            print(f.render())
        return 0 if result.clean else 1

    if args.as_json:
        print(json.dumps(result.to_json(), indent=2))
    else:
        for f in result.findings:
            print(f.render())
        n, s, b = (
            len(result.findings),
            len(result.suppressed),
            len(result.baselined),
        )
        print(
            f"kccap-torch-lint: {n} finding(s), {s} suppressed inline, "
            f"{b} baselined, over {len(project.files)} file(s)"
        )
    return 0 if result.clean else 1


def main() -> None:  # console_scripts entry
    sys.exit(run())


if __name__ == "__main__":
    main()
