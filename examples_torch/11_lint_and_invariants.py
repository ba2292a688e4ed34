"""Static analysis of the PyTorch port: proving its runtime invariants
over the AST.

``kccap-torch-lint`` is the port's own analyzer.  Its device-purity rule
(the counterpart of the JAX package's jit-purity) builds an
intra-package call graph rooted at every device program the package
declares in ``DEVICE_ROOTS`` and shows that no host subsystem, lock,
I/O or clock is reachable from one, and that no device→host wait runs
once per step of a device loop.  The lock, lock-order, hygiene and
surface rules are the JAX analyzer's, over the port's classes and
names.  This example walks the machinery:

1. run the analyzer over the port package against the checked-in
   ``LINT_BASELINE_TORCH.json`` (the tier-1 gate) — clean, with every
   declared boundary admitted inline with its reason;
2. show the call graph the device-purity prover reasons over (the
   declared roots, the reachable set);
3. analyze a deliberately-broken throwaway package and show each rule
   family firing with file:line findings, inline suppression, and a
   baseline round trip.

Run:  python examples_torch/11_lint_and_invariants.py
"""

import json
import os
import sys
import tempfile
import textwrap

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))  # noqa: E402 - run-by-path support

import kubernetesclustercapacity_tpu_torch as kccap_pkg
from kubernetesclustercapacity_tpu_torch.analysis import (
    Analyzer,
    Baseline,
    Project,
)
from kubernetesclustercapacity_tpu_torch.analysis.callgraph import CallGraph

BAD_INIT = '''
DEVICE_ROOTS = ("leaky.leaky_program",)
'''

BAD_MODULE = '''
import threading
import time

import torch

_lock = threading.Lock()


def leaky_program(x, steps: int):
    t = time.perf_counter()          # wall clock inside a device program
    with _lock:                      # lock acquisition on the launch path
        pass
    for _ in range(steps):
        x = x * 2
        if x.max().item() > 1e9:     # a device->host wait every step
            break
    return x + t


class Racy:
    def __init__(self):
        self._lock = threading.Lock()
        self._served = 0

    def record(self):
        with self._lock:
            self._served += 1

    def stats(self):
        return self._served          # guarded field read without the lock

    def stats_accepted(self):
        return self._served  # kccap: lint-ok[lock-discipline] demo: display-only racy read

METRIC = "kccap_demo_undocumented_total"
'''


def main() -> None:
    pkg_dir = os.path.dirname(os.path.abspath(kccap_pkg.__file__))
    repo_root = os.path.dirname(pkg_dir)

    # -- 1. the tier-1 gate: the port is clean against its baseline.
    project = Project(pkg_dir)
    baseline = Baseline.load(
        os.path.join(repo_root, "LINT_BASELINE_TORCH.json")
    )
    result = Analyzer(project, baseline=baseline).run()
    print(
        f"package gate: {len(result.findings)} finding(s), "
        f"{len(result.suppressed)} suppressed inline, "
        f"{len(result.baselined)} baselined "
        f"over {len(project.files)} files"
    )
    assert result.clean, [f.render() for f in result.findings]
    print(f"baseline history entries: {len(baseline.history)}")

    # -- 2. the call graph behind the device-purity proof.
    graph = CallGraph.build(project)
    roots = sorted(graph.roots(), key=lambda f: f.qname)
    reachable = graph.reachable()
    print(
        f"\ndevice-purity universe: {len(roots)} declared device roots, "
        f"{len(reachable)} reachable functions"
    )
    for info in roots[:5]:
        short = info.qname.split(".", 1)[1]
        print(f"  root {short}  ({info.root_reasons[0]})")
    print("  ...")
    boundaries = [f for f in result.suppressed if f.rule == "device-purity"]
    print(f"declared boundaries (lint-ok[device-purity]): {len(boundaries)}")

    # -- 3. every rule family firing on a deliberately-broken package.
    with tempfile.TemporaryDirectory() as tmp:
        bad_pkg = os.path.join(tmp, "demo_pkg")
        os.makedirs(bad_pkg)
        with open(os.path.join(bad_pkg, "__init__.py"), "w") as fh:
            fh.write(textwrap.dedent(BAD_INIT))
        with open(os.path.join(bad_pkg, "leaky.py"), "w") as fh:
            fh.write(textwrap.dedent(BAD_MODULE))
        with open(os.path.join(tmp, "README.md"), "w") as fh:
            fh.write("# demo\nNothing documented here.\n")

        bad = Analyzer(Project(bad_pkg)).run()
        print(f"\ndemo package: {len(bad.findings)} finding(s)")
        for f in bad.findings:
            print(f"  {f.render()}")
        rules = {f.rule for f in bad.findings}
        assert "device-purity" in rules and "lock-discipline" in rules
        assert "surface-metric" in rules
        cats = {f.message.split(":", 1)[0] for f in bad.findings
                if f.rule == "device-purity"}
        assert {"clock", "lock", "host-sync"} <= cats, cats
        assert len(bad.suppressed) == 1  # the lint-ok[...] demo line

        # Baseline round trip: accept everything, re-run clean.
        bl_path = os.path.join(tmp, "baseline.json")
        Baseline.from_findings(
            bad.findings, history=["demo: accepted during adoption"]
        ).save(bl_path)
        rerun = Analyzer(
            Project(bad_pkg), baseline=Baseline.load(bl_path)
        ).run()
        print(
            f"after --write-baseline: {len(rerun.findings)} finding(s), "
            f"{len(rerun.baselined)} baselined"
        )
        assert rerun.clean

        # The machine-readable artifact CI consumes (kccap-torch-lint --json).
        artifact = bad.to_json()
        print(
            "artifact counts: "
            + json.dumps(artifact["counts"]["by_rule"], sort_keys=True)
        )

    print("\nstatic analysis demo complete.")


if __name__ == "__main__":
    main()
