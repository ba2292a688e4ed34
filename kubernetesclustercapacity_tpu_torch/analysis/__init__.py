"""``kccap-torch-lint`` and ``kccap-torch-sanitize``: the port's own
static analysis and runtime sanitizer, plus :mod:`.benchdiff`.

Counterpart of ``kubernetesclustercapacity_tpu/analysis/``; the rules
are the same AST walks, and every family but one is a copy:

* **device-purity** (:mod:`.rules_jit`, the counterpart of
  ``jit-purity``) — an intra-package call graph rooted at the declared
  device programs (:data:`.callgraph.DEVICE_ROOTS`) proves that no
  host-subsystem call, lock, I/O, ``time.*``/``random.*`` use, and no
  device→host wait inside a step loop is reachable from them;
* **lock-discipline**, **lock-order**, **hygiene** and the
  **surface** walks (:mod:`.rules_locks`, :mod:`.rules_lockorder`,
  :mod:`.rules_hygiene`, :mod:`.rules_surface`) — unchanged, over the
  port's classes, flags, ops, env vars, metrics and span fields.

The lint rules never import the code they analyze.  The sanitizer
(:mod:`.sanitize`, gated by ``KCCAP_SANITIZE=1``) and its hammer
(:mod:`.hammer`) are the runtime complement over the port's threaded
classes.  Findings of both flow through one workflow: ``# kccap:
lint-ok[rule]`` inline markers and the checked-in
``LINT_BASELINE_TORCH.json``.

:mod:`.engine` imports only the standard library, so importing
:mod:`.benchdiff` (``kccap-torch -bench-diff``) still costs nothing else.
"""

from kubernetesclustercapacity_tpu_torch.analysis.engine import (
    Analyzer,
    AnalysisResult,
    Baseline,
    Finding,
    Project,
)

__all__ = [
    "Analyzer",
    "AnalysisResult",
    "Baseline",
    "Finding",
    "Project",
]
