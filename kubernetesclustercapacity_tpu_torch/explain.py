"""Capacity explainability: WHY the sweep stopped at N replicas.

Counterpart of ``kubernetesclustercapacity_tpu/explain.py``.  The
reference's whole diagnostic story is four ``fmt.Printf`` percentages that
never influence the fit (``ClusterCapacity.go:113-117``).  This module
answers what an operator asks: for every (scenario, node), which constraint
binds — cpu, memory, pod slots, or node health — how much headroom is left
after the fit, and the smallest additional allocatable of each resource
that would give one more replica anywhere in the cluster.

Two layers, split by where the math belongs:

* a **tensor program** (:func:`explain_per_node` / :func:`explain_grid`) on
  the device beside :mod:`.ops.fit`: the same arithmetic as
  ``fit_per_node`` (it shares its prologue, so the fits are the same bits),
  extended to return the per-constraint fit components and an attribution
  code per node;
* **host-side analysis** (:class:`ExplainResult`): binding histograms,
  saturation, and the marginal ("+1 replica") analysis, numpy and Python
  ints over the program's outputs.  Every marginal delta is verified
  against the sequential bug-compatible evaluator
  (:func:`.oracle.fit_arrays_python`), so reference-mode non-monotonicity
  (the Q1 overwrite can DECREASE a fit when capacity grows) never yields a
  wrong recommendation.

Attribution rule (deterministic, shared with the brute-force oracle in
``tests/test_explain.py``):

* ``unhealthy`` — the node's ``healthy`` flag is false;
* ``masked``    — an explicit ``node_mask`` zeroed the node;
* otherwise the FIRST minimum, in order ``cpu ≺ memory ≺ pods``, of the
  values the mode's min compares: strict compares ``(cpu_fit, mem_fit,
  slots)``; reference has no pod term in the min — its ``pods``
  attribution is the Q1 overwrite having fired
  (``min(cpu_fit, mem_fit) >= allocatable_pods``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from kubernetesclustercapacity_tpu_torch import devcache as _devcache
from kubernetesclustercapacity_tpu_torch.oracle import fit_arrays_python
from kubernetesclustercapacity_tpu_torch.ops.fit import (
    BLOCK_CELLS,
    _resource_fits,
    fetch,
    observed_fetch,
    sweep_explain_grid,
    sweep_explain_grouped,
)
from kubernetesclustercapacity_tpu_torch.scenario import ScenarioGrid
from kubernetesclustercapacity_tpu_torch.snapshot import (
    ClusterSnapshot,
    grouped_for_dispatch,
)
from kubernetesclustercapacity_tpu_torch.telemetry import phases as _phases

__all__ = [
    "BINDING_NAMES",
    "BINDING_CPU",
    "BINDING_MEMORY",
    "BINDING_PODS",
    "BINDING_UNHEALTHY",
    "BINDING_MASKED",
    "ExplainResult",
    "binding_shift",
    "explain_per_node",
    "explain_grid",
    "explain_snapshot",
    "sweep_explain_snapshot",
]

# Attribution codes, in tie-break order (cpu ≺ memory ≺ pods); health and
# mask overrides sit above the resource codes.
BINDING_CPU = 0
BINDING_MEMORY = 1
BINDING_PODS = 2
BINDING_UNHEALTHY = 3
BINDING_MASKED = 4
BINDING_NAMES = ("cpu", "memory", "pods", "unhealthy", "masked")

_U64 = 1 << 64
# Deltas beyond this are not actionable advice ("add 4 exabytes") and
# would push the int64 carrier into wrap territory — treated as "this
# resource cannot buy +1 here".
_MAX_SANE_DELTA = 1 << 62


def explain_per_node(
    alloc_cpu: torch.Tensor,
    alloc_mem: torch.Tensor,
    alloc_pods: torch.Tensor,
    used_cpu: torch.Tensor,
    used_mem: torch.Tensor,
    pods_count: torch.Tensor,
    healthy: torch.Tensor,
    cpu_req: torch.Tensor,
    mem_req: torch.Tensor,
    *,
    mode: str = "reference",
    node_mask: torch.Tensor | None = None,
):
    """Fit + binding attribution.

    Node columns are ``[N]`` int64 tensors (``healthy`` and ``node_mask``
    bool); the requests broadcast against them as in
    :func:`.ops.fit.fit_per_node` (a 0-dim tensor for one scenario,
    ``[S, 1]`` for a batch).  Returns ``(fit, code, cpu_fit, mem_fit,
    slots)``: ``fit`` bit-identical to ``fit_per_node``'s, ``code`` the
    int32 attribution per the module rule, ``cpu_fit``/``mem_fit`` the
    per-resource quotients on their int64 carriers, and ``slots`` the pod
    term the mode compares (``alloc_pods - pods_count``, clamped at 0 in
    strict mode only), which does not depend on the request and keeps the
    node shape.
    """
    cpu_fit, mem_fit = _resource_fits(
        alloc_cpu, alloc_mem, used_cpu, used_mem, cpu_req, mem_req
    )
    fit_pre = torch.minimum(cpu_fit, mem_fit)
    if mode == "reference":
        slots = alloc_pods - pods_count  # unclamped: Q1's replacement value
        q1 = fit_pre >= alloc_pods
        fit = torch.where(q1, slots, fit_pre)
        code = torch.where(
            q1,
            BINDING_PODS,
            torch.where(cpu_fit <= mem_fit, BINDING_CPU, BINDING_MEMORY),
        )
    elif mode == "strict":
        slots = torch.clamp_min(alloc_pods - pods_count, 0)
        fit = torch.clamp_min(torch.minimum(fit_pre, slots), 0)
        fit = torch.where(healthy, fit, 0)
        code = torch.where(
            (cpu_fit <= mem_fit) & (cpu_fit <= slots),
            BINDING_CPU,
            torch.where(mem_fit <= slots, BINDING_MEMORY, BINDING_PODS),
        )
    else:
        raise ValueError(f"unknown mode {mode!r}")
    # Health override: strict zeroes the node BECAUSE it is unhealthy, and
    # reference's phantom zero row exists because getHealthyNodes skipped
    # it — either way "unhealthy" is the answer, not "cpu is 0".
    code = torch.where(healthy, code, BINDING_UNHEALTHY)
    if node_mask is not None:
        fit = torch.where(node_mask, fit, 0)
        code = torch.where(node_mask, code, BINDING_MASKED)
    # torch.where on Python ints gives int64; the codes are int32.
    return fit, code.to(torch.int32), cpu_fit, mem_fit, slots


def explain_grid(
    alloc_cpu, alloc_mem, alloc_pods, used_cpu, used_mem, pods_count, healthy,
    cpu_reqs, mem_reqs, *,
    mode: str = "reference",
    node_mask: torch.Tensor | None = None,
):
    """S scenarios at once: each output is ``[S, N]`` (``code`` int32, the
    rest int64).  The scenario axis is an ``[S, 1]`` broadcast of the
    ``[S]`` int64 request tensors, taken in ``[S_chunk, N]`` blocks written
    into outputs allocated once, so the temporaries stay bounded at any S.
    """
    if mode not in ("reference", "strict"):
        raise ValueError(f"unknown mode {mode!r}")
    n = int(alloc_cpu.shape[0])
    s = int(cpu_reqs.shape[0])
    outs = [
        torch.empty((s, n), dtype=dtype, device=alloc_cpu.device)
        for dtype in (torch.int64, torch.int32, torch.int64, torch.int64,
                      torch.int64)
    ]
    step = max(1, BLOCK_CELLS // max(n, 1))
    for lo in range(0, s, step):
        parts = explain_per_node(
            alloc_cpu, alloc_mem, alloc_pods, used_cpu, used_mem, pods_count,
            healthy, cpu_reqs[lo:lo + step, None], mem_reqs[lo:lo + step, None],
            mode=mode, node_mask=node_mask,
        )
        for out, part in zip(outs, parts):
            out[lo:lo + step] = part
    return tuple(outs)


@dataclass
class ExplainResult:
    """Host-side view of an explained sweep (numpy arrays throughout).

    ``fits``/``binding``/``cpu_fit``/``mem_fit``/``slots`` are ``[S, N]``;
    ``totals`` is ``[S]``.  The snapshot rides along for the host-side
    analyses (marginals need the raw allocatable/used columns).
    """

    snapshot: ClusterSnapshot
    mode: str
    cpu_request_milli: np.ndarray  # [S] int64 carriers
    mem_request_bytes: np.ndarray  # [S]
    replicas: np.ndarray  # [S]
    fits: np.ndarray  # [S, N]
    binding: np.ndarray  # [S, N] int32 codes
    cpu_fit: np.ndarray  # [S, N]
    mem_fit: np.ndarray  # [S, N]
    slots: np.ndarray  # [S, N]
    node_mask: np.ndarray | None = field(default=None)

    @property
    def totals(self) -> np.ndarray:
        return self.fits.sum(axis=1)

    @property
    def size(self) -> int:
        return int(self.fits.shape[0])

    def binding_names(self, s: int = 0) -> list[str]:
        """Per-node attribution strings for scenario ``s``."""
        return [BINDING_NAMES[int(c)] for c in self.binding[s]]

    def binding_counts(self, s: int = 0) -> dict[str, int]:
        """``{constraint: node count}`` for scenario ``s`` (zero-count
        constraints included, so the dict shape is stable)."""
        codes, counts = np.unique(self.binding[s], return_counts=True)
        out = {name: 0 for name in BINDING_NAMES}
        for c, n in zip(codes, counts):
            out[BINDING_NAMES[int(c)]] = int(n)
        return out

    # -- headroom / saturation -------------------------------------------
    def headroom(self, s: int = 0) -> dict[str, np.ndarray]:
        """Per-node residual headroom AFTER placing scenario ``s``'s fit.

        ``cpu_milli``/``mem_bytes`` are ``head - fit * request`` (what is
        left once the reported replicas land); ``pod_slots`` the remaining
        schedulable pod slots.  Python-int arithmetic (object arrays are
        avoided by clamping to the sane domain): wrapped/degenerate rows
        report 0 residual rather than garbage.
        """
        snap = self.snapshot
        fit = self.fits[s]
        cr = int(self.cpu_request_milli[s]) % _U64
        mr = int(self.mem_request_bytes[s])
        n = snap.n_nodes
        cpu_res = np.zeros(n, dtype=np.int64)
        mem_res = np.zeros(n, dtype=np.int64)
        pod_res = np.zeros(n, dtype=np.int64)
        for i in range(n):
            f = max(int(fit[i]), 0)
            ch = (int(snap.alloc_cpu_milli[i]) % _U64) - (
                int(snap.used_cpu_req_milli[i]) % _U64
            )
            mh = int(snap.alloc_mem_bytes[i]) - int(
                snap.used_mem_req_bytes[i]
            )
            cpu_res[i] = max(min(ch - f * cr, np.iinfo(np.int64).max), 0)
            mem_res[i] = max(min(mh - f * mr, np.iinfo(np.int64).max), 0)
            pod_res[i] = max(
                int(snap.alloc_pods[i]) - int(snap.pods_count[i]) - f, 0
            )
        return {
            "cpu_milli": cpu_res,
            "mem_bytes": mem_res,
            "pod_slots": pod_res,
        }

    def saturation(self, s: int = 0) -> dict:
        """Cluster saturation summary for scenario ``s``: the binding
        histogram, zero-fit node count, and per-resource utilization
        quantiles over healthy nodes (display-grade floats — the fit
        itself never consumes them, exactly like the reference's
        percentages)."""
        snap = self.snapshot
        out = {
            "binding_counts": self.binding_counts(s),
            "zero_fit_nodes": int((self.fits[s] <= 0).sum()),
            "nodes": snap.n_nodes,
        }
        healthy = np.asarray(snap.healthy, dtype=bool)
        for name, used, alloc in (
            ("cpu_utilization", snap.used_cpu_req_milli, snap.alloc_cpu_milli),
            ("mem_utilization", snap.used_mem_req_bytes, snap.alloc_mem_bytes),
            ("pod_utilization", snap.pods_count, snap.alloc_pods),
        ):
            a = np.asarray(alloc, dtype=np.float64)
            u = np.asarray(used, dtype=np.float64)
            ok = healthy & (a > 0)
            if not ok.any():
                out[name] = None
                continue
            util = u[ok] / a[ok]
            out[name] = {
                "p50": round(float(np.percentile(util, 50)), 4),
                "p90": round(float(np.percentile(util, 90)), 4),
                "max": round(float(util.max()), 4),
                "saturated_nodes": int((util >= 1.0).sum()),
            }
        return out

    # -- marginal analysis -----------------------------------------------
    def marginal(
        self, s: int = 0, *, verify_limit: int | None = 32
    ) -> dict[str, dict | None]:
        """Smallest additional allocatable of each resource buying +1.

        For each resource R in (cpu, memory, pods): the minimal increment
        to ONE node's allocatable R that raises the cluster total by at
        least one replica, holding everything else fixed.  Candidates
        come from the monotone closed form (the exact increment that
        lifts that node's R-bound to ``fit+1``) and are accepted only
        after the full mode semantics — Q1 overwrite included — confirm
        the +1 by re-evaluating the node
        (:func:`..oracle.fit_arrays_python`); candidates the bug-
        compatible evaluator rejects are skipped.  ``verify_limit``
        bounds how many candidates are re-evaluated per resource
        (ascending delta; ``None`` = all).

        Returns ``{resource: {"delta": int, "node": str, "unit": str}}``
        with ``None`` for a resource no single-node increment can buy +1
        through.  Units: millicores, bytes, pod slots.
        """
        snap = self.snapshot
        mode = self.mode
        fit = self.fits[s]
        cpu_fit = self.cpu_fit[s]
        mem_fit = self.mem_fit[s]
        code = self.binding[s]
        cr_u = int(self.cpu_request_milli[s]) % _U64
        mr = int(self.mem_request_bytes[s])
        healthy = np.asarray(snap.healthy, dtype=bool)
        mask = (
            np.ones(snap.n_nodes, dtype=bool)
            if self.node_mask is None
            else np.asarray(self.node_mask, dtype=bool)
        )
        out: dict[str, dict | None] = {}
        for resource, unit in (
            ("cpu", "milli"),
            ("memory", "bytes"),
            ("pods", "slots"),
        ):
            candidates: list[tuple[int, int]] = []  # (delta, node index)
            for i in range(snap.n_nodes):
                if not healthy[i] or not mask[i]:
                    continue  # capacity cannot fix health or constraints
                if code[i] in (BINDING_UNHEALTHY, BINDING_MASKED):
                    continue
                d = self._candidate_delta(
                    resource, i, int(fit[i]) + 1,
                    int(cpu_fit[i]), int(mem_fit[i]), cr_u, mr, mode,
                )
                if d is not None and 0 < d <= _MAX_SANE_DELTA:
                    candidates.append((d, i))
            candidates.sort()
            chosen: dict | None = None
            limit = len(candidates) if verify_limit is None else verify_limit
            for d, i in candidates[:limit]:
                if self._verify_plus_one(resource, i, d, s):
                    chosen = {
                        "delta": int(d),
                        "node": snap.names[i],
                        "node_index": int(i),
                        "unit": unit,
                    }
                    break
            out[resource] = chosen
        return out

    def _candidate_delta(
        self, resource, i, target, cpu_fit_i, mem_fit_i, cr_u, mr, mode
    ) -> int | None:
        """Closed-form minimal increment lifting node ``i``'s R-bound to
        ``target`` replicas — the MONOTONE model's answer, which
        :meth:`_verify_plus_one` then checks against the full semantics.
        Python-int arithmetic throughout (no int64 overflow)."""
        snap = self.snapshot
        ap = int(snap.alloc_pods[i])
        pc = int(snap.pods_count[i])
        if resource == "cpu":
            if mem_fit_i < target:  # memory binds below target regardless
                return None
            head = (int(snap.alloc_cpu_milli[i]) % _U64) - (
                int(snap.used_cpu_req_milli[i]) % _U64
            )
            return target * cr_u - head
        if resource == "memory":
            if cpu_fit_i < target:
                return None
            head = int(snap.alloc_mem_bytes[i]) - int(
                snap.used_mem_req_bytes[i]
            )
            return target * mr - head
        # pods: strict compares remaining slots; reference only consults
        # alloc_pods through the Q1 overwrite, where raising it by 1 adds
        # one replica iff min(cpu_fit, mem_fit) still clears the new cap.
        if min(cpu_fit_i, mem_fit_i) < target:
            return None
        if mode == "strict":
            return target - max(ap - pc, 0)
        # Reference: the minimal useful increment is always 1 slot — the
        # overwrite writes ``alloc_pods - pods_count``, so +1 allocatable
        # is +1 replica exactly when the overwrite still fires at the new
        # cap (min(cpu_fit, mem_fit) >= ap + 1, checked above and then
        # confirmed by verification).
        return 1

    def _verify_plus_one(self, resource, i, delta, s) -> bool:
        """Re-evaluate node ``i`` with ``alloc_R + delta`` under the FULL
        mode semantics; True iff its fit strictly increases."""
        snap = self.snapshot
        ac = int(snap.alloc_cpu_milli[i])
        am = int(snap.alloc_mem_bytes[i])
        ap = int(snap.alloc_pods[i])
        if resource == "cpu":
            ac = ((ac % _U64) + delta) % _U64
            if ac >= 1 << 63:
                ac -= _U64  # back to the int64 carrier
        elif resource == "memory":
            am += delta
            if not (-(1 << 63) <= am < 1 << 63):
                return False
        else:
            ap += delta
        before = int(self.fits[s][i])
        after = fit_arrays_python(
            [ac], [am], [ap],
            [int(snap.used_cpu_req_milli[i])],
            [int(snap.used_mem_req_bytes[i])],
            [int(snap.pods_count[i])],
            int(self.cpu_request_milli[s]),
            int(self.mem_request_bytes[s]),
            mode=self.mode,
            healthy=[bool(snap.healthy[i])],
        )[0]
        return after > before


def binding_shift(
    old_counts: dict[str, int], new_counts: dict[str, int]
) -> dict[str, int]:
    """How a binding histogram MOVED between two explanations.

    ``{constraint: node-count delta}`` with zero-delta constraints
    omitted — the timeline's drift-attribution vocabulary ("binding
    constraint shifted memory→pods on 12 nodes" is ``{"memory": -12,
    "pods": +12}``).  Lives here because this module owns the binding
    taxonomy; the inputs are :meth:`ExplainResult.binding_counts` dicts
    from any two generations.
    """
    return {
        name: new_counts.get(name, 0) - old_counts.get(name, 0)
        for name in BINDING_NAMES
        if new_counts.get(name, 0) != old_counts.get(name, 0)
    }


def _dispatch(snapshot, grid, mode, node_mask, device, *, fused: bool,
              rows=None):
    """Stage the snapshot (or its node-shape groups) and the grid on
    ``device``, run :func:`explain_grid` — or, ``fused``, the sweep+explain
    program — and bring the outputs to the host: the leading ones (none,
    or totals and schedulable) whole, the five per-node ``[S, N]`` arrays
    only at the scenario indices ``rows`` when given.  Returns the leading
    outputs, the per-node arrays, and whether the groups served."""
    device = _devcache.resolve_device(device)
    cpu_reqs, mem_reqs, replicas = (
        _devcache.to_device(np.asarray(a, dtype=np.int64), device)
        for a in (grid.cpu_request_milli, grid.mem_request_bytes,
                  grid.replicas)
    )
    grouped = grouped_for_dispatch(snapshot)
    clk = _phases.current()
    if grouped is not None:
        # No mask inside the program: the mask is per NODE, so it folds
        # into the group counts for the totals and re-applies per node
        # after the group→node expansion below.
        cols = _devcache.CACHE.grouped_exact_tensors(grouped, device)
        counts = None
        if fused:
            counts = _devcache.to_device(
                grouped.effective_counts(node_mask), device
            )
        t0 = time.perf_counter()
        with clk.live("device_exec"):
            if fused:
                out = sweep_explain_grouped(
                    *cols, counts, cpu_reqs, mem_reqs, replicas, mode=mode
                )
            else:
                out = explain_grid(*cols, cpu_reqs, mem_reqs, mode=mode)
    else:
        cols = _devcache.CACHE.exact_tensors(snapshot, device)
        mask = None
        if node_mask is not None:
            mask = _devcache.to_device(
                np.asarray(node_mask, dtype=bool), device
            )
        t0 = time.perf_counter()
        with clk.live("device_exec"):
            if fused:
                out = sweep_explain_grid(
                    *cols, cpu_reqs, mem_reqs, replicas, mode=mode,
                    node_mask=mask,
                )
            else:
                out = explain_grid(
                    *cols, cpu_reqs, mem_reqs, mode=mode, node_mask=mask
                )
    per_node = out[-5:]
    if rows is not None:
        index = _devcache.to_device(np.asarray(rows, dtype=np.int64), device)
        per_node = [o.index_select(0, index) for o in per_node]
    tensors = (*out[:-5], *per_node)
    if fused:
        # The fused program is a dispatch of its own label (the JAX
        # package observes it the same way); a plain explain is not.
        label = "torch_int64_sweep_explain" + (
            "_grouped" if grouped is not None else ""
        )
        host = observed_fetch(label, t0, tensors)
    else:
        host = fetch(tensors)
    lead, per_node = list(host[:-5]), list(host[-5:])
    if grouped is not None:
        # Identical rows get identical attribution, so the expansion is
        # bit-exact; the mask is the same last-wins override the per-node
        # program gives it.
        per_node = [grouped.expand(a) for a in per_node]
        if node_mask is not None:
            mask_row = np.asarray(node_mask, dtype=bool)[None, :]
            code = per_node[1]
            per_node[0] = np.where(mask_row, per_node[0], 0)
            per_node[1] = np.where(
                mask_row, code, np.int32(BINDING_MASKED)
            ).astype(code.dtype)
    return lead, per_node, grouped is not None


def _result(snapshot, grid, mode, node_mask, per_node,
            rows=None) -> ExplainResult:
    fits, code, cpu_fit, mem_fit, slots = per_node
    take = slice(None) if rows is None else np.asarray(rows, dtype=np.int64)
    return ExplainResult(
        snapshot=snapshot,
        mode=mode,
        cpu_request_milli=np.asarray(grid.cpu_request_milli)[take],
        mem_request_bytes=np.asarray(grid.mem_request_bytes)[take],
        replicas=np.asarray(grid.replicas)[take],
        fits=fits,
        binding=code,
        cpu_fit=cpu_fit,
        mem_fit=mem_fit,
        slots=slots,
        node_mask=(
            None if node_mask is None else np.asarray(node_mask, dtype=bool)
        ),
    )


def explain_snapshot(
    snapshot: ClusterSnapshot,
    grid: ScenarioGrid,
    *,
    mode: str | None = None,
    node_mask=None,
    device="cuda",
) -> ExplainResult:
    """Explain a whole sweep: ``ClusterSnapshot`` × ``ScenarioGrid`` →
    :class:`ExplainResult` (numpy).  ``mode`` defaults to the snapshot's
    own packing semantics.  Degenerate fleets run the attribution over
    node-shape groups (:func:`.snapshot.grouped_for_dispatch`) and expand
    every ``[S, G]`` output back to ``[S, N]``; ``node_mask`` re-applies
    per node after the expansion.  ``device`` defaults to ``"cuda"`` and
    raises when no card is present."""
    mode = mode or snapshot.semantics
    grid.validate()
    _, per_node, _ = _dispatch(
        snapshot, grid, mode, node_mask, device, fused=False
    )
    return _result(snapshot, grid, mode, node_mask, per_node)


def sweep_explain_snapshot(
    snapshot: ClusterSnapshot,
    grid: ScenarioGrid,
    *,
    mode: str | None = None,
    node_mask=None,
    device="cuda",
    rows=None,
):
    """Fused sweep+explain: one device program answering both "how many
    fit" and "what binds" for every scenario.

    The totals are the attribution fits summed on the device
    (:func:`.ops.fit.sweep_explain_grid` / ``sweep_explain_grouped``), so
    they equal a solo exact sweep and the per-node outputs equal
    :func:`explain_snapshot`'s, in both modes, grouped or not.  The
    grouped route folds ``node_mask`` into the per-group counts for the
    totals and re-applies it per node after expansion.  Returns numpy
    ``(totals[S], schedulable[S], ExplainResult, kernel_name)``, the name
    ``torch_int64_sweep_explain`` or ``torch_int64_sweep_explain_grouped``.

    ``rows`` (scenario indices) restricts the :class:`ExplainResult` to
    those scenarios, in that order, and copies only their per-node rows
    to the host; the totals stay whole.  The device→host copy of the
    ``[S, N]`` outputs is most of this call at large S, and a caller that
    reads a few scenarios (the service's folded explain) pays for those.
    """
    mode = mode or snapshot.semantics
    grid.validate()
    (totals, schedulable), per_node, grouped = _dispatch(
        snapshot, grid, mode, node_mask, device, fused=True, rows=rows
    )
    kernel = "torch_int64_sweep_explain" + ("_grouped" if grouped else "")
    return (totals, schedulable,
            _result(snapshot, grid, mode, node_mask, per_node, rows),
            kernel)
