"""Replica packing as a certified linear program (LP/PDHG on the card).

Counterpart of ``kubernetesclustercapacity_tpu/optimize/lp.py``.  The
question is the sweep's — "how many replicas of this shape fit?" — but
answered by *optimization* instead of a first-fit walk, which buys two
things the walk cannot give:

* a **bound**: the LP optimum is an upper bound on ANY packing, so the
  gap between it and the integral packing is a measured distance from
  optimal, not a hope;
* **prices**: the LP's dual variables are per-resource shadow prices —
  "memory is the priced-out resource on 60% of capacity".

Formulation (over the (shape, count) node groups, so a 1M-node fleet is
~100s of variables; each node of group ``g`` contributes its clamped
headroom, count-weighted)::

    max  Σ_g x_g                              x_g = replicas on group g
    s.t. req_r · x_g  <=  count_g · head_{g,r}   ∀ g, r ∈ {cpu, mem, pods}
         Σ_g x_g      <=  demand                 (the demand row)
         x >= 0

Masks fold in exactly like the grouped sweep: ``node_mask`` and (in
strict mode) node health restrict the per-group counts; reference-mode
unhealthy nodes are already zero-capacity phantom rows.  Headrooms are
the *sane* clamped int64 view (``max(alloc - used, 0)``); where the
reference's uint64 quirks let the bug-compatible walk overshoot this
model, the result says so (``ffd_exceeds_bound``).

Solver: a diagonally-preconditioned primal-dual hybrid gradient (PDHG /
Chambolle–Pock) in f64 on ``device``, batched across the whole ``[S]``
scenario axis: :func:`_pdhg_chunk` runs 500 steps as eager elementwise
launches with no host sync inside a chunk, and the certificate is
re-checked on the host between chunks.  Groups and scenarios are padded
to powers of two exactly as in the JAX package (zero-capacity groups and
zero-demand scenarios are inert): the padded group width sets the
demand-row step ``sig / g``, so the padding is part of the iteration, not
a compile cache.  Every step size is a power of two (``sig = 16``,
``sig / g``, ``tau = 1/64``), so a fused multiply-add rounds as the
separate multiply and add do; iterates can still differ from the JAX
package's in their last bits through the order of the sums over groups.

Certification is **host-side numpy** (verbatim) and cannot lie:

* the reported primal is repaired to *exact* feasibility (clip to the
  per-group caps, scale into the demand row), so its value is a true
  achievable lower bound;
* the reported ``lp_bound`` is the *dual* objective after lifting the
  demand dual by the worst reduced-cost violation — dual-feasible by
  construction, hence a true upper bound by weak duality *regardless of
  solver state*;
* ``certified`` means the two meet within tolerance.

Integral answer: per-group per-node integer caps are exact int64 floor
division, the LP solution is floored and repaired to fill remaining
demand in group order — so the rounded *total* is closed-form
(``min(demand, Σ count·k)``) whatever the float path, while the
per-group split follows the LP.  ``verify_rounded_packing`` re-checks
feasibility against the sequential :func:`~..oracle.fit_arrays_python`.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from kubernetesclustercapacity_tpu_torch import devcache as _devcache
from kubernetesclustercapacity_tpu_torch.scenario import ScenarioGrid
from kubernetesclustercapacity_tpu_torch.snapshot import (
    ClusterSnapshot,
    grouped_for_dispatch,
)

__all__ = [
    "DEFAULT_MAX_ITERS",
    "DEFAULT_TOL",
    "OPT_RESOURCES",
    "OptimizeError",
    "OptimizeResult",
    "lp_bound_oracle",
    "opt_max_iters",
    "opt_tol",
    "optimize_snapshot",
    "verify_rounded_packing",
]

#: Constraint-row order of the LP (and of every per-resource report
#: field).  ``pods`` is the remaining-pod-slot row (request 1 per
#: replica, the strict-mode cap).
OPT_RESOURCES = ("cpu", "memory", "pods")

#: Iteration budget across all chunks (``KCCAP_OPT_ITERS`` overrides).
DEFAULT_MAX_ITERS = 20_000

#: Relative certificate tolerance (``KCCAP_OPT_TOL`` overrides): a
#: solve certifies when duality gap and feasibility residuals are all
#: within this fraction of the answer's scale.
DEFAULT_TOL = 1e-6

#: Iterations per jitted chunk — the certificate is re-checked between
#: chunks so an easy instance exits early and a hard one keeps going.
_CHUNK_ITERS = 500

_MAX_ITERS_CAP = 1 << 20
_EPS = 1e-300


class OptimizeError(ValueError):
    """Malformed optimize request (bad backend, bad knobs)."""


def opt_max_iters() -> int:
    """Process iteration budget (``KCCAP_OPT_ITERS``, else 20000).

    Read per solve (host-side only); junk or out-of-range values fall
    back to the default rather than failing a solve.
    """
    try:
        env = int(os.environ.get("KCCAP_OPT_ITERS", "0"))
    except ValueError:
        env = 0
    return env if _CHUNK_ITERS <= env <= _MAX_ITERS_CAP else DEFAULT_MAX_ITERS


def opt_tol() -> float:
    """Process certificate tolerance (``KCCAP_OPT_TOL``, else 1e-6)."""
    try:
        env = float(os.environ.get("KCCAP_OPT_TOL", "0"))
    except ValueError:
        env = 0.0
    return env if 0.0 < env <= 1e-2 else DEFAULT_TOL


def _pow2_at_least(n: int, floor: int) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def _pdhg_chunk(caps, demand, scale, x, lam, mu, *, iters: int):
    """``iters`` preconditioned PDHG steps, batched over scenarios.

    ``caps[S, G, R]`` are the per-group per-resource capacities in
    replica units, ``demand[S]`` the demand row, ``scale[S]`` the
    per-scenario normalization (≈ the LP optimum, so the normalized
    primal is O(1) and step sizes are shape-free).  State: primal
    ``x[S, G]`` (normalized units), duals ``lam[S, G, R]`` / ``mu[S]``
    (unit-free — valid across chunks, so warm restarts compose).  f64
    tensors on one device; about 17 elementwise launches a step and no
    host sync.
    """
    g = x.shape[1]
    r = caps.shape[2]
    caps_n = caps / scale[:, None, None]
    demand_n = demand / scale
    # Diagonal preconditioning: every constraint row touches one x_g
    # (resource rows) or all G (demand row); sigma·tau·row-norms < 1.
    # The dual step runs hot (16x) — the primal converges in a handful
    # of steps from the normalized start, the dual tail dominates.
    sig = 16.0
    tau = 1.0 / ((r + 1.0) * sig)
    sig_d = sig / g
    xbar = x
    for _ in range(iters):
        lam = torch.clamp_min(lam + sig * (xbar[:, :, None] - caps_n), 0.0)
        mu = torch.clamp_min(
            mu + sig_d * (torch.sum(xbar, dim=1) - demand_n), 0.0
        )
        reduced = torch.sum(lam, dim=2) + mu[:, None] - 1.0
        x_new = torch.clamp_min(x - tau * reduced, 0.0)
        xbar = 2.0 * x_new - x
        x = x_new
    return x, lam, mu


def _certify(caps, demand, x_n, lam, mu, scale, tol):
    """Host-side certificate — numpy f64, never traced, independent of
    whatever the device computed.

    The certificate covers what is REPORTED, not the raw iterate: the
    primal is first repaired to exact feasibility (clip into the
    per-group caps, scale into the demand row), the dual is lifted to
    exact dual feasibility (the demand dual absorbs the worst
    reduced-cost violation).  ``D`` then upper bounds the LP optimum by
    weak duality *regardless of solver state*, ``P`` lower bounds it,
    and ``certified`` means they meet within tolerance.

    Returns ``(x_feas[S, G], P, D, gap, primal_residual,
    dual_residual, mu_lift, certified)``.  ``primal_residual`` is the
    repaired solution's residual (≈ float rounding; part of the
    certificate), ``dual_residual`` the reduced-cost violation the
    lift absorbed (a solver-quality diagnostic — its cost is already
    priced into ``D``, and any repair loss widens ``gap`` itself, so
    nothing is hidden).
    """
    x = np.asarray(x_n, dtype=np.float64) * scale[:, None]
    u = caps.min(axis=2)  # [S, G] per-group box bound
    x_feas = np.clip(x, 0.0, u)
    tot = x_feas.sum(axis=1)
    shrink = np.where(
        tot > demand, demand / np.maximum(tot, _EPS), 1.0
    )
    x_feas = x_feas * shrink[:, None]
    primal = x_feas.sum(axis=1)
    scale1 = 1.0 + np.abs(scale)
    primal_res = (
        np.maximum(
            np.max(
                np.maximum(x_feas[:, :, None] - caps, 0.0),
                axis=(1, 2),
                initial=0.0,
            ),
            np.maximum(x_feas.sum(axis=1) - demand, 0.0),
        )
        / scale1
    )
    lam = np.asarray(lam, dtype=np.float64)
    mu = np.asarray(mu, dtype=np.float64)
    viol = np.maximum(1.0 - lam.sum(axis=2) - mu[:, None], 0.0)
    dual_res = np.max(viol, axis=1, initial=0.0)
    mu_lift = mu + dual_res
    dual = (lam * caps).sum(axis=(1, 2)) + mu_lift * demand
    gap = (dual - primal) / (1.0 + np.abs(dual) + np.abs(primal))
    certified = (gap <= tol) & (primal_res <= tol)
    return x_feas, primal, dual, gap, primal_res, dual_res, mu_lift, certified


def _packing_operands(
    snapshot: ClusterSnapshot, *, mode: str, node_mask=None
):
    """The LP's node-side data: ``(head[G, 3] i64, counts[G] i64,
    grouped | None)``.

    Grouping follows the sweep dispatch gate exactly
    (:func:`~..snapshot.grouped_for_dispatch`, so ``KCCAP_GROUPING=0``
    and the heterogeneity/floor gates behave identically); when the
    gate declines, every node is its own group (``counts`` of 0/1).
    Headrooms are clamped sane capacity — negative or wrapped carriers
    price as zero, never as 2^64 phantom headroom.  Eligibility
    (``node_mask``, strict-mode health) zeroes COUNTS, mirroring
    ``effective_counts``: a masked node contributes no capacity.
    """
    if mode not in ("reference", "strict"):
        raise ValueError(f"unknown mode {mode!r}")
    n = snapshot.n_nodes
    eligible = None
    if node_mask is not None:
        mask = np.asarray(node_mask, dtype=bool)
        if mask.shape != (n,):
            raise ValueError(
                f"node_mask: expected shape ({n},), got {mask.shape}"
            )
        eligible = mask
    if mode == "strict":
        healthy = np.asarray(snapshot.healthy, dtype=bool)
        eligible = healthy if eligible is None else (eligible & healthy)

    grouped = grouped_for_dispatch(snapshot)

    def head_of(alloc, used, pods=False):
        alloc = np.maximum(np.asarray(alloc, dtype=np.int64), 0)
        used = np.maximum(np.asarray(used, dtype=np.int64), 0)
        return np.where(alloc <= used, np.int64(0), alloc - used)

    if grouped is not None:
        head = np.stack(
            [
                head_of(grouped.alloc_cpu_milli, grouped.used_cpu_req_milli),
                head_of(grouped.alloc_mem_bytes, grouped.used_mem_req_bytes),
                head_of(grouped.alloc_pods, grouped.pods_count),
            ],
            axis=1,
        )
        counts = grouped.effective_counts(eligible)
        return head, counts, grouped
    head = np.stack(
        [
            head_of(snapshot.alloc_cpu_milli, snapshot.used_cpu_req_milli),
            head_of(snapshot.alloc_mem_bytes, snapshot.used_mem_req_bytes),
            head_of(snapshot.alloc_pods, snapshot.pods_count),
        ],
        axis=1,
    )
    counts = (
        np.ones(n, dtype=np.int64)
        if eligible is None
        else eligible.astype(np.int64)
    )
    return head, counts, None


def _req_matrix(grid: ScenarioGrid) -> np.ndarray:
    """``[S, 3]`` per-replica request in :data:`OPT_RESOURCES` order
    (pods row: one slot per replica).  A non-positive int64 request is
    a wrapped-uint64 carrier — the sane model cannot pack it, which
    the caps builder prices as zero capacity."""
    s = grid.size
    reqs = np.empty((s, 3), dtype=np.int64)
    reqs[:, 0] = np.asarray(grid.cpu_request_milli, dtype=np.int64)
    reqs[:, 1] = np.asarray(grid.mem_request_bytes, dtype=np.int64)
    reqs[:, 2] = 1
    return reqs


def _integer_caps(head: np.ndarray, reqs: np.ndarray) -> np.ndarray:
    """Per-node integral replica cap per group — ``[S, G]`` int64:
    ``min_r floor(head_gr / req_sr)`` with non-positive requests
    capping at zero (exact integer floor division, no floats)."""
    s, g = reqs.shape[0], head.shape[0]
    k = np.full((s, g), np.iinfo(np.int64).max, dtype=np.int64)
    for r in range(head.shape[1]):
        req = reqs[:, r]
        good = req > 0
        per = np.where(
            good[:, None],
            head[None, :, r] // np.maximum(req, 1)[:, None],
            np.int64(0),
        )
        k = np.minimum(k, per)
    return k


def _float_caps(head, counts, reqs) -> np.ndarray:
    """``caps[S, G, R]`` in f64 replica units: ``count_g·head_gr/req_r``
    (zero where the request is non-positive)."""
    head_f = head.astype(np.float64)
    counts_f = counts.astype(np.float64)
    reqs_f = reqs.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        caps = counts_f[None, :, None] * head_f[None, :, :] / reqs_f[:, None, :]
    return np.where(reqs_f[:, None, :] > 0, caps, 0.0)


def lp_bound_oracle(
    snapshot: ClusterSnapshot,
    grid: ScenarioGrid,
    *,
    mode: str | None = None,
    node_mask=None,
) -> np.ndarray:
    """The LP optimum in closed form — ``[S]`` f64.

    This structured LP's exact optimum is the demand-capped sum of
    per-group box bounds: ``min(demand, Σ_g min_r caps_gr)``.  The
    solver never consults it (it runs the generic primal-dual
    iteration); tests and bench use it as the independent ground truth
    the certificates must agree with.
    """
    mode = mode or snapshot.semantics
    head, counts, _ = _packing_operands(
        snapshot, mode=mode, node_mask=node_mask
    )
    caps = _float_caps(head, counts, _req_matrix(grid))
    u = caps.min(axis=2) if caps.shape[1] else np.zeros((grid.size, 0))
    demand = np.asarray(grid.replicas, dtype=np.int64).astype(np.float64)
    return np.minimum(demand, u.sum(axis=1))


@dataclass
class OptimizeResult:
    """One certified packing solve (numpy arrays, ``[S]`` leading).

    ``lp_bound`` is the *certified dual* upper bound (valid even when
    ``certified`` is False — then it is merely loose); ``rounded`` the
    integral packing after feasibility repair; ``ffd`` the
    bug-compatible first-fit baseline (the production fit path's
    placed count).  ``shadow`` carries the per-scenario dual story.
    """

    mode: str
    demand: np.ndarray  # [S] int64
    lp_bound: np.ndarray  # [S] f64 (certified dual bound)
    primal_value: np.ndarray  # [S] f64 (exact-feasible primal)
    rounded: np.ndarray  # [S] int64
    rounded_alloc: np.ndarray  # [S, G] int64 per-group integral packing
    ffd: np.ndarray  # [S] int64 — first-fit placed count
    ffd_totals: np.ndarray  # [S] int64 — raw fit-path totals
    certified: np.ndarray  # [S] bool
    duality_gap: np.ndarray  # [S] f64 (relative)
    primal_residual: np.ndarray  # [S] f64
    dual_residual: np.ndarray  # [S] f64
    shadow: list  # [S] dicts (shares / priced_out / demand_price)
    iterations: int
    tol: float
    solve_seconds: float
    groups: int
    nodes: int
    grouping_engaged: bool
    verified: np.ndarray | None = None  # [S] bool, when verify ran
    backend: str = "lp"
    group_index: np.ndarray | None = field(default=None, repr=False)

    @property
    def size(self) -> int:
        return int(self.demand.shape[0])

    @property
    def schedulable(self) -> np.ndarray:
        """Integral verdict: does the rounded packing meet demand?"""
        return self.rounded >= self.demand

    @property
    def all_certified(self) -> bool:
        return bool(np.all(self.certified))

    @property
    def gap_pct(self) -> np.ndarray:
        """LP-vs-integral optimality gap, percent of the bound."""
        return (
            (self.lp_bound - self.rounded.astype(np.float64))
            / np.maximum(self.lp_bound, 1.0)
            * 100.0
        )

    @property
    def ffd_exceeds_bound(self) -> np.ndarray:
        """True where the bug-compatible walk overshoots the certified
        bound — only reachable through reference quirks the sane model
        deliberately refuses to price: fits uncapped by pod slots
        (reference applies the slot cap only via the Q1 overwrite) and
        wrapped uint64 carriers read as huge headroom.  In strict mode
        this is always False (the strict walk obeys all three rows)."""
        return self.ffd.astype(np.float64) > self.lp_bound * (1.0 + self.tol)

    def to_wire(self) -> dict:
        return {
            "backend": self.backend,
            "mode": self.mode,
            "scenarios": self.size,
            "demand": self.demand.tolist(),
            "lp_bound": [round(float(v), 6) for v in self.lp_bound],
            "rounded": self.rounded.tolist(),
            "ffd": self.ffd.tolist(),
            "schedulable": [bool(v) for v in self.schedulable],
            "gap_pct": [round(float(v), 4) for v in self.gap_pct],
            "status": [
                "certified" if bool(c) else "uncertified"
                for c in self.certified
            ],
            "certified": self.all_certified,
            "duality_gap": [float(v) for v in self.duality_gap],
            "primal_residual": [float(v) for v in self.primal_residual],
            "dual_residual": [float(v) for v in self.dual_residual],
            "iterations": self.iterations,
            "tol": self.tol,
            "solve_seconds": round(self.solve_seconds, 6),
            "groups": self.groups,
            "nodes": self.nodes,
            "grouping_engaged": self.grouping_engaged,
            "shadow_prices": self.shadow,
            "ffd_exceeds_bound": [bool(v) for v in self.ffd_exceeds_bound],
            **(
                {"verified": [bool(v) for v in self.verified]}
                if self.verified is not None
                else {}
            ),
        }


def _shadow_report(lam, mu_lift, caps, counts, demand, tol) -> list:
    """Per-scenario dual story, wire-shaped.

    ``shares``: fraction of the dual bound's capacity mass priced on
    each resource row; ``priced_out``: count-weighted fraction of
    nodes whose binding (priced) resource is each name — "memory is
    the priced-out resource on 60% of capacity"; ``demand_price``: the
    demand row's dual (1 ⇒ one more replica of demand would not fit
    anyway — capacity-bound 0 ⇒ demand-bound); ``capacity_share``:
    fraction of the whole bound attributed to capacity rows (the
    admission controller's shed-by-shadow-price signal).
    """
    out = []
    counts_f = counts.astype(np.float64)
    total_nodes = counts_f.sum()
    for s in range(lam.shape[0]):
        mass_r = (lam[s] * caps[s]).sum(axis=0)  # [R]
        cap_mass = float(mass_r.sum())
        demand_mass = float(mu_lift[s] * demand[s])
        denom = cap_mass + demand_mass
        shares = {
            name: (float(mass_r[r]) / denom if denom > 0 else 0.0)
            for r, name in enumerate(OPT_RESOURCES)
        }
        row_max = lam[s].max(axis=1)  # [G]
        priced = row_max > tol
        frac = {}
        for r, name in enumerate(OPT_RESOURCES):
            sel = priced & (lam[s].argmax(axis=1) == r)
            frac[name] = (
                float(counts_f[sel].sum() / total_nodes)
                if total_nodes > 0
                else 0.0
            )
        out.append(
            {
                "shares": {k: round(v, 6) for k, v in shares.items()},
                "priced_out": {k: round(v, 6) for k, v in frac.items()},
                "demand_price": round(float(mu_lift[s]), 6),
                "capacity_share": round(
                    cap_mass / denom if denom > 0 else 0.0, 6
                ),
            }
        )
    return out


def _round_with_repair(x_feas, k_caps, counts, demand):
    """LP solution → integral packing — ``[S, G]`` int64.

    Floor the per-group LP mass (never above the group's exact integer
    capacity ``count_g · k_g``), then repair: fill remaining demand in
    ascending group order up to each group's integer capacity.  The
    repair makes the TOTAL closed-form (``min(demand, Σ count·k)``) —
    deterministic across hosts and float paths — while the per-group
    split follows the LP where it can.
    """
    cap_int = counts[None, :] * k_caps  # [S, G] int64
    y = np.minimum(np.floor(x_feas).astype(np.int64), cap_int)
    y = np.maximum(y, 0)
    deficit = np.asarray(demand, dtype=np.int64) - y.sum(axis=1)
    room = cap_int - y
    # Vectorized in-order fill: give group g min(room_g, deficit left
    # after groups < g) — a running-prefix formulation of the greedy.
    take_prefix = np.cumsum(room, axis=1)
    before = take_prefix - room
    add = np.clip(deficit[:, None] - before, 0, room)
    return y + add


def verify_rounded_packing(
    snapshot: ClusterSnapshot,
    grid: ScenarioGrid,
    result: "OptimizeResult",
    *,
    node_mask=None,
) -> np.ndarray:
    """Re-check the integral packing against the sequential oracle —
    ``[S]`` bool.

    For every scenario: distribute each group's replicas over its
    member nodes as evenly as possible and require each node's share
    to fit within :func:`~..oracle.fit_arrays_python`'s strict
    per-node capacity (phantom/unhealthy/masked rows must carry 0).
    Walks group *representatives*, so the check is O(G) oracle rows,
    not O(N).
    """
    from kubernetesclustercapacity_tpu_torch.oracle import fit_arrays_python

    head, counts, grouped = _packing_operands(
        snapshot, mode=result.mode, node_mask=node_mask
    )
    if grouped is not None:
        reps = grouped.representative
        alloc_cpu = snapshot.alloc_cpu_milli[reps]
        alloc_mem = snapshot.alloc_mem_bytes[reps]
        alloc_pods = snapshot.alloc_pods[reps]
        used_cpu = snapshot.used_cpu_req_milli[reps]
        used_mem = snapshot.used_mem_req_bytes[reps]
        pods_count = snapshot.pods_count[reps]
        healthy = snapshot.healthy[reps]
    else:
        alloc_cpu = snapshot.alloc_cpu_milli
        alloc_mem = snapshot.alloc_mem_bytes
        alloc_pods = snapshot.alloc_pods
        used_cpu = snapshot.used_cpu_req_milli
        used_mem = snapshot.used_mem_req_bytes
        pods_count = snapshot.pods_count
        healthy = snapshot.healthy
    reqs = _req_matrix(grid)
    ok = np.ones(result.size, dtype=bool)
    for s in range(result.size):
        if reqs[s, 0] <= 0 or reqs[s, 1] <= 0:
            # Wrapped carrier: the sane model packs nothing; feasible
            # iff the rounding agreed.
            ok[s] = bool((result.rounded_alloc[s] == 0).all())
            continue
        oracle = np.asarray(
            fit_arrays_python(
                alloc_cpu,
                alloc_mem,
                alloc_pods,
                used_cpu,
                used_mem,
                pods_count,
                int(reqs[s, 0]),
                int(reqs[s, 1]),
                mode="strict",
                healthy=healthy,
            ),
            dtype=np.int64,
        )
        alloc = result.rounded_alloc[s]
        used_any = alloc > 0
        # Even split over count_g members: the largest per-node share.
        share = np.zeros_like(alloc)
        nz = counts > 0
        share[nz] = -(-alloc[nz] // counts[nz])  # ceil div
        if (alloc[~nz] != 0).any():
            ok[s] = False
            continue
        ok[s] = bool(np.all(~used_any | (share <= oracle)))
    return ok


# --- telemetry funnel (host-side, registered lazily, switchable) -------
_OPT_MET: dict | None = None
_opt_met_lock = threading.Lock()


def _opt_metrics() -> dict:
    global _OPT_MET
    if _OPT_MET is None:
        with _opt_met_lock:
            if _OPT_MET is None:
                from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
                    REGISTRY,
                )

                _OPT_MET = {
                    "iterations": REGISTRY.gauge(
                        "kccap_opt_iterations",
                        "PDHG iterations the last optimize solve ran.",
                    ),
                    "gap": REGISTRY.gauge(
                        "kccap_opt_duality_gap",
                        "Worst relative duality gap of the last "
                        "optimize solve.",
                    ),
                    "seconds": REGISTRY.histogram(
                        "kccap_opt_solve_seconds",
                        "End-to-end optimize solve latency "
                        "(formulation + iterations + certification).",
                    ),
                    "certified": REGISTRY.counter(
                        "kccap_opt_certified_total",
                        "Optimize solves by certificate outcome.",
                        ("status",),
                    ),
                }
    return _OPT_MET


def _publish_opt_metrics(result: "OptimizeResult") -> None:
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
        enabled as _telemetry_enabled,
    )

    if not _telemetry_enabled():
        return
    try:
        met = _opt_metrics()
        met["iterations"].set(result.iterations)
        met["gap"].set(float(np.max(result.duality_gap, initial=0.0)))
        met["seconds"].observe(result.solve_seconds)
        met["certified"].labels(
            status="certified" if result.all_certified else "uncertified"
        ).inc()
    except Exception:  # noqa: BLE001 - observability never fails a solve
        pass


def optimize_snapshot(
    snapshot: ClusterSnapshot,
    grid: ScenarioGrid,
    *,
    mode: str | None = None,
    node_mask=None,
    max_iters: int | None = None,
    tol: float | None = None,
    verify: bool = True,
    device="cuda",
) -> OptimizeResult:
    """Solve the packing LP for every grid scenario, certified.

    One warm-started chunked PDHG run on ``device``; the certificate is
    re-checked host-side between chunks so the solver stops as soon as
    every scenario certifies.  The FFD baseline rides the production
    fit path (:func:`~..ops.fit.sweep_snapshot` on the same device), so
    the comparison is against what the service actually serves.
    ``device`` defaults to ``"cuda"`` and raises when no card is present.
    """
    from kubernetesclustercapacity_tpu_torch.ops.fit import sweep_snapshot
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
        enabled as _telemetry_enabled,
    )

    mode = mode or snapshot.semantics
    grid.validate()
    dev = _devcache.resolve_device(device)
    max_iters = opt_max_iters() if max_iters is None else int(max_iters)
    if not 1 <= max_iters <= _MAX_ITERS_CAP:
        raise OptimizeError(
            f"max_iters must be in [1, {_MAX_ITERS_CAP}], got {max_iters}"
        )
    tol = opt_tol() if tol is None else float(tol)
    if not 0.0 < tol <= 1e-2:
        raise OptimizeError(f"tol must be in (0, 1e-2], got {tol}")

    t0 = time.perf_counter()
    head, counts, grouped = _packing_operands(
        snapshot, mode=mode, node_mask=node_mask
    )
    reqs = _req_matrix(grid)
    demand = np.asarray(grid.replicas, dtype=np.int64)
    demand_f = np.maximum(demand, 0).astype(np.float64)
    s, g = grid.size, head.shape[0]

    caps = _float_caps(head, counts, reqs)  # [S, G, R]
    u = caps.min(axis=2) if g else np.zeros((s, 0))
    scale = np.maximum(1.0, np.minimum(demand_f, u.sum(axis=1)))

    # Pad groups and scenarios up the JAX package's pow2 ladder
    # (zero-capacity groups and zero-demand probe scenarios are inert):
    # the padded group width sets the demand-row step, so the iterates,
    # the iteration count and the certificates follow it.
    gb = _pow2_at_least(max(g, 1), 8)
    sb = _pow2_at_least(max(s, 1), 8)
    caps_p = np.zeros((sb, gb, len(OPT_RESOURCES)), dtype=np.float64)
    caps_p[:s, :g] = caps
    demand_p = np.zeros(sb, dtype=np.float64)
    demand_p[:s] = demand_f
    scale_p = np.ones(sb, dtype=np.float64)
    scale_p[:s] = scale

    caps_t = _devcache.to_device(caps_p, dev)
    demand_t = _devcache.to_device(demand_p, dev)
    scale_t = _devcache.to_device(scale_p, dev)
    x = torch.zeros((sb, gb), dtype=torch.float64, device=dev)
    lam = torch.zeros((sb, gb, len(OPT_RESOURCES)), dtype=torch.float64,
                      device=dev)
    mu = torch.zeros(sb, dtype=torch.float64, device=dev)

    iterations = 0
    cert = None
    lam_h = None
    t_solve = time.perf_counter()
    while iterations < max_iters:
        chunk = min(_CHUNK_ITERS, max_iters - iterations)
        x, lam, mu = _pdhg_chunk(
            caps_t, demand_t, scale_t, x, lam, mu, iters=chunk
        )
        iterations += chunk
        lam_h = lam[:s, :g].cpu().numpy()
        cert = _certify(
            caps,
            demand_f,
            x[:s, :g].cpu().numpy(),
            lam_h,
            mu[:s].cpu().numpy(),
            scale,
            tol,
        )
        if bool(np.all(cert[7])):
            break
    solve_s = time.perf_counter() - t_solve
    (
        x_feas,
        primal,
        dual,
        gap,
        primal_res,
        dual_res,
        mu_lift,
        certified,
    ) = cert

    if _telemetry_enabled():
        from kubernetesclustercapacity_tpu_torch.telemetry.compilewatch import (
            observe_dispatch,
        )

        observe_dispatch("opt_pdhg", solve_s)

    # Integral rounding + repair (exact int64 throughout).
    k_caps = _integer_caps(head, reqs)  # [S, G]
    rounded_alloc = _round_with_repair(x_feas, k_caps, counts, demand)
    rounded = rounded_alloc.sum(axis=1)

    # The bug-compatible baseline: the production fit path's totals,
    # capped into a placed count (a packer cannot place a negative or
    # beyond-demand fit).
    ffd_totals, _ = sweep_snapshot(
        snapshot, grid, mode=mode, node_mask=node_mask, device=dev
    )[:2]
    ffd_totals = np.asarray(ffd_totals, dtype=np.int64)
    ffd = np.clip(ffd_totals, 0, demand)

    result = OptimizeResult(
        mode=mode,
        demand=demand,
        lp_bound=dual,
        primal_value=primal,
        rounded=rounded,
        rounded_alloc=rounded_alloc,
        ffd=ffd,
        ffd_totals=ffd_totals,
        certified=certified,
        duality_gap=gap,
        primal_residual=primal_res,
        dual_residual=dual_res,
        shadow=_shadow_report(lam_h, mu_lift, caps, counts, demand_f, tol),
        iterations=iterations,
        tol=tol,
        solve_seconds=time.perf_counter() - t0,
        groups=g,
        nodes=snapshot.n_nodes,
        grouping_engaged=grouped is not None,
        group_index=None if grouped is None else grouped.group_index,
    )
    if verify:
        result.verified = verify_rounded_packing(
            snapshot, grid, result, node_mask=node_mask
        )
    _publish_opt_metrics(result)
    return result
