"""Replica placement simulator — a sequential scheduler on the device.

Counterpart of ``kubernetesclustercapacity_tpu/ops/placement.py``.  The
reference (and the fit programs) answer *how many* replicas fit by treating
nodes independently (``ClusterCapacity.go:105-140``); a real scheduler
answers *where each replica lands*, and every placement changes the
feasibility of the next.  The JAX package writes that dependence as a
``lax.scan``; here each scan is a Python loop of branchless
score→argmin→subtract steps over ``[N]`` tensors on the caller's device.
A step never reads a value back to the host: the chosen node and its
``ok`` flag stay one-element tensors, state updates go through
``index_add_``/``index_copy_`` and choices through ``torch.where``, so one
copy at the end brings the assignments home.

Policies (the classic bin-packing family):

* ``first-fit``  — lowest-index feasible node;
* ``best-fit``   — the feasible node left with the LEAST normalized
  headroom after placement (packs tightly, frees whole nodes);
* ``spread``     — the feasible node left with the MOST normalized
  headroom (worst-fit; balances load like ``LeastAllocated`` scoring).

Ties go to the lowest index: ``torch.argmin`` returns the first minimum,
as ``jnp.argmin`` does.  The score is f64 and only orders nodes: an int64
subtract, a guarded divide per resource row and a left-to-right sum, the
same sequence in every engine, so the device scans, the closed-form host
engines (``*_bulk``, ``*_trace``) and the sequential ground truths
(``*_python``) agree bit for bit.

Invariant: for identical replicas every work-conserving greedy policy
places exactly ``min(R, sum(strict per-node fits))`` — the order differs,
the capacity does not.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetesclustercapacity_tpu_torch import devcache as _devcache

__all__ = [
    "place_replicas",
    "place_replicas_bulk",
    "place_replicas_trace",
    "place_replicas_python",
    "place_pods",
    "place_pods_python",
    "place_pods_multi",
    "place_pods_multi_python",
    "place_replicas_spread",
    "place_replicas_multi",
    "place_replicas_bulk_multi",
    "place_replicas_trace_multi",
    "place_replicas_multi_python",
    "POLICIES",
]

POLICIES = ("first-fit", "best-fit", "spread")

_INF = float("inf")


def _check(policy: str, n_replicas: int) -> None:
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r} (want one of {POLICIES})")
    if n_replicas < 0:
        raise ValueError("n_replicas must be >= 0")


def _eligible(put, healthy, node_mask):
    eligible = put(healthy, torch.bool)
    if node_mask is not None:
        eligible = eligible & put(node_mask, torch.bool)
    return eligible


def _normalized_headroom(hc, hm, alloc_cpu, alloc_mem):
    """Score in [0, 2]: how empty a node would remain (f64 for ordering
    only — never feeds back into the integer feasibility state)."""
    def safe(num, den):
        return torch.where(
            den > 0, num.to(torch.float64) / den.to(torch.float64), 0.0
        )

    return safe(hc, alloc_cpu) + safe(hm, alloc_mem)


def _row_score(h, alloc_rn, sub) -> torch.Tensor:
    """The R-row score: per row ``(h - sub) / alloc`` where ``alloc > 0``,
    folded left to right from 0.0 in the caller's row order (never
    ``.sum(dim=0)``, whose reduction order is not left to right on the
    card).  ``h``/``alloc_rn`` are ``[R, ...]``; ``sub`` is per row."""
    acc = torch.zeros(h.shape[1:], dtype=torch.float64, device=h.device)
    for r in range(alloc_rn.shape[0]):
        acc = acc + torch.where(
            alloc_rn[r] > 0,
            (h[r] - sub[r]).to(torch.float64)
            / alloc_rn[r].to(torch.float64),
            0.0,
        )
    return acc


def _signed(policy: str, after: torch.Tensor) -> torch.Tensor:
    return after if policy == "best-fit" else -after


def _assemble_trace(counts, placed, n_replicas, policy, score0, key_of):
    """Per-replica assignment sequence from closed-form counts — the
    shared skeleton of both trace engines.

    ``score0`` is the [N] initial after-placement score (ignored for
    first-fit); ``key_of(i_arr, t_arr)`` computes the spread multiset
    keys.  The order arguments live in :func:`place_replicas_trace`'s
    docstring; this helper only assembles.
    """
    r = int(n_replicas)
    assignments = np.full(r, -1, dtype=np.int64)
    if placed == 0:
        return assignments
    idx = np.arange(counts.shape[0])
    if policy in ("first-fit", "best-fit"):
        order = idx if policy == "first-fit" else np.lexsort((idx, score0))
        order = order[counts[order] > 0]
        assignments[:placed] = np.repeat(order, counts[order])
        return assignments
    # spread: expand each placed node's (i, t) elements and sort by
    # (key desc, node index asc, t asc).
    i_arr = np.repeat(idx, counts)
    ends = np.cumsum(counts)
    t_arr = np.arange(placed) - np.repeat(ends - counts, counts)
    key = key_of(i_arr, t_arr)
    order = np.lexsort((t_arr, i_arr, -key))
    assignments[:placed] = i_arr[order]
    return assignments


def _np_score_after_multi(h0, alloc_rn, reqs, sel, j):
    """R-row left-fold ``score_after(j)`` for the selected node columns.

    The ONE definition of the host-side R-resource score math (the
    analog of :func:`_np_score_after` for the multi family): the bulk
    engine's order/waterline search and the trace engine's keys both
    call it, so their f64 values are bit-identical — same per-row
    guarded divide, same left-to-right fold order as the scan's
    ``score_of``.  ``sel`` is an index array of node columns; ``j``
    broadcasts against it.
    """
    j1 = np.asarray(j, dtype=np.int64) + 1
    sel = np.asarray(sel)
    acc = np.zeros(np.broadcast(sel, j1).shape, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        for r in range(alloc_rn.shape[0]):
            sub = int(reqs[r]) if reqs[r] > 0 else 0
            acc = acc + np.where(
                alloc_rn[r, sel] > 0,
                (h0[r, sel] - j1 * sub).astype(np.float64)
                / alloc_rn[r, sel].astype(np.float64),
                0.0,
            )
    return acc


def _np_score_after(hc0, hm0, ac, am, c, m, j):
    """``score_after(j)`` — the f64 score after the ``j``-th placement —
    in numpy, elementwise over broadcastable inputs.

    The ONE definition of the host-side score math: the bulk engine's
    order/waterline search and the trace engine's keys both call it, so
    their f64 values are bit-identical to each other (and to the scan's
    ``_normalized_headroom`` epilogue: same int64 headroom subtract, two
    guarded divides, left-to-right sum)."""
    j1 = np.asarray(j, dtype=np.int64) + 1
    num_c = (hc0 - j1 * c).astype(np.float64)
    num_m = (hm0 - j1 * m).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        sc = np.where(ac > 0, num_c / ac.astype(np.float64), 0.0)
        sm = np.where(am > 0, num_m / am.astype(np.float64), 0.0)
    return sc + sm



def place_replicas(
    alloc_cpu,
    alloc_mem,
    alloc_pods,
    used_cpu,
    used_mem,
    pods_count,
    healthy,
    cpu_req,
    mem_req,
    *,
    n_replicas: int,
    policy: str = "first-fit",
    node_mask=None,
    max_per_node: int | None = None,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Greedily place ``n_replicas`` identical pods, one step each, on
    ``device``.

    Feasibility is the strict fit's: integer headroom ``alloc - used >=
    request`` per resource, one free pod slot, healthy, and (optionally)
    an external constraint ``node_mask``.  Returns numpy
    ``(assignments[n_replicas], per_node_counts[N])``; an assignment of
    ``-1`` means that replica found no node (all later ones of a full
    cluster are ``-1`` too — the state stops changing).  ``max_per_node``
    caps how many of THESE replicas one node may take.

    Incremental score: each step changes ONE node's state, so the
    pre-masked ``[N]`` score vector (``+inf`` on infeasible lanes) is
    carried and only the placed lane is recomputed — with the same
    operations the vector form runs, so the result is bit-identical to a
    full recompute.
    """
    _check(policy, n_replicas)
    # kccap: lint-ok[device-purity] staging: resolve the device and upload the columns once, before the step loop
    dev, put = _devcache.int64_putter(device)
    alloc_cpu, alloc_mem = put(alloc_cpu), put(alloc_mem)
    c, m = int(cpu_req), int(mem_req)
    eligible = _eligible(put, healthy, node_mask)
    hc = alloc_cpu - put(used_cpu)
    hm = alloc_mem - put(used_mem)
    slots = torch.clamp_min(put(alloc_pods) - put(pods_count), 0)
    n = hc.shape[0]

    feasible = (hc >= c) & (hm >= m) & (slots >= 1) & eligible
    if max_per_node is not None and max_per_node <= 0:
        feasible = torch.zeros_like(feasible)  # no node takes even one
    if policy == "first-fit":
        score = torch.arange(n, device=dev, dtype=torch.float64)
    else:
        score = _signed(
            policy, _normalized_headroom(hc - c, hm - m, alloc_cpu, alloc_mem)
        )
    masked = torch.where(feasible, score, _INF)
    mine = torch.zeros(n, dtype=torch.int64, device=dev)
    out = torch.full((n_replicas,), -1, dtype=torch.int64, device=dev)
    for step in range(n_replicas):
        idx = torch.argmin(masked).view(1)
        val = masked.index_select(0, idx)
        ok = torch.isfinite(val)
        one = ok.to(torch.int64)
        hc.index_add_(0, idx, -(one * c))
        hm.index_add_(0, idx, -(one * m))
        slots.index_add_(0, idx, -one)
        mine.index_add_(0, idx, one)
        # Re-feasibility and re-score of the single updated lane.
        hc_i, hm_i = hc.index_select(0, idx), hm.index_select(0, idx)
        feas_i = (
            (hc_i >= c) & (hm_i >= m)
            & (slots.index_select(0, idx) >= 1)
            & eligible.index_select(0, idx)
        )
        if max_per_node is not None:
            feas_i = feas_i & (mine.index_select(0, idx) < max_per_node)
        if policy == "first-fit":
            lane = idx.to(torch.float64)
        else:
            lane = _signed(policy, _normalized_headroom(
                hc_i - c, hm_i - m,
                alloc_cpu.index_select(0, idx),
                alloc_mem.index_select(0, idx),
            ))
        new_val = torch.where(feas_i, lane, _INF)
        masked.index_copy_(0, idx, torch.where(ok, new_val, val))
        out[step:step + 1] = torch.where(ok, idx, -1)
    return out.cpu().numpy(), mine.cpu().numpy()


def place_replicas_bulk(
    alloc_cpu,
    alloc_mem,
    alloc_pods,
    used_cpu,
    used_mem,
    pods_count,
    healthy,
    cpu_req: int,
    mem_req: int,
    *,
    n_replicas: int,
    policy: str = "first-fit",
    node_mask=None,
    max_per_node: int | None = None,
) -> tuple[np.ndarray, int]:
    """Closed-form placement plan for R identical replicas — no scan.

    Returns ``(counts[N], placed)``: exactly the per-node replica counts
    the :func:`place_replicas` R-step greedy scan produces, computed with
    O(N) vector math instead of R sequential argmin steps.

    Why a closed form exists — for IDENTICAL pods each policy's greedy
    trajectory collapses:

    * ``first-fit`` fills nodes to capacity in index order (placing on a
      node never makes it preferable to skip);
    * ``best-fit`` picks the feasible node with minimum after-placement
      headroom; placing there only LOWERS its score, so the filling
      node's trajectory stays strictly below every other node's untouched
      initial score and can never cross one — it stays the argmin until
      exhausted → fill-to-capacity in ascending initial-score order
      (ties: lowest index, like the scan's ``argmin``).  This holds in
      f64 too: each score is ``fl(fl(a) + fl(b))`` of monotone terms, and
      ``fl`` is monotone, so rounding can flatten a step into a plateau
      but never invert the order; a plateau tied with an equal-initial-
      score node still resolves to the lowest index on both sides.
      Counts therefore match the scan in ALL cases;
    * ``spread`` picks the maximum; placing there lowers the node's score,
      so the greedy walk is a k-way head merge of per-node monotone
      non-increasing score sequences — i.e. the global top-R elements of
      the multiset ``{score_i(j) : j < cap_i}`` (water-filling).  The
      R-th value is found by bisection on the float64 bit lattice with
      EXACT per-node binary-search counting (the same f64 scores the scan
      compares — see ``count_ge``), and boundary ties at the waterline
      are distributed in the scan's order (lowest index first, each
      node's plateau exhausted before the next), so spread counts match
      the scan in ALL cases.

    Exactness is pinned against the scan by
    ``tests/test_torch_placement.py`` — randomized snapshots plus tie
    grids (identical nodes force exact f64 score collisions), all
    policies, R swept through the boundaries.

    The per-replica assignment ORDER (which the scan also returns) is
    policy-defined given the counts: index order for first-fit, score
    order for best-fit, round-robin-by-score for spread; callers who need
    the order at small R keep using :func:`place_replicas`.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r} (want one of {POLICIES})")
    if int(n_replicas) < 0:
        raise ValueError("n_replicas must be >= 0")
    ac = np.asarray(alloc_cpu, dtype=np.int64)
    am = np.asarray(alloc_mem, dtype=np.int64)
    c, m = int(cpu_req), int(mem_req)
    if c <= 0 or m <= 0:
        raise ValueError("cpu_req and mem_req must be > 0")
    hc0 = ac - np.asarray(used_cpu, dtype=np.int64)
    hm0 = am - np.asarray(used_mem, dtype=np.int64)
    slots = np.maximum(
        np.asarray(alloc_pods, dtype=np.int64)
        - np.asarray(pods_count, dtype=np.int64),
        0,
    )
    eligible = np.asarray(healthy, dtype=bool)
    if node_mask is not None:
        eligible = eligible & np.asarray(node_mask, dtype=bool)

    # Per-node capacity for THESE replicas (the scan's feasibility checks,
    # integrated over its whole trajectory).
    caps = np.minimum(
        np.where(hc0 >= c, hc0 // c, 0), np.where(hm0 >= m, hm0 // m, 0)
    )
    caps = np.minimum(caps, slots)
    if max_per_node is not None:
        caps = np.minimum(caps, int(max_per_node))
    caps = np.where(eligible, np.maximum(caps, 0), 0)

    total = int(caps.sum())
    r = int(n_replicas)
    if r <= 0:
        return np.zeros_like(caps), 0
    if r >= total:
        return caps.copy(), total

    def fill_in_order(order: np.ndarray) -> np.ndarray:
        k = caps[order]
        before = np.concatenate(([0], np.cumsum(k)[:-1]))
        got = np.clip(r - before, 0, k)
        counts = np.zeros_like(caps)
        counts[order] = got
        return counts

    if policy == "first-fit":
        return fill_in_order(np.arange(caps.shape[0])), r

    def score_after(j):
        """Score after the ``j``-th placement on each node — bit-identical
        to the scan step's ``_normalized_headroom(hc - c, hm - m, ...)``
        when the node has already taken ``j`` replicas.  ``j`` may be a
        scalar or an ``[N]`` array.  Shared with the trace engine via
        :func:`_np_score_after`."""
        return _np_score_after(hc0, hm0, ac, am, c, m, j)

    if policy == "best-fit":
        s0 = score_after(0)
        # Ascending initial score, node index breaking ties (argmin rule).
        order = np.lexsort((np.arange(caps.shape[0]), s0))
        order = order[caps[order] > 0]
        return fill_in_order(order), r

    # --- spread: top-R of the union of per-node decreasing sequences.
    feas = caps > 0
    if not feas.any():
        return np.zeros_like(caps), 0

    def count_ge(theta: float) -> tuple[np.ndarray, int]:
        """Per-node count of sequence elements with score >= theta — EXACT.

        Each node's score sequence is monotone non-increasing in ``j``
        (exact-math strictly decreasing; f64 rounding can only flatten
        steps into plateaus, never invert them, because ``fl`` and the
        two-term sum are monotone), so the count is the first ``j`` with
        ``score < theta``.  Found by a vectorized per-node binary search
        that evaluates the SAME f64 scores the scan compares — no
        float-algebra estimate, no correction window, no error bound to
        argue about.  O(N log max_cap).
        """
        lo = np.zeros_like(caps)
        hi = caps.copy()  # count lives in [0, caps]
        while True:
            active = lo < hi
            if not active.any():
                break
            mid = (lo + hi) // 2
            ge = score_after(mid) >= theta
            lo = np.where(active & ge, mid + 1, lo)
            hi = np.where(active & ~ge, mid, hi)
        cnt = np.where(feas, lo, 0)
        return cnt, int(cnt.sum())

    # Bisect theta on the ordered-int64 view of f64 (monotone encoding):
    # after ~64 halvings lo/hi are adjacent floats and lo is exactly the
    # R-th largest score in the multiset.
    def f2i(x: float) -> int:
        bits = np.float64(x).view(np.int64)
        return int(bits if bits >= 0 else (-(1 << 63)) - bits - 1)

    def i2f(i: int) -> float:
        bits = i if i >= 0 else (-(1 << 63)) - i - 1
        return float(np.int64(bits).view(np.float64))

    smax = float(score_after(0)[feas].max())
    smin = float(score_after(np.maximum(caps - 1, 0))[feas].min())
    lo_i, hi_i = f2i(smin), f2i(smax) + 1
    # invariant: count_ge(i2f(lo_i)) >= r, count_ge(i2f(hi_i)) < r
    while hi_i - lo_i > 1:
        mid = (lo_i + hi_i) // 2
        if count_ge(i2f(mid))[1] >= r:
            lo_i = mid
        else:
            hi_i = mid
    theta = i2f(lo_i)
    base, n_ge = count_ge(theta)
    strict, n_gt = count_ge(i2f(lo_i + 1))
    # Elements strictly above theta all place.  The ``r - n_gt`` remaining
    # go to elements EQUAL to theta in the scan's order: argmin breaks the
    # cross-node tie by lowest index, and after a node takes one
    # theta-element its next element is <= theta — if it EQUALS theta
    # (an f64 plateau) argmin stays on that same lowest index.  So the
    # scan exhausts each node's theta-plateau fully before moving to the
    # next node, in index order — exactly a cumsum fill over the per-node
    # plateau lengths ``base - strict``.
    at = base - strict  # elements == theta per node (plateaus can be > 1)
    before = np.concatenate(([0], np.cumsum(at)[:-1]))
    take = np.clip(r - n_gt - before, 0, at)
    return strict + take, r


def place_replicas_trace(
    alloc_cpu,
    alloc_mem,
    alloc_pods,
    used_cpu,
    used_mem,
    pods_count,
    healthy,
    cpu_req: int,
    mem_req: int,
    *,
    n_replicas: int,
    policy: str = "first-fit",
    node_mask=None,
    max_per_node: int | None = None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Closed-form per-replica assignment SEQUENCE — the scan's full trace
    without the scan.

    Returns ``(assignments[n_replicas], counts[N], placed)`` where
    ``assignments`` is element-for-element what :func:`place_replicas`
    emits (``-1`` once nothing fits).  :func:`place_replicas_bulk` proves
    the per-node counts collapse to closed form for identical replicas;
    the placement ORDER collapses too:

    * ``first-fit`` / ``best-fit``: the greedy argmin stays on the filling
      node until exhausted (the bulk engine's trajectory argument), so the
      trace is each fill-order node's index repeated ``counts`` times;
    * ``spread``: the greedy walk is a k-way head merge of per-node
      non-increasing key sequences (``key(i, t) = score_after(t)`` for the
      ``t+1``-th placement on node ``i``), so the trace is the placed
      multiset sorted by (key desc, node index asc, t asc) — ties resolve
      to the lowest index with that node's plateau exhausted first,
      exactly the scan's ``argmin`` rule.

    O(R log R) host math; exactness is pinned against the scan by
    ``tests/test_torch_placement.py`` (all policies, tie grids, boundary
    R).  Use this (or :func:`place_replicas_bulk` when only counts
    matter) for identical replicas; the device scan is R dependent steps.
    """
    counts, placed = place_replicas_bulk(
        alloc_cpu, alloc_mem, alloc_pods, used_cpu, used_mem, pods_count,
        healthy, cpu_req, mem_req, n_replicas=n_replicas, policy=policy,
        node_mask=node_mask, max_per_node=max_per_node,
    )
    ac = np.asarray(alloc_cpu, dtype=np.int64)
    am = np.asarray(alloc_mem, dtype=np.int64)
    hc0 = ac - np.asarray(used_cpu, dtype=np.int64)
    hm0 = am - np.asarray(used_mem, dtype=np.int64)
    c, m = int(cpu_req), int(mem_req)
    score0 = (
        _np_score_after(hc0, hm0, ac, am, c, m, 0)
        if policy == "best-fit"
        else None
    )
    assignments = _assemble_trace(
        counts, placed, n_replicas, policy, score0,
        lambda i_arr, t_arr: _np_score_after(
            hc0[i_arr], hm0[i_arr], ac[i_arr], am[i_arr], c, m, t_arr
        ),
    )
    return assignments, counts, placed


def place_replicas_python(
    alloc_cpu,
    alloc_mem,
    alloc_pods,
    used_cpu,
    used_mem,
    pods_count,
    healthy,
    cpu_req: int,
    mem_req: int,
    *,
    n_replicas: int,
    policy: str = "first-fit",
    node_mask=None,
    max_per_node: int | None = None,
) -> tuple[list[int], list[int]]:
    """Sequential ground truth for :func:`place_replicas` (same tie rules:
    the lowest index among equal scores, as the scan's ``torch.argmin``
    does)."""
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}")
    n = len(alloc_cpu)
    hc = [int(a) - int(u) for a, u in zip(alloc_cpu, used_cpu)]
    hm = [int(a) - int(u) for a, u in zip(alloc_mem, used_mem)]
    slots = [max(int(a) - int(p), 0) for a, p in zip(alloc_pods, pods_count)]
    eligible = [
        bool(healthy[i]) and (node_mask is None or bool(node_mask[i]))
        for i in range(n)
    ]
    assignments: list[int] = []
    counts = [0] * n
    for _ in range(n_replicas):
        best, best_score = -1, None
        for i in range(n):
            if not (
                eligible[i]
                and hc[i] >= cpu_req
                and hm[i] >= mem_req
                and slots[i] >= 1
                and (max_per_node is None or counts[i] < max_per_node)
            ):
                continue
            if policy == "first-fit":
                score = float(i)
            else:
                after = 0.0
                if alloc_cpu[i] > 0:
                    after += (hc[i] - cpu_req) / float(alloc_cpu[i])
                if alloc_mem[i] > 0:
                    after += (hm[i] - mem_req) / float(alloc_mem[i])
                score = after if policy == "best-fit" else -after
            if best_score is None or score < best_score:
                best, best_score = i, score
        if best < 0:
            assignments.append(-1)
            continue
        hc[best] -= cpu_req
        hm[best] -= mem_req
        slots[best] -= 1
        counts[best] += 1
        assignments.append(best)
    return assignments, counts



# --- Placement under a topology spread constraint.
#
# The PodTopologySpread DoNotSchedule predicate, checked the way
# kube-scheduler checks it: at EVERY placement, the candidate zone's count
# after placing may exceed the global minimum by at most maxSkew.  The
# minimum moves as zones fill, so feasibility changes globally each step —
# the scan re-derives it fully (the incremental-score carry of
# place_replicas cannot apply).  For identical replicas this greedy lands
# exactly the closed form sum(min(c_z, min_z c_z + maxSkew)) that
# CapacityModel.topology_spread reports.


def place_replicas_spread(
    alloc_cpu,
    alloc_mem,
    alloc_pods,
    used_cpu,
    used_mem,
    pods_count,
    healthy,
    cpu_req,
    mem_req,
    zone_of,
    *,
    n_replicas: int,
    n_zones: int,
    policy: str = "first-fit",
    max_skew: int = 1,
    node_mask=None,
    max_per_node: int | None = None,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy placement with the per-step maxSkew gate, on ``device``.

    ``zone_of`` is ``[N]`` int: the node's topology-domain index in
    ``[0, n_zones)``, or ``-1`` for nodes outside every domain — those are
    infeasible, the DoNotSchedule rule.  ``max_per_node`` composes the
    hostname-level cap on top of the zone constraint.  Returns numpy
    ``(assignments[R], per_node[N], per_zone[n_zones])``.
    """
    _check(policy, n_replicas)
    if n_zones < 1:
        raise ValueError("n_zones must be >= 1 (no domains = nothing places)")
    if max_skew < 1:
        raise ValueError("max_skew must be >= 1")
    # kccap: lint-ok[device-purity] staging: resolve the device and upload the columns once, before the step loop
    dev, put = _devcache.int64_putter(device)
    alloc_cpu, alloc_mem = put(alloc_cpu), put(alloc_mem)
    c, m = int(cpu_req), int(mem_req)
    zone_of = put(zone_of)
    eligible = _eligible(put, healthy, node_mask) & (zone_of >= 0)
    hc = alloc_cpu - put(used_cpu)
    hm = alloc_mem - put(used_mem)
    slots = torch.clamp_min(put(alloc_pods) - put(pods_count), 0)
    n = hc.shape[0]
    idx_f64 = torch.arange(n, device=dev, dtype=torch.float64)
    zone_gather = torch.where(zone_of >= 0, zone_of, 0)  # safe index
    counts = torch.zeros(n_zones, dtype=torch.int64, device=dev)
    mine = torch.zeros(n, dtype=torch.int64, device=dev)
    out = torch.full((n_replicas,), -1, dtype=torch.int64, device=dev)
    for step in range(n_replicas):
        zone_ok = (counts[zone_gather] + 1 - counts.min()) <= max_skew
        feasible = (hc >= c) & (hm >= m) & (slots >= 1) & eligible & zone_ok
        if max_per_node is not None:
            feasible = feasible & (mine < max_per_node)
        if policy == "first-fit":
            score = idx_f64
        else:
            score = _signed(policy, _normalized_headroom(
                hc - c, hm - m, alloc_cpu, alloc_mem
            ))
        masked = torch.where(feasible, score, _INF)
        idx = torch.argmin(masked).view(1)
        ok = torch.isfinite(masked.index_select(0, idx))
        one = ok.to(torch.int64)
        hc.index_add_(0, idx, -(one * c))
        hm.index_add_(0, idx, -(one * m))
        slots.index_add_(0, idx, -one)
        counts.index_add_(0, zone_gather.index_select(0, idx), one)
        mine.index_add_(0, idx, one)
        out[step:step + 1] = torch.where(ok, idx, -1)
    # The final ``mine`` IS the per-node count (it takes one at the chosen
    # node on every successful step).
    return out.cpu().numpy(), mine.cpu().numpy(), counts.cpu().numpy()


# --- Heterogeneous-pod placement (drain / rehoming simulation).
#
# place_replicas places R IDENTICAL replicas; a drain simulation rehomes a
# node's EXISTING pods, each with its own requests.  The step therefore
# re-derives feasibility and scores for every node (the request changes
# each step, so nothing is reusable), and pods place in the caller's order
# (CapacityModel.drain sorts size-descending).  The engine is R-resource
# (a zero request row does not consume — a requestless pod takes only a
# slot); place_pods is the (cpu, mem) row-stacking wrapper.  The JAX
# package pads the pod axis to power-of-two buckets so that XLA compiles
# once per bucket; eager PyTorch compiles nothing, so the loop runs over
# the real pods only.


def _place_pods_scan(
    alloc_rn,
    used_rn,
    alloc_pods,
    pods_count,
    healthy,
    reqs_rp: np.ndarray,
    *,
    policy: str,
    node_mask=None,
    device="cuda",
) -> np.ndarray:
    """The heterogeneous scan: ``reqs_rp`` is ``[R, P]`` (one request
    column per step).  Returns numpy ``assignments[P]``."""
    # kccap: lint-ok[device-purity] staging: resolve the device and upload the columns once, before the step loop
    dev, put = _devcache.int64_putter(device)
    alloc_rn = put(alloc_rn)
    n_res, n = alloc_rn.shape
    eligible = _eligible(put, healthy, node_mask)
    h = alloc_rn - put(used_rn)  # [R, N]
    slots = torch.clamp_min(put(alloc_pods) - put(pods_count), 0)
    idx_f64 = torch.arange(n, device=dev, dtype=torch.float64)
    p_total = reqs_rp.shape[1]
    # Each step's headroom delta, staged once: a per-step host→device copy
    # would wait for the stream.
    sub_rp = put(np.where(reqs_rp > 0, reqs_rp, 0))
    out = torch.full((p_total,), -1, dtype=torch.int64, device=dev)
    for p in range(p_total):
        req = [int(reqs_rp[r, p]) for r in range(n_res)]
        sub = [x if x > 0 else 0 for x in req]
        feasible = (slots >= 1) & eligible
        for r in range(n_res):
            if req[r] > 0:
                feasible = feasible & (h[r] >= req[r])
        if policy == "first-fit":
            score = idx_f64
        else:
            score = _signed(policy, _row_score(h, alloc_rn, sub))
        masked = torch.where(feasible, score, _INF)
        idx = torch.argmin(masked).view(1)
        ok = torch.isfinite(masked.index_select(0, idx))
        one = ok.to(torch.int64)
        h.index_add_(1, idx, -(sub_rp[:, p:p + 1] * one))
        slots.index_add_(0, idx, -one)
        out[p:p + 1] = torch.where(ok, idx, -1)
    return out.cpu().numpy()


def place_pods_multi(
    alloc_rn,
    used_rn,
    alloc_pods,
    pods_count,
    healthy,
    reqs_rp,
    *,
    policy: str = "first-fit",
    node_mask=None,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Greedily place P pods with PER-POD request vectors, one step each.

    ``reqs_rp`` is ``[R, P]`` int64 — pod ``p`` places at step ``p`` with
    request column ``reqs_rp[:, p]`` (zero entries do not consume).  Same
    policies and tie rule as the identical-replica engines; ``-1`` for a
    pod no node can take — later pods still try (a small pod may fit where
    a big one did not, so a ``-1`` is not absorbing).  Returns numpy
    ``(assignments[P], per_node_counts[N])``.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r} (want one of {POLICIES})")
    reqs_rp = np.asarray(reqs_rp, dtype=np.int64)
    if reqs_rp.ndim != 2:
        raise ValueError(f"reqs_rp must be [R, P], got shape {reqs_rp.shape}")
    n = np.asarray(alloc_pods).shape[0]
    if reqs_rp.shape[1] == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(n, dtype=np.int64)
    assignments = _place_pods_scan(
        alloc_rn, used_rn, alloc_pods, pods_count, healthy, reqs_rp,
        policy=policy, node_mask=node_mask, device=device,
    )
    counts = np.bincount(
        assignments[assignments >= 0], minlength=n
    ).astype(np.int64)
    return assignments, counts


def place_pods(
    alloc_cpu,
    alloc_mem,
    alloc_pods,
    used_cpu,
    used_mem,
    pods_count,
    healthy,
    cpu_reqs,
    mem_reqs,
    *,
    policy: str = "first-fit",
    node_mask=None,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """2-resource :func:`place_pods_multi`: rows stack as (cpu, mem)."""
    return place_pods_multi(
        np.stack([np.asarray(alloc_cpu), np.asarray(alloc_mem)]),
        np.stack([np.asarray(used_cpu), np.asarray(used_mem)]),
        alloc_pods,
        pods_count,
        healthy,
        np.stack(
            [
                np.asarray(cpu_reqs, dtype=np.int64),
                np.asarray(mem_reqs, dtype=np.int64),
            ]
        ),
        policy=policy,
        node_mask=node_mask,
        device=device,
    )


def place_pods_multi_python(
    alloc_rn,
    used_rn,
    alloc_pods,
    pods_count,
    healthy,
    reqs_rp,
    *,
    policy: str = "first-fit",
    node_mask=None,
) -> tuple[list[int], list[int]]:
    """Sequential ground truth for :func:`place_pods_multi` (same tie
    rules and zero-request convention)."""
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}")
    alloc_rn = np.asarray(alloc_rn, dtype=np.int64)
    reqs_rp = np.asarray(reqs_rp, dtype=np.int64)
    n_res, n = alloc_rn.shape
    h = [
        [int(alloc_rn[r, i]) - int(used_rn[r][i]) for i in range(n)]
        for r in range(n_res)
    ]
    slots = [max(int(a) - int(p), 0) for a, p in zip(alloc_pods, pods_count)]
    eligible = [
        bool(healthy[i]) and (node_mask is None or bool(node_mask[i]))
        for i in range(n)
    ]
    assignments: list[int] = []
    counts = [0] * n
    for p in range(reqs_rp.shape[1]):
        req = [int(reqs_rp[r, p]) for r in range(n_res)]
        best, best_score = -1, None
        for i in range(n):
            if not (
                eligible[i]
                and slots[i] >= 1
                and all(
                    req[r] <= 0 or h[r][i] >= req[r] for r in range(n_res)
                )
            ):
                continue
            if policy == "first-fit":
                score = float(i)
            else:
                after = 0.0
                for r in range(n_res):
                    if alloc_rn[r, i] > 0:
                        sub = req[r] if req[r] > 0 else 0
                        after += (h[r][i] - sub) / float(alloc_rn[r, i])
                score = after if policy == "best-fit" else -after
            if best_score is None or score < best_score:
                best, best_score = i, score
        if best < 0:
            assignments.append(-1)
            continue
        for r in range(n_res):
            if req[r] > 0:
                h[r][best] -= req[r]
        slots[best] -= 1
        counts[best] += 1
        assignments.append(best)
    return assignments, counts


def place_pods_python(
    alloc_cpu,
    alloc_mem,
    alloc_pods,
    used_cpu,
    used_mem,
    pods_count,
    healthy,
    cpu_reqs,
    mem_reqs,
    *,
    policy: str = "first-fit",
    node_mask=None,
) -> tuple[list[int], list[int]]:
    """2-resource :func:`place_pods_multi_python`."""
    return place_pods_multi_python(
        np.stack([np.asarray(alloc_cpu), np.asarray(alloc_mem)]),
        np.stack([np.asarray(used_cpu), np.asarray(used_mem)]),
        alloc_pods,
        pods_count,
        healthy,
        np.stack(
            [
                np.asarray(cpu_reqs, dtype=np.int64),
                np.asarray(mem_reqs, dtype=np.int64),
            ]
        ),
        policy=policy,
        node_mask=node_mask,
    )



# --- R-resource generalization (placement with GPUs / ephemeral-storage).
#
# Same engines, R resource rows instead of the fixed (cpu, mem) pair.  A
# zero request row means "does not consume" (excluded from feasibility and
# headroom updates), the R-resource fit's convention.  Every engine folds
# the normalized-headroom score LEFT TO RIGHT over rows in the caller's
# order, so their f64 values are bit-identical and the closed forms' tie
# arguments carry over: each per-row term is monotone non-increasing in
# the per-node placement count, and fl() and the left fold are monotone,
# so plateaus can appear but the order never inverts.


def place_replicas_multi(
    alloc_rn,
    used_rn,
    alloc_pods,
    pods_count,
    healthy,
    reqs_r,
    *,
    n_replicas: int,
    policy: str = "first-fit",
    node_mask=None,
    max_per_node: int | None = None,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """R-resource greedy placement scan — see :func:`place_replicas`.

    ``alloc_rn``/``used_rn`` are ``[R, N]`` int64, ``reqs_r`` the ``[R]``
    per-replica request vector (zero rows do not consume).
    """
    _check(policy, n_replicas)
    # kccap: lint-ok[device-purity] staging: resolve the device and upload the columns once, before the step loop
    dev, put = _devcache.int64_putter(device)
    alloc_rn = put(alloc_rn)
    n_res, n = alloc_rn.shape
    reqs = [int(x) for x in np.asarray(reqs_r, dtype=np.int64)]
    sub = [x if x > 0 else 0 for x in reqs]
    sub_r1 = put(np.asarray(sub, dtype=np.int64)).view(n_res, 1)
    eligible = _eligible(put, healthy, node_mask)
    h = alloc_rn - put(used_rn)  # [R, N]
    slots = torch.clamp_min(put(alloc_pods) - put(pods_count), 0)

    def fits(h_cols, slots_cols, eligible_cols):
        ok = (slots_cols >= 1) & eligible_cols
        for r in range(n_res):
            if reqs[r] > 0:
                ok = ok & (h_cols[r] >= reqs[r])
        return ok

    feasible = fits(h, slots, eligible)
    if max_per_node is not None and max_per_node <= 0:
        feasible = torch.zeros_like(feasible)  # no node takes even one
    if policy == "first-fit":
        score = torch.arange(n, device=dev, dtype=torch.float64)
    else:
        score = _signed(policy, _row_score(h, alloc_rn, sub))
    masked = torch.where(feasible, score, _INF)
    mine = torch.zeros(n, dtype=torch.int64, device=dev)
    out = torch.full((n_replicas,), -1, dtype=torch.int64, device=dev)
    for step in range(n_replicas):
        idx = torch.argmin(masked).view(1)
        val = masked.index_select(0, idx)
        ok = torch.isfinite(val)
        one = ok.to(torch.int64)
        h.index_add_(1, idx, -(sub_r1 * one))
        slots.index_add_(0, idx, -one)
        mine.index_add_(0, idx, one)
        # Re-feasibility and re-score of the single updated column (the
        # same left fold over the rows as the vector form).
        h_col = h.index_select(1, idx)  # [R, 1]
        feas_i = fits(h_col, slots.index_select(0, idx),
                      eligible.index_select(0, idx))
        if max_per_node is not None:
            feas_i = feas_i & (mine.index_select(0, idx) < max_per_node)
        if policy == "first-fit":
            lane = idx.to(torch.float64)
        else:
            lane = _signed(policy, _row_score(
                h_col, alloc_rn.index_select(1, idx), sub
            ))
        new_val = torch.where(feas_i, lane, _INF)
        masked.index_copy_(0, idx, torch.where(ok, new_val, val))
        out[step:step + 1] = torch.where(ok, idx, -1)
    return out.cpu().numpy(), mine.cpu().numpy()


def place_replicas_bulk_multi(
    alloc_rn,
    used_rn,
    alloc_pods,
    pods_count,
    healthy,
    reqs_r,
    *,
    n_replicas: int,
    policy: str = "first-fit",
    node_mask=None,
    max_per_node: int | None = None,
) -> tuple[np.ndarray, int]:
    """Closed-form R-resource plan — see :func:`place_replicas_bulk`.

    The 2-row proofs generalize verbatim: per-node capacity is the min
    over ACTIVE rows of ``headroom // request`` (then slots/cap/mask), and
    the score-after-j sequence is a left-fold of R monotone f64 terms —
    monotone, plateau-capable, never order-inverting — so fill-in-order
    (best-fit) and waterline-with-plateau-ties (spread) stay exact vs the
    scan.  At least one request must be positive (an all-zero request
    consumes only pod slots; use the 2-resource bulk engine's slot path
    or the scan for that degenerate case).
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r} (want one of {POLICIES})")
    if int(n_replicas) < 0:
        raise ValueError("n_replicas must be >= 0")
    alloc_rn = np.asarray(alloc_rn, dtype=np.int64)
    used_rn = np.asarray(used_rn, dtype=np.int64)
    reqs = np.asarray(reqs_r, dtype=np.int64)
    if (reqs < 0).any():
        raise ValueError("requests must be >= 0")
    if not (reqs > 0).any():
        raise ValueError("bulk multi placement needs a positive request")
    h0 = alloc_rn - used_rn  # [R, N]
    slots = np.maximum(
        np.asarray(alloc_pods, dtype=np.int64)
        - np.asarray(pods_count, dtype=np.int64),
        0,
    )
    eligible = np.asarray(healthy, dtype=bool)
    if node_mask is not None:
        eligible = eligible & np.asarray(node_mask, dtype=bool)

    caps = slots.copy()
    for r in range(alloc_rn.shape[0]):
        if reqs[r] > 0:
            row_cap = np.where(h0[r] >= reqs[r], h0[r] // reqs[r], 0)
            caps = np.minimum(caps, row_cap)
    if max_per_node is not None:
        caps = np.minimum(caps, int(max_per_node))
    caps = np.where(eligible, np.maximum(caps, 0), 0)

    total = int(caps.sum())
    r_want = int(n_replicas)
    if r_want <= 0:
        return np.zeros_like(caps), 0
    if r_want >= total:
        return caps.copy(), total

    def fill_in_order(order: np.ndarray) -> np.ndarray:
        k = caps[order]
        before = np.concatenate(([0], np.cumsum(k)[:-1]))
        got = np.clip(r_want - before, 0, k)
        counts = np.zeros_like(caps)
        counts[order] = got
        return counts

    if policy == "first-fit":
        return fill_in_order(np.arange(caps.shape[0])), r_want

    _all_nodes = np.arange(alloc_rn.shape[1])

    def score_after(j):
        # Shared with the trace engine via _np_score_after_multi.
        return _np_score_after_multi(h0, alloc_rn, reqs, _all_nodes, j)

    if policy == "best-fit":
        s0 = score_after(0)
        order = np.lexsort((np.arange(caps.shape[0]), s0))
        order = order[caps[order] > 0]
        return fill_in_order(order), r_want

    # spread: identical waterline machinery to the 2-row engine, over the
    # generalized score_after.
    feas = caps > 0
    if not feas.any():
        return np.zeros_like(caps), 0

    def count_ge(theta: float) -> tuple[np.ndarray, int]:
        lo = np.zeros_like(caps)
        hi = caps.copy()
        while True:
            active_b = lo < hi
            if not active_b.any():
                break
            mid = (lo + hi) // 2
            ge = score_after(mid) >= theta
            lo = np.where(active_b & ge, mid + 1, lo)
            hi = np.where(active_b & ~ge, mid, hi)
        cnt = np.where(feas, lo, 0)
        return cnt, int(cnt.sum())

    def f2i(x: float) -> int:
        bits = np.float64(x).view(np.int64)
        return int(bits if bits >= 0 else (-(1 << 63)) - bits - 1)

    def i2f(i: int) -> float:
        bits = i if i >= 0 else (-(1 << 63)) - i - 1
        return float(np.int64(bits).view(np.float64))

    smax = float(score_after(0)[feas].max())
    smin = float(score_after(np.maximum(caps - 1, 0))[feas].min())
    lo_i, hi_i = f2i(smin), f2i(smax) + 1
    while hi_i - lo_i > 1:
        mid = (lo_i + hi_i) // 2
        if count_ge(i2f(mid))[1] >= r_want:
            lo_i = mid
        else:
            hi_i = mid
    theta = i2f(lo_i)
    base, _n_ge = count_ge(theta)
    strict, n_gt = count_ge(i2f(lo_i + 1))
    at = base - strict
    before = np.concatenate(([0], np.cumsum(at)[:-1]))
    take = np.clip(r_want - n_gt - before, 0, at)
    return strict + take, r_want


def place_replicas_trace_multi(
    alloc_rn,
    used_rn,
    alloc_pods,
    pods_count,
    healthy,
    reqs_r,
    *,
    n_replicas: int,
    policy: str = "first-fit",
    node_mask=None,
    max_per_node: int | None = None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """R-resource closed-form trace — see :func:`place_replicas_trace`.

    The 2-resource order arguments generalize verbatim because the score
    is a left-fold of R monotone non-increasing f64 terms (the same
    argument :func:`place_replicas_bulk_multi` makes for counts):
    first/best-fit fill nodes to capacity in (initial score, index)
    order, and spread is the multiset of ``score_after(t)`` keys sorted
    by (key desc, index asc, t asc).  Exactness pinned against the scan
    by ``tests/test_torch_placement.py``.
    """
    counts, placed = place_replicas_bulk_multi(
        alloc_rn, used_rn, alloc_pods, pods_count, healthy, reqs_r,
        n_replicas=n_replicas, policy=policy,
        node_mask=node_mask, max_per_node=max_per_node,
    )
    alloc_rn = np.asarray(alloc_rn, dtype=np.int64)
    used_rn = np.asarray(used_rn, dtype=np.int64)
    reqs = np.asarray(reqs_r, dtype=np.int64)
    h0 = alloc_rn - used_rn
    score0 = (
        _np_score_after_multi(
            h0, alloc_rn, reqs, np.arange(counts.shape[0]), 0
        )
        if policy == "best-fit"
        else None
    )
    assignments = _assemble_trace(
        counts, placed, n_replicas, policy, score0,
        lambda i_arr, t_arr: _np_score_after_multi(
            h0, alloc_rn, reqs, i_arr, t_arr
        ),
    )
    return assignments, counts, placed


def place_replicas_multi_python(
    alloc_rn,
    used_rn,
    alloc_pods,
    pods_count,
    healthy,
    reqs_r,
    *,
    n_replicas: int,
    policy: str = "first-fit",
    node_mask=None,
    max_per_node: int | None = None,
) -> tuple[list[int], list[int]]:
    """Sequential ground truth for :func:`place_replicas_multi`."""
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}")
    alloc_rn = [list(map(int, row)) for row in np.asarray(alloc_rn)]
    used_rn = [list(map(int, row)) for row in np.asarray(used_rn)]
    reqs = [int(x) for x in np.asarray(reqs_r)]
    n = len(alloc_rn[0])
    h = [
        [alloc_rn[r][i] - used_rn[r][i] for i in range(n)]
        for r in range(len(reqs))
    ]
    slots = [max(int(a) - int(p), 0) for a, p in zip(alloc_pods, pods_count)]
    eligible = [
        bool(healthy[i]) and (node_mask is None or bool(node_mask[i]))
        for i in range(n)
    ]
    assignments: list[int] = []
    counts = [0] * n
    for _ in range(n_replicas):
        best, best_score = -1, None
        for i in range(n):
            if not (
                eligible[i]
                and slots[i] >= 1
                and all(
                    reqs[r] == 0 or h[r][i] >= reqs[r]
                    for r in range(len(reqs))
                )
                and (max_per_node is None or counts[i] < max_per_node)
            ):
                continue
            if policy == "first-fit":
                score = float(i)
            else:
                after = 0.0
                for r in range(len(reqs)):
                    if alloc_rn[r][i] > 0:
                        sub = reqs[r] if reqs[r] > 0 else 0
                        after += (h[r][i] - sub) / float(alloc_rn[r][i])
                score = after if policy == "best-fit" else -after
            if best_score is None or score < best_score:
                best, best_score = i, score
        if best < 0:
            assignments.append(-1)
            continue
        for r in range(len(reqs)):
            if reqs[r] > 0:
                h[r][best] -= reqs[r]
        slots[best] -= 1
        counts[best] += 1
        assignments.append(best)
    return assignments, counts
