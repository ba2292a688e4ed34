"""Capacity-at-risk: Monte Carlo capacity quantiles under usage uncertainty.

Counterpart of ``kubernetesclustercapacity_tpu/stochastic/car.py``.  The
question operators actually ask is not "how many replicas fit if every pod
uses exactly its request" but "how many fit with 95% confidence".  This
module answers it by drawing ``S`` per-pod usage samples from the spec's
distributions (:mod:`.distributions`: explicit seeds, the JAX package's
draws bit for bit) and sweeping them as ``S`` rows of a
:class:`~..scenario.ScenarioGrid`: the whole Monte Carlo pass is ONE
dispatch of the exact int64 program on the card
(:func:`..ops.fit.sweep_quantiles_snapshot`, with the order statistics taken
on the device), over node-shape groups when the fleet is degenerate.  Both
routes are bit-exact, so the capacity quantiles are deterministic in the
seed alone.  The fused kernels B1/B2 are not on this path: the JAX package
answers CaR with its exact program too.

Quantile rule (shared with the numpy seed-replay oracle): with the ``S``
totals sorted ascending, the capacity at confidence ``q`` is the order
statistic at index ``S - ceil(q·S)`` — the largest capacity ``c`` in the
sample set with ``#{samples >= c} / S >= q``.  Pure integer selection on
int64 totals: no interpolation, no float capacity.

:func:`capacity_at_risk` takes ``device=`` (default ``"cuda"``; it raises
without a card unless given ``"cpu"``).  :func:`fit_totals_numpy` and
:func:`car_oracle` are the JAX module's numpy oracle, verbatim; the oracle
draws its samples on the host.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np

from kubernetesclustercapacity_tpu_torch.ops.fit import (
    sweep_quantiles_snapshot,
    sweep_snapshot,
)
from kubernetesclustercapacity_tpu_torch.scenario import ScenarioGrid
from kubernetesclustercapacity_tpu_torch.snapshot import ClusterSnapshot
from kubernetesclustercapacity_tpu_torch.stochastic.distributions import (
    StochasticSpec,
    sample_key,
    sample_usage,
)

__all__ = [
    "DEFAULT_QUANTILES",
    "CaRResult",
    "capacity_at_risk",
    "car_oracle",
    "fit_totals_numpy",
    "quantile_index",
    "quantile_label",
]

#: The reporting ladder: median, and the three confidence levels
#: capacity planning actually quotes.
DEFAULT_QUANTILES = (0.5, 0.9, 0.95, 0.99)


def quantile_index(n: int, q: float) -> int:
    """Sorted-ascending index of the capacity at confidence ``q``.

    ``i = n - ceil(q·n)`` (clamped to ``[0, n-1]``): at least a ``q``
    fraction of samples sit at or above the returned order statistic.
    ``q·n`` is rounded to 9 decimals before the ceil so binary float
    noise (``0.9 * 10 == 9.000000000000002``) cannot shift the index.
    """
    if not 0.0 < q < 1.0:
        raise ValueError(f"quantile must be in (0, 1), got {q}")
    if n < 1:
        raise ValueError(f"need at least 1 sample, got {n}")
    k = math.ceil(round(q * n, 9))
    return min(max(n - k, 0), n - 1)


def quantile_label(q: float) -> str:
    """``0.95`` → ``"p95"`` (the wire/report spelling)."""
    return f"p{q * 100:g}"


@dataclass
class CaRResult:
    """One capacity-at-risk evaluation (numpy arrays throughout).

    ``totals`` is the ``[S]`` per-sample cluster capacity;
    ``quantiles`` maps confidence → capacity (int replicas) and
    ``quantile_samples`` maps confidence → the sample index realizing
    it (the scenario the per-quantile binding attribution explains).
    """

    spec: StochasticSpec
    mode: str
    n_samples: int
    samples_cpu: np.ndarray  # [S] int64 per-pod cpu usage draws
    samples_mem: np.ndarray  # [S] int64 per-pod memory usage draws
    totals: np.ndarray  # [S] int64 capacity per sample
    quantiles: dict[float, int]
    quantile_samples: dict[float, int]
    mean: float
    prob_fit: float
    eval_ms: float = 0.0
    bindings: dict[float, dict[str, int]] = field(default_factory=dict)

    def quantile(self, q: float) -> int:
        return self.quantiles[q]

    @property
    def schedulable(self) -> bool:
        """True when the spec's replicas fit at its confidence bar."""
        return self.prob_fit >= self.spec.confidence

    def to_wire(self) -> dict:
        """The ``car`` op's response body (and the offline report's
        input) — quantiles keyed by their ``pNN`` labels."""
        return {
            "mode": self.mode,
            "samples": self.n_samples,
            "seed": self.spec.seed,
            "replicas": self.spec.replicas,
            "confidence": self.spec.confidence,
            "quantiles": {
                quantile_label(q): int(v)
                for q, v in sorted(self.quantiles.items())
            },
            "mean": round(self.mean, 3),
            "prob_fit": round(self.prob_fit, 6),
            "schedulable": self.schedulable,
            "min_total": int(self.totals.min()),
            "max_total": int(self.totals.max()),
            "binding": {
                quantile_label(q): dict(counts)
                for q, counts in sorted(self.bindings.items())
            },
            "usage": {
                "cpu": self.spec.cpu.to_wire(),
                "memory": self.spec.memory.to_wire(),
            },
        }


def capacity_at_risk(
    snapshot: ClusterSnapshot,
    spec: StochasticSpec,
    *,
    mode: str | None = None,
    node_mask=None,
    quantiles: tuple[float, ...] = DEFAULT_QUANTILES,
    bindings: bool = True,
    fused: bool = True,
    device="cuda",
) -> CaRResult:
    """Evaluate one stochastic spec against a snapshot.

    Draws ``spec.n_samples()`` (cpu, memory) usage pairs from the
    spec's seed on ``device``, dispatches them as one ``[S]``-scenario
    exact sweep on the snapshot's device-resident columns (over node-shape
    groups when the fleet is degenerate; same node_mask conventions, same
    semantics modes), and
    reduces the per-sample totals to capacity quantiles, the mean, and
    the probability of fitting ``spec.replicas``.

    ``fused=True`` (the default) runs the sweep AND the order-statistic
    reduction as ONE device launch (:func:`..ops.fit.sweep_quantiles_snapshot`):
    the quantile indices are computed host-side from ``(S, q)`` alone
    and gathered from an on-device stable argsort — a stable sort's
    permutation is algorithm-independent, so the quantile values and
    realizing sample indices are bit-identical to the host-side
    ``np.argsort(kind="stable")`` reduction (``fused=False``, the
    pre-fusion path, kept as the oracle twin and pinned equal by test).

    ``bindings=True`` additionally explains the quantile-realizing
    scenarios (one explain pass over ``len(quantiles)`` rows): which
    constraint binds at P95 vs P50 — the per-quantile attribution the
    ``car`` surfaces report.  ``device`` defaults to ``"cuda"`` and raises
    when no card is present.
    """
    mode = mode or snapshot.semantics
    n = spec.n_samples()
    t0 = time.perf_counter()
    cpu = sample_usage(spec.cpu, n, sample_key(spec.seed, 0), device=device)
    mem = sample_usage(spec.memory, n, sample_key(spec.seed, 1), device=device)
    grid = ScenarioGrid(
        cpu_request_milli=cpu,
        mem_request_bytes=mem,
        replicas=np.full(n, int(spec.replicas), dtype=np.int64),
    )
    qvals: dict[float, int] = {}
    qsamples: dict[float, int] = {}
    if fused:
        qs = tuple(quantiles)
        q_indices = tuple(quantile_index(n, q) for q in qs)
        totals, sched, qv, qx, _kernel = sweep_quantiles_snapshot(
            snapshot, grid, mode=mode, node_mask=node_mask,
            q_indices=q_indices, device=device,
        )
        totals = np.asarray(totals, dtype=np.int64)
        for j, q in enumerate(qs):
            qvals[q] = int(qv[j])
            qsamples[q] = int(qx[j])
    else:
        totals, sched = sweep_snapshot(
            snapshot, grid, mode=mode, node_mask=node_mask, device=device
        )
        totals = np.asarray(totals, dtype=np.int64)
        # Host-side reduction: a stable argsort so the quantile-realizing
        # SAMPLE index (not just the value) is deterministic under ties.
        order = np.argsort(totals, kind="stable")
        sorted_totals = totals[order]
        for q in quantiles:
            i = quantile_index(n, q)
            qvals[q] = int(sorted_totals[i])
            qsamples[q] = int(order[i])
    result = CaRResult(
        spec=spec,
        mode=mode,
        n_samples=n,
        samples_cpu=cpu,
        samples_mem=mem,
        totals=totals,
        quantiles=qvals,
        quantile_samples=qsamples,
        mean=float(totals.astype(np.float64).mean()),
        prob_fit=float(np.asarray(sched, dtype=bool).mean()),
    )
    if bindings and quantiles:
        from kubernetesclustercapacity_tpu_torch.explain import (
            explain_snapshot,
        )

        qs = sorted(qvals)
        qgrid = ScenarioGrid(
            cpu_request_milli=cpu[[qsamples[q] for q in qs]],
            mem_request_bytes=mem[[qsamples[q] for q in qs]],
            replicas=np.full(len(qs), int(spec.replicas), dtype=np.int64),
        )
        ex = explain_snapshot(
            snapshot, qgrid, mode=mode, node_mask=node_mask, device=device
        )
        result.bindings = {
            q: ex.binding_counts(i) for i, q in enumerate(qs)
        }
    result.eval_ms = (time.perf_counter() - t0) * 1e3
    return result


def fit_totals_numpy(
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
    mode: str = "reference",
    node_mask=None,
    counts=None,
    chunk: int = 8,
) -> np.ndarray:
    """The numpy seed-replay oracle's sweep: per-sample cluster totals
    computed with pure numpy — the same Go-faithful arithmetic as
    :func:`~..ops.fit.fit_per_node` (uint64 CPU compare/divide on the
    raw bit patterns, int64 wrap-around memory with truncating
    division, the Q1 conditional pod-cap overwrite) with **no JAX in
    the loop**, so the kernel path has an independent comparator even
    at 1M-node scale where the sequential Python oracle cannot go.

    ``counts`` (optional ``[N]`` int64) weights each row's fit — the
    grouped (shape, count) vocabulary; ``None`` weights every row 1.
    Scenario rows are processed in ``chunk``-sized slabs to bound the
    ``[chunk, N]`` intermediates.  Returns ``[S]`` int64 totals.
    """
    alloc_cpu_u = np.asarray(alloc_cpu, dtype=np.int64).astype(np.uint64)
    used_cpu_u = np.asarray(used_cpu, dtype=np.int64).astype(np.uint64)
    alloc_mem = np.asarray(alloc_mem, dtype=np.int64)
    used_mem = np.asarray(used_mem, dtype=np.int64)
    alloc_pods = np.asarray(alloc_pods, dtype=np.int64)
    pods_count = np.asarray(pods_count, dtype=np.int64)
    healthy_b = np.asarray(healthy, dtype=bool)
    cpu_reqs = np.asarray(cpu_reqs, dtype=np.int64)
    mem_reqs = np.asarray(mem_reqs, dtype=np.int64)
    weights = (
        np.ones(alloc_cpu_u.shape[0], dtype=np.int64)
        if counts is None
        else np.asarray(counts, dtype=np.int64)
    )
    if node_mask is not None:
        mask = np.asarray(node_mask, dtype=bool)
    else:
        mask = None
    s = cpu_reqs.shape[0]
    totals = np.zeros(s, dtype=np.int64)
    mem_head = alloc_mem - used_mem  # wraps like Go int64 (silent in C)
    with np.errstate(over="ignore"):
        for lo in range(0, s, max(chunk, 1)):
            hi = min(lo + max(chunk, 1), s)
            cr = cpu_reqs[lo:hi].astype(np.uint64)[:, None]
            cr = np.maximum(cr, np.uint64(1))
            mr = mem_reqs[lo:hi][:, None]
            cpu_fit = np.where(
                alloc_cpu_u[None, :] <= used_cpu_u[None, :],
                np.uint64(0),
                (alloc_cpu_u[None, :] - used_cpu_u[None, :]) // cr,
            ).astype(np.int64)
            den = np.where(mr == 0, np.int64(1), mr)
            q = mem_head[None, :] // den  # numpy floors; fix to truncate
            r = mem_head[None, :] - q * den
            fix = ((r != 0) & ((mem_head[None, :] < 0) != (den < 0)))
            mem_fit = np.where(
                alloc_mem[None, :] <= used_mem[None, :],
                np.int64(0),
                q + fix.astype(np.int64),
            )
            fit = np.minimum(cpu_fit, mem_fit)
            if mode == "reference":
                fit = np.where(
                    fit >= alloc_pods[None, :],
                    alloc_pods[None, :] - pods_count[None, :],
                    fit,
                )
            elif mode == "strict":
                slots = np.maximum(
                    alloc_pods[None, :] - pods_count[None, :], np.int64(0)
                )
                fit = np.maximum(np.minimum(fit, slots), np.int64(0))
                fit = np.where(healthy_b[None, :], fit, np.int64(0))
            else:
                raise ValueError(f"unknown mode {mode!r}")
            if mask is not None:
                fit = np.where(mask[None, :], fit, np.int64(0))
            totals[lo:hi] = (fit * weights[None, :]).sum(axis=1)
    return totals


def car_oracle(
    snapshot: ClusterSnapshot,
    spec: StochasticSpec,
    *,
    mode: str | None = None,
    node_mask=None,
    quantiles: tuple[float, ...] = DEFAULT_QUANTILES,
) -> CaRResult:
    """The full seed-replay oracle: re-draw the identical samples from
    the identical seed, sweep them with :func:`fit_totals_numpy`
    (numpy, ungrouped), reduce with the documented quantile
    rule.  ``car_parity_diffs == 0`` in bench and the randomized tests
    means :func:`capacity_at_risk` and this function agree bit-for-bit.
    """
    mode = mode or snapshot.semantics
    n = spec.n_samples()
    cpu = sample_usage(spec.cpu, n, sample_key(spec.seed, 0), device="cpu")
    mem = sample_usage(spec.memory, n, sample_key(spec.seed, 1), device="cpu")
    totals = fit_totals_numpy(
        snapshot.alloc_cpu_milli,
        snapshot.alloc_mem_bytes,
        snapshot.alloc_pods,
        snapshot.used_cpu_req_milli,
        snapshot.used_mem_req_bytes,
        snapshot.pods_count,
        snapshot.healthy,
        cpu,
        mem,
        mode=mode,
        node_mask=node_mask,
    )
    order = np.argsort(totals, kind="stable")
    sorted_totals = totals[order]
    qvals = {q: int(sorted_totals[quantile_index(n, q)]) for q in quantiles}
    qsamples = {
        q: int(order[quantile_index(n, q)]) for q in quantiles
    }
    return CaRResult(
        spec=spec,
        mode=mode,
        n_samples=n,
        samples_cpu=cpu,
        samples_mem=mem,
        totals=totals,
        quantiles=qvals,
        quantile_samples=qsamples,
        mean=float(totals.astype(np.float64).mean()),
        prob_fit=float((totals >= int(spec.replicas)).mean()),
    )
