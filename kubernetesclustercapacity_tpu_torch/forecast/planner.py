"""Certified autoscaler planning: "what to buy" and "what drains free".

Counterpart of ``kubernetesclustercapacity_tpu/forecast/planner.py``: the
base capacity is one exact sweep on the card (``device=``, default
``"cuda"``); the catalog grammar, the closed forms, the greedy and trimmed
plans, the drain analysis and the certification are the JAX module's
host numpy, verbatim.

The forecast says P95 capacity crosses the threshold in six days; this
module closes the loop with the two questions an autoscaler (or a
budget meeting) actually asks:

* **scale-up** — the cheapest multiset of catalog node shapes whose
  purchase restores the q-quantile capacity to at least ``target``;
* **scale-down** — which existing nodes can be drained *for free*:
  zero contribution to capacity at every Monte Carlo sample (the
  stochastic analog of a zero shadow price), plus the surplus nodes a
  greedy drain can remove while the exact quantile stays at target.

Certification contract (the cannot-lie rule): a
plan is ``certified`` only when host-side exact integer arithmetic —
the pure-numpy oracle sweep, NOT the dispatch path that proposed the
plan — confirms the purchased capacity restores the quantile, and every
catalog shape's closed-form per-sample fit column agrees with the same
oracle.  Anything less (unsatisfiable targets, exhausted ``max_count``
bounds, a dispatch/oracle disagreement) is reported ``uncertified``
with the reason; the answer is never silently wrong.

The cost lower bound is closed-form LP duality over the order-statistic
constraint: restoring the q-quantile to ``target`` means lifting at
least ``k = ceil(q·S)`` samples to it; lifting sample ``s`` alone costs
at least ``deficit_s · min_j(cost_j / fit_js)`` (the single-constraint
LP optimum), and any feasible set of ``k`` samples pays at least its
most expensive member — so the k-th smallest per-sample bound is a
valid lower bound on ANY fractional plan.  ``gap_pct`` reports how far
the integral plan sits above it.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

import numpy as np

from kubernetesclustercapacity_tpu_torch.ops.fit import sweep_snapshot
from kubernetesclustercapacity_tpu_torch.scenario import ScenarioGrid
from kubernetesclustercapacity_tpu_torch.snapshot import ClusterSnapshot
from kubernetesclustercapacity_tpu_torch.stochastic.car import (
    fit_totals_numpy,
    quantile_index,
    quantile_label,
)
from kubernetesclustercapacity_tpu_torch.stochastic.distributions import (
    StochasticSpec,
    sample_key,
    sample_usage,
)
from kubernetesclustercapacity_tpu_torch.utils.quantity import (
    QuantityParseError,
    cpu_parse_error_payload,
    cpu_to_milli_reference,
    to_bytes_reference,
)

__all__ = [
    "CatalogShape",
    "PlanResult",
    "PlannerError",
    "apply_plan",
    "load_catalog",
    "parse_catalog",
    "plan_capacity",
]

_RESOURCE_ORDER = ("cpu", "memory", "pods")

#: Per-shape purchase ceiling when the catalog does not set one, and the
#: overall node budget a greedy mix may spend before declaring the
#: target unreachable — both explicit in the result, never silent.
_DEFAULT_MAX_COUNT = 10_000
_MAX_TOTAL_NODES = 100_000


class PlannerError(ValueError):
    """Malformed catalog or plan request (bad shape quantities, bad
    target, an empty catalog) — grammar errors, typed like the
    stochastic spec's."""


@dataclass(frozen=True)
class CatalogShape:
    """One purchasable node shape: the fit columns plus its price."""

    name: str
    cpu_milli: int
    mem_bytes: int
    pods: int
    unit_cost: float
    max_count: int = _DEFAULT_MAX_COUNT

    def to_wire(self) -> dict:
        return {
            "name": self.name,
            "cpu_milli": self.cpu_milli,
            "mem_bytes": self.mem_bytes,
            "pods": self.pods,
            "unit_cost": self.unit_cost,
            "max_count": self.max_count,
        }


def _quantity(resource: str, v, *, field_name: str) -> int:
    if isinstance(v, bool):
        raise PlannerError(f"{field_name}: expected a quantity, got {v!r}")
    if isinstance(v, (int, float)):
        if isinstance(v, float) and not v.is_integer():
            raise PlannerError(
                f"{field_name}: native-unit quantities must be integers, "
                f"got {v!r}"
            )
        return int(v)
    if not isinstance(v, str):
        raise PlannerError(f"{field_name}: expected a quantity, got {v!r}")
    if resource == "cpu":
        if cpu_parse_error_payload(v) is not None:
            raise PlannerError(f"{field_name}: bad cpu quantity {v!r}")
        return cpu_to_milli_reference(v)
    try:
        return to_bytes_reference(v)
    except QuantityParseError as e:
        raise PlannerError(
            f"{field_name}: bad memory quantity {v!r}: {e}"
        ) from e


def parse_catalog(data) -> tuple[CatalogShape, ...]:
    """``{"shapes": [...]}`` (or a bare list) → validated shapes.

    Each entry: ``name``, ``cpu`` (millicores or ``"8"``/``"8000m"``),
    ``memory`` (bytes or ``"32gb"``), ``pods`` (int), ``unit_cost``
    (positive number, any currency — only ratios matter), optional
    ``max_count``.  Names must be unique; quantities parse through the
    reference codecs so a catalog file speaks the same dialect as every
    other operator file.
    """
    if isinstance(data, dict):
        data = data.get("shapes")
    if not isinstance(data, list) or not data:
        raise PlannerError(
            "catalog wants a non-empty 'shapes' list of node shapes"
        )
    shapes: list[CatalogShape] = []
    seen: set[str] = set()
    for i, entry in enumerate(data):
        where = f"catalog shape[{i}]"
        if not isinstance(entry, dict):
            raise PlannerError(f"{where}: expected an object, got {entry!r}")
        unknown = set(entry) - {
            "name", "cpu", "memory", "pods", "unit_cost", "max_count",
        }
        if unknown:
            raise PlannerError(
                f"{where}: unknown key(s) {sorted(unknown)}"
            )
        name = entry.get("name")
        if not isinstance(name, str) or not name:
            raise PlannerError(f"{where}: wants a non-empty name")
        if name in seen:
            raise PlannerError(f"{where}: duplicate shape name {name!r}")
        seen.add(name)
        cpu = _quantity("cpu", entry.get("cpu"), field_name=f"{where}.cpu")
        mem = _quantity(
            "memory", entry.get("memory"), field_name=f"{where}.memory"
        )
        pods = entry.get("pods", 110)
        if isinstance(pods, bool) or not isinstance(pods, int) or pods < 1:
            raise PlannerError(
                f"{where}.pods: wants a positive int, got {pods!r}"
            )
        cost = entry.get("unit_cost")
        if (
            isinstance(cost, bool)
            or not isinstance(cost, (int, float))
            or not float(cost) > 0.0
        ):
            raise PlannerError(
                f"{where}.unit_cost: wants a positive number, got {cost!r}"
            )
        max_count = entry.get("max_count", _DEFAULT_MAX_COUNT)
        if (
            isinstance(max_count, bool)
            or not isinstance(max_count, int)
            or max_count < 0
        ):
            raise PlannerError(
                f"{where}.max_count: wants an int >= 0, got {max_count!r}"
            )
        if cpu < 1 or mem < 1:
            raise PlannerError(
                f"{where}: cpu and memory must be positive quantities"
            )
        shapes.append(
            CatalogShape(
                name=name,
                cpu_milli=cpu,
                mem_bytes=mem,
                pods=pods,
                unit_cost=float(cost),
                max_count=max_count,
            )
        )
    return tuple(shapes)


def load_catalog(path: str) -> tuple[CatalogShape, ...]:
    """Load a catalog file (YAML when PyYAML is present, else strict
    JSON — the same loader split as every other operator file)."""
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    try:
        import yaml  # type: ignore[import-untyped]

        data = yaml.safe_load(text)
    except ImportError:
        try:
            data = json.loads(text)
        except ValueError as e:
            raise PlannerError(
                f"{path}: not valid JSON (and PyYAML is unavailable): {e}"
            ) from e
    except Exception as e:  # yaml.YAMLError — malformed document
        raise PlannerError(f"{path}: cannot parse: {e}") from e
    return parse_catalog(data)


def _fresh_node_fits(
    shape: CatalogShape, cpu_reqs: np.ndarray, mem_reqs: np.ndarray
) -> np.ndarray:
    """``[S]`` int64 per-sample fit of ONE empty healthy node of this
    shape — closed form.  With ``used = 0`` and ``pods_count = 0`` the
    reference's conditional pod-cap overwrite and strict mode's
    slots-and-health clamp reduce to the same expression:
    ``min(cpu // req, mem // req, pods)``."""
    cpu = np.maximum(cpu_reqs.astype(np.int64), 1)
    cpu_fit = np.where(
        shape.cpu_milli <= 0, 0, shape.cpu_milli // cpu
    )
    mem = np.maximum(mem_reqs.astype(np.int64), 1)
    mem_fit = np.where(
        shape.mem_bytes <= 0, 0, shape.mem_bytes // mem
    )
    return np.minimum(
        np.minimum(cpu_fit, mem_fit), np.int64(max(shape.pods, 0))
    ).astype(np.int64)


def _oracle_shape_fits(
    shape: CatalogShape,
    cpu_reqs: np.ndarray,
    mem_reqs: np.ndarray,
    mode: str,
) -> np.ndarray:
    """The same column through :func:`~..stochastic.car.
    fit_totals_numpy` on a synthetic 1-node snapshot — the independent
    derivation certification compares against."""
    one = np.array([1], dtype=np.int64)
    return fit_totals_numpy(
        np.array([shape.cpu_milli], dtype=np.int64),
        np.array([shape.mem_bytes], dtype=np.int64),
        np.array([shape.pods], dtype=np.int64),
        one * 0,
        one * 0,
        one * 0,
        np.array([True]),
        cpu_reqs,
        mem_reqs,
        mode=mode,
    )


def _quantile_value(totals: np.ndarray, q: float) -> int:
    s = int(totals.shape[0])
    return int(np.sort(totals, kind="stable")[quantile_index(s, q)])


@dataclass
class PlanResult:
    """One planning answer (scale-up buy list + optional drain set)."""

    mode: str
    quantile: float
    target: int
    n_samples: int
    seed: int
    shapes: tuple[CatalogShape, ...]
    buy: dict[str, int]
    base_quantile_capacity: int
    projected_quantile_capacity: int
    total_cost: float
    lp_bound: float
    satisfiable: bool
    certified: bool
    uncertified_reason: str | None = None
    shadow_prices: dict[str, float] = field(default_factory=dict)
    demand_price: float | None = None
    drain: dict | None = None
    eval_ms: float = 0.0

    @property
    def status(self) -> str:
        return "certified" if self.certified else "uncertified"

    @property
    def gap_pct(self) -> float:
        if self.total_cost <= 0.0 or not np.isfinite(self.lp_bound):
            return 0.0
        return max(
            (self.total_cost - self.lp_bound) / self.total_cost * 100.0,
            0.0,
        )

    def to_wire(self) -> dict:
        out = {
            "mode": self.mode,
            "quantile": quantile_label(self.quantile),
            "target": self.target,
            "samples": self.n_samples,
            "seed": self.seed,
            "catalog": [s.to_wire() for s in self.shapes],
            "buy": [
                {
                    "shape": s.name,
                    "count": int(self.buy.get(s.name, 0)),
                    "unit_cost": s.unit_cost,
                    "cost": round(
                        s.unit_cost * self.buy.get(s.name, 0), 6
                    ),
                }
                for s in self.shapes
                if self.buy.get(s.name, 0)
            ],
            "nodes_bought": int(sum(self.buy.values())),
            "base_quantile_capacity": self.base_quantile_capacity,
            "projected_quantile_capacity": (
                self.projected_quantile_capacity
            ),
            "total_cost": round(self.total_cost, 6),
            "lp_bound": (
                round(self.lp_bound, 6)
                if np.isfinite(self.lp_bound)
                else None
            ),
            "gap_pct": round(self.gap_pct, 3),
            "satisfiable": self.satisfiable,
            "certified": self.certified,
            "status": self.status,
            "shadow_prices": {
                k: round(v, 6) for k, v in self.shadow_prices.items()
            },
            "demand_price": (
                None
                if self.demand_price is None
                else round(self.demand_price, 6)
            ),
        }
        if self.uncertified_reason:
            out["uncertified_reason"] = self.uncertified_reason
        if self.drain is not None:
            out["drain"] = self.drain
        return out


def _lp_bound(
    deficits: np.ndarray, fits: np.ndarray, costs: np.ndarray, need: int
) -> float:
    """The closed-form dual bound documented in the module docstring:
    k-th smallest per-sample single-constraint LP optimum."""
    s = deficits.shape[0]
    per_sample = np.zeros(s, dtype=np.float64)
    lifted = deficits > 0
    if lifted.any():
        with np.errstate(divide="ignore"):
            price = np.where(
                fits > 0, costs[:, None] / fits, np.inf
            ).min(axis=0)
        per_sample[lifted] = deficits[lifted] * price[lifted]
    return float(np.sort(per_sample)[min(max(need, 1), s) - 1])


def _greedy_mix(
    base: np.ndarray,
    fits: np.ndarray,
    shapes: tuple[CatalogShape, ...],
    q: float,
    target: int,
) -> dict[str, int] | None:
    """Add one node at a time, always the best exact marginal quantile
    gain per unit cost (progress-per-cost tiebreak: mean lift over the
    still-deficient samples).  Returns None when the target is
    unreachable within the catalog's bounds."""
    j_n = len(shapes)
    x = np.zeros(j_n, dtype=np.int64)
    totals = base.copy()
    budget = _MAX_TOTAL_NODES
    while _quantile_value(totals, q) < target and budget > 0:
        best = None
        deficient = totals < target
        for j in range(j_n):
            if x[j] >= shapes[j].max_count:
                continue
            cand = totals + fits[j]
            gain = _quantile_value(cand, q) - _quantile_value(totals, q)
            progress = float(fits[j][deficient].mean()) if (
                deficient.any()
            ) else float(fits[j].mean())
            score = (
                gain / shapes[j].unit_cost,
                progress / shapes[j].unit_cost,
                -shapes[j].unit_cost,
            )
            if best is None or score > best[0]:
                best = (score, j)
        if best is None or (
            best[0][0] <= 0 and best[0][1] <= 0
        ):
            return None  # no shape lifts anything: unreachable
        j = best[1]
        x[j] += 1
        totals += fits[j]
        budget -= 1
    if _quantile_value(totals, q) < target:
        return None
    return {shapes[j].name: int(x[j]) for j in range(j_n) if x[j]}


def _single_shape_plans(
    base: np.ndarray,
    fits: np.ndarray,
    shapes: tuple[CatalogShape, ...],
    q: float,
    target: int,
) -> list[dict[str, int]]:
    """Minimal feasible count per shape via binary search (capacity is
    monotone in the count)."""
    plans: list[dict[str, int]] = []
    for j, shape in enumerate(shapes):
        hi = shape.max_count
        if hi < 1:
            continue
        if _quantile_value(base + hi * fits[j], q) < target:
            continue
        lo = 1
        while lo < hi:
            mid = (lo + hi) // 2
            if _quantile_value(base + mid * fits[j], q) >= target:
                hi = mid
            else:
                lo = mid + 1
        plans.append({shape.name: lo})
    return plans


def _trim(
    plan: dict[str, int],
    base: np.ndarray,
    fits_by_name: dict[str, np.ndarray],
    shapes_by_name: dict[str, CatalogShape],
    q: float,
    target: int,
) -> dict[str, int]:
    """Drop greedy overshoot: walk shapes most-expensive-first and
    decrement while the exact quantile holds the target."""
    plan = dict(plan)
    totals = base.copy()
    for name, count in plan.items():
        totals = totals + count * fits_by_name[name]
    for name in sorted(
        plan, key=lambda n: -shapes_by_name[n].unit_cost
    ):
        while plan[name] > 0:
            cand = totals - fits_by_name[name]
            if _quantile_value(cand, q) < target:
                break
            plan[name] -= 1
            totals = cand
    return {n: c for n, c in plan.items() if c}


def _plan_cost(
    plan: dict[str, int], shapes_by_name: dict[str, CatalogShape]
) -> float:
    return float(
        sum(shapes_by_name[n].unit_cost * c for n, c in plan.items())
    )


def _shadow_report(
    plan: dict[str, int],
    shapes_by_name: dict[str, CatalogShape],
    cpu_s: int,
    mem_s: int,
) -> tuple[dict[str, float], float | None]:
    """Which resource binds the purchased capacity at the
    quantile-realizing sample, as count-weighted fractions, plus the
    marginal cost of one more replica there."""
    weights = {r: 0.0 for r in _RESOURCE_ORDER}
    total = 0
    demand_price = None
    for name, count in plan.items():
        shape = shapes_by_name[name]
        cpu_fit = shape.cpu_milli // max(cpu_s, 1)
        mem_fit = shape.mem_bytes // max(mem_s, 1)
        by = {"cpu": cpu_fit, "memory": mem_fit, "pods": shape.pods}
        binding = min(_RESOURCE_ORDER, key=lambda r: (by[r], _RESOURCE_ORDER.index(r)))
        weights[binding] += count
        total += count
        fit = min(by.values())
        if fit > 0:
            price = shape.unit_cost / fit
            if demand_price is None or price < demand_price:
                demand_price = price
    if total:
        weights = {r: w / total for r, w in weights.items()}
    return weights, demand_price


def _drain_analysis(
    snapshot: ClusterSnapshot,
    cpu: np.ndarray,
    mem: np.ndarray,
    mode: str,
    node_mask,
    q: float,
    target: int,
    *,
    max_nodes: int = 200_000,
    max_list: int = 20,
) -> dict:
    """The scale-down dual: per-node per-sample fits (pure numpy, the
    oracle arithmetic), nodes with zero contribution at EVERY sample
    (drainable for free — the stochastic zero shadow price), then a
    greedy surplus drain holding the exact quantile at ``target``.
    Every drained set is re-verified by exact recomputation before it
    is reported."""
    n = snapshot.n_nodes
    if n > max_nodes:
        return {
            "evaluated": False,
            "reason": f"{n} nodes exceeds the drain analysis cap "
            f"{max_nodes}",
        }
    fits = _per_node_fits(snapshot, cpu, mem, mode, node_mask)
    totals = fits.sum(axis=1, dtype=np.int64)
    zero = ~fits.any(axis=0)
    if node_mask is not None:
        zero &= np.asarray(node_mask, dtype=bool)  # masked-out ≠ drainable
    free_idx = np.flatnonzero(zero)
    # Oracle verification: removing the free set must not move ANY
    # sample's total (their columns are zero by construction — assert
    # it, because "verified drainable" is the contract, not a comment).
    active = totals - fits[:, free_idx].sum(axis=1, dtype=np.int64)
    verified_free = bool(np.array_equal(active, totals))
    drained: list[int] = []
    running = totals.copy()
    if verified_free:
        order = np.argsort(fits.sum(axis=0), kind="stable")
        for i in order:
            if zero[i]:
                continue
            cand = running - fits[:, i]
            if _quantile_value(cand, q) < target:
                continue
            running = cand
            drained.append(int(i))
    names = list(snapshot.names)
    return {
        "evaluated": True,
        "free_count": int(free_idx.shape[0]),
        "free_verified": verified_free,
        "free_nodes": [names[int(i)] for i in free_idx[:max_list]],
        "surplus_count": len(drained),
        "surplus_nodes": [names[i] for i in drained[:max_list]],
        "quantile_after_drain": (
            _quantile_value(running, q) if verified_free else None
        ),
    }


def _per_node_fits(
    snapshot: ClusterSnapshot,
    cpu_reqs: np.ndarray,
    mem_reqs: np.ndarray,
    mode: str,
    node_mask,
    chunk: int = 8,
) -> np.ndarray:
    """``[S, N]`` per-node fits with the exact oracle arithmetic of
    :func:`~..stochastic.car.fit_totals_numpy`, reduction omitted."""
    alloc_cpu_u = np.asarray(snapshot.alloc_cpu_milli, dtype=np.int64).astype(
        np.uint64
    )
    used_cpu_u = np.asarray(
        snapshot.used_cpu_req_milli, dtype=np.int64
    ).astype(np.uint64)
    alloc_mem = np.asarray(snapshot.alloc_mem_bytes, dtype=np.int64)
    used_mem = np.asarray(snapshot.used_mem_req_bytes, dtype=np.int64)
    alloc_pods = np.asarray(snapshot.alloc_pods, dtype=np.int64)
    pods_count = np.asarray(snapshot.pods_count, dtype=np.int64)
    healthy_b = np.asarray(snapshot.healthy, dtype=bool)
    cpu_reqs = np.asarray(cpu_reqs, dtype=np.int64)
    mem_reqs = np.asarray(mem_reqs, dtype=np.int64)
    mask = None if node_mask is None else np.asarray(node_mask, dtype=bool)
    s = cpu_reqs.shape[0]
    out = np.empty((s, alloc_cpu_u.shape[0]), dtype=np.int64)
    mem_head = alloc_mem - used_mem
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
            quot = mem_head[None, :] // den
            rem = mem_head[None, :] - quot * den
            fix = (rem != 0) & ((mem_head[None, :] < 0) != (den < 0))
            mem_fit = np.where(
                alloc_mem[None, :] <= used_mem[None, :],
                np.int64(0),
                quot + fix.astype(np.int64),
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
            out[lo:hi] = fit
    return out


def plan_capacity(
    snapshot: ClusterSnapshot,
    spec: StochasticSpec,
    catalog: tuple[CatalogShape, ...],
    *,
    target: int | None = None,
    quantile: float = 0.95,
    mode: str | None = None,
    node_mask=None,
    drain: bool = False,
    device="cuda",
) -> PlanResult:
    """Answer "cheapest node set restoring the q-quantile ≥ target".

    Draws the spec's samples (same seed streams as capacity-at-risk),
    evaluates the CURRENT base capacity as one production sweep
    dispatch, then plans over the catalog with exact integer
    evaluation: minimal single-shape plans by binary search, a greedy
    best-gain-per-cost mix, an overshoot trim — cheapest feasible plan
    wins.  Certification re-derives base totals AND shape columns with
    the pure-numpy oracle and confirms the purchase restores the
    quantile; see the module docstring for the contract and the
    ``lp_bound`` derivation.  ``target`` defaults to the spec's
    requested replicas; ``drain=True`` adds the scale-down analysis.
    """
    if not catalog:
        raise PlannerError("catalog wants at least one node shape")
    if not 0.0 < quantile < 1.0:
        raise PlannerError(
            f"quantile must be in (0, 1), got {quantile!r}"
        )
    mode = mode or snapshot.semantics
    target = int(spec.replicas if target is None else target)
    if target < 1:
        raise PlannerError(f"target must be >= 1, got {target}")
    t0 = time.perf_counter()
    n = spec.n_samples()
    cpu = sample_usage(spec.cpu, n, sample_key(spec.seed, 0), device=device)
    mem = sample_usage(spec.memory, n, sample_key(spec.seed, 1), device=device)
    grid = ScenarioGrid(
        cpu_request_milli=cpu,
        mem_request_bytes=mem,
        replicas=np.full(n, int(spec.replicas), dtype=np.int64),
    )
    base = np.asarray(
        sweep_snapshot(
            snapshot, grid, mode=mode, node_mask=node_mask, device=device
        )[0],
        dtype=np.int64,
    )
    fits = np.stack([_fresh_node_fits(s, cpu, mem) for s in catalog])
    costs = np.array([s.unit_cost for s in catalog], dtype=np.float64)
    shapes_by_name = {s.name: s for s in catalog}
    fits_by_name = {s.name: fits[j] for j, s in enumerate(catalog)}

    base_q = _quantile_value(base, quantile)
    deficits = np.maximum(target - base, 0).astype(np.float64)
    need = n - quantile_index(n, quantile)
    bound = _lp_bound(deficits, fits.astype(np.float64), costs, need)

    candidates = _single_shape_plans(base, fits, catalog, quantile, target)
    mix = _greedy_mix(base, fits, catalog, quantile, target)
    if mix is not None:
        candidates.append(mix)
    candidates = [
        _trim(p, base, fits_by_name, shapes_by_name, quantile, target)
        for p in candidates
    ]
    plan: dict[str, int] = {}
    satisfiable = base_q >= target
    if base_q < target and candidates:
        plan = min(
            candidates,
            key=lambda p: (_plan_cost(p, shapes_by_name), sorted(p.items())),
        )
        satisfiable = True
    cost = _plan_cost(plan, shapes_by_name)

    # -- cannot-lie certification: pure-numpy re-derivation ------------
    certified = False
    reason: str | None = None
    projected_q = base_q
    if not satisfiable:
        reason = (
            f"target {target} unreachable within the catalog's "
            "max_count bounds"
        )
    else:
        base_oracle = fit_totals_numpy(
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
        if not np.array_equal(base_oracle, base):
            reason = (
                "dispatch/oracle divergence on the base sweep — the "
                "plan was proposed from totals the oracle disputes"
            )
        else:
            columns_ok = all(
                np.array_equal(
                    fits[j], _oracle_shape_fits(s, cpu, mem, mode)
                )
                for j, s in enumerate(catalog)
            )
            if not columns_ok:
                reason = (
                    "catalog fit column disagrees with the numpy oracle"
                )
            else:
                projected = base_oracle.copy()
                for name, count in plan.items():
                    projected = projected + count * fits_by_name[name]
                projected_q = _quantile_value(projected, quantile)
                if projected_q >= target:
                    certified = True
                else:
                    reason = (
                        f"exact re-evaluation reaches only "
                        f"{projected_q} < target {target}"
                    )
    if satisfiable and plan:
        projected_totals = base.copy()
        for name, count in plan.items():
            projected_totals = projected_totals + count * fits_by_name[name]
        projected_q = _quantile_value(projected_totals, quantile)

    s_idx = np.argsort(base, kind="stable")[quantile_index(n, quantile)]
    shadow, demand_price = _shadow_report(
        plan or {s.name: 1 for s in catalog},
        shapes_by_name,
        int(cpu[s_idx]),
        int(mem[s_idx]),
    )
    drain_report = None
    if drain:
        drain_report = _drain_analysis(
            snapshot, np.asarray(cpu), np.asarray(mem), mode, node_mask,
            quantile, min(target, base_q),
        )
    return PlanResult(
        mode=mode,
        quantile=quantile,
        target=target,
        n_samples=n,
        seed=spec.seed,
        shapes=catalog,
        buy=plan,
        base_quantile_capacity=base_q,
        projected_quantile_capacity=projected_q,
        total_cost=cost,
        lp_bound=bound if satisfiable else float("inf"),
        satisfiable=satisfiable,
        certified=certified,
        uncertified_reason=reason,
        shadow_prices=shadow,
        demand_price=demand_price,
        drain=drain_report,
        eval_ms=(time.perf_counter() - t0) * 1e3,
    )


def apply_plan(
    snapshot: ClusterSnapshot,
    catalog: tuple[CatalogShape, ...],
    buy: dict[str, int],
) -> ClusterSnapshot:
    """The purchase applied: a new snapshot with ``buy``'s nodes
    appended as empty, healthy rows (what the cluster looks like after
    the autoscaler acts) — the recovery half of the forecast funnel."""
    shapes_by_name = {s.name: s for s in catalog}
    names = list(snapshot.names)
    cols = {
        f: [int(v) for v in np.asarray(getattr(snapshot, f))]
        for f in (
            "alloc_cpu_milli",
            "alloc_mem_bytes",
            "alloc_pods",
            "used_cpu_req_milli",
            "used_cpu_lim_milli",
            "used_mem_req_bytes",
            "used_mem_lim_bytes",
            "pods_count",
        )
    }
    healthy = [bool(v) for v in np.asarray(snapshot.healthy)]
    labels = list(snapshot.labels)
    taints = list(snapshot.taints)
    extended = {
        r: (np.asarray(a), np.asarray(u))
        for r, (a, u) in snapshot.extended.items()
    }
    added = 0
    for shape_name in sorted(buy):
        count = int(buy[shape_name])
        shape = shapes_by_name.get(shape_name)
        if shape is None:
            raise PlannerError(
                f"buy names unknown catalog shape {shape_name!r}"
            )
        for k in range(count):
            names.append(f"{shape.name}-plan-{k}")
            cols["alloc_cpu_milli"].append(shape.cpu_milli)
            cols["alloc_mem_bytes"].append(shape.mem_bytes)
            cols["alloc_pods"].append(shape.pods)
            for f in (
                "used_cpu_req_milli",
                "used_cpu_lim_milli",
                "used_mem_req_bytes",
                "used_mem_lim_bytes",
                "pods_count",
            ):
                cols[f].append(0)
            healthy.append(True)
            if labels:
                labels.append({})
            if taints:
                taints.append([])
            added += 1
    if extended and added:
        extended = {
            r: (
                np.concatenate([a, np.zeros(added, dtype=np.int64)]),
                np.concatenate([u, np.zeros(added, dtype=np.int64)]),
            )
            for r, (a, u) in extended.items()
        }
    return ClusterSnapshot(
        names=names,
        alloc_cpu_milli=np.asarray(cols["alloc_cpu_milli"], dtype=np.int64),
        alloc_mem_bytes=np.asarray(cols["alloc_mem_bytes"], dtype=np.int64),
        alloc_pods=np.asarray(cols["alloc_pods"], dtype=np.int64),
        used_cpu_req_milli=np.asarray(
            cols["used_cpu_req_milli"], dtype=np.int64
        ),
        used_cpu_lim_milli=np.asarray(
            cols["used_cpu_lim_milli"], dtype=np.int64
        ),
        used_mem_req_bytes=np.asarray(
            cols["used_mem_req_bytes"], dtype=np.int64
        ),
        used_mem_lim_bytes=np.asarray(
            cols["used_mem_lim_bytes"], dtype=np.int64
        ),
        pods_count=np.asarray(cols["pods_count"], dtype=np.int64),
        healthy=np.asarray(healthy, dtype=bool),
        semantics=snapshot.semantics,
        extended=extended,
        labels=labels,
        taints=taints,
        node_log=list(snapshot.node_log),
        pod_cpu_errs=list(snapshot.pod_cpu_errs),
    )
