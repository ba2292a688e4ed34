"""PodDisruptionBudget accounting for the drain simulation.

Counterpart of ``kubernetesclustercapacity_tpu/pdb.py``.
:meth:`..models.capacity.CapacityModel.drain` gates evictions through
:func:`blocked_evictions`; the port's :class:`~.store.ClusterStore`
validates every PDB it admits through :func:`validate_selector` and
:func:`budget_statuses`.

``kubectl drain``'s other half — beyond finding room for rehomed pods —
is the eviction API's budget check: an eviction is REFUSED while the
covering PDB's ``allowedDisruptions`` is 0 ("cannot evict pod as it
would violate the pod's disruption budget").  The reference has no
eviction concept (`ClusterCapacity.go` never mutates the cluster);
this module gives the drain simulator the same gate.

Fixture schema extension — top-level ``"pdbs"``::

    {"pdbs": [{"name": "db", "namespace": "prod",
               "selector": {"matchLabels": {"app": "db"},
                            "matchExpressions": [...]},
               "minAvailable": 2}]}        # or "maxUnavailable": 1 / "25%"

Semantics mirror the disruption controller:

* ``expectedCount`` = pods matching the selector in the PDB's namespace
  (non-terminated).  ``currentHealthy`` = the assigned Running subset —
  the fixture schema carries no per-pod readiness, so Running stands in
  for Ready (documented proxy).
* Percentages scale by ``expectedCount`` and round UP (upstream
  ``GetScaledValueFromIntOrPercent(roundUp=true)`` for both fields).
* ``minAvailable``: ``desiredHealthy = minAvailable``;
  ``maxUnavailable``: ``desiredHealthy = expected - maxUnavailable``.
  A PDB carrying both is malformed (the API forbids it) — rejected.
* ``allowedDisruptions = max(currentHealthy - desiredHealthy, 0)``; an
  eviction is blocked when ANY matching PDB has 0 allowed (with
  multiple covering PDBs the real eviction API errors out — blocked
  here too).

This is the eviction API's *point-in-time* check: a real drain evicts
one pod at a time and waits for replacements to recover the budget, so
a node whose pods all rehome eventually empties even if several share
one PDB with allowance 1.  The simulator reports the instantaneous
gate, not the retry loop.
"""

from __future__ import annotations

from dataclasses import dataclass

from kubernetesclustercapacity_tpu_torch.masks import _expr_matches
from kubernetesclustercapacity_tpu_torch.snapshot import _STRICT_TERMINATED

__all__ = [
    "BudgetStatus",
    "blocked_evictions",
    "budget_statuses",
    "validate_selector",
]

# LabelSelector operators _expr_matches evaluates.  In/NotIn require a
# non-empty values list and Exists/DoesNotExist an empty one — upstream
# LabelSelectorRequirement validation, enforced here so a malformed
# selector fails at ADMISSION (store validation), not on a later drain.
_SELECTOR_OPS = frozenset(
    {"In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt"}
)


def validate_selector(selector: dict) -> None:
    """Structural validation of a full LabelSelector — every
    ``matchExpressions`` entry checked UNCONDITIONALLY (matching a probe
    pod can short-circuit on ``matchLabels`` and never evaluate the
    expressions, which is exactly how a malformed operator used to slip
    into the store).  Raises ValueError."""
    if not isinstance(selector, dict):
        raise ValueError(f"selector must be an object, got {selector!r}")
    match_labels = selector.get("matchLabels") or {}
    if not isinstance(match_labels, dict):
        raise ValueError(
            f"matchLabels must be an object, got {match_labels!r}"
        )
    exprs = selector.get("matchExpressions") or []
    if not isinstance(exprs, (list, tuple)):
        raise ValueError(
            f"matchExpressions must be a list, got {exprs!r}"
        )
    for expr in exprs:
        if not isinstance(expr, dict):
            raise ValueError(f"match expression must be an object: {expr!r}")
        op = expr.get("operator", "In")
        if op not in _SELECTOR_OPS:
            raise ValueError(f"unknown match-expression operator {op!r}")
        values = expr.get("values", [])
        if not isinstance(values, (list, tuple)):
            raise ValueError(
                f"match-expression values must be a list, got {values!r}"
            )
        if op in ("In", "NotIn") and not values:
            raise ValueError(
                f"operator {op} requires a non-empty values list"
            )
        if op in ("Exists", "DoesNotExist") and values:
            raise ValueError(
                f"operator {op} must not carry values, got {list(values)!r}"
            )


@dataclass(frozen=True)
class BudgetStatus:
    """One PDB's disruption arithmetic at this snapshot instant."""

    name: str
    namespace: str
    expected: int  # matching non-terminated pods
    healthy: int  # the assigned Running subset (readiness proxy)
    desired_healthy: int
    allowed_disruptions: int


def _selector_matches(selector: dict, labels: dict) -> bool:
    """Full LabelSelector: matchLabels AND-ed with matchExpressions.
    An empty selector matches everything in the namespace (the API's
    ``{}`` selector), like upstream."""
    for k, v in (selector.get("matchLabels") or {}).items():
        if labels.get(k) != v:
            return False
    return all(
        _expr_matches(labels, e)
        for e in selector.get("matchExpressions") or []
    )


def _scaled(value, expected: int, field: str) -> int:
    """intstr: plain int, or "N%" scaled by expected, rounded UP.

    Negative values are rejected (the API validates both fields as
    non-negative): a negative ``minAvailable`` would otherwise silently
    yield ``allowed_disruptions == healthy`` — every eviction waved
    through by a budget that was supposed to protect the workload.
    """
    if isinstance(value, str) and value.endswith("%"):
        try:
            pct = int(value[:-1])
        except ValueError:
            raise ValueError(f"PDB {field}: bad percentage {value!r}") from None
        if pct < 0:
            raise ValueError(f"PDB {field}: must be >= 0, got {value!r}")
        return -(-pct * expected // 100)
    n = int(value)
    if n < 0:
        raise ValueError(f"PDB {field}: must be >= 0, got {n}")
    return n


def budget_statuses(fixture: dict) -> list[BudgetStatus]:
    """Evaluate every fixture PDB against the fixture's pods."""
    out = []
    for pdb in fixture.get("pdbs", []):
        name = pdb.get("name", "")
        namespace = pdb.get("namespace", "")
        selector = pdb.get("selector") or {}
        has_min = "minAvailable" in pdb
        has_max = "maxUnavailable" in pdb
        if has_min == has_max:
            raise ValueError(
                f"PDB {namespace}/{name}: exactly one of minAvailable / "
                "maxUnavailable (the API forbids both or neither)"
            )
        expected = healthy = 0
        for pod in fixture.get("pods", []):
            if pod.get("namespace", "") != namespace:
                continue
            if pod.get("phase") in _STRICT_TERMINATED:
                continue
            if not _selector_matches(selector, pod.get("labels") or {}):
                continue
            expected += 1
            if pod.get("phase") == "Running" and pod.get("nodeName"):
                healthy += 1
        if has_min:
            desired = _scaled(pdb["minAvailable"], expected, "minAvailable")
        else:
            desired = expected - _scaled(
                pdb["maxUnavailable"], expected, "maxUnavailable"
            )
        out.append(
            BudgetStatus(
                name=name,
                namespace=namespace,
                expected=expected,
                healthy=healthy,
                desired_healthy=desired,
                allowed_disruptions=max(healthy - desired, 0),
            )
        )
    return out


def blocked_evictions(
    fixture: dict, pod_keys: list[str]
) -> dict[str, list[str]]:
    """Which of ``pod_keys`` ("namespace/name") the eviction API would
    refuse right now, mapped to the responsible PDB names.

    Two refusal modes, both upstream behavior: a pod whose ONE covering
    budget has zero allowance ("would violate the pod's disruption
    budget"), and a pod covered by TWO OR MORE budgets — the eviction
    API errors out on multi-coverage regardless of allowances ("This
    pod has more than one PodDisruptionBudget").  Unblocked pods are
    absent from the result."""
    statuses = budget_statuses(fixture)
    if not statuses:
        return {}
    selectors = [
        (s, (fixture_pdb.get("selector") or {}))
        for s, fixture_pdb in zip(statuses, fixture.get("pdbs", []))
    ]
    by_key = {
        f"{p.get('namespace', '')}/{p.get('name', '')}": p
        for p in fixture.get("pods", [])
    }
    blocked: dict[str, list[str]] = {}
    for key in pod_keys:
        pod = by_key.get(key)
        if pod is None:
            continue
        covering = [
            s
            for s, selector in selectors
            if s.namespace == pod.get("namespace", "")
            and _selector_matches(selector, pod.get("labels") or {})
        ]
        if len(covering) >= 2 or (
            len(covering) == 1 and covering[0].allowed_disruptions <= 0
        ):
            blocked[key] = [s.name for s in covering]
    return blocked
