"""Scheduling-constraint masks: boolean ``[N]`` node masks from snapshot
metadata.

Counterpart of ``kubernetesclustercapacity_tpu/masks.py`` (numpy only).
The reference ignores taints, selectors and affinity; real scheduling gates
placement on them, and every family reduces to a node mask ANDed into the
sweep.  Ported families: taints × tolerations (``NoSchedule``/
``NoExecute``; ``PreferNoSchedule`` is soft and ignored), ``nodeSelector``,
required node affinity, and anti-affinity against existing pods over the
hostname topology.
"""

from __future__ import annotations

import numpy as np

from kubernetesclustercapacity_tpu_torch.snapshot import ClusterSnapshot
from kubernetesclustercapacity_tpu_torch.topology.model import (
    node_name_index,
)

__all__ = [
    "tolerations_mask",
    "node_selector_mask",
    "node_affinity_mask",
    "anti_affinity_existing_mask",
    "combine_masks",
    "implicit_taint_mask",
]

_HARD_EFFECTS = ("NoSchedule", "NoExecute")


def _toleration_matches(tol: dict, taint: dict) -> bool:
    """Kubernetes toleration-matches-taint predicate.

    ``operator: Exists`` with an empty key tolerates every taint; otherwise
    keys must match, ``Equal`` (the default operator) also requires value
    equality, and an empty toleration effect matches all effects.
    """
    t_effect = tol.get("effect", "")
    if t_effect and t_effect != taint.get("effect", ""):
        return False
    op = tol.get("operator", "Equal")
    key = tol.get("key", "")
    if op == "Exists":
        return key == "" or key == taint.get("key", "")
    return key == taint.get("key", "") and tol.get("value", "") == taint.get(
        "value", ""
    )


def tolerations_mask(
    snapshot: ClusterSnapshot, tolerations: list[dict] | None
) -> np.ndarray:
    """``mask[n]`` — every hard taint on node ``n`` is tolerated."""
    tolerations = tolerations or []
    mask = np.ones(snapshot.n_nodes, dtype=np.bool_)
    for i, taints in enumerate(snapshot.taints):
        for taint in taints or []:
            if taint.get("effect") not in _HARD_EFFECTS:
                continue
            if not any(_toleration_matches(t, taint) for t in tolerations):
                mask[i] = False
                break
    return mask


def node_selector_mask(
    snapshot: ClusterSnapshot, node_selector: dict | None
) -> np.ndarray:
    """``mask[n]`` — node labels contain every (key, value) of the selector."""
    if not node_selector:
        return np.ones(snapshot.n_nodes, dtype=np.bool_)
    mask = np.empty(snapshot.n_nodes, dtype=np.bool_)
    for i, labels in enumerate(snapshot.labels):
        labels = labels or {}
        mask[i] = all(labels.get(k) == v for k, v in node_selector.items())
    return mask


def _expr_matches(labels: dict, expr: dict) -> bool:
    key = expr.get("key", "")
    op = expr.get("operator", "In")
    values = expr.get("values", [])
    present = key in labels
    if op == "In":
        return present and labels[key] in values
    if op == "NotIn":
        return not present or labels[key] not in values
    if op == "Exists":
        return present
    if op == "DoesNotExist":
        return not present
    if op in ("Gt", "Lt"):
        if not present or not values:
            return False
        try:
            label_val = int(labels[key])
            bound = int(values[0])
        except ValueError:
            return False
        return label_val > bound if op == "Gt" else label_val < bound
    raise ValueError(f"unknown match-expression operator {op!r}")


def _field_matches(node_name: str, expr: dict) -> bool:
    """``matchFields`` against the one field Kubernetes supports,
    ``metadata.name`` with ``In``/``NotIn``; anything else is a malformed
    spec and raises."""
    key = expr.get("key")
    if key != "metadata.name":
        raise ValueError(
            f"unsupported matchFields key {key!r} (only metadata.name)"
        )
    op = expr.get("operator", "In")
    values = expr.get("values", [])
    if op == "In":
        return node_name in values
    if op == "NotIn":
        return node_name not in values
    raise ValueError(f"unknown matchFields operator {op!r}")


def node_affinity_mask(
    snapshot: ClusterSnapshot, node_selector_terms: list[dict] | None
) -> np.ndarray:
    """Required node-affinity: terms OR-ed; a term's ``matchExpressions``
    AND ``matchFields`` must ALL hold.  An empty term matches NO nodes,
    as in kube-scheduler."""
    if not node_selector_terms:
        return np.ones(snapshot.n_nodes, dtype=np.bool_)

    def term_matches(term: dict, labels: dict, node_name: str) -> bool:
        exprs = term.get("matchExpressions") or []
        fields = term.get("matchFields") or []
        if not exprs and not fields:
            return False  # nil term selects nothing
        return all(_expr_matches(labels, e) for e in exprs) and all(
            _field_matches(node_name, f) for f in fields
        )

    mask = np.zeros(snapshot.n_nodes, dtype=np.bool_)
    for i, labels in enumerate(snapshot.labels):
        labels = labels or {}
        mask[i] = any(
            term_matches(term, labels, snapshot.names[i])
            for term in node_selector_terms
        )
    return mask


def anti_affinity_existing_mask(
    snapshot: ClusterSnapshot,
    fixture: dict,
    label_selector: dict,
    *,
    namespace: str | None = None,
) -> np.ndarray:
    """Anti-affinity vs existing pods: exclude nodes hosting a matching pod.

    Hostname topology: a node is infeasible if any non-terminated pod on it
    carries all the selector labels (the fixture pods' optional ``labels``
    key).  ``namespace`` scopes the match as a ``PodAffinityTerm`` with no
    ``namespaces`` field does, to the incoming pod's own namespace;
    ``None`` matches cluster-wide (a what-if spec that models no
    namespace).  Hostname identity is the node name: a pod whose
    ``nodeName`` names no snapshot row repels nothing, and duplicate names
    keep the last row (:func:`.topology.model.node_name_index`).
    """
    node_index = node_name_index(snapshot)
    mask = np.ones(snapshot.n_nodes, dtype=np.bool_)
    for pod in fixture.get("pods", []):
        if pod.get("phase") in ("Succeeded", "Failed"):
            continue
        if namespace is not None and pod.get("namespace", "") != namespace:
            continue
        i = node_index.get(pod.get("nodeName", ""))
        if i is None:
            continue
        pod_labels = pod.get("labels", {}) or {}
        if all(pod_labels.get(k) == v for k, v in label_selector.items()):
            mask[i] = False
    return mask


def combine_masks(*masks: np.ndarray | None) -> np.ndarray | None:
    """AND together any number of optional ``[N]`` masks (None = all-true)."""
    out = None
    for m in masks:
        if m is None:
            continue
        out = m.copy() if out is None else (out & m)
    return out


def implicit_taint_mask(snap: ClusterSnapshot) -> np.ndarray | None:
    """Strict semantics honors hard taints even on plain-flag queries (an
    untolerating pod never lands on a NoSchedule node).  ``None`` when
    nothing is tainted or semantics is reference (the reference ignores
    taints).  Every strict surface that evaluates a plain spec — the CLI
    ``-grid`` path included — applies this same mask, so one spec gets one
    answer on every surface.
    """
    if snap.semantics != "strict" or not any(snap.taints or []):
        return None
    return tolerations_mask(snap, [])
