"""Preemption-aware capacity: priority-threshold suffix tables + fit.

Counterpart of ``kubernetesclustercapacity_tpu/ops/preemption.py``.  The
reference has no notion of pod priority — every Running pod consumes
capacity (``ClusterCapacity.go:105-140`` sums all of them).  A real
scheduler may *preempt*: a pending pod of priority ``p`` can evict pods of
strictly lower priority.  This module answers the preemption-aware upper
bound: how many replicas of a priority-``p`` pod fit if every
lower-priority pod may be evicted?

Survivors are the pods with ``priority >= p``, so the usable headroom is
``alloc - used_by(priority >= p)``, a suffix sum over the sorted distinct
priority levels present in the cluster:

* :func:`build_priority_table` walks the fixture once on the host (the
  strict packer's rules: assigned, non-terminated pods, effective
  ``max(sum(containers), max(initContainers))`` resources) into dense
  ``[N, K+1]`` tables, one suffix-summed column per level plus a final
  all-zero column for thresholds above every level;
* a threshold is then one column, and the exact fit
  (:func:`..fit.fit_per_node`) runs unchanged on it;
* :func:`sweep_preemption` takes ``[S]`` priorities: one
  ``searchsorted`` and one advanced index give every scenario's
  ``[S, N]`` usage columns, and the fit broadcasts over them — no loop
  over scenarios.

Strict semantics only (:class:`..models.capacity.CapacityModel` gates
it).  A pod's priority is the fixture pod's ``"priority"`` key (absent →
0).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from kubernetesclustercapacity_tpu_torch import devcache as _devcache
from kubernetesclustercapacity_tpu_torch.ops.fit import (
    fit_per_node,
    fit_per_node_multi,
)
from kubernetesclustercapacity_tpu_torch.snapshot import (
    _STRICT_TERMINATED,
    ClusterSnapshot,
    _effective_pod_resources,
)

__all__ = [
    "PreemptionExtendedError",
    "PriorityTable",
    "build_priority_table",
    "fit_with_preemption",
    "sweep_preemption",
]


class PreemptionExtendedError(ValueError):
    """An extended resource was requested that the priority table (or
    snapshot) carries no columns for — the preemptive fit would silently
    ignore the eviction gains on that resource, so it refuses instead."""


@dataclass
class PriorityTable:
    """Dense suffix-sum usage tables keyed by priority threshold.

    ``levels`` is the ascending ``[K]`` vector of distinct priorities among
    counted pods.  Every usage array is ``[N, K+1]`` int64: column ``k``
    holds what pods with ``priority >= levels[k]`` consume; the final
    column is all zeros (a threshold above every level evicts everything).
    Column 0 equals the snapshot's strict usage.
    """

    levels: np.ndarray  # [K] int64, ascending
    used_cpu_ge: np.ndarray  # [N, K+1] int64
    used_mem_ge: np.ndarray  # [N, K+1] int64
    pods_ge: np.ndarray  # [N, K+1] int64
    used_ext_ge: dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def n_nodes(self) -> int:
        return self.used_cpu_ge.shape[0]

    def column_index(self, priority: int) -> int:
        """Column for threshold ``priority``: the first level >= it
        (``side='left'``), or the zero column when it exceeds them all."""
        return int(np.searchsorted(self.levels, int(priority), side="left"))

    def columns(self, priority: int) -> tuple[np.ndarray, ...]:
        """``(used_cpu[N], used_mem[N], pods_count[N])`` for one threshold."""
        k = self.column_index(priority)
        return (self.used_cpu_ge[:, k], self.used_mem_ge[:, k],
                self.pods_ge[:, k])

    def multi_columns(
        self, priority: int, resources: tuple[str, ...]
    ) -> tuple[np.ndarray, np.ndarray]:
        """``(used_rn[R, N], pods_count[N])`` for one threshold, rows in
        ``resources`` order (``"cpu"``/``"memory"`` name the core columns,
        anything else gathers from :attr:`used_ext_ge`).  A resource the
        table has no suffix sums for raises
        :class:`PreemptionExtendedError`."""
        k = self.column_index(priority)
        rows = []
        for r in resources:
            if r == "cpu":
                rows.append(self.used_cpu_ge[:, k])
            elif r == "memory":
                rows.append(self.used_mem_ge[:, k])
            elif r in self.used_ext_ge:
                rows.append(self.used_ext_ge[r][:, k])
            else:
                raise PreemptionExtendedError(
                    f"priority table has no extended-resource columns "
                    f"for {r!r} (built with "
                    f"{tuple(sorted(self.used_ext_ge))}); rebuild with "
                    f"extended_resources including it"
                )
        return np.stack(rows), self.pods_ge[:, k]


def _suffix_sum(per_level: np.ndarray) -> np.ndarray:
    """``[N, K]`` per-level sums → ``[N, K+1]`` suffix sums + zero column."""
    n = per_level.shape[0]
    ge = np.cumsum(per_level[:, ::-1], axis=1)[:, ::-1]
    return np.concatenate([ge, np.zeros((n, 1), dtype=np.int64)], axis=1)


def build_priority_table(
    fixture: dict,
    snapshot: ClusterSnapshot,
    extended_resources: tuple[str, ...] = (),
) -> PriorityTable:
    """One host-side fixture walk → the dense ``[N, K+1]`` tables.

    Pod filtering and effective resources are the strict packer's
    (:func:`..snapshot._effective_pod_resources`), so column 0 reproduces
    the snapshot's ``used_*``/``pods_count`` columns bit for bit.
    """
    index = {name: i for i, name in enumerate(snapshot.names)}
    n = snapshot.n_nodes
    node_idx: list[int] = []
    prios: list[int] = []
    cpu_eff: list[int] = []
    mem_eff: list[int] = []
    ext_eff: dict[str, list[int]] = {r: [] for r in extended_resources}
    for pod in fixture.get("pods", []):
        node_name = pod.get("nodeName", "")
        if not node_name or node_name not in index:
            continue
        if pod.get("phase") in _STRICT_TERMINATED:
            continue
        eff = _effective_pod_resources(pod, extended_resources)
        node_idx.append(index[node_name])
        prios.append(int(pod.get("priority", 0)))
        cpu_eff.append(eff["cpu_req"])
        mem_eff.append(eff["mem_req"])
        for r in extended_resources:
            ext_eff[r].append(eff["ext"][r])

    levels = np.array(sorted(set(prios)), dtype=np.int64)  # [K]
    k = levels.shape[0]
    idx = np.asarray(node_idx, dtype=np.int64)
    li = np.searchsorted(levels, np.asarray(prios, dtype=np.int64))

    def table_for(values: list[int]) -> np.ndarray:
        per_level = np.zeros((n, k), dtype=np.int64)
        np.add.at(per_level, (idx, li), np.asarray(values, dtype=np.int64))
        return _suffix_sum(per_level)

    return PriorityTable(
        levels=levels,
        used_cpu_ge=table_for(cpu_eff),
        used_mem_ge=table_for(mem_eff),
        pods_ge=table_for([1] * len(node_idx)),
        used_ext_ge={r: table_for(ext_eff[r]) for r in extended_resources},
    )


def fit_with_preemption(
    snapshot: ClusterSnapshot,
    table: PriorityTable,
    cpu_req,
    mem_req,
    priority: int,
    *,
    mode: str = "strict",
    node_mask=None,
    extended_requests: dict[str, int] | None = None,
    device="cuda",
) -> np.ndarray:
    """Per-node preemptive fit for ONE spec — numpy ``[N]`` int64.

    Substitutes the threshold's usage columns into the exact fit; the
    epilogue and the mask are :func:`..fit.fit_per_node`'s.  With
    ``extended_requests`` the table's extended suffix sums ride the
    R-resource fit (:func:`..fit.fit_per_node_multi`); a resource absent
    from the snapshot or the table raises
    :class:`PreemptionExtendedError`.
    """
    _, put = _devcache.int64_putter(device)
    mask = None if node_mask is None else put(node_mask, torch.bool)
    if extended_requests:
        resources = ("cpu", "memory", *sorted(extended_requests))
        missing = [
            r for r in resources[2:] if r not in snapshot.extended
        ]
        if missing:
            raise PreemptionExtendedError(
                f"snapshot has no extended columns for "
                f"{', '.join(map(repr, missing))} (packed with "
                f"{tuple(sorted(snapshot.extended))})"
            )
        alloc_rn, _ = snapshot.resource_matrix(resources)
        used_rn, pods_count = table.multi_columns(priority, resources)
        reqs = np.array(
            [
                int(cpu_req),
                int(mem_req),
                *(int(extended_requests[r]) for r in resources[2:]),
            ],
            dtype=np.int64,
        )
        fits = fit_per_node_multi(
            put(alloc_rn), put(used_rn), put(snapshot.alloc_pods),
            put(pods_count), put(snapshot.healthy, torch.bool), put(reqs),
            mode=mode, node_mask=mask,
        )
        return fits.cpu().numpy()
    used_cpu, used_mem, pods_count = table.columns(priority)
    fits = fit_per_node(
        put(snapshot.alloc_cpu_milli), put(snapshot.alloc_mem_bytes),
        put(snapshot.alloc_pods), put(used_cpu), put(used_mem),
        put(pods_count), put(snapshot.healthy, torch.bool),
        put(np.int64(cpu_req)), put(np.int64(mem_req)),
        mode=mode, node_mask=mask,
    )
    return fits.cpu().numpy()


def sweep_preemption(
    alloc_cpu,
    alloc_mem,
    alloc_pods,
    healthy,
    levels,
    used_cpu_ge,
    used_mem_ge,
    pods_ge,
    cpu_reqs,
    mem_reqs,
    priorities,
    replicas,
    *,
    mode: str = "strict",
    node_mask=None,
    ext_alloc=None,
    ext_used_ge=None,
    ext_reqs=None,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """S preemption scenarios in one pass on ``device``.

    ``priorities[S]`` map to table columns through one ``searchsorted``
    over ``levels[K]``; one advanced index per table gathers every
    scenario's ``[S, N]`` usage, and the exact fit broadcasts over it with
    ``[S, 1]`` requests.  Returns numpy ``(totals[S], schedulable[S])``.

    Extended resources ride three optional operands (all or none, rows in
    :meth:`PriorityTable.multi_columns` order): ``ext_alloc[E, N]``,
    ``ext_used_ge[E, N, K+1]`` and ``ext_reqs[S, E]``; each scenario then
    runs the R-resource fit on its gathered usage.  The ``[N, K+1]`` tables
    are gathered one row at a time, so no ``[S, N, K+1]`` tensor exists.
    """
    _, put = _devcache.int64_putter(device)
    kidx = torch.searchsorted(put(levels), put(priorities), side="left")
    used_cpu_ge, used_mem_ge, pods_ge = (
        put(used_cpu_ge), put(used_mem_ge), put(pods_ge)
    )
    mask = None if node_mask is None else put(node_mask, torch.bool)
    alloc_pods, healthy = put(alloc_pods), put(healthy, torch.bool)
    cpu = put(cpu_reqs)[:, None]
    mem = put(mem_reqs)[:, None]
    # [N, K+1] -> [S, N]: column kidx[s] of every node, per scenario.
    pods = pods_ge[:, kidx].T
    if ext_used_ge is not None:
        ext_used = put(ext_used_ge)  # [E, N, K+1]
        alloc_rn = torch.cat(
            [put(alloc_cpu)[None], put(alloc_mem)[None], put(ext_alloc)]
        )
        used_rn = [used_cpu_ge[:, kidx].T, used_mem_ge[:, kidx].T] + [
            ext_used[e][:, kidx].T for e in range(ext_used.shape[0])
        ]
        reqs = torch.cat([cpu, mem, put(ext_reqs)], dim=1)  # [S, R]
        fits = fit_per_node_multi(
            alloc_rn, used_rn, alloc_pods, pods, healthy, reqs,
            mode=mode, node_mask=mask,
        )
    else:
        fits = fit_per_node(
            put(alloc_cpu), put(alloc_mem), alloc_pods,
            used_cpu_ge[:, kidx].T, used_mem_ge[:, kidx].T, pods, healthy,
            cpu, mem, mode=mode, node_mask=mask,
        )
    totals = fits.sum(dim=1)
    sched = totals >= put(replicas)
    return totals.cpu().numpy(), sched.cpu().numpy()
