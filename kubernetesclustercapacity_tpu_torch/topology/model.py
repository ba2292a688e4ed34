"""Node-label topology helpers.

Counterpart of the part of ``kubernetesclustercapacity_tpu/topology/
model.py`` that the ported surfaces need: :func:`label_codes` (one label
key's values → dense small-int domain codes on the node axis, with an
explicit missing-label policy) and :func:`node_name_index` (the
name→row map that hostname identity resolves through).
:meth:`..models.capacity.CapacityModel.topology_spread` and
``_place_spread`` read domains through :func:`label_codes` with the
``"exclude"`` policy; :func:`..masks.anti_affinity_existing_mask` resolves
hostnames through :func:`node_name_index`.

Missing labels are an explicit policy (``missing=``):

* ``"own"`` — an unlabeled node forms its own singleton domain (named
  ``~node:<row>``);
* ``"exclude"`` — an unlabeled node gets code ``-1``: it belongs to no
  domain and contributes nothing to any domain-level capacity.
"""

from __future__ import annotations

import numpy as np

__all__ = ["label_codes", "node_name_index"]

_MISSING_POLICIES = ("own", "exclude")


def label_codes(
    labels,
    key: str,
    *,
    missing: str = "own",
    eligible=None,
    n_nodes: int | None = None,
):
    """THE label→code helper: one level's label values → dense codes.

    Returns ``(codes[N] int64, domains, missing_count)`` — ``domains``
    is the value list in first-eligible-row order (``codes[i]`` indexes
    it), ``missing_count`` how many eligible rows lacked the key.

    ``labels`` is the snapshot's per-node label-dict list (rows beyond
    its length count as unlabeled — fixture-less snapshots carry an
    empty list); ``eligible`` (``[N]`` bool, optional) restricts which
    rows mint domains at all — an ineligible row keeps code ``-1`` and
    is NOT counted as missing, exactly the membership rule
    ``CapacityModel.topology_spread`` has always applied.  ``missing``
    picks the unlabeled-row policy documented in the module docstring.
    """
    if missing not in _MISSING_POLICIES:
        raise ValueError(
            f"missing-label policy must be one of {_MISSING_POLICIES}, "
            f"got {missing!r}"
        )
    n = len(labels) if n_nodes is None else int(n_nodes)
    codes = np.full(n, -1, dtype=np.int64)
    domains: list = []
    ids: dict = {}
    missing_count = 0
    for i in range(n):
        if eligible is not None and not eligible[i]:
            continue
        row = labels[i] if i < len(labels) else None
        value = (row or {}).get(key)
        if value is None:
            missing_count += 1
            if missing == "own":
                codes[i] = len(domains)
                domains.append(f"~node:{i}")
            continue
        code = ids.get(value)
        if code is None:
            code = ids[value] = len(domains)
            domains.append(value)
        codes[i] = code
    return codes, domains, missing_count


def node_name_index(snapshot) -> dict[str, int]:
    """Node name → row index — the hostname-identity rule shared by the
    anti-affinity mask's hostname topology and the topology model.

    Duplicate names keep the LAST row (dict-comprehension semantics,
    pinned by tests: the pre-topology ``masks.py`` behaved this way and
    reference-mode phantom rows all share the ``""`` key); a pod naming
    a node outside this map is excluded from hostname-topology effects.
    """
    return {name: i for i, name in enumerate(snapshot.names)}

