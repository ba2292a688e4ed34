"""Synthetic cluster fixture generation — the fake-cluster backend.

Counterpart of ``kubernetesclustercapacity_tpu/fixtures.py``: the same
deterministic, seedable generator of node/pod fixtures in the reference's
schema (memory in ``Ki``, the legacy 5-condition layout, ~110-pod
capacity), so the same seed gives the same fixture in both packages.
The R-resource workload helper is not ported yet.
"""

from __future__ import annotations

import json

__all__ = ["synthetic_fixture", "load_fixture", "save_fixture"]

# Legacy 5-condition layout the reference's health check hardcodes
# (SURVEY.md §2.2 C3): the first four must be "False" for a node to count.
_CONDITION_TYPES = (
    "OutOfDisk",
    "MemoryPressure",
    "DiskPressure",
    "PIDPressure",
    "Ready",
)

_CPU_CORES_CHOICES = (2, 4, 8, 16, 32, 64)
_CONTAINER_CPU_REQ = ("50m", "100m", "250m", "500m", "1", "2")
_CONTAINER_MEM_REQ = ("64Mi", "128Mi", "256Mi", "512Mi", "1Gi", "2Gi")


def synthetic_fixture(
    n_nodes: int,
    *,
    seed: int = 0,
    pods_per_node: int = 12,
    unhealthy_frac: float = 0.05,
    unparseable_mem_frac: float = 0.02,
    unscheduled_running_pods: int = 0,
    taint_frac: float = 0.0,
    topology: tuple[int, int] | None = None,
) -> dict:
    """Generate a deterministic fixture of ``n_nodes`` nodes and their pods.

    * ``unhealthy_frac`` of nodes get a pressure condition ``"True"`` → the
      reference health check skips them, leaving phantom zero-nodes (Q4).
    * ``unparseable_mem_frac`` of nodes advertise memory as ``"<n>Gi"`` —
      which ``bytefmt`` rejects, zeroing that node's memory (Q5).
    * ``unscheduled_running_pods`` adds Running pods with an empty
      ``nodeName`` — these bind to phantom nodes through the degenerate field
      selector (Q4).
    * ``taint_frac`` of nodes carry a NoSchedule taint (used by the
      constraint-mask layer; invisible to reference semantics).
    * ``topology=(zones, racks_per_zone)`` labels every node with the
      well-known ``topology.kubernetes.io/{zone,rack}`` keys,
      round-robin over ``zones * racks_per_zone`` racks.  Rack label
      VALUES repeat across zones (``r0`` exists in every zone) on
      purpose — the topology model must nest them into distinct
      domains.  Assignment is columnar (two numpy gathers feeding the
      per-node dict literal), so hierarchical fleets build without any
      new per-node Python work.

    Pod phases are mostly Running with a sprinkle of every excluded phase, so
    the Running-only field-selector semantics (Q7) are exercised.

    .. note:: The returned fixture ALIASES mutable objects: one shared
       container dict per distinct request shape, one shared containers
       LIST per distinct per-pod shape combination, one shared
       initContainers list, and one shared conditions list for all healthy
       nodes (a few dozen objects serve ~100k containers — this is where
       the generator's speed comes from).  Treat fixtures as immutable
       JSON-shaped data, as every framework consumer does; to tweak one
       pod in place, ``json.loads(json.dumps(fx))`` first (or replace
       whole containers/conditions values rather than mutating them).
       Per-node dicts (``allocatable``, ``labels``, ``taints``) are NOT
       shared.
    """
    # All randomness is pre-drawn as numpy arrays (one generator call per
    # decision KIND, not per object), per-container attributes collapse to
    # ONE integer shape code via numpy column math, every repeated
    # sub-object (container dicts, per-pod container lists, conditions)
    # is interned, and the per-pod columns (names, node names, phases,
    # namespaces, container lists) are assembled as whole columns —
    # object-array gathers and C-level repeats — so the only per-pod
    # Python bytecode left is one dict literal in a zip comprehension.
    # Same schema and distributions; per-seed VALUES differ from earlier
    # generator versions (tests compare paths on the same fixture, never
    # absolute contents).
    import gc

    import numpy as np

    rng = np.random.default_rng(seed)
    nodes = []

    cores_all = rng.choice(np.asarray(_CPU_CORES_CHOICES), size=n_nodes)
    mem_slack = rng.integers(0, 2**18, size=n_nodes)
    unhealthy_all = rng.random(n_nodes) < unhealthy_frac
    unhealthy_cond = rng.integers(0, 4, size=n_nodes)
    unparseable_all = rng.random(n_nodes) < unparseable_mem_frac
    tainted_all = rng.random(n_nodes) < taint_frac
    pods_per = rng.integers(0, pods_per_node * 2, size=n_nodes)

    n_pods = int(pods_per.sum()) + unscheduled_running_pods
    _PHASES = ("Running", "Pending", "Succeeded", "Failed", "Unknown")
    phase_idx = rng.choice(
        np.arange(len(_PHASES)),
        size=n_pods,
        p=np.asarray((88, 4, 4, 2, 2)) / 100.0,
    )
    _NAMESPACES = ("default", "kube-system", "batch", "web")
    ns_idx = rng.choice(np.arange(len(_NAMESPACES)), size=n_pods)
    n_containers = rng.choice(
        np.asarray((1, 2, 3)), size=n_pods, p=np.asarray((0.7, 0.2, 0.1))
    )
    has_init = rng.random(n_pods) < 0.1
    n_total_containers = int(n_containers.sum())
    has_req = rng.random(n_total_containers) < 0.9
    has_lim = rng.random(n_total_containers) < 0.7
    cpu_idx = rng.integers(0, len(_CONTAINER_CPU_REQ), size=n_total_containers)
    mem_idx = rng.integers(0, len(_CONTAINER_MEM_REQ), size=n_total_containers)

    # One integer code per container: (cpu, mem, has_lim) collapsed, -1
    # for the no-requests shape — then one integer COMBO per pod (its
    # containers' codes base-shifted into a single int), all as numpy
    # column math.  Container dicts intern per code, containers LISTS
    # intern per combo (a cluster has few distinct request shapes, so
    # both LUTs stay tiny).
    n_mem = len(_CONTAINER_MEM_REQ)
    codes = np.where(
        has_req, (cpu_idx * n_mem + mem_idx) * 2 + has_lim, -1
    ).astype(np.int64)
    container_lut: dict[int, dict] = {}
    for code in np.unique(codes).tolist():
        if code < 0:
            container_lut[code] = {"resources": {}}
            continue
        lim = code % 2
        cpu = _CONTAINER_CPU_REQ[code // 2 // n_mem]
        mem = _CONTAINER_MEM_REQ[code // 2 % n_mem]
        resources = {"requests": {"cpu": cpu, "memory": mem}}
        if lim:
            resources["limits"] = {"cpu": cpu, "memory": mem}
        container_lut[code] = {"resources": resources}

    starts = np.zeros(n_pods, dtype=np.int64)
    if n_pods > 1:
        np.cumsum(n_containers[:-1], out=starts[1:])
    base = 2 * len(_CONTAINER_CPU_REQ) * n_mem + 2  # codes span [-1, base-3]
    combo = codes[starts] + 2
    if n_pods:
        # Second/third container codes (index wraps harmlessly for pods
        # that don't have one — the where() discards the gathered value).
        wrap = max(n_total_containers, 1)
        second = np.where(
            n_containers >= 2, codes[(starts + 1) % wrap] + 2, 0
        )
        third = np.where(
            n_containers >= 3, codes[(starts + 2) % wrap] + 2, 0
        )
        combo = combo + base * second + base * base * third
    combo = combo.astype(np.int32)  # base**3 < 2^31: cheaper unique sort
    clist_lut: dict[int, list] = {}
    for cb in np.unique(combo).tolist():
        # The combo int IS the container-code sequence (base-shifted), so
        # each distinct list decodes straight from the key.
        c0, rest = cb % base - 2, cb // base
        lst = [container_lut[c0]]
        while rest:
            lst.append(container_lut[rest % base - 2])
            rest //= base
        clist_lut[cb] = lst

    _init_containers = [
        {"resources": {"requests": {"cpu": "1", "memory": "1Gi"}}}
    ]

    # Python lists for the remaining per-object reads: numpy scalar
    # extraction costs ~100 ns per index, which at ~500k reads would give
    # back most of the vectorization win.  String columns gather through
    # object arrays (C-level pointer copies, no per-element formatting).
    mem_kib_col = (
        cores_all.astype(np.int64) * (4 * 1024 * 1024) - mem_slack
    ).tolist()
    unhealthy_idx = np.flatnonzero(unhealthy_all).tolist()
    cores_all = cores_all.tolist()
    unhealthy_cond = unhealthy_cond.tolist()
    unparseable_all = unparseable_all.tolist()
    tainted_all = tainted_all.tolist()
    pods_per_l = pods_per.tolist()
    phases = np.asarray(_PHASES, dtype=object)[phase_idx].tolist()
    namespaces = np.asarray(_NAMESPACES, dtype=object)[ns_idx].tolist()

    # Pod-name suffix table: "-000", "-001", ... built once (pods_per is
    # bounded by 2*pods_per_node), so a pod name is prefix + table slot.
    max_per = max(pods_per_l, default=0)
    suffixes = [f"-{j:03d}" for j in range(max_per)]

    # One shared conditions list serves every healthy node (same interning
    # rationale as containers); unhealthy nodes build their own copy since
    # one entry differs.
    _healthy_conditions = [
        {"type": t, "status": "False"} for t in _CONDITION_TYPES[:4]
    ] + [{"type": "Ready", "status": "True"}]
    _zones = ("zone-0", "zone-1", "zone-2")
    _cores_str = {c: str(c) for c in _CPU_CORES_CHOICES}
    _taint = {"key": "dedicated", "value": "batch", "effect": "NoSchedule"}

    # Topology label columns (interned string tables gathered through
    # object arrays — the same columnar technique as every other column).
    topo_col: list = [None] * n_nodes
    if topology is not None:
        t_zones, racks_per = topology
        if t_zones < 1 or racks_per < 1:
            raise ValueError(
                f"topology wants (zones >= 1, racks_per_zone >= 1), "
                f"got {topology!r}"
            )
        n_racks = t_zones * racks_per
        rack_idx = np.arange(n_nodes) % n_racks
        zone_tbl = np.asarray(
            [f"tz-{z}" for z in range(t_zones)], dtype=object
        )
        rack_tbl = np.asarray(
            [f"r{r}" for r in range(racks_per)], dtype=object
        )
        # One interned {zone, rack} label-pair dict per rack: n_racks
        # distinct dicts serve all N nodes.
        pair_tbl = np.asarray(
            [
                {
                    "topology.kubernetes.io/zone": zone_tbl[r // racks_per],
                    "topology.kubernetes.io/rack": rack_tbl[r % racks_per],
                }
                for r in range(n_racks)
            ],
            dtype=object,
        )
        topo_col = pair_tbl[rack_idx].tolist()
    _no_topo: dict = {}

    # The bulk-assembly phase allocates ~N + ΣP acyclic dicts; pausing the
    # cyclic GC for it avoids ~500 young-generation scans over an
    # ever-growing live set (the objects survive anyway — nothing here is
    # garbage until the fixture itself is).
    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        node_names = [f"node-{i:05d}" for i in range(n_nodes)]
        # Kubelet-style memory: a little less than the round GiB figure,
        # in Ki — except the unparseable fraction, which advertises "Gi"
        # (bytefmt rejects it, Q5).
        mem_strs = [
            f"{m // 1024**2}Gi" if bad else f"{m}Ki"
            for m, bad in zip(mem_kib_col, unparseable_all)
        ]
        # Shared conditions column; only the unhealthy minority builds its
        # own copy (one entry differs).
        conds_col = [_healthy_conditions] * n_nodes
        for i in unhealthy_idx:
            conditions = [dict(c) for c in _healthy_conditions]
            conditions[unhealthy_cond[i]]["status"] = "True"
            conds_col[i] = conditions
        n_range = range(n_nodes)
        nodes = [
            {
                "name": nm,
                "allocatable": {
                    "cpu": _cores_str[cores],
                    "memory": ms,
                    "pods": "110",
                },
                "conditions": cd,
                "labels": {
                    "kubernetes.io/hostname": nm,
                    "zone": _zones[i % 3],
                    "pool": "default" if i % 4 else "highmem",
                    **(_no_topo if tp is None else tp),
                },
                "taints": [_taint.copy()] if tn else [],
            }
            for i, nm, cores, ms, cd, tn, tp in zip(
                n_range, node_names, cores_all, mem_strs, conds_col,
                tainted_all, topo_col,
            )
        ]

        # -- pod columns, then one zip comprehension ---------------------
        n_scheduled = n_pods - unscheduled_running_pods
        pod_names = [
            pfx + sfx
            for pfx, k in zip(node_names, pods_per_l)
            for sfx in suffixes[:k]
        ]
        pod_names.extend(
            f"orphan-{k:03d}" for k in range(unscheduled_running_pods)
        )
        node_of_pod = np.repeat(
            np.asarray(node_names, dtype=object), pods_per
        ).tolist()
        # Orphans bind to phantom nodes through the empty nodeName (Q4)
        # and must be Running regardless of the pre-drawn phase.
        node_of_pod.extend([""] * unscheduled_running_pods)
        phases[n_scheduled:] = ["Running"] * unscheduled_running_pods
        clists = [clist_lut[cb] for cb in combo.tolist()]
        pods = [
            {
                "name": nm,
                "namespace": ns,
                "nodeName": nn,
                "phase": ph,
                "containers": cl,
            }
            for nm, ns, nn, ph, cl in zip(
                pod_names, namespaces, node_of_pod, phases, clists
            )
        ]
        for p in np.flatnonzero(has_init).tolist():
            # Init containers exist but must be ignored by reference (Q7).
            pods[p]["initContainers"] = _init_containers
    finally:
        if gc_was_enabled:
            gc.enable()

    return {"nodes": nodes, "pods": pods}


def load_fixture(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def save_fixture(fixture: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(fixture, f, indent=1)

