"""Traffic kind ``churn``: what-if sweeps while the cluster changes.

Two streams share the server.  Pollers send ``sweep`` requests as in the
``sweep`` kind, Poisson at ``poll_rate_per_s``.  One writer sends an
``update`` every ``batch_period_s`` holding the next ``events_per_batch``
events of a seeded stream, and on the same connection, the moment the
update returns, a ``sweep`` that must already see it.  The first batch
goes in set-up: it builds the server's store.

The stream is ``chip_smoke.churn_events``' mix made continuous: chunks
of its 600 events (192 pods added, 192 deleted, 192 finished, 14 nodes
modified, 5 nodes replaced), each chunk drawn against the state the
chunks before it left.  ``churn_events`` below is a frozen copy.

The check compares kept sweeps with the plain reference on the state of
the generation that answered them, every update's reply with the node
counts that state has, and each writer sweep's generation with its
update's.
"""

from __future__ import annotations

import json

import numpy as np

from kccap_bench import arrivals
from kccap_bench.gen import sweep as _sweep
from kccap_bench.load import Plan, Stream

CHURN_PODS, CHURN_NODES_MODIFIED, CHURN_NODES_SWAPPED = 192, 14, 5


def churn_events(fixture: dict, seed: int = 9, *, pods: int = CHURN_PODS,
                 nodes_modified: int = CHURN_NODES_MODIFIED,
                 nodes_swapped: int = CHURN_NODES_SWAPPED,
                 tag: str = "") -> list[dict]:
    """One seeded chunk of watch events in the store's schema, shuffled:
    ``pods`` pods ADDED Running on random nodes, ``pods`` existing pods
    DELETED, ``pods`` existing Running pods MODIFIED to Succeeded,
    ``nodes_modified`` nodes MODIFIED (a pressure condition flipped, or
    allocatable changed), ``nodes_swapped`` nodes ADDED and as many
    DELETED.  The object sets are disjoint, so the final state does not
    depend on how the chunk interleaves kinds.  ``tag`` makes the new
    objects' names unique across chunks; with ``tag=""`` and the default
    counts this is ``chip_smoke.churn_events``."""
    rng = np.random.default_rng(seed)
    nodes, pods_ = fixture["nodes"], fixture["pods"]
    names = [n["name"] for n in nodes]
    running = [i for i, p in enumerate(pods_)
               if p["phase"] == "Running" and p.get("nodeName")]
    picked = rng.choice(len(running), 2 * pods, replace=False)
    deleted = [pods_[running[i]] for i in picked[:pods]]
    finished = [pods_[running[i]] for i in picked[pods:]]
    node_ix = rng.choice(len(nodes), nodes_modified + nodes_swapped,
                         replace=False)
    events = []
    for i in range(pods):
        requests = {"cpu": f"{int(rng.integers(50, 2000))}m",
                    "memory": f"{int(rng.integers(64, 4096))}Mi"}
        if rng.random() < 0.25:
            requests["nvidia.com/gpu"] = "1"
            requests["ephemeral-storage"] = f"{int(rng.integers(1, 11))}Gi"
        events.append({"type": "ADDED", "kind": "Pod", "object": {
            "name": f"churn-{tag}{i}", "namespace": "churn",
            "nodeName": names[int(rng.integers(len(names)))],
            "phase": "Running", "labels": {"app": "churn"},
            "containers": [{"resources": {"requests": requests,
                                          "limits": requests}}]}})
    events += [{"type": "DELETED", "kind": "Pod", "object": p}
               for p in deleted]
    events += [{"type": "MODIFIED", "kind": "Pod",
                "object": dict(p, phase="Succeeded")} for p in finished]
    for k, i in enumerate(node_ix[:nodes_modified]):
        node = json.loads(json.dumps(nodes[int(i)]))
        if k % 2:
            cond = node["conditions"][1]
            cond["status"] = "False" if cond["status"] == "True" else "True"
        else:
            node["allocatable"]["cpu"] = str(int(rng.integers(4, 97)))
        events.append({"type": "MODIFIED", "kind": "Node", "object": node})
    for i in range(nodes_swapped):
        node = json.loads(json.dumps(
            nodes[int(node_ix[nodes_modified + i])]))
        events.append({"type": "DELETED", "kind": "Node", "object": node})
        joiner = json.loads(json.dumps(nodes[int(rng.integers(len(nodes)))]))
        joiner["name"] = f"joiner-{tag}{i}"
        joiner["labels"] = dict(joiner.get("labels") or {},
                                **{"kubernetes.io/hostname": joiner["name"]})
        events.append({"type": "ADDED", "kind": "Node", "object": joiner})
    order = rng.permutation(len(events))
    return [events[int(i)] for i in order]


def event_stream(fixture: dict, seed: int, n_events: int) -> list[dict]:
    """The first ``n_events`` of the continuous stream: chunk ``k`` is
    :func:`churn_events` of the state chunks ``0..k-1`` left, drawn from
    its own stream of ``seed``."""
    nodes = {n["name"]: n for n in fixture["nodes"]}
    pods = {(p.get("namespace", ""), p["name"]): p for p in fixture["pods"]}
    out: list[dict] = []
    k = 0
    while len(out) < n_events:
        chunk = churn_events(
            {"nodes": list(nodes.values()), "pods": list(pods.values())},
            seed=int(np.random.SeedSequence([seed, 5, k]).generate_state(1)[0]),
            tag=f"{k}-")
        for e in chunk:
            obj = e["object"]
            table, key = (nodes, obj["name"]) if e["kind"] == "Node" else \
                (pods, (obj.get("namespace", ""), obj["name"]))
            if e["type"] == "DELETED":
                del table[key]
            else:
                table[key] = obj
        out += chunk
        k += 1
    return out[:n_events]


def plan(traffic: dict, config: dict, seed: int, seconds: float,
         fixture: dict) -> Plan:
    poll_due = arrivals.poisson_due(float(traffic["poll_rate_per_s"]),
                                    seconds, seed)
    period = float(traffic["batch_period_s"])
    per_batch = int(traffic["events_per_batch"])
    batch_due = np.arange(0.0, seconds - 1e-9, period)
    events = event_stream(fixture, seed, per_batch * (len(batch_due) + 1))
    batches = [events[k * per_batch:(k + 1) * per_batch]
               for k in range(len(batch_due) + 1)]
    # One draw of sweep specs serves the pollers' requests and then the
    # writer's.
    n_poll = len(poll_due)
    cpu, mem, rep = _sweep._specs(traffic, np.random.default_rng([seed, 3]),
                                  n_poll + len(batch_due) + 2)

    def sweep_of(j):
        return "sweep", _sweep._body(traffic, cpu[j], mem[j], rep[j])

    keep_poll = arrivals.sample(seed, n_poll, traffic["check_requests"])
    keep_write = frozenset(
        int(i) for i in np.random.default_rng([seed, 12]).choice(
            len(batch_due), min(int(traffic["check_writer_requests"]),
                                len(batch_due)), replace=False))
    n_batch = len(batch_due)
    streams = [
        Stream("query", "pool", poll_due,
               [sweep_of(i) for i in range(n_poll)], keep=keep_poll),
        Stream("update", "writer", batch_due,
               [("update", {"events": batches[i + 1]})
                for i in range(n_batch)],
               then=[sweep_of(n_poll + i) for i in range(n_batch)],
               keep=frozenset(range(n_batch)), then_keep=keep_write),
    ]
    last = n_poll + len(batch_due)
    warm = [[sweep_of(last)], [("update", {"events": batches[0]})],
            [sweep_of(last + 1)]]
    return Plan(streams=streams, warm=warm, query_op="sweep",
                extra={"specs": (cpu, mem, rep), "batches": batches,
                       "n_poll": n_poll})


def _spec_index(plan: Plan, key) -> int:
    stream, _prefix, i, _gen = key
    return i if stream == 0 else plan.extra["n_poll"] + i


def reference_answers(plan: Plan, traffic: dict, config: dict,
                      fixture: dict, cols, wanted, dtype, device) -> dict:
    """Kept sweeps on the state of the generation that answered each
    (generation 1 is the cluster as built, and every update adds one:
    generation ``g`` has the stream's first ``g - 1`` batches applied)."""
    from kccap_bench.reference.fit import sweep_totals
    from kccap_bench.reference.state import StrictCluster

    batches = plan.extra["batches"]
    by_gen: dict[int, list] = {}
    for key in wanted:
        by_gen.setdefault(int(key[3]), []).append(key)
    state = StrictCluster(fixture, tuple(config["extended_resources"]))
    applied, out = 0, {}
    for gen in sorted(by_gen):
        if not 1 <= gen <= len(batches) + 1:
            continue  # no such generation: the check counts it as wrong
        while applied < gen - 1:
            state.apply(batches[applied])
            applied += 1
        gen_cols = state.columns()
        for key in by_gen[gen]:
            reqs, replicas = _sweep.requests_of(plan, traffic,
                                                _spec_index(plan, key))
            out[key] = sweep_totals(gen_cols, _sweep.RESOURCES, reqs,
                                    replicas, dtype=dtype, device=device)
    return out


def update_numbers(plan: Plan, records, config: dict, fixture: dict) -> dict:
    """The writer's guarantees: every update applied all its events and
    left the node counts the stream's state has; every writer sweep was
    answered by its own update's generation or a later one."""
    from kccap_bench.reference.pack import strict_healthy
    from kccap_bench.reference.state import StrictCluster

    rec = records[1]
    batches = plan.extra["batches"]
    state = StrictCluster({"nodes": fixture["nodes"], "pods": []})
    state.apply([e for e in batches[0] if e["kind"] == "Node"])
    healthy = state.healthy_nodes()
    updates_off = stale = 0
    for i in range(len(rec.due)):
        batch = batches[i + 1]
        for e in batch:
            if e["kind"] != "Node":
                continue
            old = state.nodes.get(e["object"]["name"])
            healthy -= old is not None and strict_healthy(old)
            state.apply([e])
            healthy += e["type"] != "DELETED" and strict_healthy(e["object"])
        reply = rec.replies.get(i)
        want = {"applied": len(batch), "nodes": len(state.nodes),
                "healthy_nodes": healthy}
        if reply is None or any(reply.get(k) != v for k, v in want.items()):
            updates_off += 1
        # The update answered at the generation before it; its sweep must
        # be answered at the one it made, or later.
        if rec.ok[i] and rec.then_ok[i] and \
                rec.then_generation[i] < rec.generation[i] + 1:
            stale += 1
    return {"updates_off": updates_off, "stale_reads": stale}
