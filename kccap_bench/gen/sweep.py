"""Traffic kind ``sweep``: open-loop 2-resource what-if sweeps.

Each request asks for ``specs_per_request`` specs, every one drawn from
the seed within the traffic file's ranges: cpu in millicores, memory as
a whole number of ``mem_unit_bytes`` (1 MiB, or 10**6 bytes for users
who write ``512M``), replicas.  Arrivals are Poisson at ``rate_per_s``
over a pool of ``connections``.  The check compares the totals and
flags of ``check_requests`` replies drawn from the seed with the plain
reference's.
"""

from __future__ import annotations

import numpy as np

from kccap_bench import arrivals
from kccap_bench.load import Plan, Stream

RESOURCES = ("cpu", "memory")


def _specs(traffic: dict, rng, n: int):
    s = int(traffic["specs_per_request"])
    cpu = arrivals.draw(rng, traffic["cpu_milli"], (n, s), np.int16)
    mem = arrivals.draw(rng, traffic["mem_units"], (n, s), np.int16)
    rep = arrivals.draw(rng, traffic["replicas"], (n, s), np.int16)
    return cpu, mem, rep


def _body(traffic: dict, cpu, mem, rep) -> dict:
    return {
        "cpu_request_milli": cpu.tolist(),
        "mem_request_bytes": (mem.astype(np.int64)
                              * int(traffic["mem_unit_bytes"])).tolist(),
        "replicas": rep.tolist(),
    }


def plan(traffic: dict, config: dict, seed: int, seconds: float,
         fixture: dict) -> Plan:
    due = arrivals.poisson_due(float(traffic["rate_per_s"]), seconds, seed)
    cpu, mem, rep = _specs(traffic, np.random.default_rng([seed, 3]),
                           len(due))

    requests = [("sweep", _body(traffic, cpu[i], mem[i], rep[i]))
                for i in range(len(due))]
    keep = arrivals.sample(seed, len(due), traffic["check_requests"])
    warm_cpu, warm_mem, warm_rep = _specs(
        traffic, np.random.default_rng([seed, 4]),
        int(traffic["warm_burst"]) + 1)
    warm = [[("sweep", _body(traffic, warm_cpu[0], warm_mem[0],
                             warm_rep[0]))],
            [("sweep", _body(traffic, warm_cpu[k], warm_mem[k], warm_rep[k]))
             for k in range(1, len(warm_cpu))]]
    return Plan(
        streams=[Stream("query", "pool", due, requests, keep=keep)],
        warm=warm, query_op="sweep",
        extra={"specs": (cpu, mem, rep)},
    )


def requests_of(plan: Plan, traffic: dict, i: int):
    """The ``[S, 2]`` requests and ``[S]`` replicas of query ``i``."""
    cpu, mem, rep = plan.extra["specs"]
    reqs = np.stack([cpu[i].astype(np.int64),
                     mem[i].astype(np.int64) * int(traffic["mem_unit_bytes"])],
                    axis=1)
    return reqs, rep[i].astype(np.int64)


def reference_answers(plan: Plan, traffic: dict, config: dict,
                      fixture: dict, cols, wanted, dtype, device) -> dict:
    """``{key: (totals, schedulable)}`` for each ``key = (stream, prefix,
    i, generation)`` of ``wanted``, computed by the plain reference in
    ``dtype`` on the cluster the cell starts from."""
    from kccap_bench.reference.fit import sweep_totals

    return {key: sweep_totals(cols, RESOURCES,
                              *requests_of(plan, traffic, key[2]),
                              dtype=dtype, device=device)
            for key in wanted}
