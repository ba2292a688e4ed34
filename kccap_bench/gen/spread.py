"""Traffic kind ``spread``: open-loop zone-spread sweeps.

Each request is the grid form of ``topology_spread``: the ``sweep`` kind's
request of ``specs_per_request`` specs, drawn from the seed as that kind
draws them (cpu in millicores, memory as a whole number of
``mem_unit_bytes``, replicas), with the traffic file's ``topology_key``
and ``max_skew``.  Arrivals, warm groups and the kept requests are the
``sweep`` kind's too.  The check compares the totals and flags of the
kept replies with the plain reference's (``reference/spread.py``).
"""

from __future__ import annotations

from kccap_bench.gen import sweep
from kccap_bench.load import Plan

__all__ = ["plan", "reference_answers"]

OP = "topology_spread"


def plan(traffic: dict, config: dict, seed: int, seconds: float,
         fixture: dict) -> Plan:
    out = sweep.plan(traffic, config, seed, seconds, fixture)
    constraint = {"topology_key": traffic["topology_key"],
                  "max_skew": int(traffic["max_skew"])}

    def spread(request):
        return OP, {**request[1], **constraint}

    for stream in out.streams:
        stream.requests = [spread(r) for r in stream.requests]
    out.warm = [[spread(r) for r in group] for group in out.warm]
    out.query_op = OP
    return out


def reference_answers(plan: Plan, traffic: dict, config: dict,
                      fixture: dict, cols, wanted, dtype, device) -> dict:
    """``{key: (totals, schedulable)}`` for each ``key = (stream, prefix,
    i, generation)`` of ``wanted``, computed by the plain reference in
    ``dtype`` on the cluster the cell starts from."""
    from kccap_bench.reference.spread import spread_totals

    return {key: spread_totals(cols, fixture, traffic["topology_key"],
                               int(traffic["max_skew"]),
                               *sweep.requests_of(plan, traffic, key[2]),
                               dtype=dtype, device=device)
            for key in wanted}
