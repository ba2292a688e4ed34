"""Traffic kind ``sweep_multi``: open-loop R-resource what-if sweeps.

Each request asks for ``specs_per_request`` specs over ``resources``,
every request drawn from the seed within the traffic file's range for
its resource, in units of that resource's ``unit_bytes`` (1 for a
count); an extended request of 0 does not consume its resource.
Replicas and arrivals as in the ``sweep`` kind.
"""

from __future__ import annotations

import numpy as np

from kccap_bench import arrivals
from kccap_bench.load import Plan, Stream


def _resources(traffic: dict) -> tuple[str, ...]:
    return tuple(r["name"] for r in traffic["resources"])


def _specs(traffic: dict, rng, n: int):
    s = int(traffic["specs_per_request"])
    reqs = np.stack([arrivals.draw(rng, r["range"], (n, s), np.int16)
                     for r in traffic["resources"]], axis=2)
    rep = arrivals.draw(rng, traffic["replicas"], (n, s), np.int16)
    return reqs, rep


def _scaled(traffic: dict, reqs) -> np.ndarray:
    units = np.asarray([int(r["unit_bytes"]) for r in traffic["resources"]],
                       dtype=np.int64)
    return reqs.astype(np.int64) * units


def _body(traffic: dict, reqs, rep) -> dict:
    return {"resources": list(_resources(traffic)),
            "requests": _scaled(traffic, reqs).tolist(),
            "replicas": rep.tolist()}


def plan(traffic: dict, config: dict, seed: int, seconds: float,
         fixture: dict) -> Plan:
    due = arrivals.poisson_due(float(traffic["rate_per_s"]), seconds, seed)
    reqs, rep = _specs(traffic, np.random.default_rng([seed, 3]), len(due))

    requests = [("sweep_multi", _body(traffic, reqs[i], rep[i]))
                for i in range(len(due))]
    keep = arrivals.sample(seed, len(due), traffic["check_requests"])
    w_reqs, w_rep = _specs(traffic, np.random.default_rng([seed, 4]),
                           int(traffic["warm_burst"]) + 1)
    warm = [[("sweep_multi", _body(traffic, w_reqs[0], w_rep[0]))],
            [("sweep_multi", _body(traffic, w_reqs[k], w_rep[k]))
             for k in range(1, len(w_reqs))]]
    return Plan(
        streams=[Stream("query", "pool", due, requests, keep=keep)],
        warm=warm, query_op="sweep_multi",
        extra={"specs": (reqs, rep)},
    )


def cell_ops_per_request(plan: Plan, semantics: str) -> float:
    """The mean, over the run's requests, of the operations per node that
    a request's specs ask (``roofline.multi_cell_ops``)."""
    from kccap_bench.roofline import multi_cell_ops

    reqs, _ = plan.extra["specs"]
    values, counts = np.unique((reqs > 0).sum(axis=2), return_counts=True)
    return sum(int(c) * multi_cell_ops([v], semantics)
               for v, c in zip(values, counts)) / reqs.shape[0]


def reference_answers(plan: Plan, traffic: dict, config: dict,
                      fixture: dict, cols, wanted, dtype, device) -> dict:
    """As in the ``sweep`` kind, over the traffic's resources."""
    from kccap_bench.reference.fit import sweep_totals

    reqs, rep = plan.extra["specs"]
    return {key: sweep_totals(cols, _resources(traffic),
                              _scaled(traffic, reqs[key[2]]),
                              rep[key[2]].astype(np.int64), dtype=dtype,
                              device=device)
            for key in wanted}
