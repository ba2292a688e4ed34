"""The cluster of a zoned configuration: the frozen ``synthetic_fixture``
with every node labelled by zone.

``build`` draws the fixture from the same seed stream and with the same
sizes as ``synthetic_fixture.build`` (so the nodes, pods, health and
taints of a seed are ``k5k-gpu``'s, before its GPU and storage columns),
and passes the configuration's ``topology`` (``[zones, racks_per_zone]``),
which labels the nodes ``topology.kubernetes.io/zone`` and
``topology.kubernetes.io/rack`` round-robin.  Imports numpy and the
frozen generator only.
"""

from __future__ import annotations

import numpy as np

from kccap_bench.clusters.synthetic_fixture import synthetic_fixture


def build(cluster: dict, seed: int) -> dict:
    """The cluster a configuration's ``cluster`` block describes, drawn
    from ``seed``."""
    zones, racks_per_zone = (int(x) for x in cluster["topology"])
    return synthetic_fixture(
        int(cluster["nodes"]),
        seed=int(np.random.SeedSequence([seed, 0]).generate_state(1)[0]),
        pods_per_node=int(cluster["pods_per_node"]),
        unhealthy_frac=float(cluster["unhealthy_frac"]),
        unparseable_mem_frac=float(cluster["unparseable_mem_frac"]),
        taint_frac=float(cluster["taint_frac"]),
        topology=(zones, racks_per_zone),
    )
