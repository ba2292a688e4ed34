"""Federated multi-cluster capacity: one query plane over a fleet.

The replicated serving plane (:mod:`..service.plane`) fans ONE leader
out to N replicas; this package inverts it — N cluster leaders publish
their digest-chained generation streams INTO one
:class:`FederationServer`, which holds a verified snapshot + generation
watermark per cluster and answers fleet-global queries (``fed_sweep`` /
``fed_rank`` / ``spillover``) as one batched kernel dispatch over the
concatenated clusters.

The robustness core is the degradation contract: every reply carries a
per-cluster ``{generation, age_s, state: fresh|stale|lost}`` vector; a
partitioned cluster keeps serving its last verified snapshot marked
``stale`` until the eviction horizon flips it to ``lost`` (excluded
from totals and NAMED in the reply) — answers degrade to explicitly
stale views, never silently wrong ones.
"""

from kubernetesclustercapacity_tpu_torch.federation.server import (
    CLUSTER_STATES,
    ClusterFeed,
    FederationError,
    FederationServer,
)

__all__ = [
    "CLUSTER_STATES",
    "ClusterFeed",
    "FederationError",
    "FederationServer",
]
