"""Service boundary: a long-lived server that keeps the snapshot on the card.

Counterpart of ``kubernetesclustercapacity_tpu/service/``.  A client
sends length-prefixed JSON frames over TCP; the server answers from a
snapshot whose columns stay device-resident between requests, so a query
costs one kernel dispatch:

* :mod:`.protocol` — framing, byte-compatible with the JAX package's;
* :mod:`.server`   — threaded TCP server dispatching to the kernels;
* :mod:`.batching` — micro-batching: concurrent sweeps share one launch;
* :mod:`.coalesce` — ``-follow``'s bounded-rate snapshot publisher;
* :mod:`.client`   — Python client;
* :mod:`.tenancy`  — the tenant map and the weighted-fair slot queue;
* :mod:`.plane`    — the replicated serving plane: leader→replica
  snapshot fan-out, admission control;
* :mod:`.replicaset` — multi-endpoint client: failover, hedged reads,
  read-your-generation monotonicity across replicas.

Either package's client talks to either package's server, and either
package's replica follows either package's leader.
"""

from kubernetesclustercapacity_tpu_torch.service.client import CapacityClient  # noqa: F401
from kubernetesclustercapacity_tpu_torch.service.coalesce import SnapshotCoalescer  # noqa: F401
from kubernetesclustercapacity_tpu_torch.service.replicaset import ReplicaSet  # noqa: F401
from kubernetesclustercapacity_tpu_torch.service.server import CapacityServer  # noqa: F401
