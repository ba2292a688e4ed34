"""Distributed layer: device meshes, sharded sweeps, multi-process sweeps.

Counterpart of ``kubernetesclustercapacity_tpu/parallel/``.  The reference
has no parallelism at all — one goroutine, one sequential node loop
(SURVEY.md §2.3).  Here the sweep is laid out over a 2-D
:class:`~.mesh.MeshPlan` of ``torch.device``\\ s with a **scenario** axis
(the embarrassingly parallel what-if grid) and a **node** axis (cluster
nodes sharded across devices, the per-shard replica counts summed in
int64 on the first device).  One controller drives every cell.
Multi-process deployments split the scenario grid across processes
(:mod:`.multihost`) over ``torch.distributed``.
"""

from kubernetesclustercapacity_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshPlan,
    make_mesh,
)
from kubernetesclustercapacity_tpu_torch.parallel.sweep import (  # noqa: F401
    sweep_gspmd,
    sweep_shard_map,
)
from kubernetesclustercapacity_tpu_torch.parallel import multihost  # noqa: F401
