"""kubernetesclustercapacity_tpu_torch — the PyTorch / CUDA port.

Counterpart of ``kubernetesclustercapacity_tpu/__init__.py``.  Given a pod
spec and a replica count, compute how many replicas a Kubernetes cluster
can still schedule — for S what-if specs at once (the capacity sweep) —
on an NVIDIA H100.  The JAX package beside this one is the reference the
port is held against; the port imports ``torch`` and numpy, never JAX and
nothing of the JAX package.

Layer map:

===========  ===============================================================
L5 service   :mod:`.service` (``CapacityServer``: the snapshot stays on the
             card between requests, concurrent sweeps fold into one
             launch; ``update`` applies watch events; ``-follow`` keeps it
             synced to a live cluster through :mod:`.follower` and a
             coalesced publish; ``CapacityClient``; the JAX package's wire
             protocol), with :mod:`.resilience` and :mod:`.telemetry`;
             :mod:`.federation` (``FederationServer``, ``kccap-torch-fed``:
             one query plane over N leaders' planes, fresh/stale/lost)
L4 CLI       :mod:`.cli` (the single-spec transcript, ``-explain``, the
             ``-grid`` sweep, ``-extended-request``, ``-car-spec``,
             ``-forecast-spec``, ``-plan -catalog``, ``-gang-spec``,
             ``-optimize``, on a file or a live cluster; the six reference
             flags; the diagnostics ``-doctor`` (:mod:`.utils.doctor`),
             ``-profile``, ``-trace-tree``, ``-bench-diff``
             (:mod:`.analysis`) and ``-jax-profile``; every flag of the
             JAX CLI)
L3 model     :mod:`.models` (``CapacityModel``: ``evaluate``, ``sweep`` on
             kernel B1, ``sweep_multi`` on kernel B2, and scheduler
             fidelity: ``place``, ``drain``, ``topology_spread``,
             ``nodes_needed``, preemption), :mod:`.explain`
             (binding attribution, marginals, the fused sweep+explain),
             :mod:`.stochastic` (the seeded sampler, capacity-at-risk on
             the exact program), :mod:`.forecast` (trends, the horizon
             projection, the certified catalog planner), :mod:`.audit`
             (the audit log the trends are fitted from), :mod:`.topology`
             (whole-gang capacity over the zone/rack/host hierarchy),
             :mod:`.optimize` (the certified LP/PDHG packing)
L2 report    :mod:`.report` (the reference transcript, JSON, tables),
             :mod:`.oracle` (the sequential bug-for-bug walk)
L1 snapshot  :mod:`.snapshot`, :mod:`.fixtures`, :mod:`.sources`,
             :mod:`.scenario`, :mod:`.masks`, :mod:`.utils.quantity`,
             :mod:`.store` (per-row incremental repack), :mod:`.kubeapi`
             (the stdlib apiserver client), :mod:`.pdb` (the
             disruption-budget gate), :mod:`.topology.model` (the
             zone/rack/host code columns)
L0 kernels   :mod:`.ops.fused_fit` (the fused int32 sweep, CUDA kernel B1
             in ``csrc/sweep_fit.cu``), :mod:`.ops.fused_multi` (the fused
             R-resource sweep, kernel B2 in ``csrc/sweep_multi.cu``),
             :mod:`.ops.fit` (the exact int64 programs and the fused
             sweep+explain / sweep+quantile programs, ``sweep_snapshot``
             and its async fetch), :mod:`.ops.placement` (the placement
             scans), :mod:`.ops.preemption` (priority-threshold tables
             and the preemptive sweep), :mod:`.devcache` (device-resident
             columns, re-staged in place on a snapshot swap),
             :mod:`.parallel` (the sweep over a mesh of devices and over
             processes), :mod:`.native` (the compiled C++ loop behind
             ``-backend native`` and the columnar pod walk, on the host)
===========  ===============================================================

Entry points run on the card (``device="cuda"``) unless the caller asks for
the host (``device="cpu"``); without a card they raise.  int64 is native in
PyTorch, so no global switch is needed.
"""

__version__ = "0.4.0"

from kubernetesclustercapacity_tpu_torch.utils import quantity  # noqa: F401
from kubernetesclustercapacity_tpu_torch.snapshot import (  # noqa: F401
    ClusterSnapshot,
    GroupedSnapshot,
    grouped_for_dispatch,
    load_snapshot,
    snapshot_from_fixture,
    synthetic_snapshot,
)
from kubernetesclustercapacity_tpu_torch.fixtures import (  # noqa: F401
    load_fixture,
    save_fixture,
    synthetic_fixture,
)
from kubernetesclustercapacity_tpu_torch.scenario import (  # noqa: F401
    MultiResourceGrid,
    Scenario,
    ScenarioError,
    ScenarioGrid,
    random_scenario_grid,
    scenario_from_flags,
)
from kubernetesclustercapacity_tpu_torch.masks import (  # noqa: F401
    implicit_taint_mask,
)
from kubernetesclustercapacity_tpu_torch.ops.fit import (  # noqa: F401
    fit_per_node,
    fit_per_node_multi,
    sweep_grid,
    sweep_grid_grouped,
    sweep_grid_multi,
    sweep_quantiles_snapshot,
)
from kubernetesclustercapacity_tpu_torch.ops.fused_fit import (  # noqa: F401
    sweep_auto,
    sweep_fused,
    sweep_fused_plain,
    sweep_snapshot_auto,
)
from kubernetesclustercapacity_tpu_torch.ops.fused_multi import (  # noqa: F401
    sweep_multi,
    sweep_multi_auto,
    sweep_multi_plain,
)
from kubernetesclustercapacity_tpu_torch.explain import (  # noqa: F401
    explain_snapshot,
    sweep_explain_snapshot,
)
from kubernetesclustercapacity_tpu_torch.models import (  # noqa: F401
    CapacityModel,
    PodSpec,
)
from kubernetesclustercapacity_tpu_torch.report import (  # noqa: F401
    reference_report,
)
from kubernetesclustercapacity_tpu_torch.stochastic import (  # noqa: F401
    CaRResult,
    StochasticSpec,
    UsageDistribution,
    capacity_at_risk,
    extract_usage_history,
    load_stochastic_spec,
)
from kubernetesclustercapacity_tpu_torch.telemetry import hostmem as _hostmem

# Last, so that the reading holds every module the import loads: the
# host-memory floor (``telemetry/hostmem.py``'s ``at="import"``).
_hostmem.note_import()
