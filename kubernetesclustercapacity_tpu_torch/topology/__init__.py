"""Gang & topology-aware capacity (zone/rack/host hierarchy).

Counterpart of ``kubernetesclustercapacity_tpu/topology``: :mod:`.model`
parses node labels into dense small-int topology code columns (the
segmented-reduction index space); :mod:`.gang` counts WHOLE gangs —
all-or-nothing groups of co-scheduled ranks — under co-location and
rank-aware spread constraints, on the card, equal to a pure numpy/Python
oracle on both engines.
"""

from kubernetesclustercapacity_tpu_torch.topology.gang import (
    GangResult,
    GangSpec,
    GangSpecError,
    gang_capacity,
    gang_explain,
    gang_grouped_enabled,
    gang_oracle,
    gang_spec_from_msg,
    load_gang_spec,
    parse_gang_block,
)
from kubernetesclustercapacity_tpu_torch.topology.model import (
    DEFAULT_HOST_KEY,
    DEFAULT_RACK_KEY,
    DEFAULT_ZONE_KEY,
    LEVELS,
    ClusterTopology,
    TopologyKeys,
    attach_topology,
    label_codes,
    node_name_index,
    topology_from_snapshot,
)

__all__ = [
    "LEVELS",
    "DEFAULT_ZONE_KEY",
    "DEFAULT_RACK_KEY",
    "DEFAULT_HOST_KEY",
    "TopologyKeys",
    "ClusterTopology",
    "label_codes",
    "node_name_index",
    "topology_from_snapshot",
    "attach_topology",
    "GangSpec",
    "GangSpecError",
    "GangResult",
    "gang_capacity",
    "gang_explain",
    "gang_oracle",
    "gang_spec_from_msg",
    "load_gang_spec",
    "parse_gang_block",
    "gang_grouped_enabled",
]
