"""Bug-for-bug reference-semantics oracle (counterpart of
``kubernetesclustercapacity_tpu/oracle``): the pure-Python walk of the
reference's exact control flow, standing in for ``go run
ClusterCapacity.go`` as the ground truth the device programs are held to."""

from kubernetesclustercapacity_tpu_torch.oracle.reference import (  # noqa: F401
    NodeView,
    OracleResult,
    PerNodeResult,
    ReferencePanic,
    fit_arrays_python,
    healthy_nodes,
    non_terminated_pods_for_node,
    pod_requests_limits,
    reference_run,
)
