"""Capacity models: user-facing facades composing snapshot, programs and
masks (counterpart of ``kubernetesclustercapacity_tpu/models``)."""

from kubernetesclustercapacity_tpu_torch.models.capacity import (  # noqa: F401
    CapacityModel,
    CapacityResult,
    PodSpec,
)
