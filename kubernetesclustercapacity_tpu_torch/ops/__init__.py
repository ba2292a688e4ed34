"""Compute kernels (L1): the exact int64 fit program and the fused sweep
kernel (counterpart of ``kubernetesclustercapacity_tpu/ops``)."""
