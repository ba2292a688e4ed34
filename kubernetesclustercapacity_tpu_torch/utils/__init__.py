"""Utility layer: quantity codecs (counterpart of ``kubernetesclustercapacity_tpu/utils``)."""
