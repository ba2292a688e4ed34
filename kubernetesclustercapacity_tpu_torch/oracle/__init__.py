"""Reference-semantics helpers the snapshot packer is built on
(counterpart of ``kubernetesclustercapacity_tpu/oracle``)."""
