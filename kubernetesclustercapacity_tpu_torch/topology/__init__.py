"""Topology (counterpart of ``kubernetesclustercapacity_tpu/topology``):
so far only the label→domain-code helper and the node-name index that
topology spread and the anti-affinity mask share."""
