"""The benchmark of the PyTorch and CUDA port
(``kubernetesclustercapacity_tpu_torch``): the capacity service under
open-loop what-if traffic and cluster churn.  See ``README.md``."""
