"""The server process's peak resident memory over the whole run (its
``ru_maxrss``, read in the process when the server stops), in MiB: the
host memory an operator provisions for one server of this cluster,
CUDA's and torch's libraries, the cluster, the store and the requests'
working set together."""


def read(artifacts):
    kib = artifacts.get("maxrss_kib")
    return kib / 1024 if kib else None
