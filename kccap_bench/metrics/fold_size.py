"""Micro-batcher (``service/batching.py``): requests per dispatch over the
window, from the ``kccap_batch_size`` histogram."""

from kccap_bench.artifacts import hist_delta


def read(artifacts):
    s, n = hist_delta(artifacts, "start", "end", "server", "kccap_batch_size")
    return s / n if n > 0 else None
