"""Server process host memory (``telemetry/hostmem.py``): the peak
resident set's growth (``ru_maxrss``, the end-to-end metric's source)
from mark ``start`` to mark ``trace_start``, in MiB; 0 where the peak was
set before the window."""

from kccap_bench.hostmem import gauge, growth_mib

FAMILY = "kccap_hostmem_peak_bytes"


def read(artifacts):
    return growth_mib(gauge(artifacts, "start", FAMILY, at="now"),
                      gauge(artifacts, "trace_start", FAMILY, at="now"))
