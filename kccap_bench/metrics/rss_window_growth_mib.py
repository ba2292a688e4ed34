"""Server process host memory (``telemetry/hostmem.py``): the resident
set's growth from mark ``start`` to mark ``trace_start``, in MiB: the
window before the profiler starts, so the profiler's own memory is not
in it."""

from kccap_bench.hostmem import gauge, growth_mib

FAMILY = "kccap_hostmem_rss_bytes"


def read(artifacts):
    return growth_mib(gauge(artifacts, "start", FAMILY, at="now"),
                      gauge(artifacts, "trace_start", FAMILY, at="now"))
