"""Server process host memory (``telemetry/hostmem.py``): the resident
set's growth across the first dispatch of each route label, summed over
the labels the run dispatched, in MiB: the module images and kernel
libraries each route loads on first use."""

from kccap_bench.hostmem import MIB, family


def read(artifacts):
    values = family(artifacts, "end", "kccap_hostmem_first_dispatch_bytes")
    return None if values is None else sum(values.values()) / MIB
