"""Server process host memory (``telemetry/hostmem.py``): the memory
glibc's allocator holds freed (``mallinfo2().fordblks``) at mark
``trace_start``, in MiB.  Nothing where the C library has no
``mallinfo2`` (the gauge reads -1)."""

from kccap_bench.hostmem import MIB, gauge


def read(artifacts):
    held = gauge(artifacts, "trace_start", "kccap_hostmem_malloc_bytes",
                 kind="free_held")
    return None if held is None or held < 0 else held / MIB
