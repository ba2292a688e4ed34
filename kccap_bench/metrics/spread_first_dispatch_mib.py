"""Server process host memory (``telemetry/hostmem.py``): the resident
set's growth across the first dispatch of the grid ``topology_spread``'s
per-node route (``kccap_hostmem_first_dispatch_bytes{kernel=
"torch_int64_per_node"}``), in MiB: the module images of the generic
kernels its tensor program loads on first use.  Nothing where the route
filed no reading."""

from kccap_bench.hostmem import MIB, gauge


def read(artifacts):
    value = gauge(artifacts, "end", "kccap_hostmem_first_dispatch_bytes",
                  kernel="torch_int64_per_node")
    return None if value is None else value / MIB
