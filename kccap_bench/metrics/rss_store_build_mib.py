"""Server process host memory (``telemetry/hostmem.py``): the resident
set's growth across the build of the store that the first ``update``
makes, in MiB.  Nothing where no update came."""

from kccap_bench.hostmem import growth_mib, milestone


def read(artifacts):
    return growth_mib(milestone(artifacts, "rss", "store_start"),
                      milestone(artifacts, "rss", "store_built"))
