"""Server process host memory (``telemetry/hostmem.py``): the resident set
from the end of the program's import to the server serving, in MiB: the
harness's cluster fixture, the pack into the snapshot and the server's
construction."""

from kccap_bench.hostmem import growth_mib, milestone


def read(artifacts):
    return growth_mib(milestone(artifacts, "rss", "import"),
                      milestone(artifacts, "rss", "served"))
