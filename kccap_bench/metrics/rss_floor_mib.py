"""Server process host memory (``telemetry/hostmem.py``): the resident set
at the end of the program package's import, in MiB.  The server process
starts torch and the CUDA context before it imports the program, so this
is the interpreter, torch, the CUDA context and the program's modules:
what no change to the program's work moves."""

from kccap_bench.hostmem import MIB, milestone


def read(artifacts):
    rss = milestone(artifacts, "rss", "import")
    return None if rss is None else rss / MIB
