"""Runs benchmark cells and prints where each run's server process held its
host memory, from the run's own artifacts, traced or not.

    python3 /path/to/tools/hostmem_runs.py CELL:SEED[:trace] ... [--seconds S]

from the root of a checkout with the benchmark (this one, or another
commit's with this benchmark's files laid over it).  Each run is
``kccap_bench.run.run_cell``, as ``python3 -m kccap_bench.run`` runs it;
the run's result line goes to standard error, and one JSON line a run to
standard output: the cell, the seed, ``correct``, the peak resident set
(``maxrss_mib``, the end-to-end metric), the child's set-up seconds, and
the program's ``kccap_hostmem_*`` gauges in MiB (``telemetry/hostmem.py``):
the set-up milestones, the first dispatch of each route label, and
``rss{now}``, ``peak{now}`` and the allocator at each mark.  A program
without the gauges leaves them out.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import types

MIB = float(1 << 20)


def _values(artifacts: dict, mark: str, family: str) -> dict:
    """``{label value: MiB}`` of a one-label family at ``mark``."""
    from kccap_bench.counters import labels_of

    fam = artifacts["marks"][mark]["process"].get(family, {})
    return {next(iter(labels_of(block).values())): value / MIB
            for block, value in fam.get("values", {}).items()}


def summary(artifacts: dict) -> dict:
    """The host-memory readings of one run's artifacts, in MiB."""
    out = {"maxrss_mib": artifacts["maxrss_kib"] / 1024,
           "setup": artifacts["setup"]}
    marks = artifacts["marks"]
    rss = _values(artifacts, "end", "kccap_hostmem_rss_bytes")
    if not rss:
        return out
    peak = _values(artifacts, "end", "kccap_hostmem_peak_bytes")
    out["milestones"] = {at: v for at, v in rss.items() if at != "now"}
    out["milestone_peaks"] = {at: v for at, v in peak.items() if at != "now"}
    out["first_dispatch"] = _values(artifacts, "end",
                                    "kccap_hostmem_first_dispatch_bytes")
    out["marks"] = {
        mark: {"rss": _values(artifacts, mark,
                              "kccap_hostmem_rss_bytes")["now"],
               "peak": _values(artifacts, mark,
                               "kccap_hostmem_peak_bytes")["now"],
               "malloc": _values(artifacts, mark,
                                 "kccap_hostmem_malloc_bytes")}
        for mark in marks}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("runs", nargs="+", help="CELL:SEED or CELL:SEED:trace")
    p.add_argument("--seconds", type=float, default=None,
                   help="the window (default: BENCHMARK.json's run_seconds)")
    p.add_argument("--device", default="cuda",
                   help="cpu to rehearse at a small size on a host")
    args = p.parse_args(argv)
    root = os.getcwd()
    sys.path.insert(0, root)
    import shutil

    from kccap_bench import run, spec

    seconds = args.seconds or spec.load_benchmark(root)["run_seconds"]
    kept = {}

    def rmtree(path, ignore_errors=False):
        # run_cell removes its directory last: keep the artifacts first.
        art = os.path.join(path, "artifacts.json")
        if os.path.exists(art):
            with open(art) as f:
                kept["artifacts"] = json.load(f)
        shutil.rmtree(path, ignore_errors=ignore_errors)

    run.shutil = types.SimpleNamespace(rmtree=rmtree)
    code = 0
    for item in args.runs:
        cell, seed, *trace = item.split(":")
        kept.clear()
        out = io.StringIO()
        rc = run.run_cell(root, cell, int(seed), seconds, trace == ["trace"],
                          device=args.device, out=out)
        sys.stderr.write(out.getvalue())
        line = {"cell": cell, "seed": int(seed), "trace": bool(trace),
                "rc": rc}
        if rc == 0:
            result = json.loads(out.getvalue().strip().splitlines()[-1])
            line.update(correct=result["correct"], failed=result["failed"],
                        metrics={k: v["value"]
                                 for k, v in result["metrics"].items()})
        if "artifacts" in kept:
            line.update(summary(kept["artifacts"]))
        print(json.dumps(line), flush=True)
        code = code or rc
    return code


if __name__ == "__main__":
    sys.exit(main())
