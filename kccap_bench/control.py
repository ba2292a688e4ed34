"""The control of the check that decides ``correct``.

    python3 -m kccap_bench.control --workload W --seeds 1,2,3

For each seed it draws the cell's cluster and traffic as a run does
(``run_seconds`` from ``BENCHMARK.json``), takes the requests a run keeps
for the check, answers them with the plain reference computed in int32
instead of int64 (the nearest integer precision below the exact
arithmetic the configurations state), and compares those answers as a
run compares the program's.  The numbers have to exceed their limits on
every seed.  ``--dtype float32`` reads the float32 shortcut instead,
which answers some seeds' requests exactly at these sizes.
It prints one line per seed, and the exact reference's seconds.  A run
of the benchmark never runs it.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from kccap_bench import checks, spec
from kccap_bench.load import Records
from kccap_bench.reference import pack


def control_numbers(root: str, workload: str, seed: int, seconds: float,
                    device: str, dtype=torch.int32) -> tuple[dict, float]:
    cell = spec.load_cell(root, workload)
    config, traffic = cell["config"], cell["traffic"]
    kind = spec.load_module(root, "gen", traffic["kind"])
    cluster = spec.load_module(root, "clusters", config["cluster"]["kind"])
    fixture = cluster.build(config["cluster"], seed)
    plan = kind.plan(traffic, config, seed, seconds, fixture)
    records = [Records(s) for s in plan.streams]
    writer_due = [r.due for r in records if r.has_then]
    for rec in records:
        if rec.has_then:
            # The writer's own sweep answers at its update's generation.
            rec.then_generation[:] = 3 + np.arange(len(rec.due))
        elif writer_due:
            rec.generation[:] = 2 + np.searchsorted(writer_due[0], rec.due,
                                                    side="right")
        else:
            rec.generation[:] = 1
    cols = (pack.pack_reference(fixture)
            if config["semantics"] == "reference" else
            pack.pack_strict(fixture, tuple(config["extended_resources"])))
    keys = checks.kept_keys(records)
    t = time.perf_counter()
    exact = kind.reference_answers(plan, traffic, config, fixture, cols, keys,
                                   torch.int64, device)
    exact_s = time.perf_counter() - t
    lower = kind.reference_answers(plan, traffic, config, fixture, cols,
                                   keys, dtype, device)
    for key, (totals, sched) in lower.items():
        k, prefix, i, _ = key
        getattr(records[k], prefix + "replies")[i] = {
            "totals": totals.tolist(), "schedulable": sched.tolist()}
    return checks.compare(records, keys, exact), exact_s


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", choices=("int32", "float32"), default="int32")
    args = p.parse_args(argv)
    dtype = getattr(torch, args.dtype)
    root = os.getcwd()
    seconds = spec.load_benchmark(root)["run_seconds"]
    failed_everywhere = True
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers, exact_s = control_numbers(root, args.workload, seed,
                                           seconds, args.device, dtype)
        over = {k: v for k, v in numbers.items() if v > checks.LIMITS[k]}
        failed_everywhere &= bool(over)
        print(f"control {args.dtype} {args.workload} seed {seed}: "
              f"{numbers}; exact "
              f"reference {exact_s:.3f} s; "
              f"{'not correct' if over else 'CORRECT (the check is blind)'}",
              flush=True)
    return 0 if failed_everywhere else 1


if __name__ == "__main__":
    sys.exit(main())
