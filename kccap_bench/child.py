"""The server process of one run: the program under test, set up and
served, and its own readings taken on command.

``python -m kccap_bench.child --workload W --seed N --tmp DIR`` builds
the cell's cluster from the seed, packs it with the program's packer and
serves it with the program's ``CapacityServer`` on ``127.0.0.1:0``
(with ``--trace 1`` it also starts and stops one profiler, which is
slow the first time in a process).  It then prints ``KCCAP_BENCH READY <port> <set-up seconds as JSON>`` and
takes one command a line on standard input:

``mark NAME``
    keep the server's registry, the process registry, the
    micro-batcher's counters, the collector's pauses (``gcwatch.py``)
    and the process's CPU seconds as they are now, under ``NAME``;
``trace_start`` / ``trace_stop``
    the same marks, around a ``torch.profiler`` window (CPU and CUDA);
``dump PATH``
    mark ``end``, read the device's memory peak and the process's peak
    resident memory, stop the server, reduce
    the trace, write everything as JSON to ``PATH`` and exit.

Every command is answered with ``KCCAP_BENCH OK <command>`` once done.
The process exits non-zero, naming them on standard error, if it finds
JAX or the JAX package among its modules.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import runpy
import sys
import time

_T0 = time.perf_counter()

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "kubernetesclustercapacity_tpu"})


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (the port's name begins with the latter's, so a
    prefix test would be wrong)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def say(line: str) -> None:
    sys.stdout.write(f"KCCAP_BENCH {line}\n")
    sys.stdout.flush()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--tmp", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--chips", type=int, default=1)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--inject", default=None)
    args = p.parse_args(argv)

    from kccap_bench import spec

    cell = spec.load_cell(os.getcwd(), args.workload)
    setup = {}
    t = time.perf_counter()
    import torch

    setup["torch_import_s"] = time.perf_counter() - t
    if args.device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < args.chips:
            print(f"kccap_bench: the cell needs {args.chips} CUDA "
                  f"device(s); torch.cuda.is_available() is "
                  f"{torch.cuda.is_available()} and device_count() is "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        t = time.perf_counter()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        setup["cuda_init_s"] = time.perf_counter() - t

    from kubernetesclustercapacity_tpu_torch import snapshot_from_fixture
    from kubernetesclustercapacity_tpu_torch.service import CapacityServer
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import REGISTRY

    config = cell["config"]
    t = time.perf_counter()
    cluster = spec.load_module(os.getcwd(), "clusters",
                               config["cluster"]["kind"])
    fixture = cluster.build(config["cluster"], args.seed)
    setup["fixture_s"] = time.perf_counter() - t
    t = time.perf_counter()
    snap = snapshot_from_fixture(
        fixture, semantics=config["semantics"],
        extended_resources=tuple(config.get("extended_resources", ())))
    setup["pack_s"] = time.perf_counter() - t
    if args.inject:
        runpy.run_path(args.inject)
    server = CapacityServer(snap, fixture=fixture, device=args.device,
                            port=0, **config["server"])
    server.start()

    def profiler():
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if args.device == "cuda":
            activities.append(ProfilerActivity.CUDA)
        # The server's requests run on its handler threads, not on this
        # one: record every thread's operators.
        return profile(
            activities=activities,
            experimental_config=torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True))

    if args.trace:
        # A process's first profiler takes seconds to start: start one in
        # set-up, so that the traced window starts when it is due.
        with profiler():
            torch.zeros(1, device=args.device)
    from kccap_bench.gcwatch import GcWatch

    gcw = GcWatch()
    setup["child_s"] = time.perf_counter() - _T0
    say(f"READY {server.address[1]} {json.dumps(setup)}")

    marks: dict = {}
    trace = {}
    prof = None
    trace_t0 = trace_s = 0.0

    def mark(name: str) -> None:
        marks[name] = {
            "t": time.perf_counter(),
            "cpu_s": time.process_time(),
            "server": server.registry.snapshot(),
            "process": REGISTRY.snapshot(),
            "batcher": server.batching_stats,
            "gc": gcw.mark(),
        }

    for line in sys.stdin:
        cmd, _, arg = line.strip().partition(" ")
        if cmd == "mark":
            mark(arg)
        elif cmd == "trace_start":
            prof = profiler()
            mark("trace_start")
            prof.start()
            trace_t0 = time.perf_counter()
        elif cmd == "trace_stop":
            trace_s = time.perf_counter() - trace_t0
            mark("trace_stop")
            prof.stop()
        elif cmd == "dump":
            mark("end")
            device = {"platform": "cpu", "kind": "cpu", "count": 0,
                      "memory_peak_bytes": 0}
            if args.device == "cuda":
                device = {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": args.chips,
                    "memory_peak_bytes": max(
                        torch.cuda.max_memory_allocated(d)
                        for d in range(args.chips)),
                }
            server.shutdown()
            gcw.stop()
            gc_long = (gcw.long_between(marks["start"]["t"],
                                        marks["end"]["t"])
                       if "start" in marks else [])
            if prof is not None:
                from kccap_bench import tracesum

                path = os.path.join(args.tmp, "trace.json")
                prof.export_chrome_trace(path)
                trace = tracesum.reduce(path, trace_s)
                os.unlink(path)
            found = forbidden_modules()
            with open(arg, "w") as f:
                json.dump({"setup": setup, "marks": marks, "trace": trace,
                           "device": device, "forbidden": found,
                           "gc_long": gc_long,
                           "maxrss_kib": resource.getrusage(
                               resource.RUSAGE_SELF).ru_maxrss}, f)
            say(f"OK {cmd}")
            if found:
                print(f"kccap_bench: the server process loaded {found}",
                      file=sys.stderr)
                return 3
            return 0
        else:
            print(f"kccap_bench: unknown command {line!r}", file=sys.stderr)
            return 2
        say(f"OK {cmd}")
    server.shutdown()
    return 1


if __name__ == "__main__":
    sys.exit(main())
