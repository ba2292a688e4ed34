"""Finds the highest rate a cell's traffic is served at without a growing
backlog: one server process, one set-up, then one window per rate.

    python3 -m kccap_bench.ratesweep --workload W --seed N --seconds 10 \\
        --rates 100,200,400

For each rate it prints the requests sent and failed, the latency median
and 95th percentile from when each was due, the median latency of the
window's last quarter over its first (above 1 the backlog grows), and
how late the generator and the connection pool sent.  The benchmark's
runs never run it; a cell's traffic file keeps the rate it chose.
"""

from __future__ import annotations

import argparse
import copy
import gc
import os
import sys
import tempfile
import time

import numpy as np

from kccap_bench import spec
from kccap_bench.load import Records, drive, send_all
from kccap_bench.run import GRACE_S, READY_TIMEOUT_S, Child, _latencies


def _trend(rec: Records) -> float:
    lat = rec.done - rec.due
    q = max(len(lat) // 4, 1)
    return float(np.nanmedian(lat[-q:]) / np.nanmedian(lat[:q]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    root = os.getcwd()
    cell = spec.load_cell(root, args.workload)
    config, traffic = cell["config"], cell["traffic"]
    kind = spec.load_module(root, "gen", traffic["kind"])
    cluster = spec.load_module(root, "clusters", config["cluster"]["kind"])
    tmp = tempfile.mkdtemp(prefix="kccap_bench_")
    child = Child(root, ["--workload", args.workload, "--seed",
                         str(args.seed), "--tmp", tmp, "--device",
                         args.device])
    from kubernetesclustercapacity_tpu_torch.service import CapacityClient

    fixture = cluster.build(config["cluster"], args.seed)
    gc.collect()
    gc.freeze()
    ready = child.expect("READY", READY_TIMEOUT_S)
    if ready is None:
        print("kccap_bench: the server process ended before it served",
              file=sys.stderr)
        return 1
    port = int(ready.split(" ", 1)[0])
    pool = [CapacityClient("127.0.0.1", port, connect_timeout_s=60,
                           timeout_s=300, retry=None)
            for _ in range(int(traffic["connections"]))]
    try:
        for k, rate in enumerate(float(r) for r in args.rates.split(",")):
            t = copy.deepcopy(traffic)
            t["rate_per_s"] = rate
            plan = kind.plan(t, config, args.seed + k, args.seconds, fixture)
            gc.collect()
            gc.freeze()
            if k == 0:
                for group in plan.warm:
                    send_all(pool, group)
            t0 = time.perf_counter()
            records = drive(plan, pool, None, t0,
                            t0 + args.seconds + GRACE_S)
            load = _latencies(records, args.seconds)
            lat = np.asarray(load["answer_ms"])
            print(f"rate {rate:g}/s: sent {load['attempted']}, failed "
                  f"{load['failed']}, p50 {np.percentile(lat, 50):.3f} ms, "
                  f"p95 {np.percentile(lat, 95):.3f} ms, last/first quarter "
                  f"median {_trend(records[0]):.3f}, generator late "
                  f"{load['released_late_ms']}, sent late "
                  f"{load['sent_late_ms']}", flush=True)
            time.sleep(2.0)
    finally:
        for c in pool:
            c.close()
        child.command(f"dump {os.path.join(tmp, 'artifacts.json')}")
        child.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
