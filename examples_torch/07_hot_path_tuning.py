"""Hot-path tuning: device cache and request micro-batching.

Two knobs make repeated capacity queries run at device speed instead
of re-paying per-request overhead:

* the **device cache** keeps a snapshot's node arrays device-resident
  across sweeps (``KCCAP_DEVCACHE=0`` disables it);
* **micro-batching** (``kccap-torch-server -batch-window-ms/-batch-max``)
  merges concurrent sweeps of one snapshot generation into a single
  kernel launch.

The JAX package has a third knob, the **shape-bucket ladder**, which
pads node counts to the next power of two so that XLA reuses a compiled
executable across nearby shapes.  Eager PyTorch compiles nothing per
shape, so the port has no ladder; this example prints that fact where
the JAX example walks the ladder.

This example drives both knobs and reads their stats back through the
``info {hot_path: true}`` op — the same numbers ``/metrics`` exposes as
``kccap_devcache_*`` and ``kccap_batch_*``.

PyTorch port: the snapshot is staged on ``device`` (the card by
default).  The library sweeps run the exact int64 program there; the
served sweeps, solo and folded, run kernel B1 (``csrc/sweep_fit.cu``),
whose plain PyTorch version stands in with ``--device cpu``.

Run:  python examples_torch/07_hot_path_tuning.py [--device cpu]
"""

import os
import sys
import threading

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))  # noqa: E402 - run-by-path support

import numpy as np

from kubernetesclustercapacity_tpu_torch import devcache
from kubernetesclustercapacity_tpu_torch.ops.fit import sweep_snapshot
from kubernetesclustercapacity_tpu_torch.scenario import random_scenario_grid
from kubernetesclustercapacity_tpu_torch.service import CapacityClient, CapacityServer
from kubernetesclustercapacity_tpu_torch.snapshot import synthetic_snapshot


def main(device: str = "cuda") -> None:
    # --- shape buckets: not in the port.  Each sweep launches the same
    # kernels at the snapshot's own node count; there is no compiled
    # executable to reuse, so nothing is padded.
    print("node bucket ladder: none (eager PyTorch compiles nothing per "
          "shape; sweeps run at the exact node count)")

    # --- device cache: the first sweep of a snapshot stages its arrays
    # on device (miss); every later sweep of the same snapshot hits.
    snap = synthetic_snapshot(1000, seed=7)
    grid = random_scenario_grid(64, seed=8)
    before = devcache.CACHE.stats()
    totals_first, _ = sweep_snapshot(snap, grid, device=device)
    for _ in range(3):
        totals, _ = sweep_snapshot(snap, grid, device=device)
        assert np.array_equal(totals, totals_first)  # bit-exact on hits
    after = devcache.CACHE.stats()
    print(
        f"devcache: +{after['misses'] - before['misses']} miss, "
        f"+{after['hits'] - before['hits']} hits "
        f"(hit_rate now {after['hit_rate']:.2f})"
    )

    # --- micro-batching: concurrent client sweeps of one generation
    # collapse into shared kernel launches; every response still carries
    # its own slice, bit-identical to a solo dispatch.
    server = CapacityServer(
        snap, port=0, batch_window_ms=10.0, batch_max=16, max_inflight=16,
        device=device,
    )
    server.start()
    try:
        expected = {
            seed: sweep_snapshot(
                snap, random_scenario_grid(8, seed=seed), device=device
            )[0].tolist()
            for seed in range(6)
        }
        results: dict[int, list] = {}
        barrier = threading.Barrier(6)

        def worker(seed: int) -> None:
            with CapacityClient(*server.address) as c:
                barrier.wait()
                results[seed] = c.sweep(random={"n": 8, "seed": seed})[
                    "totals"
                ]

        threads = [
            threading.Thread(target=worker, args=(s,)) for s in range(6)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert all(results[s] == expected[s] for s in range(6))

        with CapacityClient(*server.address) as c:
            hot = c.info(hot_path=True)["hot_path"]
        bt = hot["batching"]
        print(
            f"batching: {bt['dispatches']} dispatch(es) served "
            f"{bt['batched_requests'] + bt['solo_requests']} requests, "
            f"mean batch size {bt['mean_batch_size']:.2f}"
        )
        print(f"server devcache hit_rate: {hot['devcache']['hit_rate']:.2f}")
    finally:
        server.shutdown()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(device=ap.parse_args().device)
