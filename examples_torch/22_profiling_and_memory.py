"""Continuous profiling + the device-memory ledger + the bench gate.

Three observability surfaces from one serving process:

1. **The profiler joined to the phase vocabulary** — a sampling
   profiler folds every thread's stack into collapsed-flamegraph lines
   while requests run; stacks sampled inside a request carry synthetic
   ``op=…;phase=…`` prefix frames from the live attribution table, so
   the host-CPU profile and the ``kccap_phase_seconds`` histogram tell
   ONE story in ONE vocabulary.
2. **The device-memory book** — every devcache staging registered,
   every eviction retired, reconciled against the port's staged tensors (each
   tracked leaf's weak reference) and ``torch.cuda.memory_allocated()``;
   a device-memory leak cannot stay silent, and the doctor line proves the book
   balances.
3. **The bench regression gate** — two bench artifacts diffed under a
   committed noise model: a planted 3x latency regression exits 1 and
   names itself; the rest stays within tolerance.

PyTorch port: the server sweeps on ``device`` (the card by
default) and its staged columns are what the ledger books; the
profiler and ``analysis/benchdiff.py`` are host code.

Run:  python examples_torch/22_profiling_and_memory.py [--device cpu]
"""

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))  # noqa: E402 - run-by-path support

from kubernetesclustercapacity_tpu_torch.analysis import benchdiff
from kubernetesclustercapacity_tpu_torch.service.server import CapacityServer
from kubernetesclustercapacity_tpu_torch.snapshot import synthetic_snapshot
from kubernetesclustercapacity_tpu_torch.telemetry import memledger
from kubernetesclustercapacity_tpu_torch.telemetry.metrics import MetricsRegistry
from kubernetesclustercapacity_tpu_torch.telemetry.profiler import (
    SamplingProfiler,
    dominant_phase,
    phase_counts,
    render_collapsed,
    top_frame,
)

MIB = 1 << 20


def _sweep_msg(n=6):
    return {
        "op": "sweep",
        "cpu_request_milli": [100 * (i + 1) for i in range(n)],
        "mem_request_bytes": [MIB * 64 * (i + 1) for i in range(n)],
        "replicas": [1 + i % 3 for i in range(n)],
    }


def main(device: str = "cuda") -> None:
    # ---- 1. profile a serving process -------------------------------
    snap = synthetic_snapshot(512, seed=7)
    srv = CapacityServer(
        snap, port=0, registry=MetricsRegistry(), device=device
    )
    prof = SamplingProfiler(hz=199)  # hot rate: the example is short
    try:
        srv.dispatch(_sweep_msg())  # warm: compile + staging
        prof.start()
        for _ in range(300):
            srv.dispatch(_sweep_msg())
        prof.stop()

        text = render_collapsed(prof.snapshot()[1])
        counts = phase_counts(text)
        phase, share = dominant_phase(text)
        print("profiler: %d samples, per-phase %s" % (
            sum(counts.values()),
            {k: v for k, v in sorted(counts.items()) if k != "-"},
        ))
        if phase is not None:
            print("dominant phase: %s (%.0f%% of attributed samples), "
                  "hottest frame there: %s"
                  % (phase, share * 100, top_frame(text, phase=phase)))

        # ---- 2. the device-memory book ------------------------------
        st = memledger.LEDGER.stats()
        if st["enabled"]:
            audit = memledger.LEDGER.reconcile()
            print("device ledger: %.1f MiB live (peak %.1f), "
                  "%d entries, reconcile missing=%dB sustained=%dB"
                  % (st["total_bytes"] / MIB, st["peak_bytes"] / MIB,
                     st["entries"], audit["missing_bytes"],
                     audit["sustained_missing_bytes"]))
            print("doctor line: %s" % memledger.device_memory_status())
            assert not memledger.LEDGER.leaking()
    finally:
        prof.stop()
        srv.shutdown()

    # ---- 3. the bench regression gate -------------------------------
    th = benchdiff.Thresholds({"rows": {
        "serving_p50_ms": {"gate": "serving_parity_diffs"},
    }})
    with tempfile.TemporaryDirectory() as d:
        old = os.path.join(d, "old.json")
        new = os.path.join(d, "new.json")
        with open(old, "w") as f:
            json.dump({"dispatch_p50_ms": 2.0, "serving_p50_ms": 7.0,
                       "serving_parity_diffs": 0, "requests": 900}, f)
        with open(new, "w") as f:
            json.dump({"dispatch_p50_ms": 6.0, "serving_p50_ms": 7.1,
                       "serving_parity_diffs": 0, "requests": 910}, f)
        bd = benchdiff.diff_files(old, new, th)
        print(benchdiff.render(bd))
        assert [r.name for r in bd.regressions] == ["dispatch_p50_ms"]


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(device=ap.parse_args().device)
