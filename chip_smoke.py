"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernel from ``kubernetesclustercapacity_tpu_torch/
csrc``, holds every variant against its plain PyTorch version on the card,
drives the ``-grid`` capacity sweep end to end through the port's CLI at the
north-star size (10,000 nodes x 1,000 scenarios, and 100,000 nodes in the
grouped form), checks every total against the exact int64 program on the
card and on the host, and times the kernel beside its bound.  Any failure
raises, so the script exits nonzero without its final line.  It needs a
CUDA device and the package beside it; it imports nothing of JAX.

Output: phase lines, one JSON line per timed kernel variant, a
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# Every operation, integer or float, takes at least one lane of an issued
# instruction, and a Hopper SM issues at most four 32-lane warp
# instructions a clock (one per scheduler).  So ops / (SMs x 128 x clock)
# is a floor whatever pipe each instruction goes to.  The INT32 pipe alone
# has 64 lanes, but integer multiply-adds issue to the FP32 pipe and
# compares fuse into predicates, so a 64-lane rate is not a floor.
LANES_PER_SM = 128
TIMED_LAUNCHES = 100
WARMUP_LAUNCHES = 10
HOLD_S = 0.05  # how long the stream is held while timed launches queue up

# The least work the function needs per (scenario, node) cell, however a
# kernel computes it; the rcp and divide variants compute the same
# function and get the same count.  Per-node terms are not counted: the
# headrooms max(alloc - used, 0), ap - pc, max(ap - pc, 0) and the mask do
# not depend on the scenario.  Per cell: two quotients (a divide counted
# as one operation) and their min, 3; the epilogue, reference 2 (compare
# with ap, select), strict 1 (min with the free slots: the fit and the
# slots are both >= 0, so the outer max is void); the count multiply where
# there are counts, 1; the accumulate, 1.  A node whose mask or count is 0
# adds 0 to every total and needs no per-cell work, so only the cells of
# the other nodes are counted.
FIT_OPS = 3
EPILOGUE_OPS = {False: 2, True: 1}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return float(out.splitlines()[0]) * 1e6


class Variant:
    """One of the kernel's 16 static variants."""

    def __init__(self, rcp: bool, strict: bool, mask: bool, counts: bool):
        self.rcp, self.strict, self.mask, self.counts = rcp, strict, mask, counts

    @property
    def name(self) -> str:
        parts = ["rcp" if self.rcp else "div",
                 "strict" if self.strict else "reference"]
        if self.mask:
            parts.append("mask")
        if self.counts:
            parts.append("counts")
        return "sweep_fit[" + ",".join(parts) + "]"

    def ops_per_cell(self) -> int:
        return FIT_OPS + EPILOGUE_OPS[self.strict] + int(self.counts) + 1

    def operands(self, data: dict, device) -> tuple:
        t = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
        return (
            t["ac"], t["am"], t["ap"], t["uc"], t["um"], t["pc"],
            t["cr"], t["mr"],
            t["crr"] if self.rcp else None, t["mrr"] if self.rcp else None,
            t["mask"] if self.mask else None,
            t["counts"] if self.counts else None,
        )

    def bound(self, ops: tuple, sms: int, clock_hz: float):
        """The least time the card could take on ``ops``, in ms, what
        bounds it, and the cells counted: the larger of the bytes time
        (each node column and scenario operand read once, the int64 totals
        written once, over the memory rate) and the operations time (the
        least operations per cell times the cells this data needs, over
        ``sms`` x :data:`LANES_PER_SM` x ``clock_hz``)."""
        ac, cr, mask, counts = ops[0], ops[6], ops[10], ops[11]
        n, s = int(ac.shape[0]), int(cr.shape[0])
        live = torch.ones(n, dtype=torch.bool, device=ac.device)
        for t in (mask, counts):
            if t is not None:
                live &= t != 0
        cells = int(live.sum()) * s
        cols = 6 + int(self.mask) + int(self.counts)
        scen_bytes = s * 4 * (4 if self.rcp else 2)
        nbytes = n * cols * 4 + scen_bytes + s * 8
        bytes_s = nbytes / HBM_BYTES_PER_S
        ops_s = (self.ops_per_cell() * cells
                 / (sms * LANES_PER_SM * clock_hz))
        if ops_s >= bytes_s:
            return ops_s * 1e3, "operations", cells
        return bytes_s * 1e3, "bytes", cells

VARIANTS = [Variant(*bits) for bits in itertools.product((False, True), repeat=4)]


def eligible_data(n: int, s: int, seed: int) -> dict:
    """Seeded kernel operands (KiB memory) inside the rcp-eligible domain,
    with Q1-negative nodes (pods_count > alloc_pods), a random 0/1 mask
    and group counts."""
    from kubernetesclustercapacity_tpu_torch.ops.fused_fit import (
        scenario_reciprocals,
    )

    rng = np.random.default_rng(seed)
    cores = rng.choice(np.array([2, 4, 8, 16, 32, 64]), size=n)
    ac = (cores * 1000).astype(np.int32)
    am = (cores * 4 * 1024 * 1024 - rng.integers(0, 2**18, n)).astype(np.int32)
    return _with_scenarios(rng, {
        "ac": ac,
        "am": am,
        "ap": np.full(n, 110, dtype=np.int32),
        "uc": (ac * rng.random(n) * 0.8).astype(np.int32),
        "um": (am * rng.random(n) * 0.8).astype(np.int32),
        "pc": rng.integers(0, 130, n).astype(np.int32),
        "mask": (rng.random(n) < 0.85).astype(np.int32),
        "counts": rng.integers(0, 4, n).astype(np.int32),
    }, s, scenario_reciprocals)


def _with_scenarios(rng, data, s, recip):
    cr = rng.integers(50, 4000, s).astype(np.int32)
    mr = (rng.integers(64, 8192, s) * 1024).astype(np.int32)
    data.update(cr=cr, mr=mr, crr=recip(cr), mrr=recip(mr))
    return data


def rcp_edge_data() -> list[dict]:
    """The reciprocal-division edge inputs: dividends on and one off
    multiples of the divisor at the largest eligible quotient (2^20), and
    the wrapping fixup product (dividend at int32 max, divisor 2^29)."""
    from kubernetesclustercapacity_tpu_torch.ops.fused_fit import (
        scenario_reciprocals as recip,
    )

    q, d_cpu, d_mem = 1 << 20, 997, 1031
    n = 64
    base = {
        "uc": np.zeros(n, np.int32), "um": np.zeros(n, np.int32),
        "pc": np.zeros(n, np.int32), "ap": np.full(n, 1 << 30, np.int32),
        "mask": np.ones(n, np.int32), "counts": np.ones(n, np.int32),
    }
    boundary = dict(base)
    boundary["ac"] = np.array(
        [q * d_cpu, q * d_cpu - 1, q * d_cpu + 1, (q - 1) * d_cpu] * (n // 4),
        dtype=np.int32)
    boundary["am"] = np.array(
        [q * d_mem, q * d_mem - 1, q * d_mem + 1, (q - 1) * d_mem] * (n // 4),
        dtype=np.int32)
    boundary["cr"] = np.array([d_cpu], np.int32)
    boundary["mr"] = np.array([d_mem], np.int32)
    wrap = dict(base)
    wrap["ac"] = np.full(n, (1 << 31) - 1, np.int32)
    wrap["am"] = np.full(n, 1 << 20, np.int32)
    wrap["cr"] = np.array([1 << 29], np.int32)
    wrap["mr"] = np.array([1], np.int32)
    for d in (boundary, wrap):
        d["crr"], d["mrr"] = recip(d["cr"]), recip(d["mr"])
    return [boundary, wrap]


def phase_kernel_vs_plain(ff, device) -> tuple[int, int]:
    """All 16 variants at 10k x 1k, the edge shapes and the rcp edge
    inputs: kernel totals must equal the plain version's exactly (the
    tolerance is 0: the totals are integers).  Returns the kernel calls
    made and the largest |kernel - plain| seen."""
    cases = [(eligible_data(10_000, 1_000, seed=7), "10000x1000"),
             (eligible_data(1, 1, seed=8), "1x1"),
             (eligible_data(2049, 257, seed=9), "2049x257")]
    cases += [(d, f"rcp-edge-{i}") for i, d in enumerate(rcp_edge_data())]
    calls = max_err = 0
    before = ff.LAUNCHES
    for data, label in cases:
        for v in VARIANTS:
            ops = v.operands(data, device)
            got = ff.sweep_fused(*ops, strict=v.strict)
            calls += 1
            torch.cuda.synchronize()
            want = ff.sweep_fused_plain(*ops, strict=v.strict)
            err = int((got - want).abs().max())
            max_err = max(max_err, err)
            if err:
                raise AssertionError(
                    f"{v.name} at {label}: kernel differs from plain "
                    f"(max |diff| {err})")
        log(f"kernel == plain: 16 variants at {label}")
    if ff.LAUNCHES - before != calls:
        raise AssertionError(
            f"LAUNCHES rose by {ff.LAUNCHES - before}, expected {calls}")
    return calls, max_err


def run_cli(cli, argv: list[str]) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli {argv} exited {rc}: {buf.getvalue()[-500:]}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def phase_main_path(pkg, cli, ff, tmp: str) -> dict:
    """The -grid sweep through the port's CLI, on the card, checked
    against the exact program on the card and everything on the host.
    Returns the kernel launches counted around each path's run."""
    launches = {}

    def path(name: str, npz: str, expect_label: str, extra=()):
        argv = ["-snapshot", npz, "-grid", "1000", "-output", "json", *extra]
        ff.LAUNCHES = 0
        t0 = time.perf_counter()
        doc = run_cli(cli, argv)
        dt = time.perf_counter() - t0
        launches[name] = ff.LAUNCHES
        if doc["kernel"] != expect_label:
            raise AssertionError(f"{name}: label {doc['kernel']}, want "
                                 f"{expect_label}")
        if expect_label.startswith("cuda_") and launches[name] < 1:
            raise AssertionError(f"{name}: the kernel was not launched")
        exact = run_cli(cli, argv + ["-kernel", "exact"])
        host = run_cli(cli, argv + ["-device", "cpu"])
        for other, what in ((exact, "exact on the card"), (host, "host")):
            if other["totals"] != doc["totals"] or \
                    other["schedulable"] != doc["schedulable"]:
                raise AssertionError(f"{name}: totals differ from {what}")
        totals = np.asarray(doc["totals"])
        if totals.shape != (1000,):
            raise AssertionError(f"{name}: {totals.shape} totals")
        log(f"main path {name}: label {doc['kernel']}, launches "
            f"{launches[name]}, {dt:.3f} s through the CLI, totals "
            f"sum {int(totals.sum())}, p50 {doc['totals_p50']}, equal to "
            f"exact-on-card ({exact['kernel']}) and host ({host['kernel']})")

    a = os.path.join(tmp, "a.npz")
    pkg.synthetic_snapshot(10_000, seed=1).save(a)
    path("(a) 10k x 1k reference", a, "cuda_i32_rcp_fused")

    b = os.path.join(tmp, "b.npz")
    fixture = pkg.synthetic_fixture(10_000, seed=3, taint_frac=0.1)
    strict = pkg.snapshot_from_fixture(fixture, semantics="strict")
    if pkg.implicit_taint_mask(strict) is None:
        raise AssertionError("(b): the strict fixture carries no taints")
    strict.save(b)
    path("(b) 10k x 1k strict, taint-masked", b, "cuda_i32_rcp_fused",
         ["-semantics", "strict"])

    c = os.path.join(tmp, "c.npz")
    pkg.synthetic_snapshot(100_000, seed=2, shapes=48).save(c)
    path("(c) 100k grouped (48 shapes) x 1k", c, "cuda_i32_rcp_fused_grouped")

    d = os.path.join(tmp, "d.npz")
    pkg.synthetic_snapshot(10_000, seed=4, kib_quantized=False).save(d)
    path("(d) 10k x 1k not KiB-quantized", d, "torch_int64")
    return launches


def phase_exact_adversarial(fit) -> None:
    """The exact int64 program on hostile bit patterns (Go uint64 wrap,
    INT64_MIN headroom, requests of 1 and non-KiB memory), card vs host:
    CUDA's int64 division is software and must agree."""
    rng = np.random.default_rng(10)
    n = 4099

    def mixed(lo, hi):
        v = rng.integers(lo, hi, size=n, dtype=np.int64)
        hostile = rng.random(n) < 0.1
        return np.where(
            hostile, rng.integers(-(2**62), 2**62, size=n, dtype=np.int64), v)

    cols = [mixed(0, 10**6), mixed(0, 2**45), rng.integers(0, 200, n),
            mixed(0, 10**6), mixed(0, 2**45), rng.integers(0, 300, n),
            rng.random(n) < 0.9]
    cols[0][:4] = [-1, -(2**63), 5, 2**63 - 1]
    cols[3][:4] = [-(2**63), -1, 2**63 - 1, 0]
    cols[1][4], cols[4][4] = 0, -(2**63)  # headroom wraps to INT64_MIN
    cpu = np.array([100, 1, 123457, -5, -(2**63), 2**62 + 1], np.int64)
    mem = np.array([2**20, 1, 987654321, 3, 7, 1024], np.int64)
    reps = np.zeros(cpu.size, np.int64)
    mask = rng.random(n) < 0.7
    for mode, node_mask in itertools.product(("reference", "strict"),
                                             (None, mask)):
        card = fit.sweep_grid_staged(*cols, cpu, mem, reps, mode=mode,
                                     node_mask=node_mask,
                                     return_per_node=True, device="cuda")
        host = fit.sweep_grid_staged(*cols, cpu, mem, reps, mode=mode,
                                     node_mask=node_mask,
                                     return_per_node=True, device="cpu")
        if not all(np.array_equal(x, y) for x, y in zip(card, host)):
            raise AssertionError(f"exact program: card != host ({mode})")
    log("exact int64 program: card == host on adversarial inputs "
        "(2 modes x masked/unmasked, per-node fits and totals)")


def device_ms(fn, clock_hz: float,
              launches: int = TIMED_LAUNCHES) -> tuple[float, bool]:
    """Median device time of one of ``launches`` calls, each bracketed by
    CUDA events, after warm-up.  A sleep kernel holds the stream while the
    host enqueues the calls, so the card runs them back to back and each
    event pair brackets the call's own kernels, not the host's launch
    cadence.  Returns the median and whether the hold outlasted the
    enqueueing (if not, the later pairs may include host gaps)."""
    for _ in range(WARMUP_LAUNCHES):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(launches)]
    torch.cuda._sleep(int(HOLD_S * clock_hz))
    held = torch.cuda.Event()
    held.record()
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    hold_ok = not held.query()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs), hold_ok


def host_call_ms(fn, launches: int = TIMED_LAUNCHES) -> float:
    """Host time per call of ``launches`` back-to-back calls ending in a
    synchronize, after warm-up: what a caller waits for when it issues
    calls one after another."""
    for _ in range(WARMUP_LAUNCHES):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / launches


def bare_launch(ff, ops, strict: bool, sms: int):
    """A callable that launches the kernel through its C entry point with
    every argument prepared once, so the timing sees the kernel and not
    the wrapper's Python checks (``sweep_fused`` is timed on its own as
    ``wrapper_host_ms``).  The totals are not re-zeroed between launches;
    the work per launch is the same."""
    ac, am, ap, uc, um, pc, cr, mr, crr, mrr, mask, counts = ops
    n, s = int(ac.shape[0]), int(cr.shape[0])
    totals = torch.zeros(s, dtype=torch.int64, device=ac.device)
    ptr = [None if t is None else t.data_ptr() for t in
           (ac, am, ap, uc, um, pc, mask, counts, cr, mr, crr, mrr, totals)]
    args = (*ptr, n, s, ff.node_chunk(n, s, sms), int(strict),
            torch.cuda.current_stream().cuda_stream)
    fn = ff._sweep_fn()

    def launch():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"sweep_fit launch failed: CUDA error {rc}")

    return launch


def phase_times(pkg, ff, device, identity: str, clock_hz: float,
                launches: dict) -> list[dict]:
    """Each variant the main path launches, plus the int32-divide
    reference variant, at the main path's shapes: the bare kernel's device
    time (``ms``) and the plain version's (``plain_ms``), each the median
    of 100 CUDA-event-timed calls queued behind a held stream
    (:func:`device_ms`), and the host time per call through the wrapper
    (``wrapper_host_ms``)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    big = eligible_data(10_000, 1_000, seed=7)
    grouped_snap = pkg.synthetic_snapshot(100_000, seed=2, shapes=48)
    g = grouped_snap.grouped()
    from kubernetesclustercapacity_tpu_torch.ops.fused_fit import (
        scenario_reciprocals,
    )
    rng = np.random.default_rng(11)
    grouped = _with_scenarios(rng, {
        "ac": g.alloc_cpu_milli.astype(np.int32),
        "am": (g.alloc_mem_bytes // 1024).astype(np.int32),
        "ap": g.alloc_pods.astype(np.int32),
        "uc": g.used_cpu_req_milli.astype(np.int32),
        "um": (g.used_mem_req_bytes // 1024).astype(np.int32),
        "pc": g.pods_count.astype(np.int32),
        "mask": np.ones(g.n_groups, np.int32),
        "counts": g.count.astype(np.int32),
    }, 1_000, scenario_reciprocals)
    timed = [
        (Variant(True, False, False, False), big, "(a)"),
        (Variant(True, True, True, False), big, "(b)"),
        (Variant(True, False, False, True), grouped, "(c)"),
        (Variant(False, False, False, False), big, None),
    ]
    rows = []
    for v, data, path in timed:
        ops = v.operands(data, device)
        n, s = int(ops[0].shape[0]), int(ops[6].shape[0])
        ms, hold_ok = device_ms(bare_launch(ff, ops, v.strict, sms), clock_hz)
        plain_ms, plain_hold_ok = device_ms(
            lambda: ff.sweep_fused_plain(*ops, strict=v.strict), clock_hz)
        wrapper_host_ms = host_call_ms(
            lambda: ff.sweep_fused(*ops, strict=v.strict))
        bound_ms, bound_by, cells = v.bound(ops, sms, clock_hz)
        rows.append({
            "kernel": v.name, "shape": f"{n}x{s}", "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "wrapper_host_ms": wrapper_host_ms,
            "hold_outlasted_enqueue": {"kernel": hold_ok,
                                       "plain": plain_hold_ok},
            "ops_per_cell": v.ops_per_cell(), "cells": cells,
            "launches": launches.get(path, 0) if path else 0,
            "main_path": path, "library_ms": None, "gpu": identity,
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


def host_median_ms(fn, runs: int = 20, warmup: int = 5) -> float:
    times = []
    for i in range(warmup + runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_end_to_end(pkg, ff) -> dict:
    """One sweep_snapshot_auto at 10k x 1k, host-clocked to a synchronize
    (median of 20 after warm-up; the snapshot's columns are device-resident
    after the first call), beside the host-side eligibility proofs it runs
    on every call, timed alone the same way, and the same sweep forced
    through the exact int64 program."""
    snap = pkg.synthetic_snapshot(10_000, seed=1)
    grid = pkg.random_scenario_grid(1_000, seed=0)
    nodes = (snap.alloc_cpu_milli, snap.alloc_mem_bytes, snap.alloc_pods,
             snap.used_cpu_req_milli, snap.used_mem_req_bytes,
             snap.pods_count)
    reqs = (grid.cpu_request_milli, grid.mem_request_bytes)
    out = {
        "end_to_end_ms": host_median_ms(
            lambda: ff.sweep_snapshot_auto(snap, grid, device="cuda")),
        "eligibility_ms": host_median_ms(lambda: (
            ff.fast_sweep_eligible(*nodes, *reqs),
            ff.rcp_division_eligible(nodes[0], nodes[1], nodes[3], nodes[4],
                                     *reqs))),
        "exact_end_to_end_ms": host_median_ms(
            lambda: ff.sweep_snapshot_auto(snap, grid, kernel="exact",
                                           device="cuda")),
    }
    log(f"end to end sweep_snapshot_auto 10000x1000: median "
        f"{out['end_to_end_ms']:.4f} ms, of which the host eligibility "
        f"proofs alone take {out['eligibility_ms']:.4f} ms; forced through "
        f"the exact int64 program {out['exact_end_to_end_ms']:.4f} ms "
        "(host clock, 20 runs each)")
    out.update(phase_trace(snap, grid, ff, out["end_to_end_ms"]))
    return out


def phase_trace(snap, grid, ff, end_to_end_ms: float,
                runs: int = 20) -> dict:
    """Where a 10k x 1k sweep's device time goes: torch.profiler over
    ``runs`` warm sweep_snapshot_auto calls, device time per sweep by
    kernel or copy (the sweep kernel's own as ``kernel_trace_ms``), and
    the card's busy share, that device time over the unprofiled
    end-to-end median."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            ff.sweep_snapshot_auto(snap, grid, device="cuda")
        torch.cuda.synchronize()
    per_name: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            per_name[ev.name] = (per_name.get(ev.name, 0.0)
                                 + ev.time_range.elapsed_us() / 1e3 / runs)
    if not per_name:
        raise AssertionError("the profiler recorded no device activity")
    device_ms = sum(per_name.values())
    kernel_ms = sum(ms for name, ms in per_name.items()
                    if "sweep_fit_kernel" in name)
    if not kernel_ms:
        raise AssertionError("the trace shows no sweep_fit kernel")
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"trace of {runs} sweeps: {device_ms:.4f} ms of device work per "
        f"sweep, busy share {device_ms / end_to_end_ms:.3f} of the "
        "end-to-end median; by name (ms per sweep): "
        + "; ".join(f"{name[:60]} {ms:.4f}" for name, ms in top))
    return {"device_ms_per_sweep": device_ms,
            "kernel_trace_ms": kernel_ms,
            "device_busy_share": device_ms / end_to_end_ms,
            "device_ms_by_name": dict(top)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    import kubernetesclustercapacity_tpu_torch as pkg
    from kubernetesclustercapacity_tpu_torch import cli
    from kubernetesclustercapacity_tpu_torch.ops import _build
    from kubernetesclustercapacity_tpu_torch.ops import fit
    from kubernetesclustercapacity_tpu_torch.ops import fused_fit as ff

    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("the port imported jax")
    t_start = time.perf_counter()
    identity = gpu_identity()
    log(identity)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    clock_hz = sm_clock_hz()
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    _build.library("sweep_fit")
    log(f"build: csrc/sweep_fit.cu in {time.perf_counter() - t0:.2f} s "
        f"({' '.join(_build.NVCC_FLAGS)})")
    variant = "?"
    for line in _build.ptxas_report("sweep_fit").splitlines():
        flags = re.search(r"sweep_fit_kernelILb(\d)ELb(\d)ELb(\d)ELb(\d)E", line)
        if flags:
            variant = Variant(*(bit == "1" for bit in flags.groups())).name
        elif "registers" in line:
            log(f"  {variant}: {line.split(':', 1)[1].strip()}")

    calls, max_err = phase_kernel_vs_plain(ff, device)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_main_path(pkg, cli, ff, tmp)
    phase_exact_adversarial(fit)
    main_launches = {"(a)": launches["(a) 10k x 1k reference"],
                     "(b)": launches["(b) 10k x 1k strict, taint-masked"],
                     "(c)": launches["(c) 100k grouped (48 shapes) x 1k"]}
    rows = phase_times(pkg, ff, device, identity, clock_hz, main_launches)
    e2e = phase_end_to_end(pkg, ff)

    head = rows[0]
    kernels = {"kernels": [{
        "name": "sweep_fit",
        "route": "cuda",
        "source": "kubernetesclustercapacity_tpu_torch/csrc/sweep_fit.cu",
        "replaces": "kubernetesclustercapacity_tpu/ops/pallas_fit.py:450",
        "launches": sum(main_launches.values()),
        "max_abs_err": max_err,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes this function",
        "shape": head["shape"],
        "variants_checked": len(VARIANTS),
        "checked_calls": calls,
        "variants": rows,
        **e2e,
        "gpu": identity,
    }]}
    print(json.dumps(kernels), flush=True)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")
    log(identity)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
