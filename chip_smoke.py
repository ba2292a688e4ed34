"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``kubernetesclustercapacity_tpu_torch/
csrc`` (B1 ``sweep_fit.cu``, B2 ``sweep_multi.cu`` and the exact int64 sweep
``sweep_exact.cu``, one ``nvcc`` each, started together), holds every
variant of each against its plain PyTorch version on the card, drives the ``-grid`` capacity sweep end to end through
the port's CLI at the north-star size (10,000 nodes x 1,000 scenarios, and
100,000 nodes in the grouped form) and the R-resource sweep of BASELINE
config 4 (``-extended-request``, 4 resources) through the CLI and the
library call, checks every total against the exact int64 program on the
card and on the host, and times each kernel beside its bound.  Then it
drives the single-spec surface at 10,000 nodes: the reference transcript
and ``-explain`` through the CLI, the fused sweep+explain and
sweep+quantile programs, and ``CapacityModel``'s sweeps, which must launch
B1 and B2 once each.  Last it drives the capacity service (path (l)): the
port's ``CapacityServer`` on the card, through its ``CapacityClient``, at
the same widths (``sweep`` one launch of B1, ``sweep_multi`` one of B2, 8
concurrent sweeps folded into fewer than 8 launches, ``reload``, ``fit``
and ``explain``), with each op's latency.  Path (m) drives the live
cluster at 5,000 nodes and 150,000 pods through a mock apiserver in this
process: the CLI without ``-snapshot``, 6 ``update`` batches of a
600-event churn stream, and two ``-follow`` servers (follower →
coalescer → a publish pre-staged on the card) taking the same stream on
their watch; every sweep after a change launches B1 once, the strict
server's ``sweep_multi`` B2 once, each equal to the exact program on a
full repack.  Path (n) drives scheduler fidelity at 10,000 nodes: the
placement scans on the card against the host engines, ``drain`` with its
disruption-budget gate (and ``-drain`` through the CLI), preemption,
topology spread and scale planning (B1 twice), and the service's
``place``/``drain``/``topology_spread``/``plan`` and priority ops.  Path
(o) drives capacity at risk, forecasting and the certified catalog planner
at 10,000 nodes: the seeded sampler on the card against the host (0
mismatches over 3 x 65,536 draws), ``capacity_at_risk``, the
``[16 x 512]`` horizon and the plan against their numpy oracles, the CLI's
``-car-spec``/``-forecast-spec``/``-plan -catalog`` against their
``-device cpu`` runs, and the service's ``car``/``forecast``/``plan``;
kernels B1 and B2 are not on that path and launch 0 times there.  Path
(p) drives gang capacity and the certified optimizer: a 64-rank rack gang
on a 1,000,000-node hierarchical fleet (grouped engine) and zone/rack and
host-anti-affinity gangs at 10,000 nodes x 1,000 scenarios (per-node
engine, the spread searches) against ``gang_oracle`` and the host, the
PDHG at the JAX bench's config (certified, verified, ``rounded == ffd``,
integers equal to the host run) and ungrouped, ``-gang-spec`` and
``-optimize`` against their ``-device cpu`` runs, and the service's
``gang`` and ``optimize``; B1 and B2 launch 0 times there too.  Path (q)
drives the operator's view of a running server: (m)'s cluster with
zone/rack labels behind the mock apiserver, one strict ``-follow`` server
with a watchlist of eight watches (plain, capacity at risk, forecast,
gang), its capacity timeline, an SLO monitor and a metrics endpoint;
one timeline record per published generation, each plain watch equal to
B1's sweep, the exact program and the host oracle, every record equal to
a CPU timeline fed the same snapshots, the scrape equal to the last
record, ``/healthz`` flipping with the breached watches, and the
``timeline``/``dump``/``slo`` ops and their CLI flags.  Path (r) drives
the audit trail and the replicated serving plane on (q)'s cluster: a
file-backed leader with an audit log, a shadow sampler, a plane publisher,
a 3-tenant map and admission control takes the stream in 6 ``update``
batches and answers every replayable op from the tenants' clients (B1 for
its sweeps, B2 for ``sweep_multi``); two replicas on the card follow its
plane (one through a fault proxy that cuts the stream once), each equal to
the leader at every generation with one B1 launch a sweep; the capped
tenant is refused; ``-replay`` of the leader's log verifies every request
on the card (B1 once a replayed sweep) and equals the host's replay.  Path
(s) drives the federation tier: the JAX bench's fleet of 4 x 1,000,000
nodes injected into one federation on the card (per-cluster totals equal
``fit_totals_numpy``, cluster-0 stale then lost and excluded by name on a
driven clock), then three strict 5,000-node leaders on the card feeding a
federation on the card through their planes (one through a fault proxy):
after each of 6 ``update`` batches on one leader every ``per_cluster`` row
of ``fed_sweep`` equals that leader's B1 sweep, and the proxied cluster is
partitioned (stale, lost: excluded, ``spillover`` refused, ``/healthz``
503, ``-fed-status``/``-fed-sweep`` exit 1) and healed.  Path (t) drives
the diagnostics against those servers: ``-doctor`` (exit 0 naming the
card, 1 with the cluster lost), ``-trace-tree`` over their span logs, a
leader's sampling profiler through ``-profile``, and ``-jax-profile`` of a
``-grid`` run, whose ``torch.profiler`` trace names ``sweep_fit``.  Path
(u) drives the native backend and the multi-device sweep: ``-backend
native`` on (g)'s fleet (byte-equal to (g)'s transcripts), ``native.sweep``
at 10,000 x 1,000 equal to B1, the exact program and the host, the
divide-by-zero panic (exit 2), the native pod walk on (m)'s cluster (every
column equal to the Python walk's; the script fails if the Python walk ran
or a native piece did not build), ``kccap-client`` built with ``g++``
against a port server on the card, the JAX package's 1,000,003-node mesh
layouts (shard_map 1x8, GSPMD 2x4) on a mesh that names the card eight
times, and two processes over gloo on the card (this script with
``--multihost-worker``).  Path (v) drives the static analyzer and the
runtime sanitizer: ``kccap-torch-lint --json`` over the package of this
checkout (0 findings, 0 baselined; the device roots, the functions
reachable from them and the inline markers counted), then (b)'s strict
server on the card with the sanitizer installed (seed 0) under 16 client
threads x 20 sweeps of ``random_scenario_grid(1000, seed=7)`` folded by
the micro-batcher (every total equal to the solo sweep, B1 launched, 0
races, 0 lock-order cycles), the same load without the sanitizer, and
the hammer over seeds 0-2 (0 findings); last ``torch.cuda.
set_sync_debug_mode("warn")`` around ``place_replicas`` at 64 and 256
steps, ``_pdhg_chunk`` at 50 and 500 iterations and a gang spread search
at two search depths, whose sync count must not grow with the steps.
Path (w) runs the twins of the JAX package's ``examples/`` scripts
(``examples_torch/``, one for every script) in this process with their
asserts live: each device twin with ``device="cuda"`` (B1 must launch in
``02`` and ``12``, B2 in ``02``), the analyzer and sanitizer twins on the
host; eight deterministic twins are run again on the host and must print
the same lines (durations aside; the CPU tests hold the host's lines
against the JAX scripts').  Any failure raises, so the script exits nonzero without its final line.  It needs a CUDA device and the package beside it;
it imports nothing of JAX.

Output: phase lines, one JSON line per timed kernel variant, a
``{"paths": {...}}`` line with the single-spec paths' times, a
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import itertools
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# The exact kernel's hostile inputs, shared with the tests (numpy only).
sys.path.append(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests"))
import exact_edges  # noqa: E402

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
HOLD_S = 0.05  # the shortest hold of the stream while timed calls queue up
GIB = 1 << 30
MIB = 1 << 20

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


def phase_main_path(pkg, cli, fit, ff, tmp: str) -> tuple[dict, dict]:
    """The -grid sweep through the port's CLI, on the card, checked
    against the exact program on the card and everything on the host.
    Returns the launches of B1 and of the exact kernel counted around each
    path's own run: B1's alone on (a)-(c), the exact kernel's alone on
    (d)."""
    launches, exact_launches = {}, {}

    def path(name: str, npz: str, expect_label: str, extra=()):
        argv = ["-snapshot", npz, "-grid", "1000", "-output", "json", *extra]
        ff.LAUNCHES = fit.EXACT_LAUNCHES = 0
        t0 = time.perf_counter()
        doc = run_cli(cli, argv)
        dt = time.perf_counter() - t0
        launches[name] = ff.LAUNCHES
        exact_launches[name] = fit.EXACT_LAUNCHES
        if doc["kernel"] != expect_label:
            raise AssertionError(f"{name}: label {doc['kernel']}, want "
                                 f"{expect_label}")
        on, off = (exact_launches, launches) \
            if expect_label.startswith("torch_int64") \
            else (launches, exact_launches)
        if on[name] < 1 or off[name]:
            raise AssertionError(
                f"{name}: sweep_fit launched {launches[name]} times, "
                f"sweep_exact {exact_launches[name]} times")
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
            f"{launches[name]} (sweep_exact {exact_launches[name]}), "
            f"{dt:.3f} s through the CLI, totals "
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
    return launches, exact_launches


def phase_exact_adversarial(fit) -> None:
    """The exact int64 program on hostile bit patterns (Go uint64 wrap,
    INT64_MIN headroom, requests of 1 and non-KiB memory), card vs host:
    CUDA's int64 division is software and must agree.  The inputs are
    ``tests/exact_edges.py``'s."""
    cols = exact_edges.columns(4099, seed=10)
    cpu, mem, reps = exact_edges.requests(12, seed=11)
    mask = exact_edges.mask(4099, seed=12)
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


# The cases of :func:`exact_kernel_cases` that :func:`phase_exact_times` times.
EXACT_TIMED = ("5000x1000 k5k-ref", "10000x1000 (d)")


def exact_kernel_cases(pkg) -> list[tuple[str, tuple, np.ndarray | None]]:
    """The exact kernel's inputs: ``(label, (seven node columns, cpu, mem,
    replicas), counts or None)``.  ``tests/exact_edges.py``'s hostile
    columns and requests, the ``k5k-ref`` cluster (5,000 nodes, reference
    packing, phantom and ``Gi`` rows) with 1,000 and a fold of 32,000
    decimal-MB specs, and path (d)'s 10,000 nodes with 1,000."""
    def decimal(s, seed):
        rng = np.random.default_rng(seed)
        return (rng.integers(50, 4000, s), rng.integers(64, 8192, s) * 10**6,
                rng.integers(1, 500, s))

    ref = pkg.snapshot_from_fixture(
        pkg.synthetic_fixture(5_000, seed=12, unhealthy_frac=0.05,
                              unparseable_mem_frac=0.02),
        semantics="reference")
    d = pkg.synthetic_snapshot(10_000, seed=4, kib_quantized=False)
    g = pkg.synthetic_snapshot(100_000, seed=2, shapes=48).grouped()
    cases = [("4099x257 adversarial",
              (*exact_edges.columns(4099, seed=10),
               *exact_edges.requests(257, seed=11)), None),
             ("4099x257 adversarial, hostile counts",
              (*exact_edges.columns(4099, seed=10),
               *exact_edges.requests(257, seed=11)),
              exact_edges.counts(4099, seed=13))]
    for label, snap, reqs in (("5000x1000 k5k-ref", ref, decimal(1_000, 13)),
                              ("5000x32000 k5k-ref fold", ref,
                               decimal(32_000, 14)),
                              ("10000x1000 (d)", d, decimal(1_000, 15))):
        cases.append((label, (*snapshot_columns(snap), snap.healthy, *reqs),
                      None))
    cases.append(("48 groups x 1000 (c)",
                  (*snapshot_columns(g), g.healthy, *decimal(1_000, 16)),
                  g.count))
    return cases


def phase_exact_kernel_vs_plain(pkg, fit, device) -> tuple[int, int]:
    """The exact kernel (``csrc/sweep_exact.cu``) against its plain
    version (``fit._sweep``) on the card, both modes, without a mask,
    with one, and grouped: totals and flags must be equal (tolerance 0:
    integers).  Returns the kernel calls made and the largest |kernel -
    plain| seen."""
    calls = max_err = 0
    before = fit.EXACT_LAUNCHES
    for label, arrays, counts in exact_kernel_cases(pkg):
        ops = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
               for a in arrays]
        n = int(ops[0].shape[0])
        masks = [None] if counts is not None else \
            [None, torch.from_numpy(exact_edges.mask(n, seed=17)).to(device)]
        cnt = None if counts is None else torch.from_numpy(
            np.asarray(counts, np.int64)).to(device)
        for mode, mask in itertools.product(("reference", "strict"), masks):
            if cnt is None:
                got = fit.sweep_grid(*ops, mode=mode, node_mask=mask)
            else:
                got = fit.sweep_grid_grouped(*ops[:7], cnt, *ops[7:],
                                             mode=mode)
            calls += 1
            torch.cuda.synchronize()
            want = fit._sweep(ops[:7], cnt, *ops[7:], mode=mode,
                              node_mask=mask, return_fits=False)
            err = int((got[0] - want[0]).abs().max()) if n else 0
            max_err = max(max_err, err)
            if err or not torch.equal(got[1], want[1]):
                raise AssertionError(
                    f"sweep_exact {mode} at {label}: kernel differs from "
                    f"plain (max |diff| {err})")
        log(f"exact kernel == plain at {label} (both modes"
            f"{', masked and unmasked' if counts is None else ', counts'})")
    if fit.EXACT_LAUNCHES - before != calls:
        raise AssertionError(f"EXACT_LAUNCHES rose by "
                             f"{fit.EXACT_LAUNCHES - before}, expected {calls}")
    return calls, max_err


def exact_bound(arrays, counts, mask, strict: bool, sms: int,
                clock_hz: float):
    """:meth:`Variant.bound` for the exact sweep: the least operations per
    live cell (two quotients and their min, the epilogue, the count
    multiply where there are counts, the accumulate) over the issue rate,
    against the bytes (six int64 node columns, ``healthy`` and a mask as
    bytes, the int64 counts, two int64 request rows read once and the
    int64 totals written once) over the memory rate."""
    n, s = len(arrays[0]), len(arrays[7])
    live = np.ones(n, dtype=bool)
    if mask is not None:
        live &= mask
    if strict:
        live &= arrays[6]
    if counts is not None:
        live &= np.asarray(counts) != 0
    per_cell = FIT_OPS + EPILOGUE_OPS[strict] + int(counts is not None) + 1
    cells = int(live.sum()) * s
    nbytes = (n * (6 * 8 + 1 + int(mask is not None)
                   + 8 * int(counts is not None)) + s * 8 * 2 + s * 8)
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = per_cell * cells / (sms * LANES_PER_SM * clock_hz)
    if ops_s >= bytes_s:
        return ops_s * 1e3, "operations", cells
    return bytes_s * 1e3, "bytes", cells


def phase_exact_times(pkg, fit, device, identity: str,
                      clock_hz: float) -> list[dict]:
    """The exact kernel at the main path's shapes (the ``k5k-ref`` cluster
    x 1,000 decimal-MB specs, the benchmark's decimal cell, and path (d)'s
    10,000 nodes x 1,000), reference mode unmasked as the service sends
    them: the bare launch's device time (``ms``) and the plain version's
    (``plain_ms``), each by :func:`device_ms`, the bound
    (:func:`exact_bound`) and its share, and the host time per call
    through the wrapper (``wrapper_host_ms``)."""
    from kubernetesclustercapacity_tpu_torch.ops import _build

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = []
    for label, arrays, _ in exact_kernel_cases(pkg):
        if label not in EXACT_TIMED:
            continue
        ops = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
               for a in arrays]
        n, s = int(ops[0].shape[0]), int(ops[7].shape[0])
        _, launch = _build.bind("sweep_exact", (*ops[:7], None, None,
                                                *ops[7:9]), n, s, False)
        ms, hold_calls = device_ms(launch, clock_hz)
        plain_ms, plain_hold_calls = device_ms(
            lambda: fit._sweep(ops[:7], None, *ops[7:], mode="reference",
                               node_mask=None, return_fits=False), clock_hz)
        wrapper_host_ms = host_call_ms(
            lambda: fit.sweep_grid(*ops, mode="reference"))
        bound_ms, bound_by, cells = exact_bound(arrays, None, None, False,
                                                sms, clock_hz)
        rows.append({
            "kernel": "sweep_exact[reference]", "shape": f"{n}x{s}",
            "cluster": label, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share": bound_ms / ms, "cells": cells,
            "wrapper_host_ms": wrapper_host_ms,
            "calls_per_hold": {"kernel": hold_calls,
                               "plain": plain_hold_calls},
            "library_ms": None, "gpu": identity,
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


def phase_spread_times(pkg, fit, device, identity: str,
                       clock_hz: float) -> dict:
    """The zone-spread kernel (``csrc/sweep_spread.cu``) at the benchmark's
    zonal shape: a strict 5,000-node cluster over three zones round-robin
    with 10% tainted NoSchedule (``k5k-zonal``'s shape, seed 26) x 1,000
    specs of the cell's ranges, ``max_skew`` 1.  Checks the kernel against
    its plain version (``fit._spread_plain``), then the bare launch's
    device time (``ms``) and the plain version's (``plain_ms``), each by
    :func:`device_ms`, the bound of ``kccap_bench/spread_bound.py`` and
    its share, the host time per call through ``fit.sweep_spread``, and
    the library's ``ptxas`` lines."""
    from kccap_bench.spread_bound import spread_bound_s
    from kubernetesclustercapacity_tpu_torch.ops import _build

    n, s, zones = 5_000, 1_000, 3
    fixture = pkg.synthetic_fixture(n, seed=26, taint_frac=0.1,
                                    unhealthy_frac=0.05, topology=(3, 1))
    snap = pkg.snapshot_from_fixture(fixture, semantics="strict")
    model = pkg.CapacityModel(snap, mode="strict", fixture=fixture,
                              device=device)
    _, member, _ = model._zone_membership("topology.kubernetes.io/zone",
                                          None)
    mask = np.asarray(pkg.implicit_taint_mask(snap), dtype=bool)
    rng = np.random.default_rng(27)
    scen = (rng.integers(50, 4000, s), rng.integers(64, 8192, s) * MIB,
            rng.integers(1, 500, s))
    cols = fit.snapshot_device_arrays(snap, device)
    cpu, mem, reps, zone = (torch.from_numpy(np.asarray(a, np.int64))
                            .to(device) for a in (*scen, member))
    node_mask = torch.from_numpy(mask).to(device)

    def kernel():
        return fit.sweep_spread(*cols, cpu, mem, reps, zone, zones, 1,
                                node_mask=node_mask)

    def plain():
        return fit._spread_plain(cols, cpu, mem, reps, zone, zones, 1,
                                 node_mask)

    before = fit.SPREAD_LAUNCHES
    got = kernel()
    if fit.SPREAD_LAUNCHES - before != 1 or \
            not torch.equal(got.cpu(), plain().cpu()):
        raise AssertionError("sweep_spread at 5000x1000x3: kernel differs "
                             "from plain, or did not launch once")
    _, launch = _build.bind("sweep_spread", (*cols, node_mask, zone, cpu,
                                             mem), n, s, True, (zones,),
                            (1,), rows=zones + 1)
    ms, hold_calls = device_ms(launch, clock_hz)
    plain_ms, plain_hold_calls = device_ms(plain, clock_hz)
    live = int((np.asarray(snap.healthy, bool) & mask & (member > 0)).sum())
    bound_ms = spread_bound_s(n, live, s) * 1e3
    ptxas = [line.strip() for line in
             _build.ptxas_report("sweep_spread").splitlines()
             if any(k in line for k in ("Compiling entry", "registers",
                                        "spill"))]
    row = {"kernel": "sweep_spread[strict, mask, 3 zones]",
           "shape": f"{n}x{s}", "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "share": bound_ms / ms, "live_nodes": live,
           "wrapper_host_ms": host_call_ms(kernel),
           "calls_per_hold": {"kernel": hold_calls,
                              "plain": plain_hold_calls},
           "ptxas": ptxas, "gpu": identity}
    print(json.dumps(row), flush=True)
    return row


def device_ms(fn, clock_hz: float,
              launches: int = TIMED_LAUNCHES) -> tuple[float, int]:
    """Median device time of one of ``launches`` calls, each bracketed by
    CUDA events, after warm-up.  A sleep kernel holds the stream while the
    host enqueues the calls, so the card runs them back to back and each
    event pair brackets the call's own kernels, not the host's launch
    cadence.  The hold is sized from an untimed pass (twice the host's
    time to enqueue the calls it covers, at least :data:`HOLD_S`), and a
    hold that ran out before its calls were queued (the host was slower,
    or the launch queue filled and blocked it) is thrown away and retried
    with half as many calls per hold.  Returns the median and the calls
    per hold that held."""
    for _ in range(WARMUP_LAUNCHES):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    enqueue_s = (time.perf_counter() - t0) / launches
    torch.cuda.synchronize()
    times: list[float] = []
    per_hold = launches
    while len(times) < launches:
        k = min(per_hold, launches - len(times))
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(k)]
        torch.cuda._sleep(int(max(HOLD_S, 2 * k * enqueue_s) * clock_hz))
        held = torch.cuda.Event()
        held.record()
        for start, end in pairs:
            start.record()
            fn()
            end.record()
        hold_ok = not held.query()
        torch.cuda.synchronize()
        if hold_ok:
            times += [s.elapsed_time(e) for s, e in pairs]
        elif per_hold > 1:
            per_hold //= 2
        else:
            raise AssertionError("one call outlasted a hold sized for it")
    return statistics.median(times), per_hold


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


def no_cell_ms(bind, ops, mask_at: int, clock_hz: float) -> float | None:
    """For a masked variant, the bare kernel's time on the same operands
    with every mask 0: launch, scenario loads, staging and the end of the
    block, and no cell.  None for a variant without a mask.  ``bind``
    takes the operands and returns the kernel's ``(totals, launch)``."""
    if ops[mask_at] is None:
        return None
    dead = list(ops)
    dead[mask_at] = torch.zeros_like(ops[mask_at])
    return device_ms(bind(dead)[1], clock_hz)[0]


def bind_b1(ops, strict: bool):
    """B1 through the kernel seam (:func:`_build.bind`) on ``sweep_fused``'s
    operands: the launch the timing sees, without the wrapper's Python
    checks (``sweep_fused`` is timed on its own as ``wrapper_host_ms``).
    The totals are not re-zeroed between launches; the work per launch is
    the same."""
    from kubernetesclustercapacity_tpu_torch.ops import _build

    ac, am, ap, uc, um, pc, cr, mr, crr, mrr, mask, counts = ops
    return _build.bind("sweep_fit",
                       (ac, am, ap, uc, um, pc, mask, counts, cr, mr, crr,
                        mrr), int(ac.shape[0]), int(cr.shape[0]), strict)


def bind_b2(ops, strict: bool):
    """B2 through the kernel seam on ``sweep_multi``'s operands, as
    :func:`bind_b1`."""
    from kubernetesclustercapacity_tpu_torch.ops import _build

    alloc, used, ap, pc, reqs, rcps, mask = ops
    r, n = (int(d) for d in alloc.shape)
    return _build.bind("sweep_multi", (alloc, used, ap, pc, mask, reqs, rcps),
                       n, int(reqs.shape[1]), strict, (r,))


def launch_floor_ms(clock_hz: float) -> float:
    """:func:`device_ms` of a one-element fill: the time the timing method
    gives a kernel that does next to nothing."""
    t = torch.empty(1, device="cuda")
    return device_ms(lambda: t.fill_(0), clock_hz)[0]


def phase_times(pkg, ff, device, identity: str, clock_hz: float,
                launches: dict) -> list[dict]:
    """Each variant the main path launches, plus the int32-divide
    reference variant, at the main path's shapes: the bare kernel's device
    time (``ms``) and the plain version's (``plain_ms``), each the median
    of 100 CUDA-event-timed calls queued behind a held stream
    (:func:`device_ms`), the masked variant's time with no live node
    (``no_cell_ms``, :func:`no_cell_ms`), and the host time per call
    through the wrapper (``wrapper_host_ms``)."""
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
        ms, hold_calls = device_ms(bind_b1(ops, v.strict)[1], clock_hz)
        dead_ms = no_cell_ms(lambda o: bind_b1(o, v.strict), ops, 10,
                             clock_hz)
        plain_ms, plain_hold_calls = device_ms(
            lambda: ff.sweep_fused_plain(*ops, strict=v.strict), clock_hz)
        wrapper_host_ms = host_call_ms(
            lambda: ff.sweep_fused(*ops, strict=v.strict))
        bound_ms, bound_by, cells = v.bound(ops, sms, clock_hz)
        rows.append({
            "kernel": v.name, "shape": f"{n}x{s}", "ms": ms,
            "no_cell_ms": dead_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "wrapper_host_ms": wrapper_host_ms,
            "calls_per_hold": {"kernel": hold_calls,
                               "plain": plain_hold_calls},
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
    out.update(phase_trace(
        lambda: ff.sweep_snapshot_auto(snap, grid, device="cuda"),
        "sweep_fit_kernel", out["end_to_end_ms"]))
    return out


def phase_trace(call, kernel_key: str, end_to_end_ms: float,
                runs: int = 20) -> dict:
    """Where a sweep's device time goes: torch.profiler over ``runs`` warm
    calls of ``call``, device time per sweep by kernel or copy (the kernel
    whose name holds ``kernel_key`` as ``kernel_trace_ms``), and the card's
    busy share, that device time over the unprofiled end-to-end median."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            call()
        torch.cuda.synchronize()
    per_name: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            per_name[ev.name] = (per_name.get(ev.name, 0.0)
                                 + ev.time_range.elapsed_us() / 1e3 / runs)
    if not per_name:
        raise AssertionError("the profiler recorded no device activity")
    device_ms = sum(per_name.values())
    kernel_ms = sum(ms for name, ms in per_name.items() if kernel_key in name)
    if not kernel_ms:
        raise AssertionError(f"the trace shows no {kernel_key}")
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"trace of {runs} sweeps: {device_ms:.4f} ms of device work per "
        f"sweep, busy share {device_ms / end_to_end_ms:.3f} of the "
        "end-to-end median; by name (ms per sweep): "
        + "; ".join(f"{name[:60]} {ms:.4f}" for name, ms in top))
    return {"device_ms_per_sweep": device_ms,
            "kernel_trace_ms": kernel_ms,
            "device_busy_share": device_ms / end_to_end_ms,
            "device_ms_by_name": dict(top)}


# --- Kernel B2, the R-resource sweep (BASELINE config 4) -----------------


class MultiVariant:
    """One of B2's 8 static variants (rcp x strict x mask; R is a
    runtime argument)."""

    def __init__(self, rcp: bool, strict: bool, mask: bool):
        self.rcp, self.strict, self.mask = rcp, strict, mask

    @property
    def name(self) -> str:
        parts = ["rcp" if self.rcp else "div",
                 "strict" if self.strict else "reference"]
        if self.mask:
            parts.append("mask")
        return "sweep_multi[" + ",".join(parts) + "]"

    def bound(self, ops: tuple, sms: int, clock_hz: float):
        """The least time the card could take on ``ops``, in ms, what
        bounds it, and the operations counted.  Per cell of a scenario
        with ``a`` active rows (request > 0): ``a`` quotients and ``a - 1``
        mins (none when ``a`` is 0: the fit is the constant INT32_MAX), the
        epilogue (reference 2, strict 1) and the accumulate; over the
        nodes whose mask is not 0, at the issue rate of
        :meth:`Variant.bound`.  Bytes: the 2R + 2 (+ mask) int32 node
        columns and the R request (and reciprocal) rows read once, the
        int64 totals written once, over the memory rate."""
        alloc, _, _, _, reqs, _, mask = ops
        r, n = (int(d) for d in alloc.shape)
        s = int(reqs.shape[1])
        live = n if mask is None else int((mask != 0).sum())
        active = (reqs > 0).sum(dim=0)
        per_cell = ((2 * active - 1).clamp_min(0)
                    + EPILOGUE_OPS[self.strict] + 1)
        ops_total = live * int(per_cell.sum())
        nbytes = ((2 * r + 2 + int(self.mask)) * 4 * n
                  + r * 4 * s * (2 if self.rcp else 1) + 8 * s)
        bytes_s = nbytes / HBM_BYTES_PER_S
        ops_s = ops_total / (sms * LANES_PER_SM * clock_hz)
        if ops_s >= bytes_s:
            return ops_s * 1e3, "operations", ops_total
        return bytes_s * 1e3, "bytes", ops_total


MULTI_VARIANTS = [MultiVariant(*bits)
                  for bits in itertools.product((False, True), repeat=3)]


def multi_rows(n: int, s: int, n_res: int, seed: int) -> dict:
    """Seeded R-resource inputs in their native units, rcp-eligible: cpu
    milli, memory bytes, ephemeral-storage bytes, GPUs, 2 MiB hugepages
    and an FPGA count, in that order, then device-plugin counts (0-15 per
    node, 0-3 per request) past six rows.  Some nodes are over-committed,
    pods_count can exceed alloc_pods, rows past memory request 0 (the
    row is inactive) at random, and scenario 0 requests nothing."""
    rng = np.random.default_rng(seed)
    cores = rng.choice(np.array([2, 4, 8, 16, 32, 64]), size=n)
    units = [
        (cores * 1000, lambda k: rng.integers(50, 4000, k)),
        ((cores * 4096 - rng.integers(0, 256, n)) * MIB,
         lambda k: rng.integers(64, 8192, k) * MIB),
        (rng.integers(50, 500, n) * GIB,
         lambda k: rng.integers(0, 20, k) * GIB),
        (rng.integers(0, 9, n), lambda k: rng.integers(0, 3, k)),
        (rng.integers(0, 64, n) * 2 * MIB,
         lambda k: rng.integers(0, 4, k) * 2 * MIB),
        (rng.integers(0, 4, n), lambda k: rng.integers(0, 2, k)),
    ] + [(rng.integers(0, 16, n), lambda k: rng.integers(0, 4, k))
         for _ in range(max(0, n_res - 6))]
    units = units[:n_res]
    alloc = np.stack([a for a, _ in units]).astype(np.int64)
    used = (alloc * rng.random(alloc.shape) * 1.1).astype(np.int64)
    used -= used % np.array(([1, 1024, 1024, 1, 1024] + [1] * n_res)
                            [:n_res])[:, None]
    reqs = np.stack([draw(s) for _, draw in units], axis=1).astype(np.int64)
    reqs[0, :] = 0
    return {"alloc": alloc, "used": used, "reqs": reqs,
            "ap": np.full(n, 110, dtype=np.int64),
            "pc": rng.integers(0, 130, n).astype(np.int64),
            "mask": rng.random(n) < 0.85}


def multi_edge_rows() -> list[dict]:
    """B2's reciprocal-division edge inputs on two unscaled rows: dividends
    on and one off multiples of the divisor at the largest eligible
    quotient (2^20), a divisor at 2^29 with the wrapping fixup product
    (dividend at int32 max), all-inactive scenarios and zero requests on
    one row (as zero GPU requests)."""
    q, d0, d1, n = 1 << 20, 997, 1031, 64
    boundary = np.stack([
        np.array([q * d0, q * d0 - 1, q * d0 + 1, (q - 1) * d0] * (n // 4)),
        np.array([q * d1, q * d1 - 1, q * d1 + 1, (q - 1) * d1] * (n // 4)),
    ]).astype(np.int64)
    wrap = np.stack([np.full(n, (1 << 31) - 1), np.full(n, 1 << 20)])
    cases = [
        (boundary, [[d0, d1], [d0 + 1, d1], [d0, 0], [0, d1], [0, 0]]),
        (wrap, [[1 << 29, 1], [(1 << 29) - 1, 1], [1 << 29, 0], [0, 0]]),
    ]
    return [{"alloc": alloc, "used": np.zeros_like(alloc),
             "reqs": np.array(reqs, dtype=np.int64),
             "ap": np.full(n, 1 << 30, dtype=np.int64),
             "pc": np.zeros(n, dtype=np.int64),
             "mask": np.ones(n, dtype=bool)} for alloc, reqs in cases]


def multi_wrap_rows(n_res: int) -> dict:
    """B2's wrapping edge beside the largest quotients, on ``n_res`` rows:
    row 0 holds dividend INT32_MAX for divisors 2^29 and 2^29 - 1, every
    other row dividends on and one off multiples of its divisor at quotient
    2^20 (and small ones); scenarios leave each row inactive in turn, and
    one leaves all of them."""
    q, n = 1 << 20, 64
    divisors = [997 + 34 * r for r in range(n_res)]
    rows = [np.full(n, (1 << 31) - 1)]
    for d in divisors[1:]:
        rows.append(np.array([q * d, q * d - 1, q * d + 1, (q - 1) * d,
                              d - 1, 0, d, 2 * d - 1] * (n // 8)))
    base = [1 << 29] + divisors[1:]
    reqs = [base, [(1 << 29) - 1] + divisors[1:], [0] * n_res]
    for r in range(n_res):
        reqs.append([0 if i == r else v for i, v in enumerate(base)])
    alloc = np.stack(rows).astype(np.int64)
    return {"alloc": alloc, "used": np.zeros_like(alloc),
            "reqs": np.array(reqs, dtype=np.int64),
            "ap": np.full(n, 1 << 30, dtype=np.int64),
            "pc": np.zeros(n, dtype=np.int64),
            "mask": np.ones(n, dtype=bool)}


def wide_multi_rows(n: int, s: int, n_res: int, seed: int) -> dict:
    """Unscaled R-resource inputs with more rows than one shared-memory
    pass of B2 holds.  Each scenario but the first (all inactive) requests
    1-4 random rows, so the rows that bind fall in different passes; some
    nodes are over-committed."""
    rng = np.random.default_rng(seed)
    alloc = rng.integers(0, 1 << 24, (n_res, n)).astype(np.int64)
    used = (alloc * rng.random((n_res, n)) * 1.1).astype(np.int64)
    reqs = np.zeros((s, n_res), dtype=np.int64)
    for i in range(1, s):
        rows = rng.choice(n_res, int(rng.integers(1, 5)), replace=False)
        reqs[i, rows] = rng.integers(1 << 10, 1 << 14, rows.size)
    return {"alloc": alloc, "used": used, "reqs": reqs,
            "ap": np.full(n, 1 << 14, dtype=np.int64),
            "pc": rng.integers(0, 130, n).astype(np.int64),
            "mask": rng.random(n) < 0.85}


def multi_operands(fm, data: dict, v: MultiVariant, device) -> tuple:
    scales = fm.multi_row_scales(data["alloc"], data["used"], data["reqs"])
    if scales is None or not fm.rcp_multi_eligible(
            data["alloc"], data["used"], data["reqs"], scales):
        raise AssertionError("multi test data is not rcp-eligible")
    return fm.stage_multi_operands(
        data["alloc"], data["used"], data["ap"], data["pc"], data["reqs"],
        scales, data["mask"] if v.mask else None, use_rcp=v.rcp,
        device=device)


def phase_multi_kernel_vs_plain(fm, device) -> tuple[int, int]:
    """All 8 variants of B2 at R = 1 to 9 (requests in registers up to 8,
    rows streamed at 9), at 10k x 1k and two ragged shapes, at R = 1534 and
    3100 (rows staged in passes), on the rcp edge inputs, and on the
    wrapping edge beside the largest quotients at every R up to 8: kernel
    totals must equal the plain version's exactly (tolerance 0: integer
    totals).  Returns the kernel calls made and the largest
    |kernel - plain| seen."""
    cases = []
    for n_res in range(1, 10):
        for n, s in ((10_000, 1_000), (1, 1), (2049, 257)):
            cases.append((multi_rows(n, s, n_res, seed=n + s + n_res),
                          f"R={n_res} {n}x{s}"))
    for n_res in (1534, 3100):  # past one pass of the shared tile
        cases.append((wide_multi_rows(333, 130, n_res, seed=n_res),
                      f"R={n_res} 333x130"))
    cases += [(d, f"rcp-edge-{i}") for i, d in enumerate(multi_edge_rows())]
    cases += [(multi_wrap_rows(r), f"wrap-edge R={r}") for r in range(1, 9)]
    calls = max_err = 0
    before = fm.LAUNCHES
    for data, label in cases:
        for v in MULTI_VARIANTS:
            ops = multi_operands(fm, data, v, device)
            got = fm.sweep_multi(*ops, strict=v.strict)
            calls += 1
            torch.cuda.synchronize()
            want = fm.sweep_multi_plain(*ops, strict=v.strict)
            err = int((got - want).abs().max())
            max_err = max(max_err, err)
            if err:
                raise AssertionError(
                    f"{v.name} at {label}: kernel differs from plain "
                    f"(max |diff| {err})")
    log(f"kernel == plain: sweep_multi, 8 variants at {len(cases)} input "
        f"sets (R = 1 to 9 at 10000x1000, 1x1, 2049x257; R in 1534, 3100 "
        f"at 333x130; rcp edges; the wrapping edge at R = 1 to 8)")
    if fm.LAUNCHES - before != calls:
        raise AssertionError(
            f"sweep_multi LAUNCHES rose by {fm.LAUNCHES - before}, "
            f"expected {calls}")
    return calls, max_err


def config4_fixture(pkg, n: int = 10_000):
    """``synthetic_fixture(n, seed=5, taint_frac=0.1)`` with GPUs (0-8)
    and ephemeral storage (50-500 Gi) on every node, and every fourth pod
    replaced by one that requests storage (1-10 Gi) and, on a GPU node,
    one GPU."""
    fixture = pkg.synthetic_fixture(n, seed=5, taint_frac=0.1)
    rng = np.random.default_rng(12)
    gpus = {}
    for node, g, e in zip(fixture["nodes"], rng.integers(0, 9, n),
                          rng.integers(50, 501, n)):
        node["allocatable"]["nvidia.com/gpu"] = str(int(g))
        node["allocatable"]["ephemeral-storage"] = f"{int(e)}Gi"
        gpus[node["name"]] = int(g)
    pods = fixture["pods"][::4]
    for pod, e in zip(pods, rng.integers(1, 11, len(pods))):
        gpu = "1" if gpus.get(pod.get("nodeName", ""), 0) else "0"
        pod["containers"] = [{"resources": {"requests": {
            "cpu": "250m", "memory": "256Mi", "nvidia.com/gpu": gpu,
            "ephemeral-storage": f"{int(e)}Gi"}}}]
    return fixture


def bench_config4(pkg, n: int = 10_000, s: int = 1_000) -> tuple:
    """BASELINE config 4 as ``bench.py`` builds it, on the port's
    ``synthetic_snapshot(n)``: cpu and memory rows, ephemeral storage of
    50-500 GiB with 0-50 GiB used, 0-8 GPUs with none used; scenarios of
    the random cpu/memory grid with 1-19 GiB of storage and 0-2 GPUs
    (zeros make the GPU row inactive).  Returns sweep_multi_auto's
    positional arguments."""
    snap = pkg.synthetic_snapshot(n, seed=0)
    rng = np.random.default_rng(4)
    alloc_rn = np.stack([snap.alloc_cpu_milli, snap.alloc_mem_bytes,
                         rng.integers(50, 500, n) * GIB,
                         rng.integers(0, 9, n)])
    used_rn = np.stack([snap.used_cpu_req_milli, snap.used_mem_req_bytes,
                        rng.integers(0, 50, n) * GIB,
                        np.zeros(n, dtype=np.int64)])
    grid = pkg.random_scenario_grid(s, seed=1)
    reqs = np.stack([grid.cpu_request_milli, grid.mem_request_bytes,
                     rng.integers(1, 20, s) * GIB, rng.integers(0, 3, s)],
                    axis=1)
    return (alloc_rn, used_rn, snap.alloc_pods, snap.pods_count,
            snap.healthy, reqs, grid.replicas)


def check_multi_against_exact(fm, name: str, args: tuple, kw: dict,
                              totals, schedulable) -> None:
    """Totals and flags equal the exact int64 program forced on the card
    (which must launch B2 0 times) and on the host."""
    fm.LAUNCHES = 0
    card = fm.sweep_multi_auto(*args, force_exact=True, device="cuda", **kw)
    if fm.LAUNCHES != 0:
        raise AssertionError(f"{name}: the forced exact program launched "
                             f"sweep_multi {fm.LAUNCHES} times")
    host = fm.sweep_multi_auto(*args, force_exact=True, device="cpu", **kw)
    for other, what in ((card, "exact on the card"),
                        (host, "exact on the host")):
        if other[2] != "torch_int64_multi":
            raise AssertionError(f"{name}: {what} took {other[2]}")
        if not (np.array_equal(other[0], totals)
                and np.array_equal(other[1], schedulable)):
            raise AssertionError(f"{name}: totals differ from {what}")


def phase_multi_paths(pkg, cli, ff, fm, tmp: str) -> dict:
    """Path (e): BASELINE config 4 through the port's CLI on a strict
    10k-node fixture with GPU and storage columns; path (f): the library
    call on bench.py's config-4 data.  Each checked against the exact
    program on the card and on the host, with B2's launches counted
    around the path's own run.  Returns the launches and each path's
    staged kernel operands (for the timing phase)."""
    from kubernetesclustercapacity_tpu_torch.scenario import (
        MultiResourceGrid,
    )

    out = {"launches": {}, "operands": {}}
    e_npz = os.path.join(tmp, "e.npz")
    t0 = time.perf_counter()
    snap = pkg.snapshot_from_fixture(
        config4_fixture(pkg), semantics="strict",
        extended_resources=("ephemeral-storage", "nvidia.com/gpu"))
    snap.save(e_npz)
    log(f"path (e) fixture packed strict with GPU and storage columns in "
        f"{time.perf_counter() - t0:.2f} s")
    argv = ["-snapshot", e_npz, "-grid", "1000", "-semantics", "strict",
            "-extended-request", "nvidia.com/gpu=1",
            "-extended-request", "ephemeral-storage=10Gi", "-output", "json"]
    ff.LAUNCHES = fm.LAUNCHES = 0
    t0 = time.perf_counter()
    doc = run_cli(cli, argv)
    dt = time.perf_counter() - t0
    out["launches"]["(e)"] = fm.LAUNCHES
    if doc["kernel"] != "cuda_multi_i32_rcp_fused" or fm.LAUNCHES != 1 \
            or ff.LAUNCHES != 0:
        raise AssertionError(
            f"(e): label {doc['kernel']}, sweep_multi launches "
            f"{fm.LAUNCHES}, sweep_fit launches {ff.LAUNCHES}")
    grid = pkg.random_scenario_grid(1000, seed=0)
    mgrid = MultiResourceGrid.from_grid(grid, {
        "nvidia.com/gpu": np.full(1000, 1, dtype=np.int64),
        "ephemeral-storage": np.full(1000, 10 * GIB, dtype=np.int64)})
    alloc_rn, used_rn = snap.resource_matrix(mgrid.resources)
    mask = pkg.implicit_taint_mask(snap)
    if mask is None:
        raise AssertionError("(e): the strict fixture carries no taints")
    args = (alloc_rn, used_rn, snap.alloc_pods, snap.pods_count,
            snap.healthy, mgrid.requests, mgrid.replicas)
    totals = np.asarray(doc["totals"])
    check_multi_against_exact(fm, "(e)", args, {"node_masks": mask},
                              totals, np.asarray(doc["schedulable"]))
    if totals.shape != (1000,) or doc["extended_requests"] != {
            "nvidia.com/gpu": 1, "ephemeral-storage": 10 * GIB}:
        raise AssertionError("(e): unexpected JSON")
    log(f"main path (e) config 4, 10k x 1k x 4 resources, strict, "
        f"taint-masked, through the CLI: label {doc['kernel']}, launches "
        f"{out['launches']['(e)']}, {dt:.3f} s, totals sum "
        f"{int(totals.sum())}, p50 {doc['totals_p50']}, equal to the exact "
        f"program on the card (0 launches) and on the host")
    scales, _ = fm.fast_multi_eligible(alloc_rn, used_rn, snap.alloc_pods,
                                        snap.pods_count, mgrid.requests)
    out["operands"]["(e)"] = fm.stage_multi_operands(
        alloc_rn, used_rn, snap.alloc_pods, snap.pods_count, mgrid.requests,
        scales, np.asarray(snap.healthy) & mask, use_rcp=True,
        device=torch.device("cuda", 0))

    f_args = bench_config4(pkg)
    fm.LAUNCHES = 0
    t0 = time.perf_counter()
    totals, sched, label = fm.sweep_multi_auto(*f_args, mode="strict",
                                               device="cuda")
    dt = time.perf_counter() - t0
    out["launches"]["(f)"] = fm.LAUNCHES
    if label != "cuda_multi_i32_rcp_fused" or fm.LAUNCHES != 1:
        raise AssertionError(f"(f): label {label}, launches {fm.LAUNCHES}")
    check_multi_against_exact(fm, "(f)", f_args, {"mode": "strict"},
                              totals, sched)
    log(f"main path (f) config 4, bench.py data, 10k x 1k x 4 resources, "
        f"strict, library call: label {label}, launches "
        f"{out['launches']['(f)']}, {dt:.3f} s cold, totals sum "
        f"{int(totals.sum())}, equal to the exact program on the card "
        f"(0 launches) and on the host")
    alloc_rn, used_rn, ap, pc, healthy, reqs, _ = f_args
    scales, _ = fm.fast_multi_eligible(alloc_rn, used_rn, ap, pc, reqs)
    out["operands"]["(f)"] = fm.stage_multi_operands(
        alloc_rn, used_rn, ap, pc, reqs, scales, healthy, use_rcp=True,
        device=torch.device("cuda", 0))
    out["f_args"] = f_args
    return out


def phase_multi_times(fm, paths: dict, identity: str,
                      clock_hz: float) -> list[dict]:
    """B2's variant on paths (e) and (f) (rcp, strict, mask at R = 4), and
    its int32-divide form on (f)'s operands, timed as
    :func:`phase_times` times B1."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    v = MultiVariant(True, True, True)
    f_ops = paths["operands"]["(f)"]
    div_ops = f_ops[:5] + (None,) + f_ops[6:]
    timed = [(v, paths["operands"]["(e)"], "(e)"), (v, f_ops, "(f)"),
             (MultiVariant(False, True, True), div_ops, None)]
    rows = []
    for var, ops, path in timed:
        r, n = (int(d) for d in ops[0].shape)
        s = int(ops[4].shape[1])
        ms, hold_calls = device_ms(bind_b2(ops, var.strict)[1], clock_hz)
        dead_ms = no_cell_ms(lambda o: bind_b2(o, var.strict), ops, 6,
                             clock_hz)
        plain_ms, plain_hold_calls = device_ms(
            lambda: fm.sweep_multi_plain(*ops, strict=var.strict), clock_hz)
        wrapper_host_ms = host_call_ms(
            lambda: fm.sweep_multi(*ops, strict=var.strict))
        bound_ms, bound_by, op_count = var.bound(ops, sms, clock_hz)
        rows.append({
            "kernel": var.name, "shape": f"{r}x{n}x{s}", "ms": ms,
            "no_cell_ms": dead_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "wrapper_host_ms": wrapper_host_ms,
            "calls_per_hold": {"kernel": hold_calls,
                               "plain": plain_hold_calls},
            "operations": op_count,
            "launches": paths["launches"].get(path, 0) if path else 0,
            "main_path": path, "library_ms": None, "gpu": identity,
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


def phase_multi_end_to_end(fm, f_args: tuple) -> dict:
    """Path (f)'s sweep_multi_auto, host-clocked to a synchronize (median
    of 20 after warm-up; every call stages its operands anew), beside its
    host eligibility proofs timed alone, the forced exact program, and a
    profiler trace of the device busy share."""
    alloc_rn, used_rn, ap, pc, _, reqs, _ = f_args

    def proofs():
        scales, _ = fm.fast_multi_eligible(alloc_rn, used_rn, ap, pc, reqs)
        fm.rcp_multi_eligible(alloc_rn, used_rn, reqs, scales)

    out = {
        "end_to_end_ms": host_median_ms(
            lambda: fm.sweep_multi_auto(*f_args, device="cuda")),
        "eligibility_ms": host_median_ms(proofs),
        "exact_end_to_end_ms": host_median_ms(
            lambda: fm.sweep_multi_auto(*f_args, force_exact=True,
                                        device="cuda")),
    }
    log(f"end to end sweep_multi_auto, config 4 10000x1000x4: median "
        f"{out['end_to_end_ms']:.4f} ms, of which the host eligibility "
        f"proofs alone take {out['eligibility_ms']:.4f} ms; forced through "
        f"the exact int64 program {out['exact_end_to_end_ms']:.4f} ms "
        "(host clock, 20 runs each)")
    out.update(phase_trace(
        lambda: fm.sweep_multi_auto(*f_args, device="cuda"),
        "sweep_multi_kernel", out["end_to_end_ms"]))
    return out


def run_cli_text(cli, argv: list[str]) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli {argv} exited {rc}: {buf.getvalue()[-500:]}")
    return buf.getvalue()


TRANSCRIPT_TOTAL = re.compile(
    r"Total possible replicas for the pod with required input specs : (-?\d+)")
SPEC_FLAGS = ["-cpuRequests=200m", "-cpuLimits=400m", "-memRequests=250mb",
              "-memLimits=500mb", "-replicas=5000"]
SINGLE_SPEC_NODES = 10_000


def phase_single_spec(pkg, cli, fit, ff, fm, tmp: str,
                      identity: str) -> dict:
    """Paths (g) and (h): one pod spec through the port's CLI on the card
    at 10,000 nodes, a JSON fixture of ``synthetic_fixture(10_000, seed=6,
    taint_frac=0.1)``.  (g): the default reference transcript from
    ``-backend torch`` on the card and from ``-backend cpu`` (the
    pure-Python oracle) must be byte-identical, in both semantics, and
    their total must equal the host's sum of ``fit_per_node`` (taint mask
    applied in strict).  (h): ``-explain`` as table and JSON, whose total
    must equal (g)'s.  Neither path launches B1 or B2.  Returns each run's
    host-clocked seconds (one call each) and the totals."""
    fixture = pkg.synthetic_fixture(SINGLE_SPEC_NODES, seed=6, taint_frac=0.1)
    path = os.path.join(tmp, "g.json")
    pkg.save_fixture(fixture, path)
    scenario = pkg.scenario_from_flags(
        cpuRequests="200m", cpuLimits="400m", memRequests="250mb",
        memLimits="500mb", replicas="5000")
    out = {"seconds": {}, "totals": {}, "launches": {}, "transcripts": {}}
    for semantics in ("reference", "strict"):
        argv = ["-snapshot", path, "-semantics", semantics, *SPEC_FLAGS]
        ff.LAUNCHES = fm.LAUNCHES = 0
        t0 = time.perf_counter()
        card = run_cli_text(cli, argv)
        out["seconds"][f"(g) {semantics} torch"] = time.perf_counter() - t0
        out["launches"][f"(g) {semantics}"] = ff.LAUNCHES + fm.LAUNCHES
        t0 = time.perf_counter()
        host = run_cli_text(cli, argv + ["-backend", "cpu"])
        out["seconds"][f"(g) {semantics} cpu"] = time.perf_counter() - t0
        if card != host:
            raise AssertionError(f"(g) {semantics}: the transcripts of "
                                 "-backend torch and -backend cpu differ")
        snap = pkg.snapshot_from_fixture(fixture, semantics=semantics)
        fits = fit.fit_snapshot(
            snap, scenario.cpu_request_milli, scenario.mem_request_bytes,
            mode=semantics, node_mask=pkg.implicit_taint_mask(snap),
            device="cpu")
        want = int(fits.sum())
        got = [int(t) for t in TRANSCRIPT_TOTAL.findall(card)]
        if got != [want] or card.count("\nMax replicas : ") != \
                SINGLE_SPEC_NODES:
            raise AssertionError(f"(g) {semantics}: transcript total {got}, "
                                 f"host sum of fit_per_node {want}")
        out["totals"][semantics] = want
        out["transcripts"][semantics] = card
        log(f"main path (g) single spec, {SINGLE_SPEC_NODES} nodes, "
            f"{semantics}: -backend torch on the card "
            f"{out['seconds'][f'(g) {semantics} torch']:.3f} s and "
            f"-backend cpu {out['seconds'][f'(g) {semantics} cpu']:.3f} s "
            f"through the CLI (one call each), transcripts byte-identical "
            f"({len(card)} bytes), total {want} = host sum of fit_per_node, "
            f"launches {out['launches'][f'(g) {semantics}']} ({identity})")

        argv = argv + ["-explain"]
        ff.LAUNCHES = fm.LAUNCHES = 0
        t0 = time.perf_counter()
        doc = json.loads(run_cli_text(cli, argv + ["-output", "json"]))
        out["seconds"][f"(h) {semantics} json"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        table = run_cli_text(cli, argv + ["-output", "table"])
        out["seconds"][f"(h) {semantics} table"] = time.perf_counter() - t0
        out["launches"][f"(h) {semantics}"] = ff.LAUNCHES + fm.LAUNCHES
        if doc["total_possible_replicas"] != want or \
                f"total possible replicas: {want} " not in table or \
                len(doc["nodes"]) != SINGLE_SPEC_NODES or \
                sum(n["fit"] for n in doc["nodes"]) != want:
            raise AssertionError(f"(h) {semantics}: -explain total differs "
                                 f"from (g)'s {want}")
        log(f"main path (h) -explain, {SINGLE_SPEC_NODES} nodes, "
            f"{semantics}: JSON {out['seconds'][f'(h) {semantics} json']:.3f}"
            f" s, table {out['seconds'][f'(h) {semantics} table']:.3f} s "
            f"through the CLI (one call each), total {want} = (g)'s, "
            f"binding {doc['binding_counts']}, marginal "
            f"{ {k: (v or {}).get('delta') for k, v in doc['marginal'].items()} }"
            f" ({identity})")
    return out


def quantile_index(n: int, q: float) -> int:
    """The sorted-ascending order statistic of confidence ``q`` among ``n``
    samples, ``n - ceil(q·n)`` clamped to ``[0, n - 1]`` (the JAX
    package's ``stochastic.car.quantile_index``)."""
    k = math.ceil(round(q * n, 9))
    return min(max(n - k, 0), n - 1)


def check_explain(pkg, ff, name: str, snap, grid, mode: str, mask,
                  kernel: str) -> None:
    """One fused sweep+explain on the card: totals equal the exact sweep on
    the card, every per-node output equals ``explain_snapshot``'s on the
    card, and the fits sum to the totals."""
    totals, sched, result, label = pkg.sweep_explain_snapshot(
        snap, grid, mode=mode, node_mask=mask)
    if label != kernel:
        raise AssertionError(f"{name}: label {label}, want {kernel}")
    exact, exact_sched, exact_label = ff.sweep_snapshot_auto(
        snap, grid, mode=mode, kernel="exact", node_mask=mask, device="cuda")
    if not exact_label.startswith("torch_int64") or \
            not np.array_equal(totals, exact) or \
            not np.array_equal(sched, exact_sched):
        raise AssertionError(f"{name}: totals differ from the exact sweep")
    solo = pkg.explain_snapshot(snap, grid, mode=mode, node_mask=mask)
    for field in ("fits", "binding", "cpu_fit", "mem_fit", "slots"):
        got, want = getattr(result, field), getattr(solo, field)
        if got.shape != (grid.size, snap.n_nodes) or \
                not np.array_equal(got, want):
            raise AssertionError(f"{name}: {field} differs from "
                                 "explain_snapshot")
    if not np.array_equal(result.fits.sum(axis=1), totals):
        raise AssertionError(f"{name}: the fits do not sum to the totals")


def phase_fused_programs(pkg, ff, identity: str) -> dict:
    """Paths (i) and (j): ``sweep_explain_snapshot`` at 10,000 nodes x
    1,000 scenarios (strict with the taint mask, and reference unmasked)
    and over 48 node-shape groups of 100,000 nodes x 100 scenarios, and
    ``sweep_quantiles_snapshot`` at 10,000 x 1,000 with the order
    statistics of q = 0.5, 0.9, 0.95, 0.99 against a host stable argsort
    of the exact totals.  Returns the host-clocked median of warm calls of
    each, and a profiler trace of the unmasked (i) and (j) calls."""
    grid = pkg.random_scenario_grid(1000, seed=7)
    strict = pkg.snapshot_from_fixture(
        pkg.synthetic_fixture(10_000, seed=6, taint_frac=0.1),
        semantics="strict")
    mask = pkg.implicit_taint_mask(strict)
    reference = pkg.synthetic_snapshot(10_000, seed=1)
    grouped = pkg.synthetic_snapshot(100_000, seed=2, shapes=48)
    small_grid = pkg.random_scenario_grid(100, seed=7)
    cases = [
        ("(i) 10k x 1k strict, taint-masked", strict, grid, "strict", mask,
         "torch_int64_sweep_explain"),
        ("(i) 10k x 1k reference", reference, grid, "reference", None,
         "torch_int64_sweep_explain"),
        ("(i) 100k grouped (48 shapes) x 100", grouped, small_grid,
         "reference", None, "torch_int64_sweep_explain_grouped"),
    ]
    out = {}
    for name, snap, g, mode, m, kernel in cases:
        check_explain(pkg, ff, name, snap, g, mode, m, kernel)
        out[name] = host_median_ms(
            lambda: pkg.sweep_explain_snapshot(snap, g, mode=mode,
                                               node_mask=m),
            runs=5, warmup=2)
        log(f"main path {name}: sweep_explain_snapshot equal to the exact "
            f"sweep and to explain_snapshot on the card, label {kernel}, "
            f"{out[name]:.3f} ms (host clock, median of 5 warm calls) "
            f"({identity})")
    name, snap, g, mode, m, _ = cases[1]
    out["(i) trace"] = phase_trace(
        lambda: pkg.sweep_explain_snapshot(snap, g, mode=mode, node_mask=m),
        "Memcpy DtoH", out[name], runs=5)

    qs = (0.5, 0.9, 0.95, 0.99)
    q_indices = tuple(quantile_index(grid.size, q) for q in qs)
    for name, snap, mode, m in (
            ("(j) 10k x 1k strict, taint-masked", strict, "strict", mask),
            ("(j) 10k x 1k reference", reference, "reference", None)):
        totals, sched, qvals, qidx, label = pkg.sweep_quantiles_snapshot(
            snap, grid, mode=mode, node_mask=m, q_indices=q_indices)
        exact, exact_sched, _ = ff.sweep_snapshot_auto(
            snap, grid, mode=mode, kernel="exact", node_mask=m,
            device="cuda")
        order = np.argsort(exact, kind="stable")
        if label != "torch_int64_sweep_qtile" or \
                not np.array_equal(totals, exact) or \
                not np.array_equal(sched, exact_sched) or \
                not np.array_equal(qidx, order[list(q_indices)]) or \
                not np.array_equal(qvals, exact[order][list(q_indices)]):
            raise AssertionError(f"{name}: order statistics differ from the "
                                 "host stable argsort of the exact totals")
        out[name] = host_median_ms(
            lambda: pkg.sweep_quantiles_snapshot(
                snap, grid, mode=mode, node_mask=m, q_indices=q_indices),
            runs=20, warmup=5)
        log(f"main path {name}: sweep_quantiles_snapshot at q = {qs} "
            f"(indices {q_indices}) gives {qvals.tolist()} at samples "
            f"{qidx.tolist()}, equal to a host stable argsort of the exact "
            f"totals, {out[name]:.3f} ms (host clock, median of 20 warm "
            f"calls) ({identity})")
    out["(j) trace"] = phase_trace(
        lambda: pkg.sweep_quantiles_snapshot(reference, grid,
                                             q_indices=q_indices),
        "Memcpy", out["(j) 10k x 1k reference"])
    return out


def phase_model(pkg, ff, fm, f_args: tuple, identity: str) -> dict:
    """Path (k): ``CapacityModel(snapshot, mode=...).sweep`` at 10,000 x
    1,000 (reference on path (a)'s snapshot; strict on path (b)'s fixture
    with its taint mask) must launch B1 once and ``.sweep_multi`` on path
    (f)'s inputs B2 once, each equal to the exact program on the card.
    Returns the launches of each call and the host-clocked median of warm
    calls."""
    from kubernetesclustercapacity_tpu_torch.scenario import (
        MultiResourceGrid,
    )

    grid = pkg.random_scenario_grid(1000, seed=0)
    out = {"launches": {"sweep_fit": {}, "sweep_multi": {}}, "ms": {}}
    cases = [
        ("(k) CapacityModel.sweep 10k x 1k reference",
         pkg.synthetic_snapshot(10_000, seed=1), "reference"),
        ("(k) CapacityModel.sweep 10k x 1k strict, taint-masked",
         pkg.snapshot_from_fixture(
             pkg.synthetic_fixture(10_000, seed=3, taint_frac=0.1),
             semantics="strict"), "strict"),
    ]
    for name, snap, mode in cases:
        model = pkg.CapacityModel(snap, mode=mode)
        ff.LAUNCHES = fm.LAUNCHES = 0
        totals, sched = model.sweep(grid)
        out["launches"]["sweep_fit"][name] = ff.LAUNCHES
        if (ff.LAUNCHES, fm.LAUNCHES) != (1, 0):
            raise AssertionError(f"{name}: sweep_fit launches {ff.LAUNCHES}, "
                                 f"sweep_multi launches {fm.LAUNCHES}")
        exact = ff.sweep_snapshot_auto(
            snap, grid, mode=mode, kernel="exact",
            node_mask=pkg.implicit_taint_mask(snap), device="cuda")
        if not (np.array_equal(totals, exact[0])
                and np.array_equal(sched, exact[1])):
            raise AssertionError(f"{name}: totals differ from the exact "
                                 "program")
        out["ms"][name] = host_median_ms(lambda: model.sweep(grid))
        log(f"main path {name}: launches sweep_fit 1, sweep_multi 0, equal "
            f"to the exact program on the card, {out['ms'][name]:.3f} ms "
            f"(host clock, median of 20 warm calls) ({identity})")

    alloc_rn, used_rn, ap, pc, healthy, reqs, replicas = f_args
    base = pkg.synthetic_snapshot(10_000, seed=0)
    resources = ("cpu", "memory", "ephemeral-storage", "nvidia.com/gpu")
    if not (np.array_equal(base.alloc_pods, ap)
            and np.array_equal(base.healthy, healthy)):
        raise AssertionError("(k): path (f)'s snapshot differs")
    snap = dataclasses.replace(
        base, semantics="strict",
        extended={r: (alloc_rn[i], used_rn[i])
                  for i, r in enumerate(resources) if i >= 2})
    mgrid = MultiResourceGrid(resources=resources, requests=reqs,
                              replicas=replicas)
    model = pkg.CapacityModel(snap, mode="strict")
    name = "(k) CapacityModel.sweep_multi config 4 10k x 1k x 4"
    ff.LAUNCHES = fm.LAUNCHES = 0
    totals, sched = model.sweep_multi(mgrid)
    out["launches"]["sweep_multi"][name] = fm.LAUNCHES
    if (ff.LAUNCHES, fm.LAUNCHES) != (0, 1):
        raise AssertionError(f"{name}: sweep_fit launches {ff.LAUNCHES}, "
                             f"sweep_multi launches {fm.LAUNCHES}")
    check_multi_against_exact(fm, name, f_args, {"mode": "strict"}, totals,
                              sched)
    out["ms"][name] = host_median_ms(lambda: model.sweep_multi(mgrid))
    log(f"main path {name}: launches sweep_fit 0, sweep_multi 1, equal to "
        f"the exact program on the card and the host, "
        f"{out['ms'][name]:.3f} ms (host clock, median of 20 warm calls) "
        f"({identity})")
    return out


def timed_requests(call, runs: int = 20, warmup: int = 3) -> dict:
    """Median and p90 of ``runs`` warm requests on the host clock (the
    client blocks until the reply is decoded)."""
    times = []
    for i in range(warmup + runs):
        t0 = time.perf_counter()
        reply = call()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return {"median_ms": statistics.median(times),
            "p90_ms": times[int(math.ceil(0.9 * len(times))) - 1],
            "reply": reply}


def check_equal(name: str, got, want) -> None:
    if not np.array_equal(np.asarray(got), np.asarray(want)):
        raise AssertionError(f"{name}: totals differ")


def phase_service(pkg, cli, fit, ff, fm, f_args: tuple, tmp: str,
                  identity: str) -> dict:
    """Path (l): the port's ``CapacityServer`` in this process on
    127.0.0.1:0 with ``device="cuda"``, driven through the port's
    ``CapacityClient`` at the earlier paths' widths.

    On (a)'s ``synthetic_snapshot(10_000, seed=1)`` (reference): ``ping``,
    ``info``, a ``sweep`` of ``random_scenario_grid(1000, seed=7)`` that
    must launch B1 exactly once and equal the exact program on the card
    and the host's sum of ``fit_per_node``, a ``fit`` whose reference
    transcript must be byte-identical to the CLI's ``-backend torch`` one,
    and an ``explain`` whose total must equal it.  A second server on the
    same snapshot with a batch window takes 8 concurrent sweeps of 125
    scenarios from 8 threads: each must equal its solo answer, and B1
    must launch fewer than 8 times.  ``reload`` to (b)'s strict,
    taint-masked snapshot, then ``sweep`` again, must equal
    ``sweep_snapshot_auto`` with the implicit taint mask.  A third server
    on (f)'s config-4 snapshot answers ``sweep_multi`` of 1,000 scenarios
    with exactly one launch of B2, equal to the exact program.  Each op
    is then timed over 20 warm requests; the eligibility proofs and the
    reply's JSON encoding are timed alone beside it."""
    from kubernetesclustercapacity_tpu_torch.service import (
        CapacityClient,
        CapacityServer,
    )

    out = {"launches": {"sweep_fit": {}, "sweep_multi": {}}, "ops": {},
           "shares": {}}
    a_path = os.path.join(tmp, "l_a.npz")
    snap = pkg.synthetic_snapshot(10_000, seed=1)
    snap.save(a_path)
    b_path = os.path.join(tmp, "l_b.npz")
    strict = pkg.snapshot_from_fixture(
        pkg.synthetic_fixture(10_000, seed=3, taint_frac=0.1),
        semantics="strict")
    strict.save(b_path)
    grid = pkg.random_scenario_grid(1000, seed=7)
    spec = dict(cpuRequests="200m", cpuLimits="400m", memRequests="250mb",
                memLimits="500mb", replicas="5000")
    servers = []

    def serve(snapshot, **kw):
        server = CapacityServer(snapshot, device="cuda", **kw)
        server.start()
        servers.append(server)
        return server

    def client(server):
        return CapacityClient(*server.address, connect_timeout_s=60,
                              timeout_s=300, retry=None)

    try:
        server = serve(pkg.load_snapshot(a_path), batch_window_ms=0)
        with client(server) as c:
            if c.ping() != "pong":
                raise AssertionError("(l): ping")
            info = c.info()
            if (info["nodes"], info["semantics"]) != (10_000, "reference") \
                    or info["resilience"]["fast_path_breaker"]["state"] \
                    != "closed":
                raise AssertionError(f"(l): info {info}")
            ff.LAUNCHES = fm.LAUNCHES = 0
            doc = c.sweep(random={"n": 1000, "seed": 7})
            launches = (ff.LAUNCHES, fm.LAUNCHES)
            out["launches"]["sweep_fit"]["(l) sweep"] = launches[0]
            if launches != (1, 0) or doc["kernel"] != "cuda_i32_rcp_fused":
                raise AssertionError(f"(l) sweep: label {doc['kernel']}, "
                                     f"launches {launches}")
            exact = ff.sweep_snapshot_auto(snap, grid, kernel="exact",
                                           device="cuda")
            host = fit.sweep_snapshot(snap, grid, device="cpu")
            check_equal("(l) sweep vs exact on the card", doc["totals"],
                        exact[0])
            check_equal("(l) sweep vs host fit_per_node", doc["totals"],
                        host[0])
            check_equal("(l) sweep schedulable", doc["schedulable"], host[1])
            transcript = run_cli_text(cli, ["-snapshot", a_path, *SPEC_FLAGS])
            fit_doc = c.fit(**spec)
            if fit_doc["report"] != transcript:
                raise AssertionError("(l) fit: the transcript differs from "
                                     "the CLI's -backend torch transcript")
            explain = c.explain(**spec)
            if explain["total"] != fit_doc["total"] or \
                    sum(explain["binding_counts"].values()) != 10_000:
                raise AssertionError("(l) explain: total differs from fit")
            log(f"main path (l) service on (a) 10k nodes, reference: ping, "
                f"info; sweep 1000 (seed 7) label {doc['kernel']}, B1 "
                f"launches 1, totals sum {sum(doc['totals'])} equal to the "
                f"exact program on the card and the host's fit_per_node; "
                f"fit transcript byte-identical to the CLI's "
                f"({len(transcript)} bytes, total {fit_doc['total']}); "
                f"explain total {explain['total']}, binding "
                f"{explain['binding_counts']} ({identity})")

            folded = serve(snap, batch_window_ms=2000.0, batch_max=8,
                           max_inflight=8)
            grids = [{"n": 125, "seed": 100 + i} for i in range(8)]
            solo = [c.sweep(random=g)["totals"] for g in grids]
            replies = [None] * 8
            errors = []

            def member(i):
                try:
                    with client(folded) as mc:
                        replies[i] = mc.sweep(random=grids[i])
                except Exception as e:  # noqa: BLE001 - raised below
                    errors.append(e)

            threads = [threading.Thread(target=member, args=(i,))
                       for i in range(8)]
            ff.LAUNCHES = 0
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            fold_launches = ff.LAUNCHES
            out["launches"]["sweep_fit"]["(l) folded 8 x 125"] = fold_launches
            if errors or any(t.is_alive() for t in threads):
                raise AssertionError(f"(l) folded: {errors}")
            for i, reply in enumerate(replies):
                check_equal(f"(l) folded member {i} vs solo",
                            reply["totals"], solo[i])
            if not 1 <= fold_launches < 8:
                raise AssertionError(f"(l) folded: B1 launched "
                                     f"{fold_launches} times for 8 requests")
            stats = folded.batching_stats
            log(f"main path (l) folded: 8 concurrent sweeps of 125 from 8 "
                f"threads, B1 launches {fold_launches} (< 8), "
                f"{stats['dispatches']} dispatch(es), mean batch "
                f"{stats['mean_batch_size']:.2f}, every member equal to its "
                f"solo answer ({identity})")

            before = pkg.devcache.CACHE.stats()["stage_replace"]
            reload = c.reload(b_path, semantics="strict")
            restaged = {k: v - before[k] for k, v in
                        pkg.devcache.CACHE.stats()["stage_replace"].items()}
            ff.LAUNCHES = 0
            after = c.sweep(random={"n": 1000, "seed": 7})
            after_launches = ff.LAUNCHES
            out["launches"]["sweep_fit"]["(l) sweep after reload"] = \
                after_launches
            mask = pkg.implicit_taint_mask(strict)
            want = ff.sweep_snapshot_auto(strict, grid, mode="strict",
                                          node_mask=mask, device="cuda")
            check_equal("(l) sweep after reload", after["totals"], want[0])
            if reload != {"nodes": 10_000, "semantics": "strict"} or \
                    after_launches != 1 or mask is None or \
                    restaged["copied"] < 1:
                raise AssertionError(f"(l) reload: {reload}, B1 launches "
                                     f"{after_launches}, columns {restaged}")
            log(f"main path (l) reload to (b)'s strict taint-masked "
                f"snapshot: then sweep 1000 label {after['kernel']}, B1 "
                f"launches 1, totals sum {sum(after['totals'])} equal to "
                f"sweep_snapshot_auto with the implicit taint mask; the "
                f"reload re-staged its columns {restaged} (copied: in place "
                f"into the retired snapshot's tensors) ({identity})")

        alloc_rn, used_rn, ap, pc, healthy, reqs, replicas = f_args
        resources = ("cpu", "memory", "ephemeral-storage", "nvidia.com/gpu")
        base = pkg.synthetic_snapshot(10_000, seed=0)
        config4 = dataclasses.replace(
            base, semantics="strict",
            extended={r: (alloc_rn[i], used_rn[i])
                      for i, r in enumerate(resources) if i >= 2})
        multi = serve(config4, batch_window_ms=0)
        with client(multi) as c:
            ff.LAUNCHES = fm.LAUNCHES = 0
            mdoc = c.sweep_multi(list(resources), reqs.tolist(),
                                 replicas=replicas.tolist())
            launches = (ff.LAUNCHES, fm.LAUNCHES)
            out["launches"]["sweep_multi"]["(l) sweep_multi"] = launches[1]
            if launches != (0, 1) or \
                    mdoc["kernel"] != "cuda_multi_i32_rcp_fused":
                raise AssertionError(f"(l) sweep_multi: label "
                                     f"{mdoc['kernel']}, launches {launches}")
            check_multi_against_exact(fm, "(l) sweep_multi", f_args,
                                      {"mode": "strict"},
                                      np.asarray(mdoc["totals"]),
                                      np.asarray(mdoc["schedulable"]))
            log(f"main path (l) sweep_multi on (f)'s config 4, 10k x 1k x 4: "
                f"label {mdoc['kernel']}, B2 launches 1, equal to the exact "
                f"program on the card and the host ({identity})")
            out["ops"]["sweep_multi 1000 x 4"] = timed_requests(
                lambda: c.sweep_multi(list(resources), reqs.tolist(),
                                      replicas=replicas.tolist()))
        scales, _ = fm.fast_multi_eligible(alloc_rn, used_rn, ap, pc, reqs)
        multi_proofs = host_median_ms(lambda: (
            fm.fast_multi_eligible(alloc_rn, used_rn, ap, pc, reqs),
            fm.rcp_multi_eligible(alloc_rn, used_rn, reqs, scales)))

        timed = serve(pkg.load_snapshot(a_path), batch_window_ms=0)
        with client(timed) as c:
            ops = {
                "ping": lambda: c.ping(),
                "info": lambda: c.info(),
                "sweep 1000": lambda: c.sweep(random={"n": 1000, "seed": 7}),
                "sweep 125": lambda: c.sweep(random={"n": 125, "seed": 100}),
                "fit reference transcript": lambda: c.fit(**spec),
                "fit json": lambda: c.fit(output="json", **spec),
                "explain": lambda: c.explain(**spec),
            }
            for name, call in ops.items():
                out["ops"][name] = timed_requests(call)
        nodes = (snap.alloc_cpu_milli, snap.alloc_mem_bytes, snap.alloc_pods,
                 snap.used_cpu_req_milli, snap.used_mem_req_bytes,
                 snap.pods_count)
        req = (grid.cpu_request_milli, grid.mem_request_bytes)
        proofs = host_median_ms(lambda: (
            ff.fast_sweep_eligible(*nodes, *req),
            ff.rcp_division_eligible(nodes[0], nodes[1], nodes[3], nodes[4],
                                     *req)))
        for name, proof_ms in (("sweep 1000", proofs),
                               ("sweep_multi 1000 x 4", multi_proofs),
                               ("fit reference transcript", None),
                               ("explain", None)):
            op = out["ops"][name]
            body = {"ok": True, "result": op["reply"], "generation": 1}
            encode_ms = host_median_ms(lambda: json.dumps(body).encode())
            out["shares"][name] = {
                "median_ms": op["median_ms"],
                "eligibility_ms": proof_ms,
                "eligibility_share": (None if proof_ms is None
                                      else proof_ms / op["median_ms"]),
                "json_encode_ms": encode_ms,
                "json_encode_share": encode_ms / op["median_ms"],
                "reply_bytes": len(json.dumps(body)),
            }
    finally:
        for server in servers:
            server.shutdown()
    for name, op in out["ops"].items():
        op.pop("reply")
        log(f"service op {name}: median {op['median_ms']:.4f} ms, p90 "
            f"{op['p90_ms']:.4f} ms (host clock, 20 warm requests through "
            f"CapacityClient on 127.0.0.1) ({identity})")
    for name, share in out["shares"].items():
        log(f"service op {name}: eligibility proofs "
            f"{share['eligibility_ms'] if share['eligibility_ms'] is None else round(share['eligibility_ms'], 4)}"
            f" ms (share {share['eligibility_share']}), reply JSON encoding "
            f"{share['json_encode_ms']:.4f} ms (share "
            f"{share['json_encode_share']:.4f}, {share['reply_bytes']} bytes)"
            f" ({identity})")
    return out


# --- Path (m): the live cluster ------------------------------------------
# The upper end of a supported Kubernetes cluster: 5,000 nodes and 150,000
# pods ("Considerations for large clusters",
# kubernetes.io/docs/setup/best-practices/cluster-large/).
LIVE_NODES = 5_000
LIVE_PODS_PER_NODE = 30
LIVE_TOKEN = "smoke-token"
NODES_PATH, PODS_PATH = "/api/v1/nodes", "/api/v1/pods"
EXTENDED = ("nvidia.com/gpu", "ephemeral-storage")


def k8s_node(n: dict) -> dict:
    """A fixture-schema node as the REST Node object an apiserver serves."""
    return {"metadata": {"name": n["name"], "labels": n.get("labels") or {}},
            "spec": {"taints": list(n.get("taints") or [])},
            "status": {"allocatable": n["allocatable"],
                       "conditions": n["conditions"]}}


def k8s_pod(p: dict) -> dict:
    """A fixture-schema pod as the REST Pod object an apiserver serves."""
    return {"metadata": {"name": p["name"], "namespace": p["namespace"],
                         "labels": p.get("labels") or {}},
            "spec": {"nodeName": p.get("nodeName") or None,
                     "containers": list(p.get("containers") or []),
                     "initContainers": list(p.get("initContainers") or [])},
            "status": {"phase": p["phase"]}}


class MockApiserver:
    """A stdlib stand-in for kube-apiserver on 127.0.0.1:0.

    Serves paged Lists of nodes and pods (``limit``/``continue``, a fresh
    ``resourceVersion`` on every List; the PodDisruptionBudget API answers
    404, as on a cluster where it is not readable), newline-delimited
    watch streams (each watch request takes the next queued stream of its
    path, later ones get an empty window), and refuses a request without
    the bearer token.  Items and streams are serialized once up front.
    ``stream_written[path]`` is the host clock when a stream's last byte
    was written.  ``gates`` maps a path to ``{window index: Event}``: the
    watch request that takes that window waits for the event first.
    """

    def __init__(self, fixture: dict, streams: dict | None = None,
                 gates: dict | None = None):
        import http.server

        self.items = {
            NODES_PATH: [json.dumps(k8s_node(n)).encode()
                         for n in fixture["nodes"]],
            PODS_PATH: [json.dumps(k8s_pod(p)).encode()
                        for p in fixture["pods"]],
        }
        self.streams = {
            path: [b"".join(json.dumps(e).encode() + b"\n" for e in events)
                   for events in queued]
            for path, queued in (streams or {}).items()
        }
        self.stream_written: dict[str, float] = {}
        self.gates = gates or {}
        self._windows: dict[str, int] = {}
        self.requests = 0
        self._rv = 1
        self._lock = threading.Lock()
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def log_message(self, *args):
                pass

            def reply(self, code: int, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                from urllib.parse import parse_qs, urlsplit

                with outer._lock:
                    outer.requests += 1
                if self.headers.get("Authorization") != \
                        f"Bearer {LIVE_TOKEN}":
                    return self.reply(401, b"Unauthorized")
                url = urlsplit(self.path)
                items = outer.items.get(url.path)
                if items is None:
                    return self.reply(404, b"not found")
                query = parse_qs(url.query)
                if query.get("watch"):
                    with outer._lock:
                        queued = outer.streams.get(url.path) or []
                        body = queued.pop(0) if queued else b""
                        window = outer._windows.get(url.path, 0)
                        outer._windows[url.path] = window + 1
                    gate = outer.gates.get(url.path, {}).get(window)
                    if gate is not None:
                        gate.wait()
                    self.reply(200, body)
                    if body:
                        outer.stream_written[url.path] = time.perf_counter()
                    return
                limit = int(query.get("limit", ["500"])[0])
                start = int(query.get("continue", ["0"])[0] or 0)
                end = start + limit
                with outer._lock:
                    outer._rv += 1
                    meta = {"resourceVersion": str(outer._rv)}
                if end < len(items):
                    meta["continue"] = str(end)
                self.reply(200, b'{"items":[' + b",".join(items[start:end])
                           + b'],"metadata":' + json.dumps(meta).encode()
                           + b"}")

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.server.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self) -> None:
        for gates in self.gates.values():
            for gate in gates.values():
                gate.set()
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)


def live_fixture_source(pkg) -> dict:
    """The source cluster of path (m): ``synthetic_fixture(5_000, seed=8,
    pods_per_node=30, taint_frac=0.1)``, every node also advertising 0-8
    GPUs and 50-500 Gi of ephemeral storage (for the strict server's
    R-resource sweep)."""
    fixture = pkg.synthetic_fixture(LIVE_NODES, seed=8,
                                    pods_per_node=LIVE_PODS_PER_NODE,
                                    taint_frac=0.1)
    rng = np.random.default_rng(10)
    for node, g, e in zip(fixture["nodes"], rng.integers(0, 9, LIVE_NODES),
                          rng.integers(50, 501, LIVE_NODES)):
        node["allocatable"] = dict(node["allocatable"])
        node["allocatable"]["nvidia.com/gpu"] = str(int(g))
        node["allocatable"]["ephemeral-storage"] = f"{int(e)}Gi"
    return fixture


# The churn stream's depth.  It was 3,100 events (1,000 pods of each kind,
# 80 nodes modified, 10 swapped) until path (n) was added; it is cut to
# 600 so that the whole script stays within a minute of its length
# before (n).
CHURN_PODS, CHURN_NODES_MODIFIED, CHURN_NODES_SWAPPED = 192, 14, 5


def churn_events(fixture: dict, seed: int = 9) -> list[dict]:
    """One seeded stream of 600 watch events in the store's schema,
    shuffled: 192 pods ADDED Running on random nodes, 192 existing pods
    DELETED, 192 existing Running pods MODIFIED to Succeeded, 14 nodes
    MODIFIED (a pressure condition flipped, or allocatable changed), 5
    nodes ADDED and 5 DELETED.  The object sets are disjoint, so the final
    state does not depend on how the stream interleaves kinds."""
    rng = np.random.default_rng(seed)
    nodes, pods = fixture["nodes"], fixture["pods"]
    names = [n["name"] for n in nodes]
    running = [i for i, p in enumerate(pods)
               if p["phase"] == "Running" and p.get("nodeName")]
    picked = rng.choice(len(running), 2 * CHURN_PODS, replace=False)
    deleted = [pods[running[i]] for i in picked[:CHURN_PODS]]
    finished = [pods[running[i]] for i in picked[CHURN_PODS:]]
    node_ix = rng.choice(len(nodes), CHURN_NODES_MODIFIED
                         + CHURN_NODES_SWAPPED, replace=False)
    events = []
    for i in range(CHURN_PODS):
        requests = {"cpu": f"{int(rng.integers(50, 2000))}m",
                    "memory": f"{int(rng.integers(64, 4096))}Mi"}
        if rng.random() < 0.25:
            requests["nvidia.com/gpu"] = "1"
            requests["ephemeral-storage"] = f"{int(rng.integers(1, 11))}Gi"
        events.append({"type": "ADDED", "kind": "Pod", "object": {
            "name": f"churn-{i}", "namespace": "churn",
            "nodeName": names[int(rng.integers(len(names)))],
            "phase": "Running", "labels": {"app": "churn"},
            "containers": [{"resources": {"requests": requests,
                                          "limits": requests}}]}})
    events += [{"type": "DELETED", "kind": "Pod", "object": p}
               for p in deleted]
    events += [{"type": "MODIFIED", "kind": "Pod",
                "object": dict(p, phase="Succeeded")} for p in finished]
    for k, i in enumerate(node_ix[:CHURN_NODES_MODIFIED]):
        node = json.loads(json.dumps(nodes[int(i)]))
        if k % 2:
            cond = node["conditions"][1]
            cond["status"] = "False" if cond["status"] == "True" else "True"
        else:
            node["allocatable"]["cpu"] = str(int(rng.integers(4, 97)))
        events.append({"type": "MODIFIED", "kind": "Node", "object": node})
    for i in range(CHURN_NODES_SWAPPED):
        node = json.loads(json.dumps(
            nodes[int(node_ix[CHURN_NODES_MODIFIED + i])]))
        events.append({"type": "DELETED", "kind": "Node", "object": node})
        joiner = json.loads(json.dumps(nodes[int(rng.integers(len(nodes)))]))
        joiner["name"] = f"joiner-{i}"
        joiner["labels"] = dict(joiner.get("labels") or {},
                                **{"kubernetes.io/hostname": joiner["name"]})
        events.append({"type": "ADDED", "kind": "Node", "object": joiner})
    order = rng.permutation(len(events))
    return [events[int(i)] for i in order]


def watch_streams(events: list[dict]) -> dict:
    """The event stream as one watch stream per resource, in the REST
    schema, each event with its resourceVersion."""
    streams = {NODES_PATH: [], PODS_PATH: []}
    for rv, e in enumerate(events, start=10_000):
        obj = k8s_node(e["object"]) if e["kind"] == "Node" else \
            k8s_pod(e["object"])
        obj["metadata"]["resourceVersion"] = str(rv)
        path = NODES_PATH if e["kind"] == "Node" else PODS_PATH
        streams[path].append({"type": e["type"], "object": obj})
    return {path: [evs] for path, evs in streams.items()}


def write_kubeconfig(path: str, server: str) -> None:
    import yaml

    doc = {"apiVersion": "v1", "kind": "Config", "current-context": "smoke",
           "contexts": [{"name": "smoke",
                         "context": {"cluster": "mock", "user": "smoke"}}],
           "clusters": [{"name": "mock", "cluster": {"server": server}}],
           "users": [{"name": "smoke", "user": {"token": LIVE_TOKEN}}]}
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)


class PublishClock:
    """Times each publish's parts on the publisher's thread: the
    follower's ``snapshot()`` (the store's repack), and the device
    cache's ``stage_replace`` (with its column counts) and ``warm``.
    Installed as instance attributes over the bound methods, removed by
    :meth:`close`."""

    def __init__(self, cache, follower):
        self.records: list[dict] = []
        self._cache, self._follower = cache, follower
        self._current: dict = {}
        snapshot, stage, warm = (follower.snapshot, cache.stage_replace,
                                 cache.warm)

        def timed_snapshot():
            t0 = time.perf_counter()
            out = snapshot()
            self._current = {"snapshot_ms": (time.perf_counter() - t0) * 1e3}
            return out

        def timed_stage(old, new, device):
            t0 = time.perf_counter()
            counts = stage(old, new, device)
            self._current.update(stage_replace_ms=(time.perf_counter() - t0)
                                 * 1e3, columns=counts)
            return counts

        def timed_warm(snap, device):
            t0 = time.perf_counter()
            warm(snap, device)
            self._current["warm_ms"] = (time.perf_counter() - t0) * 1e3
            self.records.append(self._current)

        follower.snapshot = timed_snapshot
        cache.stage_replace = timed_stage
        cache.warm = timed_warm

    def close(self) -> None:
        for obj, name in ((self._follower, "snapshot"),
                          (self._cache, "stage_replace"),
                          (self._cache, "warm")):
            obj.__dict__.pop(name, None)

    def summary(self) -> dict:
        out = {"publishes": len(self.records)}
        for key in ("snapshot_ms", "stage_replace_ms", "warm_ms"):
            values = [r[key] for r in self.records if key in r]
            out[key] = {"median": statistics.median(values),
                        "max": max(values)} if values else None
        out["columns"] = {k: sum(r.get("columns", {}).get(k, 0)
                                 for r in self.records)
                          for k in ("reused", "copied", "restaged")}
        return out


def check_totals(name: str, fit, ff, snap, grid, got, *, mode, mask):
    """``got`` (totals) equals the exact int64 program on the card and on
    the host for ``snap``; the exact program launches B1 0 times."""
    before = ff.LAUNCHES
    card = ff.sweep_snapshot_auto(snap, grid, mode=mode, kernel="exact",
                                  node_mask=mask, device="cuda")
    host = fit.sweep_snapshot(snap, grid, mode=mode, node_mask=mask,
                              device="cpu")
    if ff.LAUNCHES != before or card[2] not in ("torch_int64",
                                                "torch_int64_grouped"):
        raise AssertionError(f"{name}: the exact program took {card[2]}")
    check_equal(f"{name} vs the exact program on the card", got, card[0])
    check_equal(f"{name} vs the host", got, host[0])


def phase_live(pkg, cli, fit, ff, fm, tmp: str, identity: str) -> dict:
    """Path (m): the live cluster at the size of a large real one.

    (m1) the CLI without ``-snapshot`` reads the mock apiserver (through
    ``-kubeconfig`` when PyYAML is installed, else through
    ``cli.load_source`` with a ``KubeClient``): ``-grid 1000`` (B1 once)
    and (g)'s single spec with ``-output reference``, each equal to the
    CLI with ``-snapshot`` on the same cluster written as ``.json``.
    (m2) a ``CapacityServer`` on that ``.json`` takes the churn stream
    through ``CapacityClient`` as 6 ``update`` batches of 100; after each,
    a ``sweep`` of ``random_scenario_grid(1000, seed=7)`` launches B1 once
    and equals the exact program (card and host) on a full repack of the
    same events applied to a ``ClusterStore``.  (m3) a server fed by a
    ``ClusterFollower`` on the mock (``follow_publisher``, 100 ms) takes
    the same stream on its watch; sweeps answer the final state; a second,
    strict server with GPU and storage columns answers ``sweep_multi``
    1,000 x 4 with B2 once."""
    import importlib.util

    from kubernetesclustercapacity_tpu_torch import devcache, kubeapi
    from kubernetesclustercapacity_tpu_torch.follower import ClusterFollower
    from kubernetesclustercapacity_tpu_torch.service import (
        CapacityClient,
        CapacityServer,
    )
    from kubernetesclustercapacity_tpu_torch.service.server import (
        follow_publisher,
    )
    from kubernetesclustercapacity_tpu_torch.store import ClusterStore

    out = {"launches": {"sweep_fit": {}, "sweep_multi": {}}, "times": {}}
    # Go-style "-flag=value" split for argparse, as the CLI's main does.
    spec = [a for flag in SPEC_FLAGS for a in flag.split("=", 1)]
    have_yaml = importlib.util.find_spec("yaml") is not None
    log(f"(m): PyYAML {'is' if have_yaml else 'is NOT'} installed; the "
        f"CLI reads the mock through "
        f"{'-kubeconfig <file>' if have_yaml else 'load_source(client=)'}")
    t0 = time.perf_counter()
    fixture = live_fixture_source(pkg)
    events = churn_events(fixture)
    json_path = os.path.join(tmp, "m_cluster.json")
    pkg.save_fixture(fixture, json_path)
    grid = pkg.random_scenario_grid(1000, seed=7)
    log(f"(m) source: {len(fixture['nodes'])} nodes, {len(fixture['pods'])} "
        f"pods, {len(events)} churn events, built in "
        f"{time.perf_counter() - t0:.2f} s")

    mock = MockApiserver(fixture)
    mocks = [mock]
    servers, followers, coalescers = [], [], []

    def client(server):
        return CapacityClient(*server.address, connect_timeout_s=60,
                              timeout_s=600, retry=None)

    try:
        # -- (m1) the CLI's live run -------------------------------------
        kube = kubeapi.KubeClient(kubeapi.KubeConfig(mock.url,
                                                     token=LIVE_TOKEN))
        t0 = time.perf_counter()
        listed = kubeapi.live_fixture(client=kube)
        t_list = time.perf_counter() - t0
        t0 = time.perf_counter()
        pkg.snapshot_from_fixture(listed)
        t_pack = time.perf_counter() - t0
        out["times"]["list_s"], out["times"]["pack_s"] = t_list, t_pack
        log(f"(m1) List of {len(listed['nodes'])} nodes and "
            f"{len(listed['pods'])} pods through KubeClient: {t_list:.3f} s;"
            f" pack (reference): {t_pack:.3f} s ({identity})")
        kubeconfig = os.path.join(tmp, "m_kubeconfig")

        def live_cli(flags):
            if have_yaml:
                return run_cli_text(cli, ["-kubeconfig", kubeconfig, *flags])
            args = cli.build_parser().parse_args(flags)
            scenario = pkg.scenario_from_flags(
                cpuRequests=args.cpuRequests, cpuLimits=args.cpuLimits,
                memRequests=args.memRequests, memLimits=args.memLimits,
                replicas=args.replicas)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                fx, snap = cli.load_source(args, client=kubeapi.KubeClient(
                    kubeapi.KubeConfig(mock.url, token=LIVE_TOKEN)))
                if snap is None:
                    raise AssertionError(f"(m1): {buf.getvalue()}")
                rc = cli.run(args, fx, snap, scenario)
            if rc != 0:
                raise AssertionError(f"(m1) cli {flags} exited {rc}")
            return buf.getvalue()

        if have_yaml:
            write_kubeconfig(kubeconfig, mock.url)
        ff.LAUNCHES = fm.LAUNCHES = 0
        t0 = time.perf_counter()
        live_grid = json.loads(live_cli(["-grid", "1000", "-output",
                                         "json"]).strip().splitlines()[-1])
        out["times"]["cli_grid_s"] = time.perf_counter() - t0
        launches = (ff.LAUNCHES, fm.LAUNCHES)
        out["launches"]["sweep_fit"]["(m1) -grid 1000"] = launches[0]
        file_grid = run_cli(cli, ["-snapshot", json_path, "-grid", "1000",
                                  "-output", "json"])
        if launches != (1, 0) or live_grid != file_grid or \
                live_grid["kernel"] != "cuda_i32_rcp_fused":
            raise AssertionError(f"(m1) -grid: launches {launches}, label "
                                 f"{live_grid['kernel']}, equal to -snapshot "
                                 f"{live_grid == file_grid}")
        t0 = time.perf_counter()
        live_text = live_cli([*spec, "-output", "reference"])
        out["times"]["cli_transcript_s"] = time.perf_counter() - t0
        file_text = run_cli_text(cli, ["-snapshot", json_path, *spec,
                                       "-output", "reference"])
        if live_text != file_text:
            raise AssertionError("(m1): the live transcript differs from "
                                 "the -snapshot transcript")
        log(f"(m1) CLI without -snapshot: -grid 1000 label "
            f"{live_grid['kernel']}, B1 launches 1, totals equal to "
            f"-snapshot's ({out['times']['cli_grid_s']:.2f} s); transcript "
            f"byte-identical to -snapshot's ({len(live_text)} bytes, "
            f"{out['times']['cli_transcript_s']:.2f} s) ({identity})")

        # -- (m2) update batches through the service --------------------
        snap0 = pkg.snapshot_from_fixture(fixture)
        server = CapacityServer(snap0, fixture=fixture, device="cuda",
                                batch_window_ms=0)
        server.start()
        servers.append(server)
        mirror = ClusterStore(fixture)
        store_s = 0.0
        update_s = []
        quiet = {"stage_replace_ms": [], "warm_ms": [], "columns": []}
        m2_launches = 0
        with client(server) as c:
            c.sweep(random={"n": 1000, "seed": 7})  # stage generation 1
            for b in range(0, len(events), 100):
                batch = events[b:b + 100]
                t0 = time.perf_counter()
                reply = c.update(batch)
                update_s.append(time.perf_counter() - t0)
                prev = mirror.snapshot()
                t0 = time.perf_counter()
                mirror.apply(batch)
                store_s += time.perf_counter() - t0
                # The same re-stage a -follow publish makes, timed on a
                # private cache with no other thread running Python.
                cache = devcache.DeviceCache()
                cache.warm(prev, torch.device("cuda"))
                new = mirror.snapshot()
                t0 = time.perf_counter()
                quiet["columns"].append(cache.stage_replace(
                    prev, new, torch.device("cuda")))
                t1 = time.perf_counter()
                cache.warm(new, torch.device("cuda"))
                quiet["stage_replace_ms"].append((t1 - t0) * 1e3)
                quiet["warm_ms"].append((time.perf_counter() - t1) * 1e3)
                del cache, prev, new
                if reply["applied"] != len(batch):
                    raise AssertionError(f"(m2) update: {reply}")
                ff.LAUNCHES = fm.LAUNCHES = 0
                doc = c.sweep(random={"n": 1000, "seed": 7})
                launches = (ff.LAUNCHES, fm.LAUNCHES)
                m2_launches += launches[0]
                if launches != (1, 0) or doc["kernel"] != "cuda_i32_rcp_fused":
                    raise AssertionError(f"(m2) sweep after batch {b // 100}:"
                                         f" label {doc['kernel']}, launches "
                                         f"{launches}")
                repack = pkg.snapshot_from_fixture(mirror.fixture_view())
                check_totals(f"(m2) sweep after batch {b // 100}", fit, ff,
                             repack, grid, doc["totals"], mode="reference",
                             mask=None)
        final_totals = doc["totals"]
        out["launches"]["sweep_fit"][
            f"(m2) {len(update_s)} sweeps after update"] = m2_launches
        out["times"]["store_events_per_s"] = len(events) / store_s
        out["times"]["update_events_per_s"] = len(events) / sum(update_s)
        out["times"]["update_first_batch_s"] = update_s[0]
        out["times"]["update_events_per_s_after_first"] = \
            (len(events) - 100) / sum(update_s[1:])
        out["times"]["quiet_publish"] = {
            key: {"median": statistics.median(v), "max": max(v)}
            for key, v in quiet.items() if key != "columns"}
        out["times"]["quiet_publish"]["columns"] = {
            k: sum(c[k] for c in quiet["columns"])
            for k in ("reused", "copied", "restaged")}
        log(f"(m2) {len(update_s)} update batches of 100 ({len(events)} "
            f"events): after "
            f"each, sweep 1000 launched B1 once ({m2_launches} in all) and "
            f"equalled the exact program on the card and the host on a full "
            f"repack; events applied per second: store alone "
            f"{out['times']['store_events_per_s']:.0f}, through update "
            f"{out['times']['update_events_per_s']:.0f} (the first batch, "
            f"which builds the server's store, {update_s[0]:.3f} s; the "
            f"other 30 batches "
            f"{out['times']['update_events_per_s_after_first']:.0f} events "
            f"per second) ({identity})")
        log(f"(m2) the same re-stage as a publish, with no other thread "
            f"running Python, per batch (median / max ms): stage_replace "
            f"{out['times']['quiet_publish']['stage_replace_ms']}, warm "
            f"{out['times']['quiet_publish']['warm_ms']}; columns "
            f"{out['times']['quiet_publish']['columns']} ({identity})")

        # -- (m3) -follow: list+watch, coalesced publish ----------------
        def follow(mock_server, **kw):
            cfg = kubeapi.KubeConfig(mock_server.url, token=LIVE_TOKEN)
            t0 = time.perf_counter()
            follower = ClusterFollower(
                client_factory=lambda: kubeapi.KubeClient(cfg),
                stop_on_idle_window=True, **kw).start(watch=False)
            listed_s = time.perf_counter() - t0
            followers.append(follower)
            server = CapacityServer(follower.snapshot(),
                                    fixture=follower.fixture_view(),
                                    device="cuda", batch_window_ms=0,
                                    stats_source=follower.stats)
            server.start()
            servers.append(server)
            return follower, server, listed_s

        streams = watch_streams(events)
        ref_mock = MockApiserver(fixture, streams)
        mocks.append(ref_mock)
        follower, server, listed_s = follow(ref_mock, semantics="reference")
        out["times"]["follower_list_pack_s"] = listed_s
        with client(server) as c:
            c.sweep(random={"n": 1000, "seed": 7})  # stage generation 1
            clock = PublishClock(devcache.CACHE, follower)
            try:
                coalescer, publish_fatal = follow_publisher(
                    server, follower, coalesce_ms=100)
                coalescers.append(coalescer)
                polls = 0
                ff.LAUNCHES = fm.LAUNCHES = 0
                deadline = time.perf_counter() + 300
                while True:
                    doc = c.sweep(random={"n": 1000, "seed": 7})
                    answered = time.perf_counter()
                    polls += 1
                    written = ref_mock.stream_written
                    if len(written) == 2 and doc["totals"] == final_totals:
                        break
                    if time.perf_counter() > deadline:
                        raise AssertionError("(m3): no sweep answered the "
                                             "final state within 300 s")
                    time.sleep(0.001)
                launches = (ff.LAUNCHES, fm.LAUNCHES)
                staleness_ms = (answered - max(written.values())) * 1e3
                follower.join(300)
                if not coalescer.stop(timeout=300):
                    raise AssertionError("(m3): the coalescer did not drain")
            finally:
                clock.close()
            if coalescer.last_error is not None or follower.fatal is not None \
                    or publish_fatal:
                raise AssertionError(f"(m3): publish error "
                                     f"{coalescer.last_error}, follower fatal "
                                     f"{follower.fatal}, {publish_fatal}")
            if launches != (polls, 0):
                raise AssertionError(f"(m3): {polls} sweeps launched "
                                     f"{launches}")
            ff.LAUNCHES = 0
            doc = c.sweep(random={"n": 1000, "seed": 7})
            m3_launches = polls + ff.LAUNCHES
            if ff.LAUNCHES != 1 or doc["kernel"] != "cuda_i32_rcp_fused":
                raise AssertionError(f"(m3) final sweep: label "
                                     f"{doc['kernel']}, launches "
                                     f"{ff.LAUNCHES}")
            view = follower.fixture_view()
            check_totals("(m3) final sweep", fit, ff,
                         pkg.snapshot_from_fixture(view), grid,
                         doc["totals"], mode="reference", mask=None)
            check_equal("(m3) final sweep vs (m2)'s final state",
                        doc["totals"], final_totals)
            stats = follower.stats()
            if stats["events_applied"] != len(events) or stats["fatal"]:
                raise AssertionError(f"(m3) follower: {stats}")
            warm = timed_requests(lambda: c.sweep(random={"n": 1000,
                                                          "seed": 7}))
            warm.pop("reply")
        out["launches"]["sweep_fit"]["(m3) sweeps during and after the "
                                     "stream"] = m3_launches
        publishes = clock.summary()
        out["times"].update(staleness_ms=staleness_ms,
                            publishes=coalescer.flushes,
                            publish=publishes, warm_sweep=warm)
        log(f"(m3) follower list+pack at start: {listed_s:.3f} s; the "
            f"stream's {len(events)} events applied "
            f"({stats['events_applied']}), {coalescer.flushes} publishes "
            f"({coalescer.events} notifications); per publish (median / max "
            f"ms): store snapshot {publishes['snapshot_ms']}, stage_replace "
            f"{publishes['stage_replace_ms']}, warm {publishes['warm_ms']}; "
            f"stage_replace columns over all publishes: "
            f"{publishes['columns']} (reused = carried, copied = in place, "
            f"restaged = fresh) ({identity})")
        log("(m3) each publish (ms; columns carried/copied/fresh): " + "; ".join(
            f"snapshot {r.get('snapshot_ms', 0):.3f}, stage_replace "
            f"{r.get('stage_replace_ms', 0):.3f}, warm {r['warm_ms']:.3f}, "
            + "/".join(str(r.get("columns", {}).get(k, 0))
                       for k in ("reused", "copied", "restaged"))
            for r in clock.records) + f" ({identity})")
        log(f"(m3) staleness: {staleness_ms:.3f} ms from the last watch "
            f"event written to the first sweep answering the final state "
            f"({polls} sweeps polled, each B1 once); after the last publish "
            f"20 warm sweeps: median {warm['median_ms']:.4f} ms, p90 "
            f"{warm['p90_ms']:.4f} ms; final totals equal the exact program "
            f"on the card and the host and (m2)'s; last_error None, fatal "
            f"None ({identity})")

        # -- (m3) the strict server with GPU and storage columns --------
        multi_mock = MockApiserver(fixture, watch_streams(events))
        mocks.append(multi_mock)
        follower, server, _ = follow(multi_mock, semantics="strict",
                                     extended_resources=EXTENDED)
        coalescer, publish_fatal = follow_publisher(server, follower,
                                                    coalesce_ms=100)
        coalescers.append(coalescer)
        follower.join(300)
        if not coalescer.stop(timeout=300) or coalescer.last_error \
                is not None or follower.fatal is not None or publish_fatal:
            raise AssertionError(f"(m3) strict: publish error "
                                 f"{coalescer.last_error}, follower fatal "
                                 f"{follower.fatal}, {publish_fatal}")
        rng = np.random.default_rng(4)
        resources = ("cpu", "memory", *EXTENDED)
        reqs = np.stack([grid.cpu_request_milli, grid.mem_request_bytes,
                         rng.integers(0, 3, grid.size),
                         rng.integers(1, 20, grid.size) * GIB], axis=1)
        with client(server) as c:
            ff.LAUNCHES = fm.LAUNCHES = 0
            mdoc = c.sweep_multi(list(resources), reqs.tolist(),
                                 replicas=grid.replicas.tolist())
            launches = (ff.LAUNCHES, fm.LAUNCHES)
        out["launches"]["sweep_multi"]["(m3) strict sweep_multi"] = \
            launches[1]
        if launches != (0, 1) or mdoc["kernel"] != "cuda_multi_i32_rcp_fused":
            raise AssertionError(f"(m3) sweep_multi: label {mdoc['kernel']}, "
                                 f"launches {launches}")
        snap = pkg.snapshot_from_fixture(follower.fixture_view(),
                                         semantics="strict",
                                         extended_resources=EXTENDED)
        alloc_rn, used_rn = snap.resource_matrix(resources)
        check_multi_against_exact(
            fm, "(m3) sweep_multi",
            (alloc_rn, used_rn, snap.alloc_pods, snap.pods_count,
             snap.healthy, reqs, grid.replicas),
            {"mode": "strict", "node_masks": pkg.implicit_taint_mask(snap)},
            np.asarray(mdoc["totals"]), np.asarray(mdoc["schedulable"]))
        log(f"(m3) strict follow server with {', '.join(EXTENDED)}: "
            f"{coalescer.flushes} publishes, sweep_multi 1000 x 4 label "
            f"{mdoc['kernel']}, B2 launches 1, equal to the exact program "
            f"on the card and the host on a full repack ({identity})")
    finally:
        for follower in followers:
            follower.stop()
        for coalescer in coalescers:
            coalescer.stop(timeout=60)
        for server in servers:
            server.shutdown()
        for m in mocks:
            m.close()
    return out


# --- Path (n): scheduler fidelity ----------------------------------------
# (b)'s strict 10,000-node fixture with what scheduling reads beyond the
# packed columns: a pod priority (the admission-resolved pod.spec.priority
# of three PriorityClasses), an app label per pod and 40 PodDisruptionBudgets
# over those labels.  The template is m5.xlarge-shaped (README "Library").
SCHED_NODES = 10_000
SCHED_TEMPLATE = {"allocatable": {"cpu": "4", "memory": "16777216Ki",
                                  "pods": "110"}}
SCHED_SPEC = {"cpu_request_milli": 500, "mem_request_bytes": 512 * MIB}
SCHED_WIRE = {"cpuRequests": "500m", "memRequests": "512mb"}
POLICIES = ("first-fit", "best-fit", "spread")


def scheduling_fixture(pkg, n: int = SCHED_NODES) -> dict:
    """``synthetic_fixture(n, seed=3, taint_frac=0.1)`` as a seeded copy
    (seed 10): each pod gets a priority from {0, 1000, 100000} and an
    ``app`` label from 32 apps; 40 PDBs select apps 0-31 in one namespace
    each (apps 0-7 twice, so their pods are covered twice), with zero
    allowance (``minAvailable: 100%``), one (``maxUnavailable: 1``),
    slack (``minAvailable: 1``) or ``maxUnavailable: 10%``."""
    fixture = pkg.synthetic_fixture(n, seed=3, taint_frac=0.1)
    rng = np.random.default_rng(10)
    pods = fixture["pods"]
    prio = rng.choice(np.array([0, 1000, 100000]), len(pods))
    app = rng.integers(0, 32, len(pods))
    for pod, p, a in zip(pods, prio.tolist(), app.tolist()):
        pod["priority"] = p
        pod["labels"] = {"app": f"app-{a}"}
    namespaces = sorted({p.get("namespace", "") for p in pods})
    allowance = (("minAvailable", "100%"), ("maxUnavailable", 1),
                 ("minAvailable", 1), ("maxUnavailable", "10%"))
    fixture["pdbs"] = [
        {"name": f"pdb-{k}", "namespace": namespaces[k % 32 % len(namespaces)],
         "selector": {"matchLabels": {"app": f"app-{k % 32}"}},
         allowance[k % 4][0]: allowance[k % 4][1]}
        for k in range(40)
    ]
    return fixture


def strict_fits_numpy(ac, am, ap, uc, um, pc, healthy, mask, c, m):
    """The strict fit of one spec in plain numpy: per resource
    ``(alloc - used) // request`` where used < alloc, the min, clamped to
    the free pod slots and 0, zero on unhealthy and masked nodes."""
    cpu = np.where(ac > uc, (ac - uc) // c, 0)
    mem = np.where(am > um, (am - um) // m, 0)
    fit = np.minimum(np.minimum(cpu, mem), np.maximum(ap - pc, 0))
    fit = np.maximum(fit, 0)
    return np.where(healthy & (True if mask is None else mask), fit, 0)


def spread_reference(cols, c, m, zone, n_zones, n_replicas, policy,
                     max_skew, mask):
    """The zone-skew greedy in plain numpy, one step at a time: the
    feasible node whose zone stays within ``max_skew`` of the least-filled
    zone, first-fit by index, best-fit by least and spread by most
    normalized headroom after the placement (``np.argmin``: first
    minimum)."""
    ac, am, ap, uc, um, pc, healthy = (np.asarray(x) for x in cols)
    hc, hm = ac - uc, am - um
    slots = np.maximum(ap - pc, 0)
    ok_node = healthy & mask & (zone >= 0)
    counts = np.zeros(n_zones, dtype=np.int64)
    out = []
    with np.errstate(divide="ignore", invalid="ignore"):
        for _ in range(n_replicas):
            zone_ok = counts[np.maximum(zone, 0)] + 1 - counts.min() \
                <= max_skew
            feas = (hc >= c) & (hm >= m) & (slots >= 1) & ok_node & zone_ok
            if policy == "first-fit":
                score = np.arange(len(hc), dtype=np.float64)
            else:
                after = (np.where(ac > 0, (hc - c) / ac, 0.0)
                         + np.where(am > 0, (hm - m) / am, 0.0))
                score = after if policy == "best-fit" else -after
            masked = np.where(feas, score, np.inf)
            i = int(np.argmin(masked))
            if not np.isfinite(masked[i]):
                out.append(-1)
                continue
            hc[i] -= c
            hm[i] -= m
            slots[i] -= 1
            counts[zone[i]] += 1
            out.append(i)
    return np.asarray(out, dtype=np.int64)


def host_blocked(pkg_pdb, fixture, keys):
    """The eviction API's point-in-time gate, walked on the host: a pod
    covered by two or more PDBs of its namespace, or by one with no
    allowed disruption, is blocked."""
    statuses = pkg_pdb.budget_statuses(fixture)
    pods = {f"{p.get('namespace', '')}/{p.get('name', '')}": p
            for p in fixture["pods"]}
    out = {}
    for key in keys:
        pod = pods[key]
        covering = [
            s for s, doc in zip(statuses, fixture["pdbs"])
            if s.namespace == pod.get("namespace", "") and all(
                (pod.get("labels") or {}).get(k) == v
                for k, v in doc["selector"]["matchLabels"].items())
        ]
        if len(covering) >= 2 or (covering and
                                  covering[0].allowed_disruptions <= 0):
            out[key] = [s.name for s in covering]
    return out


def run_cli_rc(cli, argv: list[str]) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def phase_scheduling(pkg, cli, fit, ff, fm, tmp: str, identity: str,
                     device: str = "cuda", n: int = SCHED_NODES) -> dict:
    """Path (n): scheduler fidelity on :func:`scheduling_fixture`, strict,
    through the library, the CLI and the service, each device program on
    the card held against a host engine.

    (n1) ``place`` under each policy: the scan at 256 replicas equals the
    trace engine's and ``place_replicas_python``'s order; the trace and
    bulk engines at 5,000 agree, and every count is ``min(R, Σ strict
    fits)`` of the exact program.  (n2) the zone-skew scan at 256 equals a
    numpy reference; ``place_replicas_multi`` on (e)'s config-4 fixture
    with ``nvidia.com/gpu=1`` equals the trace engine and (best-fit)
    ``place_replicas_multi_python``.  (n3) ``drain`` of the busiest node
    under each policy equals ``place_pods_python`` and the host PDB walk;
    ``-drain`` through the CLI on the fixture as ``.json`` equals the
    ``-device cpu`` text byte for byte.  (n4) ``evaluate(priority=1000)``
    and ``sweep_preemption`` of 1,000 equal a numpy loop over the
    scenarios on the same tables.  (n5) ``topology_spread(_grid)`` and
    ``nodes_needed(_grid)`` of 1,000 (B1 and the spread kernel's launches
    counted) equal the exact program and the host.  (n6) a server on the fixture answers ``place``,
    ``drain``, ``topology_spread``, ``plan``, ``fit`` with ``priority`` and
    ``sweep`` with ``priorities`` as the library does, 20 warm requests of
    each."""
    from kubernetesclustercapacity_tpu_torch import pdb as pkg_pdb
    from kubernetesclustercapacity_tpu_torch.ops import placement as pl
    from kubernetesclustercapacity_tpu_torch.ops import preemption as pre
    from kubernetesclustercapacity_tpu_torch.service import (
        CapacityClient,
        CapacityServer,
    )
    from kubernetesclustercapacity_tpu_torch.topology.model import (
        label_codes,
    )

    out = {"ms": {}, "launches": {"sweep_fit": {}, "sweep_multi": {},
                                  "sweep_spread": {}}}
    card = device != "cpu"

    def timed(name, fn, runs=5, warmup=1):
        out["ms"][name] = host_median_ms(fn, runs=runs, warmup=warmup) \
            if card else 0.0
        return out["ms"][name]

    t0 = time.perf_counter()
    fixture = scheduling_fixture(pkg, n)
    snap = pkg.snapshot_from_fixture(fixture, semantics="strict")
    mask = pkg.implicit_taint_mask(snap)
    model = pkg.CapacityModel(snap, mode="strict", fixture=fixture,
                              device=device)
    host = pkg.CapacityModel(snap, mode="strict", fixture=fixture,
                             device="cpu")
    cols = (snap.alloc_cpu_milli, snap.alloc_mem_bytes, snap.alloc_pods,
            snap.used_cpu_req_milli, snap.used_mem_req_bytes,
            snap.pods_count, snap.healthy)
    c, m = SCHED_SPEC["cpu_request_milli"], SCHED_SPEC["mem_request_bytes"]
    exact_total = int(fit.fit_snapshot(snap, c, m, mode="strict",
                                       node_mask=mask, device=device).sum())
    log(f"(n) fixture: {n} nodes, {len(fixture['pods'])} pods, "
        f"{len(fixture['pdbs'])} PDBs, built and packed in "
        f"{time.perf_counter() - t0:.2f} s; strict total for 500m/512Mi "
        f"{exact_total}")

    # (n1) place under each policy, each engine forced.
    for policy in POLICIES:
        scan = model.place(pkg.PodSpec(**SCHED_SPEC, replicas=256),
                           policy=policy, assignments=True)
        kw = dict(n_replicas=256, policy=policy, node_mask=mask)
        trace, _, _ = pl.place_replicas_trace(*cols, c, m, **kw)
        py, _ = pl.place_replicas_python(*cols, c, m, **kw)
        if scan.engine != "scan" or not np.array_equal(scan.assignments,
                                                       trace) \
                or not np.array_equal(scan.assignments, py):
            raise AssertionError(f"(n1) {policy}: the scan's order differs "
                                 "from the trace engine or the host walk")
        big = pkg.PodSpec(**SCHED_SPEC, replicas=5000)
        tr = model.place(big, policy=policy, assignments="trace")
        bulk = model.place(big, policy=policy, assignments=False)
        for r, res in ((256, scan), (5000, tr), (5000, bulk)):
            if int(res.per_node.sum()) != min(r, exact_total):
                raise AssertionError(f"(n1) {policy} {res.engine}: placed "
                                     f"{int(res.per_node.sum())}, want "
                                     f"min({r}, {exact_total})")
        if not np.array_equal(tr.per_node, bulk.per_node):
            raise AssertionError(f"(n1) {policy}: trace and bulk differ")
        spec256 = pkg.PodSpec(**SCHED_SPEC, replicas=256)
        ms = timed(f"(n1) scan 256 {policy}", lambda: model.place(
            spec256, policy=policy, assignments=True))
        timed(f"(n1) trace 5000 {policy}", lambda: model.place(
            big, policy=policy, assignments="trace"))
        timed(f"(n1) bulk 5000 {policy}", lambda: model.place(
            big, policy=policy, assignments=False))
        log(f"(n1) place {policy}: scan 256 = trace = host walk, "
            f"{ms:.3f} ms ({ms / 256 * 1e3:.1f} us per step); trace/bulk "
            f"5000 {out['ms'][f'(n1) trace 5000 {policy}']:.3f} / "
            f"{out['ms'][f'(n1) bulk 5000 {policy}']:.3f} ms; counts "
            f"min(R, {exact_total}) (host clock, median of 5; {identity})")

    # (n2) the zone-skew scan, and the R-resource scan on config 4.
    zone, zones, _ = label_codes(snap.labels, "zone", missing="exclude",
                                 eligible=snap.healthy, n_nodes=n)
    for policy in POLICIES:
        spec = pkg.PodSpec(**SCHED_SPEC, replicas=256)
        res = model.place(spec, policy=policy, topology_key="zone",
                          max_skew=1)
        want = spread_reference(cols, c, m, zone, len(zones), 256, policy, 1,
                                np.ones(n, bool) if mask is None else mask)
        cap = model.topology_spread(spec, topology_key="zone").total
        if not np.array_equal(res.assignments, want) or \
                res.placed != min(256, cap):
            raise AssertionError(f"(n2) zone spread {policy}: differs from "
                                 "the numpy reference")
        ms = timed(f"(n2) zone scan 256 {policy}", lambda: model.place(
            spec, policy=policy, topology_key="zone", max_skew=1))
        log(f"(n2) place topology_key=zone max_skew=1 {policy}: scan 256 = "
            f"numpy reference, placed {res.placed}, {ms:.3f} ms "
            f"({ms / 256 * 1e3:.1f} us per step; {identity})")
    c4 = pkg.snapshot_from_fixture(config4_fixture(pkg, n),
                                   semantics="strict",
                                   extended_resources=EXTENDED)
    resources = ("cpu", "memory", "nvidia.com/gpu")
    alloc_rn, used_rn = c4.resource_matrix(resources)
    margs = (alloc_rn, used_rn, c4.alloc_pods, c4.pods_count, c4.healthy,
             np.array([c, m, 1]))
    mmask = pkg.implicit_taint_mask(c4)
    for policy in POLICIES:
        kw = dict(n_replicas=256, policy=policy, node_mask=mmask)
        got, counts = pl.place_replicas_multi(*margs, device=device, **kw)
        trace, t_counts, _ = pl.place_replicas_trace_multi(*margs, **kw)
        if not (np.array_equal(got, trace) and
                np.array_equal(counts, t_counts)):
            raise AssertionError(f"(n2) multi {policy}: scan != trace")
        if policy == "best-fit":
            py, _ = pl.place_replicas_multi_python(*margs, **kw)
            if not np.array_equal(got, py):
                raise AssertionError("(n2) multi best-fit: scan != host walk")
        ms = timed(f"(n2) multi scan 256 {policy}", lambda: (
            pl.place_replicas_multi(*margs, device=device, **kw)))
        log(f"(n2) place_replicas_multi {policy} config 4, nvidia.com/gpu=1:"
            f" scan 256 = trace engine"
            f"{' = host walk' if policy == 'best-fit' else ''}, placed "
            f"{int((got >= 0).sum())}, {ms:.3f} ms ({identity})")

    # (n3) drain the node with the most counted pods.
    counted = {}
    for p in fixture["pods"]:
        if p.get("nodeName") and p.get("phase") not in ("Succeeded",
                                                        "Failed"):
            counted[p["nodeName"]] = counted.get(p["nodeName"], 0) + 1
    node = min(counted, key=lambda k: (-counted[k], k))
    by_key = {f"{p.get('namespace', '')}/{p.get('name', '')}": p
              for p in fixture["pods"]}
    for policy in POLICIES:
        t0 = time.perf_counter()
        plan = model.drain(node, policy=policy)
        ms = out["ms"][f"(n3) drain {policy}"] = \
            (time.perf_counter() - t0) * 1e3
        effs = [pkg.snapshot._effective_pod_resources(by_key[k], ())
                for k in plan.pods]
        dmask = np.ones(n, bool) if mask is None else mask.copy()
        dmask[snap.names.index(node)] = False
        want, _ = pl.place_pods_python(
            *cols, [e["cpu_req"] for e in effs],
            [e["mem_req"] for e in effs], policy=policy, node_mask=dmask)
        names = [snap.names[i] if i >= 0 else None for i in want]
        if plan.assignments != names or len(plan.pods) != counted[node] or \
                plan.blocked != host_blocked(pkg_pdb, fixture, plan.pods):
            raise AssertionError(f"(n3) drain {policy}: differs from "
                                 "place_pods_python or the host PDB walk")
        log(f"(n3) drain {node} ({len(plan.pods)} pods) {policy}: = "
            f"place_pods_python, {len(plan.blocked)} blocked = host PDB "
            f"walk, evictable {plan.evictable}, {ms:.3f} ms (one call; "
            f"{identity})")
    path = os.path.join(tmp, "n.json")
    pkg.save_fixture(fixture, path)
    argv = ["-snapshot", path, "-semantics", "strict", "-drain", node]
    t0 = time.perf_counter()
    rc, text = run_cli_rc(cli, argv + ["-device", device])
    out["ms"]["(n3) -drain CLI"] = (time.perf_counter() - t0) * 1e3
    rc_cpu, text_cpu = run_cli_rc(cli, argv + ["-device", "cpu"])
    if (rc, text) != (rc_cpu, text_cpu) or not text.startswith(
            f"drain {node}: {counted[node]} pod(s)"):
        raise AssertionError("(n3) -drain: the card's text differs from "
                             "-device cpu")
    log(f"(n3) -drain {node} through the CLI on the .json: exit {rc}, "
        f"{len(text)} bytes equal to -device cpu, "
        f"{out['ms']['(n3) -drain CLI']:.1f} ms ({identity})")

    # (n4) preemption: one spec, then 1,000 scenarios.
    table = pre.build_priority_table(fixture, snap)
    res = model.evaluate(pkg.PodSpec(**SCHED_SPEC, priority=1000))
    k = table.column_index(1000)
    want = strict_fits_numpy(*cols[:3], table.used_cpu_ge[:, k],
                             table.used_mem_ge[:, k], table.pods_ge[:, k],
                             snap.healthy, mask, c, m)
    if not np.array_equal(res.fits, want) or res.total <= exact_total:
        raise AssertionError("(n4) evaluate(priority=1000): differs from "
                             "the numpy fit on the table")
    grid = pkg.random_scenario_grid(1000, seed=7)
    prio = np.random.default_rng(11).choice(
        np.array([-1, 0, 1, 999, 1000, 1001, 100000, 200000]), grid.size)
    totals, sched = model.sweep_preemption(grid, prio)
    want = np.empty(grid.size, dtype=np.int64)
    for s in range(grid.size):
        k = table.column_index(int(prio[s]))
        want[s] = strict_fits_numpy(
            *cols[:3], table.used_cpu_ge[:, k], table.used_mem_ge[:, k],
            table.pods_ge[:, k], snap.healthy, mask,
            int(grid.cpu_request_milli[s]),
            int(grid.mem_request_bytes[s])).sum()
    if not (np.array_equal(totals, want)
            and np.array_equal(sched, want >= grid.replicas)):
        raise AssertionError("(n4) sweep_preemption: differs from the "
                             "numpy loop over scenarios")
    ev = timed("(n4) evaluate priority", lambda: model.evaluate(
        pkg.PodSpec(**SCHED_SPEC, priority=1000)))
    sw = timed("(n4) sweep_preemption 1000", lambda: model.sweep_preemption(
        grid, prio))
    log(f"(n4) evaluate(priority=1000) total {res.total} (> {exact_total} "
        f"without preemption) {ev:.3f} ms; sweep_preemption 1000 x {n} "
        f"= numpy loop, {sw:.3f} ms ({identity})")

    # (n5) topology spread and scale planning; the plan asks for 10,000
    # replicas more than the cluster holds.
    spec = pkg.PodSpec(**SCHED_SPEC, replicas=exact_total + 10_000)
    ts = model.topology_spread(spec, topology_key="zone")
    if ts.zones != host.topology_spread(spec, topology_key="zone").zones:
        raise AssertionError("(n5) topology_spread: card != host")
    ff.LAUNCHES = fm.LAUNCHES = 0
    spread = fit.SPREAD_LAUNCHES
    tg = model.topology_spread_grid(grid, topology_key="zone")
    if (ff.LAUNCHES, fm.LAUNCHES) != (0, 0):
        raise AssertionError("(n5) topology_spread_grid launched B1 or B2")
    spread = fit.SPREAD_LAUNCHES - spread
    out["launches"]["sweep_spread"] = {"(n5) topology_spread_grid": spread}
    if card and spread != 1:
        raise AssertionError(f"(n5) topology_spread_grid: {spread} spread "
                             "kernel launches, want 1 (3 zones)")
    hg = host.topology_spread_grid(grid, topology_key="zone")
    for s in (0, 499, 999):
        one = host.topology_spread(pkg.PodSpec(
            cpu_request_milli=int(grid.cpu_request_milli[s]),
            mem_request_bytes=int(grid.mem_request_bytes[s])),
            topology_key="zone").total
        if int(tg[0][s]) != one:
            raise AssertionError(f"(n5) topology_spread_grid[{s}] != "
                                 "topology_spread")
    if not (np.array_equal(tg[0], hg[0]) and np.array_equal(tg[1], hg[1])):
        raise AssertionError("(n5) topology_spread_grid: card != host")
    plan = model.nodes_needed(spec, SCHED_TEMPLATE)
    if dataclasses.asdict(plan) != dataclasses.asdict(
            host.nodes_needed(spec, SCHED_TEMPLATE)) or \
            not plan.nodes_needed:
        raise AssertionError("(n5) nodes_needed: card != host")
    ff.LAUNCHES = fm.LAUNCHES = 0
    needed = model.nodes_needed_grid(grid, SCHED_TEMPLATE)
    launches = (ff.LAUNCHES, fm.LAUNCHES)
    out["launches"]["sweep_fit"]["(n5) nodes_needed_grid"] = launches[0]
    if card and launches != (2, 0):
        raise AssertionError(f"(n5) nodes_needed_grid: launches {launches}, "
                             "want B1 twice (cluster, template)")
    tmpl = pkg.snapshot_from_fixture(
        {"nodes": [dict(SCHED_TEMPLATE, name="template-node", conditions=[
            {"type": "Ready", "status": "True"}])], "pods": []},
        semantics="strict")
    cur = ff.sweep_snapshot_auto(snap, grid, mode="strict", kernel="exact",
                                 node_mask=mask, device=device)[0]
    per = ff.sweep_snapshot_auto(tmpl, grid, mode="strict", kernel="exact",
                                 device=device)[0]
    deficit = grid.replicas - cur
    want = np.where(deficit <= 0, 0, np.where(
        per > 0, -(-deficit // np.maximum(per, 1)), -1))
    if not np.array_equal(needed, want):
        raise AssertionError("(n5) nodes_needed_grid: differs from the "
                             "exact program's closed form")
    t1 = timed("(n5) topology_spread", lambda: model.topology_spread(
        spec, topology_key="zone"))
    t2 = timed("(n5) topology_spread_grid 1000", lambda: (
        model.topology_spread_grid(grid, topology_key="zone")))
    t3 = timed("(n5) nodes_needed", lambda: model.nodes_needed(
        spec, SCHED_TEMPLATE))
    t4 = timed("(n5) nodes_needed_grid 1000", lambda: (
        model.nodes_needed_grid(grid, SCHED_TEMPLATE)))
    log(f"(n5) topology_spread total {ts.total} over {len(ts.zones)} zones "
        f"{t1:.3f} ms; grid 1000 = host {t2:.3f} ms; nodes_needed "
        f"{plan.nodes_needed} (per node {plan.per_node_fit}) {t3:.3f} ms; "
        f"grid 1000 = exact closed form, B1 launches {launches[0]}, "
        f"{t4:.3f} ms ({identity})")

    # (n6) the service.
    server = CapacityServer(snap, fixture=fixture, device=device,
                            batch_window_ms=0)
    server.start()
    try:
        with CapacityClient(*server.address, connect_timeout_s=60,
                            timeout_s=300, retry=None) as client:
            spec256 = pkg.PodSpec(**SCHED_SPEC, replicas=256)
            lib_place = model.place(spec256, policy="best-fit",
                                    assignments=True)
            lib_drain = model.drain(node)
            lib_ts = model.topology_spread(spec, topology_key="zone")
            lib_plan = model.nodes_needed(spec, SCHED_TEMPLATE)
            lib_fit = model.evaluate(pkg.PodSpec(**SCHED_SPEC, priority=1000))
            ops = {
                "place": (lambda: client.place(
                    **SCHED_WIRE, replicas="256", policy="best-fit"),
                    lambda r: r["assignments"] == [
                        snap.names[i] if i >= 0 else None
                        for i in lib_place.assignments.tolist()]),
                "drain": (lambda: client.drain(node),
                          lambda r: r["assignments"] == lib_drain.assignments
                          and r["blocked"] == lib_drain.blocked),
                "topology_spread": (lambda: client.topology_spread(
                    "zone", **SCHED_WIRE, replicas=str(spec.replicas)),
                    lambda r: r["zones"] == lib_ts.zones
                    and r["total"] == lib_ts.total),
                "plan": (lambda: client.plan(
                    SCHED_TEMPLATE, **SCHED_WIRE, replicas=str(spec.replicas)),
                    lambda r: r["nodes_needed"] == lib_plan.nodes_needed
                    and r["current_total"] == lib_plan.current_total),
                "fit priority": (lambda: client.fit(
                    **SCHED_WIRE, replicas="5000", priority=1000),
                    lambda r: r["fits"] == lib_fit.fits.tolist()),
                "sweep priorities": (lambda: client.sweep(
                    random={"n": 1000, "seed": 7}, priorities=prio.tolist()),
                    lambda r: r["totals"] == totals.tolist()
                    and r["schedulable"] == sched.tolist()),
            }
            for name, (call, check) in ops.items():
                res = timed_requests(call)
                if not check(res["reply"]):
                    raise AssertionError(f"(n6) {name}: the reply differs "
                                         "from the library call")
                out["ms"][f"(n6) {name}"] = res["median_ms"]
                out["ms"][f"(n6) {name} p90"] = res["p90_ms"]
                log(f"(n6) service {name}: = the library call, "
                    f"{res['median_ms']:.3f} ms median, p90 "
                    f"{res['p90_ms']:.3f} (host clock, 20 warm requests; "
                    f"{identity})")
    finally:
        server.shutdown()
    return out


# --- Path (o): capacity at risk, forecasting and the certified planner --
# (a)'s 10,000-node reference fleet and (b)'s strict taint-masked one, with
# per-pod usage uncertain: cpu normal around 500m, memory lognormal around
# 4 GiB with sigma 1 (the case where torch.special.erfinv and torch.exp
# would move int64 samples).  The catalog holds the vCPU, memory and
# max-pods shapes of four EC2 instance types, priced in proportion to their
# vCPUs (nothing is fetched).
STOCH_USAGE = {"cpu": {"dist": "normal", "mean": "500m", "std": "200m"},
               "memory": {"dist": "lognormal", "mean": "4gb", "sigma": 1.0}}
STOCH_DISTS = (
    ("normal", {"mean": 500.0, "std": 200.0}),
    ("lognormal", {"mean": float(4 << 30), "sigma": 1.0}),
    ("empirical", {"values": (250, 500, 1000, 4000),
                   "weights": (5.0, 3.0, 1.5, 0.5)}),
)
STOCH_CATALOG = [
    {"name": "m5.xlarge", "cpu": "4", "memory": "16gb", "pods": 58,
     "unit_cost": 4},
    {"name": "m5.2xlarge", "cpu": "8", "memory": "32gb", "pods": 58,
     "unit_cost": 8},
    {"name": "m5.4xlarge", "cpu": "16", "memory": "64gb", "pods": 234,
     "unit_cost": 16},
    {"name": "c5.4xlarge", "cpu": "16", "memory": "32gb", "pods": 234,
     "unit_cost": 16},
]


def check_car(name: str, got, want) -> None:
    """Capacity-at-risk results equal in every integer and in the numpy
    floats of equal integers."""
    same = (np.array_equal(got.totals, want.totals)
            and np.array_equal(got.samples_cpu, want.samples_cpu)
            and np.array_equal(got.samples_mem, want.samples_mem)
            and got.quantiles == want.quantiles
            and got.quantile_samples == want.quantile_samples
            and got.mean == want.mean and got.prob_fit == want.prob_fit)
    if not same:
        raise AssertionError(f"{name}: capacity at risk differs")


def phase_stochastic(pkg, cli, ff, fm, tmp: str, identity: str,
                     device: str = "cuda") -> dict:
    """Path (o): the stochastic family at 10,000 nodes, through the
    library, the CLI and the service, each answer on the card held against
    its numpy oracle or its host run.

    (o1) the seeded sampler draws 65,536 samples of a normal, a lognormal
    (mean 4 GiB, sigma 1) and an empirical distribution on the card and on
    the host: 0 int64 mismatches.  (o2) ``capacity_at_risk`` of 4,096
    samples on (a) and on (b) with its taint mask, and 1,024 on (c)'s
    grouped fleet, equals ``car_oracle`` and ``fused=False``.  (o3)
    ``project_horizon`` of 16 steps x 512 samples (8,192 exact-sweep rows x
    10,000 nodes in one dispatch) equals ``horizon_oracle``.  (o4)
    ``plan_capacity`` of 1,024 samples over the four-shape catalog, target
    above the current P95, with the drain dual, is certified.  (o5) the
    CLI's ``-car-spec``, ``-forecast-spec`` (growth, and a trend from a
    20-generation audit log of a 500-node fleet, which the port writes
    here) and ``-plan -catalog``
    on (a)'s ``.npz`` print what their ``-device cpu`` runs print, with
    the same exit codes.  (o6) a server on (a) answers ``car``,
    ``forecast`` and a catalog ``plan`` as the library does, 20 warm
    requests each, and their status forms, which ``-car``/``-forecast``
    render.  Kernels B1 and B2 are not on this path: the exact int64
    program answers (as in the JAX package), so both launch 0 times."""
    from kubernetesclustercapacity_tpu_torch import audit, forecast
    from kubernetesclustercapacity_tpu_torch import stochastic as st
    from kubernetesclustercapacity_tpu_torch.service import (
        CapacityClient,
        CapacityServer,
    )

    out = {"ms": {}, "launches": {"sweep_fit": {}, "sweep_multi": {}},
           "sampler_mismatches": 0}

    def timed(name, fn, runs=5, warmup=1):
        out["ms"][name] = host_median_ms(fn, runs=runs, warmup=warmup)
        return out["ms"][name]

    t_phase = time.perf_counter()
    a = pkg.synthetic_snapshot(10_000, seed=1)
    b = pkg.snapshot_from_fixture(
        pkg.synthetic_fixture(10_000, seed=3, taint_frac=0.1),
        semantics="strict")
    mask_b = pkg.implicit_taint_mask(b)
    c = pkg.synthetic_snapshot(100_000, seed=2, shapes=48)
    ff.LAUNCHES = fm.LAUNCHES = 0

    # (o1) the sampler on the card against the host.
    n = 1 << 16
    for kind, kw in STOCH_DISTS:
        dist = st.UsageDistribution(kind=kind, **kw)
        key = st.sample_key(11, 1)
        card = st.sample_usage(dist, n, key, device=device)
        t0 = time.perf_counter()
        host = st.sample_usage(dist, n, key, device="cpu")
        t_host = out["ms"][f"(o1) {kind} draw host"] = (
            time.perf_counter() - t0) * 1e3
        bad = int((card != host).sum())
        out["sampler_mismatches"] += bad
        t_card = timed(f"(o1) {kind} draw", lambda: st.sample_usage(
            dist, n, key, device=device))
        log(f"(o1) sampler {kind}: {n} draws, card vs host mismatches "
            f"{bad}, card {t_card:.3f} ms median, host {t_host:.3f} ms "
            f"once (host clock; {identity})")
    if out["sampler_mismatches"]:
        raise AssertionError(f"(o1) {out['sampler_mismatches']} draws "
                             "differ between the card and the host")

    # (o2) capacity at risk against the oracle and the unfused path.
    def car_spec(samples):
        return st.parse_stochastic_spec({
            "usage": STOCH_USAGE, "replicas": 5000, "samples": samples,
            "seed": 11})

    for name, snap, mask, samples in (("(a)", a, None, 4096),
                                      ("(b)", b, mask_b, 4096),
                                      ("(c) grouped", c, None, 1024)):
        spec = car_spec(samples)
        got = st.capacity_at_risk(snap, spec, node_mask=mask, device=device)
        check_car(f"(o2) {name}", got, st.car_oracle(snap, spec,
                                                     node_mask=mask))
        check_car(f"(o2) {name} unfused", st.capacity_at_risk(
            snap, spec, node_mask=mask, fused=False, device=device), got)
        t = timed(f"(o2) car {name}", lambda: st.capacity_at_risk(
            snap, spec, node_mask=mask, device=device))
        if name == "(a)" and device != "cpu":
            out["trace"] = phase_trace(lambda: st.capacity_at_risk(
                snap, spec, device=device), "elementwise", t, runs=5)
        log(f"(o2) capacity_at_risk {name} {snap.n_nodes} nodes x "
            f"{samples} samples ({snap.semantics}"
            f"{', masked' if mask is not None else ''}): quantiles "
            f"{got.to_wire()['quantiles']}, P(fit 5000) {got.prob_fit}, = "
            f"car_oracle and fused=False, {t:.3f} ms median ({identity})")

    # (o3) the horizon: one [16 x 512] dispatch.
    spec = car_spec(512)
    kw = dict(steps=16, step_s=3600.0, growth_cpu_per_s=2e-6)
    hz = forecast.project_horizon(a, spec, device=device, **kw)
    want = forecast.horizon_oracle(a, spec, **kw)
    if not np.array_equal(hz.totals, want.totals) or \
            hz.time_to_breach_s != want.time_to_breach_s:
        raise AssertionError("(o3) project_horizon differs from the oracle")
    t = timed("(o3) horizon 16x512", lambda: forecast.project_horizon(
        a, spec, device=device, **kw))
    log(f"(o3) project_horizon 16 x 512 on (a): p95 now "
        f"{hz.to_wire()['now']['p95']}, time to breach "
        f"{hz.to_wire()['time_to_breach_s']}, = horizon_oracle, {t:.3f} ms "
        f"median ({identity})")

    # (o4) the certified plan.
    spec = car_spec(1024)
    catalog = forecast.parse_catalog(STOCH_CATALOG)
    p95 = st.capacity_at_risk(a, spec, bindings=False,
                              device=device).quantiles[0.95]
    target = p95 + 500
    t0 = time.perf_counter()
    plan = forecast.plan_capacity(a, spec, catalog, target=target,
                                  drain=True, device=device)
    t = out["ms"]["(o4) plan 1024"] = (time.perf_counter() - t0) * 1e3
    if not plan.certified or plan.projected_quantile_capacity < target:
        raise AssertionError(f"(o4) plan not certified: "
                             f"{plan.uncertified_reason}")
    host_plan = forecast.plan_capacity(a, spec, catalog, target=target,
                                       drain=True, device="cpu")
    if host_plan.to_wire() != plan.to_wire():
        raise AssertionError("(o4) the plan differs from the host's")
    log(f"(o4) plan_capacity target {target} (P95 {p95}): buy {plan.buy}, "
        f"cost {plan.total_cost} vs LP bound {plan.lp_bound:.3f}, "
        f"certified, drain free {plan.drain['free_count']} surplus "
        f"{plan.drain['surplus_count']}, = the host run, {t:.3f} ms once "
        f"({identity})")

    # (o5) the CLI against its -device cpu runs.
    a_npz = os.path.join(tmp, "a.npz")
    a.save(a_npz)
    audit_dir = os.path.join(tmp, "audit")
    grow = pkg.synthetic_snapshot(500, seed=5)
    with audit.AuditLog(audit_dir) as audit_log:
        for g in range(1, 21):
            audit_log.record_generation(dataclasses.replace(
                grow,
                used_cpu_req_milli=(np.asarray(grow.used_cpu_req_milli)
                                    * (1.0 + 0.02 * g)).astype(np.int64),
                used_mem_req_bytes=(np.asarray(grow.used_mem_req_bytes)
                                    * (1.0 + 0.01 * g)).astype(np.int64),
            ), g, ts=1_700_000_000.0 + 3600.0 * g)
    base = {"usage": STOCH_USAGE, "replicas": 5000, "seed": 11}
    docs = {
        "car": dict(base, samples=1024),
        "forecast": dict(base, samples=128, horizon={"steps": 8,
                                                     "step_s": 3600},
                         growth={"cpu_per_s": 2e-6, "memory_per_s": 1e-6}),
        "forecast-audit": dict(base, samples=128,
                               horizon={"steps": 8, "step_s": 3600},
                               audit_dir=audit_dir),
        "plan": dict(base, samples=512, target=target, drain=True),
    }
    files = {}
    for name, doc in list(docs.items()) + [("catalog",
                                            {"shapes": STOCH_CATALOG})]:
        files[name] = os.path.join(tmp, f"{name}.json")
        with open(files[name], "w") as f:
            json.dump(doc, f)
    argvs = {
        "-car-spec": ["-car-spec", files["car"]],
        "-forecast-spec growth": ["-forecast-spec", files["forecast"]],
        "-forecast-spec audit_dir": ["-forecast-spec",
                                     files["forecast-audit"]],
        "-plan -catalog": ["-plan", files["plan"], "-catalog",
                           files["catalog"]],
    }
    for name, args in argvs.items():
        argv = ["-snapshot", a_npz, *args, "-output", "json"]
        t0 = time.perf_counter()
        rc, text = run_cli_rc(cli, argv + ["-device", device])
        out["ms"][f"(o5) {name}"] = (time.perf_counter() - t0) * 1e3
        rc_host, text_host = run_cli_rc(cli, argv + ["-device", "cpu"])
        if (rc, text) != (rc_host, text_host) or not text:
            raise AssertionError(f"(o5) {name}: the card's output differs "
                                 "from -device cpu")
        log(f"(o5) CLI {name}: exit {rc}, {len(text)} bytes = the -device "
            f"cpu run, {out['ms'][f'(o5) {name}']:.1f} ms ({identity})")

    # (o6) the service.
    server = CapacityServer(a, device=device, batch_window_ms=0)
    server.start()
    try:
        with CapacityClient(*server.address, connect_timeout_s=60,
                            timeout_s=300, retry=None) as client:
            car_req = dict(base, samples=1024)
            fc_req = dict(base, samples=256, steps=16, step_s=3600,
                          growth={"cpu_per_s": 2e-6, "memory_per_s": 0.0})
            plan_req = dict(base, samples=256, target=target)
            lib_car = st.capacity_at_risk(
                a, car_spec(1024), mode=a.semantics, device=device).to_wire()
            lib_fc = forecast.project_horizon(
                a, car_spec(256), steps=16, step_s=3600.0,
                growth_cpu_per_s=2e-6, growth_mem_per_s=0.0,
                mode=a.semantics, device=device).to_wire()
            lib_plan = forecast.plan_capacity(
                a, car_spec(256), catalog, target=target, mode=a.semantics,
                device=device).to_wire()
            ops = {
                "car": (lambda: client.car(**car_req),
                        lambda r: r == lib_car),
                "forecast": (lambda: client.forecast(**fc_req),
                             lambda r: r == lib_fc),
                "plan catalog": (lambda: client.plan(
                    catalog=STOCH_CATALOG, **plan_req),
                    lambda r: r == lib_plan),
            }
            for name, (call, check) in ops.items():
                res = timed_requests(call)
                if not check(res["reply"]):
                    raise AssertionError(f"(o6) {name}: the reply differs "
                                         "from the library call")
                out["ms"][f"(o6) {name}"] = res["median_ms"]
                out["ms"][f"(o6) {name} p90"] = res["p90_ms"]
                log(f"(o6) service {name}: = the library call, "
                    f"{res['median_ms']:.3f} ms median, p90 "
                    f"{res['p90_ms']:.3f} (host clock, 20 warm requests; "
                    f"{identity})")
            off = {"enabled": False, "watches": {}, "breached": []}
            if client.car() != off or client.forecast() != off:
                raise AssertionError("(o6) a status form is not 'no watches'")
        addr = f"{server.address[0]}:{server.address[1]}"
        for flag in ("-car", "-forecast"):
            rc, text = run_cli_rc(cli, [flag, addr])
            if rc != 1 or "no " not in text:
                raise AssertionError(f"(o6) {flag} rendered {text!r}, "
                                     f"exit {rc}")
        log("(o6) status forms: no watches; -car and -forecast render them "
            "and exit 1")
    finally:
        server.shutdown()

    out["launches"]["sweep_fit"]["(o)"] = ff.LAUNCHES
    out["launches"]["sweep_multi"]["(o)"] = fm.LAUNCHES
    if ff.LAUNCHES or fm.LAUNCHES:
        raise AssertionError(f"(o) B1 launched {ff.LAUNCHES}, B2 "
                             f"{fm.LAUNCHES} times: the stochastic family "
                             "runs the exact program")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"(o) B1 and B2 launches on the path: 0 and 0; path (o) took "
        f"{out['seconds']:.1f} s")
    return out


# --- Path (p): gang capacity and the certified LP optimizer ---------------
# (p1) the JAX bench's 1M-node hierarchical fleet (384 machine shapes, 4
# zones x 8 racks) with a 64-rank rack-colocated training gang; (p2) a
# heterogeneous 10,000-node fleet of the same hierarchy, strict, with a
# 64-rank zone gang spread at most 16 ranks a rack and a 16-rank rack gang
# with one rank a host; (p3) the JAX bench's optimizer config (10,000
# nodes, 48 shapes, 64 scenarios, half of them demanding 10^8 replicas).
GANG_SPREAD = {"ranks": 64, "colocate": "zone", "spread_level": "rack",
               "max_ranks_per_domain": 16}
GANG_ANTI = {"ranks": 16, "colocate": "rack", "anti_affinity_host": True}
GANG_POD = {"cpuRequests": "2", "memRequests": "8gb"}
# Requests of the service's LP solve on (p2)'s ungrouped fleet (16,384
# padded groups, the whole 20,000-step budget a solve), after the library's
# own solve as the warm-up; every other op of (p5) takes 20 after 3
# warm-ups.
OPT_SERVICE_RUNS = 3


def opt_bench_grid(pkg, s: int = 64):
    """The 64-scenario grid of the JAX bench's optimizer row (rng 23; even
    scenarios demand 10^8 replicas, odd ones 1-4,999)."""
    rng = np.random.default_rng(23)
    replicas = np.where(np.arange(s) % 2 == 0, 10**8,
                        rng.integers(1, 5000, s)).astype(np.int64)
    return pkg.ScenarioGrid(
        cpu_request_milli=rng.integers(100, 4000, s),
        mem_request_bytes=rng.integers(64 * 2**20, 4 * 2**30, s),
        replicas=replicas)


def labelled_strict(pkg, topo_mod, snap):
    """``snap`` as a strict snapshot whose node labels carry its attached
    zone/rack hierarchy (so a checkpoint of it keeps the hierarchy), with
    the attached codes memoized on it too."""
    topo = topo_mod.topology_from_snapshot(snap)
    keys = topo_mod.TopologyKeys()
    labels = [{keys.zone: f"zone-{z}", keys.rack: f"rack-{r}",
               keys.host: name}
              for z, r, name in zip(topo.zone_code.tolist(),
                                    topo.rack_code.tolist(), snap.names)]
    out = dataclasses.replace(snap, semantics="strict", labels=labels)
    topo_mod.attach_topology(out, topo.zone_code, topo.rack_code)
    return out


def exact_per_node_fits(snap, grid, mode: str, device) -> np.ndarray:
    """``[S, N]`` per-node fits from the exact ungrouped int64 program on
    ``device``."""
    from kubernetesclustercapacity_tpu_torch.ops.fit import sweep_grid

    dev = torch.device(device)
    cols = [torch.from_numpy(np.ascontiguousarray(getattr(snap, c))).to(dev)
            for c in ("alloc_cpu_milli", "alloc_mem_bytes", "alloc_pods",
                      "used_cpu_req_milli", "used_mem_req_bytes",
                      "pods_count", "healthy")]
    scen = [torch.from_numpy(np.asarray(a, dtype=np.int64)).to(dev)
            for a in (grid.cpu_request_milli, grid.mem_request_bytes,
                      grid.replicas)]
    return sweep_grid(*cols, *scen, mode=mode,
                      return_per_node=True)[2].cpu().numpy()


def gang_fields(res) -> tuple:
    return (res.to_wire(), res.largest_cap.tolist(), res.largest_domain,
            None if res.co_caps is None else res.co_caps.tolist(),
            res.co_domains)


def optimize_integers(res) -> dict:
    return {"demand": res.demand.tolist(), "rounded": res.rounded.tolist(),
            "ffd": res.ffd.tolist(), "ffd_totals": res.ffd_totals.tolist(),
            "schedulable": res.schedulable.tolist()}


def phase_gang_opt(pkg, cli, ff, fm, tmp: str, identity: str,
                   device: str = "cuda") -> dict:
    """Path (p): gang capacity and the certified optimizer through the
    library, the CLI and the service, each answer on the card held against
    the numpy oracle or its host run.

    (p1) ``gang_capacity`` of a 64-rank rack gang on the 1M-node fleet
    (grouped engine) equals ``gang_oracle`` over the exact ungrouped
    per-node fits.  (p2) the zone/rack spread gang and the rack gang with
    host anti-affinity (a ``[1000, 10000]`` int64 search state) on the
    10,000-node strict fleet x 1,000 scenarios (per-node engine) equal
    ``gang_oracle`` and the ``device="cpu"`` run; ``gang_explain`` of
    scenario 0 equals the host's.  (p3) ``optimize_snapshot`` at the
    bench's config is certified and verified, ``rounded == ffd``, its
    integers equal the host run's and its bound is within tol of
    ``lp_bound_oracle``; the same fleet ungrouped (16,384 padded groups)
    too.  (p4) ``-gang-spec`` and ``-optimize`` (one spec, ``-grid 64``,
    ``-opt-backend ffd``) on both fleets as ``.npz`` equal their
    ``-device cpu`` runs.  (p5) a server on (p2)'s fleet answers ``gang``
    and ``optimize`` as the library does.  Kernels B1 and B2 are not on
    this path (the exact int64 program answers, as in the JAX package),
    so both launch 0 times."""
    from kubernetesclustercapacity_tpu_torch import optimize, topology
    from kubernetesclustercapacity_tpu_torch.audit.log import (
        canonical_result_digest,
    )
    from kubernetesclustercapacity_tpu_torch.service import (
        CapacityClient,
        CapacityServer,
    )

    out = {"ms": {}, "launches": {"sweep_fit": {}, "sweep_multi": {}},
           "opt": {}}

    def timed(name, fn, runs=5, warmup=1):
        out["ms"][name] = host_median_ms(fn, runs=runs, warmup=warmup)
        return out["ms"][name]

    t_phase = time.perf_counter()
    ff.LAUNCHES = fm.LAUNCHES = 0

    # (p1) the 1M-node grouped gang.
    big = pkg.synthetic_snapshot(1_000_000, seed=21, shapes=384,
                                 topology=(4, 8))
    grid4 = pkg.random_scenario_grid(4, seed=777)
    spec = topology.GangSpec(ranks=64, colocate="rack")
    res = topology.gang_capacity(big, grid4, spec, mode="reference",
                                 device=device)
    if res.engine != "grouped":
        raise AssertionError(f"(p1) engine {res.engine}, want grouped")
    fits = exact_per_node_fits(big, grid4, "reference", device)
    want = topology.gang_oracle(fits, topology.topology_from_snapshot(big),
                                spec)
    if res.gangs.tolist() != want:
        raise AssertionError(f"(p1) gangs {res.gangs.tolist()} != oracle "
                             f"{want}")
    t = timed("(p1) gang 1M x 4 grouped", lambda: topology.gang_capacity(
        big, grid4, spec, mode="reference", device=device))
    log(f"(p1) gang_capacity 64-rank rack gang, 1,000,000 nodes "
        f"({pkg.grouped_for_dispatch(big).n_groups} groups, 32 racks) x 4: "
        f"gangs {res.gangs.tolist()} = gang_oracle over the exact per-node "
        f"fits, engine grouped, {t:.3f} ms median ({identity})")
    del fits, big

    # (p2) the per-node engine with the spread searches, 10k x 1k strict.
    fleet = labelled_strict(pkg, topology, pkg.synthetic_snapshot(
        10_000, seed=12, topology=(4, 8)))
    if pkg.grouped_for_dispatch(fleet) is not None:
        os.environ["KCCAP_GANG_GROUPED"] = "0"
    grid = pkg.random_scenario_grid(1000, seed=12)
    fits = exact_per_node_fits(fleet, grid, "strict", device)
    topo = topology.topology_from_snapshot(fleet)
    for name, kw in (("zone/rack spread", GANG_SPREAD),
                     ("rack + host anti-affinity", GANG_ANTI)):
        spec = topology.GangSpec(**kw)
        res = topology.gang_capacity(fleet, grid, spec, device=device)
        host = topology.gang_capacity(fleet, grid, spec, device="cpu")
        if res.engine != "per-node":
            raise AssertionError(f"(p2) {name}: engine {res.engine}")
        if gang_fields(res) != gang_fields(host):
            raise AssertionError(f"(p2) {name}: the card differs from the "
                                 "host run")
        if res.gangs.tolist() != topology.gang_oracle(fits, topo, spec):
            raise AssertionError(f"(p2) {name}: differs from gang_oracle")
        ex = topology.gang_explain(fleet, grid, spec, device=device)
        if ex != topology.gang_explain(fleet, grid, spec, device="cpu"):
            raise AssertionError(f"(p2) {name}: gang_explain differs")
        t = timed(f"(p2) gang 10k x 1k {name}",
                  lambda: topology.gang_capacity(fleet, grid, spec,
                                                 device=device))
        if device != "cpu" and kw is GANG_ANTI:
            out["trace_gang"] = phase_trace(
                lambda: topology.gang_capacity(fleet, grid, spec,
                                               device=device),
                "elementwise", t, runs=5)
        log(f"(p2) gang_capacity {name} 10,000 nodes x 1,000 strict: "
            f"{int(res.gangs.sum())} gangs in all, {int(res.schedulable.sum())}"
            f" scenarios schedulable, = gang_oracle and the host run; "
            f"scenario 0 binds at {ex['binding']}; {t:.3f} ms median "
            f"({identity})")
    os.environ.pop("KCCAP_GANG_GROUPED", None)
    del fits

    # (p3) the optimizer at the JAX bench's config; then the same fleet
    # with grouping off (10,000 groups padded to 16,384).  The ungrouped
    # solve is held to the grouped one's integers and to a valid bound: its
    # host run would take minutes of CPU.
    opt_fleet = dataclasses.replace(pkg.synthetic_snapshot(
        10_000, seed=23, shapes=48), semantics="strict")
    opt_grid = opt_bench_grid(pkg)
    truth = optimize.lp_bound_oracle(opt_fleet, opt_grid)
    grouped_res = None
    for label, grouping in (("grouped", "1"), ("ungrouped", "0")):
        os.environ["KCCAP_GROUPING"] = grouping
        try:
            t0 = time.perf_counter()
            res = optimize.optimize_snapshot(opt_fleet, opt_grid,
                                             verify=True, device=device)
            t = (time.perf_counter() - t0) * 1e3
            host = (optimize.optimize_snapshot(opt_fleet, opt_grid,
                                               verify=True, device="cpu")
                    if grouping == "1" else grouped_res)
        finally:
            os.environ.pop("KCCAP_GROUPING", None)
        if not res.verified.all():
            raise AssertionError(f"(p3) {label}: rounding not verified")
        if not np.array_equal(res.rounded, res.ffd):
            raise AssertionError(f"(p3) {label}: rounded != ffd")
        if optimize_integers(res) != optimize_integers(host) or \
                canonical_result_digest("optimize", res.to_wire()) != \
                canonical_result_digest("optimize", host.to_wire()):
            raise AssertionError(f"(p3) {label}: integers differ from the "
                                 "host run")
        rel = np.abs(res.lp_bound - truth) / np.maximum(np.abs(truth), 1.0)
        if (rel[res.certified] > res.tol * 4).any() or \
                (res.lp_bound < truth * (1.0 - res.tol) - 1e-6).any():
            raise AssertionError(f"(p3) {label}: bound off the oracle")
        if grouping == "1":
            if not res.all_certified:
                raise AssertionError("(p3) grouped: not certified")
            grouped_res = res
            if device != "cpu":
                def solve():  # one 500-step chunk and its certificate
                    return optimize.optimize_snapshot(
                        opt_fleet, opt_grid, verify=False, max_iters=500,
                        device=device)

                out["trace_opt"] = phase_trace(
                    solve, "elementwise",
                    host_median_ms(solve, runs=1, warmup=0), runs=1)
        out["opt"][label] = {"iterations": res.iterations,
                             "groups": res.groups, "solve_ms": t,
                             "certified": int(res.certified.sum()),
                             "host_iterations": host.iterations,
                             "bound_rel_err": float(rel.max())}
        out["ms"][f"(p3) optimize {label}"] = t
        log(f"(p3) optimize_snapshot {label}: {res.groups} groups, "
            f"{res.iterations} iterations (host {host.iterations}), "
            f"{int(res.certified.sum())}/64 certified, verified, rounded == "
            f"ffd, integers = the host run, bound within "
            f"{float(rel.max()):.2e} of lp_bound_oracle, {t:.1f} ms once "
            f"({identity})")

    # (p4) the CLI on both fleets as .npz, against -device cpu.
    fleet_npz = os.path.join(tmp, "fleet.npz")
    fleet.save(fleet_npz)
    opt_npz = os.path.join(tmp, "opt.npz")
    opt_fleet.save(opt_npz)
    gang_path = os.path.join(tmp, "gang.json")
    with open(gang_path, "w") as f:
        json.dump({"pod": GANG_POD, "gang": GANG_SPREAD}, f)
    spec_flags = ["-cpuRequests=500m", "-memRequests=1gb",
                  "-replicas=100000000"]
    argvs = {
        "-gang-spec json": ["-snapshot", fleet_npz, "-gang-spec", gang_path,
                            "-output", "json"],
        "-gang-spec table": ["-snapshot", fleet_npz, "-gang-spec", gang_path],
        "-optimize": ["-snapshot", opt_npz, "-optimize", "-output", "json",
                      *spec_flags],
        "-optimize -grid 64": ["-snapshot", opt_npz, "-optimize", "-grid",
                               "64", "-output", "json"],
        "-opt-backend ffd": ["-snapshot", opt_npz, "-optimize",
                             "-opt-backend", "ffd", "-output", "json",
                             *spec_flags],
    }
    for name, argv in argvs.items():
        t0 = time.perf_counter()
        rc, text = run_cli_rc(cli, argv + ["-device", device])
        out["ms"][f"(p4) {name}"] = (time.perf_counter() - t0) * 1e3
        rc_host, text_host = run_cli_rc(cli, argv + ["-device", "cpu"])
        if rc != rc_host or not text:
            raise AssertionError(f"(p4) {name}: exit {rc} vs {rc_host}")
        if name.startswith("-gang-spec") or "ffd" in name:
            same = text == text_host
        else:
            got, want = json.loads(text), json.loads(text_host)
            same = (canonical_result_digest("optimize", got)
                    == canonical_result_digest("optimize", want)
                    and all(got[k] == want[k] for k in (
                        "demand", "rounded", "ffd", "schedulable")))
        if not same:
            raise AssertionError(f"(p4) {name}: the card's output differs "
                                 "from -device cpu")
        log(f"(p4) CLI {name}: exit {rc}, = the -device cpu run, "
            f"{out['ms'][f'(p4) {name}']:.1f} ms ({identity})")

    # (p5) the service on (p2)'s fleet.
    server = CapacityServer(fleet, device=device, batch_window_ms=0)
    server.start()
    try:
        with CapacityClient(*server.address, connect_timeout_s=60,
                            timeout_s=600, retry=None) as client:
            one = pkg.ScenarioGrid.from_scenarios([pkg.scenario_from_flags(
                cpuRequests="2", memRequests="8gb", replicas="1")])
            lib_one = topology.gang_capacity(
                fleet, one, topology.GangSpec(**GANG_SPREAD),
                device=device).to_wire()
            lib_one["explain"] = topology.gang_explain(
                fleet, one, topology.GangSpec(**GANG_SPREAD), device=device)
            lib_grid = topology.gang_capacity(
                fleet, grid, topology.GangSpec(**GANG_SPREAD),
                device=device).to_wire()
            arrays = {"cpu_request_milli": grid.cpu_request_milli.tolist(),
                      "mem_request_bytes": grid.mem_request_bytes.tolist(),
                      "replicas": grid.replicas.tolist()}
            opt_arrays = {
                "cpu_request_milli": opt_grid.cpu_request_milli.tolist(),
                "mem_request_bytes": opt_grid.mem_request_bytes.tolist(),
                "replicas": opt_grid.replicas.tolist()}
            lib_opt = optimize.optimize_snapshot(fleet, opt_grid,
                                                 device=device).to_wire()
            digest = canonical_result_digest
            ops = {
                "gang explain": (lambda: client.gang(**GANG_SPREAD,
                                                     **GANG_POD),
                                 lambda r: r == lib_one, 20),
                "gang 1000": (lambda: client.gang(**GANG_SPREAD, **arrays),
                              lambda r: r == lib_grid, 20),
                "gang status": (lambda: client.gang(),
                                lambda r: r == {"enabled": False,
                                                "watches": {},
                                                "breached": []}, 20),
                "optimize lp 64": (
                    lambda: client.optimize(**opt_arrays),
                    lambda r: digest("optimize", r) == digest(
                        "optimize", lib_opt), OPT_SERVICE_RUNS),
                "optimize ffd 64": (
                    lambda: client.optimize(backend="ffd", **opt_arrays),
                    lambda r: r["ffd"] == lib_opt["ffd"], 20),
            }
            for name, (call, check, runs) in ops.items():
                res = timed_requests(call, runs=runs,
                                     warmup=3 if runs == 20 else 0)
                if not check(res["reply"]):
                    raise AssertionError(f"(p5) {name}: the reply differs "
                                         "from the library call")
                out["ms"][f"(p5) {name}"] = res["median_ms"]
                out["ms"][f"(p5) {name} p90"] = res["p90_ms"]
                log(f"(p5) service {name}: = the library call, "
                    f"{res['median_ms']:.3f} ms median, p90 "
                    f"{res['p90_ms']:.3f} (host clock, {runs} warm "
                    f"requests; {identity})")
        addr = f"{server.address[0]}:{server.address[1]}"
        rc, text = run_cli_rc(cli, ["-gang", addr])
        if rc != 1 or "no gang watches" not in text:
            raise AssertionError(f"(p5) -gang rendered {text!r}, exit {rc}")
        log("(p5) status form: no watches; -gang renders it and exits 1")
    finally:
        server.shutdown()

    out["launches"]["sweep_fit"]["(p)"] = ff.LAUNCHES
    out["launches"]["sweep_multi"]["(p)"] = fm.LAUNCHES
    if ff.LAUNCHES or fm.LAUNCHES:
        raise AssertionError(f"(p) B1 launched {ff.LAUNCHES}, B2 "
                             f"{fm.LAUNCHES} times: gang and optimize run "
                             "the exact program")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"(p) B1 and B2 launches on the path: 0 and 0; path (p) took "
        f"{out['seconds']:.1f} s")
    return out


# --- Path (q): the operator's view of a running server -------------------
# (m)'s cluster (5,000 nodes, 148,991 pods, the 600-event churn stream of
# seed 9) as a seeded copy whose nodes carry a zone and a rack label, 4
# zones x 8 racks as in (p2), served by one strict -follow server with a
# watchlist, a capacity timeline, an SLO monitor and a metrics endpoint.
OPS_TOPOLOGY = (4, 8)
OPS_SPEC = {"cpuRequests": "200m", "cpuLimits": "400m",
            "memRequests": "250mb", "memLimits": "500mb", "replicas": "5000"}
OPS_POD = {"cpuRequests": "500m", "memRequests": "1gb", "replicas": "200"}
OPS_CPU_USAGE = {"dist": "normal", "mean": "500m", "std": "200m"}
OPS_MEM_USAGE = {"dist": "lognormal", "mean": "4gb", "sigma": 1.0}
OPS_SLOS = {"slos": [
    {"name": "sweep-latency", "op": "sweep", "latency": "p99 < 1000ms"},
    {"name": "sweep-availability", "op": "sweep", "availability": "99.9%"},
]}
OPS_WARM_REQUESTS = 20
STATE_CODES = {"ok": 0, "recovered": 1, "breached": 2}


def operator_fixture(pkg) -> dict:
    """(m)'s source cluster, built anew, with each node labelled with a
    zone and a rack (``topology.kubernetes.io/zone`` and ``/rack``, drawn
    from seed 13 over 4 zones x 8 racks)."""
    fixture = live_fixture_source(pkg)
    rng = np.random.default_rng(13)
    zones = rng.integers(0, OPS_TOPOLOGY[0], len(fixture["nodes"]))
    racks = rng.integers(0, OPS_TOPOLOGY[1], len(fixture["nodes"]))
    for node, z, r in zip(fixture["nodes"], zones, racks):
        node["labels"] = dict(node.get("labels") or {}, **{
            "topology.kubernetes.io/zone": f"zone-{int(z)}",
            "topology.kubernetes.io/rack": f"rack-{int(r)}"})
    return fixture


def operator_segments(events: list[dict]) -> tuple[list, list]:
    """The churn stream in two segments: first the 192 pods it adds (every
    capacity can only fall), then the rest in the stream's order (pods
    deleted and finished, nodes modified, removed and added).  The object
    sets are disjoint, so the final state is the stream's."""
    added = [e for e in events if e["kind"] == "Pod" and e["type"] == "ADDED"]
    rest = [e for e in events
            if not (e["kind"] == "Pod" and e["type"] == "ADDED")]
    return added, rest


def gated_watch_streams(first: list[dict], second: list[dict]):
    """``(streams, gates)`` for :class:`MockApiserver`: each path's watch
    windows in the REST schema (resourceVersions rising across both
    segments), the first window of ``second`` on each path gated by one
    shared event, so the script decides when the second segment is
    sent."""
    release = threading.Event()
    windows = {NODES_PATH: [], PODS_PATH: []}
    gates: dict = {NODES_PATH: {}, PODS_PATH: {}}
    rv = 10_000
    for k, segment in enumerate((first, second)):
        by_path = {NODES_PATH: [], PODS_PATH: []}
        for e in segment:
            obj = k8s_node(e["object"]) if e["kind"] == "Node" else \
                k8s_pod(e["object"])
            obj["metadata"]["resourceVersion"] = str(rv)
            rv += 1
            by_path[NODES_PATH if e["kind"] == "Node" else PODS_PATH].append(
                {"type": e["type"], "object": obj})
        for path, evs in by_path.items():
            if evs:
                if k == 1:
                    gates[path][len(windows[path])] = release
                windows[path].append(evs)
    return windows, gates, release


def operator_watchlist(plain: dict, totals: dict | None = None) -> list:
    """The eight watches.  ``plain`` holds the pods and thresholds of the
    two thresholded plain watches (``recover``: breached by the stream's
    first segment and recovered by its second; ``advisory``: breached
    throughout).  ``totals`` maps the capacity-at-risk and gang watches to
    their totals before the stream; each threshold sits there, so the
    first segment breaches them."""
    def at(name):
        return {"min_replicas": totals[name]} if totals else {}

    return [
        {"name": "spec-reference", "pod": dict(OPS_SPEC),
         "semantics": "reference"},
        {"name": "spec-strict", "pod": dict(OPS_SPEC),
         "semantics": "strict"},
        {"name": "recover", **plain["recover"]},
        {"name": "advisory", **plain["advisory"]},
        {"name": "car-p95", "pod": dict(OPS_POD), "quantile": 0.95,
         "usage": {"cpu": dict(OPS_CPU_USAGE)}, "samples": 1024, "seed": 11,
         **at("car-p95")},
        {"name": "car-memory", "pod": dict(OPS_POD), "quantile": 0.95,
         "usage": {"memory": dict(OPS_MEM_USAGE)}, "samples": 1024,
         "seed": 12},
        {"name": "forecast", "pod": dict(OPS_POD), "quantile": 0.95,
         "usage": {"cpu": dict(OPS_CPU_USAGE)}, "samples": 256, "seed": 13,
         "horizon": {"steps": 8, "step_s": 3600}, "min_replicas": 1},
        {"name": "gang-rack-64", "pod": {"cpuRequests": "2",
                                         "memRequests": "8gb"},
         "gang": {"ranks": 64, "colocate": "rack"}, **at("gang-rack-64")},
    ]


_SCRAPE_SAMPLE = re.compile(r'^(kccap_[a-z_]+)(?:\{watch="([^"]*)"\})? (\S+)')


def scrape_values(text: str) -> dict:
    """``{(family, watch): value}`` of the scrape's unlabeled and
    watch-labelled samples."""
    out = {}
    for line in text.splitlines():
        m = _SCRAPE_SAMPLE.match(line)
        if m:
            out[(m.group(1), m.group(2))] = float(m.group(3))
    return out


def expected_gauges(timeline, specs) -> dict:
    """The gauges the timeline's last record and alerts must have set."""
    last = timeline.records()[-1]
    alerts = timeline.alerts()
    out = {("kccap_generation", None): float(last.generation)}
    for spec in specs:
        r = last.watches[spec.name]
        code = float(STATE_CODES[alerts[spec.name]["state"]])
        out[("kccap_watch_replicas", spec.name)] = float(r.total)
        out[("kccap_watch_alert_state", spec.name)] = code
        threshold = spec.min_replicas or spec.scenario.replicas
        out[("kccap_watch_headroom_pct", spec.name)] = round(
            100.0 * (r.total - threshold) / threshold, 4)
        if spec.gang is not None:
            out[("kccap_gang_capacity", spec.name)] = float(r.total)
            out[("kccap_gang_alert_state", spec.name)] = code
        elif spec.horizon_steps is not None:
            out[("kccap_forecast_capacity", spec.name)] = float(
                r.horizon_min_capacity if r.horizon_min_capacity is not None
                else r.total)
            out[("kccap_forecast_time_to_breach_seconds", spec.name)] = (
                round(r.time_to_breach_s, 3)
                if r.time_to_breach_s is not None else -1.0)
            out[("kccap_forecast_alert_state", spec.name)] = code
        elif spec.quantile is not None:
            out[("kccap_car_replicas", spec.name)] = float(r.total)
            out[("kccap_car_prob_fit", spec.name)] = round(r.prob_fit, 6)
            out[("kccap_car_alert_state", spec.name)] = code
    return out


def healthz_probe(url: str, stage: str) -> dict:
    """One /healthz read: its code must be 503 exactly while the body
    names a breached capacity-at-risk, forecast, gang watch or SLO, and
    the device ledger's leak alert must not have tripped."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            code, body = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, body = e.code, json.loads(e.read())
    tl = body.get("timeline", {})
    breached = (tl.get("car_breached", []) + tl.get("gang_breached", [])
                + tl.get("forecast_breached", [])
                + body.get("slo", {}).get("breached", []))
    leak = body.get("device_memory", {}).get("leak_alert", {})
    if leak.get("state") == "breached":
        raise AssertionError(f"(q) /healthz {stage}: the device ledger's "
                             f"leak alert tripped: {body['device_memory']}")
    if code != (503 if breached else 200):
        raise AssertionError(f"(q) /healthz {stage} answered {code} with "
                             f"breached {breached}: {body}")
    return {"stage": stage, "code": code, "breached": breached,
            "plain_breached": sorted(set(tl.get("breached", []))
                                     - set(breached))}


def ms_stats(values) -> dict:
    """Median, max and n; the p90 too from 10 values on."""
    values = sorted(values)
    out = {"median": statistics.median(values), "max": values[-1],
           "n": len(values)}
    if len(values) >= 10:
        out["p90"] = values[int(math.ceil(0.9 * len(values))) - 1]
    return out


def fmt_stats(st: dict) -> str:
    tail = f"p90 {st['p90']:.3f}" if "p90" in st else f"max {st['max']:.3f}"
    return f"median {st['median']:.3f} {tail} (n={st['n']})"


def poll_until(client, grid_msg: dict, want: list, timeout_s: float = 300):
    """Sweep until a reply's totals equal ``want``; returns the host clock
    of that reply and the number of sweeps."""
    polls = 0
    deadline = time.perf_counter() + timeout_s
    while True:
        doc = client.sweep(**grid_msg)
        answered = time.perf_counter()
        polls += 1
        if doc["totals"] == want:
            return answered, polls, doc
        if time.perf_counter() > deadline:
            raise AssertionError(f"(q): no sweep answered the expected "
                                 f"state within {timeout_s} s")
        time.sleep(0.001)


def control_staleness(ff, fixture, first, second, grid_msg, ends,
                      slo_path: str) -> dict:
    """The staleness of (q)'s two gated segments against the same server
    without a timeline: (q)'s cluster, stream, gates, polling sweeps and
    SLO monitor, with ``timeline=None``.  Returns the staleness in ms, the
    sweeps polled in the second segment and B1's launches (once a
    poll)."""
    from kubernetesclustercapacity_tpu_torch import kubeapi
    from kubernetesclustercapacity_tpu_torch.follower import ClusterFollower
    from kubernetesclustercapacity_tpu_torch.service import (
        CapacityClient,
        CapacityServer,
    )
    from kubernetesclustercapacity_tpu_torch.service.server import (
        follow_publisher,
    )
    from kubernetesclustercapacity_tpu_torch.telemetry import slo as slo_mod
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
        MetricsRegistry,
    )
    from kubernetesclustercapacity_tpu_torch.telemetry.process import (
        register_process_metrics,
    )

    reg = MetricsRegistry()
    register_process_metrics(reg)
    monitor = slo_mod.SLOMonitor(slo_mod.load_slos(slo_path), registry=reg)
    streams, gates, release = gated_watch_streams(first, second)
    mock = MockApiserver(fixture, streams, gates)
    cfg = kubeapi.KubeConfig(mock.url, token=LIVE_TOKEN)
    follower = server = coalescer = None
    try:
        ff.LAUNCHES = 0
        follower = ClusterFollower(
            client_factory=lambda: kubeapi.KubeClient(cfg),
            stop_on_idle_window=True, semantics="strict",
            extended_resources=EXTENDED, registry=reg).start(watch=False)
        monitor.start(5.0)
        server = CapacityServer(follower.snapshot(),
                                fixture=follower.fixture_view(),
                                device="cuda", batch_window_ms=0,
                                registry=reg, stats_source=follower.stats,
                                slo=monitor)
        server.start()
        with CapacityClient(*server.address, connect_timeout_s=60,
                            timeout_s=600, retry=None) as c:
            c.sweep(**grid_msg)
            coalescer, publish_fatal = follow_publisher(server, follower,
                                                        coalesce_ms=100)
            _, polls_a, _ = poll_until(c, grid_msg, ends[1].tolist())
            first_written = mock.stream_written[PODS_PATH]
            release.set()
            answered, polls_b, _ = poll_until(c, grid_msg, ends[2].tolist())
            while NODES_PATH not in mock.stream_written or \
                    mock.stream_written[PODS_PATH] == first_written:
                time.sleep(0.001)
            written = max(mock.stream_written.values())
            follower.join(300)
            if not coalescer.stop(timeout=300):
                raise AssertionError("(q) control: the coalescer did not "
                                     "drain")
            if coalescer.last_error is not None or follower.fatal \
                    is not None or publish_fatal:
                raise AssertionError(f"(q) control: publish error "
                                     f"{coalescer.last_error}, follower "
                                     f"fatal {follower.fatal}, "
                                     f"{publish_fatal}")
        polls = polls_a + polls_b + 1
        if ff.LAUNCHES != polls:
            raise AssertionError(f"(q) control: {polls} sweeps launched B1 "
                                 f"{ff.LAUNCHES} times")
        return {"staleness_ms": (answered - written) * 1e3,
                "polls_second": polls_b, "launches": ff.LAUNCHES,
                "generations": server.generation}
    finally:
        release.set()
        if follower is not None:
            follower.stop()
        if coalescer is not None:
            coalescer.stop(timeout=60)
        if server is not None:
            server.shutdown()
        monitor.close()
        mock.close()


def phase_operator(pkg, cli, fit, ff, fm, tmp: str, identity: str,
                   m3_staleness_ms) -> dict:
    """Path (q): the operator's view of a running server.

    One strict ``-follow`` server on the card over the (q) cluster
    behind the mock apiserver, with a watchlist of eight watches (two
    plain watches of (g)'s spec, reference and strict; two thresholded
    plain watches; capacity at risk at P95 of 1,024 samples on cpu and on
    memory usage; a forecast of 8 steps x 256 samples; a 64-rank rack
    gang), a 64-deep timeline writing its JSONL log, an SLO monitor (a
    latency and an availability objective on ``sweep``) and a metrics
    endpoint on an ephemeral port with ``healthz_probes``.  It takes the
    churn stream on its watch in two segments (the pods it adds, then the
    rest) while sweeps poll (B1 once each), then answers ``sweep_multi``
    (B2 once), the ``timeline``, ``dump`` and ``slo`` ops and the CLI's
    ``-timeline``, ``-dump`` and ``-slo-status``.  Checks: one timeline
    record per published generation (the log too); each plain watch's
    total equals B1's sweep, the exact program and the host oracle of that
    generation's snapshot; every record equals a
    ``CapacityTimeline(device="cpu")`` fed the same snapshots and
    timestamps; the scrape's watch gauges equal the last record; /healthz
    answers 503 exactly while a capacity-at-risk, forecast or gang watch
    is breached, and flips; the first segment breaches the ``recover``
    watch and the second recovers it; the ops and the CLI answer as the
    JAX package's rules say."""
    from kubernetesclustercapacity_tpu_torch import kubeapi
    from kubernetesclustercapacity_tpu_torch.follower import ClusterFollower
    from kubernetesclustercapacity_tpu_torch.masks import implicit_taint_mask
    from kubernetesclustercapacity_tpu_torch.oracle import fit_arrays_python
    from kubernetesclustercapacity_tpu_torch.service import (
        CapacityClient,
        CapacityServer,
    )
    from kubernetesclustercapacity_tpu_torch.service.server import (
        follow_publisher,
        healthz_probes,
    )
    from kubernetesclustercapacity_tpu_torch.store import ClusterStore
    from kubernetesclustercapacity_tpu_torch.telemetry import slo as slo_mod
    from kubernetesclustercapacity_tpu_torch.telemetry.exposition import (
        start_metrics_server,
    )
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
        MetricsRegistry,
    )
    from kubernetesclustercapacity_tpu_torch.telemetry.process import (
        register_process_metrics,
    )
    from kubernetesclustercapacity_tpu_torch.timeline import (
        CapacityTimeline,
        load_watchlist,
        parse_watchlist,
    )
    from kubernetesclustercapacity_tpu_torch.utils.quantity import int64_bits

    device = "cuda"
    b1_label = "cuda_i32_rcp_fused"
    out: dict = {"launches": {"sweep_fit": {}, "sweep_multi": {}}}
    t_phase = time.perf_counter()
    fixture = operator_fixture(pkg)
    events = churn_events(fixture)
    first, second = operator_segments(events)
    grid = pkg.random_scenario_grid(1000, seed=7)
    grid_msg = {"random": {"n": 1000, "seed": 7}}
    mirror = ClusterStore(fixture, semantics="strict",
                          extended_resources=EXTENDED)
    states = [mirror.snapshot()]
    for segment in (first, second):
        mirror.apply(segment)
        states.append(mirror.snapshot())
    ends = [ff.sweep_snapshot_auto(s, grid, mode="strict", kernel="exact",
                                   node_mask=implicit_taint_mask(s),
                                   device=device)[0].astype(np.int64)
            for s in states]
    log(f"(q) source: {len(fixture['nodes'])} nodes ({OPS_TOPOLOGY[0]} "
        f"zones x {OPS_TOPOLOGY[1]} racks), {len(fixture['pods'])} pods, "
        f"{len(events)} churn events in two segments ({len(first)} pods "
        f"added, then {len(second)}), built in "
        f"{time.perf_counter() - t_phase:.2f} s")

    # The thresholds.  ``recover`` takes the grid's spec that the first
    # segment lowers most below both ends, its threshold at the lower
    # end; ``advisory`` a spec above all three totals.  The capacity-at-
    # risk and gang watches sit at their totals before the stream.
    dip = np.minimum(ends[0], ends[2]) - ends[1]
    i_dip = int(np.argmax(dip))
    if dip[i_dip] <= 0:
        raise AssertionError("(q): the first segment lowers no spec of the "
                             "grid below both ends of the stream")
    i_adv = int(np.argmin(ends[0]))

    def pod(i):
        return {"cpuRequests": f"{int(grid.cpu_request_milli[i])}m",
                "memRequests": f"{int(grid.mem_request_bytes[i]) // MIB}mb"}

    plain = {
        "recover": {"pod": pod(i_dip),
                    "min_replicas": int(min(ends[0][i_dip], ends[2][i_dip]))},
        "advisory": {"pod": pod(i_adv),
                     "min_replicas": int(max(e[i_adv] for e in ends)) + 1},
    }
    probe = CapacityTimeline(parse_watchlist(operator_watchlist(plain)),
                             device=device)
    recs = [probe.observe(s, g, ts=float(g))
            for g, s in enumerate(states[:2], start=1)]
    totals = {name: recs[0].watches[name].total
              for name in ("car-p95", "gang-rack-64")}
    if all(recs[1].watches[n].total >= t for n, t in totals.items()):
        raise AssertionError(f"(q): the first segment lowers neither the "
                             f"capacity-at-risk nor the gang watch "
                             f"({totals}); /healthz could not flip")
    watch_path = os.path.join(tmp, "q_watch.json")
    with open(watch_path, "w") as f:
        json.dump({"watches": operator_watchlist(plain, totals)}, f)
    slo_path = os.path.join(tmp, "q_slo.json")
    with open(slo_path, "w") as f:
        json.dump(OPS_SLOS, f)
    timeline_log = os.path.join(tmp, "q_timeline.jsonl")
    slo_log = os.path.join(tmp, "q_slo.jsonl")
    log(f"(q) thresholds: 'recover' {plain['recover']} (totals before, "
        f"between and after the segments {[int(e[i_dip]) for e in ends]}), "
        f"'advisory' {plain['advisory']}, at their totals before the "
        f"stream {totals}")

    # The control: the same segments against the server without the
    # timeline, so the two staleness figures differ in the watchlist alone.
    control = control_staleness(ff, fixture, first, second, grid_msg, ends,
                                slo_path)
    out["launches"]["sweep_fit"]["(q) control: sweeps polled without the "
                                 "timeline, and the first"] = \
        control["launches"]
    log(f"(q) control without the timeline: {control['generations']} "
        f"generations published; staleness {control['staleness_ms']:.3f} "
        f"ms ({control['polls_second']} sweeps polled in the second "
        f"segment) ({identity})")

    reg = MetricsRegistry()
    register_process_metrics(reg)
    specs = load_watchlist(watch_path)
    timeline = CapacityTimeline(specs, depth=64, registry=reg,
                                log=timeline_log, device=device)
    captured: list[tuple] = []  # (generation, snapshot, ts, host clock)
    observe = timeline.observe

    def observe_spy(snapshot, generation, **kw):
        record = observe(snapshot, generation, **kw)
        captured.append((generation, snapshot, record.ts,
                         time.perf_counter()))
        return record

    def settled(server):
        """Wait until the timeline has observed the served snapshot."""
        deadline = time.perf_counter() + 300
        while not captured or captured[-1][1] is not server.snapshot:
            if time.perf_counter() > deadline:
                raise AssertionError("(q): the timeline did not observe "
                                     "the served snapshot within 300 s")
            time.sleep(0.005)

    timeline.observe = observe_spy
    monitor = slo_mod.SLOMonitor(slo_mod.load_slos(slo_path), registry=reg,
                                 log=slo_log)
    streams, gates, release = gated_watch_streams(first, second)
    mock = MockApiserver(fixture, streams, gates)
    cfg = kubeapi.KubeConfig(mock.url, token=LIVE_TOKEN)
    follower = server = metrics = coalescer = None
    probes = []
    try:
        ff.LAUNCHES = fm.LAUNCHES = 0
        follower = ClusterFollower(
            client_factory=lambda: kubeapi.KubeClient(cfg),
            stop_on_idle_window=True, semantics="strict",
            extended_resources=EXTENDED, registry=reg).start(watch=False)
        monitor.start(5.0)
        server = CapacityServer(follower.snapshot(),
                                fixture=follower.fixture_view(),
                                device=device, batch_window_ms=0,
                                registry=reg, stats_source=follower.stats,
                                timeline=timeline, slo=monitor)
        server.start()
        coalescers: list = []
        healthy, status = healthz_probes(server, follower=follower,
                                         coalescers=coalescers,
                                         timeline=timeline, slo=monitor)
        metrics = start_metrics_server(reg, healthy=healthy, status=status)
        healthz_url = metrics.url + "/healthz"
        probes.append(healthz_probe(healthz_url, "before the stream"))
        addr = f"{server.address[0]}:{server.address[1]}"
        with CapacityClient(*server.address, connect_timeout_s=60,
                            timeout_s=600, retry=None) as c:
            c.sweep(**grid_msg)  # stage generation 1
            coalescer, publish_fatal = follow_publisher(server, follower,
                                                        coalesce_ms=100)
            coalescers.append(coalescer)
            _, polls_a, _ = poll_until(c, grid_msg, ends[1].tolist())
            settled(server)
            probes.append(healthz_probe(healthz_url, "after the pods added"))
            first_written = mock.stream_written[PODS_PATH]
            release.set()
            answered, polls_b, doc = poll_until(c, grid_msg,
                                                ends[2].tolist())
            probes.append(healthz_probe(healthz_url, "under the publishes"))
            while NODES_PATH not in mock.stream_written or \
                    mock.stream_written[PODS_PATH] == first_written:
                time.sleep(0.001)  # the mock's clock of its last write
            written = max(mock.stream_written.values())
            staleness_ms = (answered - written) * 1e3
            follower.join(300)
            if not coalescer.stop(timeout=300):
                raise AssertionError("(q): the coalescer did not drain")
            if coalescer.last_error is not None or follower.fatal \
                    is not None or publish_fatal:
                raise AssertionError(f"(q): publish error "
                                     f"{coalescer.last_error}, follower "
                                     f"fatal {follower.fatal}, "
                                     f"{publish_fatal}")
            settled(server)
            timeline_staleness_ms = (captured[-1][3] - written) * 1e3
            rng = np.random.default_rng(4)
            resources = ("cpu", "memory", *EXTENDED)
            reqs = np.stack([grid.cpu_request_milli, grid.mem_request_bytes,
                             rng.integers(0, 3, grid.size),
                             rng.integers(1, 20, grid.size) * GIB], axis=1)
            mdoc = c.sweep_multi(list(resources), reqs.tolist(),
                                 replicas=grid.replicas.tolist())
            probes.append(healthz_probe(healthz_url, "after the stream"))
            # The ops, 20 warm requests each, then the dump's filters.
            ops = {}
            for name, call in (("timeline", c.timeline),
                               ("slo", c.slo_status),
                               ("dump", lambda: c.dump(limit=20))):
                ops[name] = timed_requests(call, runs=OPS_WARM_REQUESTS)
            try:
                c.timeline(watch="no-such-watch")
            except RuntimeError as e:
                if "unknown watch" not in str(e):
                    raise
            else:
                raise AssertionError("(q): timeline of an unknown watch "
                                     "answered")
            dumps = {
                "last": c.dump(limit=3),
                "sweep_multi": c.dump(op="sweep_multi"),
                "errors": c.dump(status="error"),
                "tenant": c.dump(tenant="default"),
                "sampled": c.dump(sampled=True),
            }
            slo_reply = c.slo_status()
            timeline_reply = c.timeline()
            status_forms = {op: getattr(c, op)() for op in
                            ("car", "forecast", "gang")}
            import urllib.request

            scrape_ms, scrape_text = [], ""
            for _ in range(OPS_WARM_REQUESTS):
                t0 = time.perf_counter()
                with urllib.request.urlopen(metrics.url + "/metrics",
                                            timeout=60) as r:
                    scrape_text = r.read().decode()
                scrape_ms.append((time.perf_counter() - t0) * 1e3)
            probes.append(healthz_probe(healthz_url, "after the ops"))
            cli_rcs = {flag: run_cli_rc(cli, [flag, addr])
                       for flag in ("-timeline", "-dump", "-slo-status")}
        launches = (ff.LAUNCHES, fm.LAUNCHES)
        polls = polls_a + polls_b + 1
        out["launches"]["sweep_fit"]["(q) sweeps polled during the "
                                     "stream, and the first"] = launches[0]
        out["launches"]["sweep_multi"]["(q) strict sweep_multi"] = \
            launches[1]
        if launches != (polls, 1) or doc["kernel"] != b1_label or \
                mdoc["kernel"] != b1_label.replace("i32", "multi_i32"):
            raise AssertionError(f"(q): {polls} sweeps and one sweep_multi "
                                 f"launched {launches} ({doc['kernel']}, "
                                 f"{mdoc['kernel']})")
        generation = server.generation
    finally:
        release.set()
        if follower is not None:
            follower.stop()
        if coalescer is not None:
            coalescer.stop(timeout=60)
        if metrics is not None:
            metrics.shutdown()
        if server is not None:
            server.shutdown()
        monitor.close()
        timeline.close()
        mock.close()

    # -- one record per published generation -----------------------------
    gens = [g for g, *_ in captured]
    with open(timeline_log) as f:
        logged = [json.loads(x) for x in f]
    logged_gens = [x["generation"] for x in logged
                   if x["kind"] == "generation"]
    if gens != list(range(1, generation + 1)) or logged_gens != gens or \
            [r.generation for r in timeline.records()] != gens[-64:]:
        raise AssertionError(f"(q): published generations 1..{generation},"
                             f" observed {gens}, logged {logged_gens}")
    # -- each plain watch = B1 = the exact program = the host oracle -------
    plain_specs = [s for s in specs if s.quantile is None and s.gang is None]
    by_gen = {r.generation: r for r in timeline.records()}
    checked = 0
    for g, snap, *_ in captured:
        for spec in plain_specs:
            mode = spec.mode or snap.semantics
            mask = implicit_taint_mask(snap) if mode == "strict" else None
            one = pkg.ScenarioGrid.from_scenarios([spec.scenario])
            b1 = ff.sweep_snapshot_auto(snap, one, mode=mode,
                                        node_mask=mask, device=device)
            exact = fit.sweep_snapshot(snap, one, mode=mode,
                                       node_mask=mask, device=device)
            host = np.asarray(fit_arrays_python(
                snap.alloc_cpu_milli, snap.alloc_mem_bytes,
                snap.alloc_pods, snap.used_cpu_req_milli,
                snap.used_mem_req_bytes, snap.pods_count,
                int64_bits(spec.scenario.cpu_request_milli),
                spec.scenario.mem_request_bytes, mode=mode,
                healthy=snap.healthy), dtype=np.int64)
            if mask is not None:
                host = host * mask
            got = by_gen[g].watches[spec.name].total
            if b1[2] != b1_label or not (
                    got == int(b1[0][0]) == int(exact[0][0])
                    == int(host.sum())):
                raise AssertionError(
                    f"(q) generation {g} watch {spec.name}: timeline {got},"
                    f" B1 {int(b1[0][0])} ({b1[2]}), exact "
                    f"{int(exact[0][0])}, host {int(host.sum())}")
            checked += 1
    # -- the card's records = a CPU timeline fed the same snapshots --------
    host_tl = CapacityTimeline(specs, depth=64, device="cpu")
    host_eval = [host_tl.observe(snap, g, ts=ts).eval_ms
                 for g, snap, ts, _ in captured]
    card_wire, host_wire = timeline.wire(), host_tl.wire()
    card_eval = [rec.pop("eval_ms") for rec in card_wire["records"]]
    for rec in host_wire["records"]:
        rec.pop("eval_ms")
    if card_wire != host_wire:
        raise AssertionError("(q): the card's timeline differs from the "
                             "CPU timeline fed the same snapshots")
    # -- the scrape = the timeline's last record ---------------------------
    want = expected_gauges(timeline, specs)
    got = scrape_values(scrape_text)
    bad = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
    if bad:
        raise AssertionError(f"(q) scrape vs the last record: {bad}")
    # -- /healthz flipped with the breached watches ------------------------
    codes = [p["code"] for p in probes]
    if codes[:2] != [200, 503]:
        raise AssertionError(f"(q) /healthz did not flip: {probes}")
    if not probes[0]["plain_breached"]:
        raise AssertionError(f"(q) /healthz: no plain watch breached "
                             f"before the stream: {probes[0]}")
    alerts = timeline.alerts()
    if alerts["recover"]["breaches"] < 1 or \
            alerts["recover"]["recoveries"] < 1 or \
            alerts["recover"]["state"] != "recovered" or \
            alerts["advisory"]["state"] != "breached":
        raise AssertionError(f"(q): the stream did not breach and recover "
                             f"'recover': {alerts}")
    # -- the ops and the CLI -----------------------------------------------
    last3 = [(r["op"], r["status"]) for r in dumps["last"]["records"]]
    if last3 != [("dump", "ok"), ("dump", "ok"), ("timeline", "error")] \
            or dumps["sweep_multi"]["count"] != 1 or \
            dumps["errors"]["count"] != 1 or \
            dumps["errors"]["records"][0]["op"] != "timeline" or \
            dumps["tenant"]["count"] != 0 or dumps["sampled"]["count"] != 0:
        raise AssertionError(f"(q) dump filters: {dumps}")
    if [s["name"] for s in slo_reply["specs"]] != [
            "sweep-latency", "sweep-availability"] or \
            set(slo_reply["status"]) != {"sweep-latency",
                                         "sweep-availability"}:
        raise AssertionError(f"(q) slo: {slo_reply}")
    breached_watches = [n for n, a in timeline_reply["alerts"].items()
                        if a["state"] == "breached"]
    breached_slos = [n for n, s in slo_reply["status"].items()
                     if s["state"] == "breached"]
    want_rcs = {"-timeline": 1 if breached_watches else 0, "-dump": 0,
                "-slo-status": 1 if breached_slos else 0}
    got_rcs = {flag: rc for flag, (rc, _) in cli_rcs.items()}
    if got_rcs != want_rcs:
        raise AssertionError(f"(q) CLI exit codes {got_rcs}, the JAX "
                             f"rules say {want_rcs}")
    for op in ("car", "forecast", "gang"):
        if not status_forms[op]["enabled"]:
            raise AssertionError(f"(q) {op} status: {status_forms[op]}")
    # Generation 1 is observed as the server is built, cold: on its own.
    out["ms"] = {
        "eval_card": ms_stats(card_eval[1:]),
        "eval_card_first": card_eval[0],
        "eval_cpu": ms_stats(host_eval[1:]),
        "eval_cpu_first": host_eval[0],
        "staleness_ms": staleness_ms,
        "timeline_staleness_ms": timeline_staleness_ms,
        "control_staleness_ms": control["staleness_ms"],
        "m3_staleness_ms": m3_staleness_ms,
        "scrape": {**ms_stats(scrape_ms), "bytes": len(scrape_text)},
        "ops": {k: {"median_ms": v["median_ms"], "p90_ms": v["p90_ms"]}
                for k, v in ops.items()},
    }
    out["generations"] = generation
    out["healthz"] = probes
    out["seconds"] = time.perf_counter() - t_phase
    log(f"(q) follow server with {len(specs)} watches: {generation} "
        f"generations published, each with one timeline record (ring and "
        f"log); {checked} plain-watch totals equal to B1's sweep, the exact "
        f"program and the host oracle; every record equal to a CPU "
        f"timeline fed the same snapshots; {len(want)} gauges equal to the "
        f"last record; 'recover' breached {alerts['recover']['breaches']} "
        f"and recovered {alerts['recover']['recoveries']} time(s); "
        f"/healthz " + ", ".join(f"{p['stage']} {p['code']}"
                                 for p in probes)
        + f"; CLI exits {got_rcs} ({identity})")
    sampled_ms = {name: round(r.car_eval_ms, 3) for name, r in
                  timeline.records()[-1].watches.items() if r.samples}
    out["ms"]["last_sampled_watches_ms"] = sampled_ms
    log(f"(q) timeline eval_ms per generation after the first: card "
        f"{fmt_stats(out['ms']['eval_card'])}, CPU "
        f"{fmt_stats(out['ms']['eval_cpu'])}; generation 1, observed as the "
        f"server is built: card {card_eval[0]:.3f}, CPU {host_eval[0]:.3f};"
        f" of the last generation's "
        f"{card_eval[-1]:.3f} ms on the card, the sampled watches' own "
        f"evaluations (draws, sweep, reduction) took {sampled_ms} "
        f"({identity})")
    log(f"(q) staleness with the watchlist: {staleness_ms:.3f} ms from the "
        f"second segment's last event to the first sweep answering the "
        f"final state ({polls_b} sweeps polled), {timeline_staleness_ms:.3f}"
        f" ms to the last timeline record; the same segments without the "
        f"timeline: {control['staleness_ms']:.3f} ms; (m3)'s whole stream "
        f"on (m)'s cluster: {m3_staleness_ms:.3f} ms ({identity})")
    log(f"(q) /metrics scrape: {fmt_stats(out['ms']['scrape'])} ms, "
        f"{len(scrape_text)} bytes; ops median / p90 ms: " + ", ".join(
            f"{k} {v['median_ms']:.3f} / {v['p90_ms']:.3f}"
            for k, v in out["ms"]["ops"].items())
        + f"; B1 launches {launches[0]}, B2 {launches[1]} ({identity})")
    return out


# --- Path (r): the audit trail and the replicated serving plane ----------
# (q)'s cluster (5,000 nodes, 148,991 pods with GPU and storage columns and
# zone/rack labels) served by a file-backed strict leader with an audit log
# (a checkpoint every 16 generations), a shadow sampler at rate 1.0, a plane
# publisher, a 3-tenant map and admission control over it; (m)'s 600-event
# churn stream in 6 update batches of 100; two replicas on the card following
# the plane, one through a fault proxy that cuts the stream once; then the
# leader's log replayed through the CLI on the card and on the host.
REPL_BATCHES = 6
REPL_TENANTS = {"tenants": [
    {"name": "batch", "token": "tok-batch", "weight": 1},
    {"name": "web", "token": "tok-web", "weight": 2},
    {"name": "ml", "token": "tok-ml", "weight": 4, "rps": 5, "burst": 5},
]}
# The shadow oracle walks (scenario, node) pairs in Python (about 17 ms a
# scenario at 5,000 nodes on a host core), so only 64-scenario sweeps are
# sampled: the sampler runs at rate 1.0 and is set to 0 around the leader's
# 1,000-scenario sweeps.
REPL_SHADOW_SCENARIOS = 64
# ml's burst of sweep_multi after the stream: its bucket holds 5 tokens.
REPL_BURST = 12
REPL_NOT_LEADER = (
    "NotLeaderError: this server is a plane replica (read-only view of the "
    "leader's snapshot stream); send mutations to the leader")
# The replay verdict's reason for ops it records but does not re-answer.
REPL_SKIPPED = {op: f"op {op!r} is recorded but not replayable"
                for op in ("sweep_multi", "update")}


def run_cli_doc(cli, argv: list[str]) -> dict:
    """The JSON document a CLI run prints (indented over many lines)."""
    rc, text = run_cli_rc(cli, argv)
    if rc != 0:
        raise AssertionError(f"cli {argv} exited {rc}: {text[-500:]}")
    return json.loads(text)


def counting(client, counts: dict, key: str):
    """``client`` with every call counted under ``counts[key]``."""
    call = client.call

    def counted(op, *args, **kw):
        counts[key] = counts.get(key, 0) + 1
        return call(op, *args, **kw)

    client.call = counted
    return client


def phase_replicated(pkg, cli, ff, fm, tmp: str, identity: str) -> dict:
    """Path (r): the audit trail and the replicated serving plane.

    (r1) A file-backed strict leader on the card with an audit log, a
    shadow sampler (rate 1.0, its bundle file), a plane publisher on an
    ephemeral port, a 3-tenant map (weights 1/2/4, ``ml`` capped at 5 rps
    with a burst of 5) and ``AdmissionController(max_concurrent=2)`` over
    it.  It takes the churn stream as 6 ``update`` batches of 100; after
    each the tenants' clients ask a 1,000-scenario ``sweep`` (B1), a
    64-scenario ``sweep`` (B1, shadow-checked), ``explain`` and ``fit`` of
    (g)'s spec, a 64-rank rack ``gang``, an LP ``optimize`` of 64
    scenarios, a ``forecast`` of 8 steps x 256 samples, a catalog ``plan``
    of 256 samples and a 1,000 x 4 ``sweep_multi`` (B2); then ``ml`` sends
    12 small ``sweep_multi`` at once.  (r2) Two replicas on the card follow
    the plane, one through a ``FaultProxy`` that cuts the stream once;
    after each batch both hold the leader's generation and digest and
    their sweeps equal the leader's (B1 once each); a replica refuses
    ``update``; ``-plane-status`` and a ``ReplicaSet``; ``/healthz``.
    (r3) ``-replay`` of the leader's log on the card and on the host,
    ``-replay-ref``, ``-replay-generation``, ``-replay-tenant`` and
    ``replay_shadow_bundle`` of a bundle whose served totals were moved
    by one."""
    from kubernetesclustercapacity_tpu_torch import stochastic as st
    from kubernetesclustercapacity_tpu_torch.audit import (
        AuditLog,
        AuditReader,
        ShadowSampler,
        replay_shadow_bundle,
    )
    from kubernetesclustercapacity_tpu_torch.audit.shadow import (
        oracle_totals,
    )
    from kubernetesclustercapacity_tpu_torch.masks import implicit_taint_mask
    from kubernetesclustercapacity_tpu_torch.service import (
        CapacityClient,
        CapacityServer,
        protocol,
    )
    from kubernetesclustercapacity_tpu_torch.service.plane import (
        AdmissionController,
        PlanePublisher,
        PlaneSubscriber,
    )
    from kubernetesclustercapacity_tpu_torch.service.replicaset import (
        ReplicaSet,
    )
    from kubernetesclustercapacity_tpu_torch.service.server import (
        healthz_probes,
    )
    from kubernetesclustercapacity_tpu_torch.service.tenancy import (
        parse_tenants,
    )
    from kubernetesclustercapacity_tpu_torch.store import ClusterStore
    from kubernetesclustercapacity_tpu_torch.telemetry.exposition import (
        start_metrics_server,
    )
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
        MetricsRegistry,
    )
    from kubernetesclustercapacity_tpu_torch.testing_faults import (
        FaultPlan,
        FaultProxy,
    )
    from kubernetesclustercapacity_tpu_torch.timeline.diff import (
        snapshot_digest,
    )

    device = "cuda"
    b1_label = "cuda_i32_rcp_fused"
    b2_label = "cuda_multi_i32_rcp_fused"
    out: dict = {"launches": {"sweep_fit": {}, "sweep_multi": {}},
                 "ms": {}}
    t_phase = time.perf_counter()
    fixture = operator_fixture(pkg)
    events = churn_events(fixture)
    per = len(events) // REPL_BATCHES
    batches = [events[i * per:(i + 1) * per] for i in range(REPL_BATCHES)]
    mirror = ClusterStore(fixture, semantics="strict",
                          extended_resources=EXTENDED)
    snap0 = mirror.snapshot()
    grid = pkg.random_scenario_grid(1000, seed=7)
    rng = np.random.default_rng(4)
    mreqs = np.stack([grid.cpu_request_milli, grid.mem_request_bytes,
                      rng.integers(0, 3, grid.size),
                      rng.integers(1, 20, grid.size) * GIB], axis=1)
    resources = ["cpu", "memory", *EXTENDED]
    p95 = st.capacity_at_risk(
        snap0, st.parse_stochastic_spec({"usage": STOCH_USAGE,
                                         "samples": 256, "seed": 1}),
        mode="strict", node_mask=implicit_taint_mask(snap0),
        bindings=False, device=device).quantiles[0.95]
    log(f"(r) source: {snap0.n_nodes} nodes, {len(fixture['pods'])} pods, "
        f"{len(events)} churn events in {REPL_BATCHES} batches; catalog "
        f"plan target {p95 + 500} (P95 {p95} + 500); built in "
        f"{time.perf_counter() - t_phase:.2f} s")

    audit_dir = os.path.join(tmp, "r_audit")
    bundle_path = os.path.join(tmp, "r_shadow.jsonl")
    reg = MetricsRegistry()
    audit_log = AuditLog(audit_dir, checkpoint_every=16, registry=reg)
    shadow = ShadowSampler(1.0, registry=reg, bundle_path=bundle_path,
                           audit_log=audit_log)
    tenants = parse_tenants(json.loads(json.dumps(REPL_TENANTS)))
    admission = AdmissionController(max_concurrent=2, tenants=tenants,
                                    registry=reg)
    pub = PlanePublisher(registry=reg)
    leader = CapacityServer(snap0, fixture=fixture, device=device,
                            batch_window_ms=0, registry=reg,
                            audit_log=audit_log, shadow=shadow,
                            admission=admission, plane=pub, tenants=tenants)
    replicas, subs, applied, stage_ms = [], [], [{}, {}], []

    def staged(server):
        real = server.replace_snapshot

        def stage(*args, **kw):
            t0 = time.perf_counter()
            real(*args, **kw)
            stage_ms.append((time.perf_counter() - t0) * 1e3)

        server.replace_snapshot = stage
        return server

    proxy = metrics = None
    sent: dict = {}
    opt_shares = []
    try:
        ff.LAUNCHES = fm.LAUNCHES = 0
        leader.start()
        healthy, status = healthz_probes(leader, audit_log=audit_log,
                                         shadow=shadow, plane=pub)
        metrics = start_metrics_server(reg, healthy=healthy, status=status)
        # Each replica starts from an 8-node placeholder: everything it
        # serves comes from the plane.
        for k in range(2):
            replica = staged(CapacityServer(
                pkg.synthetic_snapshot(8, seed=1), device=device,
                batch_window_ms=0, registry=MetricsRegistry()))
            replica.start()
            replicas.append(replica)
        plan = FaultPlan([None] * 3 + ["drop_post"])
        proxy = FaultProxy(pub.address, plan, stream=True).start()
        for k, address in enumerate((pub.address, proxy.address)):
            subs.append(PlaneSubscriber(
                address, replicas[k], stale_after_s=60.0, seed=k,
                reconnect_base_s=0.01, reconnect_max_s=0.05,
                on_apply=(lambda g, k=k:
                          applied[k].setdefault(g, time.perf_counter()))))

        def wait_applied(want: int) -> None:
            deadline = time.perf_counter() + 120
            while any(s.applied_generation < want for s in subs):
                if time.perf_counter() > deadline:
                    raise AssertionError(
                        f"(r2): replicas did not reach generation {want}: "
                        f"{[s.stats() for s in subs]}")
                time.sleep(0.001)

        wait_applied(1)
        clients = {name: counting(CapacityClient(
            *leader.address, tenant_token=f"tok-{name}",
            connect_timeout_s=60, timeout_s=600, retry=None), sent, name)
            for name in ("batch", "web", "ml")}
        grid_msg = {"random": {"n": 1000, "seed": 7}}
        mirror_totals, update_ms, batch_s = [], [], []
        leader_b1 = replica_b1 = 0
        probes = []
        for b, events_b in enumerate(batches):
            t_batch = time.perf_counter()
            c_batch, c_web, c_ml = (clients[n] for n in ("batch", "web",
                                                         "ml"))
            t_update = time.perf_counter()
            c_batch.update(events_b)
            mirror.apply(events_b)
            want = leader.generation
            wait_applied(want)
            update_ms.append([(applied[k][want] - t_update) * 1e3
                              for k in range(2)])
            state = mirror.snapshot()
            digest = snapshot_digest(leader.snapshot)
            if digest != snapshot_digest(state):
                raise AssertionError(f"(r1) batch {b}: the leader's "
                                     "snapshot differs from the store's")
            exact = ff.sweep_snapshot_auto(
                state, grid, mode="strict", kernel="exact",
                node_mask=implicit_taint_mask(state), device=device)[0]
            mirror_totals.append(exact.astype(np.int64).tolist())
            # -- the leader, through the tenants' clients ---------------
            before = ff.LAUNCHES
            shadow.sample_rate = 0.0
            doc = c_web.sweep(**grid_msg)
            shadow.sample_rate = 1.0
            small = c_web.sweep(random={"n": REPL_SHADOW_SCENARIOS,
                                        "seed": 100 + b})
            leader_b1 += ff.LAUNCHES - before
            if doc["totals"] != mirror_totals[-1] or \
                    doc["kernel"] != b1_label or \
                    small["kernel"] != b1_label:
                raise AssertionError(f"(r1) batch {b}: the leader's sweep "
                                     f"({doc['kernel']}) differs from the "
                                     "exact program")
            c_batch.explain(**OPS_SPEC)
            c_batch.fit(**OPS_SPEC)
            c_ml.gang(ranks=64, colocate="rack", **GANG_POD)
            og = pkg.random_scenario_grid(64, seed=200 + b)
            opt = c_ml.optimize(
                cpu_request_milli=og.cpu_request_milli.tolist(),
                mem_request_bytes=og.mem_request_bytes.tolist(),
                replicas=og.replicas.tolist())
            if opt.get("certified"):
                opt_shares.append(max((s["capacity_share"]
                                       for s in opt["shadow_prices"]),
                                      default=0.0))
            c_batch.forecast(usage=STOCH_USAGE, replicas=200, samples=256,
                             seed=b, steps=8, step_s=3600,
                             growth={"cpu_per_s": 2e-6})
            c_web.plan(catalog=STOCH_CATALOG, usage=STOCH_USAGE,
                       replicas=200, samples=256, seed=b, target=p95 + 500)
            before_b2 = fm.LAUNCHES
            mdoc = c_ml.sweep_multi(resources, mreqs.tolist(),
                                    replicas=grid.replicas.tolist())
            if fm.LAUNCHES - before_b2 != 1 or \
                    mdoc["kernel"] != b2_label:
                raise AssertionError(f"(r1) batch {b}: sweep_multi "
                                     f"({mdoc['kernel']}) launched B2 "
                                     f"{fm.LAUNCHES - before_b2} times")
            # -- the replicas at this generation ------------------------
            for k, replica in enumerate(replicas):
                if replica.generation != want or \
                        subs[k].stats()["digest"] != digest:
                    raise AssertionError(f"(r2) batch {b}: replica {k} at "
                                         f"{replica.generation}, "
                                         f"{subs[k].stats()}")
                with CapacityClient(*replica.address, timeout_s=600,
                                    retry=None) as rc:
                    before = ff.LAUNCHES
                    rdoc = rc.sweep(**grid_msg)
                    launched = ff.LAUNCHES - before
                    replica_b1 += launched
                    if rdoc["totals"] != doc["totals"] or \
                            rc.last_generation != want or \
                            rdoc["kernel"] != b1_label or \
                            launched != 1:
                        raise AssertionError(
                            f"(r2) batch {b}: replica {k} answered "
                            f"generation {rc.last_generation} with "
                            f"{rdoc['kernel']}, {launched} launches")
            probes.append(repl_healthz(metrics.url + "/healthz",
                                       f"after batch {b}"))
            batch_s.append(time.perf_counter() - t_batch)
        # -- ml's burst: the capped tenant is refused ------------------
        small_multi = mreqs[:REPL_SHADOW_SCENARIOS].tolist()
        refused = admitted = 0
        before_b2 = fm.LAUNCHES
        for _ in range(REPL_BURST):
            try:
                clients["ml"].sweep_multi(resources, small_multi)
                admitted += 1
            except Exception as e:  # noqa: BLE001 - the refusal is checked
                if type(e).__name__ != "TenantQuotaError":
                    raise
                refused += 1
        if not refused or fm.LAUNCHES - before_b2 != admitted:
            raise AssertionError(f"(r1) ml's burst: {admitted} admitted, "
                                 f"{refused} refused, B2 launched "
                                 f"{fm.LAUNCHES - before_b2} times")
        dump = clients["web"].dump(op="sweep", limit=1)
        sweep_ref = dump["records"][0]["audit_ref"]
        # The audited requests of each tenant: per batch, batch's update,
        # explain, fit and forecast, web's two sweeps and plan, ml's gang,
        # optimize and sweep_multi; then ml's burst (the dump is not
        # audited).
        audited = {"batch": 4 * REPL_BATCHES, "web": 3 * REPL_BATCHES,
                   "ml": 3 * REPL_BATCHES + REPL_BURST}
        out["launches"]["sweep_fit"]["(r1) the leader's sweeps"] = \
            leader_b1
        out["launches"]["sweep_multi"]["(r1) the leader's sweep_multi"] = \
            fm.LAUNCHES
        out["launches"]["sweep_fit"]["(r2) the replicas' sweeps"] = \
            replica_b1
        if leader_b1 != 2 * REPL_BATCHES or replica_b1 != 2 * REPL_BATCHES:
            raise AssertionError(f"(r) B1 launched {leader_b1} times on the "
                                 f"leader, {replica_b1} on the replicas")
        # -- (r2) the rest: refusal, -plane-status, a set, health ------
        with socket.create_connection(replicas[0].address, 60) as sock:
            protocol.send_msg(sock, {"op": "update", "events": batches[0]})
            refusal = protocol.recv_msg(sock)
        if refusal.get("error") != REPL_NOT_LEADER or \
                refusal.get("code") != "not_leader":
            raise AssertionError(f"(r2) a replica answered update with "
                                 f"{refusal}")
        status_rcs = {}
        for name, server in (("leader", leader), ("replica", replicas[1])):
            rc, text = run_cli_rc(cli, ["-plane-status",
                                        f"{server.address[0]}:"
                                        f"{server.address[1]}",
                                        "-output", "json"])
            role = json.loads(text)["plane"]["role"]
            status_rcs[name] = rc
            if rc != 0 or role != name:
                raise AssertionError(f"(r2) -plane-status {name}: {rc} "
                                     f"{text}")
        rs = ReplicaSet([replicas[0].address, replicas[1].address,
                         leader.address], timeout_s=600)
        try:
            small_msg = {"random": {"n": REPL_SHADOW_SCENARIOS, "seed": 9}}
            want_small = leader.dispatch({"op": "sweep", **small_msg})
            for _ in range(4):
                got = rs.sweep(**small_msg)
                if got["totals"] != want_small["totals"]:
                    raise AssertionError("(r2) the replica set's sweep "
                                         "differs from the leader's")
            rs_stats = rs.stats()
        finally:
            rs.close()
        resyncs = [s.stats()["resyncs"] for s in subs]
        if plan.injected["drop_post"] != 1 or resyncs[1] < 1:
            raise AssertionError(f"(r2) the proxied replica saw no cut: "
                                 f"{plan.injected}, resyncs {resyncs}")
        replica_health = []
        for k, replica in enumerate(replicas):
            r_ok, r_status = healthz_probes(replica, subscriber=subs[k])
            body = r_status()
            if not r_ok() or body["plane"]["generation"] != \
                    leader.generation:
                raise AssertionError(f"(r2) replica {k} /healthz: {body}")
            replica_health.append(body["plane"]["stale"])
        probes.append(repl_healthz(metrics.url + "/healthz", "at the end"))
        # -- (r1) the checks after the stream ---------------------------
        if not shadow.drain(600):
            raise AssertionError("(r1) the shadow sampler did not drain")
        sh = shadow.stats()
        if sh["divergences"] or sh["checked"] < REPL_BATCHES or \
                sh["dropped"] or sh["oracle_errors"]:
            raise AssertionError(f"(r1) shadow: {sh}")
        snap_m = reg.snapshot()
        by_tenant = snap_m["kccap_tenant_requests_total"]["values"]
        got_sent = {n: int(by_tenant.get(f'tenant="{n}"', 0))
                    for n in clients}
        if got_sent != {n: sent[n] for n in clients}:
            raise AssertionError(f"(r1) tenant requests {got_sent}, the "
                                 f"clients sent {sent}")
        sheds = snap_m["kccap_tenant_shed_total"]["values"]
        shed_by = {k: int(v) for k, v in sheds.items()}
        if shed_by != {'tenant="ml",reason="tenant_quota"': refused}:
            raise AssertionError(f"(r1) tenant sheds {shed_by}, ml was "
                                 f"refused {refused} times")
        price = admission.shadow_price()
        want_price = opt_shares[-1] if opt_shares else None
        if price != want_price:
            raise AssertionError(f"(r1) admission shadow price {price}, the "
                                 f"last certified optimize priced "
                                 f"{want_price}")
        info = leader.dispatch({"op": "info", "audit": True,
                                "tenancy": True, "plane": True})
        last_generation = leader.generation
        last_digest = snapshot_digest(leader.snapshot)
    finally:
        if proxy is not None:
            proxy.stop()
        pub.close()
        for s in subs:
            s.stop()
        if metrics is not None:
            metrics.shutdown()
        leader.shutdown()
        for r in replicas:
            r.shutdown()
        shadow.close()
        audit_log.close()
    log_bytes = sum(os.path.getsize(os.path.join(audit_dir, f))
                    for f in os.listdir(audit_dir))

    # -- (r3) replay -----------------------------------------------------
    before = ff.LAUNCHES
    t0 = time.perf_counter()
    card = run_cli_doc(cli, ["-replay", audit_dir, "-output", "json",
                         "-device", device])
    replay_card_s = time.perf_counter() - t0
    replay_b1 = ff.LAUNCHES - before
    t0 = time.perf_counter()
    host = run_cli_doc(cli, ["-replay", audit_dir, "-output", "json",
                         "-device", "cpu"])
    replay_cpu_s = time.perf_counter() - t0
    if card != host:
        raise AssertionError("(r3) the replay on the card differs from the "
                             "replay on the host")
    bad = [o for o in card["outcomes"] if o["status"] != "ok" and not (
        o["status"] == "skipped"
        and o["reason"] == REPL_SKIPPED.get(o["op"]))]
    sweeps = sum(o["op"] == "sweep" for o in card["outcomes"])
    if card["chain_error"] is not None or not card["clean"] or bad or \
            card["counts"]["mismatch"] or card["counts"]["error"] or \
            card["generations_verified"] != list(
                range(1, last_generation + 1)) or \
            replay_b1 != sweeps:
        raise AssertionError(f"(r3) replay: {card['counts']}, chain "
                             f"{card['chain_error']}, {bad[:3]}, B1 "
                             f"{replay_b1} for {sweeps} sweeps")
    out["launches"]["sweep_fit"]["(r3) the replayed sweeps"] = replay_b1
    before = ff.LAUNCHES
    ref = run_cli_doc(cli, ["-replay", audit_dir, "-replay-ref", sweep_ref,
                        "-output", "json", "-device", device])
    gen = run_cli_doc(cli, ["-replay", audit_dir, "-replay-generation",
                        str(last_generation), "-output", "json",
                        "-device", device])
    if ref["outcomes"][0]["status"] != "ok" or \
            gen["digest"] != last_digest:
        raise AssertionError(f"(r3) -replay-ref {ref['outcomes']}, "
                             f"-replay-generation {gen}")
    per_tenant = {}
    for name in ("batch", "web", "ml"):
        doc = run_cli_doc(cli, ["-replay", audit_dir, "-replay-tenant", name,
                            "-output", "json", "-device", device])
        per_tenant[name] = doc["requests"]
    if per_tenant != audited:
        raise AssertionError(f"(r3) -replay-tenant counts {per_tenant}, "
                             f"the tenants sent {audited}")
    reader = AuditReader.load(audit_dir)
    last_small = [r for r in reader.requests() if r["op"] == "sweep" and
                  r["args"].get("random", {}).get("n")
                  == REPL_SHADOW_SCENARIOS][-1]
    sgrid = pkg.random_scenario_grid(REPL_SHADOW_SCENARIOS,
                                     seed=last_small["args"]["random"]["seed"])
    state = reader.snapshot_at(last_small["generation"])
    t0 = time.perf_counter()
    want = oracle_totals(state, sgrid)
    oracle_ms = (time.perf_counter() - t0) * 1e3
    bundle = {"kind": "shadow_divergence",
              "generation": last_small["generation"],
              "digest": snapshot_digest(state),
              "cpu_request_milli": sgrid.cpu_request_milli.tolist(),
              "mem_request_bytes": sgrid.mem_request_bytes.tolist(),
              "replicas": sgrid.replicas.tolist(),
              "served_totals": [t + (s == 0) for s, t in enumerate(want)]}
    verdict = replay_shadow_bundle(reader, bundle, device=device)
    if verdict["diverged"] or verdict["served_matches_bundle"]:
        raise AssertionError(f"(r3) the fake divergence: {verdict}")
    out["launches"]["sweep_fit"][
        "(r3) -replay-ref, -replay-tenant and the bundle's sweep"] = \
        ff.LAUNCHES - before

    times = sorted(t for pair in update_ms for t in pair)
    out["ms"] = {
        "update_to_staged": ms_stats(times),
        "update_to_staged_by_batch": update_ms,
        "staging": ms_stats(stage_ms),
        "replay_card_s": replay_card_s,
        "replay_cpu_s": replay_cpu_s,
        "shadow_check_64x5000_ms": oracle_ms,
        "batch_s": batch_s,
    }
    out["log_bytes"] = log_bytes
    out["replay_counts"] = card["counts"]
    out["shadow"] = {k: sh[k] for k in ("sampled", "checked",
                                        "divergences", "dropped")}
    out["tenants"] = {"sent": got_sent, "refused": refused,
                      "admitted_in_burst": admitted,
                      "shadow_price": price,
                      "certified_optimizes": len(opt_shares)}
    out["healthz"] = probes
    out["seconds"] = time.perf_counter() - t_phase
    log(f"(r1) leader: {last_generation} generations, {REPL_BATCHES} "
        f"batches of {per} events; shadow {out['shadow']}; tenants sent "
        f"{got_sent}, ml refused {refused} of its {REPL_BURST}-request "
        f"burst (tenant_quota), none else shed; admission shadow price "
        f"{price} ({len(opt_shares)} of {REPL_BATCHES} optimize solves "
        f"certified); info sections {sorted(info)}; audit log "
        f"{log_bytes} bytes in {len(os.listdir(audit_dir))} file(s) "
        f"({identity})")
    log(f"(r2) replicas: both at every generation with the leader's digest "
        f"and sweep (B1 once each), the proxied one resynced {resyncs[1]} "
        f"time(s) after the cut; update -> staged "
        f"{fmt_stats(out['ms']['update_to_staged'])} ms, staging "
        f"{fmt_stats(out['ms']['staging'])} ms; -plane-status exits "
        f"{status_rcs}; a replica set over both and the leader answered 4 "
        f"sweeps equal to the leader's (watermark {rs_stats['watermark']}); "
        f"replicas stale {replica_health}; "
        f"/healthz " + ", ".join(f"{p['stage']} {p['code']}"
                                 for p in probes) + f" ({identity})")
    log(f"(r3) replay of {card['requests']} requests: {card['counts']}, "
        f"chain of {len(card['generations_verified'])} generations "
        f"verified; on the card {replay_card_s:.2f} s (B1 {replay_b1} for "
        f"{sweeps} sweeps), on the host {replay_cpu_s:.2f} s, equal; "
        f"-replay-ref ok, -replay-generation digest equal, -replay-tenant "
        f"{per_tenant}; the fake divergence refuted; one shadow check at "
        f"{REPL_SHADOW_SCENARIOS} x {state.n_nodes} {oracle_ms:.1f} ms "
        f"({identity})")
    return out


def repl_healthz(url: str, stage: str) -> dict:
    """One leader /healthz read in (r): it must answer 200 with the audit,
    shadow and plane entries, and the device ledger's leak alert must not
    have tripped."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            code, body = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, body = e.code, json.loads(e.read())
    leak = body.get("device_memory", {}).get("leak_alert", {})
    missing = [k for k in ("audit", "shadow", "plane") if k not in body]
    if code != 200 or missing or leak.get("state") == "breached":
        raise AssertionError(f"(r) /healthz {stage}: {code}, missing "
                             f"{missing}: {body}")
    return {"stage": stage, "code": code}


# ---------------------------------------------------------------------------
# Path (s): the federation tier; path (t): the diagnostics against it
# ---------------------------------------------------------------------------
# (s1) the JAX bench's federated fleet (bench.py:1600-1660): 4 clusters of
# synthetic_snapshot(1_000_000, seed=100+i, shapes=8) injected into one
# federation on a driven clock, the bench's 3-scenario query.
FED_BENCH_NODES = 1_000_000
FED_BENCH_CLUSTERS = 4
FED_BENCH_QUERY = {"cpu_request_milli": [100, 250, 900],
                   "mem_request_bytes": [10 ** 8, 3 * 10 ** 8, 10 ** 9],
                   "replicas": [1, 4, 16]}
# (s2) three live member clusters at (m)'s size, each a strict leader on
# the card with a plane publisher; the federation's horizons are seconds.
FED_MEMBERS = ("c0", "c1", "c2")
FED_PROXIED = "c2"
FED_STALE_S, FED_EVICT_S = 3.0, 8.0
FED_HEARTBEAT_S = 0.2
FED_WARM = 20
FED_ONE = {"cpuRequests": "500m", "memRequests": "1gb", "replicas": "5000"}
FED_COSTS = {"c0": 3.0, "c1": 1.0}
FED_DEVICE = "cuda"
FED_B1_LABEL = "cuda_i32_rcp_fused"
PROFILE_HZ = 97


JAX_PROFILE_CHILD = """\
import json, sys
from kubernetesclustercapacity_tpu_torch import cli
from kubernetesclustercapacity_tpu_torch.ops import fused_fit
rc = cli.main(sys.argv[1:])
print(json.dumps({"launches": fused_fit.LAUNCHES}), file=sys.stderr)
sys.exit(rc)
"""


def wait_until(what: str, predicate, timeout_s: float = 120.0,
               interval_s: float = 0.001) -> float:
    """Poll ``predicate`` until it holds; returns the host clock then."""
    deadline = time.perf_counter() + timeout_s
    while not predicate():
        if time.perf_counter() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(interval_s)
    return time.perf_counter()


def http_status(url: str) -> tuple[int, dict]:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def run_cli_both(cli, argv: list[str]) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def grid_wire(grid) -> dict:
    return {"cpu_request_milli": grid.cpu_request_milli.tolist(),
            "mem_request_bytes": grid.mem_request_bytes.tolist(),
            "replicas": grid.replicas.tolist()}


def phase_fed_bench(pkg, ff) -> dict:
    """(s1): the bench's federated fleet, its partition of cluster-0 on
    the driven clock (stale, then lost and excluded by name), and the
    parity gate against ``fit_totals_numpy`` at each stamped
    generation."""
    from kubernetesclustercapacity_tpu_torch.federation import (
        FederationServer,
    )
    from kubernetesclustercapacity_tpu_torch.stochastic.car import (
        fit_totals_numpy,
    )

    t_phase = time.perf_counter()
    now = [0.0]
    query = {"op": "fed_sweep", **FED_BENCH_QUERY}
    cpu = np.asarray(FED_BENCH_QUERY["cpu_request_milli"], dtype=np.int64)
    mem = np.asarray(FED_BENCH_QUERY["mem_request_bytes"], dtype=np.int64)
    fed = FederationServer(stale_after_s=30.0, evict_after_s=120.0,
                           clock=lambda: now[0], device=FED_DEVICE)
    try:
        snaps = {}
        for i in range(FED_BENCH_CLUSTERS):
            name = f"cluster-{i}"
            snaps[name] = pkg.synthetic_snapshot(FED_BENCH_NODES,
                                                 seed=100 + i, shapes=8)
            fed.inject(name, snaps[name], generation=i + 1)
        built_s = time.perf_counter() - t_phase
        t0 = time.perf_counter()
        r_first = fed.dispatch(dict(query))
        first_ms = (time.perf_counter() - t0) * 1e3
        warm = []
        for _ in range(5):
            t0 = time.perf_counter()
            fed.dispatch(dict(query))
            warm.append((time.perf_counter() - t0) * 1e3)
        now[0] = 60.0
        for i, (name, snap) in enumerate(snaps.items()):
            if name != "cluster-0":
                fed.inject(name, snap, generation=100 + i)
        r_stale = fed.dispatch(dict(query))
        c0 = r_stale["clusters"]["cluster-0"]
        if c0["state"] != "stale" or not 30.0 < c0["age_s"] <= 120.0 or \
                "cluster-0" not in r_stale["per_cluster"]:
            raise AssertionError(f"(s1) cluster-0 after 60 s: {c0}")
        diffs = 0
        for result in (r_first, r_stale):
            grand = np.zeros(len(cpu), dtype=np.int64)
            for name, snap in snaps.items():
                want = fit_totals_numpy(
                    snap.alloc_cpu_milli, snap.alloc_mem_bytes,
                    snap.alloc_pods, snap.used_cpu_req_milli,
                    snap.used_mem_req_bytes, snap.pods_count, snap.healthy,
                    cpu, mem, mode=snap.semantics)
                got = np.asarray(result["per_cluster"][name], dtype=np.int64)
                diffs += int(np.sum(want != got))
                grand = grand + got
            diffs += int(np.sum(grand != np.asarray(result["totals"])))
        if diffs:
            raise AssertionError(f"(s1) {diffs} parity differences")
        now[0] = 200.0
        for i, (name, snap) in enumerate(snaps.items()):
            if name != "cluster-0":
                fed.inject(name, snap, generation=200 + i)
        r_lost = fed.dispatch(dict(query))
        survivors = sum(np.asarray(r_lost["per_cluster"][n], dtype=np.int64)
                        for n in snaps if n != "cluster-0")
        if r_lost["excluded"] != ["cluster-0"] or \
                "cluster-0" in r_lost["per_cluster"] or \
                r_lost["clusters"]["cluster-0"]["state"] != "lost" or \
                not np.array_equal(survivors, r_lost["totals"]):
            raise AssertionError(f"(s1) cluster-0 after 200 s: "
                                 f"{r_lost['clusters']['cluster-0']}, "
                                 f"excluded {r_lost['excluded']}")
    finally:
        fed.close()
    out = {"first_ms": first_ms, "warm_ms": ms_stats(warm),
           "parity_diffs": diffs, "nodes": FED_BENCH_CLUSTERS
           * FED_BENCH_NODES, "built_s": built_s,
           "launches": ff.LAUNCHES,
           "seconds": time.perf_counter() - t_phase}
    log(f"(s1) {FED_BENCH_CLUSTERS} x {FED_BENCH_NODES} nodes (shapes=8) "
        f"built and injected in {built_s:.2f} s; fed_sweep of 3 scenarios: "
        f"first {first_ms:.3f} ms, warm {fmt_stats(out['warm_ms'])} ms; "
        f"cluster-0 stale at 60 s (age {c0['age_s']}), lost and excluded "
        f"by name at 200 s; {diffs} parity differences against "
        f"fit_totals_numpy; B1 launched {ff.LAUNCHES} times")
    return out


def federation_members(pkg, tmp: str):
    """(s2)'s three strict leaders on the card, each with a plane
    publisher and a span log; cluster k is ``synthetic_fixture(5_000,
    seed=8+k, pods_per_node=30, taint_frac=0.1)``."""
    from kubernetesclustercapacity_tpu_torch.service import CapacityServer
    from kubernetesclustercapacity_tpu_torch.service.plane import (
        PlanePublisher,
    )
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
        MetricsRegistry,
    )

    fixtures, leaders, pubs = {}, {}, {}
    for k, name in enumerate(FED_MEMBERS):
        fixtures[name] = pkg.synthetic_fixture(
            LIVE_NODES, seed=8 + k, pods_per_node=LIVE_PODS_PER_NODE,
            taint_frac=0.1)
        snap = pkg.snapshot_from_fixture(fixtures[name], semantics="strict")
        if pkg.implicit_taint_mask(snap) is None:
            raise AssertionError(f"(s2) {name} carries no taints")
        pubs[name] = PlanePublisher(heartbeat_s=FED_HEARTBEAT_S,
                                    registry=MetricsRegistry())
        leaders[name] = CapacityServer(
            snap, fixture=fixtures[name], device=FED_DEVICE,
            batch_window_ms=0, plane=pubs[name], registry=MetricsRegistry(),
            trace_log=os.path.join(tmp, "traces", f"leader-{name}.jsonl"))
        leaders[name].start()
    return fixtures, leaders, pubs


def phase_federation(pkg, cli, ff, fm, tmp: str, identity: str) -> dict:
    """Paths (s2) and (t).

    (s2) Three strict 5,000-node leaders on the card (plane publishers,
    span logs) and a ``FederationServer`` on the card attached to all
    three, ``c2`` through a ``FaultProxy``, with a metrics endpoint and a
    span log.  ``c0`` takes the seed-9 churn stream as 6 ``update``
    batches of 100; after each, once the federation's watermark reaches
    the leader's generation, each leader's ``sweep`` of
    ``random_scenario_grid(1000, seed=7)`` (B1 once each) equals its
    ``per_cluster`` row of the federation's ``fed_sweep``.  Then
    ``fed_rank`` with a costs map and ``spillover`` of ``c1``, 20 warm
    requests of each; ``c2`` is partitioned (stale, lost: excluded and
    named, ``spillover`` refused with ``cluster_lost``, ``/healthz`` 503,
    ``-fed-status``/``-fed-sweep`` exit 1) and healed (fresh, equal
    totals, exit 0).

    (t) Against those servers while they run: ``-doctor -doctor-service
    -doctor-federation`` exits 0 naming the card, and 1 with ``c2`` lost;
    ``-trace-tree`` over the span logs of one traced ``fed_sweep`` shows
    one ``fed:member`` per cluster; a sampling profiler on ``c1``'s
    leader, under 1,000-scenario sweeps from a client thread, answers
    ``-profile -profile-seconds 2 -profile-out`` with a dominant phase and
    ``/healthz`` carries its entry; ``-snapshot (a).npz -grid 1000
    -jax-profile DIR`` writes a Chrome trace that names ``sweep_fit``
    (one B1 launch)."""
    import gc

    from kubernetesclustercapacity_tpu_torch import devcache
    from kubernetesclustercapacity_tpu_torch.federation import (
        FederationServer,
    )
    from kubernetesclustercapacity_tpu_torch.resilience import (
        ClusterLostError,
    )
    from kubernetesclustercapacity_tpu_torch.service import CapacityClient
    from kubernetesclustercapacity_tpu_torch.service.server import (
        healthz_probes,
    )
    from kubernetesclustercapacity_tpu_torch.telemetry import profiler
    from kubernetesclustercapacity_tpu_torch.telemetry.exposition import (
        start_metrics_server,
    )
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
        MetricsRegistry,
    )
    from kubernetesclustercapacity_tpu_torch.testing_faults import (
        FaultPlan,
        FaultProxy,
    )

    out: dict = {"launches": {"sweep_fit": {}, "sweep_multi": {}},
                 "ms": {}, "rc": {}}
    t_phase = time.perf_counter()
    ff.LAUNCHES = fm.LAUNCHES = 0
    out["s1"] = phase_fed_bench(pkg, ff)
    out["launches"]["sweep_fit"]["(s1) the bench's fleet"] = ff.LAUNCHES
    out["launches"]["sweep_multi"]["(s1) the bench's fleet"] = fm.LAUNCHES

    t_s2 = time.perf_counter()
    traces = os.path.join(tmp, "traces")
    os.makedirs(traces)
    fixtures, leaders, pubs = federation_members(pkg, tmp)
    events = churn_events(fixtures["c0"])
    per = len(events) // REPL_BATCHES
    batches = [events[i * per:(i + 1) * per] for i in range(REPL_BATCHES)]
    grid = pkg.random_scenario_grid(1000, seed=7)
    wire = grid_wire(grid)
    card = torch.cuda.get_device_name(0)
    proxy = FaultProxy(pubs[FED_PROXIED].address, FaultPlan([]),
                       stream=True).start()
    addrs = {n: (proxy.address if n == FED_PROXIED else pubs[n].address)
             for n in FED_MEMBERS}
    reg = MetricsRegistry()
    fed = FederationServer(addrs, stale_after_s=FED_STALE_S,
                           evict_after_s=FED_EVICT_S, registry=reg,
                           trace_log=os.path.join(traces, "fed.jsonl"),
                           device=FED_DEVICE).start()
    fed_addr = f"{fed.address[0]}:{fed.address[1]}"
    metrics = start_metrics_server(
        reg, healthy=fed.healthy, status=lambda: {"federation": fed.status()})
    clients = {n: CapacityClient(*leaders[n].address, timeout_s=600,
                                 retry=None) for n in FED_MEMBERS}
    fc = CapacityClient(*fed.address, timeout_s=600, retry=None)
    prof = prof_metrics = None
    stop_load = threading.Event()
    loader = None
    healthz: list = []
    try:
        def states():
            return {n: c["state"] for n, c in fed.status()["clusters"].items()}

        def leader_sweeps(stage: str) -> dict:
            want = {}
            for n in FED_MEMBERS:
                before = ff.LAUNCHES
                doc = clients[n].sweep(**wire)
                if ff.LAUNCHES - before != 1 or doc["kernel"] != FED_B1_LABEL:
                    raise AssertionError(
                        f"(s2) {stage}: {n}'s sweep ({doc['kernel']}) "
                        f"launched B1 {ff.LAUNCHES - before} times")
                want[n] = doc["totals"]
            return want

        def fed_matches(stage: str, want: dict, excluded=()) -> dict:
            doc = fc.fed_sweep(**wire)
            rows = {n: t for n, t in want.items() if n not in excluded}
            if doc["per_cluster"] != rows or \
                    sorted(doc["excluded"]) != sorted(excluded) or \
                    doc["totals"] != [sum(t) for t in zip(*rows.values())]:
                raise AssertionError(f"(s2) {stage}: the federation's rows "
                                     "differ from the leaders' sweeps")
            for n in rows:
                if doc["clusters"][n]["generation"] != leaders[n].generation:
                    raise AssertionError(
                        f"(s2) {stage}: {n} at generation "
                        f"{doc['clusters'][n]['generation']}, its leader at "
                        f"{leaders[n].generation}")
            return doc

        wait_until("(s2) every member fresh",
                   lambda: set(states().values()) == {"fresh"})
        b1_at_start = ff.LAUNCHES
        want = leader_sweeps("at the start")
        fed_matches("at the start", want)
        watermark_ms, entries = [], []
        for b, events_b in enumerate(batches):
            t_update = time.perf_counter()
            clients["c0"].update(events_b)
            gen = leaders["c0"].generation
            seen = wait_until(
                f"(s2) c0's watermark at generation {gen}",
                lambda: fed.status()["clusters"]["c0"]["generation"] >= gen)
            watermark_ms.append((seen - t_update) * 1e3)
            want = leader_sweeps(f"batch {b}")
            fed_matches(f"batch {b}", want)
            gc.collect()
            entries.append(devcache.CACHE.stats()["entries"])
        if len(set(entries[1:])) != 1:
            raise AssertionError(f"(s2) device cache entries grew over the "
                                 f"stream: {entries}")
        out["launches"]["sweep_fit"]["(s2) the leaders' sweeps"] = \
            ff.LAUNCHES - b1_at_start
        one = fc.fed_sweep(**FED_ONE)
        rank = fc.fed_rank(costs=FED_COSTS, **FED_ONE)
        spill = fc.spillover("c1", **FED_ONE)
        rows = {r["cluster"]: r["total"] for r in rank["ranking"]}
        if rows != {n: t[0] for n, t in one["per_cluster"].items()} or \
                [r["rank"] for r in rank["ranking"]] != [1, 2, 3] or \
                spill["demand"] != int(leaders["c1"].snapshot.pods_count
                                       .sum()) or \
                sum(p["replicas"] for p in spill["placements"]) \
                + spill["unplaced"] != spill["demand"]:
            raise AssertionError(f"(s2) fed_rank {rank['ranking']}, "
                                 f"spillover {spill}")
        for op, call in (
            ("fed_sweep", lambda: fc.fed_sweep(**wire)),
            ("fed_rank", lambda: fc.fed_rank(costs=FED_COSTS, **FED_ONE)),
            ("spillover", lambda: fc.spillover("c1", **FED_ONE)),
        ):
            st = timed_requests(call, runs=FED_WARM)
            out["ms"][op] = {k: st[k] for k in ("median_ms", "p90_ms")}
        out["ms"]["update_to_watermark"] = ms_stats(watermark_ms)
        out["ms"]["update_to_watermark_by_batch"] = watermark_ms
        code, body = http_status(metrics.url + "/healthz")
        if code != 200:
            raise AssertionError(f"(s2) /healthz with every member fresh: "
                                 f"{code} {body}")
        healthz.append(("fresh", code))

        # -- (t) the doctor with every member fresh ----------------------
        doctor_argv = ["-doctor", "-doctor-timeout", "120",
                       "-doctor-service",
                       f"{leaders['c0'].address[0]}:"
                       f"{leaders['c0'].address[1]}",
                       "-doctor-federation", fed_addr, "-device", FED_DEVICE]
        t0 = time.perf_counter()
        rc, text, _ = run_cli_both(cli, doctor_argv)
        doctor_s = time.perf_counter() - t0
        lines = dict((ln[:23].rstrip(), ln[25:]) for ln in text.splitlines())
        if rc != 0 or not lines.get("backend probe", "").startswith("ok: ") \
                or card not in lines["backend probe"] or \
                not lines.get("federation", "").startswith("ok: 3 cluster"):
            raise AssertionError(f"(t) -doctor exited {rc}:\n{text}")
        out["rc"]["doctor_fresh"] = rc
        out["doctor_probe"] = lines["backend probe"]
        out["ms"]["doctor_s"] = doctor_s

        # -- (t) one traced fed_sweep, stitched from the span logs -------
        tid = "5e" * 16
        fc.call("fed_sweep", trace_id=tid, **wire)
        rc, text, _ = run_cli_both(cli, ["-trace-tree", tid, "-trace-logs",
                                         traces, "-output", "json"])
        tree = json.loads(text)
        (root,) = tree["roots"]
        members = sorted(c["cluster"] for c in root["children"]
                         if c["op"] == "fed:member")
        if rc != 0 or root["op"] != "fed:fed_sweep" or \
                members != list(FED_MEMBERS):
            raise AssertionError(f"(t) -trace-tree exited {rc}: root "
                                 f"{root['op']}, members {members}")
        out["rc"]["trace_tree"] = rc
        out["trace_dominant"] = tree["critical_path"]["dominant"]

        # -- (s2) partition c2: stale, lost, refused, 503 ----------------
        t_cut = time.perf_counter()
        proxy.partition("both")
        t_stale = wait_until("(s2) c2 stale",
                             lambda: states()[FED_PROXIED] == "stale",
                             interval_s=0.01)
        doc = fc.fed_sweep(**wire)
        if doc["clusters"][FED_PROXIED]["state"] != "stale" or \
                doc["per_cluster"][FED_PROXIED] != want[FED_PROXIED] or \
                not doc["degraded"]:
            raise AssertionError(f"(s2) stale c2: {doc['clusters']}")
        t_lost = wait_until("(s2) c2 lost",
                            lambda: states()[FED_PROXIED] == "lost",
                            interval_s=0.01)
        doc = fed_matches("c2 lost", want, excluded=(FED_PROXIED,))
        try:
            fc.spillover(FED_PROXIED, **FED_ONE)
            raise AssertionError("(s2) spillover of a lost cluster answered")
        except ClusterLostError:
            pass
        code, body = http_status(metrics.url + "/healthz")
        if code != 503 or body["federation"]["excluded"] != [FED_PROXIED]:
            raise AssertionError(f"(s2) /healthz with c2 lost: {code}")
        healthz.append(("c2 lost", code))
        rc_status, status_text, _ = run_cli_both(cli, ["-fed-status",
                                                       fed_addr])
        rc_sweep, sweep_text, _ = run_cli_both(cli, ["-fed-sweep", fed_addr])
        if rc_status != 1 or rc_sweep != 1 or \
                "DEGRADED — lost: c2" not in status_text or \
                "EXCLUDED from totals" not in sweep_text:
            raise AssertionError(f"(s2) -fed-status {rc_status}, -fed-sweep "
                                 f"{rc_sweep} with c2 lost")
        out["rc"]["fed_status_lost"] = rc_status
        out["rc"]["fed_sweep_lost"] = rc_sweep
        rc, text, _ = run_cli_both(cli, doctor_argv)
        fed_line = dict((ln[:23].rstrip(), ln[25:])
                        for ln in text.splitlines()).get("federation", "")
        if rc != 1 or not fed_line.startswith("FAILED: cluster(s) lost — c2"):
            raise AssertionError(f"(t) -doctor with c2 lost exited {rc}: "
                                 f"{fed_line}")
        out["rc"]["doctor_lost"] = rc

        # -- (s2) heal ----------------------------------------------------
        t_heal = time.perf_counter()
        proxy.heal()
        t_fresh = wait_until("(s2) c2 fresh after the heal",
                             lambda: states()[FED_PROXIED] == "fresh",
                             interval_s=0.01)
        fed_matches("after the heal", want)
        code, _ = http_status(metrics.url + "/healthz")
        rc_status, _, _ = run_cli_both(cli, ["-fed-status", fed_addr])
        rc_sweep, _, _ = run_cli_both(cli, ["-fed-sweep", fed_addr])
        if code != 200 or rc_status != 0 or rc_sweep != 0:
            raise AssertionError(f"(s2) after the heal: /healthz {code}, "
                                 f"-fed-status {rc_status}, -fed-sweep "
                                 f"{rc_sweep}")
        healthz.append(("healed", code))
        out["rc"]["fed_status_healed"] = rc_status
        out["rc"]["fed_sweep_healed"] = rc_sweep
        out["ms"]["cut_to_stale_s"] = t_stale - t_cut
        out["ms"]["cut_to_lost_s"] = t_lost - t_cut
        out["ms"]["heal_to_fresh_s"] = t_fresh - t_heal
        out["dropped_frames"] = proxy.partition_dropped
        out["launches"]["sweep_fit"]["(s2) the leaders' sweeps"] = \
            ff.LAUNCHES - b1_at_start

        # -- (t) the sampling profiler on c1's leader ---------------------
        b1_before = ff.LAUNCHES
        prof = profiler.start_profiler(PROFILE_HZ)
        healthy, status = healthz_probes(leaders["c1"], profiler=prof)
        prof_metrics = start_metrics_server(
            MetricsRegistry(), healthy=healthy, status=status,
            debug={"/debug/profile": prof.debug_handler})
        loaded = []

        def load():
            with CapacityClient(*leaders["c1"].address, timeout_s=600,
                                retry=None) as c:
                while not stop_load.is_set():
                    c.sweep(**wire)
                    loaded.append(1)

        loader = threading.Thread(target=load, daemon=True)
        loader.start()
        collapsed = os.path.join(tmp, "c1.collapsed")
        rc, _, err = run_cli_both(cli, [
            "-profile", f"127.0.0.1:{prof_metrics.address[1]}",
            "-profile-seconds", "2", "-profile-out", collapsed])
        stop_load.set()
        loader.join(120)
        dominant = [ln for ln in err.splitlines()
                    if ln.startswith("# dominant phase: ")]
        code, body = http_status(prof_metrics.url + "/healthz")
        with open(collapsed, encoding="utf-8") as f:
            samples = sum(int(ln.rsplit(" ", 1)[1]) for ln in f if ln.strip())
        if rc != 0 or not dominant or code != 200 or \
                body.get("profiler", {}).get("hz") != PROFILE_HZ or \
                not samples:
            raise AssertionError(f"(t) -profile exited {rc}: {err[-500:]}; "
                                 f"/healthz {code} {body.get('profiler')}")
        out["rc"]["profile"] = rc
        phase, share = dominant[0][len("# dominant phase: "):].split()[:2]
        out["profile"] = {"dominant": phase, "share": share.strip("(%"),
                          "samples": samples, "sweeps_during": len(loaded),
                          "healthz_profiler": body["profiler"]}
        out["launches"]["sweep_fit"]["(t) the profiled leader's sweeps"] = \
            ff.LAUNCHES - b1_before
    finally:
        stop_load.set()
        if loader is not None:
            loader.join(120)
        if prof_metrics is not None:
            prof_metrics.shutdown()
        profiler.stop_profiler()
        fc.close()
        for c in clients.values():
            c.close()
        metrics.shutdown()
        fed.close()
        proxy.stop()
        for n in FED_MEMBERS:
            pubs[n].close()
            leaders[n].shutdown()
    out["s2_seconds"] = time.perf_counter() - t_s2
    s = out["ms"]
    log(f"(s2) 3 x {LIVE_NODES} strict members on the card, c2 through a "
        f"fault proxy: after each of {REPL_BATCHES} batches of {per} events "
        f"every per_cluster row equal to its leader's B1 sweep; update -> "
        f"federation watermark {fmt_stats(s['update_to_watermark'])} ms; "
        f"1,000 scenarios x {3 * LIVE_NODES} nodes: " + ", ".join(
            f"{op} median {s[op]['median_ms']:.3f} p90 {s[op]['p90_ms']:.3f} "
            f"ms" for op in ("fed_sweep", "fed_rank", "spillover"))
        + f" ({FED_WARM} warm); c2 cut: stale after "
        f"{s['cut_to_stale_s']:.2f} s, lost after {s['cut_to_lost_s']:.2f} s "
        f"(spillover refused cluster_lost, /healthz 503, -fed-status and "
        f"-fed-sweep exit 1), fresh {s['heal_to_fresh_s']:.2f} s after the "
        f"heal with equal totals; /healthz {healthz}; device cache entries "
        f"{entries} ({identity})")

    # -- (t) -jax-profile: a torch.profiler trace of a -grid run ---------
    # In a process of its own, as a user runs it: the child is the CLI and
    # reports its B1 launch count on its last stderr line.
    npz = os.path.join(tmp, "a.npz")
    pkg.synthetic_snapshot(10_000, seed=1).save(npz)
    trace_dir = os.path.join(tmp, "jax_profile")
    child = subprocess.run(
        [sys.executable, "-c", JAX_PROFILE_CHILD, "-snapshot", npz, "-grid",
         "1000", "-output", "json", "-jax-profile", trace_dir, "-device",
         FED_DEVICE],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    reported = [ln for ln in child.stderr.splitlines() if ln.startswith("{")]
    if child.returncode != 0 or not reported:
        raise AssertionError(f"(t) -jax-profile exited {child.returncode}: "
                             f"{child.stderr[-2000:]}")
    doc = json.loads(child.stdout.strip().splitlines()[-1])
    b1_profiled = json.loads(reported[-1])["launches"]
    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    with open(os.path.join(trace_dir, files[0]), encoding="utf-8") as f:
        trace = json.load(f)
    cats: dict = {}
    for e in trace["traceEvents"]:
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    kernels = sorted({e.get("name", "") for e in trace["traceEvents"]
                      if e.get("cat") == "kernel"
                      and "sweep_fit" in e.get("name", "")})
    if doc["kernel"] != FED_B1_LABEL or b1_profiled != 1 or not kernels:
        raise AssertionError(f"(t) -jax-profile: {doc['kernel']}, B1 "
                             f"{b1_profiled} launches, trace kernels "
                             f"{kernels}, events by category {cats}")
    out["launches"]["sweep_fit"]["(t) -grid 1000 -jax-profile"] = b1_profiled
    out["jax_profile"] = {"files": len(files), "kernels": kernels,
                          "events": len(trace["traceEvents"])}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"(t) -doctor exit {out['rc']['doctor_fresh']} in {doctor_s:.1f} s "
        f"(backend probe: {out['doctor_probe']}), "
        f"{out['rc']['doctor_lost']} with c2 lost; -trace-tree: "
        f"fed:fed_sweep with {len(members)} fed:member children, dominated "
        f"by {out['trace_dominant']}; -profile: {out['profile']['samples']} "
        f"samples at {PROFILE_HZ} Hz over "
        f"{out['profile']['sweeps_during']} sweeps, dominant phase "
        f"{out['profile']['dominant']} ({out['profile']['share']}% of the "
        f"attributed samples); -jax-profile: {kernels} in "
        f"{out['jax_profile']['events']} trace events ({identity})")
    return out


# --- Path (u): the native backend and the multi-device sweep --------------
# (u1) the C++ capacity library: -backend native on (g)'s fleet, its sweep
# on (a)'s and (b)'s fleets, the panic; (u2) the columnar pod walk on (m)'s
# cluster; (u3) the compiled front end against a port server on the card;
# (u4) the JAX package's TestMillionNodeScale layouts on a mesh that names
# the card eight times, and two processes over gloo on the card.
NATIVE_PANIC = "panic: integer divide by zero (ClusterCapacity.go:123/129)\n"
MESH_NODES = 1_000_003  # prime: pads the node axis
MULTIHOST_BACKEND = "gloo"  # NCCL puts no two ranks on one card
KIND_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "fixtures", "kind-3node.json")


def snapshot_columns(snap) -> tuple:
    return (snap.alloc_cpu_milli, snap.alloc_mem_bytes, snap.alloc_pods,
            snap.used_cpu_req_milli, snap.used_mem_req_bytes,
            snap.pods_count)


def multihost_worker(argv: list[str]) -> int:
    """One rank of (u4)'s two-process run (``chip_smoke.py
    --multihost-worker PORT RANK N``): a gloo group over 127.0.0.1, each
    rank sweeping its scenario block on ``cuda:0``.  Prints one JSON line
    of every result."""
    import torch.distributed as dist

    from kubernetesclustercapacity_tpu_torch import fixtures, scenario
    from kubernetesclustercapacity_tpu_torch import snapshot as snapshots
    from kubernetesclustercapacity_tpu_torch.ops.fit import (
        snapshot_device_arrays,
    )
    from kubernetesclustercapacity_tpu_torch.parallel import multihost

    port, rank, n = argv[0], int(argv[1]), int(argv[2])
    multihost.initialize(f"127.0.0.1:{port}", n, rank,
                         backend=MULTIHOST_BACKEND)
    snap = snapshots.synthetic_snapshot(10_000, seed=1)
    grid = scenario.random_scenario_grid(1_000, seed=7)
    arrays = snapshot_device_arrays(snap, "cuda")
    reqs = (grid.cpu_request_milli, grid.mem_request_bytes, grid.replicas)
    multi = fixtures.synthetic_multi_workload(snap, grid.size, seed=44)
    out = {"backend": dist.get_backend(),
           "block": multihost.scenario_block(grid.size, rank, n), "ms": {}}
    for gather in (True, False):
        t0 = time.perf_counter()
        t, s = multihost.sweep_multihost(arrays, *reqs, gather=gather,
                                         device="cuda")
        out["ms"][f"sweep gather={gather}"] = (time.perf_counter() - t0) * 1e3
        out[f"sweep_{gather}"] = [t.tolist(), s.tolist()]
        t0 = time.perf_counter()
        t, s = multihost.sweep_multihost_multi(
            multi[0], multi[1], snap.alloc_pods, snap.pods_count,
            snap.healthy, multi[2], multi[3], mode="strict", gather=gather,
            device="cuda")
        out["ms"][f"multi gather={gather}"] = (time.perf_counter() - t0) * 1e3
        out[f"multi_{gather}"] = [t.tolist(), s.tolist()]
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def run_multihost(pkg, fit, identity: str) -> dict:
    """(u4)'s two processes, each this script in worker mode, checked
    against one process's sweeps on the card."""
    from kubernetesclustercapacity_tpu_torch.fixtures import (
        synthetic_multi_workload,
    )

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multihost-worker",
         str(port), str(rank), "2"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    try:
        results = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall_s = time.perf_counter() - t0
    for rank, (p, (stdout, stderr)) in enumerate(zip(procs, results)):
        if p.returncode != 0:
            raise AssertionError(f"(u4) rank {rank} exited {p.returncode}: "
                                 f"{stderr[-3000:]}")
    docs = [json.loads(stdout.strip().splitlines()[-1])
            for stdout, _ in results]
    snap = pkg.synthetic_snapshot(10_000, seed=1)
    grid = pkg.random_scenario_grid(1_000, seed=7)
    single = fit.sweep_snapshot(snap, grid, device="cuda")
    alloc_rn, used_rn, reqs_sr, reps = synthetic_multi_workload(
        snap, grid.size, seed=44)
    put = lambda a, dt=torch.int64: torch.as_tensor(  # noqa: E731
        np.asarray(a), dtype=dt, device="cuda")
    multi = fit.sweep_grid_multi(
        put(alloc_rn), put(used_rn), put(snap.alloc_pods),
        put(snap.pods_count), put(snap.healthy, torch.bool), put(reqs_sr),
        put(reps), mode="strict")
    want = {"sweep": [np.asarray(a).tolist() for a in single],
            "multi": [a.cpu().numpy().tolist() for a in multi]}
    for rank, doc in enumerate(docs):
        if doc["backend"] != MULTIHOST_BACKEND:
            raise AssertionError(f"(u4) rank {rank}: backend {doc['backend']}")
        b0, b1 = doc["block"]
        for what in ("sweep", "multi"):
            if doc[f"{what}_True"] != want[what]:
                raise AssertionError(f"(u4) rank {rank}: gathered {what} "
                                     "differs from one process's")
            if doc[f"{what}_False"] != [c[b0:b1] for c in want[what]]:
                raise AssertionError(f"(u4) rank {rank}: {what} block "
                                     f"[{b0}, {b1}) differs")
    log(f"(u4) two processes over {MULTIHOST_BACKEND} on one card, 10000 "
        f"nodes x 1000 scenarios (blocks {docs[0]['block']} and "
        f"{docs[1]['block']}): sweep_multihost and sweep_multihost_multi, "
        f"gathered and per block, equal to one process's sweeps; rank 0 "
        f"{ {k: round(v, 3) for k, v in docs[0]['ms'].items()} } ms, "
        f"{wall_s:.1f} s for both processes from start ({identity})")
    return {"wall_s": wall_s, "rank_ms": [d["ms"] for d in docs],
            "backend": MULTIHOST_BACKEND}


def phase_native_parallel(pkg, cli, fit, ff, tmp: str, identity: str,
                          transcripts: dict) -> dict:
    """Path (u).  ``transcripts`` are (g)'s ``-backend torch`` transcripts
    of the same fleet (equal to ``-backend cpu``'s there).  Returns the
    times, B1's launches and the (u4) run."""
    from kubernetesclustercapacity_tpu_torch import native, parallel
    from kubernetesclustercapacity_tpu_torch import snapshot as snapshots
    from kubernetesclustercapacity_tpu_torch.native import ingest
    from kubernetesclustercapacity_tpu_torch.service import CapacityServer

    t_phase = time.perf_counter()
    out = {"ms": {}, "launches": {"sweep_fit": {}}}
    for what, ok, mod in (("capacity library", native.available(), native),
                          ("pod walk", ingest.available(), ingest)):
        if not ok:
            raise AssertionError(f"(u) the native {what} is unavailable: "
                                 f"{mod._BUILD_ERROR}")

    # (u1) -backend native on (g)'s fleet, both semantics.
    fixture = pkg.synthetic_fixture(SINGLE_SPEC_NODES, seed=6, taint_frac=0.1)
    g_path = os.path.join(tmp, "u.json")
    pkg.save_fixture(fixture, g_path)
    for semantics in ("reference", "strict"):
        ff.LAUNCHES = 0
        t0 = time.perf_counter()
        text = run_cli_text(cli, ["-snapshot", g_path, "-semantics",
                                  semantics, *SPEC_FLAGS, "-backend",
                                  "native"])
        out["ms"][f"(u1) -backend native {semantics}"] = \
            (time.perf_counter() - t0) * 1e3
        if text != transcripts[semantics] or ff.LAUNCHES:
            raise AssertionError(f"(u1) {semantics}: the -backend native "
                                 "transcript differs from (g)'s")
    args = cli.build_parser().parse_args(["-backend", "native",
                                          "-semantics", "reference"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli._run_single(args, None, pkg.synthetic_snapshot(8, seed=1),
                             pkg.Scenario(0, MIB, 5))
    if (rc, buf.getvalue()) != (2, NATIVE_PANIC):
        raise AssertionError(f"(u1) panic: exit {rc}, {buf.getvalue()!r}")

    # (u1) native.sweep against B1, the exact program and the host.
    grid = pkg.random_scenario_grid(1_000, seed=7)
    strict = pkg.snapshot_from_fixture(
        pkg.synthetic_fixture(10_000, seed=3, taint_frac=0.1),
        semantics="strict")
    taint = pkg.implicit_taint_mask(strict)
    for name, snap, mode, mask in (
            ("(u1) 10k x 1k reference", pkg.synthetic_snapshot(10_000,
                                                               seed=1),
             "reference", None),
            ("(u1) 10k x 1k strict, taint-masked", strict, "strict", taint)):
        ff.LAUNCHES = 0
        b1, _, label = ff.sweep_snapshot_auto(snap, grid, mode=mode,
                                              node_mask=mask, device="cuda")
        out["launches"]["sweep_fit"][name] = ff.LAUNCHES
        if label != "cuda_i32_rcp_fused" or ff.LAUNCHES != 1:
            raise AssertionError(f"{name}: B1 took {label}, {ff.LAUNCHES} "
                                 "launches")
        healthy = None if mask is None else snap.healthy & mask
        nat = native.sweep(*snapshot_columns(snap), grid.cpu_request_milli,
                           grid.mem_request_bytes, mode=mode,
                           healthy=healthy)
        check_equal(f"{name} native vs B1", nat, b1)
        check_totals(name, fit, ff, snap, grid, nat, mode=mode, mask=mask)
        out["ms"][f"{name} native.sweep"] = host_median_ms(
            lambda: native.sweep(*snapshot_columns(snap),
                                 grid.cpu_request_milli,
                                 grid.mem_request_bytes, mode=mode,
                                 healthy=healthy), runs=5, warmup=1)
        out["ms"][f"{name} B1 sweep_snapshot_auto"] = host_median_ms(
            lambda: ff.sweep_snapshot_auto(snap, grid, mode=mode,
                                           node_mask=mask, device="cuda"))
        log(f"{name}: native.sweep = B1 ({label}, 1 launch) = exact on the "
            f"card = host; native.sweep "
            f"{out['ms'][f'{name} native.sweep']:.3f} ms (host, median of "
            f"5, {os.cpu_count()} CPUs), B1 end to end "
            f"{out['ms'][f'{name} B1 sweep_snapshot_auto']:.4f} ms (median "
            f"of 20) ({identity})")

    # (u2) the pod walk on (m)'s cluster, both semantics.
    live = live_fixture_source(pkg)
    n_pods = len(live["pods"])
    for semantics in ("reference", "strict"):
        kw = {"semantics": semantics}
        if semantics == "strict":
            kw["extended_resources"] = EXTENDED
        walked = snapshots.NATIVE_WALKS[semantics]
        t0 = time.perf_counter()
        with_walk = pkg.snapshot_from_fixture(live, **kw)
        walk_s = time.perf_counter() - t0
        if snapshots.NATIVE_WALKS[semantics] - walked != 1:
            raise AssertionError(f"(u2) {semantics}: the Python pod walk "
                                 "ran on a well-formed cluster")
        os.environ["KCC_DISABLE_NATIVE_INGEST"] = "1"
        try:
            t0 = time.perf_counter()
            pure = pkg.snapshot_from_fixture(live, **kw)
            pure_s = time.perf_counter() - t0
        finally:
            del os.environ["KCC_DISABLE_NATIVE_INGEST"]
        if snapshots.NATIVE_WALKS[semantics] - walked != 1:
            raise AssertionError(f"(u2) {semantics}: the walk ran while "
                                 "disabled")
        for f in dataclasses.fields(with_walk):
            a, b = getattr(with_walk, f.name), getattr(pure, f.name)
            same = (all(np.array_equal(a[r][k], b[r][k])
                        for r in a for k in (0, 1)) and a.keys() == b.keys()
                    if f.name == "extended" else
                    np.array_equal(a, b) if isinstance(a, np.ndarray)
                    else a == b)
            if not same:
                raise AssertionError(f"(u2) {semantics}: column {f.name} "
                                     "differs between the walks")
        out["ms"][f"(u2) pack {semantics} native walk"] = walk_s * 1e3
        out["ms"][f"(u2) pack {semantics} Python walk"] = pure_s * 1e3
        log(f"(u2) {semantics} pack of {LIVE_NODES} nodes, {n_pods} pods: "
            f"native walk {walk_s:.3f} s, Python walk {pure_s:.3f} s (host "
            f"clock, one pack each), every column equal")

    # (u3) kccap-client against a port server on the card.
    src = os.path.join(os.path.dirname(native.__file__), "kccap_client.cc")
    exe = os.path.join(tmp, "kccap-client")
    t0 = time.perf_counter()
    subprocess.run(["g++", "-O2", "-std=c++17", "-o", exe, src], check=True,
                   capture_output=True, timeout=300)
    out["ms"]["(u3) g++ kccap-client"] = (time.perf_counter() - t0) * 1e3
    for name, path, fx in (("kind-3node", KIND_FIXTURE, None),
                           ("(g)'s 10,000 nodes", g_path, fixture)):
        fx = fx if fx is not None else pkg.load_fixture(path)
        server = CapacityServer(pkg.snapshot_from_fixture(fx), fixture=fx,
                                port=0, device="cuda")
        server.start()
        try:
            host, port = server.address
            t0 = time.perf_counter()
            proc = subprocess.run([exe, "-server", f"{host}:{port}",
                                   *SPEC_FLAGS], capture_output=True,
                                  text=True, timeout=300)
            out["ms"][f"(u3) kccap-client {name}"] = \
                (time.perf_counter() - t0) * 1e3
        finally:
            server.shutdown()
        want = run_cli_text(cli, ["-snapshot", path, *SPEC_FLAGS])
        if proc.returncode != 0 or proc.stdout != want:
            raise AssertionError(f"(u3) {name}: kccap-client exit "
                                 f"{proc.returncode}, its output differs "
                                 f"from the CLI's: {proc.stderr[-500:]}")
    log(f"(u3) kccap-client (g++ {out['ms']['(u3) g++ kccap-client']:.0f} "
        f"ms) against a port server on the card: kind-3node and 10,000 "
        f"nodes byte-equal to the CLI, "
        f"{out['ms']['(u3) kccap-client (g)' + chr(39) + 's 10,000 nodes']:.1f}"
        f" ms at 10,000 nodes")

    # (u4) the sharded sweeps on one card, then two processes.
    snap = pkg.synthetic_snapshot(MESH_NODES, seed=31)
    grid = pkg.random_scenario_grid(8, seed=32)
    reqs = (grid.cpu_request_milli, grid.mem_request_bytes, grid.replicas)
    single = fit.sweep_snapshot(snap, grid, device="cuda")
    check_equal("(u4) single sweep vs the host", single[0],
                fit.sweep_snapshot(snap, grid, device="cpu")[0])
    out["ms"]["(u4) single-device sweep_snapshot"] = host_median_ms(
        lambda: fit.sweep_snapshot(snap, grid, device="cuda"), runs=5,
        warmup=1)
    arrays = fit.snapshot_device_arrays(snap, "cuda")
    card8 = [torch.device("cuda", 0)] * 8
    for name, fn, sp, np_ in (("shard_map 1x8", parallel.sweep_shard_map,
                               1, 8),
                              ("gspmd 2x4", parallel.sweep_gspmd, 2, 4)):
        plan = parallel.make_mesh(sp, np_, devices=card8)
        totals, sched = fn(plan, arrays, *reqs)
        if not (np.array_equal(totals, single[0])
                and np.array_equal(sched, single[1])):
            raise AssertionError(f"(u4) {name}: differs from the single "
                                 "sweep")
        out["ms"][f"(u4) {name}"] = host_median_ms(
            lambda: fn(plan, arrays, *reqs), runs=5, warmup=1)
    log(f"(u4) {MESH_NODES} nodes x 8 scenarios on [cuda:0] x 8: "
        f"shard_map 1x8 {out['ms']['(u4) shard_map 1x8']:.1f} ms, gspmd 2x4 "
        f"{out['ms']['(u4) gspmd 2x4']:.1f} ms, the single sweep "
        f"{out['ms']['(u4) single-device sweep_snapshot']:.1f} ms (host "
        f"clock, median of 5), totals and schedulable equal ({identity})")
    del arrays
    out["multihost"] = run_multihost(pkg, fit, identity)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"(u) {out['seconds']:.1f} s")
    return out


KERNELS = ("sweep_fit", "sweep_multi", "sweep_exact", "sweep_spread")
# A kernel's name and template arguments in its mangled symbol.
KERNEL_NAME = re.compile(r"(sweep_(?:fit|multi|exact)_kernel\w*?)I((?:L[ib]\d+E)+)E")
# The kernels of the main paths' rcp variants: B1 <rcp, strict, counts> and
# B2 with requests in registers <R, rcp, strict>.
MAIN_RCP = re.compile(r"sweep_fit_kernel<1,|sweep_multi_kernel_r<\d+,1,")
CONVERSIONS = ("I2F", "I2FP", "F2I", "F2IP", "FRND", "F2F")


def build_kernels(build, names: tuple[str, ...]) -> dict[str, float]:
    """Build every kernel library at once, one nvcc process each; returns
    each build's seconds (raises with nvcc's output if one fails)."""
    def timed(name):
        t0 = time.perf_counter()
        build.build(name)
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(timed, names)))


def log_ptxas(build, name: str) -> int:
    """Each kernel's registers as ptxas reports them (template arguments in
    brackets: B1 <rcp, strict, counts>; B2 <R, rcp, strict> with requests in
    registers, <rcp, strict, mask> with rows streamed); returns the bytes
    spilled over all of them."""
    kernel, spilled = "?", 0
    for line in build.ptxas_report(name).splitlines():
        if "Compiling entry" in line:
            kernel = kernel_label(line)
        elif "spill" in line:
            spilled += sum(int(x) for x in re.findall(r"(\d+) bytes spill",
                                                      line))
        elif "registers" in line:
            log(f"  {kernel}: {line.split(':', 1)[1].strip()}")
    return spilled


# SASS opcodes counted per kernel: the conversion pipe (I2F, F2I, FRND,
# F2F; I2FP is the conversion Hopper issues to the ALU), the multi-function
# unit, and the integer, float and shared-memory work of a cell.
SASS_OPS = ("I2F", "I2FP", "F2I", "F2IP", "FRND", "F2F", "MUFU", "IMAD",
            "ISETP", "IADD3", "LOP3", "SHF", "LEA", "SEL", "IMNMX", "VIMNMX",
            "FMUL", "FADD", "FMNMX", "LDS")
_SASS_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def _cuobjdump() -> str | None:
    found = shutil.which("cuobjdump")
    if found:
        return found
    cuda = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda, "bin", "cuobjdump")
    return path if os.path.exists(path) else None


def sass_kernels(tool: str, lib: str) -> dict[str, list[tuple[int, str, str]]]:
    """``cuobjdump -sass`` of a built library: for each kernel (mangled
    name), its instructions as (address, opcode, text without predicate),
    with branch labels resolved to addresses."""
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    kernels: dict[str, list] = {}
    cur, labels, pending = None, {}, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = kernels.setdefault(m.group(1), [])
            labels, pending = {}, []
            continue
        if cur is None:
            continue
        m = _SASS_LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _SASS_INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            body = re.sub(r"^@!?U?P[T0-9]+\s+", "", m.group(2).strip())
            for name in pending:
                labels[name] = addr
            pending = []
            for label, at in labels.items():  # labels defined so far
                body = body.replace(f"`({label})", hex(at))
            cur.append((addr, body.split()[0], body))
    return kernels


def hot_loop(instrs: list[tuple[int, str, str]]) -> list[tuple[int, str, str]]:
    """The per-cell loop: of the regions closed by a backward branch and
    free of barriers (a loop that stages a tile syncs the block), the one
    with the most shared-memory loads, the shortest among equals."""
    best, best_key = [], None
    for addr, op, body in instrs:
        if not op.startswith("BRA"):
            continue
        m = re.search(r"0x([0-9a-f]+)", body)
        if not m or int(m.group(1), 16) >= addr:
            continue
        lo = int(m.group(1), 16)
        region = [i for i in instrs if lo <= i[0] <= addr]
        if any(i[1].startswith("BAR") for i in region):
            continue
        key = (sum(i[1].startswith("LDS") for i in region), -len(region))
        if best_key is None or key > best_key:
            best, best_key = region, key
    return best


def sass_counts(instrs) -> dict[str, int]:
    counts = {op: 0 for op in SASS_OPS}
    for _, op, _ in instrs:
        base = op.split(".")[0]
        if base in counts:
            counts[base] += 1
    counts["total"] = len(instrs)
    return {k: v for k, v in counts.items() if v or k in
            ("I2F", "F2I", "FRND", "total")}


def kernel_label(symbol: str) -> str:
    """``sweep_multi_kernel_r<4,1,1>`` for a mangled kernel symbol."""
    m = KERNEL_NAME.search(symbol)
    if not m:
        return symbol
    return f"{m.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', m.group(2)))}>"


def phase_sass(build, names: tuple[str, ...]) -> dict:
    """SASS instruction counts of each kernel of each library: the whole
    kernel and its per-cell loop (:func:`hot_loop`), one line each.  A
    diagnostic, not a kernel path: without ``cuobjdump`` it says so and
    returns nothing."""
    tool = _cuobjdump()
    if tool is None:
        log("sass: cuobjdump not found on PATH or under CUDA_HOME; "
            "instruction counts skipped")
        return {}
    out = {}
    for name in names:
        lib = str(build.build(name))
        for symbol, instrs in sorted(sass_kernels(tool, lib).items()):
            kernel = kernel_label(symbol)
            out[kernel] = {"kernel": sass_counts(instrs),
                           "loop": sass_counts(hot_loop(instrs))}
            log(f"sass {kernel}: " + json.dumps(out[kernel]))
    return out


def check_sass(counts: dict) -> None:
    """The main paths' rcp kernels convert nothing in their per-cell loop."""
    main = {k: v for k, v in counts.items() if MAIN_RCP.search(k)}
    bad = {k: v["loop"] for k, v in main.items()
           if any(v["loop"].get(op, 0) for op in CONVERSIONS)}
    if bad:
        raise AssertionError(f"conversions in the per-cell loop: {bad}")
    log(f"sass: no {'/'.join(CONVERSIONS)} in the per-cell loop of the "
        f"{len(main)} main-path rcp kernels")


# ---------------------------------------------------------------------------
# Path (v): the static analyzer and the runtime sanitizer.  (v1) lints the
# package of this checkout; (v2) runs (b)'s strict server on the card with
# the sanitizer installed, under 16 clients x 20 folded sweeps, then the
# same load without it, then the hammer over seeds 0-2; (v3) counts what
# torch's sync debug mode flags around the device loops at two step counts.

V_CLIENTS = 16
V_SWEEPS = 20


def count_syncs(fn) -> tuple[int, dict]:
    """Synchronizing CUDA operations ``fn`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` flags them (the mode is
    off again before the caller synchronizes), and the Python lines that
    made them (``file:line`` → count)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    sites: dict = {}
    for w in caught:
        if "synchronizing" in str(w.message):
            key = f"{os.path.basename(w.filename)}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return sum(sites.values()), sites


def folded_load(server, want: list) -> tuple[list[float], list]:
    """``V_CLIENTS`` client threads, each sending ``V_SWEEPS`` sweeps of
    ``random_scenario_grid(1000, seed=7)``; returns every request's time
    (ms) and the failures (an error, or totals other than ``want``)."""
    from kubernetesclustercapacity_tpu_torch.service import CapacityClient

    times: list[float] = []
    bad: list = []
    lock = threading.Lock()
    barrier = threading.Barrier(V_CLIENTS)

    def client(t: int) -> None:
        try:
            with CapacityClient(*server.address, connect_timeout_s=60,
                                timeout_s=300, retry=None) as c:
                barrier.wait(timeout=60)
                for _ in range(V_SWEEPS):
                    t0 = time.perf_counter()
                    doc = c.sweep(random={"n": 1000, "seed": 7})
                    dt = (time.perf_counter() - t0) * 1e3
                    with lock:
                        times.append(dt)
                        if doc["totals"] != want:
                            bad.append(f"client {t}: totals differ")
        except Exception as e:  # noqa: BLE001 - raised by the caller
            with lock:
                bad.append(f"client {t}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(V_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        bad.append("a client thread did not finish")
    return times, bad


def phase_analysis(pkg, ff, identity: str) -> dict:
    """Path (v).  Returns the times, B1's launches and the sync counts."""
    from kubernetesclustercapacity_tpu_torch.analysis import cli as lint_cli
    from kubernetesclustercapacity_tpu_torch.analysis import hammer, sanitize
    from kubernetesclustercapacity_tpu_torch.analysis.callgraph import (
        CallGraph,
    )
    from kubernetesclustercapacity_tpu_torch.analysis.engine import (
        Baseline,
        Project,
    )
    from kubernetesclustercapacity_tpu_torch.ops import placement as pl
    from kubernetesclustercapacity_tpu_torch.optimize import lp
    from kubernetesclustercapacity_tpu_torch.service import (
        CapacityClient,
        CapacityServer,
    )
    from kubernetesclustercapacity_tpu_torch.topology import gang

    t_phase = time.perf_counter()
    out = {"ms": {}, "launches": {"sweep_fit": {}}, "syncs": {}}
    pkg_dir = os.path.dirname(os.path.abspath(pkg.__file__))
    repo_root = os.path.dirname(pkg_dir)

    # (v1) kccap-torch-lint --json over the package of this checkout.
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = lint_cli.run([pkg_dir, "--json"])
    lint_s = time.perf_counter() - t0
    counts = json.loads(buf.getvalue())["counts"]
    if rc != 0 or counts["findings"] or counts["baselined"]:
        raise AssertionError(f"(v1) kccap-torch-lint: exit {rc}, {counts}")
    graph = CallGraph.build(Project(pkg_dir))
    roots, reachable = len(graph.roots()), len(graph.reachable())
    if roots < 35 or reachable <= roots or graph.unresolved_roots:
        raise AssertionError(f"(v1) {roots} roots, {reachable} reachable, "
                             f"unresolved {graph.unresolved_roots}")
    out["lint"] = {"seconds": lint_s, "roots": roots,
                   "reachable": reachable, "markers": counts["suppressed"]}
    log(f"path (v1) kccap-torch-lint --json: 0 findings, 0 baselined, "
        f"{counts['suppressed']} admitted inline; {roots} device roots, "
        f"{reachable} functions reachable from them; {lint_s:.2f} s on the "
        "host")

    # (v2) (b)'s strict server on the card, with and without the sanitizer.
    fixture = pkg.synthetic_fixture(10_000, seed=3, taint_frac=0.1)
    strict = pkg.snapshot_from_fixture(fixture, semantics="strict")
    grid = pkg.random_scenario_grid(1000, seed=7)
    mask = pkg.implicit_taint_mask(strict)
    want = ff.sweep_snapshot_auto(strict, grid, mode="strict",
                                  node_mask=mask, device="cuda")[0]
    want = [int(x) for x in np.asarray(want)]
    baseline = Baseline.load(os.path.join(repo_root,
                                          "LINT_BASELINE_TORCH.json"))

    def serve_and_load(label: str) -> tuple[list[float], int]:
        server = CapacityServer(strict, device="cuda", batch_window_ms=5.0,
                                batch_max=V_CLIENTS,
                                max_inflight=2 * V_CLIENTS)
        server.start()
        try:
            with CapacityClient(*server.address, connect_timeout_s=60,
                                timeout_s=300, retry=None) as c:
                solo = c.sweep(random={"n": 1000, "seed": 7})["totals"]
            check_equal(f"(v2) {label} solo sweep vs sweep_snapshot_auto",
                        solo, want)
            ff.LAUNCHES = 0
            t0 = time.perf_counter()
            times, bad = folded_load(server, solo)
            wall = time.perf_counter() - t0
            launches = ff.LAUNCHES
            batch = server.batching_stats or {}
        finally:
            server.shutdown()
        if bad:
            raise AssertionError(f"(v2) {label}: {bad[:3]}")
        if len(times) != V_CLIENTS * V_SWEEPS or launches < 1:
            raise AssertionError(f"(v2) {label}: {len(times)} replies, B1 "
                                 f"launches {launches}")
        out["ms"][f"(v2) load wall, {label}"] = wall * 1e3
        out["ms"][f"(v2) p90 request, {label}"] = float(
            np.percentile(times, 90))
        out[f"batching_{label}"] = {
            k: batch.get(k) for k in ("dispatches", "mean_batch_size")}
        return times, launches

    gate = os.environ.get(sanitize.ENV_SWITCH)
    os.environ[sanitize.ENV_SWITCH] = "1"
    try:
        sanitize.install(seed=0, classes=hammer.instrument_targets(pkg_dir))
        try:
            on_times, on_launches = serve_and_load("sanitized")
            san = sanitize.current()
            found = sanitize.findings_of(san, repo_root)
            st = sanitize.stats_of(san)
        finally:
            sanitize.uninstall()
        part = sanitize.partition(found, baseline, repo_root)
        races = sum(f.rule == sanitize.RACE_RULE for f in part.findings)
        cycles = sum(f.rule == sanitize.ORDER_RULE for f in part.findings)
        if part.findings or st["field_events"] == 0:
            raise AssertionError(
                "(v2) the sanitizer found races or lock-order cycles on the "
                "card:\n" + "\n".join(f.render() for f in part.findings))
        off_times, off_launches = serve_and_load("plain")
        hammer_runs = []
        for seed in range(3):
            t0 = time.perf_counter()
            h_found, h_st = hammer.run(seed=seed, threads=V_CLIENTS,
                                       package_dir=pkg_dir)
            h_part = sanitize.partition(h_found, baseline, repo_root)
            if h_part.findings or h_st["threads_seen"] < V_CLIENTS:
                raise AssertionError(
                    f"(v2) hammer seed {seed}:\n"
                    + "\n".join(f.render() for f in h_part.findings))
            hammer_runs.append({"seed": seed,
                                "s": time.perf_counter() - t0,
                                "classes": h_st["instrumented_classes"],
                                "field_events": h_st["field_events"],
                                "raw_races": h_st["races"]})
    finally:
        if gate is None:
            os.environ.pop(sanitize.ENV_SWITCH, None)
        else:
            os.environ[sanitize.ENV_SWITCH] = gate
    out["launches"]["sweep_fit"]["(v2) sanitized 16 x 20"] = on_launches
    out["launches"]["sweep_fit"]["(v2) plain 16 x 20"] = off_launches
    on_ms, off_ms = statistics.median(on_times), statistics.median(off_times)
    out["ms"]["(v2) median request, sanitized"] = on_ms
    out["ms"]["(v2) median request, plain"] = off_ms
    out["sanitizer"] = {"races": races, "cycles": cycles,
                        "raw_races": st["races"],
                        "suppressed": len(part.suppressed),
                        "field_events": st["field_events"],
                        "lock_events": st["lock_events"],
                        "instrumented_classes": st["instrumented_classes"],
                        "hammer": hammer_runs}
    log(f"path (v2) strict 10k-node server on the card, {V_CLIENTS} clients "
        f"x {V_SWEEPS} folded sweeps of 1000: every total equal to the solo "
        f"sweep; sanitized: B1 launches {on_launches}, median request "
        f"{on_ms:.3f} ms, 0 races, 0 lock-order cycles "
        f"({st['field_events']} field events, {st['lock_events']} lock "
        f"events, {st['races']} raw races, {len(part.suppressed)} admitted "
        f"inline); plain: B1 launches {off_launches}, median request "
        f"{off_ms:.3f} ms; loads of {V_CLIENTS * V_SWEEPS} requests "
        f"{out['ms']['(v2) load wall, sanitized'] / 1e3:.2f} / "
        f"{out['ms']['(v2) load wall, plain'] / 1e3:.2f} s, folds "
        f"{out['batching_sanitized']} / {out['batching_plain']} "
        f"({identity})")
    log("path (v2) hammer, 16 threads, seeds 0-2: 0 findings ("
        + ", ".join(f"seed {h['seed']} {h['s']:.1f} s" for h in hammer_runs)
        + f", {hammer_runs[0]['classes']} classes)")

    # (v3) the static host-sync claim, checked at run time.
    dev = torch.device("cuda")
    cols = (strict.alloc_cpu_milli, strict.alloc_mem_bytes,
            strict.alloc_pods, strict.used_cpu_req_milli,
            strict.used_mem_req_bytes, strict.pods_count, strict.healthy)

    def place(steps: int):
        return lambda: pl.place_replicas(
            *cols, 500, 512 << 20, n_replicas=steps, policy="best-fit",
            node_mask=mask, device="cuda")

    rng = np.random.default_rng(5)
    s_, g_ = 64, 256
    caps = rng.random((s_, g_, 3)) * rng.integers(1, 10**6, (s_, 1, 1))
    demand = rng.integers(1, 10**7, s_).astype(np.float64)
    scale = np.maximum(1.0, np.minimum(demand, caps.min(axis=2).sum(axis=1)))
    state = [torch.from_numpy(a).to(dev) for a in (
        caps, demand, scale, rng.random((s_, g_)),
        rng.random((s_, g_, 3)) * 0.1, rng.random(s_))]

    def pdhg(iters: int):
        return lambda: lp._pdhg_chunk(*state, iters=iters)

    sub = torch.from_numpy(rng.integers(0, 4000, size=(64, 400))).to(dev)
    parent = torch.from_numpy(rng.integers(-1, 8, size=400)).to(dev)

    def spread(mult: int):
        return lambda: gang._gangs_spread(sub * mult, parent, 16, 4, n_co=8)

    cases = {
        "place_replicas": ((64, place(64)), (256, place(256))),
        "_pdhg_chunk": ((50, pdhg(50)), (500, pdhg(500))),
        "_gangs_spread": ((1, spread(1)), (1 << 20, spread(1 << 20))),
    }
    sites = {}
    for name, ((lo, fn_lo), (hi, fn_hi)) in cases.items():
        fn_lo(), fn_hi()  # warm: first-use allocations are not the loop's
        torch.cuda.synchronize()
        # Three counts of each, interleaved: the gate compares the least
        # of each, so a wait that happens once in a while (not once per
        # step) cannot decide it.
        runs = {lo: [], hi: []}
        for _ in range(3):
            for steps, fn in ((lo, fn_lo), (hi, fn_hi)):
                n, where = count_syncs(fn)
                runs[steps].append(n)
                sites.setdefault(name, {}).update(where)
        out["syncs"][name] = {str(k): v for k, v in runs.items()}
        if min(runs[hi]) > min(runs[lo]):
            raise AssertionError(f"(v3) {name}: {runs[lo]} syncs at {lo}, "
                                 f"{runs[hi]} at {hi}: a wait per step")
    out["sync_sites"] = sites
    steps = {m: gang._search_steps((sub * m).sum(dim=1)) for m in (1, 1 << 20)}
    log("path (v3) sync debug mode around the device loops: "
        + "; ".join(f"{k} {v}" for k, v in out["syncs"].items())
        + f" (gang search steps {steps[1]} and {steps[1 << 20]}); the least "
        "count does not grow with the steps, as device-purity's 0 host-sync "
        f"findings say; flagged at {sites} ({identity})")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"(v) B1 launches on the path: {on_launches + off_launches}; "
        f"path (v) took {out['seconds']:.1f} s")
    return out


# Path (w): the twins of examples/ in examples_torch/.  The twins that must
# launch a kernel on the card, and the twins whose output the same twin on
# the host must print again, line for line (the CPU tests hold the host's
# output against the JAX script's).
EXAMPLE_LAUNCHES = {
    "02_what_if_sweep.py": ("sweep_fit", "sweep_multi"),
    "12_million_node_sweep.py": ("sweep_fit",),
}
EXAMPLE_HOST_PARITY = (
    "01_reference_run.py", "02_what_if_sweep.py",
    "03_constraints_and_placement.py", "12_million_node_sweep.py",
    "14_capacity_at_risk.py", "16_gang_capacity.py",
    "17_optimized_packing.py", "20_forecast_and_plan.py",
)
_DURATION = re.compile(r"\d(?:\.\d+)?\s?(?:ms|s)\b")


def example_lines(text: str) -> list[str]:
    """A twin's stdout without the lines that carry a duration, with the
    card's kernel labels (``cuda_``) written as the host's (``plain_``)."""
    return [line.replace("cuda_", "plain_") for line in text.splitlines()
            if not _DURATION.search(line)]


def run_example(path: str, device: str) -> tuple[str, bool]:
    """Run one twin's ``main`` in this process, asserts live, on
    ``device`` where it takes one.  Its stdout, and whether it did."""
    import importlib.util
    import inspect

    name = os.path.basename(path)
    spec = importlib.util.spec_from_file_location(
        f"example_torch_{name[:-3]}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    buf = io.StringIO()
    try:
        spec.loader.exec_module(mod)
        takes_device = "device" in inspect.signature(mod.main).parameters
        with contextlib.redirect_stdout(buf):
            if takes_device:
                mod.main(device=device)
            else:
                mod.main()
    finally:
        sys.modules.pop(spec.name, None)
    return buf.getvalue(), takes_device


def phase_examples(ff, fm, identity: str) -> dict:
    """Path (w).  Every twin in ``examples_torch/`` in this process with
    its asserts live: the device twins on the card (``device="cuda"``),
    the two host-only ones (the analyzer, the sanitizer) as they are.
    The launch counts are set to 0 before each twin and read after it.
    Returns the seconds and the launches by twin."""
    root = os.path.dirname(os.path.abspath(__file__))
    directory = os.path.join(root, "examples_torch")
    names = sorted(f for f in os.listdir(directory) if f.endswith(".py"))
    missing = sorted(set(f for f in os.listdir(os.path.join(root, "examples"))
                         if f.endswith(".py")) - set(names))
    if missing:
        raise AssertionError(f"(w) no twin in examples_torch/ for {missing}")
    out_dir = os.path.join(root, "chiprun_out", "examples")
    os.makedirs(out_dir, exist_ok=True)
    for var in ("KCCAP_SANITIZE", "KCC_EXAMPLE_NODES", "KCCAP_GROUPING",
                "KCCAP_GROUP_MIN_COUNT"):
        if var in os.environ:
            raise AssertionError(f"(w) {var} is set: the twins run at their "
                                 "own defaults")
    t_phase = time.perf_counter()
    out = {"s": {}, "launches": {"sweep_fit": {}, "sweep_multi": {}},
           "host_parity_s": {}}
    for name in names:
        path = os.path.join(directory, name)
        ff.LAUNCHES = fm.LAUNCHES = 0
        t0 = time.perf_counter()
        text, takes_device = run_example(path, "cuda")
        seconds = time.perf_counter() - t0
        b1, b2 = ff.LAUNCHES, fm.LAUNCHES
        out["s"][name] = seconds
        out["launches"]["sweep_fit"][name] = b1
        out["launches"]["sweep_multi"][name] = b2
        with open(os.path.join(out_dir, name[:-3] + ".txt"), "w",
                  encoding="utf-8") as fh:
            fh.write(text)
        if not text.strip():
            raise AssertionError(f"(w) {name} printed nothing")
        need = EXAMPLE_LAUNCHES.get(name, ())
        for kernel, n in (("sweep_fit", b1), ("sweep_multi", b2)):
            if kernel in need and n == 0:
                raise AssertionError(f"(w) {name} launched {kernel} 0 times")
        last = text.strip().splitlines()[-1]
        log(f"(w) {name}: {seconds:.2f} s on "
            f"{'cuda' if takes_device else 'the host (host-only twin)'}, "
            f"B1 {b1}, B2 {b2} launches, {len(text.splitlines())} lines; "
            f"last: {last[:100]}")
        if name in EXAMPLE_HOST_PARITY:
            # The same twin on the host, outside the launch counts.
            t0 = time.perf_counter()
            host, _ = run_example(path, "cpu")
            out["host_parity_s"][name] = time.perf_counter() - t0
            card_lines, host_lines = example_lines(text), example_lines(host)
            if card_lines != host_lines:
                diff = [(c, h) for c, h in zip(card_lines, host_lines)
                        if c != h][:3]
                raise AssertionError(
                    f"(w) {name} on the card differs from the host: "
                    f"{len(card_lines)} against {len(host_lines)} lines, "
                    f"first differences {diff}")
            log(f"(w) {name}: the card's {len(card_lines)} lines equal the "
                f"host's (durations dropped, cuda_ read as plain_)")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"(w) {len(names)} twins, {sum(out['s'].values()):.1f} s on the card, "
        f"{sum(out['host_parity_s'].values()):.1f} s of host reruns; B1 "
        f"{sum(out['launches']['sweep_fit'].values())}, B2 "
        f"{sum(out['launches']['sweep_multi'].values())} launches; path (w) "
        f"took {out['seconds']:.1f} s ({identity})")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--multihost-worker"]:
        return multihost_worker(sys.argv[2:])
    if sys.argv[1:] == ["--sass-only"]:
        from kubernetesclustercapacity_tpu_torch.ops import _build

        phase_sass(_build, KERNELS)
        return 0
    import kubernetesclustercapacity_tpu_torch as pkg
    from kubernetesclustercapacity_tpu_torch import cli
    from kubernetesclustercapacity_tpu_torch.ops import _build
    from kubernetesclustercapacity_tpu_torch.ops import fit
    from kubernetesclustercapacity_tpu_torch.ops import fused_fit as ff
    from kubernetesclustercapacity_tpu_torch.ops import fused_multi as fm

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
    seconds = build_kernels(_build, KERNELS)
    log(f"build: csrc/{', '.join(KERNELS)}.cu together in "
        f"{time.perf_counter() - t0:.2f} s ("
        + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items())
        + f"; {' '.join(_build.NVCC_FLAGS)})")
    spilled = sum(log_ptxas(_build, k) for k in KERNELS)
    if spilled:
        raise AssertionError(f"ptxas spilled {spilled} bytes")
    log("ptxas: no spills in any kernel")
    sass = phase_sass(_build, KERNELS)
    if sass:
        check_sass(sass)

    calls, max_err = phase_kernel_vs_plain(ff, device)
    multi_calls, multi_max_err = phase_multi_kernel_vs_plain(fm, device)
    exact_calls, exact_max_err = phase_exact_kernel_vs_plain(pkg, fit,
                                                             device)
    with tempfile.TemporaryDirectory() as tmp:
        launches, exact_main = phase_main_path(pkg, cli, fit, ff, tmp)
        multi_paths = phase_multi_paths(pkg, cli, ff, fm, tmp)
        single = phase_single_spec(pkg, cli, fit, ff, fm, tmp, identity)
    phase_exact_adversarial(fit)
    fused = phase_fused_programs(pkg, ff, identity)
    model = phase_model(pkg, ff, fm, multi_paths["f_args"], identity)
    with tempfile.TemporaryDirectory() as tmp:
        service = phase_service(pkg, cli, fit, ff, fm, multi_paths["f_args"],
                                tmp, identity)
    with tempfile.TemporaryDirectory() as tmp:
        live = phase_live(pkg, cli, fit, ff, fm, tmp, identity)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after path (m)")
    with tempfile.TemporaryDirectory() as tmp:
        sched = phase_scheduling(pkg, cli, fit, ff, fm, tmp, identity)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after path (n)")
    with tempfile.TemporaryDirectory() as tmp:
        stoch = phase_stochastic(pkg, cli, ff, fm, tmp, identity)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after path (o)")
    with tempfile.TemporaryDirectory() as tmp:
        gopt = phase_gang_opt(pkg, cli, ff, fm, tmp, identity)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after path (p)")
    with tempfile.TemporaryDirectory() as tmp:
        oper = phase_operator(pkg, cli, fit, ff, fm, tmp, identity,
                              live["times"]["staleness_ms"])
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after path (q)")
    with tempfile.TemporaryDirectory() as tmp:
        repl = phase_replicated(pkg, cli, ff, fm, tmp, identity)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after path (r)")
    with tempfile.TemporaryDirectory() as tmp:
        fed = phase_federation(pkg, cli, ff, fm, tmp, identity)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after paths (s) "
        "and (t)")
    with tempfile.TemporaryDirectory() as tmp:
        nat = phase_native_parallel(pkg, cli, fit, ff, tmp, identity,
                                    single.pop("transcripts"))
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after path (u)")
    ana = phase_analysis(pkg, ff, identity)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after path (v)")
    ex = phase_examples(ff, fm, identity)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after path (w)")
    main_launches = {"(a)": launches["(a) 10k x 1k reference"],
                     "(b)": launches["(b) 10k x 1k strict, taint-masked"],
                     "(c)": launches["(c) 100k grouped (48 shapes) x 1k"]}
    rows = phase_times(pkg, ff, device, identity, clock_hz, main_launches)
    floor = launch_floor_ms(clock_hz)
    log(f"launch floor: a one-element fill times {floor:.6f} ms by the same "
        "method")
    e2e = phase_end_to_end(pkg, ff)
    multi_rows_timed = phase_multi_times(fm, multi_paths, identity,
                                         clock_hz)
    exact_rows = phase_exact_times(pkg, fit, device, identity, clock_hz)
    spread_row = phase_spread_times(pkg, fit, device, identity, clock_hz)
    multi_e2e = phase_multi_end_to_end(fm, multi_paths["f_args"])

    print(json.dumps({"paths": {
        "single_spec_cli_s": single["seconds"],
        "single_spec_totals": single["totals"],
        "single_spec_launches": single["launches"],
        "fused_programs_ms": fused,
        "model_ms": model["ms"],
        "model_launches": model["launches"],
        "service_ops": service["ops"],
        "service_shares": service["shares"],
        "service_launches": service["launches"],
        "live": live["times"],
        "live_launches": live["launches"],
        "scheduling_ms": sched["ms"],
        "scheduling_launches": sched["launches"],
        "stochastic_ms": stoch["ms"],
        "stochastic_launches": stoch["launches"],
        "stochastic_sampler_mismatches": stoch["sampler_mismatches"],
        "stochastic_s": stoch["seconds"],
        "stochastic_trace": stoch.get("trace"),
        "gang_opt_ms": gopt["ms"],
        "gang_opt_launches": gopt["launches"],
        "gang_opt_solves": gopt["opt"],
        "gang_opt_s": gopt["seconds"],
        "gang_opt_trace": {k: gopt.get(k) for k in ("trace_gang",
                                                    "trace_opt")},
        "operator_ms": oper["ms"],
        "operator_launches": oper["launches"],
        "operator_generations": oper["generations"],
        "operator_healthz": [(p["stage"], p["code"])
                             for p in oper["healthz"]],
        "operator_s": oper["seconds"],
        "replicated_ms": repl["ms"],
        "replicated_launches": repl["launches"],
        "replicated_replay_counts": repl["replay_counts"],
        "replicated_shadow": repl["shadow"],
        "replicated_tenants": repl["tenants"],
        "replicated_log_bytes": repl["log_bytes"],
        "replicated_s": repl["seconds"],
        "federation_bench": {k: v for k, v in fed["s1"].items()
                             if k != "launches"},
        "federation_ms": fed["ms"],
        "federation_rc": fed["rc"],
        "federation_launches": fed["launches"],
        "federation_dropped_frames": fed["dropped_frames"],
        "diagnostics_profile": fed["profile"],
        "diagnostics_doctor_probe": fed["doctor_probe"],
        "diagnostics_trace_dominant": fed["trace_dominant"],
        "diagnostics_jax_profile": fed["jax_profile"],
        "federation_s": fed["seconds"],
        "native_parallel_ms": nat["ms"],
        "native_parallel_launches": nat["launches"],
        "native_parallel_multihost": nat["multihost"],
        "native_parallel_s": nat["seconds"],
        "analysis_lint": ana["lint"],
        "analysis_ms": ana["ms"],
        "analysis_launches": ana["launches"],
        "analysis_sanitizer": ana["sanitizer"],
        "analysis_syncs": ana["syncs"],
        "analysis_sync_sites": ana["sync_sites"],
        "analysis_batching": [ana["batching_sanitized"],
                              ana["batching_plain"]],
        "analysis_s": ana["seconds"],
        "examples_s": ex["seconds"],
        "examples_ms": {k: v * 1e3 for k, v in ex["s"].items()},
        "examples_launches": ex["launches"],
        "examples_host_parity_s": ex["host_parity_s"],
        "gpu": identity,
    }}), flush=True)
    head = rows[0]
    kernels = {"kernels": [{
        "name": "sweep_fit",
        "route": "cuda",
        "source": "kubernetesclustercapacity_tpu_torch/csrc/sweep_fit.cu",
        "replaces": "kubernetesclustercapacity_tpu/ops/pallas_fit.py:450",
        "launches": sum(main_launches.values())
        + sum(model["launches"]["sweep_fit"].values())
        + sum(service["launches"]["sweep_fit"].values())
        + sum(live["launches"]["sweep_fit"].values())
        + sum(sched["launches"]["sweep_fit"].values())
        + sum(stoch["launches"]["sweep_fit"].values())
        + sum(gopt["launches"]["sweep_fit"].values())
        + sum(oper["launches"]["sweep_fit"].values())
        + sum(repl["launches"]["sweep_fit"].values())
        + sum(fed["launches"]["sweep_fit"].values())
        + sum(nat["launches"]["sweep_fit"].values())
        + sum(ana["launches"]["sweep_fit"].values())
        + sum(ex["launches"]["sweep_fit"].values()),
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
        "launch_floor_ms": floor,
        **e2e,
        "gpu": identity,
    }, {
        "name": "sweep_multi",
        "route": "cuda",
        "source": "kubernetesclustercapacity_tpu_torch/csrc/sweep_multi.cu",
        "replaces": "kubernetesclustercapacity_tpu/ops/pallas_multi.py:165",
        "launches": sum(multi_paths["launches"].values())
        + sum(model["launches"]["sweep_multi"].values())
        + sum(service["launches"]["sweep_multi"].values())
        + sum(live["launches"]["sweep_multi"].values())
        + sum(sched["launches"]["sweep_multi"].values())
        + sum(stoch["launches"]["sweep_multi"].values())
        + sum(gopt["launches"]["sweep_multi"].values())
        + sum(oper["launches"]["sweep_multi"].values())
        + sum(repl["launches"]["sweep_multi"].values())
        + sum(fed["launches"]["sweep_multi"].values())
        + sum(ex["launches"]["sweep_multi"].values()),
        "max_abs_err": multi_max_err,
        "ms": multi_rows_timed[0]["ms"],
        "plain_ms": multi_rows_timed[0]["plain_ms"],
        "bound_ms": multi_rows_timed[0]["bound_ms"],
        "bound_by": multi_rows_timed[0]["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes this function",
        "shape": multi_rows_timed[0]["shape"],
        "variants_checked": len(MULTI_VARIANTS),
        "checked_calls": multi_calls,
        "variants": multi_rows_timed,
        "launch_floor_ms": floor,
        **multi_e2e,
        "gpu": identity,
    }, {
        "name": "sweep_exact",
        "route": "cuda",
        "source": "kubernetesclustercapacity_tpu_torch/csrc/sweep_exact.cu",
        "replaces": None,
        "replaces_note": "no TPU kernel: the exact int64 program, XLA's "
                         "elementwise ops in the JAX package",
        # Path (d)'s own run: the main path's exact route.
        "launches": sum(exact_main.values()),
        "max_abs_err": exact_max_err,
        "ms": exact_rows[0]["ms"],
        "plain_ms": exact_rows[0]["plain_ms"],
        "bound_ms": exact_rows[0]["bound_ms"],
        "bound_by": exact_rows[0]["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes this function",
        "shape": exact_rows[0]["shape"],
        "checked_calls": exact_calls,
        "variants": exact_rows,
        "launch_floor_ms": floor,
        "gpu": identity,
    }, {
        "name": "sweep_spread",
        "route": "cuda",
        "source": "kubernetesclustercapacity_tpu_torch/csrc/sweep_spread.cu",
        "replaces": None,
        "replaces_note": "no TPU kernel: the grid topology spread's "
                         "per-node program and zone fold, XLA's "
                         "elementwise ops in the JAX package",
        # Path (n5)'s grid spread.
        "launches": sum(sched["launches"]["sweep_spread"].values()),
        "ms": spread_row["ms"],
        "plain_ms": spread_row["plain_ms"],
        "bound_ms": spread_row["bound_ms"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes this function",
        "shape": spread_row["shape"],
        "variants": [spread_row],
        "launch_floor_ms": floor,
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
