"""The port's exact int64 program against ``kubernetesclustercapacity_tpu.
ops.fit``: per-node fits and totals, bit for bit, on the CPU.

Inputs are those of ``tests/test_fit_kernel.py`` (hostile wrapped bit
patterns, INT64_MIN headroom, requests of 1 and non-KiB memory requests)
plus wrapped CPU requests, in both modes, masked and unmasked, grouped and
ungrouped.  Tolerance: none — every result is an integer.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import exact_edges
import numpy as np
import pytest
import torch

from kubernetesclustercapacity_tpu.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu.ops import fit as j_fit
from kubernetesclustercapacity_tpu.snapshot import (
    snapshot_from_fixture,
    synthetic_snapshot,
)
from kubernetesclustercapacity_tpu_torch.ops import _build
from kubernetesclustercapacity_tpu_torch.ops import fit as t_fit
from kubernetesclustercapacity_tpu_torch.snapshot import ClusterSnapshot

MIB = 1024 * 1024
INT64_MIN = -(2**63)
MODES = ["reference", "strict"]
COLS = (
    "alloc_cpu_milli", "alloc_mem_bytes", "alloc_pods", "used_cpu_req_milli",
    "used_mem_req_bytes", "pods_count", "healthy",
)


def _adversarial_columns(seed, n=257):
    rng = np.random.default_rng(seed)

    def mixed(lo, hi):
        vals = rng.integers(lo, hi, size=n, dtype=np.int64)
        hostile = rng.random(n) < 0.1
        return np.where(
            hostile, rng.integers(-(2**62), 2**62, size=n, dtype=np.int64),
            vals,
        )

    cols = [
        mixed(0, 10**6), mixed(0, 2**45), rng.integers(0, 200, n),
        mixed(0, 10**6), mixed(0, 2**45), rng.integers(0, 300, n),
        rng.random(n) < 0.8,
    ]
    # Full-range uint64 CPU patterns and INT64_MIN memory headroom.
    cols[0][:4] = [-1, INT64_MIN, 5, 2**63 - 1]
    cols[3][:4] = [INT64_MIN, -1, 2**63 - 1, 0]
    cols[1][4:6] = [0, 2**63 - 1]
    cols[4][4:6] = [INT64_MIN, -1]
    return cols, rng


# (cpu, mem) request pairs: the fixture tests' plus wrapped uint64 CPU.
REQUESTS = (
    np.array([100, 1, 123457, 100, -5, INT64_MIN, 2**62 + 1, 7], np.int64),
    np.array([MIB, 1, 987654321, 3, 7, 1024, MIB, 2**62], np.int64),
)


def _torch(cols):
    return [torch.from_numpy(np.ascontiguousarray(c)) for c in cols]


def _jax_grid(cols, cpu, mem, reps, mode, mask):
    out = j_fit.sweep_grid(
        *cols, cpu, mem, reps, mode=mode, node_mask=mask,
        return_per_node=True,
    )
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("seed", [10, 11, 12])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("masked", [False, True])
def test_adversarial_sweep_grid(seed, mode, masked):
    cols, rng = _adversarial_columns(seed)
    cpu, mem = REQUESTS
    reps = rng.integers(-5, 3000, size=cpu.size)
    mask = rng.random(cols[0].size) < 0.7 if masked else None
    want = _jax_grid(cols, cpu, mem, reps, mode, mask)
    got = t_fit.sweep_grid(
        *_torch(cols), *_torch([cpu, mem, reps]), mode=mode,
        node_mask=None if mask is None else torch.from_numpy(mask),
        return_per_node=True,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("mode", MODES)
def test_single_scenario_fit_per_node(mode):
    cols, _ = _adversarial_columns(3)
    for c, m in zip(*REQUESTS):
        want = np.asarray(j_fit.fit_per_node(*cols, int(c), int(m), mode=mode))
        got = t_fit.fit_per_node(
            *_torch(cols), torch.tensor(int(c)), torch.tensor(int(m)),
            mode=mode,
        )
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mem_req", [3, 7, 1024])
def test_int64_min_headroom(mem_req):
    cols = [
        np.array([10_000], np.int64), np.array([0], np.int64),
        np.array([10**12], np.int64), np.array([0], np.int64),
        np.array([INT64_MIN], np.int64), np.array([0], np.int64),
        np.ones(1, dtype=bool),
    ]
    want = np.asarray(j_fit.fit_per_node(*cols, 100, mem_req))
    got = t_fit.fit_per_node(
        *_torch(cols), torch.tensor(100), torch.tensor(mem_req)
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_unsigned_division_against_python_ints():
    rng = np.random.default_rng(5)
    edge = [0, 1, 2, 3, -1, -2, INT64_MIN, INT64_MIN + 1, 2**63 - 1,
            2**62, -(2**62), 12345, -12345]
    a = np.concatenate([
        np.array(edge, np.int64),
        rng.integers(INT64_MIN, 2**63 - 1, size=400, dtype=np.int64),
    ])
    d = np.concatenate([
        np.array([1, 1, 2, 3, -1, 7, -3, INT64_MIN, 2**63 - 1, 5, 9, 1, 2],
                 np.int64),
        rng.integers(INT64_MIN, 2**63 - 1, size=400, dtype=np.int64),
    ])
    d[d == 0] = 1
    got = t_fit._u64_div(torch.from_numpy(a), torch.from_numpy(d)).numpy()
    au = a.astype(np.uint64).tolist()
    du = d.astype(np.uint64).tolist()
    want = np.array([x // y for x, y in zip(au, du)], np.uint64).astype(
        np.int64
    )
    np.testing.assert_array_equal(got, want)
    le = t_fit._u64_le(torch.from_numpy(a), torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(le, [x <= y for x, y in zip(au, du)])


@pytest.mark.parametrize("mode", MODES)
def test_strict_fixture_with_unhealthy_nodes(mode):
    fx = synthetic_fixture(40, seed=9, unhealthy_frac=0.3,
                           unscheduled_running_pods=5)
    snap = snapshot_from_fixture(fx, semantics="strict")
    cols = [getattr(snap, f) for f in COLS]
    cpu = np.array([100, 250, 1], np.int64)
    mem = np.array([MIB, 3, 1], np.int64)
    reps = np.array([1, 10, 100], np.int64)
    want = _jax_grid(cols, cpu, mem, reps, mode, None)
    got = t_fit.sweep_grid(*_torch(cols), *_torch([cpu, mem, reps]),
                           mode=mode, return_per_node=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("mode", MODES)
def test_grouped_program_matches(mode):
    cols, rng = _adversarial_columns(21, n=64)
    counts = rng.integers(0, 2**40, size=64)
    counts[:3] = [0, 1, 2**62]  # zero-count rows and a wrapping weight
    cpu, mem = REQUESTS
    reps = rng.integers(0, 10, size=cpu.size)
    want = j_fit.sweep_grid_grouped(
        *cols, counts, cpu, mem, reps, mode=mode, return_per_group=True
    )
    got = t_fit.sweep_grid_grouped(
        *_torch(cols), torch.from_numpy(counts), *_torch([cpu, mem, reps]),
        mode=mode, return_per_group=True,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _snapshot_pair(jsnap):
    return ClusterSnapshot.from_columns(
        {f: getattr(jsnap, f) for f in (
            "alloc_cpu_milli", "alloc_mem_bytes", "alloc_pods",
            "used_cpu_req_milli", "used_cpu_lim_milli", "used_mem_req_bytes",
            "used_mem_lim_bytes", "pods_count", "healthy")},
        names=list(jsnap.names), semantics=jsnap.semantics,
    )


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("masked", [False, True])
def test_staged_grouped_sweep_and_expansion(mode, masked):
    jsnap = synthetic_snapshot(2048, seed=6, shapes=12, kib_quantized=False)
    jsnap.healthy[::7] = False
    tsnap = _snapshot_pair(jsnap)
    mask = None
    if masked:
        mask = np.random.default_rng(1).random(2048) < 0.5
    cpu = np.array([1, 100, 4000, 7], np.int64)
    mem = np.array([1, MIB + 3, 2**33, 1024], np.int64)
    reps = np.array([0, 10**6, 5, 2**40], np.int64)
    want = j_fit.sweep_grouped_bucketed(
        jsnap.grouped(), cpu, mem, reps, mode=mode, node_mask=mask,
        return_per_node=True,
    )
    got = t_fit.sweep_grouped_staged(
        tsnap.grouped(), cpu, mem, reps, mode=mode, node_mask=mask,
        return_per_node=True, device="cpu",
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # Grouped equals the ungrouped per-node program.
    flat = t_fit.sweep_grid_staged(
        *[getattr(tsnap, f) for f in COLS], cpu, mem, reps, mode=mode,
        node_mask=mask, return_per_node=True, snapshot=tsnap, device="cpu",
    )
    for g, w in zip(flat, want):
        np.testing.assert_array_equal(g, w)


def test_scenario_blocks_cover_every_scenario(monkeypatch):
    cols, rng = _adversarial_columns(30, n=100)
    cpu = rng.integers(1, 5000, size=37)
    mem = rng.integers(1, 2**30, size=37)
    reps = rng.integers(0, 100, size=37)
    want = _jax_grid(cols, cpu, mem, reps, "reference", None)
    monkeypatch.setattr(t_fit, "BLOCK_CELLS", 250)  # 2 scenarios a block
    got = t_fit.sweep_grid(*_torch(cols), *_torch([cpu, mem, reps]),
                           return_per_node=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_empty_shapes():
    cols = [np.zeros(0, np.int64)] * 6 + [np.zeros(0, bool)]
    totals, sched, fits = t_fit.sweep_grid(
        *_torch(cols), *_torch([np.array([5]), np.array([5]),
                                np.array([1])]),
        return_per_node=True,
    )
    assert totals.tolist() == [0] and sched.tolist() == [False]
    assert tuple(fits.shape) == (1, 0)
    cols = [np.ones(3, np.int64)] * 6 + [np.ones(3, bool)]
    empty = np.zeros(0, np.int64)
    totals, sched = t_fit.sweep_grid(*_torch(cols),
                                     *_torch([empty, empty, empty]))
    assert totals.shape == (0,) and sched.shape == (0,)


def test_unknown_mode_rejected():
    cols, _ = _adversarial_columns(1, n=8)
    with pytest.raises(ValueError):
        t_fit.sweep_grid(*_torch(cols), *_torch([np.array([1])] * 3),
                         mode="bogus")


# -- the exact sweep without per-node fits, which on CUDA tensors is the
# exact kernel (``csrc/sweep_exact.cu``): on the CPU its plain version,
# against the JAX package; the kernel's per-node and per-cell functions
# compiled as host code, against ``fit_per_node`` and the JAX package.

def _jax_totals(cols, cpu, mem, reps, mask, counts, mode):
    if counts is None:
        return j_fit.sweep_grid(*cols, cpu, mem, reps, mode=mode,
                                node_mask=mask)
    return j_fit.sweep_grid_grouped(*cols, counts, cpu, mem, reps, mode=mode)


def _plain_totals(cols, cpu, mem, reps, mask, counts, mode):
    """The exact sweep's totals through ``sweep_grid`` or
    ``sweep_grid_grouped`` on CPU tensors: the kernel's plain version."""
    scen = _torch([cpu, mem, reps])
    if counts is None:
        return t_fit.sweep_grid(
            *_torch(cols), *scen, mode=mode,
            node_mask=None if mask is None else torch.from_numpy(mask))
    return t_fit.sweep_grid_grouped(*_torch(cols), torch.from_numpy(counts),
                                    *scen, mode=mode)


# The card tests' shapes small enough for the JAX package on the CPU: the
# card tests hold the kernel against the plain version on these very inputs
# (same generator, same seeds), so the kernel meets the JAX package through
# it (the JAX package does not run on the card).
_CARD_SHAPES = [(n, s) for n, s in exact_edges.KERNEL_SHAPES
                if n * s <= 1 << 21]


@pytest.mark.parametrize("n,s", [(257, 1), (257, 257), (64, 32_000),
                                 (0, 5), (40, 0), *_CARD_SHAPES])
@pytest.mark.parametrize("variant", exact_edges.VARIANTS)
@pytest.mark.parametrize("mode", MODES)
def test_exact_sweep_plain_version_matches_the_jax_package(mode, variant, n,
                                                           s):
    case = exact_edges.case(variant, n, s, n + s)
    want = _jax_totals(*case, mode)
    plain, launches = t_fit.EXACT_PLAIN_CALLS, t_fit.EXACT_LAUNCHES
    got = _plain_totals(*case, mode)
    assert t_fit.EXACT_PLAIN_CALLS == plain + 1
    assert t_fit.EXACT_LAUNCHES == launches
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("program", ["grid", "grouped", "quantiles_grid",
                                     "quantiles_grouped"])
def test_totals_only_sweeps_on_cpu_tensors_count_the_plain_version(program):
    """Every sweep without per-node fits is the kernel on the card, so on
    the CPU each counts one plain call, the capacity-at-risk sweeps
    too."""
    cols, cpu, mem, reps, _, counts = exact_edges.case("grouped", 300, 40,
                                                       5)
    cols, scen = _torch(cols), _torch([cpu, mem, reps])
    counts = torch.from_numpy(counts)
    grouped = program.endswith("grouped")
    args = (*cols, counts, *scen) if grouped else (*cols, *scen)
    plain, launches = t_fit.EXACT_PLAIN_CALLS, t_fit.EXACT_LAUNCHES
    if program.startswith("quantiles"):
        q = (0, 20, 39)
        fn = t_fit.sweep_quantiles_grouped if grouped else \
            t_fit.sweep_quantiles_grid
        got = fn(*args, mode="reference", q_indices=q)
    else:
        fn = t_fit.sweep_grid_grouped if grouped else t_fit.sweep_grid
        got = fn(*args, mode="reference")
    assert t_fit.EXACT_PLAIN_CALLS == plain + 1
    assert t_fit.EXACT_LAUNCHES == launches
    want = t_fit._sweep(cols, counts if grouped else None, *scen,
                        mode="reference", node_mask=None, return_fits=False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_staged_sweeps_on_cpu_tensors_take_the_plain_version():
    jsnap = synthetic_snapshot(512, seed=8, shapes=6, kib_quantized=False)
    tsnap = _snapshot_pair(jsnap)
    cpu, mem, reps = exact_edges.requests(40, 9)
    cols = [getattr(tsnap, f) for f in COLS]
    for per_node in (False, True):
        plain, launches = t_fit.EXACT_PLAIN_CALLS, t_fit.EXACT_LAUNCHES
        flat = t_fit.sweep_grid_staged(
            *cols, cpu, mem, reps, mode="reference", snapshot=tsnap,
            return_per_node=per_node, device="cpu")
        grouped = t_fit.sweep_grouped_staged(
            tsnap.grouped(), cpu, mem, reps, mode="reference",
            return_per_node=per_node, device="cpu")
        # return_per_node needs the fits, so it runs the tensor program
        # and leaves the kernel's counters alone on any device.
        assert t_fit.EXACT_PLAIN_CALLS == plain + (0 if per_node else 2)
        assert t_fit.EXACT_LAUNCHES == launches
        want = j_fit.sweep_grid(*[getattr(jsnap, f) for f in COLS], cpu,
                                mem, reps, return_per_node=per_node)
        for out in (flat, grouped):
            assert len(out) == len(want)
            for g, w in zip(out, want):
                np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("case", ["dtype", "healthy", "length", "scenarios",
                                  "mask", "stride", "device"])
def test_exact_kernel_operand_check_refuses_what_the_kernel_cannot_take(
        case):
    cols = _torch(exact_edges.columns(16, 1))
    scen = _torch(list(exact_edges.requests(5, 2)))
    mask = counts = None
    error = ValueError
    if case == "dtype":
        cols[1], error = cols[1].to(torch.int32), TypeError
    elif case == "healthy":
        cols[6], error = cols[6].to(torch.int64), TypeError
    elif case == "length":
        cols[2] = cols[2][:15]
    elif case == "scenarios":
        scen[2] = scen[2][:4]
    elif case == "mask":
        mask = torch.ones(17, dtype=torch.bool)
    elif case == "stride":
        counts = torch.ones(32, dtype=torch.int64)[::2]
    elif case == "device":
        scen[0] = scen[0].to("meta")
    with pytest.raises(error):
        _build.check_operands(t_fit._exact_spec(cols, *scen, mask, counts),
                              "exact sweep")
    _build.check_operands(t_fit._exact_spec(
        _torch(exact_edges.columns(16, 1)),
        *_torch(list(exact_edges.requests(5, 2))), None, None),
        "exact sweep")


_HOST_HARNESS = r"""
#include "SWEEP_EXACT_CU"

using namespace kccap_exact;

template <bool STRICT>
static void run(const i64* const* c, const unsigned char* healthy,
                const unsigned char* mask, const i64* counts, const i64* cr,
                const i64* mr, i64 n, i64 s, i64* fits, u64* totals) {
  for (i64 j = 0; j < s; ++j) {
    const Divisors d = stage_divisors(cr[j], mr[j]);
    u64 acc = 0;
    for (i64 i = 0; i < n; ++i) {
      const Node r = stage_node<STRICT>(c[0][i], c[1][i], c[2][i], c[3][i],
                                        c[4][i], c[5][i],
                                        counts ? counts[i] : 1);
      const bool live = (mask == nullptr || mask[i]) &&
                        (!STRICT || healthy[i]);
      const i64 f = live ? cell_fit<STRICT>(r, d) : 0;
      fits[j * n + i] = f;
      acc += static_cast<u64>(wmul(f, r.count));
    }
    totals[j] = acc;
  }
}

extern "C" void kccap_exact_host(
    const i64* ac, const i64* am, const i64* ap, const i64* uc,
    const i64* um, const i64* pc, const unsigned char* healthy,
    const unsigned char* mask, const i64* counts, const i64* cr,
    const i64* mr, i64 n, i64 s, int strict, i64* fits, u64* totals) {
  const i64* c[6] = {ac, am, ap, uc, um, pc};
  if (strict) {
    run<true>(c, healthy, mask, counts, cr, mr, n, s, fits, totals);
  } else {
    run<false>(c, healthy, mask, counts, cr, mr, n, s, fits, totals);
  }
}
"""


@pytest.fixture(scope="module")
def host_cells(tmp_path_factory):
    """``csrc/sweep_exact.cu``'s per-node and per-cell functions compiled
    as host C++ with ``g++`` (no CUDA toolkit needed), behind a loop over
    every cell."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the exact kernel's cell functions")
    cu = Path(t_fit.__file__).resolve().parent.parent / "csrc" / \
        "sweep_exact.cu"
    tmp = tmp_path_factory.mktemp("sweep_exact_host")
    src = tmp / "harness.cc"
    src.write_text(_HOST_HARNESS.replace("SWEEP_EXACT_CU", str(cu)))
    lib = tmp / "libharness.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-Wall", "-Wextra", "-Werror", "-shared",
         "-fPIC", "-o", str(lib), str(src)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    fn = ctypes.CDLL(str(lib)).kccap_exact_host
    fn.argtypes = (ctypes.c_void_p,) * 11 + (
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p)
    fn.restype = None
    return fn


def _ptr(a):
    return None if a is None else a.ctypes.data


@pytest.mark.parametrize("n,s", [(257, 1), (257, 257), (1, 12),
                                 *_CARD_SHAPES])
@pytest.mark.parametrize("variant", exact_edges.VARIANTS)
@pytest.mark.parametrize("mode", MODES)
def test_exact_kernel_cells_as_host_code_match_fit_per_node(
        host_cells, mode, variant, n, s):
    """The kernel's cell code against ``fit_per_node`` and, through the
    totals, the JAX package."""
    cols, cpu, mem, reps, mask, counts = exact_edges.case(variant, n, s,
                                                          n + s)
    fits = np.empty((s, n), np.int64)
    totals = np.empty(s, np.uint64)
    # Every array handed over by address is held by a name for the call: a
    # temporary's buffer could be freed before the call reads it.
    cells = [np.ascontiguousarray(c) for c in cols[:6]]
    healthy = cols[6].astype(np.uint8)
    mask8 = None if mask is None else mask.astype(np.uint8)
    host_cells(*(_ptr(c) for c in cells), _ptr(healthy), _ptr(mask8),
               _ptr(counts), _ptr(cpu), _ptr(mem), n, s,
               int(mode == "strict"), _ptr(fits), _ptr(totals))
    want_fits = t_fit.fit_per_node(
        *_torch(cols), torch.from_numpy(cpu)[:, None],
        torch.from_numpy(mem)[:, None], mode=mode,
        node_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(fits, want_fits.numpy())
    want = t_fit._sweep(
        _torch(cols), None if counts is None else torch.from_numpy(counts),
        torch.from_numpy(cpu), torch.from_numpy(mem), torch.from_numpy(reps),
        mode=mode, node_mask=None if mask is None else torch.from_numpy(mask),
        return_fits=False)
    np.testing.assert_array_equal(totals.view(np.int64), want[0].numpy())
    np.testing.assert_array_equal(
        totals.view(np.int64),
        np.asarray(_jax_totals(cols, cpu, mem, reps, mask, counts, mode)[0]))
