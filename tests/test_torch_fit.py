"""The port's exact int64 program against ``kubernetesclustercapacity_tpu.
ops.fit``: per-node fits and totals, bit for bit, on the CPU.

Inputs are those of ``tests/test_fit_kernel.py`` (hostile wrapped bit
patterns, INT64_MIN headroom, requests of 1 and non-KiB memory requests)
plus wrapped CPU requests, in both modes, masked and unmasked, grouped and
ungrouped.  Tolerance: none — every result is an integer.
"""

import numpy as np
import pytest
import torch

from kubernetesclustercapacity_tpu.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu.ops import fit as j_fit
from kubernetesclustercapacity_tpu.snapshot import (
    snapshot_from_fixture,
    synthetic_snapshot,
)
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
