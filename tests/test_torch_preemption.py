"""The port's preemption tables and fits (``ops/preemption.py``) against
the JAX package's, both on the CPU, with tolerance 0.

Seeded fixtures whose pods carry priorities (and, on some, GPU and storage
requests) go through ``build_priority_table``, ``fit_with_preemption`` and
``sweep_preemption`` of both packages: every table column, per-node fit,
total and verdict must be equal, with and without extended columns, a
node mask, and thresholds below, between, on and above the levels.
"""

import numpy as np
import pytest

from kubernetesclustercapacity_tpu import snapshot as j_snapshot
from kubernetesclustercapacity_tpu.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu.ops import preemption as jpre
from kubernetesclustercapacity_tpu_torch import snapshot as t_snapshot
from kubernetesclustercapacity_tpu_torch.ops import preemption as tpre

GIB = 1 << 30
EXTENDED = ("ephemeral-storage", "nvidia.com/gpu")
THRESHOLDS = [-5, 0, 1, 1000, 5000, 100000, 100001]


def _fixture(seed, n=40, extended=False):
    fx = synthetic_fixture(n, seed=seed, taint_frac=0.2, unhealthy_frac=0.1)
    rng = np.random.default_rng(seed + 100)
    for pod in fx["pods"]:
        pod["priority"] = int(rng.choice([0, 1000, 100000, -10]))
    if extended:
        for node in fx["nodes"]:
            node["allocatable"]["nvidia.com/gpu"] = str(rng.integers(0, 9))
            node["allocatable"]["ephemeral-storage"] = \
                f"{rng.integers(50, 501)}Gi"
        for pod in fx["pods"][::3]:
            pod["containers"] = [{"resources": {"requests": {
                "cpu": "250m", "memory": "256Mi",
                "nvidia.com/gpu": str(rng.integers(0, 3)),
                "ephemeral-storage": f"{rng.integers(1, 20)}Gi",
            }}}]
    return fx


def _sources(seed, extended):
    fx = _fixture(seed, extended=extended)
    ext = EXTENDED if extended else ()
    return (
        fx,
        j_snapshot.snapshot_from_fixture(fx, semantics="strict",
                                         extended_resources=ext),
        t_snapshot.snapshot_from_fixture(fx, semantics="strict",
                                         extended_resources=ext),
        ext,
    )


CASES = [(0, False), (1, False), (2, True)]


@pytest.mark.parametrize("seed,extended", CASES)
def test_tables_match_jax(seed, extended):
    fx, js, ts, ext = _sources(seed, extended)
    jt = jpre.build_priority_table(fx, js, ext)
    tt = tpre.build_priority_table(fx, ts, ext)
    for name in ("levels", "used_cpu_ge", "used_mem_ge", "pods_ge"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name))
    assert sorted(tt.used_ext_ge) == sorted(jt.used_ext_ge) == sorted(ext)
    for r in ext:
        np.testing.assert_array_equal(tt.used_ext_ge[r], jt.used_ext_ge[r])
    # Column 0 is the snapshot's own strict usage.
    np.testing.assert_array_equal(tt.used_cpu_ge[:, 0], ts.used_cpu_req_milli)
    np.testing.assert_array_equal(tt.pods_ge[:, 0], ts.pods_count)
    for p in THRESHOLDS:
        assert tt.column_index(p) == jt.column_index(p)
        for a, b in zip(tt.columns(p), jt.columns(p)):
            np.testing.assert_array_equal(a, b)
        resources = ("cpu", "memory", *ext)
        for a, b in zip(tt.multi_columns(p, resources),
                        jt.multi_columns(p, resources)):
            np.testing.assert_array_equal(a, b)


def test_empty_cluster_table_matches_jax():
    fx = {"nodes": _fixture(3)["nodes"][:4], "pods": []}
    js = j_snapshot.snapshot_from_fixture(fx, semantics="strict")
    ts = t_snapshot.snapshot_from_fixture(fx, semantics="strict")
    jt, tt = (jpre.build_priority_table(fx, js),
              tpre.build_priority_table(fx, ts))
    assert tt.levels.shape == jt.levels.shape == (0,)
    np.testing.assert_array_equal(tt.used_cpu_ge, jt.used_cpu_ge)
    got = tpre.sweep_preemption(
        ts.alloc_cpu_milli, ts.alloc_mem_bytes, ts.alloc_pods, ts.healthy,
        tt.levels, tt.used_cpu_ge, tt.used_mem_ge, tt.pods_ge,
        np.array([100, 200]), np.array([GIB, GIB]), np.array([0, 7]),
        np.array([1, 1]), device="cpu")
    want = jpre.sweep_preemption(
        js.alloc_cpu_milli, js.alloc_mem_bytes, js.alloc_pods, js.healthy,
        jt.levels, jt.used_cpu_ge, jt.used_mem_ge, jt.pods_ge,
        np.array([100, 200]), np.array([GIB, GIB]), np.array([0, 7]),
        np.array([1, 1]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("priority", THRESHOLDS)
@pytest.mark.parametrize("seed,extended", CASES)
def test_fit_with_preemption_matches_jax(seed, extended, priority, masked):
    fx, js, ts, ext = _sources(seed, extended)
    jt = jpre.build_priority_table(fx, js, ext)
    tt = tpre.build_priority_table(fx, ts, ext)
    mask = (np.random.default_rng(seed).random(js.n_nodes) > 0.3
            if masked else None)
    requests = ({"nvidia.com/gpu": 1, "ephemeral-storage": 5 * GIB}
                if extended else None)
    want = np.asarray(jpre.fit_with_preemption(
        js, jt, 500, GIB, priority, node_mask=mask,
        extended_requests=requests))
    got = tpre.fit_with_preemption(
        ts, tt, 500, GIB, priority, node_mask=mask,
        extended_requests=requests, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64


def test_missing_extended_column_raises_like_jax():
    fx, js, ts, ext = _sources(2, True)
    jt = jpre.build_priority_table(fx, js)  # no extended suffix sums
    tt = tpre.build_priority_table(fx, ts)
    for kw in ({"extended_requests": {"nvidia.com/gpu": 1}},
               {"extended_requests": {"example.com/fpga": 1}}):
        with pytest.raises(jpre.PreemptionExtendedError) as j_err:
            jpre.fit_with_preemption(js, jt, 500, GIB, 0, **kw)
        with pytest.raises(tpre.PreemptionExtendedError) as t_err:
            tpre.fit_with_preemption(ts, tt, 500, GIB, 0, device="cpu",
                                     **kw)
        assert str(t_err.value) == str(j_err.value)


def _grid(seed, s=64):
    rng = np.random.default_rng(seed)
    return (rng.integers(50, 4000, s), rng.integers(64, 8192, s) << 20,
            rng.choice(THRESHOLDS, s), rng.integers(0, 400, s))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", ["strict", "reference"])
@pytest.mark.parametrize("seed,extended", CASES)
def test_sweep_preemption_matches_jax(seed, extended, mode, masked):
    fx, js, ts, ext = _sources(seed, extended)
    jt = jpre.build_priority_table(fx, js, ext)
    tt = tpre.build_priority_table(fx, ts, ext)
    cpu, mem, prio, replicas = _grid(seed + 7)
    kw = dict(mode=mode, node_mask=(
        np.random.default_rng(seed).random(js.n_nodes) > 0.3
        if masked else None))
    if extended:
        rng = np.random.default_rng(seed + 8)
        ext_reqs = np.stack([rng.integers(0, 20, cpu.size) << 30,
                             rng.integers(0, 3, cpu.size)], axis=1)
        alloc_rn, _ = js.resource_matrix(ext)
        kw.update(
            ext_alloc=alloc_rn,
            ext_used_ge=np.stack([jt.used_ext_ge[r] for r in ext]),
            ext_reqs=ext_reqs,
        )
    want = jpre.sweep_preemption(
        js.alloc_cpu_milli, js.alloc_mem_bytes, js.alloc_pods, js.healthy,
        jt.levels, jt.used_cpu_ge, jt.used_mem_ge, jt.pods_ge,
        cpu, mem, prio, replicas, **kw)
    got = tpre.sweep_preemption(
        ts.alloc_cpu_milli, ts.alloc_mem_bytes, ts.alloc_pods, ts.healthy,
        tt.levels, tt.used_cpu_ge, tt.used_mem_ge, tt.pods_ge,
        cpu, mem, prio, replicas, device="cpu", **kw)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert got[0].sum() > 0 and 0 < got[1].sum() < cpu.size
    # Each scenario equals the one-spec preemptive fit.
    if not extended:
        for s in (0, 5, 63):
            fits = tpre.fit_with_preemption(
                ts, tt, int(cpu[s]), int(mem[s]), int(prio[s]), mode=mode,
                node_mask=kw["node_mask"], device="cpu")
            assert int(fits.sum()) == int(got[0][s])
