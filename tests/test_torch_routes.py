"""The route counters: every routed sweep dispatch files its kernel label
and the reason for its route in the process registry
(``kccap_route_dispatches_total``, ``kccap_route_scenarios_total``),
a folded batch as one dispatch of all its scenarios, and the answers and
labels do not change with the counters on or off."""

import numpy as np
import pytest

from kubernetesclustercapacity_tpu.ops import pallas_fit as jp
from kubernetesclustercapacity_tpu.ops import pallas_multi as jm
from kubernetesclustercapacity_tpu_torch.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu_torch.ops import fused_fit as tf
from kubernetesclustercapacity_tpu_torch.ops import fused_multi as tm
from kubernetesclustercapacity_tpu_torch.scenario import ScenarioGrid
from kubernetesclustercapacity_tpu_torch.service.server import (
    CapacityServer,
)
from kubernetesclustercapacity_tpu_torch.snapshot import (
    snapshot_from_fixture,
    synthetic_snapshot,
)
from kubernetesclustercapacity_tpu_torch.telemetry.metrics import REGISTRY

from test_torch_batching import WINDOW_MS, _concurrently

MIB = 1 << 20
FAMILIES = ("kccap_route_dispatches_total", "kccap_route_scenarios_total")


def _routes():
    """``{family: {(kernel, reason): value}}`` of the process registry."""
    snap = REGISTRY.snapshot()
    out = {}
    for family in FAMILIES:
        values = snap.get(family, {}).get("values", {})
        out[family] = {
            tuple(part.split("=", 1)[1].strip('"')
                  for part in block.split(",")): v
            for block, v in values.items()}
    return out


def _delta(before, after):
    """Children that moved: ``{(kernel, reason): (dispatches,
    scenarios)}``."""
    d, s = FAMILIES
    keys = set(after[d]) | set(after[s])
    out = {}
    for k in keys:
        moved = (after[d].get(k, 0) - before[d].get(k, 0),
                 after[s].get(k, 0) - before[s].get(k, 0))
        if moved != (0, 0):
            out[k] = moved
    return out


@pytest.fixture(scope="module")
def ref_snap():
    """A small fixture in reference semantics, with phantom and ``Gi``
    rows."""
    return snapshot_from_fixture(
        synthetic_fixture(48, seed=11, unhealthy_frac=0.1,
                          unparseable_mem_frac=0.1),
        semantics="reference")


def _grid(s, unit, seed=0):
    rng = np.random.default_rng(seed)
    return ScenarioGrid(
        cpu_request_milli=rng.integers(50, 4000, s),
        mem_request_bytes=rng.integers(64, 8192, s) * unit,
        replicas=rng.integers(1, 500, s))


def _sweep(snap, grid, **kw):
    before = _routes()
    totals, sched, kernel = tf.sweep_snapshot_auto(
        snap, grid, mode=snap.semantics, device="cpu", **kw)
    return np.asarray(totals), np.asarray(sched), kernel, _delta(
        before, _routes())


def test_whole_mib_specs_count_eligible_on_a_b1_label(ref_snap):
    _, _, kernel, moved = _sweep(ref_snap, _grid(40, MIB))
    assert kernel in ("plain_i32_rcp_fused", "plain_i32_fused")
    assert moved == {(kernel, "eligible"): (1, 40)}


def test_decimal_mb_specs_count_the_exact_program_and_mem_not_kib(
        ref_snap):
    grid = _grid(40, 10**6)
    # One decimal megabyte count in 16 is a whole KiB; 40 draws hold
    # others, so the whole request takes the exact program.
    assert (grid.mem_request_bytes % 1024).any()
    _, _, kernel, moved = _sweep(ref_snap, grid)
    assert kernel == "torch_int64"
    assert moved == {("torch_int64", "mem_not_kib"): (1, 40)}


def test_kernel_exact_counts_forced(ref_snap):
    _, _, kernel, moved = _sweep(ref_snap, _grid(7, MIB), kernel="exact")
    assert kernel == "torch_int64"
    assert moved == {("torch_int64", "forced"): (1, 7)}


def test_an_int32_overflowing_cluster_counts_int32_range():
    snap = synthetic_snapshot(64, seed=3)
    snap.alloc_cpu_milli[5] = np.int64(1) << 40
    _, _, kernel, moved = _sweep(snap, _grid(9, MIB))
    assert kernel == "torch_int64"
    assert moved == {("torch_int64", "int32_range"): (1, 9)}


def test_a_grouped_dispatch_counts_one_dispatch_and_all_its_scenarios():
    snap = synthetic_snapshot(4096, seed=9, shapes=12)
    _, _, kernel, moved = _sweep(snap, _grid(33, MIB))
    assert kernel.endswith("_grouped") and "_i32_" in kernel
    assert moved == {(kernel, "eligible"): (1, 33)}
    _, _, kernel, moved = _sweep(snap, _grid(21, 10**6))
    assert kernel == "torch_int64_grouped"
    assert moved == {("torch_int64_grouped", "mem_not_kib"): (1, 21)}


@pytest.mark.parametrize("unit,kernel,reason", [
    (MIB, "plain_i32_rcp_fused", "eligible"),
    (10**6, "torch_int64", "mem_not_kib"),
])
def test_a_folded_batch_of_3_counts_one_dispatch_and_all_its_scenarios(
        ref_snap, unit, kernel, reason):
    server = CapacityServer(ref_snap, device="cpu", port=0,
                            batch_window_ms=WINDOW_MS, batch_max=3,
                            max_inflight=3)
    server.start()
    try:
        sizes = (5, 8, 13)
        msgs = []
        for i, s in enumerate(sizes):
            g = _grid(s, unit, seed=i)
            msgs.append({"op": "sweep",
                         "cpu_request_milli": g.cpu_request_milli.tolist(),
                         "mem_request_bytes": g.mem_request_bytes.tolist(),
                         "replicas": g.replicas.tolist()})
        before = _routes()
        replies = _concurrently(server.address, msgs)
        moved = _delta(before, _routes())
        assert server.batching_stats["dispatches"] == 1
    finally:
        server.shutdown()
    assert all(r["ok"] and r["result"]["kernel"] == kernel for r in replies)
    assert moved == {(kernel, reason): (1, sum(sizes))}


@pytest.mark.parametrize("unit", [MIB, 10**6])
@pytest.mark.parametrize("kernel_req", ["auto", "exact"])
def test_answers_and_labels_are_the_same_with_the_counters_off(
        ref_snap, unit, kernel_req, monkeypatch):
    grid = _grid(24, unit, seed=5)
    on = _sweep(ref_snap, grid, kernel=kernel_req)
    monkeypatch.setenv("KCCAP_TELEMETRY", "0")
    off = _sweep(ref_snap, grid, kernel=kernel_req)
    assert off[3] == {}
    assert on[3] != {}
    np.testing.assert_array_equal(on[0], off[0])
    np.testing.assert_array_equal(on[1], off[1])
    assert on[2] == off[2]


_I32 = np.iinfo(np.int32).max


@pytest.mark.parametrize("case,reason", [
    ("eligible", None),
    ("negative_cpu", "int32_range"),
    ("huge_pods", "int32_range"),
    ("negative_count", "int32_range"),
    ("mem_not_kib", "mem_not_kib"),
    ("huge_mem", "int32_range"),
    ("zero_cpu_request", "zero_request"),
    ("total_bound", "total_bound"),
])
def test_the_proof_names_its_first_failed_condition(case, reason):
    rng = np.random.default_rng(4)
    n = 32
    cols = [rng.integers(1000, 64000, n),
            rng.integers(1, 64, n) * (1 << 30),
            np.full(n, 110), rng.integers(0, 1000, n),
            rng.integers(0, 4, n) * MIB, rng.integers(0, 30, n)]
    cpu, mem = rng.integers(50, 4000, 16), rng.integers(64, 8192, 16) * MIB
    counts = np.ones(n, dtype=np.int64)
    if case == "negative_cpu":
        cols[3][0] = -1
    elif case == "huge_pods":
        cols[2][1] = _I32 + 1
    elif case == "negative_count":
        counts[2] = -1
    elif case == "mem_not_kib":
        mem[3] = 512 * 10**6 + 1
    elif case == "huge_mem":
        cols[1][0] = (_I32 + 1) * 1024
    elif case == "zero_cpu_request":
        cpu[0] = 0
    elif case == "total_bound":
        counts[:] = 1 << 24
    assert tf.sweep_proof_failure(*cols, cpu, mem, counts=counts) == reason
    eligible = reason is None
    assert tf.fast_sweep_eligible(*cols, cpu, mem, counts=counts) == eligible
    assert jp.fast_sweep_eligible(*cols, cpu, mem, counts=counts) == eligible


def _multi_inputs():
    rng = np.random.default_rng(8)
    n, s = 24, 10
    alloc = np.stack([rng.integers(1000, 64000, n),
                      rng.integers(1, 64, n) * (1 << 30),
                      rng.integers(0, 8, n)])
    used = alloc // 4
    reqs = np.stack([rng.integers(50, 4000, s),
                     rng.integers(64, 8192, s) * MIB,
                     rng.integers(0, 2, s)], axis=1)
    return alloc, used, np.full(n, 110), rng.integers(0, 30, n), \
        np.ones(n, dtype=bool), reqs, rng.integers(1, 50, s)


@pytest.mark.parametrize("case,kernel,reason", [
    ("eligible", "plain_multi_i32_rcp_fused", "eligible"),
    ("forced", "torch_int64_multi", "forced"),
    ("max_per_node", "torch_int64_multi", "max_per_node"),
    ("per_scenario_mask", "torch_int64_multi", "per_scenario_mask"),
    ("negative_request", "torch_int64_multi", "negative_request"),
    ("row_scale", "torch_int64_multi", "row_scale"),
    ("pods", "torch_int64_multi", "int32_range"),
])
def test_the_r_resource_route_counts_its_reason(case, kernel, reason):
    alloc, used, ap, pc, healthy, reqs, rep = _multi_inputs()
    kw = {}
    if case == "forced":
        kw["force_exact"] = True
    elif case == "max_per_node":
        kw["max_per_node"] = np.full(len(rep), 3)
    elif case == "per_scenario_mask":
        kw["node_masks"] = np.ones((len(rep), alloc.shape[1]), dtype=bool)
    elif case == "negative_request":
        reqs[0, 2] = -1
    elif case == "row_scale":
        # Memory in bytes past int32 that no power of 1024 divides.
        reqs[1, 1] = 511 * 10**6
    elif case == "pods":
        ap = ap.copy()
        ap[0] = _I32 + 1
    before = _routes()
    _, _, got = tm.sweep_multi_auto(alloc, used, ap, pc, healthy, reqs, rep,
                                    mode="strict", device="cpu", **kw)
    assert got == kernel
    assert _delta(before, _routes()) == {(kernel, reason): (1, len(rep))}
    # The proof itself: its verdict is fast_multi_eligible's and the JAX
    # package's; the routing preconditions are not part of it.
    scales, proof_reason = tm.multi_proof(alloc, used, ap, pc, reqs)
    want = None if reason in ("eligible", "forced", "max_per_node",
                              "per_scenario_mask") else reason
    assert proof_reason == want
    assert tm.fast_multi_eligible(alloc, used, ap, pc, reqs) == (
        scales, want is None)
    assert jm.fast_multi_eligible(alloc, used, ap, pc, reqs)[1] == (
        want is None)


def test_the_route_families_stay_out_of_the_prometheus_text(ref_snap):
    from kubernetesclustercapacity_tpu_torch.telemetry.exposition import (
        render_text,
    )

    _sweep(ref_snap, _grid(3, MIB))
    assert set(FAMILIES) <= set(REGISTRY.snapshot())
    assert "kccap_route" not in render_text(REGISTRY)


def test_a_family_kept_out_of_the_scrape_is_in_the_snapshot():
    from kubernetesclustercapacity_tpu_torch.telemetry.exposition import (
        render_text,
    )
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
        MetricsError,
        MetricsRegistry,
    )

    reg = MetricsRegistry()
    hidden = reg.counter("kccap_x_total", "x", ("k",), scrape=False)
    hidden.labels(k="a").inc(3)
    reg.counter("kccap_y_total", "y").inc()
    assert reg.snapshot()["kccap_x_total"]["values"] == {'k="a"': 3.0}
    text = render_text(reg)
    assert "kccap_y_total 1" in text and "kccap_x_total" not in text
    assert reg.counter("kccap_x_total", "x", ("k",), scrape=False) is hidden
    with pytest.raises(MetricsError):
        reg.counter("kccap_x_total", "x", ("k",))


# -- the exact routes after the exact kernel: the labels and reasons are
# the JAX package's, on the CPU each dispatch runs the kernel's plain
# version once, and the totals are the JAX exact program's.

def _exact_route_case(grouped, reason):
    """``(snapshot, jax_snapshot, cpu, mem, reps, force_exact)`` that take
    the exact route for ``reason``."""
    from kubernetesclustercapacity_tpu.snapshot import (
        synthetic_snapshot as j_synthetic,
    )

    n, shapes = (4096, 12) if grouped else (64, None)
    snaps = [make(n, seed=9, shapes=shapes)
             for make in (synthetic_snapshot, j_synthetic)]
    rng = np.random.default_rng(17)
    cpu = rng.integers(50, 4000, 24)
    mem = rng.integers(64, 8192, 24) * MIB
    reps = rng.integers(1, 500, 24)
    for snap in snaps:
        if reason == "int32_range":
            snap.alloc_cpu_milli[5] = np.int64(1) << 40
        elif reason == "total_bound":
            snap.alloc_cpu_milli[:] = 1 << 30
    if reason == "mem_not_kib":
        mem = rng.integers(64, 8192, 24) * 10**6
    elif reason == "zero_request":
        cpu[3] = 0
    elif reason == "total_bound":
        cpu[0] = 1
    return (*snaps, cpu, mem, reps, reason == "forced")


@pytest.mark.parametrize("reason", ["mem_not_kib", "forced", "int32_range",
                                    "zero_request", "total_bound"])
@pytest.mark.parametrize("grouped", [False, True])
def test_every_exact_route_keeps_its_label_and_reason(grouped, reason,
                                                      monkeypatch):
    from kubernetesclustercapacity_tpu.ops import fit as j_fit
    from kubernetesclustercapacity_tpu.snapshot import (
        grouped_for_dispatch as j_grouped_for_dispatch,
    )
    from kubernetesclustercapacity_tpu_torch.ops import fit as t_fit
    from kubernetesclustercapacity_tpu_torch.snapshot import (
        grouped_for_dispatch,
    )

    snap, jsnap, cpu, mem, reps, force = _exact_route_case(grouped, reason)
    group = grouped_for_dispatch(snap)
    assert (group is not None) == grouped
    assert (j_grouped_for_dispatch(jsnap) is not None) == grouped
    before = _routes()
    plain, launches = t_fit.EXACT_PLAIN_CALLS, t_fit.EXACT_LAUNCHES
    if grouped:
        grid = ScenarioGrid(cpu_request_milli=cpu, mem_request_bytes=mem,
                            replicas=reps)
        if reason == "zero_request":
            # The grid's own check refuses a zero request before any route
            # is chosen; the router's proof is what this case holds.
            monkeypatch.setattr(ScenarioGrid, "validate", lambda self: None)
        totals, sched, kernel = tf.sweep_snapshot_auto(
            snap, grid, mode="reference", kernel="exact" if force else "auto",
            device="cpu")
    else:
        totals, sched, kernel = tf.sweep_auto(
            snap, cpu, mem, reps, mode="reference", force_exact=force,
            device="cpu")
    label = "torch_int64_grouped" if grouped else "torch_int64"
    assert kernel == label
    assert _delta(before, _routes()) == {(label, reason): (1, len(cpu))}
    assert t_fit.EXACT_PLAIN_CALLS == plain + 1
    assert t_fit.EXACT_LAUNCHES == launches
    assert tf.sweep_proof_failure(
        snap.alloc_cpu_milli, snap.alloc_mem_bytes, snap.alloc_pods,
        snap.used_cpu_req_milli, snap.used_mem_req_bytes, snap.pods_count,
        cpu, mem) == (None if force else reason)
    want = j_fit.sweep_grid(
        *(getattr(jsnap, f) for f in (
            "alloc_cpu_milli", "alloc_mem_bytes", "alloc_pods",
            "used_cpu_req_milli", "used_mem_req_bytes", "pods_count",
            "healthy")), cpu, mem, reps, mode="reference")
    np.testing.assert_array_equal(np.asarray(totals), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(sched), np.asarray(want[1]))


def test_a_folded_decimal_batch_runs_the_exact_plain_version_once(ref_snap):
    from kubernetesclustercapacity_tpu_torch.ops import fit as t_fit

    server = CapacityServer(ref_snap, device="cpu", port=0,
                            batch_window_ms=WINDOW_MS, batch_max=3,
                            max_inflight=3)
    server.start()
    try:
        msgs = []
        for i, s in enumerate((5, 8, 13)):
            g = _grid(s, 10**6, seed=20 + i)
            msgs.append({"op": "sweep",
                         "cpu_request_milli": g.cpu_request_milli.tolist(),
                         "mem_request_bytes": g.mem_request_bytes.tolist(),
                         "replicas": g.replicas.tolist()})
        plain, launches = t_fit.EXACT_PLAIN_CALLS, t_fit.EXACT_LAUNCHES
        replies = _concurrently(server.address, msgs)
        assert server.batching_stats["dispatches"] == 1
        assert t_fit.EXACT_PLAIN_CALLS == plain + 1
        assert t_fit.EXACT_LAUNCHES == launches
    finally:
        server.shutdown()
    assert all(r["ok"] and r["result"]["kernel"] == "torch_int64"
               for r in replies)
