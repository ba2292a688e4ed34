"""The plain reference: its answers against the program's on the host at
small sizes, its quirks, and its incremental state against a full
repack.  The reference itself imports nothing of the program."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kccap_bench import spec
from kccap_bench.reference import pack
from kccap_bench.reference.fit import sweep_totals
from kccap_bench.reference.quantity import (
    bytefmt_reference,
    cpu_milli_reference,
    quantity_milli,
    quantity_value,
)
from kccap_bench.reference.state import StrictCluster
from kccap_bench.tests.conftest import REPO

import kubernetesclustercapacity_tpu_torch as port  # noqa: E402
from kubernetesclustercapacity_tpu_torch.masks import implicit_taint_mask
from kubernetesclustercapacity_tpu_torch.ops.fused_fit import (  # noqa: E402
    sweep_snapshot_auto,
)
from kubernetesclustercapacity_tpu_torch.ops.fused_multi import (  # noqa: E402
    sweep_multi_auto,
)

CLUSTER = spec.load_module(REPO, "clusters", "synthetic_fixture")
CHURN = spec.load_module(REPO, "gen", "churn")
GPU = ("ephemeral-storage", "nvidia.com/gpu")
SHAPE = {"pods_per_node": 30, "unhealthy_frac": 0.05,
         "unparseable_mem_frac": 0.02, "taint_frac": 0.1}


def test_quantities():
    assert cpu_milli_reference("250m") == 250
    assert cpu_milli_reference("2") == 2000
    assert cpu_milli_reference("0.5") == 0
    assert bytefmt_reference("16777216Ki") == 16777216 * 1024
    assert bytefmt_reference("16Gi") is None  # the Go CLI's quirk Q5
    assert quantity_value("16Gi") == 16 << 30
    assert quantity_value("512M") == 512 * 10**6
    assert quantity_milli("1") == 1000
    assert quantity_value(None) == 0


def _grid(rng, s, unit):
    cpu = rng.integers(50, 4000, s)
    mem = rng.integers(64, 8192, s) * unit
    rep = rng.integers(1, 500, s)
    return np.stack([cpu, mem], axis=1), rep


@pytest.mark.parametrize("semantics", ["reference", "strict"])
@pytest.mark.parametrize("unit", [1 << 20, 10**6])
def test_two_resource_answers_equal_the_programs(semantics, unit):
    fx = CLUSTER.build(dict(SHAPE, nodes=250), 17)
    snap = port.snapshot_from_fixture(fx, semantics=semantics)
    cols = (pack.pack_reference(fx) if semantics == "reference"
            else pack.pack_strict(fx))
    reqs, rep = _grid(np.random.default_rng(1), 300, unit)
    grid = port.ScenarioGrid(reqs[:, 0], reqs[:, 1], rep)
    want, want_s, _ = sweep_snapshot_auto(
        snap, grid, mode=semantics, node_mask=implicit_taint_mask(snap),
        device="cpu")
    got, got_s = sweep_totals(cols, ("cpu", "memory"), reqs, rep)
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got_s, np.asarray(want_s))


def test_multi_resource_answers_equal_the_programs():
    fx = CLUSTER.build(dict(SHAPE, nodes=250, gpu_storage_columns=True), 23)
    snap = port.snapshot_from_fixture(fx, semantics="strict",
                                      extended_resources=GPU)
    cols = pack.pack_strict(fx, GPU)
    rng = np.random.default_rng(2)
    s = 300
    reqs = np.stack([rng.integers(50, 4000, s),
                     rng.integers(64, 8192, s) << 20,
                     rng.integers(0, 3, s),
                     rng.integers(1, 20, s) << 30], axis=1)
    rep = rng.integers(1, 500, s)
    resources = ("cpu", "memory", "nvidia.com/gpu", "ephemeral-storage")
    alloc, used = snap.resource_matrix(resources)
    want, want_s, _ = sweep_multi_auto(
        alloc, used, snap.alloc_pods, snap.pods_count, snap.healthy, reqs,
        rep, mode="strict", node_masks=implicit_taint_mask(snap),
        device="cpu")
    got, got_s = sweep_totals(cols, resources, reqs, rep)
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got_s, np.asarray(want_s))


def test_float32_control_differs_at_full_size():
    fx = CLUSTER.build(dict(SHAPE, nodes=5000, taint_frac=0.0), 29)
    cols = pack.pack_reference(fx)
    reqs, rep = _grid(np.random.default_rng(3), 2000, 10**6)
    exact, _ = sweep_totals(cols, ("cpu", "memory"), reqs, rep)
    lower, _ = sweep_totals(cols, ("cpu", "memory"), reqs, rep,
                            dtype=torch.float32)
    assert np.count_nonzero(exact != lower) > 0


def test_incremental_state_equals_a_full_repack():
    fx = CLUSTER.build(dict(SHAPE, nodes=300, gpu_storage_columns=True), 31)
    events = CHURN.event_stream(fx, 31, 1300)
    state = StrictCluster(fx, GPU)
    from kccap_bench.reference.state import StrictCluster as Fresh

    for lo in range(0, len(events), 260):
        state.apply(events[lo:lo + 260])
        mine = state.columns()
        full = pack.pack_strict(state_fixture(state), GPU)
        for r in ("cpu", "memory", *GPU):
            assert np.array_equal(mine.alloc[r], full.alloc[r])
            assert np.array_equal(mine.used[r], full.used[r])
        for name in ("alloc_pods", "pods_count", "healthy", "mask"):
            assert np.array_equal(getattr(mine, name), getattr(full, name))
    assert Fresh(state_fixture(state), GPU).usage == {
        k: v for k, v in state.usage.items() if any(v)}


def state_fixture(state):
    return {"nodes": list(state.nodes.values()),
            "pods": list(state.pods.values())}


def test_churned_answers_equal_the_programs_store():
    from kubernetesclustercapacity_tpu_torch.store import ClusterStore

    fx = CLUSTER.build(dict(SHAPE, nodes=300, gpu_storage_columns=True), 37)
    events = CHURN.event_stream(fx, 37, 700)
    store = ClusterStore(fx, semantics="strict", extended_resources=GPU)
    state = StrictCluster(fx, GPU)
    snap = store.apply(events)
    state.apply(events)
    reqs, rep = _grid(np.random.default_rng(4), 200, 1 << 20)
    grid = port.ScenarioGrid(reqs[:, 0], reqs[:, 1], rep)
    want, _, _ = sweep_snapshot_auto(snap, grid, mode="strict",
                                     node_mask=implicit_taint_mask(snap),
                                     device="cpu")
    got, _ = sweep_totals(state.columns(), ("cpu", "memory"), reqs, rep)
    assert np.array_equal(got, np.asarray(want))
    assert state.healthy_nodes() == int(snap.healthy.sum())
    assert len(state.nodes) == snap.n_nodes
