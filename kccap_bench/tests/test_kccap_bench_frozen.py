"""The generators and the bound arithmetic copied into the benchmark give
today, at fixed small seeds, what the originals give.  When the program
drifts, this fails; the yardstick does not move with it."""

from __future__ import annotations

import copy
import inspect
import json
import sys

import numpy as np
import pytest
import torch

from kccap_bench import roofline, spec
from kccap_bench.tests.conftest import REPO

sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
import kubernetesclustercapacity_tpu_torch as port  # noqa: E402

CLUSTER = spec.load_module(REPO, "clusters", "synthetic_fixture")
CHURN = spec.load_module(REPO, "gen", "churn")


@pytest.mark.parametrize("kw", [
    {"seed": 3},
    {"seed": 8, "pods_per_node": 30, "taint_frac": 0.1},
    {"seed": 4, "unscheduled_running_pods": 5, "topology": (2, 3)},
])
def test_synthetic_fixture_equals_the_ports(kw):
    assert CLUSTER.synthetic_fixture(120, **kw) == \
        port.synthetic_fixture(120, **kw)


def test_gpu_storage_columns_equal_config4_fixture():
    mine = CLUSTER.synthetic_fixture(150, seed=5, taint_frac=0.1)
    CLUSTER.gpu_storage_columns(mine, np.random.default_rng(12))
    assert mine == chip_smoke.config4_fixture(port, n=150)


def test_sweep_ranges_are_random_scenario_grids():
    defaults = inspect.signature(port.random_scenario_grid).parameters
    for name in ("sweep1k", "churn"):
        with open(f"{REPO}/kccap_bench/traffic/{name}.json") as f:
            traffic = json.load(f)
        assert tuple(traffic["cpu_milli"]) == defaults["cpu_milli_range"].default
        assert tuple(traffic["mem_units"]) == defaults["mem_mib_range"].default
        assert traffic["mem_unit_bytes"] == 1 << 20
        assert tuple(traffic["replicas"]) == defaults["replicas_range"].default


def test_churn_events_equal_chip_smokes():
    fixture = port.synthetic_fixture(400, seed=8, pods_per_node=30,
                                     taint_frac=0.1)
    mine = CHURN.churn_events(copy.deepcopy(fixture), seed=9)
    assert mine == chip_smoke.churn_events(copy.deepcopy(fixture), seed=9)


@pytest.mark.parametrize("strict", [False, True])
def test_sweep_bound_equals_chip_smokes(strict):
    n, s, live = 64, 48, 50
    mask = torch.zeros(n, dtype=torch.int32)
    mask[:live] = 1
    ops = [torch.zeros(n, dtype=torch.int32)] * 6 + [
        torch.zeros(s, dtype=torch.int32)] * 4 + [
        mask if strict else None, None]
    if not strict:
        live = n
    want_ms, _, _ = chip_smoke.Variant(False, strict, strict, False).bound(
        ops, roofline.SMS, roofline.CLOCK_HZ)
    got = roofline.sweep_bound_s(n, live, s,
                                 "strict" if strict else "reference")
    assert got * 1e3 == pytest.approx(want_ms, rel=1e-12)
    big = roofline.sweep_bound_s(5000, 5000, 1000, "reference")
    assert big == pytest.approx(6 * 5e6 / (132 * 128 * 1.98e9))


def test_multi_bound_equals_chip_smokes():
    n, s, r, live = 64, 40, 4, 30
    rng = np.random.default_rng(0)
    reqs = torch.from_numpy(rng.integers(0, 3, (r, s)).astype(np.int32))
    mask = torch.zeros(n, dtype=torch.int32)
    mask[:live] = 1
    ops = (torch.zeros((r, n), dtype=torch.int32), None, None, None, reqs,
           None, mask)
    want_ms, _, _ = chip_smoke.MultiVariant(False, True, True).bound(
        ops, roofline.SMS, roofline.CLOCK_HZ)
    active = (reqs > 0).sum(dim=0).tolist()
    got = roofline.multi_bound_s(n, live,
                                 roofline.multi_cell_ops(active, "strict"),
                                 s, r, "strict")
    assert got * 1e3 == pytest.approx(want_ms, rel=1e-12)
