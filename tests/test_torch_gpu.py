"""The CUDA sweep kernel against its plain PyTorch version, on the card.

These tests need a CUDA device and the CUDA toolkit (``nvcc``); elsewhere
they skip.  This file imports no JAX, so it runs on a GPU host without it:

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

import itertools

import numpy as np
import pytest
import torch

from kubernetesclustercapacity_tpu_torch import (
    random_scenario_grid,
    sweep_snapshot_auto,
    synthetic_snapshot,
)
from kubernetesclustercapacity_tpu_torch.ops import fused_fit as ff

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(n, s, seed, device, rcp, mask, counts):
    rng = np.random.default_rng(seed)
    cores = rng.choice(np.array([2, 4, 8, 16, 32, 64]), size=n)
    ac = (cores * 1000).astype(np.int32)
    am = (cores * 4 * 1024 * 1024 - rng.integers(0, 2**18, n)).astype(np.int32)
    cr = rng.integers(50, 4000, s).astype(np.int32)
    mr = (rng.integers(64, 8192, s) * 1024).astype(np.int32)
    host = [
        ac, am, np.full(n, 110, np.int32),
        (ac * rng.random(n) * 1.1).astype(np.int32),
        (am * rng.random(n) * 1.1).astype(np.int32),
        rng.integers(0, 130, n).astype(np.int32), cr, mr,
        ff.scenario_reciprocals(cr) if rcp else None,
        ff.scenario_reciprocals(mr) if rcp else None,
        (rng.random(n) < 0.8).astype(np.int32) if mask else None,
        rng.integers(0, 4, n).astype(np.int32) if counts else None,
    ]
    return [None if a is None else torch.from_numpy(a).to(device)
            for a in host]


@pytest.mark.parametrize("n,s", [(1, 1), (2049, 257), (10_000, 1_000)])
@pytest.mark.parametrize(
    "variant", list(itertools.product((False, True), repeat=4)),
    ids=lambda v: "-".join(str(int(b)) for b in v),
)
def test_kernel_matches_plain(cuda, variant, n, s):
    rcp, strict, mask, counts = variant
    ops = _operands(n, s, n + s, cuda, rcp, mask, counts)
    before = ff.LAUNCHES
    got = ff.sweep_fused(*ops, strict=strict)
    torch.cuda.synchronize()
    assert ff.LAUNCHES == before + 1
    assert torch.equal(got, ff.sweep_fused_plain(*ops, strict=strict))


def test_snapshot_sweep_on_card_matches_host(cuda):
    snap = synthetic_snapshot(10_000, seed=1)
    grid = random_scenario_grid(1_000, seed=0)
    card = sweep_snapshot_auto(snap, grid, device="cuda")
    host = sweep_snapshot_auto(snap, grid, device="cpu")
    exact = sweep_snapshot_auto(snap, grid, kernel="exact", device="cuda")
    assert card[2] == "cuda_i32_rcp_fused" and host[2] == "plain_i32_rcp_fused"
    np.testing.assert_array_equal(card[0], host[0])
    np.testing.assert_array_equal(card[0], exact[0])
