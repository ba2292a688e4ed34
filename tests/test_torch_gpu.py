"""The CUDA sweep kernels (B1 ``sweep_fit``, B2 ``sweep_multi``) against
their plain PyTorch versions, on the card, and the entry points above them
(``CapacityModel``'s sweeps launch each kernel once; the explain and
quantile programs equal their host runs), the stochastic family on the
card (the seeded draws equal the host's; capacity-at-risk, the horizon and
the catalog plan equal their oracles and host runs), and gang capacity and
the LP optimizer on the card (the int64 gang programs, grouped and per
node, equal ``gang_oracle`` and the host; the PDHG's integer answers equal
the host's), and the audit trail and the plane on the card (a log replays
clean on the card, one B1 launch a replayed sweep, equal to the host's
replay; a replica's sweep launches B1 once and equals the leader's), and
the federation and the doctor on the card (each per-cluster row of a
``fed_sweep`` equals its leader's B1 sweep; the doctor's probe names the
card), and the native backend and the sharded sweeps against the card
(``native.sweep`` equals B1; ``sweep_shard_map`` and ``sweep_gspmd`` over
a mesh that names the card eight times equal the single sweep).

These tests need a CUDA device and the CUDA toolkit (``nvcc``); elsewhere
they skip.  This file imports no JAX, so it runs on a GPU host without it:

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

import itertools

import numpy as np
import pytest
import torch

from kubernetesclustercapacity_tpu_torch import (
    CapacityModel,
    MultiResourceGrid,
    PodSpec,
    ScenarioGrid,
    explain_snapshot,
    random_scenario_grid,
    snapshot_from_fixture,
    sweep_explain_snapshot,
    sweep_quantiles_snapshot,
    sweep_snapshot_auto,
    synthetic_fixture,
    synthetic_snapshot,
)
from kubernetesclustercapacity_tpu_torch import forecast as _forecast
from kubernetesclustercapacity_tpu_torch import optimize as _optimize
from kubernetesclustercapacity_tpu_torch import stochastic as _stochastic
from kubernetesclustercapacity_tpu_torch import topology as _topology
from kubernetesclustercapacity_tpu_torch.ops import fused_fit as ff
from kubernetesclustercapacity_tpu_torch.ops import fused_multi as fm
from kubernetesclustercapacity_tpu_torch.snapshot import grouped_for_dispatch

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


@pytest.mark.parametrize("dead", ["every-mask-0", "most-counts-0"])
@pytest.mark.parametrize(
    "variant", list(itertools.product((False, True), repeat=4)),
    ids=lambda v: "-".join(str(int(b)) for b in v),
)
def test_kernel_leaves_out_dead_nodes(cuda, variant, dead):
    """The kernel stages only nodes whose mask and count are not 0; a chunk
    with no live node, and chunks with a few, still equal the plain
    version."""
    rcp, strict, mask, counts = variant
    ops = _operands(5_000, 700, 11, cuda, rcp, mask, counts)
    rng = np.random.default_rng(12)
    if dead == "every-mask-0" and mask:
        ops[10].zero_()
    if dead == "most-counts-0" and counts:
        keep = torch.from_numpy(rng.random(5_000) < 0.02).to(cuda)
        ops[11] = torch.where(keep, ops[11], 0).contiguous()
    got = ff.sweep_fused(*ops, strict=strict)
    torch.cuda.synchronize()
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


# -- the exact int64 kernel (``csrc/sweep_exact.cu``, what ``sweep_grid``
# and ``sweep_grid_grouped`` launch on CUDA tensors without per-node fits)
# against its plain version, ``ops/fit.py::_sweep``, on the card, and on
# the host where the case is small enough to run there too.  The inputs
# are ``tests/exact_edges.py``'s; ``test_torch_fit.py`` holds the plain
# version against the JAX package on the same ones.

@pytest.mark.parametrize("n,s", [(4099, 1), (4099, 257), (600, 32_000),
                                 (0, 7), (300, 0)])
@pytest.mark.parametrize("variant", ["flat", "masked", "every-masked",
                                     "grouped"])
@pytest.mark.parametrize("mode", ["reference", "strict"])
def test_exact_kernel_matches_plain(cuda, mode, variant, n, s):
    import exact_edges

    from kubernetesclustercapacity_tpu_torch.ops import fit

    cols, cpu, mem, reps, mask, counts = exact_edges.case(variant, n, s,
                                                          n + s)
    host = [*cols, cpu, mem, reps, mask, counts]
    want = []
    for device in ("cuda", "cpu") if n * s <= 1 << 21 else ("cuda",):
        ops = [None if a is None else torch.from_numpy(a).to(device)
               for a in host]
        want.append(fit._sweep(ops[:7], ops[11], *ops[7:10], mode=mode,
                               node_mask=ops[10], return_fits=False))
    ops = [None if a is None else torch.from_numpy(a).to(cuda) for a in host]
    launches, plain = fit.EXACT_LAUNCHES, fit.EXACT_PLAIN_CALLS
    if counts is None:
        got = fit.sweep_grid(*ops[:10], mode=mode, node_mask=ops[10])
    else:
        got = fit.sweep_grid_grouped(*ops[:7], ops[11], *ops[7:10],
                                     mode=mode)
    torch.cuda.synchronize()
    assert fit.EXACT_LAUNCHES == launches + (1 if n and s else 0)
    assert fit.EXACT_PLAIN_CALLS == plain
    for w in want:
        for g, x in zip(got, w):
            assert torch.equal(g.cpu(), x.cpu())


# -- the zone-spread kernel (``csrc/sweep_spread.cu``, what
# ``fit.sweep_spread`` launches on CUDA tensors with 1 to SPREAD_ZONE_CAP
# domains) against its plain version, ``fit._spread_plain``, on the card
# and on the host; ``test_torch_spread_kernel.py`` holds its host twins
# against numpy on the same inputs.

def _spread_case(variant, n, s, n_zones, empty_zone):
    import exact_edges

    seed = n + s + n_zones
    cols, cpu, mem, reps, mask, _ = exact_edges.case(variant, n, s, seed)
    member = exact_edges.zones(n, n_zones, seed + 4, empty_zone=empty_zone)
    return [*cols, cpu, mem, reps, member, mask]


def _spread_on(host, device, n_zones, max_skew, plain):
    from kubernetesclustercapacity_tpu_torch.ops import fit

    ops = [None if a is None else torch.from_numpy(a).to(device)
           for a in host]
    if plain:
        return fit._spread_plain(ops[:7], *ops[7:11], n_zones, max_skew,
                                 ops[11])
    return fit.sweep_spread(*ops[:11], n_zones, max_skew, node_mask=ops[11])


@pytest.mark.parametrize("n,s", [(4099, 1), (4099, 257), (5000, 1000),
                                 (1, 1), (0, 7), (300, 0)])
@pytest.mark.parametrize("max_skew", [1, 2, 2**62])
@pytest.mark.parametrize("n_zones,empty_zone", [
    (1, False), (3, False), (3, True), (16, False), (16, True), (17, False)])
@pytest.mark.parametrize("variant", ["flat", "masked", "every-masked"])
def test_spread_kernel_matches_plain(cuda, variant, n_zones, empty_zone,
                                     max_skew, n, s):
    """Bit-equal to the plain version on the card and on the host; one
    launch where there are nodes, scenarios and at most SPREAD_ZONE_CAP
    domains, the plain version where there are no nodes or more
    domains."""
    from kubernetesclustercapacity_tpu_torch.ops import fit

    assert fit.SPREAD_ZONE_CAP == 16
    host = _spread_case(variant, n, s, n_zones, empty_zone)
    want = [_spread_on(host, device, n_zones, max_skew, True)
            for device in ("cuda", "cpu")]
    launches, plain = fit.SPREAD_LAUNCHES, fit.SPREAD_PLAIN_CALLS
    got = _spread_on(host, cuda, n_zones, max_skew, False)
    torch.cuda.synchronize()
    kernel = n > 0 and n_zones <= fit.SPREAD_ZONE_CAP
    assert fit.SPREAD_LAUNCHES == launches + int(kernel and s > 0)
    assert fit.SPREAD_PLAIN_CALLS == plain + int(not kernel)
    assert got.device.type == "cuda" and tuple(got.shape) == (s,)
    for w in want:
        assert torch.equal(got.cpu(), w.cpu())


@pytest.mark.parametrize("skew", [1, 2])
def test_server_grid_spread_launches_the_spread_kernel_once_a_request(
        cuda, skew):
    """Each served grid ``topology_spread`` launches the spread kernel
    once, runs no plain version, counts one dispatch of route
    ``torch_int64_per_node`` / ``topology_spread``, and answers as a host
    server does."""
    from kubernetesclustercapacity_tpu_torch.ops import fit
    from kubernetesclustercapacity_tpu_torch.service import CapacityClient
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
        REGISTRY,
    )

    key = "topology.kubernetes.io/zone"
    route = 'kernel="torch_int64_per_node",reason="topology_spread"'
    fixture = synthetic_fixture(5_000, seed=51, taint_frac=0.1,
                                unhealthy_frac=0.05, topology=(3, 1))
    snap = snapshot_from_fixture(fixture, semantics="strict")
    rng = np.random.default_rng(52)

    def grid(s):
        return {"cpu_request_milli": rng.integers(50, 4000, s).tolist(),
                "mem_request_bytes": (rng.integers(64, 8192, s)
                                      << 20).tolist(),
                "replicas": rng.integers(1, 500, s).tolist(),
                "max_skew": skew}

    def dispatches():
        return REGISTRY.snapshot().get("kccap_route_dispatches_total",
                                       {}).get("values", {}).get(route, 0.0)

    grids = [grid(1_000), grid(257), grid(1)]
    card = _serve(snap, fixture=fixture, port=0)
    host = _serve(snap, fixture=fixture, port=0, device="cpu")
    try:
        with CapacityClient(*host.address, timeout_s=300, retry=None) as c:
            want = [c.topology_spread(key, **g) for g in grids]
        with CapacityClient(*card.address, timeout_s=300, retry=None) as c:
            for g, w in zip(grids, want):
                launches, plain = fit.SPREAD_LAUNCHES, fit.SPREAD_PLAIN_CALLS
                before = dispatches()
                got = c.topology_spread(key, **g)
                assert fit.SPREAD_LAUNCHES == launches + 1
                assert fit.SPREAD_PLAIN_CALLS == plain
                assert dispatches() == before + 1
                assert got["totals"] == w["totals"]
                assert got["schedulable"] == w["schedulable"]
    finally:
        card.shutdown()
        host.shutdown()


@pytest.mark.parametrize("grouped", [False, True])
def test_capacity_at_risk_sweeps_launch_the_exact_kernel(cuda, grouped):
    """The sweep+quantile program reads totals only, so it launches the
    exact kernel once and runs no plain version, and answers as the
    host does."""
    from kubernetesclustercapacity_tpu_torch.ops import fit

    snap = synthetic_snapshot(4_096, seed=41, shapes=12 if grouped else None,
                              kib_quantized=False)
    rng = np.random.default_rng(42)
    grid = ScenarioGrid(
        cpu_request_milli=rng.integers(50, 4000, 300),
        mem_request_bytes=rng.integers(64, 8192, 300) * 10**6,
        replicas=rng.integers(1, 500, 300))
    q = (0, 150, 299)
    launches, plain = fit.EXACT_LAUNCHES, fit.EXACT_PLAIN_CALLS
    assert (grouped_for_dispatch(snap) is not None) == grouped
    card = fit.sweep_quantiles_snapshot(snap, grid, q_indices=q,
                                        device=cuda)
    assert fit.EXACT_LAUNCHES == launches + 1
    assert fit.EXACT_PLAIN_CALLS == plain
    assert card[-1] == ("torch_int64_sweep_qtile_grouped" if grouped
                        else "torch_int64_sweep_qtile")
    host = fit.sweep_quantiles_snapshot(snap, grid, q_indices=q,
                                        device="cpu")
    assert card[-1] == host[-1]
    for c, h in zip(card[:-1], host[:-1]):
        np.testing.assert_array_equal(c, h)


def test_server_decimal_sweeps_launch_the_exact_kernel_once_a_dispatch(cuda):
    import threading

    from kubernetesclustercapacity_tpu_torch.ops import fit

    snap = snapshot_from_fixture(
        synthetic_fixture(5_000, seed=31, unhealthy_frac=0.05,
                          unparseable_mem_frac=0.02),
        semantics="reference")
    rng = np.random.default_rng(32)

    def decimal(s):
        return {"op": "sweep",
                "cpu_request_milli": rng.integers(50, 4000, s).tolist(),
                "mem_request_bytes": (rng.integers(64, 8192, s)
                                      * 10**6).tolist(),
                "replicas": rng.integers(1, 500, s).tolist()}

    msgs = [decimal(1_000)] + [decimal(125) for _ in range(8)]
    host = _serve(snap, batch_window_ms=0, device="cpu")
    solo = _serve(snap, batch_window_ms=0)
    folded = _serve(snap, batch_window_ms=60_000, batch_max=8,
                    max_inflight=8)
    try:
        want = [_ask(host, m) for m in msgs]
        launches, plain = fit.EXACT_LAUNCHES, fit.EXACT_PLAIN_CALLS
        got = [_ask(solo, m) for m in msgs]
        assert fit.EXACT_LAUNCHES - launches == len(msgs)
        assert fit.EXACT_PLAIN_CALLS == plain
        assert got == want
        assert {r["result"]["kernel"] for r in got} == {"torch_int64"}

        got = [None] * 8

        def run(i):
            got[i] = _ask(folded, msgs[1 + i])

        launches = fit.EXACT_LAUNCHES
        dispatches = folded.batching_stats["dispatches"]
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert fit.EXACT_LAUNCHES - launches == \
            folded.batching_stats["dispatches"] - dispatches == 1
        assert fit.EXACT_PLAIN_CALLS == plain
        assert got == want[1:]
    finally:
        host.shutdown()
        solo.shutdown()
        folded.shutdown()


def _multi_operands(n, s, n_res, seed, device, rcp, mask):
    """Eligible, row-scaled int32 operands of the R-resource kernel: some
    nodes over-committed, Q1-negative pod columns, zero (inactive)
    requests on every row past the first, and an all-inactive scenario."""
    rng = np.random.default_rng(seed)
    alloc = rng.integers(0, 2**24, (n_res, n)).astype(np.int32)
    used = (alloc * rng.random((n_res, n)) * 1.1).astype(np.int32)
    reqs = rng.integers(16, 2**12, (n_res, s)).astype(np.int32)
    reqs[1:][rng.random((n_res - 1, s)) < 0.3] = 0
    reqs[:, 0] = 0
    host = [
        alloc, used, np.full(n, 110, np.int32),
        rng.integers(0, 130, n).astype(np.int32), reqs,
        ff.scenario_reciprocals(np.maximum(reqs, 1)) if rcp else None,
        (rng.random(n) < 0.8).astype(np.int32) if mask else None,
    ]
    return [None if a is None else torch.from_numpy(a).to(device)
            for a in host]


@pytest.mark.parametrize("n,s", [(1, 1), (2049, 257), (10_000, 1_000)])
@pytest.mark.parametrize("n_res", [1, 2, 3, 4, 5, 6, 7, 8, 9])
@pytest.mark.parametrize(
    "variant", list(itertools.product((False, True), repeat=3)),
    ids=lambda v: "-".join(str(int(b)) for b in v),
)
def test_multi_kernel_matches_plain(cuda, variant, n_res, n, s):
    rcp, strict, mask = variant
    ops = _multi_operands(n, s, n_res, n + s + n_res, cuda, rcp, mask)
    before = fm.LAUNCHES
    got = fm.sweep_multi(*ops, strict=strict)
    torch.cuda.synchronize()
    assert fm.LAUNCHES == before + 1
    assert torch.equal(got, fm.sweep_multi_plain(*ops, strict=strict))


@pytest.mark.parametrize("n_res", [1533, 1534, 3100])
@pytest.mark.parametrize(
    "variant", list(itertools.product((False, True), repeat=3)),
    ids=lambda v: "-".join(str(int(b)) for b in v),
)
def test_multi_kernel_stages_rows_in_passes(cuda, variant, n_res):
    """Past the R at which kBatch nodes of every row fill the shared
    tile, the kernel stages the rows in passes; each scenario requests a
    few random rows, so the binding rows fall in different passes."""
    rcp, strict, mask = variant
    n, s = 333, 130
    rng = np.random.default_rng(n_res)
    alloc = rng.integers(0, 1 << 24, (n_res, n)).astype(np.int32)
    used = (alloc * rng.random((n_res, n)) * 1.1).astype(np.int32)
    reqs = np.zeros((n_res, s), np.int32)
    for i in range(1, s):
        rows = rng.choice(n_res, int(rng.integers(1, 5)), replace=False)
        reqs[rows, i] = rng.integers(1 << 10, 1 << 14, rows.size)
    host = [
        alloc, used, np.full(n, 1 << 14, np.int32),
        rng.integers(0, 130, n).astype(np.int32), reqs,
        ff.scenario_reciprocals(np.maximum(reqs, 1)) if rcp else None,
        (rng.random(n) < 0.85).astype(np.int32) if mask else None,
    ]
    ops = [None if a is None else torch.from_numpy(a).to(cuda) for a in host]
    got = fm.sweep_multi(*ops, strict=strict)
    torch.cuda.synchronize()
    assert torch.equal(got, fm.sweep_multi_plain(*ops, strict=strict))


@pytest.mark.parametrize("n_res", [1, 4, 8, 9])
@pytest.mark.parametrize(
    "variant", list(itertools.product((False, True), repeat=3)),
    ids=lambda v: "-".join(str(int(b)) for b in v),
)
def test_multi_kernel_with_every_mask_0(cuda, variant, n_res):
    """Every node masked out: the totals are 0 in the masked variants, and
    equal to the plain version's in all of them."""
    rcp, strict, mask = variant
    ops = _multi_operands(3_000, 300, n_res, n_res, cuda, rcp, mask)
    if mask:
        ops[6].zero_()
    got = fm.sweep_multi(*ops, strict=strict)
    torch.cuda.synchronize()
    assert torch.equal(got, fm.sweep_multi_plain(*ops, strict=strict))
    if mask:
        assert not got.any()


def test_multi_sweep_on_card_matches_host(cuda):
    rng = np.random.default_rng(5)
    snap = synthetic_snapshot(10_000, seed=5)
    n, s = snap.n_nodes, 1_000
    gib = 1 << 30
    alloc_rn = np.stack([snap.alloc_cpu_milli, snap.alloc_mem_bytes,
                         rng.integers(50, 500, n) * gib,
                         rng.integers(0, 9, n)])
    used_rn = np.stack([snap.used_cpu_req_milli, snap.used_mem_req_bytes,
                        rng.integers(0, 50, n) * gib, np.zeros(n, np.int64)])
    grid = random_scenario_grid(s, seed=6)
    reqs = np.stack([grid.cpu_request_milli, grid.mem_request_bytes,
                     rng.integers(1, 20, s) * gib, rng.integers(0, 3, s)],
                    axis=1)
    args = (alloc_rn, used_rn, snap.alloc_pods, snap.pods_count,
            snap.healthy, reqs, grid.replicas)
    card = fm.sweep_multi_auto(*args, device="cuda")
    host = fm.sweep_multi_auto(*args, device="cpu")
    exact = fm.sweep_multi_auto(*args, force_exact=True, device="cuda")
    assert card[2] == "cuda_multi_i32_rcp_fused"
    assert host[2] == "plain_multi_i32_rcp_fused"
    assert exact[2] == "torch_int64_multi"
    np.testing.assert_array_equal(card[0], host[0])
    np.testing.assert_array_equal(card[0], exact[0])


def _gpu_snapshot(n, seed):
    """A strict, taint-masked fleet with GPU and storage columns."""
    fx = synthetic_fixture(n, seed=seed, taint_frac=0.1, unhealthy_frac=0.05)
    rng = np.random.default_rng(seed)
    for node in fx["nodes"]:
        node["allocatable"]["nvidia.com/gpu"] = str(int(rng.integers(0, 9)))
        node["allocatable"]["ephemeral-storage"] = \
            f"{int(rng.integers(50, 501))}Gi"
    return snapshot_from_fixture(
        fx, semantics="strict",
        extended_resources=("ephemeral-storage", "nvidia.com/gpu"),
    )


def test_model_sweeps_launch_each_kernel_once(cuda):
    snap = _gpu_snapshot(4_000, seed=7)
    grid = random_scenario_grid(500, seed=8)
    card = CapacityModel(snap, mode="strict")
    host = CapacityModel(snap, mode="strict", device="cpu")
    ff.LAUNCHES = fm.LAUNCHES = 0
    totals, sched = card.sweep(grid)
    assert (ff.LAUNCHES, fm.LAUNCHES) == (1, 0)
    want = host.sweep(grid)
    np.testing.assert_array_equal(totals, want[0])
    np.testing.assert_array_equal(sched, want[1])

    rng = np.random.default_rng(9)
    mgrid = MultiResourceGrid.from_grid(grid, {
        "nvidia.com/gpu": rng.integers(0, 3, grid.size),
        "ephemeral-storage": rng.integers(1, 20, grid.size) << 30,
    })
    ff.LAUNCHES = fm.LAUNCHES = 0
    totals, sched = card.sweep_multi(mgrid)
    assert (ff.LAUNCHES, fm.LAUNCHES) == (0, 1)
    want = host.sweep_multi(mgrid)
    np.testing.assert_array_equal(totals, want[0])
    np.testing.assert_array_equal(sched, want[1])


def test_model_evaluate_on_card_matches_host(cuda):
    snap = _gpu_snapshot(3_000, seed=10)
    for requests in ({}, {"nvidia.com/gpu": 1}):
        spec = PodSpec(cpu_request_milli=250, mem_request_bytes=256 << 20,
                       replicas=100, extended_requests=requests)
        card = CapacityModel(snap, mode="strict").evaluate(spec)
        host = CapacityModel(snap, mode="strict", device="cpu").evaluate(spec)
        np.testing.assert_array_equal(card.fits, host.fits)
        assert card.total == host.total > 0


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("mode", ["reference", "strict"])
def test_explain_on_card_matches_host(cuda, mode, grouped):
    snap = (synthetic_snapshot(20_000, seed=2, shapes=48) if grouped
            else synthetic_snapshot(5_000, seed=3))
    grid = random_scenario_grid(200, seed=11)
    mask = np.random.default_rng(12).random(snap.n_nodes) < 0.8
    card = sweep_explain_snapshot(snap, grid, mode=mode, node_mask=mask)
    host = sweep_explain_snapshot(snap, grid, mode=mode, node_mask=mask,
                                  device="cpu")
    assert card[3] == host[3] == "torch_int64_sweep_explain" + (
        "_grouped" if grouped else "")
    np.testing.assert_array_equal(card[0], host[0])
    np.testing.assert_array_equal(card[1], host[1])
    for name in ("fits", "binding", "cpu_fit", "mem_fit", "slots"):
        np.testing.assert_array_equal(getattr(card[2], name),
                                      getattr(host[2], name))
    solo = explain_snapshot(snap, grid, mode=mode, node_mask=mask)
    np.testing.assert_array_equal(solo.binding, card[2].binding)
    exact = sweep_snapshot_auto(snap, grid, mode=mode, kernel="exact",
                                node_mask=mask, device="cuda")
    np.testing.assert_array_equal(card[0], exact[0])
    q = (0, 17, 100, 199)
    qt = sweep_quantiles_snapshot(snap, grid, mode=mode, node_mask=mask,
                                  q_indices=q)
    order = np.argsort(exact[0], kind="stable")
    np.testing.assert_array_equal(qt[3], order[list(q)])
    np.testing.assert_array_equal(qt[2], exact[0][order][list(q)])


# -- the service and its runtime glue on the card ---------------------------

def _serve(snap, **kw):
    from kubernetesclustercapacity_tpu_torch.service.server import (
        CapacityServer,
    )

    server = CapacityServer(snap, **kw)
    server.start()
    return server


def _ask(server, msg):
    import socket

    from kubernetesclustercapacity_tpu_torch.service import protocol

    with socket.create_connection(server.address, timeout=120) as sock:
        sock.settimeout(120)
        protocol.send_msg(sock, msg)
        return protocol.recv_msg(sock)


def test_server_sweep_launches_b1_once_and_matches_host(cuda):
    snap = synthetic_snapshot(5_000, seed=21)
    card = _serve(snap, batch_window_ms=0)
    host = _serve(snap, batch_window_ms=0, device="cpu")
    try:
        msg = {"op": "sweep", "random": {"n": 500, "seed": 22}}
        before = ff.LAUNCHES
        got = _ask(card, msg)
        assert ff.LAUNCHES - before == 1
        assert got["result"]["kernel"] == "cuda_i32_rcp_fused"
        want = _ask(host, msg)
        assert got["result"]["totals"] == want["result"]["totals"]
        exact = _ask(card, dict(msg, kernel="exact"))
        assert exact["result"]["totals"] == want["result"]["totals"]
        fit = {"op": "fit", "cpuRequests": "200m", "memRequests": "250mb",
               "replicas": "10", "output": "json"}
        assert _ask(card, fit) == _ask(host, fit)
        explain = {"op": "explain", "cpuRequests": "300m",
                   "memRequests": "500mb", "output": "json"}
        assert _ask(card, explain) == _ask(host, explain)
    finally:
        card.shutdown()
        host.shutdown()


def test_server_sweep_multi_launches_b2_once(cuda):
    snap = _gpu_snapshot(4_000, seed=23)
    card = _serve(snap, batch_window_ms=0)
    host = _serve(snap, batch_window_ms=0, device="cpu")
    try:
        rng = np.random.default_rng(24)
        msg = {"op": "sweep_multi",
               "resources": ["cpu", "memory", "nvidia.com/gpu",
                             "ephemeral-storage"],
               "requests": [[int(rng.integers(100, 2000)),
                             int(rng.integers(64, 4096)) << 20,
                             int(rng.integers(0, 3)),
                             int(rng.integers(1, 20)) << 30]
                            for _ in range(300)]}
        before = fm.LAUNCHES
        got = _ask(card, msg)
        assert fm.LAUNCHES - before == 1
        assert got["result"]["kernel"] == "cuda_multi_i32_rcp_fused"
        assert got["result"]["totals"] == _ask(host, msg)["result"]["totals"]
    finally:
        card.shutdown()
        host.shutdown()


def test_folded_sweeps_launch_b1_once_on_the_card(cuda):
    import threading

    snap = synthetic_snapshot(5_000, seed=25)
    solo = _serve(snap, batch_window_ms=0)
    folded = _serve(snap, batch_window_ms=60_000, batch_max=8,
                    max_inflight=8)
    try:
        msgs = [{"op": "sweep", "random": {"n": 125, "seed": 30 + i}}
                for i in range(8)]
        want = [_ask(solo, m) for m in msgs]
        got = [None] * 8

        def run(i):
            got[i] = _ask(folded, msgs[i])

        before = ff.LAUNCHES
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert ff.LAUNCHES - before == 1
        assert got == want
    finally:
        solo.shutdown()
        folded.shutdown()


@pytest.mark.parametrize("kernel", ["auto", "exact"])
def test_async_sweep_on_card_equals_sync(cuda, kernel):
    snap = synthetic_snapshot(5_000, seed=26)
    grid = random_scenario_grid(300, seed=27)
    sync = sweep_snapshot_auto(snap, grid, kernel=kernel)
    pending = sweep_snapshot_auto(snap, grid, kernel=kernel, sync=False)
    assert pending[0].fetch.staged.is_cuda
    np.testing.assert_array_equal(np.asarray(pending[0]), sync[0])
    np.testing.assert_array_equal(np.asarray(pending[1]), sync[1])
    assert pending[0].fetch.staged is None


def test_folded_fetch_is_booked_until_a_member_reads_it(cuda):
    """A folded dispatch's pending copy (one packed int64 buffer of every
    member's totals and flags) is booked under ``fold_fetch`` until the
    first member reads its slice, and off the book after."""
    from kubernetesclustercapacity_tpu_torch.service.server import (
        CapacityServer,
    )
    from kubernetesclustercapacity_tpu_torch.telemetry import memledger

    def booked():
        return memledger.LEDGER.stats()["by_form"].get("fold_fetch", 0)

    assert memledger.enabled()
    snap = synthetic_snapshot(5_000, seed=29)
    grids = [random_scenario_grid(100 + 20 * i, seed=31 + i)
             for i in range(3)]
    server = CapacityServer(snap, device="cuda", port=0)
    try:
        before = booked()
        out = server._dispatch_sweep_batch(
            (0, snap.semantics, "auto"),
            [("sweep", snap, None, g) for g in grids])
        assert [o[2] for o in out] == ["cuda_i32_rcp_fused"] * 3
        assert booked() - before == 2 * 360 * 8
        got = np.asarray(out[1][0])
        assert booked() == before
        for (totals, sched, _), g in zip(out, grids):
            want = sweep_snapshot_auto(snap, g)
            np.testing.assert_array_equal(np.asarray(totals), want[0])
            np.testing.assert_array_equal(np.asarray(sched), want[1])
        np.testing.assert_array_equal(got, np.asarray(out[1][0]))
    finally:
        server.shutdown()


def test_stage_replace_copies_in_place_on_the_card(cuda):
    import dataclasses

    from kubernetesclustercapacity_tpu_torch import devcache
    from kubernetesclustercapacity_tpu_torch.telemetry import memledger

    cache = devcache.DeviceCache()
    old = synthetic_snapshot(5_000, seed=28)
    prior = cache.exact_tensors(old, cuda)
    ptr = prior[3].data_ptr()
    used = old.used_cpu_req_milli.copy()
    used[:100] += 17
    new = dataclasses.replace(old, used_cpu_req_milli=used)
    del prior
    counts = cache.stage_replace(old, new, cuda)
    # exact: six columns carried over, one copied in place; the kernel
    # form was never staged for the old snapshot, so it stages fresh.
    assert counts == {"reused": 6, "copied": 1, "restaged": 6}
    staged = cache.exact_tensors(new, cuda)
    assert staged[3].data_ptr() == ptr
    fresh = devcache.DeviceCache()
    for form in ("exact_tensors", "kernel_tensors"):
        for a, b in zip(getattr(cache, form)(new, cuda),
                        getattr(fresh, form)(new, cuda)):
            assert torch.equal(a, b)
    audit = memledger.LEDGER.reconcile()
    assert audit["allocated_bytes"] >= audit["tracked_cuda_bytes"] > 0


# -- the live cluster on the card: update and -follow publishes --------------

def _pod_events(fixture, n, seed, *, gpus=False):
    """``n`` seeded pod ADDED events on random nodes of ``fixture``."""
    rng = np.random.default_rng(seed)
    names = [node["name"] for node in fixture["nodes"]]
    events = []
    for i in range(n):
        requests = {"cpu": f"{int(rng.integers(50, 2000))}m",
                    "memory": f"{int(rng.integers(64, 2048))}Mi"}
        if gpus:
            requests["nvidia.com/gpu"] = str(int(rng.integers(0, 2)))
        events.append({"type": "ADDED", "kind": "Pod", "object": {
            "name": f"live-{seed}-{i}", "namespace": "default",
            "nodeName": names[int(rng.integers(len(names)))],
            "phase": "Running",
            "containers": [{"resources": {"requests": requests,
                                          "limits": requests}}],
        }})
    return events


def test_update_then_sweep_launches_b1_once(cuda):
    fixture = synthetic_fixture(3_000, seed=40, taint_frac=0.1)
    snap = snapshot_from_fixture(fixture)
    card = _serve(snap, fixture=fixture, batch_window_ms=0)
    host = _serve(snap, fixture=fixture, batch_window_ms=0, device="cpu")
    try:
        msg = {"op": "sweep", "random": {"n": 500, "seed": 41}}
        for batch in range(3):
            update = {"op": "update",
                      "events": _pod_events(fixture, 100, 42 + batch)}
            assert _ask(card, update) == _ask(host, update)
            before = ff.LAUNCHES
            got = _ask(card, msg)
            assert ff.LAUNCHES - before == 1
            assert got["result"]["kernel"] == "cuda_i32_rcp_fused"
            assert got["generation"] == batch + 2
            assert got["result"]["totals"] == _ask(host, msg)["result"][
                "totals"]
    finally:
        card.shutdown()
        host.shutdown()


class _StoreFollower:
    """Stands in for a ``ClusterFollower`` (no apiserver): a store whose
    applied events notify the publisher exactly as watch events do."""

    def __init__(self, store):
        self.store = store
        self.on_event = None

    def snapshot(self):
        return self.store.snapshot()

    def fixture_view(self):
        return self.store.fixture_view()

    def start_watches(self):
        pass

    def stop(self):
        pass

    def apply(self, events):
        for event in events:
            self.store.apply_event(event)
            self.on_event(event["kind"], event["type"], event["object"])


def _follow(fixture, **store_kw):
    from kubernetesclustercapacity_tpu_torch.service.server import (
        follow_publisher,
    )
    from kubernetesclustercapacity_tpu_torch.store import ClusterStore

    follower = _StoreFollower(ClusterStore(fixture, **store_kw))
    server = _serve(follower.snapshot(), batch_window_ms=0)
    coalescer, fatal = follow_publisher(server, follower, coalesce_ms=0)
    return follower, server, coalescer, fatal


def test_follow_publish_restages_and_the_next_sweep_reads_it(cuda):
    from kubernetesclustercapacity_tpu_torch import devcache

    fixture = synthetic_fixture(3_000, seed=43)
    follower, server, coalescer, fatal = _follow(fixture)
    try:
        msg = {"op": "sweep", "random": {"n": 500, "seed": 44}}
        _ask(server, msg)  # stages generation 1's kernel form
        before = devcache.CACHE.stats()["stage_replace"]
        follower.apply(_pod_events(fixture, 50, 45))
        assert coalescer.stop(timeout=120)
        assert coalescer.last_error is None and fatal == []
        moved = {k: v - before[k] for k, v in
                 devcache.CACHE.stats()["stage_replace"].items()}
        assert moved["reused"] + moved["copied"] >= 1
        launches = ff.LAUNCHES
        got = _ask(server, msg)
        assert ff.LAUNCHES - launches == 1
        want = sweep_snapshot_auto(
            snapshot_from_fixture(follower.fixture_view()),
            random_scenario_grid(500, seed=44), device="cpu")
        assert got["result"]["totals"] == want[0].tolist()
        assert got["generation"] == server.generation > 1
    finally:
        server.shutdown()


def test_strict_follow_sweep_multi_launches_b2_once(cuda):
    from kubernetesclustercapacity_tpu_torch import sweep_multi_auto

    fixture = synthetic_fixture(3_000, seed=46, taint_frac=0.1)
    for i, node in enumerate(fixture["nodes"]):
        node["allocatable"]["nvidia.com/gpu"] = str(i % 9)
    follower, server, coalescer, fatal = _follow(
        fixture, semantics="strict", extended_resources=("nvidia.com/gpu",))
    try:
        follower.apply(_pod_events(fixture, 80, 47, gpus=True))
        assert coalescer.stop(timeout=120)
        assert coalescer.last_error is None and fatal == []
        rng = np.random.default_rng(48)
        requests = [[int(rng.integers(100, 2000)),
                     int(rng.integers(64, 4096)) << 20,
                     int(rng.integers(0, 3))] for _ in range(300)]
        msg = {"op": "sweep_multi",
               "resources": ["cpu", "memory", "nvidia.com/gpu"],
               "requests": requests}
        before = fm.LAUNCHES
        got = _ask(server, msg)
        assert fm.LAUNCHES - before == 1
        assert got["result"]["kernel"] == "cuda_multi_i32_rcp_fused"
        snap = snapshot_from_fixture(follower.fixture_view(),
                                     semantics="strict",
                                     extended_resources=("nvidia.com/gpu",))
        from kubernetesclustercapacity_tpu_torch import implicit_taint_mask

        alloc_rn, used_rn = snap.resource_matrix(tuple(msg["resources"]))
        want = sweep_multi_auto(
            alloc_rn, used_rn, snap.alloc_pods, snap.pods_count,
            snap.healthy, np.asarray(requests), np.ones(300, np.int64),
            mode="strict", node_masks=implicit_taint_mask(snap),
            force_exact=True, device="cpu")
        assert got["result"]["totals"] == want[0].tolist()
    finally:
        server.shutdown()


# -- scheduler fidelity: the placement scans and preemption on the card ----

def _sched_fixture(n, seed):
    fx = synthetic_fixture(n, seed=seed, taint_frac=0.1)
    rng = np.random.default_rng(seed + 1)
    for pod in fx["pods"]:
        pod["priority"] = int(rng.choice([0, 1000, 100000]))
    return fx


@pytest.mark.parametrize("policy", ["first-fit", "best-fit", "spread"])
def test_placement_scans_on_card_equal_the_host_engines(cuda, policy):
    from kubernetesclustercapacity_tpu_torch.ops import placement as pl

    snap = snapshot_from_fixture(_sched_fixture(2_000, 3), semantics="strict")
    cols = (snap.alloc_cpu_milli, snap.alloc_mem_bytes, snap.alloc_pods,
            snap.used_cpu_req_milli, snap.used_mem_req_bytes,
            snap.pods_count, snap.healthy)
    kw = dict(n_replicas=256, policy=policy)
    order, counts = pl.place_replicas(*cols, 500, 512 << 20, **kw)
    trace, t_counts, placed = pl.place_replicas_trace(*cols, 500, 512 << 20,
                                                      **kw)
    np.testing.assert_array_equal(order, trace)
    np.testing.assert_array_equal(counts, t_counts)
    py_order, _ = pl.place_replicas_python(*cols, 500, 512 << 20, **kw)
    np.testing.assert_array_equal(order, py_order)
    assert placed == 256
    zone = np.arange(snap.n_nodes) % 3
    got = pl.place_replicas_spread(*cols, 500, 512 << 20, zone, n_zones=3,
                                   **kw)
    want = pl.place_replicas_spread(*cols, 500, 512 << 20, zone, n_zones=3,
                                    device="cpu", **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(4)
    reqs = np.stack([rng.integers(0, 4000, 64), rng.integers(0, 8 << 30, 64)])
    alloc_rn, used_rn = snap.resource_matrix()
    got = pl.place_pods_multi(alloc_rn, used_rn, snap.alloc_pods,
                              snap.pods_count, snap.healthy, reqs,
                              policy=policy)
    want = pl.place_pods_multi_python(alloc_rn, used_rn, snap.alloc_pods,
                                      snap.pods_count, snap.healthy, reqs,
                                      policy=policy)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_nodes_needed_grid_launches_b1_on_the_card(cuda):
    fx = _sched_fixture(3_000, 5)
    snap = snapshot_from_fixture(fx, semantics="strict")
    grid = random_scenario_grid(500, seed=6)
    template = {"allocatable": {"cpu": "4", "memory": "16Gi", "pods": "58"}}
    card = CapacityModel(snap, fixture=fx)
    host = CapacityModel(snap, fixture=fx, device="cpu")
    ff.LAUNCHES = fm.LAUNCHES = 0
    needed = card.nodes_needed_grid(grid, template)
    assert (ff.LAUNCHES, fm.LAUNCHES) == (2, 0)
    np.testing.assert_array_equal(needed,
                                  host.nodes_needed_grid(grid, template))
    prio = np.random.default_rng(7).choice([0, 1000, 100000], grid.size)
    for g, w in zip(card.sweep_preemption(grid, prio),
                    host.sweep_preemption(grid, prio)):
        np.testing.assert_array_equal(g, w)
    node = max(snap.names, key=lambda n: sum(p.get("nodeName") == n
                                             for p in fx["pods"]))
    assert card.drain(node).assignments == host.drain(node).assignments


# The stochastic family on the card: the seeded sampler's draws equal its
# host draws (the same XLA-order arithmetic; the one libm log runs on the
# host for both), and capacity-at-risk, the horizon and the plan equal
# their numpy oracles / host runs.

_SAMPLER_CASES = [
    ("normal", {"mean": 500.0, "std": 150.0}),
    ("normal", {"mean": 10.0, "std": 1e6}),
    ("lognormal", {"mean": float(4 << 30), "sigma": 1.0}),
    ("lognormal", {"mean": 1e9, "sigma": 4.0}),
    ("empirical", {"values": (100, 200, 900), "weights": (8.0, 1.0, 1.0)}),
]


@pytest.mark.parametrize("case", _SAMPLER_CASES,
                         ids=[k for k, _ in _SAMPLER_CASES])
def test_card_draws_equal_host_draws(cuda, case):
    kind, kw = case
    dist = _stochastic.UsageDistribution(kind=kind, **kw)
    for seed, stream in ((0, 0), (11, 1), (-5, 1)):
        key = _stochastic.sample_key(seed, stream)
        host = _stochastic.sample_usage(dist, 1 << 16, key, device="cpu")
        card = _stochastic.sample_usage(dist, 1 << 16, key, device=cuda)
        assert np.array_equal(card, host), int((card != host).sum())


_CAR_DOC = {
    "usage": {"cpu": {"dist": "normal", "mean": "500m", "std": "200m"},
              "memory": {"dist": "lognormal", "mean": "4gb", "sigma": 1.0}},
    "replicas": 5000, "samples": 512, "seed": 11,
}


@pytest.mark.parametrize("mode", ["reference", "strict"])
@pytest.mark.parametrize("shapes", [None, 12])
def test_capacity_at_risk_on_the_card_equals_the_oracle(cuda, mode, shapes):
    snap = synthetic_snapshot(2000, seed=1, **({"shapes": shapes}
                                                 if shapes else {}))
    spec = _stochastic.parse_stochastic_spec(_CAR_DOC)
    mask = np.random.default_rng(2).random(snap.n_nodes) > 0.2
    want = _stochastic.car_oracle(snap, spec, mode=mode, node_mask=mask)
    for fused in (True, False):
        got = _stochastic.capacity_at_risk(snap, spec, mode=mode,
                                           node_mask=mask, fused=fused,
                                           device=cuda)
        assert np.array_equal(got.totals, want.totals)
        assert got.quantiles == want.quantiles
        assert got.quantile_samples == want.quantile_samples
        assert (got.mean, got.prob_fit) == (want.mean, want.prob_fit)
    host = _stochastic.capacity_at_risk(snap, spec, mode=mode,
                                        node_mask=mask, device="cpu")
    assert got.bindings == host.bindings


def test_horizon_and_plan_on_the_card_equal_the_host(cuda):
    snap = synthetic_snapshot(2000, seed=1)
    spec = _stochastic.parse_stochastic_spec(dict(_CAR_DOC, samples=128))
    kw = dict(steps=8, step_s=3600.0, growth_cpu_per_s=2e-6)
    card = _forecast.project_horizon(snap, spec, device=cuda, **kw)
    want = _forecast.horizon_oracle(snap, spec, **kw)
    assert np.array_equal(card.totals, want.totals)
    assert card.time_to_breach_s == want.time_to_breach_s
    catalog = _forecast.parse_catalog([
        {"name": "m5.xlarge", "cpu": "4", "memory": "16gb", "pods": 58,
         "unit_cost": 4},
        {"name": "c5.4xlarge", "cpu": "16", "memory": "32gb", "pods": 234,
         "unit_cost": 16}])
    target = card.quantiles[0.95][0] + 500
    got = _forecast.plan_capacity(snap, spec, catalog, target=target,
                                  drain=True, device=cuda).to_wire()
    host = _forecast.plan_capacity(snap, spec, catalog, target=target,
                                   drain=True, device="cpu").to_wire()
    assert got == host and got["status"] == "certified"


_GANG_SPECS = [
    dict(ranks=64, colocate="rack"),
    dict(ranks=12, colocate="host"),
    dict(ranks=64, colocate="zone", spread_level="rack",
         max_ranks_per_domain=16),
    dict(ranks=16, colocate="rack", anti_affinity_host=True),
    dict(ranks=25, anti_affinity_host=True),
    dict(ranks=9),
]


def _gang_fields(res):
    return (res.to_wire(), res.largest_cap.tolist(), res.largest_domain,
            None if res.co_caps is None else res.co_caps.tolist(),
            res.co_domains)


@pytest.mark.parametrize("gang_grouped", ["1", "0"])
@pytest.mark.parametrize("mode", ["reference", "strict"])
def test_gang_capacity_on_the_card_equals_the_oracle(cuda, mode,
                                                     gang_grouped,
                                                     monkeypatch):
    """The grouped engine (int64 products over groups, no matmul) and the
    per-node engine with the spread searches, on the card."""
    monkeypatch.setenv("KCCAP_GANG_GROUPED", gang_grouped)
    snap = synthetic_snapshot(4096, seed=21, shapes=64, topology=(4, 8))
    grid = random_scenario_grid(24, seed=777)
    mask = np.random.default_rng(3).random(snap.n_nodes) > 0.1
    from kubernetesclustercapacity_tpu_torch.ops.fit import sweep_grid

    cols = [torch.from_numpy(np.ascontiguousarray(getattr(snap, c))) for c in (
        "alloc_cpu_milli", "alloc_mem_bytes", "alloc_pods",
        "used_cpu_req_milli", "used_mem_req_bytes", "pods_count",
        "healthy")]
    per_node = sweep_grid(
        *cols, *(torch.from_numpy(np.asarray(a)) for a in (
            grid.cpu_request_milli, grid.mem_request_bytes, grid.replicas)),
        mode=mode, node_mask=torch.from_numpy(mask),
        return_per_node=True)[2].numpy()
    topo = _topology.topology_from_snapshot(snap)
    for kw in _GANG_SPECS:
        spec = _topology.GangSpec(**kw)
        card = _topology.gang_capacity(snap, grid, spec, mode=mode,
                                       node_mask=mask, device=cuda)
        host = _topology.gang_capacity(snap, grid, spec, mode=mode,
                                       node_mask=mask, device="cpu")
        assert card.engine == ("grouped" if gang_grouped == "1"
                               else "per-node")
        assert _gang_fields(card) == _gang_fields(host), kw
        assert card.gangs.tolist() == _topology.gang_oracle(
            per_node, topo, spec, node_mask=mask), kw


def test_gang_explain_on_the_card_equals_the_host(cuda):
    fx = synthetic_fixture(600, seed=9, topology=(3, 4), taint_frac=0.1)
    snap = snapshot_from_fixture(fx, semantics="strict")
    grid = random_scenario_grid(2, seed=5)
    for kw in _GANG_SPECS:
        spec = _topology.GangSpec(**kw)
        assert _topology.gang_explain(snap, grid, spec, device=cuda) == \
            _topology.gang_explain(snap, grid, spec, device="cpu"), kw


def test_gang_device_programs_on_the_card_equal_the_host(cuda):
    from kubernetesclustercapacity_tpu_torch.topology import gang

    rng = np.random.default_rng(4)
    fits = rng.integers(-50, 4000, size=(40, 300))
    fits[rng.random(fits.shape) < 0.02] = 1 << 50
    cnt = rng.integers(0, 500, size=(300, 33))
    codes = rng.integers(-1, 20, size=300)
    parent = rng.integers(-1, 4, size=33)
    host = [torch.from_numpy(a.astype(np.int64))
            for a in (fits, cnt, codes, parent)]
    card = [t.to(cuda) for t in host]
    for fn in (
        lambda f, c, k, p: gang._domain_caps(f, k, n_domains=20),
        lambda f, c, k, p: gang._grouped_caps(f, c),
        lambda f, c, k, p: gang._gangs_spread(
            gang._grouped_caps(f, c), p, 64, 16, n_co=4),
        lambda f, c, k, p: gang._gangs_spread_per_group(f, c, 16, 1),
        lambda f, c, k, p: gang._gangs_colocated_per_group(
            f, c[:, 0].contiguous(), 8),
    ):
        assert torch.equal(fn(*card).cpu(), fn(*host))


@pytest.mark.parametrize("shapes", [48, None])
def test_pdhg_integer_answers_on_the_card_equal_the_host(cuda, shapes):
    snap = synthetic_snapshot(3000, seed=23, **({"shapes": shapes}
                                                 if shapes else {}))
    grid = random_scenario_grid(16, seed=23)
    card = _optimize.optimize_snapshot(snap, grid, mode="strict",
                                       device=cuda)
    host = _optimize.optimize_snapshot(snap, grid, mode="strict",
                                       device="cpu")
    for name in ("demand", "rounded", "ffd", "ffd_totals", "schedulable"):
        assert np.array_equal(getattr(card, name), getattr(host, name))
    assert card.all_certified and card.verified.all()
    assert np.array_equal(card.rounded, card.ffd)
    np.testing.assert_allclose(card.lp_bound, host.lp_bound, rtol=1e-9)
    want = _optimize.lp_bound_oracle(snap, grid, mode="strict")
    assert (np.abs(card.lp_bound - want)
            <= 4 * card.tol * np.maximum(np.abs(want), 1.0)).all()


# The operator's view on the card: the capacity timeline evaluates its
# watches there, and /healthz and /metrics answer with a card present.
_TIMELINE_WATCHES = [
    {"name": "plain", "pod": {"cpuRequests": "500m", "memRequests": "1gb"},
     "min_replicas": 1},
    {"name": "strict", "pod": {"cpuRequests": "1", "memRequests": "2gb"},
     "semantics": "strict"},
    {"name": "p95", "pod": {"cpuRequests": "500m", "memRequests": "1gb",
                            "replicas": "40"}, "quantile": 0.95,
     "usage": {"cpu": {"dist": "normal", "mean": "500m", "std": "200m"},
               "memory": {"dist": "lognormal", "mean": "1gb",
                          "sigma": 0.5}},
     "samples": 256, "seed": 3},
    {"name": "fc", "pod": {"cpuRequests": "500m", "memRequests": "1gb",
                           "replicas": "40"}, "quantile": 0.9,
     "usage": {"cpu": {"dist": "normal", "mean": "500m", "std": "200m"}},
     "samples": 64, "seed": 4, "horizon": {"steps": 4, "step_s": 3600}},
    {"name": "train", "pod": {"cpuRequests": "2", "memRequests": "4gb"},
     "gang": {"ranks": 16, "colocate": "rack"}, "min_replicas": 1},
]


def test_timeline_observe_on_the_card_equals_the_cpu(cuda):
    import dataclasses

    from kubernetesclustercapacity_tpu_torch.timeline import (
        CapacityTimeline,
        parse_watchlist,
    )

    specs = parse_watchlist(_TIMELINE_WATCHES)
    card = CapacityTimeline(specs, device="cuda")
    host = CapacityTimeline(specs, device="cpu")
    snap = synthetic_snapshot(3000, seed=5, topology=(2, 4))
    for g in range(1, 6):
        for tl in (card, host):
            tl.observe(snap, g, ts=1000.0 + 600.0 * g)
        used = np.asarray(snap.used_cpu_req_milli) + 150 * g
        snap = dataclasses.replace(snap, used_cpu_req_milli=used)
    want, got = host.wire(), card.wire()
    for doc in (want, got):
        for rec in doc["records"]:
            rec.pop("eval_ms")
    assert got == want
    last = got["records"][-1]["watches"]
    assert last["fc"]["horizon_min_capacity"] is not None
    assert last["train"]["gang"]["ranks"] == 16


def test_healthz_and_metrics_answer_with_a_card(cuda):
    import json
    import urllib.request

    from kubernetesclustercapacity_tpu_torch.service import CapacityServer
    from kubernetesclustercapacity_tpu_torch.service.server import (
        healthz_probes,
    )
    from kubernetesclustercapacity_tpu_torch.telemetry.exposition import (
        start_metrics_server,
    )
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
        MetricsRegistry,
    )
    from kubernetesclustercapacity_tpu_torch.timeline import (
        CapacityTimeline,
        parse_watchlist,
    )

    reg = MetricsRegistry()
    timeline = CapacityTimeline(parse_watchlist(_TIMELINE_WATCHES[:3]),
                                registry=reg, device="cuda")
    server = CapacityServer(synthetic_snapshot(2000, seed=6),
                            device="cuda", registry=reg, timeline=timeline)
    healthy, status = healthz_probes(server, timeline=timeline)
    metrics = start_metrics_server(reg, healthy=healthy, status=status)
    try:
        server.dispatch({"op": "sweep", "random": {"n": 64, "seed": 1}})
        with urllib.request.urlopen(metrics.url + "/healthz") as r:
            code, body = r.status, json.loads(r.read())
        with urllib.request.urlopen(metrics.url + "/metrics") as r:
            text = r.read().decode()
    finally:
        metrics.shutdown()
        server.shutdown()
    assert code == 200 and body["ok"] is True
    assert body["timeline"]["records"] == 1
    assert body["device_memory"]["leak_alert"]["state"] != "breached"
    assert 'kccap_watch_replicas{watch="plain"}' in text
    assert 'kccap_car_replicas{watch="p95"}' in text


def test_replay_on_the_card_launches_b1_and_equals_the_host(cuda, tmp_path):
    """A log written by a server on the card replays clean on the card
    (each replayed sweep one launch of B1) and on the host, alike."""
    from kubernetesclustercapacity_tpu_torch.audit import (
        AuditLog,
        AuditReader,
        Replayer,
    )
    from kubernetesclustercapacity_tpu_torch.service import CapacityServer

    log = AuditLog(str(tmp_path / "audit"), checkpoint_every=2)
    server = CapacityServer(synthetic_snapshot(3_000, seed=31),
                            device="cuda", batch_window_ms=0, audit_log=log)
    try:
        for g in range(3):
            server.dispatch({"op": "sweep", "random": {"n": 256, "seed": g}})
            server.dispatch({"op": "explain", "cpuRequests": "300m",
                             "memRequests": "500mb"})
            server.replace_snapshot(synthetic_snapshot(3_000, seed=32 + g))
    finally:
        server.shutdown()
        log.close()
    results = {}
    for device in ("cuda", "cpu"):
        before = ff.LAUNCHES
        with Replayer(AuditReader.load(str(tmp_path / "audit")),
                      device=device) as rp:
            results[device] = rp.replay_all()
        if device == "cuda":
            assert ff.LAUNCHES - before == 3
    assert results["cuda"] == results["cpu"]
    assert results["cuda"]["clean"]
    assert results["cuda"]["counts"] == {"ok": 6, "mismatch": 0,
                                         "skipped": 0, "error": 0}


def test_replica_sweep_launches_b1_once_and_equals_the_leader(cuda):
    """A replica on the card stages each verified generation there; its
    sweep is one launch of B1 and equals the leader's."""
    import time

    from kubernetesclustercapacity_tpu_torch.service import CapacityServer
    from kubernetesclustercapacity_tpu_torch.service.plane import (
        PlanePublisher,
        PlaneSubscriber,
    )

    pub = PlanePublisher(heartbeat_s=3600.0)
    leader = CapacityServer(synthetic_snapshot(4_000, seed=41),
                            device="cuda", batch_window_ms=0, plane=pub)
    replica = CapacityServer(synthetic_snapshot(10, seed=1), device="cuda",
                             batch_window_ms=0)
    sub = PlaneSubscriber(pub.address, replica, stale_after_s=30.0)
    try:
        leader.replace_snapshot(synthetic_snapshot(4_000, seed=42))
        deadline = time.monotonic() + 60
        while sub.applied_generation < leader.generation:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        msg = {"op": "sweep", "random": {"n": 1_000, "seed": 7}}
        before = ff.LAUNCHES
        got = replica.dispatch(dict(msg))
        assert ff.LAUNCHES - before == 1
        assert got["kernel"] == "cuda_i32_rcp_fused"
        assert got["totals"] == leader.dispatch(dict(msg))["totals"]
    finally:
        pub.close()
        sub.stop()
        leader.shutdown()
        replica.shutdown()


def test_federation_rows_on_the_card_equal_the_leaders_b1_sweeps(cuda):
    """A federation on the card follows three leaders on the card; each
    ``per_cluster`` row of its ``fed_sweep`` equals that leader's ``sweep``
    (one B1 launch each) of the same grid, and the grand totals their
    sum."""
    import time

    from kubernetesclustercapacity_tpu_torch.federation import (
        FederationServer,
    )
    from kubernetesclustercapacity_tpu_torch.service import CapacityServer
    from kubernetesclustercapacity_tpu_torch.service.plane import (
        PlanePublisher,
    )

    leaders, pubs = {}, {}
    for k, name in enumerate(("east", "west", "north")):
        fx = synthetic_fixture(2_000, seed=8 + k, taint_frac=0.1)
        pubs[name] = PlanePublisher(heartbeat_s=0.2)
        leaders[name] = CapacityServer(
            snapshot_from_fixture(fx, semantics="strict"), device="cuda",
            batch_window_ms=0, plane=pubs[name])
    fed = FederationServer({n: p.address for n, p in pubs.items()},
                           stale_after_s=30.0, evict_after_s=60.0,
                           device="cuda")
    try:
        deadline = time.monotonic() + 60
        while fed.status()["counts"]["fresh"] < 3:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        grid = random_scenario_grid(1_000, seed=7)
        msg = {"op": "sweep",
               "cpu_request_milli": grid.cpu_request_milli.tolist(),
               "mem_request_bytes": grid.mem_request_bytes.tolist(),
               "replicas": grid.replicas.tolist()}
        want = {}
        for name, leader in leaders.items():
            before = ff.LAUNCHES
            reply = leader.dispatch(dict(msg))
            assert ff.LAUNCHES - before == 1
            assert reply["kernel"] == "cuda_i32_rcp_fused"
            want[name] = reply["totals"]
        got = fed.dispatch({"op": "fed_sweep", **{
            k: v for k, v in msg.items() if k != "op"}})
        assert got["per_cluster"] == want
        assert got["totals"] == [sum(t) for t in zip(*want.values())]
        assert got["excluded"] == [] and got["degraded"] is False
    finally:
        fed.close()
        for name in leaders:
            pubs[name].close()
            leaders[name].shutdown()


def test_doctor_probe_names_the_card(cuda):
    from kubernetesclustercapacity_tpu_torch.utils import doctor

    res = doctor._probe_backend(120.0, device="cuda")
    name = torch.cuda.get_device_name(0)
    assert res.startswith("ok: ")
    assert res.endswith(f"s {name} x{torch.cuda.device_count()}")
    out, rc = doctor.run_doctor(backend_timeout_s=120.0, device="cuda")
    assert rc == 0, out
    assert f"{name} x" in out


# ---------------------------------------------------------------------------
# The native backend and the sharded sweeps against the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["reference", "strict"])
def test_native_sweep_equals_b1_on_the_card(cuda, mode):
    """The host's compiled loop and kernel B1 on the card give the same
    totals at 10,000 × 1,000 (strict with a taint-style lane mask)."""
    from kubernetesclustercapacity_tpu_torch import native

    snap = synthetic_snapshot(10_000, seed=1)
    grid = random_scenario_grid(1_000, seed=7)
    mask = None
    healthy = None
    if mode == "strict":
        mask = np.arange(snap.n_nodes) % 11 != 5
        healthy = snap.healthy & mask
    before = ff.LAUNCHES
    totals, _, name = sweep_snapshot_auto(snap, grid, mode=mode,
                                          node_mask=mask)
    assert name.startswith("cuda_") and ff.LAUNCHES == before + 1
    got = native.sweep(
        snap.alloc_cpu_milli, snap.alloc_mem_bytes, snap.alloc_pods,
        snap.used_cpu_req_milli, snap.used_mem_req_bytes, snap.pods_count,
        grid.cpu_request_milli, grid.mem_request_bytes, mode=mode,
        healthy=healthy)
    np.testing.assert_array_equal(got, totals)


@pytest.mark.parametrize("fn,sp,np_", [("shard_map", 1, 8),
                                        ("gspmd", 2, 4),
                                        ("shard_map", 4, 2)])
def test_sharded_sweeps_on_one_card_equal_the_single_sweep(cuda, fn, sp,
                                                           np_):
    from kubernetesclustercapacity_tpu_torch.ops.fit import (
        snapshot_device_arrays,
        sweep_snapshot,
    )
    from kubernetesclustercapacity_tpu_torch.parallel import (
        make_mesh,
        sweep_gspmd,
        sweep_shard_map,
    )

    snap = synthetic_snapshot(100_003, seed=31)
    grid = random_scenario_grid(64, seed=32)
    plan = make_mesh(sp, np_, devices=[torch.device("cuda", 0)] * 8)
    f = sweep_shard_map if fn == "shard_map" else sweep_gspmd
    totals, sched = f(plan, snapshot_device_arrays(snap), grid.cpu_request_milli,
                      grid.mem_request_bytes, grid.replicas)
    want = sweep_snapshot(snap, grid)
    np.testing.assert_array_equal(totals, want[0])
    np.testing.assert_array_equal(sched, want[1])


# ---------------------------------------------------------------------------
# The sanitizer around a folded sweep on the card, and the static host-sync
# claim checked at run time.


def test_folded_sweeps_under_the_sanitizer_on_the_card(cuda, monkeypatch):
    """A strict server on the card with the sanitizer installed: 8 clients
    x 5 folded sweeps each equal the solo sweep, B1 launches, and the
    sanitizer sees no race and no lock-order cycle."""
    import os
    import threading

    from kubernetesclustercapacity_tpu_torch.analysis import hammer, sanitize
    from kubernetesclustercapacity_tpu_torch.analysis.engine import Baseline
    from kubernetesclustercapacity_tpu_torch.service import (
        CapacityClient,
        CapacityServer,
    )

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    snap = snapshot_from_fixture(
        synthetic_fixture(2_000, seed=3, taint_frac=0.1), semantics="strict")
    monkeypatch.setenv(sanitize.ENV_SWITCH, "1")
    sanitize.install(seed=0, classes=hammer.instrument_targets())
    try:
        server = CapacityServer(snap, device="cuda", batch_window_ms=5.0,
                                batch_max=8, max_inflight=16)
        server.start()
        try:
            with CapacityClient(*server.address, timeout_s=120,
                                retry=None) as c:
                solo = c.sweep(random={"n": 256, "seed": 7})["totals"]
            got, errors = [], []

            def client():
                try:
                    with CapacityClient(*server.address, timeout_s=120,
                                        retry=None) as c:
                        for _ in range(5):
                            got.append(c.sweep(
                                random={"n": 256, "seed": 7})["totals"])
                except Exception as e:  # noqa: BLE001 - asserted below
                    errors.append(e)

            ff.LAUNCHES = 0
            threads = [threading.Thread(target=client) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            launches = ff.LAUNCHES
        finally:
            server.shutdown()
        found = sanitize.findings(repo_root=repo)
        stats = sanitize.stats()
    finally:
        sanitize.uninstall()
    assert not errors and len(got) == 40
    assert all(t == solo for t in got)
    assert 1 <= launches <= 40
    part = sanitize.partition(
        found, Baseline.load(os.path.join(repo, "LINT_BASELINE_TORCH.json")),
        repo)
    assert part.clean, [f.render() for f in part.findings]
    assert stats["field_events"] > 0


def _count_syncs(fn) -> int:
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchronizing" in str(w.message) for w in caught)


@pytest.mark.parametrize("program", ["place_replicas", "_pdhg_chunk",
                                     "_gangs_spread"])
def test_device_loops_do_not_sync_once_per_step(cuda, program):
    """What ``torch.cuda.set_sync_debug_mode("warn")`` flags around a
    device loop does not grow with its step count — device-purity's
    ``host-sync`` claim, at run time."""
    from kubernetesclustercapacity_tpu_torch.ops import placement as pl
    from kubernetesclustercapacity_tpu_torch.optimize import lp
    from kubernetesclustercapacity_tpu_torch.topology import gang

    rng = np.random.default_rng(5)
    if program == "place_replicas":
        snap = snapshot_from_fixture(_sched_fixture(2_000, 3),
                                     semantics="strict")
        cols = (snap.alloc_cpu_milli, snap.alloc_mem_bytes, snap.alloc_pods,
                snap.used_cpu_req_milli, snap.used_mem_req_bytes,
                snap.pods_count, snap.healthy)

        def run(steps):
            return lambda: pl.place_replicas(
                *cols, 500, 512 << 20, n_replicas=steps, policy="best-fit",
                device="cuda")

        small, large = 16, 128
    elif program == "_pdhg_chunk":
        s, g = 8, 64
        caps = rng.random((s, g, 3)) * 1000
        demand = rng.integers(1, 10**5, s).astype(np.float64)
        state = [torch.from_numpy(a).to(cuda) for a in (
            caps, demand, np.maximum(1.0, demand), rng.random((s, g)),
            rng.random((s, g, 3)) * 0.1, rng.random(s))]

        def run(steps):
            return lambda: lp._pdhg_chunk(*state, iters=steps)

        small, large = 10, 100
    else:
        sub = torch.from_numpy(rng.integers(0, 4000, (16, 60))).to(cuda)
        parent = torch.from_numpy(rng.integers(-1, 4, 60)).to(cuda)

        def run(mult):
            return lambda: gang._gangs_spread(sub * mult, parent, 16, 4,
                                              n_co=4)

        small, large = 1, 1 << 20
    for steps in (small, large):
        run(steps)()  # warm
    torch.cuda.synchronize()
    # The least of three interleaved counts each: a wait that happens once
    # in a while (not once per step) cannot decide the comparison.
    counts = {small: [], large: []}
    for _ in range(3):
        for steps in (small, large):
            counts[steps].append(_count_syncs(run(steps)))
    assert min(counts[large]) <= min(counts[small]), counts


def test_b1_and_the_exact_route_each_file_a_first_dispatch_reading(cuda):
    import math

    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import REGISTRY

    snap = synthetic_snapshot(2000, seed=4)
    grid = random_scenario_grid(256, seed=4)
    _, _, b1 = sweep_snapshot_auto(snap, grid, mode=snap.semantics,
                                   device="cuda")
    _, _, exact = sweep_snapshot_auto(snap, grid, mode=snap.semantics,
                                      kernel="exact", device="cuda")
    assert b1 in ("cuda_i32_rcp_fused", "cuda_i32_fused")
    assert exact == "torch_int64"
    # Set by this test or by an earlier first dispatch of the label in
    # this process; either way once, and a finite number of bytes.
    values = REGISTRY.snapshot()[
        "kccap_hostmem_first_dispatch_bytes"]["values"]
    for label in (b1, exact):
        assert math.isfinite(values[f'kernel="{label}"'])
