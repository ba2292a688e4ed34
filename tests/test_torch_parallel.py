"""The port's sharded and multi-process sweeps against the JAX package's,
on the CPU.

The JAX side runs on the 8-device virtual CPU mesh (``tests/conftest.py``);
the port's meshes name the host eight times (``["cpu"] * 8``), so every
cell still sweeps its own shard and the partials reduce for real.  Both
must give the unsharded sweep's integers: shard_map and GSPMD layouts
(1×8, 2×4, 4×2, 8×1, grouped, strict, masked), the mesh checks and the
padding arithmetic, ``scenario_block``, ``initialize`` as a no-op, the
single-process multi-host sweeps, a two-process ``gloo`` run of
``sweep_multihost`` / ``sweep_multihost_multi`` with ``gather`` true and
false (this file is its own worker: ``python tests/test_torch_parallel.py
worker PORT RANK N DEVICE``), and the 1M-node layouts of the JAX
package's ``TestMillionNodeScale``.

Tolerance: none (integers equal).
"""

import json
import sys


def _worker(argv: list[str]) -> int:
    """One rank of the two-process run: torch and the port only.  Prints
    one JSON line of every result for the parent to compare."""
    import numpy as np

    from kubernetesclustercapacity_tpu_torch.fixtures import (
        synthetic_multi_workload,
    )
    from kubernetesclustercapacity_tpu_torch.ops.fit import (
        snapshot_device_arrays,
    )
    from kubernetesclustercapacity_tpu_torch.parallel import multihost
    from kubernetesclustercapacity_tpu_torch.scenario import (
        random_scenario_grid,
    )
    from kubernetesclustercapacity_tpu_torch.snapshot import (
        synthetic_snapshot,
    )

    port, rank, n, device = argv[0], int(argv[1]), int(argv[2]), argv[3]
    assert multihost.initialize(f"127.0.0.1:{port}", n, rank,
                                backend="gloo")
    snap = synthetic_snapshot(97, seed=4)
    # 23 scenarios over 2 processes: blocks of 12, so rank 1 takes the
    # short 11-row tail and the padding/stitch path runs.
    grid = random_scenario_grid(23, seed=5)
    arrays = snapshot_device_arrays(snap, device)
    out = {"block": multihost.scenario_block(grid.size, rank, n)}
    for gather in (True, False):
        t, s = multihost.sweep_multihost(
            arrays, grid.cpu_request_milli, grid.mem_request_bytes,
            grid.replicas, gather=gather, device=device)
        out[f"sweep_{gather}"] = [t.tolist(), s.tolist()]
    alloc_rn, used_rn, reqs_sr, reps = synthetic_multi_workload(
        snap, grid.size, seed=6)
    for gather in (True, False):
        t, s = multihost.sweep_multihost_multi(
            alloc_rn, used_rn, snap.alloc_pods, snap.pods_count,
            snap.healthy, reqs_sr, reps, mode="strict", gather=gather,
            device=device)
        out[f"multi_{gather}"] = [t.tolist(), s.tolist()]
    assert isinstance(t, np.ndarray)
    import torch.distributed as dist

    dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    sys.exit(_worker(sys.argv[2:]))

import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from kubernetesclustercapacity_tpu import parallel as j_par  # noqa: E402
from kubernetesclustercapacity_tpu.fixtures import (  # noqa: E402
    synthetic_multi_workload as j_multi_workload,
)
from kubernetesclustercapacity_tpu.ops.fit import (  # noqa: E402
    snapshot_device_arrays as j_arrays,
    sweep_grid_multi as j_sweep_grid_multi,
    sweep_snapshot as j_sweep_snapshot,
)
from kubernetesclustercapacity_tpu.parallel.sweep import (  # noqa: E402
    sweep_gspmd_grouped as j_sweep_gspmd_grouped,
)
from kubernetesclustercapacity_tpu.scenario import (  # noqa: E402
    random_scenario_grid as j_grid,
)
from kubernetesclustercapacity_tpu.snapshot import (  # noqa: E402
    synthetic_snapshot as j_synthetic,
)
from kubernetesclustercapacity_tpu_torch.fixtures import (  # noqa: E402
    synthetic_multi_workload,
)
from kubernetesclustercapacity_tpu_torch.ops.fit import (  # noqa: E402
    snapshot_device_arrays,
    sweep_grid_multi,
    sweep_snapshot,
)
from kubernetesclustercapacity_tpu_torch.parallel import (  # noqa: E402
    make_mesh,
    multihost,
    sweep_gspmd,
    sweep_shard_map,
)
from kubernetesclustercapacity_tpu_torch.parallel.sweep import (  # noqa: E402
    sweep_gspmd_grouped,
)
from kubernetesclustercapacity_tpu_torch.scenario import (  # noqa: E402
    random_scenario_grid,
)
from kubernetesclustercapacity_tpu_torch.snapshot import (  # noqa: E402
    synthetic_snapshot,
)

HOST8 = ["cpu"] * 8
LAYOUTS = [(8, 1), (4, 2), (2, 4), (1, 8)]


def _arrays(snap):
    return tuple(a.numpy() for a in snapshot_device_arrays(snap, "cpu"))


def _grid_args(grid):
    return grid.cpu_request_milli, grid.mem_request_bytes, grid.replicas


@pytest.fixture(scope="module")
def snap():
    return synthetic_snapshot(503, seed=21)  # prime: forces node padding


@pytest.fixture(scope="module")
def grid():
    return random_scenario_grid(97, seed=22)  # prime: scenario padding


@pytest.fixture(scope="module")
def baseline(snap, grid):
    """The port's unsharded sweep, held equal to the JAX package's."""
    got = sweep_snapshot(snap, grid, device="cpu")
    want = j_sweep_snapshot(j_synthetic(503, seed=21), j_grid(97, seed=22))
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    return got


def _jax_mesh_totals(fn, sp, np_, **kw):
    """The JAX package's sharded sweep of the ``snap`` × ``grid`` inputs."""
    j_snap, jg = j_synthetic(503, seed=21), j_grid(97, seed=22)
    args = tuple(np.asarray(a) for a in j_arrays(j_snap))
    return fn(j_par.make_mesh(sp, np_), args, jg.cpu_request_milli,
              jg.mem_request_bytes, jg.replicas, **kw)


def test_the_jax_side_has_eight_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("sp,np_", LAYOUTS)
def test_shard_map_matches_unsharded_and_jax(snap, grid, baseline, sp, np_):
    totals, sched = sweep_shard_map(make_mesh(sp, np_, devices=HOST8),
                                    _arrays(snap), *_grid_args(grid))
    np.testing.assert_array_equal(totals, baseline[0])
    np.testing.assert_array_equal(sched, baseline[1])
    j_totals, j_sched = _jax_mesh_totals(j_par.sweep_shard_map, sp, np_)
    np.testing.assert_array_equal(totals, j_totals)
    np.testing.assert_array_equal(sched, j_sched)


@pytest.mark.parametrize("sp,np_", [(8, 1), (2, 4), (1, 8)])
@pytest.mark.parametrize("cached", [False, True])
def test_gspmd_matches_unsharded_and_jax(snap, grid, baseline, sp, np_,
                                         cached):
    plan = make_mesh(sp, np_, devices=HOST8)
    kw = {"snapshot": snap} if cached else {}
    totals, sched = sweep_gspmd(plan, _arrays(snap), *_grid_args(grid), **kw)
    np.testing.assert_array_equal(totals, baseline[0])
    np.testing.assert_array_equal(sched, baseline[1])
    j_totals, _ = _jax_mesh_totals(j_par.sweep_gspmd, sp, np_)
    np.testing.assert_array_equal(totals, j_totals)


def test_gspmd_staging_is_cached_per_snapshot_and_mesh(snap):
    from kubernetesclustercapacity_tpu_torch.parallel.sweep import (
        stage_gspmd_arrays,
    )

    plan = make_mesh(2, 4, devices=HOST8)
    first = stage_gspmd_arrays(plan, snap)
    assert stage_gspmd_arrays(plan, snap) is first
    assert stage_gspmd_arrays(make_mesh(4, 2, devices=HOST8), snap) \
        is not first
    # 2 scenario rows × 4 node shards, each cell its own 7 columns of 126
    # rows (503 padded to 504).
    assert len(first) == 2 and all(len(row) == 4 for row in first)
    assert {tuple(c.shape) for row in first for cell in row for c in cell} \
        == {(126,)}


@pytest.mark.parametrize("mode", ["reference", "strict"])
@pytest.mark.parametrize("masked", [False, True])
def test_gspmd_grouped_matches_unsharded_and_jax(mode, masked):
    snap7 = synthetic_snapshot(1000, seed=3, shapes=7)
    grouped = snap7.grouped()
    grid = random_scenario_grid(37, seed=5)
    mask = None
    if masked:
        mask = np.random.default_rng(9).random(1000) > 0.3
    plan = make_mesh(2, 4, devices=HOST8)
    totals, sched = sweep_gspmd_grouped(plan, grouped, *_grid_args(grid),
                                        mode=mode, node_mask=mask)
    want = sweep_snapshot(snap7, grid, mode=mode, node_mask=mask,
                          device="cpu")
    np.testing.assert_array_equal(totals, want[0])
    np.testing.assert_array_equal(sched, want[1])
    j_snap7 = j_synthetic(1000, seed=3, shapes=7)
    jg = j_grid(37, seed=5)
    j_totals, j_sched = j_sweep_gspmd_grouped(
        j_par.make_mesh(2, 4), j_snap7.grouped(), jg.cpu_request_milli,
        jg.mem_request_bytes, jg.replicas, mode=mode, node_mask=mask)
    np.testing.assert_array_equal(totals, j_totals)
    np.testing.assert_array_equal(sched, j_sched)


@pytest.mark.parametrize("fn", ["shard_map", "gspmd"])
def test_strict_mode_sharded(snap, grid, fn):
    plan = make_mesh(4, 2, devices=HOST8)
    f = sweep_shard_map if fn == "shard_map" else sweep_gspmd
    totals, sched = f(plan, _arrays(snap), *_grid_args(grid), mode="strict")
    ref = sweep_snapshot(snap, grid, mode="strict", device="cpu")
    np.testing.assert_array_equal(totals, ref[0])
    np.testing.assert_array_equal(sched, ref[1])
    j_totals, _ = _jax_mesh_totals(
        j_par.sweep_shard_map if fn == "shard_map" else j_par.sweep_gspmd,
        4, 2, mode="strict")
    np.testing.assert_array_equal(totals, j_totals)


def test_tensor_inputs_and_a_mesh_of_mixed_cells(snap, grid, baseline):
    """The node arrays may come as tensors, and one device may hold
    cells of both axes."""
    arrays = snapshot_device_arrays(snap, "cpu")
    plan = make_mesh(2, 2, devices=[torch.device("cpu")] * 4)
    totals, _ = sweep_shard_map(plan, arrays, *_grid_args(grid))
    np.testing.assert_array_equal(totals, baseline[0])


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sp,np_", [(3, 2), (0, 8), (8, 0), (16, 1)])
def test_mesh_validation(sp, np_):
    with pytest.raises(ValueError):
        make_mesh(sp, np_, devices=HOST8)
    with pytest.raises(ValueError):
        j_par.make_mesh(sp, np_)


def test_mesh_padding_math():
    plan, j_plan = make_mesh(4, 2, devices=HOST8), j_par.make_mesh(4, 2)
    for s in (97, 100, 1):
        assert plan.pad_scenarios(s) == j_plan.pad_scenarios(s)
    for n in (503, 504, 1):
        assert plan.pad_nodes(n) == j_plan.pad_nodes(n)
    assert plan.pad_scenarios(97) == 100
    assert plan.pad_nodes(503) == 504 and plan.pad_nodes(504) == 504
    assert (plan.scenario_shards, plan.node_shards) == \
        (j_plan.scenario_shards, j_plan.node_shards)


def test_default_mesh_puts_every_device_on_the_scenario_axis():
    plan = make_mesh(node_parallel=2, devices=HOST8)
    assert (plan.scenario_shards, plan.node_shards) == (4, 2)
    assert plan.first_device == torch.device("cpu")


def test_default_devices_are_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()


# ---------------------------------------------------------------------------
# The multi-process layer, one process
# ---------------------------------------------------------------------------
def test_initialize_is_noop_single_process():
    assert multihost.initialize() is False
    assert multihost.initialize(num_processes=1) is False
    assert multihost.initialize("127.0.0.1:1", 1, 0, backend="gloo") \
        is False
    assert j_par.multihost.initialize() is False


def test_initialize_names_its_backend():
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize("127.0.0.1:1", 2, 0)


@pytest.mark.parametrize("total,pcount", [(97, 4), (8, 8), (5, 8), (1000, 3),
                                          (23, 2), (0, 3)])
def test_scenario_block_partition(total, pcount):
    blocks = [multihost.scenario_block(total, p, pcount)
              for p in range(pcount)]
    assert blocks == [j_par.multihost.scenario_block(total, p, pcount)
                      for p in range(pcount)]
    covered = []
    for start, stop in blocks:
        assert 0 <= start <= stop <= total
        covered.extend(range(start, stop))
    assert covered == list(range(total))  # exact disjoint cover


@pytest.mark.parametrize("gather", [True, False])
@pytest.mark.parametrize("mode", ["reference", "strict"])
def test_sweep_multihost_matches_unsharded(snap, grid, gather, mode):
    totals, sched = multihost.sweep_multihost(
        _arrays(snap), *_grid_args(grid), mode=mode, gather=gather,
        device="cpu")
    want = sweep_snapshot(snap, grid, mode=mode, device="cpu")
    np.testing.assert_array_equal(totals, want[0])
    np.testing.assert_array_equal(sched, want[1])
    j_totals, j_sched = j_par.multihost.sweep_multihost(
        j_arrays(j_synthetic(503, seed=21)), *_grid_args(j_grid(97, seed=22)),
        mode=mode, gather=gather)
    np.testing.assert_array_equal(totals, j_totals)
    np.testing.assert_array_equal(sched, j_sched)


def test_sweep_multihost_multi_matches_unsharded(snap, grid):
    alloc_rn, used_rn, reqs_sr, reps = synthetic_multi_workload(
        snap, grid.size, seed=44)
    j_snap = j_synthetic(503, seed=21)
    j_work = j_multi_workload(j_snap, grid.size, seed=44)
    for a, b in zip((alloc_rn, used_rn, reqs_sr, reps), j_work):
        np.testing.assert_array_equal(a, b)
    node = (snap.alloc_pods, snap.pods_count, snap.healthy)
    totals, sched = multihost.sweep_multihost_multi(
        alloc_rn, used_rn, *node, reqs_sr, reps, mode="strict",
        device="cpu")
    exact = sweep_grid_multi(
        *(torch.from_numpy(np.asarray(a)) for a in (
            alloc_rn, used_rn, snap.alloc_pods, snap.pods_count,
            snap.healthy, reqs_sr, reps)), mode="strict")
    np.testing.assert_array_equal(totals, exact[0].numpy())
    np.testing.assert_array_equal(sched, exact[1].numpy())
    j_exact = j_sweep_grid_multi(*j_work[:2], j_snap.alloc_pods,
                                 j_snap.pods_count, j_snap.healthy,
                                 *j_work[2:], mode="strict")
    np.testing.assert_array_equal(totals, np.asarray(j_exact[0]))


# ---------------------------------------------------------------------------
# Two processes over gloo
# ---------------------------------------------------------------------------
def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def two_process_run():
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=repo_root)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "worker", str(port),
             str(rank), "2", "cpu"],
            env=env, cwd=repo_root, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )
        for rank in range(2)
    ]
    try:
        results = [p.communicate(timeout=120) for p in procs]
    except subprocess.TimeoutExpired:
        # One rank wedged (its peer died before the rendezvous): kill both
        # and show what they wrote.
        for p in procs:
            p.kill()
        results = [p.communicate() for p in procs]
        raise AssertionError("multihost worker timed out; stderr:\n"
                             + "\n---\n".join(e for _, e in results))
    for rank, (p, (out, err)) in enumerate(zip(procs, results)):
        assert p.returncode == 0, f"rank {rank} failed:\n{err}"
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in results]


@pytest.fixture(scope="module")
def two_process_want():
    """Single-process answers to the workers' inputs, from both packages."""
    snap, grid = synthetic_snapshot(97, seed=4), random_scenario_grid(23,
                                                                      seed=5)
    single = sweep_snapshot(snap, grid, device="cpu")
    j_snap, jg = j_synthetic(97, seed=4), j_grid(23, seed=5)
    j_single = j_sweep_snapshot(j_snap, jg)
    np.testing.assert_array_equal(single[0], np.asarray(j_single[0]))
    alloc_rn, used_rn, reqs_sr, reps = j_multi_workload(j_snap, 23, seed=6)
    j_multi = j_sweep_grid_multi(alloc_rn, used_rn, j_snap.alloc_pods,
                                 j_snap.pods_count, j_snap.healthy, reqs_sr,
                                 reps, mode="strict")
    return {"sweep": [np.asarray(a).tolist() for a in single],
            "multi": [np.asarray(a).tolist() for a in j_multi]}


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("what", ["sweep", "multi"])
def test_two_process_gather_matches_single_process(two_process_run,
                                                   two_process_want, rank,
                                                   what):
    got = two_process_run[rank][f"{what}_True"]
    assert got == two_process_want[what]


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("what", ["sweep", "multi"])
def test_two_process_blocks_without_gather(two_process_run, two_process_want,
                                           rank, what):
    b0, b1 = two_process_run[rank]["block"]
    assert (b0, b1) == ((0, 12), (12, 23))[rank]
    want = [col[b0:b1] for col in two_process_want[what]]
    assert two_process_run[rank][f"{what}_False"] == want


# ---------------------------------------------------------------------------
# A million nodes (the JAX package's TestMillionNodeScale)
# ---------------------------------------------------------------------------
class TestMillionNodeScale:
    @pytest.fixture(scope="class")
    def snap1m(self):
        return synthetic_snapshot(1_000_003, seed=31)  # prime: pads nodes

    @pytest.fixture(scope="class")
    def grid1m(self):
        return random_scenario_grid(8, seed=32)

    @pytest.fixture(scope="class")
    def baseline1m(self, snap1m, grid1m):
        got = sweep_snapshot(snap1m, grid1m, device="cpu")
        want = j_sweep_snapshot(j_synthetic(1_000_003, seed=31),
                                j_grid(8, seed=32))
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        return got

    def test_shard_map_node_axis_1m(self, snap1m, grid1m, baseline1m):
        totals, sched = sweep_shard_map(make_mesh(1, 8, devices=HOST8),
                                        _arrays(snap1m), *_grid_args(grid1m))
        np.testing.assert_array_equal(totals, baseline1m[0])
        np.testing.assert_array_equal(sched, baseline1m[1])

    def test_gspmd_node_axis_1m(self, snap1m, grid1m, baseline1m):
        totals, sched = sweep_gspmd(make_mesh(2, 4, devices=HOST8),
                                    _arrays(snap1m), *_grid_args(grid1m))
        np.testing.assert_array_equal(totals, baseline1m[0])
        np.testing.assert_array_equal(sched, baseline1m[1])
