"""The fused sweep's plain PyTorch version and dispatchers against the JAX
package's Pallas kernel (interpret mode on the CPU).

* ``sweep_fused_plain`` against ``_sweep_pallas_padded`` /
  ``_sweep_pallas_padded_rcp(..., interpret=True)`` on all 16 variants
  (rcp x strict x mask x counts), with Q1-negative nodes and the
  reciprocal-division edge inputs.  Only the JAX side is padded, with the
  JAX package's own padding helpers.
* The eligibility proofs against the JAX package's.
* ``sweep_snapshot_auto(device="cpu")`` against the JAX
  ``sweep_snapshot_auto(interpret=True)``: totals, schedulable and kernel
  labels (``pallas_`` → ``plain_``, ``xla_int64`` → ``torch_int64``).

Tolerance: none — totals are integers, and the one float step (the rcp
estimate) feeds an integer that must be exact.
"""

import gc
import itertools

import numpy as np
import pytest
import torch

from kubernetesclustercapacity_tpu import masks as j_masks
from kubernetesclustercapacity_tpu import snapshot as j_snapshot
from kubernetesclustercapacity_tpu.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu.ops import pallas_fit as jp
from kubernetesclustercapacity_tpu.scenario import random_scenario_grid
from kubernetesclustercapacity_tpu_torch import devcache as t_devcache
from kubernetesclustercapacity_tpu_torch import masks as t_masks
from kubernetesclustercapacity_tpu_torch import scenario as t_scenario
from kubernetesclustercapacity_tpu_torch import snapshot as t_snapshot
from kubernetesclustercapacity_tpu_torch.ops import fused_fit as tf

MIB = 1024 * 1024
VARIANTS = list(itertools.product((False, True), repeat=4))  # rcp, strict, mask, counts
SHAPES = [(1, 1), (2048, 256), (3000, 300)]


def _variant_id(v):
    rcp, strict, mask, counts = v
    return "-".join(
        ("rcp" if rcp else "div", "strict" if strict else "ref",
         "mask" if mask else "nomask", "counts" if counts else "nocounts")
    )


def _kernel_data(n, s, seed):
    """Eligible int32 kernel operands (memory in KiB): Q1-negative nodes
    (pods_count > alloc_pods), nodes with used > alloc, divisors near the
    2^29 bound, a random 0/1 mask and group counts."""
    rng = np.random.default_rng(seed)
    cores = rng.choice(np.array([2, 4, 8, 16, 32, 64]), size=n)
    ac = (cores * 1000).astype(np.int32)
    am = (cores * 4 * 1024 * 1024 - rng.integers(0, 2**18, n)).astype(np.int32)
    cr = rng.integers(50, 4000, s).astype(np.int32)
    mr = (rng.integers(64, 8192, s) * 1024).astype(np.int32)
    if s >= 3:
        cr[-1], mr[-2] = (1 << 29) - 1, (1 << 29) - 3
    return {
        "ac": ac, "am": am,
        "ap": np.full(n, 110, dtype=np.int32),
        "uc": (ac * rng.random(n) * 1.1).astype(np.int32),
        "um": (am * rng.random(n) * 1.1).astype(np.int32),
        "pc": rng.integers(0, 130, n).astype(np.int32),
        "mask": (rng.random(n) < 0.8).astype(np.int32),
        "counts": rng.integers(0, 4, n).astype(np.int32),
        "cr": cr, "mr": mr,
    }


def _edge_data():
    """Dividends on and one off multiples of the divisor at the largest
    eligible quotient (2^20), and the wrapping fixup product (dividend at
    int32 max, divisor at 2^29, est = q + 1)."""
    q, d_cpu, d_mem, n = 1 << 20, 997, 1031, 64
    base = {
        "uc": np.zeros(n, np.int32), "um": np.zeros(n, np.int32),
        "pc": np.zeros(n, np.int32), "ap": np.full(n, 1 << 30, np.int32),
        "mask": np.ones(n, np.int32), "counts": np.ones(n, np.int32),
    }
    boundary = dict(
        base,
        ac=np.array([q * d_cpu, q * d_cpu - 1, q * d_cpu + 1,
                     (q - 1) * d_cpu] * (n // 4), np.int32),
        am=np.array([q * d_mem, q * d_mem - 1, q * d_mem + 1,
                     (q - 1) * d_mem] * (n // 4), np.int32),
        cr=np.array([d_cpu, d_cpu + 1], np.int32),
        mr=np.array([d_mem, d_mem], np.int32),
    )
    wrap = dict(
        base,
        ac=np.full(n, (1 << 31) - 1, np.int32),
        am=np.full(n, 1 << 20, np.int32),
        cr=np.array([1 << 29, (1 << 29) - 1], np.int32),
        mr=np.array([1, 1], np.int32),
    )
    return [boundary, wrap]


def _plain(data, variant):
    rcp, strict, mask, counts = variant
    t = {k: torch.from_numpy(v) for k, v in data.items()}
    crr = mrr = None
    if rcp:
        crr = torch.from_numpy(tf.scenario_reciprocals(data["cr"]))
        mrr = torch.from_numpy(tf.scenario_reciprocals(data["mr"]))
    return tf.sweep_fused_plain(
        t["ac"], t["am"], t["ap"], t["uc"], t["um"], t["pc"], t["cr"],
        t["mr"], crr, mrr, t["mask"] if mask else None,
        t["counts"] if counts else None, strict=strict,
    ).numpy()


def _pallas(data, variant):
    rcp, strict, mask, counts = variant
    n, s = data["ac"].size, data["cr"].size
    n_pad, s_pad = jp.padded_node_shape(n), jp.padded_scenario_shape(s)
    nodes = [jp.pad_node_array(data[k], n_pad)
             for k in ("ac", "am", "ap", "uc", "um", "pc")]
    cr = jp.pad_scenario_array(data["cr"], s_pad)
    mr = jp.pad_scenario_array(data["mr"], s_pad)
    mk = jp.pad_node_array(data["mask"], n_pad) if mask else None
    ct = jp.pad_node_array(data["counts"], n_pad) if counts else None
    if rcp:
        out = jp._sweep_pallas_padded_rcp(
            *nodes, cr, mr, jp.scenario_reciprocals(cr),
            jp.scenario_reciprocals(mr), mk, ct, strict=strict,
            interpret=True,
        )
    else:
        out = jp._sweep_pallas_padded(
            *nodes, cr, mr, mk, ct, strict=strict, interpret=True
        )
    return np.asarray(out)[:s]


@pytest.mark.parametrize("n,s", SHAPES)
@pytest.mark.parametrize("variant", VARIANTS, ids=_variant_id)
def test_plain_matches_pallas_interpret(variant, n, s):
    data = _kernel_data(n, s, seed=n + s)
    np.testing.assert_array_equal(_plain(data, variant), _pallas(data, variant))


@pytest.mark.parametrize("n,s", [(1, 300), (3000, 1)])
@pytest.mark.parametrize(
    "variant", [(True, True, True, True), (False, False, True, False)],
    ids=_variant_id,
)
def test_plain_matches_pallas_interpret_ragged(variant, n, s):
    data = _kernel_data(n, s, seed=7)
    np.testing.assert_array_equal(_plain(data, variant), _pallas(data, variant))


@pytest.mark.parametrize("edge", [0, 1], ids=["quotient-2^20", "wrap-2^29"])
@pytest.mark.parametrize(
    "variant", [v for v in VARIANTS if v[0]], ids=_variant_id
)
def test_rcp_edge_inputs(variant, edge):
    data = _edge_data()[edge]
    got = _plain(data, variant)
    np.testing.assert_array_equal(got, _pallas(data, variant))
    # The reciprocal path agrees with the int32 divide.
    np.testing.assert_array_equal(got, _plain(data, (False, *variant[1:])))


def _eligibility_cases():
    rng = np.random.default_rng(3)
    snap = j_snapshot.synthetic_snapshot(200, seed=1)
    base = [snap.alloc_cpu_milli, snap.alloc_mem_bytes, snap.alloc_pods,
            snap.used_cpu_req_milli, snap.used_mem_req_bytes, snap.pods_count]
    grid = random_scenario_grid(16, seed=2)
    reqs = [grid.cpu_request_milli, grid.mem_request_bytes]
    cases = [("realistic", base, reqs, None)]
    cases.append(("counts", base, reqs, rng.integers(0, 50, 200)))
    cases.append(("counts-overflow", base, reqs,
                  np.full(200, 2**24, np.int64)))
    bad_mem = [a.copy() for a in base]
    bad_mem[1][0] += 1  # not KiB-quantized
    cases.append(("unquantized", bad_mem, reqs, None))
    neg = [a.copy() for a in base]
    neg[3][5] = -1
    cases.append(("negative", neg, reqs, None))
    cases.append(("zero-request", base,
                  [np.array([0, 100]), np.array([MIB, MIB])], None))
    cases.append(("sub-KiB-request", base,
                  [np.array([100]), np.array([512])], None))
    big = [a.copy() for a in base]
    big[0][:] = 2**31 - 1
    cases.append(("total-overflow", big, [np.array([1]), np.array([MIB])],
                  None))
    q = [a.copy() for a in base]
    q[0][0] = (1 << 20) * 3 + 3
    cases.append(("quotient-2^20+1", q, [np.array([3]), np.array([MIB])],
                  None))
    cases.append(("divisor-2^29", base,
                  [np.array([100]), np.array([((1 << 29) + 1024) * 1024])],
                  None))
    cases.append(("empty-grid", base,
                  [np.zeros(0, np.int64), np.zeros(0, np.int64)], None))
    for i in range(4):
        r = np.random.default_rng(100 + i)
        cols = [r.integers(0, 2**31 + 2**28, 50) for _ in range(6)]
        cols[1] = cols[1] * 1024 * r.integers(1, 3, 50) // 2
        cases.append((f"random-{i}", cols,
                      [r.integers(0, 10**4, 8), r.integers(0, 2**33, 8)],
                      None))
    return cases


@pytest.mark.parametrize(
    "case", _eligibility_cases(), ids=lambda c: c[0]
)
def test_eligibility_proofs_match(case):
    _, cols, (cpu, mem), counts = case
    assert tf.fast_sweep_eligible(*cols, cpu, mem, counts=counts) == \
        jp.fast_sweep_eligible(*cols, cpu, mem, counts=counts)
    rcp_args = (cols[0], cols[1], cols[3], cols[4], cpu, mem)
    assert tf.rcp_division_eligible(*rcp_args) == \
        jp.rcp_division_eligible(*rcp_args)
    np.testing.assert_array_equal(
        tf.scenario_reciprocals(np.maximum(cpu, 1)),
        jp.scenario_reciprocals(np.maximum(cpu, 1)),
    )


def _label(name):
    return name.replace("pallas_", "plain_").replace("xla_int64", "torch_int64")


def _pair(jsnap):
    return t_snapshot.ClusterSnapshot.from_columns(
        {f: getattr(jsnap, f) for f in t_snapshot.COLUMNS + ("healthy",)},
        names=list(jsnap.names), semantics=jsnap.semantics,
        taints=jsnap.taints, labels=jsnap.labels,
    )


def _snapshot_cases():
    het = j_snapshot.synthetic_snapshot(3000, seed=5)
    grouped = j_snapshot.synthetic_snapshot(4096, seed=6, shapes=8)
    fx = synthetic_fixture(300, seed=8, taint_frac=0.3, unhealthy_frac=0.2)
    tainted = j_snapshot.snapshot_from_fixture(fx, semantics="strict")
    inel = j_snapshot.synthetic_snapshot(800, seed=9, kib_quantized=False)
    grouped_inel = j_snapshot.synthetic_snapshot(
        2048, seed=10, shapes=6, kib_quantized=False
    )
    mask = np.random.default_rng(4).random(4096) < 0.6
    return [
        ("heterogeneous-ref", het, "reference", None, "pallas_i32_rcp_fused"),
        ("heterogeneous-strict", het, "strict", None, "pallas_i32_rcp_fused"),
        ("grouped-ref", grouped, "reference", None,
         "pallas_i32_rcp_fused_grouped"),
        ("grouped-strict-masked", grouped, "strict", mask,
         "pallas_i32_rcp_fused_grouped"),
        ("tainted-strict", tainted, "strict",
         j_masks.implicit_taint_mask(tainted), "pallas_i32_rcp_fused"),
        ("ineligible", inel, "reference", None, "xla_int64"),
        ("ineligible-grouped", grouped_inel, "strict", None,
         "xla_int64_grouped"),
    ]


@pytest.mark.parametrize("kernel", ["auto", "exact"])
@pytest.mark.parametrize("case", _snapshot_cases(), ids=lambda c: c[0])
def test_sweep_snapshot_auto_matches_jax(case, kernel):
    _, jsnap, mode, mask, expect = case
    grid = random_scenario_grid(64, seed=11)
    tgrid = t_scenario.random_scenario_grid(64, seed=11)
    jt, js, jname = jp.sweep_snapshot_auto(
        jsnap, grid, mode=mode, kernel=kernel, node_mask=mask, interpret=True
    )
    tt, ts, tname = tf.sweep_snapshot_auto(
        _pair(jsnap), tgrid, mode=mode, kernel=kernel, node_mask=mask,
        device="cpu",
    )
    np.testing.assert_array_equal(tt, np.asarray(jt))
    np.testing.assert_array_equal(ts, np.asarray(js))
    assert tt.dtype == np.int64 and ts.dtype == np.bool_
    assert tname == _label(jname)
    if kernel == "auto":
        assert jname == expect


def test_taint_mask_from_port_packing_matches():
    fx = synthetic_fixture(200, seed=12, taint_frac=0.25)
    tsnap = t_snapshot.snapshot_from_fixture(fx, semantics="strict")
    jsnap = j_snapshot.snapshot_from_fixture(fx, semantics="strict")
    grid = random_scenario_grid(32, seed=1)
    jt, _, _ = jp.sweep_snapshot_auto(
        jsnap, grid, mode="strict", node_mask=j_masks.implicit_taint_mask(
            jsnap), interpret=True,
    )
    tt, _, name = tf.sweep_snapshot_auto(
        tsnap, t_scenario.random_scenario_grid(32, seed=1), mode="strict",
        node_mask=t_masks.implicit_taint_mask(tsnap), device="cpu",
    )
    np.testing.assert_array_equal(tt, np.asarray(jt))
    assert name == "plain_i32_rcp_fused"


def test_sweep_snapshot_auto_rejects_bad_arguments():
    snap = t_snapshot.synthetic_snapshot(10, seed=1)
    grid = t_scenario.random_scenario_grid(4, seed=1)
    with pytest.raises(ValueError):
        tf.sweep_snapshot_auto(snap, grid, kernel="fast", device="cpu")
    with pytest.raises(ValueError):
        tf.sweep_snapshot_auto(snap, grid, mode="lenient", device="cpu")
    with pytest.raises(ValueError):
        tf.sweep_snapshot_auto(snap, grid, device="mps")
    bad = t_scenario.ScenarioGrid([0, 5], [MIB, MIB], [1, 1])
    with pytest.raises(t_scenario.ScenarioError):
        tf.sweep_snapshot_auto(snap, bad, device="cpu")


def _operands(n=8, s=3):
    data = _kernel_data(n, s, seed=1)
    t = {k: torch.from_numpy(v) for k, v in data.items()}
    return [t["ac"], t["am"], t["ap"], t["uc"], t["um"], t["pc"],
            t["cr"], t["mr"]]


def test_wrapper_runs_plain_on_cpu_without_counting_a_launch():
    ops = _operands()
    before = tf.LAUNCHES
    got = tf.sweep_fused(*ops)
    assert tf.LAUNCHES == before
    assert torch.equal(got, tf.sweep_fused_plain(*ops))
    assert got.dtype == torch.int64 and got.shape == (3,)


@pytest.mark.parametrize(
    "mutate",
    [
        lambda ops: ops.__setitem__(0, ops[0].to(torch.int64)),
        lambda ops: ops.__setitem__(1, ops[1][:-1]),
        lambda ops: ops.__setitem__(6, ops[6][:-1]),
        lambda ops: ops.__setitem__(2, ops[2].reshape(2, 4)),
        lambda ops: ops.__setitem__(3, torch.zeros(16, dtype=torch.int32)[::2]),
        lambda ops: ops.__setitem__(4, ops[4].to("meta")),
        lambda ops: ops.extend([torch.ones(3), None]),
        lambda ops: ops.extend([None, None, torch.ones(8)]),
    ],
    ids=["dtype", "node-length", "scenario-length", "rank",
         "non-contiguous", "device", "half-reciprocals", "mask-dtype"],
)
def test_wrapper_rejects_bad_operands(mutate):
    ops = _operands()
    mutate(ops)
    with pytest.raises((TypeError, ValueError)):
        tf.sweep_fused(*ops)


@pytest.mark.parametrize(
    "n,s,sms", [(10_000, 1_000, 132), (48, 1_000, 132), (1, 1, 132),
                (10**8, 1, 132), (100_000, 100_000, 132)],
)
def test_node_chunk_grid(n, s, sms):
    chunk = tf.node_chunk(n, s, sms)
    chunks = -(-n // chunk)
    assert chunk >= tf.MIN_NODES_PER_BLOCK and chunks <= 65535
    scenario_blocks = -(-s // tf.SCENARIOS_PER_BLOCK)
    if n >= tf.MIN_NODES_PER_BLOCK * tf.BLOCKS_PER_SM * sms:
        assert chunks * scenario_blocks >= tf.BLOCKS_PER_SM * sms or \
            chunks == 65535


@pytest.mark.parametrize("source", ["sweep_fit.cu", "sweep_multi.cu"])
def test_grid_constants_match_the_kernel_sources(source):
    """node_chunk sizes the grid from the kernels' threads per block and
    scenarios per thread; each source declares the same two numbers."""
    from kubernetesclustercapacity_tpu_torch.ops import _build

    text = (_build.CSRC / source).read_text()
    assert f"constexpr int kThreads = {tf.THREADS_PER_BLOCK};" in text
    assert f"constexpr int kSpt = {tf.SCENARIOS_PER_THREAD};" in text


@pytest.mark.parametrize("mode", ["reference", "strict"])
@pytest.mark.parametrize("shapes", [None, 8], ids=["per-node", "grouped"])
def test_an_int_node_mask_counts_as_its_truth(mode, shapes):
    """The kernel stages a node whose mask is not 0 and the plain version
    multiplies by the mask, so the dispatcher stages ``node_mask`` as 0/1:
    an int mask with values other than 0 and 1 sweeps as ``mask != 0``."""
    snap = t_snapshot.synthetic_snapshot(600, seed=21, shapes=shapes)
    grid = t_scenario.random_scenario_grid(40, seed=22)
    rng = np.random.default_rng(23)
    weights = rng.choice(np.array([0, 1, 2, 7, -3], np.int32), size=600)
    got = tf.sweep_snapshot_auto(snap, grid, mode=mode, node_mask=weights,
                                 device="cpu")
    want = tf.sweep_snapshot_auto(snap, grid, mode=mode,
                                  node_mask=weights != 0, device="cpu")
    assert got[2] == want[2] and got[2].startswith("plain_i32_rcp_fused")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_device_cache_reuses_tensors_and_drops_them_with_the_snapshot():
    cache = t_devcache.DeviceCache()
    cpu = torch.device("cpu")
    snap = t_snapshot.synthetic_snapshot(64, seed=1)
    exact = cache.exact_tensors(snap, cpu)
    assert cache.exact_tensors(snap, cpu) is exact
    assert [t.dtype for t in exact] == [torch.int64] * 6 + [torch.bool]
    kernel = cache.kernel_tensors(snap, cpu)
    assert all(t.dtype == torch.int32 for t in kernel)
    np.testing.assert_array_equal(
        kernel[1].numpy(), snap.alloc_mem_bytes // 1024
    )
    grouped = cache.grouped_kernel_tensors(snap.grouped(), cpu)
    assert grouped[0].shape == (snap.grouped().n_groups,)
    key = id(snap)
    assert set(cache._entries[key]) == {
        ("exact", cpu), ("kernel", cpu), ("grouped_kernel", cpu)
    }
    del snap
    gc.collect()
    assert key not in cache._entries
