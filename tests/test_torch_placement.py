"""The port's placement engines (``ops/placement.py``) against the JAX
package's, both on the CPU, with tolerance 0.

Every engine × policy: the device scans (``place_replicas``,
``place_replicas_spread``, ``place_pods_multi``, ``place_replicas_multi``,
run here with ``device="cpu"``) against the JAX ``lax.scan`` engines, and
the host engines (``*_bulk``, ``*_trace``, ``*_python``) against theirs,
with and without a node mask and ``max_per_node``.  The inputs are seeded
numpy arrays; assignments, per-node and per-zone counts must be equal
element for element.  Edge cases: every node identical (the first-minimum
tie rule), every node infeasible, zero requests, zero request rows, and
scores that meet as ``-0.0`` and ``0.0``.
"""

import numpy as np
import pytest

from kubernetesclustercapacity_tpu.ops import placement as jp
from kubernetesclustercapacity_tpu_torch.ops import placement as tp

GIB = 1 << 30
POLICIES = tp.POLICIES


def _random_cluster(seed, n=24):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(1000, 64000, n),
        rng.integers(1 * GIB, 64 * GIB, n),
        rng.integers(3, 30, n),
        rng.integers(0, 32000, n),
        rng.integers(0, 32 * GIB, n),
        rng.integers(0, 25, n),
        rng.random(n) > 0.1,
    )


def _identical_cluster(n=20):
    """Every node the same: best-fit and spread scores tie on every lane."""
    return (
        np.full(n, 8000), np.full(n, 32 * GIB), np.full(n, 110),
        np.full(n, 1000), np.full(n, 4 * GIB), np.full(n, 10),
        np.ones(n, dtype=bool),
    )


def _exact_cluster(n=12):
    """Headrooms that hit exactly 0 after a placement on half the nodes
    (best-fit score 0.0, spread -0.0) beside nodes with room left."""
    alloc_cpu = np.full(n, 4000)
    alloc_mem = np.full(n, 8 * GIB)
    used_cpu = np.where(np.arange(n) % 2 == 0, 3500, 1000)
    used_mem = np.where(np.arange(n) % 2 == 0, 7 * GIB, 2 * GIB)
    return (alloc_cpu, alloc_mem, np.full(n, 110), used_cpu, used_mem,
            np.zeros(n, dtype=np.int64), np.ones(n, dtype=bool))


CLUSTERS = {
    "random-0": lambda: _random_cluster(0),
    "random-1": lambda: _random_cluster(1),
    "identical": _identical_cluster,
    "exact-zero": _exact_cluster,
}
# (id, cpu request, mem request)
REQUESTS = [("500m-1g", 500, GIB), ("700m-512m", 700, GIB // 2)]


def _mask(n, seed=5):
    return np.random.default_rng(seed).random(n) > 0.25


def _kw(variant, n):
    if variant == "plain":
        return {}
    if variant == "mask-cap":
        return {"node_mask": _mask(n), "max_per_node": 2}
    return {"max_per_node": 0}  # the degenerate cap: nothing places


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


VARIANTS = ["plain", "mask-cap", "cap-0"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("req", REQUESTS, ids=lambda r: r[0])
@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
@pytest.mark.parametrize("policy", POLICIES)
def test_scan_matches_jax(policy, cluster, req, variant):
    c = CLUSTERS[cluster]()
    kw = dict(n_replicas=60, policy=policy, **_kw(variant, len(c[0])))
    j_a, j_c = jp.place_replicas(*c, req[1], req[2], **kw)
    t_a, t_c = tp.place_replicas(*c, req[1], req[2], device="cpu", **kw)
    _eq(t_a, j_a)
    _eq(t_c, j_c)
    py_a, py_c = tp.place_replicas_python(*c, req[1], req[2], **kw)
    _eq(t_a, py_a)
    _eq(t_c, py_c)


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
@pytest.mark.parametrize("policy", POLICIES)
def test_closed_forms_match_jax_and_the_scan(policy, cluster):
    """The trace and bulk engines (host numpy, ported verbatim) equal the
    JAX package's at every replica count up to past the capacity, and
    the trace equals the port's device scan."""
    c = CLUSTERS[cluster]()
    cap = int(jp.place_replicas_bulk(*c, 500, GIB, n_replicas=10**6,
                                     policy=policy)[1])
    for r in sorted({0, 1, 7, cap // 2, cap - 1, cap, cap + 3} - {-1}):
        kw = dict(n_replicas=r, policy=policy)
        j_order, j_counts, j_placed = jp.place_replicas_trace(
            *c, 500, GIB, **kw)
        t_order, t_counts, t_placed = tp.place_replicas_trace(
            *c, 500, GIB, **kw)
        _eq(t_order, j_order)
        _eq(t_counts, j_counts)
        assert t_placed == j_placed == min(r, cap)
        j_bulk = jp.place_replicas_bulk(*c, 500, GIB, **kw)
        t_bulk = tp.place_replicas_bulk(*c, 500, GIB, **kw)
        _eq(t_bulk[0], j_bulk[0])
        assert t_bulk[1] == j_bulk[1]
        scan_order, scan_counts = tp.place_replicas(*c, 500, GIB,
                                                    device="cpu", **kw)
        _eq(scan_order, t_order)
        _eq(scan_counts, t_counts)


@pytest.mark.parametrize("policy", POLICIES)
def test_identical_nodes_take_the_first_minimum(policy):
    """All scores tie: every engine picks the lowest index first, as
    ``jnp.argmin`` and ``torch.argmin`` both document."""
    c = _identical_cluster()
    order, counts = tp.place_replicas(*c, 500, GIB, n_replicas=30,
                                      policy=policy, device="cpu")
    assert order[0] == 0
    _eq(order, jp.place_replicas(*c, 500, GIB, n_replicas=30,
                                 policy=policy)[0])
    if policy == "spread":
        # Round-robin over the tied nodes, index order.
        _eq(order[:20], np.arange(20))


@pytest.mark.parametrize("engine", ["scan", "spread", "pods", "multi"])
@pytest.mark.parametrize("policy", POLICIES)
def test_all_infeasible_places_nothing(policy, engine):
    """No lane is feasible: argmin lands on lane 0 with ``ok`` false, so
    every assignment is -1 and no state changes."""
    c = _random_cluster(3, n=10)
    huge = 10**9
    if engine == "scan":
        got = tp.place_replicas(*c, huge, GIB, n_replicas=5, policy=policy,
                                device="cpu")
        want = jp.place_replicas(*c, huge, GIB, n_replicas=5, policy=policy)
    elif engine == "spread":
        zone = np.arange(10) % 3
        got = tp.place_replicas_spread(*c, huge, GIB, zone, n_replicas=5,
                                       n_zones=3, policy=policy,
                                       device="cpu")
        want = jp.place_replicas_spread(*c, huge, GIB, zone, n_replicas=5,
                                        n_zones=3, policy=policy)
    elif engine == "pods":
        reqs = np.array([[huge] * 4, [GIB] * 4])
        args = (np.stack(c[:2]), np.stack(c[3:5]), c[2], c[5], c[6], reqs)
        got = tp.place_pods_multi(*args, policy=policy, device="cpu")
        want = jp.place_pods_multi(*args, policy=policy)
    else:
        args = (np.stack(c[:2]), np.stack(c[3:5]), c[2], c[5], c[6],
                np.array([huge, GIB]))
        got = tp.place_replicas_multi(*args, n_replicas=5, policy=policy,
                                      device="cpu")
        want = jp.place_replicas_multi(*args, n_replicas=5, policy=policy)
    for g, w in zip(got, want):
        _eq(g, w)
    assert (np.asarray(got[0]) == -1).all()


@pytest.mark.parametrize("max_skew", [1, 2])
@pytest.mark.parametrize("variant", ["plain", "mask-cap"])
@pytest.mark.parametrize("policy", POLICIES)
def test_spread_scan_matches_jax(policy, variant, max_skew):
    c = _random_cluster(4, n=30)
    zone = np.random.default_rng(6).integers(-1, 4, 30)  # -1: no domain
    kw = dict(n_replicas=70, n_zones=4, policy=policy, max_skew=max_skew,
              **_kw(variant, 30))
    got = tp.place_replicas_spread(*c, 700, GIB, zone, device="cpu", **kw)
    want = jp.place_replicas_spread(*c, 700, GIB, zone, **kw)
    for g, w in zip(got, want):
        _eq(g, w)
    assert int(got[2].sum()) == int((got[0] >= 0).sum()) > 0


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("policy", POLICIES)
def test_pods_scan_matches_jax(policy, seed, with_mask):
    """Heterogeneous pods (the drain engine), one request column each;
    some pods request nothing (they take only a slot), one row is all
    zeros.  The JAX scan pads the pod axis to 64; the port loops over the
    real 40."""
    rng = np.random.default_rng(seed)
    c = _random_cluster(seed + 10)
    p = 40
    reqs = np.stack([rng.integers(0, 9000, p), rng.integers(0, 9 * GIB, p),
                     rng.integers(0, 3, p), np.zeros(p, dtype=np.int64)])
    reqs[:, ::9] = 0
    alloc = np.stack([c[0], c[1], rng.integers(0, 9, 24), np.zeros(24)])
    used = np.stack([c[3], c[4], rng.integers(0, 4, 24), np.zeros(24)])
    kw = dict(policy=policy, node_mask=_mask(24) if with_mask else None)
    t_a, t_c = tp.place_pods_multi(alloc, used, c[2], c[5], c[6], reqs,
                                   device="cpu", **kw)
    j_a, j_c = jp.place_pods_multi(alloc, used, c[2], c[5], c[6], reqs, **kw)
    _eq(t_a, j_a)
    _eq(t_c, j_c)
    py_a, py_c = tp.place_pods_multi_python(alloc, used, c[2], c[5], c[6],
                                            reqs, **kw)
    _eq(t_a, py_a)
    _eq(t_c, py_c)
    t2 = tp.place_pods(*c, reqs[0], reqs[1], device="cpu", **kw)
    j2 = jp.place_pods(*c, reqs[0], reqs[1], **kw)
    _eq(t2[0], j2[0])
    _eq(t2[1], j2[1])


def test_pods_scan_takes_no_pods():
    c = _random_cluster(2)
    a, counts = tp.place_pods_multi(np.stack(c[:2]), np.stack(c[3:5]), c[2],
                                    c[5], c[6], np.zeros((2, 0)),
                                    device="cpu")
    assert a.shape == (0,) and counts.tolist() == [0] * 24


# (id, request rows): GPUs, a zero row, every row zero.
MULTI_REQS = [("gpu", [700, GIB, 1]), ("zero-row", [700, GIB, 0]),
              ("all-zero", [0, 0, 0])]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("reqs", MULTI_REQS, ids=lambda r: r[0])
@pytest.mark.parametrize("policy", POLICIES)
def test_multi_scan_matches_jax(policy, reqs, variant):
    rng = np.random.default_rng(8)
    c = _random_cluster(8)
    alloc = np.stack([c[0], c[1], rng.integers(0, 9, 24)])
    used = np.stack([c[3], c[4], rng.integers(0, 4, 24)])
    kw = dict(n_replicas=50, policy=policy, **_kw(variant, 24))
    args = (alloc, used, c[2], c[5], c[6], np.array(reqs[1]))
    t_a, t_c = tp.place_replicas_multi(*args, device="cpu", **kw)
    j_a, j_c = jp.place_replicas_multi(*args, **kw)
    _eq(t_a, j_a)
    _eq(t_c, j_c)
    py_a, py_c = tp.place_replicas_multi_python(*args, **kw)
    _eq(t_a, py_a)
    _eq(t_c, py_c)
    if reqs[0] != "all-zero":
        for r in (1, 13, 50, 400):
            kw["n_replicas"] = r
            j = jp.place_replicas_trace_multi(*args, **kw)
            t = tp.place_replicas_trace_multi(*args, **kw)
            for g, w in zip(t, j):
                _eq(g, w)
            scan = tp.place_replicas_multi(*args, device="cpu", **kw)
            _eq(scan[0], t[0])
            jb = jp.place_replicas_bulk_multi(*args, **kw)
            tb = tp.place_replicas_bulk_multi(*args, **kw)
            _eq(tb[0], jb[0])
            assert tb[1] == jb[1]


@pytest.mark.parametrize("fn", ["place_replicas", "place_replicas_spread",
                                "place_replicas_multi",
                                "place_replicas_bulk"])
def test_bad_arguments_raise_like_jax(fn):
    c = _random_cluster(0, n=4)
    args = {"place_replicas": c + (1, 1),
            "place_replicas_bulk": c + (1, 1),
            "place_replicas_spread": c + (1, 1, np.zeros(4)),
            "place_replicas_multi": (np.stack(c[:2]), np.stack(c[3:5]),
                                     c[2], c[5], c[6], np.array([1, 1]))}[fn]
    kw = {"n_zones": 1} if fn == "place_replicas_spread" else {}
    for bad in ({"policy": "worst-fit", "n_replicas": 1},
                {"policy": "first-fit", "n_replicas": -1}):
        with pytest.raises(ValueError) as j_err:
            getattr(jp, fn)(*args, **bad, **kw)
        with pytest.raises(ValueError) as t_err:
            getattr(tp, fn)(*args, **bad, **kw)
        assert str(t_err.value) == str(j_err.value)
