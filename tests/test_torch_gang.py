"""The port's gang capacity against ``kubernetesclustercapacity_tpu.
topology``, on the CPU.

* the topology model: codes, domains, missing-label counts, ``parent_map``
  and ``host_singleton`` of both packages on labelled fixtures, attached
  synthetic fleets, unlabelled snapshots and both missing-label policies,
  and ``attach_topology``'s rejections;
* ``synthetic_snapshot``/``synthetic_fixture(topology=)``: the same seed
  draws the same columns, codes and labels in both packages;
* ``GangSpec`` and the wire/file grammar: every case of the JAX package's
  validation tests through both, with equal error text;
* each device program against its JAX twin on seeded numpy inputs
  (negative fits, fits above the 2^40 clamp, products that wrap int64,
  empty domains, code -1);
* ``gang_capacity`` over the JAX tests' parity matrix (both modes, grouped
  and per-node engines, ``KCCAP_GANG_GROUPED=0``, colocation, spread and
  anti-affinity, node masks, the ``own`` and ``exclude`` policies, shared
  host domains) with every ``GangResult`` field compared, and
  ``gang_explain``'s dicts.

Tolerance: none.  Every compared value is an integer, a name or a string.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from kubernetesclustercapacity_tpu import fixtures as j_fixtures
from kubernetesclustercapacity_tpu import scenario as j_scenario
from kubernetesclustercapacity_tpu import snapshot as j_snapshot
from kubernetesclustercapacity_tpu import topology as j_topo
from kubernetesclustercapacity_tpu.ops.fit import sweep_grid as j_sweep_grid
from kubernetesclustercapacity_tpu.topology import gang as j_gang
from kubernetesclustercapacity_tpu_torch import fixtures as t_fixtures
from kubernetesclustercapacity_tpu_torch import scenario as t_scenario
from kubernetesclustercapacity_tpu_torch import snapshot as t_snapshot
from kubernetesclustercapacity_tpu_torch import topology as t_topo
from kubernetesclustercapacity_tpu_torch.topology import gang as t_gang

class Pkg:
    """One package's modules under the same names."""

    def __init__(self, fixtures, scenario, snapshot, topo, gang):
        self.fixtures = fixtures
        self.scenario = scenario
        self.snapshot = snapshot
        self.topo = topo
        self.gang = gang


JAX = Pkg(j_fixtures, j_scenario, j_snapshot, j_topo, j_gang)
TORCH = Pkg(t_fixtures, t_scenario, t_snapshot, t_topo, t_gang)


def _capacity(pkg, *args, **kw):
    if pkg is TORCH:
        kw["device"] = "cpu"
    return pkg.gang.gang_capacity(*args, **kw)


def _explain(pkg, *args, **kw):
    if pkg is TORCH:
        kw["device"] = "cpu"
    return pkg.gang.gang_explain(*args, **kw)


# --- the topology model -------------------------------------------------

LEVELS = ("host", "rack", "zone")


def _topology_fields(topo):
    return {
        "keys": dataclasses.astuple(topo.keys),
        "missing": topo.missing,
        "codes": {lvl: topo.codes(lvl).tolist() for lvl in LEVELS},
        "domains": {lvl: topo.domains(lvl) for lvl in LEVELS},
        "missing_labels": topo.missing_labels,
        "host_singleton": topo.host_singleton,
        "parents": {
            (sub, par): topo.parent_map(sub, par).tolist()
            for sub, par in (("host", "rack"), ("host", "zone"),
                             ("rack", "zone"))
        },
    }


def _fixture_snapshots(make_fixture, semantics="strict"):
    fx = make_fixture()
    return (j_snapshot.snapshot_from_fixture(fx, semantics=semantics),
            t_snapshot.snapshot_from_fixture(fx, semantics=semantics))


def _unlabel_racks(fx, k):
    for node in fx["nodes"][:k]:
        del node["labels"]["topology.kubernetes.io/rack"]
    return fx


def _share_hosts(fx):
    for i, node in enumerate(fx["nodes"]):
        node["labels"]["kubernetes.io/hostname"] = f"shared-{i % 7}"
    return fx


TOPOLOGY_SOURCES = {
    "fixture-3x2": lambda: _fixture_snapshots(
        lambda: j_fixtures.synthetic_fixture(60, seed=1, topology=(3, 2))),
    "fixture-no-topology": lambda: _fixture_snapshots(
        lambda: j_fixtures.synthetic_fixture(20, seed=2)),
    "fixture-reference": lambda: _fixture_snapshots(
        lambda: j_fixtures.synthetic_fixture(40, seed=3, topology=(2, 2)),
        "reference"),
    "fixture-unlabelled-racks": lambda: _fixture_snapshots(
        lambda: _unlabel_racks(
            j_fixtures.synthetic_fixture(30, seed=6, topology=(2, 2)), 10)),
    "fixture-shared-hosts": lambda: _fixture_snapshots(
        lambda: _share_hosts(
            j_fixtures.synthetic_fixture(50, seed=4, topology=(2, 2)))),
    "synthetic-attached": lambda: (
        j_snapshot.synthetic_snapshot(64, seed=3, topology=(2, 4)),
        t_snapshot.synthetic_snapshot(64, seed=3, topology=(2, 4))),
    "synthetic-unlabelled": lambda: (
        j_snapshot.synthetic_snapshot(6, seed=0),
        t_snapshot.synthetic_snapshot(6, seed=0)),
}


@pytest.mark.parametrize("missing", ["own", "exclude"])
@pytest.mark.parametrize("source", sorted(TOPOLOGY_SOURCES))
def test_topology_model_matches_jax(source, missing):
    # An attached hierarchy is memoized under the "own" key only: with
    # "exclude" both packages parse the (absent) labels instead.
    j_snap, t_snap = TOPOLOGY_SOURCES[source]()
    j = j_topo.topology_from_snapshot(j_snap, missing=missing)
    t = t_topo.topology_from_snapshot(t_snap, missing=missing)
    assert _topology_fields(t) == _topology_fields(j)
    assert t_topo.topology_from_snapshot(t_snap, missing=missing) is t


def test_topology_keys_are_configurable_like_jax():
    fx = j_fixtures.synthetic_fixture(24, seed=5, topology=(2, 3))
    keys = {"zone": "zone", "rack": "pool", "host": "kubernetes.io/hostname"}
    j_snap = j_snapshot.snapshot_from_fixture(fx, semantics="strict")
    t_snap = t_snapshot.snapshot_from_fixture(fx, semantics="strict")
    j = j_topo.topology_from_snapshot(j_snap, keys=j_topo.TopologyKeys(**keys))
    t = t_topo.topology_from_snapshot(t_snap, keys=t_topo.TopologyKeys(**keys))
    assert _topology_fields(t) == _topology_fields(j)
    assert len(t.zone_domains) == 3 and len(t.rack_domains) == 6


@pytest.mark.parametrize(
    "zone,rack",
    [([0, 1, 0, 1], [0, 0, 1, 1]),  # a rack spans two zones
     ([0, -1, 0, 0], [0, 0, 1, 1]),  # negative code
     ([0, 0, 0], [0, 0, 1, 1])],  # wrong shape
    ids=["not-nested", "negative", "shape"],
)
def test_attach_topology_rejections_match_jax(zone, rack):
    errors = []
    for pkg in (JAX, TORCH):
        snap = pkg.snapshot.synthetic_snapshot(4, seed=0)
        with pytest.raises(ValueError) as info:
            pkg.topo.attach_topology(snap, zone_code=zone, rack_code=rack)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_missing_policy_and_level_rejections_match_jax():
    for call in (
        lambda p, s: p.topo.topology_from_snapshot(s, missing="guess"),
        lambda p, s: p.topo.topology_from_snapshot(s).codes("pod"),
        lambda p, s: p.topo.topology_from_snapshot(s).parent_map(
            "zone", "rack"),
    ):
        errors = []
        for pkg in (JAX, TORCH):
            snap = pkg.snapshot.synthetic_snapshot(4, seed=0)
            with pytest.raises(ValueError) as info:
                call(pkg, snap)
            errors.append(str(info.value))
        assert errors[0] == errors[1]


@pytest.mark.parametrize("kw", [
    dict(n_nodes=300, seed=5, topology=(3, 4)),
    dict(n_nodes=2048, seed=7, shapes=24, topology=(4, 4)),
    dict(n_nodes=97, seed=1, topology=(1, 1)),
    dict(n_nodes=50, seed=2, kib_quantized=False, topology=(5, 2)),
])
def test_synthetic_snapshot_topology_matches_jax(kw):
    n = kw.pop("n_nodes")
    j = j_snapshot.synthetic_snapshot(n, **kw)
    t = t_snapshot.synthetic_snapshot(n, **kw)
    for f in dataclasses.fields(t):
        assert np.array_equal(np.asarray(getattr(t, f.name), dtype=object),
                              np.asarray(getattr(j, f.name), dtype=object)), f
    assert _topology_fields(t_topo.topology_from_snapshot(t)) == \
        _topology_fields(j_topo.topology_from_snapshot(j))


@pytest.mark.parametrize("kw", [
    dict(n_nodes=90, seed=9, topology=(3, 3)),
    dict(n_nodes=40, seed=4, topology=(2, 5), taint_frac=0.3),
])
def test_synthetic_fixture_topology_matches_jax(kw):
    n = kw.pop("n_nodes")
    j = j_fixtures.synthetic_fixture(n, **kw)
    t = t_fixtures.synthetic_fixture(n, **kw)
    assert json.dumps(t, sort_keys=True) == json.dumps(j, sort_keys=True)
    assert t["nodes"][0]["labels"]["topology.kubernetes.io/rack"] == "r0"


def test_synthetic_topology_rejects_bad_shapes_like_jax():
    for make in (lambda p: p.snapshot.synthetic_snapshot(4, topology=(0, 2)),
                 lambda p: p.fixtures.synthetic_fixture(4, topology=(2, 0))):
        errors = []
        for pkg in (JAX, TORCH):
            with pytest.raises(ValueError) as info:
                make(pkg)
            errors.append(str(info.value))
        assert errors[0] == errors[1]


# --- GangSpec and the grammar -------------------------------------------

SPEC_CASES = [
    dict(ranks=8, max_ranks_per_domain=2),
    dict(ranks=8, spread_level="host"),
    dict(ranks=8, colocate="rack", spread_level="rack",
         max_ranks_per_domain=2),
    dict(ranks=8, colocate="rack", spread_level="zone",
         max_ranks_per_domain=2),
    dict(ranks=8, anti_affinity_host=True, spread_level="host",
         max_ranks_per_domain=2),
    dict(ranks=8, anti_affinity_host=True, colocate="host"),
    dict(ranks=0),
    dict(ranks=True),
    dict(ranks=4, count=-1),
    dict(ranks=4, count=1.5),
    dict(ranks=4, colocate="pod"),
    dict(ranks=4, spread_level="host", max_ranks_per_domain=0),
    dict(ranks=4, spread_level="host", max_ranks_per_domain=True),
    dict(ranks=4, anti_affinity_host="yes"),
    dict(ranks=4, spread_level="host", max_ranks_per_domain=100),
    dict(ranks=64, colocate="zone", spread_level="rack",
         max_ranks_per_domain=16, count=3),
    dict(ranks=16, colocate="rack", anti_affinity_host=True),
]


def _spec_outcome(pkg, kw):
    try:
        spec = pkg.gang.GangSpec(**kw)
    except pkg.gang.GangSpecError as e:
        return ("error", str(e))
    return ("ok", spec.to_wire(), spec.effective_spread())


@pytest.mark.parametrize("kw", SPEC_CASES, ids=[str(i) for i in range(
    len(SPEC_CASES))])
def test_gang_spec_validation_matches_jax(kw):
    assert _spec_outcome(TORCH, kw) == _spec_outcome(JAX, kw)


BLOCKS = [
    {"ranks": 4, "colocate": "rack"},
    {"ranks": 4, "colour": "red"},
    {"count": 2},
    [4],
    {"ranks": 8, "spread_level": "host", "max_ranks_per_domain": 2,
     "count": 3},
]
MSGS = [
    {"ranks": "8", "count": "2", "colocate": "zone"},
    {"ranks": "eight"},
    {"ranks": 8, "max_ranks_per_domain": "x", "spread_level": "host"},
    {"ranks": 4, "anti_affinity_host": 1},
    {"ranks": None},
]


def _grammar_outcome(pkg, fn, arg):
    try:
        return ("ok", getattr(pkg.gang, fn)(arg).to_wire())
    except pkg.gang.GangSpecError as e:
        return ("error", str(e))


@pytest.mark.parametrize("fn,arg", [("parse_gang_block", b) for b in BLOCKS]
                         + [("gang_spec_from_msg", m) for m in MSGS])
def test_gang_grammar_matches_jax(fn, arg):
    assert _grammar_outcome(TORCH, fn, arg) == _grammar_outcome(JAX, fn, arg)


GANG_FILES = {
    "ok": {"pod": {"cpuRequests": "500m", "memRequests": "1gb"},
           "gang": {"ranks": 8, "colocate": "rack"}},
    "no-gang": {"pod": {"cpuRequests": "500m"}},
    "extra": {"pod": {}, "gang": {"ranks": 2}, "watch": 1},
    "bad-pod": {"pod": {"cpuRequests": "lots"}, "gang": {"ranks": 2}},
    "pod-not-mapping": {"pod": [1], "gang": {"ranks": 2}},
    "not-mapping": [1, 2],
}


@pytest.mark.parametrize("name", sorted(GANG_FILES) + ["unparseable"])
def test_load_gang_spec_matches_jax(name, tmp_path):
    path = tmp_path / "gang.yaml"
    path.write_text("{ranks: [" if name == "unparseable"
                    else json.dumps(GANG_FILES[name]))
    outcomes = []
    for pkg in (JAX, TORCH):
        try:
            scenario, spec = pkg.gang.load_gang_spec(str(path))
            outcomes.append(("ok", dataclasses.astuple(scenario),
                             spec.to_wire()))
        except pkg.gang.GangSpecError as e:
            outcomes.append(("error", str(e)))
    assert outcomes[1] == outcomes[0]
    assert outcomes[0][0] == ("ok" if name == "ok" else "error")


# --- the device programs against their JAX twins ------------------------


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))


def _fits(rng, s, n):
    """Seeded fits with negatives, zeros, values above the 2^40 clamp and
    near the int64 edge (reference-mode carriers)."""
    fits = rng.integers(-50, 400, size=(s, n))
    big = rng.random((s, n)) < 0.05
    fits[big] = rng.integers(1 << 40, 1 << 45, size=int(big.sum()))
    huge = rng.random((s, n)) < 0.01
    fits[huge] = rng.integers((1 << 62), (1 << 63) - 1, size=int(huge.sum()))
    return fits.astype(np.int64)


def _codes(rng, n, d, excluded=0.1):
    codes = rng.integers(0, d, size=n)
    codes[rng.random(n) < excluded] = -1
    return codes.astype(np.int64)


@pytest.mark.parametrize("seed", range(4))
def test_domain_caps_matches_jax(seed):
    rng = np.random.default_rng(seed)
    s, n, d = 5, 300, 12
    fits = _fits(rng, s, n)
    codes = _codes(rng, n, d - 2)  # the last two domains stay empty
    want = np.asarray(j_gang._domain_caps(fits, codes, n_domains=d))
    got = t_gang._domain_caps(_t(fits), _t(codes), n_domains=d).numpy()
    assert np.array_equal(got, want)
    assert (got[:, -2:] == 0).all() and (got == t_gang.CAP_MAX).any()


@pytest.mark.parametrize("seed", range(4))
def test_grouped_caps_matches_jax_including_wraps(seed):
    rng = np.random.default_rng(seed)
    s, g, d = 6, 40, 9
    fits = _fits(rng, s, g)
    cnt = rng.integers(0, 5000, size=(g, d)).astype(np.int64)
    cnt[:, 3] = 0  # an empty domain
    want = np.asarray(j_gang._grouped_caps(fits, cnt))
    got = t_gang._grouped_caps(_t(fits), _t(cnt)).numpy()
    assert np.array_equal(got, want)
    with np.errstate(over="ignore"):
        exact = [[sum(int(fits[i, k]) * int(cnt[k, j]) for k in range(g))
                  for j in range(d)] for i in range(s)]
    wrapped = any(not -(1 << 63) <= v < (1 << 63) for row in exact
                  for v in row)
    assert wrapped or seed, "seed 0 must wrap the int64 product"


def test_grouped_product_chunks_over_scenarios(monkeypatch):
    rng = np.random.default_rng(9)
    fits = _fits(rng, 17, 30)
    cnt = rng.integers(0, 50, size=(30, 7)).astype(np.int64)
    whole = t_gang._grouped_caps(_t(fits), _t(cnt)).numpy()
    monkeypatch.setattr(t_gang, "_PRODUCT_BLOCK", 30 * 7 * 2)
    assert np.array_equal(t_gang._grouped_caps(_t(fits), _t(cnt)).numpy(),
                          whole)
    assert np.array_equal(whole, np.asarray(j_gang._grouped_caps(fits, cnt)))


@pytest.mark.parametrize("ranks", [1, 3, 64, 10**6])
def test_colocated_programs_match_jax(ranks):
    rng = np.random.default_rng(ranks)
    caps = np.clip(_fits(rng, 4, 20), 0, t_gang.CAP_MAX)
    fits = _fits(rng, 4, 15)
    cnt = rng.integers(0, 300, size=15).astype(np.int64)
    assert np.array_equal(
        t_gang._gangs_colocated(_t(caps), ranks).numpy(),
        np.asarray(j_gang._gangs_colocated(caps, ranks)))
    assert np.array_equal(
        t_gang._gangs_colocated_per_group(_t(fits), _t(cnt), ranks).numpy(),
        np.asarray(j_gang._gangs_colocated_per_group(fits, cnt, ranks)))


@pytest.mark.parametrize("ranks,k", [(3, 2), (17, 5), (64, 16), (8, 1),
                                     (4, 4)])
def test_spread_search_matches_jax(ranks, k):
    rng = np.random.default_rng(ranks * 31 + k)
    s, d_sub, n_co = 6, 40, 5
    caps = np.clip(_fits(rng, s, d_sub), 0, t_gang.CAP_MAX)
    caps[:, :4] = rng.integers(0, 3 * k, size=(s, 4))  # binding small subs
    parent = rng.integers(0, n_co - 1, size=d_sub).astype(np.int64)
    parent[rng.random(d_sub) < 0.15] = -1  # excluded sub-domains
    want = np.asarray(j_gang._gangs_spread(caps, parent, ranks, k,
                                           n_co=n_co))
    got = t_gang._gangs_spread(_t(caps), _t(parent), ranks, k,
                               n_co=n_co).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("ranks,k", [(3, 1), (16, 1), (50, 2), (25, 25)])
def test_spread_per_group_search_matches_jax(ranks, k, monkeypatch):
    rng = np.random.default_rng(ranks + 100 * k)
    s, g, d = 5, 24, 6
    fits = _fits(rng, s, g)
    fits[:, :3] = -4
    cnt = rng.integers(0, 40, size=(g, d)).astype(np.int64)
    cnt[:, 2] = 0
    want = np.asarray(j_gang._gangs_spread_per_group(fits, cnt, ranks, k))
    got = t_gang._gangs_spread_per_group(_t(fits), _t(cnt), ranks,
                                         k).numpy()
    assert np.array_equal(got, want)
    monkeypatch.setattr(t_gang, "_PRODUCT_BLOCK", g * d)  # one row a chunk
    assert np.array_equal(t_gang._gangs_spread_per_group(
        _t(fits), _t(cnt), ranks, k).numpy(), want)


def test_search_step_count_settles_every_interval():
    """The fixed step count (bit_length + 1 of the largest bound) answers
    what a loop until convergence answers, at the bounds' edges."""
    for hi in (0, 1, 2, 3, 7, 8, 255, 256, (1 << 40) - 1, 1 << 40):
        for target in {0, hi // 3, hi // 2, max(hi - 1, 0), hi}:
            hi0 = torch.tensor([[hi]])
            got = t_gang._bisect(
                hi0, lambda mid, t=target: torch.where(mid <= t, mid, -1),
                1)
            assert int(got) == target, (hi, target)


def test_search_of_no_cells_takes_no_step():
    assert t_gang._search_steps(torch.zeros((0, 3), dtype=torch.int64)) == 0


# --- gang_capacity: the parity matrix -----------------------------------


def _hier(pkg, n=2048, shapes=24, seed=7, unhealthy=0.05):
    snap = pkg.snapshot.synthetic_snapshot(n, seed=seed, shapes=shapes)
    rng = np.random.default_rng(seed + 1)
    healthy = rng.random(n) >= unhealthy
    snap = dataclasses.replace(snap, healthy=healthy)
    rack = rng.integers(0, 16, size=n)
    pkg.topo.attach_topology(snap, rack // 4, rack)
    return snap


SPECS = [
    dict(ranks=17, colocate="rack"),
    dict(ranks=33, colocate="zone"),
    dict(ranks=12, colocate="host"),
    dict(ranks=40, colocate="zone", spread_level="rack",
         max_ranks_per_domain=13),
    dict(ranks=25, anti_affinity_host=True),
    dict(ranks=50, colocate="rack", spread_level="host",
         max_ranks_per_domain=2),
    dict(ranks=9),
]


def _result_fields(res):
    return {
        "spec": res.spec.to_wire(),
        "gangs": res.gangs.tolist(),
        "pod_totals": res.pod_totals.tolist(),
        "largest_cap": np.asarray(res.largest_cap).tolist(),
        "largest_domain": list(res.largest_domain),
        "mode": res.mode,
        "engine": res.engine,
        "excluded_nodes": res.excluded_nodes,
        "co_caps": None if res.co_caps is None else res.co_caps.tolist(),
        "co_domains": res.co_domains,
        "schedulable": res.schedulable.tolist(),
        "wire": res.to_wire(),
    }


def _jax_fits(snap, grid, mode, mask):
    return np.asarray(j_sweep_grid(
        snap.alloc_cpu_milli, snap.alloc_mem_bytes, snap.alloc_pods,
        snap.used_cpu_req_milli, snap.used_mem_req_bytes, snap.pods_count,
        snap.healthy, grid.cpu_request_milli, grid.mem_request_bytes,
        grid.replicas, mode=mode, node_mask=mask, return_per_node=True,
    )[2])


@pytest.fixture(scope="module")
def hier():
    return _hier(JAX), _hier(TORCH)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("mode", ["reference", "strict"])
@pytest.mark.parametrize("spec_i", range(len(SPECS)),
                         ids=[str(i) for i in range(len(SPECS))])
def test_gang_capacity_parity_matrix(spec_i, mode, masked, hier,
                                     monkeypatch):
    j_snap, t_snap = hier
    kw = SPECS[spec_i]
    j_grid = j_scenario.random_scenario_grid(3, seed=11)
    t_grid = t_scenario.random_scenario_grid(3, seed=11)
    mask = (np.random.default_rng(5).random(j_snap.n_nodes) < 0.85
            if masked else None)
    want_gangs = j_gang.gang_oracle(
        _jax_fits(j_snap, j_grid, mode, mask),
        j_topo.topology_from_snapshot(j_snap), j_gang.GangSpec(**kw),
        node_mask=mask)
    engines = set()
    for grouping, gang_grouped in (("1", "1"), ("0", "1"), ("1", "0")):
        monkeypatch.setenv("KCCAP_GROUPING", grouping)
        monkeypatch.setenv("KCCAP_GANG_GROUPED", gang_grouped)
        j = _capacity(JAX, j_snap, j_grid, j_gang.GangSpec(**kw), mode=mode,
                      node_mask=mask)
        t = _capacity(TORCH, t_snap, t_grid, t_gang.GangSpec(**kw),
                      mode=mode, node_mask=mask)
        assert _result_fields(t) == _result_fields(j), (grouping,
                                                        gang_grouped)
        assert t.gangs.tolist() == want_gangs
        engines.add(t.engine)
    assert engines == {"grouped", "per-node"}


def test_gang_oracle_matches_jax(hier):
    j_snap, t_snap = hier
    grid = j_scenario.random_scenario_grid(2, seed=4)
    fits = _jax_fits(j_snap, grid, "strict", None)
    for kw in SPECS:
        assert t_gang.gang_oracle(
            fits, t_topo.topology_from_snapshot(t_snap),
            t_gang.GangSpec(**kw)) == j_gang.gang_oracle(
            fits, j_topo.topology_from_snapshot(j_snap),
            j_gang.GangSpec(**kw))


@pytest.mark.parametrize("kw", [dict(ranks=10, anti_affinity_host=True),
                                dict(ranks=6, colocate="host"),
                                dict(ranks=30, colocate="rack",
                                     spread_level="host",
                                     max_ranks_per_domain=3)],
                         ids=["anti-affinity", "host", "rack-host"])
def test_shared_host_domains_take_the_per_node_engine_like_jax(kw):
    fx = j_fixtures.synthetic_fixture(1100, seed=4, topology=(2, 2))
    for node in fx["nodes"]:
        node["labels"]["kubernetes.io/hostname"] = "shared"
    j_snap = j_snapshot.snapshot_from_fixture(fx, semantics="strict")
    t_snap = t_snapshot.snapshot_from_fixture(fx, semantics="strict")
    assert not t_topo.topology_from_snapshot(t_snap).host_singleton
    j_grid = j_scenario.random_scenario_grid(2, seed=1)
    t_grid = t_scenario.random_scenario_grid(2, seed=1)
    j = _capacity(JAX, j_snap, j_grid, j_gang.GangSpec(**kw), mode="strict")
    t = _capacity(TORCH, t_snap, t_grid, t_gang.GangSpec(**kw),
                  mode="strict")
    assert _result_fields(t) == _result_fields(j)
    assert t.engine == "per-node"


@pytest.mark.parametrize("missing", ["own", "exclude"])
@pytest.mark.parametrize("kw", [dict(ranks=5, colocate="rack"),
                                dict(ranks=7, colocate="zone",
                                     spread_level="rack",
                                     max_ranks_per_domain=2)],
                         ids=["rack", "zone-rack"])
def test_missing_label_policies_match_jax(kw, missing):
    fx = _unlabel_racks(j_fixtures.synthetic_fixture(30, seed=6,
                                                     topology=(2, 2)), 10)
    j_snap = j_snapshot.snapshot_from_fixture(fx, semantics="strict")
    t_snap = t_snapshot.snapshot_from_fixture(fx, semantics="strict")
    grid = dict(cpu_request_milli=np.array([100, 1500]),
                mem_request_bytes=np.array([64 << 20, 2 << 30]),
                replicas=np.array([1, 4]))
    j = _capacity(JAX, j_snap, j_scenario.ScenarioGrid(**grid),
                  j_gang.GangSpec(**kw), mode="strict", missing=missing)
    t = _capacity(TORCH, t_snap, t_scenario.ScenarioGrid(**grid),
                  t_gang.GangSpec(**kw), mode="strict", missing=missing)
    assert _result_fields(t) == _result_fields(j)
    assert t.excluded_nodes == (10 if missing == "exclude" else 0)


def test_empty_cluster_and_unlabelled_fleet_match_jax():
    for n in (0, 5):
        j_snap = j_snapshot.synthetic_snapshot(n, seed=1)
        t_snap = t_snapshot.synthetic_snapshot(n, seed=1)
        for kw in SPECS:
            j = _capacity(JAX, j_snap, j_scenario.random_scenario_grid(
                2, seed=3), j_gang.GangSpec(**kw))
            t = _capacity(TORCH, t_snap, t_scenario.random_scenario_grid(
                2, seed=3), t_gang.GangSpec(**kw))
            assert _result_fields(t) == _result_fields(j), (n, kw)


def test_gang_capacity_rejects_a_bad_grid_like_jax():
    errors = []
    for pkg in (JAX, TORCH):
        snap = pkg.snapshot.synthetic_snapshot(8, seed=1, topology=(1, 2))
        grid = pkg.scenario.ScenarioGrid(
            cpu_request_milli=np.array([0]), mem_request_bytes=np.array([1]),
            replicas=np.array([1]))
        with pytest.raises(ValueError) as info:
            _capacity(pkg, snap, grid, pkg.gang.GangSpec(ranks=2))
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_default_device_is_the_card():
    snap = t_snapshot.synthetic_snapshot(8, seed=1, topology=(1, 2))
    grid = t_scenario.random_scenario_grid(1, seed=1)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_gang.gang_capacity(snap, grid, t_gang.GangSpec(ranks=2))


# --- gang_explain -------------------------------------------------------


@pytest.fixture(scope="module")
def explain_snaps():
    fx = j_fixtures.synthetic_fixture(90, seed=9, topology=(3, 3),
                                      taint_frac=0.2)
    return (j_snapshot.snapshot_from_fixture(fx, semantics="strict"),
            t_snapshot.snapshot_from_fixture(fx, semantics="strict"))


EXPLAIN_CASES = {
    "rack-binds": (dict(ranks=60, colocate="rack"), (2000, 4 << 30, 1)),
    "spread-binds": (dict(ranks=30, colocate="zone", spread_level="rack",
                          max_ranks_per_domain=3), (500, 1 << 30, 1)),
    "cluster-binds": (dict(ranks=1), (100, 1 << 20, 1)),
    "anti-affinity": (dict(ranks=8, anti_affinity_host=True, count=5),
                      (250, 256 << 20, 1)),
    "host": (dict(ranks=4, colocate="host"), (1000, 1 << 30, 1)),
    "nothing-fits": (dict(ranks=3, colocate="zone"), (64000, 1 << 40, 1)),
}


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("name", sorted(EXPLAIN_CASES))
def test_gang_explain_matches_jax(name, masked, explain_snaps):
    kw, (cpu, mem, rep) = EXPLAIN_CASES[name]
    outs = []
    for pkg, snap in zip((JAX, TORCH), explain_snaps):
        grid = pkg.scenario.ScenarioGrid(
            cpu_request_milli=np.array([cpu, 300]),
            mem_request_bytes=np.array([mem, 1 << 28]),
            replicas=np.array([rep, 2]))
        mask = (np.arange(snap.n_nodes) % 5 != 0) if masked else None
        outs.append([_explain(pkg, snap, grid, pkg.gang.GangSpec(**kw),
                              node_mask=mask, scenario=s) for s in (0, 1)])
    assert outs[1] == outs[0]
    if name == "rack-binds" and not masked:
        assert outs[1][0]["binding"] == "rack"
    if name == "cluster-binds":
        assert outs[1][0]["binding"] == "cluster"
