"""The PyTorch port's host layer against the JAX package, value for value.

Quantity codecs, the reference-semantics node/pod helpers, both snapshot
packers, the synthetic generators, grouping, checkpoints, scenarios, masks
and source resolution.  Everything here is numpy on the host, so results
are compared with exact equality.
"""

import numpy as np
import pytest

from kubernetesclustercapacity_tpu import fixtures as j_fixtures
from kubernetesclustercapacity_tpu import masks as j_masks
from kubernetesclustercapacity_tpu import scenario as j_scenario
from kubernetesclustercapacity_tpu import snapshot as j_snapshot
from kubernetesclustercapacity_tpu import sources as j_sources
from kubernetesclustercapacity_tpu.oracle import reference as j_oracle
from kubernetesclustercapacity_tpu.utils import quantity as j_q
from kubernetesclustercapacity_tpu_torch import fixtures as t_fixtures
from kubernetesclustercapacity_tpu_torch import masks as t_masks
from kubernetesclustercapacity_tpu_torch import scenario as t_scenario
from kubernetesclustercapacity_tpu_torch import snapshot as t_snapshot
from kubernetesclustercapacity_tpu_torch import sources as t_sources
from kubernetesclustercapacity_tpu_torch.oracle import reference as t_oracle
from kubernetesclustercapacity_tpu_torch.utils import quantity as t_q

KIND = "tests/fixtures/kind-3node.json"

QUANTITY_STRINGS = [
    "100m", "250m", "0m", "2", "4", "0", "+3", "1000m", "-5", "-5m", "5mm",
    "9" * 30, "0.5", "2.5", "", "m", "100Mi", "1e2", "abc", " 2", "2 ",
    "1_0", "٢", "100mb", "100MB", "100M", "100MiB", "1k", "3500Ki",
    "1KB", "2g", "2GB", "2GiB", "16Gi", "1T", "1TiB", "5B", "  250mb  ",
    "0.5M", "1.5K", "2 GB", "1.0009765625K", "0.3B", "1", "1Ki", "1Ti",
    "1M", "1e3", "1E3", "12e-1", "1500m", "1.5Gi", "-1500m", "-100m",
    "0.5B", "\x1c100MB", "inf", "nan", "0x10", "1e400", "9223372036854775808",
    "-9223372036854775809", "16E", "1e-9", "12.5.3", ".", "1e+99999",
]


def _outcome(fn, s):
    """A codec's value, or its exception type and message."""
    try:
        return ("ok", fn(s))
    except Exception as e:  # noqa: BLE001 - the error IS the compared result
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("s", QUANTITY_STRINGS)
def test_quantity_codecs_match(s):
    for name in (
        "cpu_to_milli_reference", "cpu_parse_error_payload",
        "to_bytes_reference", "go_atoi", "go_atoi_clamped", "go_atoi_error",
        "go_quote",
    ):
        assert _outcome(getattr(t_q, name), s) == _outcome(
            getattr(j_q, name), s
        ), name
    for view in ("value", "milli_value"):
        assert _outcome(
            lambda x: getattr(t_q.parse_quantity(x), view)(), s
        ) == _outcome(lambda x: getattr(j_q.parse_quantity(x), view)(), s)


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 2**20 + 7, 2**40 * 3, -5])
def test_byte_size_matches(n):
    assert t_q.byte_size(n) == j_q.byte_size(n)
    assert t_q.int64_bits(n * 2**40) == j_q.int64_bits(n * 2**40)


def _assert_same_snapshot(t, j):
    for f in t_snapshot.COLUMNS + ("healthy",):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert t.names == j.names
    assert t.semantics == j.semantics
    assert t.labels == j.labels
    assert t.taints == j.taints
    assert [tuple(x) for x in t.node_log] == [tuple(x) for x in j.node_log]
    assert [tuple(x) for x in t.pod_cpu_errs] == [
        tuple(x) for x in j.pod_cpu_errs
    ]
    assert sorted(t.extended) == sorted(j.extended)
    for r in t.extended:
        for a, b in zip(t.extended[r], j.extended[r]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("semantics", ["reference", "strict"])
def test_kind_fixture_packs_identically(semantics):
    fx_t = t_fixtures.load_fixture(KIND)
    fx_j = j_fixtures.load_fixture(KIND)
    assert fx_t == fx_j
    _assert_same_snapshot(
        t_snapshot.snapshot_from_fixture(fx_t, semantics=semantics),
        j_snapshot.snapshot_from_fixture(fx_j, semantics=semantics),
    )


@pytest.mark.parametrize("semantics", ["reference", "strict"])
@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_fixture_packs_identically(semantics, seed):
    kw = dict(
        seed=seed, unhealthy_frac=0.15, unparseable_mem_frac=0.1,
        unscheduled_running_pods=3, taint_frac=0.2,
    )
    fx_t = t_fixtures.synthetic_fixture(120, **kw)
    fx_j = j_fixtures.synthetic_fixture(120, **kw)
    assert fx_t == fx_j
    _assert_same_snapshot(
        t_snapshot.snapshot_from_fixture(fx_t, semantics=semantics),
        j_snapshot.snapshot_from_fixture(fx_j, semantics=semantics),
    )


def test_strict_extended_resources_pack_identically():
    fx = j_fixtures.synthetic_fixture(40, seed=2)
    for node in fx["nodes"]:
        node["allocatable"]["nvidia.com/gpu"] = "4"
    fx["pods"][0]["containers"] = [
        {"resources": {"requests": {"cpu": "1", "nvidia.com/gpu": "2"}}}
    ]
    ext = ("nvidia.com/gpu",)
    _assert_same_snapshot(
        t_snapshot.snapshot_from_fixture(
            fx, semantics="strict", extended_resources=ext
        ),
        j_snapshot.snapshot_from_fixture(
            fx, semantics="strict", extended_resources=ext
        ),
    )
    with pytest.raises(ValueError):
        t_snapshot.snapshot_from_fixture(fx, extended_resources=ext)


@pytest.mark.parametrize(
    "kw",
    [
        dict(seed=0),
        dict(seed=3, mean_utilization=0.7, alloc_pods=64),
        dict(seed=1, kib_quantized=False),
        dict(seed=2, shapes=8),
    ],
)
def test_synthetic_snapshot_identical(kw):
    _assert_same_snapshot(
        t_snapshot.synthetic_snapshot(300, **kw),
        j_snapshot.synthetic_snapshot(300, **kw),
    )


def _pair_from_jax(j):
    """The port's snapshot built from the JAX snapshot's numpy columns."""
    return t_snapshot.ClusterSnapshot.from_columns(
        {f: getattr(j, f) for f in t_snapshot.COLUMNS + ("healthy",)},
        names=list(j.names), semantics=j.semantics, taints=j.taints,
        labels=j.labels, extended=dict(j.extended),
    )


@pytest.mark.parametrize(
    "n,shapes", [(500, 4), (1023, 4), (1024, 4), (4096, 8), (5000, None),
                 (4096, 3000)],
)
def test_grouped_for_dispatch_matches(n, shapes):
    j = j_snapshot.synthetic_snapshot(n, seed=4, shapes=shapes)
    t = _pair_from_jax(j)
    gj = j_snapshot.grouped_for_dispatch(j)
    gt = t_snapshot.grouped_for_dispatch(t)
    assert (gt is None) == (gj is None)
    # The grouped form itself is defined at every size, gated or not.
    gj, gt = j.grouped(), t.grouped()
    for f in (
        "alloc_cpu_milli", "alloc_mem_bytes", "alloc_pods",
        "used_cpu_req_milli", "used_cpu_lim_milli", "used_mem_req_bytes",
        "used_mem_lim_bytes", "pods_count", "healthy", "count",
        "group_index", "representative",
    ):
        np.testing.assert_array_equal(getattr(gt, f), getattr(gj, f), f)
    mask = np.random.default_rng(n).random(n) < 0.6
    np.testing.assert_array_equal(
        gt.effective_counts(mask), gj.effective_counts(mask)
    )
    per_group = np.arange(gt.n_groups * 2).reshape(2, gt.n_groups)
    np.testing.assert_array_equal(gt.expand(per_group), gj.expand(per_group))


def test_grouping_switch_and_gate(monkeypatch):
    j = j_snapshot.synthetic_snapshot(4096, seed=4, shapes=8)
    monkeypatch.setenv("KCCAP_GROUPING", "0")
    assert t_snapshot.grouped_for_dispatch(_pair_from_jax(j)) is None
    monkeypatch.setenv("KCCAP_GROUPING", "1")
    monkeypatch.setenv("KCCAP_GROUP_MIN_COUNT", "1000")
    assert t_snapshot.grouped_for_dispatch(_pair_from_jax(j)) is None
    monkeypatch.setenv("KCCAP_GROUP_MIN_COUNT", "3")
    assert t_snapshot.grouped_for_dispatch(_pair_from_jax(j)) is not None


@pytest.mark.parametrize("semantics", ["reference", "strict"])
def test_checkpoints_cross_load(tmp_path, semantics):
    fx = j_fixtures.synthetic_fixture(60, seed=7, taint_frac=0.3,
                                      unscheduled_running_pods=2)
    j = j_snapshot.snapshot_from_fixture(fx, semantics=semantics)
    j.save(str(tmp_path / "jax.npz"))
    t_loaded = t_snapshot.load_snapshot(str(tmp_path / "jax.npz"))
    _assert_same_snapshot(
        t_loaded, j_snapshot.load_snapshot(str(tmp_path / "jax.npz"))
    )
    t_loaded.save(str(tmp_path / "torch.npz"))
    _assert_same_snapshot(
        t_loaded, j_snapshot.load_snapshot(str(tmp_path / "torch.npz"))
    )


def test_reference_oracle_helpers_match():
    fx = j_fixtures.synthetic_fixture(
        50, seed=9, unhealthy_frac=0.3, unparseable_mem_frac=0.2,
        unscheduled_running_pods=4,
    )
    for fixture in (fx, j_fixtures.load_fixture(KIND)):
        t_nodes = t_oracle.healthy_nodes(fixture)
        j_nodes = j_oracle.healthy_nodes(fixture)
        assert [vars(a) for a in t_nodes] == [vars(b) for b in j_nodes]
        t_idx = t_oracle.pods_by_node_index(fixture)
        assert t_idx == j_oracle.pods_by_node_index(fixture)
        for pods in t_idx.values():
            assert t_oracle.pod_requests_limits(
                pods
            ) == j_oracle.pod_requests_limits(pods)
    bad = {"name": "x", "conditions": [{"status": "False"}] * 3}
    with pytest.raises(t_oracle.ReferencePanic):
        t_oracle.node_is_healthy_reference(bad)
    with pytest.raises(j_oracle.ReferencePanic):
        j_oracle.node_is_healthy_reference(bad)


@pytest.mark.parametrize("seed", [0, 1, 77])
def test_random_scenario_grid_identical(seed):
    t = t_scenario.random_scenario_grid(257, seed=seed)
    j = j_scenario.random_scenario_grid(257, seed=seed)
    for f in ("cpu_request_milli", "mem_request_bytes", "replicas"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))


@pytest.mark.parametrize(
    "flags",
    [
        {},
        dict(cpuRequests="200m", memRequests="250mb", replicas="10"),
        dict(cpuRequests="0.5", cpuLimits="abc", memRequests="1Gi"),
        dict(cpuRequests="-5", memRequests="0.5B"),
        dict(memRequests="1073741824"),  # no unit: fatal
        dict(memLimits="16Gi"),  # GI rejected: fatal
        dict(replicas="ten"),
        dict(replicas="99999999999999999999"),
        dict(replicas="-3"),
        dict(replicas="\x01"),
    ],
)
def test_scenario_from_flags_matches(flags):
    def run(mod):
        try:
            s = mod.scenario_from_flags(**flags)
        except mod.ScenarioError as e:
            return ("error", str(e), e.reference_line)
        try:
            s.validate()
            valid = None
        except mod.ScenarioError as e:
            valid = str(e)
        return (
            s.cpu_request_milli, s.mem_request_bytes, s.replicas,
            s.cpu_limit_milli, s.mem_limit_bytes,
            s.input_cpu_error_payloads, valid,
        )

    assert run(t_scenario) == run(j_scenario)


def test_scenario_grid_validation_and_from_scenarios():
    scenarios = [
        t_scenario.Scenario(2**64 - 5, 1024, 3),
        t_scenario.Scenario(100, 5, -1),
    ]
    t = t_scenario.ScenarioGrid.from_scenarios(scenarios)
    j = j_scenario.ScenarioGrid.from_scenarios(
        [j_scenario.Scenario(2**64 - 5, 1024, 3),
         j_scenario.Scenario(100, 5, -1)]
    )
    np.testing.assert_array_equal(t.cpu_request_milli, j.cpu_request_milli)
    assert t[0] == t_scenario.Scenario(int(j[0].cpu_request_milli), 1024, 3)
    t.validate()
    for bad in (
        dict(cpu_request_milli=[0], mem_request_bytes=[1], replicas=[1]),
        dict(cpu_request_milli=[1], mem_request_bytes=[0], replicas=[1]),
    ):
        with pytest.raises(t_scenario.ScenarioError):
            t_scenario.ScenarioGrid(**bad).validate()
    with pytest.raises(t_scenario.ScenarioError):
        t_scenario.ScenarioGrid([1, 2], [1], [1])


def test_masks_match():
    fx = j_fixtures.synthetic_fixture(80, seed=3, taint_frac=0.4)
    fx["nodes"][0]["taints"] = [
        {"key": "gpu", "value": "yes", "effect": "NoExecute"},
        {"key": "soft", "value": "", "effect": "PreferNoSchedule"},
    ]
    fx["nodes"][1]["labels"]["rank"] = "7"
    j = j_snapshot.snapshot_from_fixture(fx, semantics="strict")
    t = _pair_from_jax(j)
    tolerations = [
        [],
        [{"key": "dedicated", "operator": "Equal", "value": "batch"}],
        [{"operator": "Exists"}],
        [{"key": "gpu", "operator": "Exists", "effect": "NoExecute"}],
    ]
    for tol in tolerations:
        np.testing.assert_array_equal(
            t_masks.tolerations_mask(t, tol), j_masks.tolerations_mask(j, tol)
        )
    for sel in ({}, {"zone": "zone-1"}, {"zone": "zone-1", "pool": "highmem"}):
        np.testing.assert_array_equal(
            t_masks.node_selector_mask(t, sel),
            j_masks.node_selector_mask(j, sel),
        )
    terms = [
        [{"matchExpressions": [{"key": "zone", "operator": "In",
                                "values": ["zone-0", "zone-2"]}]}],
        [{"matchExpressions": [{"key": "pool", "operator": "NotIn",
                                "values": ["highmem"]},
                               {"key": "zone", "operator": "Exists"}]}],
        [{"matchExpressions": [{"key": "rank", "operator": "Gt",
                                "values": ["5"]}]},
         {"matchFields": [{"key": "metadata.name", "operator": "In",
                           "values": ["node-00003"]}]}],
        [{}],
        [{"matchExpressions": [{"key": "nope", "operator": "DoesNotExist"}]}],
    ]
    for term in terms:
        np.testing.assert_array_equal(
            t_masks.node_affinity_mask(t, term),
            j_masks.node_affinity_mask(j, term),
        )
    a = t_masks.tolerations_mask(t, [])
    b = t_masks.node_selector_mask(t, {"zone": "zone-1"})
    np.testing.assert_array_equal(
        t_masks.combine_masks(a, None, b), j_masks.combine_masks(a, None, b)
    )
    assert t_masks.combine_masks(None) is None
    with pytest.raises(ValueError):
        t_masks.node_affinity_mask(
            t, [{"matchFields": [{"key": "spec.x", "operator": "In"}]}]
        )


@pytest.mark.parametrize("semantics", ["reference", "strict"])
@pytest.mark.parametrize("taint_frac", [0.0, 0.3])
def test_implicit_taint_mask_matches(semantics, taint_frac):
    fx = j_fixtures.synthetic_fixture(90, seed=11, taint_frac=taint_frac)
    j = j_snapshot.snapshot_from_fixture(fx, semantics=semantics)
    t = t_snapshot.snapshot_from_fixture(fx, semantics=semantics)
    jm, tm = j_masks.implicit_taint_mask(j), t_masks.implicit_taint_mask(t)
    assert (tm is None) == (jm is None)
    if tm is not None:
        np.testing.assert_array_equal(tm, jm)


def test_resolve_source_matches(tmp_path):
    strict = j_snapshot.snapshot_from_fixture(
        j_fixtures.load_fixture(KIND), semantics="strict"
    )
    npz = str(tmp_path / "s.npz")
    strict.save(npz)
    for path, semantics in ((KIND, None), (KIND, "strict"), (npz, None),
                            (npz, "strict")):
        tf, ts, tsem = t_sources.resolve_source(path, semantics)
        jf, js, jsem = j_sources.resolve_source(path, semantics)
        assert tf == jf and tsem == jsem
        _assert_same_snapshot(ts, js)
    for path, semantics in ((npz, "reference"), (str(tmp_path / "no"), None)):
        with pytest.raises(t_sources.SourceError) as te:
            t_sources.resolve_source(path, semantics)
        with pytest.raises(j_sources.SourceError) as je:
            j_sources.resolve_source(path, semantics)
        assert str(te.value) == str(je.value)


def _extended_pair():
    fx = j_fixtures.synthetic_fixture(60, seed=9, unhealthy_frac=0.1)
    for i, node in enumerate(fx["nodes"]):
        node["allocatable"]["nvidia.com/gpu"] = str(i % 9)
        node["allocatable"]["ephemeral-storage"] = f"{50 + i}Gi"
    fx["pods"][0]["containers"] = [{"resources": {"requests": {
        "cpu": "1", "nvidia.com/gpu": "2", "ephemeral-storage": "3Gi"}}}]
    ext = ("ephemeral-storage", "nvidia.com/gpu")
    return (
        t_snapshot.snapshot_from_fixture(fx, semantics="strict",
                                         extended_resources=ext),
        j_snapshot.snapshot_from_fixture(fx, semantics="strict",
                                         extended_resources=ext),
    )


@pytest.mark.parametrize(
    "resources",
    [("cpu", "memory"), ("nvidia.com/gpu",),
     ("cpu", "memory", "ephemeral-storage", "nvidia.com/gpu"),
     ("ephemeral-storage", "cpu")],
)
def test_resource_matrix_matches(resources):
    t, j = _extended_pair()
    for got, want in zip(t.resource_matrix(resources),
                         j.resource_matrix(resources)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert not got.flags.writeable
    assert t.resource_matrix(resources) is t.resource_matrix(resources)


def test_resource_matrix_missing_column_raises_like_jax():
    t, j = _extended_pair()
    with pytest.raises(KeyError) as te:
        t.resource_matrix(("cpu", "example.com/fpga"))
    with pytest.raises(KeyError) as je:
        j.resource_matrix(("cpu", "example.com/fpga"))
    assert str(te.value) == str(je.value)
    assert t.resource_matrix()[0].shape == (2, t.n_nodes)


def _outcome_of(build):
    try:
        grid = build()
        grid.validate()
        return ("ok", grid.resources, grid.requests.tolist(),
                grid.replicas.tolist())
    except Exception as e:  # noqa: BLE001 - the error IS the compared result
        return (type(e).__name__, str(e))


@pytest.mark.parametrize(
    "resources,requests,replicas",
    [
        (("cpu", "memory", "nvidia.com/gpu"), [[100, 1024, 0]], [3]),
        (("cpu", "memory"), [[100, 1024], [5, 7]], [0, 1]),
        (("cpu", "cpu"), [[1, 1]], [1]),
        (("cpu", "memory"), [[1, 1, 1]], [1]),
        (("cpu", "memory"), [1, 1], [1]),
        (("cpu", "memory"), [[1, 1]], [1, 2]),
        (("cpu", "memory", "gpu"), [[1, 1, -1]], [1]),
        (("cpu", "memory"), [[0, 1]], [1]),
        (("cpu", "memory"), [[1, 0]], [1]),
        (("gpu", "memory"), [[0, 5]], [1]),
        (("cpu", "memory"), [[1, 1]], [-1]),
    ],
    ids=["ok", "ok-2", "duplicate", "width", "rank", "replicas-shape",
         "negative", "zero-cpu", "zero-memory", "zero-extended",
         "negative-replicas"],
)
def test_multi_resource_grid_matches(resources, requests, replicas):
    def build(mod):
        return lambda: mod.MultiResourceGrid(resources, requests, replicas)

    assert _outcome_of(build(t_scenario)) == _outcome_of(build(j_scenario))


@pytest.mark.parametrize("seed", [0, 3])
def test_multi_resource_grid_from_grid_matches(seed):
    s = 16
    rng = np.random.default_rng(seed)
    extended = {"nvidia.com/gpu": rng.integers(0, 3, s),
                "ephemeral-storage": rng.integers(1, 20, s) << 30}
    t = t_scenario.MultiResourceGrid.from_grid(
        t_scenario.random_scenario_grid(s, seed=seed), extended)
    j = j_scenario.MultiResourceGrid.from_grid(
        j_scenario.random_scenario_grid(s, seed=seed), extended)
    assert t.resources == j.resources == (
        "cpu", "memory", "ephemeral-storage", "nvidia.com/gpu")
    np.testing.assert_array_equal(t.requests, j.requests)
    np.testing.assert_array_equal(t.replicas, j.replicas)
    assert t.size == j.size == s
    for mod in (t_scenario, j_scenario):
        with pytest.raises(mod.ScenarioError, match="must be \\[S\\]"):
            mod.MultiResourceGrid.from_grid(
                mod.random_scenario_grid(s, seed=seed), {"gpu": [1, 2]})


def test_resolve_source_extended_matches(tmp_path):
    fx_path = str(tmp_path / "gpu.json")
    fx = j_fixtures.synthetic_fixture(30, seed=4)
    for node in fx["nodes"]:
        node["allocatable"]["nvidia.com/gpu"] = "4"
    j_fixtures.save_fixture(fx, fx_path)
    ext = ("nvidia.com/gpu",)
    npz = str(tmp_path / "gpu.npz")
    j_snapshot.snapshot_from_fixture(
        fx, semantics="strict", extended_resources=ext).save(npz)
    plain_npz = str(tmp_path / "plain.npz")
    j_snapshot.snapshot_from_fixture(fx, semantics="strict").save(plain_npz)
    for path, semantics in ((fx_path, "strict"), (npz, None),
                            (npz, "strict")):
        tf, ts, tsem = t_sources.resolve_source(path, semantics, ext)
        jf, js, jsem = j_sources.resolve_source(path, semantics, ext)
        assert tf == jf and tsem == jsem
        _assert_same_snapshot(ts, js)
    for path, semantics in ((fx_path, None), (fx_path, "reference"),
                            (plain_npz, None)):
        with pytest.raises(t_sources.SourceError) as te:
            t_sources.resolve_source(path, semantics, ext)
        with pytest.raises(j_sources.SourceError) as je:
            j_sources.resolve_source(path, semantics, ext)
        assert str(te.value) == str(je.value)
