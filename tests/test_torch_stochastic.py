"""The port's stochastic family against ``kubernetesclustercapacity_tpu.
stochastic``, on the CPU.

* the grammar: every case of the JAX package's ``TestDistributionGrammar``
  through both parsers (equal distributions and specs, equal error text);
* the seeded sampler: keys and int64 samples equal to ``jax.random``'s for
  every seed and distribution ``tests/test_stochastic.py`` draws, its 220
  randomized specs, 250 more seeded random specs, and the mean-4-GiB σ=1
  lognormal over 65,536 draws (the case ``torch.special.erfinv`` breaks);
* the exact FMA the sampler emulates, against exact rational arithmetic;
* ``capacity_at_risk`` (fused and not, both modes, masked, grouped) and
  ``car_oracle`` against the JAX functions.

Tolerance: none.  Samples, totals, quantiles, realizing indices and
bindings are integers; ``mean`` and ``prob_fit`` are numpy floats of equal
integers, so they are compared with ``==`` too.  ``eval_ms`` is a wall
time and is left out.
"""

import dataclasses
import json
import math
import random
from fractions import Fraction

import numpy as np
import pytest
import torch

import kubernetesclustercapacity_tpu.stochastic as js
from kubernetesclustercapacity_tpu.snapshot import (
    ClusterSnapshot as JaxSnapshot,
)
from kubernetesclustercapacity_tpu.snapshot import (
    synthetic_snapshot as j_synthetic,
)
from kubernetesclustercapacity_tpu_torch import stochastic as ts
from kubernetesclustercapacity_tpu_torch.snapshot import (
    ClusterSnapshot as TorchSnapshot,
)
from kubernetesclustercapacity_tpu_torch.snapshot import (
    synthetic_snapshot as t_synthetic,
)
from kubernetesclustercapacity_tpu_torch.stochastic import (
    distributions as td,
)

COLS = (
    "alloc_cpu_milli", "alloc_mem_bytes", "alloc_pods", "used_cpu_req_milli",
    "used_cpu_lim_milli", "used_mem_req_bytes", "used_mem_lim_bytes",
    "pods_count", "healthy",
)


def _port_snapshot(snap):
    return TorchSnapshot(
        names=list(snap.names), semantics=snap.semantics,
        taints=list(snap.taints), labels=list(snap.labels),
        **{c: np.asarray(getattr(snap, c)) for c in COLS},
    )


def _dist_pair(kind, **kw):
    return (js.UsageDistribution(kind=kind, **kw),
            ts.UsageDistribution(kind=kind, **kw))


def _spec_pair(spec):
    """The port's spec equal to a JAX ``StochasticSpec``."""
    return ts.StochasticSpec(
        cpu=ts.UsageDistribution(**dataclasses.asdict(spec.cpu)),
        memory=ts.UsageDistribution(**dataclasses.asdict(spec.memory)),
        replicas=spec.replicas, samples=spec.samples, seed=spec.seed,
        confidence=spec.confidence,
    )


def _draws_equal(jdist, tdist, n, seed, stream):
    want = js.sample_usage(jdist, n, js.sample_key(seed, stream))
    got = ts.sample_usage(tdist, n, ts.sample_key(seed, stream),
                          device="cpu")
    assert got.dtype == np.int64 and got.shape == (n,)
    mismatches = int((want != got).sum())
    assert mismatches == 0, (jdist, n, seed, stream, mismatches)
    return got


# -- grammar ----------------------------------------------------------------

GOOD = [
    ("cpu", {"dist": "normal", "mean": "500m", "std": "150m"}),
    ("memory", {"dist": "lognormal", "mean": "1gb", "sigma": 0.4}),
    ("cpu", {"dist": "point", "value": 250}),
    ("cpu", {"dist": "empirical", "values": ["100m", 300], "weights": [3, 1]}),
    ("memory", "1gb"),
    ("cpu", 750),
    ("cpu", {"dist": "normal", "mean": 100, "std": 0}),
    ("cpu", {"dist": "normal", "mean": 100, "std": 1}),
    ("cpu", {"dist": "empirical", "values": [5, 5]}),
    ("cpu", {"dist": "lognormal", "mean": 100, "sigma": 0}),
]
BAD = [
    ("cpu", {"dist": "gauss"}),
    ("cpu", {"dist": "normal"}),
    ("cpu", {"dist": "normal", "mean": "500m", "sigma": 1}),
    ("cpu", {"dist": "normal", "mean": "junk!", "std": 1}),
    ("memory", {"dist": "point", "value": "12wat"}),
    ("cpu", {"dist": "point", "value": 0}),
    ("cpu", {"dist": "point", "value": -5}),
    ("cpu", {"dist": "normal", "mean": 100, "std": -1}),
    ("cpu", {"dist": "lognormal", "mean": 100, "sigma": 9}),
    ("cpu", {"dist": "empirical", "values": []}),
    ("cpu", {"dist": "empirical", "values": [1, 2], "weights": [1]}),
    ("cpu", {"dist": "empirical", "values": [1, 2], "weights": [1, 0]}),
    ("cpu", [1, 2]),
    ("cpu", True),
]


@pytest.mark.parametrize("resource,data", GOOD)
def test_distribution_parses_like_jax(resource, data):
    want = js.parse_distribution(resource, data)
    got = ts.parse_distribution(resource, data)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.degenerate == want.degenerate
    assert got.to_wire() == want.to_wire()


@pytest.mark.parametrize("resource,data", BAD)
def test_malformed_distribution_error_is_jaxs(resource, data):
    with pytest.raises(js.DistributionError) as want:
        js.parse_distribution(resource, data)
    with pytest.raises(ts.DistributionError) as got:
        ts.parse_distribution(resource, data)
    assert str(got.value) == str(want.value)


SPECS = [
    {"usage": {"cpu": "500m", "memory": "1gb"}, "replicas": "40",
     "samples": 256, "seed": 3, "confidence": 0.9},
    {"usage": {"cpu": {"dist": "normal", "mean": "500m", "std": "150m"},
               "memory": {"dist": "lognormal", "mean": "1gb", "sigma": 0.4}},
     "replicas": 40},
    {"usage": {"cpu": "500m"}},
    {"usage": {"cpu": "500m", "memory": "1gb", "gpu": 1}},
    {"usage": {"cpu": "500m", "memory": "1gb"}, "replicas": "many"},
    {"usage": {"cpu": "500m", "memory": "1gb"}, "samples": 1},
    {"usage": {"cpu": "500m", "memory": "1gb"}, "samples": 1 << 17},
    {"usage": {"cpu": "500m", "memory": "1gb"}, "seed": "7"},
    {"usage": {"cpu": "500m", "memory": "1gb"}, "confidence": 1.0},
    {"usage": {"cpu": "500m", "memory": "1gb"}, "extra": 1},
    ["not", "a", "mapping"],
]


@pytest.mark.parametrize("doc", SPECS, ids=[f"spec{i}" for i in
                                            range(len(SPECS))])
def test_spec_parses_like_jax(doc):
    try:
        want = js.parse_stochastic_spec(doc)
    except js.DistributionError as e:
        with pytest.raises(ts.DistributionError) as got:
            ts.parse_stochastic_spec(doc)
        assert str(got.value) == str(e)
        return
    got = ts.parse_stochastic_spec(doc)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_wire() == want.to_wire()


def test_spec_file_and_default_samples_like_jax(tmp_path, monkeypatch):
    path = tmp_path / "spec.json"
    path.write_text(json.dumps({
        "usage": {"cpu": {"dist": "normal", "mean": "500m", "std": "100m"},
                  "memory": "1gb"},
        "replicas": 25, "seed": 9,
    }))
    want = js.load_stochastic_spec(str(path))
    got = ts.load_stochastic_spec(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    (tmp_path / "bad.yaml").write_text("usage: [unclosed")
    with pytest.raises(js.DistributionError) as j_err:
        js.load_stochastic_spec(str(tmp_path / "bad.yaml"))
    with pytest.raises(ts.DistributionError) as t_err:
        ts.load_stochastic_spec(str(tmp_path / "bad.yaml"))
    assert str(t_err.value) == str(j_err.value)
    for env in ("", "128", "1", "junk", str(1 << 17)):
        monkeypatch.setenv("KCCAP_CAR_SAMPLES", env)
        assert ts.default_samples() == js.default_samples()
        assert got.n_samples() == want.n_samples()


# -- the sampler ------------------------------------------------------------

@pytest.mark.parametrize(
    "seed", [0, 1, 3, 7, 8, 9, 11, 99, 2026, (1 << 31) + 5, -1, -(1 << 40),
             (1 << 63) - 1])
def test_keys_equal_jax(seed):
    for stream in (0, 1, 7):
        want = tuple(int(v) for v in np.asarray(js.sample_key(seed, stream)))
        assert ts.sample_key(seed, stream) == want


# Every (distribution, n, seed, stream) tests/test_stochastic.py draws.
JAX_TEST_DRAWS = [
    (("normal", {"mean": 500.0, "std": 150.0}), 64, 7, 0),
    (("normal", {"mean": 500.0, "std": 150.0}), 64, 8, 0),
    (("normal", {"mean": 500.0, "std": 150.0}), 64, 7, 1),
    (("normal", {"mean": 10.0, "std": 1e6}), 256, 0, 0),
    (("lognormal", {"mean": 1e9, "sigma": 4.0}), 256, 0, 1),
    (("point", {"value": 123}), 5, 0, 0),
    (("empirical", {"values": (100, 200, 900), "weights": (8.0, 1.0, 1.0)}),
     512, 3, 0),
    (("normal", {"mean": 500.0, "std": 200.0}), 64, 11, 0),
    (("lognormal", {"mean": float(1 << 30), "sigma": 0.5}), 64, 11, 1),
    (("normal", {"mean": 500.0, "std": 180.0}), 24, 99, 0),
    (("lognormal", {"mean": float(1 << 30), "sigma": 0.5}), 24, 99, 1),
]


@pytest.mark.parametrize("case", JAX_TEST_DRAWS,
                         ids=[f"draw{i}" for i in range(len(JAX_TEST_DRAWS))])
def test_draws_equal_jax_on_the_jax_tests_cases(case):
    (kind, kw), n, seed, stream = case
    jdist, tdist = _dist_pair(kind, **kw)
    got = _draws_equal(jdist, tdist, n, seed, stream)
    assert got.min() >= 1 and got.max() <= td.MAX_USAGE


def test_lognormal_4gib_sigma1_65536_draws_equal_jax():
    """The case that makes ``torch.special.erfinv`` and ``torch.exp`` move
    samples: mean 4 GiB, σ = 1, the sampler's largest draw."""
    jdist, tdist = _dist_pair("lognormal", mean=float(4 << 30), sigma=1.0)
    for seed, stream in ((0, 1), (11, 1)):
        _draws_equal(jdist, tdist, td._MAX_SAMPLES, seed, stream)


def _random_dist(rng):
    kind = rng.choice(["normal", "lognormal", "empirical", "point"])
    if kind == "normal":
        scale = 10.0 ** int(rng.integers(0, 10))
        return "normal", {"mean": float(rng.integers(1, 1000)) * scale,
                          "std": float(rng.uniform(0.0, 2.0)) * scale}
    if kind == "lognormal":
        return "lognormal", {"mean": float(rng.integers(1, 1 << 40)),
                             "sigma": float(rng.uniform(0.0, 4.0))}
    if kind == "point":
        return "point", {"value": int(rng.integers(1, 1 << 40))}
    k = int(rng.integers(1, 9))
    return "empirical", {
        "values": tuple(int(v) for v in rng.integers(1, 1 << 40, size=k)),
        "weights": tuple(float(w) for w in rng.uniform(0.01, 5.0, size=k)),
    }


@pytest.mark.parametrize("chunk", range(10))
def test_seeded_random_specs_draw_like_jax(chunk):
    """250 seeded random distributions (25 per chunk), two streams each."""
    rng = np.random.default_rng(9000 + chunk)
    for _ in range(25):
        kind, kw = _random_dist(rng)
        jdist, tdist = _dist_pair(kind, **kw)
        n = int(rng.choice([64, 200]))
        seed = int(rng.integers(-(1 << 62), 1 << 62))
        for stream in (0, 1):
            _draws_equal(jdist, tdist, n, seed, stream)


def _random_snapshot(rng, n):
    """tests/test_stochastic.py's adversarial little cluster (same rng
    consumption, so the same trials)."""
    alloc_cpu = rng.integers(0, 8000, size=n).astype(np.int64)
    alloc_mem = rng.integers(0, 1 << 34, size=n).astype(np.int64)
    used_cpu = rng.integers(0, 6000, size=n).astype(np.int64)
    used_mem = rng.integers(0, 1 << 33, size=n).astype(np.int64)
    if rng.random() < 0.3:
        used_mem[rng.integers(0, n)] = np.int64(1 << 35)
    alloc_pods = rng.integers(0, 30, size=n).astype(np.int64)
    pods = rng.integers(0, 40, size=n).astype(np.int64)
    healthy = rng.random(n) > 0.2
    return JaxSnapshot(
        names=[f"n{i}" for i in range(n)],
        alloc_cpu_milli=alloc_cpu, alloc_mem_bytes=alloc_mem,
        alloc_pods=alloc_pods, used_cpu_req_milli=used_cpu,
        used_cpu_lim_milli=used_cpu, used_mem_req_bytes=used_mem,
        used_mem_lim_bytes=used_mem, pods_count=pods,
        healthy=np.asarray(healthy, dtype=np.bool_), semantics="reference",
    )


def _random_spec(rng):
    """tests/test_stochastic.py's random spec generator."""
    kind = rng.choice(["normal", "lognormal", "empirical"])
    if kind == "normal":
        cpu = js.UsageDistribution(
            kind="normal", mean=float(rng.integers(50, 2000)),
            std=float(rng.integers(1, 800)))
    elif kind == "lognormal":
        cpu = js.UsageDistribution(
            kind="lognormal", mean=float(rng.integers(50, 2000)),
            sigma=float(rng.uniform(0.05, 1.0)))
    else:
        k = int(rng.integers(2, 6))
        cpu = js.UsageDistribution(
            kind="empirical",
            values=tuple(int(v) for v in rng.integers(1, 3000, size=k)),
            weights=tuple(float(w) for w in rng.uniform(0.5, 4.0, size=k)))
    mem = js.UsageDistribution(
        kind="normal", mean=float(rng.integers(1 << 20, 1 << 30)),
        std=float(rng.integers(1, 1 << 28)))
    return js.StochasticSpec(
        cpu=cpu, memory=mem, replicas=int(rng.integers(0, 200)),
        samples=int(rng.integers(2, 16)), seed=int(rng.integers(0, 1 << 16)))


def _assert_car_equal(got, want):
    assert np.array_equal(got.samples_cpu, want.samples_cpu)
    assert np.array_equal(got.samples_mem, want.samples_mem)
    assert np.array_equal(got.totals, want.totals)
    assert got.quantiles == want.quantiles
    assert got.quantile_samples == want.quantile_samples
    assert got.mean == want.mean and got.prob_fit == want.prob_fit
    assert got.bindings == want.bindings
    assert (got.mode, got.n_samples) == (want.mode, want.n_samples)


@pytest.mark.parametrize("mode", ["reference", "strict"])
def test_the_jax_tests_randomized_trials_equal_jax(mode):
    """The 110 randomized trials of the JAX package's oracle-parity test,
    per mode: the same specs, snapshots and masks; the port's
    ``capacity_at_risk`` equals the JAX one, draws included."""
    rng = np.random.default_rng(2026 if mode == "reference" else 2027)
    quantiles = (0.5, 0.9, 0.95, 0.99)
    for trial in range(110):
        n_nodes = int(rng.integers(1, 14))
        jsnap = _random_snapshot(rng, n_nodes)
        spec = _random_spec(rng)
        node_mask = None
        if rng.random() < 0.4:
            node_mask = rng.random(n_nodes) > 0.25
        want = js.capacity_at_risk(jsnap, spec, mode=mode,
                                   node_mask=node_mask, quantiles=quantiles,
                                   bindings=False)
        got = ts.capacity_at_risk(_port_snapshot(jsnap), _spec_pair(spec),
                                  mode=mode, node_mask=node_mask,
                                  quantiles=quantiles, bindings=False,
                                  device="cpu")
        _assert_car_equal(got, want)


# -- the emulated FMA --------------------------------------------------------

def test_emulated_fma_rounds_once():
    """``_fma`` equals ``RN(a·b + c)`` computed in exact rationals, on
    random operands, near-cancelling addends and products one ulp off a
    rounding midpoint."""
    rnd = random.Random(7)
    a, b, c = [], [], []
    for i in range(30_000):
        x = rnd.uniform(-1, 1) * 2.0 ** rnd.randint(-60, 60)
        y = rnd.uniform(-1, 1) * 2.0 ** rnd.randint(-60, 60)
        if i % 3 == 0:
            z = math.nextafter(-(x * y), rnd.choice([-math.inf, math.inf]))
        elif i % 3 == 1:
            z = rnd.uniform(-1, 1) * 2.0 ** rnd.randint(-120, 120)
        else:
            z = float(Fraction(x) * Fraction(y)) * (
                1 + rnd.choice([-1, 1]) * 2.0 ** -53)
        a.append(x)
        b.append(y)
        c.append(z)
    got = td._fma(torch.tensor(a, dtype=torch.float64),
                  torch.tensor(b, dtype=torch.float64),
                  torch.tensor(c, dtype=torch.float64)).tolist()
    want = [float(Fraction(x) * Fraction(y) + Fraction(z))
            for x, y, z in zip(a, b, c)]
    assert got == want


def test_plain_torch_transcendentals_would_move_samples():
    """Why the sampler replays XLA's program: ``torch.special.erfinv`` on
    the same uniforms gives other normals than ``jax.random.normal`` in
    many draws, and over 16 × 65,536 mean-4-GiB σ=1 lognormal draws some
    int64 samples move; the port's draws equal JAX's in all."""
    import jax

    lo = math.nextafter(-1.0, 0.0)
    n = td._MAX_SAMPLES
    moved = 0
    for seed in range(16):
        key = ts.sample_key(seed, 1)
        u = torch.clamp(
            td._uniform01(key, n, torch.device("cpu")) * 2.0 + lo, min=lo)
        z_naive = math.sqrt(2) * torch.special.erfinv(u)
        if seed == 0:
            z_jax = np.asarray(jax.random.normal(
                js.sample_key(seed, 1), (n,), dtype=np.float64))
            assert (z_naive.numpy() != z_jax).mean() > 0.1
        naive = torch.clamp(
            torch.round(torch.exp(math.log(4 << 30) + z_naive)),
            1.0, float(1 << 62)).to(torch.int64).numpy()
        jdist, _ = _dist_pair("lognormal", mean=float(4 << 30), sigma=1.0)
        moved += int((naive != js.sample_usage(
            jdist, n, js.sample_key(seed, 1))).sum())
    assert moved > 0


# -- capacity at risk -------------------------------------------------------

SPEC_DOC = {
    "usage": {"cpu": {"dist": "normal", "mean": "500m", "std": "200m"},
              "memory": {"dist": "lognormal", "mean": "1gb", "sigma": 0.5}},
    "replicas": 50, "samples": 64, "seed": 11,
}


@pytest.fixture(scope="module")
def fleets():
    """(jax snapshot, port snapshot) pairs: a small fleet, a degenerate one
    that takes the grouped route, and a tainted strict one."""
    out = {}
    for name, n, kw in (("small", 40, {}), ("grouped", 1280, {"shapes": 6}),
                        ("mixed", 300, {"shapes": 9})):
        jsnap = j_synthetic(n, seed=17, **kw)
        tsnap = t_synthetic(n, seed=17, **kw)
        assert all(np.array_equal(getattr(jsnap, c), getattr(tsnap, c))
                   for c in COLS)
        out[name] = (jsnap, tsnap)
    return out


@pytest.mark.parametrize("fleet", ["small", "grouped", "mixed"])
@pytest.mark.parametrize("mode", ["reference", "strict"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_capacity_at_risk_equals_jax(fleets, fleet, mode, masked, fused):
    jsnap, tsnap = fleets[fleet]
    mask = None
    if masked:
        mask = np.random.default_rng(4).random(jsnap.n_nodes) > 0.3
    want = js.capacity_at_risk(jsnap, js.parse_stochastic_spec(SPEC_DOC),
                               mode=mode, node_mask=mask, fused=fused)
    got = ts.capacity_at_risk(tsnap, ts.parse_stochastic_spec(SPEC_DOC),
                              mode=mode, node_mask=mask, fused=fused,
                              device="cpu")
    _assert_car_equal(got, want)
    assert got.to_wire() == want.to_wire()
    assert got.bindings and got.schedulable == want.schedulable


@pytest.mark.parametrize("quantiles", [(0.5,), (0.25, 0.75, 0.999)])
def test_capacity_at_risk_quantile_ladders_equal_jax(fleets, quantiles):
    jsnap, tsnap = fleets["mixed"]
    want = js.capacity_at_risk(jsnap, js.parse_stochastic_spec(SPEC_DOC),
                               quantiles=quantiles)
    got = ts.capacity_at_risk(tsnap, ts.parse_stochastic_spec(SPEC_DOC),
                              quantiles=quantiles, device="cpu")
    assert got.to_wire() == want.to_wire()


@pytest.mark.parametrize("mode", ["reference", "strict"])
def test_car_oracle_equals_jax(fleets, mode):
    jsnap, tsnap = fleets["small"]
    mask = np.random.default_rng(5).random(jsnap.n_nodes) > 0.2
    want = js.car_oracle(jsnap, js.parse_stochastic_spec(SPEC_DOC),
                         mode=mode, node_mask=mask)
    got = ts.car_oracle(tsnap, ts.parse_stochastic_spec(SPEC_DOC),
                        mode=mode, node_mask=mask)
    _assert_car_equal(got, want)
    engine = ts.capacity_at_risk(tsnap, ts.parse_stochastic_spec(SPEC_DOC),
                                 mode=mode, node_mask=mask, bindings=False,
                                 device="cpu")
    assert np.array_equal(engine.totals, got.totals)
    assert engine.quantile_samples == got.quantile_samples


def test_fit_totals_numpy_and_quantile_rule_equal_jax():
    rng = np.random.default_rng(3)
    jsnap = _random_snapshot(rng, 23)
    cpu = rng.integers(1, 3000, size=37)
    mem = rng.integers(1, 1 << 32, size=37)
    counts = rng.integers(0, 5, size=23)
    for mode in ("reference", "strict"):
        args = [getattr(jsnap, c) for c in (
            "alloc_cpu_milli", "alloc_mem_bytes", "alloc_pods",
            "used_cpu_req_milli", "used_mem_req_bytes", "pods_count",
            "healthy")] + [cpu, mem]
        assert np.array_equal(
            ts.fit_totals_numpy(*args, mode=mode, counts=counts, chunk=5),
            js.fit_totals_numpy(*args, mode=mode, counts=counts, chunk=5))
    for n in (1, 2, 10, 64, 65536):
        for q in (0.01, 0.5, 0.9, 0.95, 0.975, 0.99):
            assert ts.quantile_index(n, q) == js.quantile_index(n, q)
            assert ts.quantile_label(q) == js.quantile_label(q)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_sampler_and_car_default_device_raises_without_cuda(no_cuda,
                                                            fleets):
    _, tsnap = fleets["small"]
    spec = ts.parse_stochastic_spec(SPEC_DOC)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ts.sample_usage(spec.cpu, 8, ts.sample_key(0, 0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ts.sample_usage(spec.memory, 8, ts.sample_key(0, 1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ts.capacity_at_risk(tsnap, spec)
    # The oracle is host numpy by design, as in the JAX package.
    assert ts.car_oracle(tsnap, spec).n_samples == 64
