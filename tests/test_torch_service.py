"""The port's capacity service against the JAX package's, both on the CPU.

The same sources (the kind fixture in both semantics, a synthetic ``.npz``
checkpoint, a tainted fixture with GPU and storage columns) are served by
the JAX ``CapacityServer`` and the port's, and the same framed requests go
to both: ``ping``, ``info``, ``fit`` (each output, the cpu backend, spec
fields), ``sweep`` (explicit grid, ``random``, ``kernel=exact``),
``sweep_multi``, ``explain`` (JSON and table), the scheduler-fidelity
ops (``place``, ``drain``, ``topology_spread``, ``plan`` with a
``node_template``, ``fit`` with ``priority``, ``sweep`` with
``priorities``) on a fixture with priorities and disruption budgets,
``gang`` and ``optimize`` (on a fleet with zone/rack labels too), on a
file-backed server and on an ``update``-fed one, ``reload`` from
``.json`` and ``.npz``, a refused token and an expired deadline.  Replies must be
equal, integers and bytes exactly, apart from the kernel labels
(``plain_``/``torch_int64`` for ``pallas_``/``xla_int64``) and the
volatile fields (the JAX breaker's success counter, the seconds in a shed
message); an ``optimize`` reply's float solver artifacts may differ in
their last bits, so it is compared on the canonical digest, equal integers
and floats within a relative and absolute 1e-9
(``tests/test_torch_optimize.py`` states why).  Both client/server cross pairs are run as well.  Every op the
port does not serve yet must say so (none is left: the operator's
``dump``, ``timeline`` and ``slo`` are answered like the JAX server's).

Servers bind 127.0.0.1 on port 0, every socket and client has a timeout,
every server is shut down by its fixture, and no latency is asserted.
"""

import copy
import json
import re
import socket
import time

import numpy as np
import pytest

from kubernetesclustercapacity_tpu import snapshot as j_snapshot
from kubernetesclustercapacity_tpu.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu.service.client import (
    CapacityClient as JaxClient,
)
from kubernetesclustercapacity_tpu.service.server import (
    CapacityServer as JaxServer,
)
from kubernetesclustercapacity_tpu.sources import (
    resolve_source as j_resolve_source,
)
from kubernetesclustercapacity_tpu_torch.service import protocol
from kubernetesclustercapacity_tpu_torch.service.client import (
    CapacityClient as TorchClient,
)
from kubernetesclustercapacity_tpu_torch.service.server import (
    UNPORTED_OPS,
)
from kubernetesclustercapacity_tpu_torch.service.server import (
    CapacityServer as TorchServer,
)
from kubernetesclustercapacity_tpu_torch.sources import (
    resolve_source as t_resolve_source,
)

KIND = "tests/fixtures/kind-3node.json"
EXTENDED = ("ephemeral-storage", "nvidia.com/gpu")
TIMEOUT_S = 120.0


@pytest.fixture(autouse=True)
def fresh_jax_breaker(monkeypatch):
    """The JAX package's fused-path breaker is process-global: its lifetime
    counters (``failures``, ``rejected``, ``trips``) carry whatever an
    earlier test in the same process did to it (``tests/test_resilience.py``
    trips it on purpose).  Each test here starts from a fresh one, as a new
    server process would; ``info`` then compares every counter with the
    port's breaker, which is never used."""
    from kubernetesclustercapacity_tpu.ops import pallas_fit
    from kubernetesclustercapacity_tpu.resilience import CircuitBreaker

    monkeypatch.setattr(pallas_fit, "_breaker", CircuitBreaker(
        name="pallas_fused_sweep", failure_threshold=1,
        recovery_timeout_s=None,
        on_state_change=pallas_fit._breaker_transition))


def _gpu_fixture():
    """A tainted 64-node fixture with 0-8 GPUs and 50-500 Gi of storage
    per node, and GPU/storage requests on every third pod."""
    fx = synthetic_fixture(64, seed=31, taint_frac=0.3, unhealthy_frac=0.1)
    rng = np.random.default_rng(32)
    for node in fx["nodes"]:
        node["allocatable"]["nvidia.com/gpu"] = str(rng.integers(0, 9))
        node["allocatable"]["ephemeral-storage"] = \
            f"{rng.integers(50, 501)}Gi"
    for pod in fx["pods"][::3]:
        pod["containers"] = [{"resources": {"requests": {
            "cpu": "250m", "memory": "256Mi",
            "nvidia.com/gpu": str(rng.integers(0, 3)),
            "ephemeral-storage": f"{rng.integers(1, 20)}Gi",
        }}}]
    return fx


APPS = [f"app-{i}" for i in range(8)]


def _sched_fixture():
    """A tainted 48-node fixture whose pods carry a priority from {0,
    1000, 100000} and an ``app`` label, with 12 PDBs over the labels
    (zero allowances, slack, and pods covered twice)."""
    fx = synthetic_fixture(48, seed=41, taint_frac=0.1, unhealthy_frac=0.05)
    rng = np.random.default_rng(42)
    for pod in fx["pods"]:
        pod["priority"] = int(rng.choice([0, 1000, 100000]))
        pod["labels"] = {"app": str(rng.choice(APPS))}
    namespaces = sorted({p.get("namespace", "") for p in fx["pods"]})
    fx["pdbs"] = [
        {"name": f"pdb-{k}", "namespace": namespaces[k % len(namespaces)],
         "selector": {"matchLabels": {"app": APPS[k % len(APPS)]}},
         ("minAvailable", "maxUnavailable", "minAvailable")[k % 3]:
             ("100%", 1, 1)[k % 3]}
        for k in range(12)
    ]
    return fx


def _busiest(fx) -> str:
    counts = {}
    for p in fx["pods"]:
        if p.get("nodeName") and p.get("phase") not in ("Succeeded",
                                                        "Failed"):
            counts[p["nodeName"]] = counts.get(p["nodeName"], 0) + 1
    return min(counts, key=lambda n: (-counts[n], n))


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("service")
    npz = str(d / "synthetic.npz")
    j_snapshot.synthetic_snapshot(64, seed=11).save(npz)
    gpu = str(d / "gpu.json")
    with open(gpu, "w") as f:
        json.dump(_gpu_fixture(), f)
    tainted = str(d / "tainted.json")
    with open(tainted, "w") as f:
        json.dump(synthetic_fixture(48, seed=12, taint_frac=0.4), f)
    sched = str(d / "sched.json")
    with open(sched, "w") as f:
        json.dump(_sched_fixture(), f)
    return {"kind": KIND, "npz": npz, "gpu": gpu, "tainted": tainted,
            "sched": sched}


# name -> (path key, semantics, extended columns)
SOURCES = {
    "kind-reference": ("kind", "reference", ()),
    "kind-strict": ("kind", "strict", ()),
    "synthetic-npz": ("npz", None, ()),
    "gpu-strict": ("gpu", "strict", EXTENDED),
    "sched-strict": ("sched", "strict", ()),
}


def _pair(path, semantics, extended, **kw):
    jf, js, _ = j_resolve_source(path, semantics,
                                 extended_resources=extended)
    tf, ts, _ = t_resolve_source(path, semantics,
                                 extended_resources=extended)
    j = JaxServer(js, fixture=jf, **kw)
    t = TorchServer(ts, fixture=tf, device="cpu", **kw)
    j.start()
    t.start()
    return j, t


def _stop(*servers):
    for s in servers:
        s.shutdown()


@pytest.fixture(scope="module")
def pairs(paths):
    out = {}
    try:
        for name, (key, semantics, extended) in SOURCES.items():
            out[name] = _pair(paths[key], semantics, extended,
                              batch_window_ms=0)
        yield out
    finally:
        _stop(*(s for pair in out.values() for s in pair))


def _raw(address, msg):
    with socket.create_connection(address, timeout=TIMEOUT_S) as sock:
        sock.settimeout(TIMEOUT_S)
        protocol.send_msg(sock, msg)
        return protocol.recv_msg(sock)


def _relabel(kernel: str) -> str:
    return kernel.replace("pallas_", "plain_").replace(
        "xla_int64", "torch_int64"
    )


def _norm(reply):
    """The reply with its kernel labels in the port's names and its
    volatile fields fixed."""
    reply = copy.deepcopy(reply)
    res = reply.get("result") if isinstance(reply, dict) else None
    if isinstance(res, dict):
        if isinstance(res.get("kernel"), str):
            res["kernel"] = _relabel(res["kernel"])
        breaker = res.get("resilience", {}).get("fast_path_breaker")
        if breaker is not None:
            breaker["successes"] = None  # the JAX breaker counts launches
    if isinstance(reply, dict) and isinstance(reply.get("error"), str):
        reply["error"] = re.sub(r"expired [0-9.]+s ago", "expired Ns ago",
                                reply["error"])
    return reply


def _both(pair, msg):
    j, t = pair
    return _raw(j.address, msg), _raw(t.address, msg)


FIT = {"op": "fit", "cpuRequests": "200m", "memRequests": "250mb",
       "replicas": "10"}
REQUESTS = {
    "ping": {"op": "ping"},
    "info": {"op": "info"},
    "info-sections": {"op": "info", "plane": True, "tenancy": True,
                      "audit": True, "tracing": True},
    "fit-reference": dict(FIT),
    "fit-json": dict(FIT, output="json"),
    "fit-table": dict(FIT, output="table"),
    "fit-backend-cpu": dict(FIT, backend="cpu"),
    "fit-backend-cpu-json": dict(FIT, backend="cpu", output="json"),
    "fit-backend-tpu": dict(FIT, backend="tpu"),
    "fit-spread": dict(FIT, spread="2", output="json"),
    "fit-big": {"op": "fit", "cpuRequests": "2", "memRequests": "4gb",
                "replicas": "3", "output": "table"},
    "fit-bad-memory": dict(FIT, memRequests="lots"),
    "sweep-grid": {"op": "sweep", "cpu_request_milli": [100, 250, 1500],
                   "mem_request_bytes": [64 << 20, 512 << 20, 3 << 30],
                   "replicas": [1, 20, 400]},
    "sweep-random": {"op": "sweep", "random": {"n": 24, "seed": 5}},
    "sweep-exact": {"op": "sweep", "random": {"n": 24, "seed": 6},
                    "kernel": "exact"},
    "sweep-unaligned": {"op": "sweep", "cpu_request_milli": [333, 77],
                        "mem_request_bytes": [100_000_001, 12_345],
                        "replicas": [2, 3]},
    "sweep-bad-kernel": {"op": "sweep", "random": {"n": 2},
                         "kernel": "fast"},
    "explain": {"op": "explain", "cpuRequests": "300m",
                "memRequests": "500mb", "replicas": "7"},
    "explain-json": {"op": "explain", "cpuRequests": "300m",
                     "memRequests": "500mb", "output": "json"},
    "explain-table": {"op": "explain", "cpuRequests": "1",
                      "memRequests": "1gb", "output": "table"},
    "unknown-op": {"op": "frobnicate"},
}
GPU_REQUESTS = {
    "sweep-multi": {"op": "sweep_multi",
                    "resources": ["cpu", "memory", "nvidia.com/gpu",
                                  "ephemeral-storage"],
                    "requests": [[250, 256 << 20, 1, 10 << 30],
                                 [500, 1 << 30, 0, 1 << 30],
                                 [100, 128 << 20, 2, 20 << 30]],
                    "replicas": [5, 50, 1]},
    "sweep-multi-exact": {"op": "sweep_multi",
                          "resources": ["cpu", "memory", "nvidia.com/gpu"],
                          "requests": [[250, 256 << 20, 1]],
                          "kernel": "exact"},
    "sweep-multi-bad-column": {"op": "sweep_multi",
                               "resources": ["cpu", "example.com/fpga"],
                               "requests": [[250, 1]]},
    "fit-extended": dict(FIT, extended_requests={"nvidia.com/gpu": 1},
                         output="json"),
    "fit-tolerations": dict(FIT, tolerations=[
        {"key": "dedicated", "operator": "Exists", "effect": "NoSchedule"}
    ], output="json"),
    "fit-node-selector": dict(FIT, node_selector={"no-such": "label"}),
}

CASES = [(src, name) for src in SOURCES if src != "sched-strict"
         for name in REQUESTS] + [
    ("gpu-strict", name) for name in GPU_REQUESTS
]


@pytest.mark.parametrize("source,name", CASES)
def test_reply_matches_the_jax_server(source, name, pairs):
    msg = {**REQUESTS, **GPU_REQUESTS}[name]
    j_reply, t_reply = _both(pairs[source], msg)
    assert _norm(t_reply) == _norm(j_reply)
    assert t_reply["ok"] is (not name.endswith(("bad-memory", "bad-kernel",
                                                 "bad-column", "unknown-op")))
    if name.startswith(("sweep", "fit", "explain")) and t_reply["ok"]:
        res = t_reply["result"]
        for key in ("totals", "fits", "total"):
            if key in res:
                values = res[key] if isinstance(res[key], list) else [
                    res[key]]
                assert all(type(v) is int for v in values)


def test_the_comparison_is_not_vacuous(pairs):
    """The sweeps took the kernel route on both sides, the fits carry
    transcripts, and the strict sources are really masked."""
    j, t = _both(pairs["kind-reference"], REQUESTS["sweep-random"])
    assert j["result"]["kernel"] == "pallas_i32_rcp_fused"
    assert t["result"]["kernel"] == "plain_i32_rcp_fused"
    assert sum(t["result"]["totals"]) > 0
    _, t = _both(pairs["kind-reference"], REQUESTS["fit-reference"])
    assert "Total possible replicas" in t["result"]["report"]
    _, t = _both(pairs["gpu-strict"], GPU_REQUESTS["sweep-multi"])
    assert t["result"]["kernel"] == "plain_multi_i32_rcp_fused"
    _, t = _both(pairs["synthetic-npz"], REQUESTS["sweep-unaligned"])
    assert t["result"]["kernel"] == "torch_int64"


@pytest.mark.parametrize("op", sorted(UNPORTED_OPS))
def test_unported_ops_say_so(op, pairs):
    msg = {"op": op}
    error = (f"NotImplementedError: op {op!r} is not yet ported to "
             "the PyTorch package")
    _, t = _both(pairs["kind-reference"], msg)
    assert t == {"ok": False, "error": error, "generation": 1}


# The operator's ops, which replaced the last "not yet ported" cases:
# ``dump`` (the flight recorder), ``timeline`` and ``slo`` on servers
# configured with neither, and the watch-status forms.  A server with a
# timeline and SLOs is compared in tests/test_torch_timeline.py and
# tests/test_torch_slo.py.
OPERATOR_REQUESTS = {
    "dump": {"op": "dump"},
    "dump-limit-op": {"op": "dump", "filter_op": "sweep", "limit": 1},
    "dump-bad-limit": {"op": "dump", "limit": 0},
    "timeline": {"op": "timeline"},
    "timeline-since": {"op": "timeline", "since_generation": 1},
    "slo": {"op": "slo"},
    "car-status": {"op": "car"},
    "forecast-status": {"op": "forecast"},
    "gang-status": {"op": "gang"},
}


@pytest.mark.parametrize("name", sorted(OPERATOR_REQUESTS))
def test_operator_ops_match_the_jax_server(name):
    pair = _pair(KIND, "reference", (), batch_window_ms=0)
    try:
        for msg in (REQUESTS["sweep-random"], REQUESTS["fit-reference"],
                    REQUESTS["fit-bad-memory"]):
            _both(pair, msg)
        j, t = _both(pair, OPERATOR_REQUESTS[name])
    finally:
        _stop(*pair)
    for reply in (j, t):
        for rec in (reply.get("result") or {}).get("records", []):
            for key in ("ts", "latency_ms", "phases", "result_digest"):
                rec.pop(key)
    assert t == j
    assert t["ok"] is (name != "dump-bad-limit")
    if name == "dump":
        assert [r["op"] for r in t["result"]["records"]] == [
            "sweep", "fit", "fit"]


# The stochastic ops: ``car``, ``forecast`` and the catalog form of
# ``plan``, with their reports, status forms and bad requests.
USAGE = {"cpu": {"dist": "normal", "mean": "200m", "std": "80m"},
         "memory": {"dist": "lognormal", "mean": "250mb", "sigma": 0.6}}
CAR = {"op": "car", "usage": USAGE, "replicas": 30, "samples": 64,
       "seed": 5}
FORECAST = {"op": "forecast", "usage": USAGE, "replicas": 30,
            "samples": 48, "seed": 8, "steps": 6, "step_s": 600,
            "growth": {"cpu_per_s": 2e-4, "memory_per_s": 1e-5}}
SHAPES = [
    {"name": "m5.xlarge", "cpu": "4", "memory": "16gb", "pods": 58,
     "unit_cost": 4},
    {"name": "m5.2xlarge", "cpu": "8", "memory": "32gb", "pods": 58,
     "unit_cost": 8},
    {"name": "c5.4xlarge", "cpu": "16", "memory": "32gb", "pods": 234,
     "unit_cost": 16, "max_count": 5},
]
PLAN = {"op": "plan", "usage": USAGE, "replicas": 30, "samples": 32,
        "seed": 2, "catalog": SHAPES, "target": 400}
STOCHASTIC_REQUESTS = {
    "car": CAR,
    "car-quantiles": dict(CAR, quantiles=[0.5, 0.975]),
    "car-table": dict(CAR, output="table"),
    "car-json": dict(CAR, output="json", confidence=0.5),
    "car-point": dict(CAR, usage={"cpu": "300m", "memory": "1gb"}),
    "car-status": {"op": "car"},
    "car-bad-dist": dict(CAR, usage={"cpu": {"dist": "gauss"},
                                     "memory": "1gb"}),
    "car-bad-quantiles": dict(CAR, quantiles=[0.5, 1.5]),
    "car-empty-quantiles": dict(CAR, quantiles=[]),
    "car-bad-samples": dict(CAR, samples=1),
    "forecast": FORECAST,
    "forecast-threshold": dict(FORECAST, threshold=1500, output="table"),
    "forecast-json": dict(FORECAST, output="json",
                          quantiles=[0.5, 0.8]),
    "forecast-defaults": {"op": "forecast", "usage": USAGE,
                          "samples": 8},
    "forecast-status": {"op": "forecast"},
    "forecast-bad-growth": dict(FORECAST, growth={"gpu_per_s": 1}),
    "forecast-bad-growth-type": dict(FORECAST, growth=[1]),
    "forecast-bad-rate": dict(FORECAST, growth={"cpu_per_s": "fast"}),
    "forecast-bad-steps": dict(FORECAST, steps="6"),
    "forecast-bad-step-s": dict(FORECAST, step_s=True),
    "forecast-too-many-steps": dict(FORECAST, steps=100_000),
    "forecast-bad-threshold": dict(FORECAST, threshold=1.5),
    "plan-catalog": PLAN,
    "plan-catalog-drain": dict(PLAN, drain=True, output="table"),
    "plan-catalog-json": dict(PLAN, output="json", quantile=0.9,
                              target=150),
    "plan-catalog-unsatisfiable": dict(PLAN, target=10 ** 7),
    "plan-catalog-holds": dict(PLAN, target=1, drain=True),
    "plan-catalog-no-usage": {"op": "plan", "catalog": SHAPES},
    "plan-catalog-bad-catalog": dict(PLAN, catalog=[{"name": "x"}]),
    "plan-catalog-bad-target": dict(PLAN, target="400"),
    "plan-catalog-bad-quantile": dict(PLAN, quantile="p95"),
    "plan-catalog-bad-drain": dict(PLAN, drain="yes"),
    "plan-catalog-out-of-range": dict(PLAN, quantile=1.0),
}
STOCHASTIC_FAILS = ("bad", "empty-quantiles", "too-many-steps", "no-usage",
                    "out-of-range")
STOCHASTIC_CASES = [
    (src, name) for src in ("kind-reference", "kind-strict",
                            "synthetic-npz", "gpu-strict")
    for name in STOCHASTIC_REQUESTS
]


@pytest.mark.parametrize("source,name", STOCHASTIC_CASES)
def test_stochastic_reply_matches_the_jax_server(source, name, pairs):
    msg = STOCHASTIC_REQUESTS[name]
    j_reply, t_reply = _both(pairs[source], msg)
    assert t_reply == j_reply
    assert t_reply["ok"] is (not any(f in name for f in STOCHASTIC_FAILS)), \
        t_reply
    res = t_reply.get("result")
    if name.endswith("-status"):
        assert res == {"enabled": False, "watches": {}, "breached": []}
    elif t_reply["ok"] and name.startswith("car"):
        assert res["samples"] == msg.get("samples") and res["quantiles"]
    elif t_reply["ok"] and name.startswith("forecast"):
        assert len(next(iter(res["quantiles"].values()))) == msg.get(
            "steps", 16)
    if name == "plan-catalog-unsatisfiable":
        assert res["status"] == "uncertified"
    elif name.startswith("plan") and t_reply["ok"]:
        assert res["status"] == "certified"


def test_stochastic_comparison_is_not_vacuous(pairs):
    """The plan buys nodes, the forecast breaches, the strict CaR is
    masked (a taint-masked fleet reports less than its unmasked twin)."""
    _, t = _both(pairs["kind-reference"], STOCHASTIC_REQUESTS["plan-catalog"])
    assert t["result"]["buy"] and t["result"]["nodes_bought"] > 0
    _, t = _both(pairs["gpu-strict"], STOCHASTIC_REQUESTS[
        "forecast-threshold"])
    ttb = t["result"]["time_to_breach_s"]
    assert t["result"]["breached_within_horizon"] and ttb["p95"] > 0.0
    assert "capacity forecast" in t["result"]["report"]
    _, t = _both(pairs["kind-strict"], STOCHASTIC_REQUESTS["car-table"])
    assert "capacity at risk (strict semantics" in t["result"]["report"]


def test_stochastic_ops_are_ported():
    assert {"car", "forecast", "plan"}.isdisjoint(UNPORTED_OPS)


@pytest.mark.parametrize("name", ["car", "forecast", "plan-catalog",
                                  "car-status"])
def test_stochastic_cross_clients_and_servers(name, pairs):
    j, t = pairs["synthetic-npz"]
    msg = STOCHASTIC_REQUESTS[name]
    jax_to_port = _call(JaxClient, t, msg)
    port_to_jax = _call(TorchClient, j, msg)
    assert jax_to_port == port_to_jax == _call(JaxClient, j, msg)


# The scheduler-fidelity ops and the priority forms of fit and sweep.
# ``NODE`` stands for the fixture's busiest node.
PLACE = {"op": "place", "cpuRequests": "500m", "memRequests": "512mb",
         "replicas": "40"}
M5_XLARGE = {"allocatable": {"cpu": "4", "memory": "16Gi", "pods": "58"}}
SCHED_REQUESTS = {
    "place-first-fit": dict(PLACE),
    "place-best-fit": dict(PLACE, policy="best-fit"),
    "place-spread": dict(PLACE, policy="spread", spread="2"),
    "place-counts": dict(PLACE, replicas="300", assignments=False),
    "place-priority": dict(PLACE, policy="best-fit", priority=1000),
    "place-selector": dict(PLACE, node_selector={"zone": "zone-1"}),
    "place-bad-assignments": dict(PLACE, assignments="yes"),
    "place-bad-policy": dict(PLACE, policy="worst-fit"),
    "drain-best-fit": {"op": "drain", "node": "NODE"},
    "drain-first-fit": {"op": "drain", "node": "NODE",
                        "policy": "first-fit"},
    "drain-spread": {"op": "drain", "node": "NODE", "policy": "spread"},
    "drain-unknown": {"op": "drain", "node": "no-such-node"},
    "drain-no-node": {"op": "drain"},
    "spread-zone": {"op": "topology_spread", "topology_key": "zone",
                    "cpuRequests": "500m", "memRequests": "512mb",
                    "replicas": "200"},
    "spread-honor": {"op": "topology_spread", "topology_key": "zone",
                     "max_skew": 2, "node_taints_policy": "honor",
                     "cpuRequests": "250m", "memRequests": "1gb",
                     "priority": 1000},
    "spread-grid": {"op": "topology_spread", "topology_key": "zone",
                    "cpu_request_milli": [100, 250, 1500],
                    "mem_request_bytes": [64 << 20, 512 << 20, 3 << 30],
                    "replicas": [1, 200, 40]},
    "spread-no-key": {"op": "topology_spread"},
    "plan": {"op": "plan", "node_template": M5_XLARGE,
             "cpuRequests": "500m", "memRequests": "512mb",
             "replicas": "5000"},
    "plan-fits": {"op": "plan", "node_template": M5_XLARGE,
                  "replicas": "3"},
    "plan-tainted-template": {
        "op": "plan", "replicas": "5000",
        "node_template": dict(M5_XLARGE, taints=[
            {"key": "dedicated", "value": "gpu", "effect": "NoSchedule"}])},
    "plan-priority": {"op": "plan", "node_template": M5_XLARGE,
                      "replicas": "5000", "priority": 100000},
    "plan-no-template": {"op": "plan", "replicas": "3"},
    "fit-priority": dict(FIT, priority=100),
    "fit-priority-json": dict(FIT, priority=1000, output="json"),
    "sweep-priorities": {"op": "sweep", "random": {"n": 4},
                         "priorities": [0, 1, 2, 3]},
    "sweep-priorities-grid": {"op": "sweep", "random": {"n": 48, "seed": 3},
                              "priorities": [0, 1000, 100000, 5] * 12},
    "sweep-priorities-bad-shape": {"op": "sweep", "random": {"n": 4},
                                   "priorities": [0, 1]},
}
SCHED_SOURCES = ("sched-strict", "kind-strict", "kind-reference",
                 "synthetic-npz")
SCHED_FAILS = {
    "place-bad-assignments", "place-bad-policy", "drain-unknown",
    "drain-no-node", "spread-no-key", "plan-no-template",
    "sweep-priorities-bad-shape",
}


def _sched_msg(name, source, paths):
    msg = copy.deepcopy(SCHED_REQUESTS[name])
    if msg.get("node") == "NODE":
        with open(paths[SOURCES[source][0]]) as f:
            msg["node"] = _busiest(json.load(f))
    return msg


@pytest.mark.parametrize("name", sorted(SCHED_REQUESTS))
@pytest.mark.parametrize("source", SCHED_SOURCES)
def test_scheduling_reply_matches_the_jax_server(source, name, pairs,
                                                 paths):
    if source == "synthetic-npz" and SCHED_REQUESTS[name].get(
            "node") == "NODE":
        # An .npz source has no fixture: drain is refused on both sides.
        msg = {"op": "drain", "node": "node-00001"}
    else:
        msg = _sched_msg(name, source, paths)
    j_reply, t_reply = _both(pairs[source], msg)
    assert _norm(t_reply) == _norm(j_reply)
    if source == "sched-strict":
        assert t_reply["ok"] is (name not in SCHED_FAILS), t_reply
    if source == "sched-strict" and t_reply["ok"]:
        res = t_reply["result"]
        if name.startswith("drain"):
            assert res["pods"] and res["blocked"] and not res["evictable"]
        if name.startswith("place") and res["assignments"] is not None:
            assert res["placed"] > 0


def test_scheduling_ops_are_ported():
    assert {"place", "drain", "topology_spread", "plan"}.isdisjoint(
        UNPORTED_OPS)


def test_update_fed_server_matches_jax(paths):
    """A strict server fed by ``update``: the store's fixture is dirty
    after each batch and is rematerialized for drain and the priority ops
    (pairing pods to snapshot rows by node name); every reply equals the
    JAX server's after each batch."""
    with open(paths["sched"]) as f:
        fx = json.load(f)
    node = _busiest(fx)
    j, t = _pair(paths["sched"], "strict", (), batch_window_ms=0)
    batches = [
        [{"type": "ADDED", "kind": "Pod", "object": {
            "name": "urgent-0", "namespace": "default", "nodeName": node,
            "phase": "Running", "priority": 100000,
            "labels": {"app": "app-0"}, "containers": [{"resources": {
                "requests": {"cpu": "1500m", "memory": "2Gi"}}}]}},
         {"type": "DELETED", "kind": "Pod", "object": {
             "name": fx["pods"][0]["name"],
             "namespace": fx["pods"][0]["namespace"]}}],
        [{"type": "ADDED", "kind": "Node", "object": {
            "name": "node-new", "allocatable": {
                "cpu": "16", "memory": "64Gi", "pods": "110"},
            "conditions": [{"type": "Ready", "status": "True"}],
            "labels": {"zone": "zone-9"}}},
         {"type": "ADDED", "kind": "Pod", "object": {
             "name": "batch-1", "namespace": "default",
             "nodeName": "node-new", "phase": "Running", "priority": 0,
             "labels": {"app": "app-3"}, "containers": [{"resources": {
                 "requests": {"cpu": "4", "memory": "8Gi"}}}]}}],
    ]
    names = ("drain-best-fit", "sweep-priorities-grid", "fit-priority-json",
             "place-priority", "spread-honor", "plan-priority",
             "place-spread", "spread-grid")
    try:
        for events in batches:
            j_reply, t_reply = _both((j, t), {"op": "update",
                                              "events": events})
            assert t_reply["ok"] and _norm(t_reply) == _norm(j_reply)
            assert t._fixture_dirty
            for name in names:
                msg = copy.deepcopy(SCHED_REQUESTS[name])
                if msg.get("node") == "NODE":
                    msg["node"] = node
                j_reply, t_reply = _both((j, t), msg)
                assert t_reply["ok"], (name, t_reply)
                assert _norm(t_reply) == _norm(j_reply), name
                if name == "drain-best-fit":
                    # The drain saw the batch: the fixture was rebuilt.
                    assert "default/urgent-0" in t_reply["result"]["pods"]
            assert not t._fixture_dirty
    finally:
        _stop(j, t)


def test_expired_deadline_is_shed_like_jax(pairs):
    msg = {"op": "sweep", "random": {"n": 4}, "deadline": time.time() - 5}
    j, t = _both(pairs["kind-reference"], msg)
    assert not t["ok"] and t["error"].startswith("DeadlineExpired: ")
    assert _norm(t) == _norm(j)
    info_j, info_t = _both(pairs["kind-reference"], {"op": "info"})
    shed = info_t["result"]["resilience"]["deadline_shed"]
    assert shed == info_j["result"]["resilience"]["deadline_shed"] >= 1


def test_auth_token_is_enforced_like_jax():
    j, t = _pair(KIND, None, (), batch_window_ms=0, auth_token="s3cret")
    try:
        for msg in ({"op": "ping"}, dict(FIT), dict(FIT, token="wrong"),
                    dict(FIT, token="s3cret"), {"op": "info"},
                    {"op": "reload", "path": KIND}):
            j_reply, t_reply = _both((j, t), msg)
            assert _norm(t_reply) == _norm(j_reply), msg
        refused = _raw(t.address, dict(FIT))
        assert refused["error"] == ("PermissionError: missing or invalid "
                                    "auth token")
    finally:
        _stop(j, t)


@pytest.mark.parametrize("target", ["npz", "tainted"])
def test_reload_matches_jax(target, paths):
    j, t = _pair(KIND, None, (), batch_window_ms=0)
    try:
        msg = {"op": "reload", "path": paths[target]}
        if target == "tainted":
            msg["semantics"] = "strict"
        j_reply, t_reply = _both((j, t), msg)
        assert _norm(t_reply) == _norm(j_reply)
        # The reload answered from generation 1 and published 2.
        assert t_reply["ok"] and t_reply["generation"] == 1
        for follow in (REQUESTS["info"], REQUESTS["sweep-random"],
                       REQUESTS["fit-json"], REQUESTS["explain-json"]):
            j_reply, t_reply = _both((j, t), follow)
            assert _norm(t_reply) == _norm(j_reply)
            assert t_reply["generation"] == 2
    finally:
        _stop(j, t)


def test_reload_roots_refuse_like_jax(paths, tmp_path):
    j, t = _pair(KIND, None, (), batch_window_ms=0,
                 reload_roots=(str(tmp_path),))
    try:
        j_reply, t_reply = _both((j, t), {"op": "reload",
                                          "path": paths["npz"]})
        assert _norm(t_reply) == _norm(j_reply)
        assert t_reply["error"].startswith("PermissionError: reload path")
    finally:
        _stop(j, t)


def test_drain_server_matches_jax():
    j, t = _pair(KIND, None, (), batch_window_ms=0)
    try:
        j_reply, t_reply = _both((j, t), {"op": "drain_server",
                                          "reason": "test"})
        for reply in (j_reply, t_reply):
            reply["result"]["ts"] = reply["result"]["waited_s"] = None
        assert t_reply == j_reply
        assert t_reply["result"]["drained"] is True
        j_reply, t_reply = _both((j, t), dict(FIT))
        assert t_reply == j_reply
        assert t_reply["code"] == "draining"
        j_reply, t_reply = _both((j, t), {"op": "info"})
        assert t_reply["result"]["draining"] is True
        assert _norm(t_reply) == _norm(j_reply)
    finally:
        _stop(j, t)


CROSS = ["info", "fit-json", "fit-backend-cpu", "sweep-grid",
         "sweep-random", "sweep-exact", "explain-json", "explain-table"]


def _call(client_cls, server, msg):
    params = {k: v for k, v in msg.items() if k != "op"}
    with client_cls(*server.address, connect_timeout_s=TIMEOUT_S,
                    timeout_s=TIMEOUT_S, retry=None) as client:
        return {"ok": True, "result": client.call(msg["op"], **params)}


@pytest.mark.parametrize("name", CROSS)
def test_cross_clients_and_servers(name, pairs):
    j, t = pairs["kind-strict"]
    msg = REQUESTS[name]
    jax_to_port = _call(JaxClient, t, msg)
    port_to_port = _call(TorchClient, t, msg)
    port_to_jax = _call(TorchClient, j, msg)
    jax_to_jax = _call(JaxClient, j, msg)
    assert jax_to_port == port_to_port
    assert port_to_jax == jax_to_jax
    assert _norm(jax_to_port) == _norm(jax_to_jax)


def test_cross_client_errors_are_the_same_type(pairs):
    j, t = pairs["kind-reference"]
    raised = []
    for client_cls, server in ((JaxClient, t), (TorchClient, j)):
        with client_cls(*server.address, timeout_s=TIMEOUT_S,
                        retry=None) as client:
            with pytest.raises(RuntimeError) as info:
                client.call("fit", memRequests="lots")
            raised.append(str(info.value))
    assert raised[0] == raised[1]


def test_default_device_raises_without_cuda(monkeypatch):
    import torch

    from kubernetesclustercapacity_tpu_torch.snapshot import (
        synthetic_snapshot,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchServer(synthetic_snapshot(8, seed=1))


def test_server_main_rejects_unported_flags_with_exit_1(capsys):
    """No server flag is left unported: -profile-hz, the last, parses as
    the JAX server's does and a command line using it runs as the JAX
    server's (here both stop at a missing snapshot, before the profiler
    starts; the served profiler is driven in tests/test_torch_profiler.py).
    """
    from kubernetesclustercapacity_tpu.service import server as j_server
    from kubernetesclustercapacity_tpu_torch.service import server

    assert [f for f, _ in server._UNPORTED_SERVER_FLAGS] == []
    argv = ["-snapshot", "missing.json", "-profile-hz", "5"]
    rc = server.main(argv)
    err = capsys.readouterr().err
    assert rc == j_server.main(argv) == 1
    assert err == capsys.readouterr().err
    assert "not yet ported" not in err
    assert server.build_parser().parse_args(argv[2:]).profile_hz == 5.0


def test_live_cluster_surfaces_are_ported(tmp_path):
    """``update`` is answered (not "not yet ported") exactly as the JAX
    server answers it, and -follow, -kubeconfig and -coalesce-ms are real
    flags of the port's server."""
    from kubernetesclustercapacity_tpu_torch.service import server

    assert "update" not in UNPORTED_OPS
    assert {"-follow", "-kubeconfig", "-coalesce-ms"}.isdisjoint(
        f for f, _ in server._UNPORTED_SERVER_FLAGS)
    args = server.build_parser().parse_args(
        ["-follow", "-kubeconfig", "kc", "-coalesce-ms", "5"])
    assert (args.follow, args.kubeconfig, args.coalesce_ms) == (True, "kc", 5)
    j, t = _pair(KIND, "reference", (), batch_window_ms=0)
    try:
        node = json.load(open(KIND))["nodes"][0]["name"]
        msg = {"op": "update", "events": [{
            "type": "ADDED", "kind": "Pod", "object": {
                "name": "new", "namespace": "default", "nodeName": node,
                "phase": "Running", "containers": [{"resources": {
                    "requests": {"cpu": "1", "memory": "1Gi"}}}]}}]}
        for request in (msg, REQUESTS["sweep-random"], REQUESTS["info"]):
            j_reply, t_reply = _both((j, t), request)
            assert t_reply["ok"] and _norm(t_reply) == _norm(j_reply)
    finally:
        _stop(j, t)


def test_server_main_knows_every_jax_server_flag():
    """Every flag of the JAX server's ``main`` is known to the port's
    parser (the lesson of the CLI's fault C1)."""
    import inspect

    from kubernetesclustercapacity_tpu.service import server as j_server
    from kubernetesclustercapacity_tpu_torch.service import server

    src = inspect.getsource(j_server.main)
    jax_flags = set(re.findall(r'p\.add_argument\(\s*"(-[a-z-]+)"', src))
    assert len(jax_flags) >= 45
    known = {o for a in server.build_parser()._actions
             for o in a.option_strings}
    assert sorted(jax_flags - known) == []


def test_trace_log_and_flight_dump(tmp_path):
    from kubernetesclustercapacity_tpu_torch.snapshot import (
        synthetic_snapshot,
    )

    trace = tmp_path / "trace.jsonl"
    dump = tmp_path / "flight.jsonl"
    server = TorchServer(synthetic_snapshot(32, seed=3), device="cpu",
                         batch_window_ms=0, trace_log=str(trace),
                         flight_dump_path=str(dump))
    try:
        server.start()
        ok = _raw(server.address, {"op": "sweep", "random": {"n": 3},
                                   "trace_id": "ab" * 16})
        bad = _raw(server.address, dict(FIT, memRequests="lots"))
    finally:
        server.shutdown()
    assert ok["ok"] and not bad["ok"]
    spans = [json.loads(line) for line in trace.read_text().splitlines()]
    request = [s for s in spans if s.get("op") == "sweep"]
    assert request and request[0]["trace_id"] == "ab" * 16
    assert request[0]["status"] == "ok"
    assert any(s.get("op", "").startswith("phase:") for s in spans)
    header, *records = [json.loads(line)
                        for line in dump.read_text().splitlines()]
    assert header["flight_dump"] is True and header["records"] == 2
    assert [r["op"] for r in records] == ["sweep", "fit"]
    assert records[-1]["status"] == "error"
    assert server.tracing_stats()["armed"] is True


def test_server_main_serves_until_drained(tmp_path):
    import threading

    from kubernetesclustercapacity_tpu_torch.service import server

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    token = tmp_path / "token"
    token.write_text("s3cret\n")
    result = {}
    thread = threading.Thread(target=lambda: result.update(rc=server.main([
        "-snapshot", KIND, "-port", str(port), "-device", "cpu",
        "-auth-token-file", str(token), "-batch-window-ms", "0",
        "-node-bucket-floor", "64",
    ])))
    thread.start()
    deadline = time.time() + TIMEOUT_S
    while True:
        try:
            reply = _raw(("127.0.0.1", port), {"op": "ping"})
            break
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.05)
    assert reply["result"] == "pong"
    sweep = _raw(("127.0.0.1", port), {"op": "sweep", "token": "s3cret",
                                       "random": {"n": 4}})
    assert sweep["ok"] and sweep["result"]["kernel"] == "plain_i32_rcp_fused"
    drained = _raw(("127.0.0.1", port), {"op": "drain_server",
                                         "token": "s3cret"})
    assert drained["result"]["drained"] is True
    thread.join(timeout=TIMEOUT_S)
    assert not thread.is_alive()
    assert result == {"rc": 0}


# Gang capacity and the optimizer.  A strict and a reference server on a
# fleet labelled with a zone/rack hierarchy, beside the kind fixture and
# the .npz checkpoint (no topology labels: every node its own domain).

@pytest.fixture(scope="module")
def gang_pairs(tmp_path_factory):
    d = tmp_path_factory.mktemp("gang")
    fleet = str(d / "fleet.json")
    with open(fleet, "w") as f:
        json.dump(synthetic_fixture(150, seed=23, topology=(3, 2),
                                    taint_frac=0.2), f)
    out = {}
    try:
        for semantics in ("strict", "reference"):
            out[f"fleet-{semantics}"] = _pair(fleet, semantics, (),
                                              batch_window_ms=0)
        yield out
    finally:
        _stop(*(s for pair in out.values() for s in pair))


GANG = {"op": "gang", "ranks": 8, "cpuRequests": "500m",
        "memRequests": "1gb"}
OPTIMIZE = {"op": "optimize", "cpu_request_milli": [500, 100, 2000],
            "mem_request_bytes": [512 << 20, 64 << 20, 4 << 30],
            "replicas": [10**6, 10, 40]}
GANG_OPT_REQUESTS = {
    "gang-rack": dict(GANG, colocate="rack", count=2),
    "gang-spread": dict(GANG, ranks="16", colocate="zone",
                        spread_level="rack", max_ranks_per_domain=6),
    "gang-anti": dict(GANG, anti_affinity_host=True),
    "gang-host": dict(GANG, ranks=2, colocate="host"),
    "gang-cluster": dict(GANG, ranks=1),
    "gang-grid": {"op": "gang", "ranks": 4, "colocate": "zone",
                  "cpu_request_milli": [100, 250, 1500],
                  "mem_request_bytes": [64 << 20, 512 << 20, 3 << 30],
                  "replicas": [1, 2, 3]},
    "gang-grid-explain": {"op": "gang", "ranks": 4, "colocate": "rack",
                          "explain": True, "cpu_request_milli": [100, 900],
                          "mem_request_bytes": [64 << 20, 1 << 30],
                          "replicas": [1, 2]},
    "gang-status": {"op": "gang"},
    "gang-bad-spec": dict(GANG, max_ranks_per_domain=2),
    "gang-bad-level": dict(GANG, colocate="pod"),
    "gang-bad-ranks": dict(GANG, ranks="eight"),
    "gang-bad-grid": {"op": "gang", "ranks": 2, "cpu_request_milli": [1]},
    "gang-bad-memory": dict(GANG, memRequests="lots"),
    "optimize": OPTIMIZE,
    "optimize-flags": {"op": "optimize", "cpuRequests": "500m",
                       "memRequests": "512mb", "replicas": "100000"},
    "optimize-table": {"op": "optimize", "cpuRequests": "500m",
                       "memRequests": "512mb", "replicas": "100000",
                       "output": "table"},
    "optimize-json": dict(OPTIMIZE, output="json"),
    "optimize-iters": dict(OPTIMIZE, iters=1, verify=False),
    "optimize-tol": dict(OPTIMIZE, tol=1e-4),
    "optimize-ffd": dict(OPTIMIZE, backend="ffd"),
    "optimize-ffd-table": {"op": "optimize", "backend": "ffd",
                           "cpuRequests": "100m", "memRequests": "100mb",
                           "replicas": "5", "output": "table"},
    "optimize-bad-backend": {"op": "optimize", "backend": "simplex",
                             "cpuRequests": "1"},
    "optimize-bad-iters": {"op": "optimize", "iters": "many",
                           "cpuRequests": "1"},
    "optimize-bad-verify": {"op": "optimize", "verify": "yes",
                            "cpuRequests": "1"},
    "optimize-bad-tol": {"op": "optimize", "tol": 0.9, "cpuRequests": "1"},
    "optimize-bad-grid": {"op": "optimize", "cpu_request_milli": [0],
                          "mem_request_bytes": [1]},
}
GANG_OPT_SOURCES = ("fleet-strict", "fleet-reference", "kind-reference",
                    "synthetic-npz")


def _gang_opt_pair(source, pairs, gang_pairs):
    return (gang_pairs if source.startswith("fleet") else pairs)[source]


def _close(a, b, path=""):
    if isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= 1e-9 + 1e-9 * abs(b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def _same_optimize_reply(t_reply, j_reply):
    from kubernetesclustercapacity_tpu.audit.log import (
        canonical_result_digest as j_digest,
    )
    from kubernetesclustercapacity_tpu_torch.audit.log import (
        canonical_result_digest as t_digest,
    )

    t_reply, j_reply = copy.deepcopy(t_reply), copy.deepcopy(j_reply)
    if not j_reply["ok"]:
        assert t_reply == j_reply
        return
    t_res, j_res = t_reply["result"], j_reply["result"]
    assert t_digest("optimize", t_res) == j_digest("optimize", j_res)
    for res in (t_res, j_res):
        res.pop("solve_seconds", None)
        report = res.pop("report", None)
        if report is not None:
            try:
                res["report"] = json.loads(report)
                res["report"].pop("solve_seconds", None)
            except ValueError:
                res["report"] = re.sub(r", [0-9.e-]+s$", ", Ns", report,
                                       flags=re.M)
    _close(t_reply, j_reply)


@pytest.mark.parametrize("name", list(GANG_OPT_REQUESTS))
@pytest.mark.parametrize("source", GANG_OPT_SOURCES)
def test_gang_and_optimize_replies_match_the_jax_server(source, name, pairs,
                                                        gang_pairs):
    msg = GANG_OPT_REQUESTS[name]
    j_reply, t_reply = _both(_gang_opt_pair(source, pairs, gang_pairs), msg)
    if name.startswith("optimize"):
        _same_optimize_reply(t_reply, j_reply)
    else:
        assert t_reply == j_reply
    assert t_reply["ok"] is ("-bad-" not in name), t_reply
    res = t_reply.get("result")
    if name == "gang-status":
        assert res == {"enabled": False, "watches": {}, "breached": []}
    elif name.startswith("gang") and t_reply["ok"]:
        assert all(type(g) is int for g in res["gangs"])
        assert ("explain" in res) is (name != "gang-grid")


def test_gang_and_optimize_comparison_is_not_vacuous(gang_pairs):
    """The labelled fleet really has a hierarchy (racks bind the gang, some
    gangs fit), the LP certifies and the first-fit form is the sweep's."""
    _, t = _both(gang_pairs["fleet-strict"], GANG_OPT_REQUESTS["gang-rack"])
    res = t["result"]
    assert res["gangs"][0] > 0 and res["explain"]["largest_domain"][
        "name"].startswith("tz-")
    _, t = _both(gang_pairs["fleet-strict"], GANG_OPT_REQUESTS["optimize"])
    assert t["result"]["status"] == ["certified"] * 3
    assert t["result"]["rounded"] == t["result"]["ffd"]
    _, t = _both(gang_pairs["fleet-strict"],
                 GANG_OPT_REQUESTS["optimize-iters"])
    assert "uncertified" in t["result"]["status"]
    _, t = _both(gang_pairs["fleet-strict"],
                 GANG_OPT_REQUESTS["optimize-table"])
    assert t["result"]["report"].startswith("optimized packing")


def test_gang_and_optimize_ops_are_ported():
    assert {"gang", "optimize"}.isdisjoint(UNPORTED_OPS)


@pytest.mark.parametrize("name", ["gang-spread", "gang-grid", "gang-status",
                                  "optimize", "optimize-ffd"])
def test_gang_and_optimize_cross_clients_and_servers(name, gang_pairs):
    j, t = gang_pairs["fleet-strict"]
    msg = GANG_OPT_REQUESTS[name]
    replies = [_call(JaxClient, t, msg), _call(TorchClient, t, msg),
               _call(TorchClient, j, msg), _call(JaxClient, j, msg)]
    for reply in replies[1:]:
        if name.startswith("optimize"):
            _same_optimize_reply(reply, replies[0])
        else:
            assert reply == replies[0]
