"""The port's tenancy and admission against ``kubernetesclustercapacity_tpu.
service.tenancy``, ``.service.plane.AdmissionController`` and
``.resilience.TokenBucket``, on the CPU.

With one injected clock, the token bucket grants the same requests and
holds the same (float) level as the JAX one at every step; a tenant map
parses, attributes, folds labels and refuses bad documents with the same
messages; the weighted-fair slot queue grants waiters in the same order;
an admission controller over a 3-tenant map makes the same admit/shed
decisions with the same errors and counters.  Then both servers, with the
same map and an admission controller on an injected clock, take one
seeded request sequence through ``dispatch``: every reply or refusal is
equal, and so are the ``info`` sections (``capabilities``, ``tenancy``),
the flight recorder's ``filter_tenant`` dump, the per-tenant metrics, and
the fold accounting of a folded launch.

Tolerance: none (verdicts, integers and floats are equal).
"""

import copy
import threading
import time

import numpy as np
import pytest

from kubernetesclustercapacity_tpu import resilience as j_resilience
from kubernetesclustercapacity_tpu.service import batching as j_batching
from kubernetesclustercapacity_tpu.service import plane as j_plane
from kubernetesclustercapacity_tpu.service import tenancy as j_tenancy
from kubernetesclustercapacity_tpu.service.server import (
    CapacityServer as JaxServer,
)
from kubernetesclustercapacity_tpu.snapshot import synthetic_snapshot
from kubernetesclustercapacity_tpu.telemetry.metrics import (
    MetricsRegistry as JaxRegistry,
)
from kubernetesclustercapacity_tpu_torch import resilience as t_resilience
from kubernetesclustercapacity_tpu_torch.service import batching as t_batching
from kubernetesclustercapacity_tpu_torch.service import plane as t_plane
from kubernetesclustercapacity_tpu_torch.service import tenancy as t_tenancy
from kubernetesclustercapacity_tpu_torch.service.server import (
    CapacityServer as TorchServer,
)
from kubernetesclustercapacity_tpu_torch.snapshot import (
    ClusterSnapshot as TorchSnapshot,
)
from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
    MetricsRegistry as TorchRegistry,
)

SIDES = {
    "jax": (j_resilience, j_tenancy, j_plane, j_batching, JaxServer,
            JaxRegistry),
    "torch": (t_resilience, t_tenancy, t_plane, t_batching, TorchServer,
              TorchRegistry),
}
MAP = {"tenants": [
    {"name": "batch", "token": "tok-batch", "weight": 1},
    {"name": "web", "token": "tok-web", "weight": 2, "max_concurrent": 1},
    {"name": "ml", "token": "tok-ml", "weight": 4, "rps": 5, "burst": 5},
]}


def _outcome(fn):
    """``fn()``'s value, or its exception as (type name, message)."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the error IS the outcome
        return (type(e).__name__, str(e))


def test_token_bucket_matches_jax_step_for_step():
    rng = np.random.default_rng(42)
    dts = rng.uniform(0.0, 0.25, size=400)
    asks = rng.choice([0.5, 1.0, 2.0], size=400)
    trails = {}
    for side in SIDES:
        now = [100.0]
        bucket = SIDES[side][0].TokenBucket(7.0, 12.0,
                                            clock=lambda: now[0])
        trail = []
        for dt, ask in zip(dts, asks):
            now[0] += float(dt)
            trail.append((bucket.try_acquire(float(ask)),
                          bucket.available()))
        trails[side] = trail
    assert trails["torch"] == trails["jax"]
    assert 0 < sum(g for g, _ in trails["torch"]) < 400


@pytest.mark.parametrize("args", [(0.0,), (1.0, 0.5), (-2.0, 3.0)])
def test_token_bucket_validation_like_jax(args):
    got = [_outcome(lambda: SIDES[s][0].TokenBucket(*args)) for s in SIDES]
    assert got[0] == got[1] and got[0][0] == "ValueError"


BAD_MAPS = [
    [],
    {"tenants": []},
    {"tenants": [{"name": "a b"}]},
    {"tenants": [{"name": "a", "rps": -1}]},
    {"tenants": [{"name": "a", "burst": 0.5}]},
    {"tenants": [{"name": "a", "max_concurrent": 1.5}]},
    {"tenants": [{"name": "a", "weight": 0}]},
    {"tenants": [{"name": "a", "token": ""}]},
    {"tenants": [{"name": "a", "colour": "red"}]},
    {"tenants": [{"name": "a"}, {"name": "a"}]},
    {"tenants": [{"name": "a", "token": "t"}, {"name": "b", "token": "t"}]},
    {"tenants": [{"name": "a"}], "extra": 1},
    {"tenants": ["a"]},
]


@pytest.mark.parametrize("doc", BAD_MAPS)
def test_bad_tenant_maps_are_refused_like_jax(doc):
    got = [_outcome(lambda: SIDES[s][1].parse_tenants(copy.deepcopy(doc)))
           for s in SIDES]
    assert got[0] == got[1] and got[0][0] == "TenancyError"


def test_tenant_map_answers_like_jax(tmp_path):
    import json

    path = tmp_path / "tenants.json"
    path.write_text(json.dumps(MAP))
    views = {}
    for side in SIDES:
        tm = SIDES[side][1].load_tenants(str(path))
        views[side] = (
            tm.to_wire(), len(tm), tm.names,
            [tm.tenant_of(t) for t in ("tok-web", "tok-ml", "nope", None)],
            [tm.label(t) for t in ("web", "default", "stranger", "")],
            [tm.weight(t) for t in ("ml", "stranger")],
            "ml" in tm, "stranger" in tm,
        )
    assert views["torch"] == views["jax"]
    assert "tok" not in json.dumps(views["torch"][0])


def test_tenancy_gate_reads_the_same_variable(monkeypatch):
    for value, want in (("0", False), ("1", True)):
        monkeypatch.setenv("KCCAP_TENANCY", value)
        assert t_tenancy.enabled() is j_tenancy.enabled() is want


def _drain_in_order(fq, tenants):
    """Queue ``tenants`` as waiters one by one behind a held slot, then
    release it; each waiter records itself when granted and releases."""
    order, lock, threads = [], threading.Lock(), []

    def waiter(tenant):
        if fq.acquire(tenant, timeout=10.0):
            with lock:
                order.append(tenant)
            fq.release(tenant)

    for k, tenant in enumerate(tenants):
        t = threading.Thread(target=waiter, args=(tenant,), daemon=True)
        t.start()
        threads.append(t)
        deadline = time.monotonic() + 10
        while fq.stats()["waiting"] < k + 1:
            assert time.monotonic() < deadline
            time.sleep(0.002)
    fq.release("seed")
    for t in threads:
        t.join(10)
    return order


def test_fair_queue_grants_in_the_jax_order():
    weights = {"heavy": 3.0, "light": 1.0, "mid": 2.0}
    rng = np.random.default_rng(7)
    tenants = [str(t) for t in rng.choice(["heavy", "light", "mid"], 24)]
    orders, stats = {}, {}
    for side in SIDES:
        fq = SIDES[side][1].FairSlotQueue(1, weight_of=weights.get)
        assert fq.acquire("seed")
        orders[side] = _drain_in_order(fq, tenants)
        stats[side] = fq.stats()
    assert orders["torch"] == orders["jax"]
    assert sorted(orders["torch"]) == sorted(tenants)
    assert stats["torch"] == stats["jax"]


def _admission_script(side):
    """One scripted sequence of admits over MAP with an injected clock:
    every outcome, the held releases run in a fixed order, then the
    controller's counters."""
    _, tenancy, plane, _, _, registry_cls = SIDES[side]
    now = [0.0]
    reg = registry_cls()
    adm = plane.AdmissionController(
        max_concurrent=2, rps=20.0, burst=6.0, clock=lambda: now[0],
        registry=reg, tenants=tenancy.parse_tenants(copy.deepcopy(MAP)),
        max_queue_wait_s=0.0, price_budget=0.5,
    )
    rng = np.random.default_rng(11)
    held, trail = [], []
    for step in range(60):
        now[0] += float(rng.uniform(0.0, 0.3))
        tenant = str(rng.choice(["batch", "web", "ml", "default",
                                 "stranger"]))
        if step == 20:
            adm.observe_shadow_price(0.7, certified=False)
        if step == 30:
            adm.observe_shadow_price(0.7, certified=True)
        if step == 40:
            adm.observe_shadow_price(0.2, certified=True)
        op = "optimize" if step % 7 == 0 else "sweep"
        out = _outcome(lambda: adm.admit(op, priced=op != "optimize",
                                         tenant=tenant))
        if out[0] == "ok":
            held.append(out[1])
            out = ("ok", None)
        trail.append((tenant, op) + out)
        if len(held) == 2 or rng.random() < 0.3:
            if held:
                held.pop(0)()
    while held:
        held.pop()()
    snap = reg.snapshot()
    return trail, adm.tenant_stats(), adm.shadow_price(), {
        k: snap[k]["values"] for k in snap
        if k.startswith(("kccap_admission", "kccap_tenant"))}


def test_admission_decisions_match_jax():
    j, t = _admission_script("jax"), _admission_script("torch")
    assert t == j
    verdicts = {v for _, _, v, _ in t[0]}
    assert {"ok", "OverloadedError", "TenantQuotaError"} <= verdicts


def _server_script(side):
    """Both servers under one tenant map and one admission controller on
    an injected clock: a seeded sequence of dispatches from the tenants'
    tokens (and an explicit label, and none), then the info, dump and
    metric views."""
    _, tenancy, plane, _, server_cls, registry_cls = SIDES[side]
    snap = synthetic_snapshot(48, seed=11)
    if side == "torch":
        snap = TorchSnapshot(**{f: getattr(snap, f)
                                for f in TorchSnapshot.__dataclass_fields__})
    tm = tenancy.parse_tenants(copy.deepcopy(MAP))
    now = [0.0]
    reg = registry_cls()
    adm = plane.AdmissionController(max_concurrent=4, tenants=tm,
                                    clock=lambda: now[0], registry=reg)
    kw = {"device": "cpu"} if side == "torch" else {}
    server = server_cls(snap, port=0, batch_window_ms=0.0, tenants=tm,
                        admission=adm, registry=reg, auth_token="shared",
                        **kw)
    rng = np.random.default_rng(5)
    trail = []
    try:
        for step in range(60):
            now[0] += float(rng.uniform(0.0, 0.01))
            who = int(rng.integers(0, 5))
            msg = {"op": ("sweep", "fit", "explain")[step % 3],
                   "cpuRequests": "250m", "memRequests": "256mb"}
            if msg["op"] == "sweep":
                msg = {"op": "sweep", "random": {"n": 4, "seed": step}}
            if who < 3:
                msg["token"] = ("tok-batch", "tok-web", "tok-ml")[who]
            elif who == 3:
                msg.update(token="shared", tenant="web")
            else:
                msg["token"] = "shared"
            out = _outcome(lambda: server.dispatch(dict(msg)))
            if out[0] == "ok" and isinstance(out[1], dict):
                out = ("ok", {k: v for k, v in out[1].items()
                              if k not in ("kernel", "report")})
            trail.append(out)
        trail.append(_outcome(lambda: server.dispatch(
            {"op": "sweep", "random": {"n": 2}, "token": "wrong"})))
        info = server.dispatch({"op": "info", "tenancy": True,
                                "token": "shared"})
        dumps = [server.dispatch({"op": "dump", "filter_tenant": t,
                                  "token": "shared"})
                 for t in ("web", "ml", "default")]
    finally:
        server.shutdown()
    keep = ("op", "tenant", "status", "error", "generation")
    dumps = [[{k: r.get(k) for k in keep} for r in d["records"]]
             for d in dumps]
    metrics = reg.snapshot()
    counts = {k: metrics[k]["values"] for k in (
        "kccap_tenant_requests_total", "kccap_tenant_admitted_total",
        "kccap_tenant_shed_total", "kccap_admission_shed_total")}
    return trail, info["capabilities"], info["tenancy"], dumps, counts


def test_servers_attribute_and_shed_alike():
    j, t = _server_script("jax"), _server_script("torch")
    assert t[0] == j[0]
    assert t[1:] == j[1:]
    assert t[1]["tenancy"] is True and t[1]["admission"] is True
    assert any(v[0] == "TenantQuotaError" for v in t[0])
    assert t[0][-1][0] == "PermissionError"
    assert {r["tenant"] for r in t[3][1]} == {"ml"}


def test_tenantless_server_keeps_the_tenantless_shape():
    replies = []
    for side in SIDES:
        snap = synthetic_snapshot(16, seed=3)
        if side == "torch":
            snap = TorchSnapshot(**{
                f: getattr(snap, f)
                for f in TorchSnapshot.__dataclass_fields__})
        kw = {"device": "cpu"} if side == "torch" else {}
        server = SIDES[side][4](snap, port=0, batch_window_ms=0.0, **kw)
        try:
            server.dispatch({"op": "sweep", "random": {"n": 2},
                             "tenant": "web"})
            info = server.dispatch({"op": "info", "tenancy": True,
                                    "plane": True, "audit": True})
            dump = server.dispatch({"op": "dump", "filter_tenant": "web"})
        finally:
            server.shutdown()
        replies.append((info["capabilities"], info["tenancy"],
                        info["plane"], info["audit"], dump["count"]))
    assert replies[0] == replies[1]
    assert replies[1] == ({"protocol": 2, "plane": False,
                           "admission": False, "drain": True,
                           "tenancy": False}, None, None,
                          {"enabled": False, "log": None, "shadow": None},
                          0)


def _fold(side):
    """Three tenants' requests folded into one launch by the batcher: the
    fold hook's per-tenant and cross-tenant counters."""
    _, tenancy, _, batching, _, registry_cls = SIDES[side]
    reg = registry_cls()
    tm = tenancy.parse_tenants(copy.deepcopy(MAP))
    start = threading.Barrier(3)
    batcher = batching.MicroBatcher(
        lambda key, items: [len(items)] * len(items), window_s=1.0,
        max_batch=3, registry=reg,
        fold_hook=tenancy.FoldAccounting(tm, reg))
    sizes = []

    def member(tenant):
        start.wait()
        sizes.append(batcher.submit("k", tenant, tenant=tenant))

    threads = [threading.Thread(target=member, args=(t,))
               for t in ("batch", "web", "ml")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    snap = reg.snapshot()
    return sizes, {k: snap[k]["values"] for k in snap
                   if k in ("kccap_tenant_folded_requests_total",
                            "kccap_fold_cross_tenant_total",
                            "kccap_batch_tenants")}


def test_fold_accounting_matches_jax():
    j, t = _fold("jax"), _fold("torch")
    assert t == j
    assert t[0] == [3, 3, 3]
