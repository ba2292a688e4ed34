"""The port's shadow-oracle sampler against ``kubernetesclustercapacity_tpu.
audit.shadow``, on the CPU.

``oracle_totals`` equals the JAX function on seeded fleets in both
semantics, with the implicit taint mask, an explicit mask and none.  The
sampler's error-diffusion decisions and counters equal the JAX sampler's
at every rate.  Both servers, each with a sampler at rate 1.0 and an audit
log, answer the same sweeps (solo, and folded on the port) with every one
checked and none divergent, and report the same ``info {audit: true}``
sampler section.  With the sweep corrupted by one on both servers, the
divergence is caught alike: the same repro bundle, the alert breached,
``/healthz`` unhealthy, and ``replay_shadow_bundle`` confirming it while
the fault lasts and refuting it once it is gone.  The served totals reach
the sampler as host arrays.

Tolerance: none (integers and verdicts are equal).
"""

import copy
import json
import threading

import numpy as np
import pytest

from kubernetesclustercapacity_tpu import masks as j_masks
from kubernetesclustercapacity_tpu.audit import AuditLog as JaxLog
from kubernetesclustercapacity_tpu.audit import AuditReader as JaxReader
from kubernetesclustercapacity_tpu.audit import shadow as j_shadow
from kubernetesclustercapacity_tpu.audit.replay import (
    replay_shadow_bundle as j_replay_bundle,
)
from kubernetesclustercapacity_tpu.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu.scenario import random_scenario_grid
from kubernetesclustercapacity_tpu.service.server import (
    CapacityServer as JaxServer,
)
from kubernetesclustercapacity_tpu.snapshot import snapshot_from_fixture
from kubernetesclustercapacity_tpu.telemetry.metrics import (
    MetricsRegistry as JaxRegistry,
)
from kubernetesclustercapacity_tpu_torch.audit import AuditLog as TorchLog
from kubernetesclustercapacity_tpu_torch.audit import (
    AuditReader as TorchReader,
)
from kubernetesclustercapacity_tpu_torch.audit import shadow as t_shadow
from kubernetesclustercapacity_tpu_torch.audit.replay import (
    replay_shadow_bundle as t_replay_bundle,
)
from kubernetesclustercapacity_tpu_torch.service import server as t_server
from kubernetesclustercapacity_tpu_torch.snapshot import (
    ClusterSnapshot as TorchSnapshot,
)
from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
    MetricsRegistry as TorchRegistry,
)

SIDES = {
    "jax": (j_shadow, JaxServer, JaxLog, JaxReader, j_replay_bundle,
            JaxRegistry, {}),
    "torch": (t_shadow, t_server.CapacityServer, TorchLog, TorchReader,
              t_replay_bundle, TorchRegistry, {"device": "cpu"}),
}


def _snapshot(side, mode, n=200, seed=61):
    fx = synthetic_fixture(n, seed=seed, taint_frac=0.25,
                           unhealthy_frac=0.1, unscheduled_running_pods=3)
    snap = snapshot_from_fixture(fx, semantics=mode)
    if side == "torch":
        snap = TorchSnapshot(**{f: getattr(snap, f)
                                for f in TorchSnapshot.__dataclass_fields__})
    return snap


@pytest.mark.parametrize("mode", ["reference", "strict"])
@pytest.mark.parametrize("mask", ["implicit", "none", "explicit"])
def test_oracle_totals_equal_jax(mode, mask):
    grid = random_scenario_grid(24, seed=3)
    got = {}
    for side in SIDES:
        snap = _snapshot(side, mode)
        kw = {}
        if mask == "none":
            kw["node_mask"] = None
        elif mask == "explicit":
            kw["node_mask"] = np.arange(snap.n_nodes) % 3 != 0
        got[side] = SIDES[side][0].oracle_totals(snap, grid, **kw)
    assert got["torch"] == got["jax"]
    if mask == "implicit" and mode == "strict":
        snap = _snapshot("jax", mode)
        assert j_masks.implicit_taint_mask(snap) is not None


def _noop_oracle(snapshot, grid, node_mask):
    return [0] * grid.size


@pytest.mark.parametrize("rate", [0.0, 0.3, 0.5, 1.0])
def test_sampling_decisions_equal_jax(rate):
    grid = random_scenario_grid(2, seed=1)
    out = {}
    for side in SIDES:
        sampler = SIDES[side][0].ShadowSampler(rate, oracle=_noop_oracle)
        try:
            decisions = [sampler.maybe_submit(None, k, grid, [0, 0],
                                              [False, False], ts=float(k))
                         for k in range(23)]
            assert sampler.drain(10.0)
            stats = sampler.stats()
        finally:
            sampler.close()
        out[side] = (decisions, stats)
    assert out["torch"] == out["jax"]


def test_rate_validation_like_jax():
    msgs = []
    for side in SIDES:
        with pytest.raises(ValueError) as info:
            SIDES[side][0].ShadowSampler(1.5)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def _serve(side, tmp_path, *, batch_window_ms=0.0):
    shadow_mod, server_cls, log_cls, _, _, registry_cls, dev = SIDES[side]
    reg = registry_cls()
    log = log_cls(str(tmp_path / f"{side}-audit"))
    sampler = shadow_mod.ShadowSampler(
        1.0, registry=reg, audit_log=log,
        bundle_path=str(tmp_path / f"{side}-bundles.jsonl"))
    server = server_cls(_snapshot(side, "strict"), port=0, registry=reg,
                        batch_window_ms=batch_window_ms, audit_log=log,
                        shadow=sampler, **dev)
    return server, sampler, log, reg


SWEEPS = [{"op": "sweep", "random": {"n": 12, "seed": s}} for s in range(5)]


def test_served_sweeps_are_checked_clean_like_jax(tmp_path):
    views = {}
    for side in SIDES:
        server, sampler, log, _ = _serve(side, tmp_path)
        try:
            replies = [server.dispatch(dict(m)) for m in SWEEPS]
            server.dispatch({"op": "sweep", "cpu_request_milli": [100, 7],
                             "mem_request_bytes": [1 << 20, 1],
                             "replicas": [1, 10 ** 6]})
            assert sampler.drain(30.0)
            info = server.dispatch({"op": "info", "audit": True})
        finally:
            server.shutdown()
            sampler.close()
            log.close()
        shadow_stats = info["audit"]["shadow"]
        assert info["audit"]["enabled"] is True
        assert info["audit"]["log"]["by_kind"]["request"] == len(SWEEPS) + 1
        views[side] = ([r["totals"] for r in replies], shadow_stats)
    assert views["torch"] == views["jax"]
    stats = views["torch"][1]
    assert stats["checked"] == stats["sampled"] == len(SWEEPS) + 1
    assert stats["divergences"] == 0 and stats["alert"]["state"] == "ok"


def test_folded_sweeps_are_checked_on_the_port(tmp_path):
    # A long window, so that the four members fold even on a loaded host.
    server, sampler, log, _ = _serve("torch", tmp_path,
                                     batch_window_ms=1000.0)
    start = threading.Barrier(4)
    replies = []

    def member(k):
        start.wait()
        replies.append(server.dispatch(dict(SWEEPS[k])))

    try:
        threads = [threading.Thread(target=member, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert sampler.drain(30.0)
        assert server.batching_stats["batched_requests"] >= 2
    finally:
        server.shutdown()
        sampler.close()
        log.close()
    stats = sampler.stats()
    assert stats["checked"] == 4 and stats["divergences"] == 0
    assert len(replies) == 4


def test_sampler_receives_host_arrays(tmp_path, monkeypatch):
    server, sampler, log, _ = _serve("torch", tmp_path)
    seen = []
    real = sampler.maybe_submit

    def spy(snapshot, generation, grid, totals, schedulable, **kw):
        seen.append((type(totals), type(schedulable), generation))
        return real(snapshot, generation, grid, totals, schedulable, **kw)

    monkeypatch.setattr(sampler, "maybe_submit", spy)
    try:
        server.dispatch(dict(SWEEPS[0]))
        assert sampler.drain(30.0)
    finally:
        server.shutdown()
        sampler.close()
        log.close()
    assert seen == [(np.ndarray, np.ndarray, 1)]


class _Plus1:
    """The served sweep, totals corrupted by one: the class of fault the
    sampler exists to catch."""

    def __init__(self, real):
        self._real = real

    def __call__(self, snap, grid, **kw):
        totals, sched, kernel = self._real(snap, grid, **kw)
        return np.asarray(totals) + 1, sched, kernel


def _fault_target(side):
    if side == "jax":
        from kubernetesclustercapacity_tpu.ops import pallas_fit

        return pallas_fit
    from kubernetesclustercapacity_tpu_torch.ops import fused_fit

    return fused_fit


def test_divergence_is_caught_and_replayed_like_jax(tmp_path, monkeypatch):
    got = {}
    for side in SIDES:
        *_, reader_cls, replay_bundle, _, dev = SIDES[side]
        server, sampler, log, reg = _serve(side, tmp_path)
        target = _fault_target(side)
        try:
            with monkeypatch.context() as mp:
                mp.setattr(target, "sweep_snapshot_auto",
                           _Plus1(target.sweep_snapshot_auto))
                server.dispatch(dict(SWEEPS[1]))
                assert sampler.drain(30.0)
                diverged = sampler.diverged
                if side == "torch":
                    healthy, status = t_server.healthz_probes(
                        server, audit_log=log, shadow=sampler)
                    assert not healthy()
                    assert status()["shadow"]["divergences"] == 1
                server.shutdown()
                log.close()
                (bundle,) = [json.loads(line) for line in open(
                    tmp_path / f"{side}-bundles.jsonl")]
                reader = reader_cls.load(str(tmp_path / f"{side}-audit"))
                confirmed = replay_bundle(reader, bundle, **dev)
            refuted = replay_bundle(reader, bundle, **dev)
            metric = reg.snapshot()["kccap_shadow_divergence_total"]
        finally:
            server.shutdown()
            sampler.close()
            log.close()
        assert diverged and confirmed["diverged"]
        assert confirmed["served_matches_bundle"]
        assert not refuted["diverged"] and refuted["rows"] == []
        assert any(r.get("kind") == "shadow_divergence"
                   for r in reader.records)
        # The ref's byte offset follows the wall-clock stamps written
        # before it; the segment it names is compared.
        bundle = {k: v for k, v in bundle.items()
                  if k not in ("ts", "audit_dir")}
        bundle["audit_ref"] = bundle["audit_ref"].split(":")[0]
        got[side] = (bundle, confirmed, refuted, metric["values"])
    assert got["torch"] == got["jax"]


def test_recovery_is_sticky_like_jax():
    grid = random_scenario_grid(2, seed=4)
    states = {}
    for side in SIDES:
        snap = _snapshot(side, "strict", n=20)
        # maybe_submit without a node_mask checks against no mask.
        want = SIDES[side][0].oracle_totals(snap, grid, node_mask=None)
        sampler = SIDES[side][0].ShadowSampler(1.0)
        trail = []
        try:
            for k, delta in enumerate((0, 1, 0, 0)):
                served = [t + delta for t in want]
                sched = [t >= int(r) for t, r in zip(want, grid.replicas)]
                sampler.maybe_submit(snap, k + 1, grid, served, sched)
                assert sampler.drain(10.0)
                st = sampler.stats()
                trail.append((sampler.diverged, st["alert"]["state"],
                              st["divergences"]))
        finally:
            sampler.close()
        states[side] = trail
    assert states["torch"] == states["jax"]
    assert [s for _, s, _ in states["torch"]] == [
        "ok", "breached", "recovered", "recovered"]


def test_disabled_telemetry_registers_nothing(monkeypatch):
    monkeypatch.setenv("KCCAP_TELEMETRY", "0")
    reg = TorchRegistry()
    sampler = t_shadow.ShadowSampler(1.0, registry=reg)
    sampler.close()
    assert copy.deepcopy(reg.snapshot()) == {}
