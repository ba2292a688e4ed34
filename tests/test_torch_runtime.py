"""The device-runtime glue under the port's service, on CPU tensors.

* ``ops/fit.sweep_snapshot`` against the JAX package's, ``sync=True`` and
  ``sync=False`` (views over one :class:`AsyncFetch`), and
  ``sweep_snapshot_auto(sync=False)`` on every route;
* ``devcache.DeviceCache.stage_replace``: unchanged columns carry over,
  the staged tuple equals a cold stage, the retired snapshot's entries
  go, ``KCCAP_DONATE=0`` answers identically, and a CPU stage never
  writes into the retired snapshot's arrays;
* ``telemetry.memledger``: booking, retirement and ``reconcile``;
* the launch counters stay exact under concurrent threads;
* ``utils.timing``, ``utils.threads``, ``resilience`` and the wire
  protocol's bytes against the JAX package's copies.
"""

import dataclasses
import socket
import sys
import threading

import numpy as np
import pytest
import torch

from kubernetesclustercapacity_tpu import resilience as j_resilience
from kubernetesclustercapacity_tpu import snapshot as j_snapshot
from kubernetesclustercapacity_tpu.ops import fit as j_fit
from kubernetesclustercapacity_tpu.scenario import (
    random_scenario_grid as j_grid,
)
from kubernetesclustercapacity_tpu.service import protocol as j_protocol
from kubernetesclustercapacity_tpu_torch import devcache as t_devcache
from kubernetesclustercapacity_tpu_torch import resilience as t_resilience
from kubernetesclustercapacity_tpu_torch.masks import implicit_taint_mask
from kubernetesclustercapacity_tpu_torch.ops import fit as t_fit
from kubernetesclustercapacity_tpu_torch.ops import fused_fit as tf
from kubernetesclustercapacity_tpu_torch.ops import fused_multi as tm
from kubernetesclustercapacity_tpu_torch.scenario import (
    random_scenario_grid as t_grid,
)
from kubernetesclustercapacity_tpu_torch.service import protocol as t_protocol
from kubernetesclustercapacity_tpu_torch.snapshot import (
    grouped_for_dispatch,
    snapshot_from_fixture,
    synthetic_snapshot,
)
from kubernetesclustercapacity_tpu_torch.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu_torch.telemetry import memledger
from kubernetesclustercapacity_tpu_torch.utils import threads as t_threads
from kubernetesclustercapacity_tpu_torch.utils import timing as t_timing

CPU = torch.device("cpu")


def _pair(n, seed, **kw):
    return (j_snapshot.synthetic_snapshot(n, seed=seed, **kw),
            synthetic_snapshot(n, seed=seed, **kw))


# -- sweep_snapshot ---------------------------------------------------------

@pytest.mark.parametrize("shapes", [None, 6], ids=["per-node", "grouped"])
@pytest.mark.parametrize("mode", ["reference", "strict"])
@pytest.mark.parametrize("per_node", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_sweep_snapshot_matches_jax(shapes, mode, per_node, masked):
    n = 1500 if shapes else 300
    js, ts = _pair(n, seed=41, shapes=shapes)
    mask = None
    if masked:
        mask = np.random.default_rng(42).random(n) < 0.7
    want = j_fit.sweep_snapshot(
        js, j_grid(33, seed=43), mode=mode, return_per_node=per_node,
        node_mask=mask,
    )
    for sync in (True, False):
        got = t_fit.sweep_snapshot(
            ts, t_grid(33, seed=43), mode=mode, return_per_node=per_node,
            node_mask=mask, device="cpu", sync=sync,
        )
        assert len(got) == len(want)
        for g, w in zip(got, want):
            g = np.asarray(g)
            w = np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    assert (grouped_for_dispatch(ts) is not None) == bool(shapes)


def test_sweep_snapshot_async_returns_views_over_one_fetch():
    snap = synthetic_snapshot(200, seed=44)
    totals, sched, fits = t_fit.sweep_snapshot(
        snap, t_grid(9, seed=45), return_per_node=True, device="cpu",
        sync=False,
    )
    assert not isinstance(totals, np.ndarray)
    assert totals.fetch is sched.fetch is fits.fetch
    assert np.asarray(fits).shape == (9, 200)
    assert np.asarray(sched).dtype == bool
    np.testing.assert_array_equal(np.asarray(fits).sum(axis=1),
                                  np.asarray(totals))


def test_async_fetch_keeps_dtypes_and_shapes():
    a = torch.arange(6, dtype=torch.int64).reshape(2, 3)
    b = torch.tensor([True, False, True])
    pending = t_fit.AsyncFetch((a, b))
    assert pending.staged is None  # nothing is copied from the host
    x, y = pending.arrays()
    assert x.dtype == np.int64 and x.shape == (2, 3)
    assert y.dtype == bool and y.tolist() == [True, False, True]
    assert pending.arrays()[0] is x  # the first reader pays, once
    views = t_fit.fetch((a, b), sync=False)
    assert np.asarray(views[0], dtype=np.float64).dtype == np.float64


@pytest.mark.parametrize("snap_kw,kernel,label", [
    ({}, "auto", "plain_i32_rcp_fused"),
    ({}, "exact", "torch_int64"),
    ({"shapes": 5}, "auto", "plain_i32_rcp_fused_grouped"),
    ({"shapes": 5}, "exact", "torch_int64_grouped"),
    ({"kib_quantized": False}, "auto", "torch_int64"),
])
@pytest.mark.parametrize("mode", ["reference", "strict"])
def test_sweep_snapshot_auto_async_equals_sync(snap_kw, kernel, label, mode):
    snap = synthetic_snapshot(1200, seed=46, **snap_kw)
    grid = t_grid(40, seed=47)
    sync = tf.sweep_snapshot_auto(snap, grid, mode=mode, kernel=kernel,
                                  device="cpu")
    async_ = tf.sweep_snapshot_auto(snap, grid, mode=mode, kernel=kernel,
                                    device="cpu", sync=False)
    assert sync[2] == async_[2] == label
    assert not isinstance(async_[0], np.ndarray)
    for s, a in zip(sync[:2], async_[:2]):
        a = np.asarray(a)
        assert a.dtype == s.dtype
        np.testing.assert_array_equal(a, s)


def test_sweep_explain_snapshot_auto_rows_are_the_full_rows():
    fx = synthetic_fixture(80, seed=48, taint_frac=0.3)
    snap = snapshot_from_fixture(fx, semantics="strict")
    grid = t_grid(12, seed=49)
    mask = implicit_taint_mask(snap)
    full = tf.sweep_explain_snapshot_auto(snap, grid, mode="strict",
                                          node_mask=mask, device="cpu")
    rows = np.array([7, 2, 11])
    part = tf.sweep_explain_snapshot_auto(snap, grid, mode="strict",
                                          node_mask=mask, device="cpu",
                                          rows=rows)
    assert part[3] == full[3] == "torch_int64_sweep_explain"
    np.testing.assert_array_equal(part[0], full[0])
    np.testing.assert_array_equal(part[1], full[1])
    for field in ("fits", "binding", "cpu_fit", "mem_fit", "slots",
                  "cpu_request_milli", "mem_request_bytes", "replicas"):
        np.testing.assert_array_equal(getattr(part[2], field),
                                      getattr(full[2], field)[rows])
    assert part[2].marginal(1) == full[2].marginal(2)


# -- stage_replace ----------------------------------------------------------

def _mutate(snap, n_changed=5):
    used = snap.used_cpu_req_milli.copy()
    used[:n_changed] += 17
    return dataclasses.replace(snap, used_cpu_req_milli=used)


def test_stage_replace_carries_unchanged_columns():
    cache = t_devcache.DeviceCache()
    old = synthetic_snapshot(200, seed=51)
    prior = cache.exact_tensors(old, CPU)
    prior_kernel = cache.kernel_tensors(old, CPU)
    new = _mutate(old)
    counts = cache.stage_replace(old, new, CPU)
    # One column changed in each form (used cpu, index 3): the rest
    # carry over; the host never copies in place.
    assert counts == {"reused": 11, "copied": 0, "restaged": 2}
    assert cache.stats()["stage_replace"] == counts
    staged = cache.exact_tensors(new, CPU)
    for i in (0, 1, 2, 4, 5, 6):
        assert staged[i] is prior[i]
    assert staged[3] is not prior[3]
    assert cache.kernel_tensors(new, CPU)[0] is prior_kernel[0]


def test_stage_replace_equals_a_cold_stage():
    cache = t_devcache.DeviceCache()
    old = synthetic_snapshot(300, seed=52)
    cache.exact_tensors(old, CPU)
    cache.kernel_tensors(old, CPU)
    before = old.used_cpu_req_milli.copy()
    new = _mutate(old, n_changed=40)
    cache.stage_replace(old, new, CPU)
    fresh = t_devcache.DeviceCache()
    for form in ("exact_tensors", "kernel_tensors"):
        for a, b in zip(getattr(cache, form)(new, CPU),
                        getattr(fresh, form)(new, CPU)):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)
    # The retired snapshot's host columns are untouched.
    np.testing.assert_array_equal(old.used_cpu_req_milli, before)


def test_stage_replace_retires_the_old_entries_and_prepays_the_new():
    cache = t_devcache.DeviceCache()
    old = synthetic_snapshot(200, seed=53)
    cache.exact_tensors(old, CPU)
    cache.grouped_exact_tensors(old.grouped(), CPU)
    new = _mutate(old)
    cache.stage_replace(old, new, CPU)
    assert cache._entries[id(old)] == {}
    assert set(cache._entries[id(new)]) == {("exact", CPU), ("kernel", CPU)}
    misses = cache.stats()["misses"]
    cache.exact_tensors(new, CPU)
    cache.kernel_tensors(new, CPU)
    assert cache.stats()["misses"] == misses


def test_stage_replace_retires_what_a_request_staged_after_the_swap():
    # A request that reaches the new snapshot between the server's swap
    # and its re-stage stages that snapshot first.  The re-stage's tuple
    # takes its place in the cache, and the ledger drops the request's
    # (the JAX cache's stage_replace retires the entry it overwrites).
    memledger.LEDGER.reset()
    cache = t_devcache.DeviceCache()
    old = synthetic_snapshot(64, seed=59)
    cache.kernel_tensors(old, CPU)
    new = _mutate(old)
    raced = cache.kernel_tensors(new, CPU)
    cache.stage_replace(old, new, CPU)
    assert cache.kernel_tensors(new, CPU) is not raced
    del raced
    assert memledger.LEDGER.form_bytes("kernel") == 64 * 6 * 4
    audits = [memledger.LEDGER.reconcile() for _ in range(2)]
    assert [a["missing_bytes"] for a in audits] == [0, 0]
    assert not memledger.LEDGER.leaking()
    cache.invalidate(new)


def test_stage_replace_restages_on_a_new_node_count_or_cold_cache():
    cache = t_devcache.DeviceCache()
    old = synthetic_snapshot(200, seed=54)
    cache.exact_tensors(old, CPU)
    bigger = synthetic_snapshot(205, seed=54)
    assert cache.stage_replace(old, bigger, CPU) == {
        "reused": 0, "copied": 0, "restaged": 13}
    never = synthetic_snapshot(200, seed=55)
    assert cache.stage_replace(never, bigger, CPU)["restaged"] == 13


def test_stage_replace_skips_the_kernel_form_when_it_would_not_be_exact():
    cache = t_devcache.DeviceCache()
    old = synthetic_snapshot(100, seed=56)
    new = synthetic_snapshot(100, seed=56, kib_quantized=False)
    counts = cache.stage_replace(old, new, CPU)
    assert sum(counts.values()) == 7
    assert set(cache._entries[id(new)]) == {("exact", CPU)}


def test_sole_holder_sees_other_references():
    staged = tuple(torch.zeros(3) for _ in range(2))
    assert t_devcache._sole_holder(staged)
    held = staged[1]
    assert not t_devcache._sole_holder(staged)
    del held
    alias = staged
    assert not t_devcache._sole_holder(staged)
    del alias
    assert t_devcache._sole_holder(staged)


@pytest.mark.parametrize("donate", ["1", "0"])
def test_reload_answers_identically_with_donation_on_or_off(
    donate, monkeypatch, tmp_path
):
    from kubernetesclustercapacity_tpu_torch.service.server import (
        CapacityServer,
    )

    monkeypatch.setenv("KCCAP_DONATE", donate)
    a = synthetic_snapshot(150, seed=57)
    path = str(tmp_path / "b.npz")
    _mutate(a, 30).save(path)
    server = CapacityServer(a, device="cpu", batch_window_ms=0)
    try:
        server.dispatch({"op": "sweep", "random": {"n": 8}})
        server.dispatch({"op": "reload", "path": path})
        got = server.dispatch({"op": "sweep", "random": {"n": 8}})
    finally:
        server.shutdown()
    want = tf.sweep_snapshot_auto(
        server.snapshot, t_grid(8), device="cpu"
    )
    assert got["totals"] == want[0].tolist()
    assert server.generation == 2
    entries = t_devcache.CACHE._entries.get(id(server.snapshot), {})
    assert (("kernel", CPU) in entries) is True


# -- memledger --------------------------------------------------------------

class _FakeCudaLeaf:
    """A leaf the ledger books as CUDA memory (the CPU tests have none)."""

    device = torch.device("meta")

    def __init__(self, nbytes):
        self.nbytes = nbytes


class _CudaType:
    type = "cuda"


def test_memledger_books_retires_and_reconciles():
    ledger = memledger.DeviceLedger()
    staged = (torch.zeros(10, dtype=torch.int64), torch.zeros(4))
    assert ledger.register(staged, "exact") == 96
    audit = ledger.reconcile()
    assert audit["missing_bytes"] == 0 and not audit["leaking"]
    assert ledger.retire(staged) == 96 and ledger.total_bytes() == 0
    assert ledger.retire(staged) == 0  # twice is harmless


def test_memledger_sustained_dead_leaf_trips_the_alert():
    ledger = memledger.DeviceLedger()
    ledger.register((torch.zeros(8, dtype=torch.int64),), "exact")
    # The only tensor died without a retire: the book still claims it.
    first = ledger.reconcile()
    assert first["missing_bytes"] == 64
    assert first["sustained_missing_bytes"] == 0 and not first["leaking"]
    second = ledger.reconcile()
    assert second["sustained_missing_bytes"] == 64 and second["leaking"]
    assert ledger.leaking()


def test_memledger_live_arrays_injection_and_cuda_excess():
    ledger = memledger.DeviceLedger()
    live = torch.zeros(4, dtype=torch.int64)
    ledger.register((live,), "kernel")
    audit = ledger.reconcile(live_arrays=[live], allocated_bytes=0)
    assert audit["missing_bytes"] == 0 and audit["tracked_cuda_bytes"] == 0
    leaf = _FakeCudaLeaf(1000)
    leaf.device = _CudaType()
    ledger.register((leaf,), "exact")
    # Booked CUDA bytes beyond what the allocator holds: a suspect, then
    # a sustained leak.
    audit = ledger.reconcile(allocated_bytes=400)
    assert audit["tracked_cuda_bytes"] == 1000
    assert audit["missing_bytes"] == 600 and not audit["leaking"]
    audit = ledger.reconcile(allocated_bytes=400)
    assert audit["sustained_missing_bytes"] == 600 and audit["leaking"]
    assert ledger.reconcile(allocated_bytes=5000)["leaking"] is False


def test_device_cache_books_its_staging_in_the_ledger():
    memledger.LEDGER.reset()
    cache = t_devcache.DeviceCache()
    snap = synthetic_snapshot(64, seed=58)
    cache.exact_tensors(snap, CPU)
    cache.kernel_tensors(snap, CPU)
    assert memledger.LEDGER.form_bytes("exact") == 64 * (6 * 8 + 1)
    assert memledger.LEDGER.form_bytes("kernel") == 64 * 6 * 4
    assert memledger.LEDGER.reconcile()["missing_bytes"] == 0
    cache.invalidate(snap)
    assert memledger.LEDGER.total_bytes() == 0


# -- counters under threads -------------------------------------------------

def test_plain_counters_are_exact_under_threads():
    n, s, per_thread, workers = 64, 8, 25, 8
    ints = [torch.full((n,), v, dtype=torch.int32)
            for v in (4000, 8192, 110, 100, 1024, 10)]
    req = torch.full((s,), 100, dtype=torch.int32)
    alloc = torch.full((2, n), 1000, dtype=torch.int32)
    used = torch.zeros((2, n), dtype=torch.int32)
    reqs = torch.full((2, s), 10, dtype=torch.int32)
    before = (tf.PLAIN_CALLS, tm.PLAIN_CALLS, tf.LAUNCHES, tm.LAUNCHES)
    errors = []

    def work():
        try:
            for _ in range(per_thread):
                tf.sweep_fused(*ints, req, req)
                tm.sweep_multi(alloc, used, ints[2], ints[5], reqs)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert tf.PLAIN_CALLS - before[0] == workers * per_thread
    assert tm.PLAIN_CALLS - before[1] == workers * per_thread
    # The kernels' own counters count launches on the card only.
    assert (tf.LAUNCHES, tm.LAUNCHES) == before[2:]


# -- host glue --------------------------------------------------------------

def test_phase_timer_waits_for_nothing_on_the_cpu():
    timer = t_timing.PhaseTimer()
    with timer.phase("kernel") as ph:
        out = ph.block(torch.ones(3) * 2)
    assert out.tolist() == [2.0, 2.0, 2.0]
    assert set(timer.phases) == {"kernel"}
    assert t_timing.wait_for((torch.ones(1), [np.ones(2)])) is not None
    stats = t_timing.measure_latency(lambda: None, reps=3)
    assert len(stats.samples_ms) == 3 and stats.p50 >= 0
    with pytest.raises(ValueError):
        t_timing.LatencyStats(samples_ms=())


def test_supervised_thread_records_its_death(capsys):
    seen = []

    def boom():
        raise RuntimeError("bang")

    before = t_threads.death_count()
    t = threading.Thread(target=t_threads.supervised(
        boom, name="t", on_death=seen.append))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert t_threads.death_count() == before + 1
    assert t_threads.last_death() == ("t", "RuntimeError: bang")
    assert [str(e) for e in seen] == ["bang"]
    assert "supervised thread 't' died" in capsys.readouterr().err


def test_resilience_wire_codes_match_jax():
    assert sorted(t_resilience.WIRE_CODES) == sorted(j_resilience.WIRE_CODES)
    for code, cls in t_resilience.WIRE_CODES.items():
        assert cls.__name__ == j_resilience.WIRE_CODES[code].__name__
        assert cls.wire_code == code
    d = t_resilience.Deadline.after(5.0)
    assert 0 < d.remaining() <= 5.0 and not d.expired()
    assert t_resilience.Deadline.from_wire(d.to_wire()).to_wire() == \
        d.to_wire()
    with pytest.raises(ValueError):
        t_resilience.Deadline.from_wire("soon")


@pytest.mark.parametrize("obj", [
    {"op": "ping"},
    {"op": "sweep", "cpu_request_milli": [1, 2], "token": "é"},
    {"ok": True, "result": {"totals": [1, 2, 3]}, "generation": 4},
])
def test_protocol_frames_are_the_jax_bytes(obj):
    frames = []
    for mod in (j_protocol, t_protocol):
        a, b = socket.socketpair()
        try:
            a.settimeout(10)
            b.settimeout(10)
            mod.send_msg(a, obj)
            a.shutdown(socket.SHUT_WR)
            chunks = []
            while chunk := b.recv(65536):
                chunks.append(chunk)
            frames.append(b"".join(chunks))
        finally:
            a.close()
            b.close()
    assert frames[0] == frames[1]
    a, b = socket.socketpair()
    try:
        b.settimeout(10)
        a.sendall(frames[0])
        assert t_protocol.recv_msg(b) == obj
    finally:
        a.close()
        b.close()
