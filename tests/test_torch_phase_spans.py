"""The port's phase clock over the server's host work, on the CPU and over a
real socket.

Each served request's phases land in ``kccap_phase_seconds{op,phase}``:
the handler's own ``decode`` and ``reply``, the dispatch lock's
``lock_wait``, the kernels' eligibility ``proof`` and per-call ``stage``,
and ``update``'s ``apply`` and ``repack``.  A sweep queued behind a slow
``update`` carries the wait in ``lock_wait``; slow staging lands in
``stage`` and not in ``device_exec``, while the dispatch's
``kccap_kernel_steady_seconds`` keeps the whole interval.  Under a CPU
``torch.profiler`` recording every thread, each phase block is a
``kccap.<phase>`` user annotation on the handler thread, and a collection
is a ``kccap.gc.gen<N>`` one; with no profiler ``record_function`` is never
entered, and under ``KCCAP_TELEMETRY=0`` nothing is recorded.

Servers bind 127.0.0.1 on port 0, every client has a timeout, every
server is shut down by its fixture, and no latency is asserted beyond the
injected delays' floors.
"""

import gc
import json
import threading
import time

import pytest
import torch

from kubernetesclustercapacity_tpu_torch.ops import fused_fit, fused_multi
from kubernetesclustercapacity_tpu_torch.service.client import CapacityClient
from kubernetesclustercapacity_tpu_torch.service import server as t_server
from kubernetesclustercapacity_tpu_torch.service.server import CapacityServer
from kubernetesclustercapacity_tpu_torch.sources import resolve_source
from kubernetesclustercapacity_tpu_torch.store import ClusterStore
from kubernetesclustercapacity_tpu_torch.telemetry import phases
from kubernetesclustercapacity_tpu_torch.telemetry import process as t_process
from kubernetesclustercapacity_tpu_torch.telemetry.metrics import REGISTRY

KIND = "tests/fixtures/kind-3node.json"
TIMEOUT_S = 120.0
DELAY_S = 0.05

SWEEP = {"cpu_request_milli": [100, 250, 500],
         "mem_request_bytes": [2**20, 2**22, 2**24], "replicas": [1, 2, 3]}
MULTI = {"resources": ["cpu", "memory"],
         "requests": [[100, 2**20], [250, 2**22], [500, 2**24]],
         "replicas": [1, 2, 3]}
HANDLER = {"decode", "reply"}


def _pod(i: int, node: str) -> dict:
    return {"type": "ADDED", "kind": "Pod", "object": {
        "name": f"spans-{i}", "namespace": "default", "nodeName": node,
        "phase": "Running", "containers": [{"resources": {
            "requests": {"cpu": "10m", "memory": "16Mi"}}}]}}


class Served:
    """A strict, fixture-backed port server and one client to it."""

    def __init__(self, batch_window_ms: float = 0) -> None:
        fixture, snap, _ = resolve_source(KIND, "strict")
        self.node = fixture["nodes"][0]["name"]
        self.server = CapacityServer(snap, fixture=fixture, device="cpu",
                                     port=0, batch_window_ms=batch_window_ms)
        self.server.start()
        self.client = self.connect()
        self._pods = 0

    def connect(self) -> CapacityClient:
        return CapacityClient(*self.server.address, timeout_s=TIMEOUT_S,
                              retry=None)

    def call(self, op: str, client=None) -> dict:
        client = client or self.client
        if op == "sweep":
            return client.sweep(**SWEEP)
        if op == "sweep_multi":
            return client.sweep_multi(**MULTI)
        self._pods += 1
        return client.update([_pod(self._pods, self.node)])

    def phases(self) -> dict:
        fam = self.server.registry.snapshot().get("kccap_phase_seconds", {})
        out = {}
        for key, child in fam.get("values", {}).items():
            op, phase = (part.split('"')[1] for part in key.split(","))
            out[op, phase] = (child["sum"], child["count"])
        return out

    def served(self, op: str, before: dict, calls: int = 1) -> dict:
        """``{phase: (seconds, count)}`` recorded for ``op`` since
        ``before``, once the handler has filed its ``reply`` (after the
        send, so shortly after the client has the answer)."""
        deadline = time.monotonic() + 10.0
        while True:
            now = self.phases()
            delta = {ph: (s - before.get((o, ph), (0.0, 0))[0],
                          c - before.get((o, ph), (0.0, 0))[1])
                     for (o, ph), (s, c) in now.items() if o == op}
            delta = {ph: v for ph, v in delta.items() if v[1] > 0}
            if delta.get("reply", (0, 0))[1] >= calls or \
                    time.monotonic() > deadline:
                return delta

    def close(self) -> None:
        self.client.close()
        self.server.shutdown()


@pytest.fixture
def served():
    made = []

    def make(**kw):
        made.append(Served(**kw))
        return made[-1]

    yield make
    for s in made:
        s.close()


# The phases each route records once warm (a label's first dispatch files
# its launch and fetch as ``compile``): the handler's two, the slot and
# the lock, the proof and the staging, the launch, the fetch and the
# reply build; a sweep through the micro-batcher also waits out its
# window (alone in it, it then takes the solo path); an update applies
# and repacks under the lock.
ROUTES = {
    "sweep": ("sweep", 0, HANDLER | {
        "queue_wait", "lock_wait", "proof", "stage", "device_exec", "fetch",
        "serialize"}),
    "sweep-batched": ("sweep", 1, HANDLER | {
        "queue_wait", "lock_wait", "batch_wait", "proof", "stage",
        "device_exec", "fetch", "serialize"}),
    "sweep_multi": ("sweep_multi", 0, HANDLER | {
        "queue_wait", "lock_wait", "proof", "stage", "device_exec", "fetch",
        "serialize"}),
    "update": ("update", 0, HANDLER | {"lock_wait", "apply", "repack"}),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_served_requests_record_the_host_phases_under_their_op(served,
                                                               route):
    op, window, want = ROUTES[route]
    s = served(batch_window_ms=window)
    s.call(op)  # warm: the label's first dispatch, the store's first build
    s.served(op, {})  # its reply is filed after the send: wait for it
    before = s.phases()
    s.call(op)
    got = s.served(op, before)
    assert set(got) == want
    assert all(count == 1 for _, count in got.values()), got
    # decode and reply are the handler's, outside the dispatch clock: the
    # dispatch's phases still sum to at most the request's latency.
    lat = s.server.registry.snapshot()["kccap_request_latency_seconds"]
    assert sum(sec for ph, (sec, _) in got.items() if ph not in HANDLER) \
        <= lat["values"][f'op="{op}"']["sum"]


def test_unknown_ops_file_the_handler_phases_as_unknown(served):
    s = served()
    before = s.phases()
    with pytest.raises(Exception):
        s.client.call("no_such_op")
    assert HANDLER <= set(s.served("unknown", before))


def test_a_sweep_behind_a_slow_update_waits_in_lock_wait(served,
                                                         monkeypatch):
    s = served()
    s.call("update")  # builds the store
    s.call("sweep")
    apply = ClusterStore.apply
    reached = threading.Event()

    def slow_apply(store, events):
        reached.set()
        # Hold the lock until the sweep is seen waiting for it, then
        # DELAY_S longer.
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and not any(
                entry[2] == "lock_wait"
                for entry in phases.live_snapshot().values()):
            time.sleep(0.001)
        time.sleep(DELAY_S)
        return apply(store, events)

    monkeypatch.setattr(ClusterStore, "apply", slow_apply)
    before = s.phases()
    writer = s.connect()
    t = threading.Thread(target=s.call, args=("update", writer))
    t.start()
    try:
        assert reached.wait(30.0)
        s.call("sweep")
    finally:
        t.join(30.0)
        writer.close()
    sweep = s.served("sweep", before)
    update = s.served("update", before)
    assert sweep["lock_wait"][0] >= 0.8 * DELAY_S
    assert update["apply"][0] >= DELAY_S
    assert update["lock_wait"][0] < DELAY_S


class _FailingLock:
    def __enter__(self):
        raise RuntimeError("acquire interrupted")

    def __exit__(self, *exc):
        return False


def test_an_acquire_that_raises_still_closes_lock_wait():
    clk = phases.new_clock()
    prev = phases.activate(clk)
    try:
        with pytest.raises(RuntimeError, match="interrupted"):
            with t_server._lock_wait() as acquired, _FailingLock():
                acquired()
    finally:
        phases.restore(prev)
    assert threading.get_ident() not in phases.live_snapshot()
    assert [p for p, _ in clk.items()] == ["lock_wait"]


@pytest.mark.parametrize("op", ["sweep", "sweep_multi"])
def test_slow_staging_lands_in_stage_and_not_device_exec(served, monkeypatch,
                                                         op):
    s = served()
    reply = s.call(op)  # warm
    label = reply["kernel"]
    if op == "sweep":
        module, name = fused_fit, "scenario_reciprocals"
    else:
        module, name = fused_multi, "stage_multi_operands"
    real = getattr(module, name)

    def slow(*a, **kw):
        time.sleep(DELAY_S)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, slow)

    def steady():
        fam = REGISTRY.snapshot()["kccap_kernel_steady_seconds"]["values"]
        return fam[f'kernel="{label}"']["sum"]

    before, steady0 = s.phases(), steady()
    s.call(op)
    got = s.served(op, before)
    assert got["stage"][0] >= DELAY_S
    assert got["device_exec"][0] < DELAY_S
    # The dispatch's own interval still runs from the staging's start.
    assert steady() - steady0 >= DELAY_S + got["device_exec"][0]


def _profiled(s: Served, ops) -> tuple[list, set]:
    """The chrome trace's events while ``ops`` are served and a
    collection is forced, and the handler threads' native ids."""
    handlers = set()
    dispatch = s.server.dispatch

    def spy(msg):
        handlers.add(threading.get_native_id())
        return dispatch(msg)

    s.server.dispatch = spy
    from torch.profiler import ProfilerActivity, profile

    prof = profile(
        activities=[ProfilerActivity.CPU],
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))
    prof.start()
    try:
        for op in ops:
            s.call(op)
        gc.collect()
    finally:
        prof.stop()
    return prof, handlers


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_phases_are_user_annotations_on_the_handler_thread(served, tmp_path,
                                                           route):
    op, window, want = ROUTES[route]
    s = served(batch_window_ms=window)
    s.call(op)
    prof, handlers = _profiled(s, [op])
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    # A collection may land on a handler thread inside the window: the
    # collector's ``kccap.gc.*`` marks are checked on their own below.
    on_handler = {e["name"] for e in events
                  if e.get("cat") == "user_annotation"
                  and e.get("tid") in handlers
                  and e.get("name", "").startswith("kccap.")
                  and not e["name"].startswith("kccap.gc.")}
    assert on_handler == {f"kccap.{p}" for p in want}
    assert any(e.get("cat") == "user_annotation"
               and e.get("name") == "kccap.gc.gen2" for e in events)
    # No device events: the annotations are host-side only.
    assert not any(e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   for e in events)


class _Forbidden:
    entered = 0

    def __init__(self, name):
        type(self).entered += 1
        raise AssertionError(f"record_function({name!r}) with no profiler")


def test_no_profiler_enters_no_record_function(served, monkeypatch):
    s = served(batch_window_ms=1)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        _Forbidden)
    assert not torch.autograd.profiler._is_profiler_enabled
    for op in ("sweep", "sweep_multi", "update", "sweep"):
        s.call(op)
    gc.collect()
    assert _Forbidden.entered == 0
    assert t_process._gc_annotate in gc.callbacks


def test_telemetry_off_records_nothing(served, monkeypatch):
    monkeypatch.setenv("KCCAP_TELEMETRY", "0")
    assert phases.new_clock() is phases.NULL_CLOCK
    s = served(batch_window_ms=1)
    for op in ("sweep", "sweep_multi", "update"):
        s.call(op)
    time.sleep(0.05)
    assert s.phases() == {}
    assert phases.live_snapshot() == {}


def test_collections_inside_phase_blocks_under_a_profiler_stall_nothing(
        served):
    """Collections forced every few allocations, so many start inside a
    phase block (the live table's lock held, an annotation open) on
    every handler thread, while a profiler records: every request of
    more clients than cores is answered."""
    import os
    import sys

    from torch.profiler import ProfilerActivity, profile

    s = served(batch_window_ms=1)
    s.call("sweep")
    clients = max(8, 2 * (os.cpu_count() or 1))
    calls = 20
    done = []

    def client():
        c = s.connect()
        try:
            for _ in range(calls):
                s.call("sweep", c)
                done.append(1)
        finally:
            c.close()

    prof = profile(
        activities=[ProfilerActivity.CPU],
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))
    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(clients)]
    thresholds, interval = gc.get_threshold(), sys.getswitchinterval()
    prof.start()
    gc.set_threshold(5, 1, 1)
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
    finally:
        sys.setswitchinterval(interval)
        gc.set_threshold(*thresholds)
        prof.stop()
    assert not any(t.is_alive() for t in threads)
    assert len(done) == clients * calls
