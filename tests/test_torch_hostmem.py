"""The host-memory gauges (``telemetry/hostmem.py``): the set-up milestones
of a server process in order, each route label's first dispatch filed once,
the store's build only after an ``update``, ``mallinfo2``'s kinds, nothing
under ``KCCAP_TELEMETRY=0``, and none of the families in the Prometheus
text.  The milestones are once a process, so the server runs in a child
process of its own."""

import json
import os
import subprocess
import sys

import pytest

from kubernetesclustercapacity_tpu_torch.telemetry import hostmem
from kubernetesclustercapacity_tpu_torch.telemetry.exposition import (
    render_text,
)
from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
    REGISTRY,
    MetricsError,
    MetricsRegistry,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("kccap_hostmem_rss_bytes", "kccap_hostmem_peak_bytes",
            "kccap_hostmem_first_dispatch_bytes", "kccap_hostmem_malloc_bytes")
MIB = 1 << 20

# The server process: each step keeps the hostmem families of the process
# registry as ``{family: {label value: value}}``.
CHILD = r"""
import json

from kubernetesclustercapacity_tpu_torch.telemetry.metrics import REGISTRY

steps = {}


def keep(step):
    steps[step] = {
        name: {block.split("=", 1)[1].strip('"'): value
               for block, value in fam["values"].items()}
        for name, fam in REGISTRY.snapshot().items()
        if name.startswith("kccap_hostmem_")}


keep("import")
from kubernetesclustercapacity_tpu_torch import (
    snapshot_from_fixture, synthetic_fixture)
from kubernetesclustercapacity_tpu_torch.service import (
    CapacityClient, CapacityServer)

fixture = synthetic_fixture(64, seed=3)
snap = snapshot_from_fixture(fixture, semantics="strict")
keep("pack")
server = CapacityServer(snap, fixture=fixture, device="cpu", port=0)
server.start()
keep("served")
mib = [64 << 20, 512 << 20, 2 << 30]
with CapacityClient(*server.address) as client:
    for step, mem in (("b1", mib), ("b1_again", mib),
                      ("exact", [65_000_000, 513_000_000, 2_001_000_000])):
        client.sweep(cpu_request_milli=[100, 250, 500],
                     mem_request_bytes=mem, replicas=[1, 5, 50])
        keep(step)
    client.sweep_multi(["cpu", "memory"], [[250, 256 << 20], [500, 1 << 30]],
                       replicas=[5, 50])
    keep("multi")
    client.update([{"type": "DELETED", "kind": "Node",
                    "object": {"name": fixture["nodes"][0]["name"]}}])
    keep("update")
server.shutdown()
print(json.dumps(steps))
"""


def _run_child(**env):
    out = subprocess.run(
        [sys.executable, "-c", CHILD], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO, **env})
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def steps():
    return _run_child()


def test_importing_the_package_touches_no_registry(steps):
    assert steps["import"] == {}


def test_the_milestones_are_set_in_order(steps):
    rss = "kccap_hostmem_rss_bytes"
    peak = "kccap_hostmem_peak_bytes"
    assert set(steps["pack"][rss]) == {"now", "import", "pack_start",
                                       "pack_end"}
    assert set(steps["served"][rss]) == set(steps["pack"][rss]) | {"served"}
    order = ("import", "pack_start", "pack_end", "served")
    # the peak never falls, and the resident set grew from import to served
    peaks = [steps["served"][peak][at] for at in order]
    assert peaks == sorted(peaks)
    assert 0 < steps["served"][rss]["import"] <= steps["served"][rss]["served"]
    # a milestone is set once: the later steps read the same values
    for step in ("b1", "exact", "multi", "update"):
        for at in order:
            assert steps[step][rss][at] == steps["served"][rss][at]
            assert steps[step][peak][at] == steps["served"][peak][at]


def test_now_reads_the_process_at_each_reading(steps):
    rss = steps["update"]["kccap_hostmem_rss_bytes"]
    peak = steps["update"]["kccap_hostmem_peak_bytes"]
    assert rss["now"] > 0 and peak["now"] >= peak["served"]


def test_each_route_labels_first_dispatch_is_filed_once(steps):
    first = "kccap_hostmem_first_dispatch_bytes"
    assert first not in steps["served"] or steps["served"][first] == {}
    assert set(steps["b1"][first]) == {"plain_i32_rcp_fused"}
    assert steps["b1_again"][first] == steps["b1"][first]
    assert set(steps["exact"][first]) == {"plain_i32_rcp_fused",
                                          "torch_int64"}
    assert steps["exact"][first]["plain_i32_rcp_fused"] == \
        steps["b1"][first]["plain_i32_rcp_fused"]
    assert set(steps["multi"][first]) == {"plain_i32_rcp_fused",
                                          "torch_int64",
                                          "plain_multi_i32_rcp_fused"}
    for value in steps["multi"][first].values():
        assert abs(value) < 1 << 30


def test_the_store_gauges_appear_only_after_an_update(steps):
    rss = "kccap_hostmem_rss_bytes"
    for step in ("served", "b1", "exact", "multi"):
        assert not {"store_start", "store_built"} & set(steps[step][rss])
    after = steps["update"][rss]
    assert after["served"] <= after["store_start"]
    assert {"store_start", "store_built"} <= set(after)


def test_mallinfo2s_kinds_are_filed(steps):
    kinds = steps["update"]["kccap_hostmem_malloc_bytes"]
    assert set(kinds) == {"arena", "mmap", "in_use", "free_held"}
    assert kinds["in_use"] > 0 and kinds["free_held"] >= 0
    assert kinds["arena"] > 0 and kinds["mmap"] >= 0


def test_nothing_registers_with_telemetry_off():
    steps = _run_child(KCCAP_TELEMETRY="0")
    assert set(steps) == {"import", "pack", "served", "b1", "b1_again",
                          "exact", "multi", "update"}
    assert all(reading == {} for reading in steps.values())


def test_free_held_reads_minus_one_without_mallinfo2(monkeypatch):
    monkeypatch.setattr(hostmem, "_mallinfo2", lambda: None)
    for kind in hostmem.MALLOC_KINDS:
        assert hostmem.malloc_bytes(kind) == -1.0
    hostmem._metrics()
    values = REGISTRY.snapshot()["kccap_hostmem_malloc_bytes"]["values"]
    assert values['kind="free_held"'] == -1.0


def test_malloc_bytes_read_glibcs_mallinfo2():
    if hostmem._mallinfo2() is None:
        pytest.skip("this C library has no mallinfo2")
    info = hostmem._mallinfo2()()
    # glibc: what its arenas took from the system is in use or held free
    assert info.uordblks + info.fordblks == info.arena
    def held():
        return hostmem.malloc_bytes("in_use") + hostmem.malloc_bytes("mmap")

    before = held()
    # in the heap or mapped on its own, as the allocator's threshold says
    block = bytearray(8 * MIB)
    assert held() - before >= 8 * MIB
    del block


def test_no_hostmem_family_is_in_the_prometheus_text():
    hostmem._metrics()
    assert set(FAMILIES) <= set(REGISTRY.snapshot())
    assert "kccap_hostmem" not in render_text(REGISTRY)


def test_a_gauge_kept_out_of_the_scrape_is_in_the_snapshot():
    reg = MetricsRegistry()
    reg.gauge("kccap_x", "x", ("a",), scrape=False).labels(a="1").set(2.0)
    reg.gauge("kccap_y", "y").set(3.0)
    assert reg.snapshot()["kccap_x"]["values"] == {'a="1"': 2.0}
    text = render_text(reg)
    assert "kccap_y 3" in text and "kccap_x" not in text
    with pytest.raises(MetricsError):
        reg.gauge("kccap_x", "x", ("a",))


def test_a_dispatch_after_the_first_reads_nothing(monkeypatch):
    hostmem.dispatch_end("test_label", hostmem.dispatch_start("test_label"))
    calls = []
    monkeypatch.setattr(hostmem, "rss_bytes", lambda: calls.append(1) or 0.0)
    assert hostmem.dispatch_start("test_label") is None
    hostmem.dispatch_end("test_label", None)
    assert calls == []
