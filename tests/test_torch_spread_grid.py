"""The grid form of ``topology_spread`` against the benchmark's plain
reference, and what it files for the benchmark to read.

``CapacityModel.topology_spread_grid`` and the server's ``topology_spread``
op over a socket give, to the unit, what ``kccap_bench/reference/spread.py``
gives on seeded small zoned fixtures: strict fits, NoSchedule taints,
unhealthy nodes, nodes without the key, ``max_skew`` 1 and 3, a zone
whose nodes are all tainted, one whose nodes are all unhealthy, and fits
far above the replicas asked.  A served grid request adds one dispatch
and its scenarios to the route counter under ``torch_int64_per_node`` /
``topology_spread``, records ``domains``, ``device_exec`` and ``fetch``
under its op, and files one first-dispatch reading; the Prometheus text
stays the JAX server's.  Servers bind 127.0.0.1 on port 0 and every
client has a timeout.
"""

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from kccap_bench.reference import pack
from kccap_bench.reference.spread import spread_totals, zone_members
from kubernetesclustercapacity_tpu_torch import (
    snapshot_from_fixture,
    synthetic_fixture,
)
from kubernetesclustercapacity_tpu_torch.models import CapacityModel
from kubernetesclustercapacity_tpu_torch.scenario import ScenarioGrid
from kubernetesclustercapacity_tpu_torch.service.client import CapacityClient
from kubernetesclustercapacity_tpu_torch.service.server import CapacityServer
from kubernetesclustercapacity_tpu_torch.telemetry.exposition import (
    render_text,
)
from kubernetesclustercapacity_tpu_torch.telemetry.metrics import REGISTRY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = "topology.kubernetes.io/zone"
ROUTE = 'kernel="torch_int64_per_node",reason="topology_spread"'
TIMEOUT_S = 120.0
NODES = 60
SPECS = 40
MIB = 1 << 20


def zoned(seed, *, unhealthy_frac=0.05, taint_frac=0.1, unkeyed=0,
          tainted_zone=None, unhealthy_zone=None):
    """A strict fixture of ``NODES`` nodes over three zones (``tz-0``..
    ``tz-2``, round-robin), ``unkeyed`` of them stripped of the key, and
    every node of ``tainted_zone`` tainted NoSchedule or of
    ``unhealthy_zone`` under memory pressure."""
    fx = copy.deepcopy(synthetic_fixture(
        NODES, seed=seed, pods_per_node=6, unhealthy_frac=unhealthy_frac,
        taint_frac=taint_frac, topology=(3, 1)))
    rng = np.random.default_rng([seed, 1])
    for i in rng.choice(NODES, unkeyed, replace=False).tolist():
        del fx["nodes"][i]["labels"][KEY]
    for node in fx["nodes"]:
        zone = node["labels"].get(KEY)
        if zone is not None and zone == tainted_zone:
            node["taints"] = [{"key": "dedicated", "value": "batch",
                               "effect": "NoSchedule"}]
        if zone is not None and zone == unhealthy_zone:
            node["conditions"] = [
                {"type": c["type"],
                 "status": "True" if c["type"] in ("MemoryPressure",
                                                   "Ready") else "False"}
                for c in node["conditions"]]
    return fx


def specs(seed, small=False):
    """``(cpu, mem, replicas)`` of ``SPECS`` specs: cpu 50-4,000 m, memory
    64-8,192 MiB and replicas 1-500, or with ``small`` requests so small
    that every node's fit is far above the 1-5 replicas asked."""
    rng = np.random.default_rng([seed, 2])
    if small:
        return (rng.integers(1, 20, SPECS), rng.integers(1, 16, SPECS) * MIB,
                rng.integers(1, 6, SPECS))
    return (rng.integers(50, 4000, SPECS), rng.integers(64, 8192, SPECS) * MIB,
            rng.integers(1, 500, SPECS))


def reference(fx, cpu, mem, rep, max_skew):
    cols = pack.pack_strict(fx)
    return spread_totals(cols, fx, KEY, max_skew, np.stack([cpu, mem], 1),
                         rep)


def model_of(fx):
    snap = snapshot_from_fixture(fx, semantics="strict")
    return CapacityModel(snap, mode="strict", fixture=fx, device="cpu")


CASES = {
    "taints": (dict(taint_frac=0.25), 1, False),
    "unhealthy": (dict(unhealthy_frac=0.3), 1, False),
    "unkeyed": (dict(unkeyed=9), 1, False),
    "skew3": (dict(unkeyed=4), 3, False),
    "zone_all_tainted": (dict(tainted_zone="tz-0"), 1, False),
    "zone_all_tainted_skew3": (dict(tainted_zone="tz-1"), 3, False),
    "zone_all_unhealthy": (dict(unhealthy_zone="tz-2"), 1, False),
    "fits_above_replicas": (dict(), 1, True),
    "fits_above_replicas_skew3": (dict(unkeyed=6), 3, True),
}


@pytest.mark.parametrize("seed", [3, 2**33 + 7])
@pytest.mark.parametrize("case", sorted(CASES))
def test_grid_spread_equals_the_plain_reference(case, seed):
    kw, skew, small = CASES[case]
    fx = zoned(seed, **kw)
    cpu, mem, rep = specs(seed, small)
    totals, sched = model_of(fx).topology_spread_grid(
        ScenarioGrid(cpu_request_milli=cpu, mem_request_bytes=mem,
                     replicas=rep),
        topology_key=KEY, max_skew=skew)
    want_totals, want_sched = reference(fx, cpu, mem, rep, skew)
    assert totals.dtype == np.int64
    assert np.array_equal(totals, want_totals)
    assert np.array_equal(sched, want_sched)
    if case.startswith("zone_all_tainted"):
        # The tainted zone is a domain of capacity 0: the others take at
        # most max_skew each.
        assert (totals <= 2 * skew).all()
    if case.startswith("fits_above_replicas"):
        assert sched.all() and (totals > 10 * rep).all()


def test_the_cases_exercise_what_they_name():
    fx = zoned(3, **CASES["unkeyed"][0])
    cols = pack.pack_strict(fx)
    member, zones = zone_members(fx, cols, KEY)
    assert zones == 3
    keyed = [KEY in n["labels"] for n in fx["nodes"]]
    assert keyed.count(False) == 9
    assert (member[~np.asarray(keyed)] == -1).all()
    fx = zoned(3, **CASES["zone_all_unhealthy"][0])
    cols = pack.pack_strict(fx)
    assert zone_members(fx, cols, KEY)[1] == 2
    fx = zoned(3, **CASES["zone_all_tainted"][0])
    cols = pack.pack_strict(fx)
    zone0 = np.asarray([n["labels"][KEY] == "tz-0" for n in fx["nodes"]])
    assert not cols.mask[zone0].any()
    assert zone_members(fx, cols, KEY)[1] == 3


@pytest.fixture
def served():
    made = []

    def serve(fx):
        snap = snapshot_from_fixture(fx, semantics="strict")
        server = CapacityServer(snap, fixture=fx, device="cpu", port=0)
        server.start()
        client = CapacityClient(*server.address, timeout_s=TIMEOUT_S,
                                retry=None)
        made.append((server, client))
        return server, client

    yield serve
    for server, client in made:
        client.close()
        server.shutdown()


def _ask(client, cpu, mem, rep, skew):
    return client.topology_spread(
        KEY, cpu_request_milli=cpu.tolist(), mem_request_bytes=mem.tolist(),
        replicas=rep.tolist(), max_skew=skew)


@pytest.mark.parametrize("skew", [1, 3])
def test_the_served_op_equals_the_plain_reference(served, skew):
    fx = zoned(11, unkeyed=5, tainted_zone="tz-2" if skew == 3 else None)
    _, client = served(fx)
    for small in (False, True):
        cpu, mem, rep = specs(11 + small, small)
        reply = _ask(client, cpu, mem, rep, skew)
        want_totals, want_sched = reference(fx, cpu, mem, rep, skew)
        assert reply["totals"] == want_totals.tolist()
        assert reply["schedulable"] == want_sched.tolist()
        assert reply["scenarios"] == SPECS


def _routes():
    out = {}
    for fam in ("kccap_route_dispatches_total", "kccap_route_scenarios_total"):
        out[fam] = REGISTRY.snapshot().get(fam, {}).get("values", {}).get(
            ROUTE, 0.0)
    return out


def _phases(server, op):
    fam = server.registry.snapshot().get("kccap_phase_seconds", {})
    out = {}
    for key, child in fam.get("values", {}).items():
        o, phase = (part.split('"')[1] for part in key.split(","))
        if o == op:
            out[phase] = child["count"]
    return out


def _phases_after(server, before, want, deadline_s=10.0):
    """The op's phase counts, once each of ``want`` has grown past
    ``before`` (the handler files them after the dispatch)."""
    deadline = time.monotonic() + deadline_s
    while True:
        now = _phases(server, "topology_spread")
        if all(now.get(p, 0) > before.get(p, 0) for p in want) or \
                time.monotonic() > deadline:
            return now


def test_a_served_grid_request_is_counted_and_phased_once(served):
    server, client = served(zoned(5))
    cpu, mem, rep = specs(5)
    _ask(client, cpu, mem, rep, 1)  # the label's first dispatch
    phased = {"domains", "device_exec", "fetch"}
    before_phases = _phases_after(server, {}, phased)
    before = _routes()
    _ask(client, cpu[:17], mem[:17], rep[:17], 1)
    after = _routes()
    assert after["kccap_route_dispatches_total"] == \
        before["kccap_route_dispatches_total"] + 1
    assert after["kccap_route_scenarios_total"] == \
        before["kccap_route_scenarios_total"] + 17
    now = _phases_after(server, before_phases, phased)
    for phase in phased:
        assert now[phase] == before_phases[phase] + 1, phase


def test_the_scalar_op_takes_no_count_of_the_per_node_route(served):
    _, client = served(zoned(6))
    before = _routes()
    reply = client.topology_spread(KEY, cpuRequests="200m",
                                   memRequests="250mb", replicas="3")
    assert "zones" in reply
    assert _routes() == before


# The first dispatch is filed once a process: the server runs in a child.
CHILD = r"""
import json, sys

import numpy as np

from kubernetesclustercapacity_tpu_torch import (
    snapshot_from_fixture, synthetic_fixture)
from kubernetesclustercapacity_tpu_torch.service import (
    CapacityClient, CapacityServer)
from kubernetesclustercapacity_tpu_torch.telemetry.exposition import (
    render_text)
from kubernetesclustercapacity_tpu_torch.telemetry.metrics import REGISTRY

FAMILY = "kccap_hostmem_first_dispatch_bytes"


def first():
    return dict(REGISTRY.snapshot().get(FAMILY, {}).get("values", {}))


fixture = synthetic_fixture(48, seed=4, taint_frac=0.1, topology=(3, 1))
snap = snapshot_from_fixture(fixture, semantics="strict")
server = CapacityServer(snap, fixture=fixture, device="cpu", port=0)
server.start()
steps = {"served": first()}
grid = {"cpu_request_milli": [100, 250, 500],
        "mem_request_bytes": [1 << 26, 1 << 28, 1 << 30],
        "replicas": [1, 5, 50]}
with CapacityClient(*server.address, timeout_s=120) as client:
    for step in ("spread", "spread_again"):
        client.topology_spread("topology.kubernetes.io/zone", **grid)
        steps[step] = first()
steps["process_text"] = render_text(REGISTRY)
steps["server_text"] = render_text(server.registry)
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


def test_the_first_grid_dispatch_files_one_reading():
    steps = _run_child()
    label = 'kernel="torch_int64_per_node"'
    assert label not in steps["served"]
    assert label in steps["spread"]
    assert abs(steps["spread"][label]) < 1 << 30
    assert steps["spread_again"] == steps["spread"]
    for text in (steps["process_text"], steps["server_text"]):
        assert "kccap_hostmem" not in text and "kccap_route" not in text
    off = _run_child(KCCAP_TELEMETRY="0")
    assert off["spread"] == off["spread_again"] == {}


def _families(text):
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def test_the_prometheus_text_stays_the_jax_servers():
    from kubernetesclustercapacity_tpu.service.server import (
        CapacityServer as JaxServer,
    )
    from kubernetesclustercapacity_tpu.snapshot import (
        snapshot_from_fixture as jax_snapshot,
    )
    from kubernetesclustercapacity_tpu.telemetry.exposition import (
        render_text as jax_render_text,
    )

    fx = zoned(8, unkeyed=3)
    cpu, mem, rep = specs(8)
    texts = []
    for server_cls, snap_of, render in (
            (JaxServer, jax_snapshot, jax_render_text),
            (CapacityServer, snapshot_from_fixture, render_text)):
        kw = {} if server_cls is JaxServer else {"device": "cpu"}
        server = server_cls(snap_of(fx, semantics="strict"), fixture=fx,
                            port=0, **kw)
        server.start()
        try:
            with CapacityClient(*server.address, timeout_s=TIMEOUT_S,
                                retry=None) as client:
                reply = _ask(client, cpu, mem, rep, 1)
            texts.append((reply, render(server.registry)))
        finally:
            server.shutdown()
    (j_reply, j_text), (t_reply, t_text) = texts
    assert t_reply["totals"] == j_reply["totals"]
    assert _families(t_text) <= _families(j_text), \
        sorted(_families(t_text) - _families(j_text))
    assert "kccap_route" not in render_text(REGISTRY)
