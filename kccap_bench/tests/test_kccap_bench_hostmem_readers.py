"""The readers of the host-memory gauges (layer "Server process host
memory") on a copy of the recorded artifact file with the program's
``kccap_hostmem_*`` families added: the set-up milestones as the program
files them, and ``at="now"`` and the allocator growing by a known step at
each mark."""

from __future__ import annotations

import copy
import json
import os

import pytest

from kccap_bench import spec
from kccap_bench.tests.conftest import REPO

with open(os.path.join(os.path.dirname(__file__), "data",
                       "artifacts.json")) as f:
    ARTIFACTS = json.load(f)

MIB = 1 << 20
MARK_K = {"start": 1, "trace_start": 2, "trace_stop": 3, "end": 5}
MILESTONES = {"import": 4700, "pack_start": 4760, "pack_end": 4790,
              "served": 4800, "store_start": 4850, "store_built": 4912}
FIRST = {"cuda_i32_rcp_fused": 3.5, "torch_int64": 14.5}
READERS = ("rss_floor_mib", "rss_served_mib", "rss_first_dispatch_mib",
           "rss_store_build_mib", "rss_window_growth_mib",
           "peak_window_growth_mib", "malloc_free_held_mib")
CELLS = ["k5k-gpu.multi1k", "k5k-gpu.churn", "k5k-ref.sweep1k",
         "k5k-ref.sweep1k-decimal"]


def read(name, artifacts):
    return spec.load_module(REPO, "metrics", name).read(artifacts)


def with_hostmem(milestones=MILESTONES, first=FIRST, free_held=40.0):
    """The artifact file with the hostmem families in the process registry
    at every mark: the milestones and first dispatches as given (MiB),
    ``rss{now}`` 5,000 + 10k MiB and ``peak{now}`` 5,100 + 2k MiB at the
    mark numbered k, ``malloc{free_held}`` ``free_held`` MiB times k."""
    a = copy.deepcopy(ARTIFACTS)
    for mark, k in MARK_K.items():
        fams = a["marks"][mark]["process"]
        for kind, now in (("rss", 5000 + 10 * k), ("peak", 5100 + 2 * k)):
            values = {f'at="{at}"': mib * MIB
                      for at, mib in milestones.items()}
            values['at="now"'] = now * MIB
            fams[f"kccap_hostmem_{kind}_bytes"] = {"type": "gauge",
                                                   "values": values}
        fams["kccap_hostmem_first_dispatch_bytes"] = {
            "type": "gauge",
            "values": {f'kernel="{kernel}"': mib * MIB
                       for kernel, mib in first.items()}}
        fams["kccap_hostmem_malloc_bytes"] = {
            "type": "gauge",
            "values": {'kind="arena"': 900.0 * MIB,
                       'kind="mmap"': 30.0 * MIB,
                       'kind="in_use"': 860.0 * MIB,
                       'kind="free_held"': free_held * k * MIB}}
    return a


def test_the_milestone_readers():
    a = with_hostmem()
    assert read("rss_floor_mib", a) == 4700
    assert read("rss_served_mib", a) == 100
    assert read("rss_store_build_mib", a) == 62


def test_first_dispatch_is_the_sum_over_the_labels():
    assert read("rss_first_dispatch_mib", with_hostmem()) == 18.0
    assert read("rss_first_dispatch_mib", with_hostmem(first={})) == 0.0


def test_the_window_readers_read_start_to_trace_start():
    a = with_hostmem()
    assert read("rss_window_growth_mib", a) == 10
    assert read("peak_window_growth_mib", a) == 2
    assert read("malloc_free_held_mib", a) == 80


def test_a_store_never_built_reads_nothing():
    milestones = {k: v for k, v in MILESTONES.items()
                  if not k.startswith("store")}
    a = with_hostmem(milestones=milestones)
    assert read("rss_store_build_mib", a) is None
    assert read("rss_served_mib", a) == 100


def test_free_held_unknowable_reads_nothing():
    assert read("malloc_free_held_mib", with_hostmem(free_held=-1.0 / MIB)) \
        is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_gauges_reads_nothing(name):
    assert read(name, ARTIFACTS) is None


def test_an_untraced_run_has_no_window_reading():
    a = with_hostmem()
    del a["marks"]["trace_start"], a["marks"]["trace_stop"]
    for name in ("rss_window_growth_mib", "peak_window_growth_mib",
                 "malloc_free_held_mib"):
        assert read(name, a) is None
    assert read("rss_floor_mib", a) == 4700


def test_each_reader_is_a_benchmark_metric_of_its_cells():
    bench = spec.load_benchmark(REPO)
    by_name = {m["name"]: m for m in bench["per_layer"]}
    assert {w["name"] for w in bench["workloads"]} >= set(CELLS)
    for name in READERS:
        m = by_name[name]
        assert (m["unit"], m["better"], m["source"], m["layer"],
                m["moves"]) == ("MiB", "lower", "program_counter",
                                "Server process host memory",
                                "server_rss_peak_mib"), name
        want = (["k5k-gpu.churn"] if name == "rss_store_build_mib"
                else CELLS)
        assert m["workloads"] == want, name
