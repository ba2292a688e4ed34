"""Each metric reader on a recorded artifact file whose readings are
known: every family is k times a base at the mark numbered k (start 1,
trace_start 2, trace_stop 3, end 5)."""

from __future__ import annotations

import copy
import json
import os

import pytest

from kccap_bench import roofline, spec
from kccap_bench.tests.conftest import REPO

with open(os.path.join(os.path.dirname(__file__), "data",
                       "artifacts.json")) as f:
    ARTIFACTS = json.load(f)


def read(name, artifacts=ARTIFACTS):
    return spec.load_module(REPO, "metrics", name).read(artifacts)


def test_end_to_end_readers():
    assert read("answer_ms.p50") == 3.0
    assert read("update_to_answer_ms.p50") == pytest.approx(20.0)
    assert read("setup_s") == 12.5


def test_layer_readers():
    # the window holds 4x the base: 400 sweeps of 2 ms, 80 updates of 10 ms
    assert read("wire_ms") == pytest.approx(3.0 - 2.0)
    assert read("serialize_ms") == pytest.approx(0.3)
    assert read("devcache_ms") == pytest.approx(0.5 * 10 / 100)
    assert read("update_ms") == pytest.approx(10.0)
    assert read("fold_size") == pytest.approx(2.5)
    assert read("dispatch_ms") == pytest.approx(1.0)
    assert read("device_idle") == pytest.approx(97.5)
    # the collector: 0.63 s of collections in the 3 s from start to end
    assert read("gc_ms_per_s") == pytest.approx(210.0)


def test_roofline_readers_count_the_requests_of_the_traced_window():
    # trace_stop - trace_start: 100 sweeps and 50 sweep_multi requests
    want = 100 * roofline.sweep_bound_s(5000, 5000, 1000, "reference")
    assert read("sweep_roofline") == pytest.approx(want / 0.01 * 100)
    want = 50 * roofline.multi_bound_s(5000, 5000, 6000.0, 1000, 4,
                                       "reference")
    assert read("multi_roofline") == pytest.approx(want / 0.01 * 100)


def test_readers_with_nothing_to_read_return_nothing():
    empty = copy.deepcopy(ARTIFACTS)
    assert read("server_rss_peak_mib", empty) is None
    empty["trace"] = {}
    empty["load"]["update_to_answer_ms"] = []
    empty["load"]["wire"] = {}
    for mark in empty["marks"].values():
        mark["server"] = {}
        mark["process"] = {}
        del mark["gc"]
    for name in ("sweep_roofline", "multi_roofline", "device_idle",
                 "update_to_answer_ms.p50", "wire_ms", "serialize_ms",
                 "fold_size", "dispatch_ms", "devcache_ms", "update_ms",
                 "gc_ms_per_s"):
        assert read(name, empty) is None, name


def test_every_benchmark_metric_has_a_reader():
    bench = spec.load_benchmark(REPO)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.load_module(REPO, "metrics", m["name"]).read)


def test_gcwatch_times_each_collection_and_resets_its_longest_at_a_mark():
    import gc

    from kccap_bench.gcwatch import GcWatch

    watch = GcWatch()
    try:
        before = watch.mark()
        gc.collect()
        after = watch.mark()
        assert after["count"][2] == before["count"][2] + 1
        assert sum(after["total_s"]) > sum(before["total_s"])
        assert after["max_s"] > 0.0
        assert watch.mark()["max_s"] == 0.0
    finally:
        watch.stop()
    assert watch._callback not in gc.callbacks


def test_peak_rss_reader_reads_the_server_process_in_mib():
    artifacts = dict(ARTIFACTS, maxrss_kib=5 * 1024 * 1024)
    assert read("server_rss_peak_mib", artifacts) == 5 * 1024
    assert read("server_rss_peak_mib") is None

