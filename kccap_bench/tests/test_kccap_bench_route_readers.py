"""The readers of the route counter (``exact_roofline``,
``fused_route_pct``) on a copy of the recorded artifact file with
``kccap_route_scenarios_total`` added: each child is k times a base at
the mark numbered k (start 1, trace_start 2, trace_stop 3, end 5), so a
reading over trace_start..trace_stop sees the base once and one over
start..end four times."""

from __future__ import annotations

import copy
import json
import os

import pytest

from kccap_bench import roofline, spec
from kccap_bench.counters import counter_delta, labels_of
from kccap_bench.tests.conftest import REPO

with open(os.path.join(os.path.dirname(__file__), "data",
                       "artifacts.json")) as f:
    ARTIFACTS = json.load(f)

MARK_K = {"start": 1, "trace_start": 2, "trace_stop": 3, "end": 5}
FAMILY = "kccap_route_scenarios_total"


def read(name, artifacts):
    return spec.load_module(REPO, "metrics", name).read(artifacts)


def with_routes(bases: dict, **cell) -> dict:
    """The artifact file with ``{(kernel, reason): base scenarios}`` in
    the process registry's route counter at every mark."""
    a = copy.deepcopy(ARTIFACTS)
    a["cell"].update(cell)
    for mark, k in MARK_K.items():
        a["marks"][mark]["process"][FAMILY] = {
            "type": "counter",
            "values": {f'kernel="{kernel}",reason="{reason}"': base * k
                       for (kernel, reason), base in bases.items()}}
    return a


DECIMAL = {("torch_int64", "mem_not_kib"): 30_000.0,
           ("torch_int64_grouped", "mem_not_kib"): 2_000.0,
           ("torch_int64", "forced"): 1_000.0,
           ("cuda_i32_rcp_fused", "eligible"): 99_000.0,
           ("torch_int64_multi", "row_scale"): 7_000.0}


@pytest.mark.parametrize("live", [5000, 4750])
def test_exact_roofline_is_the_exact_sweeps_least_time_over_kernel_time(
        live):
    a = with_routes(DECIMAL, live_nodes=live)
    # 33,000 exact scenarios in the traced window: 33 requests of 1,000;
    # B1's and the R-resource program's scenarios are not this program's.
    want = 33 * roofline.sweep_bound_s(5000, live, 1000, "reference")
    assert read("exact_roofline", a) == pytest.approx(
        want / a["trace"]["kernel_s"] * 100.0)


def test_exact_roofline_counts_the_traced_window_only():
    a = with_routes(DECIMAL)
    # The same counts at start and end as at the trace's marks: the
    # window's own delta is all that is read.
    for mark in ("start", "end"):
        a["marks"][mark]["process"][FAMILY]["values"] = {
            k: v * 100 for k, v in
            a["marks"][mark]["process"][FAMILY]["values"].items()}
    want = 33 * roofline.sweep_bound_s(5000, 5000, 1000, "reference")
    assert read("exact_roofline", a) == pytest.approx(want / 0.01 * 100.0)


@pytest.mark.parametrize("case", [
    "no_family", "b1_only", "multi_only", "no_kernel_time", "no_trace"])
def test_exact_roofline_returns_nothing_without_exact_scenarios_or_kernels(
        case):
    bases = {
        "no_family": None,
        "b1_only": {("cuda_i32_rcp_fused", "eligible"): 5_000.0},
        "multi_only": {("torch_int64_multi", "max_per_node"): 5_000.0},
    }.get(case, DECIMAL)
    a = copy.deepcopy(ARTIFACTS) if bases is None else with_routes(bases)
    if case == "no_kernel_time":
        a["trace"]["kernel_s"] = 0.0
    if case == "no_trace":
        a["trace"] = {}
    assert read("exact_roofline", a) is None


@pytest.mark.parametrize("scenarios", [1.0, 999.0, 1000.0, 2.5e6])
def test_exact_roofline_is_never_zero(scenarios):
    a = with_routes({("torch_int64", "mem_not_kib"): scenarios})
    assert read("exact_roofline", a) > 0.0


@pytest.mark.parametrize("b1,exact,want", [
    ({("cuda_i32_rcp_fused", "eligible"): 900.0}, {}, 100.0),
    ({("cuda_i32_rcp_fused", "eligible"): 600.0,
      ("cuda_i32_fused_grouped", "eligible"): 300.0},
     {("torch_int64", "mem_not_kib"): 100.0}, 90.0),
    ({("plain_i32_rcp_fused", "eligible"): 250.0},
     {("torch_int64_grouped", "total_bound"): 500.0,
      ("torch_int64", "forced"): 250.0}, 25.0),
    ({}, {("torch_int64", "mem_not_kib"): 1000.0}, 0.0),
])
def test_fused_route_pct_is_b1s_share_of_the_2_resource_scenarios(
        b1, exact, want):
    # The R-resource routes are another sweep's: never in the share.
    multi = {("cuda_multi_i32_rcp_fused", "eligible"): 4000.0,
             ("torch_int64_multi", "row_scale"): 4000.0}
    a = with_routes({**b1, **exact, **multi})
    assert read("fused_route_pct", a) == pytest.approx(want)


def test_fused_route_pct_reads_from_start_to_end():
    a = with_routes({("cuda_i32_rcp_fused", "eligible"): 900.0,
                     ("torch_int64", "mem_not_kib"): 100.0})
    # Scenarios before the window's start are not the window's.
    a["marks"]["start"]["process"][FAMILY]["values"][
        'kernel="torch_int64",reason="mem_not_kib"'] = 400.0
    # 3,600 B1 scenarios and 500 - 400 = 100 exact ones in the window.
    assert read("fused_route_pct", a) == pytest.approx(3600 / 3700 * 100)


@pytest.mark.parametrize("bases", [
    None, {("torch_int64_multi", "forced"): 50.0},
    {("cuda_multi_i32_rcp_fused", "eligible"): 50.0}])
def test_fused_route_pct_returns_nothing_without_a_2_resource_route(bases):
    a = copy.deepcopy(ARTIFACTS) if bases is None else with_routes(bases)
    assert read("fused_route_pct", a) is None


def test_counter_delta_sums_the_kept_children_between_two_marks():
    a = with_routes(DECIMAL)
    every = counter_delta(a, "start", "end", "process", FAMILY,
                          lambda labels: True)
    assert every == pytest.approx(4 * sum(DECIMAL.values()))
    forced = counter_delta(a, "trace_start", "trace_stop", "process", FAMILY,
                           lambda labels: labels["reason"] == "forced")
    assert forced == 1_000.0
    assert counter_delta(a, "start", "end", "server", FAMILY,
                         lambda labels: True) == 0


def test_labels_of_reads_an_escaped_label_block():
    assert labels_of('kernel="torch_int64",reason="mem_not_kib"') == {
        "kernel": "torch_int64", "reason": "mem_not_kib"}
    assert labels_of(r'a="x\"y",b=""') == {"a": r'x\"y', "b": ""}
    assert labels_of("") == {}


def test_each_reader_is_a_benchmark_metric_of_its_cells():
    bench = spec.load_benchmark(REPO)
    by_name = {m["name"]: m for m in bench["per_layer"]}
    want = {
        "exact_roofline": ("device_trace", "Kernels and exact program",
                           ["k5k-ref.sweep1k-decimal"]),
        "fused_route_pct": ("program_counter", "Dispatch",
                            ["k5k-ref.sweep1k", "k5k-gpu.churn"]),
    }
    cells = {w["name"] for w in bench["workloads"]}
    for name, (source, layer, workloads) in want.items():
        m = by_name[name]
        assert (m["unit"], m["better"], m["source"], m["layer"],
                m["moves"], m["workloads"]) == (
            "%", "higher", source, layer, "server_rss_peak_mib", workloads)
        assert set(workloads) <= cells
