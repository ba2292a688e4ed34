"""The readers of the server's host phases (``decode``, ``reply``,
``queue_wait``, ``proof``, ``stage``, ``batch_wait``, ``lock_wait``,
``apply``, ``repack``) on a copy of the recorded artifact file with
those phases added: each family is k times a base at the mark numbered k
(start 1, trace_start 2, trace_stop 3, end 5), so a reader's value is
the base seconds over the base count of the op's requests (sweep 100,
sweep_multi 50, update 20)."""

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

MARK_K = {"start": 1, "trace_start": 2, "trace_stop": 3, "end": 5}
REQUESTS = {"sweep": 100, "sweep_multi": 50, "update": 20}
# reader -> (phase, the op it reads; None for the cell's query op)
READERS = {
    "decode_ms": ("decode", None),
    "reply_ms": ("reply", None),
    "queue_wait_ms": ("queue_wait", None),
    "proof_ms": ("proof", None),
    "stage_ms": ("stage", None),
    "batch_wait_ms": ("batch_wait", "sweep"),
    "lock_wait_ms": ("lock_wait", "sweep"),
    "update_apply_ms": ("apply", "update"),
    "update_repack_ms": ("repack", "update"),
}


def read(name, artifacts):
    return spec.load_module(REPO, "metrics", name).read(artifacts)


def with_phases(bases: dict, query_op: str = "sweep") -> dict:
    """The artifact file with ``{(op, phase): base seconds}`` added to
    ``kccap_phase_seconds`` at every mark, 10 intervals a base."""
    a = copy.deepcopy(ARTIFACTS)
    a["cell"]["query_op"] = query_op
    for mark, k in MARK_K.items():
        fam = a["marks"][mark]["server"]["kccap_phase_seconds"]["values"]
        for (op, phase), base in bases.items():
            fam[f'op="{op}",phase="{phase}"'] = {
                "buckets": {"+Inf": 10 * k}, "sum": base * k,
                "count": 10 * k}
    return a


CASES = [(name, op or query_op, query_op)
         for name, (_, op) in READERS.items()
         for query_op in (("sweep", "sweep_multi") if op is None
                          else ("sweep",))]


@pytest.mark.parametrize("name,op,query_op", CASES,
                         ids=[f"{n}-{q}" for n, _, q in CASES])
def test_reader_reads_its_phase_over_the_ops_requests(name, op, query_op):
    phase = READERS[name][0]
    # The same phase under the other ops, which the reader must not read.
    others = {(o, phase): 9.0 for o in REQUESTS if o != op}
    a = with_phases({(op, phase): 0.02, **others}, query_op)
    assert read(name, a) == pytest.approx(0.02 / REQUESTS[op] * 1e3)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_returns_nothing_without_the_phase(name):
    # A program that records no such phase, as one older than the
    # reader, with the requests counted all the same.
    assert read(name, copy.deepcopy(ARTIFACTS)) is None
    # Another phase of the same op is not this one.
    phase, op = READERS[name]
    other = "serialize" if phase != "serialize" else "devcache"
    assert read(name, with_phases({(op or "sweep", other): 0.02})) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_returns_nothing_with_no_registry(name):
    phase, op = READERS[name]
    a = with_phases({(op or "sweep", phase): 0.02})
    for mark in a["marks"].values():
        mark["server"] = {}
    assert read(name, a) is None


def test_every_reader_is_a_benchmark_metric_of_its_cells():
    bench = spec.load_benchmark(REPO)
    by_name = {m["name"]: m for m in bench["per_layer"]}
    for name, (_, op) in READERS.items():
        m = by_name[name]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == (
            "ms", "lower", "program_span", "server_rss_peak_mib")
        want = (["k5k-gpu.multi1k", "k5k-gpu.churn"] if op is None
                else ["k5k-gpu.churn"])
        assert m["workloads"] == want, name
