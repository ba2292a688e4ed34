"""Shared set-up of the benchmark's own tests: copies of the benchmark,
with the ``k5k-ref`` cells added, and with its clusters cut to a size
the host runs in seconds."""

from __future__ import annotations

import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY_NODES = 300
TINY_RATE = 20


def copy_benchmark(dest: str) -> str:
    """``BENCHMARK.json`` and ``kccap_bench/`` copied under ``dest``."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(REPO, "kccap_bench"),
                    os.path.join(dest, "kccap_bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dest


# Cells whose data files the benchmark has but ``BENCHMARK.json`` does
# not list: the tests add them to a copy, as a later PR would add them
# to the benchmark, to cover the reference semantics and decimal memory.
REF_CONFIG = {
    "name": "k5k-ref",
    "source": "https://kubernetes.io/docs/setup/best-practices/cluster-large/",
    "file": "kccap_bench/configs/k5k-ref.json", "reduced": [],
    "why": "The 5,000-node cluster in the Go CLI's reference semantics",
}
REF_CELLS = [
    {"name": f"k5k-ref.{t}", "config": "k5k-ref", "traffic": t, "chips": 1,
     "why": "sweeps of 1,000 specs in the reference semantics"}
    for t in ("sweep1k", "sweep1k-decimal")
]
REF_PER_LAYER = ("serialize_ms", "fold_size", "sweep_roofline")


def add_ref_cells(root: str) -> str:
    """Add the ``k5k-ref`` configuration and its two sweep cells to the
    copy's ``BENCHMARK.json``."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(REF_CONFIG)
    bench["workloads"] += REF_CELLS
    for m in bench["per_layer"]:
        if m["name"] in REF_PER_LAYER:
            m["workloads"] += [c["name"] for c in REF_CELLS]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture(scope="session")
def full_root(tmp_path_factory):
    """A full-size copy of the benchmark with the ``k5k-ref`` cells in
    it."""
    return add_ref_cells(copy_benchmark(str(tmp_path_factory.mktemp("b"))))


def edit_json(path: str, **changes) -> None:
    with open(path) as f:
        doc = json.load(f)
    for key, value in changes.items():
        target = doc
        *parents, last = key.split("__")
        for p in parents:
            target = target[p]
        target[last] = value
    with open(path, "w") as f:
        json.dump(doc, f)


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """A copy of the benchmark whose clusters hold ``TINY_NODES`` nodes and
    whose traffic arrives at ``TINY_RATE`` a second; the server process
    finds the program through ``PYTHONPATH``."""
    root = add_ref_cells(copy_benchmark(str(tmp_path)))
    bench = os.path.join(root, "kccap_bench")
    for c in ("k5k-ref", "k5k-gpu"):
        edit_json(os.path.join(bench, "configs", f"{c}.json"),
                  cluster__nodes=TINY_NODES)
    for t in ("sweep1k", "sweep1k-decimal", "multi1k"):
        edit_json(os.path.join(bench, "traffic", f"{t}.json"),
                  rate_per_s=TINY_RATE)
    edit_json(os.path.join(bench, "traffic", "churn.json"),
              poll_rate_per_s=TINY_RATE)
    monkeypatch.setenv("PYTHONPATH", REPO)
    monkeypatch.chdir(root)
    return root
