"""Finds a cell's pieces by the names ``BENCHMARK.json`` gives them.

A workload names its configuration and its traffic mix; the
configuration entry names its file; the traffic mix is
``kccap_bench/traffic/<traffic>.json``; its ``kind`` is the generator
``kccap_bench/gen/<kind>.py``; a configuration's cluster ``kind`` is
``kccap_bench/clusters/<kind>.py``; a metric is read by
``kccap_bench/metrics/<metric>.py``.  So a new cell, mix or metric is new
files and entries, and no file that is there changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

__all__ = ["BENCH_DIR", "load_benchmark", "load_cell", "load_module",
           "cell_metrics"]

BENCH_DIR = "kccap_bench"
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    return name


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_cell(root: str, workload: str) -> dict:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    entry = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[entry["config"]]["file"])) as f:
        config = json.load(f)
    traffic_name = _checked(entry["traffic"])
    with open(os.path.join(root, BENCH_DIR, "traffic",
                           f"{traffic_name}.json")) as f:
        traffic = json.load(f)
    return {"bench": bench, "workload": entry, "config": config,
            "traffic": traffic}


def load_module(root: str, sub: str, name: str):
    """``kccap_bench/<sub>/<name>.py`` under ``root``, by its path."""
    path = os.path.join(root, BENCH_DIR, sub, f"{_checked(name)}.py")
    mod_name = "kccap_bench_" + re.sub(r"\W", "_", f"{sub}_{name}")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: the end-to-end ones
    with ``trace`` off, the per-layer ones with it on; a metric with a
    ``workloads`` list only in those cells."""
    metrics = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in metrics
            if "workloads" not in m or workload in m["workloads"]]
