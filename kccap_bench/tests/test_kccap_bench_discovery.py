"""A configuration, a traffic mix, a generator kind and a metric added as
files of their own and entries of BENCHMARK.json are found by name and
run, and no file that was there changes."""

from __future__ import annotations

import hashlib
import io
import json
import os

from kccap_bench import run
from kccap_bench.tests.conftest import TINY_NODES


def _digests(root):
    out = {}
    for dirpath, _, files in os.walk(os.path.join(root, "kccap_bench")):
        for f in files:
            if not f.endswith(".pyc"):
                path = os.path.join(dirpath, f)
                out[path] = hashlib.sha256(open(path, "rb").read()).hexdigest()
    return out


def test_new_files_and_entries_make_a_new_cell(tiny_root):
    bench = os.path.join(tiny_root, "kccap_bench")
    before = _digests(tiny_root)
    with open(os.path.join(bench, "configs", "k5k-ref.json")) as f:
        config = json.load(f)
    config["name"] = "throwaway"
    config["cluster"]["nodes"] = TINY_NODES // 2
    with open(os.path.join(bench, "configs", "throwaway.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(bench, "traffic", "sweep1k.json")) as f:
        traffic = json.load(f)
    traffic.update(kind="throwaway_kind", specs_per_request=64,
                   rate_per_s=15, check_requests="all")
    with open(os.path.join(bench, "traffic", "throwaway_mix.json"),
              "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(bench, "gen", "throwaway_kind.py"), "w") as f:
        f.write("from kccap_bench.gen.sweep import "
                "plan, reference_answers  # noqa: F401\n")
    with open(os.path.join(bench, "metrics", "answered_pct.py"), "w") as f:
        f.write("def read(artifacts):\n"
                "    load = artifacts['load']\n"
                "    return 100.0 * (load['attempted'] - load['failed'])"
                " / load['attempted']\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        doc = json.load(f)
    doc["configs"].append({"name": "throwaway", "source": "https://x",
                           "file": "kccap_bench/configs/throwaway.json",
                           "reduced": [], "why": "a test"})
    doc["workloads"].append({"name": "throwaway.cell", "config": "throwaway",
                             "traffic": "throwaway_mix", "chips": 1,
                             "why": "a test"})
    doc["end_to_end"].append({"name": "answered_pct", "unit": "%",
                              "better": "higher", "bound": 0.01,
                              "source": "host_clock",
                              "workloads": ["throwaway.cell"]})
    with open(path, "w") as f:
        json.dump(doc, f)

    out = io.StringIO()
    assert run.run_cell(tiny_root, "throwaway.cell", 2**32 + 9, 2.0, False,
                        device="cpu", out=out) == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["answered_pct"]["value"] == 100.0
    assert set(result["metrics"]) == {"server_rss_peak_mib", "setup_s",
                                      "answered_pct"}
    assert result["attempted"] == 30
    after = _digests(tiny_root)
    assert {p: d for p, d in after.items() if p in before} == before
