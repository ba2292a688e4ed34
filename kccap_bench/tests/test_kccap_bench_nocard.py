"""The run command exits non-zero with a clear message, and prints no
result, where there is no CUDA device or no program beside it."""

from __future__ import annotations

import os
import subprocess
import sys

from kccap_bench.tests.conftest import REPO, copy_benchmark

CMD = [sys.executable, "-m", "kccap_bench.run", "--workload",
       "k5k-gpu.multi1k", "--seed", "3000000000", "--seconds", "1",
       "--trace", "0"]


def test_no_card_exits_non_zero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(CMD, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode != 0
    assert "CUDA device" in proc.stderr
    assert '"correct"' not in proc.stdout


def test_the_benchmark_alone_exits_non_zero(tmp_path):
    root = copy_benchmark(str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(CMD, cwd=root, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode != 0
    assert "kubernetesclustercapacity_tpu_torch" in proc.stderr
    assert '"correct"' not in proc.stdout
