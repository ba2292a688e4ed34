"""The control: the plain reference computed in int32, put where the
program's answers go, fails the check; so does the float32 shortcut
on the ``k5k-ref`` cells.  At the cells' own cluster size
(5,000 nodes), with fewer kept requests than a run keeps so that it
fits a test; ``python3 -m kccap_bench.control`` runs it at the cells'
full size on the card."""

from __future__ import annotations

import os

import pytest
import torch

from kccap_bench import checks, control
from kccap_bench.tests.conftest import (
    copy_benchmark,
    edit_json,
    add_ref_cells,
)


@pytest.mark.parametrize("workload,kept", [
    ("k5k-ref.sweep1k", 64),
    ("k5k-ref.sweep1k-decimal", 32),
])
def test_the_float32_control_is_not_correct(tmp_path, workload, kept):
    root = add_ref_cells(copy_benchmark(str(tmp_path)))
    traffic = workload.split(".", 1)[1]
    edit_json(os.path.join(root, "kccap_bench", "traffic", f"{traffic}.json"),
              check_requests=kept, rate_per_s=50)
    numbers, _ = control.control_numbers(root, workload, 2024, 2.0, "cpu",
                                         torch.float32)
    assert numbers["totals_off"] > checks.LIMITS["totals_off"]


@pytest.mark.parametrize("workload", ["k5k-gpu.multi1k", "k5k-gpu.churn"])
def test_the_int32_control_is_not_correct(tmp_path, workload):
    root = copy_benchmark(str(tmp_path))
    traffic = os.path.join(root, "kccap_bench", "traffic",
                           f"{workload.split('.', 1)[1]}.json")
    if workload.endswith("churn"):
        edit_json(traffic, check_requests=8, check_writer_requests=4)
    else:
        edit_json(traffic, rate_per_s=8)
    numbers, _ = control.control_numbers(root, workload, 2024, 1.0, "cpu")
    assert numbers["totals_off"] > checks.LIMITS["totals_off"]
