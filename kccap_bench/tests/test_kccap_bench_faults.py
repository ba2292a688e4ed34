"""The check that decides ``correct`` catches a broken program.

Each case drives a whole run on the host (the harness's look for a card
skipped), with a fault planted in the server process beneath the timed
path, and sees ``correct`` come out false; the same run without a fault
comes out true.  The faults a cell of this benchmark can have: a step
that returns its state unchanged (an update that applies nothing), half
of each request's answers left out and filled with the mean of the rest,
an answer altered where it is produced (a total, or a schedulable
flag), and an update acknowledged before it is applied.  There is no exchange between chips: every cell
runs on one.
"""

from __future__ import annotations

import io
import json

import pytest

from kccap_bench import run

_PATCH_SWEEP = '''
import numpy as np
from kubernetesclustercapacity_tpu_torch.ops import fused_fit

_original = fused_fit.sweep_snapshot_auto

def broken(*args, **kwargs):
    kwargs["sync"] = True
    totals, sched, kernel = _original(*args, **kwargs)
    totals = np.array(totals)
    for lo in range(0, len(totals), 1000):
        block = totals[lo:lo + 1000]
{body}
    sched = totals >= np.asarray(args[1].replicas)
{flags}
    return totals, sched, kernel

fused_fit.sweep_snapshot_auto = broken
'''

FAULTS = {
    "update_applies_nothing": '''
from kubernetesclustercapacity_tpu_torch.store import ClusterStore
ClusterStore.apply = lambda self, events: self.snapshot()
''',
    "half_left_out": _PATCH_SWEEP.format(
        body="        half = len(block) // 2\n"
             "        block[half:] = int(block[:half].mean())", flags=""),
    "answer_altered": _PATCH_SWEEP.format(body="        block[0] += 1",
                                          flags=""),
    "flag_flipped": _PATCH_SWEEP.format(
        body="        pass", flags="    sched[::1000] = ~sched[::1000]"),
    # The update is acknowledged before it is applied, so the writer's
    # sweep reads the generation before it.
    "update_acknowledged_early": '''
import threading, time
from kubernetesclustercapacity_tpu_torch.service.server import CapacityServer

_original = CapacityServer._op_update

def early(self, msg):
    reply = {"nodes": self.snapshot.n_nodes,
             "healthy_nodes": int(self.snapshot.healthy.sum()),
             "applied": len(msg["events"])}
    threading.Timer(0.05, _original, (self, msg)).start()
    return reply

CapacityServer._op_update = early
''',
}


# The numbers each fault must drive over their limit.
CAUGHT_BY = {
    "update_applies_nothing": {"totals_off"},
    "half_left_out": {"totals_off"},
    "flag_flipped": {"sched_off"},
    "answer_altered": {"totals_off"},
    "update_acknowledged_early": {"stale_reads"},
}


def _run(root, workload, inject=None):
    out = io.StringIO()
    assert run.run_cell(root, workload, 2**31 + 101, 2.0, False,
                        device="cpu", inject=inject, out=out) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload", ["k5k-ref.sweep1k", "k5k-gpu.churn"])
def test_a_sound_run_is_correct(tiny_root, workload):
    result = _run(tiny_root, workload)
    assert result["correct"] is True
    assert all(c["value"] == 0 for c in result["checks"].values())


@pytest.mark.parametrize("fault,workload", [
    ("update_applies_nothing", "k5k-gpu.churn"),
    ("half_left_out", "k5k-ref.sweep1k"),
    ("half_left_out", "k5k-gpu.churn"),
    ("answer_altered", "k5k-ref.sweep1k"),
    ("answer_altered", "k5k-ref.sweep1k-decimal"),
    ("flag_flipped", "k5k-ref.sweep1k"),
    ("update_acknowledged_early", "k5k-gpu.churn"),
])
def test_a_fault_makes_the_run_incorrect(tiny_root, tmp_path, fault,
                                         workload):
    inject = tmp_path / f"{fault}.py"
    inject.write_text(FAULTS[fault])
    result = _run(tiny_root, workload, str(inject))
    assert result["correct"] is False
    over = {k for k, c in result["checks"].items() if c["value"] > c["limit"]}
    assert over >= CAUGHT_BY[fault], result["checks"]
