"""The port's runtime guards and compile watching against the JAX
package's.

``checked_fit_totals`` / ``checked_fit_totals_multi``: the same totals on
valid inputs, and on each violated check the same error class family
(``ValueError``) with the same message.  ``compilewatch``: the same
first-versus-steady split per kernel label, for the unit and for every
dispatch entry point that reports to it, and the same phase-clock split
(``compile`` on a label's first dispatch, ``device_exec`` + ``fetch``
after) for the fused sweep+explain and sweep+quantile programs.
"""

import numpy as np
import pytest

from kubernetesclustercapacity_tpu import snapshot as j_snapshot
from kubernetesclustercapacity_tpu.explain import (
    sweep_explain_snapshot as j_sweep_explain,
)
from kubernetesclustercapacity_tpu.ops import fit as j_fit
from kubernetesclustercapacity_tpu.ops import pallas_fit as j_pallas
from kubernetesclustercapacity_tpu.ops import pallas_multi as j_multi
from kubernetesclustercapacity_tpu.scenario import (
    random_scenario_grid as j_grid,
)
from kubernetesclustercapacity_tpu.telemetry import compilewatch as j_cw
from kubernetesclustercapacity_tpu.telemetry import phases as j_phases
from kubernetesclustercapacity_tpu.utils import guards as j_guards
from kubernetesclustercapacity_tpu_torch import snapshot as t_snapshot
from kubernetesclustercapacity_tpu_torch.explain import (
    sweep_explain_snapshot as t_sweep_explain,
)
from kubernetesclustercapacity_tpu_torch.ops import fit as t_fit
from kubernetesclustercapacity_tpu_torch.ops import fused_fit as t_fused
from kubernetesclustercapacity_tpu_torch.ops import fused_multi as t_multi
from kubernetesclustercapacity_tpu_torch.scenario import (
    random_scenario_grid as t_grid,
)
from kubernetesclustercapacity_tpu_torch.telemetry import compilewatch as t_cw
from kubernetesclustercapacity_tpu_torch.telemetry import phases as t_phases
from kubernetesclustercapacity_tpu_torch.utils import guards as t_guards

MIB = 1 << 20


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except ValueError as e:
        return ("ValueError", str(e))


def _cols(snap):
    return (snap.alloc_cpu_milli, snap.alloc_mem_bytes, snap.alloc_pods,
            snap.used_cpu_req_milli, snap.used_mem_req_bytes,
            snap.pods_count, snap.healthy)


def _bad(cols, index, value):
    cols = [np.array(c) for c in cols]
    cols[index][0] = value
    return cols


CASES = {
    "valid": lambda c: (c, 100, MIB),
    "zero-cpu": lambda c: (c, 0, MIB),
    "zero-mem": lambda c: (c, 100, 0),
    "zero-both": lambda c: (c, 0, 0),
    "negative-cpu": lambda c: (_bad(c, 3, -5), 100, MIB),
    "negative-mem": lambda c: (_bad(c, 4, -(2**40)), 100, MIB),
    "negative-pods": lambda c: (_bad(c, 5, -1), 100, MIB),
    "negative-cpu-and-pods": lambda c: (_bad(_bad(c, 0, -1), 5, -1), 1, 1),
    "wrap-range": lambda c: (
        [np.full(50, v, dtype=np.int64) for v in (2**61, 2**62, 2**62, 0, 0,
                                                  0)] + [c[6]], 1, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_checked_fit_totals_match_jax(case):
    snap = t_snapshot.synthetic_snapshot(50, seed=1)
    cols, cpu, mem = CASES[case](_cols(snap))
    j = _outcome(j_guards.checked_fit_totals, *cols, cpu, mem)
    t = _outcome(t_guards.checked_fit_totals, *cols, cpu, mem, device="cpu")
    assert t == j
    assert (t[0] == "ok") is (case == "valid")
    if t[0] != "ok":
        with pytest.raises(t_guards.GuardError):
            t_guards.checked_fit_totals(*cols, cpu, mem, device="cpu")


@pytest.mark.parametrize("case", ["valid", "negative-request",
                                  "negative-matrix", "negative-pods"])
def test_checked_fit_totals_multi_match_jax(case):
    snap = t_snapshot.synthetic_snapshot(40, seed=2)
    alloc_rn = np.stack([snap.alloc_cpu_milli, snap.alloc_mem_bytes])
    used_rn = np.stack([snap.used_cpu_req_milli, snap.used_mem_req_bytes])
    reqs = np.array([100, MIB], dtype=np.int64)
    pods = snap.pods_count.copy()
    if case == "negative-request":
        reqs[1] = -1
    elif case == "negative-matrix":
        used_rn[1, 3] = -7
    elif case == "negative-pods":
        pods[0] = -1
    args = (alloc_rn, used_rn, snap.alloc_pods, pods, snap.healthy, reqs)
    j = _outcome(j_guards.checked_fit_totals_multi, *args)
    t = _outcome(t_guards.checked_fit_totals_multi, *args, device="cpu")
    assert t == j
    assert (t[0] == "ok") is (case == "valid")


@pytest.fixture
def fresh_watch(monkeypatch):
    monkeypatch.setenv("KCCAP_TELEMETRY", "1")
    j_cw.reset()
    t_cw.reset()
    yield
    j_cw.reset()
    t_cw.reset()


def test_observe_dispatch_splits_first_from_steady_like_jax(fresh_watch,
                                                            monkeypatch):
    got = []
    for cw in (j_cw, t_cw):
        got.append([cw.observe_dispatch(label, 0.001)
                    for label in ("a", "a", "b", "a", "b")])
        assert cw.seen_kernels() == ("a", "b")
    assert got[0] == got[1] == ["compile", "steady", "compile", "steady",
                                "steady"]
    monkeypatch.setenv("KCCAP_TELEMETRY", "0")
    assert t_cw.observe_dispatch("c", 0.1) == j_cw.observe_dispatch(
        "c", 0.1) == "disabled"
    assert "c" not in t_cw.seen_kernels()


def _relabel(label: str) -> str:
    return label.replace("pallas_", "plain_").replace("xla_", "torch_")


def _dispatch_all(side):
    """Every entry point that reports to compilewatch, on one package."""
    snapshot, grid, fit, pallas, multi, explain = side
    snap = snapshot.synthetic_snapshot(64, seed=3)
    fleet = snapshot.synthetic_snapshot(1500, seed=4, shapes=5)
    g = grid(12, seed=5)
    mask = np.arange(64) % 3 != 0
    kw = {} if side[0] is j_snapshot else {"device": "cpu"}
    pallas.sweep_snapshot_auto(snap, g, **kw)
    pallas.sweep_snapshot_auto(snap, g, mode="strict", node_mask=mask, **kw)
    pallas.sweep_snapshot_auto(snap, g, kernel="exact", **kw)
    pallas.sweep_snapshot_auto(fleet, g, **kw)
    pallas.sweep_snapshot_auto(fleet, g, kernel="exact", **kw)
    alloc = np.stack([snap.alloc_cpu_milli, snap.alloc_mem_bytes])
    used = np.stack([snap.used_cpu_req_milli, snap.used_mem_req_bytes])
    reqs = np.stack([g.cpu_request_milli, g.mem_request_bytes], axis=1)
    for force in (False, True):
        multi.sweep_multi_auto(alloc, used, snap.alloc_pods, snap.pods_count,
                               snap.healthy, reqs, g.replicas,
                               force_exact=force, **kw)
    explain(snap, g, **kw)
    fit.sweep_quantiles_snapshot(snap, g, q_indices=(0, 6), **kw)


def test_dispatch_entry_points_report_the_same_labels(fresh_watch):
    for side in ((j_snapshot, j_grid, j_fit, j_pallas, j_multi,
                  j_sweep_explain),
                 (t_snapshot, t_grid, t_fit, t_fused, t_multi,
                  t_sweep_explain)):
        _dispatch_all(side)
        _dispatch_all(side)
    # The JAX package also files each dispatch under its shape bucket's
    # label (``@n…``/``@g…``); the port has no bucket ladder.
    jax_labels = {_relabel(k.split("@")[0]) for k in j_cw.seen_kernels()}
    assert set(t_cw.seen_kernels()) == jax_labels
    assert {"plain_i32_rcp_fused", "torch_int64", "torch_int64_grouped",
            "plain_multi_i32_rcp_fused", "torch_int64_multi",
            "torch_int64_sweep_explain",
            "torch_int64_sweep_qtile"} <= jax_labels


@pytest.mark.parametrize("program", ["explain", "quantiles"])
def test_fused_programs_clock_compile_then_steady_like_jax(fresh_watch,
                                                           program):
    splits = []
    for phases, snapshot, grid, call in (
        (j_phases, j_snapshot, j_grid, {
            "explain": lambda s, g: j_sweep_explain(s, g),
            "quantiles": lambda s, g: j_fit.sweep_quantiles_snapshot(
                s, g, q_indices=(1,))}[program]),
        (t_phases, t_snapshot, t_grid, {
            "explain": lambda s, g: t_sweep_explain(s, g, device="cpu"),
            "quantiles": lambda s, g: t_fit.sweep_quantiles_snapshot(
                s, g, q_indices=(1,), device="cpu")}[program]),
    ):
        snap = snapshot.synthetic_snapshot(32, seed=6)
        per_call = []
        for seed in (1, 2):
            clk = phases.new_clock()
            prev = phases.activate(clk)
            try:
                call(snap, grid(8, seed=seed))
            finally:
                phases.restore(prev)
            per_call.append(sorted(clk.counts()))
        splits.append(per_call)
    # The first call also stages the snapshot (a devcache miss).
    assert splits[0] == splits[1] == [["compile", "devcache"],
                                      ["device_exec", "fetch"]]
