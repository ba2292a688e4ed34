"""The port's audit log and node-set diff against ``kubernetesclustercapacity_tpu.
audit.log`` and ``timeline.diff``, on the CPU.

The log is a file format shared by the two packages: the port reads logs
the JAX package wrote, and the JAX reader reads logs the port wrote, with
equal records, equal digest chains and equal reconstructed snapshots, a
torn final record recovered on both sides, and byte-equal segments under
one fixed wall clock.  The diff module's
summaries, digests and shape keys are equal too.  Tolerance: none.
"""

import dataclasses
import os

import numpy as np
import pytest

from kubernetesclustercapacity_tpu.audit import log as j_log
from kubernetesclustercapacity_tpu.fixtures import synthetic_fixture
from kubernetesclustercapacity_tpu.snapshot import (
    snapshot_from_fixture,
    synthetic_snapshot,
)
from kubernetesclustercapacity_tpu.timeline import diff as j_diff
from kubernetesclustercapacity_tpu_torch import audit as t_audit
from kubernetesclustercapacity_tpu_torch.audit import log as t_log
from kubernetesclustercapacity_tpu_torch.snapshot import (
    ClusterSnapshot as TorchSnapshot,
)
from kubernetesclustercapacity_tpu_torch.timeline import diff as t_diff

COLS = (
    "alloc_cpu_milli", "alloc_mem_bytes", "alloc_pods",
    "used_cpu_req_milli", "used_cpu_lim_milli", "used_mem_req_bytes",
    "used_mem_lim_bytes", "pods_count", "healthy",
)


def _port(snap):
    """The port's snapshot with every field of a JAX one."""
    return TorchSnapshot(**{
        f.name: getattr(snap, f.name)
        for f in dataclasses.fields(TorchSnapshot)
    })


def _same_snapshot(a, b):
    assert list(a.names) == list(b.names)
    assert a.semantics == b.semantics
    assert list(a.taints) == list(b.taints)
    assert list(a.labels) == list(b.labels)
    for c in COLS:
        assert np.array_equal(np.asarray(getattr(a, c)),
                              np.asarray(getattr(b, c))), c


def _generations(seed, mode, n=14):
    """A generation sequence with the awkward cases: duplicate/phantom
    names, taints and labels, dropped rows, mid-list inserts, health
    flips, a semantics flip."""
    fx = synthetic_fixture(24, seed=seed, unhealthy_frac=0.2,
                           taint_frac=0.3, unscheduled_running_pods=3)
    snap = snapshot_from_fixture(fx, semantics=mode)
    rng = np.random.default_rng(seed)
    out = [snap]
    for g in range(1, n):
        s = out[-1]
        cols = {c: np.asarray(getattr(s, c)).copy() for c in COLS}
        i = int(rng.integers(0, s.n_nodes))
        cols["used_cpu_req_milli"][i] += int(rng.integers(1, 500))
        cols["pods_count"][i] += 1
        if g % 4 == 0:
            cols["healthy"][i] = not cols["healthy"][i]
        names = list(s.names)
        taints = list(s.taints)
        labels = list(s.labels)
        if g % 5 == 2 and len(names) > 6:  # drop a row
            keep = [k for k in range(len(names)) if k != i]
            names = [names[k] for k in keep]
            taints = [taints[k] for k in keep] if taints else []
            labels = [labels[k] for k in keep] if labels else []
            cols = {c: v[keep] for c, v in cols.items()}
        if g % 5 == 3:  # insert a row mid-list
            at = len(names) // 2
            names.insert(at, f"grown-{g}")
            if taints:
                taints.insert(at, [])
            if labels:
                labels.insert(at, {"zone": "z9"})
            for c, v in cols.items():
                cols[c] = np.insert(v, at, v[0])
        semantics = s.semantics
        if g == n - 2:
            semantics = "strict" if semantics == "reference" else "reference"
        out.append(dataclasses.replace(
            s, names=names, taints=taints, labels=labels, node_log=[],
            pod_cpu_errs=[], semantics=semantics, **cols))
    return out


def _write(log_mod, d, snaps, convert=lambda s: s, **kw):
    log = log_mod.AuditLog(d, **kw)
    refs = []
    for g, snap in enumerate(snaps, start=1):
        refs.append(log.record_generation(convert(snap), g,
                                          ts=1000.0 + 30.0 * g))
        if g % 3 == 0:
            refs.append(log.record_request(
                op="car", args={"usage": {"cpu": "500m", "memory": "1gb"}},
                generation=g, status="ok",
                result={"quantiles": {"p95": g}, "kernel": "x",
                        "eval_ms": 1.5},
                ts=1000.0 + 30.0 * g + 1,
            ))
    log.close()
    return refs


def _segments(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.fixture
def frozen_clock(monkeypatch):
    """Segment headers carry ``time.time()``; a fixed clock makes the two
    writers' segments (and so their byte offsets) comparable."""
    import time

    monkeypatch.setattr(time, "time", lambda: 1760000000.25)


CASES = [(3, "reference", {}), (5, "strict", {}),
         (7, "reference", {"checkpoint_every": 3}),
         (9, "strict", {"checkpoint_every": 2, "segment_max_bytes": 3000})]


@pytest.mark.parametrize("seed,mode,kw", CASES)
def test_port_writes_the_jax_logs_bytes(tmp_path, frozen_clock, seed, mode,
                                        kw):
    snaps = _generations(seed, mode)
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    j_refs = _write(j_log, j_dir, snaps, **kw)
    t_refs = _write(t_log, t_dir, snaps, convert=_port, **kw)
    assert t_refs == j_refs
    assert _segments(t_dir) == _segments(j_dir)


@pytest.mark.parametrize("seed,mode,kw", CASES)
def test_port_reads_jax_written_logs(tmp_path, seed, mode, kw):
    snaps = _generations(seed, mode)
    d = str(tmp_path / "jax")
    _write(j_log, d, snaps, **kw)
    want = j_log.AuditReader.load(d)
    got = t_log.AuditReader.load(d)
    assert got.records == want.records
    assert got.recovered_tail == want.recovered_tail == 0
    assert got.verify_chain() == want.verify_chain() == list(
        range(1, len(snaps) + 1))
    assert got.requests() == want.requests()
    for g in range(1, len(snaps) + 1):
        _same_snapshot(got.snapshot_at(g), want.snapshot_at(g))
        assert t_diff.snapshot_digest(got.snapshot_at(g)) == \
            j_diff.snapshot_digest(snaps[g - 1])
    ref = want.generations()[-1]["_ref"]
    assert got.record_at(ref) == want.record_at(ref)


@pytest.mark.parametrize("seed,mode,kw", CASES[:2])
def test_jax_reads_port_written_logs(tmp_path, seed, mode, kw):
    snaps = _generations(seed, mode)
    d = str(tmp_path / "torch")
    _write(t_log, d, snaps, convert=_port, **kw)
    got = t_log.AuditReader.load(d)
    want = j_log.AuditReader.load(d)
    assert want.records == got.records
    assert want.verify_chain() == got.verify_chain()
    for g in range(1, len(snaps) + 1):
        _same_snapshot(want.snapshot_at(g), got.snapshot_at(g))


def test_torn_tail_and_corruption_are_read_alike(tmp_path):
    snaps = _generations(11, "reference", n=6)
    d = str(tmp_path / "a")
    _write(j_log, d, snaps)
    seg = os.path.join(d, sorted(os.listdir(d))[-1])
    with open(seg, "a", encoding="utf-8") as f:
        f.write('{"kind": "diff", "generation": 7, "par')
    want = j_log.AuditReader.load(d)
    got = t_log.AuditReader.load(d)
    assert got.recovered_tail == want.recovered_tail == 1
    assert got.records == want.records
    # A torn record that is not the tail is an error on both sides.
    with open(seg, "a", encoding="utf-8") as f:
        f.write('\n{"kind": "request"}\n')
    with pytest.raises(j_log.AuditError) as j_err:
        j_log.AuditReader.load(d)
    with pytest.raises(t_audit.AuditError) as t_err:
        t_log.AuditReader.load(d)
    assert str(t_err.value) == str(j_err.value)
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    with pytest.raises(t_audit.AuditError, match="no audit segments"):
        t_log.AuditReader.load(empty)
    for bad in ("nope", "audit-000001.jsonl:x", "bad:0"):
        with pytest.raises(j_log.AuditError) as j_err:
            want.record_at(bad)
        with pytest.raises(t_audit.AuditError) as t_err:
            got.record_at(bad)
        assert str(t_err.value) == str(j_err.value)


def test_reopened_log_starts_a_fresh_segment_like_jax(tmp_path,
                                                       frozen_clock):
    snaps = _generations(13, "strict", n=5)
    for mod, name, convert in ((j_log, "jax", lambda s: s),
                               (t_log, "torch", _port)):
        d = str(tmp_path / name)
        _write(mod, d, snaps[:3], convert=convert)
        _write(mod, d, snaps[3:], convert=convert)
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(
        os.listdir(tmp_path / "jax"))
    assert _segments(str(tmp_path / "torch")) == _segments(
        str(tmp_path / "jax"))
    assert t_log.AuditReader.load(str(tmp_path / "torch")).verify_chain() \
        == j_log.AuditReader.load(str(tmp_path / "jax")).verify_chain()


def test_snapshot_from_summary_equals_jax():
    snap = _generations(17, "strict", n=1)[0]
    summary = j_diff.node_summary(snap)
    assert t_diff.node_summary(_port(snap)) == summary
    keys = list(summary)
    name_of = dict(zip(keys, snap.names))
    taints_of = dict(zip(keys, snap.taints))
    labels_of = dict(zip(keys, snap.labels))
    want = j_log.snapshot_from_summary(summary, name_of, taints_of, "strict",
                                       labels_of=labels_of)
    got = t_audit.snapshot_from_summary(summary, name_of, taints_of,
                                        "strict", labels_of=labels_of)
    _same_snapshot(got, want)
    bare = t_audit.snapshot_from_summary(summary, {}, {}, "reference")
    _same_snapshot(bare, j_log.snapshot_from_summary(summary, {}, {},
                                                     "reference"))


def test_diffs_and_keys_equal_jax():
    snaps = _generations(19, "reference", n=8)
    for a, b in zip(snaps, snaps[1:]):
        sa, sb = j_diff.node_summary(a), j_diff.node_summary(b)
        want = j_diff.diff_summaries(sa, sb)
        got = t_diff.diff_summaries(t_diff.node_summary(_port(a)),
                                    t_diff.node_summary(_port(b)))
        assert got.to_wire() == want.to_wire()
        assert got.apply(sa) == sb and got.empty == want.empty
        assert t_diff.snapshot_digest(_port(b)) == j_diff.snapshot_digest(b)
        for row in list(sb.values())[:5]:
            assert t_diff.shape_key(row) == j_diff.shape_key(row)
    assert t_diff.NODE_FIELDS == j_diff.NODE_FIELDS


@pytest.mark.parametrize("op", ["car", "forecast", "plan", "optimize",
                                "sweep"])
def test_canonical_digests_and_args_equal_jax(op):
    result = {"quantiles": {"p95": 7}, "kernel": "cuda_i32", "eval_ms": 3.25,
              "lp_bound": 1.5, "status": "certified", "buy": [1, 2],
              "report": "text", "totals": np.arange(3)}
    msg = {"op": op, "token": "s3cret", "trace_id": "t", "usage": {"cpu": 1},
           "deadline": 5, "seed": 3}
    assert t_audit.canonical_result(op, result) == j_log.canonical_result(
        op, result)
    assert t_audit.canonical_result_digest(op, result) == \
        j_log.canonical_result_digest(op, result)
    assert t_audit.strip_args(msg) == j_log.strip_args(msg)


def test_stats_and_validation_like_jax(tmp_path, frozen_clock):
    for bad in ({"checkpoint_every": 0}, {"segment_max_bytes": 0}):
        with pytest.raises(ValueError) as j_err:
            j_log.AuditLog(str(tmp_path / "x"), **bad)
        with pytest.raises(ValueError) as t_err:
            t_log.AuditLog(str(tmp_path / "y"), **bad)
        assert str(t_err.value) == str(j_err.value)
    snap = synthetic_snapshot(8, seed=1)
    stats = {}
    for mod, name, convert in ((j_log, "jax", lambda s: s),
                               (t_log, "torch", _port)):
        log = mod.AuditLog(str(tmp_path / name), checkpoint_every=2)
        for g in range(1, 4):
            log.record_generation(convert(snap), g, ts=float(g))
        st = log.stats()
        st.pop("dir")
        stats[name] = (st, log.generation_ref(2))
        log.close()
        with pytest.raises(mod.AuditError):
            log.record_request(op="fit", args={}, generation=1, status="ok")
    assert stats["torch"] == stats["jax"]
