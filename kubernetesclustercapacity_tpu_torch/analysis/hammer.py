"""The package-wide sanitize hammer: every threaded class, 16 threads,
fuzzed schedules, seeded and replayable.

Each driver builds fresh instances of one threaded class *while the
sanitizer is installed* (so their locks are wrapped and their guarded
fields — the statically inferred set from
:func:`..rules_locks.lock_model` — are monitored), then hits them from
``threads`` concurrent workers.  One :func:`run` call covers all
fifteen classes under one instrumentation window per seed; findings
flow through the shared suppression/baseline workflow.

The drivers deliberately exercise the *synchronization surface*, not
the numerics: stubs stand in for kernels and oracles, snapshots are
tiny, and every expected control-flow exception (admission sheds,
breaker refusals) is caught inside the op.  What must survive is the
locking — the detector decides whether it did.
"""

from __future__ import annotations

import os
import tempfile
import threading

from kubernetesclustercapacity_tpu_torch.analysis import sanitize
from kubernetesclustercapacity_tpu_torch.analysis.engine import Project
from kubernetesclustercapacity_tpu_torch.analysis.rules_locks import lock_model

__all__ = ["run", "HAMMERED_CLASSES", "instrument_targets"]

#: The fifteen threaded classes the tier-1 gate certifies, as
#: ``(module, class name)`` — every one must also be inferred threaded
#: by the static model (cross-checked in tests/test_torch_sanitize.py).
HAMMERED_CLASSES = (
    ("kubernetesclustercapacity_tpu_torch.devcache", "DeviceCache"),
    ("kubernetesclustercapacity_tpu_torch.service.batching", "MicroBatcher"),
    ("kubernetesclustercapacity_tpu_torch.timeline.history", "CapacityTimeline"),
    ("kubernetesclustercapacity_tpu_torch.audit.log", "AuditLog"),
    ("kubernetesclustercapacity_tpu_torch.audit.shadow", "ShadowSampler"),
    ("kubernetesclustercapacity_tpu_torch.service.plane", "PlanePublisher"),
    ("kubernetesclustercapacity_tpu_torch.service.plane", "PlaneSubscriber"),
    ("kubernetesclustercapacity_tpu_torch.federation.server", "ClusterFeed"),
    ("kubernetesclustercapacity_tpu_torch.service.plane", "AdmissionController"),
    ("kubernetesclustercapacity_tpu_torch.service.tenancy", "FairSlotQueue"),
    ("kubernetesclustercapacity_tpu_torch.resilience", "TokenBucket"),
    ("kubernetesclustercapacity_tpu_torch.resilience", "CircuitBreaker"),
    ("kubernetesclustercapacity_tpu_torch.telemetry.metrics", "MetricsRegistry"),
    ("kubernetesclustercapacity_tpu_torch.telemetry.tracectx", "TailSampler"),
    ("kubernetesclustercapacity_tpu_torch.telemetry.memledger", "DeviceLedger"),
)


def _package_dir() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def instrument_targets(package_dir: str | None = None):
    """``(cls, monitored fields, label)`` for every hammered class —
    the monitored set IS the static model's guarded set, so the two
    provers cannot drift apart."""
    import importlib

    model = lock_model(Project(package_dir or _package_dir()))
    by_name = {}
    for m in model.values():
        by_name.setdefault(m.name, m)
    out = []
    for module, cls_name in HAMMERED_CLASSES:
        cls = getattr(importlib.import_module(module), cls_name)
        m = by_name.get(cls_name)
        if m is None:
            raise RuntimeError(
                f"{cls_name} is hammered but the static lock model does "
                "not infer it threaded — the provers disagree"
            )
        out.append((cls, tuple(sorted(m.guarded)), cls_name))
    return out


# ---------------------------------------------------------------------------
# Per-class drivers.  Each returns (ops, cleanup): ops is a list of
# ``fn(i, t)`` callables the workers round-robin; cleanup tears the
# instances down after the join.


def _drive_device_cache():
    """Staging, swaps and invalidation racing on CPU tensors: ``get``
    through both staged forms, ``stage_replace`` moving one snapshot's
    entries to another (the server's swap), ``invalidate`` (the retire),
    and readers.  The entry map is only ever touched under the lock —
    ``_per_locked`` runs inside the callers' blocks."""
    import torch

    from kubernetesclustercapacity_tpu_torch.devcache import DeviceCache
    from kubernetesclustercapacity_tpu_torch.snapshot import synthetic_snapshot

    cache = DeviceCache()
    cpu = torch.device("cpu")
    snaps = [synthetic_snapshot(8, seed=s) for s in range(4)]

    def get(i, t):
        s = snaps[(i + t) % len(snaps)]
        if i % 2:
            cache.exact_tensors(s, cpu)
        else:
            cache.kernel_tensors(s, cpu)

    def swap(i, t):
        old = snaps[(i + t) % len(snaps)]
        cache.stage_replace(old, snaps[(i + t + 1) % len(snaps)], cpu)

    def invalidate(i, t):
        if i % 3 == 0:
            cache.invalidate(snaps[(i * t) % len(snaps)])

    def stats(i, t):
        cache.stats()

    return [get, get, swap, invalidate, stats], lambda: None


def _drive_micro_batcher():
    from kubernetesclustercapacity_tpu_torch.service.batching import MicroBatcher

    mb = MicroBatcher(
        lambda key, items: [x * 2 for x in items],
        window_s=0.0005,
        max_batch=8,
    )

    def submit(i, t):
        assert mb.submit(("gen", i % 2), i) == i * 2

    def stats(i, t):
        mb.stats  # property: reads the registry families

    return [submit, submit, submit, stats], lambda: None


def _drive_fold_queue():
    """The generalized cross-spec fold queue: the same
    MicroBatcher class, but driven the way the server now drives it —
    keys carrying (generation, semantics, kernel family), weighted
    items, per-member deadlines racing the window budget, tenant tags
    flowing into a fold_hook, and a dispatcher that answers per-member
    slices out of one concatenated launch.  The deadline-bypass path
    and the leader's hook/histogram bookkeeping all run under the
    sanitizer here."""
    from kubernetesclustercapacity_tpu_torch.resilience import Deadline
    from kubernetesclustercapacity_tpu_torch.service.batching import MicroBatcher

    hook_lock = threading.Lock()
    hook_calls = [0]

    def fold_hook(tenants):
        with hook_lock:
            hook_calls[0] += 1
        assert len(tenants) >= 1

    def dispatch(key, items):
        # One folded "launch": every member's answer is its own item
        # scaled — per-member slicing of a shared result, shaped like
        # the server's scatter loop.
        _gen, _sem, _fam = key
        return [(spec, spec * 2) for spec in items]

    mb = MicroBatcher(
        dispatch, window_s=0.0008, max_batch=8, fold_hook=fold_hook
    )
    keys = (
        (("g", 0), "reference", "auto"),
        (("g", 0), "strict", "auto"),
        (("g", 1), "reference", "pallas"),
    )

    def folded(i, t):
        key = keys[(i + t) % len(keys)]
        got = mb.submit(
            key,
            i,
            tenant=f"team-{t % 3}",
            weight=1 + i % 4,
        )
        assert got == (i, i * 2)

    def racing_deadline(i, t):
        # Deadlines straddling the window budget: some members join,
        # some bypass solo — the per-member decision runs under the
        # batch lock and must never double-dispatch.
        key = keys[i % len(keys)]
        got = mb.submit(
            key,
            i,
            deadline=Deadline.after(0.0002 + (i % 5) * 0.0004),
            tenant=f"team-{i % 2}",
        )
        assert got == (i, i * 2)

    def stats(i, t):
        st = mb.stats
        assert st["fold_rate"] >= 0.0
        assert st["mean_folded_specs"] >= 0.0

    return [folded, folded, racing_deadline, stats], lambda: None


def _drive_timeline():
    from kubernetesclustercapacity_tpu_torch.snapshot import synthetic_snapshot
    from kubernetesclustercapacity_tpu_torch.timeline.history import (
        CapacityTimeline,
    )

    tl = CapacityTimeline(depth=8, device="cpu")
    snap = synthetic_snapshot(8, seed=3)
    gen_lock = threading.Lock()
    gen = [0]

    def observe(i, t):
        with gen_lock:
            gen[0] += 1
            g = gen[0]
        tl.observe(snap, g)

    def read(i, t):
        tl.records()
        tl.alerts()
        tl.stats()

    return [observe, read, read], tl.close


def _drive_audit_log(tmpdir):
    from kubernetesclustercapacity_tpu_torch.audit.log import AuditLog
    from kubernetesclustercapacity_tpu_torch.snapshot import synthetic_snapshot

    log = AuditLog(os.path.join(tmpdir, "audit"), checkpoint_every=4)
    snap = synthetic_snapshot(8, seed=3)
    gen_lock = threading.Lock()
    gen = [0]

    def generation(i, t):
        with gen_lock:
            gen[0] += 1
            g = gen[0]
        log.record_generation(snap, g)

    def request(i, t):
        log.record_request(
            op="sweep",
            args={"i": i, "t": t},
            generation=gen[0],
            status="ok",
        )

    def stats(i, t):
        log.stats()
        log.generation_ref(1)

    return [generation, request, request, stats], log.close


def _drive_shadow(tmpdir):
    from kubernetesclustercapacity_tpu_torch.audit.shadow import ShadowSampler

    served = [3, 5]

    sampler = ShadowSampler(
        1.0,
        oracle=lambda snapshot, grid, node_mask: list(served),
        bundle_path=os.path.join(tmpdir, "bundles.jsonl"),
        max_queue=64,
    )

    def submit(i, t):
        sampler.maybe_submit(None, i, None, served, [True, True])

    def stats(i, t):
        sampler.stats()
        sampler.diverged  # property

    def close():
        sampler.drain(timeout_s=10.0)
        sampler.close()

    return [submit, submit, stats], close


def _drive_plane(tmpdir):
    """PlanePublisher + PlaneSubscriber + ClusterFeed in one driver —
    the federation wiring: a real leader fans frames to a subscriber
    staging into a feed, while workers publish and read stats."""
    from kubernetesclustercapacity_tpu_torch.federation.server import ClusterFeed
    from kubernetesclustercapacity_tpu_torch.service.plane import (
        PlanePublisher,
        PlaneSubscriber,
    )
    from kubernetesclustercapacity_tpu_torch.snapshot import synthetic_snapshot

    pub = PlanePublisher(heartbeat_s=0.05)
    feed = ClusterFeed("hammer-cluster")
    sub = PlaneSubscriber(
        pub.address, feed, stale_after_s=5.0, reconnect_base_s=0.01
    )
    snap = synthetic_snapshot(8, seed=3)
    gen_lock = threading.Lock()
    gen = [0]

    def publish(i, t):
        with gen_lock:
            gen[0] += 1
            g = gen[0]
            # Publish order is the plane's contract (the server's
            # coalescer serializes it); the lock models that.
            pub.publish(snap, g)

    def pub_stats(i, t):
        pub.stats()

    def sub_stats(i, t):
        sub.stats()
        sub.stale  # property
        sub.applied_generation  # property
        sub.sync_age_s()

    def feed_view(i, t):
        feed.view()
        feed.last_verified_age_s()
        feed.stream_stats()

    def close():
        sub.stop()
        pub.close()

    return [publish, pub_stats, sub_stats, feed_view], close


def _drive_admission():
    from kubernetesclustercapacity_tpu_torch.resilience import (
        DeadlineExpired,
        OverloadedError,
    )
    from kubernetesclustercapacity_tpu_torch.service.plane import (
        AdmissionController,
    )

    ac = AdmissionController(max_concurrent=4, rps=10000.0)

    def admit(i, t):
        try:
            release = ac.admit("sweep")
        except (OverloadedError, DeadlineExpired):
            return
        try:
            pass
        finally:
            release()

    def price(i, t):
        ac.observe_shadow_price(0.25 * (i % 4), certified=bool(i % 2))
        ac.shadow_price()

    def shed(i, t):
        ac.count_shed("sweep", "draining")

    return [admit, admit, price, shed], lambda: None


def _drive_fair_queue():
    """Adversarial schedules against the weighted-fair admission queue:
    a saturated slot pool, skewed weights, timed-out waiters racing
    grants, and readers — the no-tenant-starves-another class.  Every
    acquire is paired with a release (ValueError on a pairing bug is a
    real finding, not expected control flow)."""
    from kubernetesclustercapacity_tpu_torch.service.tenancy import FairSlotQueue

    weights = {"hot": 8.0, "warm": 2.0, "cold": 0.5}
    fq = FairSlotQueue(4, weight_of=lambda t: weights.get(t, 1.0))
    tenants = ("hot", "hot", "warm", "cold", "other")

    def acquire(i, t):
        tenant = tenants[(i + t) % len(tenants)]
        # Short timeout: under 16 saturating workers many waits expire,
        # exercising the timeout-vs-grant race on purpose.
        if fq.acquire(tenant, timeout=0.002):
            fq.release(tenant)

    def fast(i, t):
        tenant = tenants[(i * 3 + t) % len(tenants)]
        if fq.try_acquire(tenant):
            fq.release(tenant)

    def stats(i, t):
        fq.stats()

    return [acquire, acquire, fast, stats], lambda: None


def _drive_token_bucket():
    from kubernetesclustercapacity_tpu_torch.resilience import TokenBucket

    tb = TokenBucket(1000.0, 64.0)

    def acquire(i, t):
        tb.try_acquire(1.0)

    def avail(i, t):
        tb.available()

    return [acquire, acquire, avail], lambda: None


def _drive_breaker():
    from kubernetesclustercapacity_tpu_torch.resilience import CircuitBreaker

    br = CircuitBreaker(failure_threshold=3, recovery_timeout_s=0.01)

    def ok(i, t):
        if br.allow():
            br.record_success()

    def fail(i, t):
        if br.allow():
            br.record_failure(RuntimeError("hammer"))

    def read(i, t):
        br.state  # property
        br.last_error  # property
        br.snapshot()

    def reset(i, t):
        if i % 7 == 0:
            br.reset()

    return [ok, fail, read, reset], lambda: None


def _drive_registry():
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
        MetricsRegistry,
    )

    reg = MetricsRegistry()

    def counter(i, t):
        reg.counter(
            f"kccap_hammer_c{i % 3}_total", "hammer", ("k",)
        ).labels(k=str(t % 2)).inc()

    def gauge(i, t):
        reg.gauge(f"kccap_hammer_g{i % 2}", "hammer").set(i)

    def collect(i, t):
        reg.collect()
        reg.snapshot()

    return [counter, gauge, collect], lambda: None


def _drive_tail_sampler():
    """The tail-sampling ring under exact-count audit: every span body
    ever recorded must end the run as kept, dropped, or still buffered
    — and kept must equal what actually reached the sink.  Off-by-one
    races in the ring's eviction/flush accounting have nowhere to
    hide."""
    from kubernetesclustercapacity_tpu_torch.telemetry.tracectx import TailSampler

    class _CountingSink:
        def __init__(self):
            self.lock = threading.Lock()
            self.written = 0

        def record(self, **fields):
            with self.lock:
                self.written += 1

    sink = _CountingSink()
    ts = TailSampler(sink, "rate:3", max_traces=8, max_spans_per_trace=4)
    issued = [0]
    issued_lock = threading.Lock()

    def _record(tid):
        ts.record(trace_id=tid, span_id="s", duration_ms=1.0, op="hammer")
        with issued_lock:
            issued[0] += 1

    def own_trace(i, t):
        # The normal request shape: buffer a few spans, decide, finish.
        tid = f"T{t}.{i}"
        _record(tid)
        _record(tid)
        ts.finish(tid, keep=ts.decide("hammer", 0.001, None))

    def hot_trace(i, t):
        # Every thread piles into the same two traces: contends the
        # per-trace span cap and the max_traces eviction path.
        _record(f"hot{i % 2}")

    def finish_hot(i, t):
        ts.finish(f"hot{i % 2}", keep=bool(i % 2))

    def stats(i, t):
        ts.stats()

    def cleanup():
        with ts._lock:
            buffered = sum(len(b) for b in ts._ring.values())
            kept, dropped = ts.kept_spans, ts.dropped_spans
        if kept != sink.written:
            raise AssertionError(
                f"tail-sampler ledger drifted from the sink: "
                f"kept={kept} written={sink.written}"
            )
        if kept + dropped + buffered != issued[0]:
            raise AssertionError(
                "tail-sampler lost or invented spans: "
                f"kept={kept} + dropped={dropped} + buffered={buffered} "
                f"!= issued={issued[0]}"
            )

    return [own_trace, own_trace, hot_trace, finish_hot, stats], cleanup


def _drive_memledger():
    """The device-memory ledger under exact-bytes audit: workers stage
    and retire leaf containers in per-thread slots (mirrored in a
    ledger-independent book) while reconcilers sweep with the mirror as
    the injected live-array view and readers scrape.  The mirror is
    maintained so it always covers the ledger (add-before-register,
    retire-before-remove), so a reconcile mid-race may see suspects but
    never a sustained leak.  After the join the ledger must equal the
    mirror to the byte — accounting that drifts under contention is
    exactly the silent HBM leak the ledger exists to catch."""
    from kubernetesclustercapacity_tpu_torch.telemetry.memledger import (
        DeviceLedger,
    )

    class _Leaf:
        __slots__ = ("nbytes",)

        def __init__(self, nbytes):
            self.nbytes = nbytes

    ledger = DeviceLedger()
    mirror_lock = threading.Lock()
    # (thread, slot) -> (container, nbytes); each thread stages only
    # into its own slots, so the mirror ordering invariant holds.
    mirror: dict = {}
    forms = ("exact", "grouped", "pallas", "fold_fetch")

    def _unstage(key):
        with mirror_lock:
            entry = mirror.get(key)
        if entry is None:
            return
        ledger.retire(entry[0])
        with mirror_lock:
            del mirror[key]

    def stage(i, t):
        key = (t, i % 4)
        _unstage(key)
        leaves = tuple(
            _Leaf(64 * (1 + (i + t + k) % 3)) for k in range(2)
        )
        nbytes = sum(x.nbytes for x in leaves)
        with mirror_lock:
            mirror[key] = (leaves, nbytes)
        ledger.register(leaves, forms[(i + t) % len(forms)])

    def retire(i, t):
        _unstage((t, (i + 1) % 4))

    def reconcile(i, t):
        # Snapshot + reconcile under the mirror lock: a live view that
        # raced a register would mark fresh leaves missing, and id
        # reuse after a free could turn that transient into a phantom
        # "sustained" leak.  Real deployments reconcile against
        # the weak references resolved inside the call; the hammer's mirror
        # must be at least that coherent.  (Safe: no worker holds the
        # ledger lock while taking the mirror lock.)
        with mirror_lock:
            live = [
                leaf for c, _ in mirror.values() for leaf in c
            ]
            audit = ledger.reconcile(live_arrays=live)
        assert audit["sustained_missing_bytes"] == 0

    def read(i, t):
        ledger.stats()
        ledger.total_bytes()
        ledger.peak_bytes()
        ledger.budget_breached()

    def cleanup():
        with mirror_lock:
            expected = sum(n for _, n in mirror.values())
            count = len(mirror)
        st = ledger.stats()
        if st["total_bytes"] != expected or st["entries"] != count:
            raise AssertionError(
                "memledger drifted from the mirror book: "
                f"total={st['total_bytes']} expected={expected} "
                f"entries={st['entries']} expected_entries={count}"
            )
        if st["registered"] - st["retired"] != count:
            raise AssertionError(
                "memledger lost or invented registrations: "
                f"registered={st['registered']} retired={st['retired']} "
                f"live_entries={count}"
            )
        if ledger.leaking():
            raise AssertionError(
                "memledger reported a sustained leak under a mirror "
                "that always covered the book"
            )

    return [stage, stage, retire, reconcile, read], cleanup


def _drive_memledger_reconcile():
    """Reconciles racing each other on one ledger — no outer lock, as
    the ``/healthz`` probe and ``info``/``dump`` run them.  One leaf stays
    alive, one is gone from the first reconcile on: every audit judges
    against the suspects of a whole earlier reconcile, so the gone leaf
    is sustained from the second reconcile on and never before."""
    from kubernetesclustercapacity_tpu_torch.telemetry.memledger import (
        DeviceLedger,
    )

    class _Leaf:
        __slots__ = ("nbytes",)

        def __init__(self, nbytes):
            self.nbytes = nbytes

    ledger = DeviceLedger()
    kept, gone = _Leaf(256), _Leaf(128)
    ledger.register((kept,), "exact")
    ledger.register((gone,), "kernel")

    def reconcile(i, t):
        audit = ledger.reconcile(live_arrays=[kept], allocated_bytes=0)
        assert audit["missing_bytes"] == gone.nbytes
        assert audit["sustained_missing_bytes"] in (0, gone.nbytes)

    def read(i, t):
        ledger.stats()
        ledger.leaking()

    def cleanup():
        audit = ledger.reconcile(live_arrays=[kept], allocated_bytes=0)
        if audit["sustained_missing_bytes"] != gone.nbytes:
            raise AssertionError(
                "concurrent reconciles lost the suspect set: "
                f"sustained={audit['sustained_missing_bytes']} "
                f"expected={gone.nbytes}"
            )

    return [reconcile, reconcile, reconcile, read], cleanup


# ---------------------------------------------------------------------------


def _spin(ops, *, threads: int, iters: int) -> list:
    """Round-robin the ops across ``threads`` workers; unexpected
    exceptions are collected and re-raised after the join (a hammer
    that swallows crashes would certify garbage)."""
    errors: list = []
    barrier = threading.Barrier(threads)

    def worker(t: int) -> None:
        try:
            barrier.wait(timeout=30)
            for i in range(iters):
                ops[(t + i) % len(ops)](i, t)
        except Exception as e:  # noqa: BLE001 - surfaced after join
            errors.append(e)

    ts = [
        threading.Thread(target=worker, args=(t,), daemon=True)
        for t in range(threads)
    ]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    return errors


def run(
    *,
    seed: int,
    threads: int = 16,
    iters: int = 40,
    fuzz: bool = True,
    package_dir: str | None = None,
) -> tuple:
    """One full hammer pass: install → drive all fifteen classes
    (the MicroBatcher twice: once as the legacy coalescer, once as the
    generalized fold queue; the DeviceLedger twice: once staged against
    a mirror book, once with bare concurrent reconciles) → report →
    uninstall.  Returns ``(findings, stats)`` with findings
    relative to the repo root.  Raises if any worker crashed."""
    targets = instrument_targets(package_dir)
    repo_root = os.path.dirname(package_dir or _package_dir())
    sanitize.install(seed=seed, fuzz=fuzz, classes=targets)
    try:
        with tempfile.TemporaryDirectory(prefix="kccap-torch-sanitize-") as tmp:
            drivers = (
                _drive_device_cache(),
                _drive_micro_batcher(),
                _drive_fold_queue(),
                _drive_timeline(),
                _drive_audit_log(tmp),
                _drive_shadow(tmp),
                _drive_plane(tmp),
                _drive_admission(),
                _drive_fair_queue(),
                _drive_token_bucket(),
                _drive_breaker(),
                _drive_registry(),
                _drive_tail_sampler(),
                _drive_memledger(),
                _drive_memledger_reconcile(),
            )
            errors: list = []
            try:
                for ops, _cleanup in drivers:
                    errors.extend(_spin(ops, threads=threads, iters=iters))
            finally:
                for _ops, cleanup in drivers:
                    try:
                        cleanup()
                    except Exception as e:  # noqa: BLE001 - keep closing
                        errors.append(e)
        if errors:
            raise RuntimeError(
                f"hammer workers crashed (seed {seed}): "
                + "; ".join(f"{type(e).__name__}: {e}" for e in errors[:5])
            )
        san = sanitize.current()
        found = sanitize.findings_of(san, repo_root)
        st = sanitize.stats_of(san)
        return found, st
    finally:
        sanitize.uninstall()
