"""Server-side request micro-batching: concurrent sweeps share a kernel.

The dispatch path used to launch one kernel per request even when dozens
of concurrent sweeps targeted the *same* snapshot generation and mode —
each paying its own dispatch overhead for a scenario axis the kernel
would happily evaluate in one launch (the batch-bin-packing observation:
admission queries are tiny; their per-query overhead is the product).

:class:`MicroBatcher` is the continuous-batching analog for the capacity
kernel, leader-driven so it owns no threads:

* the **first** request for a key opens a batch and becomes its leader;
* the leader waits up to ``window_s`` (default ~1–2 ms) while concurrent
  requests for the same key append their scenario rows — a full batch
  (``max_batch``) dispatches early;
* the leader runs ONE combined dispatch on its own thread and scatters
  per-request slices back; followers block on the batch's event and
  return their own slice.

Deadline semantics are preserved per request: a request whose remaining
budget would expire inside the window bypasses batching and dispatches
solo (counted separately), so batching can never *cause* a shed.  Trace
IDs ride the per-request envelope untouched — the batch is invisible on
the wire.

Registry-backed metrics: ``kccap_batch_size`` (batch-size histogram —
``sum/count`` is the mean batch size), ``kccap_batch_window_wait_seconds``
(how long leaders actually waited), ``kccap_batch_tenants`` (distinct
tenants folded into each dispatched batch — cross-tenant folding is the
multi-tenancy win: one padded dispatch, split per tenant on return,
bit-exact vs solo), ``kccap_fold_specs`` (scenario rows per dispatch),
and batched/solo/bypass counters.

A copy of the JAX package's ``service/batching.py``.
"""

from __future__ import annotations

import threading
import time

__all__ = ["MicroBatcher"]

#: Batch-size buckets: powers of two up to the plausible max_batch range.
_BATCH_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

#: Hard ceiling on a follower's wait for its leader's dispatch: the
#: combined kernel may compile on first dispatch (seconds), but a wedged
#: leader must not strand followers forever.
_FOLLOWER_TIMEOUT_S = 120.0


class _Batch:
    __slots__ = (
        "items", "tenants", "weights", "closed", "full", "done", "results",
        "error", "leader_span_id", "opened_at",
    )

    def __init__(self, opened_at: float = 0.0) -> None:
        self.items: list = []
        # Parallel to ``items``: who asked (None when tenancy is off).
        # Results scatter back BY INDEX, so per-tenant attribution never
        # influences — or could even touch — the combined dispatch.
        self.tenants: list = []
        # Parallel to ``items``: scenario rows each member contributes
        # to the folded dispatch (the fold-accounting weight).
        self.weights: list = []
        # When the leader opened the window (the batcher's clock) — a
        # joiner's bypass decision compares its deadline against the
        # REMAINING window, not the full one.
        self.opened_at = opened_at
        self.closed = False
        self.full = threading.Event()
        self.done = threading.Event()
        self.results: list | None = None
        self.error: str | None = None
        # The leader's "batch:dispatch" span id, minted when the batch
        # opens so followers can LINK to it (links, not parentage:
        # a follower's request is caused by its own caller; it merely
        # rode the leader's dispatch).
        self.leader_span_id: str | None = None


class MicroBatcher:
    """Collect concurrent same-key requests into one dispatch.

    ``dispatch(key, items)`` (the embedder's) must return one result per
    item, in order.  ``key`` groups only requests whose combined dispatch
    is semantically identical to their solo dispatches (the server keys
    by snapshot generation + kernel choice).
    """

    def __init__(
        self,
        dispatch,
        *,
        window_s: float = 0.0015,
        max_batch: int = 32,
        registry=None,
        trace_sink=None,
        fold_hook=None,
        clock=None,
    ) -> None:
        from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
            MetricsRegistry,
        )

        if window_s <= 0:
            raise ValueError("window_s must be > 0 (omit the batcher to "
                             "disable batching)")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._dispatch = dispatch
        # Span sink (a TailSampler or TraceLog; None = no tracing):
        # batch leaders record a "batch:dispatch" span, followers a
        # "batch:join" span linked to it — the trace-tree form of "who
        # rode whose kernel launch".
        self._trace_sink = trace_sink
        # Fold-accounting hook: called once per MULTI-request dispatch
        # with the members' tenant labels (service/tenancy.py's
        # FoldAccounting when tenancy is armed; None otherwise).
        # Strictly best-effort — accounting must never fail a dispatch.
        self._fold_hook = fold_hook
        # Injectable monotonic clock (tests freeze it to pin the
        # joiner-bypass window arithmetic); production uses perf_counter.
        self._clock = clock if clock is not None else time.perf_counter
        self.window_s = float(window_s)
        self.max_batch = int(max_batch)
        self._lock = threading.Lock()
        self._pending: dict = {}
        self.registry = registry if registry is not None else MetricsRegistry()
        m = self.registry
        self._m_size = m.histogram(
            "kccap_batch_size",
            "Requests per dispatched micro-batch (sum/count = mean).",
            buckets=_BATCH_SIZE_BUCKETS,
        )
        self._m_wait = m.histogram(
            "kccap_batch_window_wait_seconds",
            "How long batch leaders waited for followers before "
            "dispatching.",
        )
        self._m_batched = m.counter(
            "kccap_batched_requests_total",
            "Requests served as part of a multi-request batch.",
        )
        self._m_solo = m.counter(
            "kccap_solo_requests_total",
            "Requests dispatched alone (batch of one).",
        )
        self._m_bypass = m.counter(
            "kccap_batch_deadline_bypass_total",
            "Requests that bypassed batching because their deadline "
            "would expire inside the window.",
        )
        self._m_tenants = m.histogram(
            "kccap_batch_tenants",
            "Distinct tenants folded into each dispatched micro-batch "
            "(1 when tenancy is off; >1 means cross-tenant sharing).",
            buckets=_BATCH_SIZE_BUCKETS,
        )
        self._m_specs = m.histogram(
            "kccap_fold_specs",
            "Scenario rows folded into each dispatched micro-batch "
            "(sum of member weights; sum/count = mean folded specs per "
            "launch — the cross-spec amortization factor).",
            buckets=_BATCH_SIZE_BUCKETS + (256, 512, 1024),
        )

    @property
    def stats(self) -> dict:
        """JSON-able batching counters (info op / doctor / bench)."""
        size = self._m_size.labels()
        dispatches = size.count
        total = size.sum
        specs = self._m_specs.labels()
        batched = int(self._m_batched.value)
        solo = int(self._m_solo.value)
        requests = batched + solo
        return {
            "window_ms": self.window_s * 1e3,
            "max_batch": self.max_batch,
            "dispatches": dispatches,
            "batched_requests": batched,
            "solo_requests": solo,
            "deadline_bypass": int(self._m_bypass.value),
            "mean_batch_size": (total / dispatches) if dispatches else 0.0,
            # Fraction of requests that actually shared a launch, and
            # the mean scenario rows per launch — the two numbers the
            # open-loop serving bench row reports.
            "fold_rate": (batched / requests) if requests else 0.0,
            "mean_folded_specs": (
                (specs.sum / specs.count) if specs.count else 0.0
            ),
        }

    def submit(
        self, key, item, *, deadline=None, tenant=None, trace=None, weight=1
    ):
        """Run ``item`` through a (possibly shared) dispatch; returns its
        own result.  Blocking — callers are the server's per-connection
        threads, each already holding a compute slot.

        ``tenant`` is pure attribution: concurrent tenants' same-key
        sweeps FOLD into one padded dispatch and split per tenant on
        return (bit-exact vs solo, because the combined dispatch is
        index-scattered and never reads the label).

        ``weight`` is the scenario-row count this member contributes to
        the folded dispatch (fold accounting only — never consulted by
        the dispatch itself).

        Deadline bypass is per member against the batch it would
        ACTUALLY join: a leader's wait budget is the full window, but a
        joiner's is only the window's remainder — so each member's OWN
        deadline is consulted (never just the leader's), and a joiner
        whose budget would expire before the leader dispatches goes
        solo instead of riding a batch it cannot afford.

        ``trace`` is the caller's
        :class:`~..telemetry.tracectx.TraceContext` (``None`` when the
        request is untraced): the leader's combined dispatch lands as a
        "batch:dispatch" child span of ITS request; every follower
        records a "batch:join" span under its OWN request whose
        ``links`` field names the leader's dispatch span — cross-trace
        causality without fake parentage."""
        solo = False
        with self._lock:
            batch = self._pending.get(key)
            joinable = (
                batch is not None
                and not batch.closed
                and len(batch.items) < self.max_batch
            )
            if deadline is not None:
                # The wait this member would actually sign up for: the
                # whole window when it would open a fresh batch, the
                # REMAINING window when it would join an open one.
                budget = (
                    max(
                        0.0,
                        self.window_s
                        - (self._clock() - batch.opened_at),
                    )
                    if joinable
                    else self.window_s
                )
                if deadline.remaining() <= budget:
                    # The wait would eat the caller's whole budget:
                    # dispatch alone, now.  (An already-expired deadline
                    # was shed upstream.)
                    solo = True
            if not solo:
                leader = False
                if not joinable:
                    batch = _Batch(opened_at=self._clock())
                    if self._trace_sink is not None:
                        from kubernetesclustercapacity_tpu_torch.telemetry.tracing import (  # noqa: E501
                            new_span_id,
                        )

                        batch.leader_span_id = new_span_id()
                    self._pending[key] = batch
                    leader = True
                idx = len(batch.items)
                batch.items.append(item)
                batch.tenants.append(tenant)
                batch.weights.append(weight)
                if len(batch.items) >= self.max_batch:
                    batch.full.set()
        if solo:
            # Outside the lock: a bypass dispatch must never hold the
            # fold queue shut while its kernel runs.
            self._m_bypass.inc()
            self._m_solo.inc()
            self._m_size.observe(1)
            self._m_tenants.observe(1)
            self._m_specs.observe(weight)
            return self._dispatch(key, [item])[0]

        from kubernetesclustercapacity_tpu_torch.telemetry import phases as _phases

        clk = _phases.current()
        if leader:
            t0 = time.perf_counter()
            with clk.live("batch_wait"):
                batch.full.wait(self.window_s)
            with self._lock:
                # Close under the same lock appends take: every item is
                # either in this snapshot or in a successor batch.
                batch.closed = True
                if self._pending.get(key) is batch:
                    del self._pending[key]
                items = list(batch.items)
            waited = time.perf_counter() - t0
            self._m_wait.observe(waited)
            # The leader's batch_wait is the window it held the door
            # open; its combined dispatch below records device phases on
            # this same (request) thread's clock.
            clk.record("batch_wait", waited)
            try:
                results = self._dispatch(key, items)
                if len(results) != len(items):
                    raise RuntimeError(
                        f"batch dispatch returned {len(results)} results "
                        f"for {len(items)} requests"
                    )
                batch.results = results
            except Exception as e:  # noqa: BLE001 - relayed per member
                batch.error = f"{type(e).__name__}: {e}"
                raise
            finally:
                self._m_size.observe(len(items))
                # Distinct tenants per dispatch: None (tenancy off)
                # counts as one anonymous tenant, so the histogram is
                # well-defined on the pre-tenancy path too.
                self._m_tenants.observe(
                    len(set(batch.tenants[: len(items)])) or 1
                )
                self._m_specs.observe(
                    sum(batch.weights[: len(items)]) or 1
                )
                if len(items) > 1:
                    self._m_batched.inc(len(items))
                    if self._fold_hook is not None:
                        try:
                            self._fold_hook(batch.tenants[: len(items)])
                        except Exception:  # noqa: BLE001 - accounting
                            pass  # must never fail a dispatch
                else:
                    self._m_solo.inc()
                batch.done.set()
                if trace is not None and self._trace_sink is not None:
                    from kubernetesclustercapacity_tpu_torch.telemetry import (
                        tracectx as _tracectx,
                    )

                    _tracectx.span(
                        self._trace_sink,
                        ts=time.time(),
                        trace_id=trace.trace_id,
                        span_id=batch.leader_span_id,
                        parent_span_id=trace.span_id,
                        op="batch:dispatch",
                        service="server",
                        leader=True,
                        batch_size=len(items),
                        duration_ms=round(
                            (time.perf_counter() - t0) * 1e3, 3
                        ),
                        status="error" if batch.error else "ok",
                    )
        else:
            t0 = time.perf_counter()
            with clk.live("batch_wait"):
                done = batch.done.wait(_FOLLOWER_TIMEOUT_S)
            wait_s = time.perf_counter() - t0
            # A follower's whole batching story is this wait: the
            # remainder of the leader's window plus the combined kernel
            # dispatch it rode.  Its own clock never sees device phases
            # — the leader's does — so batch_wait is the honest
            # per-request attribution.
            if clk:
                clk.record("batch_wait", wait_s)
            if trace is not None and self._trace_sink is not None:
                from kubernetesclustercapacity_tpu_torch.telemetry import (
                    tracectx as _tracectx,
                )
                from kubernetesclustercapacity_tpu_torch.telemetry.tracing import (
                    new_span_id,
                )

                _tracectx.span(
                    self._trace_sink,
                    ts=time.time(),
                    trace_id=trace.trace_id,
                    span_id=new_span_id(),
                    parent_span_id=trace.span_id,
                    op="batch:join",
                    service="server",
                    leader=False,
                    **(
                        {"links": [batch.leader_span_id]}
                        if batch.leader_span_id
                        else {}
                    ),
                    duration_ms=round(wait_s * 1e3, 3),
                    status="ok" if done else "error",
                )
            if not done:
                raise RuntimeError(
                    "micro-batch dispatch timed out waiting for its leader"
                )
        if batch.error is not None:
            raise RuntimeError(f"batched dispatch failed: {batch.error}")
        return batch.results[idx]
