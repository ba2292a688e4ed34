"""Shadow-oracle sampler: live parity monitoring off the request path.

Counterpart of ``kubernetesclustercapacity_tpu/audit/shadow.py``
(verbatim apart from imports).

A configurable fraction of live sweep responses is re-evaluated against
the pure-Python sequential oracle (:func:`~..oracle.fit_arrays_python`
— the same ground truth every kernel is pinned bit-exact against at
test time) on a background worker thread.  The request path pays only
the sampling decision and a queue append: no device work, no oracle
walk, and — like every other observability hook — zero registry calls
under ``KCCAP_TELEMETRY=0``.  Nothing here touches the device: the served
totals arrive as the host arrays the sweep reply is built from.

A divergence is treated as what it is — evidence of kernel/cache/batch
corruption in production:

* ``kccap_shadow_divergence_total`` increments and the
  ``kccap_shadow_divergence`` gauge flips to 1;
* the :class:`~..timeline.alerts.WatchAlert` machine (the SAME machine
  watchlist breaches drive) transitions ``ok → breached`` — sticky
  through ``recovered``, so "it diverged overnight" stays visible;
* a self-contained repro bundle (generation, snapshot digest, the full
  scenario grid, served vs oracle totals, the generation's audit ref)
  is appended as JSONL — :func:`~.replay.replay_shadow_bundle` turns it
  into an offline confirmed mismatch;
* ``/healthz`` reports it (the server's health callable consults
  :attr:`ShadowSampler.diverged`) and ``kccap -doctor -doctor-service``
  prints it as a hard FAILED line.

Sampling is deterministic (an error-diffusion accumulator, not an
RNG): at rate ``r`` exactly every ``1/r``-th eligible sweep is
checked, so a fault is detected within one sample window.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque

import numpy as np

from kubernetesclustercapacity_tpu_torch.timeline.alerts import WatchAlert
from kubernetesclustercapacity_tpu_torch.timeline.diff import snapshot_digest

__all__ = ["ShadowSampler", "oracle_totals"]

#: Sentinel: derive the node mask from the snapshot (the implicit
#: strict-mode taint mask every serving surface applies).
_IMPLICIT = "implicit"


def oracle_totals(snapshot, grid, node_mask=_IMPLICIT) -> list[int]:
    """Sequential-oracle sweep totals for one snapshot × grid — the
    reference answer a served sweep must equal.  ``node_mask`` defaults
    to the snapshot's own implicit taint mask (what the service
    applies); pass an explicit mask (or ``None``) to override."""
    # Imported here: the package's import of ``masks`` reaches this
    # module (through the device ledger, the timeline and the forecast's
    # audit-log reader) before ``masks`` has finished initialising.
    from kubernetesclustercapacity_tpu_torch.masks import implicit_taint_mask
    from kubernetesclustercapacity_tpu_torch.oracle import fit_arrays_python

    if node_mask is _IMPLICIT:
        node_mask = implicit_taint_mask(snapshot)
    healthy = np.asarray(snapshot.healthy, dtype=bool)
    if node_mask is not None:
        healthy = healthy & np.asarray(node_mask, dtype=bool)
    totals = []
    for s in range(grid.size):
        fits = fit_arrays_python(
            snapshot.alloc_cpu_milli,
            snapshot.alloc_mem_bytes,
            snapshot.alloc_pods,
            snapshot.used_cpu_req_milli,
            snapshot.used_mem_req_bytes,
            snapshot.pods_count,
            int(grid.cpu_request_milli[s]),
            int(grid.mem_request_bytes[s]),
            mode=snapshot.semantics,
            healthy=healthy,
        )
        totals.append(int(sum(fits)))
    return totals


class ShadowSampler:
    """Sample live sweeps, re-check against the oracle, alarm on drift.

    ``sample_rate`` is the checked fraction of eligible sweeps (0 — the
    default posture — disables sampling entirely; 1 checks every
    sweep).  ``bundle_path`` receives one JSONL repro bundle per
    divergent check; with ``audit_log`` set the bundle also lands in
    the audit log itself and carries the divergent generation's audit
    ref.  ``max_queue`` bounds the worker backlog — a slow oracle must
    shed samples, never requests (drops are counted).
    """

    def __init__(
        self,
        sample_rate: float,
        *,
        registry=None,
        oracle=None,
        bundle_path: str | None = None,
        audit_log=None,
        max_queue: int = 128,
        on_divergence=None,
    ) -> None:
        rate = float(sample_rate)
        if not 0.0 <= rate <= 1.0:
            raise ValueError(
                f"sample_rate must be in [0, 1], got {sample_rate}"
            )
        self.sample_rate = rate
        self._oracle = oracle
        self._bundle_path = bundle_path
        self._audit_log = audit_log
        self._max_queue = max(1, int(max_queue))
        self._on_divergence = on_divergence
        self._alert = WatchAlert("shadow-oracle", min_replicas=1)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._inflight = 0
        self._worker: threading.Thread | None = None
        self._closed = False
        self._acc = 0.0
        self._sampled = 0
        self._checked = 0
        self._divergences = 0
        self._dropped = 0
        self._oracle_errors = 0
        self._last_divergence: dict | None = None
        self._m = None
        if registry is not None:
            from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
                enabled as _telemetry_enabled,
            )

            if _telemetry_enabled():
                self._m = {
                    "checked": registry.counter(
                        "kccap_shadow_checked_total",
                        "Live sweep responses re-checked against the "
                        "pure-Python oracle.",
                    ),
                    "divergence": registry.counter(
                        "kccap_shadow_divergence_total",
                        "Shadow checks whose served totals diverged "
                        "from the oracle.",
                    ),
                    "diverged": registry.gauge(
                        "kccap_shadow_divergence",
                        "1 while the shadow-oracle alert is breached "
                        "(a divergence was seen and no clean check "
                        "followed), else 0.",
                    ),
                    "dropped": registry.counter(
                        "kccap_shadow_dropped_total",
                        "Sampled sweeps shed because the shadow queue "
                        "was full.",
                    ),
                }

    # -- request-path side -------------------------------------------------
    def maybe_submit(
        self,
        snapshot,
        generation,
        grid,
        totals,
        schedulable,
        *,
        node_mask=None,
        ts=None,
        trace_id=None,
    ) -> bool:
        """Sampling decision + queue append; the ENTIRE request-path
        cost.  Returns whether this sweep was sampled.  ``totals`` /
        ``schedulable`` are the served answers (host arrays/lists);
        ``node_mask`` is the mask the serving dispatch applied.
        ``trace_id`` is the originating request's trace — a divergence
        bundle that names it can be joined straight to the retained
        span tree of the request that produced the bad answer."""
        if self.sample_rate <= 0.0:
            return False
        with self._cond:
            # Checked under the lock: a lock-free read raced close() —
            # a sample admitted after _closed flips would sit in the
            # queue forever (the worker exits on close).
            if self._closed:
                return False
            self._acc += self.sample_rate
            if self._acc < 1.0:
                return False
            self._acc -= 1.0
            self._sampled += 1
            if len(self._queue) >= self._max_queue:
                self._dropped += 1
                if self._m is not None:
                    self._m["dropped"].inc()
                return True
            self._queue.append(
                (
                    snapshot,
                    generation,
                    grid,
                    np.asarray(totals, dtype=np.int64).copy(),
                    np.asarray(schedulable, dtype=bool).copy(),
                    None if node_mask is None else np.asarray(
                        node_mask, dtype=bool
                    ).copy(),
                    time.time() if ts is None else float(ts),
                    trace_id if isinstance(trace_id, str) else None,
                )
            )
            if self._worker is None:
                from kubernetesclustercapacity_tpu_torch.utils.threads import (
                    supervised,
                )

                self._worker = threading.Thread(
                    target=supervised(self._run, name="kccap-shadow"),
                    daemon=True,
                    name="kccap-shadow",
                )
                self._worker.start()
            self._cond.notify()
        return True

    # -- worker side -------------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait(0.25)
                if self._closed and not self._queue:
                    return
                job = self._queue.popleft()
                self._inflight += 1
            try:
                self._check(*job)
            except Exception:  # noqa: BLE001 - monitoring never crashes
                with self._cond:
                    self._oracle_errors += 1
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._cond.notify_all()

    def _check(
        self, snapshot, generation, grid, totals, schedulable, node_mask,
        ts, trace_id=None,
    ) -> None:
        if self._oracle is not None:
            oracle = [
                int(t) for t in self._oracle(snapshot, grid, node_mask)
            ]
        else:
            oracle = oracle_totals(
                snapshot, grid, node_mask=node_mask
            )
        replicas = np.asarray(grid.replicas, dtype=np.int64)
        rows = []
        for s in range(grid.size):
            want_sched = oracle[s] >= int(replicas[s])
            if int(totals[s]) != oracle[s] or bool(
                schedulable[s]
            ) != want_sched:
                rows.append(
                    {
                        "scenario": s,
                        "served_total": int(totals[s]),
                        "oracle_total": oracle[s],
                        "served_schedulable": bool(schedulable[s]),
                        "oracle_schedulable": want_sched,
                    }
                )
        gen_for_alert = generation if isinstance(generation, int) else -1
        with self._cond:
            self._checked += 1
            if rows:
                self._divergences += 1
        if self._m is not None:
            self._m["checked"].inc()
        if not rows:
            self._alert.update(1, gen_for_alert)
            if self._m is not None:
                self._m["diverged"].set(
                    1 if self._alert.state == "breached" else 0
                )
            return
        bundle = {
            "kind": "shadow_divergence",
            "ts": ts,
            **({"trace_id": trace_id} if trace_id else {}),
            "generation": generation,
            "digest": snapshot_digest(snapshot),
            "semantics": snapshot.semantics,
            "nodes": snapshot.n_nodes,
            "scenarios": grid.size,
            "cpu_request_milli": np.asarray(
                grid.cpu_request_milli
            ).tolist(),
            "mem_request_bytes": np.asarray(
                grid.mem_request_bytes
            ).tolist(),
            "replicas": replicas.tolist(),
            "served_totals": np.asarray(totals).tolist(),
            "oracle_totals": oracle,
            "divergent_scenarios": len(rows),
            "rows": rows[:16],
        }
        if self._audit_log is not None:
            try:
                ref = self._audit_log.generation_ref(generation)
                if ref is not None:
                    bundle["audit_ref"] = ref
                bundle["audit_dir"] = self._audit_log.directory
            except Exception:  # noqa: BLE001 - bundling is best-effort
                pass
        self._alert.update(0, gen_for_alert)
        with self._cond:
            self._last_divergence = {
                k: bundle[k]
                for k in (
                    "ts", "generation", "digest", "semantics",
                    "divergent_scenarios",
                )
            }
        if self._m is not None:
            self._m["divergence"].inc()
            self._m["diverged"].set(1)
        self._write_bundle(bundle)
        if self._on_divergence is not None:
            try:
                self._on_divergence(bundle)
            except Exception:  # noqa: BLE001 - observer, not dispatcher
                pass

    def _write_bundle(self, bundle: dict) -> None:
        if self._bundle_path:
            try:
                with open(self._bundle_path, "a", encoding="utf-8") as fh:
                    fh.write(json.dumps(bundle, sort_keys=True) + "\n")
            except OSError:
                pass
        if self._audit_log is not None:
            try:
                self._audit_log.append_raw(bundle)
            except Exception:  # noqa: BLE001 - best-effort
                pass

    # -- read surfaces -----------------------------------------------------
    @property
    def diverged(self) -> bool:
        """True while the shadow alert is breached — the ``/healthz``
        verdict (a clean check after a divergence moves to
        ``recovered``, restoring health but keeping the history)."""
        return self._alert.state == "breached"

    def stats(self) -> dict:
        """Compact health view (``info {audit: true}``, ``/healthz``,
        doctor)."""
        with self._cond:
            return {
                "sample_rate": self.sample_rate,
                "sampled": self._sampled,
                "checked": self._checked,
                "divergences": self._divergences,
                "dropped": self._dropped,
                "oracle_errors": self._oracle_errors,
                "queue": len(self._queue),
                "alert": self._alert.to_wire(),
                "last_divergence": self._last_divergence,
            }

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Block until every queued sample is checked (tests/bench)."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while self._queue or self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, 0.25))
        return True

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            # Snapshot under the lock: _worker is lazily spawned under
            # _cond, so a lock-free read could miss a thread started by
            # a concurrent submit and skip the join below.
            worker = self._worker
        if worker is not None:
            worker.join(timeout=5.0)
