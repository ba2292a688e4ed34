"""Environment diagnostics: a hang-proof report of the stack's health.

Counterpart of ``kubernetesclustercapacity_tpu/utils/doctor.py``: the same
checks, in the same order, with the same names and the same verdict rules
(a line starting HUNG, FAILED or DISABLED fails ``-doctor``).  Where the
JAX doctor asks PJRT, this one asks torch and CUDA:

* ``backend probe`` runs a killable child that imports only ``torch``, so
  a hang indicts the CUDA stack or the card, never this package.  On
  ``device="cuda"`` it initialises the card and names it
  (``torch.cuda.get_device_name``) with the count of visible cards; with
  no card it is a FAILED line.  On ``device="cpu"`` it reports the host.
  A child that does not answer within the timeout is killed as a process
  group: a wedged CUDA init can only be recovered by killing the
  process that attempted it, and the doctor must never become the thing
  it diagnoses;
* ``x64 ints`` says that int64 is native in torch (there is no switch to
  forget), so it never fails;
* ``fused fast path`` reads the breaker the ``info`` op reports, which
  never opens (a kernel that fails to build or launch raises); it builds
  and launches nothing;
* ``native kernel (C++)``, ``native pod-walk (C ext)`` and ``sanitizer``
  are soft lines: those modules are not ported yet;
* ``device memory`` reconciles the port's device ledger against the
  caching allocator, as ``/healthz`` does; ``optimizer`` runs one small
  certified solve on the chosen device.

The service lines (``-doctor-service``) and the ``federation`` line
(``-doctor-federation``) read a running port or JAX server over the wire,
exactly as the JAX doctor does.  Surfaced via ``kccap-torch -doctor``
(``cli.py``).
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

__all__ = ["run_doctor", "doctor_report", "healthy"]

# The probe child's entire program: stdlib + torch only, so a hang here
# indicts the environment, not this package.  Its one argument is the
# device the caller asked for.
_PROBE_CODE = """\
import sys
import time
t0 = time.time()
import torch
if sys.argv[1:2] == ["cpu"]:
    print("DEVICES %.1fs cpu x1" % (time.time() - t0), flush=True)
    raise SystemExit(0)
if not torch.cuda.is_available():
    raise SystemExit("CUDA is not available (pass -device cpu to run on "
                     "the host)")
torch.zeros(1, device="cuda").add_(1).item()
print("DEVICES %.1fs %s x%d" % (time.time() - t0,
      torch.cuda.get_device_name(0), torch.cuda.device_count()), flush=True)
"""


def _probe_backend(
    timeout_s: float, probe_code: str = _PROBE_CODE, device: str = "cuda"
) -> str:
    """Run the device probe in a killable child; never hangs.

    Output is read by a pump thread, not ``communicate()``: on this
    path (single merged pipe + text mode + timeout) CPython's
    retry-without-loss guarantee proved unreliable — partial output
    written before the hang vanished, and that partial output is
    exactly the diagnostic a wedged-init report needs.
    """
    import threading

    proc = subprocess.Popen(
        [sys.executable, "-c", probe_code, str(device)],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
        start_new_session=True,
    )
    lines: list[str] = []

    def pump() -> None:
        assert proc.stdout is not None
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))

    # kccap: lint-ok[hygiene-thread-death] pump lifetime is bounded by reader.join(timeout); a late death only truncates probe output, never the report
    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    try:
        proc.wait(timeout=timeout_s)
        hung = False
    except subprocess.TimeoutExpired:
        hung = True
        # Whole-group SIGKILL: a CUDA init blocked in C++ ignores
        # SIGTERM, and its helper threads must go with it.
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError, OSError):
            pass
        try:
            proc.wait(timeout=10)
        except Exception:  # noqa: BLE001 - best-effort reap
            pass
    reader.join(timeout=5)  # EOF follows the kill; bounded regardless
    if proc.stdout is not None:
        proc.stdout.close()
    if hung:
        tail = [ln for ln in lines if ln][-2:]
        return (
            f"HUNG: backend init did not return within {timeout_s:.0f}s "
            "(killed) — the CUDA stack or the card is wedged; CPU "
            "surfaces (-device cpu, -backend cpu, packing, store) still "
            "work"
            + (f" | last output: {' | '.join(tail)}" if tail else "")
        )
    for line in lines:
        if line.startswith("DEVICES"):
            return "ok: " + line[len("DEVICES "):]
    tail = [ln for ln in lines if ln][-3:]
    return "FAILED: " + (" | ".join(tail) if tail else "no output")


def doctor_report(
    *,
    backend_timeout_s: float = 30.0,
    probe_code: str | None = None,
    service_addr: tuple[str, int] | None = None,
    federation_addr: tuple[str, int] | None = None,
    device: str = "cuda",
) -> list[tuple[str, str]]:
    """Collect (check, result) pairs.  Pure data; rendering is the CLI's.

    ``probe_code`` defaults to the module's probe at CALL time (not def
    time) so tests can swap ``_PROBE_CODE`` without re-binding defaults.
    ``device`` is what the probe, the device-memory line and the optimizer
    check run on (``"cuda"`` unless the caller asks for ``"cpu"``).
    """
    if probe_code is None:
        probe_code = _PROBE_CODE
    checks: list[tuple[str, str]] = []

    def check(name: str, fn) -> None:
        # One broken subsystem must become a FAILED line, never abort the
        # report — broken environments are exactly what -doctor triages,
        # and the backend probe's result must survive whatever follows.
        try:
            checks.append((name, fn()))
        except Exception as e:  # noqa: BLE001 - diagnostic must complete
            checks.append((name, f"FAILED: {type(e).__name__}: {e}"))

    def _pkg():
        import kubernetesclustercapacity_tpu_torch as kcc

        return f"kubernetesclustercapacity_tpu_torch {kcc.__version__}"

    check("package", _pkg)
    check(
        "platform env",
        lambda: (
            f"device {device}, CUDA_VISIBLE_DEVICES="
            + os.environ.get("CUDA_VISIBLE_DEVICES", "(default)")
        ),
    )
    check(
        "backend probe",
        lambda: _probe_backend(backend_timeout_s, probe_code, device),
    )
    # int64 is native in torch: there is no switch to leave off.
    check("x64 ints", lambda: "ok: int64 is native in torch")
    check(
        "native kernel (C++)",
        lambda: (
            "unavailable (not yet ported to the PyTorch package) — "
            "-backend native off"
        ),
    )
    check(
        "native pod-walk (C ext)",
        lambda: (
            "unavailable (not yet ported to the PyTorch package) — "
            "packers use the pure-Python walk"
        ),
    )

    def _fast():
        # The breaker the info op reports: it never opens, because a
        # kernel that fails to build or launch raises.  Nothing is built
        # or launched here.
        from kubernetesclustercapacity_tpu_torch.service.server import (
            _NEVER_OPEN,
        )

        b = _NEVER_OPEN.snapshot()
        err = b["last_error"]
        if b["state"] != "closed" or err:
            return (
                f"degraded: breaker {b['state']}, trips={b['trips']}, "
                f"rejected={b['rejected']}"
                + (f" — {err}" if err else "")
            )
        return (
            "armed (never trips: a kernel that fails to build or launch "
            f"raises; breaker closed, successes={b['successes']})"
        )

    check("fused fast path", _fast)

    def _telemetry():
        # The process registry + one exposition render: proves the
        # scrape surface works in THIS environment (and how big it is)
        # without binding a port.
        from kubernetesclustercapacity_tpu_torch.telemetry.exposition import (
            render_text,
        )
        from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
            REGISTRY,
            enabled,
        )

        if not enabled():
            return "disabled (KCCAP_TELEMETRY=0) — registry calls off"
        families = REGISTRY.collect()
        text = render_text(REGISTRY)
        return (
            f"ok: {len(families)} metric families, exposition renders "
            f"{len(text)} bytes"
        )

    check("telemetry", _telemetry)

    def _hot_path():
        # The process device cache: hit rates say whether repeat sweeps
        # are actually reusing device-resident columns.  Eager PyTorch
        # compiles nothing per shape, so there is no bucket ladder.
        from kubernetesclustercapacity_tpu_torch import devcache

        st = devcache.CACHE.stats()
        return (
            f"ok: {st['entries']} entries, hits={st['hits']} "
            f"misses={st['misses']} hit_rate={st['hit_rate']:.2f}, "
            "no shape-bucket ladder"
        )

    check("device snapshot cache", _hot_path)

    def _sanitizer():
        # The dynamic sanitizer is not ported yet; the supervised-thread
        # death note still reads this process's own workers.
        from kubernetesclustercapacity_tpu_torch.utils import threads as _threads

        deaths = _threads.death_count()
        death_note = ""
        if deaths:
            name, err = _threads.last_death()
            death_note = (
                f"; WARNING {deaths} supervised thread death(s), "
                f"last: {name}: {err}"
            )
        return (
            "unavailable (not yet ported to the PyTorch package) — zero "
            "instrumentation" + death_note
        )

    check("sanitizer", _sanitizer)

    def _profiler():
        # The continuous profiler's standing state: armed/sampling/off.
        # Off is soft (a configuration, not a failure); a profiler whose
        # supervised sampler died shows up in the sanitizer line's
        # thread-death note.
        from kubernetesclustercapacity_tpu_torch.telemetry.profiler import (
            profiler_status,
        )

        return profiler_status()

    check("profiler", _profiler)

    def _device_memory():
        # The device-memory book: live/peak staged bytes and the leak
        # alert.  A sustained reconcile discrepancy or a breached HBM
        # budget is a hard FAILED line — silent device leaks are the
        # incident class the ledger exists to make impossible.
        from kubernetesclustercapacity_tpu_torch.telemetry.memledger import (
            device_memory_status,
            enabled as _ledger_enabled,
        )
        from kubernetesclustercapacity_tpu_torch.telemetry.memledger import (
            LEDGER,
        )

        if _ledger_enabled():
            # Reconciled against the caching allocator, as /healthz does
            # (0 bytes where the chosen device is the host).
            try:
                LEDGER.reconcile()
            except Exception:  # noqa: BLE001 - audit must not abort
                pass
        return device_memory_status()

    check("device memory", _device_memory)

    def _optimizer():
        # One tiny certified solve in-process: proves the LP/PDHG
        # backend converges AND certifies on this host — an optimizer
        # that cannot close its duality gap is a hard FAILED line (its
        # bounds would be valid but useless).
        import numpy as _np

        from kubernetesclustercapacity_tpu_torch.optimize import (
            optimize_snapshot,
        )
        from kubernetesclustercapacity_tpu_torch.scenario import ScenarioGrid
        from kubernetesclustercapacity_tpu_torch.snapshot import (
            synthetic_snapshot,
        )

        snap = synthetic_snapshot(64, seed=3, shapes=4)
        grid = ScenarioGrid(
            cpu_request_milli=_np.array([250, 2000], dtype=_np.int64),
            mem_request_bytes=_np.array(
                [256 << 20, 2 << 30], dtype=_np.int64
            ),
            replicas=_np.array([10**6, 3], dtype=_np.int64),
        )
        r = optimize_snapshot(snap, grid, mode="strict", device=device)
        if not r.all_certified:
            return (
                "FAILED: uncertified solve — worst gap "
                f"{float(r.duality_gap.max()):.2e} after "
                f"{r.iterations} iteration(s) (tol {r.tol})"
            )
        if r.verified is not None and not bool(r.verified.all()):
            return "FAILED: rounded packing failed oracle verification"
        return (
            f"ok: certified in {r.iterations} iteration(s), worst gap "
            f"{float(r.duality_gap.max()):.1e}, bound "
            f"{float(r.lp_bound[0]):.1f} vs rounded "
            f"{int(r.rounded[0])}"
        )

    check("optimizer", _optimizer)

    if service_addr is not None:
        # A LIVE service's resilience counters (deadline sheds, breaker
        # state, follower retry/backoff) — the doctor probes the same
        # info op clients use, with a short budget so a wedged server
        # cannot hang the report.
        def _service():
            from kubernetesclustercapacity_tpu_torch.resilience import RetryPolicy
            from kubernetesclustercapacity_tpu_torch.service.client import (
                CapacityClient,
            )

            with CapacityClient(
                *service_addr,
                connect_timeout_s=5.0,
                timeout_s=5.0,
                retry=RetryPolicy(max_attempts=2, base_delay_s=0.1),
                deadline_s=5.0,
            ) as c:
                info = c.info(metrics=True, hot_path=True)
            r = info.get("resilience", {})
            fp = r.get("fast_path_breaker", {})
            parts = [
                f"ok: {info.get('nodes')} nodes ({info.get('semantics')})",
                f"deadline_shed={r.get('deadline_shed')}",
                f"fast_path={fp.get('state')}",
            ]
            hp = info.get("hot_path") or {}
            dc = hp.get("devcache")
            if dc:
                parts.append(
                    f"devcache_hit_rate={dc.get('hit_rate', 0):.2f}"
                )
            bt = hp.get("batching")
            if bt:
                parts.append(
                    f"mean_batch={bt.get('mean_batch_size', 0):.2f}"
                )
            reqs = (
                info.get("metrics", {})
                .get("kccap_requests_total", {})
                .get("values", {})
            )
            if reqs:
                parts.append(f"requests={int(sum(reqs.values()))}")
            follower = r.get("follower")
            if follower:
                parts.append(
                    "follower relists=%s watch_failures=%s backoff=%s"
                    % (
                        follower.get("relists"),
                        follower.get("watch_failures"),
                        follower.get("backoff_s") or "none",
                    )
                )
            return " ".join(parts)

        check("capacity service", _service)

        # Multi-tenancy: is a tenant map armed, how many tenants, who
        # is being shed.  A server without -tenants reports a soft
        # "off" line (single-tenant deployments are the default, not a
        # failure).  Separate connection for the usual isolation reason.
        def _tenancy():
            from kubernetesclustercapacity_tpu_torch.resilience import RetryPolicy
            from kubernetesclustercapacity_tpu_torch.service.client import (
                CapacityClient,
            )

            with CapacityClient(
                *service_addr,
                connect_timeout_s=5.0,
                timeout_s=5.0,
                retry=RetryPolicy(max_attempts=2, base_delay_s=0.1),
                deadline_s=5.0,
            ) as c:
                info = c.info(tenancy=True)
            caps = info.get("capabilities") or {}
            ten = info.get("tenancy")
            if not caps.get("tenancy") or not isinstance(ten, dict):
                return "off (no -tenants map; single-tenant admission)"
            # info's "tenants" key carries TenantMap.to_wire(), which
            # nests the spec list under its own "tenants" key.
            tmap = ten.get("tenants") or {}
            specs = tmap.get("tenants") or [] if isinstance(
                tmap, dict
            ) else tmap
            parts = [f"ok: {len(specs)} tenant(s)"]
            adm = ten.get("admission")
            if isinstance(adm, dict):
                active = adm.get("active") or {}
                shed = adm.get("shed") or {}
                if active:
                    parts.append(
                        "active="
                        + ",".join(
                            f"{t}:{n}" for t, n in sorted(active.items())
                        )
                    )
                total_shed = sum(shed.values()) if shed else 0
                parts.append(f"tenant_shed={total_shed}")
                fq = adm.get("fair_queue")
                if isinstance(fq, dict):
                    parts.append(
                        f"fair_queue={fq.get('free')}/{fq.get('slots')} free"
                        f" waiting={fq.get('waiting')}"
                    )
            return " ".join(parts)

        check("tenancy", _tenancy)

        # The service's capacity timeline: generation history + watch
        # alert states — the "did capacity drift while nobody looked"
        # line.  Same short budgets; separate connection so a timeline
        # failure cannot contaminate the lines above.
        def _timeline():
            from kubernetesclustercapacity_tpu_torch.resilience import RetryPolicy
            from kubernetesclustercapacity_tpu_torch.service.client import (
                CapacityClient,
            )

            with CapacityClient(
                *service_addr,
                connect_timeout_s=5.0,
                timeout_s=5.0,
                retry=RetryPolicy(max_attempts=2, base_delay_s=0.1),
                deadline_s=5.0,
            ) as c:
                t = c.timeline()
            if not t.get("enabled", False):
                return "not configured (-watch / -timeline-depth off)"
            parts = [
                f"ok: {t.get('count')}/{t.get('depth')} generations",
                f"generation={t.get('generation')}",
                f"watches={len(t.get('watchlist', []))}",
            ]
            alerts = t.get("alerts", {})
            flagged = [
                f"{name}={a['state']}(breaches={a['breaches']})"
                for name, a in sorted(alerts.items())
                if a.get("state") != "ok"
            ]
            if flagged:
                parts.append("alerts: " + " ".join(flagged))
            elif alerts:
                parts.append("alerts: all ok")
            return " ".join(parts)

        check("capacity timeline", _timeline)

        # The service's capacity-at-risk watches: the last quantile
        # capacities and their alert states.  A breached quantile watch
        # is a hard FAILED line — it is a standing confidence statement
        # ("with 95% confidence fewer than N replicas fit") that the
        # cluster no longer meets, the stochastic analog of a breached
        # SLO.  Same short budgets; separate connection so a car-op
        # failure cannot contaminate the timeline line above.
        def _car():
            from kubernetesclustercapacity_tpu_torch.resilience import RetryPolicy
            from kubernetesclustercapacity_tpu_torch.service.client import (
                CapacityClient,
            )

            with CapacityClient(
                *service_addr,
                connect_timeout_s=5.0,
                timeout_s=5.0,
                retry=RetryPolicy(max_attempts=2, base_delay_s=0.1),
                deadline_s=5.0,
            ) as c:
                status = c.car()
            if not status.get("enabled", False):
                return "not configured (no quantile: watches in -watch)"
            parts = []
            for name in sorted(status.get("watches", {})):
                w = status["watches"][name]
                parts.append(
                    f"{name}=p{w['quantile'] * 100:g}:"
                    f"{w.get('last_total')}"
                    f"(pfit={w.get('prob_fit')},"
                    f"{w['alert']['state']})"
                )
            breached = status.get("breached", [])
            if breached:
                return (
                    "FAILED: capacity-at-risk breach — "
                    + ", ".join(breached)
                    + " below min_replicas at their quantile; "
                    + " ".join(parts)
                )
            return "ok: " + " ".join(parts)

        check("capacity at risk", _car)

        # The service's gang watches: the last whole-gang counts and
        # their alert states.  A breached gang watch is a hard FAILED
        # line — "fewer than N whole gangs fit" is the all-or-nothing
        # capacity statement a training-job admission plane relies on,
        # the gang analog of a breached quantile watch.  Same short
        # budgets; separate connection so a gang-op failure cannot
        # contaminate the lines above.
        def _gang():
            from kubernetesclustercapacity_tpu_torch.resilience import RetryPolicy
            from kubernetesclustercapacity_tpu_torch.service.client import (
                CapacityClient,
            )

            with CapacityClient(
                *service_addr,
                connect_timeout_s=5.0,
                timeout_s=5.0,
                retry=RetryPolicy(max_attempts=2, base_delay_s=0.1),
                deadline_s=5.0,
            ) as c:
                status = c.gang()
            if not status.get("enabled", False):
                return "not configured (no gang: watches in -watch)"
            parts = []
            for name in sorted(status.get("watches", {})):
                w = status["watches"][name]
                parts.append(
                    f"{name}={w.get('last_gangs')}x{w['ranks']}rank"
                    f"({w.get('binding')},{w['alert']['state']})"
                )
            breached = status.get("breached", [])
            if breached:
                return (
                    "FAILED: gang capacity breach — "
                    + ", ".join(breached)
                    + " below min_replicas whole gangs; "
                    + " ".join(parts)
                )
            return "ok: " + " ".join(parts)

        check("gang capacity", _gang)

        # The service's forecast (horizon) watches: the projected
        # quantile minimum over each watch's horizon and the
        # time-to-breach.  A breached horizon watch is a hard FAILED
        # line — "the p95 capacity crosses the threshold within the
        # horizon" is the early-warning statement an autoscaler plans
        # against, and it fires BEFORE the plain quantile watch does.
        # Same short budgets; separate connection so a forecast-op
        # failure cannot contaminate the lines above.
        def _forecast():
            from kubernetesclustercapacity_tpu_torch.resilience import RetryPolicy
            from kubernetesclustercapacity_tpu_torch.service.client import (
                CapacityClient,
            )

            with CapacityClient(
                *service_addr,
                connect_timeout_s=5.0,
                timeout_s=5.0,
                retry=RetryPolicy(max_attempts=2, base_delay_s=0.1),
                deadline_s=5.0,
            ) as c:
                status = c.forecast()
            if not status.get("enabled", False):
                return "not configured (no horizon: watches in -watch)"
            parts = []
            for name in sorted(status.get("watches", {})):
                w = status["watches"][name]
                ttb = w.get("time_to_breach_s")
                parts.append(
                    f"{name}=p{w['quantile'] * 100:g}:"
                    f"min{w.get('horizon_min_capacity')}"
                    f"(ttb={'-' if ttb is None else f'{ttb:g}s'},"
                    f"{w['alert']['state']})"
                )
            breached = status.get("breached", [])
            if breached:
                return (
                    "FAILED: forecast breach — "
                    + ", ".join(breached)
                    + " projected below min_replicas within their "
                    "horizon; " + " ".join(parts)
                )
            return "ok: " + " ".join(parts)

        check("capacity forecast", _forecast)

        # The service's audit log + shadow oracle: is correctness being
        # continuously observed, and has it ever been caught lying?  A
        # recorded divergence is a hard FAILED line — it means a served
        # answer disagreed with the sequential oracle in production,
        # which is exactly the incident this check exists to surface.
        def _audit_shadow():
            from kubernetesclustercapacity_tpu_torch.resilience import RetryPolicy
            from kubernetesclustercapacity_tpu_torch.service.client import (
                CapacityClient,
            )

            with CapacityClient(
                *service_addr,
                connect_timeout_s=5.0,
                timeout_s=5.0,
                retry=RetryPolicy(max_attempts=2, base_delay_s=0.1),
                deadline_s=5.0,
            ) as c:
                a = c.audit_status()
            if not a.get("enabled", False):
                return (
                    "not configured (-audit-dir / -shadow-sample-rate off)"
                )
            parts = []
            log = a.get("log")
            if log:
                parts.append(
                    f"audit: {log['records']} record(s) in "
                    f"{log['segments']} segment(s), "
                    f"generation={log['last_generation']}"
                )
            sh = a.get("shadow")
            if sh:
                parts.append(
                    f"shadow: rate={sh['sample_rate']} "
                    f"checked={sh['checked']} "
                    f"divergences={sh['divergences']} "
                    f"state={sh['alert']['state']}"
                )
                if sh["divergences"]:
                    return (
                        "FAILED: shadow-oracle divergence — served "
                        "answers disagreed with the oracle; "
                        + " ".join(parts)
                    )
            return "ok: " + " ".join(parts)

        check("audit & shadow", _audit_shadow)

        # The service's own latency + SLO burn-rate state: p50/p99 of
        # its request-latency histogram (estimated from the scrape's
        # buckets) and every -slo objective's alert state.  A breached
        # objective is a hard FAILED line — the service is burning its
        # error budget faster than the page threshold RIGHT NOW.
        def _latency_slo():
            from kubernetesclustercapacity_tpu_torch.resilience import RetryPolicy
            from kubernetesclustercapacity_tpu_torch.service.client import (
                CapacityClient,
            )
            from kubernetesclustercapacity_tpu_torch.telemetry.slo import (
                estimate_quantile,
            )

            with CapacityClient(
                *service_addr,
                connect_timeout_s=5.0,
                timeout_s=5.0,
                retry=RetryPolicy(max_attempts=2, base_delay_s=0.1),
                deadline_s=5.0,
            ) as c:
                slo = c.slo_status()
                info = c.info(metrics=True)
            parts = []
            lat = (
                info.get("metrics", {})
                .get("kccap_request_latency_seconds", {})
                .get("values", {})
            )
            # Pool every op's buckets into one overall latency estimate
            # (cumulative dicts share boundaries by construction).
            pooled: dict[str, int] = {}
            count = 0
            for hist in lat.values():
                count += hist.get("count", 0)
                for le, cum in hist.get("buckets", {}).items():
                    pooled[le] = pooled.get(le, 0) + cum
            if count:
                p50 = estimate_quantile(pooled, count, 0.50)
                p99 = estimate_quantile(pooled, count, 0.99)
                parts.append(
                    f"latency p50={p50 * 1e3:.1f}ms "
                    f"p99={p99 * 1e3:.1f}ms over {count} request(s)"
                )
            if not slo.get("enabled", False):
                parts.append("slo: not configured (-slo off)")
                return "ok: " + " ".join(parts)
            states = []
            breached = []
            for name in sorted(slo.get("status", {})):
                s = slo["status"][name]
                states.append(f"{name}={s['state']}")
                if s["state"] == "breached":
                    breached.append(
                        f"{name} ({s['objective']}, "
                        f"short={s['short_burn']:.1f}x "
                        f"long={s['long_burn']:.1f}x)"
                    )
            parts.append("slo: " + " ".join(states))
            if breached:
                return (
                    "FAILED: error budget fast-burning — "
                    + "; ".join(breached) + "; " + " ".join(parts)
                )
            return "ok: " + " ".join(parts)

        check("latency & SLO", _latency_slo)

        # The service's flight recorder: its last-K request history over
        # the dump op — one line of "what was this server just doing"
        # before anyone attaches a debugger.  Same short budgets as the
        # info probe; separate connection so a dump-op failure cannot
        # contaminate the resilience line above.
        def _flight():
            from kubernetesclustercapacity_tpu_torch.resilience import RetryPolicy
            from kubernetesclustercapacity_tpu_torch.service.client import (
                CapacityClient,
            )

            with CapacityClient(
                *service_addr,
                connect_timeout_s=5.0,
                timeout_s=5.0,
                retry=RetryPolicy(max_attempts=2, base_delay_s=0.1),
                deadline_s=5.0,
            ) as c:
                dump = c.dump()
            records = dump.get("records", [])
            parts = [
                f"ok: {dump.get('count')}/{dump.get('capacity')} records",
                f"generation={dump.get('generation')}",
                f"dropped={dump.get('dropped')}",
            ]
            errors = sum(1 for r in records if r.get("status") == "error")
            if errors:
                parts.append(f"errors={errors}")
            if records:
                last = records[-1]
                parts.append(
                    f"last={last.get('op')}/{last.get('status')} "
                    f"{last.get('latency_ms')}ms"
                )
            return " ".join(parts)

        check("flight recorder", _flight)

        # Tracing posture: is the server emitting spans at all, what
        # tail-sampling policy gates the bodies, and is the ring
        # shedding (dropped spans mean traces are losing limbs under
        # load — raise max_spans or tighten the sample spec).
        def _tracing():
            from kubernetesclustercapacity_tpu_torch.resilience import RetryPolicy
            from kubernetesclustercapacity_tpu_torch.service.client import (
                CapacityClient,
            )

            with CapacityClient(
                *service_addr,
                connect_timeout_s=5.0,
                timeout_s=5.0,
                retry=RetryPolicy(max_attempts=2, base_delay_s=0.1),
                deadline_s=5.0,
            ) as c:
                tr = c.info(tracing=True).get("tracing", {})
            if not tr.get("armed", False):
                return (
                    "not configured (-trace-log off"
                    + (
                        "; request log armed"
                        if tr.get("request_log")
                        else ""
                    )
                    + ")"
                )
            parts = [
                f"ok: sample={tr.get('spec')}",
                f"buffered={tr.get('buffered_traces')}",
                f"kept={tr.get('kept_spans')}",
            ]
            dropped = tr.get("dropped_spans", 0)
            if dropped:
                parts.append(f"dropped={dropped} (ring shedding)")
            return " ".join(parts)

        check("tracing", _tracing)

    if federation_addr is not None:
        # The federation tier's degradation vector: which clusters are
        # fresh, which serve explicitly-stale views, and which are LOST.
        # A lost cluster is a hard FAILED line — every fleet total is an
        # explicit lower bound until it resyncs, and the operator
        # running -doctor must see that verdict, not derive it.
        def _federation():
            from kubernetesclustercapacity_tpu_torch.resilience import RetryPolicy
            from kubernetesclustercapacity_tpu_torch.service.client import (
                CapacityClient,
            )

            with CapacityClient(
                *federation_addr,
                connect_timeout_s=5.0,
                timeout_s=5.0,
                retry=RetryPolicy(max_attempts=2, base_delay_s=0.1),
                deadline_s=5.0,
            ) as c:
                status = c.fed_status()
            if not status.get("enabled", False):
                return "not configured (no clusters attached)"
            counts = status.get("counts", {})
            parts = [
                f"{counts.get('total')} cluster(s)",
                f"fresh={counts.get('fresh')}",
                f"stale={counts.get('stale')}",
                f"lost={counts.get('lost')}",
            ]
            gens = [
                f"{name}@{c_.get('generation')}"
                for name, c_ in sorted(
                    status.get("clusters", {}).items()
                )
            ]
            if gens:
                parts.append("generations: " + " ".join(gens))
            excluded = status.get("excluded", [])
            if excluded:
                return (
                    "FAILED: cluster(s) lost — "
                    + ", ".join(excluded)
                    + " excluded from fleet totals; "
                    + " ".join(parts)
                )
            return "ok: " + " ".join(parts)

        check("federation", _federation)
    return checks


def healthy(checks: list[tuple[str, str]]) -> bool:
    """True when no check reports a hard failure (HUNG/FAILED/DISABLED).

    "unavailable"/"degraded" results are soft (the CLI still works on
    fallback paths) and do not fail the exit code.
    """
    return not any(
        result.startswith(("HUNG", "FAILED", "DISABLED"))
        for _, result in checks
    )


def run_doctor(
    *,
    backend_timeout_s: float = 30.0,
    probe_code: str | None = None,
    service_addr: tuple[str, int] | None = None,
    federation_addr: tuple[str, int] | None = None,
    device: str = "cuda",
) -> tuple[str, int]:
    """Render the report; returns ``(text, exit_code)``.

    Exit code 1 when any check is a hard failure (HUNG/FAILED/DISABLED)
    so wrappers and CI gates can trust the command, not parse its prose.
    """
    t0 = time.time()
    checks = doctor_report(
        backend_timeout_s=backend_timeout_s,
        probe_code=probe_code,
        service_addr=service_addr,
        federation_addr=federation_addr,
        device=device,
    )
    width = max(len(name) for name, _ in checks)
    lines = [f"{name:<{width}}  {result}" for name, result in checks]
    lines.append(f"{'elapsed':<{width}}  {time.time() - t0:.1f}s")
    return "\n".join(lines), (0 if healthy(checks) else 1)
