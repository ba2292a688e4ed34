"""The port's ``-doctor`` against ``kubernetesclustercapacity_tpu.utils.
doctor``, on the CPU.

The probe child is swapped (``_PROBE_CODE``) as the JAX tests swap it, so
each outcome — healthy, wedged (killed as a process group), crashed — is
driven without a card, and the two packages' probes read the same child
alike.  The port's report has the JAX report's check names in the JAX
order, with and without ``-doctor-service`` and ``-doctor-federation``;
one broken check becomes a FAILED line and the rest still run; the exit
code is 1 exactly when a line is a hard failure.  Against a port server
and a JAX server on the same fixture, and a port and a JAX federation on
the same fleet, the service and federation lines are equal (volatile
latencies and counters aside).  With no card and no ``-device cpu`` the
real probe is a FAILED line and ``-doctor`` exits 1.

Tolerance: none (line text equal where not named volatile).
"""

import contextlib
import dataclasses
import threading
import time

import pytest

from kubernetesclustercapacity_tpu import cli as j_cli
from kubernetesclustercapacity_tpu import federation as j_fed
from kubernetesclustercapacity_tpu.telemetry import profiler as j_prof
from kubernetesclustercapacity_tpu.service.server import (
    CapacityServer as JaxServer,
)
from kubernetesclustercapacity_tpu.snapshot import (
    synthetic_snapshot as j_synthetic,
)
from kubernetesclustercapacity_tpu.utils import doctor as j_doc
from kubernetesclustercapacity_tpu.utils import threads as j_threads
from kubernetesclustercapacity_tpu_torch import cli as t_cli
from kubernetesclustercapacity_tpu_torch import federation as t_fed
from kubernetesclustercapacity_tpu_torch.service.server import (
    CapacityServer as TorchServer,
)
from kubernetesclustercapacity_tpu_torch.snapshot import (
    synthetic_snapshot as t_synthetic,
)
from kubernetesclustercapacity_tpu_torch.telemetry import profiler as t_prof
from kubernetesclustercapacity_tpu_torch.utils import doctor as t_doc
from kubernetesclustercapacity_tpu_torch.utils import threads as t_threads

OK_PROBE = "print('DEVICES 0s D x1')"
SERVICE_LINES = (
    "capacity service", "tenancy", "capacity timeline", "capacity at risk",
    "gang capacity", "capacity forecast", "audit & shadow", "latency & SLO",
    "flight recorder", "tracing",
)
# Lines whose text carries per-process counters or timings.
VOLATILE = ("package", "platform env", "backend probe", "x64 ints",
            "native kernel (C++)", "native pod-walk (C ext)",
            "fused fast path", "telemetry", "device snapshot cache",
            "sanitizer", "device memory", "optimizer", "capacity service",
            "latency & SLO", "flight recorder")


def _names(checks):
    return [name for name, _ in checks]


@pytest.fixture
def profilers_stopped():
    """Both packages' process-wide sampling profilers stopped for the
    test, and put back as they were after it.

    The profiler line reads process state: a server ``main`` run earlier
    in the same process (by another test file) may have left a package's
    sampler running, and then that line says ``ok: sampling ...`` in one
    package and ``armed ...`` in the other.
    """
    running = []
    for mod in (j_prof, t_prof):
        prof = mod.get_profiler()
        if prof is not None and prof.running():
            running.append((mod, prof.hz))
        mod.stop_profiler()
    yield
    for mod in (j_prof, t_prof):
        mod.stop_profiler()
    for mod, hz in running:
        mod.start_profiler(hz)


@contextlib.contextmanager
def _thread_deaths_cleared():
    """Both packages' supervised-thread death records emptied, and the
    old lists put back after.

    The sanitizer line appends ``; WARNING n supervised thread death(s),
    last: ...`` when its own package's ``utils/threads`` has recorded a
    death in this process, and the record is process-global: a test run
    earlier in the same process (``tests/test_torch_runtime.py::
    test_supervised_thread_records_its_death`` records a port death on
    purpose) would put the note in one package's line only.  Each
    module's list is swapped under that module's own lock.
    """
    saved = []
    for mod in (j_threads, t_threads):
        with mod._lock:
            saved.append((mod, mod._deaths))
            mod._deaths = []
    try:
        yield
    finally:
        for mod, deaths in saved:
            with mod._lock:
                mod._deaths = deaths


@pytest.fixture
def thread_deaths_cleared():
    with _thread_deaths_cleared():
        yield


# ---------------------------------------------------------------------------
# The probe child
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("code,prefix", [
    (OK_PROBE, "ok: 0s D x1"),
    ("raise RuntimeError('no backend for you')", "FAILED: "),
    ("print('half', flush=True); import sys; sys.exit(3)", "FAILED: half"),
])
def test_probe_reads_the_child_as_the_jax_probe_does(code, prefix):
    j = j_doc._probe_backend(20.0, code)
    t = t_doc._probe_backend(20.0, code, "cpu")
    assert t == j and t.startswith(prefix)


def test_wedged_probe_is_killed_not_waited_on():
    t0 = time.monotonic()
    res = t_doc._probe_backend(
        8.0, "print('almost there', flush=True); import time; time.sleep(60)",
        "cuda",
    )
    assert time.monotonic() - t0 < 30.0  # killed, not slept out
    assert res.startswith("HUNG: backend init did not return within 8s")
    assert "almost there" in res  # partial output salvaged


def test_the_real_probe_names_the_host_on_cpu():
    res = t_doc._probe_backend(120.0, device="cpu")
    assert res.startswith("ok: ") and res.endswith("s cpu x1")


def test_the_real_probe_fails_without_a_card(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    res = t_doc._probe_backend(120.0, device="cuda")
    assert res == ("FAILED: CUDA is not available (pass -device cpu to run "
                   "on the host)")


def test_the_probe_child_imports_only_torch():
    import ast

    tree = ast.parse(t_doc._PROBE_CODE)
    imported = {alias.name for node in ast.walk(tree)
                if isinstance(node, ast.Import) for alias in node.names}
    assert imported == {"sys", "time", "torch"}


# ---------------------------------------------------------------------------
# The report
# ---------------------------------------------------------------------------
# Process-global inputs of the lines the next test compares exactly.
# Both packages read the same environment variables, so an unset one
# cannot make the lines differ; it is cleared so the expected text is
# the default's.  The native loaders' caches (``native._LIB`` and
# ``_BUILD_ERROR``, ``native.ingest._MOD`` and ``_BUILD_ERROR``) are
# only ever set by a successful build or patched with monkeypatch; the
# sanitizer is installed only inside a try/finally that uninstalls it.
DOCTOR_ENV = ("KCCAP_SANITIZE", "KCC_DISABLE_NATIVE_INGEST",
              "KCCAP_PROFILER", "KCCAP_TELEMETRY", "KCCAP_PROFILE_HZ")


def _assert_check_names_in_the_jax_order(monkeypatch):
    for var in DOCTOR_ENV:
        monkeypatch.delenv(var, raising=False)
    j = j_doc.doctor_report(backend_timeout_s=20.0, probe_code=OK_PROBE)
    t = t_doc.doctor_report(backend_timeout_s=20.0, probe_code=OK_PROBE,
                            device="cpu")
    assert _names(t) == _names(j)
    assert len(t) == 13 and t_doc.healthy(t)
    got = dict(t)
    assert got["backend probe"] == "ok: 0s D x1"
    assert got["x64 ints"] == "ok: int64 is native in torch"
    assert got["optimizer"].startswith("ok: certified in ")
    for native in ("native kernel (C++)", "native pod-walk (C ext)"):
        assert got[native] == dict(j)[native]
    assert got["sanitizer"] == dict(j)["sanitizer"]
    assert got["sanitizer"].startswith("dormant (KCCAP_SANITIZE unset)")
    assert got["fused fast path"].startswith("armed (never trips")
    assert got["profiler"] == dict(j)["profiler"]


def test_check_names_in_the_jax_order(profilers_stopped,
                                      thread_deaths_cleared, monkeypatch):
    _assert_check_names_in_the_jax_order(monkeypatch)


def _record_a_death(threads_mod, message):
    def die():
        raise RuntimeError(message)

    t = threading.Thread(
        target=threads_mod.supervised(die, name="pin"), name="pin"
    )
    t.start()
    t.join()


def test_thread_deaths_recorded_earlier_leave_the_comparison_exact(
        profilers_stopped, monkeypatch):
    """One supervised death in each package, recorded before the doctor
    runs (as by tests run earlier in the same process): the sanitizer
    lines would differ (``jax bang`` against ``port bang``), and with the
    records cleared they are equal, and the records come back after."""
    with _thread_deaths_cleared():
        _record_a_death(j_threads, "jax bang")
        _record_a_death(t_threads, "port bang")
        assert j_threads.last_death() == ("pin", "RuntimeError: jax bang")
        assert t_threads.last_death() == ("pin", "RuntimeError: port bang")
        before = (j_threads.death_count(), t_threads.death_count())
        with _thread_deaths_cleared():
            _assert_check_names_in_the_jax_order(monkeypatch)
        assert (j_threads.death_count(), t_threads.death_count()) == before
        assert t_threads.last_death() == ("pin", "RuntimeError: port bang")


def test_one_broken_check_does_not_abort_the_report(monkeypatch):
    def boom(*a, **kw):
        raise ImportError("no backend for this platform")

    monkeypatch.setattr(t_doc, "_probe_backend", boom)
    checks = t_doc.doctor_report(backend_timeout_s=1.0, device="cpu")
    res = dict(checks)["backend probe"]
    assert res == "FAILED: ImportError: no backend for this platform"
    assert "optimizer" in dict(checks)  # later checks still ran
    assert not t_doc.healthy(checks)


@pytest.mark.parametrize("code,want", [
    (OK_PROBE, 0),
    ("raise RuntimeError('down')", 1),
])
def test_rendered_report_and_exit_codes(code, want):
    out, rc = t_doc.run_doctor(backend_timeout_s=20.0, probe_code=code,
                               device="cpu")
    assert rc == want
    lines = out.splitlines()
    assert len(lines) == 14 and lines[-1].startswith("elapsed")
    assert lines[-1].endswith("s")
    assert ("FAILED" in out) == bool(want)


def test_healthy_reads_results_as_the_jax_doctor_does():
    for results in (["ok"], ["unavailable (x)", "degraded: y"],
                    ["HUNG: x"], ["FAILED: y"], ["DISABLED — z"]):
        checks = [(f"c{i}", r) for i, r in enumerate(results)]
        assert t_doc.healthy(checks) == j_doc.healthy(checks)


# ---------------------------------------------------------------------------
# The CLI flag
# ---------------------------------------------------------------------------
def test_doctor_flag_runs_and_exits_zero(capsys, monkeypatch):
    monkeypatch.setattr(t_doc, "_PROBE_CODE", OK_PROBE)
    assert t_cli.main(["-doctor", "-device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "backend probe" in out and "ok: 0s D x1" in out


def test_doctor_flag_exit_1_when_wedged(capsys, monkeypatch):
    monkeypatch.setattr(t_doc, "_PROBE_CODE", "import time; time.sleep(60)")
    assert t_cli.main(["-doctor", "-doctor-timeout=1", "-device", "cpu"]) == 1
    assert "HUNG" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["-doctor-service", "-doctor-federation"])
def test_bad_addresses_match_the_jax_cli(flag, capsys, monkeypatch):
    monkeypatch.setattr(t_doc, "_PROBE_CODE", OK_PROBE)
    monkeypatch.setattr(j_doc, "_PROBE_CODE", OK_PROBE)
    outs = []
    for main, extra in ((j_cli.main, []), (t_cli.main, ["-device", "cpu"])):
        rc = main(["-doctor", flag, "nowhere:x", *extra])
        outs.append((rc, *capsys.readouterr()))
    assert outs[0] == outs[1] and outs[0][0] == 1


# ---------------------------------------------------------------------------
# -doctor-service and -doctor-federation against running servers
# ---------------------------------------------------------------------------
def test_service_lines_against_a_port_server_match_jax(profilers_stopped):
    kind = "tests/fixtures/kind-3node.json"
    from kubernetesclustercapacity_tpu.sources import resolve_source as jrs
    from kubernetesclustercapacity_tpu_torch.sources import (
        resolve_source as trs,
    )

    j_server = JaxServer(jrs(kind, None)[1], port=0, batch_window_ms=0.0)
    t_server = TorchServer(trs(kind, None)[1], port=0, batch_window_ms=0.0,
                           device="cpu")
    j_server.start()
    t_server.start()
    try:
        j = j_doc.doctor_report(backend_timeout_s=20.0, probe_code=OK_PROBE,
                                service_addr=j_server.address)
        t = t_doc.doctor_report(backend_timeout_s=20.0, probe_code=OK_PROBE,
                                service_addr=t_server.address, device="cpu")
    finally:
        j_server.shutdown()
        t_server.shutdown()
    assert _names(t) == _names(j)
    assert _names(t)[13:] == list(SERVICE_LINES)
    for (name, jres), (_, tres) in zip(j, t):
        if name not in VOLATILE:
            assert tres == jres, name
    got = dict(t)
    assert got["capacity service"].startswith(
        "ok: 3 nodes (reference) deadline_shed=0 fast_path=closed")
    assert got["latency & SLO"].startswith("ok: latency p50=")
    assert got["flight recorder"].startswith("ok: ")
    assert t_doc.healthy(t)


def _fleet(fed_mod, synthetic, now, **kw):
    fed = fed_mod.FederationServer(stale_after_s=5.0, evict_after_s=20.0,
                                   clock=lambda: now[0], **kw)
    snaps = {name: synthetic(40 + 8 * i, seed=30 + i)
             for i, name in enumerate(("east", "west", "north"))}
    for i, (name, snap) in enumerate(snaps.items()):
        fed.inject(name, snap, generation=i + 1)
    return fed.start(), snaps


def test_federation_line_against_a_port_federation_matches_jax():
    now = [0.0]
    j_fleet, j_snaps = _fleet(j_fed, j_synthetic, now)
    t_fleet, t_snaps = _fleet(t_fed, t_synthetic, now, device="cpu")
    try:
        lines = []
        for step in ("fresh", "lost"):
            if step == "lost":
                now[0] = 30.0
                for fed, snaps in ((j_fleet, j_snaps), (t_fleet, t_snaps)):
                    for i, (name, snap) in enumerate(snaps.items()):
                        if name != "east":
                            fed.inject(name, snap, generation=10 + i)
            j_out, j_rc = j_doc.run_doctor(
                backend_timeout_s=20.0, probe_code=OK_PROBE,
                federation_addr=j_fleet.address)
            t_out, t_rc = t_doc.run_doctor(
                backend_timeout_s=20.0, probe_code=OK_PROBE,
                federation_addr=t_fleet.address, device="cpu")
            j_line, t_line = (
                next(ln for ln in out.splitlines()
                     if ln.startswith("federation"))
                for out in (j_out, t_out))
            assert t_line == j_line and t_rc == j_rc
            lines.append((t_line, t_rc))
    finally:
        j_fleet.close()
        t_fleet.close()
    assert "ok: 3 cluster(s)" in lines[0][0] and "fresh=3" in lines[0][0]
    assert lines[0][1] == 0
    assert "FAILED: cluster(s) lost — east" in lines[1][0]
    assert lines[1][1] == 1


def test_doctor_flags_against_live_endpoints(capsys, monkeypatch):
    monkeypatch.setattr(t_doc, "_PROBE_CODE", OK_PROBE)
    now = [0.0]
    t_fleet, _ = _fleet(t_fed, t_synthetic, now, device="cpu")
    server = TorchServer(dataclasses.replace(t_synthetic(16, seed=3)),
                         port=0, batch_window_ms=0.0, device="cpu")
    server.start()
    try:
        rc = t_cli.main([
            "-doctor", "-doctor-timeout", "20",
            "-doctor-service", f"127.0.0.1:{server.address[1]}",
            "-doctor-federation", f"127.0.0.1:{t_fleet.address[1]}",
            "-device", "cpu",
        ])
        out = capsys.readouterr().out
        names = [ln[:23].rstrip() for ln in out.splitlines()]
        assert names[13:24] == [*SERVICE_LINES, "federation"]
        assert rc == 0
        now[0] = 30.0  # every cluster aged past the eviction horizon
        rc = t_cli.main([
            "-doctor", "-doctor-federation",
            f"127.0.0.1:{t_fleet.address[1]}", "-device", "cpu",
        ])
        assert rc == 1
        assert "FAILED: cluster(s) lost" in capsys.readouterr().out
    finally:
        server.shutdown()
        t_fleet.close()
