"""The port's sampling profiler against ``kubernetesclustercapacity_tpu.
telemetry.profiler``, on the CPU.

The collapsed-text readers (``phase_counts``, ``attribution_counts``,
``dominant_phase``, ``top_frame``, ``render_collapsed``) give equal answers
in both packages on the same texts.  The sampler folds stacks joined to
the port's live ``(op, tenant, phase)`` table, and the port's server
publishes ``(op, tenant)`` at the JAX server's point in the dispatch, so a
sample lands with the same attribution.  ``KCCAP_PROFILER=0`` pins the
profiler to zero threads and zero registry calls.  End to end, the port
server's ``main`` with ``-profile-hz`` and ``-metrics-port`` serves
``/debug/profile`` and a ``profiler`` entry in ``/healthz``, and
``kccap-torch -profile`` fetches and summarises a window as the JAX CLI
does (its error lines equal the JAX CLI's).

Tolerance: none (counts, shares and lines equal).
"""

import json
import socket
import threading
import time
import urllib.request

import pytest

from kubernetesclustercapacity_tpu import cli as j_cli
from kubernetesclustercapacity_tpu.service.server import (
    CapacityServer as JaxServer,
)
from kubernetesclustercapacity_tpu.snapshot import (
    synthetic_snapshot as j_synthetic,
)
from kubernetesclustercapacity_tpu.telemetry import phases as j_phases
from kubernetesclustercapacity_tpu.telemetry import profiler as j_prof
from kubernetesclustercapacity_tpu_torch import cli as t_cli
from kubernetesclustercapacity_tpu_torch.service import server as t_server
from kubernetesclustercapacity_tpu_torch.service.client import (
    CapacityClient as TorchClient,
)
from kubernetesclustercapacity_tpu_torch.snapshot import (
    synthetic_snapshot as t_synthetic,
)
from kubernetesclustercapacity_tpu_torch.telemetry import phases
from kubernetesclustercapacity_tpu_torch.telemetry import profiler as prof_mod
from kubernetesclustercapacity_tpu_torch.telemetry.profiler import (
    SamplingProfiler,
    attribution_counts,
    dominant_phase,
    phase_counts,
    render_collapsed,
    top_frame,
)

KIND = "tests/fixtures/kind-3node.json"

# A hand-built collapsed profile: three attributed stacks (two op=sweep
# with a tenant, one without) and one unattributed loop.
COLLAPSED = (
    "op=sweep;tenant=acme;phase=device_exec;server:dispatch;"
    "fit:sweep_auto 6\n"
    "op=sweep;tenant=acme;phase=serialize;server:_respond;"
    "report:render 3\n"
    "op=sweep;phase=fetch;server:dispatch;fit:_materialize 1\n"
    "bench:_arrival_loop;threading:wait 10\n"
)
TEXTS = [
    COLLAPSED,
    "a:b;c:d 5\n",
    "# profiler header\n\na:b;c:d 4\n",
    "",
    "op=fit;phase=serialize;x:y 2\nop=fit;phase=serialize;x:z 2\n"
    "op=fit;phase=device_exec;x:y 3\nbroken line\nno_count x\n",
]


# ---------------------------------------------------------------------------
# The collapsed-text readers, both packages on the same text
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
def test_collapsed_readers_equal_jax(text):
    for key in ("op", "tenant", "phase"):
        assert (attribution_counts(text, key)
                == j_prof.attribution_counts(text, key))
    assert phase_counts(text) == j_prof.phase_counts(text)
    assert dominant_phase(text) == j_prof.dominant_phase(text)
    for phase in (None, "device_exec", "serialize", "fetch"):
        assert top_frame(text, phase) == j_prof.top_frame(text, phase)


def test_phase_counts_includes_the_unattributed_bucket():
    assert phase_counts(COLLAPSED) == {
        "device_exec": 6, "serialize": 3, "fetch": 1, "-": 10}
    assert attribution_counts(COLLAPSED, "tenant") == {"acme": 9, "-": 11}
    assert dominant_phase(COLLAPSED) == ("device_exec", 0.6)
    assert top_frame(COLLAPSED) == "threading:wait"
    assert top_frame(COLLAPSED, phase="serialize") == "report:render"


@pytest.mark.parametrize("counts", [
    {"a:b": 1, "c:d": 9, "e:f": 5}, {}, {"x:y": 2, "a:b": 2},
])
def test_render_collapsed_equals_jax(counts):
    assert render_collapsed(counts) == j_prof.render_collapsed(counts)


def test_fold_names_frames_as_jax_does():
    frame = __import__("sys")._getframe()
    for attribution in (None, ("sweep", "acme", "serialize"),
                        ("fit", None, None)):
        assert (prof_mod._fold(frame, attribution)
                == j_prof._fold(frame, attribution))


# ---------------------------------------------------------------------------
# The live table and the sampler
# ---------------------------------------------------------------------------
def test_phase_block_publishes_and_clears():
    clk = phases.PhaseClock()
    ident = threading.get_ident()
    with clk.phase("serialize"):
        assert phases.live_snapshot()[ident] == (None, None, "serialize")
    assert ident not in phases.live_snapshot()


def test_live_preserves_op_and_tenant():
    ident = threading.get_ident()
    phases.live_set(op="sweep", tenant="acme")
    try:
        with phases.PhaseClock().live("device_exec"):
            assert phases.live_snapshot()[ident] == (
                "sweep", "acme", "device_exec")
        assert phases.live_snapshot()[ident] == ("sweep", "acme", None)
    finally:
        phases.live_clear()
    assert ident not in phases.live_snapshot()


def _worker(ready, release):
    phases.live_set(op="sweep", tenant="acme")
    try:
        with phases.PhaseClock().live("device_exec"):
            ready.set()
            release.wait(10)
    finally:
        phases.live_clear()


def test_sample_once_joins_the_live_table():
    prof = SamplingProfiler(hz=50)
    ready, release = threading.Event(), threading.Event()
    t = threading.Thread(target=_worker, args=(ready, release))
    t.start()
    try:
        assert ready.wait(10)
        prof.sample_once()
    finally:
        release.set()
        t.join(10)
    samples, counts = prof.snapshot()
    assert samples == 1
    text = render_collapsed(counts)
    assert phase_counts(text).get("device_exec", 0) >= 1
    assert attribution_counts(text, "op").get("sweep", 0) >= 1
    assert attribution_counts(text, "tenant").get("acme", 0) >= 1
    st = prof.stats()
    assert (st["hz"], st["samples"], st["running"]) == (50.0, 1, False)


def test_the_server_publishes_op_and_tenant_where_the_jax_server_does():
    """A sample taken inside the routed dispatch sees the same
    ``(op, tenant, phase)`` entry on both servers."""
    seen = {}
    servers = {
        "jax": JaxServer(j_synthetic(8, seed=1), port=0, batch_window_ms=0),
        "torch": t_server.CapacityServer(t_synthetic(8, seed=1), port=0,
                                         batch_window_ms=0, device="cpu"),
    }
    try:
        for side, server in servers.items():
            routed = server._dispatch_routed

            def spy(msg, routed=routed, side=side):
                seen.setdefault(side, []).append(
                    phases.live_snapshot().get(threading.get_ident())
                    if side == "torch" else
                    j_phases.live_snapshot().get(threading.get_ident()))
                return routed(msg)

            server._dispatch_routed = spy
            for op in ({"op": "info"},
                       {"op": "sweep", "random": {"n": 4}}):
                server.dispatch(op)
            ident = threading.get_ident()
            live = (phases if side == "torch" else j_phases).live_snapshot()
            assert ident not in live  # cleared when the request ends
    finally:
        for server in servers.values():
            server.shutdown()
    assert seen["torch"] == seen["jax"] == [("info", None, None),
                                            ("sweep", None, None)]


# ---------------------------------------------------------------------------
# The KCCAP_PROFILER=0 hatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("env", ["KCCAP_PROFILER", "KCCAP_TELEMETRY"])
def test_hatches_disable(monkeypatch, env):
    monkeypatch.setenv(env, "0")
    assert not prof_mod.enabled()
    assert prof_mod.start_profiler() is None
    assert prof_mod.profiler_status() == j_prof.profiler_status()


def test_start_spawns_no_thread_and_touches_no_registry(monkeypatch):
    monkeypatch.setenv("KCCAP_PROFILER", "0")
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import REGISTRY

    def boom(*a, **kw):
        raise AssertionError("registry touched with the profiler off")

    monkeypatch.setattr(REGISTRY, "counter", boom)
    before = threading.active_count()
    prof = SamplingProfiler()
    assert prof.start() is prof and not prof.running()
    assert threading.active_count() == before
    ctype, body = prof.debug_handler("seconds=0")
    assert (ctype, body) == SamplingProfiler().debug_handler("seconds=0")
    assert body.startswith(b"# profiler disabled")


@pytest.mark.parametrize("raw,want", [
    ("53", 53.0), ("not-a-number", 29.0), ("-3", 29.0), ("", 29.0)])
def test_env_hz_parsing(monkeypatch, raw, want):
    monkeypatch.setenv("KCCAP_PROFILE_HZ", raw)
    assert SamplingProfiler().hz == want == j_prof.SamplingProfiler().hz


def test_singleton_lifecycle_and_the_doctor_line():
    prof_mod.stop_profiler()
    assert prof_mod.get_profiler() is None
    assert prof_mod.profiler_status().startswith("armed (hz=")
    prof = prof_mod.start_profiler(200)
    try:
        assert prof is prof_mod.start_profiler() and prof.running()
        time.sleep(0.1)
        assert prof_mod.profiler_status().startswith("ok: sampling at 200 Hz")
        text = prof.collect(0.05)
        assert all(line.rsplit(" ", 1)[1].isdigit()
                   for line in text.splitlines())
    finally:
        prof_mod.stop_profiler()
    assert prof_mod.get_profiler() is None and not prof.running()


# ---------------------------------------------------------------------------
# End to end: the server's -profile-hz and the CLI's -profile
# ---------------------------------------------------------------------------
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_for(predicate, timeout_s=30.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def test_server_profile_hz_and_the_cli_profile(tmp_path, capsys):
    port, mport = _free_port(), _free_port()
    rc = []
    main = threading.Thread(target=lambda: rc.append(t_server.main([
        "-snapshot", KIND, "-port", str(port), "-metrics-port", str(mport),
        "-profile-hz", "97", "-batch-window-ms", "0", "-device", "cpu",
    ])), daemon=True)
    main.start()
    stop = threading.Event()
    try:
        def up():
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{mport}/healthz", timeout=2) as r:
                    return r.status == 200
            except OSError:
                return False

        _wait_for(up, what="the server's metrics port")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{mport}/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["profiler"]["hz"] == 97.0
        assert health["profiler"]["running"] is True

        def load():
            with TorchClient("127.0.0.1", port) as c:
                while not stop.is_set():
                    c.sweep(random={"n": 64, "seed": 1})

        loader = threading.Thread(target=load, daemon=True)
        loader.start()
        out_file = tmp_path / "p.collapsed"
        assert t_cli.main(["-profile", f"127.0.0.1:{mport}",
                           "-profile-seconds", "0.6",
                           "-profile-out", str(out_file)]) == 0
        out, err = capsys.readouterr()
        assert out == ""
        text = out_file.read_text()
        samples = sum(phase_counts(text).values())
        assert (f"collapsed profile ({samples} sample(s)) written to "
                f"{out_file}\n") in err
        assert "op=sweep" in text
        assert "# dominant phase: " in err
        assert t_cli.main(["-profile", f"127.0.0.1:{mport}",
                           "-profile-seconds", "0.3", "-output", "json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert set(doc) == {"seconds", "samples", "phase_samples",
                            "dominant_phase", "dominant_share", "top_frame",
                            "top_frame_dominant_phase"}
        assert doc["seconds"] == 0.3 and doc["samples"] > 0
        # The JAX CLI reads the port server's endpoint the same way.
        assert j_cli.main(["-profile", f"127.0.0.1:{mport}",
                           "-profile-seconds", "0.2", "-output",
                           "json"]) == 0
        assert set(json.loads(capsys.readouterr().out)) == set(doc)
    finally:
        stop.set()
        with TorchClient("127.0.0.1", port) as c:
            c.drain_server(timeout_s=5.0)
        main.join(30)
    assert rc == [0]
    assert prof_mod.get_profiler() is None  # stopped at shutdown


@pytest.mark.parametrize("target", ["nowhere", "dead"])
def test_cli_profile_errors_match_jax(target, capsys):
    if target == "dead":
        target = f"127.0.0.1:{_free_port()}"
    outs = []
    for main in (j_cli.main, t_cli.main):
        rc = main(["-profile", target, "-profile-seconds", "0"])
        outs.append((rc, *capsys.readouterr()))
    assert outs[0] == outs[1] and outs[0][0] == 1


def test_cli_profile_of_a_disabled_profiler_matches_jax(capsys, monkeypatch):
    from kubernetesclustercapacity_tpu_torch.telemetry.exposition import (
        start_metrics_server,
    )
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
        MetricsRegistry,
    )

    monkeypatch.setenv("KCCAP_PROFILER", "0")
    ms = start_metrics_server(
        MetricsRegistry(), port=0,
        debug={"/debug/profile": SamplingProfiler().debug_handler})
    try:
        outs = []
        for main in (j_cli.main, t_cli.main):
            rc = main(["-profile", f"127.0.0.1:{ms.address[1]}",
                       "-profile-seconds", "0"])
            outs.append((rc, *capsys.readouterr()))
    finally:
        ms.shutdown()
    assert outs[0] == outs[1] and outs[0][0] == 1
    assert outs[0][2].startswith("# profiler disabled")


# ---------------------------------------------------------------------------
# -jax-profile: the torch.profiler twin of the JAX CLI's capture
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("argv", [
    ["-snapshot", KIND, "-grid", "16", "-output", "json"],
    ["-snapshot", KIND, "-cpuRequests=200m", "-memRequests=250mb"],
])
def test_jax_profile_writes_a_chrome_trace_and_only_observes(
    tmp_path, capsys, argv
):
    j_dir, t_dir = tmp_path / "jax", tmp_path / "torch"
    j_rc = j_cli.main(argv + ["-jax-profile", str(j_dir)])
    j_out = capsys.readouterr().out
    t_rc = t_cli.main(argv + ["-jax-profile", str(t_dir), "-device", "cpu"])
    t_out = capsys.readouterr().out
    # Kernel labels differ by design: plain_ (CPU) stands for pallas_.
    assert (t_rc, t_out) == (j_rc, j_out.replace('"pallas_', '"plain_'))
    assert t_rc == 0
    (trace,) = t_dir.iterdir()
    assert trace.name.endswith(".pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
