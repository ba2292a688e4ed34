"""The port's SLO burn-rate engine against the JAX package's, on the CPU.

The grammar (every entry the JAX tests accept or reject), the window
math (:func:`burn_rate` on seeded random series, and
:func:`estimate_quantile`), the registry counter source, the monitor's
ok → breached → recovered machine with its gauges and JSONL log, and the
service surfaces: the ``slo`` op on both servers after the same requests,
``/healthz`` flipping with a fast burn, and ``-slo-status`` from either
CLI.  Every monitor reads a driven clock (``time_fn``), so nothing waits
on a real window and, unlike the JAX end-to-end case, nothing waits on a
first ``doctor_report``.

Tolerance: the same arithmetic on the same inputs, so burn rates,
quantile estimates and states are equal, floats included.
"""

import copy
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from kubernetesclustercapacity_tpu import cli as j_cli
from kubernetesclustercapacity_tpu import report as j_report
from kubernetesclustercapacity_tpu.service.client import (
    CapacityClient as JaxClient,
)
from kubernetesclustercapacity_tpu.service.server import (
    CapacityServer as JaxServer,
)
from kubernetesclustercapacity_tpu.snapshot import (
    synthetic_snapshot as j_synthetic,
)
from kubernetesclustercapacity_tpu.telemetry import slo as j_slo
from kubernetesclustercapacity_tpu.telemetry.metrics import (
    MetricsRegistry as JaxRegistry,
)
from kubernetesclustercapacity_tpu_torch import cli as t_cli
from kubernetesclustercapacity_tpu_torch import report as t_report
from kubernetesclustercapacity_tpu_torch.service.client import (
    CapacityClient as TorchClient,
)
from kubernetesclustercapacity_tpu_torch.service.server import (
    CapacityServer as TorchServer,
)
from kubernetesclustercapacity_tpu_torch.service.server import healthz_probes
from kubernetesclustercapacity_tpu_torch.snapshot import synthetic_snapshot
from kubernetesclustercapacity_tpu_torch.telemetry import slo as t_slo
from kubernetesclustercapacity_tpu_torch.telemetry.exposition import (
    start_metrics_server,
)
from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
    MetricsRegistry as TorchRegistry,
)

TIMEOUT_S = 120.0

BAD_ENTRIES = {
    "no-name": {"availability": 0.9},
    "neither": {"name": "x"},
    "both": {"name": "x", "latency": "p99 < 80ms", "availability": 0.9},
    "no-p": {"name": "x", "latency": "99 < 80ms"},
    "negative": {"name": "x", "latency": "p99 < -80ms"},
    "p0": {"name": "x", "latency": "p0 < 80ms"},
    "p100": {"name": "x", "latency": "p100 < 80ms"},
    "zero-bound": {"name": "x", "latency": "p99 < 0ms"},
    "latency-number": {"name": "x", "latency": 80},
    "above-one": {"name": "x", "availability": 1.5},
    "bad-percent": {"name": "x", "availability": "nope%"},
    "bad-string": {"name": "x", "availability": "high"},
    "bool": {"name": "x", "availability": True},
    "unknown": {"name": "x", "availability": 0.9, "bogus": 1},
    "short-negative": {"name": "x", "availability": 0.9,
                       "short_window_s": -1},
    "windows-swapped": {"name": "x", "availability": 0.9,
                        "short_window_s": 600, "long_window_s": 60},
    "burn-bool": {"name": "x", "availability": 0.9, "fast_burn": True},
    "empty-op": {"name": "x", "availability": 0.9, "op": ""},
    "empty-tenant": {"name": "x", "latency": "p99 < 80ms", "tenant": ""},
    "tenant-and-op": {"name": "x", "latency": "p99 < 80ms",
                      "tenant": "a", "op": "sweep"},
    "tenant-availability": {"name": "x", "availability": 0.9,
                            "tenant": "a"},
    "not-a-mapping": "slo",
}

GOOD_DOCS = {
    "latency-op": {"slos": [{"name": "lat", "op": "sweep",
                             "latency": "p99 < 80ms"}]},
    "latency-seconds": [{"name": "l", "latency": "p99.9 < 2s"}],
    "availability-percent": [{"name": "a", "availability": "99.9%"}],
    "availability-fraction": [{"name": "a", "availability": 0.95,
                               "short_window_s": 5, "long_window_s": 50,
                               "fast_burn": 3}],
    "tenant": [{"name": "t", "latency": "p95 < 250ms", "tenant": "acme"}],
    "two": {"slos": [{"name": "lat", "op": "sweep",
                      "latency": "p99 < 100ms"},
                     {"name": "availability", "availability": "99.9%"}]},
}


def _outcome(module, doc):
    try:
        return "ok", [s.to_wire() for s in module.parse_slos(doc)]
    except module.SLOError as e:
        return "SLOError", str(e)


@pytest.mark.parametrize("name", sorted(BAD_ENTRIES))
def test_bad_entries_rejected_like_jax(name):
    doc = [copy.deepcopy(BAD_ENTRIES[name])]
    want = _outcome(j_slo, copy.deepcopy(doc))
    assert want[0] == "SLOError"
    assert _outcome(t_slo, doc) == want


@pytest.mark.parametrize("doc", [
    {"slos": []}, [],
    {"slos": [{"name": "x", "availability": 0.9}], "extra": 1},
    [{"name": "x", "availability": 0.9}, {"name": "x",
                                         "latency": "p99 < 80ms"}],
], ids=["empty", "empty-list", "top-level", "duplicate"])
def test_bad_documents_rejected_like_jax(doc):
    want = _outcome(j_slo, copy.deepcopy(doc))
    assert want[0] == "SLOError"
    assert _outcome(t_slo, copy.deepcopy(doc)) == want


@pytest.mark.parametrize("name", sorted(GOOD_DOCS))
def test_good_documents_parse_like_jax(name):
    want = _outcome(j_slo, copy.deepcopy(GOOD_DOCS[name]))
    assert want[0] == "ok"
    assert _outcome(t_slo, copy.deepcopy(GOOD_DOCS[name])) == want


@pytest.mark.parametrize("text", [
    json.dumps(GOOD_DOCS["two"]),
    "slos:\n  - name: a\n    availability: '99%'\n",
    "slos: [unclosed",
], ids=["json", "yaml", "bad-yaml"])
def test_load_slos_like_jax(text, tmp_path):
    path = tmp_path / "slo.yaml"
    path.write_text(text)
    outs = []
    for module in (j_slo, t_slo):
        try:
            outs.append([s.to_wire() for s in module.load_slos(str(path))])
        except module.SLOError as e:
            outs.append(str(e))
    assert outs[1] == outs[0]


@pytest.mark.parametrize("seed", range(6))
def test_burn_rate_matches_jax_on_random_series(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    ts = np.cumsum(rng.uniform(0.1, 30.0, n))
    tot = np.cumsum(rng.integers(0, 50, n))
    bad = np.minimum(np.cumsum(rng.integers(0, 10, n)), tot)
    samples = list(zip(ts.tolist(), tot.tolist(), bad.tolist()))
    for _ in range(25):
        now = float(rng.uniform(0, ts[-1] * 1.2))
        window = float(rng.uniform(1, 300))
        budget = float(rng.uniform(0.001, 0.5))
        got = t_slo.burn_rate(samples, now=now, window_s=window,
                              budget=budget)
        want = j_slo.burn_rate(samples, now=now, window_s=window,
                               budget=budget)
        assert got == want


def test_burn_rate_edges_like_jax():
    for fn in (t_slo.burn_rate, j_slo.burn_rate):
        assert fn([(0, 10, 0), (10, 10, 0)], now=10, window_s=5,
                  budget=0.1) == 0.0
        assert fn([(0, 10, 0)], now=10, window_s=5, budget=0.1) is None
        assert fn([(0, 0, 0), (20, 10, 5)], now=10, window_s=5,
                  budget=0.1) is None
    for module in (t_slo, j_slo):
        with pytest.raises(module.SLOError):
            module.burn_rate([], now=0, window_s=1, budget=0)


@pytest.mark.parametrize("seed", range(4))
def test_estimate_quantile_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    reg_j, reg_t = JaxRegistry(), TorchRegistry()
    hists = [r.histogram("h", "", ()) for r in (reg_j, reg_t)]
    for v in rng.exponential(0.05, int(rng.integers(1, 300))):
        for h in hists:
            h.observe(float(v))
    snap = hists[1].labels().snapshot()
    assert snap == hists[0].labels().snapshot()
    for q in (0.5, 0.9, 0.99, 0.999):
        assert (t_slo.estimate_quantile(snap["buckets"], snap["count"], q)
                == j_slo.estimate_quantile(snap["buckets"], snap["count"],
                                           q))
    assert t_slo.estimate_quantile({}, 0, 0.5) is None


def test_registry_source_matches_jax():
    reads = []
    for module, reg in ((j_slo, JaxRegistry()), (t_slo, TorchRegistry())):
        read = module.registry_source(reg)
        lat = reg.histogram("kccap_request_latency_seconds",
                            "End-to-end dispatch latency, by op.", ("op",))
        for v in (0.01, 0.05, 0.2, 0.3, 0.05):
            lat.observe(v, op="sweep")
        lat.observe(5.0, op="fit")
        req = reg.counter("kccap_requests_total", "Requests dispatched, by "
                          "op.", ("op",))
        err = reg.counter("kccap_request_errors_total",
                          "Requests that raised, by op and exception type.",
                          ("op", "error"))
        shed = reg.counter("kccap_deadline_shed_total", "Requests shed "
                           "because their deadline had already expired.")
        req.inc(10, op="sweep")
        req.inc(5, op="fit")
        err.inc(2, op="sweep", error="ValueError")
        err.inc(1, op="fit", error="RuntimeError")
        shed.inc(3)
        specs = module.parse_slos([
            {"name": "l", "op": "sweep", "latency": "p90 < 100ms"},
            {"name": "l2", "latency": "p90 < 100ms"},
            {"name": "l3", "latency": "p90 < 100s"},
            {"name": "a", "availability": 0.9},
            {"name": "s", "op": "sweep", "availability": 0.9},
        ])
        reads.append([read(s) for s in specs])
    assert reads[1] == reads[0]
    assert reads[1] == [(5, 2), (6, 3), (6, 0), (15, 6), (10, 5)]


def _series(values):
    it = iter(values)
    last = {"v": (0, 0)}

    def read(_spec):
        try:
            last["v"] = next(it)
        except StopIteration:
            pass
        return last["v"]

    return read


MONITOR_CASES = {
    "breach-recover": ([(100, 0), (200, 0), (300, 80), (400, 160),
                        (500, 160), (600, 160), (700, 160)],
                       dict(short_window_s=10, long_window_s=100,
                            fast_burn=2)),
    "one-window": ([(10_000, 0), (10_200, 0), (10_400, 0), (10_500, 90)],
                   dict(short_window_s=10, long_window_s=1000,
                        fast_burn=2)),
    "immediate": ([(100, 0), (200, 100)],
                  dict(short_window_s=10, long_window_s=100, fast_burn=2)),
    "idle": ([(5, 0)] * 6, dict(short_window_s=10, long_window_s=100,
                                fast_burn=2)),
}


@pytest.mark.parametrize("case", sorted(MONITOR_CASES))
def test_monitor_matches_jax_under_a_driven_clock(case, tmp_path):
    series, windows = MONITOR_CASES[case]
    runs = []
    for name, module, reg in (("jax", j_slo, JaxRegistry()),
                              ("torch", t_slo, TorchRegistry())):
        spec = module.parse_slos([{"name": "avail", "availability": 0.9,
                                   **windows}])[0]
        clock = {"t": 0.0}
        log = tmp_path / f"{name}.jsonl"
        mon = module.SLOMonitor([spec], source=_series(series),
                                registry=reg, log=str(log),
                                time_fn=lambda c=clock: c["t"])
        outs = []
        for _ in series:
            outs.append(mon.evaluate())
            clock["t"] += 5.0
        run = {"outs": outs, "status": mon.status(), "wire": mon.wire(),
               "stats": mon.stats(), "fast": mon.fast_burning,
               "gauges": reg.snapshot()}
        mon.close()
        run["log"] = ([json.loads(x) for x in log.read_text().splitlines()]
                      if log.exists() else [])
        runs.append(run)
    assert runs[1] == runs[0]
    states = [o["avail"]["state"] for o in runs[1]["outs"]]
    if case == "breach-recover":
        assert "breached" in states and states[-1] == "recovered"
        assert [x["transition"] for x in runs[1]["log"]] == [
            "breached", "recovered"]
    if case == "one-window":
        assert states[-1] == "ok"


def test_disabled_telemetry_makes_zero_registry_calls(monkeypatch):
    monkeypatch.setenv("KCCAP_TELEMETRY", "0")
    reg = TorchRegistry()
    spec = t_slo.parse_slos([{"name": "a", "availability": 0.9,
                              "short_window_s": 1, "long_window_s": 10,
                              "fast_burn": 1}])[0]
    mon = t_slo.SLOMonitor([spec], source=_series([(10, 0), (20, 10)]),
                           registry=reg)
    mon.evaluate()
    mon.evaluate()
    assert reg.snapshot() == {}
    mon.close()


def test_monitor_needs_specs_and_a_source():
    with pytest.raises(t_slo.SLOError):
        t_slo.SLOMonitor([], registry=TorchRegistry())
    with pytest.raises(t_slo.SLOError):
        t_slo.SLOMonitor(t_slo.parse_slos([{"name": "a",
                                            "availability": 0.9}]))
    with pytest.raises(t_slo.SLOError):
        t_slo.SLOMonitor(t_slo.parse_slos([{"name": "a",
                                            "availability": 0.9}]),
                         registry=TorchRegistry()).start(0)


# -- the service surfaces -----------------------------------------------------

SLO_DOC = [
    {"name": "sweep-latency", "op": "sweep", "latency": "p99 < 100s",
     "short_window_s": 10, "long_window_s": 100},
    {"name": "availability", "availability": 0.9, "short_window_s": 10,
     "long_window_s": 100, "fast_burn": 1.5},
]
BAD_FIT = {"cpuRequests": "200m", "memRequests": "lots"}


@pytest.fixture()
def slo_pair():
    """The JAX server and the port's, each with an SLO monitor on its own
    registry and a driven clock that advances 5 s per evaluation."""
    out = {}
    for name, module, server_cls, reg, snap, kw in (
        ("jax", j_slo, JaxServer, JaxRegistry(), j_synthetic(24, seed=31),
         {}),
        ("torch", t_slo, TorchServer, TorchRegistry(),
         synthetic_snapshot(24, seed=31), {"device": "cpu"}),
    ):
        clock = {"t": 0.0}

        def tick(c=clock):
            c["t"] += 5.0
            return c["t"]

        mon = module.SLOMonitor(module.parse_slos(copy.deepcopy(SLO_DOC)),
                                registry=reg, time_fn=tick)
        server = server_cls(snap, registry=reg, slo=mon, batch_window_ms=0,
                            **kw)
        server.start()
        out[name] = (server, mon, reg)
    try:
        yield out
    finally:
        for server, mon, _ in out.values():
            server.shutdown()
            mon.close()


def _traffic(pair, n_ok, n_bad):
    for name, client_cls in (("jax", JaxClient), ("torch", TorchClient)):
        server = pair[name][0]
        with client_cls(*server.address, timeout_s=TIMEOUT_S,
                        retry=None) as c:
            for _ in range(n_ok):
                c.sweep(random={"n": 4, "seed": 2})
            for _ in range(n_bad):
                with pytest.raises(RuntimeError):
                    c.fit(**BAD_FIT)


def _slo_replies(pair):
    out = []
    for name, client_cls in (("jax", JaxClient), ("torch", TorchClient)):
        with client_cls(*pair[name][0].address, timeout_s=TIMEOUT_S,
                        retry=None) as c:
            out.append(c.slo_status())
    return out


def test_slo_op_matches_jax_through_breach_and_recovery(slo_pair):
    """The same requests on both servers: clean traffic (ok), a burst of
    failing fits (the availability objective fast-burns), clean traffic
    again (recovered).  Every ``slo`` reply is equal."""
    seen = []
    for n_ok, n_bad in ((6, 0), (6, 0), (2, 8), (2, 8), (30, 0), (30, 0),
                        (30, 0)):
        _traffic(slo_pair, n_ok, n_bad)
        j, t = _slo_replies(slo_pair)
        assert t == j
        seen.append(t["status"]["availability"]["state"])
    assert seen[0] == "ok"
    assert "breached" in seen
    assert seen[-1] == "recovered"
    assert t["status"]["sweep-latency"]["state"] == "ok"
    assert t["status"]["sweep-latency"]["bad"] == 0
    assert t["evaluations"] == 7
    assert len(t["specs"]) == 2


def test_healthz_flips_with_a_fast_burn(slo_pair):
    server, mon, reg = slo_pair["torch"]
    healthy, status = healthz_probes(server, slo=mon)
    metrics = start_metrics_server(reg, healthy=healthy, status=status)
    try:
        codes = []
        for n_ok, n_bad in ((6, 0), (2, 8), (30, 0), (30, 0), (30, 0)):
            _traffic(slo_pair, n_ok, n_bad)
            mon.evaluate()
            try:
                with urllib.request.urlopen(metrics.url + "/healthz",
                                            timeout=TIMEOUT_S) as r:
                    codes.append((r.status, json.loads(r.read())))
            except urllib.error.HTTPError as e:
                codes.append((e.code, json.loads(e.read())))
    finally:
        metrics.shutdown()
    assert codes[0][0] == 200 and codes[0][1]["slo"]["breached"] == []
    assert codes[1][0] == 503
    assert codes[1][1]["slo"]["breached"] == ["availability"]
    assert codes[-1][0] == 200
    assert codes[-1][1]["slo"]["states"]["availability"] == "recovered"


@pytest.mark.parametrize("output", ["table", "json"])
def test_cli_slo_status_matches_jax(output, slo_pair, capsys):
    """-slo-status from either CLI against either server renders the same
    text and exits by the verdict (0 ok, 1 while breached)."""
    rcs = []
    for n_ok, n_bad in ((6, 0), (2, 8)):
        _traffic(slo_pair, n_ok, n_bad)
        outs = []
        for main in (j_cli.main, t_cli.main):
            for name in ("jax", "torch"):
                host, port = slo_pair[name][0].address
                rc = main(["-slo-status", f"{host}:{port}",
                           "-output", output])
                outs.append((rc, capsys.readouterr().out))
        # Each call evaluates once on its server: the JAX CLI's pair saw
        # the same evaluation count, and so did the port CLI's.
        assert outs[1] == outs[0]
        assert outs[3] == outs[2]
        assert [rc for rc, _ in outs] == [outs[0][0]] * 4
        rcs.append(outs[0][0])
    assert rcs == [0, 1]


@pytest.mark.parametrize("addr", ["nonsense", "127.0.0.1:1"])
def test_cli_slo_status_bad_address_like_jax(addr, capsys):
    outs = []
    for main in (j_cli.main, t_cli.main):
        rc = main(["-slo-status", addr])
        captured = capsys.readouterr()
        outs.append((rc, captured.out, captured.err))
    assert outs[1] == outs[0]
    assert outs[0][0] == 1 and outs[0][2].startswith("ERROR : ")


def test_unconfigured_server_like_jax(capsys):
    outs = []
    jserver = JaxServer(j_synthetic(8, seed=33))
    tserver = TorchServer(synthetic_snapshot(8, seed=33), device="cpu")
    for s in (jserver, tserver):
        s.start()
    try:
        assert jserver.dispatch({"op": "slo"}) == tserver.dispatch(
            {"op": "slo"}) == {"enabled": False}
        for main in (j_cli.main, t_cli.main):
            for s in (jserver, tserver):
                host, port = s.address
                outs.append((main(["-slo-status", f"{host}:{port}"]),
                             capsys.readouterr().out))
    finally:
        for s in (jserver, tserver):
            s.shutdown()
    assert all(o == outs[0] for o in outs)
    assert outs[0] == (1, "slo: not enabled on this server (-slo FILE)\n")


@pytest.mark.parametrize("render", ["table", "json"])
def test_renderers_match_jax(render, slo_pair):
    _traffic(slo_pair, 2, 8)
    wire = _slo_replies(slo_pair)[1]
    assert (getattr(t_report, f"slo_{render}_report")(wire)
            == getattr(j_report, f"slo_{render}_report")(wire))


def test_server_main_rejects_bad_slo_file_like_jax(tmp_path, capsys):
    from kubernetesclustercapacity_tpu.service import server as j_server
    from kubernetesclustercapacity_tpu_torch.service import server as t_server

    bad = tmp_path / "slo.json"
    bad.write_text(json.dumps({"slos": [{"name": "x"}]}))
    argv = ["-snapshot", "tests/fixtures/kind-3node.json", "-slo", str(bad),
            "-port", "0"]
    assert j_server.main(argv) == 1
    j_err = capsys.readouterr().err
    assert t_server.main(argv + ["-device", "cpu"]) == 1
    assert capsys.readouterr().err == j_err
    assert j_err.startswith("ERROR : bad SLO file: ")
