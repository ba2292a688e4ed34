"""Prometheus exposition: text format v0.0.4 + a tiny scrape endpoint.

Counterpart of ``kubernetesclustercapacity_tpu/telemetry/exposition.py``,
verbatim: the scrape text is host formatting, byte for byte the JAX
package's for the same registry.

:func:`render_text` turns a :class:`~.metrics.MetricsRegistry` into the
text format every Prometheus-compatible scraper parses — ``# HELP`` /
``# TYPE`` headers, samples with escaped label values in declaration
order, histogram ``_bucket{le=...}`` series cumulative with the
``+Inf`` bucket equal to ``_count``.

:class:`MetricsServer` serves that rendering over HTTP from a
background thread (stdlib ``http.server`` — no new dependencies):

* ``GET /metrics``  — the scrape, ``text/plain; version=0.0.4`` with an
  explicit charset; the endpoint self-reports
  ``kccap_scrape_duration_seconds`` (how long each rendering took), so
  a scrape config's timeout budget is tunable from the scrapes
  themselves;
* ``GET /healthz``  — liveness JSON; an embedder-supplied ``healthy``
  callable flips it to 503 (e.g. a dead follower behind a serving
  snapshot must be *visible* to the load balancer, the same
  never-silently-stale rule the follower itself enforces).

``HEAD`` is answered on every path with the GET status/headers and no
body — uptime probes and load balancers preflight with HEAD, and an
observability endpoint that 501s them reads as down.

The endpoint is observability-only and carries no auth: bind it to
localhost (the default) or scrape-net, never the request port.
"""

from __future__ import annotations

import json
import threading

from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
    MetricsRegistry,
    _format_value,
    _HistogramChild,
    escape_label_value,
)

__all__ = ["render_text", "MetricsServer", "start_metrics_server"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _label_block(labelnames, key, extra: str = "") -> str:
    """``{a="x",b="y"}`` in declaration order; ``""`` when empty."""
    parts = [
        f'{ln}="{escape_label_value(v)}"'
        for ln, v in zip(labelnames, key)
    ]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _exemplar_suffix(ex: dict | None, le: str) -> str:
    """The OpenMetrics exemplar tail for one bucket sample —
    `` # {trace_id="..."} value ts`` — or ``""`` when the bucket never
    carried one.  Classic v0.0.4 parsers that split on the LAST space
    still read the line once they strip the `` # `` comment tail (the
    test-side ``parse_exposition`` does exactly that)."""
    if not ex:
        return ""
    entry = ex.get(le)
    if entry is None:
        return ""
    return (
        f' # {{trace_id="{escape_label_value(entry["trace_id"])}"}}'
        f' {_format_value(entry["value"])} {entry["ts"]:.3f}'
    )


def render_text(registry: MetricsRegistry) -> str:
    """The registry as Prometheus text format v0.0.4 (one scrape body).
    Histogram buckets that recorded an exemplar carry it in OpenMetrics
    exemplar syntax — the metrics→traces join, no grepping required."""
    lines: list[str] = []
    for fam in registry.collect():
        if not fam.scrape:
            continue
        lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.type}")
        for key, child in fam._items():
            if isinstance(child, _HistogramChild):
                snap = child.snapshot()
                exemplars = snap.get("exemplars")
                for le, cum in snap["buckets"].items():
                    le_pair = 'le="%s"' % le
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_label_block(fam.labelnames, key, le_pair)}"
                        f" {_format_value(cum)}"
                        f"{_exemplar_suffix(exemplars, le)}"
                    )
                lines.append(
                    f"{fam.name}_sum{_label_block(fam.labelnames, key)}"
                    f" {_format_value(snap['sum'])}"
                )
                lines.append(
                    f"{fam.name}_count{_label_block(fam.labelnames, key)}"
                    f" {_format_value(snap['count'])}"
                )
            else:
                lines.append(
                    f"{fam.name}{_label_block(fam.labelnames, key)}"
                    f" {_format_value(child.value)}"
                )
    return "\n".join(lines) + ("\n" if lines else "")


class MetricsServer:
    """Background-thread HTTP endpoint for ``/metrics`` + ``/healthz``.

    ``healthy`` is an optional zero-arg callable returning truthy when
    the embedding process considers itself live; a raise counts as
    unhealthy (a health check that can crash the server it reports on
    would be worse than no check).

    ``status`` is an optional zero-arg callable returning a JSON-able
    dict merged into the ``/healthz`` body — the embedder's freshness
    evidence (snapshot generation, follower last-relist age) so a load
    balancer can detect a *stuck* follower behind a liveness check that
    still answers.  A raise surfaces as ``{"status_error": ...}`` and
    flips the reply to 503: a status source that cannot report is
    indistinguishable from a wedged feed.

    ``debug`` is an optional ``{path: handler}`` map of extra GET
    endpoints (e.g. ``/debug/profile``); each handler takes the raw
    query string and returns ``(content_type, body_bytes)``.  Handlers
    run on the request's own thread (the threading server means a
    handler that sleeps — the profiler's collection window — blocks
    only its caller, never scrapes).  A raising handler is a 500 with
    the error named, same crash-isolation rule as ``healthy``.
    """

    def __init__(
        self,
        registry: MetricsRegistry,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        healthy=None,
        status=None,
        debug=None,
    ) -> None:
        import http.server
        import time

        from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
            enabled as _telemetry_enabled,
        )

        self.registry = registry
        self._healthy = healthy
        self._status = status
        self._debug = dict(debug or {})
        # Scrape self-report: the time each exposition render takes,
        # visible in the very scrape it measures (the previous render's
        # sample — a scrape cannot carry its own final timing).  Skipped
        # under KCCAP_TELEMETRY=0: a disabled process must not have its
        # metrics endpoint re-populate the registry it silenced.
        self._scrape_hist = (
            registry.histogram(
                "kccap_scrape_duration_seconds",
                "Time spent rendering the /metrics exposition.",
            )
            if _telemetry_enabled()
            else None
        )
        outer = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 - stdlib contract
                self._serve(head=False)

            def do_HEAD(self) -> None:  # noqa: N802 - stdlib contract
                # Identical routing/status/headers, body withheld: the
                # cheap liveness preflight probes and LBs issue.
                self._serve(head=True)

            def _serve(self, *, head: bool) -> None:
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    t0 = time.perf_counter()
                    body = render_text(outer.registry).encode()
                    if outer._scrape_hist is not None:
                        outer._scrape_hist.observe(
                            time.perf_counter() - t0
                        )
                    self._reply(200, CONTENT_TYPE, body, head)
                elif path == "/healthz":
                    ok = True
                    if outer._healthy is not None:
                        try:
                            ok = bool(outer._healthy())
                        except Exception:  # noqa: BLE001 - check != crash
                            ok = False
                    payload = {"ok": ok}
                    if outer._status is not None:
                        try:
                            payload.update(outer._status() or {})
                        except Exception as e:  # noqa: BLE001 - see class doc
                            ok = False
                            payload["ok"] = False
                            payload["status_error"] = (
                                f"{type(e).__name__}: {e}"
                            )
                    body = json.dumps(payload).encode()
                    self._reply(
                        200 if ok else 503,
                        "application/json; charset=utf-8",
                        body,
                        head,
                    )
                elif path in outer._debug:
                    query = (
                        self.path.split("?", 1)[1]
                        if "?" in self.path
                        else ""
                    )
                    try:
                        ctype, body = outer._debug[path](query)
                    except Exception as e:  # noqa: BLE001 - see class doc
                        self._reply(
                            500,
                            "text/plain; charset=utf-8",
                            f"{type(e).__name__}: {e}\n".encode(),
                            head,
                        )
                        return
                    self._reply(200, ctype, body, head)
                else:
                    self._reply(
                        404, "text/plain; charset=utf-8", b"not found\n",
                        head,
                    )

            def _reply(
                self, code: int, ctype: str, body: bytes,
                head: bool = False,
            ) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if not head:
                    self.wfile.write(body)

            def log_message(self, *args) -> None:  # scrapes are not news
                pass

        class _Server(http.server.ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._http = _Server((host, port), _Handler)
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> tuple[str, int]:
        return self._http.server_address  # type: ignore[return-value]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(
            target=self._http.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._http.shutdown()
        self._http.server_close()


def start_metrics_server(
    registry: MetricsRegistry,
    *,
    host: str = "127.0.0.1",
    port: int = 0,
    healthy=None,
    status=None,
    debug=None,
) -> MetricsServer:
    """Construct AND start a :class:`MetricsServer` (the one-liner every
    embedder wants; ``port=0`` picks a free port — read ``.address``)."""
    return MetricsServer(
        registry, host=host, port=port, healthy=healthy, status=status,
        debug=debug,
    ).start()
