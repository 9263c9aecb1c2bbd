"""Live telemetry endpoints: the scrapeable per-process surface.

Counterpart of the JAX package's ``obs/http.py``, stdlib only.  One
:class:`ThreadingHTTPServer` per process, read-only, bound to 127.0.0.1 by
default and **off by default** (``QRP2P_HTTP_PORT`` or
``SecureMessaging(telemetry_port=)``; when disabled there is no listener,
no thread, and the engine does not import this module).

Endpoints (all ``GET``; every other verb is 405, an unknown path 404):

=================  ==========================================================
``/metrics``       Prometheus text exposition through
                   :func:`obs.metrics.prometheus_text` (the one exposition
                   path); rendering walks the registry's collectors, so a
                   scrape advances the SLO engine
``/metrics.json``  the registry's JSON snapshot (instruments + collectors)
``/healthz``       liveness: 200 with node id + uptime while serving
``/readyz``        readiness: 200 only when the warm-up finished, no breaker
                   is away from ``closed`` and the engine is not draining;
                   else 503 with the reason in the body
``/slo``           the SLO engine's burn/budget report
``/trace``         recent spans as a chrome://tracing document (bounded by
                   the tracer's ring)
``/cost``          the device-cost ledger snapshot (obs/cost.py)
=================  ==========================================================

Every document is built from registry snapshots, SLO reports and span
dumps, which hold no secrets; request parsing is bounded by the stdlib
handler (a request line over 64 KiB answers 414) and every response by
:data:`MAX_RESPONSE_BYTES` (503 past it).
"""

from __future__ import annotations

import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable

from .metrics import PROMETHEUS_CONTENT_TYPE, prometheus_text

logger = logging.getLogger(__name__)

#: env knob: unset/empty = disabled (the default), ``0`` = ephemeral
#: port, ``N`` = fixed port.  app/messaging.py reads it at engine
#: construction when no explicit ``telemetry_port=`` is passed.
TELEMETRY_PORT_ENV = "QRP2P_HTTP_PORT"

#: hard response-size bound: a route whose document exceeds this answers
#: 503 instead of streaming an unbounded body to the scraper
MAX_RESPONSE_BYTES = 16 * 1024 * 1024

JSON_TYPE = "application/json"

#: a route: () -> (http status, content type, body bytes)
Route = Callable[[], "tuple[int, str, bytes]"]


def env_port() -> int | None:
    """The :data:`TELEMETRY_PORT_ENV` value, or None when unset/empty/
    malformed (malformed values disable with a WARNING — a typo must not
    crash engine construction)."""
    raw = os.environ.get(TELEMETRY_PORT_ENV, "").strip()
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        logger.warning("ignoring malformed %s=%r (want an integer port; "
                       "0 = ephemeral)", TELEMETRY_PORT_ENV, raw)
        return None


def json_route(fn: Callable[[], Any],
               status_fn: Callable[[Any], int] | None = None) -> Route:
    """Wrap a document builder as a JSON route (sorted keys: scrape
    diffs stay stable)."""
    def route() -> tuple[int, str, bytes]:
        doc = fn()
        body = (json.dumps(doc, default=str, sort_keys=True) + "\n").encode()
        return (status_fn(doc) if status_fn is not None else 200,
                JSON_TYPE, body)

    return route


class _Handler(BaseHTTPRequestHandler):
    """Read-only request handler over the server's route table.

    The stdlib base already bounds hostile input: a request line over
    64 KiB answers 414, header count/size are capped by http.client.
    Everything that is not a ``GET`` of a known path is 404/405.
    """

    server_version = "qrp2p-telemetry"
    sys_version = ""  # no Python version banner in responses
    protocol_version = "HTTP/1.0"  # close per request: one scrape, one
    # thread, no keep-alive thread pinning
    timeout = 10.0

    def do_GET(self) -> None:  # noqa: N802 (stdlib handler contract)
        path = self.path.split("?", 1)[0]
        route = self.server.routes.get(path)  # type: ignore[attr-defined]
        if route is None:
            self._respond(404, JSON_TYPE, b'{"error": "unknown path"}\n')
            return
        try:
            status, ctype, body = route()
        except Exception:  # one crashing route answers a bounded 500, never kills the thread
            logger.exception("telemetry route %s failed", path)
            self._respond(500, JSON_TYPE, b'{"error": "handler failed"}\n')
            return
        if len(body) > MAX_RESPONSE_BYTES:
            self._respond(503, JSON_TYPE,
                          b'{"error": "response too large"}\n')
            return
        self._respond(status, ctype, body)

    def _reject_write(self) -> None:
        self._respond(405, JSON_TYPE,
                      b'{"error": "telemetry is read-only (GET only)"}\n')

    # the surface is read-only by construction: every mutating verb is
    # rejected with one typed reply
    do_POST = do_PUT = do_DELETE = do_PATCH = _reject_write

    def _respond(self, status: int, ctype: str, body: bytes) -> None:
        # the single response-write chokepoint: only registry snapshots,
        # SLO reports and span dumps flow here
        try:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (ConnectionError, OSError):
            pass  # the scraper went away mid-response; nothing to serve

    def log_message(self, fmt: str, *args: Any) -> None:
        # scrapes are high-frequency background traffic: keep them out of
        # stderr; DEBUG keeps the trail findable
        logger.debug("telemetry %s " + fmt, self.address_string(), *args)


class TelemetryServer:
    """One per-process telemetry listener over a route table.

    ``port=0`` binds an ephemeral port (read it back via :attr:`port`
    after :meth:`start`).  The accept loop runs on a daemon thread;
    request handling threads are daemonic too, so a forgotten server
    never blocks interpreter exit — but callers should :meth:`stop` on
    drain (the engine does, in ``stop_telemetry``).
    """

    def __init__(self, routes: dict[str, Route], host: str = "127.0.0.1",
                 port: int = 0):
        self.routes = dict(routes)
        self._host = host
        self._requested_port = port
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> "TelemetryServer":
        if self._server is not None:
            return self
        srv = ThreadingHTTPServer((self._host, self._requested_port),
                                  _Handler)
        srv.daemon_threads = True
        srv.routes = self.routes  # type: ignore[attr-defined]
        self._server = srv
        self._thread = threading.Thread(
            target=srv.serve_forever, name="qrp2p-telemetry", daemon=True,
            kwargs={"poll_interval": 0.25},
        )
        self._thread.start()
        logger.info("telemetry endpoints on http://%s:%d (read-only)",
                    self._host, self.port)
        return self

    @property
    def port(self) -> int | None:
        """The bound port (None before :meth:`start`)."""
        if self._server is None:
            return None
        return self._server.server_address[1]

    @property
    def address(self) -> str | None:
        if self._server is None:
            return None
        return f"{self._host}:{self.port}"

    def stop(self) -> None:
        srv, self._server = self._server, None
        thread, self._thread = self._thread, None
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        if thread is not None:
            thread.join(timeout=5.0)

    # -- canned route tables --------------------------------------------------

    @classmethod
    def for_engine(cls, engine, host: str = "127.0.0.1",
                   port: int = 0) -> "TelemetryServer":
        """The per-gateway route table over one ``SecureMessaging``
        engine: every document is built from the engine's registry /
        SLO engine / cost ledger / the process tracer — read-only
        snapshots, no mutation path."""
        from . import trace as obs_trace

        registry = engine.registry

        def prom() -> tuple[int, str, bytes]:
            # the shared exposition path (obs/metrics.prometheus_text):
            # rendering walks the registry collectors, so a scrape
            # advances the SLO engine exactly like metrics() does
            return 200, PROMETHEUS_CONTENT_TYPE, prometheus_text(
                registry).encode()

        def trace_doc() -> dict[str, Any]:
            return obs_trace.to_chrome_trace(obs_trace.TRACER.snapshot())

        return cls({
            "/metrics": prom,
            "/metrics.json": json_route(registry.snapshot),
            "/healthz": json_route(engine.health_doc),
            "/readyz": json_route(
                engine.ready_status,
                status_fn=lambda doc: 200 if doc.get("ready") else 503),
            "/slo": json_route(engine.slo_status),
            "/trace": json_route(trace_doc),
            "/cost": json_route(engine.cost.snapshot),
        }, host=host, port=port).start()
