"""Health endpoint (a copy of `shockwave_tpu/obs/exporter.py`; the port's
worker daemon serves it on ``--obs_port``): a lightweight HTTP server
exposing

- ``GET /metrics``      — Prometheus text exposition of a MetricsRegistry,
- ``GET /healthz``      — JSON from an injected health callback (current
  round, live workers, breaker states, journal lag, ...),
- ``GET /history.json`` — JSON from an injected telemetry-history
  callback (obs/history.py: per-round metric snapshots + observed
  throughput points + alert verdicts); 404 when the process keeps no
  history (e.g. an HA hot standby before promotion — the history is
  served by whichever process holds the journal).

Built on the stdlib ThreadingHTTPServer: no new dependencies, one
daemon thread, bounded per-request work (render + send). Opt-in (port 0
binds an ephemeral port, readable from ``.port`` after start()). The
worker daemon passes no history callback, as the reference's does.

The server never touches the daemon's internals directly — the health
callback owns its own locking — so a wedged daemon can stall
``/healthz`` but never the other way around.
"""
from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from .registry import MetricsRegistry

logger = logging.getLogger("shockwave_tpu_torch.obs")

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class ObsHttpServer:
    def __init__(self, registry: MetricsRegistry,
                 health_fn: Optional[Callable[[], dict]] = None,
                 history_fn: Optional[Callable[[], dict]] = None,
                 addr: str = "0.0.0.0", port: int = 0):
        self._registry = registry
        self._health_fn = health_fn
        self._history_fn = history_fn
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            # One scrape every few seconds; access logs are noise.
            def log_message(self, fmt, *args):  # noqa: D102
                logger.debug("obs http: " + fmt, *args)

            def _send(self, code: int, content_type: str,
                      body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 - http.server API
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = outer._registry.render_prometheus().encode()
                    self._send(200, PROMETHEUS_CONTENT_TYPE, body)
                elif path == "/healthz":
                    code, payload = outer._health()
                    self._send(code, "application/json",
                               json.dumps(payload).encode())
                elif path == "/history.json":
                    code, payload = outer._history()
                    self._send(code, "application/json",
                               json.dumps(payload).encode())
                else:
                    self._send(404, "text/plain",
                               b"try /metrics, /healthz or "
                               b"/history.json\n")

        self._httpd = ThreadingHTTPServer((addr, port), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="swtpu-obs-http",
            daemon=True)
        self._started = False

    def _health(self):
        if self._health_fn is None:
            return 200, {"status": "ok"}
        try:
            payload = dict(self._health_fn())
        except Exception as e:  # noqa: BLE001 - a health probe must
            # report the failure, not take the exporter thread down.
            logger.exception("health callback failed")
            return 500, {"status": "error", "error": f"{type(e).__name__}: {e}"}
        payload.setdefault("status", "ok")
        return 200, payload

    def _history(self):
        if self._history_fn is None:
            return 404, {"status": "no_history",
                         "detail": "this process keeps no telemetry "
                                   "history (see /metrics for live "
                                   "gauges)"}
        try:
            return 200, dict(self._history_fn())
        except Exception as e:  # noqa: BLE001 - history is telemetry;
            # a broken ring must report, not take the exporter down.
            logger.exception("history callback failed")
            return 500, {"status": "error",
                         "error": f"{type(e).__name__}: {e}"}

    @property
    def port(self) -> int:
        """The bound port (resolves port=0 to the ephemeral choice)."""
        return self._httpd.server_address[1]

    def start(self) -> "ObsHttpServer":
        if not self._started:
            self._thread.start()
            self._started = True
            logger.info("obs endpoint serving /metrics and /healthz on "
                        "port %d", self.port)
        return self

    def stop(self) -> None:
        if self._started:
            self._httpd.shutdown()
            self._started = False
        self._httpd.server_close()
