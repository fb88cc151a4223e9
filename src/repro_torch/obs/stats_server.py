"""HTTP exposition endpoint: Prometheus text metrics + JSON stats.

A tiny stdlib ``http.server`` wrapper (no new dependencies) serving:

  * ``GET /metrics`` — the registry's Prometheus text exposition
    (``Content-Type: text/plain; version=0.0.4``), scrape-ready;
  * ``GET /stats``   — a JSON document merging every registered stats
    provider (e.g. ``engine.stats``), for humans and dashboards;
  * ``GET /healthz`` — liveness probe (``ok``).

Usage::

    server = StatsServer(registry, port=9100)
    server.add_stats_provider("engine", engine.stats)
    server.start()                      # daemon thread
    ...
    server.stop()

``port=0`` binds an ephemeral port (``server.port`` reports the real
one) — what the tests use so parallel CI lanes never collide.
"""
from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from repro_torch.obs.registry import MetricsRegistry

logger = logging.getLogger(__name__)


def _default(obj):
    """JSON fallback for numpy scalars/arrays inside stats dicts."""
    try:
        import numpy as np
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, np.generic):
            return obj.item()
    except ImportError:  # pragma: no cover - numpy is a hard dep here
        pass
    return repr(obj)


class StatsServer:
    """Serve one :class:`MetricsRegistry` (plus optional JSON stats
    providers) over HTTP. Start/stop are idempotent; the listener is a
    daemon ``ThreadingHTTPServer`` so a scrape can never block serving.
    """

    def __init__(self, registry: MetricsRegistry, *, host: str = "0.0.0.0",
                 port: int = 0):
        self.registry = registry
        self.host = host
        self._port = port
        self._providers: Dict[str, Callable[[], dict]] = {}
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        """The bound port (resolves ``port=0`` after :meth:`start`)."""
        return (self._httpd.server_address[1] if self._httpd
                else self._port)

    def add_stats_provider(self, name: str,
                           fn: Callable[[], dict]) -> None:
        self._providers[name] = fn

    def stats(self) -> dict:
        out = {}
        for name, fn in list(self._providers.items()):
            try:
                out[name] = fn()
            except Exception as e:   # a dead provider must not 500 the
                out[name] = {"error": repr(e)}   # whole endpoint
        return out

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "StatsServer":
        if self._httpd is not None:
            return self
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):   # route through logging,
                logger.debug("stats_server: " + fmt, *args)   # not stderr

            def _send(self, code: int, body: str, ctype: str) -> None:
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        self._send(200, server.registry.render_prometheus(),
                                   "text/plain; version=0.0.4; "
                                   "charset=utf-8")
                    elif path == "/stats":
                        self._send(200,
                                   json.dumps(server.stats(),
                                              default=_default),
                                   "application/json")
                    elif path == "/healthz":
                        self._send(200, "ok\n", "text/plain")
                    else:
                        self._send(404, f"unknown path {path}\n",
                                   "text/plain")
                except BrokenPipeError:   # client went away mid-write
                    pass

        self._httpd = ThreadingHTTPServer((self.host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="stats-server",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._httpd = self._thread = None

    def __enter__(self) -> "StatsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
