"""Embedded HTTP telemetry endpoints: scrape, probe, and dump — live (the
port of ``gradaccum_tpu/obs/telemetry.py``).

Trace rings and flight dumps make the system legible post-hoc; this
module makes the same state reachable WHILE the system runs, with zero
dependencies (stdlib ``http.server``) and zero cost when off (nothing
listens unless a caller starts it — the default everywhere).

Endpoints (GET only; everything is read-only by design):

========== ==================================================================
``/metrics``  Prometheus text exposition of the bound registry (scrapers)
``/healthz``  liveness: 200 while the owner reports alive, else 503
``/readyz``   readiness: 200 only while the owner can take traffic
              (fault state clean, not draining), else 503
``/varz``     the owner's live JSON snapshot (``ServingServer.stats()``:
              queue depth, pool occupancy, ``per_replica`` breakdown)
``/trace``    the recent span ring as Chrome trace-event JSON
``/slo``      the SLO evaluator's live status (when one is bound)
``/sentinel`` the sentinel's firing/heartbeat/baseline view (when bound)
========== ==================================================================

The server binds ``127.0.0.1`` by default (operator-local; front it with
real infra to expose it) and ``port=0`` picks an ephemeral port — read it
back from :attr:`TelemetryServer.port`. Handler threads only ever READ
owner state through the provided callables, which must therefore be
thread-safe (``ServingServer.stats`` is; registry/tracer snapshots are).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple

from gradaccum_tpu_torch.obs import trace as obs_trace

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _Handler(BaseHTTPRequestHandler):
    server_version = "gradaccum-telemetry/1"

    def log_message(self, *args):  # noqa: D102 — the obs plane must not spam
        pass

    def do_GET(self):  # noqa: N802 — http.server API
        owner: "TelemetryServer" = self.server.owner  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            code, ctype, body = owner._render(path)
        except Exception as e:  # noqa: BLE001 — a probe must get an answer
            code, ctype = 500, "application/json"
            body = json.dumps({"error": repr(e)}).encode() + b"\n"
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # a scraper hanging up early is its problem


class TelemetryServer:
    """One embedded ops-plane HTTP server.

    All hooks are optional — an endpoint whose hook is missing answers
    404, so a bare ``TelemetryServer(registry=...)`` is already a valid
    scrape target. ``health``/``ready`` return ``(ok, detail_dict)``;
    ``varz`` returns a JSON-able dict; ``tracer=None`` resolves the
    process-global tracer per request.
    """

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        registry=None,
        tracer=None,
        varz: Optional[Callable[[], dict]] = None,
        health: Optional[Callable[[], Tuple[bool, dict]]] = None,
        ready: Optional[Callable[[], Tuple[bool, dict]]] = None,
        slo=None,
        sentinel=None,
    ):
        self._bind = (host, int(port))
        self.registry = registry
        self._tracer = tracer
        self._varz = varz
        self._health = health
        self._ready = ready
        self.slo = slo
        self.sentinel = sentinel
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "TelemetryServer":
        if self._httpd is not None:
            return self
        httpd = ThreadingHTTPServer(self._bind, _Handler)
        httpd.daemon_threads = True
        httpd.owner = self  # type: ignore[attr-defined]
        self._httpd = httpd
        self._thread = threading.Thread(target=httpd.serve_forever,
                                        daemon=True, name="obs-telemetry")
        self._thread.start()
        return self

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        thread, self._thread = self._thread, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=5.0)

    @property
    def port(self) -> Optional[int]:
        """The bound port (the actual one when constructed with 0)."""
        return None if self._httpd is None else self._httpd.server_address[1]

    def url(self, path: str = "/") -> str:
        host = self._bind[0]
        return f"http://{host}:{self.port}{path}"

    def __enter__(self) -> "TelemetryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- rendering ---------------------------------------------------------

    @staticmethod
    def _json(payload, code: int = 200):
        body = (json.dumps(payload, sort_keys=True, default=str) + "\n"
                ).encode()
        return code, "application/json", body

    def _probe(self, fn) -> Tuple[int, str, bytes]:
        ok, detail = fn()
        return self._json({"ok": bool(ok), **detail}, 200 if ok else 503)

    def _render(self, path: str) -> Tuple[int, str, bytes]:
        if path == "/metrics" and self.registry is not None:
            return (200, PROM_CONTENT_TYPE,
                    self.registry.to_prometheus().encode())
        if path == "/healthz":
            # with no hook, answering at all IS liveness
            return self._probe(self._health or (lambda: (True, {})))
        if path == "/readyz" and self._ready is not None:
            return self._probe(self._ready)
        if path == "/varz" and self._varz is not None:
            return self._json(self._varz())
        if path == "/trace":
            tracer = obs_trace.resolve(self._tracer)
            return self._json(tracer.to_chrome())
        if path == "/slo" and self.slo is not None:
            return self._json(self.slo.status())
        if path == "/sentinel" and self.sentinel is not None:
            return self._json(self.sentinel.status())
        if path == "/":
            have = [p for p, ok in (
                ("/metrics", self.registry is not None),
                ("/healthz", True),
                ("/readyz", self._ready is not None),
                ("/varz", self._varz is not None),
                ("/trace", True),
                ("/slo", self.slo is not None),
                ("/sentinel", self.sentinel is not None),
            ) if ok]
            return 200, "text/plain", ("\n".join(have) + "\n").encode()
        return self._json({"error": f"no such endpoint: {path}"}, 404)
