"""The repo's ONE telemetry HTTP server (r19: both planes serve through it).

One :class:`~..utils.metrics.MetricsRegistry` — shared by the engine, the
ingest ring, the watchdog, the validation pipeline, or a whole live
network — rendered through ``render_prometheus``:

- ``GET /metrics``    Prometheus text exposition (format 0.0.4);
- ``GET /debug/obs``  JSON observability digest: span-ledger summary, the
  black box's recent frames, and the serving plane's live control surface
  (controller knobs + watchdog tier + recent decisions) — when wired;
- plus any ``extra_json`` endpoints the caller plugs in — the live plane
  mounts its ``/debug/tree`` topology snapshot here, so both planes share
  one serving path and one exposition formatter (the hand-rolled asyncio
  ``MetricsHTTPServer`` that lived in ``net/live.py`` since r6 is gone).

Runs a stdlib ``ThreadingHTTPServer`` on a daemon thread — works for
synchronous host code and for the live plane alike (its snapshot callables
only read loop-owned state, never await).  Bind port 0 for an ephemeral
port (tests).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional


class ObsHTTPServer:
    """Thread-backed observability endpoint over one shared registry."""

    def __init__(
        self,
        registry,
        ledger=None,
        blackbox=None,
        host: str = "127.0.0.1",
        port: int = 0,
        extra_json: Optional[Dict[str, Callable[[], object]]] = None,
        controls: Optional[Callable[[], object]] = None,
    ) -> None:
        self.registry = registry
        self.ledger = ledger
        self.blackbox = blackbox
        # r20: zero-arg callable returning the serving plane's live control
        # surface (controller knobs, watchdog tier, recent decisions) —
        # merged into /debug/obs as doc["controls"].  Typically
        # serve.controller.Controller.controls.
        self.controls = controls
        # path -> zero-arg callable returning a JSON-serializable doc,
        # rendered sorted-keys like /debug/obs.  Reserved paths lose.
        self.extra_json = dict(extra_json or {})
        self._bind = (host, port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        """Bind + serve on a daemon thread; returns the bound port."""
        if self._httpd is not None:
            raise RuntimeError("server already started")
        owner = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (stdlib naming)
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = owner.registry.render_prometheus().encode()
                    ctype = "text/plain; version=0.0.4"
                    status = 200
                elif path == "/debug/obs":
                    body = json.dumps(
                        owner._debug_doc(), sort_keys=True
                    ).encode()
                    ctype = "application/json"
                    status = 200
                elif path in owner.extra_json:
                    body = json.dumps(
                        owner.extra_json[path](), sort_keys=True
                    ).encode()
                    ctype = "application/json"
                    status = 200
                else:
                    body = b"not found\n"
                    ctype = "text/plain"
                    status = 404
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a) -> None:  # quiet: no stderr spam
                pass

        self._httpd = ThreadingHTTPServer(self._bind, Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-metrics", daemon=True
        )
        self._thread.start()
        return self.port

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("server not started")
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._bind[0]}:{self.port}"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _debug_doc(self) -> dict:
        doc: dict = {"counters": self.registry.counters()}
        if self.ledger is not None:
            doc["spans"] = self.ledger.summary()
        if self.blackbox is not None:
            doc["blackbox"] = {
                "recorded": self.blackbox.recorded,
                "frames": self.blackbox.frames()[-8:],
            }
        if self.controls is not None:
            doc["controls"] = self.controls()
        return doc
