"""HTTP front-end for the continuous-batching search server.

The counterpart of ``vaq_tpu/serving_http.py``, with its routes, body cap
and errors. The reference is a CLI-only library (demos print metrics and
exit); a serving deployment needs a network surface. This module wraps
:class:`vaq_tpu_torch.serving.SearchServer` in a threaded stdlib HTTP
server (no external dependencies):

* ``POST /search``  body ``{"query": [[...]] | [...], "k": int?}`` →
  ``{"distances": [[...]], "labels": [[...]]}``. Each request is submitted
  to the batcher and the handler thread blocks on its future, so many
  concurrent HTTP connections coalesce into fixed-shape device batches
  (the HTTP thread pool is the open-loop client population).
* ``GET /stats``    → end-to-end latency percentiles + counters.
* ``GET /healthz``  → 200 once the search path is warm.

Threading model: ``ThreadingHTTPServer`` gives one thread per in-flight
request; the only shared state is the SearchServer queue (thread-safe) and
its stats (lock-guarded). Request bodies are capped (`max_body`) so a
misbehaving client cannot balloon host memory.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from vaq_tpu_torch.errors import ShapeError
from vaq_tpu_torch.serving import SearchServer


class SearchHTTPServer:
    """Owns a ThreadingHTTPServer bound to (host, port) serving `server`."""

    def __init__(self, server: SearchServer, host: str = "127.0.0.1",
                 port: int = 0, max_body: int = 64 << 20,
                 request_timeout_s: float = 60.0):
        self.search_server = server
        self.max_body = max_body
        self.request_timeout_s = request_timeout_s
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _reply(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, {"ok": True})
                elif self.path == "/stats":
                    srv = outer.search_server
                    with srv._lock:
                        s = srv.stats.summary()
                        s["queries_served"] = srv.queries_served
                        s["batches_served"] = srv.batches_served
                    self._reply(200, s)
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/search":
                    self._reply(404, {"error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    if length <= 0 or length > outer.max_body:
                        self._reply(413, {"error": "bad Content-Length"})
                        return
                    req = json.loads(self.rfile.read(length))
                    q = np.asarray(req["query"], dtype=np.float32)
                    if q.ndim == 1:
                        q = q[None, :]
                    if q.ndim != 2:
                        raise ShapeError("query must be (d,) or (g, d)")
                    k = int(req.get("k", outer.search_server.k))
                    if k != outer.search_server.k:
                        # the batcher serves one compiled k; trim client-side
                        if k > outer.search_server.k:
                            raise ShapeError(
                                f"k={k} exceeds server k="
                                f"{outer.search_server.k}")
                    d, i = outer.search_server.search(
                        q, timeout=outer.request_timeout_s)
                    self._reply(200, {"distances": d[:, :k].tolist(),
                                      "labels": i[:, :k].tolist()})
                except (KeyError, ValueError, ShapeError) as e:
                    self._reply(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 — server must survive
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self):
        return self._httpd.server_address  # (host, bound port)

    def start(self) -> "SearchHTTPServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
