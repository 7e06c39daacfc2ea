"""Minimal HTTP serving front (a copy of ``colbert_tpu.serving.http``;
standard library only).

Endpoints:
  POST /search        {"query": str, "k": int=10} -> {"pids", "scores"}
  POST /search_batch  {"queries": [str], "k": int=10} -> {"pids", "scores"}
  GET  /health        -> {"ok": true, "n_passages": N}
  GET  /stats         -> batcher stats (queries, batches, max_batch_seen)

Every single-query request goes through the
:class:`~colbert_torch.serving.batcher.BatchingSearcher`, so concurrent
clients share batched searches. The reference has no serving layer
(README.md:179-190 roadmap).

Throughput through this front is bounded by the standard library's HTTP
server and its threads, not by the device; for performance-critical
fronts, call :class:`BatchingSearcher` in process. This module is the
wire-protocol reference.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from colbert_torch.serving.batcher import BatchingSearcher

__all__ = ["make_server", "serve"]


def make_server(searcher, host: str = "127.0.0.1", port: int = 8080,
                **batcher_kw) -> ThreadingHTTPServer:
    """-> a ready (not yet serving) ThreadingHTTPServer; call
    ``serve_forever()`` (or use :func:`serve`). ``server.batcher`` is the
    attached BatchingSearcher; ``server.shutdown()`` then
    ``server.batcher.close()`` to stop."""
    batcher = BatchingSearcher(searcher, **batcher_kw)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet; stats endpoint covers observability
            pass

        def _reply(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                n = len(searcher.doclens) if searcher.doclens is not None else 0
                self._reply(200, {"ok": True, "n_passages": int(n)})
            elif self.path == "/stats":
                self._reply(200, batcher.stats)
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                k = int(req.get("k", 10))
                if self.path == "/search":
                    pids, scores = batcher.search(str(req["query"]), k=k)
                    self._reply(200, {
                        "pids": np.asarray(pids).tolist(),
                        "scores": np.asarray(scores, np.float64).tolist(),
                    })
                elif self.path == "/search_batch":
                    out = batcher.search_many(
                        [str(q) for q in req["queries"]], k=k
                    )
                    self._reply(200, {
                        "pids": [np.asarray(p).tolist() for p, _ in out],
                        "scores": [
                            np.asarray(s, np.float64).tolist() for _, s in out
                        ],
                    })
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except KeyError as e:
                self._reply(400, {"error": f"missing field {e}"})
            except Exception as e:
                self._reply(500, {"error": repr(e)})

    class Server(ThreadingHTTPServer):
        # the standard library's default accept backlog (5) resets the
        # connections of a concurrent burst; batching fronts exist to
        # absorb such bursts
        request_queue_size = 1024
        daemon_threads = True

    server = Server((host, port), Handler)
    server.batcher = batcher
    return server


def serve(searcher, host: str = "127.0.0.1", port: int = 8080, **batcher_kw):
    """Blocking convenience entry point: serve until interrupted."""
    server = make_server(searcher, host, port, **batcher_kw)
    try:
        server.serve_forever()
    finally:
        server.shutdown()
        server.batcher.close()
