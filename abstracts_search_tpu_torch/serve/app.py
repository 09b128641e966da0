"""HTTP search service (stdlib http.server; no extra dependencies).

A minimal web page at ``/``, a JSON API at ``GET /search?q=...&k=10``,
batches at ``POST /search {"queries": [...], "k": 10}`` and a liveness
probe at ``/healthz``. Over a mesh the server lives on rank 0 and the
other ranks follow its searches (``run_server``).
"""

from __future__ import annotations

import json
import logging
import signal
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..config import Config, load_config
from .engine import MAX_K, SearchEngine

logger = logging.getLogger(__name__)

_PAGE = """<!doctype html>
<html><head><title>abstracts-search</title>
<style>body{font-family:sans-serif;max-width:50em;margin:2em auto}
input{width:70%;padding:.5em}button{padding:.5em 1em}
li{margin:.6em 0}</style></head>
<body><h2>abstracts-search</h2>
<form onsubmit="go();return false"><input id=q placeholder="search abstracts...">
<button>Search</button></form><ol id=out></ol>
<script>
async function go(){
  const q=document.getElementById('q').value;
  const r=await fetch('/search?q='+encodeURIComponent(q));
  const d=await r.json();
  const out=document.getElementById('out');
  out.replaceChildren();
  for(const x of d.results){
    // metadata is third-party content: build nodes with textContent
    // (no raw HTML injection) and only link http(s) ids
    const li=document.createElement('li');
    const a=document.createElement('a');
    if(/^https?:[/][/]/.test(x.id)) a.href=x.id;
    a.textContent=x.title||x.id;
    const small=document.createElement('small');
    small.textContent=' ('+x.score.toFixed(3)+
      (x.publication_year?', '+x.publication_year:'')+')';
    li.append(a, small);
    out.append(li);
  }
}
</script></body></html>"""


def _parse_k(raw) -> int | None:
    """A request's k, capped at ``MAX_K``; None unless an integer >= 1."""
    try:
        k = int(raw)
    except (TypeError, ValueError):
        return None
    return min(k, MAX_K) if k >= 1 else None


def make_handler(engine: SearchEngine, batcher=None):
    """``batcher``: optional MicroBatcher — concurrent GET /search
    requests fold into one batched search (serve/batcher.py)."""
    single = batcher.search if batcher is not None else engine.search

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            url = urllib.parse.urlparse(self.path)
            if url.path == "/":
                self._send(200, _PAGE.encode(), "text/html")
            elif url.path == "/search":
                qs = urllib.parse.parse_qs(url.query)
                query = (qs.get("q") or [""])[0]
                if not query:
                    self._send(400, b'{"error":"missing q"}', "application/json")
                    return
                k = _parse_k((qs.get("k") or ["10"])[0])
                if k is None:
                    self._send(400, b'{"error":"k must be an integer >= 1"}', "application/json")
                    return
                try:
                    results = single(query, k=k)
                    body = json.dumps({"query": query, "results": results}).encode()
                    self._send(200, body, "application/json")
                except Exception as e:
                    logger.exception("search failed")
                    self._send(500, json.dumps({"error": str(e)}).encode(),
                               "application/json")
            elif url.path == "/healthz":
                self._send(200, b'{"ok":true}', "application/json")
            else:
                self._send(404, b'{"error":"not found"}', "application/json")

        def do_POST(self):  # noqa: N802 (http.server API)
            url = urllib.parse.urlparse(self.path)
            if url.path != "/search":
                self._send(404, b'{"error":"not found"}', "application/json")
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(length) or b"{}")
                queries = body.get("queries")
                if (not isinstance(queries, list) or not queries
                        or not all(isinstance(q, str) for q in queries)):
                    self._send(400, b'{"error":"queries must be a list of strings"}',
                               "application/json")
                    return
                k = _parse_k(body.get("k", 10))
                if k is None:
                    self._send(400, b'{"error":"k must be an integer >= 1"}', "application/json")
                    return
                results = engine.search_batch(queries[:256], k=k)
                self._send(200, json.dumps({"results": results}).encode(),
                           "application/json")
            except Exception as e:
                logger.exception("batch search failed")
                self._send(500, json.dumps({"error": str(e)}).encode(),
                           "application/json")

        def log_message(self, fmt, *args):
            logger.info("%s " + fmt, self.client_address[0], *args)

    return Handler


def stop_on_signals(server) -> None:
    """Shut ``server`` down on SIGTERM or SIGINT, so that ``run_server``
    ends through its ``finally`` (the batcher closes, a mesh's followers
    stop) and returns. Call from the main thread, e.g. as ``on_bound``."""
    def handler(signum, frame):
        threading.Thread(target=server.shutdown, daemon=True).start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, handler)


def run_server(cfg: Config | None = None, *, engine: SearchEngine | None = None,
               embedder: str = "auto", device=None, mesh=None, host: str = "127.0.0.1",
               port: int = 7860, micro_batch: bool = True, micro_batch_workers: int = 4,
               on_bound=None) -> None:
    """Serve until ``server.shutdown()``. Without ``engine``, build it
    from ``cfg``'s artifact directory on ``device`` (the card by
    default) or on this rank of ``mesh``, the ``embedder`` beside the
    index on that device (``SearchEngine.from_artifacts``; ``cfg``
    defaults to ``load_config()``). ``on_bound(server)`` is
    called once the socket is bound, e.g. to learn the port picked for
    ``port=0`` or to keep a handle for shutdown from another thread.

    Over a mesh (the engine's) every rank calls this: the HTTP server,
    the micro-batcher and the id map live on rank 0, which pings idle
    followers within the collective timeout and stops them when it ends;
    the other ranks run the engine's follower loop. A failed collective
    shuts the server down and raises."""
    from .batcher import MicroBatcher

    if engine is None:
        cfg = cfg if cfg is not None else load_config()
        engine = SearchEngine.from_artifacts(cfg, index_dir=cfg.index_dir, embedder=embedder,
                                             device=device, mesh=mesh)
    mesh = engine.mesh
    collective = mesh is not None and mesh.collective
    if collective and mesh.rank != 0:
        engine.follow()
        return
    batcher = (MicroBatcher(engine, workers=micro_batch_workers)
               if micro_batch else None)
    server = ThreadingHTTPServer((host, port), make_handler(engine, batcher))
    stop = threading.Event()
    if collective:
        engine.on_failure = lambda: threading.Thread(target=server.shutdown,
                                                     daemon=True).start()
        threading.Thread(target=engine.keep_followers_alive, args=(stop, mesh.timeout_s / 4),
                         name="astpu-mesh-keepalive", daemon=True).start()
    if on_bound is not None:
        on_bound(server)
    logger.info("serving on http://%s:%d%s", host, server.server_address[1],
                " (micro-batching)" if batcher else "")
    try:
        server.serve_forever()
    finally:
        stop.set()
        server.server_close()
        if batcher is not None:
            batcher.close()
        engine.stop_followers()
    if engine.failed is not None:
        raise RuntimeError(f"a rank of the mesh failed: {engine.failed}")
