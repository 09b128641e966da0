"""HTTP search service (stdlib http.server; no extra dependencies).

A minimal web page at ``/``, a JSON API at ``GET /search?q=...&k=10``,
batches at ``POST /search {"queries": [...], "k": 10}`` and a liveness
probe at ``/healthz``.
"""

from __future__ import annotations

import json
import logging
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..config import Config, load_config
from .engine import SearchEngine

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
                try:
                    k = int((qs.get("k") or ["10"])[0])
                    results = single(query, k=min(k, 100))
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
                k = min(int(body.get("k", 10)), 100)
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


def run_server(cfg: Config | None = None, *, engine: SearchEngine | None = None,
               embedder: str = "auto", device=None, host: str = "127.0.0.1",
               port: int = 7860, micro_batch: bool = True, micro_batch_workers: int = 4,
               on_bound=None) -> None:
    """Serve until ``server.shutdown()``. Without ``engine``, build it
    from ``cfg``'s artifact directory on ``device`` (the card by
    default; ``SearchEngine.from_artifacts``; ``cfg`` defaults to
    ``load_config()``). ``on_bound(server)`` is
    called once the socket is bound, e.g. to learn the port picked for
    ``port=0`` or to keep a handle for shutdown from another thread."""
    from .batcher import MicroBatcher

    if engine is None:
        cfg = cfg if cfg is not None else load_config()
        engine = SearchEngine.from_artifacts(cfg, index_dir=cfg.index_dir, embedder=embedder,
                                             device=device)
    batcher = (MicroBatcher(engine, workers=micro_batch_workers)
               if micro_batch else None)
    server = ThreadingHTTPServer((host, port), make_handler(engine, batcher))
    if on_bound is not None:
        on_bound(server)
    logger.info("serving on http://%s:%d%s", host, server.server_address[1],
                " (micro-batching)" if batcher else "")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        if batcher is not None:
            batcher.close()
