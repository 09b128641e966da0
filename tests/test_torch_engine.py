"""Serving: the port's SearchEngine, HashEmbedder, HTTP handler and
micro-batcher, held against the JAX package's on the CPU.

Both engines search the same indexes (built by the JAX package, carried
across with ``index_from_numpy``) with the same ids and embedder. Id
lists must be identical; scores agree to rtol=1e-5, atol=1e-5 (f32 sums
in another order).
"""

import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from abstracts_search_tpu.index.ivfpq import IVFPQIndex as JaxIVFPQ
from abstracts_search_tpu.models.registry import HashEmbedder as JaxHash
from abstracts_search_tpu.parallel import build_mesh
from abstracts_search_tpu.serve.engine import SearchEngine as JaxEngine
from abstracts_search_tpu_torch.index import index_from_numpy
from abstracts_search_tpu_torch.models.registry import HashEmbedder
from abstracts_search_tpu_torch.serve.app import make_handler
from abstracts_search_tpu_torch.serve.batcher import MicroBatcher
from abstracts_search_tpu_torch.serve.engine import SearchEngine

DIM = 24
QUERIES = ["subject 3", "subject 7", "document number 11", "updated work 2",
           "something else entirely"]


def _jax_index(x, n_lists):
    idx = JaxIVFPQ(n_lists, DIM, pq_m=4, pq_nbits=4, use_opq=False, mesh=build_mesh(),
                   seg_size=32, chunk=128, seed=0, scan_impl="map")
    idx.train(x, kmeans_iters=4, pq_iters=4)
    idx.fill(x)
    return idx


def _port(jidx):
    meta = {"n_lists": jidx.n_lists, "dim": jidx.dim, "pq_m": jidx.pq.m,
            "pq_nbits": jidx.pq.nbits, "use_opq": jidx.use_opq,
            "seg_size": jidx.seg_size, "spherical": jidx.spherical}
    return index_from_numpy(meta, jidx.kmeans.centroids, jidx.pq.centroids,
                            jidx.rotation, jidx.packed, device="cpu", chunk=jidx.chunk)


@pytest.fixture(scope="module")
def engines():
    emb = HashEmbedder(DIM)
    docs = [f"document number {i} about subject {i % 13}" for i in range(400)]
    ids = [f"https://openalex.org/W{i}" for i in range(400)]
    base = _jax_index(emb(docs), 8)
    # a delta: 20 updated works (same ids, new text) and 20 new ones
    ddocs = [f"updated work {i}" for i in range(20)] + \
        [f"new work {i} about subject {i % 5}" for i in range(20)]
    dids = ids[:20] + [f"https://openalex.org/W{400 + i}" for i in range(20)]
    # k-means needs as many rows as ksub per subspace: repeat the delta
    delta = _jax_index(np.concatenate([emb(ddocs)] * 8), 2)
    dids8 = dids * 8
    deltas_j = [(delta, dids8, set(dids))]
    deltas_t = [(_port(delta), dids8, set(dids))]
    return (JaxEngine(base, ids, JaxHash(DIM), nprobe=4),
            SearchEngine(_port(base), ids, emb, nprobe=4),
            deltas_j, deltas_t)


def _assert_rows_equal(got, want):
    assert [[r["id"] for r in row] for row in got] == \
        [[r["id"] for r in row] for row in want]
    np.testing.assert_allclose([r["score"] for row in got for r in row],
                               [r["score"] for row in want for r in row],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_delta", [False, True], ids=["base", "base+delta"])
def test_engine_matches_jax(engines, with_delta):
    jeng, teng, deltas_j, deltas_t = engines
    jeng.deltas = deltas_j if with_delta else []
    teng.deltas = deltas_t if with_delta else []
    try:
        _assert_rows_equal(teng.search_batch(QUERIES, k=7),
                           jeng.search_batch(QUERIES, k=7))
        for qtext in QUERIES[:2]:
            _assert_rows_equal([teng.search(qtext, k=5)], [jeng.search(qtext, k=5)])
        if with_delta:
            # newest-wins: an updated work serves from the delta
            rows = teng.search_batch(["updated work 2"], k=5)[0]
            assert rows[0]["id"] == "https://openalex.org/W2"
    finally:
        jeng.deltas, teng.deltas = [], []


def test_hash_embedder_is_bit_identical():
    texts = ["a", "semantic search", "ünïcödé", ""]
    np.testing.assert_array_equal(HashEmbedder(64)(texts), JaxHash(64)(texts))
    np.testing.assert_array_equal(HashEmbedder(64).queries(texts[:1]),
                                  JaxHash(64).queries(texts[:1]))
    assert HashEmbedder(8)([]).shape == (0, 8)


@pytest.fixture(scope="module")
def server(engines):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engines[1]))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    t.join(timeout=10)


def test_http_round_trip(server, engines):
    teng = engines[1]
    with urllib.request.urlopen(f"{server}/search?q=subject%203&k=4", timeout=60) as r:
        body = json.loads(r.read())
    assert r.status == 200
    _assert_rows_equal([body["results"]], [teng.search("subject 3", k=4)])
    req = urllib.request.Request(f"{server}/search", data=json.dumps(
        {"queries": QUERIES, "k": 3}).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        _assert_rows_equal(json.loads(r.read())["results"],
                           teng.search_batch(QUERIES, k=3))
    with urllib.request.urlopen(f"{server}/healthz", timeout=10) as r:
        assert json.loads(r.read()) == {"ok": True}
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{server}/search", timeout=10)
    assert e.value.code == 400


def test_micro_batcher_returns_engine_results(engines):
    teng = engines[1]
    mb = MicroBatcher(teng, window_s=0.02, workers=2)
    try:
        out = {}
        threads = [threading.Thread(target=lambda t=t: out.__setitem__(t, mb.search(t, 4)))
                   for t in QUERIES]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        # a batch and a single query may round the f32 products apart
        _assert_rows_equal([out[t] for t in QUERIES],
                           [teng.search(t, k=4) for t in QUERIES])
        assert mb.stats["requests"] == len(QUERIES)
    finally:
        mb.close()
    with pytest.raises(RuntimeError):
        mb.search("late", 4)
