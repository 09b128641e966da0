"""k past the HTTP cap: the one-process engine serves any k, as the JAX
engine does; only an engine over a mesh caps k at ``MAX_K`` (100).

- ``search_batch`` at k 101 and 150 on a one-process CPU engine equals the
  JAX engine's answer (ids equal, scores within rtol=atol=1e-5, as in
  ``test_torch_engine.py``);
- ``astpu-torch search -k 150`` over artifacts exits 0 with 150 hits;
- an engine over a one-rank gloo mesh refuses k 101 before any
  collective and answers k 100.
"""

import json
import socket

import numpy as np
import pytest

from abstracts_search_tpu.models.registry import HashEmbedder as JaxHash
from abstracts_search_tpu.serve.engine import SearchEngine as JaxEngine
from abstracts_search_tpu_torch import cli
from abstracts_search_tpu_torch.driver import _write_ids_parquet
from abstracts_search_tpu_torch.index import IVFPQIndex
from abstracts_search_tpu_torch.models.registry import HashEmbedder
from abstracts_search_tpu_torch.parallel import init_distributed, shutdown_distributed
from abstracts_search_tpu_torch.serve.engine import MAX_K, SearchEngine

from test_torch_engine import DIM, QUERIES, _assert_rows_equal, _jax_index, _port

N = 400


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The JAX-built index, both engines over it, and the port's artifacts."""
    emb = HashEmbedder(DIM)
    docs = [f"document number {i} about subject {i % 13}" for i in range(N)]
    ids = [f"https://openalex.org/W{i}" for i in range(N)]
    jidx = _jax_index(emb(docs), 8)
    tidx = _port(jidx)
    root = tmp_path_factory.mktemp("k")
    tidx.save(root / "idx" / "index")
    _write_ids_parquet(root / "idx" / "ids.parquet", ids)
    (root / "env.json").write_text(json.dumps({"embed_dim": DIM, "index_dir": "idx",
                                               "index_storage": "device"}))
    return (JaxEngine(jidx, ids, JaxHash(DIM), nprobe=4),
            SearchEngine(tidx, ids, emb, nprobe=4), root)


@pytest.mark.parametrize("k", [MAX_K + 1, 150])
def test_one_process_engine_serves_k_past_the_cap_as_jax_does(built, k):
    jeng, teng, _ = built
    got = teng.search_batch(QUERIES, k=k)
    assert [len(row) for row in got] == [k] * len(QUERIES)
    _assert_rows_equal(got, jeng.search_batch(QUERIES, k=k))


def test_cli_search_takes_k_150(built, monkeypatch, capsys):
    monkeypatch.chdir(built[2])
    assert cli.main(["--device", "cpu", "search", "subject 3", "-k", "150", "--embedder",
                     "hash", "--no-hydrate"]) == 0
    hits = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert len(hits) == 150 and len({h["id"] for h in hits}) == 150


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_collective_engine_still_caps_k(built):
    root = built[2]
    mesh = init_distributed(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu", timeout_s=60)
    try:
        idx = IVFPQIndex.load(root / "idx" / "index", mesh=mesh)
        engine = SearchEngine(idx, built[1].ids, HashEmbedder(DIM), nprobe=4, mesh=mesh)
        q = engine.encode_queries(QUERIES)
        with pytest.raises(ValueError, match="over a mesh"):
            engine.search_batch_encoded(q, k=MAX_K + 1)
        assert engine.failed is None
        got = engine.search_batch_encoded(q, k=MAX_K)
        assert [len(row) for row in got] == [MAX_K] * len(QUERIES)
        np.testing.assert_array_equal(
            [[r["id"] for r in row] for row in got],
            [[r["id"] for r in row] for row in built[1].search_batch_encoded(q, k=MAX_K)])
        engine.stop_followers()
    finally:
        shutdown_distributed(mesh)
