"""The engine as a deployment starts it: ``SearchEngine.from_artifacts``
and ``run_server(cfg)`` over one artifact directory, held against the
JAX package's on the CPU.

The directory holds what a fill and a tune leave: ``index/`` (built by
the JAX package), ``ids.parquet`` with the sidecar the port's
``build_sidecar`` writes, ``params.json`` at nprobe 3 (not the default
16) and one delta sub-index whose ids supersede 20 base works. Both
engines must return identical ids, scores within rtol=1e-5, atol=1e-5,
and equal hydrated fields from one stub fetcher (no network).
"""

import json
import logging
import shutil
import threading
import time
import urllib.parse
import urllib.request

import numpy as np
import pytest

from abstracts_search_tpu.config import Config as JaxConfig
from abstracts_search_tpu.driver import compaction_due as jax_compaction_due
from abstracts_search_tpu.index.ivfpq import IVFPQIndex as JaxIVFPQ
from abstracts_search_tpu.index.tune import read_params as jax_read_params
from abstracts_search_tpu.parallel import build_mesh
from abstracts_search_tpu.serve.engine import SearchEngine as JaxEngine
from abstracts_search_tpu.serve.hydrate import OpenAlexClient as JaxClient
from abstracts_search_tpu.storage.idmap import IdMap as JaxIdMap
from abstracts_search_tpu.utils.trace import StageTimer as JaxStageTimer
from abstracts_search_tpu_torch.config import Config
from abstracts_search_tpu_torch.driver import compaction_due
from abstracts_search_tpu_torch.index.tune import read_params, write_params
from abstracts_search_tpu_torch.models.registry import HashEmbedder, get_embedder
from abstracts_search_tpu_torch.serve import hydrate
from abstracts_search_tpu_torch.serve.engine import SearchEngine
from abstracts_search_tpu_torch.storage.idmap import (IdMap, _footer_fingerprint,
                                                      build_sidecar)
from abstracts_search_tpu_torch.utils.trace import StageTimer, profile_scope

DIM = 24
QUERIES = ["subject 3", "subject 7", "document number 11", "updated work 2",
           "something else entirely"]


def _ids(n, base=0):
    return [f"https://openalex.org/W{base + i}" for i in range(n)]


def _write_ids(path, ids, groups=(100, 150)):
    """ids.parquet in uneven row groups (the last takes the rest)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    with pq.ParquetWriter(path, pa.schema([pa.field("id", pa.string())])) as w:
        lo = 0
        for size in (*groups, len(ids)):
            if lo < len(ids):
                w.write_table(pa.table({"id": pa.array(ids[lo:lo + size])}))
            lo += size


def _jax_index(x, n_lists):
    idx = JaxIVFPQ(n_lists, DIM, pq_m=4, pq_nbits=4, use_opq=False, mesh=build_mesh(),
                   seg_size=32, chunk=128, seed=0)
    idx.train(x, kmeans_iters=4, pq_iters=4)
    idx.fill(x)
    return idx


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_artifacts")
    emb = HashEmbedder(DIM)
    docs = [f"document number {i} about subject {i % 13}" for i in range(400)]
    _jax_index(emb(docs), 8).save(root / "index")
    _write_ids(root / "ids.parquet", _ids(400))
    build_sidecar(root / "ids.parquet")
    write_params(root / "params.json", {"nprobe": 3, "k": 10})
    # a delta: 20 updated works (same ids, new text) and 20 new ones,
    # repeated so k-means has ksub rows per subspace
    ddocs = [f"updated work {i}" for i in range(20)] + \
        [f"new work {i} about subject {i % 5}" for i in range(20)]
    dids = (_ids(20) + _ids(20, base=400)) * 8
    ddir = root / "delta" / "0001"
    _jax_index(np.concatenate([emb(ddocs)] * 8), 2).save(ddir / "index")
    _write_ids(ddir / "ids.parquet", dids)
    return root


class StubFetcher:
    """The OpenAlex works API for ids W<n>: a title, year and author per
    id; counts its calls. No network."""

    def __init__(self):
        self.urls = []

    def __call__(self, url: str) -> bytes:
        self.urls.append(url)
        flt = urllib.parse.parse_qs(urllib.parse.urlparse(url).query)["filter"][0]
        short = flt.split(":", 1)[1].split("|")
        return json.dumps({"results": [
            {"id": f"https://openalex.org/{s}", "title": f"Title of {s}",
             "publication_year": 1990 + int(s[1:]) % 30, "doi": None,
             "authorships": [{"author": {"display_name": f"Author {s}"}}]}
            for s in short]}).encode()


def _engines(art, storage="auto", hot=1 << 30, **cfg_kw):
    fetcher = StubFetcher()
    kw = dict(index_dir=str(art), embed_dim=DIM, index_storage=storage,
              index_hot_bytes=hot, **cfg_kw)
    jeng = JaxEngine.from_artifacts(JaxConfig(**kw), index_dir=art, embedder="hash",
                                    hydrate=True, fetcher=fetcher, warmup=False)
    teng = SearchEngine.from_artifacts(Config(**kw), index_dir=art, embedder="hash",
                                       hydrate=True, fetcher=fetcher, warmup=False,
                                       device="cpu")
    return jeng, teng, fetcher


def _assert_rows_equal(got, want):
    assert [[r["id"] for r in row] for row in got] == \
        [[r["id"] for r in row] for row in want]
    np.testing.assert_allclose([r["score"] for row in got for r in row],
                               [r["score"] for row in want for r in row],
                               rtol=1e-5, atol=1e-5)
    strip = lambda rows: [[{k: v for k, v in r.items() if k != "score"}  # noqa: E731
                           for r in row] for row in rows]
    assert strip(got) == strip(want)


@pytest.mark.parametrize("storage,hot", [("auto", 1 << 30), ("host", 0), ("hybrid", 400)],
                         ids=["auto", "host", "hybrid"])
def test_from_artifacts_matches_jax(art, storage, hot):
    jeng, teng, fetcher = _engines(art, storage, hot)
    assert teng.nprobe == jeng.nprobe == 3                 # from params.json
    assert teng.index.storage == ("device" if storage == "auto" else storage)
    assert teng.ids.uses_sidecar and len(teng.deltas) == len(jeng.deltas) == 1
    assert teng.deltas[0][2] == jeng.deltas[0][2]          # the delta's id set
    _assert_rows_equal(teng.search_batch(QUERIES, k=7), jeng.search_batch(QUERIES, k=7))
    for q in QUERIES[:3]:
        got, want = teng.search(q, k=5), jeng.search(q, k=5)
        _assert_rows_equal([got], [want])
        assert all(r["title"] == "Title of " + r["id"].rsplit("/", 1)[1] for r in got)
    # newest-wins: an updated work serves from the delta
    assert teng.search("updated work 2", k=5)[0]["id"] == "https://openalex.org/W2"
    # the micro-batcher's path hydrates too, in one fetch per 50 ids
    rows = teng.search_batch_encoded(teng.encode_queries(QUERIES), k=10)
    n = len(fetcher.urls)
    teng.hydrate_rows(rows)
    assert len(fetcher.urls) - n == -(-sum(map(len, rows)) // 50)
    assert all("title" in r for row in rows for r in row)


@pytest.mark.parametrize("frac,warned", [(0.10, True), (10.0, False)])
def test_compaction_warning_in_both(art, caplog, frac, warned):
    """320 delta rows against 400 base rows cross a 10% policy."""
    with caplog.at_level(logging.WARNING):
        _engines(art, compact_max_delta_frac=frac)
    msgs = {(r.name.split(".")[0], r.getMessage()) for r in caplog.records
            if "compaction policy" in r.getMessage()}
    assert {m[0] for m in msgs} == ({"abstracts_search_tpu", "abstracts_search_tpu_torch"}
                                    if warned else set())
    assert len({m[1] for m in msgs}) <= 1                 # the same text
    if warned:
        assert "astpu index compact" in next(iter(msgs))[1]


def test_from_artifacts_without_params_uses_nprobe_16(art, tmp_path):
    bare = tmp_path / "bare"
    shutil.copytree(art / "index", bare / "index")
    for f in ("ids.parquet", "ids.bin", "ids.off", "ids.sidecar.json"):
        shutil.copy(art / f, bare / f)
    eng = SearchEngine.from_artifacts(Config(index_dir=str(bare), embed_dim=DIM),
                                      index_dir=bare, embedder="hash", hydrate=False,
                                      warmup=False, device="cpu")
    assert eng.nprobe == 16 and eng.deltas == [] and eng.hydrator is None
    with pytest.raises(FileNotFoundError):
        SearchEngine.from_artifacts(Config(), index_dir=tmp_path / "none", device="cpu")


@pytest.mark.parametrize("sidecar", [True, False], ids=["sidecar", "parquet"])
def test_idmap_matches_jax(art, sidecar):
    path = art / "ids.parquet"
    t = IdMap(path, prefer_sidecar=sidecar, cache_groups=2)
    j = JaxIdMap(path, prefer_sidecar=sidecar, cache_groups=2)
    assert t.uses_sidecar == j.uses_sidecar == sidecar and len(t) == len(j) == 400
    pos = np.random.default_rng(0).integers(0, 400, 300)
    assert t.resolve(pos) == j.resolve(pos) == [f"https://openalex.org/W{p}" for p in pos]
    assert [t[i] for i in (0, 99, 100, 399)] == [j[i] for i in (0, 99, 100, 399)]
    if not sidecar:
        assert t.cached_groups == j.cached_groups == 2
    with pytest.raises(IndexError):
        t.resolve([0, 400])
    assert t.resolve([]) == []


def test_sidecar_binds_the_parquet_as_the_jax_one_does(art, tmp_path):
    """The port's build_sidecar writes what the JAX IdMap trusts, byte
    for byte what the JAX build_sidecar writes."""
    from abstracts_search_tpu.storage.idmap import build_sidecar as jax_build_sidecar

    path = tmp_path / "ids.parquet"
    shutil.copy(art / "ids.parquet", path)
    jax_build_sidecar(path)
    want = {f: (tmp_path / f).read_bytes() for f in ("ids.bin", "ids.off", "ids.sidecar.json")}
    build_sidecar(path, force=True)
    assert {f: (tmp_path / f).read_bytes() for f in want} == want
    assert JaxIdMap(path).uses_sidecar and IdMap(path).uses_sidecar


def test_truncated_parquet_makes_the_sidecar_stale(art, tmp_path, monkeypatch, caplog):
    """A parquet cut short after the reader opened it: its footer length
    points past the file. The port ignores the sidecar (with the JAX
    package's warning) instead of raising."""
    import pyarrow.parquet as pq

    for f in ("ids.parquet", "ids.bin", "ids.off", "ids.sidecar.json"):
        shutil.copy(art / f, tmp_path / f)
    path = tmp_path / "ids.parquet"
    tail = path.read_bytes()[-8:]
    real = pq.ParquetFile

    def open_then_truncate(p, *a, **kw):
        pf = real(p, *a, **kw)
        path.write_bytes(tail)          # footer length 4 + "PAR1", nothing else
        return pf

    monkeypatch.setattr(pq, "ParquetFile", open_then_truncate)
    with caplog.at_level(logging.WARNING):
        m = IdMap(path)
    assert not m.uses_sidecar and len(m) == 400
    assert any("ignoring it" in r.getMessage() for r in caplog.records)
    assert _footer_fingerprint(path) is None
    from abstracts_search_tpu.storage.idmap import _footer_fingerprint as jax_fp

    with pytest.raises(OSError):                    # what the port repairs
        jax_fp(path)


def test_run_server_builds_from_artifacts(art, monkeypatch):
    from abstracts_search_tpu_torch.serve.app import run_server

    fetcher = StubFetcher()
    monkeypatch.setattr(hydrate, "_default_fetcher", fetcher)
    cfg = Config(index_dir=str(art), embed_dim=DIM)
    box = []
    th = threading.Thread(target=run_server, args=(cfg,), kwargs=dict(
        device="cpu", port=0, on_bound=box.append, micro_batch_workers=1), daemon=True)
    th.start()
    deadline = time.monotonic() + 120
    while not box and time.monotonic() < deadline:
        time.sleep(0.05)
    assert box, "the server never bound"
    try:
        url = f"http://127.0.0.1:{box[0].server_address[1]}"
        with urllib.request.urlopen(f"{url}/search?q=subject%203&k=4", timeout=60) as r:
            body = json.loads(r.read())
        assert r.status == 200 and len(body["results"]) == 4
        assert all(x["title"] == "Title of " + x["id"].rsplit("/", 1)[1]
                   for x in body["results"])
        assert fetcher.urls
    finally:
        box[0].shutdown()
        th.join(timeout=30)


def test_stage_timer_report_has_the_jax_shape(tmp_path):
    reports = []
    for timer in (StageTimer(), JaxStageTimer()):
        with timer.stage("encode", batch=4):
            pass
        with pytest.raises(KeyError):
            with timer.stage("probe"):
                raise KeyError("x")
        reports.append(timer.report())
    shape = lambda rep: ([sorted(s) for s in rep["stages"]], sorted(rep))  # noqa: E731
    assert shape(reports[0]) == shape(reports[1])
    assert [s["stage"] for s in reports[0]["stages"]] == ["encode", "probe"]
    assert reports[0]["stages"][1]["error"] == reports[1]["stages"][1]["error"]
    timer.write(tmp_path / "r" / "report.json")
    assert json.loads((tmp_path / "r" / "report.json").read_text())["stages"]


def test_profile_scope_writes_a_chrome_trace_only_when_asked(tmp_path, monkeypatch):
    import torch

    monkeypatch.delenv("ASTPU_PROFILE", raising=False)
    with profile_scope("off"):
        torch.ones(4).sum()
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv("ASTPU_PROFILE", str(tmp_path))
    with profile_scope("search"):
        torch.ones(4).sum()
    trace = json.loads((tmp_path / "search" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_auto_embedder_falls_back_to_hash(caplog):
    with caplog.at_level(logging.WARNING):
        emb = get_embedder("auto", Config(embed_dim=DIM))
    assert isinstance(emb, HashEmbedder) and emb.dim == DIM
    assert any("falling back to hash embedder" in r.getMessage() for r in caplog.records)
    with pytest.raises(NotImplementedError):
        get_embedder("stella", Config())
    with pytest.raises(ValueError):
        get_embedder("bogus", Config())


@pytest.mark.parametrize("base,delta,n,frac,maxd", [
    (1000, 0, 0, 0.1, 4), (1000, 100, 1, 0.1, 4), (1000, 101, 1, 0.1, 4),
    (1000, 5, 5, 0.1, 4), (0, 1, 1, 0.1, 4), (10**6, 10, 4, 0.1, 4)])
def test_compaction_due_matches_jax(base, delta, n, frac, maxd):
    assert compaction_due(base, delta, n, max_frac=frac, max_deltas=maxd) == \
        jax_compaction_due(base, delta, n, max_frac=frac, max_deltas=maxd)


def test_params_round_trip(tmp_path):
    p = tmp_path / "sub" / "params.json"
    write_params(p, {"nprobe": 24, "k": 10, "achieved_recall": 0.95})
    assert read_params(p) == jax_read_params(p) == {"nprobe": 24, "k": 10,
                                                     "achieved_recall": 0.95}


def test_openalex_client_matches_jax_in_batches_of_50(caplog):
    ids = _ids(120, base=7)
    outs = []
    for client_cls in (hydrate.OpenAlexClient, JaxClient):
        f = StubFetcher()
        outs.append(client_cls(f).get_works(ids))
        assert [len(urllib.parse.parse_qs(urllib.parse.urlparse(u).query)["filter"][0]
                    .split("|")) for u in f.urls] == [50, 50, 20]
    assert outs[0] == outs[1] and len(outs[0]) == 120

    def failing(url):
        raise OSError("offline")

    with caplog.at_level(logging.WARNING):
        assert hydrate.OpenAlexClient(failing).get_works(ids[:3]) == {}
    assert any("hydration failed" in r.getMessage() for r in caplog.records)
