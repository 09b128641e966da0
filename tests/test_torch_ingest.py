"""The port's ingest against the JAX package's.

- Manifest: parsing, partition names (percent-encoded ``file://`` URIs
  included), grouping and the changed-only manifest file are equal.
- Filter: ``filter_record`` and ``filter_works_lines`` equal the JAX
  package's on valid, dropped and malformed records; the port's native
  filter (built into ``build/native/``, never under ``cpp/``) keeps the
  same records as its Python filter.
- Sync: over a ``file://`` manifest of gzipped part files, the port
  ingests the same partitions as the JAX package, stamps them, stores
  the same rows bit for bit (hash embedder: the same vectors in both
  packages), reports its ``rows``/``embed_s``/``stall_s``, and a re-run
  is a no-op; native and Python filters give the same store.
"""

import gzip
import json
import sqlite3

import numpy as np
import pytest

from abstracts_search_tpu.ingest import manifest as jman
from abstracts_search_tpu.ingest import oa_filter as jfilt
from abstracts_search_tpu.ingest import sync as jsync
from abstracts_search_tpu.models.registry import HashEmbedder as JaxHash
from abstracts_search_tpu.storage.sqlite_store import init_store as jinit
from abstracts_search_tpu_torch.ingest import manifest as tman
from abstracts_search_tpu_torch.ingest import oa_filter as tfilt
from abstracts_search_tpu_torch.ingest import sync as tsync
from abstracts_search_tpu_torch.models.registry import HashEmbedder
from abstracts_search_tpu_torch.storage.sqlite_store import init_store

DIM = 16
RECORDS = [
    {"id": "https://openalex.org/W1", "title": "T", "language": "en",
     "abstract_inverted_index": {"a": [0, 2], "b": [1]}},
    {"id": "https://openalex.org/W2", "title": None, "abstract_inverted_index": {"x": [0]}},
    {"id": "https://openalex.org/W3", "language": "de", "abstract_inverted_index": {"x": [0]}},
    {"id": "https://openalex.org/W4", "language": None, "abstract_inverted_index": {"x": [0]}},
    {"id": "https://openalex.org/W5", "language": "en", "abstract_inverted_index": None},
    {"id": "https://openalex.org/W6", "language": "en", "abstract_inverted_index": {}},
    {"id": "https://openalex.org/W7", "abstract_inverted_index": {"": [0], "w": [3]}},
    {"id": "", "abstract_inverted_index": {"x": [0]}},
    {"id": "https://openalex.org/W9", "title": "Ünïcødé \"q\"",
     "abstract_inverted_index": {"é": [1], "\\n": [0], "z": [-1, 5]}},
    {"id": "https://openalex.org/W10", "abstract_inverted_index": {"dup": [0], "dup2": [0]}},
]


@pytest.mark.parametrize("rec", RECORDS, ids=lambda r: r["id"][-3:] or "noid")
def test_filter_record_equals_jax(rec):
    assert tfilt.filter_record(rec) == jfilt.filter_record(rec)


def lines():
    out = [json.dumps(r) for r in RECORDS]
    out += ["", "not json", "null", "[1, 2]", '{"id": "W", "abstract_inverted_index": ',
            json.dumps(RECORDS[0], ensure_ascii=False)]
    return out


def test_filter_lines_equal_jax_and_native():
    py = list(tfilt.filter_works_lines(lines()))
    assert py == list(jfilt.filter_works_lines(lines()))
    assert [r["id"][-2:] for r in py] == ["W1", "W2", "W7", "W9", "10", "W1"]
    with tfilt.OaJsonlFilter() as f:
        assert f.filter_text("\n".join(lines()) + "\n") == py
    native = [r for batch in tfilt.filter_stream_native(
        [("\n".join(lines()) + "\n").encode()[i:i + 7] for i in range(0, 4000, 7)],
        batch_size=2) for r in batch]
    assert native == py


def test_native_filter_builds_outside_cpp():
    cpp = tfilt.SOURCE.parent
    before = sorted((p.name, p.stat().st_mtime_ns) for p in cpp.iterdir())
    binary = tfilt.ensure_filter_built()
    assert binary.parent == tfilt.BUILD_DIR and binary.exists()
    assert tfilt.ensure_filter_built() == binary
    assert sorted((p.name, p.stat().st_mtime_ns) for p in cpp.iterdir()) == before


def test_manifest_equals_jax(tmp_path):
    urls = ["s3://b/works/updated_date=2024-02-01/part_001.gz",
            "file:///x/works/updated_date%3D2024-01-01/part_000.gz",
            "s3://b/works/updated_date=2024-02-01/part_000.gz", "s3://b/works/manifest"]
    raw = json.dumps({"entries": [{"url": u} for u in urls]}).encode()
    assert tman.parse_manifest(raw) == jman.parse_manifest(raw)
    assert tman.fetch_manifest("u", lambda u: raw) == jman.fetch_manifest("u", lambda u: raw)
    assert [tman.partition_of(u) for u in urls] == [jman.partition_of(u) for u in urls]
    assert tman.group_by_partition(urls) == jman.group_by_partition(urls)
    p = tmp_path / "manifest.txt"
    assert tman.update_manifest_file(p, sorted(urls))
    assert not tman.update_manifest_file(p, sorted(urls))
    assert not jman.update_manifest_file(p, sorted(urls))
    assert tman.update_manifest_file(p, [])


def work(i, date, rng):
    n = int(rng.integers(3, 12))
    inv = {}
    for pos, w in enumerate(f"w{j}" for j in rng.integers(0, 50, n)):
        inv.setdefault(w, []).append(pos)
    return {"id": f"https://openalex.org/W{date}x{i}", "title": f"Study {i}",
            "language": "en" if i % 9 else "fr", "abstract_inverted_index": inv}


def snapshot(root, dates_counts, seed=0):
    """Gzipped part files (two per partition, the second of two gzip
    members) and a file:// manifest."""
    rng = np.random.default_rng(seed)
    entries = []
    for date, n in dates_counts:
        pdir = root / "snapshot" / f"updated_date={date}"
        pdir.mkdir(parents=True, exist_ok=True)
        recs = [json.dumps(work(i, date, rng)) for i in range(n)]
        half = n // 2
        (pdir / "part_000.gz").write_bytes(gzip.compress(("\n".join(recs[:half]) + "\n")
                                                         .encode()))
        (pdir / "part_001.gz").write_bytes(
            gzip.compress(("\n".join(recs[half:half + 3]) + "\n").encode())
            + gzip.compress(("\n".join(recs[half + 3:]) + "\n").encode()))
        entries += [{"url": (pdir / f).as_uri()} for f in ("part_000.gz", "part_001.gz")]
    (root / "manifest.json").write_text(json.dumps({"entries": entries}))
    return (root / "manifest.json").as_uri()


def store_rows(path):
    with sqlite3.connect(path) as c:
        return c.execute("SELECT id, embedding, rev FROM works ORDER BY id").fetchall()


def test_hash_embedders_agree():
    texts = ["a b c", "Study 3 w1 w2", ""]
    np.testing.assert_array_equal(HashEmbedder(DIM)(texts), JaxHash(DIM)(texts))


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_sync_equals_jax(tmp_path, native):
    url = snapshot(tmp_path, [("2024-01-01", 30), ("2024-02-01", 17)])
    urls = tman.fetch_manifest(url, tman.default_fetcher)
    res = {}
    for name, mod, init, emb in (("jax", jsync, jinit, JaxHash(DIM)),
                                 ("port", tsync, init_store, HashEmbedder(DIM))):
        st = init(tmp_path / f"{name}.sqlite")
        st.bump_rev()
        state = mod.SyncState(tmp_path / f"events_{name}")
        kw = {"stats": {}} if name == "port" else {}
        got = mod.sync(urls, state, emb, st, batch_size=8, use_native_filter=native, **kw)
        again = mod.sync(urls, state, emb, st, batch_size=8, use_native_filter=native)
        st.close()
        res[name] = (got, again, state.completed(), kw.get("stats"))
    (jg, ja, jdone, _), (tg, ta, tdone, stats) = res["jax"], res["port"]
    assert tg == jg and sum(tg.values()) > 0
    assert ta == ja == {} and tdone == jdone == sorted(tg)
    assert store_rows(tmp_path / "port.sqlite") == store_rows(tmp_path / "jax.sqlite")
    assert {p: s["rows"] for p, s in stats.items()} == tg
    assert all(s["embed_s"] >= 0 and s["stall_s"] >= 0 for s in stats.values())


def test_sync_owner_split_equals_jax(tmp_path):
    url = snapshot(tmp_path, [("2024-01-01", 6), ("2024-02-01", 6), ("2024-03-01", 6)])
    urls = tman.fetch_manifest(url, tman.default_fetcher)
    for pid in (0, 1):
        out = []
        for name, mod, init, emb in (("jax", jsync, jinit, JaxHash(DIM)),
                                     ("port", tsync, init_store, HashEmbedder(DIM))):
            st = init(tmp_path / f"{name}{pid}.sqlite")
            out.append(mod.sync(urls, mod.SyncState(tmp_path / f"ev_{name}{pid}"), emb, st,
                                owner=(pid, 2), use_native_filter=False))
            st.close()
        assert out[0] == out[1] and out[0]


def test_gunzip_stream_equals_jax():
    blob = gzip.compress(b"one\ntwo\n") + gzip.compress(b"three\n") + gzip.compress(b"")
    chunks = [blob[i:i + 5] for i in range(0, len(blob), 5)]
    assert b"".join(tsync._gunzip_stream(chunks)) == b"".join(jsync._gunzip_stream(chunks)) \
        == b"one\ntwo\nthree\n"
