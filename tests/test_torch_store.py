"""The port's SQLite store and parquet shards against the JAX package's.

- Store: the same upserts through either package give the same rows
  (bit for bit), the same revision stamps and watermarks, and either
  package opens the other's file.
- Shards: the port's dump equals the JAX package's file for file: ids,
  embeddings (bit for bit), schema, row-group layout and the dump meta;
  either reader reads the other's shards; ``sample`` draws the same rows;
  ``load_shards_to_store`` restores the same rows.
"""

import json

import numpy as np
import pyarrow.parquet as pq
import pytest

from abstracts_search_tpu.storage import shards as jshards
from abstracts_search_tpu.storage import sqlite_store as jstore
from abstracts_search_tpu_torch.storage import shards as tshards
from abstracts_search_tpu_torch.storage import sqlite_store as tstore

DIM = 12


def rows(seed, n, prefix="W"):
    rng = np.random.default_rng(seed)
    ids = [f"https://openalex.org/{prefix}{i:04d}" for i in rng.permutation(n)]
    return ids, rng.standard_normal((n, DIM)).astype(np.float32)


def fill_store(mod, path):
    """Two sync generations, with an update of existing ids in the second."""
    st = mod.init_store(path)
    st.bump_rev()
    st.upsert(*rows(0, 50))
    st.bump_rev()
    ids, e = rows(1, 20)
    st.upsert(ids, e)                  # 20 of the 50 ids, new vectors
    st.upsert(*rows(2, 7, prefix="X"))
    return st


def dump_rows(st, **kw):
    out = []
    for ids, e in st.iter_batches(batch_size=16, **kw):
        out += [(i, r.tobytes()) for i, r in zip(ids, e)]
    return out


@pytest.mark.parametrize("min_rev", [None, 1, 2, 3])
def test_store_rows_equal_jax(tmp_path, min_rev):
    a = fill_store(jstore, tmp_path / "jax.sqlite")
    b = fill_store(tstore, tmp_path / "port.sqlite")
    assert len(a) == len(b) == 57
    assert (a.dim, a.sync_rev) == (b.dim, b.sync_rev) == (DIM, 2)
    assert dump_rows(a, min_rev=min_rev) == dump_rows(b, min_rev=min_rev)
    for w in (0, 1, 2):
        assert a.count_since(w) == b.count_since(w)
    assert np.array_equal(a.get(rows(1, 20)[0][3]), b.get(rows(1, 20)[0][3]))
    assert b.get("missing") is None
    a.close()
    b.close()


def test_store_files_open_across_packages(tmp_path):
    fill_store(jstore, tmp_path / "jax.sqlite").close()
    fill_store(tstore, tmp_path / "port.sqlite").close()
    with tstore.EmbeddingStore(tmp_path / "jax.sqlite") as p, \
            jstore.EmbeddingStore(tmp_path / "port.sqlite") as j:
        assert dump_rows(p) == dump_rows(j)
        assert p.sync_rev == j.sync_rev == 2


def test_store_guards(tmp_path):
    with pytest.raises(FileNotFoundError):
        tstore.EmbeddingStore(tmp_path / "none.sqlite")
    st = tstore.init_store(tmp_path / "s.sqlite")
    with pytest.raises(FileExistsError):
        tstore.init_store(tmp_path / "s.sqlite")
    st.upsert(*rows(0, 3))
    with pytest.raises(ValueError, match="dim mismatch"):
        st.upsert(["a"], np.zeros((1, DIM + 1), np.float32))
    with pytest.raises(ValueError, match="bad embeddings shape"):
        st.upsert(["a", "b"], np.zeros((1, DIM), np.float32))
    st.close()


def shard_layout(d):
    out = {}
    for p in sorted(d.glob("data_*.parquet")):
        f = pq.ParquetFile(p)
        t = f.read()
        out[p.name] = {
            "schema": str(f.schema_arrow),
            "groups": [f.metadata.row_group(i).num_rows for i in range(f.num_row_groups)],
            "ids": t.column("id").to_pylist(),
            "emb": np.asarray(t.column("embedding").combine_chunks().flatten()).tobytes(),
        }
    return out


@pytest.mark.parametrize("shard_size,row_group_size", [(64, 16), (20, 8), (1000, 64)])
def test_dump_equals_jax(tmp_path, shard_size, row_group_size):
    st = fill_store(tstore, tmp_path / "s.sqlite")
    nj = jshards.dump_store_to_shards(st, tmp_path / "j", shard_size=shard_size,
                                      row_group_size=row_group_size)
    nt = tshards.dump_store_to_shards(st, tmp_path / "t", shard_size=shard_size,
                                      row_group_size=row_group_size)
    st.close()
    assert nj == nt == 57
    lj, lt = shard_layout(tmp_path / "j"), shard_layout(tmp_path / "t")
    assert lj == lt and len(lj) == -(-57 // shard_size)
    meta = ".astpu_dump_meta.json"
    assert json.loads((tmp_path / "t" / meta).read_text()) == \
        json.loads((tmp_path / "j" / meta).read_text()) == {"store_rev": 2}


def test_readers_read_each_others_shards(tmp_path):
    st = fill_store(tstore, tmp_path / "s.sqlite")
    jshards.dump_store_to_shards(st, tmp_path / "j", shard_size=20, row_group_size=8)
    st.close()
    jr, tr = jshards.ShardReader(tmp_path / "j"), tshards.ShardReader(tmp_path / "j")
    assert (len(tr), tr.dim, tr.num_shards) == (len(jr), jr.dim, jr.num_shards)
    for start in (0, 5, 8, 33):
        a = list(jr.iter_row_groups(start_row=start))
        b = list(tr.iter_row_groups(start_row=start))
        assert [x[0] for x in a] == [x[0] for x in b]
        assert all(np.array_equal(x[1], y[1]) for x, y in zip(a, b))
    ids_j, e_j = jr.read_all()
    ids_t, e_t = tr.read_all()
    assert ids_j == ids_t and np.array_equal(e_j, e_t)
    # the same row-group-wise uniform sample, into RAM or a destination
    for n, seed in ((10, 0), (30, 3), (100, 1)):
        assert np.array_equal(jr.sample(n, seed=seed), tr.sample(n, seed=seed))
    out = np.zeros((25, DIM), np.float32)
    assert np.array_equal(tr.sample(25, seed=4, out=out), jr.sample(25, seed=4))
    with pytest.raises(FileNotFoundError):
        tshards.ShardReader(tmp_path / "nothing")


def test_writer_splits_rows_as_jax(tmp_path):
    ids, e = rows(5, 101)
    for mod, d in ((jshards, tmp_path / "j"), (tshards, tmp_path / "t")):
        with mod.ShardWriter(d, DIM, shard_size=30, row_group_size=7) as w:
            for lo in range(0, 101, 13):
                w.write(ids[lo:lo + 13], e[lo:lo + 13])
    assert shard_layout(tmp_path / "j") == shard_layout(tmp_path / "t")


def test_load_shards_to_store_equals_jax(tmp_path):
    st = fill_store(tstore, tmp_path / "s.sqlite")
    tshards.dump_store_to_shards(st, tmp_path / "d", shard_size=20, row_group_size=8)
    want = dump_rows(st)
    st.close()
    a, b = jstore.init_store(tmp_path / "a.sqlite"), tstore.init_store(tmp_path / "b.sqlite")
    assert jshards.load_shards_to_store(tmp_path / "d", a) == \
        tshards.load_shards_to_store(tmp_path / "d", b) == 57
    assert dump_rows(a) == dump_rows(b) == want
    a.close()
    b.close()
