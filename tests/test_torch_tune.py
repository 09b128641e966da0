"""The port's tune against the JAX package's.

- Held-out queries: from an array and from a shard reader, with and
  without noise, bit-equal to the JAX package's (numpy draws).
- Oracles: the array oracle (``FlatIndex``) and the streamed oracle
  (kernel 1 over each row group, ``n_valid`` masking the padding of
  ragged row groups) give the JAX package's positions, scores within
  1e-5; the streamed oracle numbers rows in reader order (global
  positions), equal to the array oracle.
- The oracle cache: a miss computes and writes it, a hit reads it back
  without recomputing, a key mismatch or a broken file misses; the
  packages read each other's cache files.
- ``tune_index`` on one artifact (IVF-Flat and IVF-PQ, JAX-built) loaded
  by both packages: the recall at every nprobe and the chosen nprobe are
  equal. (QPS and ms are host-clock times of each package: not compared.)
"""

import numpy as np
import pytest

from abstracts_search_tpu.index import tune as jtune
from abstracts_search_tpu.index.ivf import IVFFlatIndex as JaxIVF
from abstracts_search_tpu.index.ivfpq import IVFPQIndex as JaxIVFPQ
from abstracts_search_tpu.parallel import build_mesh
from abstracts_search_tpu.storage.shards import ShardReader as JaxReader
from abstracts_search_tpu.storage.shards import ShardWriter
from abstracts_search_tpu_torch.index import IVFFlatIndex, IVFPQIndex
from abstracts_search_tpu_torch.index import tune
from abstracts_search_tpu_torch.storage.shards import ShardReader

N, DIM, CHUNK = 1500, 24, 128


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    cs = rng.standard_normal((40, DIM)).astype(np.float32)
    x = cs[rng.integers(0, 40, N)] + 0.3 * rng.standard_normal((N, DIM)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def shards(data, tmp_path_factory):
    """The rows as parquet shards with ragged row groups (100 rows: not a
    multiple of the top-k chunk)."""
    d = tmp_path_factory.mktemp("shards")
    with ShardWriter(d, DIM, shard_size=700, row_group_size=100) as w:
        w.write([f"W{i}" for i in range(N)], data)
    return d


@pytest.mark.parametrize("noise", [0.0, 0.1])
@pytest.mark.parametrize("n", [20, 5000])
def test_holdout_queries_equal_jax(data, shards, noise, n):
    for a, b in ((data, data), (ShardReader(shards), JaxReader(shards))):
        np.testing.assert_array_equal(
            tune.make_holdout_queries(a, n, noise=noise, seed=3),
            jtune.make_holdout_queries(b, n, noise=noise, seed=3))


def test_oracles_equal_jax(data, shards):
    q = tune.make_holdout_queries(data, 40, noise=0.05, seed=1)
    jv, jp = jtune.exact_ground_truth(data, q, 10, mesh=build_mesh(), chunk=CHUNK)
    av, ap = tune.exact_ground_truth(data, q, 10, device="cpu", chunk=CHUNK)
    sv, sp = tune.exact_ground_truth(ShardReader(shards), q, 10, device="cpu", chunk=CHUNK)
    jsv, jsp = jtune.exact_ground_truth(JaxReader(shards), q, 10, chunk=CHUNK)
    for p in (ap, sp, jsp):
        np.testing.assert_array_equal(p, jp)
    for v in (av, sv, jsv):
        np.testing.assert_allclose(v, jv, atol=1e-5, rtol=0)


def test_streamed_oracle_k_past_a_row_group(shards, data):
    """k larger than a row group: the running merge still gives the
    array oracle's positions (ties to the earlier row group)."""
    q = data[:8]
    _, sp = tune.exact_ground_truth(ShardReader(shards), q, 150, device="cpu", chunk=CHUNK)
    _, jp = jtune.exact_ground_truth(JaxReader(shards), q, 150, chunk=CHUNK)
    np.testing.assert_array_equal(sp, jp)
    assert (sp[:, 0] == np.arange(8)).all()


def test_oracle_cache_hit_miss_and_key(shards, tmp_path, monkeypatch):
    key = {"fingerprint": {"a": 1}, "n_queries": 16, "k": 5, "seed": 0, "spherical": True}
    path = tmp_path / "tune_oracle.npz"
    reader = ShardReader(shards)
    assert tune.ensure_oracle_cache(path, key, reader, k=5, device="cpu", chunk=CHUNK)
    q, ref = tune.load_oracle_cache(path, key)
    assert q.shape == (16, DIM) and ref.shape == (16, 5)
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-6)
    # a hit never recomputes
    monkeypatch.setattr(tune, "exact_ground_truth", lambda *a, **k: pytest.fail("recomputed"))
    assert not tune.ensure_oracle_cache(path, key, reader, k=5, device="cpu", chunk=CHUNK)
    assert tune.load_oracle_cache(path, {**key, "k": 6}) is None
    assert tune.load_oracle_cache(tmp_path / "absent.npz", key) is None
    (tmp_path / "broken.npz").write_bytes(b"PK\x03\x04 not a zip")
    assert tune.load_oracle_cache(tmp_path / "broken.npz", key) is None
    # the packages read each other's cache files
    jq, jref = jtune.load_oracle_cache(path, key)
    assert np.array_equal(jq, q) and np.array_equal(jref, ref)
    jtune.save_oracle_cache(tmp_path / "j.npz", key, q, ref)
    got = tune.load_oracle_cache(tmp_path / "j.npz", key)
    assert np.array_equal(got[0], q) and np.array_equal(got[1], ref)


def test_ensure_oracle_equals_jax(shards, tmp_path):
    key = {"fingerprint": {}, "n_queries": 32, "k": 10, "seed": 2, "spherical": True}
    tune.ensure_oracle_cache(tmp_path / "t.npz", key, ShardReader(shards), k=10,
                             device="cpu", chunk=CHUNK)
    jtune.ensure_oracle_cache(tmp_path / "j.npz", key, JaxReader(shards), k=10, chunk=CHUNK)
    (tq, tr), (jq, jr) = (tune.load_oracle_cache(tmp_path / f, key) for f in ("t.npz", "j.npz"))
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(tr, jr)


def jax_artifact(kind, x, d):
    if kind == "ivf_flat":
        j = JaxIVF(16, mesh=build_mesh(), seg_size=32, chunk=CHUNK, seed=0)
        j.train(x, iters=6)
    else:
        j = JaxIVFPQ(16, DIM, mesh=build_mesh(), pq_m=8, pq_nbits=4, use_opq=True,
                     seg_size=32, chunk=CHUNK, seed=0, scan_impl="map")
        j.train(x, kmeans_iters=5, opq_iters=2, pq_iters=5)
    j.fill(x)
    j.save(d)
    return j


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
@pytest.mark.parametrize("source", ["array", "reader"])
def test_tune_index_equals_jax(kind, source, data, shards, tmp_path):
    j = jax_artifact(kind, data, tmp_path / "art")
    t = (IVFFlatIndex if kind == "ivf_flat" else IVFPQIndex).load(
        tmp_path / "art", device="cpu", chunk=CHUNK)
    src_t, src_j = ((data, data) if source == "array"
                    else (ShardReader(shards), JaxReader(shards)))
    kw = dict(n_queries=64, k=10, target_recall=0.9, timing_reps=1, stop_after=None)
    pt = tune.tune_index(t, src_t, **kw)
    pj = jtune.tune_index(j, src_j, **kw)
    assert [p["nprobe"] for p in pt["operating_points"]] == \
        [p["nprobe"] for p in pj["operating_points"]] == [1, 2, 4, 8, 16]
    assert [p["recall"] for p in pt["operating_points"]] == \
        [p["recall"] for p in pj["operating_points"]]
    assert (pt["nprobe"], pt["achieved_recall"]) == (pj["nprobe"], pj["achieved_recall"])
    assert set(pt) == set(pj)
    tune.write_params(tmp_path / "params.json", pt)
    assert tune.read_params(tmp_path / "params.json") == pt


def test_tune_stops_after_the_target_holds(data):
    t = IVFFlatIndex(16, seg_size=32, chunk=CHUNK, device="cpu")
    t.train(data, iters=4)
    t.fill(data)
    p = tune.tune_index(t, data, n_queries=32, k=5, target_recall=0.0, timing_reps=1)
    assert [x["nprobe"] for x in p["operating_points"]] == [1, 2] and p["nprobe"] == 1
