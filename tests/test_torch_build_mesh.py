"""The port's index build over a mesh against the JAX package's, on the CPU.

The port's ranks are real gloo processes (``tests/torch_mesh_worker.py``,
one job per mesh size, W 2 and 4); the JAX package builds on a 2- and
4-device CPU mesh (``build_mesh(jax.devices()[:W])``). Held here:

- k-means (an in-memory sample, and a chunked device source whose three
  chunks leave rank 3 of 4 an empty block): against the JAX mesh,
  centroids atol 1e-5, the same iterations, splits and assignments (the
  tolerances of ``test_torch_kmeans.py``); against the port in one
  process, centroids atol 1e-5; the same bits on every rank;
- PQ (host and staged rows) and OPQ: codebooks atol 1e-5 and the
  rotation atol 1e-4 (``test_torch_pq.py``), the same bits on every rank;
- ``IVFPQIndex.train`` in the streamed mode (a memmap sample): each rank
  rotates only its block, the arrays equal one process's and the JAX
  mesh's within 1e-4;
- ``IVFPQIndex.train`` then ``fill_stream(lists_dir=)``: trained arrays
  the same on every rank and within 1e-4 of the JAX mesh's (OPQ's
  rotation sets the tolerance; the same k-means iterations); the packed
  lists byte for byte the port's one-process fill of the same empty
  artifact; searches equal to that one process's;
- ``IVFFlatIndex`` train and fill: the JAX mesh's centroids and
  searches, and the one-process lists and searches;
- tune: the same oracle cache and nprobe as one process, and the JAX
  mesh's nprobe and recalls;
- ``Driver`` ``build`` -> ``dump`` over 2 ranks: a store per rank holding
  its own partitions, merged into the one-process ingest's rows;
- the fill's ownership over 2 ranks (``test_multihost.py``'s two-process
  test): two ``.owner_p*`` breadcrumbs whose rows cover the corpus, then
  the driver's fill and tune, each rank reading only its own parquet row
  groups;
- ``astpu-torch index train``, ``index fill`` and ``index tune`` over 2
  ranks through ``cli.main`` against the same commands in one process;
  ``sync``, ``dump`` and ``all`` over 2 ranks.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from abstracts_search_tpu.index import tune as jtune
from abstracts_search_tpu.index.ivf import IVFFlatIndex as JaxIVFFlat
from abstracts_search_tpu.index.ivfpq import IVFPQIndex as JaxIVFPQ
from abstracts_search_tpu.index.kmeans import KMeans as JaxKMeans
from abstracts_search_tpu.index.opq import OPQ as JaxOPQ
from abstracts_search_tpu.index.pq import ProductQuantizer as JaxPQ
from abstracts_search_tpu.parallel import build_mesh as jax_build_mesh
from abstracts_search_tpu.parallel.mesh import global_put
from abstracts_search_tpu_torch.config import Config
from abstracts_search_tpu_torch.driver import Driver
from abstracts_search_tpu_torch.index import IVFFlatIndex, IVFPQIndex, tune
from abstracts_search_tpu_torch.index.kmeans import KMeans, _normalize_rows
from abstracts_search_tpu_torch.index.opq import OPQ
from abstracts_search_tpu_torch.index.pq import ProductQuantizer
from abstracts_search_tpu_torch.storage.shards import ShardReader, ShardWriter
from abstracts_search_tpu_torch.storage.sqlite_store import EmbeddingStore

from test_torch_driver import snapshot
from test_torch_parallel import _free_port, run_ranks

ROOT = Path(__file__).resolve().parents[1]
DIM, CHUNK, K = 32, 128, 12
KM_CHUNK_ROWS = 1024           # 3 chunks of the k-means sample: rank 3 of 4 gets none
STREAM_WINDOW = 512            # 8 windows of the 4096-row corpus in the streamed mode
PQ_CASES = [(10, 4), (5, 1)]
IVF_CASES = [(10, 3), (7, 1)]
BUILD = dict(n_lists=16, args=dict(pq_m=8, pq_nbits=4, use_opq=True, seg_size=32,
                                   chunk=CHUNK, seed=0),
             train=dict(kmeans_iters=4, opq_iters=2, pq_iters=4))
LIST_FILES = ("codes.bin", "row_ids.bin", "seg_valid.npy", "seg_start.npy", "seg_cnt.npy",
              "lists_meta.json")
# PQ and OPQ windows of 256 rows (the units a rank's block is made of)
PQ_SCORE_BYTES = {nbits: 8 * (1 << nbits) * 4 * 256 for nbits in (4, 8)}
ING_CFG = dict(embed_dim=32, ivf_centroids=4, pq_m=8, pq_nbits=4, train_sample=10_000,
               shard_size=64, row_group_size=16, embed_batch=8)


def blobs(seed, n_per=256, centers=K, dim=DIM, scale=0.05):
    rng = np.random.default_rng(seed)
    cs = rng.standard_normal((centers, dim)).astype(np.float32)
    cs /= np.linalg.norm(cs, axis=1, keepdims=True)
    x = np.repeat(cs, n_per, axis=0) + scale * rng.standard_normal(
        (centers * n_per, dim)).astype(np.float32)
    return np.ascontiguousarray(x[rng.permutation(len(x))])


def aniso(seed, n, d=DIM):
    """Full-rank correlated unit rows (``test_torch_pq.py``)."""
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((d, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32) @ mix
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def corpus(seed, n=4096, centers=40):
    """Clustered unit rows (``test_torch_build.py``)."""
    rng = np.random.default_rng(seed)
    cs = rng.standard_normal((centers, DIM)).astype(np.float32)
    x = cs[rng.integers(0, centers, n)] + 0.3 * rng.standard_normal((n, DIM)).astype(
        np.float32)
    return _normalize_rows(x).astype(np.float32)


class JaxChunks:
    """A chunked device source for the JAX package on its W-device mesh."""

    prenormalized = False

    def __init__(self, x, chunk_rows, mesh):
        self.x, self.chunk_rows, self.mesh = x, chunk_rows, mesh
        self.num_chunks, self.shape = len(x) // chunk_rows, x.shape

    def __len__(self):
        return len(self.x)

    def device_chunk(self, j):
        return global_put(self.x[j * self.chunk_rows:(j + 1) * self.chunk_rows], self.mesh,
                          P("shard"))

    def gather_rows(self, idx):
        return self.x[np.asarray(idx)]


class TorchChunks(JaxChunks):
    def device_chunk(self, j):
        return torch.from_numpy(self.x[j * self.chunk_rows:(j + 1) * self.chunk_rows])


def lists_bytes(d: Path) -> dict:
    return {f: (d / "lists" / f).read_bytes() for f in LIST_FILES}


def one_process_fill(empty: Path, x, chunk_rows: int, out: Path) -> IVFPQIndex:
    """The port's one-process fill of an empty artifact, as the ranks fill it."""
    shutil.copytree(empty, out)
    idx = IVFPQIndex.load(out, device="cpu", chunk=CHUNK)
    idx.fill_stream(((x[lo:lo + chunk_rows], np.arange(lo, min(lo + chunk_rows, len(x))))
                     for lo in range(0, len(x), chunk_rows)), lists_dir=out / "lists")
    idx.save(out)
    return idx


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs, the port's ranks' results at W 2 and 4, and the JAX mesh's."""
    root = tmp_path_factory.mktemp("build_mesh")
    km_x = blobs(0)
    pq_x = aniso(1, 3000)
    x = corpus(2)
    rng = np.random.default_rng(3)
    q = (x[rng.choice(len(x), 24, replace=False)]
         + 0.05 * rng.standard_normal((24, DIM)).astype(np.float32))
    for name, a in (("km_x", km_x), ("pq_x", pq_x), ("x", x), ("q", q)):
        np.save(root / f"{name}.npy", a)
    res = {"root": root, "km_x": km_x, "pq_x": pq_x, "x": x, "q": q, "port": {}, "jax": {}}

    ingest_url = snapshot(root / "ingest_src", [("2024-01-01", 20), ("2024-02-01", 16),
                                                ("2024-03-01", 12)])
    for w in (2, 4):
        jmesh = jax_build_mesh(jax.devices()[:w])
        j = {}
        km_kw = dict(spherical=True, chunk=CHUNK, seed=1)
        for mode in ("array", "device_stream"):
            jk = JaxKMeans(K, mesh=jmesh, **km_kw)
            if mode == "array":
                jk.fit(km_x, iters=6, batch_rows=700)
            else:
                jk.fit(JaxChunks(km_x, KM_CHUNK_ROWS, jmesh), iters=6)
            j[("kmeans", mode)] = (jk.centroids, dict(jk.stats), jk.assign(km_x)[1])
        for nbits in (4, 8):
            jp = JaxPQ(DIM, 8, nbits, mesh=jmesh, seed=0)
            jp.train(pq_x, iters=6, batch_rows=1000)
            j[("pq", nbits)] = jp.centroids
        jo = JaxOPQ(DIM, 8, 8, mesh=jmesh, seed=0)
        jo.train(pq_x, outer_iters=2, pq_iters=4)
        j["opq"] = (jo.rotation, jo.pq.centroids)
        ji = JaxIVFPQ(BUILD["n_lists"], DIM, mesh=jmesh, scan_impl="map", **BUILD["args"])
        ji.train(x, **BUILD["train"])
        j["ivfpq"] = ji
        ji = JaxIVFPQ(BUILD["n_lists"], DIM, mesh=jmesh, scan_impl="map", **BUILD["args"])
        ji.train(np.load(root / "x.npy", mmap_mode="r"), workdir=root / f"jax_work{w}",
                 **BUILD["train"])
        j["ivfpq_streamed"] = ji
        jf = JaxIVFFlat(16, mesh=jmesh, seg_size=32, chunk=CHUNK, spherical=True, seed=0)
        jf.train(x, iters=5)
        jf.fill(x)
        j["ivf"] = (jf.centroids, {c: jf.search(q, c[0], nprobe=c[1])
                                   for c in IVF_CASES})
        res["jax"][w] = j

        d = root / f"w{w}"
        d.mkdir()
        tasks = []
        for mode in ("array", "staged", "device_stream"):
            tasks.append({"name": f"km_{mode}", "kind": "kmeans", "x": str(root / "km_x.npy"),
                          "k": K, "spherical": True, "chunk": CHUNK, "seed": 1, "mode": mode,
                          "iters": 6, "batch_rows": 700, "chunk_rows": KM_CHUNK_ROWS})
        for nbits in (4, 8):
            for staged in (False, True):
                tasks.append({"name": f"pq{nbits}_{int(staged)}", "kind": "pq",
                              "x": str(root / "pq_x.npy"), "m": 8, "nbits": nbits, "seed": 0,
                              "iters": 6, "batch_rows": 1000, "staged": staged,
                              "score_bytes": PQ_SCORE_BYTES[nbits]})
        tasks.append({"name": "opq", "kind": "opq", "x": str(root / "pq_x.npy"), "m": 8,
                      "nbits": 8, "seed": 0, "outer": 2, "pq_iters": 4,
                      "score_bytes": PQ_SCORE_BYTES[8]})
        tasks.append({"name": "ivfpq", "kind": "ivfpq_build", "x": str(root / "x.npy"),
                      "queries": str(root / "q.npy"), "empty": str(d / "empty"),
                      "filled": str(d / "filled"), "chunk_rows": 500, "cases": PQ_CASES,
                      **BUILD})
        tasks.append({"name": "stream", "kind": "ivfpq_streamed", "x": str(root / "x.npy"),
                      "window_rows": STREAM_WINDOW, **BUILD})
        tasks.append({"name": "ivf", "kind": "ivf_build", "x": str(root / "x.npy"),
                      "queries": str(root / "q.npy"), "n_lists": 16, "spherical": True,
                      "chunk": CHUNK, "iters": 5, "cases": IVF_CASES})
        tasks.append({"name": "tune", "kind": "tune", "art": str(d / "filled"),
                      "x": str(root / "x.npy"), "chunk": CHUNK, "n_queries": 48, "k": 10,
                      "target_recall": 0.9, "cache": str(d / "oracle.npz")})
        if w == 2:
            tasks.append({"name": "ingest", "kind": "ingest", "root": str(d / "drv"),
                          "cfg": {**ING_CFG, "manifest_url": ingest_url}})
        res["port"][w] = run_ranks(w, d, tasks, timeout=420)
    return res


W = pytest.mark.parametrize("w", [2, 4])


def _same_on_every_rank(ranks, key):
    """The ranks' values of ``key``, checked bit for bit equal."""
    for r in ranks[1:]:
        assert r[key].tobytes() == ranks[0][key].tobytes(), key
    return ranks[0][key]


@W
@pytest.mark.parametrize("mode", ["array", "device_stream"])
def test_kmeans_matches_jax_mesh(world, w, mode):
    jc, jstats, jassign = world["jax"][w][("kmeans", mode)]
    ranks = world["port"][w]
    c = _same_on_every_rank(ranks, f"km_{mode}/centroids")
    assert int(ranks[0][f"km_{mode}/iters_run"]) == jstats["iters_run"]
    assert list(ranks[0][f"km_{mode}/empty_splits"]) == jstats["empty_splits"]
    np.testing.assert_allclose(ranks[0][f"km_{mode}/objective"], jstats["objective"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(c, jc, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(_same_on_every_rank(ranks, f"km_{mode}/assign"), jassign)


@W
@pytest.mark.parametrize("mode", ["array", "staged", "device_stream"])
def test_kmeans_over_the_mesh_equals_one_process(world, w, mode):
    """Every mode against the port in one process; each step's sums, counts
    and objective cross the mesh once, in f64."""
    x = world["km_x"]
    km = KMeans(K, spherical=True, chunk=CHUNK, seed=1, device="cpu")
    if mode == "array":
        km.fit(x, iters=6, batch_rows=700)
    elif mode == "staged":
        km.fit_staged(torch.from_numpy(x), iters=6, batch_rows=700)
    else:
        km.fit(TorchChunks(x, KM_CHUNK_ROWS, None), iters=6, batch_rows=700)
    ranks = world["port"][w]
    np.testing.assert_allclose(_same_on_every_rank(ranks, f"km_{mode}/centroids"),
                               km.centroids, rtol=0, atol=1e-5)
    assert int(ranks[0][f"km_{mode}/iters_run"]) == km.stats["iters_run"]
    np.testing.assert_array_equal(ranks[0][f"km_{mode}/assign"], km.assign(x)[1])
    per_step = K * DIM * 8 + K * 8 + 8           # f64 sums, i64 counts, f64 objective
    assert list(ranks[0][f"km_{mode}/reduce_bytes"]) == [per_step] * km.stats["iters_run"]


def test_kmeans_rank_with_an_empty_block(world):
    """Three chunks over four ranks: rank 3 sums nothing, joins every
    collective, and ends with the same centroids."""
    ranks = world["port"][4]
    c = _same_on_every_rank(ranks, "km_device_stream/centroids")
    assert c.shape == (K, DIM) and np.isfinite(c).all()
    assert len(ranks[3]["km_device_stream/reduce_bytes"]) == \
        int(ranks[3]["km_device_stream/iters_run"])


@W
@pytest.mark.parametrize("nbits", [4, 8])
@pytest.mark.parametrize("staged", [0, 1], ids=["host", "staged"])
def test_pq_matches_jax_mesh_and_one_process(world, w, nbits, staged, monkeypatch):
    ranks = world["port"][w]
    c = _same_on_every_rank(ranks, f"pq{nbits}_{staged}/centroids")
    np.testing.assert_allclose(c, world["jax"][w][("pq", nbits)], rtol=0, atol=1e-5)
    monkeypatch.setattr(ProductQuantizer, "SCORE_BYTES", PQ_SCORE_BYTES[nbits])
    one = ProductQuantizer(DIM, 8, nbits, seed=0, device="cpu")
    x = world["pq_x"]
    if staged:
        one.train_staged(torch.from_numpy(x.reshape(len(x), 8, -1)), iters=6)
    else:
        one.train(x, iters=6, batch_rows=1000)
    np.testing.assert_allclose(c, one.centroids, rtol=0, atol=1e-5)


@W
def test_opq_matches_jax_mesh_and_one_process(world, w, monkeypatch):
    monkeypatch.setattr(ProductQuantizer, "SCORE_BYTES", PQ_SCORE_BYTES[8])
    ranks = world["port"][w]
    rot = _same_on_every_rank(ranks, "opq/rotation")
    cb = _same_on_every_rank(ranks, "opq/centroids")
    jrot, jcb = world["jax"][w]["opq"]
    np.testing.assert_allclose(rot, jrot, rtol=0, atol=1e-4)
    one = OPQ(DIM, 8, 8, seed=0, device="cpu")
    one.train(world["pq_x"], outer_iters=2, pq_iters=4)
    np.testing.assert_allclose(rot, one.rotation, rtol=0, atol=1e-4)
    for ref in (jcb, one.pq.centroids):
        np.testing.assert_allclose(cb, ref, rtol=0, atol=1e-4)


@W
def test_ivfpq_train_matches_jax_mesh(world, w):
    ranks = world["port"][w]
    ji = world["jax"][w]["ivfpq"]
    assert int(ranks[0]["ivfpq/kmeans_iters"]) == ji.train_stats["kmeans"]["iters_run"]
    for name, ref in (("rotation", ji.rotation), ("centroids", ji.kmeans.centroids),
                      ("pq_centroids", ji.pq.centroids)):
        np.testing.assert_allclose(_same_on_every_rank(ranks, f"ivfpq/{name}"), ref,
                                   rtol=0, atol=1e-4, err_msg=name)


@W
def test_ivfpq_streamed_train_over_the_mesh(world, w, tmp_path, monkeypatch):
    """The streamed mode (a memmap sample): each rank rotates to disk only
    its block of the one-process windows (the blocks cover the sample
    once), and the trained arrays are the same on every rank and within
    1e-4 (OPQ's rotation sets the tolerance) of one process's streamed
    train and of the JAX mesh's, after the same k-means iterations."""
    ranks = world["port"][w]
    n = len(world["x"])
    per = -(-(-(-n // STREAM_WINDOW)) // w) * STREAM_WINDOW
    assert [str(r["stream/train_mode"]) for r in ranks] == ["streamed"] * w
    assert [int(r["stream/rotated_rows"]) for r in ranks] == \
        [min(per * (r + 1), n) - min(per * r, n) for r in range(w)]
    monkeypatch.setattr(IVFPQIndex, "TRAIN_WINDOW_ROWS", STREAM_WINDOW)
    one = IVFPQIndex(BUILD["n_lists"], DIM, device="cpu", **BUILD["args"])
    one.train(np.load(world["root"] / "x.npy", mmap_mode="r"), workdir=tmp_path,
              **BUILD["train"])
    assert one.train_stats["train_mode"] == "streamed"
    assert one.train_stats["rotated_rows"] == n
    ji = world["jax"][w]["ivfpq_streamed"]
    iters = int(_same_on_every_rank(ranks, "stream/kmeans_iters"))
    assert iters == one.train_stats["kmeans"]["iters_run"] == \
        ji.train_stats["kmeans"]["iters_run"]
    for name, jref in (("rotation", ji.rotation), ("centroids", ji.kmeans.centroids),
                       ("pq_centroids", ji.pq.centroids)):
        c = _same_on_every_rank(ranks, f"stream/{name}")
        np.testing.assert_allclose(c, getattr(one, name), rtol=0, atol=1e-4, err_msg=name)
        np.testing.assert_allclose(c, jref, rtol=0, atol=1e-4, err_msg=name)


@W
def test_ivfpq_fill_over_the_mesh_equals_one_process(world, w, tmp_path):
    """The W-trained empty artifact filled over the mesh and in one
    process: the same lists byte for byte, the same searches bit for
    bit; the ranks' fills cover the corpus."""
    d = world["root"] / f"w{w}"
    one = one_process_fill(d / "empty", world["x"], 500, tmp_path / "one")
    assert lists_bytes(d / "filled") == lists_bytes(tmp_path / "one")
    ranks = world["port"][w]
    for k, nprobe in PQ_CASES:
        v, p = one.search(world["q"], k, nprobe=nprobe)
        np.testing.assert_array_equal(_same_on_every_rank(ranks, f"ivfpq/{k}_{nprobe}/p"), p)
        np.testing.assert_array_equal(_same_on_every_rank(ranks, f"ivfpq/{k}_{nprobe}/v"), v)
    # 9 chunks of 500 rows (the last 96) dealt round-robin
    sizes = [500] * 8 + [96]
    assert [int(r["ivfpq/fill_rows"]) for r in ranks] == [sum(sizes[r::w]) for r in range(w)]
    owners = sorted((d / "filled" / "lists").glob(".owner_p*.json"))
    assert [json.loads(o.read_text())["rows"] for o in owners] == \
        [int(r["ivfpq/fill_rows"]) for r in ranks]
    assert not (d / "filled" / ".astpu_spill").exists()


@W
def test_ivfpq_built_over_the_mesh_recall_matches_jax(world, w):
    """The JAX mesh's own build of the same corpus reaches the recall of
    the port's W-rank build within 0.02 (recall@10 at nprobe 4 against
    the exact top 10; 4-bit codes of these noisy clusters keep it near
    0.2, where a random list scores ~0.003)."""
    x, q = world["x"], world["q"]
    ji = world["jax"][w]["ivfpq"]
    ji.fill(x)
    exact = np.argsort(-(q @ x.T), axis=1)[:, :10]
    _, jp = ji.search(q, 10, nprobe=4)
    tp = world["port"][w][0]["ivfpq/10_4/p"]
    recall = [np.mean([len(set(a[i]) & set(exact[i])) / 10 for i in range(len(q))])
              for a in (np.asarray(jp), tp)]
    assert abs(recall[0] - recall[1]) <= 0.02 and recall[1] > 0.1, recall


@W
def test_ivf_flat_build_over_the_mesh_equals_one_process(world, w):
    one = IVFFlatIndex(16, seg_size=32, chunk=CHUNK, spherical=True, seed=0, device="cpu")
    one.train(world["x"], iters=5)
    one.fill(world["x"])
    ranks = world["port"][w]
    np.testing.assert_allclose(_same_on_every_rank(ranks, "ivf/centroids"), one.centroids,
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(_same_on_every_rank(ranks, "ivf/row_ids"),
                                  np.asarray(one.packed.row_ids))
    np.testing.assert_array_equal(ranks[0]["ivf/seg_cnt"], np.asarray(one.packed.seg_cnt))
    for k, nprobe in IVF_CASES:
        v, p = one.search(world["q"], k, nprobe=nprobe)
        np.testing.assert_array_equal(_same_on_every_rank(ranks, f"ivf/{k}_{nprobe}/p"), p)
        np.testing.assert_allclose(ranks[0][f"ivf/{k}_{nprobe}/v"], v, rtol=1e-6, atol=1e-6)


@W
def test_ivf_flat_build_over_the_mesh_matches_jax_mesh(world, w):
    """Centroids atol 1e-5 and searches (positions equal, scores within
    rtol=atol=1e-5, as ``test_torch_parallel.py``) against the JAX
    package's IVF-Flat trained and filled on its W-device mesh."""
    jc, jres = world["jax"][w]["ivf"]
    ranks = world["port"][w]
    np.testing.assert_allclose(ranks[0]["ivf/centroids"], jc, rtol=0, atol=1e-5)
    for k, nprobe in IVF_CASES:
        jv, jp = jres[(k, nprobe)]
        np.testing.assert_array_equal(ranks[0][f"ivf/{k}_{nprobe}/p"], jp)
        np.testing.assert_allclose(ranks[0][f"ivf/{k}_{nprobe}/v"], jv, rtol=1e-5, atol=1e-5)


@W
def test_tune_over_the_mesh_equals_one_process_and_jax(world, w, tmp_path):
    d = world["root"] / f"w{w}"
    ranks = world["port"][w]
    nprobe = int(_same_on_every_rank(ranks, "tune/nprobe"))
    recall = _same_on_every_rank(ranks, "tune/recall")
    key = {"fingerprint": {}, "n_queries": 48, "k": 10, "seed": 0, "spherical": True}
    kw = dict(n_queries=48, k=10, target_recall=0.9, timing_reps=1)
    one = IVFPQIndex.load(d / "filled", device="cpu", chunk=CHUNK)
    p1 = tune.tune_index(one, world["x"], oracle_cache=tmp_path / "one.npz", oracle_key=key,
                         **kw)
    assert p1["nprobe"] == nprobe
    np.testing.assert_array_equal([p["recall"] for p in p1["operating_points"]], recall)
    # rank 0's oracle cache holds one process's oracle
    for a, b in zip(tune.load_oracle_cache(d / "oracle.npz", key),
                    tune.load_oracle_cache(tmp_path / "one.npz", key)):
        assert a.tobytes() == b.tobytes()
    jidx = JaxIVFPQ.load(d / "filled", mesh=jax_build_mesh(jax.devices()[:w]), chunk=CHUNK,
                         scan_impl="map")
    pj = jtune.tune_index(jidx, world["x"], **kw)
    assert pj["nprobe"] == nprobe
    np.testing.assert_allclose([p["recall"] for p in pj["operating_points"]], recall,
                               atol=1e-9)


def _store_rows(path: Path) -> dict:
    with EmbeddingStore(path) as st:
        return {i: e.tobytes() for ids, embs in st.iter_batches() for i, e in zip(ids, embs)}


def test_driver_build_and_dump_over_two_ranks(world, tmp_path):
    """Each rank ingests its partitions (``i % 2 == rank``) into its own
    store; rank 0's dump merges them into the rows a one-process ingest
    stores, and exports them."""
    drv = world["root"] / "w2" / "drv"
    cfg = Config(**ING_CFG, manifest_url=(world["root"] / "ingest_src" /
                                          "manifest.json").as_uri())
    parts = sorted(p for r in world["port"][2] for p in r["ingest/partitions"])
    assert parts == [f"updated_date=2024-0{m}-01" for m in (1, 2, 3)]
    assert list(world["port"][2][1]["ingest/partitions"]) == ["updated_date=2024-02-01"]
    assert int(world["port"][2][0]["ingest/dumped"]) == 48
    assert int(world["port"][2][1]["ingest/dumped"]) == 0
    for r in (0, 1):
        assert (drv / f"{cfg.store_path}.p{r}").exists()
    one = Driver(cfg, root=tmp_path, embedder="hash", device="cpu")
    one.target_build()
    assert _store_rows(drv / cfg.store_path) == _store_rows(tmp_path / cfg.store_path)
    assert sorted(p.name for p in (drv / "events").iterdir()) == parts


@pytest.fixture(scope="module")
def two_rank_fill(tmp_path_factory):
    """``test_multihost.py``'s two-process build on the port: train on
    half the corpus, fill in chunks of 1024 over 2 ranks, search; then the
    driver's fill and tune over the same ranks on a parquet data dir."""
    out = tmp_path_factory.mktemp("own")
    x = np.random.default_rng(0).standard_normal((4096, 32)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    np.save(out / "x.npy", x)
    np.save(out / "q.npy", x[::97][:32])
    data = out / "drv" / "data"
    w = ShardWriter(data, 32, shard_size=2048, row_group_size=512)
    for lo in range(0, len(x), 512):
        w.write([f"W{i}" for i in range(lo, lo + 512)], x[lo:lo + 512])
    w.close()
    cfg = dict(data_dir="data", index_dir="idx", store_path="s.sqlite", events_dir="ev",
               ivf_centroids=16, train_sample=2048, pq_m=8, pq_nbits=8, normalize=True,
               index_storage="device", embed_dim=32, tune_sample=4096)
    tasks = [{"name": "own", "kind": "ivfpq_build", "x": str(out / "x.npy"),
              "queries": str(out / "q.npy"), "empty": str(out / "empty"),
              "filled": str(out / "filled"), "chunk_rows": 1024, "cases": [(5, 8)],
              "n_lists": 16, "args": dict(pq_m=8, pq_nbits=8, chunk=1024),
              "train": dict(kmeans_iters=4)},
             {"name": "drv", "kind": "driver_fill", "root": str(out / "drv"), "cfg": cfg,
              "kmeans_iters": 4, "n_queries": 32, "k": 5}]
    (out / "job").mkdir()
    return out, run_ranks(2, out / "job", tasks, timeout=300)


def test_two_rank_fill_ownership(two_rank_fill):
    out, ranks = two_rank_fill
    # both ranks returned the same answers, mostly the query rows themselves
    pos = _same_on_every_rank(ranks, "own/5_8/p")
    assert (pos[:, 0] == np.arange(4096)[::97][:32]).mean() >= 0.9
    owners = sorted((out / "filled" / "lists").glob(".owner_p*.json"))
    assert len(owners) == 2
    rows = [json.loads(p.read_text())["rows"] for p in owners]
    assert sum(rows) == 4096 and min(rows) >= 1024, rows
    # the driver's fill and tune over the two ranks
    assert int(_same_on_every_rank(ranks, "drv/nprobe")) >= 1
    assert float(ranks[0]["drv/recall"]) >= 0.45
    assert (out / "drv" / "idx" / "ids.parquet").exists()
    # an incremental fill over several ranks runs a full one: up to date here
    assert not bool(ranks[0]["drv/again"]) and int(ranks[0]["drv/deltas"]) == 0
    report = json.loads((out / "drv" / "idx" / "fill_report.json").read_text())
    assert [r["rank"] for r in report["ranks"]] == [0, 1]
    untuned = json.loads((out / "drv" / "idx" / "untuned.json").read_text())
    assert len({r["sha256"] for r in untuned["ranks"]}) == 1


def test_two_rank_fill_reads_only_its_row_groups(two_rank_fill):
    """The row groups are dealt before any is read: in the driver's fill
    rank ``r`` reads the embeddings of the row groups ``g % 2 == r`` alone,
    and rank 0 alone reads the id column, of every row group (for
    ``ids.parquet``); the streamed tune oracle reads each rank's own row
    groups, after rank 0 alone has sampled the queries from every one."""
    import pyarrow.parquet as pq

    out, ranks = two_rank_fill
    groups = [(p.name, rg) for p in ShardReader(out / "drv" / "data").paths
              for rg in range(pq.ParquetFile(p).metadata.num_row_groups)]
    assert len(groups) == 8
    for r in (0, 1):
        reads = [str(e) for e in ranks[r]["drv/reads"]]
        mine = [f"{f} {rg} embedding" for f, rg in groups[r::2]]
        ids = [f"{f} {rg} id" for f, rg in groups] if r == 0 else []
        fill = [e.split(" ", 1)[1] for e in reads if e.startswith("fill ")]
        tune_reads = [e.split(" ", 1)[1] for e in reads if e.startswith("tune ")]
        assert sorted(fill) == sorted(mine + ids), r
        sample = [f"{f} {rg} embedding" for f, rg in groups] if r == 0 else []
        assert tune_reads == sample + mine, r


def _cli(cwd: Path, world: int, *argv, timeout: float = 300) -> None:
    """``astpu-torch --device cpu ... <argv>``: one process, or ``world``
    gloo ranks on a free port."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    if world == 1:
        cmds = [[sys.executable, "-m", "abstracts_search_tpu_torch.cli", "--device", "cpu",
                 *argv]]
    else:
        port = _free_port()
        cmds = [[sys.executable, "-m", "abstracts_search_tpu_torch.cli", "--device", "cpu",
                 "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(world),
                 "--process-id", str(r), *argv] for r in range(world)]
    procs = [subprocess.Popen(c, cwd=cwd, env={**env, "PYTHONPATH": str(ROOT)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {argv} exited {p.returncode}:\n{log[-4000:]}"


def test_cli_index_train_fill_tune_over_two_ranks(two_rank_fill, tmp_path):
    """``astpu-torch index train``, ``index fill`` and ``index tune`` over 2
    gloo ranks, and in one process from a copy of the 2-rank empty
    artifact: the same lists and ids.parquet, the same nprobe."""
    src = two_rank_fill[0] / "drv" / "data"
    env = {"embed_dim": 32, "pq_m": 8, "pq_nbits": 4, "train_sample": 4096,
           "index_seg_size": 64, "tune_sample": 4096}
    trees = {}
    for name in ("mesh", "one"):
        t = tmp_path / name
        t.mkdir()
        (t / "env.json").write_text(json.dumps(env))
        trees[name] = t
    train = ("index", "-B", "idx", "train", "-N", "-c", "16", "--iters", "4", str(src))
    _cli(trees["mesh"], 2, *train)
    untuned = json.loads((trees["mesh"] / "idx" / "untuned.json").read_text())
    assert [r["rank"] for r in untuned["ranks"]] == [0, 1]
    assert untuned["ranks"][0]["sha256"] == untuned["ranks"][1]["sha256"]
    assert len(untuned["kmeans"]["reduce_s"]) == untuned["kmeans"]["iters_run"]
    (trees["one"] / "idx").mkdir()
    for f in ("empty", "untuned.json"):
        s = trees["mesh"] / "idx" / f
        (shutil.copytree if s.is_dir() else shutil.copy)(s, trees["one"] / "idx" / f)
    for name, world in (("mesh", 2), ("one", 1)):
        _cli(trees[name], world, "index", "-B", "idx", "fill", str(src))
        _cli(trees[name], world, "index", "-B", "idx", "tune", "--k", "10", str(src))
    a, b = (trees[n] / "idx" for n in ("mesh", "one"))
    assert lists_bytes(a / "index") == lists_bytes(b / "index")
    assert (a / "ids.parquet").read_bytes() == (b / "ids.parquet").read_bytes()
    pa, pb = (json.loads((d / "params.json").read_text()) for d in (a, b))
    assert pa["nprobe"] == pb["nprobe"]
    assert [p["recall"] for p in pa["operating_points"]] == \
        [p["recall"] for p in pb["operating_points"]]


def test_cli_sync_dump_and_all_over_two_ranks(world, tmp_path):
    """``astpu-torch sync`` (build -> dump -> fill -> tune), ``dump`` and
    ``all`` over 2 gloo ranks: a store per rank, every ingested work in
    ``ids.parquet`` and the dumped shards, and ``all`` a no-op re-run."""
    from abstracts_search_tpu_torch.driver import read_ids_parquet

    url = (world["root"] / "ingest_src" / "manifest.json").as_uri()
    (tmp_path / "env.json").write_text(json.dumps({**ING_CFG, "manifest_url": url}))
    _cli(tmp_path, 2, "sync", "--embedder", "hash")
    cfg = Config(**ING_CFG)
    for r in (0, 1):
        assert (tmp_path / f"{cfg.store_path}.p{r}").exists()
    rows = _store_rows(tmp_path / cfg.store_path)
    assert len(rows) == 48
    assert sorted(read_ids_parquet(tmp_path / cfg.index_dir / "ids.parquet")) == sorted(rows)
    assert json.loads((tmp_path / cfg.index_dir / "params.json").read_text())["nprobe"] >= 1
    _cli(tmp_path, 2, "dump", cfg.store_path, "redump")
    ids, embs = ShardReader(tmp_path / "redump").read_all()
    assert {i: e.tobytes() for i, e in zip(ids, embs)} == rows
    stamp = (tmp_path / cfg.index_dir / "fill.stamp.json").read_bytes()
    _cli(tmp_path, 2, "all", "--embedder", "hash")
    assert (tmp_path / cfg.index_dir / "fill.stamp.json").read_bytes() == stamp
