"""The port's index build against the JAX package's, on the CPU.

- Encode: with the JAX package's trained state carried across, the
  port's fused encode gives its assignments and codes, except where two
  centroids (or two codewords) score within 1e-5.
- Fill: fed the JAX package's (assignments, codes, positions), the
  port's ``fill_encoded_stream`` writes a ``lists/`` byte-identical to
  the JAX package's fill, in RAM and through the spill.
- Cross-package search: an index trained and filled by the port, in
  each train mode, saved, opened by the JAX package and searched there
  (``scan_impl="map"``) gives the port's own positions (scores within
  1e-5); port- and JAX-built recall@10 lie within 0.02.
- Guards: the empty-artifact hand-off, the refused refill and legacy
  non-spherical build, ``train_stats`` through JSON, and a save that
  does not rewrite lists written in place.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from abstracts_search_tpu.index.ivfpq import IVFPQIndex as JaxIVFPQ
from abstracts_search_tpu.parallel import build_mesh
from abstracts_search_tpu_torch.index import IVFPQIndex, index_from_numpy
from abstracts_search_tpu_torch.index.kmeans import _normalize_rows

N_LISTS, DIM, M, SEG, CHUNK = 16, 32, 8, 32, 128
LIST_FILES = ("codes.bin", "row_ids.bin", "seg_valid.npy", "seg_start.npy", "seg_cnt.npy",
              "lists_meta.json")
ARGS = dict(pq_m=M, pq_nbits=4, use_opq=True, seg_size=SEG, chunk=CHUNK, seed=0)
TRAIN = dict(kmeans_iters=5, opq_iters=2, pq_iters=5)


def corpus(seed, n=3000, centers=40):
    """Clustered unit rows: neighbours share a list, so recall is
    probe-limited, not noise."""
    rng = np.random.default_rng(seed)
    cs = rng.standard_normal((centers, DIM)).astype(np.float32)
    x = cs[rng.integers(0, centers, n)] + 0.3 * rng.standard_normal((n, DIM)).astype(
        np.float32)
    return _normalize_rows(x).astype(np.float32)


def queries(x, seed, n=40):
    rng = np.random.default_rng(seed)
    q = x[rng.choice(len(x), n, replace=False)] + 0.05 * rng.standard_normal(
        (n, DIM)).astype(np.float32)
    return q.astype(np.float32)


def jax_meta(jidx):
    return {"n_lists": jidx.n_lists, "dim": jidx.dim, "pq_m": jidx.pq.m,
            "pq_nbits": jidx.pq.nbits, "use_opq": jidx.use_opq,
            "seg_size": jidx.seg_size, "spherical": jidx.spherical}


def port_of(jidx):
    """The port's index with the JAX package's trained state, unfilled."""
    return index_from_numpy(jax_meta(jidx), jidx.kmeans.centroids, jidx.pq.centroids,
                            jidx.rotation, None, device="cpu", chunk=CHUNK)


@pytest.fixture(scope="module")
def jax_built(tmp_path_factory):
    x = corpus(0)
    jidx = JaxIVFPQ(N_LISTS, DIM, mesh=build_mesh(), scan_impl="map", **ARGS)
    jidx.train(x, **TRAIN)
    art = tmp_path_factory.mktemp("jax") / "index"
    jidx.save(art, include_lists=False)
    jidx.fill(x)
    jidx.save(art)
    return x, jidx, art


def test_encode_matches_jax(jax_built):
    x, jidx, _ = jax_built
    idx = port_of(jidx)
    assert idx.is_trained and idx.kmeans.centroids is idx.centroids
    rng = np.random.default_rng(5)
    v = np.concatenate([x[:1000], rng.standard_normal((500, DIM)).astype(np.float32)])
    ja, jc = jidx.encode(v, batch_rows=700)
    ta, tc = idx.encode(v, batch_rows=700)
    assert ta.dtype == np.int64 and tc.dtype == np.uint8 and tc.shape == (len(v), M // 2)
    # rows whose list differs: the two centroids score within 1e-5 on the
    # kernel's bf16 operands
    xr = _normalize_rows(v) @ idx.rotation
    xb = torch.from_numpy(xr).bfloat16().double()
    cb = torch.from_numpy(idx.centroids).bfloat16().double()
    da = (xb * cb[torch.from_numpy(ta)]).sum(1) - (xb * cb[torch.from_numpy(ja)]).sum(1)
    assign_differ = ta != ja
    assert (da.abs().numpy()[assign_differ] <= 1e-5).all()
    # rows on one list: codes differ only at PQ near-ties
    same = ~assign_differ
    res = (xr - idx.centroids[ta]).reshape(len(v), M, DIM // M).astype(np.float64)
    nib = lambda c: np.stack([c & 15, c >> 4], axis=2).reshape(len(c), M)  # noqa: E731
    tn, jn = nib(tc), nib(jc)
    ci = np.arange(M)[None, :]
    dt = ((res - idx.pq_centroids[ci, tn]) ** 2).sum(-1)
    dj = ((res - idx.pq_centroids[ci, jn]) ** 2).sum(-1)
    code_differ = (tn != jn) & same[:, None]
    assert (np.abs(dt - dj)[code_differ] <= 1e-5).all()
    assert assign_differ.sum() + code_differ.any(1).sum() <= 5


@pytest.mark.parametrize("spill", [False, True], ids=["in-ram", "spill"])
def test_fill_encoded_stream_writes_jax_lists(jax_built, tmp_path, spill):
    x, jidx, art = jax_built
    pos = np.arange(len(x), dtype=np.int64)
    chunks = [(*jidx.encode(x[lo:lo + 700]), pos[lo:lo + 700])
              for lo in range(0, len(x), 700)]
    idx = port_of(jidx)
    if spill:
        j2 = JaxIVFPQ.load(art, mesh=build_mesh(), chunk=CHUNK, scan_impl="map")
        j2.packed = None
        j2.fill_encoded_stream(iter(chunks), lists_dir=tmp_path / "jax" / "lists")
        idx.fill_encoded_stream(iter(chunks), lists_dir=tmp_path / "port" / "lists")
        ref_dir = tmp_path / "jax" / "lists"
        assert isinstance(idx.packed.data, np.memmap)
    else:
        idx.fill_encoded_stream(iter(chunks))
        ref_dir = art / "lists"
    idx.save(tmp_path / "port")
    for name in LIST_FILES:
        assert (tmp_path / "port" / "lists" / name).read_bytes() == \
            (ref_dir / name).read_bytes(), name
    assert idx.n == len(x) and idx.fill_stats["rows"] == len(x)


def device_source(x, chunk_rows):
    class Chunks:
        prenormalized = False
        shape = x.shape
        num_chunks = len(x) // chunk_rows

        def __init__(self):
            self.chunk_rows = chunk_rows

        def __len__(self):
            return len(x)

        def device_chunk(self, j):
            return torch.from_numpy(x[j * chunk_rows:(j + 1) * chunk_rows])

        def gather_rows(self, idx):
            return x[np.asarray(idx)]

    return Chunks()


def port_built(mode, x, tmp_path):
    idx = IVFPQIndex(N_LISTS, DIM, device="cpu", **ARGS)
    idx.PQ_TRAIN_ROWS = 2000
    if mode == "in_ram":
        sample = x
    elif mode == "streamed":
        mm = np.memmap(tmp_path / "sample.f32", dtype=np.float32, mode="w+", shape=x.shape)
        mm[:] = x
        mm.flush()
        sample = np.memmap(tmp_path / "sample.f32", dtype=np.float32, mode="r",
                           shape=x.shape)
    elif mode == "device":
        idx.TRAIN_INRAM_BYTES = 0
        sample = x
    else:
        sample = device_source(x, 500)
    stats = idx.train(sample, workdir=tmp_path / "work", **TRAIN)
    assert stats.get("train_mode", "in_ram") == mode
    assert not (tmp_path / "work" / "train_rot.f32").exists()
    pos = np.arange(len(x), dtype=np.int64)
    idx.fill_stream(((torch.from_numpy(x[lo:lo + 600]) if lo % 1200 else x[lo:lo + 600],
                      pos[lo:lo + 600]) for lo in range(0, len(x), 600)),
                    lists_dir=tmp_path / "art" / "lists")
    idx.save(tmp_path / "art")
    return idx


@pytest.mark.parametrize("mode", ["in_ram", "streamed", "device", "device_streamed"])
def test_port_built_index_searches_the_same_in_jax(mode, tmp_path):
    x = corpus(1)
    idx = port_built(mode, x, tmp_path)
    j = JaxIVFPQ.load(tmp_path / "art", mesh=build_mesh(), chunk=CHUNK, scan_impl="map")
    q = queries(x, 2)
    for nprobe, k in ((1, 5), (4, 10), (N_LISTS, 10)):
        tv, tp = idx.search(q, k, nprobe=nprobe)
        jv, jp = j.search(q, k, nprobe=nprobe)
        np.testing.assert_array_equal(jp, tp)
        np.testing.assert_allclose(jv, tv, rtol=1e-5, atol=1e-5)
    assert j.train_stats["kmeans"]["iters_run"] == idx.train_stats["kmeans"]["iters_run"]


def recall_at_10(index, x, q, nprobe):
    exact = np.argsort(-(_normalize_rows(q) @ x.T), axis=1, kind="stable")[:, :10]
    _, got = index.search(q, 10, nprobe=nprobe)
    return float(np.mean([len(set(got[i]) & set(exact[i])) / 10 for i in range(len(q))]))


def test_recall_matches_jax_build(jax_built):
    x, jidx, _ = jax_built
    idx = IVFPQIndex(N_LISTS, DIM, device="cpu", **ARGS)
    idx.train(x, **TRAIN)
    idx.fill(x)
    q = queries(x, 3)
    for nprobe in (2, 4):
        r_port, r_jax = recall_at_10(idx, x, q, nprobe), recall_at_10(jidx, x, q, nprobe)
        assert abs(r_port - r_jax) <= 0.02, (nprobe, r_port, r_jax)
    # PQ8x4 at d 32 ranks ~75 rows of a cluster coarsely; chance is ~0.003
    assert r_port > 0.15


def test_empty_artifact_hand_off_and_guards(jax_built, tmp_path):
    x = corpus(2, n=1500)
    idx = IVFPQIndex(N_LISTS, DIM, device="cpu", **ARGS)
    with pytest.raises(RuntimeError, match="train"):
        idx.fill(x)
    idx.train(x, **TRAIN)
    idx.save(tmp_path / "empty", include_lists=False)
    meta = json.loads((tmp_path / "empty" / "meta.json").read_text())
    assert not (tmp_path / "empty" / "lists").exists() and meta["n"] == 0

    j = IVFPQIndex.load(tmp_path / "empty", device="cpu", chunk=CHUNK)
    assert j.is_trained and j.packed is None
    assert j.train_stats == json.loads(json.dumps(j.train_stats))
    assert j.train_stats["kmeans"]["objective"] == idx.train_stats["kmeans"]["objective"]
    for a, b in ((j.centroids, idx.centroids), (j.pq_centroids, idx.pq_centroids),
                 (j.rotation, idx.rotation)):
        np.testing.assert_array_equal(a, b)
    assert j.kmeans.centroids is j.centroids and j.opq.rotation is j.rotation
    pos = np.arange(len(x), dtype=np.int64)
    j.fill_stream([(x[:700], pos[:700]), (x[700:], pos[700:])],
                  lists_dir=tmp_path / "filled" / "lists")
    codes = tmp_path / "filled" / "lists" / "codes.bin"
    before = codes.stat().st_mtime_ns
    j.save(tmp_path / "filled")                 # the in-place lists stay as written
    assert codes.stat().st_mtime_ns == before
    idx.fill(x)
    np.testing.assert_array_equal(j.search(x[:8], 5, nprobe=4)[1],
                                  idx.search(x[:8], 5, nprobe=4)[1])

    with pytest.raises(RuntimeError, match="already filled"):
        j.fill_stream([(x[:10], pos[:10])])
    with pytest.raises(ValueError, match="spherical"):
        IVFPQIndex(N_LISTS, DIM, spherical=False, device="cpu", **ARGS)

    # a legacy -N-less artifact still opens, serve-only
    legacy = tmp_path / "legacy"
    shutil.copytree(tmp_path / "filled", legacy)
    meta = json.loads((legacy / "meta.json").read_text())
    meta["spherical"] = False
    (legacy / "meta.json").write_text(json.dumps(meta))
    old = IVFPQIndex.load(legacy, device="cpu", chunk=CHUNK)
    assert not old.spherical and old.search(x[:2], 3, nprobe=2)[1].shape == (2, 3)
    for op in (lambda: old.train(x), lambda: old.fill_stream([(x[:10], pos[:10])])):
        with pytest.raises(ValueError, match="legacy"):
            op()


def test_train_stats_with_numpy_values_survive_json(tmp_path):
    x = corpus(3, n=1200)
    idx = IVFPQIndex(N_LISTS, DIM, device="cpu", **ARGS)
    idx.train(x, **TRAIN)
    idx.train_stats["extra"] = {"n": np.int64(3), "f": np.float32(0.5),
                                "a": np.arange(3), "t": (np.int32(1), 2.0)}
    idx.save(tmp_path / "a", include_lists=False)
    back = IVFPQIndex.load(tmp_path / "a", device="cpu", chunk=CHUNK).train_stats
    assert back["extra"] == {"n": 3, "f": 0.5, "a": [0, 1, 2], "t": [1, 2.0]}
    assert back["pq"]["mse"] == idx.train_stats["pq"]["mse"]
