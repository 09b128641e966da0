"""The port's k-means against the JAX package's, on the CPU.

Both packages draw their init rows and split jitter from one numpy
generator in the same order, so from one seed every fit mode (array,
memmap, iterable, staged, device-streamed) must run the same number of
iterations, split the same empties and assign the same rows. Centroids
agree to atol 1e-5: the port sums in f32 segment sums, the JAX package
by one-hot matmuls, in another order. A single Lloyd step on random
data may assign differently only where a row's two best centroids score
within 1e-5 (in exact arithmetic on the kernel's operands); its sums
agree to rtol 1e-5.
"""

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from abstracts_search_tpu.index.kmeans import KMeans as JaxKMeans
from abstracts_search_tpu.parallel import build_mesh
from abstracts_search_tpu.parallel.mesh import global_put
from abstracts_search_tpu_torch.index.kmeans import KMeans, _l2_augment, _round_up

CHUNK = 128


def blobs(seed, n_per=128, centers=8, dim=16, scale=0.05):
    rng = np.random.default_rng(seed)
    cs = rng.standard_normal((centers, dim)).astype(np.float32)
    cs /= np.linalg.norm(cs, axis=1, keepdims=True)
    x = np.repeat(cs, n_per, axis=0) + scale * rng.standard_normal(
        (centers * n_per, dim)).astype(np.float32)
    return x[rng.permutation(len(x))]


class CpuChunks:
    """A chunked device source on the CPU: chunk j is rows j*ch:(j+1)*ch
    of ``x`` as a tensor (``to_jax``: a row-sharded JAX array)."""

    prenormalized = False

    def __init__(self, x, chunk_rows, to_jax=False):
        self.x, self.chunk_rows, self.to_jax = x, chunk_rows, to_jax
        self.num_chunks = len(x) // chunk_rows
        self.shape = x.shape

    def __len__(self):
        return len(self.x)

    def device_chunk(self, j):
        c = self.x[j * self.chunk_rows:(j + 1) * self.chunk_rows]
        return global_put(c, build_mesh(), P("shard")) if self.to_jax else torch.from_numpy(c)

    def gather_rows(self, idx):
        return self.x[np.asarray(idx)]


def jax_staged(km, x):
    ndev = km.ndev
    total = ((len(x) + ndev - 1) // ndev + 7) // 8 * 8 * ndev
    xp = np.zeros((total, x.shape[1]), np.float32)
    xp[: len(x)] = x
    valid = np.zeros((total, 1), np.float32)
    valid[: len(x)] = 1
    return global_put(xp, km.mesh, P("shard")), global_put(valid, km.mesh, P("shard"))


def run_both(mode, x, k, spherical, seed, tmp_path, iters=6):
    kw = dict(spherical=spherical, chunk=CHUNK, seed=seed)
    jk = JaxKMeans(k, mesh=build_mesh(), **kw)
    tk = KMeans(k, device="cpu", **kw)
    if mode == "array":
        jk.fit(x, iters=iters, batch_rows=300)
        tk.fit(x, iters=iters, batch_rows=300)
    elif mode == "memmap":
        mm = np.memmap(tmp_path / "x.f32", dtype=np.float32, mode="w+", shape=x.shape)
        mm[:] = x
        mm.flush()
        ro = np.memmap(tmp_path / "x.f32", dtype=np.float32, mode="r", shape=x.shape)
        jk.fit(ro, iters=iters, batch_rows=300)
        tk.fit(ro, iters=iters, batch_rows=300)
    elif mode == "iterable":
        parts = [x[:400], x[400:650], x[650:]]
        jk.fit(iter(parts), iters=iters, batch_rows=300)
        tk.fit(iter(parts), iters=iters, batch_rows=300)
    elif mode == "staged":
        jk.fit_staged(*jax_staged(jk, x), len(x), iters=iters)
        # rows past n_total must not train
        pad = np.concatenate([x, np.full((5, x.shape[1]), 9.0, np.float32)])
        tk.fit_staged(torch.from_numpy(pad), len(x), iters=iters, batch_rows=300)
    elif mode == "device_stream":
        jk.fit(CpuChunks(x, 256, to_jax=True), iters=iters)
        tk.fit(CpuChunks(x, 256), iters=iters, batch_rows=100)
    return jk, tk


def assert_same_fit(jk, tk, x):
    for key in ("iters_run", "empty_splits", "k", "n_train"):
        assert tk.stats[key] == jk.stats[key], key
    np.testing.assert_allclose(tk.stats["objective"], jk.stats["objective"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tk.centroids, jk.centroids, rtol=0, atol=1e-5)
    _, ja = jk.assign(x)
    _, ta = tk.assign(x)
    np.testing.assert_array_equal(ta, ja)


@pytest.mark.parametrize("mode", ["array", "memmap", "iterable", "staged", "device_stream"])
def test_fit_matches_jax(mode, tmp_path):
    x = blobs(0)
    jk, tk = run_both(mode, x, 8, True, 1, tmp_path)
    assert_same_fit(jk, tk, x)
    if mode == "device_stream":
        assert tk.stats["mode"] == jk.stats["mode"] == "device_stream"
    np.testing.assert_allclose(np.linalg.norm(tk.centroids, axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("mode", ["array", "device_stream"])
def test_plain_l2_fit_matches_jax(mode, tmp_path):
    """Norm-separated blobs (radii 1-20): plain L2 through the augmented
    f32 operands (the kernel's FMA route on the card)."""
    x = blobs(4, n_per=64, centers=4, dim=16)
    x = x * np.repeat(np.array([1.0, 5.0, 10.0, 20.0], np.float32), 64)[:, None]
    x = np.ascontiguousarray(x[np.random.default_rng(5).permutation(len(x))])
    jk, tk = run_both(mode, x, 4, False, 3, tmp_path)
    assert_same_fit(jk, tk, x)
    assert np.linalg.norm(tk.centroids, axis=1).max() > 10


@pytest.mark.parametrize("spherical", [True, False], ids=["spherical", "l2"])
@pytest.mark.parametrize("mode", ["array", "device_stream"])
def test_empty_split_repair_matches_jax(mode, spherical, tmp_path):
    """Identical rows: every score ties, row 0's centroid takes all, the
    other 15 are empty and split with the seeded jitter (scaled by the
    source centroid's norm in plain L2) on both sides."""
    x = np.ones((512, 8), np.float32) * (1.0 if spherical else 3.0)
    jk, tk = run_both(mode, x, 16, spherical, 0, tmp_path, iters=3)
    assert sum(tk.stats["empty_splits"]) > 0
    assert_same_fit(jk, tk, x)


def exact_scores(x, c, spherical):
    """Exact (f64) scores of the kernel's own operands: bf16-rounded for
    spherical, the augmented f32 ones for plain L2."""
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    if spherical:
        return (xt.bfloat16().double() @ ct.bfloat16().double().T).numpy()
    xa, ca = _l2_augment(xt, ct)
    return (xa.double() @ ca.double().T).numpy()


@pytest.mark.parametrize("spherical", [True, False], ids=["spherical", "l2"])
def test_one_lloyd_step_matches_jax(spherical):
    rng = np.random.default_rng(11)
    n, d, k = 2000, 32, 40
    x = rng.standard_normal((n, d)).astype(np.float32)
    if spherical:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    c = x[rng.choice(n, k, replace=False)] + 0.1 * rng.standard_normal((k, d)).astype(
        np.float32)
    if spherical:
        c /= np.linalg.norm(c, axis=1, keepdims=True)

    jk = JaxKMeans(k, mesh=build_mesh(), spherical=spherical, chunk=CHUNK)
    jk.centroids = c
    step = jk._build_step(n // jk.ndev, d)
    js, jcnt, jobj = step(*jax_staged(jk, x), global_put(jk._centroids_padded(), jk.mesh))
    _, ja = jk.assign(x)

    tk = KMeans(k, spherical=spherical, chunk=CHUNK, device="cpu")
    tk.centroids = c
    c_pad = tk._centroids_padded()
    assert c_pad.shape == (_round_up(k, CHUNK), d)
    ts, tcnt, tobj = tk._step(torch.from_numpy(x), c_pad)
    _, ta = tk.assign(x)

    s = np.sort(exact_scores(x, c, spherical), axis=1)
    gap = s[:, -1] - s[:, -2]
    differ = ta != ja
    assert (gap[differ] <= 1e-5).all()
    if not differ.any():
        np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tobj), float(jobj), rtol=1e-5)
    # the segment sums are the per-cluster sums of the assigned rows
    ref = np.zeros((k, d))
    np.add.at(ref, ta, x.astype(np.float64))
    np.testing.assert_allclose(ts.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_assign_matches_jax():
    x = blobs(7)
    jk, tk = run_both("array", x, 8, True, 2, None, iters=3)
    rng = np.random.default_rng(8)
    fresh = rng.standard_normal((700, 16)).astype(np.float32)
    jv, ja = jk.assign(fresh, batch_rows=256)
    tv, ta = tk.assign(fresh, batch_rows=256)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
    assert ta.dtype == np.int64


def test_too_few_rows_refused():
    with pytest.raises(ValueError, match="need >= k"):
        KMeans(64, device="cpu").fit(np.ones((10, 4), np.float32))
