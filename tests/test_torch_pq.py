"""The port's PQ and OPQ against the JAX package's, on the CPU.

From one seed both packages draw the same init rows and reseeds, so the
trained codebooks agree to atol 1e-5 (sums in another order). Encoding
with the JAX package's codebooks gives its codes except where two
codewords' distances lie within 1e-5 (``argmin`` takes the first index
on exact ties in both). Decoding is host numpy in both: bit for bit,
nibble-packed input included. OPQ after 2 outer iterations: rotation
within atol 1e-4 (an SVD of grams summed in another order),
``decode_unrotated`` within 1e-5.

Training data are full-rank anisotropic Gaussian rows: the gram's polar
factor is then well conditioned. A rounding-level difference can still
move a row across a codeword boundary it lies on within ~1e-7, and the
Lloyd iterations after it then part; these seeds put no row there.
"""

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from abstracts_search_tpu.index.opq import OPQ as JaxOPQ
from abstracts_search_tpu.index.pq import ProductQuantizer as JaxPQ
from abstracts_search_tpu.parallel import build_mesh
from abstracts_search_tpu.parallel.mesh import global_put
from abstracts_search_tpu_torch.index.opq import OPQ
from abstracts_search_tpu_torch.index.pq import ProductQuantizer

DIM = 32


def clustered(seed, n=3000, d=DIM, centers=24):
    """Rows near a few centers, so codebooks converge to a fixed point."""
    rng = np.random.default_rng(seed)
    cs = rng.standard_normal((centers, d)).astype(np.float32)
    return (cs[rng.integers(0, centers, n)]
            + 0.05 * rng.standard_normal((n, d)).astype(np.float32))


def aniso(seed, n, d=DIM):
    """Full-rank correlated unit rows."""
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((d, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32) @ mix
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def near_tie_free(x, c, codes_a, codes_b, m, tol=1e-5):
    """Codes equal except where the two codewords' f64 distances to the
    subvector lie within ``tol``."""
    dsub = x.shape[1] // m
    x3 = x.reshape(len(x), m, dsub).astype(np.float64)
    ci = np.arange(m)[None, :]
    da = ((x3 - c[ci, codes_a]) ** 2).sum(-1)
    db = ((x3 - c[ci, codes_b]) ** 2).sum(-1)
    differ = codes_a != codes_b
    return bool((np.abs(da - db)[differ] <= tol).all()), int(differ.sum())


@pytest.mark.parametrize("m,nbits", [(8, 4), (4, 8)], ids=["pq8x4", "pq4x8"])
def test_pq_train_matches_jax(m, nbits):
    x = aniso(10, 3000)
    jp = JaxPQ(DIM, m, nbits, mesh=build_mesh(), seed=3)
    tp = ProductQuantizer(DIM, m, nbits, seed=3, device="cpu")
    jp.train(x, iters=6, batch_rows=1000)
    tp.train(x, iters=6, batch_rows=1000)
    assert len(tp.stats["mse"]) == len(jp.stats["mse"])
    np.testing.assert_allclose(tp.stats["mse"], jp.stats["mse"], rtol=1e-4)
    np.testing.assert_allclose(tp.centroids, jp.centroids, rtol=0, atol=1e-5)


def test_pq_train_staged_matches_jax():
    """The staged path (OPQ's inner loop): rows already on the device;
    reseeds fetch sorted rows on both sides."""
    m, nbits = 8, 4
    x = clustered(1, n=2048)
    jp = JaxPQ(DIM, m, nbits, mesh=build_mesh(), seed=5)
    x3 = x.reshape(len(x), m, DIM // m)
    jp.train_staged(global_put(x3, jp.mesh, P("shard")),
                    global_put(np.ones((len(x), 1), np.float32), jp.mesh, P("shard")),
                    len(x), iters=5)
    tp = ProductQuantizer(DIM, m, nbits, seed=5, device="cpu")
    tp.train_staged(torch.from_numpy(x3), iters=5)
    np.testing.assert_allclose(tp.centroids, jp.centroids, rtol=0, atol=1e-5)


@pytest.mark.parametrize("m,nbits", [(8, 4), (4, 8)], ids=["pq8x4", "pq4x8"])
def test_pq_encode_decode_match_jax(m, nbits):
    x = clustered(2)
    jp = JaxPQ(DIM, m, nbits, mesh=build_mesh(), seed=0)
    jp.train(x, iters=4)
    tp = ProductQuantizer(DIM, m, nbits, device="cpu")
    tp.centroids = jp.centroids
    rng = np.random.default_rng(9)
    q = rng.standard_normal((1500, DIM)).astype(np.float32)
    jc, tc = jp.encode(q, batch_rows=500), tp.encode(q, batch_rows=500)
    assert tc.dtype == np.uint8 and tc.shape == (1500, m)
    ok, _ = near_tie_free(q, jp.centroids, tc, jc, m)
    assert ok
    np.testing.assert_array_equal(tp.decode(jc), jp.decode(jc))
    if nbits == 4:
        packed = (jc[:, 0::2] | (jc[:, 1::2] << 4)).astype(np.uint8)
        np.testing.assert_array_equal(tp.decode(packed), jp.decode(packed))
        np.testing.assert_array_equal(tp.decode(packed), tp.decode(jc))
    assert tp.reconstruction_mse(q) == pytest.approx(jp.reconstruction_mse(q), rel=1e-5)


def test_pq_encode_bounds_its_score_block():
    """Windows keep the [n, M, ksub] scores within SCORE_BYTES and give
    the unwindowed argmin."""
    x = clustered(3, n=900)
    tp = ProductQuantizer(DIM, 8, 4, seed=0, device="cpu")
    tp.train(x, iters=3)
    full = tp.encode(x)
    tp.SCORE_BYTES = 8 * 16 * 4 * 100        # 100 rows a window
    assert tp.window_rows() == 100
    np.testing.assert_array_equal(tp.encode(x), full)


def test_pq_validates_args():
    with pytest.raises(ValueError, match="divisible"):
        ProductQuantizer(30, 8, device="cpu")
    with pytest.raises(ValueError, match="nbits"):
        ProductQuantizer(32, 8, 9, device="cpu")
    with pytest.raises(RuntimeError, match="train"):
        ProductQuantizer(32, 8, device="cpu").encode(np.zeros((2, 32), np.float32))


@pytest.mark.parametrize("init", ["identity", "random"])
def test_opq_matches_jax(init):
    # correlated rows: a rotation helps, so the alternation moves R
    x = aniso(0, 2048)
    jo = JaxOPQ(DIM, 8, 4, mesh=build_mesh(), seed=1)
    to = OPQ(DIM, 8, 4, seed=1, device="cpu")
    jo.train(x, outer_iters=2, pq_iters=4, init=init, seed=6)
    to.train(x, outer_iters=2, pq_iters=4, init=init, seed=6, keep_staged=True)
    np.testing.assert_allclose(to.rotation, jo.rotation, rtol=0, atol=1e-4)
    np.testing.assert_allclose(to.stats["mse"], jo.stats["mse"], rtol=1e-4)
    codes = jo.encode(x[:300])
    np.testing.assert_allclose(to.decode_unrotated(codes), jo.decode_unrotated(codes),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(to.apply(x[:5]), jo.apply(x[:5]), rtol=0, atol=1e-4)
    xj, n = to.staged()
    assert n == len(x) and torch.equal(xj, torch.from_numpy(x))
    to.drop_staged()
    assert to.staged() is None
