"""The port's FlatIndex and merge_topk (plain PyTorch route, on the CPU)
against the JAX package's FlatIndex on the 8-device CPU mesh.

Same numpy inputs go through both. Positions must be identical: on both
sides the result is the global top-k under (value desc, row asc), the
JAX one by per-device top-k plus an all-gather merge in which the lower
device wins ties. Scores agree to rtol=1e-5, atol=1e-5 (f32 sums in
another order); with small-integer inputs, where every sum is exact,
they are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from abstracts_search_tpu.index import FlatIndex as JaxFlat
from abstracts_search_tpu.parallel import build_mesh
from abstracts_search_tpu_torch.index import FlatIndex
from abstracts_search_tpu_torch.parallel import merge_topk

CASES = {
    #            n,    d,  Q,  k,  chunk, ints
    "random":   (5000, 64, 16, 10, 256, False),
    "uneven":   (777, 32, 4, 20, 128, False),
    # 30 distinct integer rows repeated: exact ties across every device
    "ties":     (2000, 16, 6, 25, 64, True),
}


def _inputs(case):
    n, d, qn, k, chunk, ints = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    if ints:
        x = rng.integers(-3, 4, (30, d)).astype(np.float32)[rng.integers(0, 30, n)]
        q = rng.integers(-3, 4, (qn, d)).astype(np.float32)
    else:
        x = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((qn, d)).astype(np.float32)
    return x, q, k, chunk, ints


@pytest.mark.parametrize("case", list(CASES))
def test_search_matches_jax(case):
    x, q, k, chunk, ints = _inputs(case)
    jidx = JaxFlat(build_mesh(), chunk=chunk)
    jidx.add(x)
    idx = FlatIndex(chunk=chunk, device="cpu")
    idx.add(x)
    assert idx.n == jidx.n == len(x) and idx.dim == jidx.dim
    assert idx.dtype == torch.float32 and idx._x.shape[0] % chunk == 0
    jv, jp = jidx.search(q, k)
    v, p = idx.search(q, k)
    assert v.dtype == np.float32 and p.dtype == np.int64
    np.testing.assert_array_equal(p, jp)
    if ints:
        np.testing.assert_array_equal(v, jv)
    else:
        np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-5)
    assert (p < len(x)).all() and np.isfinite(v).all()


def test_incremental_add_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((100, 16)).astype(np.float32)
    b = rng.standard_normal((50, 16)).astype(np.float32)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    jidx = JaxFlat(build_mesh(), chunk=64)
    idx = FlatIndex(chunk=64, device="cpu")
    for part in (a, b):
        jidx.add(part)
        idx.add(torch.from_numpy(part))          # tensors are taken as well
    assert idx.n == 150 and idx._x.shape == (192, 16)
    assert not idx._x[150:].any()                # the padding is zeros
    jv, jp = jidx.search(q, 5)
    v, p = idx.search(q, 5)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-5)


def test_merge_topk_tie_order():
    """Part-major concatenation and a stable top-k: among equal values
    the lower part wins, then the earlier entry in its list, as lax.top_k
    over the all-gathered candidates picks them."""
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 4, (5, 3, 6)).astype(np.float32)      # [P, Q, kl]
    vals[2, 1] = -np.inf
    idx = rng.integers(0, 1000, (5, 3, 6)).astype(np.int32)
    v, i = merge_topk(torch.from_numpy(vals), torch.from_numpy(idx), 9)
    cat_v = jnp.asarray(vals.transpose(1, 0, 2).reshape(3, 30))
    cat_i = idx.transpose(1, 0, 2).reshape(3, 30)
    jv, sel = lax.top_k(cat_v, 9)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.take_along_axis(cat_i, np.asarray(sel), 1))


def test_refuses_what_it_cannot_do():
    idx = FlatIndex(chunk=64, device="cpu")
    with pytest.raises(RuntimeError, match="empty"):
        idx.search(np.zeros((1, 8), np.float32), 1)
    idx.add(np.zeros((10, 8), np.float32))
    with pytest.raises(ValueError):
        idx.add(np.zeros((10, 9), np.float32))
    cuda_on_cpu = FlatIndex(chunk=64, impl="cuda", device="cpu")
    cuda_on_cpu.add(np.zeros((4, 8), np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_on_cpu.search(np.zeros((1, 8), np.float32), 2)
