"""The port's streaming top-k (plain PyTorch version) against the JAX
package's ``streaming_topk`` (``impl="xla"`` and ``"pallas_interpret"``).

Same numpy inputs, made from a seed, go through both. Exact mode:
indices must be identical (ties go to the lowest row on both sides) and
values agree to rtol=1e-5, atol=1e-6 (both accumulate in f32, in another
order). Fast mode: values and indices bit-equal. Its inputs are small
integers, so every dot product is exact in any order, and truncated
values tie everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abstracts_search_tpu.ops.topk import streaming_topk as jax_topk
from abstracts_search_tpu_torch.ops.topk import streaming_topk

CASES = {
    #            Q, D,  N,   chunk, n_valid, k,  dtype
    "f32":      (5, 32, 512, 128, 512, 10, "f32"),
    "bf16":     (5, 32, 512, 128, 512, 10, "bf16"),
    "n_valid":  (4, 16, 512, 128, 300, 10, "f32"),
    "k_gt_valid": (4, 16, 128, 128, 5, 16, "f32"),
    "k_gt_16":  (3, 16, 256, 64, 256, 32, "bf16"),
    "dup_rows": (6, 16, 256, 64, 250, 12, "f32"),
}


def _inputs(case):
    qn, d, n, chunk, n_valid, k, dtype = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q = rng.standard_normal((qn, d)).astype(np.float32)
    if case == "dup_rows":
        # every row repeats one of 20 distinct rows: exact ties everywhere
        x = rng.standard_normal((20, d)).astype(np.float32)[rng.integers(0, 20, n)]
    else:
        x = rng.standard_normal((n, d)).astype(np.float32)
    return q, x, n_valid, k, chunk, dtype


@pytest.mark.parametrize("jax_impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax(case, jax_impl):
    q, x, n_valid, k, chunk, dtype = _inputs(case)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    v, i = streaming_topk(torch.from_numpy(q).to(tdt), torch.from_numpy(x).to(tdt),
                          n_valid, k, chunk=chunk, impl="torch")
    jv, ji = jax_topk(jnp.asarray(q, jdt), jnp.asarray(x, jdt), jnp.int32(n_valid),
                      k, chunk=chunk, impl=jax_impl)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    if k > n_valid:
        assert np.isneginf(v.numpy()[:, n_valid:]).all()
        assert (i.numpy()[:, n_valid:] == 0).all()


def test_auto_takes_the_plain_version_on_cpu():
    q, x, n_valid, k, chunk, _ = _inputs("f32")
    a = streaming_topk(torch.from_numpy(q), torch.from_numpy(x), n_valid, k, chunk=chunk)
    b = streaming_topk(torch.from_numpy(q), torch.from_numpy(x), n_valid, k, chunk=chunk,
                       impl="torch")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_validates_args():
    q = torch.zeros((2, 8))
    with pytest.raises(ValueError):
        streaming_topk(q, torch.zeros((100, 8)), 100, 5, chunk=64)   # 100 % 64
    with pytest.raises(ValueError):
        streaming_topk(q, torch.zeros((64, 8)), 64, 65, chunk=64)    # k > chunk
    with pytest.raises(ValueError, match="power-of-two"):
        streaming_topk(q, torch.zeros((300, 8)), 300, 5, chunk=100, mode="fast")
    with pytest.raises(ValueError):
        streaming_topk(q, torch.zeros((64, 8)), 64, 5, chunk=64, mode="nope")
    with pytest.raises(ValueError):
        streaming_topk(q, torch.zeros((64, 8)), 64, 5, chunk=64, impl="pallas")


FAST_CASES = {
    #              Q, D,  N,    chunk, n_valid, k,  q range,    x range,     dtype
    "small_ints":  (5, 16, 512, 64, 512, 10, (-3, 3), (-3, 3), "f32"),
    # |q . x| up to ~7.8e6 < 2**23: exact sums, and truncation to
    # 23 - 7 mantissa bits merges nearby values into ties
    "truncating":  (4, 16, 1024, 128, 1000, 12, (-700, 700), (-700, 700), "f32"),
    "negative":    (4, 16, 512, 128, 512, 10, (1, 700), (-700, -1), "f32"),
    "n_valid_lt_k": (3, 16, 256, 128, 5, 10, (-3, 3), (-3, 3), "f32"),
    "none_valid":  (2, 16, 256, 128, 0, 10, (-3, 3), (-3, 3), "f32"),
    "k_gt_16":     (3, 16, 512, 64, 450, 24, (-3, 3), (-3, 3), "f32"),
    "bf16":        (5, 16, 512, 64, 480, 10, (-3, 3), (-3, 3), "bf16"),
}


def _fast_inputs(case):
    qn, d, n, chunk, n_valid, k, qr, xr, dtype = FAST_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q = rng.integers(qr[0], qr[1] + 1, (qn, d)).astype(np.float32)
    x = rng.integers(xr[0], xr[1] + 1, (n, d)).astype(np.float32)
    return q, x, n_valid, k, chunk, dtype


@pytest.mark.parametrize("jax_impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("case", list(FAST_CASES))
def test_fast_mode_matches_jax_bit_for_bit(case, jax_impl):
    q, x, n_valid, k, chunk, dtype = _fast_inputs(case)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    v, i = streaming_topk(torch.from_numpy(q).to(tdt), torch.from_numpy(x).to(tdt),
                          n_valid, k, chunk=chunk, impl="torch", mode="fast")
    jv, ji = jax_topk(jnp.asarray(q, jdt), jnp.asarray(x, jdt), jnp.int32(n_valid),
                      k, chunk=chunk, impl=jax_impl, mode="fast")
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    if n_valid < k:
        assert np.isneginf(v.numpy()[:, max(n_valid, 0):]).all()


def test_fast_mode_worked_case():
    """Equal truncated values: the earlier chunk wins, then the higher
    lane. With fewer valid rows than k, the tail holds chunk 0's sentinel
    rows, highest lane first, at -inf."""
    q = torch.ones((1, 4))
    x = torch.zeros((256, 4))
    x[[3, 10, 130, 200]] = 1
    v, i = streaming_topk(q, x, 256, 4, chunk=128, mode="fast")
    assert i.tolist() == [[10, 3, 200, 130]] and v.tolist() == [[4.0] * 4]
    v, i = streaming_topk(q, x, 6, 10, chunk=128, mode="fast")
    assert i.tolist() == [[3, 5, 4, 2, 1, 0, 127, 126, 125, 124]]
    assert v.tolist() == [[4.0, 0, 0, 0, 0, 0] + [float("-inf")] * 4]


def test_fast_mode_keys_round_trip():
    """Decoding a packed key gives the score truncated toward -inf and
    the lane: a negative score grows in magnitude even when its low bits
    are zero, since its key's low bits are ones."""
    from abstracts_search_tpu_torch.ops.topk import _pack_keys, _unpack_keys

    s = torch.tensor([[1.0 + 2**-22, -(1.0 + 2**-22), 3.5, -0.75]])
    lanes = torch.tensor([5, 0, 7, 2], dtype=torch.int32)
    v, lane = _unpack_keys(_pack_keys(s, lanes, 3), 3)
    assert lane[0].tolist() == lanes.tolist()
    assert v[0, 0] == 1.0 and v[0, 1] < -(1.0 + 2**-22)
    assert v[0, 2] == 3.5
    assert v[0, 3] == torch.tensor(-0.75).view(torch.int32).add(7).view(torch.float32)


def test_cuda_impl_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        streaming_topk(torch.zeros((2, 8)), torch.zeros((64, 8)), 64, 5, chunk=64,
                       impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        streaming_topk(torch.zeros((2, 8)), torch.zeros((64, 8)), 64, 5, chunk=64,
                       impl="cuda", mode="fast")


# -- the CUDA kernel's launch plan (pure Python, so it is tested here) ---------

from abstracts_search_tpu_torch.ops.topk import _BLOCK_SMEM, _TC, _plan  # noqa: E402

# the largest k the f32-FMA design of the kernel took at its 8-query tile
K_MAX_FMA = (_BLOCK_SMEM - 4 * (8 * 32 + 128 * 33 + 8 * 128)) // (8 * 8)
H100_SMS = 132


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qn,n_eff,k", [
    (1, 65_536, 16), (7, 65_536, 2), (129, 65_536, 16), (256, 65_536, 16),
    (300, 65_536, 300), (128, 2_097_152, 10), (5, 0, 10), (40, 1_500, 64),
    (3, 7, 16), (256, 50_001, 300), (1, 65_536, K_MAX_FMA)])
def test_plan_ranges_cover_the_corpus_once_tile_aligned(dtype, qn, n_eff, k):
    p = _plan(qn, n_eff, k, dtype, H100_SMS)
    assert p.range_rows % p.tn == 0 and p.range_rows >= p.tn
    assert p.n_ranges * p.range_rows >= n_eff        # every valid row in a range
    assert (p.n_ranges - 1) * p.range_rows < max(n_eff, 1)   # no empty range
    assert p.smem <= _BLOCK_SMEM and 1 <= p.qb


@pytest.mark.parametrize("qn", [1, 7, 9, 16, 17, 129, 300, 1000])
@pytest.mark.parametrize("k", [1, 16, 300, 1024, K_MAX_FMA])
def test_plan_takes_every_q_and_k_the_fma_design_took(qn, k):
    for dtype in (torch.float32, torch.bfloat16):
        p = _plan(qn, 65_536, k, dtype, H100_SMS)
        assert p.smem <= _BLOCK_SMEM
        assert -(-qn // p.qb) * p.qb >= qn


def test_plan_raises_for_a_k_no_block_holds():
    with pytest.raises(ValueError, match="shared memory"):
        _plan(4, 65_536, K_MAX_FMA + 1, torch.float32, H100_SMS)
    with pytest.raises(ValueError, match="shared memory"):
        _plan(4, 65_536, 40_000, torch.bfloat16, H100_SMS)
    with pytest.raises(TypeError):
        _plan(4, 65_536, 10, torch.float16, H100_SMS)


@pytest.mark.parametrize("qn", [1, 8, 37, 300])
def test_plan_f32_takes_the_fma_scan_and_bf16_tensor_cores(qn):
    assert not _plan(qn, 8_192, 40, torch.float32, H100_SMS).tensor_cores
    assert _plan(qn, 8_192, 40, torch.bfloat16, H100_SMS).tensor_cores


@pytest.mark.parametrize("qn,k", [(1, 16), (16, 16), (17, 10), (128, 10), (129, 16),
                                  (256, 16)])
def test_plan_reads_the_corpus_once_up_to_256_queries(qn, k):
    """One query tile (grid y 1) for the probe's and flat search's shapes,
    and the ranges fill at most one wave of the card."""
    p = _plan(qn, 2_097_152, k, torch.bfloat16, H100_SMS)
    assert p.qb == qn
    assert p.n_ranges <= H100_SMS


def test_plan_narrows_the_query_tile_for_large_k():
    """k 300 at Q 256 does not fit 128 or 256 lists of 300: the
    128-query tile takes it with 32 queries per block, still on tensor
    cores; a k near the old limit goes down to a few queries per block."""
    p = _plan(256, 65_536, 300, torch.bfloat16, H100_SMS)
    assert p.tensor_cores and p.cfg == min(_TC) and p.qb == 32
    assert _plan(256, 65_536, K_MAX_FMA, torch.bfloat16, H100_SMS).qb < 32


@pytest.mark.parametrize("qn,k", [(1, 2), (1, 16), (7, 16), (16, 300), (100, 64)])
def test_plan_gives_few_queries_the_128_query_tile(qn, k):
    """A few queries, the single-query path among them, run on the
    128-query tile with one block serving all of them; the tile's other
    query rows are masked."""
    p = _plan(qn, 65_536, k, torch.bfloat16, H100_SMS)
    assert p.cfg == min(_TC) and p.qb == qn and p.tn == _TC[p.cfg][1]
