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
    # the wgmma scan's k range (nprobe 32-256, flat search's k 100): rows
    # repeated, so exact ties reach the k-th place
    "k32_ties": (16, 64, 2048, 512, 2048, 32, "bf16"),
    "k64_ties": (9, 64, 2048, 512, 1977, 64, "bf16"),
    "k128_ties": (16, 64, 2048, 512, 2048, 128, "bf16"),
    "k256_ties": (5, 64, 2048, 512, 2000, 256, "bf16"),
}


def _inputs(case):
    qn, d, n, chunk, n_valid, k, dtype = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q = rng.standard_normal((qn, d)).astype(np.float32)
    if case == "dup_rows" or case.endswith("_ties"):
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
    """It no longer does: the wgmma scan keeps no per-query list in shared
    memory, so k 300 at Q 256 (32 queries per block before) and a k near
    the old limit (a few) keep the 256-query tile and one query tile, on
    tensor cores; the shared memory is the same at every k."""
    p = _plan(256, 65_536, 300, torch.bfloat16, H100_SMS)
    assert p.tensor_cores and p.cfg == max(_TC) and p.qb == 256
    big = _plan(256, 65_536, K_MAX_FMA, torch.bfloat16, H100_SMS)
    assert big.cfg == max(_TC) and big.qb == 256 and big.smem == p.smem


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("k", [2, 16, 32, 64, 100, 128, 256])
@pytest.mark.parametrize("qn,n_eff", [(1, 65_536), (129, 65_536), (256, 65_536),
                                      (128, 2_097_152), (256, 131_072)])
def test_plan_serves_up_to_256_queries_in_one_query_tile_at_every_k(qn, n_eff, k, fast):
    """The serve probe at nprobe 2-256, flat search at k up to 100 and the
    tune oracle: Q <= 256 takes one query tile (the corpus read once) on
    the smallest wgmma tile that holds it, whatever k; each (query, range)
    gets 2k + 2 (rows per tile) candidate slots (folded past k + rows per
    tile), and k/4 shared bins per query when the ranges' lanes are that
    many sources."""
    p = _plan(qn, n_eff, k, torch.bfloat16, H100_SMS, fast=fast)
    assert p.cfg == (min(_TC) if qn <= 128 else max(_TC)) and p.qb == qn
    assert p.smem == _smem(p.cfg, p.qb, 1) <= _BLOCK_SMEM
    assert p.cap == 2 * k + 2 * p.tn and p.nbins == -(-k // 4)
    assert H100_SMS // 2 < p.n_ranges <= H100_SMS


@pytest.mark.parametrize("qn,k", [(1, 2), (1, 16), (7, 16), (16, 300), (100, 64)])
def test_plan_gives_few_queries_the_128_query_tile(qn, k):
    """A few queries, the single-query path among them, run on the
    128-query tile with one block serving all of them; the tile's other
    query rows are masked."""
    p = _plan(qn, 65_536, k, torch.bfloat16, H100_SMS)
    assert p.cfg == min(_TC) and p.qb == qn and p.tn == _TC[p.cfg][1]


# -- the k-1 scan for many bf16 queries and the register-blocked f32 scan --------

from abstracts_search_tpu_torch.ops.topk import (  # noqa: E402
    _FMA, _K1, _K1_MIN_Q, _SIMT, _smem)


@pytest.mark.parametrize("qn", [131_072, 262_144])
def test_plan_gives_the_build_shape_the_k1_scan(qn):
    """The k-means assignment and the fill's coarse encode: exact mode at
    k 1 over 65,536 bf16 centroids of 1,024 dims takes the k-1 scan, whose
    ranges are the whole corpus (no second pass), on tensor cores."""
    p = _plan(qn, 65_536, 1, torch.bfloat16, H100_SMS)
    assert p.cfg in _K1 and p.tensor_cores
    assert (p.qb, p.tn) == _K1[p.cfg] and p.n_ranges == 1 and p.range_rows >= 65_536
    assert p.smem == _smem(p.cfg, p.qb, 1) <= _BLOCK_SMEM


@pytest.mark.parametrize("qn", [1, 16, 128, _K1_MIN_Q - 1])
def test_plan_keeps_the_wgmma_scan_below_the_k1_crossover(qn):
    """The serve probe at nprobe 1 (Q <= 256) and every Q under the
    crossover stay on the wgmma scan at k 1."""
    p = _plan(qn, 65_536, 1, torch.bfloat16, H100_SMS)
    assert p.cfg in _TC


@pytest.mark.parametrize("kw", [{"aligned": False}, {"fast": True}], ids=["unaligned", "fast"])
@pytest.mark.parametrize("qn", [_K1_MIN_Q, 131_072])
def test_plan_keeps_the_wgmma_scan_for_rows_tma_cannot_copy_and_fast_mode(qn, kw):
    """Rows that are not 16-byte aligned (d = 100: 200 bytes; d = 1,000 is
    2,000 bytes, aligned, its last 64-deep slice zero-filled by the copy)
    and fast mode keep the wgmma scan at any Q; k > 1 too."""
    assert _plan(qn, 65_536, 1, torch.bfloat16, H100_SMS, **kw).cfg in _TC
    assert _plan(qn, 65_536, 2, torch.bfloat16, H100_SMS).cfg in _TC


@pytest.mark.parametrize("cfg,qb,k", [(6, 128, 1), (4, 64, 1), (4, 64, 16), (5, 128, 1),
                                      (5, 128, 16), (4, 64, 200), (2, 128, 16), (2, 7, 256),
                                      (3, 256, 16), (3, 129, 256), (3, 256, 3288)])
def test_smem_mirror_covers_the_new_configurations(cfg, qb, k):
    """The Python mirror of topk_smem_bytes: the k-1 scan's ring of four
    48 KiB stages and its barriers, whatever k; the register-blocked
    scan's ring of four stages of 32-deep f32 rows (128 bytes), its
    barriers and its lists; the wgmma scan's ring of four 48 KiB stages,
    its barriers, 16 bytes per query of its tile, 16 of scratch and 32
    per thread of its 512, whatever k and however many queries the block
    serves."""
    if cfg in _K1:
        assert _smem(cfg, qb, k) == 1024 + 4 * (128 + 256) * 64 * 2 + 16 * 4
    elif cfg in _TC:
        qt, tn = _TC[cfg]
        assert _smem(cfg, qb, k) == (1024 + 4 * (qt + tn) * 64 * 2 + 64 + 16 * qt + 16
                                     + 32 * 512)
        assert (qt + tn) * 64 * 2 == 48 * 1024
    else:
        qt, tn = _SIMT[cfg]
        assert _smem(cfg, qb, k) == (1024 + 4 * (qt + tn) * 128 + 8 * 4 + 8 * qt * (k + 16)
                                     + 4 * qt)
    assert _smem(cfg, qb, k) <= _BLOCK_SMEM


@pytest.mark.parametrize("qn,n_eff,k,cfg", [
    (256, 4_096, 16, 4),        # the IVF-Flat probe: 64-query tiles
    (262_144, 4_096, 1, 5),     # plain-L2 k-means' windows: 128-query tiles
    (2_000_000, 256, 1, 5),
    (9, 8_192, 40, 4)])
def test_plan_gives_f32_the_register_blocked_scan(qn, n_eff, k, cfg):
    """f32 plans at the IVF-Flat probe and the plain-L2 k-means shape take
    the register-blocked scan on the CUDA cores (no tensor cores: true
    f32); k 1 with many queries has one range, so no second pass."""
    p = _plan(qn, n_eff, k, torch.float32, H100_SMS)
    assert p.cfg == cfg and not p.tensor_cores and (p.qb, p.tn) == _SIMT[cfg]
    if k == 1:
        assert p.n_ranges == 1


def test_plan_probe_ranges_fill_the_card_with_few_lists():
    """The IVF-Flat probe's 4 query tiles x 32 ranges of one 128-row tile:
    about one block per SM, and pass 2 merges 32 lists (64 before)."""
    p = _plan(256, 4_096, 16, torch.float32, H100_SMS)
    assert p.n_ranges == 32 and p.range_rows == 128
    assert H100_SMS // 2 <= 4 * p.n_ranges <= H100_SMS


@pytest.mark.parametrize("qn,k", [(1, 16), (8, 1), (8, 300), (40, 300), (300, 1024),
                                  (1000, K_MAX_FMA)])
def test_plan_keeps_the_8_query_fma_scan_for_few_queries_and_large_k(qn, k):
    """Q <= 8, and a k whose lists the register-blocked tiles do not hold,
    stay on the 8-query FMA scan (so every k it took is still taken)."""
    p = _plan(qn, 65_536, k, torch.float32, H100_SMS)
    assert p.cfg in _FMA and not p.tensor_cores and p.smem <= _BLOCK_SMEM
    if qn > 8:
        assert all(_smem(c, _SIMT[c][0], k) > _BLOCK_SMEM for c in _SIMT)
