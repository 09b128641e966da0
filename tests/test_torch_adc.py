"""The port's ADC scans (plain PyTorch versions) against the JAX
package's.

``adc_topk`` against ``adc_topk_xla(transposed=True)`` and
``adc_topk_pallas(interpret=True)``: rows must be identical wherever a
value is finite (against the Pallas kernel everywhere: both report row 0
for an empty slot, where XLA's top_k counts on through the masked rows).
Values agree to rtol=1e-5: each side sums the M lookups in f32, in
another order.

``adc_scan`` against ``adc_scan_xla`` and ``adc_scan_pallas(interpret=
True)`` for every layout: equal. Its LUT values are dyadic (multiples of
1/8 below 8), so every sum is exact in any order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abstracts_search_tpu.ops.adc import (adc_scan_pallas, adc_scan_xla, adc_topk_pallas,
                                          adc_topk_xla)
from abstracts_search_tpu_torch.ops.adc import adc_scan, adc_topk


def _inputs(ksub, m, seed, n_segs=6, seg=32, q=3, spq=4):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, ksub, (n_segs, seg, m), dtype=np.uint8)
    wire = codes[..., 0::2] | (codes[..., 1::2] << 4) if ksub == 16 else codes
    codes_t = np.ascontiguousarray(wire.transpose(0, 2, 1))     # [n_segs, MB, SEG]
    luts = rng.standard_normal((q, m, ksub)).astype(np.float32)
    n_slots = q * spq
    seg_ids = rng.integers(0, n_segs, n_slots).astype(np.int32)
    q_ids = np.repeat(np.arange(q, dtype=np.int32), spq)        # query-major
    valid = rng.integers(0, seg + 1, n_slots).astype(np.int32)
    valid[[0, 5]] = 0                                           # empty slots
    valid[1] = seg                                              # a full one
    return codes, codes_t, luts, seg_ids, q_ids, valid


def _numpy_scores(codes, luts, seg_ids, q_ids, valid):
    m = codes.shape[2]
    lut = luts[q_ids]                                            # [S, M, ksub]
    c = codes[seg_ids].astype(np.int64)                          # [S, SEG, M]
    s = np.take_along_axis(lut[:, None], c[..., None], axis=3)[..., 0]
    s = s.astype(np.float64).sum(-1)
    s[np.arange(codes.shape[1])[None, :] >= valid[:, None]] = -np.inf
    assert s.shape[-1] == codes.shape[1] and m == luts.shape[1]
    return s


@pytest.mark.parametrize("kp", [4, 32])
@pytest.mark.parametrize("ksub,m", [(16, 8), (256, 4)], ids=["packed", "unpacked"])
def test_matches_jax(ksub, m, kp):
    codes, codes_t, luts, seg_ids, q_ids, valid = _inputs(ksub, m, seed=ksub + kp)
    v, rows = adc_topk(*(torch.from_numpy(a) for a in (codes_t, luts, seg_ids, q_ids,
                                                       valid)), kp, impl="torch")
    v, rows = v.numpy(), rows.numpy()
    jargs = tuple(jnp.asarray(a) for a in (codes_t, luts, seg_ids, q_ids, valid))
    xv, xr = (np.asarray(a) for a in adc_topk_xla(*jargs, kp, transposed=True))
    pv, pr = (np.asarray(a) for a in adc_topk_pallas(*jargs, kp, interpret=True))
    live = np.isfinite(v)
    for ov, orow in ((xv, xr), (pv, pr)):
        np.testing.assert_array_equal(np.isfinite(ov), live)
        np.testing.assert_allclose(v[live], ov[live], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(rows[live], orow[live])
    np.testing.assert_array_equal(rows, pr)
    # the empty slots are all -inf, and every winner is a valid row
    assert np.isneginf(v[[0, 5]]).all()
    assert (rows[live] < np.broadcast_to(valid[:, None], rows.shape)[live]).all()
    # and the sums are the lookups' (float64 oracle)
    ref = _numpy_scores(codes, luts, seg_ids, q_ids, valid)
    np.testing.assert_allclose(v[live], np.take_along_axis(ref, rows, 1)[live],
                               rtol=1e-5, atol=1e-5)


def test_nibble_order():
    """Byte j holds subspace 2j in its low nibble and 2j+1 in its high
    nibble: swapping the nibbles must change the scores."""
    codes, codes_t, luts, seg_ids, q_ids, valid = _inputs(16, 8, seed=3)
    valid[:] = codes.shape[1]
    args = [torch.from_numpy(a) for a in (codes_t, luts, seg_ids, q_ids, valid)]
    v, rows = adc_topk(*args, 32, impl="torch")
    ref = _numpy_scores(codes, luts, seg_ids, q_ids, valid)
    np.testing.assert_allclose(v.numpy(), np.take_along_axis(ref, rows.numpy(), 1),
                               rtol=1e-5, atol=1e-5)
    swapped = ((codes_t & 15) << 4) | (codes_t >> 4)
    args[0] = torch.from_numpy(np.ascontiguousarray(swapped))
    vs, _ = adc_topk(*args, 32, impl="torch")
    assert not np.allclose(vs.numpy(), v.numpy())


def test_validates_args():
    codes, codes_t, luts, seg_ids, q_ids, valid = _inputs(16, 8, seed=4)
    args = [torch.from_numpy(a) for a in (codes_t, luts, seg_ids, q_ids, valid)]
    with pytest.raises(ValueError):
        adc_topk(*args, 33, impl="torch")                         # kp > SEG
    with pytest.raises(ValueError):
        adc_topk(args[0][:, :3], *args[1:], 4, impl="torch")       # bytes != M/2
    with pytest.raises(ValueError):
        adc_topk(*args, 4, impl="xla")


def test_cuda_impl_refuses_cpu_tensors():
    codes, codes_t, luts, seg_ids, q_ids, valid = _inputs(16, 8, seed=5)
    args = [torch.from_numpy(a) for a in (codes_t, luts, seg_ids, q_ids, valid)]
    with pytest.raises(ValueError, match="CUDA"):
        adc_topk(*args, 4, impl="cuda")


SCAN_LAYOUTS = {
    #                     ksub, M, transposed, packed  (TPU kernel)
    "t_packed":          (16, 8, True, True),          # _adc_kernel_t
    "t_bytes":           (256, 4, True, False),        # _adc_kernel_t
    "rows_packed":       (16, 8, False, True),         # _adc_kernel_packed4
    "rows_bytes":        (256, 4, False, False),       # _adc_kernel
    "rows_4bit_bytes":   (16, 4, False, False),        # _adc_kernel, legacy 4-bit
}


@pytest.mark.parametrize("layout", list(SCAN_LAYOUTS))
def test_scan_matches_jax(layout):
    ksub, m, transposed, packed = SCAN_LAYOUTS[layout]
    codes, codes_t, luts, seg_ids, q_ids, _ = _inputs(ksub, m, seed=len(layout))
    luts = np.random.default_rng(9).integers(-64, 64, luts.shape).astype(np.float32) / 8
    if packed:
        wire = codes[..., 0::2] | (codes[..., 1::2] << 4)       # [n_segs, SEG, M/2]
    else:
        wire = codes
    payload = np.ascontiguousarray(wire.transpose(0, 2, 1) if transposed else wire)
    got = adc_scan(*(torch.from_numpy(a) for a in (payload, luts, seg_ids, q_ids)),
                   transposed=transposed, impl="torch").numpy()
    jargs = tuple(jnp.asarray(a) for a in (payload, luts, seg_ids, q_ids))
    assert got.dtype == np.float32 and got.shape == (len(seg_ids), codes.shape[1])
    np.testing.assert_array_equal(got, np.asarray(adc_scan_xla(*jargs,
                                                              transposed=transposed)))
    np.testing.assert_array_equal(got, np.asarray(adc_scan_pallas(
        *jargs, interpret=True, transposed=transposed)))
    everything = np.full(len(seg_ids), codes.shape[1], np.int32)
    np.testing.assert_array_equal(got, _numpy_scores(codes, luts, seg_ids, q_ids,
                                                     everything))


def test_scan_validates_args():
    codes, codes_t, luts, seg_ids, q_ids, _ = _inputs(16, 8, seed=6)
    args = [torch.from_numpy(a) for a in (codes_t, luts, seg_ids, q_ids)]
    with pytest.raises(ValueError):
        adc_scan(*args, transposed=False, impl="torch")            # SEG is not M/2
    with pytest.raises(ValueError):
        adc_scan(args[0], args[1], args[2], args[3][:-1], transposed=True, impl="torch")
    with pytest.raises(ValueError, match="CUDA"):
        adc_scan(*args, transposed=True, impl="cuda")
    with pytest.raises(ValueError):
        adc_scan(*args, transposed=True, impl="xla")


# -- launch plans of the staged kernels (pure Python, no card) ------------------------

from abstracts_search_tpu_torch.ops.adc import _SMEM_LIMIT, _adc_plan, _stage_smem  # noqa: E402

H100_SMS = 132


def _old_accepts(kind, m, ksub, seg):
    """The shared-memory check of the unstaged wrappers this plan replaced."""
    lut_words = m * ksub
    return 4 * (lut_words + (seg if kind == "topk" else 0)) <= _SMEM_LIMIT


def _lut_near_the_limit(kind, mb, seg, m, ksub):
    """What the staged kernels refuse: a LUT within one chunk (a byte-row
    of SEG bytes transposed, a row of MB bytes row-major), plus the ring's
    fixed bytes, of the limit. The old raw wrapper took these where the
    LUT alone fitted."""
    lut = 4 * m * ksub
    unit = mb if kind == "rows" else seg
    return _stage_smem(1, 1, unit, lut, 1 if lut > _SMEM_LIMIT // 2 else 2) > _SMEM_LIMIT


@pytest.mark.parametrize("seg", [1, 7, 32, 100, 256, 512, 1000, 4096])
@pytest.mark.parametrize("m,ksub", [(8, 16), (16, 16), (64, 16), (128, 16), (3, 256),
                                    (24, 256), (64, 256), (128, 256), (200, 256),
                                    (226, 256), (227, 256), (256, 256)])
def test_adc_plan_accepts_what_the_old_wrapper_did(m, ksub, seg):
    """Every kind over each payload it takes: the fused scan and the
    transposed raw scan ("cols") over [MB, SEG] tiles, the row-major raw
    scan ("rows") over [SEG, MB] ones; nibble-packed (MB = M/2) where ksub
    is 16 and M even, and a code a byte (MB = M) always."""
    mbs = [m] + ([m // 2] if ksub == 16 and m % 2 == 0 else [])
    for kind in ("topk", "cols", "rows"):
        for mb in mbs:
            if _lut_near_the_limit(kind, mb, seg, m, ksub):
                # the fused scan's old wrapper refused these too
                assert kind != "topk" or not _old_accepts(kind, m, ksub, seg)
                with pytest.raises(ValueError):
                    _adc_plan(kind, mb, seg, m, ksub, 1000, H100_SMS)
                continue
            assert _old_accepts(kind, m, ksub, seg) or kind == "topk"
            p = _adc_plan(kind, mb, seg, m, ksub, 1000, H100_SMS)
            assert p.smem == _stage_smem(p.warps, p.depth, p.chunk_bytes, 4 * m * ksub,
                                         p.n_luts)
            assert p.smem <= _SMEM_LIMIT
            assert 1 <= p.warps <= 16 and 1 <= p.depth <= 3 and p.n_luts in (1, 2)
            # two LUT buffers below 64 KiB, as before, and above only with
            # 8 warps at full depth beside them
            if 4 * m * ksub < 64 * 1024:
                assert p.n_luts == 2
            elif p.n_luts == 2:
                assert p.warps >= 8 and p.depth == 3
            unit, units = (mb, seg) if kind == "rows" else (seg, mb)
            assert 1 <= p.chunk <= units and p.chunk_bytes == p.chunk * unit
            if kind != "rows":   # a power of two of rows per lane; passes cover SEG
                assert p.rows in (1, 2, 4, 8, 16)
                assert 32 * p.rows * p.passes >= seg > 32 * p.rows * (p.passes - 1)
                assert p.passes == 1 or p.rows == 16
            assert p.grid == min(1000, H100_SMS)


@pytest.mark.parametrize("kind,m,seg", [("rows", 226, 256), ("rows", 227, 256),
                                        ("cols", 226, 256), ("cols", 226, 1000)])
def test_adc_plan_refuses_only_a_lut_near_the_limit(kind, m, seg):
    """ksub 256: a 226-subspace LUT (231,424 bytes) leaves room for one
    row, or one byte-row of 256 codes, but not for a byte-row of 1000; a
    227-subspace LUT fills the whole 232,448 bytes."""
    if _lut_near_the_limit(kind, m, seg, m, 256):
        assert (m, seg) in ((227, 256), (226, 1000))
        with pytest.raises(ValueError, match="do not fit"):
            _adc_plan(kind, m, seg, m, 256, 1000, H100_SMS)
    else:
        p = _adc_plan(kind, m, seg, m, 256, 1000, H100_SMS)
        assert p.depth >= 1 and p.warps >= 1 and p.smem <= _SMEM_LIMIT


@pytest.mark.parametrize("kind", ["topk", "cols", "rows"])
def test_adc_plan_keeps_chunks_in_flight_at_the_production_shape(kind):
    """MB 64, SEG 256, PQ128x4: 4 KiB chunks, 3 stages per warp (2 chunks
    in flight ahead of each of 16 warps), two 8 KiB LUT buffers."""
    p = _adc_plan(kind, 64, 256, 128, 16, 51_642, H100_SMS)
    assert p.depth - 1 >= 2 and p.warps == 16 and p.n_luts == 2
    assert p.chunk_bytes == 4096 and p.grid == H100_SMS
    assert p.rows == (0 if kind == "rows" else 8) and p.passes == 1
    assert p.smem == 256 + 2 * 8192 + 16 * 3 * 4096 + 8 * (48 + 2) + 4 * 16 * 6


def test_adc_plan_of_the_byte_code_rows_at_pq64x8():
    """Kernel 6 at the legacy PQ64x8 shape (MB 64, SEG 256, M 64, ksub
    256): two 64 KiB LUT buffers, so a block crosses a query boundary
    without draining, and beside them 8 warps with 2 chunks of 64 rows in
    flight ahead of each."""
    p = _adc_plan("rows", 64, 256, 64, 256, 10_177, H100_SMS)
    assert p.n_luts == 2 and p.depth - 1 >= 2 and p.warps >= 8
    assert p.chunk == 64 and p.chunk_bytes == 4096 and p.grid == H100_SMS
    assert p.smem <= _SMEM_LIMIT
    assert p.smem == _stage_smem(p.warps, p.depth, 4096, 64 * 1024, 2)


@pytest.mark.parametrize("m,ksub,mb,seg", [(128, 16, 64, 256), (64, 256, 64, 256),
                                           (16, 16, 8, 1000)])
def test_adc_plan_of_the_transposed_raw_scan_is_the_fused_scans(m, ksub, mb, seg):
    """Kernel 4 is kernel 3's staged sums without the selection: the same
    rows per lane, passes, ring and chunk (PQ128x4, PQ64x8, and SEG 1000
    in two passes)."""
    assert _adc_plan("cols", mb, seg, m, ksub, 8192, H100_SMS) == \
        _adc_plan("topk", mb, seg, m, ksub, 8192, H100_SMS)


@pytest.mark.parametrize("m", [64, 128])
def test_adc_plan_gives_a_large_lut_one_buffer(m):
    """A 128 KiB LUT (ksub 256) gets one buffer, and the ring in what is
    left; a 64 KiB one still gets two, with 8 warps at full depth."""
    p = _adc_plan("topk", m, 256, m, 256, 51_642, H100_SMS)
    assert p.n_luts == (2 if m == 64 else 1)
    assert p.depth == 3 and p.warps >= 8 and p.smem <= _SMEM_LIMIT


def test_adc_plan_grid_and_kind():
    assert _adc_plan("topk", 64, 256, 128, 16, 5, H100_SMS).grid == 5
    assert _adc_plan("rows", 64, 256, 128, 16, 0, H100_SMS).grid == 1
    # slots past one block per SM change nothing (the wrappers clip them)
    assert _adc_plan("rows", 64, 256, 64, 256, 10_177, H100_SMS) == \
        _adc_plan("rows", 64, 256, 64, 256, H100_SMS, H100_SMS)
    with pytest.raises(ValueError):
        _adc_plan("columns", 64, 256, 128, 16, 5, H100_SMS)
