"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; run
them on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -m gpu -q

(``chip_smoke.py`` makes the same checks at the production shapes.)
"""

import numpy as np
import pytest
import torch

from abstracts_search_tpu_torch.ops import adc, topk

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qn,n,n_valid,k", [(3, 1024, 1024, 10), (40, 2048, 1500, 64),
                                            (5, 256, 7, 16), (9, 4096, 4096, 300)])
def test_topk_kernel_matches_plain(cuda, dtype, qn, n, n_valid, k):
    g = torch.Generator(device=cuda).manual_seed(qn + k)
    q = torch.randn((qn, 64), device=cuda, generator=g).to(dtype)
    # 40 distinct rows repeated: exact ties, broken by the lowest row
    x = torch.randn((40, 64), device=cuda, generator=g)[
        torch.randint(0, 40, (n,), device=cuda, generator=g)].to(dtype)
    kv, ki = topk.streaming_topk(q, x, n_valid, k, chunk=256 if k <= 256 else 512,
                                 impl="cuda")
    pv, pi = topk.streaming_topk(q, x, n_valid, k, chunk=256 if k <= 256 else 512,
                                 impl="torch")
    torch.testing.assert_close(kv, pv, rtol=1e-5, atol=1e-5)
    assert torch.equal(ki, pi)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qn,n,n_valid,k,chunk,sign", [
    (3, 1024, 1024, 10, 256, 0), (40, 2048, 1500, 24, 512, 0), (5, 512, 7, 16, 256, 0),
    (2, 512, 0, 10, 128, 0), (9, 4096, 4000, 64, 1024, -1), (1, 8192, 8192, 1, 4096, 0)])
def test_fast_topk_kernel_matches_plain_bit_for_bit(cuda, dtype, qn, n, n_valid, k, chunk,
                                                    sign):
    """Small integers: every sum is exact, so values and rows must be
    equal, truncation ties, sentinel tail and negative scores included."""
    g = torch.Generator(device=cuda).manual_seed(qn + k)
    if sign:       # every score negative: q > 0, x < 0
        q = torch.randint(1, 4, (qn, 64), device=cuda, generator=g).float()
        x = -torch.randint(1, 4, (n, 64), device=cuda, generator=g).float()
    else:
        q = torch.randint(-3, 4, (qn, 64), device=cuda, generator=g).float()
        x = torch.randint(-3, 4, (n, 64), device=cuda, generator=g).float()
    q, x = q.to(dtype), x.to(dtype)
    kv, ki = topk.streaming_topk(q, x, n_valid, k, chunk=chunk, impl="cuda", mode="fast")
    pv, pi = topk.streaming_topk(q, x, n_valid, k, chunk=chunk, impl="torch", mode="fast")
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("qn,n,n_valid,d,k", [
    (37, 4096, 4096, 100, 10),        # odd d: scalar staging, zero-filled depth
    (37, 4096, 4000, 1000, 10),       # a ragged last depth slice
    (256, 65536, 65536, 64, 300),     # k 300 at Q 256: one query tile
    (1, 65536, 65536, 64, 16), (7, 8192, 8192, 64, 16),     # Q at tile edges
    (129, 8192, 8192, 64, 16), (300, 8192, 8192, 64, 16),
    (128, 8192, 8192 - 77, 64, 10),   # n_valid no multiple of any tile
    (5, 4096, 0, 64, 10)])
def test_topk_kernel_edges_bit_for_bit(cuda, mode, qn, n, n_valid, d, k):
    """bf16 small integers and 64 distinct rows repeated through the
    corpus: every sum is exact on the tensor cores as on the plain path,
    so both modes must give its values and rows bit for bit, exact ties
    going to the lowest row."""
    g = torch.Generator(device=cuda).manual_seed(qn + d + k)
    q = torch.randint(-3, 4, (qn, d), device=cuda, generator=g).to(torch.bfloat16)
    x = torch.randint(-3, 4, (64, d), device=cuda, generator=g)[
        torch.randint(0, 64, (n,), device=cuda, generator=g)].to(torch.bfloat16)
    kv, ki = topk.streaming_topk(q, x, n_valid, k, chunk=512, impl="cuda", mode=mode)
    pv, pi = topk.streaming_topk(q, x, n_valid, k, chunk=512, impl="torch", mode=mode)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("k", [32, 64, 128, 256])
@pytest.mark.parametrize("qn", [1, 129, 256])
def test_wgmma_scan_large_k_bit_for_bit(cuda, qn, k, mode):
    """The serve probe's k at nprobe 32-256: Q 1, 129 and 256 over 65,536
    rows with a ragged n_valid, in one query tile; bf16 small integers and
    64 distinct rows repeated, so every sum is exact and both modes must
    give the plain version's values and rows bit for bit, exact ties going
    to the lowest row."""
    g = torch.Generator(device=cuda).manual_seed(qn + k)
    q = torch.randint(-3, 4, (qn, 64), device=cuda, generator=g).to(torch.bfloat16)
    x = torch.randint(-3, 4, (64, 64), device=cuda, generator=g)[
        torch.randint(0, 64, (65_536,), device=cuda, generator=g)].to(torch.bfloat16)
    n_valid = 65_536 - 77
    assert topk._launch_plan(qn, n_valid, k, torch.bfloat16, cuda.index or 0, True,
                             mode == "fast").qb == qn
    before = topk.launches + topk.fast_launches
    kv, ki = topk.streaming_topk(q, x, n_valid, k, chunk=512, impl="cuda", mode=mode)
    assert topk.launches + topk.fast_launches == before + 1
    pv, pi = topk.streaming_topk(q, x, n_valid, k, chunk=512, impl="torch", mode=mode)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("qn,k,distinct,n_valid", [(37, 64, 1, 65_536), (256, 256, 1, 65_536),
                                                   (129, 100, 3, 65_000), (3, 256, 2, 100)])
def test_wgmma_scan_full_buffers_bit_for_bit(cuda, qn, k, distinct, n_valid, mode):
    """One, two or three distinct rows: a query's scores tie across the
    corpus, so every range's candidate buffer fills and is folded in the
    kernel, and more candidates than the select pass holds in shared memory
    reach the bound (it reads them from device memory); fewer valid rows
    than k leave the tail empty. The plain version's values and rows, bit
    for bit: the lowest rows win."""
    g = torch.Generator(device=cuda).manual_seed(qn + k + distinct)
    q = torch.randint(-3, 4, (qn, 64), device=cuda, generator=g).to(torch.bfloat16)
    x = torch.randint(-3, 4, (distinct, 64), device=cuda, generator=g)[
        torch.randint(0, distinct, (65_536,), device=cuda, generator=g)].to(torch.bfloat16)
    kv, ki = topk.streaming_topk(q, x, n_valid, k, chunk=512, impl="cuda", mode=mode)
    pv, pi = topk.streaming_topk(q, x, n_valid, k, chunk=512, impl="torch", mode=mode)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


def _q_ids(order, n_slots, qn, cuda, g):
    """query-major (the search path), alternating every slot (the index's
    load check), or shuffled"""
    major = (torch.arange(n_slots, device=cuda) * qn // n_slots).int()
    if order == "major":
        return major
    if order == "alternating":
        return (torch.arange(n_slots, device=cuda) % 2).int()
    return major[torch.randperm(n_slots, device=cuda, generator=g)].contiguous()


# layout -> (M, ksub, transposed, packed). Transposed: kernel 4, packed
# and a code a byte (a 64 KiB LUT at M 64). Row-major packed rows of 8,
# 16, 32, 64 and 128 bytes (kernel 5): byte loads, then 1, 2, 4 and 8
# rotated 16-byte pieces. Row-major bytes (kernel 6): ksub 256 at M 8, 24
# (byte loads: not a multiple of 16), 64 and 128 (64 and 128 KiB LUTs),
# and the legacy unpacked 4-bit codes (ksub 16, MB = M)
SCAN_LAYOUTS = {
    "t_packed": (16, 16, True, True), "t_bytes": (8, 256, True, False),
    "t_bytes_m64": (64, 256, True, False),
    "rows_packed": (16, 16, False, True), "rows_packed_mb16": (32, 16, False, True),
    "rows_packed_mb32": (64, 16, False, True), "rows_packed_mb64": (128, 16, False, True),
    "rows_packed_mb128": (256, 16, False, True), "rows_bytes": (8, 256, False, False),
    "rows_bytes_m24": (24, 256, False, False), "rows_bytes_m64": (64, 256, False, False),
    "rows_bytes_m128": (128, 256, False, False), "rows_4bit_bytes": (64, 16, False, False),
}


@pytest.mark.parametrize("values", ["randn", "ties"])
@pytest.mark.parametrize("order", ["major", "alternating", "shuffled"])
@pytest.mark.parametrize("layout", list(SCAN_LAYOUTS))
@pytest.mark.parametrize("seg", [32, 256, 512, 1000])
def test_adc_scan_kernel_matches_plain_bit_for_bit(cuda, layout, seg, order, values):
    """700 slots of 7 queries over 50 segments: Gaussian LUTs, and
    small-integer ones (many equal sums); SEG 1000 takes two passes of
    512 rows transposed and a ragged last chunk row-major."""
    g = torch.Generator(device=cuda).manual_seed(seg + len(layout))
    m, ksub, transposed, packed = SCAN_LAYOUTS[layout]
    mb = m // 2 if packed else m
    shape = (50, mb, seg) if transposed else (50, seg, mb)
    codes = torch.randint(0, 256 if packed else ksub, shape, dtype=torch.uint8, device=cuda,
                          generator=g)
    if values == "ties":
        luts = torch.randint(-2, 3, (7, m, ksub), device=cuda, generator=g).float()
    else:
        luts = torch.randn((7, m, ksub), device=cuda, generator=g)
    n_slots = 700
    seg_ids = torch.randint(0, 50, (n_slots,), dtype=torch.int32, device=cuda, generator=g)
    q_ids = _q_ids(order, n_slots, 7, cuda, g)
    got = adc.adc_scan(codes, luts, seg_ids, q_ids, transposed=transposed, impl="cuda")
    ref = adc.adc_scan(codes, luts, seg_ids, q_ids, transposed=transposed, impl="torch")
    assert torch.equal(got, ref)


def test_adc_plan_refuses_a_lut_that_fills_shared_memory(cuda):
    """ksub 256 at M 227: the LUT alone is 232,448 bytes; the wrapper
    raises before any launch."""
    codes = torch.zeros((2, 32, 227), dtype=torch.uint8, device=cuda)
    luts = torch.zeros((1, 227, 256), device=cuda)
    ids = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="do not fit"):
        adc.adc_scan(codes, luts, ids, ids, transposed=False, impl="cuda")


def test_flat_index_on_the_card_matches_the_cpu(cuda):
    from abstracts_search_tpu_torch.index import FlatIndex

    rng = np.random.default_rng(1)
    x = rng.integers(-3, 4, (3000, 32)).astype(np.float32)
    q = rng.integers(-3, 4, (7, 32)).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        idx = FlatIndex(chunk=256, dtype=torch.float32, device=dev)
        idx.add(x[:1000])
        idx.add(x[1000:])
        out[dev] = idx.search(q, 12)
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])


# ksub, M, SEG, kp, LUT values, slot order, valid counts
ADC_TOPK_CASES = [
    *[(ksub, m, seg, kp, "randn", "major", "random") for ksub, m in ((16, 16), (256, 8))
      for seg, kp in ((32, 4), (256, 10), (512, 100))],
    # small-integer LUTs: many rows tie, and row order decides
    (16, 128, 256, 10, "ties", "major", "random"),
    (16, 128, 256, 10, "ties", "alternating", "random"),
    (16, 128, 256, 10, "ties", "shuffled", "random"),
    (16, 128, 32, 8, "ties", "alternating", "random"),
    (16, 128, 512, 10, "ties", "alternating", "random"),
    (16, 16, 32, 32, "ties", "major", "random"),              # kp = SEG
    (16, 16, 256, 256, "ties", "shuffled", "random"),
    (16, 128, 512, 512, "randn", "major", "random"),
    (16, 128, 256, 10, "ties", "major", "zero_or_full"),     # valid_cnt 0 and SEG
    (256, 64, 256, 10, "randn", "alternating", "random"),    # 64 KiB LUT
    (256, 128, 256, 10, "ties", "shuffled", "random"),       # 128 KiB LUT
    (256, 128, 512, 16, "randn", "major", "random"),
    (256, 3, 37, 5, "ties", "major", "random"),              # 111-byte tiles
    (16, 16, 1000, 20, "ties", "major", "random"),           # rows in two passes
    (16, 16, 2048, 64, "randn", "shuffled", "zero_or_full"),
]


@pytest.mark.parametrize("ksub,m,seg,kp,values,order,valid", ADC_TOPK_CASES)
def test_adc_kernel_matches_plain_bit_for_bit(cuda, ksub, m, seg, kp, values, order, valid):
    """Values and rows bit for bit, (value desc, row asc) ties included,
    over 2,000 slots of 7 queries, so query boundaries fall inside the
    persistent blocks' slot ranges."""
    g = torch.Generator(device=cuda).manual_seed(seg + kp + m)
    mb = m // 2 if ksub == 16 else m
    codes = torch.randint(0, 256 if ksub > 16 or mb * 2 == m else 16, (50, mb, seg),
                          dtype=torch.uint8, device=cuda, generator=g)
    if values == "ties":
        luts = torch.randint(-2, 3, (7, m, ksub), device=cuda, generator=g).float()
    else:
        luts = torch.randn((7, m, ksub), device=cuda, generator=g)
    n_slots = 2000
    seg_ids = torch.randint(0, 50, (n_slots,), dtype=torch.int32, device=cuda, generator=g)
    q_ids = _q_ids(order, n_slots, 7, cuda, g)
    if valid == "zero_or_full":
        valid_cnt = (torch.randint(0, 2, (n_slots,), device=cuda, generator=g) * seg).int()
    else:
        valid_cnt = torch.randint(0, seg + 1, (n_slots,), dtype=torch.int32, device=cuda,
                                  generator=g)
    args = (codes, luts, seg_ids, q_ids, valid_cnt, kp)
    kv, ki = adc.adc_topk(*args, impl="cuda")
    pv, pi = adc.adc_topk(*args, impl="torch")
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


def test_index_on_the_card_matches_the_cpu(cuda):
    _index_on_the_card_matches_the_cpu(transposed=True)


def test_row_major_index_on_the_card_matches_the_cpu(cuda):
    _index_on_the_card_matches_the_cpu(transposed=False)


@pytest.mark.parametrize("storage,budget", [("host", None), ("hybrid", "half"),
                                            ("hybrid", 0), ("hybrid", 1 << 40)],
                         ids=["host", "hybrid", "hybrid_cold", "hybrid_hot"])
@pytest.mark.parametrize("transposed", [True, False], ids=["transposed", "row-major"])
def test_storage_on_the_card_matches_the_cpu(cuda, transposed, storage, budget):
    """Host and hybrid storage on the card: the kernels over gathered
    tiles (staged in chunks of 3 tiles, so the pinned ring turns over
    within and across batches) return the plain device storage's hits."""
    _index_on_the_card_matches_the_cpu(transposed=transposed, storage=storage,
                                       budget=budget)


@pytest.mark.parametrize("transposed", [True, False], ids=["transposed", "row-major"])
def test_unpacked_4bit_index_on_the_card_matches_the_cpu(cuda, transposed):
    """Legacy 4-bit artifacts hold one code a byte (MB = M): the kernels
    take the payload width from the codes."""
    _index_on_the_card_matches_the_cpu(transposed=transposed, unpacked=True)


def _index_on_the_card_matches_the_cpu(transposed, storage="device", budget=None,
                                       unpacked=False):
    from abstracts_search_tpu_torch.index import CSRLists, IVFPQIndex

    rng = np.random.default_rng(0)
    n_lists, d, m, seg = 64, 64, 16, 32
    sizes = rng.integers(1, 200, n_lists)
    cnt = -(-sizes // seg)
    start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    n_segs = int(cnt.sum())
    seg_list = np.repeat(np.arange(n_lists), cnt)
    valid = np.clip(sizes[seg_list] - (np.arange(n_segs) - start[seg_list]) * seg, 0, seg)
    rows = np.arange(n_segs * seg, dtype=np.int32).reshape(n_segs, seg)
    data = rng.integers(0, 256, (n_segs, m // 2, seg), dtype=np.uint8)
    if unpacked:
        data = np.stack([data & 15, data >> 4], axis=2).reshape(n_segs, m, seg)
    if not transposed:
        data = np.ascontiguousarray(data.transpose(0, 2, 1))
    csr = CSRLists(data=data, row_ids=rows, seg_valid=valid.astype(np.int32),
                   seg_start=start.astype(np.int64), seg_cnt=cnt.astype(np.int32),
                   seg_size=seg, n_lists=n_lists, n_rows=int(sizes.sum()),
                   transposed=transposed)
    cent = rng.standard_normal((n_lists, d)).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=1, keepdims=True)
    pqc = 0.05 * rng.standard_normal((m, 16, d // m)).astype(np.float32)
    rot = np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
    q = rng.standard_normal((20, d)).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        kw = {}
        if dev == "cuda":
            kw["storage"] = storage
            if budget is not None:
                kw["hot_budget_bytes"] = data.nbytes // 2 if budget == "half" else budget
        idx = IVFPQIndex(n_lists, d, pq_m=m, pq_nbits=4, seg_size=seg, chunk=64,
                         device=dev, **kw)
        idx.STAGE_CHUNK_BYTES = 3 * data[0].nbytes
        idx.set_params(cent, pqc, rot)
        idx._install(csr)
        before = (adc.launches, dict(adc.scan_launches))
        out[dev] = [idx.search(q, 10, nprobe=8), idx.search(q[:3], 300, nprobe=2)]
        if dev == "cuda":
            # the kernels ran: nothing gave way to the plain version
            assert (adc.launches, adc.scan_launches) != before
            if storage == "hybrid":
                st = idx.last_scan_stats
                assert (budget == 1 << 40) == (st["cold_live_slots"] == 0)
                assert (budget == 0) == (st["live_slots"] == 0)
    for (gv, gp), (pv, pp) in zip(out["cuda"], out["cpu"]):
        np.testing.assert_array_equal(gp, pp)
        np.testing.assert_allclose(gv, pv, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 0.02)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
def test_tiny_encoder_on_the_card_matches_the_cpu(cuda, dtype, atol, causal):
    """The tiny stella encoder through EmbeddingPipeline on the card
    against the same weights on the CPU: f32 within 1e-5 (cuBLAS sums in
    another order), bf16 within 0.02 and a cosine of 0.999 per row (the
    two devices round bf16 products at other places)."""
    from abstracts_search_tpu_torch.device import assert_exact_f32
    from abstracts_search_tpu_torch.models.embed import EmbeddingPipeline, whitespace_tokenizer
    from abstracts_search_tpu_torch.models.qwen2 import Qwen2Config
    from abstracts_search_tpu_torch.models.stella import StellaConfig, StellaEncoder

    cfg = StellaConfig.tiny(backbone=Qwen2Config.tiny(dtype=dtype), causal=causal)
    weights = StellaEncoder(cfg, device="cpu").init_random_(
        torch.Generator().manual_seed(0), std=0.2).state_dict()
    tok = whitespace_tokenizer(128)
    texts = [f"query {i} " + "word " * (i % 37) for i in range(40)]
    outs = [EmbeddingPipeline(cfg, weights, tok, batch_size=16, buckets=(8, 16, 32, 64),
                              batch_buckets=True, device=dev).embed_queries(texts)
            for dev in ("cpu", cuda)]
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=atol)
    cos = (outs[0] * outs[1]).sum(1)
    assert cos.min() >= 0.999
    assert_exact_f32()


# -- the index build: kernel 1 at k 1 -------------------------------------------------


@pytest.mark.parametrize("qn", [1000, 70_000])
def test_topk_kernel_at_k1_bit_for_bit(cuda, qn):
    """The k-means assignment's shape: k 1 on bf16 operands across many
    256-query tiles. Small integers and 64 distinct rows repeated: every
    sum is exact, so values and rows (ties to the lowest) must be equal."""
    g = torch.Generator(device=cuda).manual_seed(qn)
    q = torch.randint(-3, 4, (qn, 64), device=cuda, generator=g).to(torch.bfloat16)
    x = torch.randint(-3, 4, (64, 64), device=cuda, generator=g)[
        torch.randint(0, 64, (4096,), device=cuda, generator=g)].to(torch.bfloat16)
    kv, ki = topk.streaming_topk(q, x, 4000, 1, chunk=1024, impl="cuda")
    pv, pi = topk.streaming_topk(q, x, 4000, 1, chunk=1024, impl="torch")
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


def _ints_repeated(cuda, g, qn, n, d, dtype):
    """Small-integer queries and 64 distinct small-integer rows repeated:
    every sum is exact on any route, and ties are everywhere."""
    q = torch.randint(-3, 4, (qn, d), device=cuda, generator=g).to(dtype)
    x = torch.randint(-3, 4, (64, d), device=cuda, generator=g)[
        torch.randint(0, 64, (n,), device=cuda, generator=g)].to(dtype)
    return q, x


@pytest.mark.parametrize("qn,d", [(1000, 64), (70_000, 64), (262_144, 64), (70_000, 1000)])
def test_k1_scan_bit_for_bit(cuda, qn, d):
    """The k-1 scan (2-block clusters, TMA multicast, running max in
    registers) at Q 1,000, 70,000 and 262,144: n_valid 4,000 is no
    multiple of the 256-row tile, and Q 1,000 and 70,000 leave the last
    128-query tile partly full; d 1,000 has a ragged last 64-deep slice.
    Values and rows (ties to the lowest) equal the plain version's bit for
    bit, through the route."""
    g = torch.Generator(device=cuda).manual_seed(qn + d)
    q, x = _ints_repeated(cuda, g, qn, 4096, d, torch.bfloat16)
    assert topk._launch_plan(qn, 4000, 1, torch.bfloat16, cuda.index or 0).cfg in topk._K1
    before = topk.launches
    kv, ki = topk.streaming_topk(q, x, 4000, 1, chunk=1024, impl="cuda")
    assert topk.launches == before + 1
    pv, pi = topk.streaming_topk(q, x, 4000, 1, chunk=1024, impl="torch")
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


@pytest.mark.parametrize("qn,n,n_valid,d,k", [
    (256, 4096, 4096, 1152, 16),       # the IVF-Flat probe's shape
    (262_144, 4096, 4096, 1152, 1),    # plain-L2 k-means' window, one range
    (300, 8192, 8000, 102, 10),        # d % 4 != 0: scalar staging
    (100, 4096, 4000, 64, 1)])         # k 1 over several ranges: the second pass
def test_register_blocked_f32_scan_bit_for_bit(cuda, qn, n, n_valid, d, k):
    """The register-blocked f32 scan: small integers with repeated rows,
    every f32 sum exact, so values and rows (ties to the lowest) equal the
    plain version's bit for bit, through the route."""
    g = torch.Generator(device=cuda).manual_seed(qn + k)
    q, x = _ints_repeated(cuda, g, qn, n, d, torch.float32)
    assert topk._launch_plan(qn, n_valid, k, torch.float32, cuda.index or 0,
                             d % 4 == 0).cfg in topk._SIMT
    before = topk.launches
    kv, ki = topk.streaming_topk(q, x, n_valid, k, chunk=1024, impl="cuda")
    assert topk.launches == before + 1
    pv, pi = topk.streaming_topk(q, x, n_valid, k, chunk=1024, impl="torch")
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


def test_plain_l2_kmeans_past_the_fma_grid_limit(cuda):
    """Plain-L2 k-means rides the kernel's f32 route, whose grid holds at
    most 65,535 query tiles a call (8,388,480 queries on the 128-query
    register-blocked tile; 2,097,120 on the 32-query FMA tile it
    replaced); fit_staged over 2,200,000 rows windows its calls and must
    assign as the plain route. Small
    integers keep every score and the first update's sums exact, so the
    two routes' centroids must be equal bit for bit."""
    from abstracts_search_tpu_torch.index.kmeans import KMeans

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randint(-3, 4, (2_200_000, 16), device=cuda, generator=g).float()
    cents = {}
    for impl in ("cuda", "torch"):
        km = KMeans(256, spherical=False, impl=impl, seed=0, device=cuda)
        km.fit_staged(x, iters=1)
        cents[impl] = km.centroids
    np.testing.assert_array_equal(cents["cuda"], cents["torch"])
    # and row by row at the (integer) init rows, on the last window
    init_idx = np.sort(np.random.default_rng(0).choice(len(x), 256, replace=False))
    top1 = {}
    for impl in ("cuda", "torch"):
        km = KMeans(256, spherical=False, impl=impl, device=cuda)
        km.centroids = x[torch.from_numpy(init_idx).to(cuda)].cpu().numpy()
        top1[impl] = km._top1(x[-262_144:], km._centroids_padded())
    assert torch.equal(top1["cuda"][0], top1["torch"][0])
    assert torch.equal(top1["cuda"][1], top1["torch"][1])


def test_segment_sums_are_deterministic(cuda):
    """Two runs of the centroid sums on one input are bit-identical."""
    from abstracts_search_tpu_torch.index.kmeans import segment_sum

    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((131_072, 1024), device=cuda, generator=g)
    a = torch.randint(0, 4096, (131_072,), device=cuda, generator=g)
    s1, s2 = segment_sum(x, a, 65_536), segment_sum(x, a, 65_536)
    assert torch.equal(s1, s2)
    ref = torch.zeros((65_536, 1024), dtype=torch.float64, device=cuda)
    ref.index_add_(0, a, x.double())
    torch.testing.assert_close(s1, ref.float(), rtol=1e-5, atol=1e-4)


def test_fused_encode_kernel_route_matches_plain(cuda):
    """The fill's fused encode with kernel 1 against the plain top-k:
    assignments equal except where two centroids score within 1e-5 on the
    bf16 operands; rows on one list get the same codes (the rest of the
    encode is one code path)."""
    from abstracts_search_tpu_torch.index import IVFPQIndex

    g = torch.Generator(device=cuda).manual_seed(2)
    n_lists, dim, m = 1024, 64, 16
    norm = torch.nn.functional.normalize
    idx = IVFPQIndex(n_lists, dim, pq_m=m, pq_nbits=4, seg_size=64, device=cuda)
    rot, _ = torch.linalg.qr(torch.randn((dim, dim), device=cuda, generator=g))
    idx.set_params(norm(torch.randn((n_lists, dim), device=cuda, generator=g), dim=1).cpu(),
                   0.05 * torch.randn((m, 16, dim // m), device=cuda, generator=g).cpu(),
                   rot.cpu())
    x = torch.randn((70_000, dim), device=cuda, generator=g)
    out = {}
    for impl in ("cuda", "torch"):
        idx.impl = impl
        out[impl] = idx.encode(x, timing={})
    (ka, kc), (pa, pc) = out["cuda"], out["torch"]
    differ = ka != pa
    xr = (norm(x, dim=1) @ idx._rot).to(torch.bfloat16).double()
    cb = idx._cent_bf16.double()
    gap = ((xr * cb[ka]).sum(1) - (xr * cb[pa]).sum(1)).abs()
    assert bool((gap[differ] <= 1e-5).all()) and int(differ.sum()) < 20
    assert torch.equal(kc[~differ], pc[~differ])


def test_host_and_device_groups_fill_alike(cuda):
    """Host groups of unnormalised rows go up as they are and take the
    device groups' normalisation and encode on the card: the same
    assignments and codes, and the same packed lists byte for byte."""
    from abstracts_search_tpu_torch.index import IVFPQIndex

    g = torch.Generator(device=cuda).manual_seed(3)
    n_lists, dim, m, group = 1024, 64, 16, 8192
    norm = torch.nn.functional.normalize
    rot, _ = torch.linalg.qr(torch.randn((dim, dim), device=cuda, generator=g))
    params = (norm(torch.randn((n_lists, dim), device=cuda, generator=g), dim=1).cpu().numpy(),
              0.05 * torch.randn((m, 16, dim // m), device=cuda, generator=g).cpu().numpy(),
              rot.cpu().numpy())
    x = 3 * torch.randn((5 * group, dim), device=cuda, generator=g)
    xh = x.cpu().numpy()
    pos = np.arange(len(xh), dtype=np.int64)

    def fill(host):
        idx = IVFPQIndex(n_lists, dim, pq_m=m, pq_nbits=4, seg_size=64, device=cuda)
        idx.set_params(*params)
        idx.fill_stream(iter([(xh[lo:lo + group] if host else x[lo:lo + group],
                               pos[lo:lo + group]) for lo in range(0, len(xh), group)]))
        return idx

    host, card = fill(True), fill(False)
    ha, hc = host.encode(xh[:group])
    da, dc = card.encode(x[:group])
    np.testing.assert_array_equal(ha, da)
    np.testing.assert_array_equal(hc, dc)
    for name in ("data", "row_ids", "seg_valid", "seg_start", "seg_cnt"):
        h, c = getattr(host.packed, name), getattr(card.packed, name)
        assert h.dtype == c.dtype and h.tobytes() == c.tobytes(), name


def test_host_rows_staged_through_pinned_buffers_fill_alike(cuda, monkeypatch):
    """Host rows go up through the index's pinned staging (``_RowStager``),
    in pieces that divide neither the window nor the group, with more
    pieces and windows than pinned buffers and card windows, so each is
    refilled while the card works: the assignments, codes and packed
    lists equal those of the same rows passed as card tensors bit for
    bit. A read-only array warns of nothing, every host row counts as
    staged, each upload span says so, and the fill lets its card windows
    go; the pinned buffers hold at most two windows' bytes."""
    import functools
    import warnings

    from abstracts_search_tpu_torch.index import IVFPQIndex
    from abstracts_search_tpu_torch.index import ivfpq as mod
    from abstracts_search_tpu_torch.utils import trace

    # 64 KiB pieces: 256 rows of 64 f32
    monkeypatch.setattr(mod._RowStager, "PIECE_BYTES", 64 << 10)
    g = torch.Generator(device=cuda).manual_seed(5)
    n_lists, dim, m, group, window = 512, 64, 16, 7000, 1500
    norm = torch.nn.functional.normalize
    rot, _ = torch.linalg.qr(torch.randn((dim, dim), device=cuda, generator=g))
    params = (norm(torch.randn((n_lists, dim), device=cuda, generator=g), dim=1).cpu().numpy(),
              0.05 * torch.randn((m, 16, dim // m), device=cuda, generator=g).cpu().numpy(),
              rot.cpu().numpy())
    x = 3 * torch.randn((4 * group + 123, dim), device=cuda, generator=g)
    xh = x.cpu().numpy()
    xh.flags.writeable = False
    pos = np.arange(len(xh), dtype=np.int64)
    cuts = [(lo, min(lo + group, len(xh))) for lo in range(0, len(xh), group)]

    def fill(host):
        idx = IVFPQIndex(n_lists, dim, pq_m=m, pq_nbits=4, seg_size=64, device=cuda)
        idx.set_params(*params)
        idx.encode = functools.partial(IVFPQIndex.encode, idx, batch_rows=window)
        idx.fill_stream(iter([(xh[a:b] if host else x[a:b], pos[a:b]) for a, b in cuts]))
        return idx

    trace.start()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            host = fill(True)
            ha, hc = host.encode(xh, batch_rows=window)
        spans = trace.collect()
    finally:
        trace.stop()
    assert not [w for w in caught if "writable" in str(w.message)], caught
    card = fill(False)
    da, dc = card.encode(x)
    np.testing.assert_array_equal(ha, da)
    np.testing.assert_array_equal(hc, dc)
    for name in ("data", "row_ids", "seg_valid", "seg_start", "seg_cnt"):
        h, c = getattr(host.packed, name), getattr(card.packed, name)
        assert h.dtype == c.dtype and h.tobytes() == c.tobytes(), name
    assert host.fill_stats["upload_pinned_rows"] == len(xh)
    assert card.fill_stats["upload_pinned_rows"] == 0
    ups = [s["counts"] for s in spans if s["name"] == "fill.upload"]
    windows = sum(-(-(b - a) // window) for a, b in cuts) + -(-len(xh) // window)
    assert ups == [{"bytes": u["bytes"], "pinned": 1} for u in ups] and len(ups) == windows
    assert sum(u["bytes"] for u in ups) == 2 * xh.nbytes
    stager = host._stager
    assert stager.windows == [None] * stager.WINDOWS
    assert sum(b.nbytes for b in stager.ring.bufs) <= 2 * window * dim * 4


def test_card_pack_fill_matches_the_host_pack(cuda, monkeypatch):
    """An in-memory fill on the card packs its lists there (host and
    device groups, positions out of order): the lists equal a host-pack
    fill's of the same groups byte for byte, and so do the answers; the
    card's memory stays within the bound the route checks."""
    from abstracts_search_tpu_torch.index import IVFPQIndex

    g = torch.Generator(device=cuda).manual_seed(4)
    n_lists, dim, m, group = 512, 64, 16, 4096
    norm = torch.nn.functional.normalize
    rot, _ = torch.linalg.qr(torch.randn((dim, dim), device=cuda, generator=g))
    params = (norm(torch.randn((n_lists, dim), device=cuda, generator=g), dim=1).cpu().numpy(),
              0.05 * torch.randn((m, 16, dim // m), device=cuda, generator=g).cpu().numpy(),
              rot.cpu().numpy())
    x = torch.randn((6 * group, dim), device=cuda, generator=g)
    xh = x.cpu().numpy()
    pos = np.random.default_rng(4).permutation(10 * len(xh))[:len(xh)].astype(np.int64)
    groups = [(xh[lo:lo + group] if lo % (2 * group) else x[lo:lo + group], pos[lo:lo + group])
              for lo in range(0, len(xh), group)]

    def fill():
        idx = IVFPQIndex(n_lists, dim, pq_m=m, pq_nbits=4, seg_size=64, device=cuda)
        idx.set_params(*params)
        idx.fill_stream(iter(groups))
        return idx

    card = fill()
    with monkeypatch.context() as mp:
        mp.setattr(IVFPQIndex, "_card_room", lambda self: None)
        host = fill()
    assert card.fill_stats["pack_on_card"] == len(xh) and host.fill_stats["pack_on_card"] == 0
    for name in ("data", "row_ids", "seg_valid", "seg_start", "seg_cnt"):
        h, c = getattr(host.packed, name), getattr(card.packed, name)
        assert isinstance(c, np.ndarray) and h.dtype == c.dtype and h.tobytes() == c.tobytes()
    assert torch.equal(card._codes, host._codes)
    q = xh[::97] + 0.05
    for got, want in zip(card.search(q, 10, nprobe=8), host.search(q, 10, nprobe=8)):
        np.testing.assert_array_equal(got, want)
    # from its collection to the end of its pack the fill holds no more of
    # the card than the bound its route checks the card's room against
    idx = IVFPQIndex(n_lists, dim, pq_m=m, pq_nbits=4, seg_size=64, device=cuda)
    idx.set_params(*params)
    chunks = [(*(torch.from_numpy(a).to(cuda) for a in idx.encode(v)), p) for v, p in groups]
    torch.cuda.synchronize(cuda)
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    peak = []
    install = IVFPQIndex._install

    def measured(self, packed, data=None):
        peak.append(torch.cuda.max_memory_allocated(cuda) - base)
        return install(self, packed, data)

    monkeypatch.setattr(IVFPQIndex, "_install", measured)
    monkeypatch.setattr(IVFPQIndex, "_card_room", lambda self: 1 << 40)
    idx.fill_encoded_stream(iter(chunks))
    assert idx.fill_stats["pack_on_card"] == len(xh)
    assert 0 < peak[0] <= idx._card_pack_bytes(len(xh), idx.packed.n_segs), peak
