"""Streaming top-k of inner products.

``streaming_topk(q, x, n_valid, k)`` returns, per query, the k largest
``q . x[r]`` over rows ``r < n_valid`` as (values [Q, k] f32, rows
[Q, k] int32), without a [Q, N] score matrix in device memory. It is
the probe of the IVF-PQ search, flat search (``FlatIndex``) and later
k-means assignment (k = 1).

Two selection modes, as in the JAX package:

- ``"exact"``: ties go to the lowest row; slots with no candidate are
  (-inf, 0).
- ``"fast"``: each chunk of ``chunk`` rows (from row 0) selects on packed
  int32 keys whose low ``lane_bits = log2(chunk)`` mantissa bits are
  replaced by the row's lane in the chunk (``_pack_keys``). Returned
  values keep ``23 - lane_bits`` mantissa bits, truncated toward -inf.
  Among equal truncated values the earlier chunk wins, and within a
  chunk the higher lane. Rows at or past ``n_valid`` score the finite
  ``FAST_SENTINEL``, so when ``n_valid < k`` the tail holds sentinel
  rows (the highest lanes of chunk 0 first) with value -inf.

Two implementations behind ``impl``:

- ``"cuda"``: the hand-written kernels in ``csrc/topk.cu``, templated on
  the mode. A first pass splits the corpus into ranges, one block per
  (range, query tile), each keeping a sorted top-k list per query in
  shared memory; a second pass merges the range lists. For bf16
  operands the first pass multiplies on tensor cores (``wgmma`` fed by
  TMA copies), holds up to 256 queries per block so the corpus is read
  once, and selects straight from the accumulator registers: only
  scores that beat their query's current k-th entry reach shared
  memory. f32 operands keep an f32-FMA scan, since TF32 would break
  their true-f32 contract. ``_plan`` chooses the route, the queries per
  block and the ranges;
- ``"torch"``: the plain version, a chunked scan with a running [Q, k]
  result: ``_topk_torch`` (twin of the JAX package's ``_topk_xla``) and
  ``_topk_torch_fast`` (twin of ``_topk_xla_fast``).

``"auto"`` takes the kernel for a CUDA tensor and the plain version for
a CPU tensor. Operands are f32 (true IEEE f32 products) or bf16 (whose
products are exact in f32); scores always accumulate in f32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

NEG_INF = float("-inf")

# fast-mode sentinel for invalid rows: FINITE, since clearing the low
# mantissa bits of -inf's pattern gives a NaN. Values <= FAST_INVALID in
# the output are mapped back to -inf.
FAST_SENTINEL = -3.0e38
FAST_INVALID = -1.0e38

# kernel launches through streaming_topk (pass 1 + pass 2 count as one),
# exact mode and fast mode
launches = 0
fast_launches = 0


def _select(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """Top-k along dim 1 under (value desc, position asc): a stable
    descending sort keeps equal values in their input order."""
    v, order = torch.sort(vals, dim=1, descending=True, stable=True)
    return v[:, :k], torch.gather(idx, 1, order[:, :k])


def _topk_torch(q, x, n_valid: int, k: int, chunk: int):
    qf = q.to(x.dtype).float()
    n_total = x.shape[0]
    qn = q.shape[0]
    vals = torch.full((qn, k), NEG_INF, dtype=torch.float32, device=x.device)
    idx = torch.zeros((qn, k), dtype=torch.int32, device=x.device)
    for c0 in range(0, n_total, chunk):
        s = qf @ x[c0:c0 + chunk].float().T
        cols = torch.arange(c0, c0 + chunk, dtype=torch.int32, device=x.device)
        s = torch.where(cols[None, :] < n_valid, s, NEG_INF)
        vals, idx = _select(torch.cat([vals, s], dim=1),
                            torch.cat([idx, cols.expand(qn, -1)], dim=1), k)
    return vals, idx


def _pack_keys(s, cols, lane_bits: int):
    """f32 scores -> int32 keys ordered as the floats, with the low
    ``lane_bits`` bits replaced by the lane id. The sign-flip transform
    is an involution, so ``_unpack_keys`` reuses it."""
    si = s.contiguous().view(torch.int32)
    key = si ^ ((si >> 31) & 0x7FFFFFFF)
    return (key & ~((1 << lane_bits) - 1)) | cols


def _unpack_keys(wk, lane_bits: int):
    """packed keys -> (truncated f32 values, lane ids)."""
    mask_lo = (1 << lane_bits) - 1
    kv = wk & ~mask_lo
    kv = kv ^ ((kv >> 31) & 0x7FFFFFFF)
    return kv.view(torch.float32), wk & mask_lo


def _topk_torch_fast(q, x, n_valid: int, k: int, chunk: int, lane_bits: int):
    """Per chunk: the top-k packed keys, decoded, then merged into the
    running result under (value desc, position asc)."""
    qf = q.to(x.dtype).float()
    qn = q.shape[0]
    vals = torch.full((qn, k), NEG_INF, dtype=torch.float32, device=x.device)
    idx = torch.zeros((qn, k), dtype=torch.int32, device=x.device)
    cols = torch.arange(chunk, dtype=torch.int32, device=x.device)
    for c0 in range(0, x.shape[0], chunk):
        s = qf @ x[c0:c0 + chunk].float().T
        s = torch.where(c0 + cols[None, :] < n_valid, s, FAST_SENTINEL)
        wk = torch.topk(_pack_keys(s, cols, lane_bits), k, dim=1).values
        wv, wl = _unpack_keys(wk, lane_bits)
        vals, idx = _select(torch.cat([vals, wv], dim=1),
                            torch.cat([idx, c0 + wl], dim=1), k)
    return vals, idx


def _lib():
    lib = _build.library("topk")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.topk_launch.argtypes = [vp, vp, i, i, i, i, i, i, i, i, i, i, i, i, i, vp, vp,
                                    vp, vp]
        lib.topk_launch.restype = i
        lib.topk_smem_bytes.argtypes = [i, i, i]
        lib.topk_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


# Hopper: shared memory one block may use
_BLOCK_SMEM = 232_448

# first-pass configurations of csrc/topk.cu (topk_launch's ``cfg``).
# f32 operands, the FMA scan: cfg -> (queries per block, corpus rows per
# tile, blocks per SM); it stages 32 deep. bf16, the wgmma scan (one
# block per SM): cfg -> (query rows per tile, corpus rows per tile).
_FMA = {0: (32, 64, 8), 1: (8, 128, 8)}
_FMA_DK = 32
_TC = {2: (128, 256), 3: (256, 128)}
# the wgmma scan's ring (stages of 64-deep bf16 slices) and candidate
# slots per query
_TC_STAGES, _TC_DK, _TC_CB = 3, 64, 16


class Plan(NamedTuple):
    cfg: int             # first-pass configuration (``_FMA`` or ``_TC``)
    qb: int              # queries per block
    tn: int              # corpus rows per tile
    n_ranges: int        # corpus ranges: grid x of the first pass
    range_rows: int      # rows per range, a multiple of ``tn``
    smem: int            # shared memory bytes per block

    @property
    def tensor_cores(self) -> bool:
        return self.cfg in _TC


def _smem(cfg: int, qb: int, k: int) -> int:
    """Mirror of ``topk_smem_bytes`` in csrc/topk.cu."""
    if cfg in _FMA:   # query and corpus slices (rows padded by one), scores, lists
        qt, tn, _ = _FMA[cfg]
        return 4 * (qt * _FMA_DK + tn * (_FMA_DK + 1) + qt * tn) + 8 * qt * k
    # 1 KiB to align the ring, the ring, 64 bytes of stage barriers; per
    # query a list of k 8-byte entries, the candidate slots and a count
    qt, tn = _TC[cfg]
    ring = _TC_STAGES * (qt + tn) * _TC_DK * 2
    return 1024 + ring + 64 + 8 * qb * (k + _TC_CB) + 4 * qb


def _plan(qn: int, n_eff: int, k: int, dtype, sms: int) -> Plan:
    """The launch plan for Q ``qn`` queries over ``n_eff`` valid rows.

    f32 operands take the FMA scan (query tile 8 or 32). bf16 operands
    take the wgmma scan with the smallest query tile that holds all
    ``qn`` queries (128 or 256), so the corpus is read once; a k whose
    lists do not fit moves to the 128-query tile, which then serves fewer
    queries per block, halving down to 1. The ranges fill one wave of the
    card's ``sms`` SMs, tile-aligned. Raises ValueError for a k no
    configuration holds."""
    if dtype == torch.float32:
        cfg = 1 if qn <= 8 or _smem(0, 32, k) > _BLOCK_SMEM else 0
        qb, tn, per_sm = _FMA[cfg]
    elif dtype == torch.bfloat16:
        # configurations are numbered by query tile; take the first that
        # holds every query, then the 128-query tile with fewer queries
        # per block while the lists do not fit
        cfg = min((c for c in _TC if _TC[c][0] >= qn), default=max(_TC))
        qb = min(_TC[cfg][0], qn)
        if _smem(cfg, qb, k) > _BLOCK_SMEM:
            cfg = min(_TC)
            qb = min(_TC[cfg][0], qn)
            while qb > 1 and _smem(cfg, qb, k) > _BLOCK_SMEM:
                qb //= 2
        tn, per_sm = _TC[cfg][1], 1
    else:
        raise TypeError(f"x must be float32 or bfloat16, got {dtype}")
    smem = _smem(cfg, qb, k)
    if smem > _BLOCK_SMEM:
        raise ValueError(f"k={k} needs more shared memory than a block has")
    q_tiles = -(-qn // qb)
    want = max(1, sms * per_sm // q_tiles)
    n_ranges = max(1, min(want, -(-n_eff // tn)))
    range_rows = -(-max(n_eff, 1) // n_ranges)
    range_rows = -(-range_rows // tn) * tn
    n_ranges = max(1, -(-n_eff // range_rows))
    return Plan(cfg, qb, tn, n_ranges, range_rows, smem)


@functools.lru_cache(maxsize=256)
def _launch_plan(qn: int, n_eff: int, k: int, dtype, device: int) -> Plan:
    """``_plan`` for this card, checked once against the kernel's own
    shared-memory count."""
    p = _plan(qn, n_eff, k, dtype, torch.cuda.get_device_properties(device).multi_processor_count)
    if _lib().topk_smem_bytes(p.cfg, p.qb, k) != p.smem:
        raise RuntimeError("the top-k plan and csrc/topk.cu disagree on shared memory")
    return p


def _topk_cuda(q, x, n_valid: int, k: int, chunk: int = 0, lane_bits: int = 0):
    """The kernel; ``lane_bits`` > 0 selects fast mode at this ``chunk``."""
    global launches, fast_launches
    fast = lane_bits > 0
    if not (q.is_cuda and x.is_cuda and q.device == x.device):
        raise ValueError("the CUDA top-k needs q and x on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"shapes q {tuple(q.shape)} and x {tuple(x.shape)}")
    if fast and x.shape[0] >= 2**31:
        raise ValueError("fast mode keys hold a row offset below 2**31")
    q = q.to(x.dtype).contiguous()
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    qn, d = q.shape
    n_eff = max(0, min(int(n_valid), x.shape[0]))
    out_v = torch.empty((qn, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((qn, k), dtype=torch.int32, device=x.device)
    if qn == 0 or k == 0:
        return out_v, out_i
    lib = _lib()
    p = _launch_plan(qn, n_eff, k, x.dtype, x.device.index)
    # 16-byte rows and bases: the tensor-core scan stages by TMA
    vec = d % 8 == 0 and q.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0
    # fast-mode key layout: the chunk's row count and the corpus's chunks
    chunk_log2, n_chunks = (chunk.bit_length() - 1, x.shape[0] // chunk) if fast else (0, 0)
    # one 8-byte list entry per candidate: (f32, i32) exact, int64 key fast
    cand = torch.empty((qn, p.n_ranges, k), dtype=torch.int64, device=x.device)
    err = lib.topk_launch(
        q.data_ptr(), x.data_ptr(), p.cfg, int(vec), qn, n_eff, d, k, p.qb, p.n_ranges,
        p.range_rows, int(fast), lane_bits, chunk_log2, n_chunks,
        cand.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "topk")
    if fast:
        fast_launches += 1
    else:
        launches += 1
    return out_v, out_i


def _sentinel_tail(vals, idx, n_valid: int, n_rows: int, chunk: int):
    """Fast mode scans only rows below ``n_valid``. Where fewer than k
    are valid, the reference fills the tail with sentinel rows, which
    all share one truncated value: chunk 0's invalid lanes (k <= chunk),
    highest lane first. Writes into the kernel's fresh outputs."""
    k = vals.shape[1]
    n_eff = max(0, min(n_valid, n_rows))
    if n_eff >= k or n_rows == 0:
        return vals, idx
    vals[:, n_eff:] = NEG_INF
    idx[:, n_eff:] = torch.arange(chunk - 1, chunk - 1 - (k - n_eff), -1,
                                  dtype=torch.int32, device=idx.device)
    return vals, idx


def streaming_topk(q, x, n_valid, k: int, *, chunk: int = 1024,
                   impl: str = "auto", mode: str = "exact"):
    """Top-k inner products of q [Q, D] against x[:n_valid] (x [N, D],
    N a multiple of ``chunk``, k <= chunk). Returns (values [Q, k] f32,
    rows [Q, k] int32). impl: "cuda" | "torch" | "auto"; mode: "exact" |
    "fast" (see the module docstring)."""
    if x.shape[0] % chunk != 0:
        raise ValueError(f"corpus rows {x.shape[0]} not a multiple of chunk {chunk}")
    if k > chunk:
        raise ValueError(f"k={k} must be <= chunk={chunk}")
    if mode not in ("exact", "fast"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "fast" and chunk & (chunk - 1):
        raise ValueError(f"fast mode needs a power-of-two chunk, got {chunk}")
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "torch"
    if impl not in ("cuda", "torch"):
        raise ValueError(f"unknown impl {impl!r}")
    n_valid = int(n_valid)
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    if mode == "exact":
        if impl == "cuda":
            return _topk_cuda(q, x, n_valid, k)
        return _topk_torch(q, x, n_valid, k, chunk)
    lane_bits = max(1, chunk.bit_length() - 1)
    if impl == "cuda":
        vals, idx = _sentinel_tail(*_topk_cuda(q, x, n_valid, k, chunk, lane_bits),
                                   n_valid, x.shape[0], chunk)
    else:
        vals, idx = _topk_torch_fast(q, x, n_valid, k, chunk, lane_bits)
    # the sentinel rows come back as -inf, as in exact mode
    return torch.where(vals <= FAST_INVALID, NEG_INF, vals), idx
