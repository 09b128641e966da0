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
  (range, query tile); a second pass combines the ranges' results. For
  bf16 operands the first pass multiplies on tensor cores (``wgmma`` fed
  by TMA copies), holds up to 256 queries per block whatever k, so the
  corpus is read once, and selects straight from the accumulator
  registers: per query only a bound (a proven lower bound on its k-th
  best score, shared between blocks through bins raised by atomicMax)
  and a count stay in shared memory, and scores at or above the bound go
  to a candidate buffer in device memory, from which the second pass
  selects the k best. Exact mode at k 1 over many bf16 queries (k-means
  assignment, the fill's coarse encode) takes a k-1 scan instead: 2-block
  clusters sharing each centroid tile by TMA multicast, a producer
  warpgroup, and each query's running (max, lowest row) kept in
  registers, written once with no second pass. f32 operands take a
  register-blocked f32 scan on the CUDA cores (8 x 8 sums a thread, TMA
  staging, sorted per-query lists in shared memory), since TF32 would
  break their true-f32 contract; Q <= 8 and very large k keep the FMA
  scan. ``_plan`` chooses the route, the queries per block and the
  ranges;
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

from ..utils import trace
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
        lib.topk_launch.argtypes = [vp, vp] + [i] * 15 + [vp] * 6
        lib.topk_launch.restype = i
        lib.topk_smem_bytes.argtypes = [i, i, i]
        lib.topk_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


# Hopper: shared memory one block may use
_BLOCK_SMEM = 232_448

# first-pass configurations of csrc/topk.cu (topk_launch's ``cfg``).
# f32 operands: the register-blocked scan, cfg -> (queries, corpus rows
# per tile), staged 32 deep by TMA in a 4-stage ring; the FMA scan (Q <= 8,
# or a k whose lists the first does not hold), cfg -> (queries, rows per
# tile, blocks per SM), staged 32 deep. bf16, the wgmma scan (one block per
# SM): cfg -> (query rows per tile, corpus rows per tile); and the k-1
# scan for many queries: 2-block clusters, a 4-stage ring.
_SIMT = {4: (64, 128), 5: (128, 128)}
_SIMT_DK, _SIMT_STAGES, _SIMT_CB = 32, 4, 16
_FMA = {1: (8, 128, 8)}
_FMA_DK = 32
_TC = {2: (128, 256), 3: (256, 128)}
_K1 = {6: (128, 256)}
_K1_STAGES = 4
# the wgmma scan's ring (stages of 64-deep bf16 slices), the keys one fold
# holds (8 a thread of its 512), and the device memory its candidate
# buffers may take (fewer ranges past it)
_TC_STAGES, _TC_DK, _TC_THREADS = 4, 64, 512
_TC_FOLD_MAX = 8 * _TC_THREADS
_TC_SCRATCH = 512 << 20
# bf16 queries from which exact mode at k 1 takes the k-1 scan. On an H100
# it was faster at every Q measured, 256 to 32,768 (tools/topk_ab.py
# --crossover); Q <= 256, the serve probe at nprobe 1, stays on the wgmma
# scan that serves it
_K1_MIN_Q = 257


class Plan(NamedTuple):
    cfg: int             # first-pass configuration (``_SIMT``, ``_FMA``, ``_TC`` or ``_K1``)
    qb: int              # queries per block
    tn: int              # corpus rows per tile
    n_ranges: int        # corpus ranges: the ranges' grid axis of the first pass
    range_rows: int      # rows per range, a multiple of ``tn``
    smem: int            # shared memory bytes per block
    cap: int = 0         # wgmma scan: candidate slots per (query, range)
    nbins: int = 0       # wgmma scan: shared bins per query (0: none)

    @property
    def tensor_cores(self) -> bool:
        return self.cfg in _TC or self.cfg in _K1


def _smem(cfg: int, qb: int, k: int) -> int:
    """Mirror of ``topk_smem_bytes`` in csrc/topk.cu."""
    if cfg in _SIMT:   # 1 KiB to align the ring, the ring, a barrier a stage, lists
        qt, tn = _SIMT[cfg]
        return (1024 + _SIMT_STAGES * (qt + tn) * _SIMT_DK * 4 + 8 * _SIMT_STAGES
                + 8 * qt * (k + _SIMT_CB) + 4 * qt)
    if cfg in _FMA:   # query and corpus slices (rows padded by one), scores, lists
        qt, tn, _ = _FMA[cfg]
        return 4 * (qt * _FMA_DK + tn * (_FMA_DK + 1) + qt * tn) + 8 * qt * k
    if cfg in _K1:   # 1 KiB to align the ring, the ring, a full and an empty barrier a stage
        qt, tn = _K1[cfg]
        return 1024 + _K1_STAGES * (qt + tn) * _TC_DK * 2 + 16 * _K1_STAGES
    # 1 KiB to align the ring, the ring, 64 bytes of stage barriers; per
    # query of the tile a threshold, a count and a bound (16 bytes), whatever
    # k; 16 bytes of block scratch; per thread two top-4 lists (32 bytes)
    qt, tn = _TC[cfg]
    return 1024 + _TC_STAGES * (qt + tn) * _TC_DK * 2 + 64 + 16 * qt + 16 + 32 * _TC_THREADS


def _plan(qn: int, n_eff: int, k: int, dtype, sms: int, *, aligned: bool = True,
          fast: bool = False) -> Plan:
    """The launch plan for Q ``qn`` queries over ``n_eff`` valid rows.

    f32 operands take the register-blocked scan: the 128-query tile when
    its tiles alone fill the card, else the 64-query one, whichever holds
    the lists; Q <= 8, or a k neither holds, takes the 8-query FMA scan.
    bf16 operands in exact mode at k 1 with 16-byte rows (``aligned``) and
    at least ``_K1_MIN_Q`` queries take the k-1 scan (128 queries a block).
    Other bf16 calls take the wgmma scan with the smallest query tile that
    holds all ``qn`` queries (128 or 256), so Q <= 256 reads the corpus
    once at every k: its blocks keep no per-query list, so k does not
    change the queries a block serves. Its candidates take ``cap`` = 2k +
    2 (rows per tile) slots per query and range in device memory, at most
    ``_TC_FOLD_MAX`` and at least k + (rows per tile) + 8 (a buffer past
    cap - (rows per tile) - 8 is folded to its k best), and ``nbins`` =
    ceil(k / 4) shared bins per query when the lanes of all ranges (4 per
    warpgroup column) are that many sources, else none. The ranges fill
    one wave of the card's ``sms`` SMs, tile-aligned, and are fewer when
    the candidate buffers would pass ``_TC_SCRATCH`` bytes. Raises
    ValueError for a k no configuration holds."""
    if dtype == torch.float32:
        cfg = 1
        if qn > 8:
            wide = -(-qn // _SIMT[5][0]) >= sms
            cfg = next((c for c in ((5, 4) if wide else (4,))
                        if _smem(c, _SIMT[c][0], k) <= _BLOCK_SMEM), 1)
        qb, tn = (_SIMT[cfg] if cfg in _SIMT else _FMA[cfg][:2])
        per_sm = _FMA[cfg][2] if cfg in _FMA else 1
    elif dtype == torch.bfloat16:
        if k == 1 and not fast and aligned and qn >= _K1_MIN_Q:
            cfg = min(_K1)
            qb = _K1[cfg][0]
        else:
            # configurations are numbered by query tile; take the first that
            # holds every query
            cfg = min((c for c in _TC if _TC[c][0] >= qn), default=max(_TC))
            qb = min(_TC[cfg][0], qn)
        tn, per_sm = (_K1[cfg] if cfg in _K1 else _TC[cfg])[1], 1
    else:
        raise TypeError(f"x must be float32 or bfloat16, got {dtype}")
    smem = _smem(cfg, qb, k)
    cap = min(2 * k + 2 * tn, _TC_FOLD_MAX) if cfg in _TC else 0
    if smem > _BLOCK_SMEM or cap and cap < k + tn + 8:
        raise ValueError(f"k={k} needs more shared memory than a block has")
    q_tiles = -(-qn // qb)
    want = max(1, sms * per_sm // q_tiles)
    if cap:
        want = min(want, max(1, _TC_SCRATCH // (8 * qn * cap)))
    n_ranges = max(1, min(want, -(-n_eff // tn)))
    range_rows = -(-max(n_eff, 1) // n_ranges)
    range_rows = -(-range_rows // tn) * tn
    n_ranges = max(1, -(-n_eff // range_rows))
    # sources of the bins: 4 lanes a warpgroup column (tn / 128) a range
    nbins = -(-k // 4) if cap and -(-k // 4) <= n_ranges * (tn // 128) * 4 else 0
    return Plan(cfg, qb, tn, n_ranges, range_rows, smem, cap, nbins)


@functools.lru_cache(maxsize=256)
def _launch_plan(qn: int, n_eff: int, k: int, dtype, device: int, aligned: bool = True,
                 fast: bool = False) -> Plan:
    """``_plan`` for this card, checked once against the kernel's own
    shared-memory count."""
    p = _plan(qn, n_eff, k, dtype, torch.cuda.get_device_properties(device).multi_processor_count,
              aligned=aligned, fast=fast)
    if _lib().topk_smem_bytes(p.cfg, p.qb, k) != p.smem:
        raise RuntimeError("the top-k plan and csrc/topk.cu disagree on shared memory")
    return p


def _topk_cuda(q, x, n_valid: int, k: int, chunk: int = 0, lane_bits: int = 0):
    """The kernel; ``lane_bits`` > 0 selects fast mode at this ``chunk``.
    The ``topk`` span runs from here to the launcher's return."""
    with trace.span("topk", device=x.device, q=q.shape[0], rows=n_valid, k=k):
        return _topk_launch(q, x, n_valid, k, chunk, lane_bits)


def _topk_launch(q, x, n_valid: int, k: int, chunk: int, lane_bits: int):
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
    # 16-byte rows and bases: the tensor-core scans stage by TMA, the
    # register-blocked f32 scan by cp.async
    vec = (d % (16 // x.element_size()) == 0 and q.data_ptr() % 16 == 0
           and x.data_ptr() % 16 == 0)
    p = _launch_plan(qn, n_eff, k, x.dtype, x.device.index, vec, fast)
    # fast-mode key layout: the chunk's row count and the corpus's chunks
    chunk_log2, n_chunks = (chunk.bit_length() - 1, x.shape[0] // chunk) if fast else (0, 0)
    # one 8-byte entry per candidate: the range lists ((f32, i32) exact,
    # int64 key fast), or the wgmma scan's candidate keys, then their counts
    # (int32) and the shared bins (uint32), zeroed by the launcher
    slots = qn * p.n_ranges * (p.cap or k)
    extra = qn * (p.n_ranges + p.nbins) if p.cap else 0
    cand = torch.empty(slots + (extra + 1) // 2, dtype=torch.int64, device=x.device)
    cnt = cand.data_ptr() + 8 * slots
    err = lib.topk_launch(
        q.data_ptr(), x.data_ptr(), p.cfg, int(vec), qn, n_eff, d, k, p.qb, p.n_ranges,
        p.range_rows, int(fast), lane_bits, chunk_log2, n_chunks, p.cap, p.nbins,
        cand.data_ptr(), cnt, cnt + 4 * qn * p.n_ranges, out_v.data_ptr(), out_i.data_ptr(),
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
