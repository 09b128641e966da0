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

- ``"cuda"``: the hand-written kernel in ``csrc/topk.cu`` (a split-
  corpus pass with per-range top-k lists, then a merge pass), templated
  on the mode;
- ``"torch"``: the plain version, a chunked scan with a running [Q, k]
  result: ``_topk_torch`` (twin of the JAX package's ``_topk_xla``) and
  ``_topk_torch_fast`` (twin of ``_topk_xla_fast``).

``"auto"`` takes the kernel for a CUDA tensor and the plain version for
a CPU tensor. Operands are f32 (true IEEE f32 products) or bf16 (widened
to f32, where bf16 products are exact); scores always accumulate in f32.
"""

from __future__ import annotations

import ctypes

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

_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
_BLOCKS_PER_SM = 8


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
        lib.topk_launch.argtypes = [vp, vp, i, i, i, i, i, i, i, i, i, i, i, i, vp, vp,
                                    vp, vp]
        lib.topk_launch.restype = i
        lib.topk_smem_bytes.argtypes = [i, i]
        lib.topk_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


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
    lib = _lib()
    qn, d = q.shape
    qt = 8 if qn <= 8 or lib.topk_smem_bytes(32, k) > _SMEM_LIMIT else 32
    if lib.topk_smem_bytes(qt, k) > _SMEM_LIMIT:
        raise ValueError(f"k={k} needs more shared memory than a block has")
    tn = 64 if qt == 32 else 128
    n_eff = max(0, min(int(n_valid), x.shape[0]))
    q_tiles = -(-qn // qt)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    want = max(1, -(-sms * _BLOCKS_PER_SM // q_tiles))
    n_ranges = max(1, min(want, -(-n_eff // tn)))
    range_rows = -(-max(n_eff, 1) // n_ranges)
    range_rows = -(-range_rows // tn) * tn
    n_ranges = max(1, -(-n_eff // range_rows))
    # fast-mode key layout: the chunk's row count and the corpus's chunks
    chunk_log2, n_chunks = (chunk.bit_length() - 1, x.shape[0] // chunk) if fast else (0, 0)
    # one 8-byte list entry per candidate: (f32, i32) exact, int64 key fast
    cand = torch.empty((qn, n_ranges, k), dtype=torch.int64, device=x.device)
    out_v = torch.empty((qn, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((qn, k), dtype=torch.int32, device=x.device)
    if qn == 0:
        return out_v, out_i
    err = lib.topk_launch(
        q.data_ptr(), x.data_ptr(), int(x.dtype == torch.bfloat16), qn, n_eff, d,
        k, qt, n_ranges, range_rows, int(fast), lane_bits, chunk_log2, n_chunks,
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
