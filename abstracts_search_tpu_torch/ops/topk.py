"""Streaming exact top-k of inner products.

``streaming_topk(q, x, n_valid, k)`` returns, per query, the k largest
``q . x[r]`` over rows ``r < n_valid`` as (values [Q, k] f32, rows
[Q, k] int32), without a [Q, N] score matrix in device memory. Ties go
to the lowest row; slots with no candidate are (-inf, 0). It is the
probe of the IVF-PQ search, and later flat search and k-means
assignment (k = 1).

Two implementations behind ``impl``:

- ``"cuda"``: the hand-written kernel in ``csrc/topk.cu`` (a split-
  corpus pass with per-range top-k lists, then a merge pass);
- ``"torch"``: ``_topk_torch``, the plain version: a chunked scan with
  a running [Q, k] result, the twin of the JAX package's ``_topk_xla``.

``"auto"`` takes the kernel for a CUDA tensor and the plain version for
a CPU tensor. Operands are f32 (true IEEE f32 products) or bf16 (widened
to f32, where bf16 products are exact); scores always accumulate in f32.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = float("-inf")

# kernel launches through streaming_topk (pass 1 + pass 2 count as one)
launches = 0

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


def _lib():
    lib = _build.library("topk")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.topk_launch.argtypes = [vp, vp, i, i, i, i, i, i, i, i, vp, vp, vp, vp, vp]
        lib.topk_launch.restype = i
        lib.topk_smem_bytes.argtypes = [i, i]
        lib.topk_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def _topk_cuda(q, x, n_valid: int, k: int):
    global launches
    if not (q.is_cuda and x.is_cuda and q.device == x.device):
        raise ValueError("the CUDA top-k needs q and x on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"shapes q {tuple(q.shape)} and x {tuple(x.shape)}")
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
    cand_v = torch.empty((qn, n_ranges, k), dtype=torch.float32, device=x.device)
    cand_i = torch.empty((qn, n_ranges, k), dtype=torch.int32, device=x.device)
    out_v = torch.empty((qn, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((qn, k), dtype=torch.int32, device=x.device)
    if qn == 0:
        return out_v, out_i
    err = lib.topk_launch(
        q.data_ptr(), x.data_ptr(), int(x.dtype == torch.bfloat16), qn, n_eff, d,
        k, qt, n_ranges, range_rows, cand_v.data_ptr(), cand_i.data_ptr(),
        out_v.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "topk")
    launches += 1
    return out_v, out_i


def streaming_topk(q, x, n_valid, k: int, *, chunk: int = 1024,
                   impl: str = "auto", mode: str = "exact"):
    """Top-k inner products of q [Q, D] against x[:n_valid] (x [N, D],
    N a multiple of ``chunk``, k <= chunk). Returns (values [Q, k] f32,
    rows [Q, k] int32). impl: "cuda" | "torch" | "auto"."""
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
    if mode == "fast":
        raise NotImplementedError("fast mode: see ROADMAP")
    n_valid = int(n_valid)
    if impl == "cuda":
        if not x.is_cuda:
            raise ValueError("impl='cuda' needs CUDA tensors")
        return _topk_cuda(q, x, n_valid, k)
    return _topk_torch(q, x, n_valid, k, chunk)
