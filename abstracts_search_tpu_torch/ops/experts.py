"""The grouped SwiGLU expert product of a sparse-expert layer.

Token rows arrive permuted by expert: rows ``offsets[e]:offsets[e+1]``
of ``x`` [P, H] go to expert ``e``, each expert's block as long as its
load (zero rows included). Expert ``e`` computes

    y = (silu(x W_gate[e]^T) * (x W_up[e]^T)) W_down[e]^T

with its weights stacked: ``w13`` [E, 2I, H] (gate rows, then up rows)
and ``w2`` [E, H, I]. Operands are in the weights' dtype, products sum
in f32; the SwiGLU product ``h`` is taken in f32 from the two f32
accumulators and rounded once to the operand dtype for the down product;
``y`` comes out in f32 [P, H], unscaled (the caller weights and sums
the rows of each token).

``impl``:

- ``"cuda"``: two Triton kernels (bf16 only), written for this op; the
  JAX package has no counterpart (its encoder has no sparse-expert
  layer). Kernel 1 computes the gate and up tiles of one row tile in two
  f32 accumulators and writes ``h``; kernel 2 the down product. At
  abstract lengths an expert sees hundreds of rows, so both are
  compute-bound (about 3 x 2 x H x I operations a row against the
  expert's 17 MB of weights read once): the grid runs the output
  columns fastest, so one wave of the card shares a row tile in L2
  across its column tiles and an expert's weights across its row tiles.
  Uneven loads need no host sync: the wrapper makes a tile table on the
  card (``_tiles``), sized for the worst case (every expert's last tile
  partial), and tiles past the last live one return at once.
- ``"torch"``: a per-expert loop of f32 products on the same operands,
  ``h`` rounded alike: the CPU route and the oracle.
- ``"auto"``: the kernels for CUDA tensors, the loop for CPU tensors.
"""

from __future__ import annotations

import functools

import torch

# kernel launches through grouped_swiglu (two kernels a call)
launches = 0

# rows per tile; each kernel's column and depth tiles and launch settings
_BM = 128
_GATE_UP = {"BN": 64, "BK": 64, "num_warps": 8, "num_stages": 4}
_DOWN = {"BN": 128, "BK": 64, "num_warps": 8, "num_stages": 4}


def _check(x, offsets, w13, w2):
    if x.dim() != 2 or w13.dim() != 3 or w2.dim() != 3:
        raise ValueError("x must be [P, H], w13 [E, 2I, H] and w2 [E, H, I]")
    e, i2, h = w13.shape
    if x.shape[1] != h or w2.shape != (e, h, i2 // 2) or i2 % 2:
        raise ValueError(f"shapes do not fit: x {tuple(x.shape)}, w13 {tuple(w13.shape)}, "
                         f"w2 {tuple(w2.shape)}")
    if offsets.shape != (e + 1,):
        raise ValueError(f"offsets must be [E + 1] = [{e + 1}], got {tuple(offsets.shape)}")
    if not (x.dtype == w13.dtype == w2.dtype):
        raise TypeError(f"x, w13 and w2 must share a dtype, got {x.dtype}, {w13.dtype}, "
                        f"{w2.dtype}")


def grouped_swiglu_torch(x, offsets, w13, w2):
    """The plain version: one expert at a time."""
    _check(x, offsets, w13, w2)
    inter = w13.shape[1] // 2
    out = torch.zeros((x.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
    offs = offsets.tolist()
    for e in range(w13.shape[0]):
        lo, hi = offs[e], offs[e + 1]
        if hi == lo:
            continue
        gu = x[lo:hi].float() @ w13[e].float().T
        h = (torch.nn.functional.silu(gu[:, :inter]) * gu[:, inter:]).to(x.dtype)
        out[lo:hi] = h.float() @ w2[e].float().T
    return out


@functools.lru_cache(maxsize=None)
def _kernels():
    """The two Triton kernels, built at the first CUDA call (Triton is
    imported here: the CPU has none)."""
    import triton
    import triton.language as tl

    @triton.jit
    def experts_gate_up(x_ptr, w13_ptr, h_ptr, tile_e_ptr, tile_row_ptr, tile_end_ptr,
                        H: tl.constexpr, INTER: tl.constexpr, E: tl.constexpr,
                        BM: tl.constexpr, BN: tl.constexpr, BK: tl.constexpr):
        pid_n = tl.program_id(0)
        pid_m = tl.program_id(1)
        e = tl.load(tile_e_ptr + pid_m)
        if e >= E:
            return
        r0 = tl.load(tile_row_ptr + pid_m)
        r1 = tl.load(tile_end_ptr + pid_m)
        rows = r0 + tl.arange(0, BM)
        live = rows < r1
        cols = pid_n * BN + tl.arange(0, BN)
        ks = tl.arange(0, BK)
        a_ptrs = x_ptr + rows[:, None].to(tl.int64) * H + ks[None, :]
        g_ptrs = (w13_ptr + e.to(tl.int64) * (2 * INTER * H)
                  + cols[None, :].to(tl.int64) * H + ks[:, None])
        u_ptrs = g_ptrs + INTER * H
        acc_g = tl.zeros((BM, BN), dtype=tl.float32)
        acc_u = tl.zeros((BM, BN), dtype=tl.float32)
        for _ in range(0, H, BK):
            a = tl.load(a_ptrs, mask=live[:, None], other=0.0)
            acc_g += tl.dot(a, tl.load(g_ptrs))
            acc_u += tl.dot(a, tl.load(u_ptrs))
            a_ptrs += BK
            g_ptrs += BK
            u_ptrs += BK
        h = acc_g * tl.sigmoid(acc_g) * acc_u
        tl.store(h_ptr + rows[:, None].to(tl.int64) * INTER + cols[None, :],
                 h.to(h_ptr.dtype.element_ty), mask=live[:, None])

    @triton.jit
    def experts_down(h_ptr, w2_ptr, y_ptr, tile_e_ptr, tile_row_ptr, tile_end_ptr,
                     H: tl.constexpr, INTER: tl.constexpr, E: tl.constexpr,
                     BM: tl.constexpr, BN: tl.constexpr, BK: tl.constexpr):
        pid_n = tl.program_id(0)
        pid_m = tl.program_id(1)
        e = tl.load(tile_e_ptr + pid_m)
        if e >= E:
            return
        r0 = tl.load(tile_row_ptr + pid_m)
        r1 = tl.load(tile_end_ptr + pid_m)
        rows = r0 + tl.arange(0, BM)
        live = rows < r1
        cols = pid_n * BN + tl.arange(0, BN)
        ks = tl.arange(0, BK)
        a_ptrs = h_ptr + rows[:, None].to(tl.int64) * INTER + ks[None, :]
        b_ptrs = (w2_ptr + e.to(tl.int64) * (H * INTER)
                  + cols[None, :].to(tl.int64) * INTER + ks[:, None])
        acc = tl.zeros((BM, BN), dtype=tl.float32)
        for _ in range(0, INTER, BK):
            a = tl.load(a_ptrs, mask=live[:, None], other=0.0)
            acc += tl.dot(a, tl.load(b_ptrs))
            a_ptrs += BK
            b_ptrs += BK
        tl.store(y_ptr + rows[:, None].to(tl.int64) * H + cols[None, :], acc,
                 mask=live[:, None])

    return experts_gate_up, experts_down


def _tiles(offsets, n_rows: int, bm: int):
    """The tile table on the card: for each of the ``cdiv(P, bm) + E``
    row tiles a load of any split can need, its expert (E past the last
    live tile), first row and end row. No host sync."""
    e = offsets.shape[0] - 1
    counts = offsets[1:] - offsets[:-1]
    tiles = (counts + bm - 1) // bm
    cum = torch.cumsum(tiles, 0)
    n_tiles = -(-n_rows // bm) + e
    t = torch.arange(n_tiles, device=offsets.device, dtype=cum.dtype)
    tile_e = torch.searchsorted(cum, t, right=True)
    at = tile_e.clamp_max(e - 1)
    tile_row = offsets[at] + (t - (cum - tiles)[at]) * bm
    return (tile_e.to(torch.int32), tile_row.to(torch.int32), offsets[at + 1].to(torch.int32),
            n_tiles)


def grouped_swiglu_cuda(x, offsets, w13, w2):
    global launches
    _check(x, offsets, w13, w2)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA route takes bf16 operands, got {x.dtype}")
    tensors = (x, offsets, w13, w2)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("the CUDA route needs every input on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA route needs contiguous inputs")
    e, i2, h = w13.shape
    inter = i2 // 2
    if inter % _GATE_UP["BN"] or h % _GATE_UP["BK"] or h % _DOWN["BN"] or inter % _DOWN["BK"]:
        raise ValueError(f"H={h} and I={inter} must be multiples of the kernels' tiles")
    p = x.shape[0]
    y = torch.empty((p, h), dtype=torch.float32, device=x.device)
    if p == 0:
        return y
    gate_up, down = _kernels()
    tile_e, tile_row, tile_end, n_tiles = _tiles(offsets.long(), p, _BM)
    hbuf = torch.empty((p, inter), dtype=x.dtype, device=x.device)
    gate_up[(inter // _GATE_UP["BN"], n_tiles)](x, w13, hbuf, tile_e, tile_row, tile_end, H=h,
                                                INTER=inter, E=e, BM=_BM, **_GATE_UP)
    down[(h // _DOWN["BN"], n_tiles)](hbuf, w2, y, tile_e, tile_row, tile_end, H=h, INTER=inter,
                                      E=e, BM=_BM, **_DOWN)
    launches += 2
    return y


def grouped_swiglu(x, offsets, w13, w2, *, impl: str = "auto"):
    """Rows [P, H] permuted by expert, ``offsets`` [E + 1] (int, on the
    rows' device), stacked weights -> each row's expert output [P, H]
    f32 (module docstring). impl: "cuda" | "torch" | "auto"."""
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "torch"
    if impl == "cuda":
        if not x.is_cuda:
            raise ValueError("impl='cuda' needs CUDA tensors")
        return grouped_swiglu_cuda(x, offsets, w13, w2)
    if impl == "torch":
        return grouped_swiglu_torch(x, offsets, w13, w2)
    raise ValueError(f"unknown impl {impl!r}")
