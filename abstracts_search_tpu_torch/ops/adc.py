"""IVF-PQ ADC scans — the IVF-PQ query hot loop.

A *slot* is a pair (query ``q_ids[i]``, segment ``seg_ids[i]``) over the
list payload ``codes3``. Each row of the segment scores
``sum_m luts[q, m, code_m]``, added in the fixed order m = 0..M-1.

Two ops:

- ``adc_topk``: fused scan + per-slot top-kp over the transposed payload
  ``[n_segs, MB, SEG]`` (what every fill writes). Rows at or past
  ``valid_cnt[i]`` are -inf; the slot keeps its top-kp rows (value desc,
  row asc; (-inf, 0) where fewer than kp rows are valid). The per-slot
  bias q . c_list is constant within a slot, so the caller adds it to the
  kp winners.
- ``adc_scan``: the raw sums ``[n_slots, SEG]``, no mask, no selection,
  over either layout: transposed ``[n_segs, MB, SEG]`` or row-major
  ``[n_segs, SEG, MB]`` (legacy format<=2 artifacts). The caller adds
  the bias, masks and selects.

Payloads are nibble-packed (ksub 16, MB = M/2: byte j holds subspace 2j
in its low nibble and 2j+1 in its high nibble) or unpacked (ksub up to
256, MB = M), told apart by shape (``_is_packed``).

Each op has an ``impl`` switch:

- ``"cuda"``: the hand-written kernels, ``csrc/adc_topk.cu`` and
  ``csrc/adc_scan.cu``. Every one stages each slot's tile through a ring
  of shared-memory stages filled by bulk async copies
  (``csrc/adc_stage.cuh``), with the launch plan from ``_adc_plan``;
- ``"torch"``: the plain versions ``adc_topk_torch`` (twin of the JAX
  package's ``adc_topk_xla``) and ``adc_scan_torch`` (twin of
  ``adc_scan_xla``). They add the M lookups in the kernels' order, so
  kernel and plain version agree bit for bit.

``"auto"`` takes the kernel for a CUDA tensor and the plain version for
a CPU tensor. The LUTs are passed as [Q, M, ksub], with no re-layout.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

NEG_INF = float("-inf")

# kernel launches through adc_topk, and through adc_scan by kernel (named
# after the TPU kernel each replaces)
launches = 0
scan_launches = {"adc_kernel_t": 0, "adc_kernel_packed4": 0, "adc_kernel": 0}

_SMEM_LIMIT = 232_448
_SLOT_CHUNK = 8192

# the staging ring (csrc/adc_stage.cuh): at most 16 consumer warps per
# block, chunks of about 4 KiB, and 3, else 2, else 1 stages per warp
_STAGE_MAX_WARPS = 16
_CHUNK_TARGET = 4096
_DEPTHS = (3, 2, 1)
# two LUT buffers where they leave room for this many warps at full depth
# (a block then crosses a query boundary without draining); else one
_TWO_LUT_WARPS = 8
# LUT mailbox entries per warp (adc_stage::MAIL)
_MAIL = 4


def _is_packed(codes3, luts, transposed: bool) -> bool:
    """Nibble-packed payloads (ksub 16, MB = M/2), told from unpacked
    4-bit payloads by shape; MB is axis 1 transposed, axis 2 row-major."""
    mb_axis = 1 if transposed else 2
    return luts.shape[2] == 16 and codes3.shape[mb_axis] * 2 == luts.shape[1]


# -- launch plans of the staged kernels ------------------------------------------------


class AdcPlan(NamedTuple):
    rows: int          # "topk", "cols": rows per lane (a power of two <= 16); "rows": 0
    passes: int        # "topk", "cols": passes of 32 * rows over a slot's rows
    warps: int         # consumer warps per block (one producer warp more)
    depth: int         # ring stages per consumer warp
    chunk: int         # per chunk: byte-rows j ("topk", "cols") or rows ("rows")
    chunk_bytes: int
    n_luts: int        # LUT buffers
    smem: int          # shared memory bytes per block
    grid: int          # persistent blocks, one per SM


def _align(b: int, to: int) -> int:
    return -(-b // to) * to


def _stage_smem(warps: int, depth: int, chunk_bytes: int, lut_bytes: int, n_luts: int) -> int:
    """Mirror of ``adc_stage::smem_bytes`` in csrc/adc_stage.cuh: 256
    bytes to align the start, the LUT buffers (256-byte aligned), the
    stages, 8-byte barriers per stage and LUT, and per warp two 4-byte
    counters and ``_MAIL`` mailbox words."""
    return (256 + n_luts * _align(lut_bytes, 256) + warps * depth * _align(chunk_bytes, 16)
            + 8 * (warps * depth + n_luts) + 4 * warps * (2 + _MAIL))


@functools.lru_cache(maxsize=256)
def _adc_plan(kind: str, mb: int, seg: int, m: int, ksub: int, n_slots: int,
              sms: int) -> AdcPlan:
    """The launch plan of a staged kernel over transposed [MB, SEG] tiles
    chunked by byte-rows (``kind`` "topk", the fused scan, or "cols", the
    raw scan) or row-major [SEG, MB] tiles chunked by rows ("rows", the
    raw scan, packed or a code a byte).

    A chunk is about ``_CHUNK_TARGET`` bytes; the ring takes the deepest
    of ``_DEPTHS`` that fits with at least one warp, and then as many
    warps as fit. The chunk halves while not even one warp and one stage
    fit. The LUT gets two buffers where they leave room for
    ``_TWO_LUT_WARPS`` warps at full depth (up to 64 KiB LUTs at 4 KiB
    chunks), else one. One block per SM (``sms``), at most one per slot,
    so ``n_slots`` past ``sms`` gives the same plan. Raises ValueError
    where one byte-row (or row) and the LUT do not fit shared memory."""
    lut_bytes = 4 * m * ksub
    if kind in ("topk", "cols"):
        rows = min(16, 1 << max(0, (-(-seg // 32) - 1).bit_length()))
        passes = -(-seg // (32 * rows))
        unit, units = seg, mb          # bytes per byte-row, byte-rows per tile
    elif kind == "rows":
        rows, passes = 0, 1
        unit, units = mb, seg          # bytes per row, rows per tile
    else:
        raise ValueError(f"unknown kind {kind!r}")
    chunk = max(1, min(units, _CHUNK_TARGET // unit))
    n_luts = 2 if _stage_smem(_TWO_LUT_WARPS, _DEPTHS[0], chunk * unit, lut_bytes,
                              2) <= _SMEM_LIMIT else 1
    while True:
        for depth in _DEPTHS:
            fits = [w for w in range(1, _STAGE_MAX_WARPS + 1)
                    if _stage_smem(w, depth, chunk * unit, lut_bytes, n_luts) <= _SMEM_LIMIT]
            if fits:
                warps = max(fits)
                return AdcPlan(rows, passes, warps, depth, chunk, chunk * unit, n_luts,
                               _stage_smem(warps, depth, chunk * unit, lut_bytes, n_luts),
                               max(1, min(n_slots, sms)))
        if chunk == 1:
            raise ValueError(f"a [{m}, {ksub}] LUT and {unit}-byte chunks do not fit "
                             f"shared memory")
        chunk //= 2


@functools.lru_cache(maxsize=64)
def _check_smem(kind: str, warps: int, depth: int, chunk_bytes: int, lut_bytes: int,
                n_luts: int, smem: int) -> None:
    """The plan's shared-memory count against the kernel's own, once."""
    lib, fn = ((_lib(), "adc_topk_smem_bytes") if kind == "topk" else
               (_scan_lib(), "adc_scan_smem_bytes"))
    if getattr(lib, fn)(warps, depth, chunk_bytes, lut_bytes, n_luts) != smem:
        raise RuntimeError(f"the ADC plan and csrc/adc_stage.cuh disagree on shared memory "
                           f"({kind})")


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _launch_plan(kind: str, codes3, mb: int, seg: int, m: int, ksub: int,
                 n_slots: int) -> AdcPlan:
    sms = _sms(codes3.device.index)
    p = _adc_plan(kind, mb, seg, m, ksub, min(n_slots, sms), sms)
    _check_smem(kind, p.warps, p.depth, p.chunk_bytes, 4 * m * ksub, p.n_luts, p.smem)
    return p


def _check_payload(codes3, luts, transposed: bool) -> bool:
    if codes3.dim() != 3 or codes3.dtype != torch.uint8:
        raise ValueError(f"codes3 must be [n_segs, MB, SEG] or [n_segs, SEG, MB] "
                         f"uint8, got {tuple(codes3.shape)} {codes3.dtype}")
    if luts.dim() != 3 or luts.dtype != torch.float32:
        raise ValueError(f"luts must be [Q, M, ksub] float32, got "
                         f"{tuple(luts.shape)} {luts.dtype}")
    mb = codes3.shape[1 if transposed else 2]
    _, m, ksub = luts.shape
    packed = _is_packed(codes3, luts, transposed)
    if mb != (m // 2 if packed else m) or ksub > 256:
        raise ValueError(f"payload bytes {mb} do not fit M={m}, ksub={ksub}")
    return packed


def _check_shapes(codes3, luts, seg_ids, q_ids, valid_cnt, kp):
    packed = _check_payload(codes3, luts, transposed=True)
    n = seg_ids.shape[0]
    if q_ids.shape != (n,) or valid_cnt.shape != (n,):
        raise ValueError("seg_ids, q_ids and valid_cnt must be [n_slots]")
    if not 0 < kp <= codes3.shape[2]:
        raise ValueError(f"kp={kp} must be in [1, SEG={codes3.shape[2]}]")
    return packed


def _check_cuda(codes3, luts, **slot_arrays):
    """The kernels take every input contiguous on one CUDA device, with
    int32 slot arrays."""
    tensors = (codes3, luts, *slot_arrays.values())
    if not all(t.is_cuda and t.device == codes3.device for t in tensors):
        raise ValueError("the CUDA ADC scan needs every input on one CUDA device")
    for name, t in slot_arrays.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA ADC scan needs contiguous inputs")


def _sums(codes3, luts, seg_ids, q_ids, packed: bool, transposed: bool):
    """Raw ADC sums [S, SEG] for a few slots, adding the M lookups in
    order m = 0..M-1 as the kernels do."""
    _, m, ksub = luts.shape
    tiles = codes3[seg_ids.long()]                         # [S, MB, SEG] | [S, SEG, MB]
    if not transposed:
        tiles = tiles.transpose(1, 2)                      # -> [S, MB, SEG]
    flat = luts.reshape(-1)
    base = q_ids.long()[:, None] * (m * ksub)              # [S, 1]
    acc = torch.zeros((tiles.shape[0], tiles.shape[2]), dtype=torch.float32,
                      device=codes3.device)
    for mm in range(m):
        if packed:
            byte = tiles[:, mm // 2, :]
            code = (byte & 15) if mm % 2 == 0 else (byte >> 4)
        else:
            code = tiles[:, mm, :]
        acc = acc + flat[base + mm * ksub + code.long()]
    return acc


def adc_topk_torch(codes3, luts, seg_ids, q_ids, valid_cnt, kp: int):
    packed = _check_shapes(codes3, luts, seg_ids, q_ids, valid_cnt, kp)
    seg = codes3.shape[2]
    dev = codes3.device
    n_slots = seg_ids.shape[0]
    rows = torch.arange(seg, device=dev)
    out_v = torch.empty((n_slots, kp), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_slots, kp), dtype=torch.int32, device=dev)
    for s0 in range(0, n_slots, _SLOT_CHUNK):     # bounds the [S, SEG] temporaries
        s1 = min(s0 + _SLOT_CHUNK, n_slots)
        acc = _sums(codes3, luts, seg_ids[s0:s1], q_ids[s0:s1], packed, True)
        acc = torch.where(rows[None, :] < valid_cnt[s0:s1, None].to(dev), acc,
                          NEG_INF)
        v, order = torch.sort(acc, dim=1, descending=True, stable=True)
        v = v[:, :kp]
        out_v[s0:s1] = v
        out_i[s0:s1] = torch.where(v == NEG_INF, 0, order[:, :kp]).to(torch.int32)
    return out_v, out_i


def _lib():
    lib = _build.library("adc_topk")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.adc_topk_launch.argtypes = [vp, vp, vp, vp, vp] + [i] * 13 + [vp, vp, vp, vp]
        lib.adc_topk_launch.restype = i
        lib.adc_topk_smem_bytes.argtypes = [i] * 5
        lib.adc_topk_smem_bytes.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def adc_topk_cuda(codes3, luts, seg_ids, q_ids, valid_cnt, kp: int):
    global launches
    packed = _check_shapes(codes3, luts, seg_ids, q_ids, valid_cnt, kp)
    _check_cuda(codes3, luts, seg_ids=seg_ids, q_ids=q_ids, valid_cnt=valid_cnt)
    _, mb, seg = codes3.shape
    _, m, ksub = luts.shape
    n_slots = seg_ids.shape[0]
    p = _launch_plan("topk", codes3, mb, seg, m, ksub, n_slots)
    dev = codes3.device
    out_v = torch.empty((n_slots, kp), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_slots, kp), dtype=torch.int32, device=dev)
    if n_slots == 0:
        return out_v, out_i
    # partial sums of the slots whose rows take several passes
    scratch = (torch.empty((p.grid * p.warps * seg,), dtype=torch.float32, device=dev)
               if p.passes > 1 else None)
    err = _lib().adc_topk_launch(
        codes3.data_ptr(), luts.data_ptr(), seg_ids.data_ptr(), q_ids.data_ptr(),
        valid_cnt.data_ptr(), n_slots, mb, seg, m, ksub, int(packed), kp, p.rows, p.warps,
        p.depth, p.chunk, p.n_luts, p.grid,
        scratch.data_ptr() if scratch is not None else None,
        out_v.data_ptr(), out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "adc_topk")
    launches += 1
    return out_v, out_i


def adc_topk(codes3, luts, seg_ids, q_ids, valid_cnt, kp: int, *,
             impl: str = "auto"):
    """Per-slot (scan -> mask -> top-kp): returns (values [n_slots, kp]
    f32 raw ADC sums, rows [n_slots, kp] int32 within the segment).
    impl: "cuda" | "torch" | "auto"."""
    if impl == "auto":
        impl = "cuda" if codes3.is_cuda else "torch"
    if impl == "cuda":
        if not codes3.is_cuda:
            raise ValueError("impl='cuda' needs CUDA tensors")
        return adc_topk_cuda(codes3, luts, seg_ids, q_ids, valid_cnt, kp)
    if impl == "torch":
        return adc_topk_torch(codes3, luts, seg_ids, q_ids, valid_cnt, kp)
    raise ValueError(f"unknown impl {impl!r}")


# -- raw scans (kernels 4-6 of the JAX package) ---------------------------------------


def _check_scan(codes3, luts, seg_ids, q_ids, transposed: bool) -> bool:
    packed = _check_payload(codes3, luts, transposed)
    if seg_ids.dim() != 1 or q_ids.shape != seg_ids.shape:
        raise ValueError("seg_ids and q_ids must be [n_slots]")
    return packed


def adc_scan_torch(codes3, luts, seg_ids, q_ids, *, transposed: bool):
    packed = _check_scan(codes3, luts, seg_ids, q_ids, transposed)
    seg = codes3.shape[2 if transposed else 1]
    n_slots = seg_ids.shape[0]
    out = torch.empty((n_slots, seg), dtype=torch.float32, device=codes3.device)
    for s0 in range(0, n_slots, _SLOT_CHUNK):
        s1 = min(s0 + _SLOT_CHUNK, n_slots)
        out[s0:s1] = _sums(codes3, luts, seg_ids[s0:s1], q_ids[s0:s1], packed, transposed)
    return out


def _scan_lib():
    lib = _build.library("adc_scan")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.adc_cols_launch.argtypes = [vp] * 4 + [i] * 12 + [vp, vp]
        lib.adc_cols_launch.restype = i
        lib.adc_rows_launch.argtypes = [vp] * 4 + [i] * 11 + [vp, vp]
        lib.adc_rows_launch.restype = i
        lib.adc_scan_smem_bytes.argtypes = [i] * 5
        lib.adc_scan_smem_bytes.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def adc_scan_cuda(codes3, luts, seg_ids, q_ids, *, transposed: bool):
    packed = _check_scan(codes3, luts, seg_ids, q_ids, transposed)
    _check_cuda(codes3, luts, seg_ids=seg_ids, q_ids=q_ids)
    mb, seg = (codes3.shape[1], codes3.shape[2]) if transposed else \
        (codes3.shape[2], codes3.shape[1])
    _, m, ksub = luts.shape
    n_slots = seg_ids.shape[0]
    dev = codes3.device
    p = _launch_plan("cols" if transposed else "rows", codes3, mb, seg, m, ksub, n_slots)
    out = torch.empty((n_slots, seg), dtype=torch.float32, device=dev)
    if n_slots == 0:
        return out
    args = (codes3.data_ptr(), luts.data_ptr(), seg_ids.data_ptr(), q_ids.data_ptr(),
            n_slots, mb, seg, m, ksub, int(packed))
    tail = (p.warps, p.depth, p.chunk, p.n_luts, p.grid, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if transposed:                          # kernel 4
        err = _scan_lib().adc_cols_launch(*args, p.rows, *tail)
        key = "adc_kernel_t"
    else:                                   # kernels 5 (packed) and 6 (bytes)
        err = _scan_lib().adc_rows_launch(*args, *tail)
        key = "adc_kernel_packed4" if packed else "adc_kernel"
    _build.check(err, "adc_scan")
    scan_launches[key] += 1
    return out


def adc_scan(codes3, luts, seg_ids, q_ids, *, transposed: bool, impl: str = "auto"):
    """Raw per-slot ADC sums [n_slots, SEG] f32 over transposed
    ([n_segs, MB, SEG]) or row-major ([n_segs, SEG, MB]) payloads.
    impl: "cuda" | "torch" | "auto"."""
    if impl == "auto":
        impl = "cuda" if codes3.is_cuda else "torch"
    if impl == "cuda":
        if not codes3.is_cuda:
            raise ValueError("impl='cuda' needs CUDA tensors")
        return adc_scan_cuda(codes3, luts, seg_ids, q_ids, transposed=transposed)
    if impl == "torch":
        return adc_scan_torch(codes3, luts, seg_ids, q_ids, transposed=transposed)
    raise ValueError(f"unknown impl {impl!r}")
