"""Fused IVF-PQ ADC scan + per-slot top-kp — the IVF-PQ query hot loop.

A *slot* is a pair (query ``q_ids[i]``, segment ``seg_ids[i]``) over the
transposed payload ``codes3 [n_segs, MB, SEG]`` uint8. Each row scores
``sum_m luts[q, m, code_m]``; rows at or past ``valid_cnt[i]`` are -inf;
the slot keeps its top-kp rows (value desc, row asc; (-inf, 0) where
fewer than kp rows are valid). The per-slot bias q . c_list is constant
within a slot, so the caller adds it to the kp winners.

Payloads are nibble-packed (ksub 16, MB = M/2: byte j holds subspace 2j
in its low nibble and 2j+1 in its high nibble) or unpacked (ksub up to
256, MB = M), told apart by shape (``_is_packed``).

- ``"cuda"``: the hand-written kernel in ``csrc/adc_topk.cu``;
- ``"torch"``: ``adc_topk_torch``, the plain version (gather + sum, mask,
  stable sort), the twin of the JAX package's ``adc_topk_xla``. It adds
  the M lookups in the same order as the kernel, so the two agree bit
  for bit.

``"auto"`` takes the kernel for a CUDA tensor and the plain version for
a CPU tensor. The LUTs are passed as [Q, M, ksub], with no re-layout.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = float("-inf")

# kernel launches through adc_topk
launches = 0

_SMEM_LIMIT = 232_448
_BLOCKS_PER_SM = 16
_SLOT_CHUNK = 8192


def _is_packed(codes3, luts) -> bool:
    return luts.shape[2] == 16 and codes3.shape[1] * 2 == luts.shape[1]


def _check_shapes(codes3, luts, seg_ids, q_ids, valid_cnt, kp):
    if codes3.dim() != 3 or codes3.dtype != torch.uint8:
        raise ValueError(f"codes3 must be [n_segs, MB, SEG] uint8, got "
                         f"{tuple(codes3.shape)} {codes3.dtype}")
    if luts.dim() != 3 or luts.dtype != torch.float32:
        raise ValueError(f"luts must be [Q, M, ksub] float32, got "
                         f"{tuple(luts.shape)} {luts.dtype}")
    _, mb, seg = codes3.shape
    _, m, ksub = luts.shape
    packed = _is_packed(codes3, luts)
    if mb != (m // 2 if packed else m) or ksub > 256:
        raise ValueError(f"payload bytes {mb} do not fit M={m}, ksub={ksub}")
    n = seg_ids.shape[0]
    if q_ids.shape != (n,) or valid_cnt.shape != (n,):
        raise ValueError("seg_ids, q_ids and valid_cnt must be [n_slots]")
    if not 0 < kp <= seg:
        raise ValueError(f"kp={kp} must be in [1, SEG={seg}]")
    return packed


def adc_topk_torch(codes3, luts, seg_ids, q_ids, valid_cnt, kp: int):
    packed = _check_shapes(codes3, luts, seg_ids, q_ids, valid_cnt, kp)
    _, mb, seg = codes3.shape
    _, m, ksub = luts.shape
    dev = codes3.device
    n_slots = seg_ids.shape[0]
    flat = luts.reshape(-1)
    rows = torch.arange(seg, device=dev)
    out_v = torch.empty((n_slots, kp), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_slots, kp), dtype=torch.int32, device=dev)
    for s0 in range(0, n_slots, _SLOT_CHUNK):     # bounds the [S, SEG] temporaries
        s1 = min(s0 + _SLOT_CHUNK, n_slots)
        tiles = codes3[seg_ids[s0:s1].long()]                  # [S, MB, SEG]
        base = q_ids[s0:s1].long()[:, None] * (m * ksub)       # [S, 1]
        acc = torch.zeros((s1 - s0, seg), dtype=torch.float32, device=dev)
        for mm in range(m):                    # sequential, as the kernel adds
            if packed:
                byte = tiles[:, mm // 2, :]
                code = (byte & 15) if mm % 2 == 0 else (byte >> 4)
            else:
                code = tiles[:, mm, :]
            acc = acc + flat[base + mm * ksub + code.long()]
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
        lib.adc_topk_launch.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i,
                                        vp, vp, vp]
        lib.adc_topk_launch.restype = i
        lib._typed = True
    return lib


def adc_topk_cuda(codes3, luts, seg_ids, q_ids, valid_cnt, kp: int):
    global launches
    packed = _check_shapes(codes3, luts, seg_ids, q_ids, valid_cnt, kp)
    tensors = (codes3, luts, seg_ids, q_ids, valid_cnt)
    if not all(t.is_cuda and t.device == codes3.device for t in tensors):
        raise ValueError("the CUDA ADC scan needs every input on one CUDA device")
    for name, t in (("seg_ids", seg_ids), ("q_ids", q_ids), ("valid_cnt", valid_cnt)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA ADC scan needs contiguous inputs")
    _, mb, seg = codes3.shape
    _, m, ksub = luts.shape
    if 4 * (m * ksub + seg) > _SMEM_LIMIT:
        raise ValueError(f"a [{m}, {ksub}] LUT does not fit shared memory")
    n_slots = seg_ids.shape[0]
    out_v = torch.empty((n_slots, kp), dtype=torch.float32, device=codes3.device)
    out_i = torch.empty((n_slots, kp), dtype=torch.int32, device=codes3.device)
    if n_slots == 0:
        return out_v, out_i
    sms = torch.cuda.get_device_properties(codes3.device).multi_processor_count
    spb = max(1, n_slots // (sms * _BLOCKS_PER_SM))
    err = _lib().adc_topk_launch(
        codes3.data_ptr(), luts.data_ptr(), seg_ids.data_ptr(), q_ids.data_ptr(),
        valid_cnt.data_ptr(), n_slots, mb, seg, m, ksub, int(packed), kp, spb,
        out_v.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(codes3.device).cuda_stream)
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
