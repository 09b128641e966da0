"""The gated delta rule of Kimi Delta Attention (KDA), over a whole sequence.

Per sequence and head, with a state ``S`` [K, V] in f32 that starts at 0::

    S_t = (I - b_t k_t k_t^T) Diag(a_t) S_{t-1} + b_t k_t v_t^T
    o_t = S_t^T q_t

where ``a_t = exp(g_t)`` is a per-channel decay (``g`` the log-decays,
[B, T, H, K] f32, each <= 0) and ``b_t`` a per-head write strength
(``beta`` [B, T, H]). ``q`` and ``k`` [B, T, H, K] arrive normalised
(and ``q`` scaled) by the caller, ``v`` [B, T, H, V] with V = K; ``o``
[B, T, H, V] comes out in ``q``'s dtype. The recurrence is causal, so
padding on the right of a sequence leaves its real tokens' outputs as
they are.

``impl``:

- ``"cuda"``: two CUDA kernels (``csrc/kda.cu``: its header sets out the
  chunked form, chunks of ``CHUNK`` tokens, and how the decays are kept
  from overflowing), written for this op; the JAX package has no
  counterpart (its encoder has no linear-attention layer). bf16 q, k, v,
  f32 log-decays; products take bf16 operands and sum in f32, the state
  and the decays stay in f32.
- ``"torch"``: the token-by-token recurrence in f32: the CPU route and
  the oracle.
- ``"auto"``: the kernels for CUDA tensors, the recurrence for CPU ones.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# kernel launches through kda_scan (two kernels a call)
launches = 0

# the kernels' chunk (tokens; csrc/kda.cu's C)
CHUNK = 64


def _check(q, k, v, g, beta):
    if q.dim() != 4 or q.shape != k.shape or q.shape != g.shape:
        raise ValueError(f"q, k and g must be [B, T, H, K] alike, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(g.shape)}")
    if v.shape != q.shape:
        raise ValueError(f"v must be [B, T, H, V] with V = K, got {tuple(v.shape)}")
    if beta.shape != q.shape[:3]:
        raise ValueError(f"beta must be [B, T, H] = {tuple(q.shape[:3])}, got "
                         f"{tuple(beta.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")


def kda_scan_torch(q, k, v, g, beta):
    """The plain version: one token at a time, every head at once, f32."""
    _check(q, k, v, g, beta)
    b, t, h, d = q.shape
    s = torch.zeros((b, h, d, v.shape[-1]), dtype=torch.float32, device=q.device)
    out = torch.empty((b, t, h, v.shape[-1]), dtype=torch.float32, device=q.device)
    qf, kf, vf = q.float(), k.float(), v.float()
    a, bf = g.float().exp(), beta.float()
    for i in range(t):
        s = s * a[:, i, :, :, None]
        kt = kf[:, i]
        pred = torch.einsum("bhk,bhkv->bhv", kt, s)
        s = s + torch.einsum("bhk,bhv->bhkv", kt, bf[:, i, :, None] * (vf[:, i] - pred))
        out[:, i] = torch.einsum("bhk,bhkv->bhv", qf[:, i], s)
    return out.to(q.dtype)


def _lib():
    lib = _build.library("kda")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.kda_launch.argtypes = [vp] * 12 + [i] * 4 + [vp]
        lib.kda_launch.restype = i
        lib.kda_chunk.restype = i
        if lib.kda_chunk() != CHUNK:
            raise RuntimeError(f"csrc/kda.cu chunks by {lib.kda_chunk()}, ops/kda.py by {CHUNK}")
        lib._typed = True
    return lib


def kda_scan_cuda(q, k, v, g, beta):
    global launches
    _check(q, k, v, g, beta)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA route takes bf16 q, k and v, got {q.dtype}")
    if g.dtype != torch.float32:
        raise TypeError(f"the CUDA route takes f32 log-decays, got {g.dtype}")
    tensors = (q, k, v, g, beta)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("the CUDA route needs every input on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA route needs contiguous inputs")
    b, t, h, d = q.shape
    if d != 128:
        raise ValueError(f"the CUDA route takes KDA's head width 128, got {d}")
    o = torch.empty_like(v)
    if b * t * h == 0:
        return o
    nt = -(-t // CHUNK)
    dev = q.device
    # what the chunk pass leaves the state pass (csrc/kda.cu)
    u = torch.empty((b * h, nt, CHUNK, d), dtype=torch.float32, device=dev)
    wn, qg, kd = (torch.empty((b * h, nt, CHUNK, d), dtype=torch.bfloat16, device=dev)
                  for _ in range(3))
    m = torch.empty((b * h, nt, CHUNK, CHUNK), dtype=torch.bfloat16, device=dev)
    gl = torch.empty((b * h, nt, d), dtype=torch.float32, device=dev)
    beta = beta.float().contiguous()
    err = _lib().kda_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                            beta.data_ptr(), u.data_ptr(), wn.data_ptr(), m.data_ptr(),
                            qg.data_ptr(), kd.data_ptr(), gl.data_ptr(), o.data_ptr(), b, t, h, d,
                            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "kda")
    launches += 2
    return o


def kda_scan(q, k, v, g, beta, *, impl: str = "auto"):
    """q, k [B, T, H, K], v [B, T, H, K], log-decays g [B, T, H, K] f32,
    beta [B, T, H] -> o [B, T, H, K] in q's dtype (module docstring).
    impl: "cuda" | "torch" | "auto"."""
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "torch"
    if impl == "cuda":
        if not q.is_cuda:
            raise ValueError("impl='cuda' needs CUDA tensors")
        return kda_scan_cuda(q, k, v, g, beta)
    if impl == "torch":
        return kda_scan_torch(q, k, v, g, beta)
    raise ValueError(f"unknown impl {impl!r}")
