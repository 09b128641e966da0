"""Hand-written Hopper kernels and their plain PyTorch versions.

- ``topk`` — streaming top-k of q . x^T, exact and fast mode (the IVF
  probe, flat search). At k 1 it is also the index build's assignment:
  k-means (``index/kmeans.py``), the residual assignment of PQ training
  and the fused encode of the fill (``index/ivfpq.py``); no separate
  k-means kernel exists.
- ``adc``  — IVF-PQ ADC scans: fused scan + per-slot top-kp over
  transposed lists, and raw scans over either layout.
- ``experts`` — the grouped SwiGLU product of a sparse-expert layer over
  rows permuted by expert (Triton; the Moonlight and Kimi Linear
  encoders' experts).
- ``kda`` — the gated delta rule of Kimi Delta Attention over whole
  sequences, chunked (``csrc/kda.cu``; the Kimi Linear encoder's KDA
  layers).

Each op has an ``impl`` switch: ``"cuda"`` (the kernel in ``csrc/``,
built by ``_build`` with nvcc at first use, or Triton's, built at its
first call), ``"torch"`` (the plain
version: the CPU route and the oracle), ``"auto"`` (the kernel for CUDA
tensors, the plain version for CPU tensors). Nothing falls back from
the kernel to the plain version.
"""

from . import adc, experts, kda, topk
from .adc import adc_scan, adc_topk
from .experts import grouped_swiglu
from .kda import kda_scan
from .topk import streaming_topk

__all__ = ["adc_scan", "adc_topk", "grouped_swiglu", "kda_scan", "launch_counts",
           "streaming_topk"]


def launch_counts() -> dict:
    """Kernel launches so far, by kernel: each wrapper adds one where it
    launches its kernel (never on the plain route)."""
    return {"topk": topk.launches, "topk_fast": topk.fast_launches,
            "adc_topk": adc.launches, **adc.scan_launches,
            "experts": experts.launches, "kda": kda.launches}
