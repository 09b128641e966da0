"""Hand-written Hopper kernels and their plain PyTorch versions.

- ``topk`` — streaming top-k of q . x^T, exact and fast mode (the IVF
  probe, flat search). At k 1 it is also the index build's assignment:
  k-means (``index/kmeans.py``), the residual assignment of PQ training
  and the fused encode of the fill (``index/ivfpq.py``); no separate
  k-means kernel exists.
- ``adc``  — IVF-PQ ADC scans: fused scan + per-slot top-kp over
  transposed lists, and raw scans over either layout.

Each op has an ``impl`` switch: ``"cuda"`` (the kernel in ``csrc/``,
built by ``_build`` with nvcc at first use), ``"torch"`` (the plain
version: the CPU route and the oracle), ``"auto"`` (the kernel for CUDA
tensors, the plain version for CPU tensors). Nothing falls back from
the kernel to the plain version.
"""

from .adc import adc_scan, adc_topk
from .topk import streaming_topk

__all__ = ["adc_scan", "adc_topk", "streaming_topk"]
