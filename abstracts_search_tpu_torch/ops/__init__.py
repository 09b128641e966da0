"""Hand-written Hopper kernels and their plain PyTorch versions.

- ``topk`` — streaming exact top-k of q . x^T (the IVF probe).
- ``adc``  — fused IVF-PQ ADC scan + per-slot top-kp.

Each op has an ``impl`` switch: ``"cuda"`` (the kernel in ``csrc/``,
built by ``_build`` with nvcc at first use), ``"torch"`` (the plain
version: the CPU route and the oracle), ``"auto"`` (the kernel for CUDA
tensors, the plain version for CPU tensors). Nothing falls back from
the kernel to the plain version.
"""

from .adc import adc_topk
from .topk import streaming_topk

__all__ = ["adc_topk", "streaming_topk"]
