"""abstracts_search_tpu_torch — the query path of abstracts-search on
PyTorch and CUDA (NVIDIA Hopper, ``sm_90a``).

A second package beside the JAX one, ported slice by slice. What runs
here today:

- the serving path: hash-embedded queries -> ``IVFPQIndex`` probe
  (hand-written streaming top-k kernel) -> ADC scan (fused scan +
  per-slot top-k kernel over transposed lists, raw scan kernels over
  row-major legacy lists) -> ragged per-query merge -> host-side
  position resolution -> ``SearchEngine`` / HTTP;
- flat search: ``FlatIndex`` (exact streaming top-k), and the fast-mode
  top-k that ``bench.py``'s configuration runs.

- ``ops``      — the CUDA kernels (``csrc/``), their ctypes builder, and a
                 plain PyTorch version of each (CPU route, test oracle).
- ``index``    — CSR list artifacts (same on-disk format 3), the IVF-PQ
                 search index and the flat index.
- ``parallel`` — the top-k merge over corpus parts.
- ``models`` — the offline ``HashEmbedder``.
- ``serve``  — search engine, micro-batcher, HTTP app.

Entry points default to the CUDA device and raise without one; pass
``device="cpu"`` for the plain-PyTorch route.
"""

from .device import set_exact_f32

set_exact_f32()

__version__ = "0.1.0"
