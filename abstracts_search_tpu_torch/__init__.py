"""abstracts_search_tpu_torch — the query path and the index build of
abstracts-search on PyTorch and CUDA (NVIDIA Hopper, ``sm_90a``).

A second package beside the JAX one, ported slice by slice. What runs
here today:

- the serving path: ``run_server(cfg)`` -> ``SearchEngine.from_artifacts``
  (index, ``params.json``, the ``ids.parquet`` id map, delta
  sub-indexes, OpenAlex hydration) -> queries embedded by the stella
  encoder (or the offline hash embedder) ->
  ``IVFPQIndex`` probe (hand-written streaming top-k kernel) -> ADC scan
  (fused scan + per-slot top-k kernel over transposed lists, raw scan
  kernels over row-major legacy lists) over lists on the card, gathered
  from the memmap per batch (host storage), or both (hybrid) -> ragged
  per-query merge -> host-side position resolution -> ids / HTTP; the
  same path corpus-sharded over a ``torch.distributed`` mesh (one rank per
  card or process, each holding the lists ``l % W == r``, merged by one
  all-gather; HTTP on rank 0, the other ranks following its searches),
  and the stella encoder at dp x tp over a 2-D ``(shard, tp)`` mesh (rows
  over ``shard``, each rank its tp slices of the weights, the partial
  sums all-reduced in its tp group; rank 0 tokenizes and broadcasts the
  token ids);
- flat search: ``FlatIndex`` (exact streaming top-k), and the fast-mode
  top-k that ``bench.py``'s configuration runs;
- the index build: ``IVFPQIndex.train`` (OPQ, spherical k-means with the
  top-k kernel at k 1 as its assignment, residual PQ) -> ``save`` ->
  ``load`` -> ``fill_stream`` (fused encode on the card, spill, external
  pack) -> ``save``.

- ``ops``      — the CUDA kernels (``csrc/``), their ctypes builder, and a
                 plain PyTorch version of each (CPU route, test oracle).
- ``index``    — CSR list artifacts (same on-disk format 3) and their
                 packing, the IVF-PQ index (search and build), k-means,
                 PQ, OPQ and the flat index.
- ``parallel`` — the corpus mesh (``torch.distributed``: ranks, the
                 collectives, row and list sharding; a 2-D mesh with a
                 ``tp`` axis), the top-k merge over corpus parts, across
                 ranks by one all-gather, and the encoder's TP rules.
- ``models`` — the stella encoder (Qwen2 backbone, pooling, MRL head),
               its embedding pipeline, weight loading (safetensors, HF
               snapshots, the JAX package's parameters) and the
               embedder registry with the offline ``HashEmbedder``.
- ``serve``  — search engine, micro-batcher, HTTP app, OpenAlex hydration.
- ``storage`` — the lazy ``ids.parquet`` id map and its binary sidecar;
               the rotated device source of the build's k-means.
- ``utils``  — stage timers, profiler scopes, iterator prefetch.
- ``driver`` — the delta-compaction policy.

Entry points default to the CUDA device and raise without one; pass
``device="cpu"`` for the plain-PyTorch route.
"""

from .device import set_exact_f32

set_exact_f32()

__version__ = "0.1.0"
