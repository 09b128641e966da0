"""Corpus sharding over a ``torch.distributed`` mesh (``mesh.py``: one rank
per card or process, rank r owning the lists ``l % W == r``) and the
top-k merge over parts of a corpus, across ranks by one all-gather
(``topk_merge.py``)."""

from .mesh import (Mesh, all_gather, broadcast, build_mesh, init_distributed,
                   process_barrier, shard_rows, shutdown_distributed)
from .topk_merge import merge_topk, merge_topk_all_gather

__all__ = ["Mesh", "all_gather", "broadcast", "build_mesh", "init_distributed",
           "merge_topk", "merge_topk_all_gather", "process_barrier", "shard_rows",
           "shutdown_distributed"]
