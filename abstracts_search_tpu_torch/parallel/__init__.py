"""Corpus sharding over a ``torch.distributed`` mesh (``mesh.py``: one rank
per card or process, rank r owning the lists ``l % W == r``; with
``tp > 1`` a 2-D ``(shard, tp)`` mesh), the top-k merge over parts of a
corpus, across ranks by one all-gather (``topk_merge.py``), and the
encoder's tensor-parallel weight rules (``sharding.py``)."""

from .mesh import (Mesh, all_gather, all_reduce, broadcast, build_mesh, deal,
                   gather_objects, init_distributed, process_barrier, shard_rows,
                   shutdown_distributed, sum_in_rank_order)
from .sharding import shard_state_dict, stella_param_specs
from .topk_merge import merge_topk, merge_topk_all_gather

__all__ = ["Mesh", "all_gather", "all_reduce", "broadcast", "build_mesh", "deal",
           "gather_objects", "init_distributed", "merge_topk", "merge_topk_all_gather",
           "process_barrier", "shard_rows", "shard_state_dict", "shutdown_distributed",
           "stella_param_specs", "sum_in_rank_order"]
