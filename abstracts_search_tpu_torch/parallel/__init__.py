"""Merging per-part results. Collectives across cards (NCCL) come with
the multi-GPU slice; on one card the parts are plain tensors."""

from .topk_merge import merge_topk

__all__ = ["merge_topk"]
