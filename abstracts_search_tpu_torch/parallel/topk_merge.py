"""Top-k merge over parts of a corpus.

The JAX package all-gathers each device's (values, global rows) top-k
over its mesh and reduces the [parts * k_local] candidates back to k
(``merge_topk_all_gather``). Here the parts arrive as one tensor; the
reduction is the same: part-major concatenation, then a stable top-k, so
the lowest part wins ties.
"""

from __future__ import annotations

import torch


def merge_topk(values, indices, k: int):
    """values, indices: [P, Q, k_local], indices already global rows.
    -> (values [Q, k], indices [Q, k]) under (value desc, part asc,
    position in the part's list asc)."""
    p, q, kl = values.shape
    all_v = values.permute(1, 0, 2).reshape(q, p * kl)
    all_i = indices.permute(1, 0, 2).reshape(q, p * kl)
    top_v, order = torch.sort(all_v, dim=1, descending=True, stable=True)
    return top_v[:, :k], torch.gather(all_i, 1, order[:, :k])
