"""Top-k merge over parts of a corpus.

``merge_topk`` reduces [parts, Q, k_local] candidates back to k: a
part-major concatenation, then a stable top-k, so the lowest part wins
ties. ``merge_topk_all_gather`` is the JAX package's cross-device merge
over a ``torch.distributed`` mesh: each rank's [Q, k_local] values and
global indices are all-gathered (one collective), then merged the same
way on every rank, so the result is replicated.
"""

from __future__ import annotations

import torch

from .mesh import Mesh, all_gather


def merge_topk(values, indices, k: int):
    """values, indices: [P, Q, k_local], indices already global rows.
    -> (values [Q, k], indices [Q, k]) under (value desc, part asc,
    position in the part's list asc)."""
    p, q, kl = values.shape
    all_v = values.permute(1, 0, 2).reshape(q, p * kl)
    all_i = indices.permute(1, 0, 2).reshape(q, p * kl)
    top_v, order = torch.sort(all_v, dim=1, descending=True, stable=True)
    return top_v[:, :k], torch.gather(all_i, 1, order[:, :k])


def merge_topk_all_gather(values, indices, k: int, mesh: Mesh, *, stats=None):
    """Merge every rank's top-k: values [Q, k_local] f32 and indices
    [Q, k_local] (global rows or corpus positions) on each rank ->
    (values [Q, k], indices [Q, k] int64, stats [W, n] or None), the same
    on every rank, under (value desc, rank asc, position in the rank's list
    asc): ``lax.top_k``'s order over the gathered [W * k_local]
    candidates. ``stats``, an int64 vector of the same length on every
    rank, rides the same gather. Values travel as their f32 bits, so the
    merged scores are each rank's exactly."""
    q, kl = values.shape
    n = q * kl
    parts = [values.float().contiguous().view(torch.int32).reshape(-1).long(),
             indices.reshape(-1).long()]
    if stats is not None:
        parts.append(stats.reshape(-1).long().to(values.device))
    g = all_gather(mesh, torch.cat(parts))                       # [W, 2n (+ stats)]
    w = g.shape[0]
    v = g[:, :n].int().view(torch.float32).reshape(w, q, kl)
    i = g[:, n:2 * n].reshape(w, q, kl)
    top_v, top_i = merge_topk(v, i, k)
    return top_v, top_i, (g[:, 2 * n:] if stats is not None else None)
