"""Exact inner-product top-k over a flat shard, written plainly.

The deployment's semantics: rows and queries are held in the shard's
dtype (bf16 on the card) and every product is summed in f32. The judge
compares served (rows, scores) with the reference rank by rank:
``score_err`` is the served score against the reference's score of the
same row, ``rank_gap`` the served row's reference score against the
reference's own score at that rank. A row outside the shard, or served
twice, reads infinite.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .stella import exact_f32


def top(x: torch.Tensor, q: torch.Tensor, k: int, block: int = 1 << 18):
    """(values [Q, k], rows [Q, k]) of the k best rows of ``x`` [N, D]."""
    qx = q.to(x.dtype).float()
    best_v = torch.full((len(q), 0), -math.inf, device=x.device)
    best_i = torch.zeros((len(q), 0), dtype=torch.int64, device=x.device)
    for lo in range(0, len(x), block):
        s = qx @ x[lo:lo + block].float().T
        v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        best_v, at = torch.topk(torch.cat([best_v, v], 1), min(k, best_v.shape[1] + v.shape[1]),
                                dim=1)
        best_i = torch.gather(torch.cat([best_i, i + lo], 1), 1, at)
    return best_v, best_i


def judge(x: torch.Tensor, q: torch.Tensor, served: list, k: int) -> dict:
    """Served results [(rows [k], scores [k])] of queries ``q`` [Q, D]
    -> {"score_err", "rank_gap"}, the worst over every query."""
    with exact_f32(), torch.no_grad():
        q = q.to(x.device)
        ref, _ = top(x, q, k)
        err = gap = 0.0
        for qi, (rows, sc) in enumerate(served):
            rows = torch.as_tensor(np.asarray(rows, np.int64), device=x.device)
            if (len(rows) != min(k, len(x)) or bool((rows < 0).any())
                    or bool((rows >= len(x)).any()) or len(torch.unique(rows)) != len(rows)):
                return {"score_err": math.inf, "rank_gap": math.inf}
            mine = x[rows].float() @ q[qi].to(x.dtype).float()
            sc = torch.as_tensor(np.asarray(sc, np.float64), device=x.device).float()
            err = max(err, float((sc - mine).abs().max()))
            gap = max(gap, float((ref[qi] - mine).abs().max()))
    return {"score_err": err, "rank_gap": gap}
