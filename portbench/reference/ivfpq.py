"""IVF-PQ search written plainly, and the judge of served results.

The deployment's semantics (OPQ rotation, spherical IVF over unit
queries, PQ residual codes; the probe SELECTS lists by products of bf16
operands, every score is f32): a query is normalised, rotated, its
lists chosen by bf16 products with the centroids, and each row of those
lists scored as q_rot . c_list + sum_m q_rot[m] . codebook[m, code_m] in
f32. Codes come from ``yardstick.corpus.SeededCodes`` (the benchmark's
input), never from the program.

The probe's choice is exact only up to rounding: a list whose probe
score lies within ``tau`` of the cut may be in or out. So the judge
takes two reference lists per query, over the lists certainly probed
(``core``) and over every list that may be (``union``), and asks of the
served scores, rank by rank, that core[j] <= served[j] <= union[j], each
served score being the reference's own score of the served row. Two
numbers come out: ``score_err`` (the served score against the
reference's score of the same row) and ``rank_gap`` (how far a served
rank falls outside [core, union]); a row that is not in the corpus, or
served twice, reads infinite.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..yardstick.corpus import decode_codes
from .stella import exact_f32, operands


class Corpus:
    """The reference's view of an IVF-PQ corpus: the trained state (f32
    on the device), the layout, the seeded codes and the row ids (host)."""

    # rows scored at a time (bounds the [rows, M] temporaries)
    BLOCK_ROWS = 1 << 18

    def __init__(self, cent, rot, pqc, layout, codes, rid: np.ndarray, pq_m: int):
        self.cent, self.rot, self.pqc = cent, rot, pqc
        self.layout, self.codes, self.pq_m = layout, codes, pq_m
        self.device = cent.device
        seg = layout.seg
        flat = torch.from_numpy(rid.reshape(-1)).to(self.device).long()
        live = flat >= 0
        self.n_rows = int(live.sum())
        # corpus position -> flat row (segment * seg + row in segment)
        self.row_of = torch.full((self.n_rows,), -1, dtype=torch.int64, device=self.device)
        self.row_of[flat[live]] = torch.nonzero(live).flatten()
        self.seg = seg
        self.seg_start = torch.from_numpy(layout.seg_start).to(self.device)
        self.seg_cnt = torch.from_numpy(layout.seg_cnt).to(self.device)
        self.seg_valid = torch.from_numpy(layout.seg_valid).to(self.device).long()
        self.rid = torch.from_numpy(rid).to(self.device).long()
        self.cent_bf16 = cent.to(torch.bfloat16).float()
        self._slot = None    # segment -> its place in ``_store``
        self._store = None

    def load(self, segs: torch.Tensor) -> None:
        """Make the codes of segments ``segs`` once, for ``score_rows``."""
        segs = torch.unique(segs.long())
        self._slot = torch.full((self.layout.n_segs,), -1, dtype=torch.int64,
                                device=self.device)
        self._slot[segs] = torch.arange(len(segs), device=self.device)
        self._store = None
        self._store = self.codes.segments(segs)

    def prepare(self, q: torch.Tensor, kind: str = "f32"):
        """Unit, rotated queries [Q, D] and their LUTs [Q, M, ksub], the
        products in ``kind``."""
        q = torch.nn.functional.normalize(q.float(), dim=1)
        qr = torch.matmul(*operands(kind, q, self.rot))
        m = self.pq_m
        luts = torch.einsum("qmd,mkd->qmk", *operands(kind, qr.view(len(qr), m, -1), self.pqc))
        return qr, luts

    def score_rows(self, qr, luts, qi: int, flat_rows: torch.Tensor,
                   kind: str = "f32") -> torch.Tensor:
        """f32 scores of query ``qi`` over flat rows [n] (the bias product
        in ``kind``)."""
        segs = flat_rows // self.seg
        within = flat_rows % self.seg
        lists = torch.searchsorted(self.seg_start, segs, right=True) - 1
        at = self._slot[segs]
        if bool((at < 0).any()):
            raise RuntimeError("score_rows over segments that were not loaded")
        out = torch.empty(len(flat_rows), device=self.device)
        m = torch.arange(self.pq_m, device=self.device)
        for lo in range(0, len(flat_rows), self.BLOCK_ROWS):
            hi = lo + self.BLOCK_ROWS
            raw = self._store[at[lo:hi], :, within[lo:hi]]              # [n, MB]
            c = decode_codes(raw, self.pq_m)                             # [n, M]
            out[lo:hi] = (torch.matmul(*operands(kind, qr[qi], self.cent[lists[lo:hi]].T))
                          + luts[qi][m[None, :], c].sum(1))
        return out

    def list_rows(self, lists: torch.Tensor) -> torch.Tensor:
        """Flat rows of the live rows of ``lists``."""
        if len(lists) == 0:
            return torch.zeros(0, dtype=torch.int64, device=self.device)
        cnt = self.seg_cnt[lists]
        segs = torch.repeat_interleave(self.seg_start[lists], cnt)
        segs = segs + torch.arange(len(segs), device=self.device) - torch.repeat_interleave(
            torch.cumsum(cnt, 0) - cnt, cnt)
        rows = segs[:, None] * self.seg + torch.arange(self.seg, device=self.device)[None, :]
        live = torch.arange(self.seg, device=self.device)[None, :] < self.seg_valid[segs][:, None]
        return rows[live]


def _top(scores: torch.Tensor, k: int) -> torch.Tensor:
    v = torch.topk(scores, min(k, len(scores))).values if len(scores) else scores
    return torch.cat([v, torch.full((k - len(v),), -math.inf, device=scores.device)])


def judge(corpus: Corpus, q: torch.Tensor, served: list, nprobe: int, k: int,
          tau: float = 1e-4) -> dict:
    """Served results [(positions [k'], scores [k'])] of queries ``q``
    [Q, D] against the reference -> {"score_err", "rank_gap"}, the worst
    over every query (module docstring)."""
    err, gap = 0.0, 0.0
    with exact_f32(), torch.no_grad():
        qr, luts = corpus.prepare(q.to(corpus.device))
        probe = (qr.to(torch.bfloat16).float() @ corpus.cent_bf16.T)  # [Q, L]
        top = torch.topk(probe, min(nprobe + 1, probe.shape[1]), dim=1).values
        sets, rows = [], []
        for qi, (pos, _) in enumerate(served):
            s_in = top[qi, nprobe - 1]
            s_out = top[qi, nprobe] if top.shape[1] > nprobe else -math.inf
            core = torch.nonzero(probe[qi] > s_out + 2 * tau).flatten()
            union = torch.nonzero(probe[qi] >= s_in - 2 * tau).flatten()
            pos = torch.as_tensor(np.asarray(pos, np.int64), device=corpus.device)
            if (len(pos) != min(k, corpus.n_rows) or bool((pos < 0).any())
                    or bool((pos >= corpus.n_rows).any()) or len(torch.unique(pos)) != len(pos)):
                return {"score_err": math.inf, "rank_gap": math.inf}
            sets.append((core, union, corpus.row_of[pos]))
            rows += [corpus.list_rows(union) // corpus.seg, corpus.row_of[pos] // corpus.seg]
        corpus.load(torch.cat(rows))
        for qi, (core, union, flat) in enumerate(sets):
            sc = served[qi][1]
            r_core = _top(corpus.score_rows(qr, luts, qi, corpus.list_rows(core)), k)
            r_union = _top(corpus.score_rows(qr, luts, qi, corpus.list_rows(union)), k)
            mine = corpus.score_rows(qr, luts, qi, flat)
            sc = torch.as_tensor(np.asarray(sc, np.float64), device=corpus.device).float()
            err = max(err, float((sc - mine).abs().max()))
            gap = max(gap, float(torch.clamp(r_core - mine, min=0).max()),
                      float(torch.clamp(mine - r_union, min=0).max()))
    return {"score_err": err, "rank_gap": gap}


def search(corpus: Corpus, q: torch.Tensor, nprobe: int, k: int, kind: str) -> list:
    """The reference's own top-k with its f32 products in ``kind`` (the
    control: "tf32"): [(positions [k], scores [k])] per query."""
    out = []
    with exact_f32(), torch.no_grad():
        qr, luts = corpus.prepare(q.to(corpus.device), kind)
        probe = (qr.to(torch.bfloat16).float() @ corpus.cent_bf16.T)
        lists = torch.topk(probe, nprobe, dim=1).indices
        corpus.load(torch.cat([corpus.list_rows(ls) // corpus.seg for ls in lists]))
        for qi in range(len(q)):
            rows = corpus.list_rows(lists[qi])
            s = corpus.score_rows(qr, luts, qi, rows, kind)
            v, i = torch.topk(s, min(k, len(s)))
            out.append((corpus.rid.view(-1)[rows[i]].cpu().numpy(), v.cpu().numpy()))
    return out
