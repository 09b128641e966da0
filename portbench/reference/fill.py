"""The fill's encode and pack, written plainly, and the judge of a
filled index.

The deployment's semantics: a row is normalised, rotated (f32), assigned
to the list whose centroid gives the largest product of bf16 operands
(summed in f32), and its residual against that centroid (f32) coded per
subspace by the nearest codeword; 4-bit codes pack two to a byte, the
low nibble first. The lists are cut into segments of ``seg`` rows, list
after list, each list's rows in stream order, stored transposed
([bytes, rows] per segment), padded rows zero with row id -1.

The judge reads the program's output (the packed lists) and compares:

- ``layout_mismatches``: the packed arrays against the layout the
  reference builds from the program's own assignments and codes (exact;
  this follows the program's encode, which the next two numbers judge);
- ``assign_flips``: how many rows the program put in a list that scores
  below the reference's best (products as above). A row near a tie may
  flip on rounding alone; a count over every row of a job separates
  that from a lower precision, which flips far more (PERF.md);
- ``code_gap``: how far the program's codeword falls from the nearest
  one, in squared distance, on the residual against the program's list.
"""

from __future__ import annotations

import numpy as np
import torch

from .stella import exact_f32, operands


def program_output(data, rid, seg_cnt, n_rows: int, device):
    """The packed lists -> (list of each position [N] int64, its stored
    code bytes [N, MB] u8), on ``device``."""
    data = torch.as_tensor(np.asarray(data)).to(device)        # [S, MB, SEG]
    rid = torch.as_tensor(np.asarray(rid)).to(device).long()    # [S, SEG]
    seg_cnt = torch.as_tensor(np.asarray(seg_cnt, np.int64)).to(device)
    seg_list = torch.repeat_interleave(torch.arange(len(seg_cnt), device=device), seg_cnt)
    live = rid >= 0
    pos = rid[live]
    assign = torch.full((n_rows,), -1, dtype=torch.int64, device=device)
    codes = torch.zeros((n_rows, data.shape[1]), dtype=torch.uint8, device=device)
    assign[pos] = seg_list[:, None].expand_as(rid)[live]
    codes[pos] = data.transpose(1, 2)[live]
    return assign, codes


def layout(assign: torch.Tensor, codes: torch.Tensor, n_lists: int, seg: int) -> dict:
    """The packed arrays that rows 0..N-1 (in stream order) with these
    lists and code bytes make."""
    dev = assign.device
    n, mb = codes.shape
    counts = torch.bincount(assign, minlength=n_lists)
    seg_cnt = (counts + seg - 1) // seg
    seg_start = torch.cumsum(seg_cnt, 0) - seg_cnt
    n_segs = max(int(seg_cnt.sum()), 1)
    order = torch.sort(assign, stable=True).indices
    row_start = torch.cumsum(counts, 0) - counts
    lists = assign[order]
    dest = seg_start[lists] * seg + torch.arange(n, device=dev) - row_start[lists]
    rid = torch.full((n_segs * seg,), -1, dtype=torch.int32, device=dev)
    rid[dest] = order.int()
    rows = torch.zeros((n_segs * seg, mb), dtype=torch.uint8, device=dev)
    rows[dest] = codes[order]
    seg_list = torch.repeat_interleave(torch.arange(n_lists, device=dev), seg_cnt)
    valid = torch.clamp(counts[seg_list] - (torch.arange(len(seg_list), device=dev)
                                            - seg_start[seg_list]) * seg, 0, seg)
    return {"data": rows.view(n_segs, seg, mb).transpose(1, 2), "row_ids": rid.view(n_segs, seg),
            "seg_valid": valid, "seg_start": seg_start, "seg_cnt": seg_cnt}


def layout_mismatches(packed: dict, assign, codes, n_lists: int, seg: int) -> int:
    """Elements of the program's packed arrays that differ from the
    layout of its own assignments and codes (shapes that differ count
    every element)."""
    want = layout(assign, codes, n_lists, seg)
    bad = 0
    for name, w in want.items():
        got = torch.as_tensor(np.asarray(packed[name])).to(w.device)
        if got.shape != w.shape:
            bad += max(got.numel(), w.numel())
        else:
            bad += int((got.long() != w.long()).sum())
    return bad


def encode(x: torch.Tensor, cent, rot, pqc, kind: str = "f32", block: int = 4096):
    """Rows [n, D] f32 -> (lists [n], codes [n, M]) in ``kind`` precision
    for the f32 products (the control: "tf32")."""
    out_a, out_c = [], []
    cb = cent.to(torch.bfloat16).float()
    with exact_f32(), torch.no_grad():
        for lo in range(0, len(x), block):
            xr = torch.matmul(*operands(kind, torch.nn.functional.normalize(x[lo:lo + block],
                                                                            dim=1), rot))
            a = torch.argmax(xr.to(torch.bfloat16).float() @ cb.T, dim=1)
            res = (xr - cent[a]).view(len(xr), pqc.shape[0], -1)
            d = (res.square().sum(-1)[..., None]
                 - 2 * torch.einsum("nmd,mkd->nmk", *operands(kind, res, pqc))
                 + pqc.square().sum(-1)[None])
            out_a.append(a)
            out_c.append(torch.argmin(d, dim=-1))
    return torch.cat(out_a), torch.cat(out_c)


def encode_gaps(x: torch.Tensor, assign, codes, cent, rot, pqc, block: int = 4096) -> dict:
    """The program's lists [n] and codes [n, M] of rows ``x`` [n, D]
    -> {"assign_flips", "code_gap"} (module docstring), in f32."""
    cb = cent.to(torch.bfloat16).float()
    cg = 0.0
    flips = 0
    with exact_f32(), torch.no_grad():
        for lo in range(0, len(x), block):
            xr = torch.nn.functional.normalize(x[lo:lo + block], dim=1) @ rot
            a = assign[lo:lo + block]
            s = xr.to(torch.bfloat16).float() @ cb.T
            gap = s.max(1).values - s.gather(1, a[:, None])[:, 0]
            flips += int((gap > 0).sum())
            res = (xr - cent[a]).view(len(xr), pqc.shape[0], 1, -1)
            d = (res - pqc[None]).square().sum(-1)                    # [n, M, ksub]
            mine = d.gather(2, codes[lo:lo + block].long()[..., None])[..., 0]
            cg = max(cg, float((mine - d.min(-1).values).max()))
    return {"assign_flips": float(flips), "code_gap": cg}
