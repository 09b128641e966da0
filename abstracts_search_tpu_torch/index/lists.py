"""Packed inverted-list storage — CSR segments, on-disk format 3.

The port's copy of the list layout the JAX package writes, so one
artifact directory serves both packages bit for bit. Variable-length IVF
lists are split into fixed-size *segments* (SEG rows, zero-padded tail),
stored list-contiguous:

- ``data``      [n_segs, SEG, *payload] or, transposed, [n_segs, MB, SEG]
                 (PQ codes: one payload byte per row of the block, rows
                 along the minor axis); may be an ``np.memmap``
- ``row_ids``   [n_segs, SEG] int32     — global corpus positions (-1 pad)
- ``seg_valid`` [n_segs] int32          — live rows per segment
- ``seg_start`` [n_lists] int64, ``seg_cnt`` [n_lists] int32 — CSR:
                 list ``l`` owns segments [seg_start[l],
                 seg_start[l]+seg_cnt[l]), contiguous.

A probe expands to exactly ``seg_cnt[probed_lists]`` scan slots, so the
scan is work-proportional. Packing and resegmenting come with the index
build.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np


def bucket_size(v: int, lo: int = 8) -> int:
    """Smallest slot-bucket size >= ``v`` on a ~1.25x geometric ladder
    aligned to multiples of 8 (the JAX package pads its slot lists to
    these; the port's eager scan uses exact lengths, and keeps the
    ladder for callers that want stable shapes, e.g. CUDA graphs).
    """
    b = lo
    v = max(int(v), lo)
    while b < v:
        b = ((max(int(b * 1.25), b + 1) + 7) // 8) * 8
    return b


def ragged_ranges(starts: np.ndarray, counts: np.ndarray):
    """Vectorized concatenation of the ranges [starts[i], starts[i]+counts[i]).

    Returns (values [sum(counts)], source [sum(counts)]) where
    ``source[j]`` is the range index i that produced ``values[j]``.
    """
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    ends = np.cumsum(counts)
    offs = ends - counts
    source = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    within = np.arange(total, dtype=np.int64) - offs[source]
    return np.asarray(starts, np.int64)[source] + within, source


@dataclasses.dataclass
class CSRLists:
    """Canonical packed lists (see module docstring).

    ``transposed=True`` stores each segment block as [MB, SEG] (one row
    of the block per payload byte, one column per corpus row) instead of
    [SEG, MB]. Every IVF-PQ fill writes this layout; the port's ADC
    kernel reads it with neighbouring threads on neighbouring rows.
    """

    data: np.ndarray       # [n_segs, SEG, *payload] or [n_segs, MB, SEG]
    row_ids: np.ndarray    # [n_segs, SEG] int32; may be np.memmap
    seg_valid: np.ndarray  # [n_segs] int32
    seg_start: np.ndarray  # [n_lists] int64
    seg_cnt: np.ndarray    # [n_lists] int32
    seg_size: int
    n_lists: int
    n_rows: int
    transposed: bool = False

    @property
    def n_segs(self) -> int:
        return self.data.shape[0]


# -- on-disk format -------------------------------------------------------------------

_META = "lists_meta.json"


def save_lists(csr: CSRLists, directory: str | Path) -> None:
    """Persist as raw memmap-able binaries + small npy/json sidecars.

    Raw (not compressed) so `load_lists(mmap=True)` serves straight from
    the page cache and a device install can stream it in chunks.
    """
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    _tofile_chunked(csr.data, d / "codes.bin")
    _tofile_chunked(np.ascontiguousarray(csr.row_ids, np.int32), d / "row_ids.bin")
    np.save(d / "seg_valid.npy", csr.seg_valid)
    np.save(d / "seg_start.npy", csr.seg_start)
    np.save(d / "seg_cnt.npy", csr.seg_cnt)
    (d / _META).write_text(json.dumps({
        "format": 3,
        "n_segs": int(csr.n_segs),
        "seg_size": int(csr.seg_size),
        "n_lists": int(csr.n_lists),
        "n_rows": int(csr.n_rows),
        "payload_shape": (list(csr.data.shape[1:2]) if csr.transposed
                          else list(csr.data.shape[2:])),
        "payload_dtype": str(csr.data.dtype),
        "transposed": bool(csr.transposed),
    }))


def _tofile_chunked(arr: np.ndarray, path: Path, chunk_rows: int = 1 << 14) -> None:
    """Write without materializing a full contiguous copy (arr may be a
    memmap several times larger than RAM)."""
    with open(path, "wb") as f:
        for lo in range(0, arr.shape[0], chunk_rows):
            np.ascontiguousarray(arr[lo : lo + chunk_rows]).tofile(f)



def load_lists(directory: str | Path, *, mmap: bool = True) -> CSRLists:
    d = Path(directory)
    meta = json.loads((d / _META).read_text())
    n_segs, seg = meta["n_segs"], meta["seg_size"]
    pshape = tuple(meta["payload_shape"])
    pdtype = np.dtype(meta["payload_dtype"])
    transposed = bool(meta.get("transposed", False))  # format<=2: rows
    blk = (pshape[0], seg) if transposed else (seg,) + pshape
    mode = "r" if mmap else None
    if mmap:
        data = np.memmap(d / "codes.bin", dtype=pdtype, mode=mode,
                         shape=(n_segs,) + blk)
        row_ids = np.memmap(d / "row_ids.bin", dtype=np.int32, mode=mode,
                            shape=(n_segs, seg))
    else:
        data = np.fromfile(d / "codes.bin", dtype=pdtype).reshape(
            (n_segs,) + blk)
        row_ids = np.fromfile(d / "row_ids.bin", dtype=np.int32).reshape(n_segs, seg)
    return CSRLists(
        data=data, row_ids=row_ids,
        seg_valid=np.load(d / "seg_valid.npy"),
        seg_start=np.load(d / "seg_start.npy"),
        seg_cnt=np.load(d / "seg_cnt.npy"),
        seg_size=seg, n_lists=meta["n_lists"], n_rows=meta["n_rows"],
        transposed=transposed,
    )
