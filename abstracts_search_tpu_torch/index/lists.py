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
scan is work-proportional. The index fill packs rows into this layout in
RAM (``pack_lists``) or straight into the on-disk artifact
(``pack_lists_external``: a one-pass sorted scatter, or a two-pass
distribution sort past ``bucket_bytes``); ``resegment_lists`` rewrites
an artifact at a smaller segment size. Host numpy throughout: the files
they write equal the JAX package's byte for byte.
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


def pack_lists(
    payloads: np.ndarray,
    positions: np.ndarray,
    assignments: np.ndarray,
    n_lists: int,
    *,
    seg_size: int = 512,
    data_out: np.ndarray | None = None,
    row_ids_out: np.ndarray | None = None,
    transposed: bool = False,
) -> CSRLists:
    """Bucket rows by IVF list into the canonical CSR layout, fully
    vectorized (no per-list Python loop).

    payloads: [N, ...]; positions: [N] global corpus ids;
    assignments: [N] list id per row. ``data_out``/``row_ids_out``
    optionally supply preallocated (e.g. memmap) destination arrays of
    the segment-block shape.

    ``transposed=True`` (1-D payloads only) stores segment blocks as
    [MB, SEG] — see CSRLists: the layout the fused scan reads.
    """
    n = len(payloads)
    assert len(positions) == n and len(assignments) == n
    assignments = np.asarray(assignments, np.int64)

    counts = np.bincount(assignments, minlength=n_lists).astype(np.int64)
    seg_cnt = -(-counts // seg_size)
    seg_start = np.concatenate([[0], np.cumsum(seg_cnt)])[:-1]
    n_segs = max(int(seg_cnt.sum()), 1)  # keep >=1 dead segment: scans clamp to 0

    payload_shape = payloads.shape[1:]
    if transposed and len(payload_shape) != 1:
        raise ValueError("transposed packing requires 1-D row payloads")
    blk = ((payload_shape[0], seg_size) if transposed
           else (seg_size,) + tuple(payload_shape))
    if data_out is None:
        data_out = np.zeros((n_segs,) + blk, payloads.dtype)
    if row_ids_out is None:
        row_ids_out = np.full((n_segs, seg_size), -1, np.int32)

    if n:
        order = np.argsort(assignments, kind="stable")
        row_start = np.concatenate([[0], np.cumsum(counts)])[:-1]
        sorted_lists = assignments[order]
        row_in_list = np.arange(n, dtype=np.int64) - row_start[sorted_lists]
        # segments of a list are contiguous, so the flat destination is
        # simply seg_start[l]*SEG + rank-within-list
        dest = seg_start[sorted_lists] * seg_size + row_in_list
        if transposed:
            # naive per-row column scatter (data_out[seg, :, col] = row)
            # costs ~2 us/row of numpy overhead — the fill-path pack's
            # hot loop at 207M. Instead: stage a run of segments
            # ROW-major (one contiguous fancy row-scatter), transpose
            # the whole block, write. dest is ascending, so segment
            # runs are contiguous slices of the sorted rows.
            mb = payload_shape[0]
            ch_segs = max(1, (64 << 20) // (seg_size * mb))  # ~64 MB stage
            for s0 in range(0, int(seg_cnt.sum()), ch_segs):
                s1 = min(s0 + ch_segs, int(seg_cnt.sum()))
                lo, hi = np.searchsorted(
                    dest, [s0 * seg_size, s1 * seg_size])
                if lo == hi:
                    continue
                stage = np.zeros((s1 - s0, seg_size, mb), payloads.dtype)
                stage.reshape(-1, mb)[dest[lo:hi] - s0 * seg_size] = \
                    payloads[order[lo:hi]]
                data_out[s0:s1] = stage.transpose(0, 2, 1)
        else:
            data_out.reshape((-1,) + tuple(payload_shape))[dest] = payloads[order]
        row_ids_out.reshape(-1)[dest] = np.asarray(positions, np.int64)[order]

    seg_valid = _seg_valid(counts, seg_cnt, seg_start, n_segs, seg_size)
    return CSRLists(
        data=data_out, row_ids=row_ids_out, seg_valid=seg_valid,
        seg_start=seg_start.astype(np.int64), seg_cnt=seg_cnt.astype(np.int32),
        seg_size=seg_size, n_lists=n_lists, n_rows=n, transposed=transposed,
    )


def _seg_valid(counts, seg_cnt, seg_start, n_segs, seg_size) -> np.ndarray:
    seg_valid = np.zeros(n_segs, np.int32)
    total = int(seg_cnt.sum())
    if total:
        seg_list = np.repeat(np.arange(len(counts), dtype=np.int64), seg_cnt)
        seg_idx = np.arange(total, dtype=np.int64) - seg_start[seg_list]
        seg_valid[:total] = np.clip(
            counts[seg_list] - seg_idx * seg_size, 0, seg_size
        ).astype(np.int32)
    return seg_valid


def pack_lists_external(
    payloads: np.ndarray,
    positions: np.ndarray,
    assignments: np.ndarray,
    n_lists: int,
    *,
    seg_size: int,
    out_dir: str | Path,
    slab_rows: int = 1 << 18,
    bucket_bytes: int = 1 << 30,
    transposed: bool = False,
) -> CSRLists:
    """External-memory pack: write the CSR artifact directly to
    ``out_dir`` (the `save_lists` layout) without ever holding the
    payloads in RAM (the 207M-row fill path: the reference fills on a
    16 GB machine).

    ``payloads``/``positions`` may be np.memmap over spill files. Small
    inputs (payload <= ``bucket_bytes``) take a one-pass sorted-scatter.
    Bigger inputs use a two-pass bucketed distribution sort so every
    file access is SEQUENTIAL and RAM stays O(bucket_bytes):

      pass 1: stream the spill once, appending each row to the spill
              file of its list-id *bucket* (contiguous list ranges cut
              so each bucket holds ~bucket_bytes of payload);
      pass 2: per bucket, load its rows (fits RAM by construction),
              pack in RAM, and write that bucket's contiguous artifact
              range (lists are laid out in id order, so a list range
              owns a contiguous segment range).

    The one-pass path's O(N log N) argsort + random spill reads would
    thrash the page cache exactly when the corpus is big; the
    distribution sort replaces them with O(N) sequential I/O. (A single
    list larger than bucket_bytes degrades that bucket to its size.)
    """
    n = len(assignments)
    # assignments may be an int32 memmap over the spill file — never
    # materialize an O(N) int64 copy (1.6 GB at 207M); count in slabs
    # and cast per-slab inside the pack passes
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    counts = np.zeros(n_lists, np.int64)
    for lo in range(0, n, slab_rows):
        counts += np.bincount(assignments[lo : lo + slab_rows],
                              minlength=n_lists)
    seg_cnt = -(-counts // seg_size)
    seg_start = np.concatenate([[0], np.cumsum(seg_cnt)])[:-1]
    n_segs = max(int(seg_cnt.sum()), 1)

    payload_shape = tuple(payloads.shape[1:])
    if transposed and len(payload_shape) != 1:
        raise ValueError("transposed packing requires 1-D row payloads")
    pdtype = payloads.dtype
    rowbytes = int(np.prod(payload_shape, dtype=np.int64)) * pdtype.itemsize
    blk = ((payload_shape[0], seg_size) if transposed
           else (seg_size,) + payload_shape)
    data_mm = np.memmap(out_dir / "codes.bin", dtype=pdtype, mode="w+",
                        shape=(n_segs,) + blk)
    row_mm = np.memmap(out_dir / "row_ids.bin", dtype=np.int32, mode="w+",
                       shape=(n_segs, seg_size))
    # padding rows are conventionally -1 (sequential init pass)
    for lo in range(0, n_segs, max(1, slab_rows // seg_size)):
        row_mm[lo : lo + max(1, slab_rows // seg_size)] = -1

    if n and n * rowbytes <= bucket_bytes:
        # small-input path: the global argsort wants a real array
        assignments = np.asarray(assignments, np.int64)
        _pack_sorted_scatter(payloads, positions, assignments, counts,
                             seg_start, seg_size, data_mm, row_mm,
                             payload_shape, slab_rows, transposed)
    elif n:
        _pack_distribution(payloads, positions, assignments, counts,
                           seg_cnt, seg_start, n_lists, seg_size, data_mm,
                           row_mm, payload_shape, pdtype, rowbytes,
                           slab_rows, bucket_bytes, out_dir, transposed)
    data_mm.flush()
    row_mm.flush()
    del data_mm, row_mm

    seg_valid = _seg_valid(counts, seg_cnt, seg_start, n_segs, seg_size)
    np.save(out_dir / "seg_valid.npy", seg_valid)
    np.save(out_dir / "seg_start.npy", seg_start.astype(np.int64))
    np.save(out_dir / "seg_cnt.npy", seg_cnt.astype(np.int32))
    (out_dir / _META).write_text(json.dumps({
        "format": 3,
        "n_segs": n_segs,
        "seg_size": int(seg_size),
        "n_lists": int(n_lists),
        "n_rows": int(n),
        "payload_shape": list(payload_shape),
        "payload_dtype": str(pdtype),
        "transposed": bool(transposed),
    }))
    return load_lists(out_dir, mmap=True)


def _pack_sorted_scatter(payloads, positions, assignments, counts, seg_start,
                         seg_size, data_mm, row_mm, payload_shape, slab_rows,
                         transposed=False):
    """One-pass path: argsort by list, scatter slabs. Destinations are
    non-decreasing in sorted order (segments of a list are contiguous),
    so artifact writes are sequential; spill reads are random.

    Transposed payloads scatter COLUMNS of [MB, SEG] segment blocks; a
    naive per-row column scatter degrades the sequential-write property
    on the memmap, so the slab is transposed in RAM and
    written one whole [MB, run] block per touched segment — dest values
    inside one segment are consecutive because every segment belongs to
    exactly one list and ranks within a list are consecutive."""
    n = len(assignments)
    order = np.argsort(assignments, kind="stable")
    row_start = np.concatenate([[0], np.cumsum(counts)])[:-1]
    data_flat = None if transposed else data_mm.reshape((-1,) + payload_shape)
    row_flat = row_mm.reshape(-1)
    for lo in range(0, n, slab_rows):
        sel = order[lo : lo + slab_rows]
        sl = assignments[sel]
        rank = (lo + np.arange(len(sel), dtype=np.int64)) - row_start[sl]
        dest = seg_start[sl] * seg_size + rank
        if transposed:
            # stage whole segment runs row-major and block-transpose
            # (same trick as pack_lists; the per-run [MB, run] column
            # writes cost ~2 us/row of numpy overhead). A slab may
            # START or END mid-segment, so the boundary segments are
            # read-modify-written from the memmap.
            mb = data_mm.shape[1]
            s_first, s_last = int(dest[0] // seg_size), int(dest[-1] // seg_size)
            ch = max(2, (64 << 20) // (seg_size * mb))
            rows_sorted = np.asarray(payloads[sel])
            for s0 in range(s_first, s_last + 1, ch):
                s1 = min(s0 + ch, s_last + 1)
                a, b = np.searchsorted(dest, [s0 * seg_size, s1 * seg_size])
                if a == b:
                    continue
                stage = np.zeros((s1 - s0, seg_size, mb), data_mm.dtype)
                # boundary segments may hold rows from other slabs/chunks
                stage[0] = data_mm[s0].transpose(1, 0)
                if s1 - 1 != s0:
                    stage[-1] = data_mm[s1 - 1].transpose(1, 0)
                stage.reshape(-1, mb)[dest[a:b] - s0 * seg_size] = rows_sorted[a:b]
                data_mm[s0:s1] = stage.transpose(0, 2, 1)
        else:
            data_flat[dest] = payloads[sel]
        row_flat[dest] = np.asarray(positions[sel], np.int64)


def _pack_distribution(payloads, positions, assignments, counts, seg_cnt,
                       seg_start, n_lists, seg_size, data_mm, row_mm,
                       payload_shape, pdtype, rowbytes, slab_rows,
                       bucket_bytes, out_dir, transposed=False):
    import shutil
    import tempfile

    n = len(assignments)
    bucket_rows = max(1, bucket_bytes // max(rowbytes, 1))
    # cut list-id space into contiguous ranges of <= bucket_rows rows
    cum_rows = np.cumsum(counts)
    bounds = [0]
    while bounds[-1] < n_lists:
        lo = bounds[-1]
        base = cum_rows[lo - 1] if lo else 0
        hi = int(np.searchsorted(cum_rows, base + bucket_rows, side="right"))
        bounds.append(max(hi, lo + 1))  # a mega-list still advances
    bounds = np.asarray(bounds, np.int64)
    n_buckets = len(bounds) - 1
    bucket_of_list = np.searchsorted(bounds, np.arange(n_lists), side="right") - 1

    tmp = Path(tempfile.mkdtemp(prefix="astpu_pack_", dir=out_dir.parent))
    try:
        files = [
            (open(tmp / f"p{b}", "wb"), open(tmp / f"r{b}", "wb"),
             open(tmp / f"a{b}", "wb"))
            for b in range(n_buckets)
        ]
        # pass 1: sequential spill scan, sequential per-bucket appends
        for lo in range(0, n, slab_rows):
            # per-slab int64 cast (input may be an int32 memmap)
            a = np.asarray(assignments[lo : lo + slab_rows], np.int64)
            pay = np.asarray(payloads[lo : lo + slab_rows])
            pos = np.asarray(positions[lo : lo + slab_rows], np.int64)
            ab = bucket_of_list[a]
            for b in np.unique(ab):
                m = ab == b
                pf, rf, af = files[b]
                np.ascontiguousarray(pay[m]).tofile(pf)
                pos[m].tofile(rf)
                a[m].tofile(af)
        for pf, rf, af in files:
            pf.close(); rf.close(); af.close()

        # pass 2: per bucket, in-RAM pack into the bucket's contiguous
        # artifact range (list ranges own contiguous segment ranges)
        for b in range(n_buckets):
            l0, l1 = int(bounds[b]), int(bounds[b + 1])
            nb = int(counts[l0:l1].sum())
            if nb == 0:
                continue
            pay = np.fromfile(tmp / f"p{b}", dtype=pdtype).reshape(
                (nb,) + payload_shape)
            pos = np.fromfile(tmp / f"r{b}", dtype=np.int64)
            a = np.fromfile(tmp / f"a{b}", dtype=np.int64) - l0
            s0, s1 = int(seg_start[l0]), int(seg_start[l1 - 1] + seg_cnt[l1 - 1])
            local = pack_lists(
                pay, pos, a, l1 - l0, seg_size=seg_size,
                data_out=data_mm[s0:s1], row_ids_out=row_mm[s0:s1],
                transposed=transposed,
            )
            assert local.n_segs == s1 - s0 or (s1 == s0 and local.n_segs == 1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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


def resegment_lists(src: str | Path, dst: str | Path, seg_size: int,
                    *, slab: int = 1 << 13) -> None:
    """Rewrite an on-disk artifact at a smaller segment size WITHOUT
    re-encoding the corpus: each segment splits into ``old_seg/seg_size``
    sub-blocks (a pure slice in both layouts), and all-dead tail blocks
    are dropped, so the rewrite also sheds the per-list tail padding.

    Why: segment size trades per-slot scan overhead against tail
    padding that must sit on the card. At 207M rows x 65,536 lists the
    512-row artifact carries ~9.6% padding (13.52 GiB codes) while 256
    carries ~4.6% (12.9 GiB).
    Streaming + memmap-backed: peak RAM is O(slab), not O(artifact).
    """
    csr = load_lists(src, mmap=True)
    old = csr.seg_size
    if old % seg_size or old == seg_size:
        raise ValueError(f"seg_size {seg_size} must strictly divide {old}")
    f = old // seg_size

    v = csr.seg_valid.astype(np.int64)                      # [S]
    sub = np.clip(v[:, None] - np.arange(f, dtype=np.int64)[None] * seg_size,
                  0, seg_size)                              # [S, f]
    valid2 = sub.reshape(-1)
    keep = valid2 > 0
    src_idx = np.nonzero(keep)[0]
    olds, offs = src_idx // f, (src_idx % f) * seg_size

    total_old = int(csr.seg_cnt.astype(np.int64).sum())
    seg_list = np.repeat(np.arange(csr.n_lists, dtype=np.int64),
                         csr.seg_cnt.astype(np.int64))
    counts = np.bincount(seg_list, weights=v[:total_old],
                         minlength=csr.n_lists).astype(np.int64)
    new_cnt = -(-counts // seg_size)
    new_start = np.concatenate([[0], np.cumsum(new_cnt)])[:-1]
    if int(new_cnt.sum()) != len(src_idx):
        raise AssertionError("resegment bookkeeping mismatch")
    n_new = max(len(src_idx), 1)

    d = Path(dst)
    d.mkdir(parents=True, exist_ok=True)
    blk = ((csr.data.shape[1], seg_size) if csr.transposed
           else (seg_size,) + csr.data.shape[2:])
    data_mm = np.memmap(d / "codes.bin", dtype=csr.data.dtype, mode="w+",
                        shape=(n_new,) + blk)
    rows_mm = np.memmap(d / "row_ids.bin", dtype=np.int32, mode="w+",
                        shape=(n_new, seg_size))
    # only the trailing pad segment (n_new > kept blocks) needs the -1
    # fill — live sub-blocks are copied whole and partial source
    # segments already carry -1 in their dead columns. A full-file fill
    # would double the write I/O of a disk-bound rewrite.
    if n_new > len(src_idx):
        rows_mm[len(src_idx):] = -1
    for lo in range(0, len(src_idx), slab):
        hi = min(lo + slab, len(src_idx))
        o_s, off_s = olds[lo:hi], offs[lo:hi]
        for j in range(f):                       # group by sub-block offset
            m = np.nonzero(off_s == j * seg_size)[0]
            if not len(m):
                continue
            sel = o_s[m]
            cols = slice(j * seg_size, (j + 1) * seg_size)
            if csr.transposed:
                data_mm[lo + m] = csr.data[sel][:, :, cols]
            else:
                data_mm[lo + m] = csr.data[sel][:, cols]
            rows_mm[lo + m] = csr.row_ids[sel][:, cols]
    data_mm.flush()
    rows_mm.flush()

    seg_valid = np.zeros(n_new, np.int32)
    seg_valid[: len(src_idx)] = valid2[src_idx]
    np.save(d / "seg_valid.npy", seg_valid)
    np.save(d / "seg_start.npy", new_start.astype(np.int64))
    np.save(d / "seg_cnt.npy", new_cnt.astype(np.int32))
    (d / _META).write_text(json.dumps({
        "format": 3,
        "n_segs": int(n_new),
        "seg_size": int(seg_size),
        "n_lists": int(csr.n_lists),
        "n_rows": int(csr.n_rows),
        "payload_shape": (list(csr.data.shape[1:2]) if csr.transposed
                          else list(csr.data.shape[2:])),
        "payload_dtype": str(csr.data.dtype),
        "transposed": bool(csr.transposed),
    }))


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
