"""Lazy position -> OpenAlex-id resolution over the ids.parquet artifact.

``ids.parquet`` maps index positions to OpenAlex work ids. Decoding all
207M id strings into a Python list would cost ~15-25 GB of RSS, so
serving resolves ids lazily instead.

Two backends, picked at open:

- **binary sidecar** (preferred): ``ids.bin`` (concatenated UTF-8 id
  bytes) + ``ids.off`` (uint64 start offsets, n+1 entries) beside the
  parquet. Lookups memmap-slice exactly the id's bytes: a flat cost per
  lookup, no decode, no cache.
- **parquet row groups** (artifacts without a sidecar): positions map to
  their row group through the row-count prefix sums, only touched groups
  are read, and a small LRU keeps the hottest resident. RSS is bounded
  by ``cache_groups * row_group_size`` strings.

A sidecar is trusted only when its offsets count the parquet's rows and
its ``<stem>.sidecar.json`` binds it to the parquet's footer (or, for
artifacts without that file, when 16 probed positions agree). A footer
that cannot be read (a truncated file) makes the sidecar count as stale.

Thread-safe: the LRU is guarded by a lock and parquet reads by an IO
lock (Arrow's reader is not thread-safe); memmap slicing is lock-free.
pyarrow is imported only where parquet is read or written, so the
package imports without it.
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
from collections import OrderedDict
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)


def _footer_fingerprint(path: str | Path) -> str | None:
    """sha256 of the parquet footer (thrift metadata + length + magic),
    or None where the footer length points outside the file.

    The footer embeds every row group's data-page offsets, byte sizes
    and column statistics, so any content change to the file changes
    it: a whole-file identity from a few KB read."""
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        if size < 8:
            return None
        f.seek(-8, 2)
        flen = int.from_bytes(f.read(4), "little")
        if flen + 8 > size:
            return None
        f.seek(-(8 + flen), 2)
        return hashlib.sha256(f.read(flen + 8)).hexdigest()


def sidecar_meta_path(path: str | Path) -> Path:
    path = Path(path)
    return path.with_name(path.stem + ".sidecar.json")


def write_sidecar_meta(path: str | Path) -> Path:
    """Bind the sidecars to their parquet generation. Written last by
    every producer (after the parquet and .bin/.off are at their final
    names), so its presence and a matching fingerprint prove the commit
    completed."""
    path = Path(path)
    fp = _footer_fingerprint(path)
    if fp is None:
        raise ValueError(f"{path}: the parquet footer cannot be read")
    p = sidecar_meta_path(path)
    tmp = p.with_name(p.name + ".tmp")
    tmp.write_text(json.dumps({"parquet_footer_sha256": fp}))
    tmp.replace(p)
    return p


class IdMap:
    """Indexable position -> id string view of ids.parquet.

    Stands in for an eager ``list[str]``: ``len``, ``__getitem__`` (ints)
    and batch ``resolve`` (misses grouped per row group so each group is
    read once).
    """

    def __init__(self, path: str | Path, *, cache_groups: int = 8,
                 prefer_sidecar: bool = True):
        import pyarrow.parquet as pq

        self._path = Path(path)
        self._pf = pq.ParquetFile(self._path)
        md = self._pf.metadata
        counts = [md.row_group(i).num_rows for i in range(md.num_row_groups)]
        self._starts = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(counts, dtype=np.int64)])
        self._n = int(self._starts[-1])
        self._cap = max(1, int(cache_groups))
        self._cache: OrderedDict[int, object] = OrderedDict()
        self._lock = threading.Lock()
        # Arrow's parquet reader is not thread-safe: reads of the shared
        # ParquetFile are serialized; cache hits never wait on them
        self._io_lock = threading.Lock()
        self._blob = self._offs = None
        bin_p = self._path.with_name(self._path.stem + ".bin")
        off_p = self._path.with_name(self._path.stem + ".off")
        if prefer_sidecar and bin_p.exists() and off_p.exists():
            offs = np.memmap(off_p, dtype=np.uint64, mode="r")
            if len(offs) == self._n + 1:
                self._offs = offs
                self._blob = np.memmap(bin_p, dtype=np.uint8, mode="r")
                if self._n and not self._sidecar_fresh():
                    logger.warning("idmap: sidecar %s disagrees with parquet"
                                   " — ignoring it (stale?)", off_p)
                    self._offs = self._blob = None
            else:
                logger.warning("idmap: sidecar %s has %d offsets for %d parquet rows"
                               " — ignoring it (stale?)", off_p, len(offs) - 1, self._n)

    @property
    def uses_sidecar(self) -> bool:
        return self._offs is not None

    def __len__(self) -> int:
        return self._n

    def _group_of(self, pos: int) -> int:
        return int(np.searchsorted(self._starts, pos, "right") - 1)

    def _group(self, g: int):
        """Decoded pyarrow StringArray for row group ``g`` (LRU-cached)."""
        with self._lock:
            col = self._cache.get(g)
            if col is not None:
                self._cache.move_to_end(g)
                return col
        # read outside the cache lock, under the IO lock; a double read of
        # one group after a race on the lookup is harmless
        with self._io_lock:
            col = (self._pf.read_row_group(g, columns=["id"])
                   .column("id").combine_chunks())
        with self._lock:
            self._cache[g] = col
            self._cache.move_to_end(g)
            while len(self._cache) > self._cap:
                self._cache.popitem(last=False)
        return col

    def _sidecar_fresh(self) -> bool:
        """Is the sidecar pair safe to trust against this parquet?

        With a ``<stem>.sidecar.json``: its footer fingerprint must match,
        and one probe (the last position) must agree. Without it (older
        artifacts): 16 positions chosen by a generator seeded from the
        footer fingerprint (so repeat opens agree) must agree. A footer
        that cannot be read fails both."""
        fp = _footer_fingerprint(self._path)
        if fp is None:
            return False
        meta_p = sidecar_meta_path(self._path)
        if meta_p.exists():
            try:
                meta = json.loads(meta_p.read_text())
            except (OSError, ValueError):
                meta = {}
            if meta.get("parquet_footer_sha256") != fp:
                return False
            probes = [self._n - 1]
        else:
            rng = np.random.default_rng(int(fp[:16], 16))
            probes = sorted({0, self._n - 1,
                             *rng.integers(0, self._n, 14).tolist()})
        for pos in probes:
            g = self._group_of(int(pos))
            want = self._group(g)[int(pos) - int(self._starts[g])].as_py()
            if self._sidecar_get(int(pos)) != want:
                return False
        return True

    def _sidecar_get(self, pos: int) -> str:
        a, b = int(self._offs[pos]), int(self._offs[pos + 1])
        return self._blob[a:b].tobytes().decode("utf-8")

    def __getitem__(self, pos: int) -> str:
        pos = int(pos)
        if not 0 <= pos < self._n:
            raise IndexError(f"position {pos} out of range [0, {self._n})")
        if self._offs is not None:
            return self._sidecar_get(pos)
        g = self._group_of(pos)
        return self._group(g)[pos - int(self._starts[g])].as_py()

    def resolve(self, positions) -> list[str]:
        """Batch lookup: the sidecar slices exactly the ids' bytes; the
        parquet backend decodes each touched row group at most once."""
        positions = np.asarray(positions, dtype=np.int64)
        if positions.size == 0:
            return []
        if positions.min() < 0 or positions.max() >= self._n:
            raise IndexError(
                f"positions outside [0, {self._n}): "
                f"[{positions.min()}, {positions.max()}]")
        if self._offs is not None:
            return [self._sidecar_get(int(p)) for p in positions]
        groups = np.searchsorted(self._starts, positions, "right") - 1
        out: list[str | None] = [None] * len(positions)
        for g in np.unique(groups):
            col = self._group(int(g))
            base = int(self._starts[g])
            for i in np.nonzero(groups == g)[0]:
                out[int(i)] = col[int(positions[i]) - base].as_py()
        return out  # type: ignore[return-value]

    @property
    def cached_groups(self) -> int:
        with self._lock:
            return len(self._cache)


def build_sidecar(path: str | Path, *, force: bool = False) -> tuple[Path, Path]:
    """Write ``ids.bin``/``ids.off`` next to an existing ids.parquet.

    Streams one row group at a time and writes the Arrow string column's
    raw offset and data buffers (no per-string decode), in O(row group)
    memory; tmp-then-rename, and the binding meta last.
    """
    import pyarrow as pa
    import pyarrow.parquet as pq

    path = Path(path)
    bin_p = path.with_name(path.stem + ".bin")
    off_p = path.with_name(path.stem + ".off")
    if not force and bin_p.exists() and off_p.exists():
        return bin_p, off_p
    pf = pq.ParquetFile(path)
    bin_tmp = path.with_name(bin_p.name + ".tmp")
    off_tmp = path.with_name(off_p.name + ".tmp")
    pos = 0
    with open(bin_tmp, "wb") as fb, open(off_tmp, "wb") as fo:
        fo.write(np.uint64(0).tobytes())
        for g in range(pf.metadata.num_row_groups):
            arr = pf.read_row_group(g, columns=["id"]).column(0).combine_chunks()
            if len(arr) == 0:
                continue            # zero-row group: nothing to append
            if arr.null_count:
                raise ValueError(f"{path}: null id in row group {g}")
            if pa.types.is_large_string(arr.type):
                odt = np.int64
            elif pa.types.is_string(arr.type):
                odt = np.int32
            else:
                raise TypeError(f"{path}: id column is {arr.type}")
            bufs = arr.buffers()          # [validity, offsets, data]
            offs = np.frombuffer(bufs[1], dtype=odt)[arr.offset:arr.offset + len(arr) + 1]
            data = np.frombuffer(bufs[2], dtype=np.uint8)
            fb.write(data[int(offs[0]):int(offs[-1])].tobytes())
            rel = offs[1:].astype(np.uint64) - np.uint64(int(offs[0]))
            fo.write((np.uint64(pos) + rel).tobytes())
            pos += int(rel[-1])
    bin_tmp.replace(bin_p)
    off_tmp.replace(off_p)
    write_sidecar_meta(path)  # binding meta last: presence => complete
    return bin_p, off_p
