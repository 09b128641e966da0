"""Parquet shard writer/reader: the on-disk embedding feed.

The port's copy of the JAX package's ``storage/shards.py`` (the
reference's ``sidecar-search dump``). The layout is the interchange
format between the stages: the published ``abstracts-embeddings``
dataset, the index train/fill stages and the recover path all read it.

Layout: ``<dir>/data_{i:05d}.parquet`` with schema
``id: string, embedding: fixed_size_list<float32>[dim]``, ``shard_size``
rows per file, ``row_group_size`` rows per row group (the streaming
granule: 65,536 rows x 1024 dims x 4 B = 256 MiB). Files are the same
in both packages.

pyarrow is imported only inside the functions that read or write
parquet, so the package imports without it.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from ..config import DEFAULT_ROW_GROUP_SIZE, DEFAULT_SHARD_SIZE

_SHARD_RE = re.compile(r"data_(\d+)\.parquet$")
DUMP_META = ".astpu_dump_meta.json"


def _schema(dim: int):
    import pyarrow as pa

    return pa.schema([pa.field("id", pa.string()),
                      pa.field("embedding", pa.list_(pa.float32(), dim))])


def _embedding_array(embs: np.ndarray):
    import pyarrow as pa

    n, dim = embs.shape
    flat = pa.array(np.ascontiguousarray(embs, dtype=np.float32).reshape(-1))
    return pa.FixedSizeListArray.from_arrays(flat, dim)


class ShardWriter:
    """Streaming writer producing the shard layout."""

    def __init__(self, out_dir: str | Path, dim: int, *,
                 shard_size: int = DEFAULT_SHARD_SIZE,
                 row_group_size: int = DEFAULT_ROW_GROUP_SIZE):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.dim = dim
        self.shard_size = shard_size
        self.row_group_size = row_group_size
        self._writer = None
        self._shard_idx = 0
        self._rows_in_shard = 0
        self._buf_ids: list[list[str]] = []
        self._buf_embs: list[np.ndarray] = []
        self._buf_rows = 0

    def _open_shard(self) -> None:
        import pyarrow.parquet as pq

        path = self.out_dir / f"data_{self._shard_idx:05d}.parquet"
        self._writer = pq.ParquetWriter(path, _schema(self.dim))
        self._rows_in_shard = 0

    def _flush_row_group(self) -> None:
        import pyarrow as pa

        if self._buf_rows == 0:
            return
        if self._writer is None:
            self._open_shard()
        ids = pa.array([i for chunk in self._buf_ids for i in chunk])
        embs = _embedding_array(np.concatenate(self._buf_embs, axis=0))
        table = pa.Table.from_arrays([ids, embs], schema=_schema(self.dim))
        self._writer.write_table(table, row_group_size=self.row_group_size)
        self._rows_in_shard += self._buf_rows
        self._buf_ids, self._buf_embs, self._buf_rows = [], [], 0
        if self._rows_in_shard >= self.shard_size:
            self._writer.close()
            self._writer = None
            self._shard_idx += 1
            self._rows_in_shard = 0

    def write(self, ids: Sequence[str], embeddings: np.ndarray) -> None:
        """Append rows; splits across row groups and shards as needed."""
        embeddings = np.asarray(embeddings, dtype=np.float32)
        pos, n = 0, len(ids)
        while pos < n:
            room_shard = self.shard_size - self._rows_in_shard - self._buf_rows
            room_group = self.row_group_size - self._buf_rows
            take = min(n - pos, room_shard, room_group)
            self._buf_ids.append(list(ids[pos:pos + take]))
            self._buf_embs.append(embeddings[pos:pos + take])
            self._buf_rows += take
            pos += take
            if (self._buf_rows >= self.row_group_size
                    or self._rows_in_shard + self._buf_rows >= self.shard_size):
                self._flush_row_group()

    def close(self) -> None:
        self._flush_row_group()
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    def __enter__(self) -> "ShardWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ShardReader:
    """Reader over a shard directory; iterates row groups (the stream
    granule) as numpy arrays."""

    def __init__(self, data_dir: str | Path):
        import pyarrow.parquet as pq

        self.data_dir = Path(data_dir)
        self.paths = sorted(
            (p for p in self.data_dir.glob("data_*.parquet") if _SHARD_RE.search(p.name)),
            key=lambda p: int(_SHARD_RE.search(p.name).group(1)))
        if not self.paths:
            raise FileNotFoundError(f"no shards found under {self.data_dir}")
        self._files = [pq.ParquetFile(p) for p in self.paths]
        self.dim = self._files[0].schema_arrow.field("embedding").type.list_size

    def __len__(self) -> int:
        return sum(f.metadata.num_rows for f in self._files)

    @property
    def num_shards(self) -> int:
        return len(self.paths)

    def row_group_rows(self) -> list[int]:
        """Each row group's rows, in reader order (from the metadata)."""
        return [f.metadata.row_group(rg).num_rows
                for f in self._files for rg in range(f.metadata.num_row_groups)]

    def iter_row_groups(self, *, with_ids: bool = True, start_row: int = 0, groups=None
                        ) -> Iterator[tuple[list[str] | None, np.ndarray]]:
        """Yield (ids, embeddings [n, dim] f32) one row group at a time;
        ``groups``: only the row groups of these indices (in reader
        order), the others never read."""
        want = None if groups is None else set(groups)
        row = g = 0
        for f in self._files:
            for rg in range(f.metadata.num_row_groups):
                nrows = f.metadata.row_group(rg).num_rows
                skip = row + nrows <= start_row or (want is not None and g not in want)
                row += nrows
                g += 1
                if skip:
                    continue
                cols = ["id", "embedding"] if with_ids else ["embedding"]
                t = f.read_row_group(rg, columns=cols)
                embs = np.asarray(t.column("embedding").combine_chunks().flatten()
                                  ).reshape(-1, self.dim)
                ids = t.column("id").to_pylist() if with_ids else None
                yield ids, embs

    def iter_ids(self) -> Iterator[list[str]]:
        """Each row group's ids, from the id column alone, through file
        handles of its own (so it may run beside a reader of the
        embeddings)."""
        import pyarrow.parquet as pq

        for p in self.paths:
            f = pq.ParquetFile(p)
            for rg in range(f.metadata.num_row_groups):
                yield f.read_row_group(rg, columns=["id"]).column("id").to_pylist()

    def read_all(self, *, with_ids: bool = True) -> tuple[list[str] | None, np.ndarray]:
        ids_all: list[str] = []
        embs_all: list[np.ndarray] = []
        for ids, embs in self.iter_row_groups(with_ids=with_ids):
            if with_ids:
                ids_all.extend(ids)
            embs_all.append(embs)
        return (ids_all if with_ids else None), np.concatenate(embs_all, axis=0)

    def sample(self, n: int, *, seed: int = 0, out: np.ndarray | None = None) -> np.ndarray:
        """About ``n`` rows sampled uniformly, row group by row group (a
        training subset). ``out``: an optional preallocated [n, dim]
        destination (an np.memmap), so a 10M x 1024 sample never
        concatenates in host RAM."""
        total = len(self)
        if out is None and n >= total:
            return self.read_all(with_ids=False)[1]
        n = min(n, total)
        rate = n / total
        rng = np.random.default_rng(seed)
        parts = [] if out is None else None
        got = 0
        for _, embs in self.iter_row_groups(with_ids=False):
            k = min(int(round(len(embs) * rate)) + 1, len(embs), n - got)
            if k <= 0:
                break
            rows = embs[np.sort(rng.choice(len(embs), size=k, replace=False))]
            if out is None:
                parts.append(rows)
            else:
                out[got:got + k] = rows
            got += k
        if out is not None:
            if got < n:
                raise RuntimeError(f"sampled {got} rows, expected {n}")
            return out
        return np.concatenate(parts, axis=0)[:n]


def dump_store_to_shards(store, out_dir: str | Path, *,
                         shard_size: int = DEFAULT_SHARD_SIZE,
                         row_group_size: int = DEFAULT_ROW_GROUP_SIZE) -> int:
    """sqlite -> parquet export. Records the store revision it captured
    in ``.astpu_dump_meta.json``: a full fill of these shards covers the
    rows with rev <= that revision (the incremental-fill watermark)."""
    dim = store.dim
    if dim is None:
        raise ValueError("store is empty; nothing to dump")
    store_rev = getattr(store, "sync_rev", None)
    n = 0
    with ShardWriter(out_dir, dim, shard_size=shard_size,
                     row_group_size=row_group_size) as w:
        for ids, embs in store.iter_batches(batch_size=row_group_size):
            w.write(ids, embs)
            n += len(ids)
    if store_rev is not None:
        (Path(out_dir) / DUMP_META).write_text(json.dumps({"store_rev": int(store_rev)}))
    return n


def load_shards_to_store(data_dir: str | Path, store) -> int:
    """parquet -> sqlite recovery."""
    n = 0
    for ids, embs in ShardReader(data_dir).iter_row_groups(with_ids=True):
        store.upsert(ids, embs)
        n += len(ids)
    return n
