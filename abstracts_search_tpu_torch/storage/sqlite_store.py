"""SQLite document/embedding store.

The port's copy of the JAX package's ``storage/sqlite_store.py``: one
SQLite file (``data.sqlite``) mapping OpenAlex work id -> embedding
vector, with upsert semantics, so a crashed partition ingest can be
re-streamed safely (a partition with no stamp is re-run; upserts make
that idempotent). It is stdlib ``sqlite3`` plus numpy, with the same
schema and SQL, so either package opens a store the other wrote.

Embeddings are raw little-endian float32 blobs; the dimensionality and
the sync revision counter live in a ``meta`` table.
"""

from __future__ import annotations

import sqlite3
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

_SCHEMA = """
CREATE TABLE IF NOT EXISTS works (
    id        TEXT PRIMARY KEY,
    embedding BLOB NOT NULL,
    rev       INTEGER NOT NULL DEFAULT 0
) WITHOUT ROWID;
CREATE TABLE IF NOT EXISTS meta (
    key   TEXT PRIMARY KEY,
    value TEXT NOT NULL
);
"""


class EmbeddingStore:
    """id -> float32 embedding store with upsert semantics.

    Every row carries a sync revision ``rev`` (stamped at upsert from
    the store-level ``sync_rev`` counter, bumped once per sync run by
    the driver): the incremental-fill path streams only rows with
    ``rev`` past the last fill's watermark, so a quarterly sync indexes
    O(new/updated works) instead of refilling the whole corpus (the
    reference re-fills all 207M rows each quarter, Makefile:23-25)."""

    def __init__(self, path: str | Path, *, create: bool = False):
        self.path = Path(path)
        if not create and not self.path.exists():
            raise FileNotFoundError(f"store does not exist: {self.path}")
        # check_same_thread=False: fill_stream consumes row iterators
        # from its prefetch thread; access is single-threaded at any
        # moment (handoff, not sharing), which sqlite allows
        self.conn = sqlite3.connect(str(self.path), check_same_thread=False)
        self.conn.executescript(_SCHEMA)
        # migrate pre-rev stores in place (rows keep rev=0)
        cols = {r[1] for r in self.conn.execute("PRAGMA table_info(works)")}
        if "rev" not in cols:
            with self.conn:
                self.conn.execute(
                    "ALTER TABLE works ADD COLUMN rev INTEGER NOT NULL DEFAULT 0")
        # Without this index the incremental-fill delta stream
        # (WHERE rev >= ?) and count_since (rev > ?) walk every row's
        # overflow pages (rev sits after the embedding BLOB) — an
        # O(corpus) ~850 GB table scan at 207M rows, defeating the
        # O(delta) sync. Created after the rev migration on purpose.
        with self.conn:
            self.conn.execute(
                "CREATE INDEX IF NOT EXISTS works_rev ON works (rev)")
        # Bulk-ingest friendly pragmas; durability is provided by the
        # events/ stamp protocol above this layer, not by per-row fsync.
        self.conn.execute("PRAGMA journal_mode=WAL")
        self.conn.execute("PRAGMA synchronous=NORMAL")

    # -- meta ---------------------------------------------------------------

    def set_meta(self, key: str, value: str) -> None:
        with self.conn:
            self.conn.execute(
                "INSERT INTO meta (key, value) VALUES (?, ?) "
                "ON CONFLICT(key) DO UPDATE SET value=excluded.value",
                (key, value),
            )

    def get_meta(self, key: str, default: str | None = None) -> str | None:
        row = self.conn.execute("SELECT value FROM meta WHERE key=?", (key,)).fetchone()
        return row[0] if row else default

    @property
    def dim(self) -> int | None:
        v = self.get_meta("dim")
        return int(v) if v is not None else None

    # -- sync revisions -------------------------------------------------------

    @property
    def sync_rev(self) -> int:
        return int(self.get_meta("sync_rev", "0"))

    def bump_rev(self) -> int:
        """Start a new sync generation; subsequent upserts stamp it."""
        rev = self.sync_rev + 1
        self.set_meta("sync_rev", str(rev))
        return rev

    def count_since(self, watermark: int) -> int:
        return self.conn.execute(
            "SELECT COUNT(*) FROM works WHERE rev > ?", (watermark,)
        ).fetchone()[0]

    # -- rows ---------------------------------------------------------------

    def upsert(self, ids: Sequence[str], embeddings: np.ndarray) -> None:
        """Insert or replace a batch of rows. embeddings: [len(ids), dim] f32."""
        embeddings = np.ascontiguousarray(embeddings, dtype=np.float32)
        if embeddings.ndim != 2 or embeddings.shape[0] != len(ids):
            raise ValueError(f"bad embeddings shape {embeddings.shape} for {len(ids)} ids")
        dim = self.dim
        if dim is None:
            self.set_meta("dim", str(embeddings.shape[1]))
        elif dim != embeddings.shape[1]:
            raise ValueError(f"dim mismatch: store={dim}, batch={embeddings.shape[1]}")
        rev = self.sync_rev
        rows = ((i, memoryview(e.tobytes()), rev) for i, e in zip(ids, embeddings))
        with self.conn:
            self.conn.executemany(
                "INSERT INTO works (id, embedding, rev) VALUES (?, ?, ?) "
                "ON CONFLICT(id) DO UPDATE SET "
                "embedding=excluded.embedding, rev=excluded.rev",
                rows,
            )

    def __len__(self) -> int:
        return self.conn.execute("SELECT COUNT(*) FROM works").fetchone()[0]

    def get(self, id_: str) -> np.ndarray | None:
        row = self.conn.execute("SELECT embedding FROM works WHERE id=?", (id_,)).fetchone()
        if row is None:
            return None
        return np.frombuffer(row[0], dtype=np.float32)

    def iter_batches(self, batch_size: int = 65_536, *,
                     min_rev: int | None = None,
                     ) -> Iterator[tuple[list[str], np.ndarray]]:
        """Iterate (ids, embeddings) batches in id order (deterministic
        dumps). ``min_rev`` restricts to rows upserted at or after that
        sync revision (the incremental-fill delta stream)."""
        dim = self.dim
        if min_rev is None:
            cur = self.conn.execute(
                "SELECT id, embedding FROM works ORDER BY id")
        else:
            cur = self.conn.execute(
                "SELECT id, embedding FROM works WHERE rev >= ? ORDER BY id",
                (min_rev,))
        while True:
            rows = cur.fetchmany(batch_size)
            if not rows:
                return
            ids = [r[0] for r in rows]
            embs = np.frombuffer(b"".join(r[1] for r in rows), dtype=np.float32)
            yield ids, embs.reshape(len(ids), dim)

    def close(self) -> None:
        self.conn.close()

    def __enter__(self) -> "EmbeddingStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def init_store(path: str | Path, *, exist_ok: bool = False) -> EmbeddingStore:
    """`sidecar-search init data.sqlite` equivalent (reference Makefile:71-72)."""
    p = Path(path)
    if p.exists() and not exist_ok:
        raise FileExistsError(f"store already exists: {p}")
    p.parent.mkdir(parents=True, exist_ok=True)
    return EmbeddingStore(p, create=True)
