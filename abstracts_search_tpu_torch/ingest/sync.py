"""Incremental ingest: download -> filter -> embed -> store, with stamps.

The port's copy of the JAX package's ``ingest/sync.py``, the reference's
partition-stamp protocol: one stamp file per OpenAlex partition under
``events/``; a partition is streamed (download | gunzip | native filter
| embed | upsert) and its stamp touched only after the whole partition
landed. A crash leaves no stamp, and a re-run re-streams just that
partition, which the store's upserts make safe.

The embedder is injected (``texts -> np.ndarray [n, dim]``): production
passes the stella encoder (``models/registry.py``), tests a hash
embedder. Decompression is streamed (zlib), so a 4 GiB part file never
materializes; a bounded chunk queue between the download and the
filter plays the reference's ``mbuffer -m 4G``.
"""

from __future__ import annotations

import logging
import urllib.request
import zlib
from pathlib import Path
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np

from .manifest import group_by_partition
from .oa_filter import filter_stream_native, filter_works_lines

logger = logging.getLogger(__name__)

Embedder = Callable[[Sequence[str]], np.ndarray]


def _stream_url(url: str, chunk_size: int = 1 << 20) -> Iterator[bytes]:
    with urllib.request.urlopen(url) as r:
        while True:
            chunk = r.read(chunk_size)
            if not chunk:
                return
            yield chunk


def _gunzip_stream(chunks: Iterable[bytes]) -> Iterator[bytes]:
    """Streaming gzip decompression (multi-member, like `gunzip`)."""
    d = zlib.decompressobj(16 + zlib.MAX_WBITS)
    for chunk in chunks:
        out = d.decompress(chunk)
        if out:
            yield out
        # gzip files may concatenate members; restart on leftover data
        while d.eof and d.unused_data:
            rest = d.unused_data
            d = zlib.decompressobj(16 + zlib.MAX_WBITS)
            out = d.decompress(rest)
            if out:
                yield out
    tail = d.flush()
    if tail:
        yield tail


class SyncState:
    """events/ stamp directory — the ingest high-water mark."""

    def __init__(self, events_dir: str | Path):
        self.events_dir = Path(events_dir)
        self.events_dir.mkdir(parents=True, exist_ok=True)

    def done(self, partition: str) -> bool:
        return (self.events_dir / partition).exists()

    def mark_done(self, partition: str) -> None:
        (self.events_dir / partition).touch()

    def pending(self, partitions: Iterable[str]) -> list[str]:
        return [p for p in partitions if not self.done(p)]

    def completed(self) -> list[str]:
        return sorted(p.name for p in self.events_dir.iterdir() if p.is_file())


def ingest_partition(
    urls: Sequence[str],
    embedder: Embedder,
    store,
    *,
    batch_size: int = 32,
    use_native_filter: bool = True,
    compressed: bool = True,
    buffer_bytes: int = 256 << 20,
    stats: dict | None = None,
) -> int:
    """Stream one partition's part files end to end. Returns rows upserted
    (embedded, with ``store`` None: a tp rank that runs its shard's encoder
    beside the rank that writes).

    ``stats``, when given, receives the overlap accounting this function
    logs (``rows``, ``embed_s``, ``stall_s``) — benchmarks assert the
    mbuffer-pipeline property (stall ~ 0) from it instead of scraping
    log records.

    Mirrors the reference per-partition recipe (Makefile:58-65): all part
    files of the partition are one concatenated stream through the filter
    and the embedder. Download runs on a producer thread feeding a
    bounded byte-chunk queue of ~``buffer_bytes`` (the `mbuffer -m 4G`
    role, Makefile:62), and filtered batches are prefetched ahead of the
    embedder — so network, the native filter subprocess, and the device
    forward all overlap instead of taking turns. ``stall_s`` is the time
    the embedder waited on its input; ``embed_s`` the embedder's own.
    """
    import time

    from ..utils import prefetch_iterator

    def raw_bytes() -> Iterator[bytes]:
        for url in urls:
            chunks = _stream_url(url)
            yield from (_gunzip_stream(chunks) if compressed else chunks)

    stream = prefetch_iterator(raw_bytes(), depth=max(1, buffer_bytes >> 20))

    n = 0
    if use_native_filter:
        batches = filter_stream_native(stream, batch_size=batch_size)
    else:
        def lines() -> Iterator[str]:
            buf = b""
            for chunk in stream:
                buf += chunk
                while True:
                    nl = buf.find(b"\n")
                    if nl < 0:
                        break
                    yield buf[:nl].decode("utf-8", errors="replace")
                    buf = buf[nl + 1:]
            if buf:
                yield buf.decode("utf-8", errors="replace")

        def batched() -> Iterator[list[dict]]:
            batch: list[dict] = []
            for rec in filter_works_lines(lines()):
                batch.append(rec)
                if len(batch) >= batch_size:
                    yield batch
                    batch = []
            if batch:
                yield batch

        batches = batched()

    # a few batches ready ahead of the embedder: parse/filter overlaps
    # the device forward
    batches = prefetch_iterator(batches, depth=4)

    t_embed = 0.0
    t_stall = 0.0
    it = iter(batches)
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        t_stall += time.perf_counter() - t0  # waiting on download/filter
        if batch is None:
            break
        ids = [r["id"] for r in batch]
        docs = [r["document"] for r in batch]
        t0 = time.perf_counter()
        embs = embedder(docs)
        t_embed += time.perf_counter() - t0
        if store is not None:
            store.upsert(ids, embs)
        n += len(ids)
    logger.info(
        "partition ingest: %d rows, embed %.1fs, input-stall %.1fs "
        "(download/filter hidden behind embed when stall ~ 0)",
        n, t_embed, t_stall,
    )
    if stats is not None:
        stats.update(rows=n, embed_s=t_embed, stall_s=t_stall)
    return n


def sync(
    manifest_urls: Sequence[str],
    state: SyncState,
    embedder: Embedder,
    store,
    *,
    batch_size: int = 32,
    use_native_filter: bool = True,
    compressed: bool = True,
    buffer_bytes: int = 256 << 20,
    owner: tuple[int, int] | None = None,
    stats: dict | None = None,
) -> dict[str, int]:
    """Ingest every partition that has no stamp yet (quarterly sync semantics,
    reference README.md:63-65: rerunning is incremental).

    ``owner=(process_id, process_count)``: multi-host builds split the
    manifest by PARTITION ownership — process p ingests partitions where
    ``i % count == p`` into its own store/stamp set (stores merge at
    dump; on a 2-D mesh ``p`` is the shard and its tp ranks all run this
    with the same arguments, making the same embedder calls in the same
    order). None = own everything (one process). ``store`` None: embed
    only, neither upsert nor stamp (a tp rank other than 0; its tp rank 0
    writes, and stamps a partition only after every batch of it went
    through the shard's encoder, so this rank has taken its pending set
    by then). ``stats``, when given, receives each ingested partition's
    ``ingest_partition`` stats under its name.
    """
    groups = group_by_partition(manifest_urls)
    todo = state.pending(groups.keys())
    if owner is not None:
        pid, count = owner
        all_parts = sorted(groups.keys())
        mine = {p for i, p in enumerate(all_parts) if i % count == pid}
        todo = [p for p in todo if p in mine]
    results: dict[str, int] = {}
    for part in sorted(todo):
        logger.info("ingesting partition %s (%d part files)", part, len(groups[part]))
        results[part] = ingest_partition(
            groups[part], embedder, store,
            batch_size=batch_size,
            use_native_filter=use_native_filter,
            compressed=compressed,
            buffer_bytes=buffer_bytes,
            stats=None if stats is None else stats.setdefault(part, {}),
        )
        if store is not None:
            state.mark_done(part)
    return results
