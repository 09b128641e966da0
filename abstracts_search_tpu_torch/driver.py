"""Build orchestrator: the Makefile-equivalent driver.

The port of the JAX package's ``driver.py``, the reference's target DAG
and rebuild semantics:

- ``build``   : fetch the manifest (replaced only when it changed),
                ingest every partition without a stamp (download |
                gunzip | native filter | embed | upsert), touch stamps.
- ``dump``    : when the stamp set changed since the last export,
                re-export the parquet shards and copy ``events/`` next
                to them.
- ``train``   : ONLY when the train artifacts are absent (order-only: new
                data does not retrain; ``clean`` or deleting ``empty/``
                forces it).
- ``tune``    : only when ``params.json`` is absent.
- ``fill``    : when the data or the train artifacts are newer than the
                filled index (a fill stamp of the data fingerprint); or,
                incrementally, only the rows upserted since the last
                fill, into a delta sub-index.
- ``all``     : fill + tune, pulling the chain as needed.
- ``recover`` : parquet -> sqlite, and ``events/`` restored.
- ``clean``   : remove the artifacts.

It runs on one device (the card unless the caller asks for the CPU),
or as one rank of a ``torch.distributed`` mesh (``mesh=``: every rank
runs the same targets, as every JAX process does). Over a mesh:

- ``build``: rank 0 writes the manifest; each rank ingests the
  partitions ``i % W == rank`` (every rank embeds on its own card) into
  its own store ``data.sqlite.p<rank>``. On a 2-D mesh (``tp > 1``)
  the partitions are owned per shard, ``i % n_shard == shard``: the tp
  ranks of a shard run one encoder over their tp group
  (``get_embedder(mesh=mesh.tp_view())``), making the same embedder calls
  in the same order, and tp rank 0 alone writes ``data.sqlite.p<shard>``
  and the partition stamps;
- ``dump``: rank 0 folds the per-rank stores into the main store and
  dumps; the others wait;
- ``train``, ``fill``, ``tune``: every rank runs them over the mesh
  (``index/``); rank 0 alone writes the artifacts, ``ids.parquet``,
  the stamps and the reports, which hold every rank's stages under
  ``ranks``; the trained arrays are checked equal on every rank; the
  fill deals the reader's row groups round-robin before any is read,
  and rank 0 reads the id column of every row group for ``ids.parquet``;
- an incremental fill runs a full fill (the delta streams from one
  store);
- each target ends at a barrier, so every rank sees its files;
- on a 2-D mesh the index stages (train, fill, tune and the tune
  oracle) run over the ``shard`` axis alone, on the ranks of tp index 0
  (a ``Driver`` over ``mesh.shard_view()``: the index is replicated over
  ``tp``, so one rank builds each shard, as every write has one writer);
  the other tp ranks wait at the target's barrier and return rank 0's
  result.

Two deliberate differences from the JAX copy: ``_IdsWriter.commit``
leaves a tombstone meta before its first rename, so a half-committed
sidecar is refused, not probed; ``target_compact`` checks the filled
index's ``meta.json``, the artifact being compacted, not ``empty/``'s.
And the data fingerprint of a virtual dir names the generator that made
its rows (``storage/virtual.py::generator_tag``), so a tune oracle or
fill stamp written by the JAX package, or on another device type, never
matches. A full fill and a tune also write ``fill_report.json`` and
``tune_report.json`` beside the index: each stage's seconds and kernel
launches (``StageTimer`` over ``ops.launch_counts``).

pyarrow is imported only where ``ids.parquet`` or shards are read or
written.
"""

from __future__ import annotations

import json
import logging
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from .config import Config
from .index import tune
from .index.ivfpq import IVFPQIndex, _json_safe
from .ingest.manifest import default_fetcher, parse_manifest, update_manifest_file
from .ingest.sync import SyncState, sync
from .models.registry import get_embedder
from .ops import launch_counts
from .parallel.mesh import Mesh, deal, gather_objects, process_barrier, rank_mesh
from .storage.shards import DUMP_META, dump_store_to_shards, load_shards_to_store
from .storage.sqlite_store import EmbeddingStore, init_store
from .storage.virtual import SPEC_NAME, generator_tag, open_data_source
from .utils.trace import StageTimer

logger = logging.getLogger(__name__)


def compaction_due(base_rows: int, delta_rows: int, n_deltas: int, *,
                   max_frac: float, max_deltas: int) -> bool:
    """Fold delta sub-indexes back into the base once they hold more than
    ``max_frac`` of the base rows or number more than ``max_deltas``
    (each delta adds a search fan-out and a RAM-resident id set)."""
    if n_deltas == 0:
        return False
    if n_deltas > max_deltas:
        return True
    return delta_rows > max_frac * max(base_rows, 1)


class Driver:
    """The pipeline's targets over one artifact tree.

    ``embedder``: a registry name (``get_embedder``, built at first use
    on the driver's device) or an embedder object (``texts -> [n, dim]
    f32``). ``device``: where indexes and virtual corpora live; None is
    the CUDA card. ``mesh``: this process's rank of the mesh every rank
    runs the targets over (module docstring); its device then."""

    # tune defaults shared by target_tune and the oracle precompute
    TUNE_QUERIES = 256
    TUNE_K = 10
    # samples above this byte size stream to a disk memmap instead of RAM
    SAMPLE_INRAM_BYTES = 1 << 30

    def __init__(self, cfg: Config, *, root: str | Path = ".", embedder="auto",
                 fetcher=default_fetcher, device=None, mesh: Mesh | None = None):
        self.cfg = cfg
        self.root = Path(root)
        self.fetcher = fetcher
        self.mesh = rank_mesh(mesh, device)
        self.device = self.mesh.device
        self.rank0 = self.mesh.rank == 0
        self._embedder_name = embedder if isinstance(embedder, str) else None
        self._embedder = None if isinstance(embedder, str) else embedder
        self._filled_index = None
        # per-partition ingest stats of the last target_build
        self.build_stats: dict = {}

        self.manifest_path = self.root / "manifest.txt"
        self.events_dir = self.root / cfg.events_dir
        self.store_path = self.root / cfg.store_path
        self.data_dir = self.root / cfg.data_dir
        self.published_events = self.data_dir.parent / "events"
        self.index_dir = self.root / cfg.index_dir
        self.empty_dir = self.index_dir / "empty"        # trained, unfilled
        self.filled_dir = self.index_dir / "index"       # filled lists
        self.untuned_path = self.index_dir / "untuned.json"
        self.params_path = self.index_dir / "params.json"
        self.ids_path = self.index_dir / "ids.parquet"
        self.fill_stamp = self.index_dir / "fill.stamp.json"
        # stage seconds and kernel launches of the last full fill and tune
        self.fill_report_path = self.index_dir / "fill_report.json"
        self.tune_report_path = self.index_dir / "tune_report.json"

    # -- helpers -------------------------------------------------------------

    @property
    def embedder(self):
        """The ingest's embedder: at tp 1 a whole one on this rank's device
        (every rank embeds its own partitions), at tp > 1 this rank's part
        of its shard's encoder (None on a tp rank other than 0 for the hash
        embedder, which its tp rank 0 runs alone)."""
        if self._embedder is None:
            self._embedder = get_embedder(
                self._embedder_name, self.cfg, device=self.device,
                mesh=self.mesh.tp_view() if self.mesh.tp > 1 else None)
        return self._embedder

    def _barrier(self) -> None:
        process_barrier(self.mesh)

    def _on_shard_axis(self, target: str, **kw):
        """An index stage on a 2-D mesh (module docstring): ``target`` run
        by a Driver over the shard axis on the ranks of tp index 0, then a
        barrier of every rank -> rank 0's result on every rank."""
        out = None
        if self.mesh.tp_rank == 0:
            sub = Driver(self.cfg, root=self.root, fetcher=self.fetcher,
                         embedder=self._embedder or self._embedder_name,
                         mesh=self.mesh.shard_view())
            out = getattr(sub, target)(**kw)
        self._barrier()
        return gather_objects(self.mesh, out)[0]

    def _rank_report(self, report: dict, path: Path | None = None, **mine) -> dict:
        """``report`` with every rank's ``mine`` under ``ranks`` over a
        mesh (gathered: a collective), written by rank 0 to ``path``."""
        if self.mesh.collective:
            report = {**report, "ranks": gather_objects(self.mesh,
                                                        {"rank": self.mesh.rank, **mine})}
        if path is not None and self.rank0:
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(_json_safe(report), indent=2))
        return report

    def _store(self, create=False) -> EmbeddingStore:
        if create and not self.store_path.exists():
            return init_store(self.store_path)
        return EmbeddingStore(self.store_path)

    def _reader(self):
        """The index stages' data source: the parquet ShardReader, or the
        virtual corpus (made on the driver's device) when the data dir
        holds a ``virtual.json`` spec."""
        return open_data_source(self.data_dir, device=self.device)

    def _data_fingerprint(self) -> dict:
        if not self.data_dir.is_dir():
            return {}
        fp = {p.name: p.stat().st_size for p in sorted(self.data_dir.glob("data_*.parquet"))}
        vj = self.data_dir / SPEC_NAME
        if vj.exists():
            import hashlib

            fp[SPEC_NAME] = hashlib.sha1(vj.read_bytes()).hexdigest()
            # the rows depend on the generator, not only on the spec
            fp["generator"] = generator_tag(self.device)
        return fp

    # -- targets -------------------------------------------------------------

    def target_build(self) -> dict:
        """Manifest fetch + incremental partition ingest into the store.
        ``build_stats`` then holds each ingested partition's rows,
        ``embed_s`` and ``stall_s``. Over a mesh each rank (each shard
        at tp > 1) ingests its own partitions into its own store."""
        urls = parse_manifest(self.fetcher(self.cfg.manifest_url))
        if self.rank0:
            changed = update_manifest_file(self.manifest_path, urls)
            logger.info("manifest: %d part urls (%s)", len(urls),
                        "updated" if changed else "unchanged")
        self._barrier()
        state = SyncState(self.events_dir)
        owner = None
        if self.mesh.size == 1:
            store = self._store(create=True)
        else:
            # one store per shard, written by its tp rank 0 (at tp 1: per rank)
            p = self.store_path.with_name(f"{self.store_path.name}.p{self.mesh.shard_rank}")
            store = None
            if self.mesh.tp_rank == 0:
                store = init_store(p) if not p.exists() else EmbeddingStore(p)
            owner = (self.mesh.shard_rank, self.mesh.n_shard)
        # one revision per sync run: rows this run upserts are "since the
        # last fill" for the incremental-fill watermark (a part store's
        # revision bounds what the dump's merge moves)
        if store is not None:
            store.bump_rev()
        self.build_stats = {}
        try:
            out = {}
            if store is not None or self.embedder is not None:
                out = sync(urls, state, self.embedder, store, batch_size=self.cfg.embed_batch,
                           buffer_bytes=self.cfg.ingest_buffer_bytes, owner=owner,
                           stats=self.build_stats)
        finally:
            if store is not None:
                store.close()
        self._barrier()
        return out

    def _host_stores(self) -> list[Path]:
        return sorted(self.store_path.parent.glob(self.store_path.name + ".p*"))

    def _merge_host_stores(self) -> int:
        """Fold per-host ingest stores (``data.sqlite.p<pid>``) into the
        main store (sqlite ATTACH + INSERT OR REPLACE, id-keyed, so a
        re-merge is idempotent)."""
        parts = self._host_stores()
        if not parts:
            return 0
        store = self._store(create=True)
        merged = 0
        try:
            # merged rows get a fresh MAIN-store revision (part counters
            # are per host, incomparable), but only the rows each part
            # upserted since its last merge move (a per-part high-water
            # mark in main meta): re-merging every part row on every dump
            # would mark the whole corpus "new" for the incremental fill
            rev = store.bump_rev()
            for p in parts:
                store.conn.execute("ATTACH DATABASE ? AS src", (str(p),))
                hw_key = f"merged_rev_{p.name}"
                last = int(store.get_meta(hw_key, "-1"))
                part_rev = store.conn.execute(
                    "SELECT value FROM src.meta WHERE key='sync_rev'").fetchone()
                cur = store.conn.execute(
                    "INSERT OR REPLACE INTO works (id, embedding, rev) "
                    "SELECT id, embedding, ? FROM src.works WHERE rev > ?", (rev, last))
                merged += cur.rowcount
                # meta too (the `dim` key), never the part's own sync_rev
                store.conn.execute(
                    "INSERT OR REPLACE INTO meta SELECT * FROM src.meta WHERE key != 'sync_rev'")
                store.set_meta(hw_key, part_rev[0] if part_rev else "0")
                store.conn.commit()
                store.conn.execute("DETACH DATABASE src")
        finally:
            store.close()
        logger.info("merged %d rows from %d host stores", merged, len(parts))
        return merged

    def target_dump(self, *, force: bool = False) -> int:
        """Export sqlite -> parquet when the event set changed. Over a mesh
        rank 0 alone merges the per-rank stores and dumps; -> its rows (0
        on the other ranks)."""
        try:
            return self._dump(force=force) if self.rank0 else 0
        finally:
            self._barrier()

    def _dump(self, *, force: bool) -> int:
        self._merge_host_stores()
        current = set(SyncState(self.events_dir).completed())
        copied = (set(p.name for p in self.published_events.iterdir())
                  if self.published_events.is_dir() else None)
        if not force and self.data_dir.is_dir() and copied == current:
            logger.info("dump: up to date (%d events)", len(current))
            return 0
        if self.data_dir.exists():
            shutil.rmtree(self.data_dir)
        if self.published_events.exists():
            shutil.rmtree(self.published_events)
        store = self._store()
        try:
            # records the captured store revision: the incremental-fill
            # watermark (rows upserted after the dump stay pending)
            n = dump_store_to_shards(store, self.data_dir, shard_size=self.cfg.shard_size,
                                     row_group_size=self.cfg.row_group_size)
        finally:
            store.close()
        shutil.copytree(self.events_dir, self.published_events)
        logger.info("dump: exported %d rows", n)
        return n

    def _load_training_sample(self):
        """The training subset. A virtual corpus gives a device-streamed
        view (the sample never exists on the host); a large parquet
        sample lands in a disk memmap under ``<data_dir>/.astpu_cache``
        (cleaned by ``astpu index --source ... clean``)."""
        reader = self._reader()
        n = min(self.cfg.train_sample, len(reader))
        if hasattr(reader, "train_view"):
            return reader.train_view(n)
        if n * reader.dim * 4 <= self.SAMPLE_INRAM_BYTES:
            return reader.sample(n)
        cache = self.data_dir / ".astpu_cache"
        path = cache / f"train_sample_{n}x{reader.dim}.f32"
        if self.rank0:      # one writer; over a mesh every rank reads it
            cache.mkdir(parents=True, exist_ok=True)
            mm = np.memmap(path, dtype=np.float32, mode="w+", shape=(n, reader.dim))
            reader.sample(n, out=mm)
            mm.flush()
            del mm
        self._barrier()
        return np.memmap(path, dtype=np.float32, mode="r", shape=(n, reader.dim))

    def target_train(self, *, force: bool = False, kmeans_iters: int = 10) -> bool:
        """Order-only semantics: retrain only when artifacts are absent."""
        if self.mesh.tp > 1:
            return self._on_shard_axis("target_train", force=force, kmeans_iters=kmeans_iters)
        if self.empty_dir.is_dir() and self.untuned_path.exists() and not force:
            logger.info("train: artifacts present, skipping (order-only dep)")
            return False
        sample = self._load_training_sample()
        n_lists = min(self.cfg.ivf_centroids, max(1, len(sample) // 16))
        index = IVFPQIndex(n_lists, sample.shape[1], pq_m=self.cfg.pq_m,
                           pq_nbits=self.cfg.pq_nbits, use_opq=self.cfg.opq,
                           spherical=self.cfg.normalize, storage=self.cfg.index_storage,
                           seg_size=self.cfg.index_seg_size, mesh=self.mesh)
        stats = index.train(sample, kmeans_iters=kmeans_iters,
                            workdir=self.data_dir / ".astpu_cache")
        # every rank trained the same arrays, bit for bit: checked before
        # rank 0 writes the artifact and untuned.json (every rank's stages
        # and hash under "ranks")
        digest = _trained_sha256(index)
        stats = self._rank_report(stats, stages=stats["stages"], sha256=digest)
        if len({r["sha256"] for r in stats.get("ranks", [])} | {digest}) != 1:
            raise RuntimeError(f"the ranks trained different arrays: {stats['ranks']}")
        if self.rank0:
            index.save(self.empty_dir, include_lists=False)
            self.untuned_path.parent.mkdir(parents=True, exist_ok=True)
            self.untuned_path.write_text(json.dumps(_json_safe(stats), indent=2))
        self._barrier()
        logger.info("train: %d lists trained on %d rows", n_lists, len(sample))
        return True

    def _load_index(self, *, filled: bool) -> IVFPQIndex:
        if filled and self._filled_index is not None:
            return self._filled_index
        d = self.filled_dir if filled else self.empty_dir
        idx = IVFPQIndex.load(d, mesh=self.mesh, storage=self.cfg.index_storage,
                              hot_budget_bytes=self.cfg.index_hot_bytes)
        if filled:
            # kept: a second load would install a second copy of the lists
            # (2 x 12.9 GiB at 207M rows). Invalidated by the fills.
            self._filled_index = idx
        return idx

    def _read_fill_stamp(self) -> dict | None:
        """{"fingerprint": ..., "watermark": int | None}; older stamps were
        the raw fingerprint dict (no watermark: incremental fill waits
        for the next full fill)."""
        if not self.fill_stamp.exists():
            return None
        raw = json.loads(self.fill_stamp.read_text())
        if isinstance(raw, dict) and "fingerprint" in raw and "watermark" in raw:
            return raw
        return {"fingerprint": raw, "watermark": None}

    @property
    def delta_root(self) -> Path:
        return self.index_dir / "delta"

    def incremental_ready(self) -> bool:
        """True when ``target_fill(incremental=True)`` can take the
        O(delta) path: a watermarked base fill exists and the store is
        there to stream deltas from."""
        stamp = self._read_fill_stamp()
        return (stamp is not None and stamp["watermark"] is not None
                and self.filled_dir.is_dir() and self.ids_path.exists()
                and self.store_path.exists())

    def delta_dirs(self) -> list[Path]:
        if not self.delta_root.is_dir():
            return []
        return sorted(p for p in self.delta_root.iterdir()
                      if (p / "index" / "meta.json").exists())

    def delta_stats(self) -> dict:
        """{"base_rows", "delta_rows", "n_deltas"} from artifact metadata
        only (the deltas' stamp.json row counts, the base ids.parquet's
        row count)."""
        ddirs = self.delta_dirs()
        delta_rows = 0
        for d in ddirs:
            try:
                delta_rows += int(json.loads((d / "stamp.json").read_text())["rows"])
            except (OSError, KeyError, ValueError):
                delta_rows += _parquet_rows(d / "ids.parquet")
        base_rows = _parquet_rows(self.ids_path) if self.ids_path.exists() else 0
        return {"base_rows": base_rows, "delta_rows": delta_rows, "n_deltas": len(ddirs)}

    def compaction_due(self) -> bool:
        s = self.delta_stats()
        return compaction_due(s["base_rows"], s["delta_rows"], s["n_deltas"],
                              max_frac=self.cfg.compact_max_delta_frac,
                              max_deltas=self.cfg.compact_max_deltas)

    def target_compact(self) -> bool:
        """Fold the delta sub-indexes back into one base index: re-dump
        (the store holds the delta rows) + full refill, which drops
        ``delta/`` and advances the watermark. ``astpu index compact``;
        ``target_fill(incremental=True)`` runs it when the policy fires
        (``cfg.auto_compact``)."""
        if not self.delta_dirs():
            logger.info("compact: no delta sub-indexes; nothing to do")
            return False
        # the artifact being compacted is the filled index (the JAX copy
        # reads empty/meta.json here)
        meta_p = self.filled_dir / "meta.json"
        if meta_p.exists() and not json.loads(meta_p.read_text())["spherical"]:
            raise ValueError(
                "compact unavailable: the index was built without -N "
                "(legacy mode, serve-only). Rebuild with -N "
                "(`astpu index clean && astpu all`).")
        s = self.delta_stats()
        logger.info("compact: folding %d delta sub-index(es), %d rows (base %d rows)",
                    s["n_deltas"], s["delta_rows"], s["base_rows"])
        if not self.store_path.exists():
            # the dump predates the deltas; refilling from it would drop
            # every delta row (the store holds their only embeddings)
            raise FileNotFoundError(
                f"compact: no store at {self.store_path} — a full refill from the stale "
                f"dump would lose the delta rows; run `astpu recover` first")
        self.target_dump(force=True)
        return self.target_fill(force=True)

    def target_fill(self, *, force: bool = False, kmeans_iters: int = 10,
                    incremental: bool = False) -> bool:
        if self.mesh.tp > 1:
            return self._on_shard_axis("target_fill", force=force, kmeans_iters=kmeans_iters,
                                       incremental=incremental)
        self.target_train(kmeans_iters=kmeans_iters)
        fp = self._data_fingerprint()
        stamp = self._read_fill_stamp()
        # the incremental path streams from the STORE, so it is consulted
        # before the dump-fingerprint no-op: `astpu build && astpu index
        # fill --incremental` has new store rows but an unchanged dump
        if incremental and not force and self.incremental_ready() and self.mesh.size > 1:
            logger.warning("incremental fill runs in one process (the delta streams from "
                           "one store); running a full fill over the %d ranks",
                           self.mesh.size)
        elif incremental and not force and self.incremental_ready():
            changed = self._fill_delta(fp, stamp)
            if changed and self.cfg.auto_compact and self.compaction_due():
                s = self.delta_stats()
                logger.warning(
                    "fill: delta set past compaction policy (%d rows in %d sub-indexes vs "
                    "%d base rows; thresholds frac=%.2f count=%d) — compacting",
                    s["delta_rows"], s["n_deltas"], s["base_rows"],
                    self.cfg.compact_max_delta_frac, self.cfg.compact_max_deltas)
                self.target_compact()
            return changed
        if (not force and stamp is not None and self.filled_dir.is_dir()
                and self.ids_path.exists() and stamp["fingerprint"] == fp):
            logger.info("fill: up to date")
            return False

        self._filled_index = None
        index = self._load_index(filled=False)
        reader = self._reader()
        self.filled_dir.mkdir(parents=True, exist_ok=True)
        # the row groups are dealt before any is read: each rank reads
        # the embeddings of its own (deal); ids.parquet has one writer,
        # rank 0, which reads the id column of every row group beside
        # the fill
        starts = np.cumsum([0, *reader.row_group_rows()])
        mine = deal(len(starts) - 1, self.mesh)
        n_rows = int(starts[-1])
        writer = (_IdsWriter(self.ids_path.with_name(self.ids_path.name + ".tmp"))
                  if self.rank0 else None)

        def chunks():
            for g, (_, embs) in zip(mine, reader.iter_row_groups(with_ids=False,
                                                                  groups=mine)):
                yield embs, np.arange(starts[g], starts[g + 1], dtype=np.int64)

        def write_ids():
            for ids in reader.iter_ids():
                writer.write(ids)

        # codes spill to disk and the external pack writes the memmap
        # artifact in place
        timer = StageTimer(counters=launch_counts)
        try:
            with timer.stage("fill_stream") as rec, ThreadPoolExecutor(1) as pool:
                ids_job = pool.submit(write_ids) if writer is not None else None
                index.fill_stream(chunks(), lists_dir=self.filled_dir / "lists")
                if ids_job is not None:
                    ids_job.result()
                rec["fill_stats"] = index.fill_stats
        except BaseException:
            # the pool's exit waited for the ids thread
            if writer is not None:
                writer.abort()
            raise
        if self.rank0:
            with timer.stage("save"):
                writer.commit(self.ids_path)
                index.save(self.filled_dir)
            self._stamp_full_fill(fp)
        self._rank_report(timer.report(), self.fill_report_path, stages=timer.stages)
        self._barrier()
        # the lists are installed: a same-process tune or serve reuses them
        self._filled_index = index
        logger.info("fill: %d vectors indexed", n_rows)
        return True

    def _stamp_full_fill(self, fp: dict) -> None:
        """The fill stamp of a full fill; drops the delta sub-indexes."""
        # a full fill covers exactly what the DUMP captured: its store
        # revision is the incremental watermark (stamping the live store
        # counter would orphan rows upserted after the dump). A data dir
        # without dump metadata (virtual corpora, recovered trees) gets
        # no watermark.
        watermark = None
        dm = self.data_dir / DUMP_META
        if dm.exists():
            watermark = json.loads(dm.read_text()).get("store_rev")
        if self.delta_root.is_dir():
            shutil.rmtree(self.delta_root)
        self.fill_stamp.write_text(json.dumps({"fingerprint": fp, "watermark": watermark}))

    def _fill_delta(self, fp: dict, stamp: dict) -> bool:
        """Incremental fill: index only the rows upserted since the last
        fill's watermark into a self-contained delta sub-index
        (``index_dir/delta/<n>/``: lists + its own ids.parquet). The
        engine searches base + deltas and merges newest-wins; a full fill
        drops the deltas."""
        with self._store() as store:
            w = int(stamp["watermark"])
            if store.count_since(w) == 0:
                self.fill_stamp.write_text(json.dumps({"fingerprint": fp, "watermark": w}))
                logger.info("fill: no rows past watermark %d; stamp refreshed", w)
                return False
            new_w = store.sync_rev
            index = self._load_index(filled=False)
            if not index.spherical:
                raise ValueError(
                    "incremental fill unavailable: the index was built without -N "
                    "(legacy mode, serve-only). Rebuild with -N "
                    "(`astpu index clean && astpu all`).")
            ddir = self.delta_root / f"{len(self.delta_dirs()):04d}"
            (ddir / "index").mkdir(parents=True, exist_ok=True)
            writer = _IdsWriter(ddir / "ids.parquet.tmp")
            n_rows = 0

            def chunks():
                nonlocal n_rows
                pos = 0
                for ids, embs in store.iter_batches(min_rev=w + 1):
                    writer.write(ids)
                    positions = np.arange(pos, pos + len(embs), dtype=np.int64)
                    pos += len(embs)
                    n_rows = pos
                    yield embs, positions

            try:
                index.fill_stream(chunks(), lists_dir=ddir / "index" / "lists")
            except BaseException:
                writer.abort()
                shutil.rmtree(ddir, ignore_errors=True)
                raise
            writer.commit(ddir / "ids.parquet")
            index.save(ddir / "index")
            (ddir / "stamp.json").write_text(json.dumps(
                {"watermark_from": w, "watermark_to": new_w, "rows": n_rows}))
            self.fill_stamp.write_text(json.dumps({"fingerprint": fp, "watermark": new_w}))
        self._filled_index = None  # the engine reloads base + deltas
        logger.info("fill: delta %s indexed %d rows (watermark %d -> %d)",
                    ddir.name, n_rows, w, new_w)
        return True

    def _tune_oracle_kw(self, n_queries: int, k: int) -> dict:
        """Cache path + identity key of the tune ground truth: the exact
        oracle is a full corpus pass but depends only on this key, so it
        is cached next to the index artifacts."""
        n_rows = len(self._reader())
        return dict(
            oracle_cache=self.index_dir / "tune_oracle.npz",
            oracle_key={"fingerprint": self._data_fingerprint(),
                        "n_queries": int(min(n_queries, n_rows)), "k": int(k), "seed": 0,
                        "spherical": bool(self.cfg.normalize)})

    def _ensure_tune_oracle(self, *, n_queries: int | None = None,
                            k: int | None = None) -> None:
        """Compute and persist the exact tune oracle if the cache misses,
        before the filled index is installed: streaming the corpus needs
        workspace that the installed lists would share."""
        if self.mesh.tp > 1:
            return self._on_shard_axis("_ensure_tune_oracle", n_queries=n_queries, k=k)
        n_queries = self.TUNE_QUERIES if n_queries is None else n_queries
        k = self.TUNE_K if k is None else k
        kw = self._tune_oracle_kw(n_queries, k)
        tune.ensure_oracle_cache(kw["oracle_cache"], kw["oracle_key"], self._reader(), k=k,
                                 mesh=self.mesh, spherical=bool(self.cfg.normalize))

    def target_tune(self, *, force: bool = False, n_queries: int | None = None,
                    k: int | None = None, target_recall: float = 0.95) -> bool:
        if self.mesh.tp > 1:
            return self._on_shard_axis("target_tune", force=force, n_queries=n_queries, k=k,
                                       target_recall=target_recall)
        n_queries = self.TUNE_QUERIES if n_queries is None else n_queries
        k = self.TUNE_K if k is None else k
        self.target_train()
        if self.params_path.exists() and not force:
            logger.info("tune: params.json present, skipping")
            return False
        # Tune the filled index against the FULL corpus reader, so the
        # oracle and index.search share one position space. Without a
        # filled index, fill a temporary one with a sample: then
        # sample-local positions ARE the index's positions.
        reader = self._reader()
        cache_kw = {}
        timer = StageTimer(counters=launch_counts)
        if self.filled_dir.is_dir():
            with timer.stage("oracle"):
                self._ensure_tune_oracle(n_queries=n_queries, k=k)
            index = self._load_index(filled=True)
            source, n_rows = reader, len(reader)
            cache_kw = self._tune_oracle_kw(n_queries, k)
        else:
            index = self._load_index(filled=False)
            sample = reader.sample(min(len(reader), self.cfg.tune_sample))
            if len(reader) > len(sample):
                logger.warning(
                    "tune: no filled index — tuning a TEMPORARY index filled with a "
                    "%d-row sample of the %d-row corpus; the chosen nprobe may not "
                    "transfer. Run `astpu index fill` first (or `astpu all`) and re-tune "
                    "with --force for a production operating point.",
                    len(sample), len(reader))
            with timer.stage("sample_fill"):
                index.fill(sample)
            source, n_rows = sample, len(sample)
        with timer.stage("sweep"):
            params = tune.tune_index(index, source, n_queries=min(n_queries, n_rows), k=k,
                                     target_recall=target_recall, **cache_kw)
        if self.rank0:
            tune.write_params(self.params_path, params)
        self._rank_report(timer.report(), self.tune_report_path, stages=timer.stages)
        self._barrier()
        logger.info("tune: nprobe=%d recall=%.3f", params["nprobe"],
                    params["achieved_recall"])
        return True

    def target_all(self, *, kmeans_iters: int = 10) -> None:
        """fill + tune, pulling build and dump as needed. Stage timings
        land in ``<index_dir>/build_report.json``; with
        ``ASTPU_PROFILE=<dir>`` each stage also writes a profiler trace."""
        from .utils import StageTimer, profile_scope

        timer = StageTimer()
        if self.events_dir.is_dir() or not self.data_dir.is_dir():
            if self.manifest_path.exists() or self.cfg.manifest_url.startswith("file:"):
                try:
                    with timer.stage("build"), profile_scope("build"):
                        self.target_build()
                except Exception as e:
                    if self.mesh.size > 1:
                        raise       # the other ranks wait in its barriers
                    logger.warning("build skipped: %s", e)
            if self.store_path.exists() or self._host_stores():
                with timer.stage("dump"):
                    self.target_dump()
        if self.data_dir.is_dir() and not self.params_path.exists():
            # the exact-oracle pass before fill installs the lists;
            # cached, so sync re-runs skip it
            with timer.stage("tune_oracle"), profile_scope("tune_oracle"):
                self._ensure_tune_oracle()
        with timer.stage("fill"), profile_scope("fill"):
            self.target_fill(kmeans_iters=kmeans_iters)
        with timer.stage("tune"), profile_scope("tune"):
            self.target_tune()
        self._rank_report(timer.report(), self.index_dir / "build_report.json",
                          stages=timer.stages)

    def target_recover(self) -> int:
        """Rebuild sqlite + the sync position from the published dataset."""
        store = self._store(create=True)
        try:
            n = load_shards_to_store(self.data_dir, store)
        finally:
            store.close()
        if self.published_events.is_dir():
            if self.events_dir.exists():
                shutil.rmtree(self.events_dir)
            shutil.copytree(self.published_events, self.events_dir)
        logger.info("recover: %d rows restored", n)
        return n

    def target_clean(self) -> None:
        for p in (self.events_dir, self.data_dir, self.index_dir):
            if p.exists():
                shutil.rmtree(p)
        for f in (self.store_path, self.manifest_path):
            if f.exists():
                f.unlink()
        logger.info("clean: done")


def _trained_sha256(index: IVFPQIndex) -> str:
    """sha256 of the trained arrays: centroids, codebooks, rotation."""
    import hashlib

    h = hashlib.sha256()
    for a in (index.centroids, index.pq_centroids, index.rotation):
        h.update(np.ascontiguousarray(a, np.float32).tobytes())
    return h.hexdigest()


def _parquet_rows(path: Path) -> int:
    import pyarrow.parquet as pq

    return pq.ParquetFile(path).metadata.num_rows


class _IdsWriter:
    """Incremental ids.parquet writer (one row group per id batch):
    positions -> OpenAlex work ids. Also streams the binary sidecar that
    ``IdMap`` memmap-slices (``ids.bin``: concatenated UTF-8 ids;
    ``ids.off``: uint64 start offsets, n+1 entries)."""

    # the sidecar meta a commit leaves while its renames are in flight:
    # it binds to no parquet footer, so IdMap refuses the pair
    TOMBSTONE = {"parquet_footer_sha256": None, "commit": "in progress"}

    def __init__(self, path: Path):
        import pyarrow as pa
        import pyarrow.parquet as pq

        path.parent.mkdir(parents=True, exist_ok=True)
        self._pa = pa
        self._path = path
        self._writer = pq.ParquetWriter(path, pa.schema([pa.field("id", pa.string())]))
        self._bin_tmp = path.with_name(path.name + ".bin")
        self._off_tmp = path.with_name(path.name + ".off")
        self._bin = open(self._bin_tmp, "wb")
        self._off = open(self._off_tmp, "wb")
        self._off.write(np.uint64(0).tobytes())
        self._pos = 0

    def write(self, ids) -> None:
        if not len(ids):
            # no empty parquet row groups: they break row-group streamers
            return
        self._writer.write_table(self._pa.table({"id": self._pa.array(ids,
                                                                     self._pa.string())}))
        encoded = [str(i).encode("utf-8") for i in ids]
        lens = np.fromiter((len(e) for e in encoded), dtype=np.uint64, count=len(encoded))
        offs = self._pos + np.cumsum(lens, dtype=np.uint64)
        self._bin.write(b"".join(encoded))
        self._off.write(offs.tobytes())
        self._pos = int(offs[-1])

    def close(self) -> None:
        self._writer.close()
        self._bin.close()
        self._off.close()

    def commit(self, dst: Path) -> None:
        """Move parquet + sidecars to their final names (``<dst>``,
        ``<stem>.bin``, ``<stem>.off``), then write the binding meta
        (``<stem>.sidecar.json``: the parquet footer's fingerprint)
        LAST. Before the first rename the meta is replaced by a
        tombstone, so a crash anywhere in the window leaves a meta that
        binds to no parquet and ``IdMap`` refuses the sidecars outright
        (the JAX copy unlinks the meta, and a meta-less pair is then
        admitted by a probe of 16 positions)."""
        from .storage.idmap import sidecar_meta_path, write_sidecar_meta

        self.close()
        meta = sidecar_meta_path(dst)
        tmp = meta.with_name(meta.name + ".tmp")
        tmp.write_text(json.dumps(self.TOMBSTONE))
        tmp.replace(meta)
        self._path.replace(dst)
        self._bin_tmp.replace(dst.with_name(dst.stem + ".bin"))
        self._off_tmp.replace(dst.with_name(dst.stem + ".off"))
        write_sidecar_meta(dst)

    def abort(self) -> None:
        self.close()
        for p in (self._path, self._bin_tmp, self._off_tmp):
            p.unlink(missing_ok=True)


def _write_ids_parquet(path: Path, ids: list[str]) -> None:
    """One-shot ids.parquet + binary sidecars (small corpora, tests)."""
    path = Path(path)
    w = _IdsWriter(path.with_name(path.name + ".tmp"))
    w.write(list(ids))
    w.commit(path)


def read_ids_parquet(path: str | Path) -> list[str]:
    import pyarrow.parquet as pq

    return pq.read_table(path, columns=["id"]).column("id").to_pylist()
