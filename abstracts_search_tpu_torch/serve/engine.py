"""Search engine: the query path.

startup (``from_artifacts``): load the filled index at the configured
storage, the ``params.json`` operating point, the lazy ``ids.parquet``
position map, any delta sub-indexes, and the query encoder.
per query: encode -> IVF-PQ search on the card at the tuned nprobe ->
positions -> ids, merged newest-wins over the deltas -> optional live
OpenAlex hydration.
"""

from __future__ import annotations

import logging
import threading
import time
from pathlib import Path

from ..config import Config
from ..driver import compaction_due
from ..index.ivfpq import IVFPQIndex
from ..index.tune import read_params
from ..models.registry import get_embedder
from .hydrate import OpenAlexClient

logger = logging.getLogger(__name__)


class SearchEngine:
    # extra base results fetched when delta sub-indexes exist, so
    # superseded (updated-work) base hits can be masked without
    # starving the top-k merge
    DELTA_OVERFETCH = 16

    def __init__(self, index, ids, embedder, *, nprobe: int = 16,
                 hydrator: OpenAlexClient | None = None, deltas=()):
        """``ids``: any indexable position->id map: an ``IdMap`` (lazy;
        the production path), a list, or a mapping; one with
        ``resolve(positions)`` is asked once per batch.

        ``deltas``: incremental-fill sub-indexes, OLDEST FIRST — each an
        (index, ids, id_set) triple. Search fans out over base + deltas
        and merges newest-wins: a hit is dropped when its id also lives
        in a NEWER delta, which holds the row's current embedding."""
        self.index = index
        self.ids = ids
        self.embedder = embedder
        self.nprobe = nprobe
        self.hydrator = hydrator
        self.deltas = list(deltas)  # property: publishes (deltas, masks)
        # lazily-built executor for the base+delta fan-out
        self._pool = None
        self._pool_lock = threading.Lock()

    @property
    def deltas(self):
        return list(self._delta_state[0])

    @deltas.setter
    def deltas(self, value) -> None:
        """Swapping the delta set also rebuilds the newest-wins masks.
        The (deltas, masks) pair is published as ONE atomically-assigned
        tuple and snapshotted once per search, so a swap on a live engine
        never pairs N sources with M masks. Assign a new list to mutate
        (``engine.deltas = [...]``); the getter returns a copy."""
        deltas = tuple(value)
        newer: list[set] = []
        acc: set = set()
        for _, _, dset in reversed(deltas):            # newest first
            newer.append(acc)
            acc = acc | dset
        newer.append(acc)                              # for the base
        newer.reverse()                                # align to sources
        self._delta_state = (deltas, newer)

    @classmethod
    def from_artifacts(
        cls,
        cfg: Config,
        *,
        index_dir: str | Path,
        embedder: str = "auto",
        hydrate: bool = True,
        device=None,
        fetcher=None,
        warmup: bool = True,
    ) -> "SearchEngine":
        """The engine a deployment serves, from an artifact directory:
        ``index/`` (at ``cfg.index_storage``, ``cfg.index_hot_bytes``),
        ``params.json`` (nprobe; 16 without it), ``ids.parquet`` and
        ``delta/*/{index,ids.parquet}``. Needs pyarrow."""
        import pyarrow.parquet as pq

        from ..storage.idmap import IdMap

        index_dir = Path(index_dir)
        filled = index_dir / "index"
        if not filled.is_dir():
            raise FileNotFoundError(
                f"no filled index under {index_dir} (run `astpu index fill` / `astpu all`)")
        index = IVFPQIndex.load(filled, device=device, storage=cfg.index_storage,
                                hot_budget_bytes=cfg.index_hot_bytes)

        params_path = index_dir / "params.json"
        nprobe = 16
        if params_path.exists():
            nprobe = int(read_params(params_path)["nprobe"])

        # lazy map: 207M id strings as a Python list are ~15-25 GB of RSS
        ids = IdMap(index_dir / "ids.parquet")

        # incremental-fill delta sub-indexes: small, so device storage and
        # an in-RAM id set per delta
        deltas = []
        delta_root = index_dir / "delta"
        if delta_root.is_dir():
            for ddir in sorted(delta_root.iterdir()):
                if not (ddir / "index" / "meta.json").exists():
                    continue
                didx = IVFPQIndex.load(ddir / "index", device=device)
                dmap = IdMap(ddir / "ids.parquet")
                dset = set(pq.read_table(ddir / "ids.parquet").column(0).to_pylist())
                deltas.append((didx, dmap, dset))
            if deltas:
                total = sum(d[0].n for d in deltas)
                logger.info("engine: %d delta sub-index(es), %d rows total",
                            len(deltas), total)
                # the policy the build pipeline compacts on; seen here,
                # auto_compact is off or the artifacts are stale
                if compaction_due(index.n, total, len(deltas),
                                  max_frac=cfg.compact_max_delta_frac,
                                  max_deltas=cfg.compact_max_deltas):
                    # legacy -N-absent bases are serve-only: compact would
                    # refuse them
                    remedy = ("run `astpu index compact`" if index.spherical
                              else "this legacy non--N index is serve-"
                                   "only; rebuild with -N to compact")
                    logger.warning(
                        "engine: delta set is past the compaction policy "
                        "(%d rows in %d sub-indexes vs %d base rows; id "
                        "sets are RAM-resident and each delta adds a "
                        "search round trip) — %s",
                        total, len(deltas), index.n, remedy)

        emb = get_embedder(embedder, cfg)
        hyd = OpenAlexClient(fetcher) if hydrate else None
        logger.info("engine: %d vectors, nprobe=%d, dim=%d, storage=%s", index.n, nprobe,
                    index.dim, index.storage)
        engine = cls(index, ids, emb, nprobe=nprobe, hydrator=hyd, deltas=deltas)
        if warmup:
            engine.warmup()
        return engine

    def warmup(self, k: int = 10) -> None:
        """Run the single-query path once at startup (allocator and
        cuBLAS set-up). Logs and continues on failure, as the JAX engine
        does; kernel faults surface earlier, at ``IVFPQIndex.load``."""
        t0 = time.perf_counter()
        try:
            self._search_ids(self.embedder.queries(["warmup"]), k)
            logger.info("warmup: %.2fs", time.perf_counter() - t0)
        except Exception:  # noqa: BLE001 — warmup must never kill startup
            logger.exception("warmup failed (serving continues)")

    @staticmethod
    def _resolve_with(ids, positions) -> list[str]:
        """Batch position -> id lookup: one ``resolve`` call where the
        map has one (an ``IdMap`` reads each touched row group once)."""
        if hasattr(ids, "resolve"):
            return ids.resolve(positions)
        return [ids[int(p)] for p in positions]

    def _search_one_source(self, idx, ids, q, ks: int):
        scores, pos = idx.search(q, min(ks, idx.n) if idx.n else 1,
                                 nprobe=self.nprobe)
        rows = [
            [(float(s), int(p)) for s, p in zip(scores[qi], pos[qi]) if p >= 0]
            for qi in range(len(q))
        ]
        names = iter(self._resolve_with(ids, [p for row in rows for _, p in row]))
        return [[(s, next(names)) for s, _ in row] for row in rows]

    def _search_ids(self, q, k: int) -> list[list[tuple[float, str]]]:
        """Fan out over base + delta sub-indexes and merge newest-wins:
        per query, a list of (score, id) of length <= k, score-sorted.
        Without deltas this is exactly the base search + id resolve."""
        deltas, newer_sets = self._delta_state   # ONE snapshot per search
        sources = [(self.index, self.ids)] + [(d[0], d[1]) for d in deltas]
        # every source whose hits a NEWER delta can mask is overfetched
        # so the post-mask pool stays >= k; the newest source needs none
        kk = [k + self.DELTA_OVERFETCH] * len(sources)
        kk[-1] = k
        if len(sources) == 1:
            per_source = [self._search_one_source(self.index, self.ids, q, kk[0])]
        else:
            with self._pool_lock:
                if self._pool is None:
                    from concurrent.futures import ThreadPoolExecutor

                    self._pool = ThreadPoolExecutor(
                        max_workers=4, thread_name_prefix="astpu-delta-fan")
            per_source = list(self._pool.map(
                lambda src_ks: self._search_one_source(
                    src_ks[0][0], src_ks[0][1], q, src_ks[1]),
                zip(sources, kk)))
        out = []
        for qi in range(len(q)):
            cands = []
            for src, rows in enumerate(per_source):
                mask = newer_sets[src]
                cands.extend((s, n) for s, n in rows[qi] if n not in mask)
            cands.sort(key=lambda t: -t[0])
            out.append(cands[:k])
        return out

    def hydrate_rows(self, rows: list[list[dict]]) -> None:
        """Attach OpenAlex metadata in place, one ``get_works`` call for
        all rows (the single-query path and the micro-batcher share it)."""
        if self.hydrator is None:
            return
        ids = [r["id"] for row in rows for r in row]
        if not ids:
            return
        meta = self.hydrator.get_works(ids)
        for row in rows:
            for r in row:
                r.update(meta.get(r["id"], {}))

    def search(self, query: str, k: int = 10) -> list[dict]:
        q = self.embedder.queries([query])
        results = [{"id": n, "score": s} for s, n in self._search_ids(q, k)[0]]
        self.hydrate_rows([results])
        return results

    def search_batch(self, queries: list[str], k: int = 10) -> list[list[dict]]:
        return self.search_batch_encoded(self.encode_queries(queries), k)

    def encode_queries(self, queries: list[str]):
        """Encoder-only half of the batched path."""
        return self.embedder.queries(queries)

    def search_batch_encoded(self, q, k: int = 10) -> list[list[dict]]:
        """Search half over already-encoded query vectors."""
        return [[{"id": n, "score": s} for s, n in row]
                for row in self._search_ids(q, k)]
