"""Search engine: the query path.

startup (``from_artifacts``): load the filled index at the configured
storage, the ``params.json`` operating point, the lazy ``ids.parquet``
position map, any delta sub-indexes, and the query encoder.
per query: encode -> IVF-PQ search on the card at the tuned nprobe ->
positions -> ids, merged newest-wins over the deltas -> optional live
OpenAlex hydration.

Over a mesh (``from_artifacts(mesh=)``, ``parallel/mesh.py``) each rank
holds its own lists of the base index and of every delta (its shard's,
replicated over the tp ranks of a 2-D mesh); rank 0 alone resolves ids
and hydrates. Each search is one collective section: rank 0 broadcasts a
header (op, Q, k, nprobe, D, sources) and the query vectors, then every
rank runs the same ``search`` calls in the same order, base first, then
each delta. With the hash embedder rank 0 alone encodes; with stella
over the mesh (``StellaEmbedder.collective``: rows over ``shard``,
weights over ``tp``) each encode is a section of its own before the
search: rank 0 tokenizes and broadcasts the header and each batch's
token ids and mask (never the texts: the whitespace tokenizer's ``hash``
differs between processes), then every rank runs the forward and holds
the vectors. The other ranks run ``follow()`` until rank 0 broadcasts the
stop op. One lock serializes the sections, so concurrent callers (the
batcher's workers, HTTP threads) never interleave collectives, and an
encode and a search never interleave; id resolution and hydration stay
concurrent. A request is checked on rank 0 before its header goes out,
so a malformed one is refused there (``ValueError``) and no rank sees
it. A failed collective (a lost rank, a timeout) marks the engine failed
and every later search raises. The delta set of an engine over a mesh
is fixed when it starts.
"""

from __future__ import annotations

import logging
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..config import Config
from ..driver import compaction_due
from ..index.ivfpq import IVFPQIndex
from ..index.tune import read_params
from ..models.registry import get_embedder
from ..parallel.mesh import Mesh, broadcast
from ..utils import trace
from .hydrate import OpenAlexClient

logger = logging.getLogger(__name__)

# the ops of a collective section's header: [op, Q, k, nprobe, D, sources]
# for a search, [op, batches, 0, 0, mrl_dim, 0] for an encode
OP_SEARCH, OP_PING, OP_STOP, OP_ENCODE = 1, 2, 3, 4
# the largest k a search over a mesh takes (the HTTP API's cap)
MAX_K = 100


class SearchEngine:
    # extra base results fetched when delta sub-indexes exist, so
    # superseded (updated-work) base hits can be masked without
    # starving the top-k merge
    DELTA_OVERFETCH = 16

    def __init__(self, index, ids, embedder, *, nprobe: int = 16,
                 hydrator: OpenAlexClient | None = None, deltas=(), mesh: Mesh | None = None):
        """``ids``: any indexable position->id map: an ``IdMap`` (lazy;
        the production path), a list, or a mapping; one with
        ``resolve(positions)`` is asked once per batch.

        ``deltas``: incremental-fill sub-indexes, OLDEST FIRST — each an
        (index, ids, id_set) triple. Search fans out over base + deltas
        and merges newest-wins: a hit is dropped when its id also lives
        in a NEWER delta, which holds the row's current embedding.

        ``mesh``: the indexes' mesh; with a process group every search is
        a collective section (module docstring). On the ranks other than
        0, ``ids``, ``embedder`` and the deltas' id maps are unused."""
        self.index = index
        self.ids = ids
        self.embedder = embedder
        self.nprobe = nprobe
        self.hydrator = hydrator
        self.mesh = mesh
        self._publish_deltas(deltas)
        # lazily-built executor for the base+delta fan-out
        self._pool = None
        self._pool_lock = threading.Lock()
        # collective sections: one at a time, in rank 0's order
        self._lead_lock = threading.Lock()
        self._last_section = time.monotonic()
        self._stopped = False
        self.failed: BaseException | None = None
        # called once when a collective fails (run_server: shut down)
        self.on_failure = None

    @property
    def deltas(self):
        return list(self._delta_state[0])

    @deltas.setter
    def deltas(self, value) -> None:
        """Swapping the delta set also rebuilds the newest-wins masks.
        The (deltas, masks) pair is published as ONE atomically-assigned
        tuple and snapshotted once per search, so a swap on a live engine
        never pairs N sources with M masks. Assign a new list to mutate
        (``engine.deltas = [...]``); the getter returns a copy. Refused
        over a mesh: every rank must search the same sources."""
        if self._collective:
            raise RuntimeError("the delta set of an engine over a mesh is fixed when it "
                               "starts: restart every rank to change it")
        self._publish_deltas(value)

    def _publish_deltas(self, value) -> None:
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
        mesh: Mesh | None = None,
        fetcher=None,
        warmup: bool = True,
    ) -> "SearchEngine":
        """The engine a deployment serves, from an artifact directory:
        ``index/`` (at ``cfg.index_storage``, ``cfg.index_hot_bytes``),
        ``params.json`` (nprobe; 16 without it), ``ids.parquet`` and
        ``delta/*/{index,ids.parquet}``, and the query encoder
        (``get_embedder``) on the index's ``device``. Needs pyarrow.

        Over ``mesh`` (every rank calls this) each index loads this rank's
        lists; the id maps and hydration live on rank 0, the encoder too
        unless it is stella (every rank's part of it); rank 0's warm-up is
        the first collective section (the other ranks take it in
        ``follow()``)."""
        import pyarrow.parquet as pq

        from ..storage.idmap import IdMap

        index_dir = Path(index_dir)
        filled = index_dir / "index"
        if not filled.is_dir():
            raise FileNotFoundError(
                f"no filled index under {index_dir} (run `astpu index fill` / `astpu all`)")
        leader = mesh is None or mesh.rank == 0
        t0 = time.perf_counter()
        index = IVFPQIndex.load(filled, device=device, mesh=mesh, storage=cfg.index_storage,
                                hot_budget_bytes=cfg.index_hot_bytes)
        load_s = time.perf_counter() - t0

        params_path = index_dir / "params.json"
        nprobe = 16
        if params_path.exists():
            nprobe = int(read_params(params_path)["nprobe"])

        # lazy map: 207M id strings as a Python list are ~15-25 GB of RSS
        ids = IdMap(index_dir / "ids.parquet") if leader else None

        # incremental-fill delta sub-indexes: small, so device storage and
        # an in-RAM id set per delta
        deltas = []
        delta_root = index_dir / "delta"
        if delta_root.is_dir():
            for ddir in sorted(delta_root.iterdir()):
                if not (ddir / "index" / "meta.json").exists():
                    continue
                didx = IVFPQIndex.load(ddir / "index", device=device, mesh=mesh)
                if leader:
                    dmap = IdMap(ddir / "ids.parquet")
                    dset = set(pq.read_table(ddir / "ids.parquet").column(0).to_pylist())
                else:
                    dmap, dset = None, set()
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

        emb = get_embedder(embedder, cfg, device=index.device, mesh=mesh)
        hyd = OpenAlexClient(fetcher) if hydrate and leader else None
        logger.info("engine: %d vectors, nprobe=%d, dim=%d, storage=%s; rank %d of %d, "
                    "%.2f GiB of codes on %s, loaded in %.1f s", index.n, nprobe, index.dim,
                    index.storage, index.mesh.rank, index.mesh.size,
                    index.resident_bytes / 2**30, index.device, load_s)
        engine = cls(index, ids, emb, nprobe=nprobe, hydrator=hyd, deltas=deltas, mesh=mesh)
        if warmup and leader:
            engine.warmup()
        return engine

    def warmup(self, k: int = 10) -> None:
        """Run the single-query path once at startup (allocator and
        cuBLAS set-up). Logs and continues on failure, as the JAX engine
        does; kernel faults surface earlier, at ``IVFPQIndex.load``. Over
        a mesh the warm-up runs the collective sections, and a failed one
        raises: the ranks are out of step."""
        t0 = time.perf_counter()
        try:
            self._search_ids(self.encode_queries(["warmup"]), k)
            logger.info("warmup: %.2fs", time.perf_counter() - t0)
        except Exception:  # noqa: BLE001 — warmup must never kill startup
            if self._collective:
                raise
            logger.exception("warmup failed (serving continues)")

    # -- the collective sections over a mesh ---------------------------------------

    @property
    def _collective(self) -> bool:
        return self.mesh is not None and self.mesh.collective

    @property
    def _collective_encoder(self) -> bool:
        return self._collective and getattr(self.embedder, "collective", False)

    def _source_ks(self, n_sources: int, k: int) -> list[int]:
        """The k of each source: every source whose hits a NEWER delta can
        mask is overfetched so the post-mask pool stays >= k; the newest
        source needs none."""
        return [k + self.DELTA_OVERFETCH] * (n_sources - 1) + [k]

    def _check_k(self, k) -> None:
        """A malformed k raises ``ValueError`` (before any collective, and
        before a query is encoded). Only a collective engine caps k (at
        ``MAX_K``): one process serves any k, as the JAX engine does (its
        HTTP handler caps k itself)."""
        if isinstance(k, bool) or not isinstance(k, (int, np.integer)) or k < 1:
            raise ValueError(f"k={k!r}: an integer >= 1")
        if self._collective and k > MAX_K:
            raise ValueError(f"k={k!r}: an engine over a mesh takes k in [1, {MAX_K}]")

    def _check_request(self, q, k: int):
        """-> ``q`` as C-contiguous f32 [Q, D]; a malformed request raises
        ``ValueError`` here, before any collective (``_check_k``)."""
        self._check_k(k)
        q = np.ascontiguousarray(q, np.float32)
        if q.ndim != 2 or q.shape[0] < 1 or q.shape[1] != self.index.dim:
            raise ValueError(f"query vectors {q.shape}: need [Q >= 1, {self.index.dim}]")
        if not np.isfinite(q).all():
            raise ValueError("query vectors hold a non-finite value")
        return q

    def _search_sources(self, srcs, q, k: int, nprobe: int) -> list:
        """Every source's (scores, positions), base first, one after
        another: over a mesh each is a collective, in this order on every
        rank."""
        return [idx.search(q, min(ks, idx.n) if idx.n else 1, nprobe=nprobe)
                for idx, ks in zip(srcs, self._source_ks(len(srcs), k))]

    def _lead(self, head: list, body=None):
        """Rank 0: one collective section: the header, then ``body()``
        (the section's broadcasts and collective work) -> its result."""
        with self._lead_lock:
            if self.failed is not None:
                raise RuntimeError(f"a rank of the mesh failed: {self.failed}")
            if self._stopped:
                raise RuntimeError("the mesh's followers are stopped")
            try:
                broadcast(self.mesh, torch.tensor(head, dtype=torch.int64))
                self._stopped = head[0] == OP_STOP
                return None if body is None else body()
            except Exception as e:
                self.failed = e
                logger.error("collective section failed: %s", e)
                if self.on_failure is not None:
                    self.on_failure()
                raise
            finally:
                self._last_section = time.monotonic()

    def _lead_search(self, srcs, q, k: int):
        """Rank 0: a search section (the query vectors, then the search of
        each of ``srcs``) -> their hits."""
        def body():
            broadcast(self.mesh, torch.from_numpy(q))
            return self._search_sources(srcs, q, k, self.nprobe)

        return self._lead([OP_SEARCH, len(q), k, self.nprobe, self.index.dim, len(srcs)], body)

    def _encode_batches(self, pipe, n: int, plan=None) -> list:
        """Every rank of an encode section of ``n`` batches: their shapes,
        then each one's token ids and mask, from rank 0 (``plan``'s; the
        followers pass None), run through this rank's part of the
        encoder -> each batch's [bs, mrl_dim] vectors."""
        shapes = (torch.tensor([ids.shape for _, ids, _ in plan], dtype=torch.int64)
                  if plan is not None else torch.zeros((n, 2), dtype=torch.int64))
        out = []
        for i, (bs, t) in enumerate(broadcast(self.mesh, shapes).tolist()):
            both = (torch.from_numpy(np.stack(plan[i][1:])) if plan is not None
                    else torch.zeros((2, bs, t), dtype=torch.int64))
            both = broadcast(self.mesh, both).numpy()
            out.append(pipe.forward(both[0], both[1]))
        return out

    def _lead_encode(self, texts) -> np.ndarray:
        """Rank 0: an encode section over the mesh -> [n, mrl_dim] f32."""
        pipe = self.embedder.pipeline
        if not isinstance(texts, (list, tuple)) or not all(isinstance(t, str) for t in texts):
            raise ValueError("queries: a list of strings")
        out = np.zeros((len(texts), pipe.cfg.mrl_dim), np.float32)
        if not texts:
            return out
        plan = pipe.plan(texts, "s2p_query")
        embs = self._lead([OP_ENCODE, len(plan), 0, 0, pipe.cfg.mrl_dim, 0],
                          lambda: self._encode_batches(pipe, len(plan), plan))
        for (rows, _, _), e in zip(plan, embs):
            out[rows] = e[: len(rows)]
        return out

    def follow(self) -> None:
        """A follower rank's loop (ranks other than 0): take each
        collective section's header from rank 0 and run the same work in
        the same order (searches, or this rank's part of an encode), until
        rank 0's stop op. A failed collective, or a header whose dimension
        or source count differs from this rank's, raises."""
        d = self.index.dim
        srcs = [self.index] + [dd[0] for dd in self._delta_state[0]]
        while True:
            head = broadcast(self.mesh, torch.zeros(6, dtype=torch.int64)).tolist()
            op, qn, k, nprobe, hd, n_src = head
            if op == OP_STOP:
                return
            if op == OP_SEARCH:
                if (hd, n_src) != (d, len(srcs)):
                    raise RuntimeError(f"rank 0 searches {n_src} source(s) of dimension {hd}, "
                                       f"this rank {len(srcs)} of dimension {d}")
                q = broadcast(self.mesh, torch.empty((qn, d), dtype=torch.float32)).numpy()
                self._search_sources(srcs, q, k, nprobe)
            elif op == OP_ENCODE:
                if not self._collective_encoder or self.embedder.pipeline.cfg.mrl_dim != hd:
                    raise RuntimeError(f"rank 0 encodes over the mesh to dimension {hd}; this "
                                       f"rank holds no part of that encoder")
                self._encode_batches(self.embedder.pipeline, qn)

    def stop_followers(self) -> None:
        """Rank 0: end the followers' loops (once; nothing to do without
        a group or after a failure)."""
        if not self._collective or self.failed is not None or self._stopped:
            return
        self._lead([OP_STOP, 0, 0, 0, 0, 0])

    def keep_followers_alive(self, stop: threading.Event, interval_s: float) -> None:
        """Rank 0, on a thread: a ping section whenever none ran for
        ``interval_s``, so an idle follower's wait stays inside the
        collective timeout and a lost rank shows while idle too."""
        while not stop.wait(interval_s):
            if time.monotonic() - self._last_section < interval_s:
                continue
            try:
                self._lead([OP_PING, 0, 0, 0, 0, 0])
            except Exception:  # noqa: BLE001 — recorded in self.failed; on_failure ran
                return

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
        return self._named_rows(ids, scores, pos)

    def _named_rows(self, ids, scores, pos):
        rows = [
            [(float(s), int(p)) for s, p in zip(scores[qi], pos[qi]) if p >= 0]
            for qi in range(len(scores))
        ]
        names = iter(self._resolve_with(ids, [p for row in rows for _, p in row]))
        return [[(s, next(names)) for s, _ in row] for row in rows]

    def _search_ids(self, q, k: int) -> list[list[tuple[float, str]]]:
        """Fan out over base + delta sub-indexes and merge newest-wins:
        per query, a list of (score, id) of length <= k, score-sorted.
        Without deltas this is exactly the base search + id resolve."""
        q = self._check_request(q, k)
        deltas, newer_sets = self._delta_state   # ONE snapshot per search
        sources = [(self.index, self.ids)] + [(d[0], d[1]) for d in deltas]
        kk = self._source_ks(len(sources), k)
        if self._collective:
            hits = self._lead_search([idx for idx, _ in sources], q, k)
            per_source = [self._named_rows(ids, *h) for (_, ids), h in zip(sources, hits)]
        elif len(sources) == 1:
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
        self._check_k(k)
        q = self.encode_queries([query])
        with trace.span("engine.search", queries=1):
            results = [{"id": n, "score": s} for s, n in self._search_ids(q, k)[0]]
        self.hydrate_rows([results])
        return results

    def search_batch(self, queries: list[str], k: int = 10) -> list[list[dict]]:
        self._check_k(k)
        return self.search_batch_encoded(self.encode_queries(queries), k)

    def encode_queries(self, queries: list[str]):
        """Encoder-only half of the batched path: an encode section over
        the mesh when the encoder spans it, else rank 0's own."""
        if self._collective_encoder:
            return self._lead_encode(queries)
        return self.embedder.queries(queries)

    def search_batch_encoded(self, q, k: int = 10) -> list[list[dict]]:
        """Search half over already-encoded query vectors."""
        with trace.span("engine.search", queries=len(q)):
            return [[{"id": n, "score": s} for s, n in row] for row in self._search_ids(q, k)]
