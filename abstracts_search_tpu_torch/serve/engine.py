"""Search engine: the query path.

per query: encode -> IVF-PQ search on the card at the engine's nprobe
-> positions -> ids, merged newest-wins over any delta sub-indexes.

Building an engine from an artifact directory (``from_artifacts``: the
parquet id map, ``params.json``, delta discovery) and live OpenAlex
metadata hydration are still to be ported; construct the engine
directly.
"""

from __future__ import annotations

import logging
import threading
import time

logger = logging.getLogger(__name__)


class SearchEngine:
    # extra base results fetched when delta sub-indexes exist, so
    # superseded (updated-work) base hits can be masked without
    # starving the top-k merge
    DELTA_OVERFETCH = 16

    def __init__(self, index, ids, embedder, *, nprobe: int = 16, deltas=()):
        """``ids``: any indexable position->id map (a list, a numpy
        array, or a lazy mapping).

        ``deltas``: incremental-fill sub-indexes, OLDEST FIRST — each an
        (index, ids, id_set) triple. Search fans out over base + deltas
        and merges newest-wins: a hit is dropped when its id also lives
        in a NEWER delta, which holds the row's current embedding."""
        self.index = index
        self.ids = ids
        self.embedder = embedder
        self.nprobe = nprobe
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

    def _search_one_source(self, idx, ids, q, ks: int):
        scores, pos = idx.search(q, min(ks, idx.n) if idx.n else 1,
                                 nprobe=self.nprobe)
        rows = [
            [(float(s), int(p)) for s, p in zip(scores[qi], pos[qi]) if p >= 0]
            for qi in range(len(q))
        ]
        return [[(s, str(ids[p])) for s, p in row] for row in rows]

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

    def search(self, query: str, k: int = 10) -> list[dict]:
        q = self.embedder.queries([query])
        return [{"id": n, "score": s} for s, n in self._search_ids(q, k)[0]]

    def search_batch(self, queries: list[str], k: int = 10) -> list[list[dict]]:
        return self.search_batch_encoded(self.encode_queries(queries), k)

    def encode_queries(self, queries: list[str]):
        """Encoder-only half of the batched path."""
        return self.embedder.queries(queries)

    def search_batch_encoded(self, q, k: int = 10) -> list[list[dict]]:
        """Search half over already-encoded query vectors."""
        return [[{"id": n, "score": s} for s, n in row]
                for row in self._search_ids(q, k)]
