"""Dynamic micro-batching for the HTTP serving path.

Each single-query request costs a whole probe + scan + host copy; a
batch of queries shares the probe's centroid read and the kernels'
launches. A short gather window folds concurrent requests into ONE
batched search, adding at most ``window_s`` of latency (default 5 ms).

``workers`` gather/dispatch threads run concurrently. A gather mutex
lets only one worker soak the window at a time, so folding is exactly
the single-worker behaviour; the search runs outside the mutex, so one
batch's host work (encoding, id resolution) overlaps another's device
work.

The JAX package pads each batch to a power of two so its compiled
program shapes stay few; PyTorch runs eagerly, so batches go to the
engine at their real size.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future

logger = logging.getLogger(__name__)


class MicroBatcher:
    """Folds concurrent `search(query, k)` calls into batched engine
    searches. Thread-safe; requests block until their batch returns."""

    def __init__(self, engine, *, max_batch: int = 64,
                 window_s: float = 0.005, workers: int = 4):
        self.engine = engine
        self.max_batch = max_batch
        self.window_s = window_s
        self.stats = {"requests": 0, "batches": 0, "max_batch_seen": 0}
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._gather_lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._loop,
                             name=f"astpu-microbatch-{i}", daemon=True)
            for i in range(max(1, workers))
        ]
        for t in self._threads:
            t.start()

    def search(self, query: str, k: int = 10):
        fut: Future = Future()
        # the closed check and the enqueue are one atomic step: without
        # the lock a request could slip in behind the shutdown sentinel
        # and block forever on a future nobody will complete
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher closed")
            self._q.put((query, k, fut))
        return fut.result()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)  # workers re-post it for each other
        for t in self._threads:
            t.join(timeout=5)
        # fail anything that was queued behind the sentinel
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[2].set_exception(RuntimeError("batcher closed"))

    # -- worker -----------------------------------------------------------------

    def _gather(self):
        """Block for the first request, then soak the window."""
        first = self._q.get()
        if first is None:
            self._q.put(None)  # propagate shutdown to sibling workers
            return None
        batch = [first]
        deadline = time.monotonic() + self.window_s
        while len(batch) < self.max_batch:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                item = self._q.get(timeout=left)
            except queue.Empty:
                break
            if item is None:
                self._q.put(None)  # re-post the shutdown sentinel
                break
            batch.append(item)
        return batch

    def _loop(self) -> None:
        while True:
            with self._gather_lock:
                batch = self._gather()
            if batch is None:
                return
            texts = [t for t, _, _ in batch]
            kmax = max(k for _, k, _ in batch)
            try:
                q = self.engine.encode_queries(texts)
                rows = self.engine.search_batch_encoded(q, k=kmax)
            except Exception as exc:  # noqa: BLE001 — deliver to callers
                for _, _, fut in batch:
                    fut.set_exception(exc)
                continue
            with self._stats_lock:
                self.stats["requests"] += len(batch)
                self.stats["batches"] += 1
                self.stats["max_batch_seen"] = max(
                    self.stats["max_batch_seen"], len(batch))
            for (_, k, fut), row in zip(batch, rows):
                fut.set_result(row[:k])
