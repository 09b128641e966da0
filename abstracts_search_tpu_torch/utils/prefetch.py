"""Bounded-queue iterator prefetch.

A producer thread pulls from the source iterator into a bounded queue
while the consumer (work on the card) drains it, so host reads hide
behind the card's work without unbounded RAM growth. The index fill
pulls its (vectors, positions) chunks through it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_DONE = object()


class _Raised:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch_iterator(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Yield from ``it``, producing up to ``depth`` items ahead in a
    background thread. Exceptions in the producer re-raise at the
    consumer's next pull."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))

    def produce():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 — forwarded to consumer
            q.put(_Raised(e))
            return
        q.put(_DONE)

    t = threading.Thread(target=produce, daemon=True, name="astpu-prefetch")
    t.start()
    while True:
        item = q.get()
        if item is _DONE:
            return
        if isinstance(item, _Raised):
            raise item.exc
        yield item
