"""Exact flat inner-product index on one card.

``bench.py``'s configuration (``BASELINE.md`` config 1, exact flat search
over one 2,097,152-row shard) and the recall oracle for IVF/PQ tuning.
The corpus lives in one device tensor padded to ``chunk`` rows, in bf16
on the card (half the bytes of f32 at equal recall for unit vectors) and
f32 on the CPU. Search is the streaming top-k (exact mode) over the
corpus, then ``merge_topk`` over its one part; the JAX package shards the
corpus over a mesh and merges the devices' results with an all-gather.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import assert_exact_f32, resolve_device
from ..ops.topk import streaming_topk
from ..parallel.topk_merge import merge_topk


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


class FlatIndex:
    """Exact IP search over a corpus resident on one device."""

    def __init__(self, chunk: int = 1024, dtype=None, impl: str = "auto", device=None):
        self.device = resolve_device(device)
        self.chunk = chunk
        self.impl = impl
        if dtype is None:
            dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.dtype = dtype
        self.n = 0
        self._x: torch.Tensor | None = None    # [round_up(n, chunk), D], zero tail

    @property
    def dim(self) -> int | None:
        return None if self._x is None else self._x.shape[1]

    def add(self, vectors) -> None:
        """Append rows (a numpy array or a tensor on any device)."""
        v = torch.as_tensor(vectors)
        if v.dim() != 2 or (self._x is not None and v.shape[1] != self.dim):
            raise ValueError(f"vectors {tuple(v.shape)} do not fit dim {self.dim}")
        n = self.n + v.shape[0]
        buf = torch.zeros((_round_up(n, self.chunk), v.shape[1]), dtype=self.dtype,
                          device=self.device)
        if self._x is not None:
            buf[: self.n] = self._x[: self.n]
        buf[self.n: n] = v.to(self.device).to(self.dtype)
        self._x, self.n = buf, n

    def search(self, queries, k: int):
        """-> (scores [Q, k] f32, positions [Q, k] int64) as numpy arrays.
        Positions index the corpus in insertion order."""
        if self._x is None:
            raise RuntimeError("index is empty")
        assert_exact_f32()
        q = torch.from_numpy(np.asarray(queries, np.float32)).to(self.device)
        with torch.inference_mode():
            v, i = streaming_topk(q.to(self.dtype), self._x, self.n, k, chunk=self.chunk,
                                  impl=self.impl)
            v, i = merge_topk(v[None], i[None], k)
        return v.cpu().numpy(), i.cpu().numpy().astype(np.int64)
