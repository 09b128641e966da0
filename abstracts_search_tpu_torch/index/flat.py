"""Exact flat inner-product index, on one card or row-sharded over a mesh.

``bench.py``'s configuration (``BASELINE.md`` config 1, exact flat search
over one 2,097,152-row shard) and the recall oracle for IVF/PQ tuning.
The corpus lives in one device tensor padded to ``chunk`` rows, in bf16
on the card (half the bytes of f32 at equal recall for unit vectors) and
f32 on the CPU. Search is the streaming top-k (exact mode) over the
corpus, then ``merge_topk`` over its one part. Over a mesh
(``parallel/mesh.py``) rank ``r`` keeps the ``r``-th block of rows (the
JAX package's padded row sharding, ``shard_rows``), runs the top-k over
its rows, offsets them to corpus rows, and one all-gather merges the
ranks' lists (``merge_topk_all_gather``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import assert_exact_f32
from ..ops.topk import streaming_topk
from ..parallel.mesh import Mesh, index_mesh, shard_rows
from ..parallel.topk_merge import merge_topk, merge_topk_all_gather
from ..utils import trace


class FlatIndex:
    """Exact IP search over a corpus resident on one device, or on each
    rank of a mesh its block of rows."""

    def __init__(self, chunk: int = 1024, dtype=None, impl: str = "auto", device=None,
                 mesh: Mesh | None = None):
        self.mesh = index_mesh(mesh, device)
        self.device = self.mesh.device
        self.chunk = chunk
        self.impl = impl
        if dtype is None:
            dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.dtype = dtype
        self.n = 0
        self._x: torch.Tensor | None = None    # [round_up(rows, chunk), D], zero tail
        self._lo = self._rows = 0              # this rank's corpus rows [lo, lo + rows)

    @property
    def dim(self) -> int | None:
        return None if self._x is None else self._x.shape[1]

    def add(self, vectors) -> None:
        """Append rows (a numpy array or a tensor on any device). Over a
        mesh of several ranks every rank passes the whole corpus, once;
        each keeps its own block."""
        v = torch.as_tensor(vectors)
        if v.dim() != 2 or (self._x is not None and v.shape[1] != self.dim):
            raise ValueError(f"vectors {tuple(v.shape)} do not fit dim {self.dim}")
        if self.mesh.size > 1 and self._x is not None:
            raise ValueError("a sharded FlatIndex takes its corpus in one add()")
        # one rank appends to the rows it holds (self._rows == self.n);
        # over several, the one add keeps rows [lo, hi) of v
        n = self.n + v.shape[0]
        lo, hi, per = shard_rows(n, self.mesh, self.chunk)
        buf = torch.zeros((per, v.shape[1]), dtype=self.dtype, device=self.device)
        if self._x is not None:
            buf[: self._rows] = self._x[: self._rows]
        buf[self._rows: hi - lo] = v[lo + self._rows - self.n: hi - self.n].to(self.device).to(
            self.dtype)
        self._x, self.n, self._lo, self._rows = buf, n, lo, hi - lo

    def search(self, queries, k: int):
        """-> (scores [Q, k] f32, positions [Q, k] int64) as numpy arrays.
        Positions index the corpus in insertion order. Over a mesh this
        is a collective: every rank calls it with the same queries."""
        if self._x is None:
            raise RuntimeError("index is empty")
        assert_exact_f32()
        with trace.span("flat.search", queries=len(queries)):
            with trace.span("flat.upload"):
                q = torch.from_numpy(np.asarray(queries, np.float32)).to(self.device)
            with torch.inference_mode():
                v, i = streaming_topk(q.to(self.dtype), self._x, self._rows, k, chunk=self.chunk,
                                      impl=self.impl)
                with trace.span("flat.merge"):
                    if self.mesh.collective:
                        v, i, _ = merge_topk_all_gather(v, i.long() + self._lo, k, self.mesh)
                    else:
                        v, i = merge_topk(v[None], i[None], k)
            with trace.span("flat.winners"):
                return v.cpu().numpy(), i.cpu().numpy().astype(np.int64)
