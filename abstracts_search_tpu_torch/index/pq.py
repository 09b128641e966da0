"""Product quantizer: per-subspace codebooks, trained on the card.

The port of the JAX package's ``index/pq.py``. The vector space is split
into M subspaces of dsub dims; each gets a ksub = 2^nbits codebook; a
vector is stored as M codes (nibble-packed when nbits is 4).

All M subspace k-means run as one batched Lloyd iteration: scores by
one batched matmul [n, M, dsub] x [M, ksub, dsub], assignment by
``argmin(||c||^2 - 2 x.c)`` in f32 (on ties the first index wins, as
``torch.argmin`` and ``jnp.argmin`` both document), centroid sums by an
f32 segment sum over (subspace, code). The [n, M, ksub] score block is
bounded by windowing rows (``SCORE_BYTES``). Random draws (init rows,
empty-code reseeds) come from ``np.random.default_rng(seed)`` in the JAX
package's order.

Over a mesh (``mesh=``) every rank passes the whole sample and draws the
same numbers; rank ``r`` assigns and sums its block of rows (whole
windows, the units one process sums; each window's f32 sums added in
f64), and each iteration's sums, counts and error are summed over the
ranks in rank order (``sum_in_rank_order``), so every rank ends with the
same codebooks, bit for bit, and at one window a rank one process's.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..parallel.mesh import Mesh, index_mesh, shard_rows, sum_in_rank_order
from .kmeans import segment_sum

logger = logging.getLogger(__name__)


class ProductQuantizer:
    # bytes of one window's [n, M, ksub] f32 score block; the subtraction
    # beside it takes as much again
    SCORE_BYTES = 1 << 30
    # bytes of training rows staged on the card by ``train``
    DEVICE_BUDGET_BYTES = 4 << 30

    def __init__(
        self,
        dim: int,
        m: int = 64,
        nbits: int = 8,
        *,
        seed: int = 0,
        device=None,
        mesh: Mesh | None = None,
    ):
        if dim % m != 0:
            raise ValueError(f"dim {dim} not divisible by M {m}")
        if nbits > 8:
            raise ValueError("nbits > 8 not supported (codes are uint8)")
        self.dim = dim
        self.m = m
        self.nbits = nbits
        self.ksub = 1 << nbits
        self.dsub = dim // m
        self.seed = seed
        self.mesh = index_mesh(mesh, device)
        self.device = self.mesh.device
        self.centroids: np.ndarray | None = None  # [M, ksub, dsub]
        self.stats: dict = {}

    @property
    def is_trained(self) -> bool:
        return self.centroids is not None

    def block(self, n: int, unit: int | None = None) -> tuple[int, int]:
        """This rank's rows ``[lo, hi)`` of an ``n``-row sample, in whole
        ``unit``-row windows (by default the assignment's)."""
        lo, hi, _ = shard_rows(n, self.mesh, unit or self.window_rows())
        return lo, hi

    # -- on the card ---------------------------------------------------------------

    def window_rows(self) -> int:
        """Rows per assignment window: the score block within SCORE_BYTES."""
        return max(1, self.SCORE_BYTES // (self.m * self.ksub * 4))

    def assign(self, x3: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """x3 [n, M, dsub] f32, c [M, ksub, dsub] f32 -> codes [n, M] i64:
        ``argmin ||x - c||^2 == argmin ||c||^2 - 2 x.c`` per subspace."""
        c2 = torch.sum(c * c, dim=-1)                             # [M, ksub]
        out = torch.empty(x3.shape[:2], dtype=torch.int64, device=x3.device)
        w = self.window_rows()
        for lo in range(0, x3.shape[0], w):
            dots = torch.einsum("nmd,mkd->nmk", x3[lo:lo + w], c)
            out[lo:lo + w] = torch.argmin(c2[None] - 2.0 * dots, dim=-1)
        return out

    def reconstruct(self, codes: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """codes [n, M] -> [n, M, dsub] codewords."""
        return c[torch.arange(self.m, device=c.device)[None, :], codes]

    def _train_step(self, x3: torch.Tensor, c: torch.Tensor):
        """One batch of Lloyd: -> (sums [M, ksub, dsub], counts [M, ksub]
        i64, squared error), each window's f32 sums added in f64."""
        m, ksub, dsub = self.m, self.ksub, self.dsub
        sums = torch.zeros((m * ksub, dsub), dtype=torch.float64, device=x3.device)
        counts = torch.zeros(m * ksub, dtype=torch.int64, device=x3.device)
        err = torch.zeros((), dtype=torch.float64, device=x3.device)
        base = torch.arange(m, device=x3.device) * ksub
        w = self.window_rows()
        for lo in range(0, x3.shape[0], w):
            xw = x3[lo:lo + w]
            codes = self.assign(xw, c)
            flat = (codes + base[None, :]).reshape(-1)
            sums += segment_sum(xw.reshape(-1, dsub), flat, m * ksub)
            counts += torch.bincount(flat, minlength=m * ksub)
            err += torch.sum(torch.square(xw - self.reconstruct(codes, c)))
        return sums.view(m, ksub, dsub), counts.view(m, ksub), err

    # -- API ---------------------------------------------------------------------------

    def _subspaced(self, x: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(
            np.asarray(x, np.float32).reshape(len(x), self.m, self.dsub))

    def train(self, x: np.ndarray, *, iters: int = 12, tol: float = 1e-5,
              batch_rows: int = 1 << 18) -> np.ndarray:
        """Train on host rows ``x`` [n, dim]: staged on the card once when
        they fit DEVICE_BUDGET_BYTES, else uploaded batch by batch every
        iteration."""
        x = self._subspaced(x)
        n = len(x)
        if n < self.ksub:
            raise ValueError(f"need >= ksub={self.ksub} rows, got {n}")
        lo, hi = self.block(n, batch_rows)
        spans = [(w, min(w + batch_rows, hi)) for w in range(lo, hi, batch_rows)]

        def upload(lo, hi):
            return torch.from_numpy(x[lo:hi]).to(self.device)

        staged = ([upload(*sp) for sp in spans] if x.nbytes <= self.DEVICE_BUDGET_BYTES
                  else None)

        def batches():
            if staged is not None:
                yield from staged
            else:
                for sp in spans:
                    yield upload(*sp)

        def fetch_rows(idx: np.ndarray) -> np.ndarray:
            return x[idx]

        return self._lloyd(batches, n, fetch_rows, iters=iters, tol=tol)

    def train_staged(self, x3: torch.Tensor, n: int | None = None, *, iters: int = 12,
                     tol: float = 1e-5) -> np.ndarray:
        """Train on a sample already on the card: ``x3`` [total, M, dsub]
        f32, of which the first ``n`` rows (all by default) train.
        Nothing sample-sized crosses to the host: only per-iteration sums
        and the rows for init and reseeds. OPQ's inner loop and the
        residual training take this path. Over a mesh every rank holds
        the whole sample and sums its block."""
        n = x3.shape[0] if n is None else n
        if n < self.ksub:
            raise ValueError(f"need >= ksub={self.ksub} rows, got {n}")
        x3 = x3[:n]
        lo, hi = self.block(n)

        def fetch_rows(idx: np.ndarray) -> np.ndarray:
            # gather on the card, download only the requested rows
            return x3[torch.from_numpy(np.sort(idx)).to(x3.device)].cpu().numpy()

        return self._lloyd(lambda: iter((x3[lo:hi],)), n, fetch_rows, iters=iters, tol=tol)

    def _lloyd(self, batches, n, fetch_rows, *, iters, tol) -> np.ndarray:
        """Shared batched-subspace Lloyd loop over ``batches()`` (device
        [b, M, dsub] blocks of this rank's rows, re-read each iteration);
        ``fetch_rows(idx) -> [len(idx), M, dsub]`` supplies rows for init
        and empty-code reseeds. Per-batch f32 sums accumulate in f64,
        then sum over the mesh."""
        rng = np.random.default_rng(self.seed)
        init = rng.choice(n, size=self.ksub, replace=False)
        c = np.transpose(
            np.asarray(fetch_rows(np.sort(init)), np.float32), (1, 0, 2)
        ).copy()  # [M, ksub, dsub]

        errs = []
        prev = None
        for it in range(iters):
            cj = torch.from_numpy(c).to(self.device)
            sums = torch.zeros((self.m, self.ksub, self.dsub), dtype=torch.float64,
                               device=self.device)
            counts = torch.zeros((self.m, self.ksub), dtype=torch.int64, device=self.device)
            err = 0.0
            for xb in batches():
                s, cnt, e = self._train_step(xb, cj)
                sums += s.double()
                counts += cnt
                err += float(e)
            if self.mesh.collective:
                sums, counts, err_t = (sum_in_rank_order(self.mesh, t) for t in
                                       (sums, counts, torch.tensor(err, dtype=torch.float64)))
                err = float(err_t)
            sums = sums.cpu().numpy()
            counts = counts.cpu().numpy().astype(np.float64)
            mse = err / (n * self.dim)
            errs.append(mse)

            newc = np.where(
                counts[..., None] > 0, sums / np.maximum(counts[..., None], 1), c
            ).astype(np.float32)
            # empty codes: reseed from random training rows (per subspace)
            empties = {mi: np.flatnonzero(counts[mi] == 0) for mi in range(self.m)}
            n_empty = sum(len(v) for v in empties.values())
            if n_empty:
                seeds = np.asarray(
                    fetch_rows(rng.integers(0, n, n_empty)), np.float32)
                off = 0
                for mi, empty in empties.items():
                    if len(empty):
                        newc[mi, empty] = seeds[off : off + len(empty), mi]
                        off += len(empty)
            c = newc
            logger.info("pq train iter %d: mse=%.6g", it, mse)
            if prev is not None and abs(prev - mse) < tol * max(prev, 1e-12):
                break
            prev = mse

        self.centroids = c
        self.stats = {"m": self.m, "ksub": self.ksub, "n_train": n, "mse": errs}
        return c

    def encode(self, x: np.ndarray, *, batch_rows: int = 1 << 18) -> np.ndarray:
        """x [N, dim] -> codes [N, M] uint8 (streamed through the card)."""
        if not self.is_trained:
            raise RuntimeError("train() first")
        xs = self._subspaced(x)
        cj = torch.from_numpy(self.centroids).to(self.device)
        out = np.empty((len(xs), self.m), np.uint8)
        for lo in range(0, len(xs), batch_rows):
            xb = torch.from_numpy(xs[lo:lo + batch_rows]).to(self.device)
            out[lo:lo + len(xb)] = self.assign(xb, cj).to(torch.uint8).cpu().numpy()
        return out

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """codes [N, M] (or nibble-packed [N, M/2] — the 4-bit storage
        format: byte j = subspace 2j low nibble, 2j+1 high) -> approx
        vectors [N, dim]."""
        codes = np.asarray(codes)
        if self.nbits == 4 and codes.shape[-1] == self.m // 2:
            codes = np.stack([codes & 0xF, codes >> 4], axis=-1
                             ).reshape(len(codes), self.m)
        c = self.centroids  # [M, ksub, dsub]
        out = c[np.arange(self.m)[None, :], codes.astype(np.int64)]  # [N, M, dsub]
        return out.reshape(len(codes), self.dim)

    def reconstruction_mse(self, x: np.ndarray) -> float:
        return float(np.mean(np.square(x - self.decode(self.encode(x)))))
