"""Spherical or plain-L2 k-means — the IVF coarse quantizer trainer.

The port of the JAX package's ``index/kmeans.py``: spherical k-means
(``-N``: rows and centroids on the unit sphere, assignment by max inner
product) over a training sample of ~10M rows at production scale, or
true Lloyd's-L2.

On the card:

- assignment is the streaming top-k kernel at k 1 (``ops/topk.py``,
  kernel 1): a tiled [rows, K] score matmul with a running argmax that
  never holds the rows x 65,536 scores. Every call goes through
  ``streaming_topk(..., k=1, chunk=self.chunk, impl=self.impl)`` on
  windows of at most ``batch_rows`` rows, against the centroids padded
  to a multiple of ``chunk`` with ``n_valid = k``;
- centroid sums are f32 segment sums (a stable sort by assignment, then
  each run reduced in order: ``segment_sum``), so two runs from one seed
  give bit-identical centroids. The JAX package sums by one-hot
  matmuls because a TPU handles scatters badly; a one-hot SGEMM over
  65,536 lists would cost ~1.4e15 f32 operations an iteration here;
- the centroid update and the empty-cluster split run on the host for
  in-RAM and staged samples, and on the card for device-streamed
  sources (where only [k] counts and two scalars reach the host an
  iteration). The host draws every random number (init rows, split
  jitter) from ``np.random.default_rng(seed)`` in the JAX package's
  order, so one seed gives both packages the same init and repairs.
"""

from __future__ import annotations

import logging
from typing import Iterable

import numpy as np
import torch

from ..device import resolve_device
from ..ops.topk import streaming_topk

logger = logging.getLogger(__name__)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _normalize_rows(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(n, 1e-12)


def _normalize_rows_t(x: torch.Tensor) -> torch.Tensor:
    """The same formula on the card, for rows that live there."""
    return x / torch.linalg.norm(x, dim=1, keepdim=True).clamp_min(1e-12)


def _l2_augment(x: torch.Tensor, c: torch.Tensor):
    """Bias augmentation making max-IP selection equal min-L2:
    ``argmin_j ||x - c_j||^2 == argmax_j (x . c_j - ||c_j||^2 / 2)``.

    Appends a ones column to ``x`` and a ``-||c||^2/2`` column to ``c``
    (both zero-padded to a 128-column multiple, as the JAX package pads
    them), which routes plain-L2 assignment through the same top-k
    kernel as the spherical path. Returned scores are
    ``x.c - ||c||^2/2 = (||x||^2 - ||x - c||^2)/2`` — per-row monotone
    in negative distance."""
    d = x.shape[-1]
    pad = _round_up(d + 1, 128) - d
    xa = torch.cat([x, torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device),
                    torch.zeros(x.shape[:-1] + (pad - 1,), dtype=x.dtype, device=x.device)],
                   dim=-1)
    cf = c.float()
    bias = -0.5 * torch.sum(cf * cf, dim=-1, keepdim=True)
    ca = torch.cat([cf, bias, torch.zeros((c.shape[0], pad - 1), dtype=torch.float32,
                                          device=c.device)], dim=-1)
    return xa, ca


def _assign_operands(x: torch.Tensor, c: torch.Tensor, spherical: bool):
    """Operands of the assignment top-k — the one place the metric's
    dtype rule lives.

    Spherical rides bf16: unit-norm scores in [-1, 1] keep the
    quantization step ~2^-9, and bf16 operands take the kernel's
    tensor-core route. Plain-L2 augments (``_l2_augment``) and must stay
    f32: the ``-||c||^2/2`` bias has magnitude ~||c||^2/2, so a bf16 step
    can exceed inter-centroid score gaps on high-norm data. f32 operands
    take the kernel's FMA route, in true f32 (TF32 stays off)."""
    if spherical:
        return x.to(torch.bfloat16), c.to(torch.bfloat16)
    xa, ca = _l2_augment(x, c)
    return xa.float(), ca.float()


def segment_sum(values: torch.Tensor, seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    """f32 sums of ``values`` [n, d] by segment id ``seg`` [n] into
    [n_seg, d], deterministic on every device: a stable sort by segment
    id, then each segment's rows reduced in order (``segment_reduce``
    has no atomics; an atomic scatter-add would sum in launch order)."""
    order = torch.argsort(seg, stable=True)
    lengths = torch.bincount(seg, minlength=n_seg)
    return torch.segment_reduce(values.float()[order], "sum", lengths=lengths, axis=0,
                                unsafe=True)


class KMeans:
    """Spherical (``-N``) or plain-L2 k-means on one device.

    ``spherical=False`` is true Lloyd's-L2: assignment runs
    argmax(x.c - ||c||^2/2) == argmin ||x - c||^2 through the same top-k
    kernel via :func:`_l2_augment`, and centroid updates are
    unnormalized means. The reported per-iteration ``objective`` is then
    the mean biased score ``(||x||^2 - ||x - c||^2)/2``."""

    # bytes of training rows staged on the card by ``fit``; larger
    # samples stream from their source (host RAM or memmap) every
    # iteration
    DEVICE_BUDGET_BYTES = 4 << 30
    # empty clusters repaired per device-streamed iteration at most
    SPLIT_SLAB = 4096

    def __init__(
        self,
        k: int,
        *,
        spherical: bool = True,
        chunk: int = 1024,
        impl: str = "auto",
        seed: int = 0,
        device=None,
    ):
        self.k = k
        self.spherical = spherical
        self.chunk = chunk
        self.impl = impl
        self.seed = seed
        self.device = resolve_device(device)
        self.centroids: np.ndarray | None = None
        self.stats: dict = {}

    # -- one window ------------------------------------------------------------

    def _centroids_padded(self) -> torch.Tensor:
        """[round_up(k, chunk), D] f32 on the device; rows past k are
        zero and never win: the top-k masks rows >= n_valid = k."""
        k_pad = _round_up(self.k, self.chunk)
        c = torch.zeros((k_pad, self.centroids.shape[1]), dtype=torch.float32,
                        device=self.device)
        c[: self.k] = torch.from_numpy(np.asarray(self.centroids, np.float32)).to(self.device)
        return c

    def _top1(self, x: torch.Tensor, c_pad: torch.Tensor):
        """Kernel 1 at k 1 over one window -> (scores [n] f32, ids [n] i64)."""
        xq, cq = _assign_operands(x, c_pad, self.spherical)
        v, idx = streaming_topk(xq, cq, self.k, 1, chunk=self.chunk, impl=self.impl)
        return v[:, 0], idx[:, 0].long()

    def _step(self, x: torch.Tensor, c_pad: torch.Tensor):
        """One window of Lloyd: -> (f32 sums [k, D], counts [k] i64,
        score sum f32)."""
        v, a = self._top1(x, c_pad)
        return segment_sum(x, a, self.k), torch.bincount(a, minlength=self.k), v.sum()

    def _lloyd_update(self, sums: np.ndarray, counts: np.ndarray, rng) -> tuple[int, float]:
        """Host update from f64 sums and counts (the JAX package's
        ``fit``/``fit_staged`` tail): -> (empties split, delta)."""
        new_c = np.where(
            counts[:, None] > 0, sums / np.maximum(counts[:, None], 1), self.centroids
        ).astype(np.float32)
        if self.spherical:
            new_c = _normalize_rows(new_c)
        n_split = self._split_empty(new_c, counts, rng)
        delta = float(np.linalg.norm(new_c - self.centroids) / np.sqrt(self.k))
        self.centroids = new_c
        return n_split, delta

    def _run(self, windows, n_total: int, rng, *, iters: int, tol: float) -> np.ndarray:
        """Lloyd iterations over ``windows()`` (an iterable of device
        [b, D] row blocks, re-read each iteration); per-window f32 sums
        accumulate in f64, as the JAX package accumulates its per-window
        partials on the host."""
        dim = self.centroids.shape[1]
        objective_hist, split_hist = [], []
        for it in range(iters):
            c_pad = self._centroids_padded()
            sums = torch.zeros((self.k, dim), dtype=torch.float64, device=self.device)
            counts = torch.zeros(self.k, dtype=torch.int64, device=self.device)
            obj = 0.0
            for x in windows():
                s, cnt, o = self._step(x, c_pad)
                sums += s.double()
                counts += cnt
                obj += float(o)
            del c_pad
            n_split, delta = self._lloyd_update(
                sums.cpu().numpy(), counts.cpu().numpy().astype(np.float64), rng)
            split_hist.append(n_split)
            mean_obj = obj / n_total
            objective_hist.append(mean_obj)
            logger.info("kmeans iter %d: objective=%.6f empties_split=%d delta=%.2e",
                        it, mean_obj, n_split, delta)
            if delta < tol:
                break
        self.stats = {
            "k": self.k,
            "n_train": int(n_total),
            "iters_run": len(objective_hist),
            "objective": objective_hist,
            "empty_splits": split_hist,
            "spherical": self.spherical,
        }
        return self.centroids

    # -- device-streamed sources ---------------------------------------------------

    def _update_device(self, c_pad, sums, counts, e_dst, e_src, eps):
        """The Lloyd update and the empty-split application on the card
        (the JAX package's ``_build_update``): -> (next padded centroids,
        delta). ``e_src``/``e_dst``/``eps`` are the host's picks."""
        k = self.k
        c = c_pad[:k]
        new_c = torch.where(counts[:, None] > 0,
                            sums / counts.float().clamp_min(1.0)[:, None], c)
        if self.spherical:
            new_c = _normalize_rows_t(new_c)
        if len(e_dst):
            new_c[e_dst] = new_c[e_src] + eps
        if self.spherical:
            new_c = _normalize_rows_t(new_c)
        delta = torch.linalg.norm(new_c - c) / np.sqrt(k)
        out = torch.zeros_like(c_pad)
        out[:k] = new_c
        return out, delta

    def _fit_device_stream(self, src, *, iters: int, tol: float,
                           batch_rows: int = 1 << 18) -> np.ndarray:
        """Lloyd iterations over a chunked device source: chunks are
        (re)generated or (re)staged on the card every iteration
        (``src.device_chunk(j)``), accumulators and centroids stay
        there, and the host sees only [k] counts and two scalars an
        iteration. The production ``-c 65536`` x 10M-row training path.

        ``src`` has ``__len__``, ``shape``, ``chunk_rows``,
        ``num_chunks``, ``device_chunk(j)`` -> a [chunk_rows, D] f32
        tensor on this device, ``gather_rows(idx)`` -> numpy rows, and
        ``prenormalized``."""
        n = len(src)
        dim = src.shape[1]
        if n < self.k:
            raise ValueError(f"need >= k={self.k} training rows, got {n}")
        norm = self.spherical and not getattr(src, "prenormalized", False)

        rng = np.random.default_rng(self.seed)
        init_idx = np.sort(rng.choice(n, size=self.k, replace=False))
        init_rows = np.asarray(src.gather_rows(init_idx), np.float32)
        if norm or self.spherical:
            init_rows = _normalize_rows(init_rows)
        self.centroids = init_rows
        c_pad = self._centroids_padded()

        objective_hist, split_hist = [], []
        for it in range(iters):
            sums = torch.zeros((self.k, dim), dtype=torch.float32, device=self.device)
            counts = torch.zeros(self.k, dtype=torch.int64, device=self.device)
            obj = torch.zeros((), dtype=torch.float32, device=self.device)
            for j in range(src.num_chunks):
                x = src.device_chunk(j)
                for lo in range(0, x.shape[0], batch_rows):
                    s, cnt, o = self._step(x[lo:lo + batch_rows], c_pad)
                    sums += s
                    counts += cnt
                    obj += o
                del x
            counts_h = counts.cpu().numpy().astype(np.float64)

            # the host picks empty-split (dst, src) pairs from counts alone
            empty = np.flatnonzero(counts_h == 0)[: self.SPLIT_SLAB]
            order = np.argsort(-counts_h)
            e_src = np.array([order[j % max(1, len(order))] for j in range(len(empty))],
                             np.int64)
            eps = np.zeros((len(empty), dim), np.float32)
            if len(empty):
                # scale-aware jitter (see _split_empty), sized from the
                # source rows of the current centroids
                if self.spherical:
                    scales = np.full(len(empty), 0.1 + 1e-3, np.float32)
                else:
                    src_rows = c_pad[torch.from_numpy(e_src).to(self.device)].cpu().numpy()
                    scales = (0.1 * np.linalg.norm(src_rows, axis=1)
                              + 1e-3).astype(np.float32)
                for j in range(len(empty)):
                    eps[j] = scales[j] * rng.standard_normal(dim).astype(np.float32)
            split_hist.append(int(len(empty)))

            dev = self.device
            c_pad, delta = self._update_device(
                c_pad, sums, counts, torch.from_numpy(empty.astype(np.int64)).to(dev),
                torch.from_numpy(e_src).to(dev), torch.from_numpy(eps).to(dev))
            del sums
            mean_obj = float(obj) / n
            objective_hist.append(mean_obj)
            delta = float(delta)
            logger.info("kmeans iter %d: objective=%.6f empties_split=%d delta=%.2e "
                        "(device-streamed, %d chunks)", it, mean_obj, split_hist[-1],
                        delta, src.num_chunks)
            if delta < tol:
                break

        self.centroids = c_pad[: self.k].cpu().numpy()
        self.stats = {
            "k": self.k,
            "n_train": int(n),
            "iters_run": len(objective_hist),
            "objective": objective_hist,
            "empty_splits": split_hist,
            "spherical": self.spherical,
            "mode": "device_stream",
        }
        return self.centroids

    # -- API ------------------------------------------------------------------------

    def fit(
        self,
        data: np.ndarray | Iterable[np.ndarray],
        *,
        iters: int = 10,
        batch_rows: int = 1 << 18,
        tol: float = 1e-4,
        prenormalized: bool = False,
    ) -> np.ndarray:
        """Lloyd iterations over the training data.

        ``data``: an [N, D] array — possibly an np.memmap (the 10M-row
        production sample lives on disk) — an iterable of arrays, or a
        chunked device source (``device_chunk``: see
        ``_fit_device_stream``). Host data is consumed window by window:
        when the sample fits ``DEVICE_BUDGET_BYTES``, windows are staged
        on the card once; otherwise each iteration re-reads them from
        their source, so host RSS stays O(batch_rows). ``prenormalized``
        skips the per-window normalize for callers that wrote unit rows.
        """
        if hasattr(data, "device_chunk"):
            return self._fit_device_stream(data, iters=iters, tol=tol,
                                           batch_rows=batch_rows)
        sources = [data] if isinstance(data, np.ndarray) else list(data)
        n_total = sum(len(s) for s in sources)
        if n_total < self.k:
            raise ValueError(f"need >= k={self.k} training rows, got {n_total}")
        dim = sources[0].shape[1]
        norm = self.spherical and not prenormalized

        # init: random distinct rows, gathered per source — no
        # concatenation of the sample
        rng = np.random.default_rng(self.seed)
        init_idx = np.sort(rng.choice(n_total, size=self.k, replace=False))
        bounds = np.cumsum([0] + [len(s) for s in sources])
        init_rows = np.empty((self.k, dim), np.float32)
        for si, s in enumerate(sources):
            sel = init_idx[(init_idx >= bounds[si]) & (init_idx < bounds[si + 1])]
            take = np.asarray(s[sel - bounds[si]], np.float32)
            init_rows[np.searchsorted(init_idx, sel)] = take
        self.centroids = _normalize_rows(init_rows) if self.spherical else init_rows

        on_device = n_total * dim * 4 <= self.DEVICE_BUDGET_BYTES

        def load_window(src, lo, hi):
            x = np.asarray(src[lo:hi], np.float32)
            x = _normalize_rows(x) if norm else x
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

        spans = list(_windows(sources, batch_rows))
        staged = [load_window(*w) for w in spans] if on_device else None

        def windows():
            if staged is not None:
                yield from staged
            else:
                for w in spans:
                    yield load_window(*w)

        return self._run(windows, n_total, rng, iters=iters, tol=tol)

    def fit_staged(self, x: torch.Tensor, n_total: int | None = None, *, iters: int = 10,
                   tol: float = 1e-4, batch_rows: int = 1 << 18) -> np.ndarray:
        """Lloyd iterations over a sample already on the card: ``x``
        [total, D] f32, of which the first ``n_total`` rows (all by
        default) train. Used by the device-resident train path
        (``IVFPQIndex._train_big``): the sample was rotated on the card
        and never returns to the host; only init rows and per-iteration
        centroid sums do. The kernel runs on windows of ``batch_rows``
        rows (the JAX package passes the whole sample to one call)."""
        n_total = x.shape[0] if n_total is None else n_total
        if n_total < self.k:
            raise ValueError(f"need >= k={self.k} training rows, got {n_total}")
        rng = np.random.default_rng(self.seed)
        init_idx = np.sort(rng.choice(n_total, size=self.k, replace=False))
        init_rows = x[torch.from_numpy(init_idx).to(x.device)].float().cpu().numpy()
        self.centroids = _normalize_rows(init_rows) if self.spherical else init_rows

        def windows():
            for lo in range(0, n_total, batch_rows):
                yield x[lo:min(lo + batch_rows, n_total)]

        return self._run(windows, n_total, rng, iters=iters, tol=tol)

    def _split_empty(self, centroids: np.ndarray, counts: np.ndarray, rng) -> int:
        """faiss-style repair: empty centroid <- jittered copy of a big one.

        The jitter scales with the source centroid's norm: spherical
        scores ride bf16 operands, so a fixed 1e-3 jitter would fall
        below the score resolution on high-norm data and the split would
        never attract a point."""
        empty = np.flatnonzero(counts == 0)
        if len(empty) == 0:
            return 0
        order = np.argsort(-counts)
        for j, e in enumerate(empty):
            src = order[j % max(1, len(order))]
            scale = 0.1 * float(np.linalg.norm(centroids[src])) + 1e-3
            eps = scale * rng.standard_normal(centroids.shape[1]).astype(np.float32)
            centroids[e] = centroids[src] + eps
            if self.spherical:
                centroids[e] /= max(np.linalg.norm(centroids[e]), 1e-12)
        return len(empty)

    def assign(self, x: np.ndarray, *, batch_rows: int = 1 << 18
               ) -> tuple[np.ndarray, np.ndarray]:
        """Return (scores, centroid ids) for rows of x, streamed through
        the card in windows of ``batch_rows`` rows."""
        if self.centroids is None:
            raise RuntimeError("fit() first")
        x = np.asarray(x, np.float32)
        if self.spherical:
            x = _normalize_rows(x)
        c_pad = self._centroids_padded()
        scores = np.empty(len(x), np.float32)
        assign = np.empty(len(x), np.int64)
        for lo in range(0, len(x), batch_rows):
            xc = torch.from_numpy(np.ascontiguousarray(x[lo:lo + batch_rows])).to(self.device)
            v, a = self._top1(xc, c_pad)
            scores[lo:lo + len(xc)] = v.cpu().numpy()
            assign[lo:lo + len(xc)] = a.cpu().numpy()
        return scores, assign


def _windows(sources, batch_rows):
    """Yield (source, lo, hi) windows of ~batch_rows rows."""
    for s in sources:
        for lo in range(0, len(s), batch_rows):
            yield s, lo, min(lo + batch_rows, len(s))
