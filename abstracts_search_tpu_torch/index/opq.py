"""OPQ: a learned rotation that minimizes PQ reconstruction error.

The port of the JAX package's ``index/opq.py`` (the faiss
``OPQMatrix`` analog). Classic alternating optimization:

  repeat:
    1. train a PQ on the rotated data  x @ R
    2. update R by orthogonal Procrustes: minimize ||x R - x_hat||_F
       over orthogonal R, where x_hat = decode(encode(x R)).
       Solution: R = U V^T from SVD(x^T x_hat).

The sample is staged on the card once; rotate, PQ Lloyd, encode/decode,
the gram x^T x_hat and the error run there. The [D, D] SVD stays host
float64 numpy.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..device import resolve_device
from .pq import ProductQuantizer

logger = logging.getLogger(__name__)

_CHUNK = 1 << 18


def _rotate(x: np.ndarray, r: np.ndarray, device) -> np.ndarray:
    """x @ R on the card in chunks of host rows, back to the host."""
    out = np.empty_like(x)
    rj = torch.from_numpy(np.asarray(r, np.float32)).to(device)
    for lo in range(0, len(x), _CHUNK):
        xc = torch.from_numpy(np.ascontiguousarray(x[lo:lo + _CHUNK])).to(device)
        out[lo:lo + _CHUNK] = (xc @ rj).cpu().numpy()
    return out


class OPQ:
    def __init__(self, dim: int, m: int = 64, nbits: int = 8, *, seed: int = 0,
                 device=None):
        self.dim = dim
        self.device = resolve_device(device)
        self.pq = ProductQuantizer(dim, m, nbits, seed=seed, device=self.device)
        self.rotation = np.eye(dim, dtype=np.float32)  # R: applied as x @ R
        self.stats: dict = {}
        self._staged = None

    def _gram(self, x: torch.Tensor, xr: torch.Tensor, c: torch.Tensor):
        """Encode xr, decode, then the gram x^T x_hat and the squared
        error ||xr - x_hat||^2, over windows of rows."""
        pq = self.pq
        gram = torch.zeros((self.dim, self.dim), dtype=torch.float32, device=x.device)
        err = torch.zeros((), dtype=torch.float32, device=x.device)
        w = pq.window_rows()
        for lo in range(0, x.shape[0], w):
            xr3 = xr[lo:lo + w].reshape(-1, pq.m, pq.dsub)
            xhat = pq.reconstruct(pq.assign(xr3, c), c).reshape(xr3.shape[0], self.dim)
            gram += x[lo:lo + w].T @ xhat
            err += torch.sum(torch.square(xr[lo:lo + w] - xhat))
        return gram, err

    def train(
        self,
        x: np.ndarray,
        *,
        outer_iters: int = 4,
        pq_iters: int = 8,
        init: str = "identity",
        seed: int = 0,
        keep_staged: bool = False,
    ) -> np.ndarray:
        """Alternate PQ training and Procrustes rotation updates.

        The sample is staged on the card once; only the [D, D] gram and
        scalars come back per outer iteration. With ``keep_staged`` the
        staged rows stay for the caller (``staged()``, the residual PQ
        training of ``IVFPQIndex``) until ``drop_staged()``."""
        x = np.asarray(x, np.float32)
        n, dim = x.shape
        m, dsub = self.pq.m, self.pq.dsub
        if init == "random":
            rng = np.random.default_rng(seed)
            q, _ = np.linalg.qr(rng.standard_normal((self.dim, self.dim)))
            self.rotation = q.astype(np.float32)

        xj = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        mses = []
        for it in range(outer_iters):
            xr = xj @ torch.from_numpy(self.rotation).to(self.device)
            self.pq.train_staged(xr.view(n, m, dsub), n, iters=pq_iters)
            gram, sq_err = self._gram(xj, xr, torch.from_numpy(self.pq.centroids)
                                      .to(self.device))
            del xr
            mse = float(sq_err) / (n * dim)
            mses.append(mse)
            logger.info("opq iter %d: mse=%.6g", it, mse)
            if it == outer_iters - 1:
                break
            # Procrustes: R <- argmin_{R orthogonal} ||x R - xhat||
            u, _, vt = np.linalg.svd(gram.cpu().numpy().astype(np.float64),
                                     full_matrices=False)
            self.rotation = (u @ vt).astype(np.float32)

        self.stats = {"mse": mses, "m": self.pq.m, "nbits": self.pq.nbits}
        self._staged = (xj, n) if keep_staged else None
        return self.rotation

    def staged(self):
        """(x [n, D] on the card, n) staged by train(keep_staged=True), or None."""
        return self._staged

    def drop_staged(self) -> None:
        self._staged = None

    def apply(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x, np.float32) @ self.rotation

    def encode(self, x: np.ndarray) -> np.ndarray:
        return self.pq.encode(self.apply(x))

    def decode_unrotated(self, codes: np.ndarray) -> np.ndarray:
        """Decode back into the ORIGINAL (unrotated) space."""
        return self.pq.decode(codes) @ self.rotation.T
