"""Chunked device sources for the index build.

A device source holds a training sample as chunks that are (re)made or
(re)staged on the card on demand: ``__len__``, ``shape``,
``chunk_rows``, ``num_chunks``, ``device_chunk(j)`` -> a
[chunk_rows, D] f32 tensor on the card, ``gather_rows(idx)`` -> numpy
rows, and ``prenormalized``. ``KMeans._fit_device_stream`` and
``IVFPQIndex._train_big`` consume it.

``RotatedDeviceSource`` applies the OPQ rotation on the card, so the
rotated sample never exists on the host. (The JAX package's synthetic
corpus reader in the same module comes with the storage slice.)
"""

from __future__ import annotations

import numpy as np
import torch


class RotatedDeviceSource:
    """Device-source view with an orthogonal rotation applied on the
    card (norms persist, so rows stay unit). Used by the
    device-streamed k-means branch of ``IVFPQIndex._train_big``."""

    prenormalized = True

    def __init__(self, src, rotation: np.ndarray, device):
        self.src = src
        self.chunk_rows = src.chunk_rows
        self.num_chunks = src.num_chunks
        self.shape = src.shape
        self._rot = torch.from_numpy(np.asarray(rotation, np.float32)).to(device)

    def __len__(self) -> int:
        return self.shape[0]

    def device_chunk(self, j: int) -> torch.Tensor:
        return self.src.device_chunk(j) @ self._rot

    def gather_rows(self, idx) -> np.ndarray:
        return _gather_from_chunks(self.device_chunk, self.chunk_rows,
                                   np.asarray(idx, np.int64), self.shape[1])


def _gather_from_chunks(device_chunk, chunk_rows: int, idx: np.ndarray,
                        dim: int) -> np.ndarray:
    """Gather rows by global index from a chunked device source: per
    involved chunk, gather on the card and download only the picks."""
    out = np.empty((len(idx), dim), np.float32)
    order = np.argsort(idx, kind="stable")
    sidx = idx[order]
    cis = sidx // chunk_rows
    lo = 0
    while lo < len(sidx):
        hi = lo
        ci = cis[lo]
        while hi < len(sidx) and cis[hi] == ci:
            hi += 1
        x = device_chunk(int(ci))
        local = torch.from_numpy(sidx[lo:hi] - ci * chunk_rows).to(x.device)
        out[order[lo:hi]] = x[local].float().cpu().numpy()
        lo = hi
    return out
