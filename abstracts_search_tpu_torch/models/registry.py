"""Embedder registry: pick the embedding backend by name.

- ``hash``   : deterministic offline embedder (seeded Gaussian per text),
               bit-identical to the JAX package's. Offline runs and tests
               use it; every stage downstream of embedding runs for real.
- ``stella`` : the real encoder — not yet ported.
- ``auto``   : stella where it loads, else the hash embedder with a
               warning; while the encoder is not ported, always the
               hash embedder.

An embedder is ``texts -> np.ndarray [n, dim] float32`` with a
``queries(texts)`` variant that applies the query prompt.
"""

from __future__ import annotations

import hashlib
import logging

import numpy as np

from ..config import Config

logger = logging.getLogger(__name__)


class HashEmbedder:
    """Deterministic pseudo-embedder for offline runs and tests."""

    def __init__(self, dim: int):
        self.dim = dim

    def _one(self, text: str) -> np.ndarray:
        seed = int.from_bytes(hashlib.sha1(text.encode()).digest()[:8], "little")
        v = np.random.default_rng(seed).standard_normal(self.dim).astype(np.float32)
        return v / np.linalg.norm(v)

    def __call__(self, texts) -> np.ndarray:
        if len(texts) == 0:
            return np.zeros((0, self.dim), np.float32)
        return np.stack([self._one(t) for t in texts])

    def queries(self, texts) -> np.ndarray:
        # prompting is meaningless for a hash embedder; corpus == query space
        return self(texts)


def get_embedder(name: str, cfg: Config):
    if name == "hash":
        return HashEmbedder(cfg.embed_dim)
    if name == "stella":
        raise NotImplementedError("embedder 'stella': encoder not yet ported")
    if name == "auto":
        logger.warning("stella unavailable (%s); falling back to hash embedder",
                       "encoder not yet ported")
        return HashEmbedder(cfg.embed_dim)
    raise ValueError(f"unknown embedder {name!r}")
