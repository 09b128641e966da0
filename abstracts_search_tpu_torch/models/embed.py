"""Batched, bucketed embedding pipeline on one device.

The JAX package's ``models/embed.py`` in PyTorch:

- texts are tokenized (tokenizer injected: any callable
  ``text -> list[int]``; production uses the HF Qwen2 tokenizer, tests
  and the card's smoke the whitespace one) and cut to the largest bucket,
- sorted by length and padded into a small set of sequence-length
  buckets, so padding waste stays small,
- batches are padded to a fixed batch size, or with
  ``batch_buckets=True`` to the next power of two (the serving mode: a
  single interactive query runs a 1-row forward), each padding row given
  one live token so masked pooling stays finite,
- query texts get the ``s2p_query`` prompt prefix; corpus documents are
  embedded bare.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .stella import PROMPTS, StellaConfig, StellaEncoder

Tokenizer = Callable[[str], Sequence[int]]

DEFAULT_BUCKETS = (32, 64, 128, 256, 512)


class EmbeddingPipeline:
    """texts -> [n, mrl_dim] float32 embeddings.

    ``params``: a ``StellaEncoder`` state dict (any device, any float
    dtype: it is copied into the model's own, on ``device``, the card by
    default)."""

    def __init__(
        self,
        cfg: StellaConfig,
        params,
        tokenizer: Tokenizer,
        *,
        pad_id: int = 0,
        batch_size: int = 32,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        batch_buckets: bool = False,
        device=None,
    ):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.pad_id = pad_id
        self.batch_size = batch_size
        self.buckets = tuple(sorted(buckets))
        self.batch_buckets = batch_buckets
        self.device = resolve_device(device)
        self.model = StellaEncoder(cfg, device=self.device)
        self.model.load_state_dict(params)
        self.model.eval()

    # -- tokenization / bucketing --------------------------------------------

    def _bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        return self.buckets[-1]

    def _batch_pad(self, n: int) -> int:
        """Rows the forward carries for a chunk of ``n`` texts: the fixed
        ``batch_size`` by default (the bulk-build mode), else the next
        power of two, at most ``batch_size``."""
        if not self.batch_buckets:
            return self.batch_size
        b = 1
        while b < n:
            b <<= 1
        return min(b, self.batch_size)

    def _tokenize(self, texts: Sequence[str], prompt: str | None):
        prefix = PROMPTS[prompt] if prompt else ""
        return [list(self.tokenizer(prefix + t))[: self.buckets[-1]] for t in texts]

    # -- embedding -------------------------------------------------------------

    def __call__(self, texts: Sequence[str], *, prompt: str | None = None) -> np.ndarray:
        if len(texts) == 0:
            return np.zeros((0, self.cfg.mrl_dim), np.float32)
        toks = self._tokenize(texts, prompt)

        # group indices by length to minimize padding waste
        order = sorted(range(len(toks)), key=lambda i: len(toks[i]))
        out = np.zeros((len(texts), self.cfg.mrl_dim), np.float32)

        pos = 0
        while pos < len(order):
            batch_idx = order[pos : pos + self.batch_size]
            pos += self.batch_size
            bucket = self._bucket_for(max(len(toks[i]) for i in batch_idx))

            bs = self._batch_pad(len(batch_idx))
            ids = np.full((bs, bucket), self.pad_id, np.int64)
            mask = np.zeros((bs, bucket), np.int64)
            for r, i in enumerate(batch_idx):
                t = toks[i]
                ids[r, : len(t)] = t
                mask[r, : len(t)] = 1
            # fully-padded rows break masked pooling denominators; give
            # them one live token (their output is discarded anyway)
            mask[len(batch_idx):, 0] = 1

            with torch.inference_mode():
                emb = self.model(torch.from_numpy(ids).to(self.device),
                                 torch.from_numpy(mask).to(self.device))
                out[batch_idx] = emb[: len(batch_idx)].cpu().numpy()
        return out

    def embed_queries(self, texts: Sequence[str], prompt: str = "s2p_query") -> np.ndarray:
        """Query-side embedding with the instruction prompt."""
        return self(texts, prompt=prompt)


def whitespace_tokenizer(vocab_size: int = 30_000) -> Tokenizer:
    """Toy deterministic tokenizer for offline tests and demos (Python's
    ``hash``: the same ids as the JAX package's within one process)."""

    def tok(text: str) -> list[int]:
        return [(hash(w) % (vocab_size - 2)) + 2 for w in text.split()] or [1]

    return tok


def load_hf_tokenizer(model_name: str):
    """Production tokenizer via transformers (needs a local HF cache)."""
    from transformers import AutoTokenizer

    t = AutoTokenizer.from_pretrained(model_name)
    return lambda text: t(text, add_special_tokens=True)["input_ids"]
