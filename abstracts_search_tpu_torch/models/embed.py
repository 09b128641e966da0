"""Batched, bucketed embedding pipeline on one device or over a mesh.

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

Over a mesh (``mesh=``, ``parallel/mesh.py``) the pipeline is the JAX
package's dp x tp one: every rank calls it with the same batch, shard
``s`` of ``n_shard`` runs rows ``[s bs/n_shard, (s+1) bs/n_shard)`` of the
padded batch on its weight slices (``models/qwen2.py``: tp all-reduces in
its tp group), and the rows are all-gathered over the shard axis in shard
order, so every rank returns all of them (JAX's ``out_shardings=repl``).
``__call__`` takes the mesh's rank 0's token ids, broadcast per batch
(the whitespace tokenizer's ``hash`` differs between processes);
``plan`` and ``forward`` split the same work for a caller that
tokenizes on one rank and broadcasts the ids itself (``serve/engine.py``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.mesh import Mesh, all_gather, broadcast
from ..parallel.sharding import shard_state_dict
from ..utils import trace
from .stella import PROMPTS, StellaConfig, StellaEncoder

Tokenizer = Callable[[str], Sequence[int]]

DEFAULT_BUCKETS = (32, 64, 128, 256, 512)


class EmbeddingPipeline:
    """texts -> [n, mrl_dim] float32 embeddings.

    ``params``: a ``StellaEncoder`` state dict (any device, any float
    dtype: it is copied into the model's own, on ``device``, the card by
    default). ``mesh``: the encoder's mesh (module docstring); the model
    lives on its device and holds this rank's tp slices of ``params``
    (whole tensors are sliced, slices kept)."""

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
        mesh: Mesh | None = None,
    ):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.pad_id = pad_id
        self.batch_size = batch_size
        self.buckets = tuple(sorted(buckets))
        self.batch_buckets = batch_buckets
        self.mesh = mesh if mesh is not None and mesh.collective else None
        self.device = resolve_device(device if self.mesh is None else self.mesh.device)
        tp = None
        if self.mesh is not None:
            tp = self.mesh.tp_view()
            params = shard_state_dict(params, tp.rank, tp.size, cfg)
        self.model = StellaEncoder(cfg, device=self.device, tp=tp)
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
        power of two, at most ``batch_size``. Over a mesh the power of two
        is floored at the shard axis' extent, not at ``W``: a 1-text
        encode on a dp x tp mesh pads to ``n_shard`` rows, not by the tp
        factor (the JAX package's rule)."""
        if not self.batch_buckets:
            return self.batch_size
        b = 1
        while b < n:
            b <<= 1
        if self.mesh is not None:
            b = max(b, self.mesh.n_shard)
        return min(b, self.batch_size)

    def _tokenize(self, texts: Sequence[str], prompt: str | None):
        prefix = PROMPTS[prompt] if prompt else ""
        return [list(self.tokenizer(prefix + t))[: self.buckets[-1]] for t in texts]

    # -- embedding -------------------------------------------------------------

    def plan(self, texts: Sequence[str], prompt: str | None = None) -> list:
        """The batches ``texts`` run as: ``(rows, ids, mask)`` each, where
        ``rows`` are the texts' positions and ``ids``/``mask`` int64
        ``[bs, bucket]`` arrays (texts sorted by length to keep padding
        small, padding rows given one live token)."""
        toks = self._tokenize(texts, prompt)
        order = sorted(range(len(toks)), key=lambda i: len(toks[i]))
        out = []
        for pos in range(0, len(order), self.batch_size):
            batch_idx = order[pos : pos + self.batch_size]
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
            out.append((batch_idx, ids, mask))
        return out

    def forward(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """One padded batch -> [bs, mrl_dim] f32. Over a mesh every rank
        calls this with the same batch: its shard's rows run here and the
        shards' rows are all-gathered (a batch whose rows the shards do not
        divide runs padded to a multiple of ``n_shard``). The model's call
        is the ``encoder.forward`` span (rows, bucket, real tokens)."""
        bs = len(ids)
        if self.mesh is not None and self.mesh.n_shard > 1:
            n_shard, s = self.mesh.n_shard, self.mesh.shard_rank
            per = -(-bs // n_shard)
            pad = per * n_shard - bs
            if pad:
                ids = np.concatenate([ids, np.full((pad, ids.shape[1]), self.pad_id, ids.dtype)])
                mask = np.concatenate([mask, np.zeros((pad, mask.shape[1]), mask.dtype)])
                mask[bs:, 0] = 1
            ids, mask = ids[s * per:(s + 1) * per], mask[s * per:(s + 1) * per]
        span = (trace.span("encoder.forward", device=self.device, rows=ids.shape[0],
                           bucket=ids.shape[1], tokens=int(mask.sum()))
                if trace.enabled() else trace.OFF)
        with torch.inference_mode():
            with span:
                emb = self.model(torch.from_numpy(np.ascontiguousarray(ids)).to(self.device),
                                 torch.from_numpy(np.ascontiguousarray(mask)).to(self.device))
            if self.mesh is not None and self.mesh.n_shard > 1:
                emb = all_gather(self.mesh.shard_view(), emb).reshape(-1, emb.shape[-1])
            return emb[:bs].cpu().numpy()

    def __call__(self, texts: Sequence[str], *, prompt: str | None = None) -> np.ndarray:
        if len(texts) == 0:
            return np.zeros((0, self.cfg.mrl_dim), np.float32)
        out = np.zeros((len(texts), self.cfg.mrl_dim), np.float32)
        for batch_idx, ids, mask in self.plan(texts, prompt):
            if self.mesh is not None:
                both = broadcast(self.mesh, torch.from_numpy(np.stack([ids, mask]))).numpy()
                ids, mask = both[0], both[1]
            out[batch_idx] = self.forward(ids, mask)[: len(batch_idx)]
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
