"""stella_en_1.5B_v5 sentence encoder: Qwen2 backbone + pooling + MRL head.

The JAX package's ``models/stella.py`` in PyTorch. Tokens -> Qwen2 hidden
states -> masked pooling (mean by default) -> ``vector_linear``
(hidden -> mrl_dim, with bias, in the compute dtype) -> f32 -> L2
normalisation. Queries carry the ``s2p_query`` prompt; corpus documents
are embedded bare. The published corpus uses the 1024-d MRL head.

The backbone is whichever ``StellaConfig.backbone`` names: a
``Qwen2Config`` (stella's own), a ``MoonlightConfig`` (Moonlight-16B-A3B,
``models/moonlight.py``) or a ``KimiLinearConfig`` (Kimi-Linear-48B-A3B,
``models/kimi_linear.py``), behind the same pooling and head.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..device import resolve_device
from . import kimi_linear, moonlight, qwen2
from .kimi_linear import KimiLinearConfig, KimiLinearEncoder
from .moonlight import MoonlightConfig, MoonlightEncoder
from .qwen2 import Qwen2Config, Qwen2Encoder

# a backbone config's type -> its encoder and the initialiser of a stella
# module over it
_BACKBONES = {MoonlightConfig: (MoonlightEncoder, moonlight.init_random_),
              KimiLinearConfig: (KimiLinearEncoder, kimi_linear.init_random_),
              Qwen2Config: (Qwen2Encoder, qwen2.init_random_)}

# stella's config_sentence_transformers.json prompts, byte for byte; the
# serving setting PROMPT_NAME selects one
PROMPTS = {
    "s2p_query": (
        "Instruct: Given a web search query, retrieve relevant passages "
        "that answer the query.\nQuery: "
    ),
    "s2s_query": "Instruct: Retrieve semantically similar text.\nQuery: ",
}


@dataclasses.dataclass(frozen=True)
class StellaConfig:
    backbone: Qwen2Config | MoonlightConfig | KimiLinearConfig = dataclasses.field(
        default_factory=Qwen2Config.stella_1_5b)
    mrl_dim: int = 1024          # published MRL heads: 512..8192; corpus uses 1024
    pooling: str = "mean"        # "mean" | "last" | "cls"
    causal: bool = True
    normalize: bool = True

    @staticmethod
    def tiny(**kw) -> "StellaConfig":
        defaults = dict(backbone=Qwen2Config.tiny(), mrl_dim=16)
        defaults.update(kw)
        return StellaConfig(**defaults)


def pool_hidden(hidden, attention_mask, mode: str):
    """Masked pooling over the sequence axis. hidden [B,T,H], mask [B,T]."""
    m = attention_mask.to(hidden.dtype)
    if mode == "mean":
        s = (hidden * m[:, :, None]).sum(1)
        cnt = m.sum(1, keepdim=True).clamp_min(1.0)
        return s / cnt
    if mode == "last":
        # index of the last real token of each row
        idx = (attention_mask.sum(1) - 1).clamp_min(0).long()
        return hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
    if mode == "cls":
        return hidden[:, 0]
    raise ValueError(f"unknown pooling mode {mode!r}")


class StellaEncoder(nn.Module):
    """(input_ids [B,T], attention_mask [B,T]) -> [B, mrl_dim] f32.

    Parameters: ``backbone.*`` (a ``Qwen2Encoder``, ``MoonlightEncoder``
    or ``KimiLinearEncoder``, as ``cfg.backbone`` is) and
    ``vector_linear.{weight,bias}``, uninitialised until
    ``load_state_dict`` or ``init_random_``. ``tp``: the backbone's tp
    group (Qwen2 only: the others refuse one); pooling and
    ``vector_linear`` are replicated on every rank of it."""

    def __init__(self, cfg: StellaConfig, *, device=None, tp=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        backbone, self._init = _BACKBONES[type(cfg.backbone)]
        self.backbone = backbone(cfg.backbone, causal=cfg.causal, device=device, tp=tp)
        self.vector_linear = nn.Linear(cfg.backbone.hidden_size, cfg.mrl_dim, bias=True,
                                       dtype=cfg.backbone.dtype, device="meta")
        self.vector_linear.to_empty(device=device)

    def init_random_(self, generator: torch.Generator, std: float = 0.02):
        return self._init(self, generator, self.cfg.backbone.param_dtype, std)

    def forward(self, input_ids, attention_mask):
        hidden = self.backbone(input_ids, attention_mask)
        pooled = pool_hidden(hidden, attention_mask, self.cfg.pooling)
        emb = self.vector_linear(pooled).float()
        if self.cfg.normalize:
            emb = emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return emb
