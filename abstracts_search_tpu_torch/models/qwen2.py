"""Qwen2 transformer backbone (the stella_en_1.5B_v5 base) as torch modules.

The JAX package's flax Qwen2 (``abstracts_search_tpu/models/qwen2.py``)
written again in PyTorch: RMSNorm, rotary position embeddings (HF
rotate-half convention), grouped-query attention with q/k/v projection
biases, and a SwiGLU MLP. Parameters carry HF's names
(``embed_tokens.weight``, ``layers.{i}.self_attn.q_proj.{weight,bias}``,
``norm.weight``, ...), so a HF ``Qwen2Model`` state dict loads with no
renaming.

Numerics follow the JAX module, not HF, where the two differ:

- linear and embedding weights are held in the compute dtype ``dtype``
  (flax's ``Dense(dtype=...)`` casts kernel, bias and input to it on
  every call: rounding once at load gives the same numbers);
- RMSNorm takes its statistics in f32 and multiplies by an f32 scale in
  f32 before casting to ``dtype`` (HF casts before the scale); norm
  scales stay f32 whatever ``dtype`` is;
- attention scores are taken in ``dtype``, then cast to f32, divided by
  sqrt(head_dim) and offset by an additive -1e9 mask; the softmax is
  f32, its probabilities are cast back to ``dtype`` for the PV product;
- GQA repeats each KV head in place (``repeat_interleave``, as
  ``jnp.repeat``);
- the rotary tables are built in f32 and cast to ``dtype``.

Attention is written as plain matmuls, as the JAX package's is a stock
einsum outside any kernel; a fused attention kernel would not round the
scores to ``dtype`` before the softmax. No code here touches TF32: the
port pins it off, so an f32 encoder runs in true f32.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class Qwen2Config:
    vocab_size: int = 151_646
    hidden_size: int = 1536
    intermediate_size: int = 8960
    num_layers: int = 28
    num_heads: int = 12
    num_kv_heads: int = 2
    head_dim: int = 128
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.float32          # compute dtype
    # the dtype random initialisation draws weights in (flax's
    # param_dtype); loaded weights are cast straight to ``dtype``, as
    # flax applies a loaded tree
    param_dtype: torch.dtype = torch.float32

    @staticmethod
    def stella_1_5b(**kw) -> "Qwen2Config":
        return Qwen2Config(**kw)

    @staticmethod
    def tiny(**kw) -> "Qwen2Config":
        defaults = dict(
            vocab_size=128, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
            rope_theta=10_000.0,
        )
        defaults.update(kw)
        return Qwen2Config(**defaults)


class RMSNorm(nn.Module):
    def __init__(self, size: int, eps: float, dtype: torch.dtype, device):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(size, dtype=torch.float32, device=device))

    def forward(self, x):
        x32 = x.float()
        var = x32.square().mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        return (y * self.weight).to(self.dtype)


def _rope_cos_sin(positions, head_dim: int, theta: float, dtype):
    """HF-convention rotary tables: [T, head_dim] with duplicated halves."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=positions.device) / head_dim))
    freqs = positions.float()[:, None] * inv_freq[None, :]             # [T, hd/2]
    emb = torch.cat([freqs, freqs], dim=-1)                            # [T, hd]
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _apply_rope(x, cos, sin):
    # x: [B, T, H, hd]; cos/sin: [T, hd]
    return x * cos[None, :, None, :] + _rotate_half(x) * sin[None, :, None, :]


def _linear(n_in: int, n_out: int, bias: bool, cfg: Qwen2Config, device) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=bias, dtype=cfg.dtype, device=device)


class Attention(nn.Module):
    def __init__(self, cfg: Qwen2Config, device):
        super().__init__()
        self.cfg = cfg
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.q_proj = _linear(cfg.hidden_size, h * hd, True, cfg, device)
        self.k_proj = _linear(cfg.hidden_size, kv * hd, True, cfg, device)
        self.v_proj = _linear(cfg.hidden_size, kv * hd, True, cfg, device)
        self.o_proj = _linear(h * hd, cfg.hidden_size, False, cfg, device)

    def forward(self, x, mask_bias, cos, sin):
        cfg = self.cfg
        b, t, _ = x.shape
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = _apply_rope(self.q_proj(x).view(b, t, h, hd), cos, sin)
        k = _apply_rope(self.k_proj(x).view(b, t, kv, hd), cos, sin)
        v = self.v_proj(x).view(b, t, kv, hd)

        # GQA: each kv head serves h // kv consecutive query heads
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)

        scores = torch.einsum("bthd,bshd->bhts", q, k).float()
        scores = scores / (hd ** 0.5)
        scores = scores + mask_bias              # [B, 1, T, T] additive -1e9 mask
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)

        out = torch.einsum("bhts,bshd->bthd", probs, v).reshape(b, t, h * hd)
        return self.o_proj(out)


class MLP(nn.Module):
    def __init__(self, cfg: Qwen2Config, device):
        super().__init__()
        self.gate_proj = _linear(cfg.hidden_size, cfg.intermediate_size, False, cfg, device)
        self.up_proj = _linear(cfg.hidden_size, cfg.intermediate_size, False, cfg, device)
        self.down_proj = _linear(cfg.intermediate_size, cfg.hidden_size, False, cfg, device)

    def forward(self, x):
        return self.down_proj(nn.functional.silu(self.gate_proj(x)) * self.up_proj(x))


class Block(nn.Module):
    def __init__(self, cfg: Qwen2Config, device):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, device)
        self.self_attn = Attention(cfg, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                                cfg.dtype, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x, mask_bias, cos, sin):
        x = x + self.self_attn(self.input_layernorm(x), mask_bias, cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))


def init_random_(module: nn.Module, generator: torch.Generator, param_dtype,
                 std: float = 0.02) -> nn.Module:
    """HF-style random weights in place: N(0, ``std``) linear and
    embedding weights drawn in ``param_dtype`` from ``generator`` (on the
    module's device), zero biases, unit norm scales."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                w = torch.empty(m.weight.shape, dtype=param_dtype, device=m.weight.device)
                m.weight.copy_(w.normal_(0.0, std, generator=generator))
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, RMSNorm):
                m.weight.fill_(1.0)
    return module


class Qwen2Encoder(nn.Module):
    """Token ids -> final hidden states [B, T, hidden] in ``cfg.dtype``.

    Built on ``device`` (the card by default) with uninitialised weights:
    ``load_state_dict`` or ``init_random_`` fills them."""

    def __init__(self, cfg: Qwen2Config, causal: bool = True, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.causal = causal
        # built on the meta device, then given memory: no default init of
        # 1.5B weights that a load overwrites anyway
        meta = torch.device("meta")
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype,
                                         device=meta)
        self.layers = nn.ModuleList(Block(cfg, meta) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, meta)
        self.to_empty(device=device)

    def init_random_(self, generator: torch.Generator, std: float = 0.02):
        return init_random_(self, generator, self.cfg.param_dtype, std)

    def forward(self, input_ids, attention_mask):
        cfg = self.cfg
        t = input_ids.shape[1]
        x = self.embed_tokens(input_ids)

        positions = torch.arange(t, device=input_ids.device)
        cos, sin = _rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.dtype)

        # additive mask: padding always; causal optionally
        allow = attention_mask[:, None, None, :].bool()               # [B,1,1,S]
        if self.causal:
            tri = torch.ones((t, t), dtype=torch.bool, device=input_ids.device).tril()
            allow = allow & tri[None, None]
        mask_bias = torch.zeros(allow.shape, dtype=torch.float32,
                                device=input_ids.device).masked_fill_(~allow, -1e9)

        for layer in self.layers:
            x = layer(x, mask_bias, cos, sin)
        return self.norm(x)
