"""Kimi-Linear-48B-A3B (``model_type: kimi_linear``) as an encoder backbone.

A hybrid of linear and full attention at 2,304 wide: Kimi Delta
Attention (KDA, a gated delta rule with per-channel decays) in three
layers of four and in the second-last, NoPE multi-head latent attention
(MLA) in the others, per ``linear_attn_config`` (1-based layer numbers);
a dense SwiGLU in the first ``first_k_dense_replace`` layers and
sparse-expert SwiGLU layers after them, with one shared expert. It takes
the place of Qwen2 under stella's pooling and MRL head
(``models/stella.py``), with ``Qwen2Encoder``'s interface: ``(input_ids
[B, T], attention_mask [B, T]) -> hidden [B, T, hidden]`` in
``cfg.dtype``, causal. MLA, the router, the permutation, the combine and
the grouped expert product are Moonlight's (``models/moonlight.py``):
parameters carry HF's names, the routed experts stacked as there
(``layers.{i}.mlp.experts.w13`` [E, 2I, H], ``.w2`` [E, H, I]).

The layer equations, after the Kimi Linear technical report (Moonshot
AI, 2025) and flash-linear-attention's ``KimiDeltaAttention``::

    x = x + Mixer(input_layernorm(x))            # KDA or MLA, by layer
    x = x + FFN(post_attention_layernorm(x))     # MLP(intermediate_size) in the
    out = norm(x)                                # dense layers, MoE after them

KDA, per head h of ``kda_num_heads`` with d = ``kda_head_dim`` (keys and
values alike)::

    q, k, v = silu(conv(q_proj(x))), silu(conv(k_proj(x))), silu(conv(v_proj(x)))
    q = l2norm(q_h) * d^-0.5,  k = l2norm(k_h)            # l2norm: x / sqrt(|x|^2 + 1e-6)
    g = -exp(A_log_h) * softplus(f_b_proj(f_a_proj(x)) + dt_bias)     # log-decays, f32
    b = sigmoid(b_proj(x))_h
    S_t = (I - b_t k_t k_t^T) Diag(exp g_t) S_{t-1} + b_t k_t v_t^T,  S_0 = 0
    o_t = S_t^T q_t
    y = o_proj(rms(o_h) * o_norm.weight * sigmoid(g_b_proj(g_a_proj(x))_h))

``conv`` is a causal depthwise convolution of width
``short_conv_kernel_size`` (zero left padding, no bias); the gated
RMSNorm normalises each head's d values and shares one weight of d over
the heads; ``f_a``/``g_a`` have rank d. The recurrence is
``ops/kda.py``'s ``kda_scan`` (chunked CUDA kernels on the card, the
token-by-token recurrence on the CPU).

MLA is Moonlight's with ``mla_use_nope``: the rope dims stay in
``q_proj`` and ``kv_a_proj_with_mqa`` and the one rope key is still
shared by the heads, unrotated; scores scaled by (nope + rope)^-0.5.

MoE: Moonlight's router over all ``n_routed_experts`` (sigmoid scores,
the choice by score plus correction bias, ties to the lowest expert, the
top ``num_experts_per_tok`` weighted by their scores normalised over all
chosen and scaled); this device holds experts ``expert_first`` ..
``expert_first + expert_count - 1`` (an expert-parallel share) and
computes their part of the output, plus the shared expert whole.
Absent experts add nothing.

Where this departs from the published description or HF (beside
Moonlight's own rules: weights in the compute dtype, norms scaling in f32
before the cast, scores taken in ``dtype`` then scaled in f32):

- the convolutions, the SiLU, the l2 norms and the gates are taken in
  f32 from the projections in ``dtype``; q and k are cast back to
  ``dtype`` for the recurrence, whose products on the card take bf16
  operands with f32 sums (the state and decays in f32);
- ``b`` is taken in f32 from the projection in ``dtype``;
- assumed, as flash-linear-attention's layer has it: ``g_b_proj``
  carries a bias, the convolutions none, ``A_log`` one value a head and
  ``dt_bias`` one a channel (``convert`` flattens HF's ``A_log`` of any
  shape with one value a head).

Spans (``utils/trace.py``): ``kda.attention`` (tokens) around each KDA
mixer, projections to ``o_proj``; ``kda.scan`` (tokens, chunks of 64)
around the recurrence; Moonlight's ``mla.attention``, ``moe.route`` and
``moe.experts`` (tokens, pairs, held pairs). ``last_moe_stats`` holds the
expert layers' tokens, padding tokens (on the card), routed and held
pairs; ``last_kda_stats`` the tokens the scans computed and how many were
padding (on the card). Nothing syncs for them; the share's permutation
reads its held pairs back once a layer (``moonlight.permute``).

The model runs on one device: over a tensor-parallel group it is refused
(``parallel/sharding.py`` has Qwen2's rules only).
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import torch
from torch import nn

from ..device import resolve_device
from ..ops.kda import CHUNK, kda_scan
from ..utils import trace
from . import moonlight
from .moonlight import MLA, MoE, _width, moe_stats
from .qwen2 import MLP, RMSNorm, _linear, _mask_bias


@dataclasses.dataclass(frozen=True)
class KimiLinearConfig:
    MODEL_TYPE: ClassVar[str] = "kimi_linear"

    vocab_size: int = 163_840
    hidden_size: int = 2304
    intermediate_size: int = 9216         # the dense layers' SwiGLU
    moe_intermediate_size: int = 1024     # one routed expert's SwiGLU
    num_layers: int = 27
    first_k_dense_replace: int = 1
    kda_layers: tuple = (1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22, 23, 25,
                         26)              # 1-based; the others are MLA
    kda_num_heads: int = 32
    kda_head_dim: int = 128
    short_conv_kernel_size: int = 4
    num_heads: int = 32                   # MLA's
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 256           # the router's width
    expert_first: int = 0                 # the experts held here
    expert_count: int = 256
    num_experts_per_tok: int = 8
    n_shared_experts: int = 1
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    rms_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32          # compute dtype
    param_dtype: torch.dtype = torch.float32    # what init_random_ draws in

    def __post_init__(self):
        object.__setattr__(self, "kda_layers", tuple(self.kda_layers))
        if not (0 <= self.expert_first
                and self.expert_first + self.expert_count <= self.n_routed_experts
                and self.expert_count > 0):
            raise ValueError(f"held experts [{self.expert_first}, "
                             f"{self.expert_first + self.expert_count}) outside the router's "
                             f"{self.n_routed_experts}")

    @property
    def held(self) -> tuple[int, int] | None:
        """(first, count) of the experts held here, or None for all."""
        if self.expert_count == self.n_routed_experts:
            return None
        return self.expert_first, self.expert_count

    @property
    def n_moe_layers(self) -> int:
        return self.num_layers - self.first_k_dense_replace

    @staticmethod
    def tiny(**kw) -> "KimiLinearConfig":
        defaults = dict(
            vocab_size=128, hidden_size=32, intermediate_size=64, moe_intermediate_size=16,
            num_layers=4, first_k_dense_replace=1, kda_layers=(1, 2, 3), kda_num_heads=2,
            kda_head_dim=16, num_heads=4, kv_lora_rank=16, qk_nope_head_dim=8,
            qk_rope_head_dim=4, v_head_dim=8, n_routed_experts=8, expert_count=8,
            num_experts_per_tok=3, n_shared_experts=1,
        )
        defaults.update(kw)
        return KimiLinearConfig(**defaults)


class ShortConv(nn.Module):
    """A causal depthwise convolution, ``weight`` [D, 1, width] (HF's
    ``*_conv1d``), then SiLU; in f32 -> f32."""

    def __init__(self, channels: int, width: int, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((channels, 1, width), dtype=dtype, device=device))

    def forward(self, x):
        width = self.weight.shape[-1]
        y = nn.functional.conv1d(x.transpose(1, 2).float(), self.weight.float(),
                                 padding=width - 1, groups=self.weight.shape[0])
        return nn.functional.silu(y[..., :x.shape[1]]).transpose(1, 2)


def _l2norm(x):
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + 1e-6)


class KDA(nn.Module):
    def __init__(self, cfg: KimiLinearConfig, device):
        super().__init__()
        self.cfg = cfg
        h, d, hd = cfg.kda_num_heads, cfg.kda_head_dim, cfg.hidden_size
        proj = h * d
        for name in ("q", "k", "v"):
            setattr(self, f"{name}_proj", _linear(hd, proj, False, cfg, device))
            setattr(self, f"{name}_conv1d",
                    ShortConv(proj, cfg.short_conv_kernel_size, cfg.dtype, device))
        self.f_a_proj = _linear(hd, d, False, cfg, device)
        self.f_b_proj = _linear(d, proj, False, cfg, device)
        self.A_log = nn.Parameter(torch.empty(h, dtype=torch.float32, device=device))
        self.dt_bias = nn.Parameter(torch.empty(proj, dtype=torch.float32, device=device))
        self.b_proj = _linear(hd, h, False, cfg, device)
        self.g_a_proj = _linear(hd, d, False, cfg, device)
        self.g_b_proj = _linear(d, proj, True, cfg, device)
        self.o_norm = RMSNorm(d, cfg.rms_norm_eps, torch.float32, device)
        self.o_proj = _linear(proj, hd, False, cfg, device)

    def forward(self, x):
        cfg = self.cfg
        b, t, _ = x.shape
        h, d = cfg.kda_num_heads, cfg.kda_head_dim
        with trace.span("kda.attention", device=x.device, tokens=b * t):
            q = _l2norm(self.q_conv1d(self.q_proj(x)).view(b, t, h, d)) * d ** -0.5
            k = _l2norm(self.k_conv1d(self.k_proj(x)).view(b, t, h, d))
            v = self.v_conv1d(self.v_proj(x)).view(b, t, h, d)
            f = self.f_b_proj(self.f_a_proj(x)).float() + self.dt_bias
            g = -self.A_log.exp()[:, None] * nn.functional.softplus(f.view(b, t, h, d))
            beta = torch.sigmoid(self.b_proj(x).float())
            with trace.span("kda.scan", device=x.device, tokens=b * t,
                            chunks=b * h * -(-t // CHUNK)):
                o = kda_scan(*(y.to(cfg.dtype).contiguous() for y in (q, k, v)),
                             g.contiguous(), beta)
            gate = torch.sigmoid(self.g_b_proj(self.g_a_proj(x)).float()).view(b, t, h, d)
            o = (self.o_norm(o) * gate).to(cfg.dtype)
            return self.o_proj(o.reshape(b, t, h * d))


class Block(nn.Module):
    def __init__(self, cfg: KimiLinearConfig, layer: int, device):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, device)
        self.kda = layer + 1 in cfg.kda_layers
        self.self_attn = KDA(cfg, device) if self.kda else MLA(cfg, device, rope=False)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                                cfg.dtype, device)
        self.mlp = (MLP(cfg, device, _width(cfg, cfg.intermediate_size))
                    if layer < cfg.first_k_dense_replace else MoE(cfg, device, cfg.held))

    def forward(self, x, mask_bias):
        a = self.input_layernorm(x)
        x = x + (self.self_attn(a) if self.kda else self.self_attn(a, mask_bias, None, None))
        return x + self.mlp(self.post_attention_layernorm(x))


def init_random_(module: nn.Module, generator: torch.Generator, param_dtype,
                 std: float = 0.02) -> nn.Module:
    """``moonlight.init_random_`` (linears, embeddings, norms, routers,
    stacked experts), then the convolutions N(0, ``std``), and each KDA
    layer's decay parameters as published KDA (and Mamba) initialise
    them: A uniform in [1, 16] (``A_log = log A``), dt log-uniform in
    [1e-3, 1e-1] stored through the inverse softplus (``dt_bias``)."""
    moonlight.init_random_(module, generator, param_dtype, std)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, ShortConv):
                w = torch.empty(m.weight.shape, dtype=param_dtype, device=m.weight.device)
                m.weight.copy_(w.normal_(0.0, std, generator=generator))
            elif isinstance(m, KDA):
                dev = m.A_log.device
                a = torch.empty(m.A_log.shape, device=dev).uniform_(1.0, 16.0, generator=generator)
                m.A_log.copy_(a.log())
                u = torch.empty(m.dt_bias.shape, device=dev).uniform_(generator=generator)
                dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
                m.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
    return module


class KimiLinearEncoder(nn.Module):
    """Token ids -> final hidden states [B, T, hidden] in ``cfg.dtype``.

    Built on the meta device, then given memory on ``device`` (the card
    by default), uninitialised until ``load_state_dict`` or
    ``init_random_``. Causal only (KDA's recurrence is). ``tp``: refused
    (the model runs on one device)."""

    def __init__(self, cfg: KimiLinearConfig, causal: bool = True, *, device=None, tp=None):
        super().__init__()
        if tp is not None and tp.size > 1:
            raise ValueError("the Kimi Linear backbone runs on one device: tensor "
                             "parallelism has rules for the Qwen2 backbone only")
        if not causal:
            raise ValueError("the Kimi Linear backbone is causal: KDA's recurrence is")
        device = resolve_device(device)
        self.cfg = cfg
        self.causal = causal
        meta = torch.device("meta")
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype,
                                         device=meta)
        self.layers = nn.ModuleList(Block(cfg, i, meta) for i in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, meta)
        self.to_empty(device=device)
        self.last_moe_stats: dict = {}
        self.last_kda_stats: dict = {}

    def init_random_(self, generator: torch.Generator, std: float = 0.02):
        return init_random_(self, generator, self.cfg.param_dtype, std)

    def forward(self, input_ids, attention_mask):
        x = self.embed_tokens(input_ids)
        mask_bias = _mask_bias(attention_mask, True)
        for layer in self.layers:
            x = layer(x, mask_bias)
        n = sum(layer.kda for layer in self.layers)
        self.last_moe_stats = moe_stats(self.layers, attention_mask, self.cfg.num_experts_per_tok)
        self.last_kda_stats = {"tokens": n * attention_mask.numel(),
                               "pad_tokens": n * (attention_mask == 0).sum()}
        return self.norm(x)
