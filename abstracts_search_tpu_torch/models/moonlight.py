"""Moonlight-16B-A3B (``model_type: deepseek_v3``) as an encoder backbone.

DeepSeek-V3's decoder block at 2,048 wide: multi-head latent attention
(MLA) and, after the first ``first_k_dense_replace`` dense layers,
sparse-expert SwiGLU layers with shared experts. It takes the place of
Qwen2 under stella's pooling and MRL head (``models/stella.py``), with
``Qwen2Encoder``'s interface: ``(input_ids [B, T], attention_mask [B, T])
-> hidden [B, T, hidden]`` in ``cfg.dtype``, causal. Parameters carry
HF's names (``layers.{i}.self_attn.kv_a_proj_with_mqa.weight``,
``layers.{i}.mlp.gate.e_score_correction_bias``, ...), except the
routed experts, which are stacked so that one kernel reads them:
``layers.{i}.mlp.experts.w13`` [E, 2I, H] (each expert's gate rows, then
its up rows) and ``layers.{i}.mlp.experts.w2`` [E, H, I]
(``convert.hf_backbone_state_dict`` stacks HF's per-expert tensors).

The layer equations, after HF's ``modeling_deepseek.py``::

    x = x + MLA(input_layernorm(x))
    x = x + FFN(post_attention_layernorm(x))      # MLP(intermediate_size) in the
    out = norm(x)                                 # dense layers, MoE after them

MLA (no q LoRA: ``q_lora_rank`` null)::

    q = q_proj(x)                       -> [T, h, nope + rope], split q_nope, q_pe
    c, k_pe = split(kv_a_proj_with_mqa(x), [kv_lora_rank, rope])
    kv = kv_b_proj(kv_a_layernorm(c))   -> [T, h, nope + v], split k_nope, v
    q_pe, k_pe = rope(q_pe), rope(k_pe)  # k_pe: one key shared by all heads
    k = cat(k_nope, k_pe), q = cat(q_nope, q_pe)
    o_proj(softmax(q . k * (nope + rope)^-0.5 + mask) . v)

``rope`` is DeepSeek's: the ``rope`` dims are de-interleaved
(``view(..., rope/2, 2).transpose``) and then rotated in the rotate-half
form with the duplicated-halves tables of ``qwen2._rope_cos_sin``. No
projection has a bias.

MoE (``scoring_func`` sigmoid, ``topk_method`` noaux_tc with ``n_group``
and ``topk_group`` 1, so no group limit)::

    s = sigmoid(x.float() @ W_gate.float().T)              # [T, E] f32
    idx = top_k(s + e_score_correction_bias)               # the choice only
    w = s.gather(idx); w = scale * w / (sum(w) + 1e-20)    # norm_topk_prob
    y = sum_k w_k E_{idx_k}(x)  (f32, cast to dtype) + shared(x)

each ``E_e`` and ``shared`` (one SwiGLU of ``n_shared_experts`` x
``moe_intermediate_size``) being ``down(silu(gate(x)) * up(x))``.

Where this departs from HF (the numbers of the qwen2 module's rules):

- weights are held in the compute dtype; norms scale in f32 before the
  cast to ``dtype`` (HF casts first); the router's weight is held in
  ``dtype`` and multiplied in f32, its correction bias in f32;
- scores are taken in ``dtype``, cast to f32, scaled and offset by an
  additive -1e9 mask (HF scales in ``dtype``);
- the top-k is a stable sort: ties go to the lowest expert (HF's
  ``topk(sorted=False)`` leaves them open);
- a routed expert's gate and up products stay f32 into ``silu(g) * u``,
  rounded once to ``dtype`` (HF rounds g, u, silu(g) and the product);
  its down product comes out in f32 and the k outputs are weighted and
  summed in f32, cast once (HF weights bf16 outputs);
- the routed experts run as one grouped product over the tokens
  permuted by expert (``ops/experts.py``), not a loop over experts.

Spans (``utils/trace.py``): ``mla.attention`` around each layer's MLA,
``moe.route`` around the router, the top-k and the permutation,
``moe.experts`` (tokens, token-expert pairs, held pairs) around the
grouped product, the combine and the shared expert; with the input's
device, for CUDA events. ``last_moe_stats`` holds, for the last forward,
the tokens the expert layers computed and how many of them were padding,
the latter a tensor on the input's device (read it after the device
work; nothing syncs here), and the routed and held token-expert pairs.

The sparse layer may hold a share of the experts (``MoE(held=)``, Kimi
Linear's expert-parallel cut): it routes over all of them and computes
its own experts' part. Moonlight's layers hold every expert and run the
path above unchanged.

The model is held whole on one device: over a tensor-parallel group it
is refused (``parallel/sharding.py`` has Qwen2's rules only).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch
from torch import nn

from ..device import resolve_device
from ..ops.experts import grouped_swiglu
from ..parallel.sharding import TPLayout
from ..utils import trace
from .qwen2 import MLP, RMSNorm, _linear, _mask_bias, _rope_cos_sin, _rotate_half
from .qwen2 import init_random_ as _init_random_


@dataclasses.dataclass(frozen=True)
class MoonlightConfig:
    MODEL_TYPE: ClassVar[str] = "deepseek_v3"

    vocab_size: int = 163_840
    hidden_size: int = 2048
    intermediate_size: int = 11_264       # the dense layers' SwiGLU
    moe_intermediate_size: int = 1408     # one routed expert's SwiGLU
    num_layers: int = 27
    first_k_dense_replace: int = 1
    num_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    rope_theta: float = 50_000.0
    rms_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32          # compute dtype
    param_dtype: torch.dtype = torch.float32    # what init_random_ draws in

    @property
    def n_moe_layers(self) -> int:
        return self.num_layers - self.first_k_dense_replace

    @staticmethod
    def tiny(**kw) -> "MoonlightConfig":
        defaults = dict(
            vocab_size=128, hidden_size=32, intermediate_size=64, moe_intermediate_size=16,
            num_layers=3, first_k_dense_replace=1, num_heads=4, kv_lora_rank=16,
            qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8, n_routed_experts=8,
            num_experts_per_tok=3, n_shared_experts=2, rope_theta=10_000.0,
        )
        defaults.update(kw)
        return MoonlightConfig(**defaults)


def _width(cfg: MoonlightConfig, inter: int) -> TPLayout:
    """The layout of one whole SwiGLU of width ``inter`` (``qwen2.MLP``)."""
    return TPLayout(1, 0, (0, cfg.num_heads), (0, cfg.num_heads), (0, inter))


def _deinterleave(x):
    """DeepSeek's rope layout: [x0, x1, x2, x3, ...] -> [x0, x2, ..., x1, x3, ...]."""
    d = x.shape[-1]
    return x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)


def _apply_rope(x, cos, sin):
    """x [B, T, H, rope] de-interleaved, then rotated (rotate-half)."""
    x = _deinterleave(x)
    return x * cos[None, :, None, :] + _rotate_half(x) * sin[None, :, None, :]


class MLA(nn.Module):
    """``rope=False``: the rope dims of q and of the shared key are used
    unrotated (Kimi Linear's ``mla_use_nope``; ``cos`` and ``sin`` are
    then not read)."""

    def __init__(self, cfg: MoonlightConfig, device, rope: bool = True):
        super().__init__()
        self.cfg = cfg
        self.rope = rope
        h, nope, rope = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        self.q_proj = _linear(cfg.hidden_size, h * (nope + rope), False, cfg, device)
        self.kv_a_proj_with_mqa = _linear(cfg.hidden_size, cfg.kv_lora_rank + rope, False, cfg,
                                          device)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps, cfg.dtype, device)
        self.kv_b_proj = _linear(cfg.kv_lora_rank, h * (nope + cfg.v_head_dim), False, cfg,
                                 device)
        self.o_proj = _linear(h * cfg.v_head_dim, cfg.hidden_size, False, cfg, device)

    def forward(self, x, mask_bias, cos, sin):
        cfg = self.cfg
        b, t, _ = x.shape
        h, nope, rope, vd = (cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                             cfg.v_head_dim)
        with trace.span("mla.attention", device=x.device):
            q_nope, q_pe = self.q_proj(x).view(b, t, h, nope + rope).split([nope, rope], -1)
            c, k_pe = self.kv_a_proj_with_mqa(x).split([cfg.kv_lora_rank, rope], -1)
            kv = self.kv_b_proj(self.kv_a_layernorm(c)).view(b, t, h, nope + vd)
            k_nope, v = kv.split([nope, vd], -1)
            k_pe = k_pe.view(b, t, 1, rope)
            if self.rope:
                q_pe, k_pe = _apply_rope(q_pe, cos, sin), _apply_rope(k_pe, cos, sin)
            q = torch.cat([q_nope, q_pe], -1)
            k = torch.cat([k_nope, k_pe.expand(b, t, h, rope)], -1)
            scores = torch.einsum("bthd,bshd->bhts", q, k).float()
            scores = scores * (nope + rope) ** -0.5 + mask_bias
            probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
            out = torch.einsum("bhts,bshd->bthd", probs, v).reshape(b, t, h * vd)
            return self.o_proj(out)


class Router(nn.Module):
    """``gate.weight`` [E, H] in ``dtype`` and ``gate.e_score_correction_bias``
    [E] in f32 (HF's names)."""

    def __init__(self, cfg: MoonlightConfig, device):
        super().__init__()
        e = cfg.n_routed_experts
        self.weight = nn.Parameter(torch.empty((e, cfg.hidden_size), dtype=cfg.dtype,
                                               device=device))
        self.e_score_correction_bias = nn.Parameter(torch.empty(e, dtype=torch.float32,
                                                                device=device))


class Experts(nn.Module):
    """The routed experts held here, stacked: ``w13`` [E, 2I, H], ``w2``
    [E, H, I] (E: ``n``, by default all of the router's)."""

    def __init__(self, cfg: MoonlightConfig, device, n: int | None = None):
        super().__init__()
        e = cfg.n_routed_experts if n is None else n
        h, i = cfg.hidden_size, cfg.moe_intermediate_size
        self.w13 = nn.Parameter(torch.empty((e, 2 * i, h), dtype=cfg.dtype, device=device))
        self.w2 = nn.Parameter(torch.empty((e, h, i), dtype=cfg.dtype, device=device))


def route(x, weight, bias, cfg: MoonlightConfig):
    """Tokens x [N, H] -> (chosen experts [N, k] int64, their weights
    [N, k] f32): sigmoid scores, the choice by score plus correction bias
    (ties to the lowest expert), the weights from the scores alone,
    normalised and scaled."""
    s = torch.sigmoid(x.float() @ weight.float().T)
    idx = torch.sort(s + bias, dim=-1, descending=True, stable=True)[1]
    idx = idx[:, :cfg.num_experts_per_tok]
    w = s.gather(1, idx)
    if cfg.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * cfg.routed_scaling_factor


def permute(x, idx, n_experts: int, held: tuple[int, int] | None = None):
    """Token-expert pairs sorted by expert (tokens in order within one):
    -> (order [P]: each sorted pair's flat index t * k + slot, offsets
    [E + 1] int32, rows [P, H]: the pairs' tokens). ``held``: the first
    and the count of the experts held here, numbered from 0 in
    ``offsets``; the pairs of other experts are dropped, so P is read
    back to the host (one sync). None: every expert, P = N k, no sync."""
    k = idx.shape[1]
    flat = idx.flatten()
    if held is not None:
        first, n_experts = held
        flat = flat - first
        flat = torch.where((flat >= 0) & (flat < n_experts), flat, n_experts)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=n_experts)[:n_experts]
    offsets = torch.zeros(n_experts + 1, dtype=torch.int32, device=x.device)
    offsets[1:] = torch.cumsum(counts, 0)
    if held is not None:
        order = order[:int(offsets[-1])]
    return order, offsets, x[order // k]


def combine(y_sorted, order, w):
    """Expert outputs of the sorted pairs [P, H] f32 -> each token's
    weighted sum over its k experts [N, H] f32 (in slot order); a pair
    not among the P (an expert not held) adds nothing."""
    n, k = w.shape
    y = (torch.empty_like(y_sorted) if order.numel() == w.numel()
         else y_sorted.new_zeros((w.numel(), y_sorted.shape[1])))
    y[order] = y_sorted
    return (y.view(n, k, -1) * w[:, :, None]).sum(1)


class MoE(nn.Module):
    """``held``: (first, count) of the routed experts this device holds
    (an expert-parallel share); None holds them all. The router keeps
    its full width either way; a share computes the part of the output
    that its own experts give (``permute``, ``combine``), and the shared
    experts whole. ``held_pairs``: the token-expert pairs the last
    forward computed."""

    def __init__(self, cfg: MoonlightConfig, device, held: tuple[int, int] | None = None):
        super().__init__()
        self.cfg = cfg
        self.held = held
        self.gate = Router(cfg, device)
        self.experts = Experts(cfg, device, None if held is None else held[1])
        self.shared_experts = MLP(cfg, device,
                                  _width(cfg, cfg.n_shared_experts * cfg.moe_intermediate_size))
        self.held_pairs = 0

    def forward(self, x):
        cfg = self.cfg
        b, t, hd = x.shape
        x2 = x.reshape(b * t, hd)
        with trace.span("moe.route", device=x.device):
            idx, w = route(x2, self.gate.weight, self.gate.e_score_correction_bias, cfg)
            order, offsets, rows = permute(x2, idx, cfg.n_routed_experts, self.held)
        self.held_pairs = order.numel()
        with trace.span("moe.experts", device=x.device, tokens=b * t, pairs=idx.numel(),
                        held_pairs=self.held_pairs):
            y = grouped_swiglu(rows, offsets, self.experts.w13, self.experts.w2)
            out = combine(y, order, w).to(cfg.dtype) + self.shared_experts(x2)
        return out.view(b, t, hd)


class Block(nn.Module):
    def __init__(self, cfg: MoonlightConfig, layer: int, device):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype, device)
        self.self_attn = MLA(cfg, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                                cfg.dtype, device)
        self.mlp = (MLP(cfg, device, _width(cfg, cfg.intermediate_size))
                    if layer < cfg.first_k_dense_replace else MoE(cfg, device))

    def forward(self, x, mask_bias, cos, sin):
        x = x + self.self_attn(self.input_layernorm(x), mask_bias, cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))


def moe_stats(layers, attention_mask, top_k: int) -> dict:
    """The expert layers' work in the last forward: tokens, padding
    tokens (a tensor on the mask's device), routed and held token-expert
    pairs."""
    moe = [layer.mlp for layer in layers if isinstance(layer.mlp, MoE)]
    n = attention_mask.numel()
    return {"tokens": len(moe) * n, "pad_tokens": len(moe) * (attention_mask == 0).sum(),
            "pairs": len(moe) * n * top_k, "held_pairs": sum(m.held_pairs for m in moe)}


def init_random_(module: nn.Module, generator: torch.Generator, param_dtype,
                 std: float = 0.02) -> nn.Module:
    """``qwen2.init_random_`` (linears, embeddings, norms), then the
    router's weight, the correction bias and the stacked experts, N(0,
    ``std``) drawn in ``param_dtype``."""
    _init_random_(module, generator, param_dtype, std)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Router, Experts)):
                for p in m.parameters():
                    w = torch.empty(p.shape, dtype=param_dtype, device=p.device)
                    p.copy_(w.normal_(0.0, std, generator=generator))
    return module


class MoonlightEncoder(nn.Module):
    """Token ids -> final hidden states [B, T, hidden] in ``cfg.dtype``.

    Built on the meta device, then given memory on ``device`` (the card
    by default), uninitialised until ``load_state_dict`` or
    ``init_random_``. ``tp``: refused (the model is held whole)."""

    def __init__(self, cfg: MoonlightConfig, causal: bool = True, *, device=None, tp=None):
        super().__init__()
        if tp is not None and tp.size > 1:
            raise ValueError("the Moonlight backbone runs whole on one device: tensor "
                             "parallelism has rules for the Qwen2 backbone only")
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

    def init_random_(self, generator: torch.Generator, std: float = 0.02):
        return init_random_(self, generator, self.cfg.param_dtype, std)

    def forward(self, input_ids, attention_mask):
        cfg = self.cfg
        b, t = input_ids.shape
        x = self.embed_tokens(input_ids)
        positions = torch.arange(t, device=input_ids.device)
        cos, sin = _rope_cos_sin(positions, cfg.qk_rope_head_dim, cfg.rope_theta, cfg.dtype)
        mask_bias = _mask_bias(attention_mask, self.causal)
        for layer in self.layers:
            x = layer(x, mask_bias, cos, sin)
        self.last_moe_stats = moe_stats(self.layers, attention_mask, cfg.num_experts_per_tok)
        return self.norm(x)
