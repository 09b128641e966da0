"""Kimi Linear's side of the yardstick: its configuration as run, its
tensors made from the seed, and the operations and bytes of its KDA
kernel and of a whole forward.

Both sides get the tensors: the program through its own entry points,
the plain reference (``reference/kimi_linear.py``) one layer at a time
after the window. Each tensor is one generator call keyed by the seed
and its name, so any one of them can be made again alone. The texts,
prompts and the expert kernel's count are Moonlight's
(``yardstick/moonlight.py``). Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch

from . import corpus


def encoder(config: dict) -> dict:
    """The configuration's model keys (the catalog's at its top level,
    ``linear_attn_config`` and the ``expert_share`` among them) with its
    ``encoder`` run settings."""
    keep = ("linear_attn_config", "expert_share")
    return {**{k: v for k, v in config.items()
               if not isinstance(v, (dict, list)) or k in keep},
            **config["encoder"]}


def kda_layers(enc: dict) -> set:
    """The 0-based layers whose mixer is KDA."""
    return {i - 1 for i in enc["linear_attn_config"]["kda_layers"]}


def _kda_shapes(enc: dict, p: str) -> list:
    lin = enc["linear_attn_config"]
    h, nh, d = enc["hidden_size"], lin["num_heads"], lin["head_dim"]
    proj, width = nh * d, lin["short_conv_kernel_size"]
    out = []
    for x in ("q", "k", "v"):
        out += [(p + f"{x}_proj.weight", (proj, h), "weight"),
                (p + f"{x}_conv1d.weight", (proj, 1, width), "weight")]
    return out + [(p + "f_a_proj.weight", (d, h), "weight"),
                  (p + "f_b_proj.weight", (proj, d), "weight"),
                  (p + "A_log", (nh,), "A_log"),
                  (p + "dt_bias", (proj,), "dt_bias"),
                  (p + "b_proj.weight", (nh, h), "weight"),
                  (p + "g_a_proj.weight", (d, h), "weight"),
                  (p + "g_b_proj.weight", (proj, d), "weight"),
                  (p + "g_b_proj.bias", (proj,), "bias"),
                  (p + "o_norm.weight", (d,), "norm"),
                  (p + "o_proj.weight", (h, proj), "weight")]


def _mla_shapes(enc: dict, p: str) -> list:
    h, r = enc["hidden_size"], enc["kv_lora_rank"]
    nh, nope, rope, vd = (enc["num_attention_heads"], enc["qk_nope_head_dim"],
                          enc["qk_rope_head_dim"], enc["v_head_dim"])
    return [(p + "q_proj.weight", (nh * (nope + rope), h), "weight"),
            (p + "kv_a_proj_with_mqa.weight", (r + rope, h), "weight"),
            (p + "kv_a_layernorm.weight", (r,), "norm"),
            (p + "kv_b_proj.weight", (nh * (nope + vd), r), "weight"),
            (p + "o_proj.weight", (h, nh * vd), "weight")]


def layer_shapes(enc: dict, i: int) -> list:
    """(name, shape, kind) of layer ``i``'s tensors under the port's names
    (the held routed experts stacked: ``w13`` [E, 2I, H], gate rows then
    up rows, and ``w2`` [E, H, I], E the held count); kind "weight",
    "bias", "norm", "A_log" or "dt_bias"."""
    h = enc["hidden_size"]
    p = f"backbone.layers.{i}."
    mixer = (_kda_shapes if i in kda_layers(enc) else _mla_shapes)(enc, p + "self_attn.")
    out = ([(p + "input_layernorm.weight", (h,), "norm")] + mixer
           + [(p + "post_attention_layernorm.weight", (h,), "norm")])
    if i < enc["first_k_dense_replace"]:
        inter = enc["intermediate_size"]
        return out + [(p + "mlp.gate_proj.weight", (inter, h), "weight"),
                      (p + "mlp.up_proj.weight", (inter, h), "weight"),
                      (p + "mlp.down_proj.weight", (h, inter), "weight")]
    e, ie = enc["num_experts"], enc["moe_intermediate_size"]
    router, s = enc["expert_share"]["router_experts"], enc["num_shared_experts"] * ie
    return out + [(p + "mlp.gate.weight", (router, h), "weight"),
                  (p + "mlp.gate.e_score_correction_bias", (router,), "bias"),
                  (p + "mlp.experts.w13", (e, 2 * ie, h), "weight"),
                  (p + "mlp.experts.w2", (e, h, ie), "weight"),
                  (p + "mlp.shared_experts.gate_proj.weight", (s, h), "weight"),
                  (p + "mlp.shared_experts.up_proj.weight", (s, h), "weight"),
                  (p + "mlp.shared_experts.down_proj.weight", (h, s), "weight")]


def shapes(enc: dict) -> list:
    """(name, shape, kind) of every tensor of the stella-wrapped encoder."""
    h = enc["hidden_size"]
    out = [("backbone.embed_tokens.weight", (enc["vocab_size"], h), "weight")]
    for i in range(enc["num_hidden_layers"]):
        out += layer_shapes(enc, i)
    return out + [("backbone.norm.weight", (h,), "norm"),
                  ("vector_linear.weight", (enc["mrl_dim"], h), "weight"),
                  ("vector_linear.bias", (enc["mrl_dim"],), "bias")]


def tensor(seed: int, name: str, shape, kind: str, device, std: float = 0.02) -> torch.Tensor:
    """One tensor, made from (seed, name) alone: N(0, std) drawn in bf16
    on ``device``; a norm scale 1 + that, and a correction bias, in f32;
    KDA's decay parameters as the published initialisation draws them,
    in f32: ``A_log`` = log A, A uniform in [1, 16]; ``dt_bias`` the
    inverse softplus of dt, log-uniform in [1e-3, 1e-1]."""
    g = corpus.generator(seed, "kimi_linear", name, device=device)
    if kind in ("A_log", "dt_bias"):
        u = torch.rand(tuple(shape), dtype=torch.float32, device=device, generator=g)
        if kind == "A_log":
            return torch.log(1.0 + 15.0 * u)
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        return dt + torch.log(-torch.expm1(-dt))
    t = torch.empty(tuple(shape), dtype=torch.bfloat16, device=device).normal_(0.0, std,
                                                                              generator=g)
    if kind == "norm":
        return 1.0 + t.float()
    if name.endswith("e_score_correction_bias"):
        return t.float()
    return t


def kda_cost(b: int, t: int, h: int, d: int) -> tuple:
    """The KDA kernel on [b, t, h, d] (``ops/kda.py``): -> (ops, bytes).
    Operations: the recurrence's 7 d^2 a token and head (the decay, the
    prediction k^T S, the write, the read q^T S; whatever implements
    it). Bytes: q, k, v (bf16), the log-decays (f32) and beta (f32) in
    once, o (bf16) out once."""
    tokens = float(b) * t * h
    return 7.0 * tokens * d * d, tokens * (2 * 3 * d + 4 * d + 4 + 2 * d)


def active_weights(enc: dict) -> dict:
    """Weights that multiply each token, by part: the KDA and MLA mixers,
    the dense SwiGLU, an expert layer's router and shared expert, one
    routed expert; the embedding is a gather, the MRL head runs once a
    text."""
    h, r = enc["hidden_size"], enc["kv_lora_rank"]
    lin = enc["linear_attn_config"]
    nh, d = lin["num_heads"], lin["head_dim"]
    proj = nh * d
    mh, nope, rope, vd = (enc["num_attention_heads"], enc["qk_nope_head_dim"],
                          enc["qk_rope_head_dim"], enc["v_head_dim"])
    ie = enc["moe_intermediate_size"]
    return {"kda": 4 * h * proj + 2 * h * d + 2 * d * proj + h * nh,
            "mla": h * mh * (nope + rope) + h * (r + rope) + r * mh * (nope + vd) + mh * vd * h,
            "dense": 3 * h * enc["intermediate_size"],
            "moe": h * enc["expert_share"]["router_experts"]
            + 3 * h * enc["num_shared_experts"] * ie,
            "expert": 3 * h * ie}


def flops(enc: dict, lengths, held_share: float) -> float:
    """Operations of the encoder over texts of these real lengths: 2 per
    active weight a token (of the routed experts, the held pairs only:
    ``held_share`` of the top-k's), KDA's recurrence 7 d^2 a token and
    head, MLA's causal q.k and p.v (t (t + 1) / 2 pairs a head, of
    nope + rope and v wide), the MRL head once a text."""
    w = active_weights(enc)
    lin = enc["linear_attn_config"]
    n = enc["num_hidden_layers"]
    n_kda = len(lin["kda_layers"])
    n_dense = enc["first_k_dense_replace"]
    per_token = 2.0 * (n_kda * w["kda"] + (n - n_kda) * w["mla"] + n_dense * w["dense"]
                       + (n - n_dense) * (w["moe"] + held_share
                                          * enc["num_experts_per_token"] * w["expert"]))
    per_token += 7.0 * n_kda * lin["num_heads"] * lin["head_dim"] ** 2
    att = (2.0 * enc["num_attention_heads"] * (n - n_kda)
           * (enc["qk_nope_head_dim"] + enc["qk_rope_head_dim"] + enc["v_head_dim"]))
    head = 2.0 * enc["hidden_size"] * enc["mrl_dim"]
    return float(sum(per_token * t + att * t * (t + 1) / 2 + head for t in lengths))
