"""Moonlight's side of the yardstick: its configuration as run, its
tensors made from the seed, the abstract-length texts, and the
operations and bytes of its expert kernel and of a whole forward.

Both sides get the tensors: the program through its own entry points,
the plain reference (``reference/moonlight.py``) one layer at a time
after the window. Each tensor is one generator call keyed by the seed
and its name, so any one of them can be made again alone. Nothing here
imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import corpus

# stella's config_sentence_transformers.json query prompts (the port's
# PROMPTS), frozen here
PROMPTS = {
    "s2s_query": "Instruct: Retrieve semantically similar text.\nQuery: ",
}


def encoder(config: dict) -> dict:
    """The configuration's model keys (the catalog's, at its top level)
    with its ``encoder`` run settings."""
    return {**{k: v for k, v in config.items() if not isinstance(v, (dict, list))},
            **config["encoder"]}


def layer_shapes(enc: dict, i: int) -> list:
    """(name, shape, kind) of layer ``i``'s tensors under the port's names
    (the routed experts stacked: ``w13`` [E, 2I, H], gate rows then up
    rows, and ``w2`` [E, H, I]); kind "weight", "bias" or "norm"."""
    h, r = enc["hidden_size"], enc["kv_lora_rank"]
    nh, nope, rope, vd = (enc["num_attention_heads"], enc["qk_nope_head_dim"],
                          enc["qk_rope_head_dim"], enc["v_head_dim"])
    p = f"backbone.layers.{i}."
    out = [(p + "input_layernorm.weight", (h,), "norm"),
           (p + "self_attn.q_proj.weight", (nh * (nope + rope), h), "weight"),
           (p + "self_attn.kv_a_proj_with_mqa.weight", (r + rope, h), "weight"),
           (p + "self_attn.kv_a_layernorm.weight", (r,), "norm"),
           (p + "self_attn.kv_b_proj.weight", (nh * (nope + vd), r), "weight"),
           (p + "self_attn.o_proj.weight", (h, nh * vd), "weight"),
           (p + "post_attention_layernorm.weight", (h,), "norm")]
    if i < enc["first_k_dense_replace"]:
        inter = enc["intermediate_size"]
        return out + [(p + "mlp.gate_proj.weight", (inter, h), "weight"),
                      (p + "mlp.up_proj.weight", (inter, h), "weight"),
                      (p + "mlp.down_proj.weight", (h, inter), "weight")]
    e, ie = enc["n_routed_experts"], enc["moe_intermediate_size"]
    s = enc["n_shared_experts"] * ie
    return out + [(p + "mlp.gate.weight", (e, h), "weight"),
                  (p + "mlp.gate.e_score_correction_bias", (e,), "bias"),
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
    on ``device``; a norm scale 1 + that, and a correction bias, in f32."""
    g = corpus.generator(seed, "moonlight", name, device=device)
    t = torch.empty(tuple(shape), dtype=torch.bfloat16, device=device).normal_(0.0, std,
                                                                              generator=g)
    if kind == "norm":
        return 1.0 + t.float()
    if name.endswith("e_score_correction_bias"):
        return t.float()
    return t


def abstract_texts(n: int, seed: int, vocab: list, median: float, sigma: float, low: int,
                   high: int, zipf: float) -> list:
    """``n`` abstract-length texts: word counts lognormal (``median``,
    ``sigma``) clipped to [low, high]; words drawn from ``vocab`` by
    Zipf's law (rank r of the vocabulary's order with weight r^-zipf)."""
    r = corpus.rng(seed, "abstracts")
    counts = np.clip(np.round(median * np.exp(sigma * r.standard_normal(n))), low,
                     high).astype(np.int64)
    p = np.arange(1, len(vocab) + 1, dtype=np.float64) ** -zipf
    words = r.choice(len(vocab), int(counts.sum()), p=p / p.sum())
    out, at = [], 0
    for c in counts.tolist():
        out.append(" ".join(vocab[j] for j in words[at: at + c]))
        at += c
    return out


def experts_cost(pairs: int, touched: int, h: int, inter: int) -> tuple:
    """The grouped expert product (``ops/experts.py``): -> (ops, bytes).
    Operations: the gate, up and down products of every token-expert
    pair (bf16). Bytes: each touched expert's weights once, the pairs'
    rows in (bf16) and out (f32) once."""
    ops = 2.0 * pairs * 3 * h * inter
    moved = 2.0 * touched * 3 * h * inter + 2.0 * pairs * h + 4.0 * pairs * h
    return ops, moved


def active_weights(enc: dict) -> tuple:
    """Weights that multiply each token: (in a dense layer, in an expert
    layer); the embedding is a gather, the MRL head runs once a text."""
    h, r = enc["hidden_size"], enc["kv_lora_rank"]
    nh, nope, rope, vd = (enc["num_attention_heads"], enc["qk_nope_head_dim"],
                          enc["qk_rope_head_dim"], enc["v_head_dim"])
    mla = h * nh * (nope + rope) + h * (r + rope) + r * nh * (nope + vd) + nh * vd * h
    dense = mla + 3 * h * enc["intermediate_size"]
    ie = enc["moe_intermediate_size"]
    moe = (mla + h * enc["n_routed_experts"] + enc["num_experts_per_tok"] * 3 * h * ie
           + 3 * h * enc["n_shared_experts"] * ie)
    return dense, moe


def flops(enc: dict, lengths) -> float:
    """Operations of the encoder over texts of these real lengths: 2 per
    active weight per token, q.k and p.v over each text (2 t^2 heads
    (nope + rope + v) a layer), the MRL head once a text."""
    dense, moe = active_weights(enc)
    n_dense = enc["first_k_dense_replace"]
    per_token = 2.0 * (n_dense * dense + (enc["num_hidden_layers"] - n_dense) * moe)
    att = (2.0 * enc["num_attention_heads"] * enc["num_hidden_layers"]
           * (enc["qk_nope_head_dim"] + enc["qk_rope_head_dim"] + enc["v_head_dim"]))
    head = 2.0 * enc["hidden_size"] * enc["mrl_dim"]
    return float(sum(per_token * t + att * t * t + head for t in lengths))
