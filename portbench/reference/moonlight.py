"""Moonlight-16B-A3B behind stella's pooling and MRL head, written from
the published architecture in plain PyTorch: the judge of the Moonlight
cell's embeddings.

DeepSeek-V3's block (``modeling_deepseek.py``): x += MLA(rms(x)),
x += FFN(rms(x)), a final RMSNorm. MLA without q LoRA: q [T, h, nope +
rope]; a compressed KV latent (``kv_lora_rank``) normalised by its own
RMSNorm and lifted to k_nope and v; one rope key shared by all heads;
the rope dims de-interleaved, then rotated in the rotate-half form at
``rope_theta``; scores scaled by (nope + rope)^-0.5, causal. The FFN: a
SwiGLU in the first ``first_k_dense_replace`` layers; then sigmoid
router scores, the top ``num_experts_per_tok`` chosen by score plus
``e_score_correction_bias`` (ties to the lowest expert), weighted by
their scores normalised to sum 1 and scaled by
``routed_scaling_factor``, plus the shared experts' SwiGLU. Then mean
pooling over the text, the MRL head with its bias, L2 normalisation.

One text at a time at its own length, one head and one routed expert at
a time, no padding, batching, cache or kernel, in f32 with TF32 off. It
runs layer by layer over all the texts it checks: each layer's tensors
are made again from the seed (``yardstick/moonlight.py``), upcast to
f32, used and freed, so it fits on the card once the program is gone.
With ``kind="e4m3"`` every product takes its operands rounded to 3
mantissa bits (e4m3's; the exponent is kept), one step below the bf16
the deployment serves in: the control. Imports nothing of the program.
"""

from __future__ import annotations

import torch

from ..yardstick import moonlight as ym
from .stella import exact_f32

MANTISSA = {"f32": 23, "e4m3": 3}


def rounded(x: torch.Tensor, kind: str) -> torch.Tensor:
    """f32 values rounded to ``kind``'s mantissa bits (nearest, ties away
    from zero)."""
    drop = 23 - MANTISSA[kind]
    if not drop:
        return x
    i = x.float().contiguous().view(torch.int32)
    return ((i + (1 << (drop - 1))) & -(1 << drop)).view(torch.float32)


def mm(a, b, kind: str):
    return rounded(a, kind) @ rounded(b, kind)


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _swiglu(x, gate, up, down, kind):
    return mm(torch.nn.functional.silu(mm(x, gate.T, kind)) * mm(x, up.T, kind), down.T, kind)


def _rope(x, theta):
    """x [T, H, d]: de-interleaved ([x0, x2, ..., x1, x3, ...]), then
    rotated by position in the rotate-half form."""
    t, _, d = x.shape
    x = torch.cat([x[..., 0::2], x[..., 1::2]], -1)
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d)
    ang = torch.arange(t, device=x.device, dtype=torch.float32)[:, None] * inv[None]
    cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None, :]
    return x * cos + torch.cat([-x[..., d // 2:], x[..., : d // 2]], -1) * sin


def _mla(x, w, p, enc, kind):
    t = x.shape[0]
    nh, nope, rope, vd = (enc["num_attention_heads"], enc["qk_nope_head_dim"],
                          enc["qk_rope_head_dim"], enc["v_head_dim"])
    r = enc["kv_lora_rank"]
    q = mm(x, w[p + "q_proj.weight"].T, kind).view(t, nh, nope + rope)
    ckv = mm(x, w[p + "kv_a_proj_with_mqa.weight"].T, kind)
    kv = mm(_rms(ckv[:, :r], w[p + "kv_a_layernorm.weight"], enc["rms_norm_eps"]),
            w[p + "kv_b_proj.weight"].T, kind).view(t, nh, nope + vd)
    q_pe = _rope(q[..., nope:], enc["rope_theta"])
    k_pe = _rope(ckv[:, r:].reshape(t, 1, rope), enc["rope_theta"])[:, 0]
    causal = torch.full((t, t), float("-inf"), device=x.device).triu(1)
    out = torch.empty((t, nh, vd), device=x.device)
    for j in range(nh):
        qj = torch.cat([q[:, j, :nope], q_pe[:, j]], -1)
        kj = torch.cat([kv[:, j, :nope], k_pe], -1)
        s = mm(qj, kj.T, kind) * (nope + rope) ** -0.5 + causal
        out[:, j] = mm(torch.softmax(s, -1), kv[:, j, nope:], kind)
    return mm(out.reshape(t, nh * vd), w[p + "o_proj.weight"].T, kind)


def _moe(x, w, p, enc, kind):
    k, ie = enc["num_experts_per_tok"], enc["moe_intermediate_size"]
    s = torch.sigmoid(mm(x, w[p + "gate.weight"].T, kind))
    choice = s + w[p + "gate.e_score_correction_bias"]
    idx = torch.sort(choice, dim=-1, descending=True, stable=True)[1][:, :k]
    wt = s.gather(1, idx)
    if enc["norm_topk_prob"]:
        wt = wt / (wt.sum(-1, keepdim=True) + 1e-20)
    wt = wt * enc["routed_scaling_factor"]
    y = torch.zeros_like(x)
    w13, w2 = w[p + "experts.w13"], w[p + "experts.w2"]
    for e in torch.unique(idx).tolist():
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        y[tok] += wt[tok, slot, None] * _swiglu(x[tok], w13[e, :ie], w13[e, ie:], w2[e], kind)
    return y + _swiglu(x, w[p + "shared_experts.gate_proj.weight"],
                       w[p + "shared_experts.up_proj.weight"],
                       w[p + "shared_experts.down_proj.weight"], kind)


def _layer(x, w, i, enc, kind):
    p, eps = f"backbone.layers.{i}.", enc["rms_norm_eps"]
    x = x + _mla(_rms(x, w[p + "input_layernorm.weight"], eps), w, p + "self_attn.", enc, kind)
    a = _rms(x, w[p + "post_attention_layernorm.weight"], eps)
    if i < enc["first_k_dense_replace"]:
        return x + _swiglu(a, w[p + "mlp.gate_proj.weight"], w[p + "mlp.up_proj.weight"],
                           w[p + "mlp.down_proj.weight"], kind)
    return x + _moe(a, w, p + "mlp.", enc, kind)


def embed_texts(texts: list, tokenize, prompt: str, enc: dict, seed: int, device,
                kind: str = "f32") -> torch.Tensor:
    """Prompted texts -> [n, mrl_dim] f32 unit embeddings, every product
    in ``kind``; the weights made from ``seed`` on ``device``."""
    cap = enc["seq_buckets"][-1]
    ids = [list(tokenize(prompt + t))[:cap] for t in texts]

    def made(name, shape, kind_of):
        return ym.tensor(seed, name, shape, kind_of, device).float()

    with exact_f32(), torch.no_grad():
        table = made("backbone.embed_tokens.weight",
                     (enc["vocab_size"], enc["hidden_size"]), "weight")
        xs = [table[torch.tensor(t, device=device)] for t in ids]
        del table
        for i in range(enc["num_hidden_layers"]):
            w = {name: made(name, shape, kd) for name, shape, kd in ym.layer_shapes(enc, i)}
            xs = [_layer(x, w, i, enc, kind) for x in xs]
            del w
        norm = made("backbone.norm.weight", (enc["hidden_size"],), "norm")
        head = made("vector_linear.weight", (enc["mrl_dim"], enc["hidden_size"]), "weight")
        bias = made("vector_linear.bias", (enc["mrl_dim"],), "bias")
        out = []
        for x in xs:
            pooled = _rms(x, norm, enc["rms_norm_eps"]).mean(0)
            e = mm(pooled[None], head.T, kind)[0] + bias
            out.append(e / e.norm().clamp_min(1e-12))
        return torch.stack(out)
