"""Moonlight-16B-A3B (DeepSeek-V3's block) behind stella's pooling and
MRL head, written plainly from the published architecture for the CPU
tests: plain ``torch`` in f32 with TF32 off, one text at its own length,
one head and one routed expert at a time, no kernel, cache or batching.
It imports nothing of the port.

``w`` holds the tensors under the port's names: ``backbone.*`` (HF's
names, the routed experts of layer i stacked as ``mlp.experts.w13``
[E, 2I, H], gate rows then up rows, and ``mlp.experts.w2`` [E, H, I])
and ``vector_linear.{weight,bias}``. ``c`` is a dict of the HF
config.json's keys (``hidden_size``, ``kv_lora_rank``, ...).

Per layer (``modeling_deepseek.py``): x += MLA(rms(x)); x += FFN(rms(x)).
MLA has no q LoRA; the rope dims are de-interleaved and rotated in the
rotate-half form; the single rope key is shared by all heads; scores
are scaled by (nope + rope)^-0.5. The FFN is a SwiGLU in the first
``first_k_dense_replace`` layers and, after them, sigmoid routing (the
correction bias in the choice only, ties to the lowest expert), the
chosen experts' outputs weighted by their normalised, scaled scores,
plus the shared experts' SwiGLU.
"""

from __future__ import annotations

import torch


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _swiglu(x, gate, up, down):
    return (torch.nn.functional.silu(x @ gate.T) * (x @ up.T)) @ down.T


def _rope(x, theta):
    """x [T, H, d]: DeepSeek's de-interleave, then rotate-half by position."""
    t, _, d = x.shape
    x = torch.cat([x[..., 0::2], x[..., 1::2]], -1)
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32) / d)
    ang = torch.arange(t, dtype=torch.float32)[:, None] * inv[None]
    cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None, :]
    return x * cos + torch.cat([-x[..., d // 2:], x[..., : d // 2]], -1) * sin


def _mla(x, w, p, c):
    t = x.shape[0]
    nh, nope, rope, vd = (c["num_attention_heads"], c["qk_nope_head_dim"],
                          c["qk_rope_head_dim"], c["v_head_dim"])
    q = (x @ w[p + "q_proj.weight"].T).view(t, nh, nope + rope)
    ckv = x @ w[p + "kv_a_proj_with_mqa.weight"].T
    lat, k_pe = ckv[:, : c["kv_lora_rank"]], ckv[:, c["kv_lora_rank"]:]
    kv = (_rms(lat, w[p + "kv_a_layernorm.weight"], c["rms_norm_eps"])
          @ w[p + "kv_b_proj.weight"].T).view(t, nh, nope + vd)
    q_pe = _rope(q[..., nope:], c["rope_theta"])
    k_pe = _rope(k_pe.view(t, 1, rope), c["rope_theta"])[:, 0]
    causal = torch.full((t, t), float("-inf")).triu(1)
    out = torch.empty((t, nh, vd))
    for j in range(nh):
        qj = torch.cat([q[:, j, :nope], q_pe[:, j]], -1)
        kj = torch.cat([kv[:, j, :nope], k_pe], -1)
        s = qj @ kj.T * (nope + rope) ** -0.5 + causal
        out[:, j] = torch.softmax(s, -1) @ kv[:, j, nope:]
    return out.reshape(t, nh * vd) @ w[p + "o_proj.weight"].T


def route(x, gate, bias, c):
    """Tokens [T, H] -> (chosen experts [T, k], in order of choice, and
    their weights [T, k])."""
    k = c["num_experts_per_tok"]
    s = torch.sigmoid(x @ gate.T)
    choice = s + bias
    idx = torch.stack([torch.tensor(sorted(range(len(r)), key=lambda e: (-r[e], e))[:k])
                       for r in choice.tolist()])
    wt = s.gather(1, idx)
    if c["norm_topk_prob"]:
        wt = wt / (wt.sum(-1, keepdim=True) + 1e-20)
    return idx, wt * c["routed_scaling_factor"]


def _moe(x, w, p, c):
    inter = c["moe_intermediate_size"]
    idx, wt = route(x, w[p + "gate.weight"], w[p + "gate.e_score_correction_bias"], c)
    y = torch.zeros_like(x)
    w13, w2 = w[p + "experts.w13"], w[p + "experts.w2"]
    for e in sorted(set(idx.flatten().tolist())):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        y[tok] += wt[tok, slot, None] * _swiglu(x[tok], w13[e, :inter], w13[e, inter:], w2[e])
    return y + _swiglu(x, w[p + "shared_experts.gate_proj.weight"],
                       w[p + "shared_experts.up_proj.weight"],
                       w[p + "shared_experts.down_proj.weight"])


def hidden(ids: list, w: dict, c: dict) -> torch.Tensor:
    """Token ids of one text -> its final hidden states [T, H] f32."""
    w = {k: v.float() for k, v in w.items()}
    eps = c["rms_norm_eps"]
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            x = w["backbone.embed_tokens.weight"][torch.tensor(ids)]
            for i in range(c["num_hidden_layers"]):
                p = f"backbone.layers.{i}."
                x = x + _mla(_rms(x, w[p + "input_layernorm.weight"], eps), w,
                             p + "self_attn.", c)
                a = _rms(x, w[p + "post_attention_layernorm.weight"], eps)
                if i < c["first_k_dense_replace"]:
                    x = x + _swiglu(a, w[p + "mlp.gate_proj.weight"], w[p + "mlp.up_proj.weight"],
                                    w[p + "mlp.down_proj.weight"])
                else:
                    x = x + _moe(a, w, p + "mlp.", c)
            return _rms(x, w["backbone.norm.weight"], eps)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def embed(ids: list, w: dict, c: dict) -> torch.Tensor:
    """Token ids of one text -> its unit embedding [mrl_dim] f32: mean
    pooling over the text, the MRL head with its bias, L2 normalised."""
    pooled = hidden(ids, w, c).mean(0)
    e = pooled @ w["vector_linear.weight"].float().T + w["vector_linear.bias"].float()
    return e / e.norm().clamp_min(1e-12)
