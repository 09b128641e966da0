"""Kimi-Linear-48B-A3B behind stella's pooling and MRL head, written from
the published architecture in plain PyTorch: the judge of the Kimi
Linear cell's embeddings.

The block (the Kimi Linear technical report; flash-linear-attention's
``KimiDeltaAttention``): x += Mixer(rms(x)), x += FFN(rms(x)), a final
RMSNorm. The mixer is KDA in ``linear_attn_config``'s ``kda_layers``
(1-based) and MLA in the others.

KDA (heads of ``head_dim`` d): q, k, v = silu(causal depthwise convolution
of width ``short_conv_kernel_size`` over each projection); q = q / |q|
d^-0.5, k = k / |k| (|x| = sqrt(sum x^2 + 1e-6)); log-decays g =
-exp(A_log) softplus(f_b(f_a(x)) + dt_bias), per channel; beta =
sigmoid(b(x)), per head; then, token by token from S = 0, S = Diag(exp
g) S, S += beta k (v - k^T S)^T, o = S^T q; y = o_proj(rms(o) o_norm
sigmoid(g_b(g_a(x)))). The recurrence is taken one token at a time with
every head of the token in one batched product (the heads share no
arithmetic; one at a time would take 32 times as long on the card).

MLA with ``mla_use_nope``: no q LoRA, a compressed KV latent
(``kv_lora_rank``) normalised by its own RMSNorm and lifted to k_nope and
v, the one rope key shared by all heads and used unrotated, scores
scaled by (nope + rope)^-0.5, causal, one head at a time.

The FFN: a SwiGLU in the first ``first_k_dense_replace`` layers; then
sigmoid router scores over all ``router_experts`` of the
``expert_share``, the top ``num_experts_per_token`` chosen by score plus
``e_score_correction_bias`` (ties to the lowest expert), weighted by
their scores normalised over all chosen and scaled by
``routed_scaling_factor``; of those, the held experts' outputs (the
share's ``first`` .. ``first + count - 1``) one expert at a time, plus
the shared expert. Then mean pooling over the text, the MRL head with
its bias, L2 normalisation.

One text at a time at its own length, no padding, batching, chunking,
cache or kernel, in f32 with TF32 off. It runs layer by layer over all
the texts it checks: each layer's tensors are made again from the seed
(``yardstick/kimi_linear.py``), upcast to f32, used and freed, so it fits
on the card once the program is gone. With ``kind="e4m3"`` every
product takes its operands rounded to 3 mantissa bits (e4m3's; the
exponent is kept), one step below the bf16 the deployment serves in:
the control. Imports nothing of the program.
"""

from __future__ import annotations

import torch

from ..yardstick import kimi_linear as yk
from .moonlight import mm
from .stella import exact_f32


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _swiglu(x, gate, up, down, kind):
    return mm(torch.nn.functional.silu(mm(x, gate.T, kind)) * mm(x, up.T, kind), down.T, kind)


def _conv(x, w):
    """x [T, D], w [D, 1, width]: silu(sum_j w_j x_{t - width + 1 + j})."""
    width, t = w.shape[-1], x.shape[0]
    xp = torch.cat([torch.zeros((width - 1, x.shape[1]), device=x.device), x])
    return torch.nn.functional.silu(sum(w[:, 0, j] * xp[j:j + t] for j in range(width)))


def _unit(x):
    return x / torch.sqrt(x.pow(2).sum(-1, keepdim=True) + 1e-6)


def _kda(x, w, p, enc, kind):
    lin = enc["linear_attn_config"]
    t, nh, d = x.shape[0], lin["num_heads"], lin["head_dim"]
    proj = {n: _conv(mm(x, w[p + f"{n}_proj.weight"].T, kind), w[p + f"{n}_conv1d.weight"])
            for n in ("q", "k", "v")}
    q = _unit(proj["q"].view(t, nh, d)) * d ** -0.5
    k = _unit(proj["k"].view(t, nh, d))
    v = proj["v"].view(t, nh, d)
    f = mm(mm(x, w[p + "f_a_proj.weight"].T, kind), w[p + "f_b_proj.weight"].T, kind)
    g = -w[p + "A_log"].exp()[:, None] * torch.nn.functional.softplus(
        (f + w[p + "dt_bias"]).view(t, nh, d))
    beta = torch.sigmoid(mm(x, w[p + "b_proj.weight"].T, kind))
    gate = torch.sigmoid(mm(mm(x, w[p + "g_a_proj.weight"].T, kind), w[p + "g_b_proj.weight"].T,
                            kind) + w[p + "g_b_proj.bias"]).view(t, nh, d)
    s = torch.zeros((nh, d, d), device=x.device)
    o = torch.empty((t, nh, d), device=x.device)
    for i in range(t):
        s = g[i].exp()[:, :, None] * s
        pred = mm(k[i][:, None, :], s, kind)[:, 0]                       # k^T S  [nh, d]
        s = s + mm((beta[i][:, None] * k[i])[:, :, None], (v[i] - pred)[:, None, :], kind)
        o[i] = mm(q[i][:, None, :], s, kind)[:, 0]
    o = _rms(o, w[p + "o_norm.weight"], enc["rms_norm_eps"]) * gate
    return mm(o.reshape(t, nh * d), w[p + "o_proj.weight"].T, kind)


def _mla(x, w, p, enc, kind):
    t = x.shape[0]
    nh, nope, rope, vd = (enc["num_attention_heads"], enc["qk_nope_head_dim"],
                          enc["qk_rope_head_dim"], enc["v_head_dim"])
    r = enc["kv_lora_rank"]
    q = mm(x, w[p + "q_proj.weight"].T, kind).view(t, nh, nope + rope)
    ckv = mm(x, w[p + "kv_a_proj_with_mqa.weight"].T, kind)
    kv = mm(_rms(ckv[:, :r], w[p + "kv_a_layernorm.weight"], enc["rms_norm_eps"]),
            w[p + "kv_b_proj.weight"].T, kind).view(t, nh, nope + vd)
    causal = torch.full((t, t), float("-inf"), device=x.device).triu(1)
    out = torch.empty((t, nh, vd), device=x.device)
    for j in range(nh):
        kj = torch.cat([kv[:, j, :nope], ckv[:, r:]], -1)
        s = mm(q[:, j], kj.T, kind) * (nope + rope) ** -0.5 + causal
        out[:, j] = mm(torch.softmax(s, -1), kv[:, j, nope:], kind)
    return mm(out.reshape(t, nh * vd), w[p + "o_proj.weight"].T, kind)


def _moe(x, w, p, enc, kind):
    k, ie = enc["num_experts_per_token"], enc["moe_intermediate_size"]
    share = enc["expert_share"]
    s = torch.sigmoid(mm(x, w[p + "gate.weight"].T, kind))
    choice = s + w[p + "gate.e_score_correction_bias"]
    idx = torch.sort(choice, dim=-1, descending=True, stable=True)[1][:, :k]
    wt = s.gather(1, idx)
    if enc["moe_renormalize"]:
        wt = wt / (wt.sum(-1, keepdim=True) + 1e-20)
    wt = wt * enc["routed_scaling_factor"]
    y = torch.zeros_like(x)
    w13, w2 = w[p + "experts.w13"], w[p + "experts.w2"]
    for e in torch.unique(idx).tolist():
        here = e - share["first"]
        if not 0 <= here < share["count"]:
            continue
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        y[tok] += wt[tok, slot, None] * _swiglu(x[tok], w13[here, :ie], w13[here, ie:], w2[here],
                                                kind)
    return y + _swiglu(x, w[p + "shared_experts.gate_proj.weight"],
                       w[p + "shared_experts.up_proj.weight"],
                       w[p + "shared_experts.down_proj.weight"], kind)


def _layer(x, w, i, enc, kind):
    p, eps = f"backbone.layers.{i}.", enc["rms_norm_eps"]
    mixer = _kda if i in yk.kda_layers(enc) else _mla
    x = x + mixer(_rms(x, w[p + "input_layernorm.weight"], eps), w, p + "self_attn.", enc, kind)
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
        return yk.tensor(seed, name, shape, kind_of, device).float()

    with exact_f32(), torch.no_grad():
        table = made("backbone.embed_tokens.weight",
                     (enc["vocab_size"], enc["hidden_size"]), "weight")
        xs = [table[torch.tensor(t, device=device)] for t in ids]
        del table
        for i in range(enc["num_hidden_layers"]):
            w = {name: made(name, shape, kd) for name, shape, kd in yk.layer_shapes(enc, i)}
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
