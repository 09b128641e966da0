"""Kimi-Linear-48B-A3B behind stella's pooling and MRL head, written
plainly from the published architecture for the CPU tests: plain
``torch`` in f32 with TF32 off, one text at its own length, one head and
one routed expert at a time, no kernel, cache, chunking or batching. It
imports nothing of the port.

``w`` holds the tensors under the port's names: ``backbone.*`` (HF's
names, the held routed experts of layer i stacked as ``mlp.experts.w13``
[E, 2I, H], gate rows then up rows, and ``mlp.experts.w2`` [E, H, I])
and ``vector_linear.{weight,bias}``. ``c`` is a dict of the HF
config.json's keys (``hidden_size``, ``linear_attn_config``, ...), with
``expert_share`` (``router_experts``, ``first``, ``count``) where the
layers hold a share of the experts.

Per layer: x += Mixer(rms(x)); x += FFN(rms(x)); a final RMSNorm. The
mixer is KDA in the 1-based ``kda_layers`` and MLA elsewhere.

KDA, per head (d = ``head_dim``): q, k, v = silu(causal depthwise conv of
width ``short_conv_kernel_size`` over the projections); q = q / |q| *
d^-0.5, k = k / |k| (|x| = sqrt(sum x^2 + 1e-6)); log-decays
g = -exp(A_log) softplus(f_b(f_a(x)) + dt_bias); beta = sigmoid(b(x));
then token by token S = Diag(exp g) S; S += beta k (v - k^T S)^T; o =
S^T q; then y = o_proj(rms(o) * o_norm * sigmoid(g_b(g_a(x)))).

MLA with ``mla_use_nope``: no q LoRA, the one rope key shared by all
heads and used unrotated, scores scaled by (nope + rope)^-0.5, causal.

The FFN: a SwiGLU in the first ``first_k_dense_replace`` layers; then
sigmoid router scores over all ``router_experts``, the top
``num_experts_per_token`` chosen by score plus correction bias (ties to
the lowest expert), weighted by their scores normalised over all chosen
and scaled; of those, only the held experts' outputs are added (a share
of the layer, numbered from ``first``), plus the shared expert's SwiGLU.
"""

from __future__ import annotations

import torch


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _swiglu(x, gate, up, down):
    return (torch.nn.functional.silu(x @ gate.T) * (x @ up.T)) @ down.T


def _conv(x, w):
    """x [T, D], w [D, 1, width]: y_t = sum_j w_j x_{t - width + 1 + j}."""
    width = w.shape[-1]
    xp = torch.cat([torch.zeros(width - 1, x.shape[1]), x])
    y = sum(w[:, 0, j] * xp[j:j + x.shape[0]] for j in range(width))
    return torch.nn.functional.silu(y)


def _unit(x):
    return x / torch.sqrt(x.pow(2).sum(-1, keepdim=True) + 1e-6)


def kda_head(q, k, v, g, beta):
    """One head's recurrence: q, k [T, d], v [T, dv], log-decays g [T, d],
    beta [T] -> o [T, dv]."""
    s = torch.zeros(k.shape[1], v.shape[1])
    out = torch.empty(q.shape[0], v.shape[1])
    for t in range(q.shape[0]):
        s = g[t].exp()[:, None] * s
        s = s + beta[t] * torch.outer(k[t], v[t] - k[t] @ s)
        out[t] = q[t] @ s
    return out


def _kda(x, w, p, c):
    lin = c["linear_attn_config"]
    t, nh, d = x.shape[0], lin["num_heads"], lin["head_dim"]
    q = _conv(x @ w[p + "q_proj.weight"].T, w[p + "q_conv1d.weight"]).view(t, nh, d)
    k = _conv(x @ w[p + "k_proj.weight"].T, w[p + "k_conv1d.weight"]).view(t, nh, d)
    v = _conv(x @ w[p + "v_proj.weight"].T, w[p + "v_conv1d.weight"]).view(t, nh, d)
    f = (x @ w[p + "f_a_proj.weight"].T) @ w[p + "f_b_proj.weight"].T + w[p + "dt_bias"]
    g = -w[p + "A_log"].exp()[:, None] * torch.nn.functional.softplus(f.view(t, nh, d))
    beta = torch.sigmoid(x @ w[p + "b_proj.weight"].T)
    gate = torch.sigmoid((x @ w[p + "g_a_proj.weight"].T) @ w[p + "g_b_proj.weight"].T
                         + w[p + "g_b_proj.bias"]).view(t, nh, d)
    out = torch.empty(t, nh, d)
    for j in range(nh):
        o = kda_head(_unit(q[:, j]) * d ** -0.5, _unit(k[:, j]), v[:, j], g[:, j], beta[:, j])
        out[:, j] = _rms(o, w[p + "o_norm.weight"], c["rms_norm_eps"]) * gate[:, j]
    return out.reshape(t, nh * d) @ w[p + "o_proj.weight"].T


def _mla(x, w, p, c):
    t = x.shape[0]
    nh, nope, rope, vd = (c["num_attention_heads"], c["qk_nope_head_dim"],
                          c["qk_rope_head_dim"], c["v_head_dim"])
    q = (x @ w[p + "q_proj.weight"].T).view(t, nh, nope + rope)
    ckv = x @ w[p + "kv_a_proj_with_mqa.weight"].T
    lat, k_pe = ckv[:, : c["kv_lora_rank"]], ckv[:, c["kv_lora_rank"]:]
    kv = (_rms(lat, w[p + "kv_a_layernorm.weight"], c["rms_norm_eps"])
          @ w[p + "kv_b_proj.weight"].T).view(t, nh, nope + vd)
    causal = torch.full((t, t), float("-inf")).triu(1)
    out = torch.empty((t, nh, vd))
    for j in range(nh):
        kj = torch.cat([kv[:, j, :nope], k_pe], -1)
        s = q[:, j] @ kj.T * (nope + rope) ** -0.5 + causal
        out[:, j] = torch.softmax(s, -1) @ kv[:, j, nope:]
    return out.reshape(t, nh * vd) @ w[p + "o_proj.weight"].T


def route(x, gate, bias, c):
    """Tokens [T, H] -> (chosen experts [T, k] of all the router's, in
    order of choice, and their weights [T, k])."""
    k = c["num_experts_per_token"]
    s = torch.sigmoid(x @ gate.T)
    choice = s + bias
    idx = torch.stack([torch.tensor(sorted(range(len(r)), key=lambda e: (-r[e], e))[:k])
                       for r in choice.tolist()])
    wt = s.gather(1, idx)
    if c["moe_renormalize"]:
        wt = wt / (wt.sum(-1, keepdim=True) + 1e-20)
    return idx, wt * c["routed_scaling_factor"]


def routed(x, w, p, c):
    """The held experts' part of the layer's output (no shared expert)."""
    inter = c["moe_intermediate_size"]
    share = c.get("expert_share") or {"first": 0, "count": c["num_experts"]}
    idx, wt = route(x, w[p + "gate.weight"], w[p + "gate.e_score_correction_bias"], c)
    y = torch.zeros_like(x)
    w13, w2 = w[p + "experts.w13"], w[p + "experts.w2"]
    for e in sorted(set(idx.flatten().tolist())):
        here = e - share["first"]
        if not 0 <= here < share["count"]:
            continue
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        y[tok] += wt[tok, slot, None] * _swiglu(x[tok], w13[here, :inter], w13[here, inter:],
                                                w2[here])
    return y


def shared(x, w, p):
    return _swiglu(x, w[p + "shared_experts.gate_proj.weight"],
                   w[p + "shared_experts.up_proj.weight"],
                   w[p + "shared_experts.down_proj.weight"])


def _exact_f32():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return old


def hidden(ids: list, w: dict, c: dict) -> torch.Tensor:
    """Token ids of one text -> its final hidden states [T, H] f32."""
    w = {k: v.float() for k, v in w.items()}
    eps = c["rms_norm_eps"]
    kda = set(c["linear_attn_config"]["kda_layers"])
    old = _exact_f32()
    try:
        with torch.no_grad():
            x = w["backbone.embed_tokens.weight"][torch.tensor(ids)]
            for i in range(c["num_hidden_layers"]):
                p = f"backbone.layers.{i}."
                a = _rms(x, w[p + "input_layernorm.weight"], eps)
                mixer = _kda if i + 1 in kda else _mla
                x = x + mixer(a, w, p + "self_attn.", c)
                a = _rms(x, w[p + "post_attention_layernorm.weight"], eps)
                if i < c["first_k_dense_replace"]:
                    x = x + _swiglu(a, w[p + "mlp.gate_proj.weight"], w[p + "mlp.up_proj.weight"],
                                    w[p + "mlp.down_proj.weight"])
                else:
                    x = x + routed(a, w, p + "mlp.", c) + shared(a, w, p + "mlp.")
            return _rms(x, w["backbone.norm.weight"], eps)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def embed(ids: list, w: dict, c: dict) -> torch.Tensor:
    """Token ids of one text -> its unit embedding [mrl_dim] f32: mean
    pooling over the text, the MRL head with its bias, L2 normalised."""
    pooled = hidden(ids, w, c).mean(0)
    e = pooled @ w["vector_linear.weight"].float().T + w["vector_linear.bias"].float()
    return e / e.norm().clamp_min(1e-12)
