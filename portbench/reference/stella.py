"""stella_en_1.5B_v5 written from its published architecture, in plain
PyTorch: a Qwen2 decoder (RMSNorm, rotary embeddings in the rotate-half
convention at theta 1e6, grouped-query attention with q/k/v biases, a
SwiGLU MLP), mean pooling over the real tokens, the 1024-wide MRL head
(``vector_linear``, with bias) and L2 normalisation.

One text at a time at its own length: no padding, no batching, no cache,
no kernels. ``weights`` holds the tensors under the HF names (as
``yardstick.corpus.stella_shapes`` lists them). Products run in true f32
(TF32 off, ``exact_f32``); with ``kind="tf32"`` every matrix product
takes its operands rounded to TF32 (10 mantissa bits) and sums in f32,
as TF32 tensor cores do: the control, one step below the f32 the
deployment serves in, the same on any device.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact_f32():
    """f32 products in true f32 (TF32 off) inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 mantissa bits (nearest, ties away
    from zero)."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def operands(kind: str, *xs):
    """The operands of a product in ``kind`` ("f32" or "tf32")."""
    if kind == "f32":
        return xs
    if kind == "tf32":
        return tuple(tf32(x) for x in xs)
    raise ValueError(f"kind={kind!r}")


def mm(a, b, kind: str = "f32"):
    a, b = operands(kind, a, b)
    return a @ b


def _rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x, theta):
    """x [T, H, hd] rotated by position (HF rotate-half)."""
    t, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device, dtype=torch.float32) / hd)
    ang = torch.arange(t, device=x.device, dtype=torch.float32)[:, None] * inv[None]
    cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return x * cos + torch.cat([-x2, x1], -1) * sin


def embed(ids: list, weights: dict, enc: dict, kind: str = "f32") -> torch.Tensor:
    """Token ids of one text -> its [mrl_dim] f32 unit embedding."""
    w = weights
    dev = w["vector_linear.weight"].device
    h, hd = enc["hidden_size"], enc["head_dim"]
    nh, nkv = enc["num_attention_heads"], enc["num_key_value_heads"]
    eps, theta = enc["rms_norm_eps"], enc["rope_theta"]
    t = len(ids)
    x = w["backbone.embed_tokens.weight"][torch.tensor(ids, device=dev)].float()
    causal = torch.full((t, t), float("-inf"), device=dev).triu(1)
    for i in range(enc["num_hidden_layers"]):
        p = f"backbone.layers.{i}."
        a = _rms_norm(x, w[p + "input_layernorm.weight"], eps)
        q = mm(a, w[p + "self_attn.q_proj.weight"].T, kind) + w[p + "self_attn.q_proj.bias"]
        k = mm(a, w[p + "self_attn.k_proj.weight"].T, kind) + w[p + "self_attn.k_proj.bias"]
        v = mm(a, w[p + "self_attn.v_proj.weight"].T, kind) + w[p + "self_attn.v_proj.bias"]
        q = _rope(q.view(t, nh, hd), theta)
        k = _rope(k.view(t, nkv, hd), theta)
        v = v.view(t, nkv, hd)
        g = nh // nkv                                   # query heads per KV head
        out = torch.empty((t, nh, hd), device=dev)
        for j in range(nh):
            s = mm(q[:, j], k[:, j // g].T, kind) / hd ** 0.5 + causal
            out[:, j] = mm(torch.softmax(s, dim=-1), v[:, j // g], kind)
        x = x + mm(out.reshape(t, nh * hd), w[p + "self_attn.o_proj.weight"].T, kind)
        a = _rms_norm(x, w[p + "post_attention_layernorm.weight"], eps)
        gate = mm(a, w[p + "mlp.gate_proj.weight"].T, kind)
        up = mm(a, w[p + "mlp.up_proj.weight"].T, kind)
        x = x + mm(torch.nn.functional.silu(gate) * up, w[p + "mlp.down_proj.weight"].T, kind)
    x = _rms_norm(x, w["backbone.norm.weight"], eps)
    pooled = x.mean(0)
    e = mm(pooled[None], w["vector_linear.weight"].T, kind)[0] + w["vector_linear.bias"]
    return e / e.norm().clamp_min(1e-12)


def embed_texts(texts: list, tokenize, prompt: str, weights: dict, enc: dict,
                kind: str = "f32") -> torch.Tensor:
    """Prompted texts -> [n, mrl_dim] f32, in ``kind`` precision."""
    cap = enc["seq_buckets"][-1]
    if kind == "tf32":
        # the weight operands rounded once (the activations per product)
        weights = {k: tf32(v) if v.dim() == 2 else v for k, v in weights.items()}
    with exact_f32(), torch.no_grad():
        return torch.stack([embed(list(tokenize(prompt + t))[:cap], weights, enc, kind)
                            for t in texts])
