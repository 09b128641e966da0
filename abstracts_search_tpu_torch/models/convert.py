"""Weight carrying into the port's ``StellaEncoder`` / ``Qwen2Encoder``.

Two sources:

- ``params_from_jax``: the JAX package's flax parameter tree (numpy
  arrays) -> the port's state dict. flax ``Dense`` kernels are
  ``[in, out]`` and torch ``Linear`` weights ``[out, in]``, so kernels are
  transposed back; ``embedding`` and RMSNorm ``scale`` become ``weight``;
  ``layers_{i}`` becomes ``layers.{i}``.
- ``stella_state_dict``: a HF ``Qwen2Model``, ``deepseek_v3`` or
  ``kimi_linear`` model state dict (a leading ``model.`` stripped,
  ``lm_head.*`` ignored) plus the sentence-transformers ``2_Dense_<d>``
  head -> the port's ``StellaEncoder`` state dict. HF's names are the
  port's, except a sparse-expert layer's routed experts: HF's
  ``layers.{i}.mlp.experts.{e}.{gate,up,down}_proj.weight`` are stacked
  into ``layers.{i}.mlp.experts.w13`` [E, 2I, H] (gate rows, then up
  rows) and ``.w2`` [E, H, I] (``models/moonlight.py``), of the held
  experts only where the backbone holds a share.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_LEAVES = {"kernel": "weight", "embedding": "weight", "scale": "weight", "bias": "bias"}


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def params_from_jax(flax_params: Mapping) -> dict:
    """flax parameter tree (with or without the top-level ``params``
    key) -> f32 state dict of the matching port module."""
    tree = flax_params.get("params", flax_params)
    out: dict = {}

    def walk(node: Mapping, path: list) -> None:
        for key, v in node.items():
            if isinstance(v, Mapping):
                m = re.fullmatch(r"layers_(\d+)", key)
                walk(v, path + (["layers", m.group(1)] if m else [key]))
                continue
            if key not in _LEAVES:
                raise KeyError(f"unexpected flax leaf {'/'.join(path + [key])}")
            t = _tensor(v)
            out[".".join(path + [_LEAVES[key]])] = t.T.contiguous() if key == "kernel" else t

    walk(tree, [])
    return out


_EXPERT = re.compile(r"layers\.(\d+)\.mlp\.experts\.(\d+)\.(gate|up|down)_proj\.weight")
# kimi_linear's sparse layer, as its modeling file names it: the block
# ``block_sparse_moe``, an expert's gate, down and up ``w1``, ``w2``, ``w3``
_KIMI_MOE = re.compile(r"(layers\.\d+\.)block_sparse_moe\.")
_KIMI_EXPERT = {"w1": "gate_proj", "w2": "down_proj", "w3": "up_proj"}
_KIMI_W = re.compile(r"(layers\.\d+\.mlp\.experts\.\d+\.)(w[123])(\.weight)")


def _stack_experts(sd: dict, held: tuple[int, int] | None = None) -> dict:
    """HF's per-expert weights -> each layer's stacked ``w13`` and ``w2``
    of the held experts (``held``: first and count; None: all of them,
    numbered from 0); every other tensor as it is."""
    per: dict = {}
    out = {}
    for key, v in sd.items():
        m = _EXPERT.fullmatch(key)
        if m:
            per.setdefault(int(m.group(1)), {})[int(m.group(2)), m.group(3)] = v
        else:
            out[key] = v
    for layer, t in sorted(per.items()):
        first, n = held if held is not None else (0, 1 + max(e for e, _ in t))
        ids = range(first, first + n)
        out[f"layers.{layer}.mlp.experts.w13"] = torch.stack(
            [torch.cat([t[e, "gate"], t[e, "up"]]) for e in ids])
        out[f"layers.{layer}.mlp.experts.w2"] = torch.stack([t[e, "down"] for e in ids])
    return out


def hf_backbone_state_dict(sd: Mapping, held: tuple[int, int] | None = None) -> dict:
    """HF ``Qwen2Model`` (or ``Qwen2ForCausalLM``), ``deepseek_v3`` or
    ``kimi_linear`` state dict -> the port's ``Qwen2Encoder``,
    ``MoonlightEncoder`` or ``KimiLinearEncoder`` state dict: a leading
    ``model.`` stripped, ``lm_head.*`` and rotary ``inv_freq`` buffers
    dropped, kimi_linear's sparse layers under Moonlight's names (its
    ``A_log`` flattened to one value a head), routed experts stacked
    (``held``: only the experts first .. first + count - 1)."""
    out = {}
    for key, v in sd.items():
        if key.startswith("lm_head.") or key.endswith("rotary_emb.inv_freq"):
            continue
        key = _KIMI_MOE.sub(r"\1mlp.", key.removeprefix("model."))
        key = _KIMI_W.sub(lambda m: m.group(1) + _KIMI_EXPERT[m.group(2)] + m.group(3), key)
        out[key] = v.reshape(-1) if key.endswith("self_attn.A_log") else v
    return _stack_experts(out, held)


def stella_state_dict(backbone_sd: Mapping, dense_weight, dense_bias=None,
                      held: tuple[int, int] | None = None) -> dict:
    """Full stella state dict: the HF backbone (its held experts only,
    ``hf_backbone_state_dict``) + the ``2_Dense_<d>`` MRL head
    (``[mrl_dim, hidden]``; zero bias when it ships none)."""
    w = _tensor(dense_weight)
    out = {f"backbone.{k}": v
           for k, v in hf_backbone_state_dict(backbone_sd, held).items()}
    out["vector_linear.weight"] = w
    out["vector_linear.bias"] = (_tensor(dense_bias) if dense_bias is not None
                                 else torch.zeros(w.shape[0]))
    return out
