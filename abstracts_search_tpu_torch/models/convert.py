"""Weight carrying into the port's ``StellaEncoder`` / ``Qwen2Encoder``.

Two sources:

- ``params_from_jax``: the JAX package's flax parameter tree (numpy
  arrays) -> the port's state dict. flax ``Dense`` kernels are
  ``[in, out]`` and torch ``Linear`` weights ``[out, in]``, so kernels are
  transposed back; ``embedding`` and RMSNorm ``scale`` become ``weight``;
  ``layers_{i}`` becomes ``layers.{i}``.
- ``stella_state_dict``: a HF ``Qwen2Model`` state dict (a leading
  ``model.`` stripped, ``lm_head.*`` ignored) plus the
  sentence-transformers ``2_Dense_<d>`` head -> the port's
  ``StellaEncoder`` state dict. HF's names are the port's, so the
  backbone needs no renaming.
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


def hf_backbone_state_dict(sd: Mapping) -> dict:
    """HF ``Qwen2Model`` (or ``Qwen2ForCausalLM``) state dict -> the
    port's ``Qwen2Encoder`` state dict: a leading ``model.`` stripped,
    ``lm_head.*`` and rotary ``inv_freq`` buffers dropped."""
    out = {}
    for key, v in sd.items():
        if key.startswith("lm_head.") or key.endswith("rotary_emb.inv_freq"):
            continue
        out[key.removeprefix("model.")] = v
    return out


def stella_state_dict(backbone_sd: Mapping, dense_weight, dense_bias=None) -> dict:
    """Full stella state dict: the HF backbone + the ``2_Dense_<d>`` MRL
    head (``[mrl_dim, hidden]``; zero bias when it ships none)."""
    w = _tensor(dense_weight)
    out = {f"backbone.{k}": v for k, v in hf_backbone_state_dict(backbone_sd).items()}
    out["vector_linear.weight"] = w
    out["vector_linear.bias"] = (_tensor(dense_bias) if dense_bias is not None
                                 else torch.zeros(w.shape[0]))
    return out
