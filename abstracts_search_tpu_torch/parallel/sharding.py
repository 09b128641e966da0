"""Tensor-parallel weight rules for the stella encoder.

The JAX package's ``parallel/sharding.py`` on the port's state-dict
names: Megatron-style TP over the mesh's ``tp`` axis. The q/k/v, gate and
up projections are split by output feature, o and down by input feature,
the q/k/v biases with their weights; the token embedding, the norms and
``vector_linear`` stay replicated. Each block then ends in a partial
sum, which ``models/qwen2.py`` all-reduces over the tp group.

A torch ``nn.Linear.weight`` is ``[out, in]`` and a flax kernel
``[in, out]``: JAX's column split ``P(None, tp)`` of a kernel is a split of
the torch weight's rows (dim 0), its row split ``P(tp, None)`` a split of
the weight's columns (dim 1).

Slices follow heads and never cut one. Rank ``r`` of ``tp`` holds query
heads ``[r h/tp, (r+1) h/tp)`` and intermediate columns
``[r I/tp, (r+1) I/tp)``. Query head ``q`` reads KV head ``q // (h/kv)``
(``repeat_interleave`` in ``models/qwen2.py``), so with ``tp <= kv`` each
rank holds ``kv/tp`` whole KV heads, and with ``tp > kv`` it holds the one
KV head its query heads read, which ``tp/kv`` ranks then hold alike.
JAX's spec splits ``k_proj`` evenly by columns instead (stella at tp 4:
64 of 256 columns, half a head) and lets XLA reshard before the
attention; both compute the same function.
"""

from __future__ import annotations

import dataclasses

_COL = ("q_proj.weight", "k_proj.weight", "v_proj.weight", "gate_proj.weight",
        "up_proj.weight")
_ROW = ("o_proj.weight", "down_proj.weight")
_COL_BIAS = ("q_proj.bias", "k_proj.bias", "v_proj.bias")


def stella_param_specs(state_dict) -> dict:
    """Each name of a stella (or Qwen2 backbone) state dict -> the dim its
    tp split runs along: 0 (a Linear weight's rows, or a bias), 1 (its
    columns), or None (replicated)."""
    def spec(name: str):
        if name.endswith(_COL) or name.endswith(_COL_BIAS):
            return 0
        if name.endswith(_ROW):
            return 1
        return None

    return {name: spec(name) for name in state_dict}


@dataclasses.dataclass(frozen=True)
class TPLayout:
    """What tp rank ``tp_rank`` of ``tp`` holds: half-open ranges of
    query heads, KV heads and intermediate columns."""

    tp: int
    tp_rank: int
    q_heads: tuple[int, int]
    kv_heads: tuple[int, int]
    inter: tuple[int, int]


def tp_layout(cfg, tp: int = 1, tp_rank: int = 0) -> TPLayout:
    """The layout of rank ``tp_rank`` of ``tp`` for a Qwen2 config (or a
    stella config's backbone); any other backbone (Moonlight's, Kimi
    Linear's) is refused. Refuses a ``tp`` that does not divide the
    query heads and the intermediate size, or whose ranks would share KV
    heads unevenly (``kv % tp`` and ``tp % kv`` both nonzero)."""
    cfg = getattr(cfg, "backbone", cfg)
    if getattr(cfg, "MODEL_TYPE", "qwen2") != "qwen2":
        raise ValueError(f"no tensor-parallel rules for a {cfg.MODEL_TYPE} backbone: it "
                         f"is held whole on one card")
    h, kv, inter = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size
    if tp < 1 or h % tp or inter % tp:
        raise ValueError(f"tp={tp} must divide num_heads={h} and "
                         f"intermediate_size={inter}")
    if kv % tp and tp % kv:
        raise ValueError(f"tp={tp} would split num_kv_heads={kv} unevenly: tp must "
                         f"divide it or be a multiple of it")
    if not 0 <= tp_rank < tp:
        raise ValueError(f"tp rank {tp_rank} outside [0, {tp})")
    per, group = h // tp, h // kv
    lo, hi = tp_rank * per, (tp_rank + 1) * per
    return TPLayout(tp, tp_rank, (lo, hi), (lo // group, (hi - 1) // group + 1),
                    (tp_rank * inter // tp, (tp_rank + 1) * inter // tp))


def param_slice(name: str, cfg, layout: TPLayout):
    """-> (dim, lo, hi): the part of ``name`` that ``layout``'s rank holds,
    or None where it holds the whole tensor."""
    cfg = getattr(cfg, "backbone", cfg)
    dim = stella_param_specs([name])[name]
    if dim is None or layout.tp == 1:
        return None
    hd = cfg.head_dim
    proj = name.rsplit(".", 2)[-2]
    if proj in ("q_proj", "o_proj"):
        lo, hi = layout.q_heads[0] * hd, layout.q_heads[1] * hd
    elif proj in ("k_proj", "v_proj"):
        lo, hi = layout.kv_heads[0] * hd, layout.kv_heads[1] * hd
    else:                                       # gate_proj, up_proj, down_proj
        lo, hi = layout.inter
    return dim, lo, hi


def shard_state_dict(params, tp_rank: int, tp: int, cfg) -> dict:
    """This rank's slices of a stella (or backbone) state dict, as views;
    the replicated tensors whole. A tensor already at its slice's extent
    (a checkpoint restored by slices) is kept as it is."""
    layout = tp_layout(cfg, tp, tp_rank)
    out = {}
    for name, t in params.items():
        s = param_slice(name, cfg, layout)
        if s is not None and t.shape[s[0]] != s[2] - s[1]:
            t = t.narrow(s[0], s[1], s[2] - s[1])
        out[name] = t
    return out
