"""The Kimi Linear backbone (``models/kimi_linear.py``), its KDA op
(``ops/kda.py``) and the expert share of Moonlight's sparse layer
against the plain reference (``tests/kimi_linear_reference.py``, which
imports nothing of the port), on tiny seeded f32 configs of the
published shape kinds: KDA in three layers of four with short
convolutions and per-channel decays, NoPE MLA, a dense first layer,
routed experts (a share of them held) with a shared one. Planted faults
must each read wrong. Card tests (marker ``gpu``) hold the KDA kernels
(CUDA) and the expert kernels (Triton) against the plain routes."""

import dataclasses
import json
import math
import types

import numpy as np
import pytest
import torch

import kimi_linear_reference as ref
from abstracts_search_tpu_torch.models import kimi_linear, moonlight
from abstracts_search_tpu_torch.models.embed import EmbeddingPipeline
from abstracts_search_tpu_torch.models.kimi_linear import KimiLinearConfig, KimiLinearEncoder
from abstracts_search_tpu_torch.models.stella import StellaConfig, StellaEncoder
from abstracts_search_tpu_torch.ops import experts, kda

# f32 rounding over four layers of products of width <= 64, a recurrence
# of up to 56 steps and sums of a few experts, taken in another order
# than the reference's (a convolution against shifted sums, batched
# einsums, every head of a step at once, one grouped product against a
# head, a step and an expert at a time), on hidden states of magnitude
# ~4: 2.4e-6 to 1.3e-5 here (30 ulps), so 3e-5 holds with room while
# every planted fault below moves the outputs by 3e-3 or more
ATOL = 3e-5
# 8 routed experts of 8 held, or a share: 3 of them from expert 2
CFG = KimiLinearConfig.tiny()
SHARE = KimiLinearConfig.tiny(expert_first=2, expert_count=3)
MRL = 16
# KDA's A = exp(A_log) and dt ranges: weak decays (log-decay ~ -1e-3 a
# step) and strong ones (down to ~ -11 a step), as in the card test
DECAYS = {"weak": ((1.0, 2.0), (1e-3, 1e-2)), "strong": ((8.0, 16.0), (0.3, 0.8))}


def hf_config(cfg: KimiLinearConfig) -> dict:
    """The config.json keys of ``cfg`` (the reference's view), with its
    expert share."""
    full = [i for i in range(1, cfg.num_layers + 1) if i not in cfg.kda_layers]
    return {"vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "moe_intermediate_size": cfg.moe_intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "first_k_dense_replace": cfg.first_k_dense_replace,
            "linear_attn_config": {"kda_layers": list(cfg.kda_layers), "full_attn_layers": full,
                                   "num_heads": cfg.kda_num_heads, "head_dim": cfg.kda_head_dim,
                                   "short_conv_kernel_size": cfg.short_conv_kernel_size},
            "num_attention_heads": cfg.num_heads, "kv_lora_rank": cfg.kv_lora_rank,
            "qk_nope_head_dim": cfg.qk_nope_head_dim, "qk_rope_head_dim": cfg.qk_rope_head_dim,
            "v_head_dim": cfg.v_head_dim, "num_experts": cfg.expert_count,
            "expert_share": {"router_experts": cfg.n_routed_experts, "first": cfg.expert_first,
                             "count": cfg.expert_count},
            "num_experts_per_token": cfg.num_experts_per_tok,
            "num_shared_experts": cfg.n_shared_experts,
            "routed_scaling_factor": cfg.routed_scaling_factor,
            "moe_renormalize": cfg.norm_topk_prob, "rms_norm_eps": cfg.rms_norm_eps}


def seeded(cfg: KimiLinearConfig = CFG, seed: int = 0, std: float = 0.15,
           decays: str = "strong") -> dict:
    """A stella-wrapped Kimi Linear state dict from numpy: N(0, std)
    weights and biases, norm scales 1 + N(0, std), KDA's A and dt drawn
    from ``DECAYS[decays]`` (log-uniform dt, stored by inverse softplus)."""
    names = StellaEncoder(StellaConfig(backbone=cfg, mrl_dim=MRL), device="cpu").state_dict()
    r = np.random.default_rng(seed)
    (a_lo, a_hi), (dt_lo, dt_hi) = DECAYS[decays]
    out = {}
    for name, t in names.items():
        shape = tuple(t.shape)
        if name.endswith("A_log"):
            v = np.log(r.uniform(a_lo, a_hi, shape))
        elif name.endswith("dt_bias"):
            dt = np.exp(r.uniform(math.log(dt_lo), math.log(dt_hi), shape))
            v = dt + np.log(-np.expm1(-dt))
        else:
            v = r.normal(0.0, std, shape) + (1.0 if "norm" in name else 0.0)
        out[name] = torch.from_numpy(v.astype(np.float32))
    return out


def texts_ids(seed: int = 1, n: int = 4, low: int = 3, high: int = 57):
    """Token ids of ``n`` texts, the longest spanning three chunks of 16."""
    r = np.random.default_rng(seed)
    lengths = [high - 1] + r.integers(low, high, n - 1).tolist()
    return [r.integers(2, CFG.vocab_size, t).tolist() for t in lengths]


def backbone_of(params: dict, cfg: KimiLinearConfig = CFG) -> KimiLinearEncoder:
    enc = KimiLinearEncoder(cfg, device="cpu")
    enc.load_state_dict({k.removeprefix("backbone."): v for k, v in params.items()
                         if k.startswith("backbone.")})
    return enc.eval()


def padded(ids: list):
    t = max(len(x) for x in ids)
    a = np.zeros((len(ids), t), np.int64)
    m = np.zeros((len(ids), t), np.int64)
    for i, x in enumerate(ids):
        a[i, :len(x)], m[i, :len(x)] = x, 1
    return torch.from_numpy(a), torch.from_numpy(m)


def worst_gap(enc: KimiLinearEncoder, params: dict, ids: list) -> float:
    """The backbone ``enc`` on a right-padded batch against the reference,
    text by text over the real tokens: the largest absolute difference."""
    a, m = padded(ids)
    with torch.no_grad():
        got = enc(a, m)
    return max(float((got[i, :len(x)] - ref.hidden(x, params, hf_config(enc.cfg))).abs().max())
               for i, x in enumerate(ids))


@pytest.mark.parametrize("cfg", [CFG, SHARE], ids=["all_experts", "share"])
@pytest.mark.parametrize("decays", sorted(DECAYS))
def test_backbone_matches_the_reference(cfg, decays):
    params = seeded(cfg, decays=decays)
    assert worst_gap(backbone_of(params, cfg), params, texts_ids()) < ATOL


def test_the_encoder_through_the_pipeline_matches_the_reference():
    params = seeded(SHARE, seed=3)
    tok = lambda text: [2 + sum(map(ord, w)) % (CFG.vocab_size - 2) for w in text.split()]  # noqa: E731
    pipe = EmbeddingPipeline(StellaConfig(backbone=SHARE, mrl_dim=MRL), params, tok,
                             batch_size=4, buckets=(16, 32, 64), batch_buckets=True,
                             device="cpu")
    texts = [" ".join(f"w{j * i % 37}" for j in range(n)) for i, n in
             enumerate([3, 9, 14, 41, 5, 27])]
    got = pipe.embed_queries(texts, "s2s_query")
    prompt = "Instruct: Retrieve semantically similar text.\nQuery: "
    want = torch.stack([ref.embed(tok(prompt + t), params, hf_config(SHARE)) for t in texts])
    assert float((torch.from_numpy(got) - want).abs().max()) < ATOL


def _kda_inputs(b, t, h, d, decays, seed=0):
    (a_lo, a_hi), (dt_lo, dt_hi) = DECAYS[decays]
    r = np.random.default_rng(seed)
    unit = lambda x: x / np.sqrt((x ** 2).sum(-1, keepdims=True) + 1e-6)  # noqa: E731
    q = unit(r.normal(0, 1, (b, t, h, d))) * d ** -0.5
    k = unit(r.normal(0, 1, (b, t, h, d)))
    v = r.normal(0, 1, (b, t, h, d))
    g = -r.uniform(a_lo, a_hi, (b, t, h, d)) * np.exp(r.uniform(math.log(dt_lo),
                                                                math.log(dt_hi), (b, t, h, d)))
    beta = r.uniform(0, 1, (b, t, h))
    return [torch.from_numpy(x.astype(np.float32)) for x in (q, k, v, g, beta)]


@pytest.mark.parametrize("decays", sorted(DECAYS))
def test_the_kda_ops_plain_route_against_the_reference_recurrence(decays):
    q, k, v, g, beta = _kda_inputs(2, 37, 3, 16, decays)
    got = kda.kda_scan(q, k, v, g, beta, impl="torch")
    for b in range(2):
        for h in range(3):
            want = ref.kda_head(q[b, :, h], k[b, :, h], v[b, :, h], g[b, :, h], beta[b, :, h])
            # one step's f32 products in another order (an einsum of every
            # head against one head's vector products)
            torch.testing.assert_close(got[b, :, h], want, rtol=1e-5, atol=1e-5)


def test_the_kda_op_refuses_what_it_does_not_take():
    q, k, v, g, beta = _kda_inputs(1, 5, 2, 16, "weak")
    with pytest.raises(ValueError):
        kda.kda_scan(q, k, v[..., :8], g, beta)
    with pytest.raises(ValueError):
        kda.kda_scan(q, k, v, g, beta[..., :1])
    with pytest.raises(ValueError):
        kda.kda_scan(q, k, v, g, beta, impl="cuda")
    with pytest.raises(ValueError):
        kda.kda_scan(q, k, v, g, beta, impl="chunked")


def test_the_router_chooses_exactly_the_references_experts_of_all():
    cfg = KimiLinearConfig.tiny(n_routed_experts=32, expert_first=8, expert_count=8,
                                num_experts_per_tok=8)
    r = np.random.default_rng(5)
    x = torch.from_numpy(r.normal(0, 1, (64, cfg.hidden_size)).astype(np.float32))
    gate = torch.from_numpy(r.normal(0, 0.2, (32, cfg.hidden_size)).astype(np.float32))
    gate[21] = gate[3]                        # experts 3 and 21 tie on every token
    bias = torch.from_numpy(r.normal(0, 0.1, 32).astype(np.float32))
    bias[21] = bias[3]
    idx, w = moonlight.route(x, gate, bias, cfg)
    ridx, rw = ref.route(x, gate, bias, hf_config(cfg))
    assert torch.equal(idx, ridx) and idx.shape == (64, 8)
    assert bool((idx >= 16).any()) and bool((idx < 8).any())    # beyond the held range too
    assert not bool((idx == 21).any()) or bool((idx == 3).any())
    torch.testing.assert_close(w, rw, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ranges", [[(0, 4), (4, 4)], [(0, 3), (3, 1), (4, 4)],
                                    [(0, 1), (1, 6), (7, 1)]])
def test_the_shares_add_up_to_the_uncut_layer(ranges):
    """Each held range's part of the layer (its MoE, which adds the shared
    expert once), summed over a partition of the router's 8 experts, less
    the shared expert counted once a share beyond the first, is the
    reference's whole layer."""
    params = seeded(CFG, seed=11)
    p = "backbone.layers.2.mlp."
    w = {k.removeprefix(p): v for k, v in params.items() if k.startswith(p)}
    r = np.random.default_rng(2)
    x = torch.from_numpy(r.normal(0, 1, (2, 19, CFG.hidden_size)).astype(np.float32))
    total = torch.zeros_like(x)
    for first, count in ranges:
        cfg = dataclasses.replace(CFG, expert_first=first, expert_count=count)
        moe = moonlight.MoE(cfg, "cpu", cfg.held)
        moe.load_state_dict({**w, "experts.w13": w["experts.w13"][first:first + count],
                             "experts.w2": w["experts.w2"][first:first + count]})
        with torch.no_grad():
            total += moe(x)
        assert moe.held_pairs < x.shape[0] * x.shape[1] * CFG.num_experts_per_tok
    x2 = x.reshape(-1, CFG.hidden_size)
    pw = {f"mlp.{k}": v for k, v in w.items()}
    with torch.no_grad():
        shared = ref.shared(x2, pw, "mlp.")
        want = ref.routed(x2, pw, "mlp.", hf_config(CFG)) + shared
        got = total.reshape(-1, CFG.hidden_size) - (len(ranges) - 1) * shared
    assert float((got - want).abs().max()) < ATOL


def test_the_stats_count_the_tokens_pairs_and_padding():
    ids = texts_ids(n=3)
    a, m = padded(ids)
    enc = backbone_of(seeded(SHARE), SHARE)
    with torch.no_grad():
        enc(a, m)
    n_moe, n_kda = SHARE.num_layers - SHARE.first_k_dense_replace, len(SHARE.kda_layers)
    st = enc.last_moe_stats
    assert st["tokens"] == n_moe * a.numel()
    assert int(st["pad_tokens"]) == n_moe * int((m == 0).sum())
    assert st["pairs"] == st["tokens"] * SHARE.num_experts_per_tok
    assert 0 < st["held_pairs"] < st["pairs"]
    assert enc.last_kda_stats["tokens"] == n_kda * a.numel()
    assert int(enc.last_kda_stats["pad_tokens"]) == n_kda * int((m == 0).sum())


def test_the_spans_count_the_kda_and_expert_layers_work():
    from abstracts_search_tpu_torch.utils import trace

    ids = texts_ids(n=3)
    a, m = padded(ids)
    enc = backbone_of(seeded(SHARE), SHARE)
    trace.start()
    try:
        with torch.no_grad():
            enc(a, m)
        spans = trace.collect()
    finally:
        trace.stop()
        trace.collect()
    by = {}
    for sp in spans:
        by.setdefault(sp["name"], []).append(sp)
    n_kda = len(SHARE.kda_layers)
    assert len(by["kda.attention"]) == len(by["kda.scan"]) == n_kda
    assert all(sp["parent"] in {p["id"] for p in by["kda.attention"]} for sp in by["kda.scan"])
    assert {sp["counts"]["tokens"] for sp in by["kda.scan"]} == {a.numel()}
    assert {sp["counts"]["chunks"] for sp in by["kda.scan"]} == {3 * SHARE.kda_num_heads}
    held = [sp["counts"]["held_pairs"] for sp in by["moe.experts"]]
    assert len(held) == SHARE.n_moe_layers and sum(held) == enc.last_moe_stats["held_pairs"]
    assert all(sp["counts"]["pairs"] == a.numel() * SHARE.num_experts_per_tok
               for sp in by["moe.experts"])
    assert len(by["mla.attention"]) == SHARE.num_layers - n_kda


# -- planted faults: each must move the backbone past the tolerance ------------------


def _decay_ignored(mp, enc):
    scan = kimi_linear.kda_scan
    mp.setattr(kimi_linear, "kda_scan", lambda q, k, v, g, b: scan(q, k, v, torch.zeros_like(g),
                                                                   b))


def _state_dropped_every_16(mp, enc):
    scan = kimi_linear.kda_scan
    mp.setattr(kimi_linear, "kda_scan", lambda q, k, v, g, b: torch.cat(
        [scan(q[:, i:i + 16], k[:, i:i + 16], v[:, i:i + 16], g[:, i:i + 16], b[:, i:i + 16])
         for i in range(0, q.shape[1], 16)], 1))


def _conv_not_causal(mp, enc):
    def centred(self, x):
        width = self.weight.shape[-1]
        y = torch.nn.functional.conv1d(x.transpose(1, 2).float(), self.weight.float(),
                                       padding=width - 1, groups=self.weight.shape[0])
        return torch.nn.functional.silu(y[..., 1:x.shape[1] + 1]).transpose(1, 2)

    mp.setattr(kimi_linear.ShortConv, "forward", centred)


def _output_gate_dropped(mp, enc):
    for m in enc.modules():
        if isinstance(m, kimi_linear.KDA):
            n = m.g_b_proj.out_features
            mp.setattr(m.g_b_proj, "forward", lambda x, n=n: torch.full(x.shape[:-1] + (n,),
                                                                        30.0))


def _held_range_shifted(mp, enc):
    for m in enc.modules():
        if isinstance(m, moonlight.MoE):
            mp.setattr(m, "held", (m.held[0] + 1, m.held[1]))


def _rope_applied(mp, enc):
    for m in enc.modules():
        if isinstance(m, moonlight.MLA):
            mp.setattr(m, "rope", True)
    forward = KimiLinearEncoder.forward

    def with_tables(self, input_ids, attention_mask):
        t = input_ids.shape[1]
        cos, sin = moonlight._rope_cos_sin(torch.arange(t), SHARE.qk_rope_head_dim, 10_000.0,
                                           SHARE.dtype)
        for layer in self.layers:
            if not layer.kda:
                f = layer.self_attn.forward
                mp.setattr(layer.self_attn, "forward",
                           lambda x, mb, c, s, f=f: f(x, mb, cos, sin))
        return forward(self, input_ids, attention_mask)

    mp.setattr(KimiLinearEncoder, "forward", with_tables)


FAULTS = [_decay_ignored, _state_dropped_every_16, _conv_not_causal, _output_gate_dropped,
          _held_range_shifted, _rope_applied]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__.strip("_"))
def test_a_planted_fault_reads_wrong(fault, monkeypatch):
    params = seeded(SHARE)
    enc = backbone_of(params, SHARE)
    fault(monkeypatch, enc)
    gap = worst_gap(enc, params, texts_ids())
    assert gap > 100 * ATOL, gap


# -- one device runs it ---------------------------------------------------------------


def test_a_mesh_is_refused():
    from abstracts_search_tpu_torch.parallel.sharding import tp_layout

    with pytest.raises(ValueError, match="kimi_linear"):
        tp_layout(StellaConfig(backbone=CFG), 2, 0)
    with pytest.raises(ValueError, match="Qwen2 backbone only"):
        StellaEncoder(StellaConfig(backbone=CFG, mrl_dim=MRL), device="cpu",
                      tp=types.SimpleNamespace(size=2, rank=0))
    mesh = types.SimpleNamespace(collective=True, device="cpu",
                                 tp_view=lambda: types.SimpleNamespace(rank=0, size=1))
    with pytest.raises(ValueError, match="kimi_linear"):
        EmbeddingPipeline(StellaConfig(backbone=CFG, mrl_dim=MRL), seeded(), str.split,
                          device="cpu", mesh=mesh)


# -- the registry: a kimi_linear snapshot ------------------------------------------


def _hf_snapshot(root, params: dict, cfg: KimiLinearConfig, **overrides):
    """A tiny HF snapshot of ``params`` holding every expert: config.json
    (with an expert share where ``cfg`` holds one), the sparse layers
    under kimi_linear's names (``block_sparse_moe``, an expert's ``w1``,
    ``w2``, ``w3``), ``A_log`` as [1, 1, heads, 1], an lm_head, and the
    2_Dense_<d> MRL head."""
    from abstracts_search_tpu_torch.models.checkpoint import save_file

    inter = cfg.moe_intermediate_size
    hf = {}
    for name, t in params.items():
        if not name.startswith("backbone."):
            continue
        key = "model." + name.removeprefix("backbone.").replace(".mlp.", ".block_sparse_moe.")
        if ".block_sparse_moe." in key and not (".experts." in key or ".gate." in key
                                                or ".shared_experts." in key):
            key = key.replace(".block_sparse_moe.", ".mlp.")       # the dense layer
        if key.endswith("experts.w13"):
            for e in range(t.shape[0]):
                hf[key.replace("w13", f"{e}.w1.weight")] = t[e, :inter].clone()
                hf[key.replace("w13", f"{e}.w3.weight")] = t[e, inter:].clone()
        elif key.endswith("experts.w2"):
            for e in range(t.shape[0]):
                hf[key.replace("w2", f"{e}.w2.weight")] = t[e].clone()
        elif key.endswith("A_log"):
            hf[key] = t.view(1, 1, -1, 1)
        else:
            hf[key] = t
    hf["lm_head.weight"] = torch.zeros(cfg.vocab_size, cfg.hidden_size)
    save_file(root / "model.safetensors", hf)
    c = dict(hf_config(cfg), model_type="kimi_linear", q_lora_rank=None, num_expert_group=1,
             topk_group=1, moe_router_activation_func="sigmoid", hidden_act="silu",
             moe_layer_freq=1, mla_use_nope=True, head_dim=cfg.hidden_size // cfg.num_heads)
    if cfg.held is None:
        del c["expert_share"]
    c.update(overrides)
    (root / "config.json").write_text(json.dumps(c))
    head = root / f"2_Dense_{MRL}"
    head.mkdir()
    save_file(head / "model.safetensors", {"linear.weight": params["vector_linear.weight"],
                                           "linear.bias": params["vector_linear.bias"]})


def test_a_kimi_linear_snapshot_converts_its_share_and_round_trips(tmp_path):
    """A snapshot of every expert, asked for a share: the held experts are
    sliced out, and the encoder runs as the reference's share."""
    from abstracts_search_tpu_torch.config import Config
    from abstracts_search_tpu_torch.models import registry

    whole = seeded(CFG, seed=9)
    _hf_snapshot(tmp_path, whole, CFG)
    c = json.loads((tmp_path / "config.json").read_text())
    c.update(num_experts=SHARE.expert_count,
             expert_share={"router_experts": 8, "first": SHARE.expert_first,
                           "count": SHARE.expert_count})
    (tmp_path / "config.json").write_text(json.dumps(c))
    scfg, got = registry._convert_from_torch(Config(model_name=str(tmp_path), embed_dim=MRL))
    assert scfg.backbone == SHARE
    held = slice(SHARE.expert_first, SHARE.expert_first + SHARE.expert_count)
    params = {k: (v[held] if k.endswith(("experts.w13", "experts.w2")) else v)
              for k, v in whole.items()}
    assert set(got) == set(params)
    for name, t in params.items():
        assert torch.equal(got[name].float(), t), name
    enc = StellaEncoder(scfg, device="cpu")
    enc.load_state_dict(got)
    ids = texts_ids(seed=4, n=2)
    a, m = padded(ids)
    with torch.no_grad():
        out = enc.eval()(a, m)
    for i, x in enumerate(ids):
        want = ref.embed(x, params, hf_config(SHARE))
        assert float((out[i] - want).abs().max()) < ATOL
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    registry.save_encoder(ckpt, scfg, got, str(tmp_path))
    meta = json.loads((ckpt / registry.ENCODER_META).read_text())
    assert meta["backbone"]["model_type"] == "kimi_linear"
    assert registry._stella_config_from_json(meta) == scfg


def test_a_snapshot_of_every_expert_converts_whole(tmp_path):
    from abstracts_search_tpu_torch.config import Config
    from abstracts_search_tpu_torch.models import registry

    params = seeded(CFG, seed=10)
    _hf_snapshot(tmp_path, params, CFG)
    scfg, got = registry._convert_from_torch(Config(model_name=str(tmp_path), embed_dim=MRL))
    assert scfg.backbone == CFG and scfg.backbone.held is None
    for name, t in params.items():
        assert torch.equal(got[name].float(), t), name


@pytest.mark.parametrize("override", [
    {"q_lora_rank": 1536}, {"num_expert_group": 8}, {"moe_router_activation_func": "softmax"},
    {"mla_use_nope": False}, {"moe_layer_freq": 2},
    {"linear_attn_config": {"kda_layers": [1, 2], "full_attn_layers": [4], "num_heads": 2,
                            "head_dim": 16, "short_conv_kernel_size": 4}},
    {"expert_share": {"router_experts": 8, "first": 6, "count": 3}},
    {"num_experts": 4}])
def test_a_snapshot_asking_for_what_the_backbone_lacks_is_refused(tmp_path, override):
    from abstracts_search_tpu_torch.config import Config
    from abstracts_search_tpu_torch.models import registry

    _hf_snapshot(tmp_path, seeded(SHARE), SHARE, **override)
    with pytest.raises(ValueError):
        registry._convert_from_torch(Config(model_name=str(tmp_path), embed_dim=MRL))


# -- on the card ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_kda_inputs(b, t, h, d, lo, hi, cuda, seed=0, alike=0.0):
    """q, k unit (q scaled), v normal in bf16; log-decays log-uniform in
    [-hi, -lo] a step and channel (f32); beta uniform. ``alike``: each
    head's keys (and queries) share a direction, cos ~ alike^2 apart."""
    g = torch.Generator(device=cuda).manual_seed(seed)

    def unit():
        x = torch.randn((b, t, h, d), device=cuda, generator=g)
        shared = torch.randn((b, 1, h, d), device=cuda, generator=g)
        return torch.nn.functional.normalize(alike * shared + (1 - alike ** 2) ** 0.5 * x, dim=-1)

    q, k = unit(), unit()
    v = torch.randn((b, t, h, d), device=cuda, generator=g)
    u = torch.rand((b, t, h, d), device=cuda, generator=g)
    lg = -torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    beta = torch.rand((b, t, h), device=cuda, generator=g)
    return ((q * d ** -0.5).bfloat16(), k.bfloat16(), v.bfloat16(), lg.contiguous(), beta)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 17, 64, 100, 129, 255, 512])
@pytest.mark.parametrize("decays", [(1e-3, 11.0), (1e-3, 1e-2), (5.0, 11.0)],
                         ids=["wide", "weak", "strong"])
def test_the_kda_kernel_matches_the_recurrence(cuda, t, decays):
    """32 heads of 128 at lengths in and off the chunk, decays from e^-11
    to e^-0.001 a step: the kernel against the f32 recurrence on the same
    bf16 inputs."""
    q, k, v, lg, beta = _card_kda_inputs(2, t, 32, 128, *decays, cuda, seed=t)
    got = kda.kda_scan(q, k, v, lg, beta, impl="cuda").float()
    want = kda.kda_scan(q, k, v, lg, beta, impl="torch").float()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    # bf16 operands of every product (the decayed keys and queries, the
    # inverse, the state's copy, the writes) against f32 ones: a few bf16
    # steps of the outputs' scale
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("t", [100, 512])
@pytest.mark.parametrize("alike", [0.95, 0.99])
def test_the_kda_kernel_holds_when_keys_run_alike(cuda, t, alike):
    """Keys of one direction and weak decays make I + diag(b) A far from
    the identity: the chunk's inverse must still be taken stably."""
    q, k, v, lg, beta = _card_kda_inputs(2, t, 32, 128, 1e-3, 1e-2, cuda, seed=t, alike=alike)
    got = kda.kda_scan(q, k, v, lg, beta, impl="cuda").float()
    want = kda.kda_scan(q, k, v, lg, beta, impl="torch").float()
    torch.cuda.synchronize()
    # as above: bf16 operands against the f32 recurrence
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())


@pytest.mark.gpu
def test_the_kda_kernel_keeps_padding_on_the_right_out_of_real_tokens(cuda):
    q, k, v, lg, beta = _card_kda_inputs(1, 300, 32, 128, 1e-3, 11.0, cuda, seed=3)
    whole = kda.kda_scan(q, k, v, lg, beta, impl="cuda")
    part = kda.kda_scan(*(x[:, :200].contiguous() for x in (q, k, v, lg, beta)), impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(whole[:, :200], part)


@pytest.mark.gpu
@pytest.mark.parametrize("pairs,seed", [(65_536, 0), (131_072, 1), (29, 2)])
def test_the_expert_kernels_at_kimis_shapes(cuda, pairs, seed):
    """128 held experts of H 2,304 and I 1,024, loads by Zipf's law over a
    shuffled order with an eighth of the experts idle."""
    e, h, i = 128, 2304, 1024
    r = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, e + 1)
    p[r.choice(e, e // 8, replace=False)] = 0.0
    counts = r.multinomial(pairs, r.permutation(p / p.sum())).tolist()
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((pairs, h), device=cuda, generator=g).to(torch.bfloat16)
    w13 = (0.02 * torch.randn((e, 2 * i, h), device=cuda, generator=g)).to(torch.bfloat16)
    w2 = (0.02 * torch.randn((e, h, i), device=cuda, generator=g)).to(torch.bfloat16)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32,
                           device=cuda)
    got = experts.grouped_swiglu(x, offsets, w13, w2, impl="cuda")
    want = experts.grouped_swiglu(x, offsets, w13, w2, impl="torch")
    torch.cuda.synchronize()
    # f32 sums in another order, h rounded to bf16 one step apart where the
    # sums straddle a rounding boundary; at 1,024 columns over 131,072 rows
    # the largest h (|h| ~ 25, one step 0.125) flips too: 2.05e-3 of the
    # output's scale read at 131,072 pairs, so 4e-3 of it
    assert float((got - want).abs().max()) <= 4e-3 * float(want.abs().max())


@pytest.mark.gpu
def test_a_bf16_backbone_on_the_card_matches_its_plain_routes(cuda, monkeypatch):
    """A few layers at KDA's published head width (the kernel's), a
    share of the experts, against the same weights through the plain
    KDA recurrence and expert loop."""
    cfg = KimiLinearConfig.tiny(hidden_size=256, intermediate_size=512,
                                moe_intermediate_size=128, kda_num_heads=4, kda_head_dim=128,
                                n_routed_experts=16, expert_first=4, expert_count=8,
                                num_experts_per_tok=4, dtype=torch.bfloat16,
                                param_dtype=torch.bfloat16)
    enc = KimiLinearEncoder(cfg, device=cuda)
    enc.init_random_(torch.Generator(device=cuda).manual_seed(0))
    a, m = padded(texts_ids(n=4, low=60, high=200))
    a, m = a.to(cuda), m.to(cuda)
    before = kda.launches
    # the plain run takes the kernel run's choice of experts (each weighted
    # by its own scores): a near-tie that bf16 rounding tips the other way
    # would move a token by a whole expert's output
    route, chosen = moonlight.route, []

    def recorded(x, w, b, c):
        idx, wt = route(x, w, b, c)
        chosen.append(idx)
        return idx, wt

    def replayed(x, w, b, c):
        idx = chosen.pop(0)
        wt = torch.sigmoid(x.float() @ w.float().T).gather(1, idx)
        return idx, wt / (wt.sum(-1, keepdim=True) + 1e-20) * c.routed_scaling_factor

    with torch.no_grad():
        monkeypatch.setattr(moonlight, "route", recorded)
        got = enc.eval()(a, m).float()
        monkeypatch.setattr(moonlight, "route", replayed)
        monkeypatch.setattr(kimi_linear, "kda_scan",
                            lambda *args: kda.kda_scan(*args, impl="torch"))
        monkeypatch.setattr(moonlight, "grouped_swiglu",
                            lambda *args: experts.grouped_swiglu(*args, impl="torch"))
        want = enc(a, m).float()
    assert kda.launches > before and not chosen
    assert float((got - want).abs().max()) <= 3e-2 * float(want.abs().max())
