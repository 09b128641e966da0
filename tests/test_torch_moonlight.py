"""The Moonlight backbone (``models/moonlight.py``) and its grouped expert
op (``ops/experts.py``) against the plain reference
(``tests/moonlight_reference.py``, which imports nothing of the port), on
tiny seeded f32 configs of the published shape kinds: MLA with a
decoupled rope key, a dense first layer, routed experts with a shared
one. Planted faults in the program must each read wrong. Card tests
(marker ``gpu``) hold the Triton kernels against the plain route."""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

import moonlight_reference as ref
from abstracts_search_tpu_torch.models import moonlight
from abstracts_search_tpu_torch.models.embed import EmbeddingPipeline
from abstracts_search_tpu_torch.models.moonlight import MoonlightConfig, MoonlightEncoder
from abstracts_search_tpu_torch.models.stella import StellaConfig, StellaEncoder
from abstracts_search_tpu_torch.ops import experts

# f32 rounding over three layers of products of width <= 64 and sums of
# a few experts, taken in another order than the reference's (batched
# einsums and one grouped product against a head and an expert at a
# time): 2.7e-6 here, so 1e-5 holds with room while every planted fault
# below moves the outputs by 1e-3 or more
ATOL = 1e-5
CFG = MoonlightConfig.tiny()
MRL = 16


def hf_config(cfg: MoonlightConfig) -> dict:
    """The config.json keys of ``cfg`` (the reference's view)."""
    return {"vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "moe_intermediate_size": cfg.moe_intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "first_k_dense_replace": cfg.first_k_dense_replace,
            "num_attention_heads": cfg.num_heads, "kv_lora_rank": cfg.kv_lora_rank,
            "qk_nope_head_dim": cfg.qk_nope_head_dim, "qk_rope_head_dim": cfg.qk_rope_head_dim,
            "v_head_dim": cfg.v_head_dim, "n_routed_experts": cfg.n_routed_experts,
            "num_experts_per_tok": cfg.num_experts_per_tok,
            "n_shared_experts": cfg.n_shared_experts,
            "routed_scaling_factor": cfg.routed_scaling_factor,
            "norm_topk_prob": cfg.norm_topk_prob, "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.rms_norm_eps}


def seeded(cfg: MoonlightConfig = CFG, seed: int = 0, std: float = 0.15) -> dict:
    """A stella-wrapped Moonlight state dict from numpy: N(0, std)
    weights and biases, norm scales 1 + N(0, std)."""
    names = StellaEncoder(StellaConfig(backbone=cfg, mrl_dim=MRL), device="cpu").state_dict()
    r = np.random.default_rng(seed)
    out = {}
    for name, t in names.items():
        v = r.normal(0.0, std, tuple(t.shape)).astype(np.float32)
        if "norm" in name:
            v += 1.0
        out[name] = torch.from_numpy(v)
    return out


def texts_ids(seed: int = 1, n: int = 5):
    r = np.random.default_rng(seed)
    return [r.integers(2, CFG.vocab_size, int(r.integers(3, 20))).tolist() for _ in range(n)]


def backbone_of(params: dict, cfg: MoonlightConfig = CFG) -> MoonlightEncoder:
    enc = MoonlightEncoder(cfg, device="cpu")
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


def worst_gap(enc: MoonlightEncoder, params: dict, ids: list) -> float:
    """The backbone ``enc`` on a padded batch against the reference, text
    by text over the real tokens: the largest absolute difference."""
    a, m = padded(ids)
    with torch.no_grad():
        got = enc(a, m)
    return max(float((got[i, :len(x)] - ref.hidden(x, params, hf_config(enc.cfg))).abs().max())
               for i, x in enumerate(ids))


def test_backbone_matches_the_reference():
    params = seeded()
    assert worst_gap(backbone_of(params), params, texts_ids()) < ATOL


def test_the_encoder_through_the_pipeline_matches_the_reference():
    params = seeded(seed=3)
    tok = lambda text: [2 + sum(map(ord, w)) % (CFG.vocab_size - 2) for w in text.split()]  # noqa: E731
    pipe = EmbeddingPipeline(StellaConfig(backbone=CFG, mrl_dim=MRL), params, tok,
                             batch_size=4, buckets=(8, 16, 32), batch_buckets=True,
                             device="cpu")
    texts = [" ".join(f"w{j * i % 37}" for j in range(n)) for i, n in
             enumerate([3, 9, 14, 21, 5, 17])]
    got = pipe.embed_queries(texts, "s2s_query")
    prompt = "Instruct: Retrieve semantically similar text.\nQuery: "
    want = torch.stack([ref.embed(tok(prompt + t), params, hf_config(CFG)) for t in texts])
    assert float((torch.from_numpy(got) - want).abs().max()) < ATOL


def test_the_router_chooses_exactly_the_references_experts():
    r = np.random.default_rng(5)
    x = torch.from_numpy(r.normal(0, 1, (64, CFG.hidden_size)).astype(np.float32))
    gate = torch.from_numpy(r.normal(0, 0.2, (CFG.n_routed_experts, CFG.hidden_size))
                            .astype(np.float32))
    gate[5] = gate[2]                       # experts 2 and 5 tie on every token
    bias = torch.from_numpy(r.normal(0, 0.1, CFG.n_routed_experts).astype(np.float32))
    bias[5] = bias[2]
    idx, w = moonlight.route(x, gate, bias, CFG)
    ridx, rw = ref.route(x, gate, bias, hf_config(CFG))
    assert torch.equal(idx, ridx)
    assert not bool((idx == 5).any()) or bool((idx == 2).any())
    torch.testing.assert_close(w, rw, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("counts", [[0, 5, 0, 0, 17, 1, 0, 3], [30, 0, 0, 0, 0, 0, 0, 0],
                                    [0, 0, 0, 0, 0, 0, 0, 0], [2, 9, 1, 4, 0, 6, 3, 11]])
def test_the_expert_ops_plain_route_against_a_naive_loop(counts):
    r = np.random.default_rng(len(counts) + sum(counts))
    e, h, i = len(counts), 32, 16
    x = torch.from_numpy(r.normal(0, 1, (sum(counts), h)).astype(np.float32))
    w13 = torch.from_numpy(r.normal(0, 0.2, (e, 2 * i, h)).astype(np.float32))
    w2 = torch.from_numpy(r.normal(0, 0.2, (e, h, i)).astype(np.float32))
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32)
    got = experts.grouped_swiglu(x, offsets, w13, w2, impl="torch")
    want = torch.zeros_like(got)
    for row in range(sum(counts)):
        ex = int(np.searchsorted(np.cumsum(counts), row, side="right"))
        g, u = x[row] @ w13[ex, :i].T, x[row] @ w13[ex, i:].T
        want[row] = (torch.nn.functional.silu(g) * u) @ w2[ex].T
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("counts", [[0, 300, 0, 1, 128, 129, 0, 0], [0] * 8, [1000] + [0] * 7,
                                    [3] * 64])
def test_the_kernels_tile_table_covers_every_row_once(counts):
    """``_tiles`` runs in plain torch: each row lies in exactly one live
    tile of its own expert, and every tile past the live ones is dead."""
    bm = 128
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int64)
    tile_e, tile_row, tile_end, n = experts._tiles(offsets, sum(counts), bm)
    assert n == -(-sum(counts) // bm) + len(counts) == len(tile_e)
    seen = np.zeros(sum(counts), np.int64)
    for e, r0, r1 in zip(tile_e.tolist(), tile_row.tolist(), tile_end.tolist()):
        if e >= len(counts):
            continue
        assert offsets[e] <= r0 < r1 == offsets[e + 1]
        seen[r0:min(r0 + bm, r1)] += 1
    assert (seen == 1).all()
    live = tile_e < len(counts)
    assert int(live.sum()) == sum(-(-c // bm) for c in counts)
    assert not bool(live[int(live.sum()):].any())


def test_moe_stats_count_the_padding_the_expert_layers_computed():
    ids = texts_ids(n=3)
    a, m = padded(ids)
    enc = backbone_of(seeded())
    with torch.no_grad():
        enc(a, m)
    n_moe = CFG.num_layers - CFG.first_k_dense_replace
    assert enc.last_moe_stats["tokens"] == n_moe * a.numel()
    assert int(enc.last_moe_stats["pad_tokens"]) == n_moe * int((m == 0).sum())


# -- planted faults: each must move the backbone past the tolerance ------------------


def _top_k_less(mp, enc):
    route = moonlight.route
    mp.setattr(moonlight, "route", lambda x, w, b, cfg: route(
        x, w, b, dataclasses.replace(cfg, num_experts_per_tok=cfg.num_experts_per_tok - 1)))


def _bias_in_the_weights(mp, enc):
    route = moonlight.route

    def wrong(x, weight, bias, cfg):
        idx, _ = route(x, weight, bias, cfg)
        w = (torch.sigmoid(x.float() @ weight.float().T) + bias).gather(1, idx)
        return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor

    mp.setattr(moonlight, "route", wrong)


def _no_bias_in_the_choice(mp, enc):
    route = moonlight.route
    mp.setattr(moonlight, "route", lambda x, w, b, cfg: route(x, w, torch.zeros_like(b), cfg))


def _no_normalisation(mp, enc):
    route = moonlight.route
    mp.setattr(moonlight, "route", lambda x, w, b, cfg: route(
        x, w, b, dataclasses.replace(cfg, norm_topk_prob=False)))


def _no_scale(mp, enc):
    route = moonlight.route
    mp.setattr(moonlight, "route", lambda x, w, b, cfg: route(
        x, w, b, dataclasses.replace(cfg, routed_scaling_factor=1.0)))


def _shared_expert_dropped(mp, enc):
    for m in enc.modules():
        if isinstance(m, moonlight.MoE):
            mp.setattr(m.shared_experts, "forward", torch.zeros_like)


def _rope_without_deinterleave(mp, enc):
    mp.setattr(moonlight, "_deinterleave", lambda x: x)


def _kv_a_layernorm_skipped(mp, enc):
    for m in enc.modules():
        if isinstance(m, moonlight.MLA):
            mp.setattr(m.kv_a_layernorm, "forward", lambda c: c)


FAULTS = [_top_k_less, _bias_in_the_weights, _no_bias_in_the_choice, _no_normalisation,
          _no_scale, _shared_expert_dropped, _rope_without_deinterleave, _kv_a_layernorm_skipped]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__.strip("_"))
def test_a_planted_fault_reads_wrong(fault, monkeypatch):
    params = seeded()
    enc = backbone_of(params)
    fault(monkeypatch, enc)
    gap = worst_gap(enc, params, texts_ids())
    assert gap > 100 * ATOL, gap


# -- one card holds it whole -------------------------------------------------------


def test_a_mesh_is_refused():
    from abstracts_search_tpu_torch.parallel.sharding import tp_layout

    with pytest.raises(ValueError, match="whole"):
        tp_layout(StellaConfig(backbone=CFG), 2, 0)
    with pytest.raises(ValueError, match="Qwen2 backbone only"):
        StellaEncoder(StellaConfig(backbone=CFG, mrl_dim=MRL), device="cpu",
                      tp=types.SimpleNamespace(size=2, rank=0))
    # the pipeline over a mesh shards the weights first, and tp_layout refuses
    mesh = types.SimpleNamespace(collective=True, device="cpu",
                                 tp_view=lambda: types.SimpleNamespace(rank=0, size=1))
    with pytest.raises(ValueError, match="whole"):
        EmbeddingPipeline(StellaConfig(backbone=CFG, mrl_dim=MRL), seeded(), str.split,
                          device="cpu", mesh=mesh)


# -- the registry: a deepseek_v3 snapshot ------------------------------------------


def _hf_snapshot(root, params: dict, cfg: MoonlightConfig, **overrides):
    """A tiny HF snapshot of ``params``: config.json, per-expert HF names,
    an lm_head, and the 2_Dense_<d> MRL head."""
    from abstracts_search_tpu_torch.models.checkpoint import save_file

    inter = cfg.moe_intermediate_size
    hf = {}
    for name, t in params.items():
        if not name.startswith("backbone."):
            continue
        key = "model." + name.removeprefix("backbone.")
        if key.endswith("experts.w13"):
            for e in range(t.shape[0]):
                hf[key.replace("w13", f"{e}.gate_proj.weight")] = t[e, :inter].clone()
                hf[key.replace("w13", f"{e}.up_proj.weight")] = t[e, inter:].clone()
        elif key.endswith("experts.w2"):
            for e in range(t.shape[0]):
                hf[key.replace("w2", f"{e}.down_proj.weight")] = t[e].clone()
        else:
            hf[key] = t
    hf["lm_head.weight"] = torch.zeros(cfg.vocab_size, cfg.hidden_size)
    save_file(root / "model.safetensors", hf)
    c = dict(hf_config(cfg), model_type="deepseek_v3", q_lora_rank=None, n_group=1,
             topk_group=1, scoring_func="sigmoid", topk_method="noaux_tc", hidden_act="silu",
             moe_layer_freq=1, attention_bias=False)
    c.update(overrides)
    (root / "config.json").write_text(json.dumps(c))
    head = root / f"2_Dense_{MRL}"
    head.mkdir()
    save_file(head / "model.safetensors", {"linear.weight": params["vector_linear.weight"],
                                           "linear.bias": params["vector_linear.bias"]})


def test_a_deepseek_v3_snapshot_converts_and_round_trips(tmp_path):
    from abstracts_search_tpu_torch.config import Config
    from abstracts_search_tpu_torch.models import registry

    params = seeded(seed=9)
    _hf_snapshot(tmp_path, params, CFG)
    cfg = Config(model_name=str(tmp_path), embed_dim=MRL)
    scfg, got = registry._convert_from_torch(cfg)
    assert scfg.backbone == CFG and set(got) == set(params)
    for name, t in params.items():
        assert torch.equal(got[name].float(), t), name
    enc = StellaEncoder(scfg, device="cpu")
    enc.load_state_dict(got)
    ids = texts_ids(seed=4, n=2)
    a, m = padded(ids)
    with torch.no_grad():
        out = enc.eval()(a, m)
    for i, x in enumerate(ids):
        want = ref.embed(x, params, hf_config(CFG))
        assert float((out[i] - want).abs().max()) < ATOL
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    registry.save_encoder(ckpt, scfg, got, str(tmp_path))
    meta = json.loads((ckpt / registry.ENCODER_META).read_text())
    assert meta["backbone"]["model_type"] == "deepseek_v3"
    assert registry._stella_config_from_json(meta) == scfg


@pytest.mark.parametrize("override", [{"q_lora_rank": 1536}, {"n_group": 8},
                                      {"scoring_func": "softmax"}, {"model_type": "llama"}])
def test_a_snapshot_asking_for_what_the_backbone_lacks_is_refused(tmp_path, override):
    from abstracts_search_tpu_torch.config import Config
    from abstracts_search_tpu_torch.models import registry

    _hf_snapshot(tmp_path, seeded(), CFG, **override)
    with pytest.raises(ValueError):
        registry._convert_from_torch(Config(model_name=str(tmp_path), embed_dim=MRL))


# -- on the card ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _zipf_counts(n_experts: int, pairs: int, seed: int) -> list:
    """Loads of Zipf's law over a shuffled expert order, some experts idle."""
    r = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_experts + 1)
    p[r.choice(n_experts, n_experts // 8, replace=False)] = 0.0
    return r.multinomial(pairs, r.permutation(p / p.sum())).tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("pairs,seed", [(6144, 0), (98_304, 1), (37, 2)])
def test_the_expert_kernels_match_the_plain_route(cuda, pairs, seed):
    e, h, i = 64, 2048, 1408
    counts = _zipf_counts(e, pairs, seed)
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((pairs, h), device=cuda, generator=g).to(torch.bfloat16)
    w13 = (0.02 * torch.randn((e, 2 * i, h), device=cuda, generator=g)).to(torch.bfloat16)
    w2 = (0.02 * torch.randn((e, h, i), device=cuda, generator=g)).to(torch.bfloat16)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32,
                           device=cuda)
    got = experts.grouped_swiglu(x, offsets, w13, w2, impl="cuda")
    want = experts.grouped_swiglu(x, offsets, w13, w2, impl="torch")
    torch.cuda.synchronize()
    # f32 sums in another order; h rounded to bf16 may land one bf16 step
    # apart where the sums straddle a rounding boundary
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2e-3 * scale


@pytest.mark.gpu
def test_a_bf16_backbone_on_the_card_matches_its_plain_expert_route(cuda, monkeypatch):
    cfg = MoonlightConfig.tiny(hidden_size=256, moe_intermediate_size=128,
                               intermediate_size=512, n_routed_experts=16,
                               num_experts_per_tok=4, dtype=torch.bfloat16,
                               param_dtype=torch.bfloat16)
    enc = MoonlightEncoder(cfg, device=cuda)
    enc.init_random_(torch.Generator(device=cuda).manual_seed(0))
    a, m = padded(texts_ids(n=4))
    a, m = a.to(cuda), m.to(cuda)
    with torch.no_grad():
        got = enc.eval()(a, m).float()
        monkeypatch.setattr(moonlight, "grouped_swiglu",
                            lambda *args: experts.grouped_swiglu(*args, impl="torch"))
        want = enc(a, m).float()
    assert experts.launches > 0
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())
