"""The port's encoder (models/qwen2.py, stella.py, convert.py,
checkpoint.py) held against the JAX package's flax modules, the golden
fixture and a live HF ``Qwen2Model``, on the CPU at the tiny config.

Tolerances:
- f32 against the JAX modules: rtol = atol = 1e-5 (the same f32
  products summed in another order);
- bf16 against the JAX modules: atol = 0.1 on hidden states of unit RMS
  (12 bf16 ulps near 1; both sides round after every op, but XLA fuses
  and rounds in other places than torch) and 0.02 on unit embeddings,
  plus a cosine of at least 0.999 per row;
- the golden fixture: rtol = atol = 1e-4, as the JAX package's own
  replay;
- HF ``Qwen2Model`` on real positions: rtol = atol = 2e-4, as the JAX
  package's parity test (HF applies its norm scale after the cast).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abstracts_search_tpu.models import qwen2 as jq
from abstracts_search_tpu.models import stella as js
from abstracts_search_tpu_torch.models import checkpoint
from abstracts_search_tpu_torch.models import qwen2 as tq
from abstracts_search_tpu_torch.models import stella as ts
from abstracts_search_tpu_torch.models.convert import (
    hf_backbone_state_dict,
    params_from_jax,
    stella_state_dict,
)

FIXTURE = Path(__file__).parent / "fixtures" / "stella_tiny_golden.npz"
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed=0, b=4, t=12, vocab=128):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[1, 7:] = 0          # padded rows
    mask[2, 3:] = 0
    mask[3, 1:] = 0          # one live token
    return ids, mask


def _jax_params(module, ids, mask, seed=0):
    """flax-initialised parameters with random biases and norm scales
    (flax initialises them to 0 and 1, which would hide a mapping bug)."""
    params = module.init(jax.random.key(seed), jnp.asarray(ids), jnp.asarray(mask))
    rng = np.random.default_rng(seed + 100)

    def perturb(path, x):
        x = np.asarray(x, np.float32)
        name = path[-1].key
        if name == "bias":
            return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(perturb, params)


def _torch(x):
    return torch.from_numpy(np.asarray(x, np.int64))


def _close(got, want, dtype, atol_bf16):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    np.testing.assert_allclose(got, want, rtol=0, atol=atol_bf16)
    g, w = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    cos = (g * w).sum(1) / np.maximum(np.linalg.norm(g, axis=1) * np.linalg.norm(w, axis=1),
                                      1e-12)
    assert cos.min() >= 0.999, cos.min()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
def test_qwen2_encoder_matches_jax(dtype, causal):
    jd, td = DTYPES[dtype]
    ids, mask = _inputs()
    jmod = jq.Qwen2Encoder(jq.Qwen2Config.tiny(dtype=jd), causal=causal)
    params = _jax_params(jmod, ids, mask)
    want = np.asarray(jmod.apply(params, jnp.asarray(ids), jnp.asarray(mask)).astype(jnp.float32))

    tmod = tq.Qwen2Encoder(tq.Qwen2Config.tiny(dtype=td), causal=causal, device="cpu")
    tmod.load_state_dict(params_from_jax(params))
    with torch.inference_mode():
        got = tmod(_torch(ids), _torch(mask))
    assert got.dtype == td and got.shape == want.shape
    _close(got.float().numpy(), want, dtype, atol_bf16=0.1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pooling", ["mean", "last", "cls"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
def test_stella_encoder_matches_jax(dtype, pooling, causal):
    jd, td = DTYPES[dtype]
    ids, mask = _inputs(seed=1)
    jcfg = js.StellaConfig(backbone=jq.Qwen2Config.tiny(dtype=jd), mrl_dim=16,
                           pooling=pooling, causal=causal)
    jmod = js.StellaEncoder(jcfg)
    params = _jax_params(jmod, ids, mask, seed=1)
    want = np.asarray(jmod.apply(params, jnp.asarray(ids), jnp.asarray(mask)))

    tcfg = ts.StellaConfig(backbone=tq.Qwen2Config.tiny(dtype=td), mrl_dim=16,
                           pooling=pooling, causal=causal)
    tmod = ts.StellaEncoder(tcfg, device="cpu")
    tmod.load_state_dict(params_from_jax(params))
    with torch.inference_mode():
        got = tmod(_torch(ids), _torch(mask)).numpy()
    assert got.dtype == np.float32 and got.shape == (4, 16)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    _close(got, want, dtype, atol_bf16=0.02)


@pytest.mark.parametrize("mode", ["mean", "last", "cls"])
def test_pool_hidden_matches_jax(mode):
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((4, 6, 5)).astype(np.float32)
    mask = np.array([[1] * 6, [1, 1, 0, 0, 0, 0], [0] * 6, [1, 0, 0, 0, 0, 0]], np.int32)
    want = np.asarray(js.pool_hidden(jnp.asarray(hidden), jnp.asarray(mask), mode))
    got = ts.pool_hidden(torch.from_numpy(hidden), torch.from_numpy(mask), mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        ts.pool_hidden(torch.from_numpy(hidden), torch.from_numpy(mask), "max")


def test_rope_tables_and_rotation_match_jax():
    pos = np.arange(40)
    jc, jsn = jq._rope_cos_sin(jnp.asarray(pos), 16, 1_000_000.0, jnp.float32)
    tc, tsn = tq._rope_cos_sin(torch.from_numpy(pos), 16, 1_000_000.0, torch.float32)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tsn.numpy(), np.asarray(jsn), rtol=1e-6, atol=1e-6)
    x = np.random.default_rng(4).standard_normal((2, 40, 3, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tq._apply_rope(torch.from_numpy(x), tc, tsn).numpy(),
        np.asarray(jq._apply_rope(jnp.asarray(x), jc, jsn)), rtol=1e-5, atol=1e-5)


def test_configs_and_prompts_match_jax():
    import dataclasses

    for name in ("stella_1_5b", "tiny"):
        j = dataclasses.asdict(getattr(jq.Qwen2Config, name)())
        t = dataclasses.asdict(getattr(tq.Qwen2Config, name)())
        for d in (j, t):
            d.pop("dtype"), d.pop("param_dtype")
        assert j == t
    assert tq.Qwen2Config().dtype == tq.Qwen2Config().param_dtype == torch.float32
    assert ts.PROMPTS == js.PROMPTS
    assert {k: v.encode() for k, v in ts.PROMPTS.items()} == \
        {k: v.encode() for k, v in js.PROMPTS.items()}
    jt, tt = js.StellaConfig.tiny(), ts.StellaConfig.tiny()
    assert (jt.mrl_dim, jt.pooling, jt.causal, jt.normalize) == \
        (tt.mrl_dim, tt.pooling, tt.causal, tt.normalize)


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *parts, leaf = key.split("/")
        node = tree
        for p in parts:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def test_golden_fixture_replays_through_the_port():
    z = np.load(FIXTURE)
    params = _unflatten({k: z[k] for k in z.files if not k.startswith("__")})
    enc = ts.StellaEncoder(ts.StellaConfig.tiny(), device="cpu")
    enc.load_state_dict(params_from_jax(params))
    with torch.inference_mode():
        emb = enc(_torch(z["__ids__"]), _torch(z["__mask__"])).numpy()
    np.testing.assert_allclose(emb, z["__emb__"], rtol=1e-4, atol=1e-4)


def test_params_from_jax_refuses_unknown_leaves():
    with pytest.raises(KeyError, match="backbone/norm/gamma"):
        params_from_jax({"params": {"backbone": {"norm": {"gamma": np.ones(4)}}}})


@pytest.fixture(scope="module")
def hf_tiny():
    pytest.importorskip("transformers")
    from transformers import Qwen2Config as HFConfig, Qwen2Model

    hf_cfg = HFConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rope_theta=10000.0,
        attn_implementation="eager",
    )
    torch.manual_seed(0)
    model = Qwen2Model(hf_cfg)
    with torch.no_grad():        # non-trivial norm scales
        for name, p in model.named_parameters():
            if name.endswith("norm.weight"):
                p.add_(0.1 * torch.randn_like(p))
    return model.eval()


def test_hf_state_dict_loads_without_renaming(hf_tiny):
    ids, mask = _inputs(seed=2)
    with torch.no_grad():
        ref = hf_tiny(input_ids=_torch(ids), attention_mask=_torch(mask)).last_hidden_state
    enc = tq.Qwen2Encoder(tq.Qwen2Config.tiny(), device="cpu")
    enc.load_state_dict(hf_tiny.state_dict())          # strict: same names, no conversion
    with torch.inference_mode():
        got = enc(_torch(ids), _torch(mask))
    for b in range(ids.shape[0]):
        t = int(mask[b].sum())
        np.testing.assert_allclose(got[b, :t].numpy(), ref[b, :t].numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_hf_state_dict_with_model_prefix_and_head(hf_tiny):
    """A causal-LM state dict (``model.`` prefix, ``lm_head``) plus the
    2_Dense head maps onto StellaEncoder; equal to the bare model's."""
    sd = hf_tiny.state_dict()
    prefixed = {f"model.{k}": v for k, v in sd.items()}
    prefixed["lm_head.weight"] = torch.zeros(128, 32)
    assert hf_backbone_state_dict(prefixed).keys() == sd.keys()
    w = torch.randn(16, 32, generator=torch.Generator().manual_seed(0))
    a = stella_state_dict(prefixed, w)
    b = stella_state_dict(sd, w.numpy(), np.zeros(16, np.float32))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    enc = ts.StellaEncoder(ts.StellaConfig.tiny(), device="cpu")
    enc.load_state_dict(a)
    assert torch.equal(enc.vector_linear.weight, w)


def test_random_init_is_seeded_and_hf_style():
    cfg = ts.StellaConfig.tiny()
    a = ts.StellaEncoder(cfg, device="cpu").init_random_(torch.Generator().manual_seed(5))
    b = ts.StellaEncoder(cfg, device="cpu").init_random_(torch.Generator().manual_seed(5))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert torch.equal(sa["backbone.norm.weight"], torch.ones(32))
    assert torch.equal(sa["backbone.layers.0.self_attn.q_proj.bias"], torch.zeros(32))
    assert abs(float(sa["backbone.embed_tokens.weight"].std()) - 0.02) < 0.002
    # bf16 compute: linear weights in bf16, norm scales in f32
    c = ts.StellaEncoder(ts.StellaConfig.tiny(backbone=tq.Qwen2Config.tiny(
        dtype=torch.bfloat16)), device="cpu")
    assert c.backbone.layers[0].mlp.up_proj.weight.dtype == torch.bfloat16
    assert c.backbone.norm.weight.dtype == torch.float32


# -- safetensors -----------------------------------------------------------------


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a.weight": torch.randn(3, 5, generator=g),
            "b.bias": torch.randn(7, generator=g).half(),
            "c": torch.randn(2, 3, 3, generator=g).to(torch.bfloat16),
            "odd": torch.randn(1, generator=g).half(),
            "empty": torch.zeros(0, 4)}


def _assert_same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_safetensors_reader_reads_the_reference_writer(tmp_path):
    st_np = pytest.importorskip("safetensors.numpy")
    st_torch = pytest.importorskip("safetensors.torch")
    arrays = {"x": np.arange(12, dtype=np.float32).reshape(3, 4),
              "y": np.linspace(-1, 1, 5).astype(np.float16)}
    st_np.save_file(arrays, str(tmp_path / "np.safetensors"), metadata={"format": "np"})
    got = checkpoint.load_file(tmp_path / "np.safetensors")
    _assert_same(got, {k: torch.from_numpy(v) for k, v in arrays.items()})
    # bf16 (numpy has none), f16 of odd length before others: unaligned offsets
    want = _tensors()
    st_torch.save_file(want, str(tmp_path / "t.safetensors"))
    _assert_same(checkpoint.load_file(tmp_path / "t.safetensors"), want)


def test_safetensors_writer_reads_back_in_both_readers(tmp_path):
    st_torch = pytest.importorskip("safetensors.torch")
    want = _tensors(1)
    checkpoint.save_file(tmp_path / "w.safetensors", want, metadata={"step": 3})
    _assert_same(checkpoint.load_file(tmp_path / "w.safetensors"), want)
    _assert_same(st_torch.load_file(str(tmp_path / "w.safetensors")), want)
    with pytest.raises(ValueError, match="dtype"):
        checkpoint.save_file(tmp_path / "i.safetensors", {"i": torch.arange(3)})


def test_hf_weights_single_and_sharded(tmp_path):
    st_torch = pytest.importorskip("safetensors.torch")
    want = _tensors(2)
    single = tmp_path / "single"
    single.mkdir()
    st_torch.save_file(want, str(single / "model.safetensors"))
    _assert_same(checkpoint.load_hf_weights(single), want)

    sharded = tmp_path / "sharded"
    sharded.mkdir()
    names = sorted(want)
    shards = {"model-00001-of-00002.safetensors": names[:2],
              "model-00002-of-00002.safetensors": names[2:]}
    for fname, keys in shards.items():
        st_torch.save_file({k: want[k] for k in keys}, str(sharded / fname))
    (sharded / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {}, "weight_map": {k: f for f, ks in shards.items() for k in ks}}))
    _assert_same(checkpoint.load_hf_weights(sharded), want)
    with pytest.raises(FileNotFoundError):
        checkpoint.load_hf_weights(tmp_path)
