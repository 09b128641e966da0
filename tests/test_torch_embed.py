"""The port's embedding pipeline and encoder lifecycle (models/embed.py,
models/registry.py), held against the JAX package's on the CPU.

- ``EmbeddingPipeline`` against the JAX one on the same parameters and
  tokenizer: the same bucket and batch-pad decisions, embeddings within
  rtol = atol = 1e-5 (f32 products summed in another order).
- The lifecycle: the port's ``convert_and_save`` writes
  ``encoder_meta.json`` (the JAX package's schema) and
  ``encoder.safetensors``; ``StellaEmbedder`` loads it with no
  conversion; the MRL head comes from ``2_Dense_<d>`` or fails loudly;
  ``verify_conversion`` gates a conversion against a live HF model.
- ``get_embedder("auto")`` falls back to hashing only when the weights
  are missing.
- A ``SearchEngine`` with the stella embedder, started from artifacts,
  returns the JAX engine's ids on the same weights and index.
"""

import copy
import json
import shutil

import jax
import numpy as np
import pytest
import torch

from abstracts_search_tpu.config import Config as JaxConfig
from abstracts_search_tpu.models import StellaConfig as JaxStellaConfig
from abstracts_search_tpu.models import StellaEncoder as JaxStellaEncoder
from abstracts_search_tpu.models import registry as jax_registry
from abstracts_search_tpu.models.embed import EmbeddingPipeline as JaxPipeline
from abstracts_search_tpu.models.embed import whitespace_tokenizer as jax_whitespace
from abstracts_search_tpu_torch.config import Config
from abstracts_search_tpu_torch.models import embed, registry
from abstracts_search_tpu_torch.models.convert import params_from_jax
from abstracts_search_tpu_torch.models.embed import EmbeddingPipeline, whitespace_tokenizer
from abstracts_search_tpu_torch.models.stella import PROMPTS, StellaConfig

BUCKETS = (8, 16, 32)
TEXTS = ["alpha beta gamma", "one two", "x " * 40, "solo", "a b c d e f g h i",
         "the quick brown fox jumps over the lazy dog again and again today"]


@pytest.fixture(scope="module")
def jax_params():
    cfg = JaxStellaConfig.tiny()
    ids, mask = np.zeros((1, 8), np.int32), np.ones((1, 8), np.int32)
    return JaxStellaEncoder(cfg).init(jax.random.key(0), ids, mask)


def _pipelines(jax_params, batch_size, batch_buckets):
    tok = whitespace_tokenizer(128)
    kw = dict(batch_size=batch_size, buckets=BUCKETS, batch_buckets=batch_buckets)
    return (JaxPipeline(JaxStellaConfig.tiny(), jax_params, jax_whitespace(128), **kw),
            EmbeddingPipeline(StellaConfig.tiny(), params_from_jax(jax_params), tok,
                              device="cpu", **kw))


@pytest.mark.parametrize("batch_size,batch_buckets", [(2, False), (4, False), (8, True),
                                                      (4, True)])
def test_pipeline_matches_jax(jax_params, batch_size, batch_buckets):
    jp, tp = _pipelines(jax_params, batch_size, batch_buckets)
    for n in range(0, 45):
        assert tp._bucket_for(n) == jp._bucket_for(n)
    for n in range(1, 12):
        assert tp._batch_pad(n) == jp._batch_pad(n)
    assert tp._tokenize(TEXTS, "s2p_query") == jp._tokenize(TEXTS, "s2p_query")
    assert max(len(t) for t in tp._tokenize(TEXTS, None)) == BUCKETS[-1]   # truncated
    np.testing.assert_allclose(tp(TEXTS), jp(TEXTS), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tp.embed_queries(TEXTS[:3]), jp.embed_queries(TEXTS[:3]),
                               rtol=1e-5, atol=1e-5)
    assert tp([]).shape == (0, 16)


def test_pipeline_order_independence_and_prompt(jax_params):
    _, p = _pipelines(jax_params, 2, False)
    base = p(TEXTS[:4])
    np.testing.assert_array_equal(base, p(TEXTS[:4]))
    np.testing.assert_allclose(np.linalg.norm(base, axis=1), 1.0, rtol=1e-5)
    perm = [2, 0, 3, 1]
    np.testing.assert_allclose(p([TEXTS[i] for i in perm]), base[perm], atol=1e-5)
    # the s2p_query instruction prefix must flow into the tokens
    assert not np.allclose(p(["hello world"]), p.embed_queries(["hello world"]))


def test_pipeline_batch_buckets_match_fixed_batch(jax_params):
    _, fixed = _pipelines(jax_params, 8, False)
    _, bucketed = _pipelines(jax_params, 8, True)
    for texts in (["solo query"], ["a b", "c d e", "f"],
                  [f"doc {i} words here" for i in range(6)], TEXTS * 2):
        np.testing.assert_allclose(bucketed(texts), fixed(texts), atol=1e-5)
    assert [bucketed._batch_pad(n) for n in (1, 3, 8, 9)] == [1, 4, 8, 8]
    assert fixed._batch_pad(1) == 8


# -- the lifecycle -------------------------------------------------------------------


def _write_tiny_backbone(d):
    from transformers import Qwen2Config as HFConfig, Qwen2Model

    hf_cfg = HFConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rope_theta=10000.0,
        attn_implementation="eager",
    )
    torch.manual_seed(0)
    Qwen2Model(hf_cfg).save_pretrained(d)


def _write_dense_module(mod_dir, out_dim, in_dim=32, seed=1, fmt="safetensors"):
    """A sentence-transformers 2_Dense_<d> module, the only place the
    stella MRL head ships in the real checkpoint."""
    mod_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    tensors = {"linear.weight": rng.standard_normal((out_dim, in_dim)).astype(np.float32),
               "linear.bias": rng.standard_normal(out_dim).astype(np.float32)}
    if fmt == "bin":
        torch.save({k: torch.from_numpy(v) for k, v in tensors.items()},
                   mod_dir / "pytorch_model.bin")
    else:
        from safetensors.numpy import save_file

        save_file(tensors, str(mod_dir / "model.safetensors"))
    return tensors


@pytest.fixture(scope="module")
def headless_hf_dir(tmp_path_factory):
    pytest.importorskip("transformers")
    pytest.importorskip("safetensors")
    d = tmp_path_factory.mktemp("hf_headless")
    _write_tiny_backbone(d)
    return d


@pytest.fixture(scope="module")
def tiny_hf_dir(headless_hf_dir, tmp_path_factory):
    d = tmp_path_factory.mktemp("hf_model") / "snap"
    shutil.copytree(headless_hf_dir, d)
    _write_dense_module(d / "2_Dense_16", out_dim=16)
    return d


@pytest.fixture
def tokenizers(monkeypatch):
    """Both packages' HF tokenizer replaced by the whitespace one (the
    same ids within this process)."""
    monkeypatch.setattr(embed, "load_hf_tokenizer", lambda name: whitespace_tokenizer(128))
    monkeypatch.setattr("abstracts_search_tpu.models.embed.load_hf_tokenizer",
                        lambda name: jax_whitespace(128))


def test_convert_and_save_then_serve_without_conversion(tiny_hf_dir, tmp_path, monkeypatch,
                                                        tokenizers):
    cfg = Config(model_name=str(tiny_hf_dir), embed_dim=16,
                 ckpt_dir=str(tmp_path / "ckpt"), embed_batch=4)
    registry.convert_and_save(cfg, tmp_path / "ckpt")
    assert {p.name for p in (tmp_path / "ckpt").iterdir()} == \
        {registry.ENCODER_META, registry.ENCODER_WEIGHTS}

    def no_conversion(_cfg, **kw):
        raise AssertionError("conversion ran at serve time")

    monkeypatch.setattr(registry, "_convert_from_torch", no_conversion)
    emb = registry.StellaEmbedder(cfg, device="cpu")
    texts = ["alpha beta gamma", "delta epsilon"]
    out = emb(texts)
    assert out.shape == (2, 16) and emb.dim == 16
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, rtol=1e-5)
    assert not np.allclose(out, emb.queries(texts))      # prompt registry applied


def test_checkpoint_matches_direct_conversion_and_jax(tiny_hf_dir, tmp_path, tokenizers):
    """Checkpoint-loaded == directly converted == the JAX package's
    StellaEmbedder (converted by transformers) on the same snapshot."""
    texts = ["the quick brown fox", "jumps over", "the lazy dog", "x"]
    direct_cfg = Config(model_name=str(tiny_hf_dir), embed_dim=16, embed_batch=4)
    direct = registry.StellaEmbedder(direct_cfg, device="cpu")
    registry.convert_and_save(direct_cfg, tmp_path / "ck")
    ck_cfg = Config(model_name=str(tiny_hf_dir), embed_dim=16,
                    ckpt_dir=str(tmp_path / "ck"), embed_batch=4)
    restored = registry.StellaEmbedder(ck_cfg, device="cpu")
    np.testing.assert_array_equal(restored(texts), direct(texts))
    jemb = jax_registry.StellaEmbedder(JaxConfig(model_name=str(tiny_hf_dir), embed_dim=16,
                                                 embed_batch=4))
    np.testing.assert_allclose(restored(texts), jemb(texts), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(restored.queries(texts), jemb.queries(texts),
                               rtol=1e-5, atol=1e-5)


def test_encoder_meta_schema_matches_jax(tiny_hf_dir, tmp_path):
    cfg = Config(model_name=str(tiny_hf_dir), embed_dim=16)
    registry.convert_and_save(cfg, tmp_path)
    meta = json.loads((tmp_path / registry.ENCODER_META).read_text())
    jscfg = jax_registry._stella_config_from_json(meta)       # the JAX package reads it
    assert jax_registry._stella_config_to_json(jscfg) == registry._stella_config_to_json(
        registry._stella_config_from_json(meta))
    assert meta["model_name"] == str(tiny_hf_dir)
    assert meta["backbone"]["num_layers"] == 2 and meta["mrl_dim"] == 16


def test_orbax_only_checkpoint_names_the_missing_file(tiny_hf_dir, tmp_path):
    """A ckpt_dir as the JAX package writes it (encoder_meta.json and an
    orbax params/ tree) is refused with the port's file named."""
    registry.convert_and_save(Config(model_name=str(tiny_hf_dir), embed_dim=16), tmp_path)
    (tmp_path / registry.ENCODER_WEIGHTS).unlink()
    (tmp_path / "params").mkdir()
    cfg = Config(model_name=str(tiny_hf_dir), embed_dim=16, ckpt_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="encoder.safetensors"):
        registry.StellaEmbedder(cfg, device="cpu")


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_dense_module_head_is_loaded_not_identity(headless_hf_dir, tmp_path, fmt):
    d = tmp_path / "snap"
    shutil.copytree(headless_hf_dir, d)
    w = _write_dense_module(d / "2_Dense_16", out_dim=16, seed=3, fmt=fmt)
    _, params = registry._convert_from_torch(Config(model_name=str(d), embed_dim=16))
    k = params["vector_linear.weight"].numpy()
    assert not np.allclose(k, np.eye(16, 32)), "identity head substituted"
    np.testing.assert_array_equal(k, w["linear.weight"])
    np.testing.assert_array_equal(params["vector_linear.bias"].numpy(), w["linear.bias"])


def test_headless_snapshot_raises(headless_hf_dir):
    cfg = Config(model_name=str(headless_hf_dir), embed_dim=16)
    with pytest.raises(registry.MRLHeadNotFound, match="2_Dense_16"):
        registry._convert_from_torch(cfg)


def test_headless_identity_escape_hatch(headless_hf_dir):
    cfg = Config(model_name=str(headless_hf_dir), embed_dim=16, identity_head=True)
    _, params = registry._convert_from_torch(cfg)
    np.testing.assert_array_equal(params["vector_linear.weight"].numpy(),
                                  np.eye(16, 32, dtype=np.float32))
    assert not params["vector_linear.bias"].any()


def test_mismatched_head_dim_raises(tiny_hf_dir, tmp_path):
    """embed_dim=24 finds no 2_Dense_24; must raise, not truncate. A
    2_Dense/ of the wrong width raises too."""
    with pytest.raises(registry.MRLHeadNotFound):
        registry._convert_from_torch(Config(model_name=str(tiny_hf_dir), embed_dim=24))
    d = tmp_path / "snap"
    shutil.copytree(tiny_hf_dir, d)
    _write_dense_module(d / "2_Dense", out_dim=16)
    with pytest.raises(registry.MRLHeadNotFound, match="projects to 16 dims"):
        registry._convert_from_torch(Config(model_name=str(d), embed_dim=24))


def test_bare_2_dense_dir_accepted_when_dim_matches(headless_hf_dir, tmp_path):
    d = tmp_path / "snap"
    shutil.copytree(headless_hf_dir, d)
    w = _write_dense_module(d / "2_Dense", out_dim=16, seed=7)
    _, params = registry._convert_from_torch(Config(model_name=str(d), embed_dim=16))
    np.testing.assert_array_equal(params["vector_linear.weight"].numpy(), w["linear.weight"])


def test_verify_conversion_gate(tiny_hf_dir, tmp_path):
    """The gate passes on a faithful load of the snapshot and fails on a
    row-permuted MRL head and on prompt drift — before anything is
    written."""
    tok = whitespace_tokenizer(128)
    cfg = Config(model_name=str(tiny_hf_dir), embed_dim=16)
    scfg, params, model, dw, db = registry._convert_from_torch(cfg, return_hf=True)
    report = registry.verify_conversion(cfg, scfg, params, model, dw, db, tokenizer=tok)
    assert report["min_cosine"] > 0.999
    assert report["min_cosine_document"] > 0.999 and report["min_cosine_query"] > 0.999
    assert report["prompt_checked"] is False

    bad = copy.deepcopy(params)
    bad["vector_linear.weight"] = bad["vector_linear.weight"].flip(0).contiguous()
    with pytest.raises(registry.ConversionVerificationError, match="cosine"):
        registry.verify_conversion(cfg, scfg, bad, model, dw, db, tokenizer=tok)

    snap = tmp_path / "model"
    snap.mkdir()
    (snap / "config_sentence_transformers.json").write_text(
        '{"prompts": {"s2p_query": "Different instruction\\nQuery: "}}')
    cfg2 = Config(model_name=str(snap), embed_dim=16)
    with pytest.raises(registry.ConversionVerificationError, match="prompt registry"):
        registry.verify_conversion(cfg2, scfg, params, model, dw, db, tokenizer=tok)
    # the published prompt byte-equal to the registry's passes the check
    (snap / "config_sentence_transformers.json").write_text(json.dumps(
        {"prompts": {"s2p_query": PROMPTS["s2p_query"]}}))
    ok = registry.verify_conversion(cfg2, scfg, params, model, dw, db, tokenizer=tok)
    assert ok["prompt_checked"] is True


def test_auto_falls_back_only_for_missing_weights(headless_hf_dir, tiny_hf_dir, tmp_path,
                                                  tokenizers, caplog):
    import logging

    def auto(**kw):
        return registry.get_embedder("auto", Config(embed_dim=16, **kw), device="cpu")

    with caplog.at_level(logging.WARNING):
        # no snapshot, no checkpoint; a snapshot without its MRL head; a
        # checkpoint without its weights file
        assert isinstance(auto(model_name=str(tmp_path / "nothing")), registry.HashEmbedder)
        assert isinstance(auto(model_name=str(headless_hf_dir)), registry.HashEmbedder)
        registry.convert_and_save(Config(model_name=str(tiny_hf_dir), embed_dim=16),
                                  tmp_path / "ck")
        (tmp_path / "ck" / registry.ENCODER_WEIGHTS).rename(tmp_path / "moved")
        assert isinstance(auto(model_name=str(tiny_hf_dir), ckpt_dir=str(tmp_path / "ck")),
                          registry.HashEmbedder)
    assert sum("falling back to hash embedder" in r.getMessage()
               for r in caplog.records) == 3
    (tmp_path / "moved").rename(tmp_path / "ck" / registry.ENCODER_WEIGHTS)
    assert isinstance(auto(model_name=str(tiny_hf_dir), ckpt_dir=str(tmp_path / "ck")),
                      registry.StellaEmbedder)

    # weights that do not fit the config: a shape mismatch propagates
    meta = json.loads((tmp_path / "ck" / registry.ENCODER_META).read_text())
    meta["backbone"]["intermediate_size"] = 48
    (tmp_path / "ck" / registry.ENCODER_META).write_text(json.dumps(meta))
    with pytest.raises(RuntimeError, match="size mismatch"):
        auto(model_name=str(tiny_hf_dir), ckpt_dir=str(tmp_path / "ck"))


# -- the engine, started from artifacts ---------------------------------------------


def test_engine_with_stella_matches_jax(tiny_hf_dir, tmp_path, tokenizers):
    pytest.importorskip("pyarrow")
    import pyarrow as pa
    import pyarrow.parquet as pq

    from abstracts_search_tpu.index.ivfpq import IVFPQIndex as JaxIVFPQ
    from abstracts_search_tpu.parallel import build_mesh
    from abstracts_search_tpu.serve.engine import SearchEngine as JaxEngine
    from abstracts_search_tpu_torch.serve.engine import SearchEngine

    kw = dict(model_name=str(tiny_hf_dir), embed_dim=16, embed_batch=8,
              index_dir=str(tmp_path / "art"))
    jemb = jax_registry.StellaEmbedder(JaxConfig(**kw))
    docs = [f"document {i} about subject {i % 11} and topic {i % 7}" for i in range(300)]
    idx = JaxIVFPQ(8, 16, pq_m=4, pq_nbits=4, use_opq=False, mesh=build_mesh(),
                   seg_size=32, chunk=128, seed=0)
    x = jemb(docs)
    idx.train(x, kmeans_iters=4, pq_iters=4)
    idx.fill(x)
    idx.save(tmp_path / "art" / "index")
    pq.write_table(pa.table({"id": [f"https://openalex.org/W{i}" for i in range(300)]}),
                   tmp_path / "art" / "ids.parquet")

    # the port converts the snapshot itself, on the device it is given
    jeng = JaxEngine.from_artifacts(JaxConfig(**kw), index_dir=tmp_path / "art",
                                    embedder="stella", hydrate=False, warmup=False)
    teng = SearchEngine.from_artifacts(Config(**kw), index_dir=tmp_path / "art",
                                       embedder="stella", hydrate=False, warmup=False,
                                       device="cpu")
    assert isinstance(teng.embedder, registry.StellaEmbedder)
    assert teng.embedder.pipeline.device == torch.device("cpu")
    queries = ["subject 3", "topic 5 document", "document 17 about subject 6", "zzz"]
    got, want = teng.search_batch(queries, k=6), jeng.search_batch(queries, k=6)
    assert [[r["id"] for r in row] for row in got] == [[r["id"] for r in row] for row in want]
    np.testing.assert_allclose([r["score"] for row in got for r in row],
                               [r["score"] for row in want for r in row],
                               rtol=1e-5, atol=1e-5)
    assert [r["id"] for r in teng.search("subject 3", k=6)] == \
        [r["id"] for r in jeng.search("subject 3", k=6)]
