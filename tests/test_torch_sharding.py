"""The stella encoder at dp x tp over the port's 2-D mesh against the JAX
package's, on the CPU at the tiny config (4 heads, 2 KV heads, hidden 32,
intermediate 64, 2 layers, MRL 16).

The port's ranks are gloo processes (``tests/torch_mesh_worker.py``,
``init_distributed(tp=)``) at (1 x 2), (2 x 2) and (1 x 4); the JAX side
runs in this process on ``build_mesh(jax.devices()[:W], tp=)`` of the
conftest's 8-device CPU mesh. Both read one checkpoint: the port's
``encoder.safetensors`` and the JAX package's orbax ``params/`` of the
same weights, beside one ``encoder_meta.json``. The HF tokenizer's place
is taken by a crc32 word tokenizer on both sides (the same ids in every
process). Held here:

- the TP rules: every state-dict entry covered, ``num_layers x 10`` split
  entries, each split the transpose of JAX's ``stella_param_specs``; the
  slices reassemble at tp 2 and 4, and at tp 4 (> 2 KV heads) each rank
  holds the whole KV head its query heads read;
- the forward at each layout against JAX's TP-sharded ``jit(apply)`` and
  the port's one process: f32 within rtol = atol = 1e-5, bf16 within
  atol 0.02 on unit embeddings (``test_torch_encoder.py``'s limits);
- the pipeline: ``_batch_pad`` equal to JAX's on the same mesh shape, and
  mixed-length documents and queries equal to JAX's
  ``EmbeddingPipeline(mesh=, param_shardings=)``;
- the restore: each rank's tensors are its slices of the checkpoint;
- the engine: typed queries' ids equal to the JAX engine's on
  ``build_mesh(tp=2)`` and the port's one process; malformed requests
  refused on rank 0 before any section;
- the ingest: ``Driver.target_build`` at (2 x 2), a store per shard whose
  merged dump equals one process's rows; a re-run ingests nothing;
- the mesh: views, refusals of ``W % tp`` and of a ``tp`` stella's heads
  or intermediate size do not allow.
"""

import json
import shutil
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from abstracts_search_tpu.config import Config as JaxConfig
from abstracts_search_tpu.index.ivfpq import IVFPQIndex as JaxIVFPQ
from abstracts_search_tpu.models import embed as jembed
from abstracts_search_tpu.models import qwen2 as jq
from abstracts_search_tpu.models import stella as js
from abstracts_search_tpu.models.checkpoint import load_params as jax_load_params
from abstracts_search_tpu.models.checkpoint import save_params as jax_save_params
from abstracts_search_tpu.parallel import build_mesh as jax_build_mesh
from abstracts_search_tpu.parallel.sharding import stella_param_shardings
from abstracts_search_tpu.parallel.sharding import stella_param_specs as jax_specs
from abstracts_search_tpu.serve.engine import SearchEngine as JaxEngine
from abstracts_search_tpu_torch.config import Config
from abstracts_search_tpu_torch.driver import Driver
from abstracts_search_tpu_torch.index.tune import write_params
from abstracts_search_tpu_torch.models import embed as tembed
from abstracts_search_tpu_torch.models import qwen2 as tq
from abstracts_search_tpu_torch.models import stella as ts
from abstracts_search_tpu_torch.models.checkpoint import load_file
from abstracts_search_tpu_torch.models.convert import params_from_jax
from abstracts_search_tpu_torch.models.registry import (ENCODER_WEIGHTS, StellaEmbedder,
                                                        get_embedder, save_encoder)
from abstracts_search_tpu_torch.parallel import Mesh, build_mesh
from abstracts_search_tpu_torch.parallel.sharding import (param_slice, shard_state_dict,
                                                          stella_param_specs, tp_layout)
from abstracts_search_tpu_torch.serve.engine import SearchEngine
from abstracts_search_tpu_torch.storage.idmap import build_sidecar
from abstracts_search_tpu_torch.storage.shards import ShardReader

from test_torch_driver import snapshot
from test_torch_encoder import _inputs, _jax_params
from test_torch_parallel import run_ranks
from test_torch_serve_artifacts import _ids, _write_ids

LAYOUTS = [(2, 2), (4, 2), (4, 4)]                    # (W, tp)
EMBED_BATCH = 8
PADS = [1, 3, 5, 32]
TEXTS = ([f"short text {i}" for i in range(3)]
         + [" ".join(f"word{j} topic{i}" for j in range(4 + 7 * i)) for i in range(6)]
         + ["A", "the the the the the the the the"])
SINGLES = 3
CFG = dict(embed_dim=16, embed_batch=EMBED_BATCH)
ING = dict(embed_dim=16, embed_batch=EMBED_BATCH, shard_size=64, row_group_size=16,
           ivf_centroids=4, pq_m=4, pq_nbits=4, index_seg_size=32)
ING_TUNE = dict(kmeans_iters=3, n_queries=8)
BF16_ATOL = 0.02


def stable_tokenizer(vocab_size: int):
    """``tests/torch_mesh_worker.py``'s tokenizer: crc32 of each word."""
    def tok(text: str) -> list:
        return [zlib.crc32(w.encode()) % (vocab_size - 2) + 2 for w in text.split()] or [1]

    return tok


def _jcfg(dtype=jnp.float32):
    return js.StellaConfig(backbone=jq.Qwen2Config.tiny(dtype=dtype), mrl_dim=16)


def _tcfg(dtype=torch.float32):
    return ts.StellaConfig(backbone=tq.Qwen2Config.tiny(dtype=dtype), mrl_dim=16)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """One tiny stella checkpoint in both packages' formats: (dir, the
    flax tree, the port's state dict)."""
    d = tmp_path_factory.mktemp("stella_tp")
    ids, mask = _inputs(seed=5)
    params = _jax_params(js.StellaEncoder(_jcfg()), ids, mask, seed=5)
    sd = params_from_jax(params)
    save_encoder(d, _tcfg(), sd, "tiny-tp")
    jax_save_params(d / "params", params)
    return d, params, sd


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """An IVF-PQ artifact over 400 unit vectors of dimension 16 (built by
    the JAX package), ids.parquet with its sidecar, params.json at nprobe 3."""
    root = tmp_path_factory.mktemp("stella_tp_art")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((400, 16)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    idx = JaxIVFPQ(8, 16, pq_m=4, pq_nbits=4, use_opq=False, mesh=jax_build_mesh(),
                   seg_size=32, chunk=128, seed=0)
    idx.train(x, kmeans_iters=4, pq_iters=4)
    idx.fill(x)
    idx.save(root / "index")
    _write_ids(root / "ids.parquet", _ids(400))
    build_sidecar(root / "ids.parquet")
    write_params(root / "params.json", {"nprobe": 3, "k": 10})
    return root


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    ids, mask = _inputs(seed=6)
    p = tmp_path_factory.mktemp("stella_tp_batch") / "batch.npz"
    np.savez(p, ids=ids.astype(np.int64), mask=mask.astype(np.int64))
    return p, ids, mask


@pytest.fixture(scope="module")
def ranks(ckpt, art, batch, tmp_path_factory):
    """Every layout's rank job, once: {(W, tp): [each rank's results]}."""
    d, _, _ = ckpt
    root = tmp_path_factory.mktemp("stella_tp_ranks")
    url = snapshot(root / "src", [("2024-01-01", 24), ("2024-02-01", 20),
                                  ("2024-03-01", 18), ("2024-04-01", 22)])
    out = {}
    for w, tp in LAYOUTS:
        job = root / f"w{w}_tp{tp}"
        job.mkdir()
        enc = dict(ckpt=str(d), cfg=CFG, batch=str(batch[0]), texts=TEXTS, pads=PADS)
        tasks = [{"name": "f32", "kind": "encode", **enc},
                 {"name": "bf16", "kind": "encode", "dtype": "bf16", **enc}]
        if tp == 2:
            tasks.append({"name": "engine", "kind": "engine_tp", "ckpt": str(d),
                          "cfg": {**CFG, "index_dir": str(art)}, "dir": str(art),
                          "texts": TEXTS, "singles": SINGLES})
        if (w, tp) == (2, 2):
            empty = root / "no_weights"
            empty.mkdir(exist_ok=True)
            tasks += [{"name": f"choice_{e}", "kind": "embedder_choice", "embedder": e,
                       "ckpt": str(d), "empty": str(empty)} for e in ("auto", "stella")]
        if (w, tp) == (4, 2):
            tasks.append({"name": "ingest", "kind": "ingest_tp", "ckpt": str(d),
                          "root": str(job / "drv"), "cfg": {**ING, "manifest_url": url},
                          **ING_TUNE})
        out[(w, tp)] = run_ranks(w, job, tasks, timeout=240, tp=tp)
    out["url"] = url
    out["root"] = root
    return out


@pytest.fixture
def stable_tokenizers(monkeypatch):
    monkeypatch.setattr(tembed, "load_hf_tokenizer", lambda name: stable_tokenizer(128))
    monkeypatch.setattr(jembed, "load_hf_tokenizer", lambda name: stable_tokenizer(128))


def _port_name(path) -> str:
    """A flax path -> the port's state-dict name (``convert.params_from_jax``)."""
    keys = [str(getattr(k, "key", k)) for k in path]
    keys = keys[1:] if keys[0] == "params" else keys
    out = []
    for k in keys[:-1]:
        out += k.split("_", 1) if k.startswith("layers_") else [k]
    leaf = {"kernel": "weight", "embedding": "weight", "scale": "weight"}.get(keys[-1],
                                                                               keys[-1])
    return ".".join(out + [leaf])


def _one_process(sd, texts, dtype=torch.float32, prompt=None):
    pipe = tembed.EmbeddingPipeline(_tcfg(dtype), sd, stable_tokenizer(128),
                                    batch_size=EMBED_BATCH, batch_buckets=True, device="cpu")
    return pipe(texts, prompt=prompt), pipe


# -- the rules and the slices ------------------------------------------------------------


def test_rules_cover_the_state_dict_and_transpose_jax(ckpt):
    _, params, sd = ckpt
    specs = stella_param_specs(sd)
    assert set(specs) == set(sd)
    assert sum(v is not None for v in specs.values()) == _tcfg().backbone.num_layers * 10
    flat = jax.tree_util.tree_flatten_with_path(
        jax_specs(params), is_leaf=lambda x: isinstance(x, P))[0]
    assert len(flat) == len(sd)
    # a flax kernel is [in, out], a torch weight [out, in]: JAX's column
    # split (dim 1) is the port's row split (dim 0) and the other way round
    want = {(1, None): 0, (0, None): 1}
    for path, spec in flat:
        name = _port_name(path)
        axes = [i for i, a in enumerate(spec) if a is not None]
        if not axes:
            assert specs[name] is None, name
        elif name.endswith("bias"):
            assert specs[name] == 0 == axes[0], name
        else:
            assert specs[name] == want[(axes[0], None)], (name, spec)


@pytest.mark.parametrize("tp", [2, 4])
def test_slices_reassemble_and_follow_heads(ckpt, tp):
    _, _, sd = ckpt
    cfg = _tcfg().backbone
    parts = [shard_state_dict(sd, r, tp, _tcfg()) for r in range(tp)]
    hd, group = cfg.head_dim, cfg.num_heads // cfg.num_kv_heads
    for name, full in sd.items():
        s = param_slice(name, cfg, tp_layout(cfg, tp, 0))
        if s is None:
            assert all(p[name] is full for p in parts), name
            continue
        if name.endswith(("k_proj.weight", "k_proj.bias", "v_proj.weight", "v_proj.bias")) \
                and tp > cfg.num_kv_heads:
            # each rank: the whole KV head its query heads read
            for r, p in enumerate(parts):
                kv = (r * cfg.num_heads // tp) // group
                assert torch.equal(p[name], full.narrow(0, kv * hd, hd)), (name, r)
            whole = torch.cat([parts[r][name] for r in range(0, tp, tp // cfg.num_kv_heads)])
        else:
            whole = torch.cat([p[name] for p in parts], dim=s[0])
        assert torch.equal(whole, full), name
    # already-sliced tensors are kept: slicing is idempotent
    again = shard_state_dict(parts[1], 1, tp, _tcfg())
    assert all(again[k] is parts[1][k] for k in sd)


@pytest.mark.parametrize("tp", [3, 8])
def test_tp_that_splits_a_head_or_the_ffn_is_refused(tp):
    with pytest.raises(ValueError, match="must divide"):
        tp_layout(tq.Qwen2Config.stella_1_5b(), tp, 0)


def test_stella_allows_tp_1_2_4_with_whole_kv_heads():
    cfg = tq.Qwen2Config.stella_1_5b()
    assert [tp_layout(cfg, 4, r).kv_heads for r in range(4)] == [(0, 1), (0, 1), (1, 2),
                                                                 (1, 2)]
    assert [tp_layout(cfg, 2, r).q_heads for r in range(2)] == [(0, 6), (6, 12)]
    assert tp_layout(cfg, 1, 0).inter == (0, 8960)


def test_row_split_projections_have_no_bias():
    """o_proj and down_proj end in the tp all-reduce: a bias there would be
    added tp times."""
    m = tq.Qwen2Encoder(tq.Qwen2Config.tiny(), device="cpu")
    for layer in m.layers:
        assert layer.self_attn.o_proj.bias is None and layer.mlp.down_proj.bias is None
    specs = stella_param_specs(m.state_dict())
    assert not [k for k, v in specs.items() if v == 1 and k.endswith("bias")]


def test_load_file_reads_one_slice(ckpt):
    d, _, sd = ckpt
    cfg = _tcfg()
    layout = tp_layout(cfg, 2, 1)
    got = load_file(d / ENCODER_WEIGHTS, select=lambda n, s: param_slice(n, cfg, layout))
    want = shard_state_dict(sd, 1, 2, cfg)
    for name in sd:
        assert torch.equal(got[name], want[name]), name
    q = "backbone.layers.0.self_attn.q_proj.weight"
    assert got[q].is_contiguous() and got[q].shape == (16, 32)
    o = "backbone.layers.0.self_attn.o_proj.weight"
    assert got[o].shape == (32, 16) and not got[o].is_contiguous()


# -- the mesh ----------------------------------------------------------------------------


def test_mesh_views():
    m = Mesh(3, 4, torch.device("cpu"), tp=2)
    assert (m.tp_rank, m.shard_rank, m.n_shard) == (1, 1, 2)
    sv, tv = m.shard_view(), m.tp_view()
    assert (sv.rank, sv.size, sv.tp) == (1, 2, 1)
    assert (tv.rank, tv.size, tv.tp, tv.n_shard, tv.shard_rank) == (1, 2, 2, 1, 0)
    assert tv.tp_view() == tv
    one = Mesh(2, 4, torch.device("cpu"))
    assert one.shard_view() is one and one.tp_view().size == 1
    assert one.tp_view().group is None


@pytest.mark.parametrize("tp", [2, 0])
def test_mesh_refuses_a_tp_that_does_not_divide(tp):
    with pytest.raises(ValueError, match="not divisible"):
        build_mesh("cpu", tp=tp)


# -- the forward, the pipeline and the restore over the ranks ----------------------------


def _jax_mesh(w, tp):
    return jax_build_mesh(jax.devices()[:w], tp=tp)


@pytest.mark.parametrize("w,tp", LAYOUTS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_matches_jax_tp_mesh(ranks, ckpt, batch, w, tp, dtype):
    _, params, sd = ckpt
    _, ids, mask = batch
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    model = js.StellaEncoder(_jcfg(jd))
    mesh = _jax_mesh(w, tp)
    want = np.asarray(jax.jit(model.apply)(
        jax.device_put(params, stella_param_shardings(params, mesh)),
        jnp.asarray(ids), jnp.asarray(mask)))
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    one = tembed.EmbeddingPipeline(_tcfg(td), sd, stable_tokenizer(128), device="cpu")
    mine = one.forward(ids.astype(np.int64), mask.astype(np.int64))
    for r, res in enumerate(ranks[(w, tp)]):
        got = res[f"{dtype}/forward"]
        if dtype == "f32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=f"rank {r}")
            np.testing.assert_allclose(got, mine, rtol=1e-5, atol=1e-5, err_msg=f"rank {r}")
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL, err_msg=f"rank {r}")
            np.testing.assert_allclose(got, mine, rtol=0, atol=BF16_ATOL, err_msg=f"rank {r}")
        np.testing.assert_array_equal(got, ranks[(w, tp)][0][f"{dtype}/forward"])


@pytest.mark.parametrize("w,tp", LAYOUTS)
def test_batch_pad_matches_jax(ranks, ckpt, w, tp):
    _, params, _ = ckpt
    jpipe = jembed.EmbeddingPipeline(_jcfg(), params, stable_tokenizer(128),
                                     batch_size=EMBED_BATCH, batch_buckets=True,
                                     mesh=_jax_mesh(w, tp),
                                     param_shardings=stella_param_shardings(
                                         params, _jax_mesh(w, tp)))
    want = [jpipe._batch_pad(n) for n in PADS]
    for res in ranks[(w, tp)]:
        assert list(res["f32/pads"]) == want


@pytest.mark.parametrize("w,tp", LAYOUTS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pipeline_matches_jax_pipeline(ranks, ckpt, w, tp, dtype):
    _, params, sd = ckpt
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    mesh = _jax_mesh(w, tp)
    jpipe = jembed.EmbeddingPipeline(_jcfg(jd), params, stable_tokenizer(128),
                                     batch_size=EMBED_BATCH, batch_buckets=True, mesh=mesh,
                                     param_shardings=stella_param_shardings(params, mesh))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "f32" else dict(rtol=0, atol=BF16_ATOL)
    for key, prompt in (("docs", None), ("queries", "s2p_query")):
        want = jpipe(TEXTS, prompt=prompt)
        mine, _ = _one_process(sd, TEXTS, td, prompt)
        for r, res in enumerate(ranks[(w, tp)]):
            got = res[f"{dtype}/{key}"]
            assert got.shape == (len(TEXTS), 16)
            np.testing.assert_allclose(got, want, **tol, err_msg=f"{key} rank {r}")
            np.testing.assert_allclose(got, mine, **tol, err_msg=f"{key} rank {r}")


@pytest.mark.parametrize("w,tp", LAYOUTS)
def test_each_rank_restores_only_its_slices(ranks, ckpt, w, tp):
    _, _, sd = ckpt
    for r, res in enumerate(ranks[(w, tp)]):
        want = shard_state_dict(sd, r % tp, tp, _tcfg())
        got = {k[len("f32/sd/"):]: v for k, v in res.items() if k.startswith("f32/sd/")}
        assert set(got) == set(sd)
        for name, t in want.items():
            np.testing.assert_array_equal(got[name], t.numpy(), err_msg=f"{name} rank {r}")
        assert sum(v.size for v in got.values()) < sum(t.numel() for t in sd.values())


# -- the engine ------------------------------------------------------------------------


def test_engine_typed_queries_match_jax_and_one_process(ranks, ckpt, art, stable_tokenizers):
    d, _, _ = ckpt
    kw = dict(index_dir=str(art), ckpt_dir=str(d), **CFG)
    jeng = JaxEngine.from_artifacts(JaxConfig(**kw), index_dir=art, embedder="stella",
                                    hydrate=False, mesh=_jax_mesh(2, 2), warmup=False)
    teng = SearchEngine.from_artifacts(Config(**kw), index_dir=art, embedder="stella",
                                       hydrate=False, device="cpu", warmup=False)
    assert isinstance(teng.embedder, StellaEmbedder) and not teng.embedder.collective
    want, mine = [], []
    for eng, out in ((jeng, want), (teng, mine)):
        rows = eng.search_batch(TEXTS, 10) + [eng.search(t, 10) for t in TEXTS[:SINGLES]]
        out.append(np.asarray([[r["id"] for r in row] for row in rows]))
        out.append(np.asarray([[r["score"] for r in row] for row in rows]))
    np.testing.assert_array_equal(mine[0], want[0])
    for w, tp in ((2, 2), (4, 2)):
        res = ranks[(w, tp)][0]
        assert int(res["engine/refused"]) == 2
        np.testing.assert_array_equal(res["engine/ids"], want[0])
        np.testing.assert_array_equal(res["engine/ids"], mine[0])
        np.testing.assert_allclose(res["engine/scores"], want[1], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["engine/scores"], mine[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,want", [("auto", ["RuntimeError", "RuntimeError"]),
                                       ("stella", ["RuntimeError", "FileNotFoundError"])])
def test_ranks_that_load_differently_all_raise(ranks, name, want):
    """Rank 0 has the weights, rank 1 none: under ``auto`` rank 1 would
    fall back to hash, under ``stella`` its load fails. Either way every
    rank raises before the encoder's first collective (no rank waits out
    the timeout in a forward the other never runs)."""
    got = [str(r[f"choice_{name}/raised"]) for r in ranks[(2, 2)]]
    assert got == want


def test_get_embedder_splits_only_stella_over_a_mesh(ckpt, stable_tokenizers):
    d, _, _ = ckpt
    emb = get_embedder("auto", Config(ckpt_dir=str(d), **CFG), device="cpu")
    assert isinstance(emb, StellaEmbedder) and emb.pipeline.mesh is None


# -- the ingest ------------------------------------------------------------------------


def test_ingest_over_the_2d_mesh_equals_one_process(ranks, ckpt, tmp_path, stable_tokenizers):
    d, _, _ = ckpt
    res = ranks[(4, 2)]
    drv = ranks["root"] / "w4_tp2" / "drv"
    # a store per shard, written by its tp rank 0; partitions i % 2 == shard
    assert sorted(p.name for p in drv.glob("data.sqlite.p*")) == ["data.sqlite.p0",
                                                                   "data.sqlite.p1"]
    for r in range(4):
        want = (["updated_date=2024-01-01", "updated_date=2024-03-01"] if r // 2 == 0
                else ["updated_date=2024-02-01", "updated_date=2024-04-01"])
        assert list(res[r]["ingest/partitions"]) == want
        assert list(res[r]["ingest/again"]) == []
        assert bool(res[r]["ingest/filled"]) and bool(res[r]["ingest/tuned"])
    assert int(res[0]["ingest/dumped"]) > 0
    assert all(int(res[r]["ingest/dumped"]) == 0 for r in (1, 2, 3))

    one = Driver(Config(ckpt_dir=str(d), manifest_url=ranks["url"], **ING), root=tmp_path,
                 embedder="stella", device="cpu")
    one.target_build()
    assert one.target_dump() == int(res[0]["ingest/dumped"])

    def rows(root):
        ids, vecs = [], []
        for b_ids, b_vecs in ShardReader(root / Config().data_dir).iter_row_groups():
            ids += list(b_ids)
            vecs.append(b_vecs)
        order = np.argsort(ids)
        return np.asarray(ids)[order], np.concatenate(vecs)[order]

    got_ids, got = rows(drv)
    want_ids, want = rows(tmp_path)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_index_stages_on_the_2d_mesh_run_over_the_shard_axis(ranks, ckpt, tmp_path,
                                                              stable_tokenizers):
    """train, fill and tune on the (2 x 2) mesh run on tp index 0's two
    ranks over the shard axis (a W = 2 build, which the mesh build makes
    bit-equal to one process's over the same dump): the trained arrays
    and the filled lists byte for byte, the tuned nprobe equal on every
    rank."""
    d, _, _ = ckpt
    drv = ranks["root"] / "w4_tp2" / "drv"
    one_root = tmp_path / "one"
    one_root.mkdir()
    shutil.copytree(drv / Config().data_dir, one_root / Config().data_dir)
    one = Driver(Config(ckpt_dir=str(d), manifest_url=ranks["url"], **ING), root=one_root,
                 embedder="stella", device="cpu")
    assert one.target_fill(kmeans_iters=ING_TUNE["kmeans_iters"])
    assert one.target_tune(n_queries=ING_TUNE["n_queries"], k=3)
    nprobe = json.loads(one.params_path.read_text())["nprobe"]
    assert [int(r["ingest/nprobe"]) for r in ranks[(4, 2)]] == [nprobe] * 4
    for sub in ("empty", "index"):
        a, b = one.index_dir / sub, drv / Config().index_dir / sub
        files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file()
                       and p.name != "meta.json")
        assert files
        for f in files:
            assert (a / f).read_bytes() == (b / f).read_bytes(), f


def test_jax_side_reads_the_same_checkpoint(ckpt):
    """The JAX package restores the orbax copy to the weights the port's
    safetensors file holds (so both sides above run one model)."""
    d, _, sd = ckpt
    meta = json.loads((Path(d) / "encoder_meta.json").read_text())
    assert meta["backbone"]["num_heads"] == 4 and meta["mrl_dim"] == 16
    got = load_file(d / ENCODER_WEIGHTS)
    restored = params_from_jax(jax_load_params(d / "params"))
    assert set(restored) == set(sd)
    assert all(torch.equal(got[k], v) and torch.equal(restored[k], v) for k, v in sd.items())
