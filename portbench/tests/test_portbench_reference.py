"""Each plain reference against the port's plain (``impl="torch"``) path
at tiny sizes on the CPU."""

import numpy as np
import pytest
import torch

from portbench.drivers.common import IVFPQInputs, LazyIds, served
from portbench.drivers.open_loop_http import stella_config
from portbench.reference import fill as ref_fill
from portbench.reference import flat as ref_flat
from portbench.reference import ivfpq as ref_ivfpq
from portbench.reference import stella as ref_stella
from portbench.tests import tiny
from portbench.yardstick import corpus


def test_stella_reference_matches_the_port_s_encoder():
    from abstracts_search_tpu_torch.models.embed import EmbeddingPipeline

    enc = tiny.ENCODER
    tok = corpus.tokenizer(enc["vocab_size"])
    w = corpus.stella_weights(enc, 3, "cpu")
    pipe = EmbeddingPipeline(stella_config(enc), w, tok, batch_size=enc["embed_batch"],
                             buckets=enc["seq_buckets"], batch_buckets=True, device="cpu")
    texts = corpus.typed_texts(np.array([1, 4, 9, 24, 30]), 2, corpus.vocabulary())
    got = pipe.embed_queries(texts, "s2p_query")
    want = ref_stella.embed_texts(texts, tok, corpus.PROMPTS["s2p_query"], w, enc)
    assert np.abs(got - want.numpy()).max() < 2e-6
    low = ref_stella.embed_texts(texts, tok, corpus.PROMPTS["s2p_query"], w, enc, "tf32")
    assert 1e-5 < float((low - want).abs().max()) < 1e-2


def _ivfpq():
    work, config, tr = tiny.cell("ivfpq_vectors_np128")
    inp = IVFPQInputs(config, 11, "cpu")
    return inp, inp.index()


def test_ivfpq_reference_matches_the_port_s_search():
    inp, idx = _ivfpq()
    q, _ = corpus.reconstructions(inp.codes, inp.layout, inp.rid, inp.cent, inp.rot, inp.pqc,
                                  24, 5, noise=0.1)
    v, p = idx.search(q.numpy(), 10, nprobe=8)
    ref = ref_ivfpq.search(inp.reference(), q, 8, 10, "f32")
    agree = np.mean([len(set(a[0].tolist()) & set(b.tolist())) / 10 for a, b in zip(ref, p)])
    assert agree > 0.95
    got = ref_ivfpq.judge(inp.reference(), q, list(zip(p, v)), 8, 10)
    assert got["score_err"] < 1e-5 and got["rank_gap"] < 1e-5


def test_ivfpq_judge_reads_a_wrong_answer():
    inp, idx = _ivfpq()
    q, _ = corpus.reconstructions(inp.codes, inp.layout, inp.rid, inp.cent, inp.rot, inp.pqc,
                                  8, 5, noise=0.1)
    v, p = idx.search(q.numpy(), 10, nprobe=8)
    p2 = p.copy()
    p2[3, 0] = (p2[3, 0] + 1) % inp.layout.sizes.sum()
    got = ref_ivfpq.judge(inp.reference(), q, list(zip(p2, v)), 8, 10)
    assert got["score_err"] > 1e-3
    dup = p.copy()
    dup[0, 1] = dup[0, 0]
    assert ref_ivfpq.judge(inp.reference(), q, list(zip(dup, v)), 8, 10)["rank_gap"] == np.inf


def test_engine_rows_and_lazy_ids():
    rows = [[{"id": "W12", "score": 0.5}, {"id": "W3", "score": 0.25}]]
    (pos, sc), = served(rows)
    assert pos.tolist() == [12, 3] and sc.tolist() == [0.5, 0.25]
    assert LazyIds().resolve([7, 9]) == ["W7", "W9"]


def test_flat_reference_matches_the_port_s_flat_index():
    from abstracts_search_tpu_torch.index.flat import FlatIndex

    x = corpus.unit_rows(4096, 32, 1, "cpu", torch.float32)
    f = FlatIndex(chunk=1024, device="cpu")
    f.add(x)
    q = torch.nn.functional.normalize(torch.randn(16, 32), dim=1)
    v, p = f.search(q.numpy(), 10)
    rv, rp = ref_flat.top(x, q, 10)
    assert np.array_equal(p, rp.numpy())
    got = ref_flat.judge(x, q, list(zip(p, v)), 10)
    assert got["score_err"] < 1e-6 and got["rank_gap"] < 1e-6


@pytest.mark.parametrize("seg", [4, 16])
def test_fill_layout_matches_the_port_s_pack(seg):
    from abstracts_search_tpu_torch.index.lists import pack_lists

    r = np.random.default_rng(seg)
    n, lists, mb = 500, 9, 6
    assign = r.integers(0, lists, n)
    assign[assign == 4] = 5                     # an empty list
    codes = r.integers(0, 256, (n, mb)).astype(np.uint8)
    p = pack_lists(codes, np.arange(n), assign, lists, seg_size=seg, transposed=True)
    a, c = ref_fill.program_output(p.data, p.row_ids, p.seg_cnt, n, "cpu")
    assert np.array_equal(a.numpy(), assign) and np.array_equal(c.numpy(), codes)
    packed = {"data": p.data, "row_ids": p.row_ids, "seg_valid": p.seg_valid,
              "seg_start": p.seg_start, "seg_cnt": p.seg_cnt}
    assert ref_fill.layout_mismatches(packed, a, c, lists, seg) == 0
    rid = p.row_ids.copy()
    rid[0, [0, 1]] = rid[0, [1, 0]]
    packed["row_ids"] = rid
    assert ref_fill.layout_mismatches(packed, a, c, lists, seg) == 2


def test_fill_encode_matches_the_port_s_encode():
    from abstracts_search_tpu_torch.index.ivfpq import IVFPQIndex

    work, config, tr = tiny.cell("ivfpq_fill_delta")
    ix = config["index"]
    cent, rot, pqc = corpus.trained_params(ix["n_lists"], ix["dim"], ix["pq_m"], 16, 2, "cpu")
    (x, _), = corpus.fill_rows(512, 512, cent, rot, np.ones(ix["n_lists"]), 2)
    idx = IVFPQIndex(ix["n_lists"], ix["dim"], pq_m=ix["pq_m"], pq_nbits=4, seg_size=32,
                     device="cpu")
    idx.set_params(cent.numpy(), pqc.numpy(), rot.numpy())
    a, c = idx.encode(x)
    ra, rc = ref_fill.encode(torch.from_numpy(x), cent, rot, pqc)
    assert np.mean(a == ra.numpy()) > 0.99
    assert np.array_equal(corpus.decode_codes(torch.from_numpy(c), ix["pq_m"])[a == ra.numpy()],
                          rc[torch.from_numpy(a == ra.numpy())])
    gaps = ref_fill.encode_gaps(torch.from_numpy(x), torch.from_numpy(a),
                                corpus.decode_codes(torch.from_numpy(c), ix["pq_m"]),
                                cent, rot, pqc)
    assert gaps["assign_flips"] <= 2 and gaps["code_gap"] < 1e-6
