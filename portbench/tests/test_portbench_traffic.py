"""Traffic and inputs: the same seed gives the same work; every seed the
same set of sizes."""

import numpy as np
import torch

from portbench.drivers import open_loop_http
from portbench.tests import tiny
from portbench.yardstick import corpus


def test_schedule_is_the_seed_s_and_one_set_of_sizes():
    tr = {"rate_qps": 50.0, "words": [4, 24]}
    a, b = open_loop_http.schedule(tr, 10, 2**31 + 11), open_loop_http.schedule(tr, 10, 2**31 + 11)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    c = open_loop_http.schedule(tr, 10, 3)
    assert not np.array_equal(a[1], c[1])
    assert np.array_equal(np.sort(a[1]), np.sort(c[1]))
    assert np.allclose(np.sort(np.diff(a[0])), np.sort(np.diff(a[0])))
    assert abs((a[0][-1] + np.diff(a[0]).mean()) - 10) < 1.0 and a[0][0] == 0


def test_texts_are_the_seed_s():
    v = corpus.vocabulary()
    assert v == corpus.vocabulary()
    w = np.array([4, 9, 24])
    assert corpus.typed_texts(w, 5, v) == corpus.typed_texts(w, 5, v)
    assert corpus.typed_texts(w, 5, v) != corpus.typed_texts(w, 6, v)
    assert [len(t.split()) for t in corpus.typed_texts(w, 5, v)] == [4, 9, 24]


def test_keys_take_any_whole_number():
    keys = {corpus.derive(s, "x") for s in (-1, 0, 1, 2**31 + 5, 2**70)}
    assert len(keys) == 5 and all(0 <= k < 2**63 for k in keys)


def test_seeded_codes_do_not_depend_on_the_slice():
    codes = corpus.SeededCodes((40_000, 4, 8), seed=3, device="cpu")
    whole = codes[0:40_000]
    assert np.array_equal(codes[16_380:16_390], whole[16_380:16_390])
    segs = torch.tensor([39_999, 5, 16_384, 5])
    assert np.array_equal(codes.segments(segs).numpy(), whole[segs.numpy()])


def test_layout_and_row_ids():
    sizes = corpus.list_sizes(5000, 0, 37)
    assert sizes.sum() == 5000 and sizes.min() >= 1
    lay = corpus.Layout.of(sizes, 16)
    assert lay.seg_valid.sum() == 5000
    rid = corpus.row_ids(lay, 4, "cpu")
    live = rid[rid >= 0]
    assert np.array_equal(np.sort(live), np.arange(5000))
    assert np.array_equal(rid, corpus.row_ids(lay, 4, "cpu"))


def test_fill_rows_and_query_pools_are_the_seed_s():
    cent, rot, pqc = corpus.trained_params(16, 8, 4, 16, 1, "cpu")
    a = corpus.fill_rows(100, 32, cent, rot, np.ones(16), 9)
    b = corpus.fill_rows(100, 32, cent, rot, np.ones(16), 9)
    assert [len(x) for x, _ in a] == [32, 32, 32, 4]
    assert all(np.array_equal(x, y) for (x, _), (y, _) in zip(a, b))
    work, config, tr = tiny.cell("flat_shard_k10")
    from portbench.drivers.batch_loop import Cell

    p1 = Cell(config, tr, seed=5, device="cpu").pool()
    p2 = Cell(config, tr, seed=5, device="cpu").pool()
    assert np.array_equal(p1, p2) and p1.shape == (tr["pool_batches"], tr["batch"], 64)
