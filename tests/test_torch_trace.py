"""The port's tracer (``utils/trace.py``) and the spans at its layer
boundaries, on the CPU at tiny sizes.

- The tracer: off, a span is one shared no-op that reads no clock and
  opens no profiler range; on, spans record their parents, counts and
  self time; under ``torch.profiler`` each span is an ``astpu::<name>``
  range that contains its children's, its counts the range's arguments;
  ``collect`` resolves device spans; ``StageTimer`` and
  ``profile_scope`` ride on it; threads keep their own stacks.
- The layers: the engine -> ``ivfpq.search`` -> probe / slots / scan /
  winners / positions tree (and the host storage's gather), the flat
  tree, the fill's stages and ``fill_stats``, and no wrapper span on
  the kernels' plain route.
"""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from abstracts_search_tpu_torch.index import FlatIndex, IVFPQIndex
from abstracts_search_tpu_torch.ops import adc, topk
from abstracts_search_tpu_torch.serve.engine import SearchEngine
from abstracts_search_tpu_torch.utils import trace
from abstracts_search_tpu_torch.utils.trace import StageTimer, profile_scope

N_LISTS, DIM, M, SEG = 8, 32, 8, 32
FILL_KEYS = {"rows", "seconds", "rows_per_s", "spill_s", "pack_s", "install_s", "encode_s",
             "download_s", "normalize_s", "upload_s", "upload_pinned_rows", "pack_on_card"}
# what a fill through ``lists_dir`` adds: the mesh's barrier and this rank's share
SPILL_KEYS = {"barrier_s", "rank", "mesh_size", "rank_rows", "rank_chunks"}


@pytest.fixture(autouse=True)
def fresh_tracer():
    """Each test starts and ends with the tracer off and drained."""
    trace.stop()
    trace.collect()
    yield
    trace.stop()
    trace.collect()


def by_name(spans) -> dict:
    out: dict = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def children(spans, parent) -> list:
    return [s["name"] for s in spans if s["parent"] == parent["id"]]


# -- the tracer ---------------------------------------------------------------------


def test_off_is_one_shared_no_op_that_reads_no_clock(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("an off span touched the clock or the profiler")

    monkeypatch.setattr(trace.time, "perf_counter_ns", refuse)
    monkeypatch.setattr(trace, "_Range", refuse)
    assert not trace.enabled()
    sp = trace.span("engine.search", queries=3)
    assert sp is trace.OFF and trace.span("topk", device=torch.device("cpu")) is trace.OFF
    with sp as inner:
        assert inner is trace.OFF
    monkeypatch.undo()
    assert trace.collect() == []


def test_on_records_parents_counts_and_self_time():
    trace.start()
    with trace.span("outer", queries=3, nprobe=np.int64(4)):
        time.sleep(0.02)
        with trace.span("inner", device=torch.device("cpu")):
            time.sleep(0.03)
        with trace.span("second"):
            pass
    trace.stop()
    with trace.span("after"):
        pass
    spans = by_name(trace.collect())
    assert set(spans) == {"outer", "inner", "second"}
    (o,), (i,), (s,) = spans["outer"], spans["inner"], spans["second"]
    assert o["parent"] is None and i["parent"] == s["parent"] == o["id"]
    assert o["counts"] == {"queries": 3, "nprobe": 4} and i["counts"] == {}
    assert type(o["counts"]["nprobe"]) is int     # a profiler range takes ints alone
    assert o["thread"] == i["thread"] == threading.get_ident()
    assert o["start_ns"] <= i["start_ns"] < i["end_ns"] <= o["end_ns"]
    assert o["self_s"] == pytest.approx(o["host_s"] - i["host_s"] - s["host_s"])
    assert 0.015 < o["self_s"] < o["host_s"] and i["self_s"] == i["host_s"] >= 0.03
    # off the card a device span's device time is its host time
    assert i["device_s"] == i["host_s"] and o["device_s"] is None
    # collect drains
    assert trace.collect() == []


def test_spans_are_profiler_ranges_that_contain_their_children():
    from torch.profiler import ProfilerActivity, profile

    assert not trace.enabled()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.enabled()      # a running profiler turns the tracer on
        with trace.span("outer"):
            with trace.span("inner"):
                torch.ones(64).sum()
    assert not trace.enabled()
    ranges = {e.name: e.time_range for e in prof.events() if e.name.startswith(trace.PREFIX)}
    outer, inner = ranges["astpu::outer"], ranges["astpu::inner"]
    assert outer.start <= inner.start and inner.end <= outer.end
    assert [s["name"] for s in trace.collect()] == ["inner", "outer"]


def test_garbage_collections_are_profiler_ranges_while_on(monkeypatch):
    import gc

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("engine.search"):
            gc.collect(1)
    assert "astpu::gc" in {e.name for e in prof.events()}
    # the collection is no span: the span it fell in keeps it
    assert [s["name"] for s in trace.collect()] == ["engine.search"]
    # once the tracer is off, collections cost nothing of the tracer's
    assert trace._gc_range not in gc.callbacks

    def refuse(*a, **kw):
        raise AssertionError("a collection opened a range with the tracer off")

    monkeypatch.setattr(trace, "_Range", refuse)
    gc.collect(0)
    assert trace._gc_open is None


def test_measure_times_itself_with_the_tracer_off():
    with trace.measure("stage.x", device=torch.device("cpu")) as sp:
        time.sleep(0.01)
    assert sp.host_s >= 0.01 and sp.device_seconds() == sp.host_s
    assert trace.collect() == []
    trace.start()
    with trace.measure("stage.y"):
        pass
    assert [s["name"] for s in trace.collect()] == ["stage.y"]


def test_stage_timer_report_is_unchanged_and_its_stages_are_spans():
    trace.start()
    timer = StageTimer()
    with timer.stage("encode", batch=4) as rec:
        time.sleep(0.01)
        rec["rows"] = 7
    with pytest.raises(KeyError):
        with timer.stage("probe"):
            raise KeyError("x")
    rep = timer.report()
    assert [sorted(s) for s in rep["stages"]] == [["batch", "rows", "seconds", "stage"],
                                                  ["error", "seconds", "stage"]]
    assert rep["stages"][0]["seconds"] >= 0.01
    spans = by_name(trace.collect())
    assert rep["stages"][0]["seconds"] == round(spans["stage.encode"][0]["host_s"], 4)
    assert "stage.probe" in spans


def test_profile_scope_turns_the_tracer_on(tmp_path, monkeypatch):
    monkeypatch.setenv("ASTPU_PROFILE", str(tmp_path))
    with profile_scope("fill"):
        assert trace.enabled()
        with trace.span("fill.job"):
            with trace.span("fill.upload", bytes=4096):
                torch.ones(4).sum()
    assert not trace.enabled()
    events = {e["name"]: e for e in json.loads((tmp_path / "fill" / "trace.json").read_text())
              ["traceEvents"]}
    assert "astpu::fill.job" in events
    # the operator's trace carries each span's counts
    assert events["astpu::fill.upload"]["args"]["bytes"] == 4096
    # the scope's spans live on in its trace alone
    assert trace.collect() == []
    # a scope leaves a tracer that was started on, and its spans for collect
    trace.start()
    with profile_scope("tune"):
        with trace.span("stage.sweep"):
            pass
    assert trace.enabled()
    assert [s["name"] for s in trace.collect()] == ["stage.sweep"]


def test_threads_keep_their_own_parents():
    """Eight threads open nested spans at a short switch interval: every
    child's parent is its own thread's outer span, and no span is lost."""
    n_threads, reps = 8, 200
    trace.start()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for i in range(reps):
                with trace.span("outer", i=i):
                    with trace.span("inner"):
                        pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans = trace.collect()
    by_id = {s["id"]: s for s in spans}
    assert len(spans) == len(by_id) == 2 * n_threads * reps
    for s in spans:
        if s["name"] == "inner":
            parent = by_id[s["parent"]]
            assert parent["name"] == "outer" and parent["thread"] == s["thread"]


@pytest.mark.gpu
def test_device_spans_resolve_in_collect_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    a = torch.randn((2048, 2048), device=dev)
    trace.start()
    for _ in range(3):
        with trace.span("mm", device=dev):
            a @ a
    spans = trace.collect()
    assert [s["name"] for s in spans] == ["mm"] * 3
    assert all(s["device_s"] > 0 for s in spans)
    assert len(trace._pool) >= 3     # the events went back to the pool


# -- the layers ---------------------------------------------------------------------


def _corpus(n=1200, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((24, DIM)).astype(np.float32)
    x = c[rng.integers(0, 24, n)] + 0.3 * rng.standard_normal((n, DIM)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def trained():
    x = _corpus()
    idx = IVFPQIndex(N_LISTS, DIM, pq_m=M, pq_nbits=4, seg_size=SEG, chunk=128, device="cpu")
    idx.train(x, kmeans_iters=3, opq_iters=1, pq_iters=3)
    return x, (idx.centroids, idx.pq_centroids, idx.rotation)


def _filled(trained, storage="device"):
    x, params = trained
    idx = IVFPQIndex(N_LISTS, DIM, pq_m=M, pq_nbits=4, seg_size=SEG, chunk=128,
                     storage=storage, device="cpu")
    idx.set_params(*params)
    idx.fill(x)
    return idx


class Ids:
    def resolve(self, positions):
        return [f"W{int(p)}" for p in positions]


def test_engine_and_ivfpq_search_tree(trained):
    idx = _filled(trained)
    eng = SearchEngine(idx, Ids(), None, nprobe=4)
    q = _corpus(16, seed=1)
    trace.start()
    rows = eng.search_batch_encoded(q, 5)
    spans = trace.collect()
    names = by_name(spans)
    (e,), (s,) = names["engine.search"], names["ivfpq.search"]
    assert e["parent"] is None and s["parent"] == e["id"]
    assert len(rows) == 16
    assert e["counts"] == {"queries": 16}
    assert s["counts"] == {"queries": 16, "nprobe": 4}
    assert children(spans, s) == ["ivfpq.probe", "ivfpq.slots", "ivfpq.scan", "ivfpq.winners",
                                  "ivfpq.positions"]
    assert names["ivfpq.scan"][0]["counts"] == {"slots": idx.last_scan_stats["live_slots"]}
    for name in ("ivfpq.probe", "ivfpq.slots", "ivfpq.scan"):
        assert names[name][0]["device_s"] == names[name][0]["host_s"]
    assert e["self_s"] == pytest.approx(e["host_s"] - s["host_s"])
    # the plain route takes no wrapper span
    assert "adc_topk" not in names and "topk" not in names


def test_host_storage_search_gathers_under_its_span(trained):
    idx = _filled(trained, storage="host")
    q = _corpus(8, seed=2)
    trace.start()
    idx.search(q, 5, nprobe=4)
    spans = trace.collect()
    (s,) = by_name(spans)["ivfpq.search"]
    assert children(spans, s) == ["ivfpq.probe", "ivfpq.slots", "ivfpq.gather", "ivfpq.scan",
                                  "ivfpq.winners", "ivfpq.positions"]
    names = by_name(spans)
    assert names["ivfpq.gather"][0]["counts"] == {
        "bytes": idx.last_scan_stats["gathered_bytes"]}
    assert names["ivfpq.scan"][0]["counts"] == {"slots": idx.last_scan_stats["tiles"]}


def test_flat_search_tree():
    x = _corpus(1000)
    flat = FlatIndex(chunk=256, device="cpu")
    flat.add(x)
    trace.start()
    flat.search(x[:6], 4)
    spans = trace.collect()
    (s,) = by_name(spans)["flat.search"]
    assert s["counts"] == {"queries": 6}
    assert children(spans, s) == ["flat.upload", "flat.merge", "flat.winners"]


@pytest.mark.parametrize("spill", [False, True], ids=["in-memory", "spilled"])
def test_fill_stages_are_spans_and_fill_stats_keep_their_keys(trained, tmp_path, spill):
    """In memory from host chunks (off the card the host packs), and
    spilled to ``lists_dir`` from host-array and tensor chunks in turn,
    whose lists equal the in-memory fill's of the same chunks."""
    x, params = trained

    def index():
        idx = IVFPQIndex(N_LISTS, DIM, pq_m=M, pq_nbits=4, seg_size=SEG, chunk=128,
                         device="cpu")
        idx.set_params(*params)
        return idx

    groups = [(torch.from_numpy(x[lo:lo + 400]) if spill and lo % 800 else x[lo:lo + 400],
               np.arange(lo, lo + 400, dtype=np.int64)) for lo in range(0, len(x), 400)]
    hosts = [isinstance(v, np.ndarray) for v, _ in groups]
    assert hosts == [True, not spill, True]
    idx = index()
    trace.start()
    idx.fill_stream(iter(groups), lists_dir=tmp_path / "lists" if spill else None)
    spans = trace.collect()
    st = idx.fill_stats
    assert set(st) == FILL_KEYS | (SPILL_KEYS if spill else set()) and st["rows"] == len(x)
    names = by_name(spans)
    (job,) = names["fill.job"]
    assert set(children(spans, job)) == {"fill.encode", "fill.download", "fill.collect",
                                         "fill.pack", "fill.install"}
    # the fill holds the codes on the host: each chunk's come there once,
    # under one fill.download
    assert [s["parent"] for s in names["fill.download"]] == [job["id"]] * len(groups)
    # off the card no host row is staged through pinned memory
    assert st["pack_on_card"] == st["upload_pinned_rows"] == 0
    if spill:
        ref = index()
        ref.fill_stream(iter(groups))
        for f in ("data", "row_ids", "seg_valid", "seg_start", "seg_cnt"):
            a, b = np.asarray(getattr(idx.packed, f)), np.asarray(getattr(ref.packed, f))
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), f
    else:
        # off the card the host packs, and the span says so
        assert [s["counts"] for s in names["fill.pack"]] == [{"rows": len(x), "on_card": 0}]
    # a host chunk's encode holds, window by window, its upload and the
    # card's normalisation of it; a tensor goes up whole
    assert [children(spans, enc) for enc in names["fill.encode"]] == \
        [["fill.upload", "fill.normalize"] if h else [] for h in hosts]
    assert len(names["fill.normalize"]) == len(names["fill.upload"]) == sum(hosts)
    assert [u["counts"] for u in names["fill.upload"]] == \
        [{"bytes": 400 * DIM * 4, "pinned": 0}] * sum(hosts)
    # each stage's seconds are the host seconds of its spans
    for key, name in (("normalize_s", "fill.normalize"), ("upload_s", "fill.upload"),
                      ("spill_s", "fill.collect"), ("pack_s", "fill.pack"),
                      ("install_s", "fill.install"), ("encode_s", "fill.encode"),
                      ("download_s", "fill.download")):
        assert st[key] == pytest.approx(sum(s["host_s"] for s in names[name])), key
    assert st["normalize_s"] + st["upload_s"] <= st["encode_s"]
    assert st["encode_s"] + st["download_s"] + st["spill_s"] + st["pack_s"] <= job["host_s"]


def test_fill_stats_without_the_tracer(trained):
    x, params = trained
    idx = IVFPQIndex(N_LISTS, DIM, pq_m=M, pq_nbits=4, seg_size=SEG, chunk=128, device="cpu")
    idx.set_params(*params)
    idx.fill_stream(iter([(torch.from_numpy(x), np.arange(len(x)))]))
    assert set(idx.fill_stats) == FILL_KEYS and idx.fill_stats["encode_s"] > 0
    assert trace.collect() == []


@pytest.mark.parametrize("spill", [False, True], ids=["in-memory", "spilled"])
def test_every_fill_chunk_takes_its_codes_from_encode(trained, tmp_path, monkeypatch, spill):
    """What ``encode`` returns for a chunk is what the fill packs, for host
    and tensor chunks on either tail: a fault planted in ``encode``
    reaches the lists."""
    x, params = trained
    groups = [(torch.from_numpy(x[lo:lo + 400]) if lo % 800 else x[lo:lo + 400],
               np.arange(lo, lo + 400, dtype=np.int64)) for lo in range(0, len(x), 400)]

    def filled(name):
        idx = IVFPQIndex(N_LISTS, DIM, pq_m=M, pq_nbits=4, seg_size=SEG, chunk=128,
                         device="cpu")
        idx.set_params(*params)
        idx.fill_stream(iter(groups), lists_dir=tmp_path / name if spill else None)
        return idx.packed

    ref = filled("ref")
    encode, calls = IVFPQIndex.encode, []

    def flipped(self, v, **kw):
        a, c = encode(self, v, **kw)
        calls.append(len(c))
        return a, c ^ 1

    monkeypatch.setattr(IVFPQIndex, "encode", flipped)
    got = filled("got")
    assert calls == [len(p) for _, p in groups]
    np.testing.assert_array_equal(np.asarray(got.row_ids), np.asarray(ref.row_ids))
    # every stored code byte, and no padding byte, has its low bit flipped
    diff = np.asarray(got.data) ^ np.asarray(ref.data)
    assert set(np.unique(diff)) == {0, 1} and int(diff.sum()) == len(x) * M // 2


def test_the_plain_route_takes_no_wrapper_span():
    g = torch.Generator().manual_seed(0)
    q, x = torch.randn((3, 16), generator=g), torch.randn((256, 16), generator=g)
    codes = torch.randint(0, 256, (4, 4, SEG), dtype=torch.uint8, generator=g)
    luts = torch.randn((2, 8, 16), generator=g)
    ids = torch.arange(4, dtype=torch.int32)
    trace.start()
    topk.streaming_topk(q, x, 256, 5, chunk=128, impl="torch")
    topk.streaming_topk(q, x, 256, 5, chunk=128, impl="torch", mode="fast")
    adc.adc_topk(codes, luts, ids, ids % 2, torch.full((4,), SEG, dtype=torch.int32), 5,
                 impl="torch")
    adc.adc_scan(codes, luts, ids, ids % 2, transposed=True, impl="torch")
    assert trace.collect() == []
