"""The readers of the program's spans: each on a hand-made run, none
where the program has no tracer, and all five in the tiny traced runs
of their cells on the CPU."""

import pytest

from portbench import harness
from portbench.tests import tiny

READERS = {"k1_host_us.flat": "flat_shard_k10", "engine_self_ms.vectors": "ivfpq_vectors_np128",
           "scan_device_ms.vectors": "ivfpq_vectors_np128",
           "normalize_share.fill": "ivfpq_fill_delta", "upload_share.fill": "ivfpq_fill_delta"}


def _run(**kw):
    run = harness.Run({}, {}, True)
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def _span(name, sid, parent=None, host_s=0.0, self_s=None, device_s=None, **counts):
    return {"name": name, "id": sid, "parent": parent, "thread": 1, "start_ns": 0,
            "end_ns": int(host_s * 1e9), "host_s": host_s,
            "self_s": host_s if self_s is None else self_s, "device_s": device_s,
            "counts": counts}


@pytest.fixture(autouse=True)
def drained():
    """No span of an earlier run in this process reaches a reader."""
    from abstracts_search_tpu_torch.utils import trace

    trace.stop()
    trace.collect()
    yield
    trace.collect()


def test_readers_on_hand_made_spans():
    spans = [_span("topk", 1, host_s=40e-6, route=2), _span("topk", 2, host_s=60e-6),
             _span("engine.search", 3, host_s=0.010, self_s=0.004),
             _span("engine.search", 4, host_s=0.012, self_s=0.006),
             _span("ivfpq.search", 5, parent=3, host_s=0.006),
             _span("ivfpq.scan", 6, parent=5, host_s=0.001, device_s=0.003),
             _span("ivfpq.scan", 7, parent=5, host_s=0.001, device_s=0.005)]
    run = _run(program=spans)
    assert harness.reader("k1_host_us.flat")(run) == pytest.approx(50.0)
    assert harness.reader("engine_self_ms.vectors")(run) == pytest.approx(5.0)
    assert harness.reader("scan_device_ms.vectors")(run) == pytest.approx(4.0)
    empty = _run(program=[])
    assert all(harness.reader(m)(empty) is None for m in
               ("k1_host_us.flat", "engine_self_ms.vectors", "scan_device_ms.vectors"))


def test_fill_shares_on_hand_made_jobs():
    jobs = [(100, 2.0, {"normalize_s": 0.5, "upload_s": 0.2, "pack_s": 0.1}),
            (100, 3.0, {"normalize_s": 1.0, "upload_s": 0.3, "pack_s": 0.1})]
    assert harness.reader("normalize_share.fill")(_run(jobs=jobs)) == pytest.approx(30.0)
    assert harness.reader("upload_share.fill")(_run(jobs=jobs)) == pytest.approx(10.0)
    # a program whose fill_stats lack the stage gives nothing
    old = [(100, 2.0, {"pack_s": 0.1})]
    assert harness.reader("normalize_share.fill")(_run(jobs=old)) is None
    assert harness.reader("upload_share.fill")(_run(jobs=old)) is None
    assert harness.reader("upload_share.fill")(_run(jobs=[])) is None


def test_span_readers_give_nothing_without_the_programs_tracer(monkeypatch):
    """A program whose tracer has no ``collect`` (one without spans)."""
    from abstracts_search_tpu_torch.utils import trace

    monkeypatch.delattr(trace, "collect")
    for metric in ("k1_host_us.flat", "engine_self_ms.vectors", "scan_device_ms.vectors"):
        assert harness.reader(metric)(_run()) is None


def _emulated_kernel_wrapper(monkeypatch):
    """The flat cell on the CPU runs kernel 1's plain route, which takes
    no span; the kernel's wrapper is stood in for by a ``topk`` span
    around the plain route, so the reader has calls to read."""
    from abstracts_search_tpu_torch.index import flat
    from abstracts_search_tpu_torch.utils import trace

    plain = flat.streaming_topk

    def wrapper(q, x, *a, **kw):
        with trace.span("topk", device=x.device):
            return plain(q, x, *a, **kw)

    monkeypatch.setattr(flat, "streaming_topk", wrapper)


@pytest.mark.parametrize("cell", sorted(set(READERS.values())))
def test_tiny_traced_runs_read_the_span_metrics(cell, monkeypatch):
    if cell == "flat_shard_k10":
        _emulated_kernel_wrapper(monkeypatch)
    out = tiny.run(cell, seconds=3.0, trace=True)
    assert out["correct"], out["checks"]
    mine = [m for m, c in READERS.items() if c == cell]
    got = {m: out["metrics"][m]["value"] for m in mine if m in out["metrics"]}
    assert set(got) == set(mine), out["metrics"]
    assert all(v > 0 for v in got.values()), got
    if cell == "ivfpq_fill_delta":
        m = out["metrics"]
        assert sum(m[k]["value"] for k in ("normalize_share.fill", "upload_share.fill",
                                           "pack_share.fill")) <= 100.0


def test_untraced_runs_leave_the_tracer_off():
    from abstracts_search_tpu_torch.utils import trace

    out = tiny.run("ivfpq_vectors_np128", seconds=3.0)
    assert out["correct"], out["checks"]
    assert not trace.enabled() and trace.collect() == []
