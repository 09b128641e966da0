"""The end-to-end arithmetic and the counts of operations and bytes."""

import math
import types

import pytest
import torch

from portbench import harness
from portbench.yardstick import peaks, timeline


def _run(**kw):
    run = harness.Run({}, {}, False)
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def test_p95_counts_failures_as_missing():
    read = harness.reader("search_p95_ms")
    ok = [float(i) for i in range(1, 96)]
    assert read(_run(latencies_ms=ok + [math.inf] * 5)) == 95.0
    assert read(_run(latencies_ms=ok + [math.inf] * 6)) is None
    assert timeline.percentile([5.0] * 19 + [100.0], 95) == 5.0
    assert timeline.percentile([5.0] * 18 + [100.0] * 2, 95) == 100.0


def test_rates_are_over_the_whole_window():
    assert harness.reader("batch_qps")(_run(queries=1280, window_s=2.0)) == 640.0
    assert harness.reader("flat_qps")(_run(queries=1280, window_s=2.0)) == 640.0
    jobs = [(100, 2.0, {"pack_s": 0.5}), (100, 3.0, {"pack_s": 1.0})]
    assert harness.reader("fill_rows_per_s")(_run(jobs=jobs)) == 40.0
    assert harness.reader("pack_share.fill")(_run(jobs=jobs)) == pytest.approx(30.0)
    assert harness.reader("setup_s")(_run(setup_s=12.5)) == 12.5


def test_adc_bytes_count_each_probed_segment_once():
    one = peaks.adc_cost(10, 16384, 10, 4, 128, 16, 256, 10)
    again = peaks.adc_cost(10, 16384, 40, 4, 128, 16, 256, 10)
    seg_bytes = 10 * 16384
    assert one[1] - 12 * 10 - 80 * 10 - 4 * 4 * 128 * 16 == seg_bytes
    assert again[1] - 12 * 40 - 80 * 40 - 4 * 4 * 128 * 16 == seg_bytes
    assert again[0] == 4 * one[0]


@pytest.mark.parametrize("slower", [1.0, 1.25, 3.0])
def test_roofline_share_stays_at_or_below_100(slower):
    ops, moved = peaks.topk_cost(128, 2_097_152, 1024, 10, 2)
    least, by = peaks.least_seconds(ops, moved, "bf16")
    assert by == "bytes"
    run = _run(op_costs={"k1": {i: (ops, moved, "bf16") for i in (3, 4, 5, 9)}},
               op_device_s={"k1": {i: least * slower for i in (2, 3, 4, 5)}})
    # calls 3-5 were both counted and traced; 2 and 9 lie across an edge
    share = peaks.roofline_share(run, "k1")
    assert share == pytest.approx(100.0 / slower) and share <= 100.0 + 1e-9
    assert peaks.roofline_share(run, "k3") is None


def test_window_least_scales_the_traced_calls_to_the_window():
    a = peaks.topk_cost(128, 2_097_152, 1024, 10, 2)
    b = peaks.topk_cost(128, 1_048_576, 1024, 10, 2)
    run = _run(op_costs={"k1": {0: a + ("bf16",), 1: b + ("bf16",)}},
               counters={"calls": {"k1": 10, "k3": 4}}, window_s=2.0)
    mean = (peaks.least_seconds(*a, "bf16")[0] + peaks.least_seconds(*b, "bf16")[0]) / 2
    assert peaks.window_least_seconds(run, ["k1"]) == pytest.approx(10 * mean)
    assert peaks.window_least_seconds(run, ["k1", "k3"]) is None
    assert harness.reader("flat_step_mfu")(run) == pytest.approx(100 * 10 * mean / 2.0)


def test_readers_of_spans_and_counters():
    run = _run(counters={"batches": 4, "batch_requests": 10, "live_slots": [10, 30]})
    assert harness.reader("batch_rows.typed")(run) == 2.5
    assert harness.reader("live_slots.vectors")(run) == 20.0
    run.span_log = [("batch", 0.0, 1.0, 1), ("index", 0.1, 0.7, 1)]
    assert harness.reader("result_share.vectors")(run) == pytest.approx(40.0)
    run.profile = {"busy_s": 0.25, "window_s": 1.0}
    assert harness.reader("device_idle.flat")(run) == 75.0


def test_typed_step_mfu_reads_the_union_of_steps():
    enc = {"vocab_size": 10, "hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 1,
           "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 4, "mrl_dim": 8}
    run = _run(config={"encoder": enc},
               counters={"window_perf": (0.0, 10.0), "tokens": [[3, 5]]})
    # two workers whose steps overlap by half: the union is 3 s
    run.span_log = [("encode", 1.0, 2.0, 1), ("search", 2.0, 3.0, 1),
                    ("encode", 2.0, 3.5, 2), ("search", 3.5, 4.0, 2)]
    want = 100.0 * peaks.stella_flops(enc, [3, 5]) / (3.0 * peaks.PEAK_OPS["f32"])
    assert harness.reader("typed_step_mfu")(run) == pytest.approx(want)
    assert harness.reader("encode_share.typed")(run) == pytest.approx(100 * 2.5 / 4.0)


def test_stella_flops_count_every_projection():
    enc = {"hidden_size": 4, "intermediate_size": 6, "num_hidden_layers": 2,
           "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 2, "mrl_dim": 3}
    layer = 4 * (2 + 2) * 2 + 2 * 2 * 4 + 3 * 4 * 6
    assert peaks.stella_matmul_params(enc) == 2 * layer + 4 * 3
    assert peaks.stella_flops(enc, [5]) == 2 * 2 * layer * 5 + 4 * 2 * 2 * 2 * 25 + 2 * 4 * 3


def test_fill_costs_are_bounded_by_kernel_1():
    parts = {n: peaks.least_seconds(o, m, k) for n, o, m, k in
             peaks.fill_costs(4_194_304, 1024, 65_536, 128, 16, 64)}
    assert parts["assign"][1] == "operations"
    assert parts["assign"][0] == pytest.approx(2 * 4_194_304 * 65_536 * 1024 / 989e12)


def test_busy_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6)]
    assert timeline.busy(iv) == 4
    assert timeline.gaps(iv, 0, 8) == [(3, 5), (6, 8)]
    assert timeline.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(
        (4.5 - 1.5) / 3.0)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from portbench.reference.stella import tf32

    x = torch.tensor([1.0 + 2.0 ** -12, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 3.0])
    assert tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 3.0]


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "abstracts_search_tpu_torch_fake", types.ModuleType("x"))
    assert "abstracts_search_tpu_torch_fake" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "flax.fake", types.ModuleType("y"))
    assert "flax" in harness.banned_modules()


def test_op_ranges_time_and_count_only_the_calls_in_the_slice(monkeypatch):
    from portbench.drivers import common

    class Event:
        clock = [0.0]

        def __init__(self, enable_timing=False):
            self.t = None

        def record(self):
            Event.clock[0] += 1.0
            self.t = Event.clock[0]

        def elapsed_time(self, end):
            return (end.t - self.t) * 1e3  # ms: one second a call

    class Arg:
        is_cuda = True
        shape = (128, 1024)
        dtype = torch.bfloat16

        def element_size(self):
            return 2

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    mod = types.SimpleNamespace(streaming_topk=lambda q, x, n, k: "out")
    run = _run()
    on = [False]
    r = common.OpRanges(run, "k1", mod, "streaming_topk", common.topk_cost, lambda: on[0])
    r.on = True
    assert mod.streaming_topk(Arg(), Arg(), 4096, 10) == "out"
    on[0] = True
    for _ in range(2):
        assert mod.streaming_topk(Arg(), Arg(), 4096, 10) == "out"
    on[0] = False
    mod.streaming_topk(Arg(), Arg(), 4096, 10)
    r.close()
    assert run.counters["calls"]["k1"] == 4
    assert sorted(run.op_costs["k1"]) == [1, 2] == sorted(run.op_device_s["k1"])
    assert run.op_costs["k1"][1] == peaks.topk_cost(128, 4096, 1024, 10, 2) + ("bf16",)
    assert run.op_device_s["k1"][2] == pytest.approx(1.0)
    assert mod.streaming_topk(Arg(), Arg(), 4096, 10) == "out" and run.counters["calls"]["k1"] == 4
