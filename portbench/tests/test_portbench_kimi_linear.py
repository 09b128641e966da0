"""The Kimi Linear cell driven end to end at a tiny size on the CPU, with
its own tiny configuration (the catalog's keys cut to tiny widths, a
share of the experts held, the index of ``tiny.INDEX``, f32): correct on
a sound run, reporting its metrics; not correct with the timed path
broken underneath or with the control in the program's place; refused
at once by a program without the Kimi Linear backbone; and the cost
functions' arithmetic."""

import copy
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import INDEX
from portbench.yardstick import kimi_linear as yk

NAME = "kimi_linear_abstracts_np16"
MODEL = {"vocab_size": 1000, "hidden_size": 32, "intermediate_size": 64,
         "moe_intermediate_size": 16, "num_hidden_layers": 4, "first_k_dense_replace": 1,
         "linear_attn_config": {"kda_layers": [1, 2, 3], "full_attn_layers": [4],
                                "num_heads": 2, "head_dim": 16, "short_conv_kernel_size": 4},
         "num_attention_heads": 4, "kv_lora_rank": 16, "qk_nope_head_dim": 8,
         "qk_rope_head_dim": 4, "v_head_dim": 8, "num_experts": 4,
         "expert_share": {"router_experts": 8, "first": 2, "count": 4},
         "num_experts_per_token": 3}
ENCODER = {"mrl_dim": 64, "dtype": "float32", "embed_batch": 4, "seq_buckets": [16, 32, 64]}
# limits of an f32 run at this size: sound runs read |token_gap| <= 2.9e-6
# (seeds 5, 7, 11, 2147483911), the faults below 1.7e-3 (one expert
# zeroed) to 0.13 (the state dropped every 16 tokens), the control 2.3e-2
# or more (seeds 3, 7, 11); the index's as the vectors cell's. Two calls
# in the pool, both checked.
TRAFFIC = {"batch": 8, "pool_calls": 2, "check_calls": 2, "check_texts": 6, "check_longest": 2,
           "words": {"median": 20, "sigma": 0.5, "low": 8, "high": 40, "zipf": 1.0},
           "nprobe": 8, "trace_length_s": 0.5,
           "limits": {"token_gap": 1e-4, "score_err": 5e-6, "rank_gap": 8e-7}}


def cell():
    """(workload entry, tiny configuration, tiny traffic)."""
    spec = harness.benchmark()
    work, config, traffic = harness.cell_files(spec, NAME)
    config = dict(copy.deepcopy(config), **MODEL)
    config["index"] = dict(INDEX)
    config["encoder"] = dict(config["encoder"], **ENCODER)
    return work, config, dict(copy.deepcopy(traffic), **TRAFFIC)


def run(*, trace=False, seconds=4.0, cell_obj=None, seed=7):
    work, config, tr = cell()
    spec = harness.benchmark()
    return harness.execute(work, config, tr, seed=seed, seconds=seconds, trace=trace,
                           device="cpu", t0=time.perf_counter(),
                           metric_entries=harness.metrics_of(spec, work, trace), cell=cell_obj)


def test_a_sound_run_is_correct_and_reports_its_metrics():
    out = run(seed=2_147_483_911)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"batch_qps", "setup_s"}
    assert set(out["checks"]) == {"token_gap", "score_err", "rank_gap"}


def test_a_traced_run_reads_its_per_layer_metrics():
    """The two kernels' rooflines need the card (CUDA events around their
    calls); the other three read here."""
    out = run(trace=True, seconds=5.0)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert {"kda_share.kimi", "kimi_step_mfu", "device_idle.kimi"} <= set(got)
    assert 0 < got["kda_share.kimi"]["value"] < 100
    assert 0 < got["kimi_step_mfu"]["value"] < 100


def test_the_cost_functions_count_the_work():
    ops, moved = yk.kda_cost(32, 512, 32, 128)
    tokens = 32 * 512 * 32
    assert ops == 7 * tokens * 128 * 128
    assert moved == tokens * (3 * 2 * 128 + 4 * 128 + 4 + 2 * 128)
    _, config, _ = harness.cell_files(harness.benchmark(), NAME)
    enc = yk.encoder(config)
    w = yk.active_weights(enc)
    assert w["kda"] == 39_460_864 and w["mla"] == 29_114_368
    assert w["expert"] == 7_077_888 and w["moe"] == 2304 * 256 + w["expert"]
    # the held share's weights, as the configuration's memory reckons them
    assert sum(torch.Size(s).numel() for _, s, _ in yk.shapes(enc)) == 25_192_425_344
    # a text of 3 tokens: 3 tokens' weights and recurrence, 6 causal pairs
    # of 32 MLA heads in 7 layers (q.k 192 wide, p.v 128), the head once
    per_token = 2.0 * (20 * w["kda"] + 7 * w["mla"] + w["dense"]
                       + 26 * (w["moe"] + 0.5 * 8 * w["expert"])) + 7.0 * 20 * 32 * 128 ** 2
    pair, head = 2.0 * 32 * 7 * 320, 2.0 * 2304 * 1024
    assert yk.flops(enc, [3], 0.5) == pytest.approx(3 * per_token + 6 * pair + head)


def _broken(fault, monkeypatch):
    """A cell whose timed path is broken by ``fault`` once it is set up."""
    work, config, tr = cell()
    base = harness.driver(tr["driver"]).Cell

    class Broken(base):
        def setup(self):
            super().setup()
            fault(monkeypatch, self)

    return Broken(config, tr, seed=7, device="cpu")


def state_dropped_at_chunks(monkeypatch, cell, chunk: int = 16):
    """The KDA state dropped at every chunk boundary: each chunk's
    recurrence starts again from zero."""
    from abstracts_search_tpu_torch.models import kimi_linear

    scan = kimi_linear.kda_scan

    def dropped(q, k, v, g, beta):
        return torch.cat([scan(*(x[:, i:i + chunk].contiguous() for x in (q, k, v, g, beta)))
                          for i in range(0, q.shape[1], chunk)], 1)

    monkeypatch.setattr(kimi_linear, "kda_scan", dropped)


def decay_ignored_in_one_layer(monkeypatch, cell):
    """The first KDA layer runs with alpha = 1: its A_log at -inf makes
    every log-decay -0."""
    from abstracts_search_tpu_torch.models import kimi_linear

    first = next(m for m in cell.pipe.model.modules() if isinstance(m, kimi_linear.KDA))
    with torch.no_grad():
        first.A_log.fill_(float("-inf"))


def expert_zeroed(monkeypatch, cell):
    """The first held expert's output zeroed where the expert layer
    computes it."""
    from abstracts_search_tpu_torch.models import moonlight

    grouped = moonlight.grouped_swiglu

    def zeroed(x, offsets, w13, w2):
        y = grouped(x, offsets, w13, w2)
        y[int(offsets[0]):int(offsets[1])] = 0.0
        return y

    monkeypatch.setattr(moonlight, "grouped_swiglu", zeroed)


def held_range_shifted(monkeypatch, cell):
    """Every sparse layer takes its held range one expert on: its weights
    serve the pairs of the next expert's."""
    from abstracts_search_tpu_torch.models import moonlight

    forward = moonlight.MoE.forward

    def shifted(self, x):
        first, count = self.held
        self.held = (first + 1, count)
        try:
            return forward(self, x)
        finally:
            self.held = (first, count)

    monkeypatch.setattr(moonlight.MoE, "forward", shifted)


FAULTS = [state_dropped_at_chunks, decay_ignored_in_one_layer, expert_zeroed,
          held_range_shifted]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    out = run(cell_obj=_broken(fault, monkeypatch))
    assert not out["correct"], out["checks"]
    # not correct by the embeddings, not because no checked call ran
    assert out["checks"]["token_gap"]["value"] < float("inf"), out["checks"]


def test_the_control_is_not_correct():
    work, config, tr = cell()
    got = harness.driver(tr["driver"]).Cell(config, tr, seed=3, device="cpu").control(1.0)
    assert any(v > tr["limits"][k] for k, v in got.items()), got


def test_a_program_without_the_backbone_fails_as_the_cell_is_made(monkeypatch):
    from abstracts_search_tpu_torch import models

    work, config, tr = cell()
    monkeypatch.delattr(models, "kimi_linear")
    monkeypatch.setitem(sys.modules, "abstracts_search_tpu_torch.models.kimi_linear", None)
    with pytest.raises(ImportError):
        harness.driver(tr["driver"]).Cell(config, tr, seed=7, device="cpu")
