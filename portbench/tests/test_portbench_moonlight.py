"""The Moonlight cell driven end to end at a tiny size on the CPU, with
its own tiny configuration (the catalog's keys cut to tiny widths, the
index of ``tiny.INDEX``, f32): correct on a sound run, reporting its
metrics; not correct with the timed path broken underneath or with the
control in the program's place; and refused at once by a program
without the Moonlight backbone."""

import copy
import sys
import time

import pytest

from portbench import harness
from portbench.tests.tiny import INDEX

NAME = "moonlight_abstracts_np16"
MODEL = {"vocab_size": 1000, "hidden_size": 32, "intermediate_size": 64,
         "moe_intermediate_size": 16, "num_hidden_layers": 3, "first_k_dense_replace": 1,
         "num_attention_heads": 4, "kv_lora_rank": 16, "qk_nope_head_dim": 8,
         "qk_rope_head_dim": 4, "v_head_dim": 8, "n_routed_experts": 8, "num_experts_per_tok": 3,
         "rope_theta": 10_000}
ENCODER = {"mrl_dim": 64, "dtype": "float32", "embed_batch": 4, "seq_buckets": [16, 32, 64]}
# limits of an f32 run at this size: sound runs read |token_gap| <= 2.9e-6
# (seeds 5, 7, 11, 2147483911), one zeroed expert 1.2e-3, top-k off by
# one 1.1e-2 and the control 3.5e-2 or more (seeds 3, 7, 11); the
# index's as the vectors cell's
# two calls in the pool, both checked: a window of a few seconds reaches
# them even on a loaded CPU (a call takes up to ~2 s there)
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
    """The expert kernel's roofline needs the card (CUDA events around
    its calls); the other four read here."""
    out = run(trace=True, seconds=5.0)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert {"moe_share.moonlight", "routed_pad_share.moonlight", "moonlight_step_mfu",
            "device_idle.moonlight"} <= set(got)
    assert 0 < got["moe_share.moonlight"]["value"] < 100
    assert 0 < got["routed_pad_share.moonlight"]["value"] < 100


def _broken(fault, monkeypatch):
    """A cell whose timed path is broken by ``fault`` once it is set up."""
    work, config, tr = cell()
    base = harness.driver(tr["driver"]).Cell

    class Broken(base):
        def setup(self):
            super().setup()
            fault(monkeypatch)

    return Broken(config, tr, seed=7, device="cpu")


def _expert_zeroed(monkeypatch):
    """Expert 0's output zeroed where the expert layer computes it."""
    from abstracts_search_tpu_torch.models import moonlight

    grouped = moonlight.grouped_swiglu

    def zeroed(x, offsets, w13, w2):
        y = grouped(x, offsets, w13, w2)
        y[int(offsets[0]):int(offsets[1])] = 0.0
        return y

    monkeypatch.setattr(moonlight, "grouped_swiglu", zeroed)


def _top_k_off_by_one(monkeypatch):
    import dataclasses

    from abstracts_search_tpu_torch.models import moonlight

    route = moonlight.route
    monkeypatch.setattr(moonlight, "route", lambda x, w, b, cfg: route(
        x, w, b, dataclasses.replace(cfg, num_experts_per_tok=cfg.num_experts_per_tok - 1)))


@pytest.mark.parametrize("fault", [_expert_zeroed, _top_k_off_by_one], ids=lambda f: f.__name__)
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
    monkeypatch.delattr(models, "moonlight")
    monkeypatch.setitem(sys.modules, "abstracts_search_tpu_torch.models.moonlight", None)
    with pytest.raises(ImportError):
        harness.driver(tr["driver"]).Cell(config, tr, seed=7, device="cpu")
