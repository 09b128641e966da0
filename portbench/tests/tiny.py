"""Tiny configurations and traffic of every cell, for runs on the CPU."""

from __future__ import annotations

import copy

from portbench import harness

INDEX = {"n_rows": 20_000, "n_lists": 64, "dim": 64, "pq_m": 16, "pq_nbits": 4, "opq": True,
         "spherical": True, "seg_size": 32, "storage": "device", "geometry_seed": 0}
ENCODER = {"vocab_size": 1000, "hidden_size": 32, "intermediate_size": 64,
           "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
           "head_dim": 8, "rope_theta": 10_000.0, "rms_norm_eps": 1e-6, "mrl_dim": 64,
           "dtype": "float32", "embed_batch": 8, "seq_buckets": [16, 32, 64]}
TRAFFIC = {
    "ivfpq_typed_steady": {"rate_qps": 20.0, "client_threads": 32, "drain_s": 30.0,
                           "check_requests": 12, "check_longest": 3, "trace_length_s": 0.3},
    "flat_shard_k10": {"batch": 16, "pool_batches": 8, "check_batches": 2, "check_queries": 16,
                       "trace_length_s": 0.2},
    "ivfpq_vectors_np128": {"batch": 16, "nprobe": 8, "pool_batches": 8, "check_batches": 2,
                            "check_queries": 16, "trace_length_s": 0.2},
    "ivfpq_fill_delta": {"rows": 8192, "row_group": 1024, "warm_groups": 1},
}


def cell(name: str):
    """(workload entry, tiny configuration, tiny traffic) of a cell."""
    spec = harness.benchmark(parked=True)
    work, config, traffic = harness.cell_files(spec, name)
    config = copy.deepcopy(config)
    if "index" in config:
        config["index"] = dict(INDEX)
        config["encoder"] = dict(config["encoder"], **ENCODER)
        config["serve"] = dict(config["serve"], workers=2)
    if "flat" in config:
        config["flat"] = {"n_rows": 8192, "dim": 64, "dtype": "float32", "chunk": 1024}
    traffic = dict(copy.deepcopy(traffic), **TRAFFIC[name])
    return work, config, traffic


def run(name: str, *, seed: int = 7, seconds: float = 1.0, trace: bool = False, cell_obj=None):
    """One run of a tiny cell on the CPU -> the result dict."""
    import time

    work, config, tr = cell(name)
    spec = harness.benchmark(parked=True)
    return harness.execute(work, config, tr, seed=seed, seconds=seconds, trace=trace,
                           device="cpu", t0=time.perf_counter(),
                           metric_entries=harness.metrics_of(spec, work, trace), cell=cell_obj)
