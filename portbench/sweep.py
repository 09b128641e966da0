"""The knee of the typed cell: one set-up, then one window at each rate.

    python3 -m portbench.sweep --workload ivfpq_typed_steady --seed <n> --seconds <s> \\
        --rates 100,200,300

Prints one JSON line per rate: requests attempted and failed, the
latency median, 95th and 99th percentiles (from each due time), the
completed rate, the generator's lateness, and the backlog (the 95th
percentile of the window's last fifth against its first fifth).
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import statistics
import sys
import time

from . import harness
from .yardstick.timeline import percentile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.sweep")
    ap.add_argument("--workload", default="ivfpq_typed_steady")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    spec = harness.benchmark(parked=True)
    work, config, traffic = harness.cell_files(spec, args.workload)
    cell = harness.driver(traffic["driver"]).Cell(config, traffic, seed=args.seed,
                                                  device="cuda")
    cell.setup()
    print(json.dumps({"setup_s": time.perf_counter() - t0}), flush=True)
    for rate in [float(r) for r in args.rates.split(",")]:
        cell.traffic = dict(copy.deepcopy(traffic), rate_qps=rate)
        run = harness.Run(config, cell.traffic, False)
        cell.window(args.seconds, run)
        lat = run.latencies_ms
        n = len(lat)
        fifth = max(1, n // 5)
        recs = cell.records
        done = [r for r in recs if r[3] == 200]
        last_done = max((r[2] for r in done), default=math.nan)
        print(json.dumps({
            "rate_qps": rate, "attempted": n, "failed": run.failed,
            "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
            "p99_ms": percentile(lat, 99),
            "completed_qps": len(done) / last_done if done else 0.0,
            "late_p95_ms": percentile([(r[1] - r[0]) * 1e3 for r in recs if r[1] is not None], 95),
            "p95_first_fifth_ms": percentile(lat[:fifth], 95),
            "p95_last_fifth_ms": percentile(lat[-fifth:], 95),
            "batch_rows": run.counters["batch_requests"] / max(1, run.counters["batches"]),
            "p50_first_s": statistics.median(lat[:fifth]) / 1e3 if lat else None}),
            flush=True)
    # where a request's time goes at a low rate: the engine's encode and
    # search spans (synchronising) and the device's busy share
    cell.traffic = dict(copy.deepcopy(traffic), rate_qps=float(args.rates.split(",")[0]))
    run = harness.Run(config, cell.traffic, True)
    cell.window(args.seconds, run)
    ms = lambda name: sorted((b - a) * 1e3 for a, b in run.spans(name))  # noqa: E731
    enc, srch = ms("encode"), ms("search")
    print(json.dumps({"spans_at_qps": cell.traffic["rate_qps"], "batches": len(enc),
                      "encode_ms_p50": percentile(enc, 50), "encode_ms_p95": percentile(enc, 95),
                      "search_ms_p50": percentile(srch, 50),
                      "p50_ms": percentile(run.latencies_ms, 50),
                      "device_busy": (run.profile or {}).get("busy_s"),
                      "slice_s": (run.profile or {}).get("window_s")}), flush=True)
    # the engine alone, one caller: a batch of n typed queries
    import numpy as np

    from .yardstick import corpus

    for n in (1, 4, 16, 32, 64):
        texts = corpus.typed_texts(np.full(n, 14), args.seed + 5, corpus.vocabulary())
        times = []
        for _ in range(5):
            t = time.perf_counter()
            cell.engine.search_batch(texts, k=10)
            times.append((time.perf_counter() - t) * 1e3)
        print(json.dumps({"engine_alone_rows": n, "ms_median": statistics.median(times)}),
              flush=True)
    cell.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
