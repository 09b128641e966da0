#!/usr/bin/env python3
"""Measure what ``StageTimer``'s per-stage INFO line costs the batch-256
stage split of ``chip_smoke.py``, on one card.

    python3 tools/stage_split_log.py [--seed 0] [--n-rows 206962688] [--rounds 4] \
        2> split.err

Writes the smoke's seeded serve index (``chip_smoke.open_index``, ~14 GB
of disk under ``build/``, deleted at exit), serves it, then runs
``chip_smoke.stage_split`` in turns with the trace logger at INFO and at
WARNING. Prints one JSON line per turn: the share of the batch's
host-clock time that no stage covers, the stages' sum and the batch's
time (or the split's failure), and first the cost of one INFO line on
this process's stderr. Run it with stderr on a file, as the smoke runs.
"""

import argparse
import json
import logging
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-rows", type=int, default=206_962_688)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not cs.torch.cuda.is_available():
        print("stage_split_log: no CUDA device", file=sys.stderr)
        return 2
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    log = logging.getLogger("abstracts_search_tpu_torch.utils.trace")
    t = time.perf_counter()
    for _ in range(500):
        log.info("stage %s: %.3fs%s", "x", 0.001, "")
    print(json.dumps({"logger_info_us": (time.perf_counter() - t) / 500 * 1e6}), flush=True)

    from abstracts_search_tpu_torch.ops import _build

    _build.build_all()
    art = ROOT / "build" / "stage_split_index"
    try:
        idx = cs.open_index(art, args.n_rows, args.seed, "index")
        ctx, _ = cs.serve(idx, args.seed, {}, http=False, path="serve",
                          must_launch=("topk", "adc_topk"))
        for level in ("INFO", "WARNING") * args.rounds:
            try:
                r = cs.stage_split(ctx, trace_level=getattr(logging, level))
                out = {"unaccounted_share": r["unaccounted_share"],
                       "stages_sum_ms": r["stages_sum_ms"], "batch_ms": r["batch_ms"]}
            except AssertionError as e:
                out = {"failed": str(e)}
            print(json.dumps({"trace_log_level": level, **out}), flush=True)
    finally:
        shutil.rmtree(art, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
