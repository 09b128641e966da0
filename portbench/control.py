"""The control of a cell, on several seeds: the reference in the
program's place one precision down (or the program's own lower-precision
path), judged as a run is. It must come out not correct.

    python3 -m portbench.control --workload <name> --seeds 1,2,3 [--seconds 10]

Prints one JSON line per seed: the numbers compared, each beside its
limit in the traffic file.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = harness.benchmark(parked=True)
    work, config, traffic = harness.cell_files(spec, args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        cell = harness.driver(traffic["driver"]).Cell(config, traffic, seed=seed,
                                                      device=args.device)
        got = cell.control(args.seconds)
        lim = traffic["limits"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": {k: {"value": v, "limit": lim[k]} for k, v in got.items()},
                          "fails": any(v > lim[k] for k, v in got.items())}), flush=True)
        del cell
    return 0


if __name__ == "__main__":
    sys.exit(main())
