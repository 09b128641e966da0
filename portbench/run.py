"""Run one cell once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Exits 2, printing no result, without as many CUDA cards as the cell
asks for, and 3 if a JAX module is loaded once the window has closed.
The last line of standard output is the result (JSON); the numbers
compared for ``correct`` end standard error, each beside its limit.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parent.parent
# every cache of the program and its libraries at a fixed place inside
# the checkout, so only a cell's first run there builds
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(_ROOT / "build" / _sub)
# libraries that would load JAX or flax by themselves
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

if __package__ in (None, ""):
    sys.path.insert(0, str(_ROOT))
    __package__ = "portbench"  # noqa: A001

from . import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = harness.benchmark()
    work, config, traffic = harness.cell_files(spec, args.workload)
    import torch

    chips = int(work.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # the port's kernels, built here first (nvcc only on a checkout's
    # first run) and timed apart; set-up counts them too
    from abstracts_search_tpu_torch.ops import _build

    t_build = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t_build
    out = harness.execute(work, config, traffic, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device="cuda", t0=T0,
                          metric_entries=harness.metrics_of(spec, work, bool(args.trace)))
    bad = harness.banned_modules()
    if bad:
        print(f"portbench: modules of {bad} are loaded after the window", file=sys.stderr)
        return 3
    prof = out.pop("_profile", None)
    if prof is not None:
        print(f"trace: {json.dumps({k: prof[k] for k in ('window_s', 'busy_s', 'device_events', 'events_seen', 'slice_us')})}",
              file=sys.stderr)
    checks = out.pop("checks")
    out["build_s"] = build_s
    out["checks"] = checks  # last in the line
    print(f"build_s = {build_s!r}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
