#!/usr/bin/env python3
"""Time variants of kernel 1 (the streaming top-k), each a build of a copy
of a tree's csrc/topk.cu with a few text edits, on one card.

    python3 tools/topk_variants.py [--tree DIR] [--only NAME,...] [--out FILE]

DIR (default: this checkout) is the tree whose package and
``csrc/topk.cu`` are used, e.g. another commit unpacked with ``git
archive``. Each variant below is a list of (text in DIR's csrc/topk.cu,
replacement); a variant whose anchors DIR's source lacks is reported as
such and skipped. Every variant's copy is compiled at once (one nvcc each,
DIR's flags) into build/topk_variants/ and called through DIR's own
``streaming_topk`` (its plan, its launcher's signature), with the
library the wrapper loads swapped for the variant's. Shapes:

- ``build``: the index build's k 1 (Q 131,072 x 65,536 x 1,024 bf16);
- ``kmeans``: plain-L2 k-means' window (Q 262,144 x 4,096 x 1,152 f32, k 1);
- ``probe``: the IVF-Flat probe (Q 256 x 4,096 x 1,152 f32, k 16);
- ``probe16``, ``probe64``: the IVF-PQ serve probe, Q 256 x 65,536 x
  1,024 bf16 at k 16 and k 64 (nprobe 16 and 64).

Inputs are Gaussian, made on the card from a fixed seed. Each variant is
timed by CUDA events (two medians around one wrapper call) and by
torch.profiler, its device time split by kernel function; its rows are
compared with DIR's own kernel. Variants that skip work (no loads, no
epilogue, no selection) give wrong rows by design and only bound what that
work costs. Prints a JSON line per variant and the nvidia-smi line; --out
writes them all.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (imports numpy and torch only)

OUT = ROOT / "build" / "topk_variants"

# anchors in csrc/topk.cu: the k-1 scan (tc::kone)
ARRIVE = '"mbarrier.arrive.shared::cluster.b64 _, [ra];\\n"'
LOAD_A = "        wg::tma_load(st, &tmq, d0, q0, bar);\n"
EXPECT = ("        wg::mbar_expect(bar, STAGE_BYTES);   "
          "// own queries + both halves of the tile\n")
LOAD_B = """        tma_load_mc(st + A_BYTES + rank * HALF * DK * 2, &tmx, d0, r0 + (int)rank * HALF, bar,
                    (uint16_t)((1u << CLUSTER) - 1));
"""
EPILOGUE = "    running_max<1, 32>(acc, rv, ri, r_begin + (it / ksteps) * BN + 2 * tg, r_end);\n"
RAISE = '  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\\n" ::: "memory");\n'
CHAIN = """      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (!edge || rbase + 8 * j + c < r_end) m = fmaxf(m, acc[i][j][2 * h + c]);"""
TREE = """      float m = -INFINITY;
      if (!edge) {
        float t[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j) t[j] = fmaxf(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
#pragma unroll
        for (int w = NT / 2; w >= 1; w /= 2)
#pragma unroll
          for (int j = 0; j < w; ++j) t[j] = fmaxf(t[j], t[j + w]);
        m = t[0];
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (rbase + 8 * j + c < r_end) m = fmaxf(m, acc[i][j][2 * h + c]);
      }"""
# the register-blocked f32 scan
WARPS = "constexpr int SIMT64_WN = 8, SIMT128_WN = 4;"
# the wgmma scan's selection call as it stood before its redesign (sorted
# per-query lists in shared memory; commit 37c55fe): none at all, or on a
# range's first tile only
WG_SELECT = "    select_tile<Sel, 1, 16, C::WARPS, C::CB>(acc, wm * 64 + (warp & 3) * 16, wn * 128,\n"
# the redesigned wgmma scan's selection call (thresholds, candidates in
# device memory): none at all, or on a range's first tile only
WG_APPEND = "    append_tile<Sel, C>(acc,"
# ... its shared bins: neither read nor raised
BINS_READ = "  if (nbins > 0) {   // the bound from the bins"
BINS_RAISE = "    if (nbins > 0 && w3 > old3 && ql < qlim && w3 > gb[ql])"
FOLD_CHECK = "  if (!__syncthreads_or(t < qlim && cnt[t] > level)) return;\n"
# ... no fold; no appends; nothing past the bins' read
FOLD_CALL = "    fold_full<C>("
APPEND_LOOP = "    int np = __popc(pass);"
AFTER_READ = "    if (part == 0 && ql < qlim) gb[ql] = max(gb[ql], v);\n  }\n  __syncthreads();\n"
NO_BINS = [[BINS_READ, "  if (false) {   // the bound from the bins"],
           [BINS_RAISE, BINS_RAISE.replace("nbins > 0", "false")]]

# name -> (shape, edits)
VARIANTS = {
    "k1": ("build", []),
    "k1_cluster_release": ("build", [[ARRIVE, ARRIVE.replace(
        "arrive.shared", "arrive.release.cluster.shared")]]),
    "k1_no_epilogue": ("build", [[EPILOGUE, ""]]),
    "k1_tree_epilogue": ("build", [[CHAIN, TREE]]),
    "k1_no_loads": ("build", [[LOAD_A, ""], [LOAD_B, ""],
                              [EXPECT, "        wg::mbar_expect(bar, 0);\n"]]),
    "k1_no_query_loads": ("build", [[LOAD_A, ""], [EXPECT, EXPECT.replace(
        "STAGE_BYTES)", "STAGE_BYTES - A_BYTES)")]]),
    "k1_no_register_raise": ("build", [[RAISE, ""]]),
    "f32_kmeans": ("kmeans", []),
    "f32_probe": ("probe", []),
    "f32_probe_4_row_warps": ("probe", [[WARPS, WARPS.replace("= 8", "= 4")]]),
    "probe_k16": ("probe16", []),
    "probe_k64": ("probe64", []),
    "lists_k16_no_select": ("probe16", [[WG_SELECT, "    if (false)" + WG_SELECT[3:]]]),
    "lists_k64_no_select": ("probe64", [[WG_SELECT, "    if (false)" + WG_SELECT[3:]]]),
    "lists_k16_first_tile_select": ("probe16", [[WG_SELECT,
                                                 "    if (step < ksteps)" + WG_SELECT[3:]]]),
    "lists_k64_first_tile_select": ("probe64", [[WG_SELECT,
                                                 "    if (step < ksteps)" + WG_SELECT[3:]]]),
    "append_k16_no_select": ("probe16", [[WG_APPEND, "    if (false)" + WG_APPEND[3:]]]),
    "append_k64_no_select": ("probe64", [[WG_APPEND, "    if (false)" + WG_APPEND[3:]]]),
    "append_k16_first_tile_select": ("probe16", [[WG_APPEND,
                                                  "    if (tile == 0)" + WG_APPEND[3:]]]),
    "append_k64_first_tile_select": ("probe64", [[WG_APPEND,
                                                  "    if (tile == 0)" + WG_APPEND[3:]]]),
    "append_k16_no_bins": ("probe16", NO_BINS),
    "append_k16_no_fold": ("probe16", [[FOLD_CALL, "    if (false) " + FOLD_CALL[4:]]]),
    "append_k16_bound_only": ("probe16", [[APPEND_LOOP, "    pass = 0;\n" + APPEND_LOOP]]),
    "append_k16_read_only": ("probe16", [[AFTER_READ, AFTER_READ + "  if (k > 0) return;\n"]]),
    "append_k64_no_fold": ("probe64", [[FOLD_CALL, "    if (false) " + FOLD_CALL[4:]]]),
    "bound_k16_no_read": ("probe16", [[APPEND_LOOP, "    pass = 0;\n" + APPEND_LOOP],
                                      [BINS_READ, "  if (false) {   // the bound from the bins"]]),
    "bound_k16_no_raise": ("probe16", [[APPEND_LOOP, "    pass = 0;\n" + APPEND_LOOP],
                                       [BINS_RAISE, BINS_RAISE.replace("nbins > 0", "false")]]),
    "bound_k16_no_fold_check": ("probe16", [[APPEND_LOOP, "    pass = 0;\n" + APPEND_LOOP],
                                            [FOLD_CHECK, "  return;\n"]]),
    "append_k64_bound_only": ("probe64", [[APPEND_LOOP, "    pass = 0;\n" + APPEND_LOOP]]),
    "append_k64_no_bins": ("probe64", NO_BINS),
}
# shape -> (queries, rows, dims, k, dtype)
SHAPES = {"build": (131_072, 65_536, 1024, 1, torch.bfloat16),
          "kmeans": (262_144, 4096, 1152, 1, torch.float32),
          "probe": (256, 4096, 1152, 16, torch.float32),
          "probe16": (256, 65_536, 1024, 16, torch.bfloat16),
          "probe64": (256, 65_536, 1024, 64, torch.bfloat16)}
# kernel functions of either tree, as the profiler names them
FUNCTIONS = ("range_kernel", "topk_merge_kernel", "topk_select_kernel")


def build(names, tree: Path) -> tuple:
    """Compile each variant's copy of ``tree``'s topk.cu, all at once ->
    ({name: CDLL}, {name: reason skipped})."""
    from abstracts_search_tpu_torch.ops import _build

    src = (_build.CSRC / "topk.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs, skipped = {}, {}
    for name in names:
        text = src
        for old, new in VARIANTS[name][1]:
            if old not in text:
                skipped[name] = f"anchor not in {tree}'s csrc/topk.cu: {old[:60]!r}"
                break
            text = text.replace(old, new)
        if name in skipped:
            continue
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name} failed to build:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
    return libs, skipped


def device_split(fn, reps: int) -> dict:
    """Device milliseconds per call of each kernel function ``fn``
    launches (``FUNCTIONS``), by torch.profiler over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for n in FUNCTIONS:
            if n in e.name:
                spans.setdefault(n, []).append((e.time_range.end - e.time_range.start) / 1e3)
    return {n: statistics.mean(v) for n, v in spans.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--only", help="comma-separated variant names")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("topk_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.tree.resolve()))
    for mod in [m for m in sys.modules if m.startswith("abstracts_search_tpu_torch")]:
        del sys.modules[mod]
    from abstracts_search_tpu_torch.ops import _build, topk

    if not Path(topk.__file__).resolve().is_relative_to(args.tree.resolve()):
        raise RuntimeError(f"imported {topk.__file__}, not {args.tree}'s package")
    names = args.only.split(",") if args.only else list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    libs, skipped = build(names, args.tree)
    res = {name: {"skipped": why} for name, why in skipped.items()}
    for name, why in skipped.items():
        print(json.dumps({name: res[name]}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    inputs = {}
    library = _build.library
    for name in sorted(libs, key=lambda n: VARIANTS[n][0]):
        shape = VARIANTS[name][0]
        if shape not in inputs:
            inputs.clear()
            torch.cuda.empty_cache()
            qn, n, d, _, dtype = SHAPES[shape]
            inputs[shape] = (torch.randn((qn, d), device="cuda", generator=g).to(dtype),
                             torch.randn((n, d), device="cuda", generator=g).to(dtype))
        q, x = inputs[shape]
        qn, n, d, k, dtype = SHAPES[shape]
        own = topk.streaming_topk(q, x, n, k, impl="cuda")[1]
        variant = libs[name]
        # the tree's wrapper types and plans with the variant's library
        _build.library = lambda lib_name, v=variant: v if lib_name == "topk" else library(lib_name)
        topk._launch_plan.cache_clear()
        try:
            run = lambda: topk.streaming_topk(q, x, n, k, impl="cuda")  # noqa: E731
            rows_equal = bool(torch.equal(run()[1], own))
            reps = 3 if shape in ("build", "kmeans") else 20
            res[name] = {"shape": shape, "plan": topk._launch_plan(qn, n, k, dtype, 0)._asdict(),
                         "ms": [cs.cuda_ms(run, reps=reps, warmup=1) for _ in range(2)],
                         "device_ms": device_split(run, reps),
                         "rows_equal_the_tree_kernel": rows_equal}
        finally:
            _build.library = library
            topk._launch_plan.cache_clear()
        print(json.dumps({name: res[name]}), flush=True)
    if args.out:
        args.out.write_text(json.dumps({"card": smi, "tree": str(args.tree), "variants": res}))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
