#!/usr/bin/env python3
"""Time variants of kernel 1's new scans, each a build of a copy of
csrc/topk.cu with a few text edits, on one card.

    python3 tools/topk_variants.py [--only NAME,...] [--out FILE]

Each variant below is a list of (text in csrc/topk.cu, replacement). Every
variant's copy is compiled at once (one nvcc each, the package's flags)
into build/topk_variants/, loaded with ctypes and launched through its own
topk_launch at one shape:

- ``build``: kernel 1 at the index build's k 1 (Q 131,072 x 65,536 x
  1,024 bf16, the k-1 scan);
- ``kmeans``: plain-L2 k-means' window (Q 262,144 x 4,096 x 1,152 f32, k 1,
  the register-blocked scan on the 128-query tile);
- ``probe``: the IVF-Flat probe (Q 256 x 4,096 x 1,152 f32, k 16, the
  64-query tile).

Inputs are Gaussian, made on the card from a fixed seed. Each variant is
timed by CUDA events (two medians) and its rows compared with the
package's own kernel; variants that skip work (no loads, no epilogue)
give wrong rows by design and only bound what that work costs. Prints a
JSON line per variant and the nvidia-smi line; --out writes them all.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (imports numpy and torch only)

OUT = ROOT / "build" / "topk_variants"

# anchors in csrc/topk.cu
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
WARPS = "constexpr int SIMT64_WN = 8, SIMT128_WN = 4;"

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
}
# shape -> (queries, rows, dims, k, dtype)
SHAPES = {"build": (131_072, 65_536, 1024, 1, torch.bfloat16),
          "kmeans": (262_144, 4096, 1152, 1, torch.float32),
          "probe": (256, 4096, 1152, 16, torch.float32)}


def build(names) -> dict:
    """Compile each variant's copy, all at once -> {name: CDLL}."""
    from abstracts_search_tpu_torch.ops import _build

    src = (_build.CSRC / "topk.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name][1]:
            if old not in text:
                raise ValueError(f"{name}: anchor not in csrc/topk.cu: {old[:60]!r}")
            text = text.replace(old, new)
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
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.topk_launch.argtypes = [vp, vp] + [i] * 13 + [vp] * 4
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", help="comma-separated variant names")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("topk_variants: no CUDA device", file=sys.stderr)
        return 2
    from abstracts_search_tpu_torch.ops import topk

    names = args.only.split(",") if args.only else list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    libs = build(names)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(0)
    res, inputs = {}, {}
    for name in sorted(names, key=lambda n: VARIANTS[n][0]):
        shape = VARIANTS[name][0]
        if shape not in inputs:
            inputs.clear()
            torch.cuda.empty_cache()
            qn, n, d, _, dtype = SHAPES[shape]
            inputs[shape] = (torch.randn((qn, d), device="cuda", generator=g).to(dtype),
                             torch.randn((n, d), device="cuda", generator=g).to(dtype))
        q, x = inputs[shape]
        qn, n, d, k, dtype = SHAPES[shape]
        p = topk._plan(qn, n, k, dtype, sms)
        cand = torch.empty((qn, p.n_ranges, k), dtype=torch.int64, device="cuda")
        ov = torch.empty((qn, k), device="cuda")
        oi = torch.empty((qn, k), dtype=torch.int32, device="cuda")

        def run():
            err = libs[name].topk_launch(
                q.data_ptr(), x.data_ptr(), p.cfg, 1, qn, n, d, k, p.qb, p.n_ranges,
                p.range_rows, 0, 0, 0, 0, cand.data_ptr(), ov.data_ptr(), oi.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: launch failed with cudaError {err}")

        run()
        torch.cuda.synchronize()
        rows_equal = bool(torch.equal(oi, topk.streaming_topk(q, x, n, k, impl="cuda")[1]))
        reps = 20 if shape == "probe" else 3
        res[name] = {"shape": shape, "cfg": p.cfg,
                     "ms": [cs.cuda_ms(run, reps=reps, warmup=1) for _ in range(2)],
                     "rows_equal_the_package_kernel": rows_equal}
        print(json.dumps({name: res[name]}), flush=True)
    if args.out:
        args.out.write_text(json.dumps({"card": smi, "variants": res}))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
