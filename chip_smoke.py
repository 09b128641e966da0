#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's search paths once on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--n-rows 206962688] [--phases ...]

Phases, each printing one JSON line; any failure exits non-zero:

  device  the card (nvidia-smi name and power limit), torch/CUDA
          versions, TF32 asserted off. Exits non-zero without CUDA.
  build   every kernel from abstracts_search_tpu_torch/csrc with nvcc
          (sm_90a), all sources compiled in parallel; fails unless the
          top-k library's SASS (cuobjdump) holds tensor-core instructions
          and every kernel function of both ADC libraries stages by bulk
          async copies (UBLKCP in its own SASS).
  kernels each kernel against its plain PyTorch version on the card at
          the paths' shapes: exact top-k (index mismatches beyond ties
          within f32 accumulation error fail), fast top-k (beyond one
          truncation step), ADC scans (bit for bit), with CUDA-event times;
          then the top-k's tile edges in both modes (odd d, k 300 at Q
          256, Q 1/7/129/300, a ragged n_valid, repeated rows), and the
          ADC kernels (3-5 at PQ128x4, 4 and 6 at PQ64x8) on tie-heavy
          LUTs and on q_ids query-major, alternating and shuffled (bit for
          bit).
  flat    bench.py's configuration: 2,097,152 x 1024 bf16 unit vectors,
          128 queries, k 10, chunk 4096. The fast-mode top-k kernel
          against its plain version, QPS by CUDA events over chained
          calls, the library yardstick torch.topk(q @ x.T, k), and
          FlatIndex (exact kernel) against its plain route.
  index   seeded IVF-PQ artifacts at the production geometry (D 1024,
          65,536 lists, OPQ rotation, PQ128x4 nibble-packed transposed,
          SEG 256, 206,962,688 rows, lognormal-skewed list sizes), written
          through the port's save path and opened with IVFPQIndex.load.
  serve   SearchEngine over the loaded index: the kernel path against
          the plain path on the same index (hash-embedded texts and
          reconstructions of corpus rows), batch-256 QPS, single-query
          p50, and an HTTP round trip through run_server.
  stages_batch256
          on the served index (device storage): one batch-256 search
          split by StageTimer into encode, probe, slot list, scan and
          merge, device->host copy, row resolve and id strings, each
          ended by a synchronize; the stages must sum to within 10% of
          the batch's host-clock time.
  hybrid  the same artifact reopened with storage="hybrid" at a 6 GiB hot
          budget (the largest lists on the card, a cold tail gathered
          from the memmap per batch): the kernel path against the plain
          path, and against the device storage's kept results (scores bit
          for bit, positions identical except among equal scores); QPS,
          p50, the cold share of live slots and the gather's time.
  host    the same artifact with storage="host" (every probed segment
          gathered per batch), the same checks, batch-16 and batch-256
          times and the bytes gathered; then, in the legacy phase, the
          row-major PQ64x8 artifact in host storage (path host_pq8).
  legacy  after the transposed index is freed and deleted: the same
          geometry written row-major (legacy format<=2 layout, raw scan
          kernel for packed rows) and served with the same checks, then a
          row-major PQ64x8 artifact (4,096 lists, 2,097,152 rows, raw scan
          kernel for byte codes) held against its plain path.

Each path (serve, flat, hybrid, host, legacy, legacy_pq8, host_pq8)
runs with every launch count set to 0
just before it and read just after, and fails if one of its kernels
never launched. Then a ``{"kernels": [...]}`` line with one row per TPU
kernel (launches from the paths; times and bounds at the inputs the
paths gave each kernel: ``ms`` by CUDA events around one wrapper call,
host work between the events included, ``device_ms`` the kernel's own
time under torch.profiler over the same calls), the card's nvidia-smi
line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import gc
import json
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}

N_LISTS, DIM, PQ_M, PQ_NBITS, SEG = 65_536, 1024, 128, 4, 256
# the small row-major byte-code artifact (kernel 6)
PQ8 = {"n_lists": 4096, "pq_m": 64, "pq_nbits": 8, "n_rows": 2_097_152}
# bench.py's configuration (BASELINE.md config 1)
FLAT_N, FLAT_Q, FLAT_K, FLAT_CHUNK = 2_097_152, 128, 10, 4096
# hybrid storage's hot budget at the serve geometry: the largest lists,
# about 46% of the 12.9 GiB of codes, on the card; a real cold tail
HYBRID_HOT_BYTES = 6 << 30
FLAT_METRIC = (f"flat IP search QPS (fast selection; {FLAT_N}x{DIM} corpus, "
               f"batch {FLAT_Q}, k={FLAT_K})")

CSRC = "abstracts_search_tpu_torch/csrc/"
# one row per TPU kernel: key -> (name, source, the TPU kernel it replaces)
KERNELS = {
    "topk": ("streaming_topk (exact)", CSRC + "topk.cu",
             "abstracts_search_tpu/ops/topk.py:184"),
    "topk_fast": ("streaming_topk (fast)", CSRC + "topk.cu",
                  "abstracts_search_tpu/ops/topk.py:235"),
    "adc_topk": ("adc_topk", CSRC + "adc_topk.cu", "abstracts_search_tpu/ops/adc.py:333"),
    "adc_kernel_t": ("adc_scan (transposed)", CSRC + "adc_scan.cu",
                     "abstracts_search_tpu/ops/adc.py:52"),
    "adc_kernel_packed4": ("adc_scan (row-major, packed)", CSRC + "adc_scan.cu",
                           "abstracts_search_tpu/ops/adc.py:92"),
    "adc_kernel": ("adc_scan (row-major, bytes)", CSRC + "adc_scan.cu",
                   "abstracts_search_tpu/ops/adc.py:119"),
}
# the kernel functions each row's wrapper launches, as the profiler names them
DEVICE_NAMES = {"topk": ("range_kernel", "topk_merge_kernel"),
                "topk_fast": ("range_kernel", "topk_merge_kernel"),
                "adc_topk": ("adc_topk_kernel",), "adc_kernel_t": ("adc_cols_kernel",),
                "adc_kernel_packed4": ("adc_rows_kernel",), "adc_kernel": ("adc_rows_kernel",)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the card by CUDA events."""

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def device_ms(fn, names, reps: int = 10) -> float:
    """Milliseconds per call of ``fn`` on the card by torch.profiler: the
    device time of the kernels whose names hold one of ``names``, over
    ``reps`` calls. A profiler run can miss its first launches, so each
    kernel's mean span counts (a call launches each of its kernels
    once)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and any(n in e.name for n in names):
            spans.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
    if not spans:
        raise AssertionError(f"the profiler saw no kernel named {names}")
    return sum(statistics.mean(v) for v in spans.values()) / 1e3


def bound(bytes_moved: float, ops: float, kind: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- launch counts -------------------------------------------------------------


def counts() -> dict:
    from abstracts_search_tpu_torch.ops import adc, topk

    return {"topk": topk.launches, "topk_fast": topk.fast_launches,
            "adc_topk": adc.launches, **adc.scan_launches}


def reset_counts() -> None:
    from abstracts_search_tpu_torch.ops import adc, topk

    topk.launches = topk.fast_launches = adc.launches = 0
    for key in adc.scan_launches:
        adc.scan_launches[key] = 0


def drive(path: str, fn, must_launch, by_path: dict):
    """Run one path with the counts at 0 just before it; record the
    counts just after and fail if a kernel of the path never launched."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    by_path[path] = {k: v for k, v in counts().items() if v}
    missing = [k for k in must_launch if not by_path[path].get(k)]
    if missing:
        raise AssertionError(f"{path}: kernels never launched: {missing}")
    return out


# -- comparisons ---------------------------------------------------------------


def compare_topk(q, x, k, got, ref, tol):
    """Kernel vs plain top-k: values within ``tol``; index lists equal
    except where both lists are a valid top-k under exact (f64) scores
    to within ``tol`` (a near-tie: the two sides sum in another order).
    -> (max_abs_err, index_mismatches, near_ties)."""

    gv, gi = got
    pv, pi = ref
    err = float((gv - pv).abs().max())
    bad = (gi != pi).any(dim=1).nonzero().flatten().tolist()
    ties = 0
    for r in bad:
        qd = q[r].double()
        a = (x[gi[r].long()].double() @ qd).sort(descending=True).values
        b = (x[pi[r].long()].double() @ qd).sort(descending=True).values
        ties += int((a - b).abs().max() <= tol)
    return err, len(bad) - ties, ties


def trunc_step(v, lane_bits: int):
    """One fast-mode truncation step at |v|: 2**lane_bits f32 ulps."""
    e = torch.frexp(v.abs().double().clamp_min(2.0**-126)).exponent
    # 2**(e - 24 + lane_bits) built from its bits: torch.pow on the card
    # may land an ulp under the power of two, and one step would then
    # count as more than one
    return ((e.long() - 24 + lane_bits + 1023) << 52).view(torch.float64)


def compare_fast(q, x, n_valid, got, ref, lane_bits):
    """Fast kernel vs its plain version: the sentinel tail (-inf) equal;
    finite values equal or one truncation step apart; index lists equal
    except near-ties whose exact (f64) scores differ by at most one step.
    -> dict of max_abs_err, values_one_step_apart, index_mismatches,
    near_ties."""

    gv, gi = got
    pv, pi = ref
    fin = torch.isfinite(pv)
    if not torch.equal(fin, torch.isfinite(gv)) or not torch.equal(gi[~fin], pi[~fin]):
        raise AssertionError("fast top-k: the sentinel tails differ")
    step = trunc_step(torch.maximum(gv.abs(), pv.abs()), lane_bits)
    diff = (gv.double() - pv.double()).abs()
    if bool((diff[fin] > step[fin]).any()):
        raise AssertionError(f"fast top-k: values more than one step apart: "
                             f"{float(diff[fin].max())}")
    bad = ((gi != pi) & fin).any(dim=1).nonzero().flatten().tolist()
    ties = 0
    for r in bad:
        f = fin[r]
        qd = q[r].double()
        a = (x[gi[r][f].long()].double() @ qd).sort(descending=True).values
        b = (x[pi[r][f].long()].double() @ qd).sort(descending=True).values
        ties += int(((a - b).abs() <= trunc_step(torch.maximum(a.abs(), b.abs()),
                                                 lane_bits)).all())
    return {"max_abs_err": float(diff[fin].max()) if fin.any() else 0.0,
            "values_one_step_apart": int((diff[fin] > 0).sum()),
            "index_mismatches": len(bad) - ties, "near_ties": ties}


def unit_rows(n: int, g, dtype=torch.bfloat16, block: int = 1 << 18):
    """n seeded unit vectors [n, DIM] made on the card block by block, so
    no f32 copy of the whole corpus exists."""
    x = torch.empty((n, DIM), dtype=dtype, device="cuda")
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        x[lo:hi] = torch.nn.functional.normalize(
            torch.randn((hi - lo, DIM), device="cuda", generator=g), dim=1).to(dtype)
    return x


def topk_edges(x, g) -> list:
    """The shapes the tensor-core tiling of the top-k puts at risk, in
    both modes, each held against the plain version and timed: odd d
    (scalar staging, zero-filled depth tail), k 300 at Q 256 over the
    probe corpus ``x`` (32 queries per block), Q at tile edges, an n_valid
    that is not a multiple of any tile, and a corpus of 64 distinct
    small-integer rows repeated (every sum exact, so exact ties must go to
    the lowest row and both modes must equal the plain version bit for
    bit)."""

    from abstracts_search_tpu_torch.ops import topk

    chunk = FLAT_CHUNK
    lane_bits = chunk.bit_length() - 1

    def unit(shape):
        return torch.nn.functional.normalize(
            torch.randn(shape, device="cuda", generator=g), dim=1).to(torch.bfloat16)

    ints = lambda shape: torch.randint(-3, 4, shape, device="cuda",  # noqa: E731
                                       generator=g).to(torch.bfloat16)
    x_rep = ints((64, DIM))[torch.randint(0, 64, (N_LISTS,), device="cuda", generator=g)]
    cases = [("odd_d", unit((37, 100)), unit((8192, 100)), 8192, 10),
             ("odd_d", unit((37, 1000)), unit((8192, 1000)), 8000, 10),
             ("k300", unit((256, DIM)), x, N_LISTS, 300),
             *[("q_edge", unit((qn, DIM)), x, N_LISTS, 16) for qn in (1, 7, 129, 300)],
             ("n_valid", unit((128, DIM)), x, N_LISTS - 77, 16),
             ("repeated_rows", ints((128, DIM)), x_rep, N_LISTS - 77, 16)]
    out = []
    for name, q, xs, n_valid, k in cases:
        for mode in ("exact", "fast"):
            run = lambda impl: topk.streaming_topk(  # noqa: E731
                q, xs, n_valid, k, chunk=chunk, impl=impl, mode=mode)
            got, ref = run("cuda"), run("torch")
            torch.cuda.synchronize()
            if mode == "exact":
                err, bad, ties = compare_topk(q, xs, k, got, ref, 1e-5)
                res = {"max_abs_err": err, "index_mismatches": bad, "near_ties": ties}
            else:
                res = compare_fast(q, xs, n_valid, got, ref, lane_bits)
            if name == "repeated_rows":
                res["bit_equal"] = bool(torch.equal(got[0], ref[0])
                                        and torch.equal(got[1], ref[1]))
            case = {"case": name, "mode": mode, "q": q.shape[0], "n": xs.shape[0],
                    "n_valid": n_valid, "d": q.shape[1], "k": k, **res,
                    "ms": cuda_ms(lambda: run("cuda"))}
            out.append(case)
            if (res["index_mismatches"] or not res.get("bit_equal", True)
                    or (mode == "exact" and res["max_abs_err"] > 1e-4)):
                raise AssertionError(f"topk kernel disagrees at an edge: {case}")
    return out


def sass_by_function(lib_path: str) -> dict:
    """A built library's SASS (cuobjdump), split by kernel function:
    mangled name -> its SASS text."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            name = m.group(1)
            out[name] = ""
        elif name is not None:
            out[name] += line + "\n"
    return out


def sass_count(text: str, *mnemonics: str) -> int:
    """Lines of SASS holding any of the mnemonics."""
    return sum(1 for line in text.splitlines() if any(m in line for m in mnemonics))


def adc_edges(g) -> list:
    """Every ADC kernel against its plain version, bit for bit, over 8,192
    slots of 256 queries: at PQ128x4 the fused scan (3) and the packed
    raw scans, transposed (4) and row-major (5); at PQ64x8 (64 KiB LUTs)
    the byte-code raw scans, transposed (4) and row-major (6).
    Small-integer LUTs (many rows tie, and row order decides) and Gaussian
    ones, each with q_ids query-major (the search path), alternating
    every slot (the index's load check) and shuffled (a LUT reload at
    almost every slot). Each timed."""

    from abstracts_search_tpu_torch.ops import adc

    n_segs, n_slots, qn = 24_576, 8_192, 256
    seg_ids = torch.randint(0, n_segs, (n_slots,), dtype=torch.int32, device="cuda",
                            generator=g)
    major = (torch.arange(n_slots, device="cuda") * qn // n_slots).int()
    orders = {"major": major, "alternating": (torch.arange(n_slots, device="cuda") % 2).int(),
              "shuffled": major[torch.randperm(n_slots, device="cuda", generator=g)]}
    valid = torch.randint(0, SEG + 1, (n_slots,), dtype=torch.int32, device="cuda",
                          generator=g)
    out = []
    for pq, mb, m, ksub in (("PQ128x4", 64, 128, 16), ("PQ64x8", 64, 64, 256)):
        codes = torch.randint(0, 256, (n_segs, mb, SEG), dtype=torch.uint8, device="cuda",
                              generator=g)
        rows = codes.transpose(1, 2).contiguous()

        def run(kernel, luts, q_ids, impl):
            if kernel == "adc_topk":
                return adc.adc_topk(codes, luts, seg_ids, q_ids, valid, 10, impl=impl)
            transposed = kernel == "adc_kernel_t"
            return (adc.adc_scan(codes if transposed else rows, luts, seg_ids, q_ids,
                                 transposed=transposed, impl=impl),)

        kernels = (("adc_topk", "adc_kernel_t", "adc_kernel_packed4") if ksub == 16 else
                   ("adc_kernel_t", "adc_kernel"))
        for values in ("ties", "randn"):
            luts = (torch.randint(-2, 3, (qn, m, ksub), device="cuda", generator=g).float()
                    if values == "ties" else
                    torch.randn((qn, m, ksub), device="cuda", generator=g))
            for order, q_ids in orders.items():
                for kernel in kernels:
                    got, ref = run(kernel, luts, q_ids, "cuda"), run(kernel, luts, q_ids, "torch")
                    torch.cuda.synchronize()
                    case = {"kernel": kernel, "pq": pq, "luts": values, "q_ids": order,
                            "slots": n_slots,
                            "bit_equal": all(torch.equal(a, b) for a, b in zip(got, ref)),
                            "ms": cuda_ms(lambda: run(kernel, luts, q_ids, "cuda"))}
                    out.append(case)
                    if not case["bit_equal"]:
                        raise AssertionError(f"an ADC kernel disagrees: {case}")
        del codes, rows
    return out


def check_kernels(seed: int):
    """Each kernel against its plain version at the paths' shapes.
    -> (results, the kernel-4 row: no search path reaches that kernel,
    so its launches are this phase's, timing calls not counted)."""

    from abstracts_search_tpu_torch.ops import adc, topk

    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {"topk": [], "topk_fast": [], "adc_topk": [], "adc_scan": []}
    x = unit_rows(N_LISTS, g)
    for qn in (1, 256):
        q = torch.nn.functional.normalize(
            torch.randn((qn, DIM), device="cuda", generator=g), dim=1).to(torch.bfloat16)
        for k in (2, 16, 64):
            got = topk.streaming_topk(q, x, N_LISTS, k, impl="cuda")
            ref = topk.streaming_topk(q, x, N_LISTS, k, impl="torch")
            torch.cuda.synchronize()
            err, bad, ties = compare_topk(q, x, k, got, ref, 1e-5)
            case = {"q": qn, "n": N_LISTS, "d": DIM, "dtype": "bf16", "k": k,
                    "max_abs_err": err, "index_mismatches": bad, "near_ties": ties,
                    "ms": cuda_ms(lambda: topk.streaming_topk(q, x, N_LISTS, k,
                                                              impl="cuda")),
                    "plain_ms": cuda_ms(lambda: topk.streaming_topk(
                        q, x, N_LISTS, k, impl="torch"), reps=3, warmup=1),
                    "library_ms": cuda_ms(lambda: torch.topk(q @ x.T, k))}
            out["topk"].append(case)
            if bad or err > 1e-4:
                raise AssertionError(f"topk kernel disagrees: {case}")
    # f32 operands run as true f32 (no TF32): a smaller shape suffices
    q32 = torch.randn((37, 256), device="cuda", generator=g)
    x32 = torch.randn((8192, 256), device="cuda", generator=g)
    got = topk.streaming_topk(q32, x32, 8000, 40, impl="cuda")
    ref = topk.streaming_topk(q32, x32, 8000, 40, impl="torch")
    err, bad, ties = compare_topk(q32, x32, 40, got, ref, 1e-4)
    out["topk"].append({"q": 37, "n": 8192, "n_valid": 8000, "d": 256, "dtype": "f32",
                        "k": 40, "max_abs_err": err, "index_mismatches": bad,
                        "near_ties": ties})
    if bad or err > 1e-3:
        raise AssertionError(f"topk f32 kernel disagrees: {out['topk'][-1]}")

    # fast mode at bench.py's chunk over the probe-sized corpus; a case
    # with fewer valid rows than k (sentinel tail) and one where every
    # score is negative (truncation toward -inf grows the magnitude)
    chunk = FLAT_CHUNK
    lane_bits = chunk.bit_length() - 1
    x_pos = x.abs()
    for qn, k, n_valid, neg in ((1, 1, N_LISTS, False), (1, 10, N_LISTS, False),
                                (128, 10, N_LISTS, False), (128, 24, N_LISTS, False),
                                (128, 10, 5, False), (1, 24, 20_000, True),
                                (128, 10, N_LISTS, True)):
        q = torch.randn((qn, DIM), device="cuda", generator=g).to(torch.bfloat16)
        xs = x_pos if neg else x
        if neg:
            q = -q.abs()
        run = lambda impl: topk.streaming_topk(q, xs, n_valid, k, chunk=chunk,  # noqa: E731
                                               impl=impl, mode="fast")
        got, ref = run("cuda"), run("torch")
        torch.cuda.synchronize()
        case = {"q": qn, "n": N_LISTS, "n_valid": n_valid, "d": DIM, "dtype": "bf16",
                "k": k, "chunk": chunk, "negative_scores": neg,
                **compare_fast(q, xs, n_valid, got, ref, lane_bits),
                "ms": cuda_ms(lambda: run("cuda")),
                "plain_ms": cuda_ms(lambda: run("torch"), reps=3, warmup=1)}
        out["topk_fast"].append(case)
        if case["index_mismatches"]:
            raise AssertionError(f"fast topk kernel disagrees: {case}")
    out["topk_edges"] = topk_edges(x, g)
    del x, x_pos

    n_segs, n_slots, qn = 24_576, 8_192, 256
    k4, k4_launches = None, 0
    for mb, m, ksub in ((64, 128, 16), (64, 64, 256)):
        codes = torch.randint(0, 256, (n_segs, mb, SEG), dtype=torch.uint8,
                              device="cuda", generator=g)
        luts = torch.randn((qn, m, ksub), device="cuda", generator=g)
        seg_ids = torch.randint(0, n_segs, (n_slots,), dtype=torch.int32,
                                device="cuda", generator=g)
        q_ids = (torch.arange(n_slots, device="cuda") * qn // n_slots).int()
        full = torch.rand((n_slots,), device="cuda", generator=g) < 0.8
        valid = torch.where(full, SEG, torch.randint(0, SEG + 1, (n_slots,), device="cuda",
                                                     generator=g)).int()
        for kp in (10, 32):
            args = (codes, luts, seg_ids, q_ids, valid, kp)
            kv, ki = adc.adc_topk(*args, impl="cuda")
            pv, pi = adc.adc_topk(*args, impl="torch")
            torch.cuda.synchronize()
            fin = torch.isfinite(pv)
            case = {"slots": n_slots, "mb": mb, "m": m, "ksub": ksub, "seg": SEG,
                    "kp": kp, "zero_valid_slots": int((valid == 0).sum()),
                    "bit_equal": bool(torch.equal(kv, pv) and torch.equal(ki, pi)),
                    "max_abs_err": float((kv[fin] - pv[fin]).abs().max()),
                    "index_mismatches": int((ki != pi).sum()),
                    "inf_mismatches": int((torch.isfinite(kv) != fin).sum()),
                    "ms": cuda_ms(lambda: adc.adc_topk(*args, impl="cuda")),
                    "plain_ms": cuda_ms(lambda: adc.adc_topk(*args, impl="torch"),
                                        reps=3, warmup=1)}
            out["adc_topk"].append(case)
            if not case["bit_equal"]:
                raise AssertionError(f"adc_topk kernel disagrees: {case}")
        # raw scans over both layouts of the same codes (kernels 4, 5, 6)
        for transposed in (True, False):
            c3 = codes if transposed else codes.transpose(1, 2).contiguous()
            sargs = (c3, luts, seg_ids, q_ids)
            run = lambda impl: adc.adc_scan(*sargs, transposed=transposed,  # noqa: E731
                                            impl=impl)
            before = counts()["adc_kernel_t"]
            got, ref = run("cuda"), run("torch")
            torch.cuda.synchronize()
            k4_launches += counts()["adc_kernel_t"] - before
            case = {"slots": n_slots, "mb": mb, "m": m, "ksub": ksub, "seg": SEG,
                    "transposed": transposed, "bit_equal": bool(torch.equal(got, ref)),
                    "ms": cuda_ms(lambda: run("cuda")),
                    "plain_ms": cuda_ms(lambda: run("torch"), reps=3, warmup=1)}
            out["adc_scan"].append(case)
            if not case["bit_equal"]:
                raise AssertionError(f"adc_scan kernel disagrees: {case}")
            if transposed and ksub == 16:
                b, by = bound(n_slots * (mb * SEG + 4 * SEG + 8) + luts.numel() * 4,
                              n_slots * SEG * m, "f32")
                k4 = {"shape": [n_slots, mb, SEG, m, ksub], "max_abs_err": 0.0,
                      "ms": case["ms"],
                      "device_ms": device_ms(lambda: run("cuda"),
                                             DEVICE_NAMES["adc_kernel_t"]),
                      "plain_ms": case["plain_ms"], "bound_ms": b,
                      "bound_by": by, "library_ms": None,
                      "launches_from": "kernels phase, the calls held against the "
                                       "plain version (timing calls not counted): no "
                                       "search path of the JAX package reaches this "
                                       "kernel"}
            del c3
        del codes
    k4["launches"] = k4_launches
    out["adc_edges"] = adc_edges(g)
    return out, k4


# -- flat search (bench.py's configuration) ------------------------------------------


def flat_phase(seed: int, by_path: dict):
    """-> (phase result, kernel rows for the fast kernel and the exact
    kernel at this shape)."""

    from abstracts_search_tpu_torch.index import FlatIndex
    from abstracts_search_tpu_torch.ops import topk

    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    x = unit_rows(FLAT_N, g)
    # bench.py's queries: standard normal rows, cast to the corpus type
    qs = [torch.randn((FLAT_Q, DIM), device="cuda", generator=g).to(torch.bfloat16)
          for _ in range(4)]
    lane_bits = FLAT_CHUNK.bit_length() - 1
    fast = lambda q, impl="cuda": topk.streaming_topk(  # noqa: E731
        q, x, FLAT_N, FLAT_K, chunk=FLAT_CHUNK, impl=impl, mode="fast")
    flat = FlatIndex()
    flat.add(x)
    q_np = qs[0].float().cpu().numpy()

    def path():
        fast(qs[0])
        torch.cuda.synchronize()
        reps = 16
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for r in range(reps):        # chained calls, one sync, as bench.py times them
            fast(qs[r % 4])
        e.record()
        e.synchronize()
        per_batch_ms = s.elapsed_time(e) / reps
        return per_batch_ms, flat.search(q_np, FLAT_K)

    per_batch_ms, (fv, fp) = drive("flat", path, ("topk_fast", "topk"), by_path)

    got, ref = fast(qs[0]), fast(qs[0], "torch")
    torch.cuda.synchronize()
    fast_cmp = compare_fast(qs[0], x, FLAT_N, got, ref, lane_bits)
    if fast_cmp["index_mismatches"]:
        raise AssertionError(f"fast kernel disagrees at bench.py's shape: {fast_cmp}")
    flat.impl = "torch"
    pv, pp = flat.search(q_np, FLAT_K)
    flat.impl = "auto"
    err, bad, ties = compare_topk(qs[0], x, FLAT_K,
                                  (torch.from_numpy(fv).cuda(), torch.from_numpy(fp).cuda()),
                                  (torch.from_numpy(pv).cuda(), torch.from_numpy(pp).cuda()),
                                  1e-4)
    if bad or err > 1e-4 or not np.isfinite(fv).all() or fv.shape != (FLAT_Q, FLAT_K):
        raise AssertionError(f"FlatIndex kernel route disagrees: err {err}, {bad} rows")
    # fast values are exact scores truncated toward -inf by at most a step
    ex = torch.from_numpy(fv).cuda().double()
    gap = ex - got[0].double()
    if bool((gap < -1e-4).any() or (gap > trunc_step(ex, lane_bits) + 1e-4).any()):
        raise AssertionError("fast values are not the exact ones truncated")

    library_ms = cuda_ms(lambda: torch.topk(qs[0] @ x.T, FLAT_K))
    b, by = bound(x.numel() * 2 + qs[0].numel() * 2 + FLAT_Q * FLAT_K * 8,
                  2 * FLAT_Q * FLAT_N * DIM, "bf16")
    shape = [FLAT_Q, FLAT_N, DIM, FLAT_K]
    q0 = qs[0]
    exact = lambda impl: topk.streaming_topk(q0, x, FLAT_N, FLAT_K,  # noqa: E731
                                             chunk=FLAT_CHUNK, impl=impl)
    rows = {
        "topk_fast": {"shape": shape + [FLAT_CHUNK], **fast_cmp,
                      "ms": cuda_ms(lambda: fast(q0), reps=10),
                      "device_ms": device_ms(lambda: fast(q0), DEVICE_NAMES["topk_fast"],
                                             reps=5),
                      "plain_ms": cuda_ms(lambda: fast(q0, "torch"), reps=3, warmup=1),
                      "bound_ms": b, "bound_by": by, "library_ms": library_ms},
        "topk_flat": {"shape": shape, "max_abs_err": err, "index_mismatches": bad,
                      "near_ties": ties, "ms": cuda_ms(lambda: exact("cuda"), reps=10),
                      "device_ms": device_ms(lambda: exact("cuda"), DEVICE_NAMES["topk"],
                                             reps=5),
                      "plain_ms": cuda_ms(lambda: exact("torch"), reps=3, warmup=1),
                      "bound_ms": b, "bound_by": by, "library_ms": library_ms},
    }
    res = {"metric": FLAT_METRIC, "value": FLAT_Q / (per_batch_ms / 1e3),
           "unit": "queries/sec/chip", "mode": "fast", "batch_ms": per_batch_ms,
           "flat_index_exact": {"max_abs_err": err, "index_mismatches": bad,
                                "near_ties": ties},
           "fast_vs_plain": fast_cmp, "library_ms": library_ms,
           "launches": by_path["flat"]}
    del x, flat, qs, got, ref
    release()
    return res, rows


# -- index artifacts ----------------------------------------------------------------


def list_sizes(n_rows: int, seed: int, n_lists: int = N_LISTS):
    """Lognormal (sigma 1) list sizes summing to n_rows, each >= 1: the
    mass-weighted mean list is ~e times the plain mean, like real IVF
    lists under skewed data."""

    w = np.random.default_rng(seed).lognormal(0.0, 1.0, n_lists)
    raw = w / w.sum() * (n_rows - n_lists)
    sizes = np.floor(raw).astype(np.int64) + 1
    short = n_rows - int(sizes.sum())
    sizes[np.argsort(raw - np.floor(raw))[::-1][:short]] += 1
    return sizes


class _SeededCodes:
    """Random uint8 codes [n_segs, ...], made on the card chunk by chunk
    as save_lists reads them, so the 12.9 GiB payload never sits in host
    memory. A slice's content depends only on (seed, start)."""

    dtype = np.dtype(np.uint8)

    def __init__(self, shape, seed: int):
        self.shape = shape
        self.seed = seed

    def __getitem__(self, sl: slice):

        lo, hi, _ = sl.indices(self.shape[0])
        g = torch.Generator(device="cuda").manual_seed(self.seed * 1_000_003 + lo)
        return torch.randint(0, 256, (hi - lo,) + tuple(self.shape[1:]),
                             dtype=torch.uint8, device="cuda", generator=g).cpu().numpy()


def write_index(out: Path, n_rows: int, seed: int, *, n_lists: int = N_LISTS,
                pq_m: int = PQ_M, pq_nbits: int = PQ_NBITS,
                transposed: bool = True) -> dict:
    """Seeded artifacts through the port's own save path: centroids,
    rotation and codebooks via IVFPQIndex.save, lists via save_lists.
    Segment blocks are [MB, SEG] (transposed) or [SEG, MB] (row-major)."""

    from abstracts_search_tpu_torch.index.ivfpq import IVFPQIndex
    from abstracts_search_tpu_torch.index.lists import CSRLists, save_lists

    g = torch.Generator(device="cuda").manual_seed(seed)
    sizes = list_sizes(n_rows, seed, n_lists)
    seg_cnt = -(-sizes // SEG)
    seg_start = np.concatenate([[0], np.cumsum(seg_cnt)[:-1]])
    n_segs = int(seg_cnt.sum())
    seg_list = np.repeat(np.arange(n_lists), seg_cnt)
    seg_valid = np.clip(sizes[seg_list] - (np.arange(n_segs) - seg_start[seg_list]) * SEG,
                        0, SEG).astype(np.int32)

    cent = torch.nn.functional.normalize(
        torch.randn((n_lists, DIM), device="cuda", generator=g), dim=1)
    rot, _ = torch.linalg.qr(torch.randn((DIM, DIM), device="cuda", generator=g))
    # residual codebooks small next to the unit centroids (|r| ~ 0.3)
    pqc = 0.01 * torch.randn((pq_m, 1 << pq_nbits, DIM // pq_m), device="cuda",
                             generator=g)
    idx = IVFPQIndex(n_lists, DIM, pq_m=pq_m, pq_nbits=pq_nbits, use_opq=True,
                     seg_size=SEG, device="cuda")
    idx.set_params(cent.cpu().numpy(), pqc.cpu().numpy(), rot.cpu().numpy())
    idx.n = n_rows
    idx.save(out, include_lists=False)
    mb = idx.code_bytes
    del idx

    # row ids: a seeded permutation of the corpus positions laid out
    # list-contiguously, -1 in each list's padded tail
    size_t = torch.from_numpy(sizes).cuda()
    dest = (torch.repeat_interleave(torch.from_numpy(seg_start * SEG).cuda(), size_t,
                                    output_size=n_rows)
            + torch.arange(n_rows, device="cuda")
            - torch.repeat_interleave(torch.cumsum(size_t, 0) - size_t, size_t,
                                      output_size=n_rows))
    rows = torch.full((n_segs * SEG,), -1, dtype=torch.int32, device="cuda")
    rows[dest] = torch.randperm(n_rows, device="cuda", generator=g).int()
    del dest
    blk = (mb, SEG) if transposed else (SEG, mb)
    csr = CSRLists(data=_SeededCodes((n_segs,) + blk, seed),
                   row_ids=rows.view(n_segs, SEG).cpu().numpy(),
                   seg_valid=seg_valid, seg_start=seg_start.astype(np.int64),
                   seg_cnt=seg_cnt.astype(np.int32), seg_size=SEG, n_lists=n_lists,
                   n_rows=n_rows, transposed=transposed)
    save_lists(csr, out / "lists")
    del rows
    torch.cuda.empty_cache()
    return {"n_rows": n_rows, "n_lists": n_lists, "pq": f"PQ{pq_m}x{pq_nbits}",
            "transposed": transposed, "n_segs": n_segs,
            "seg_cnt_min": int(seg_cnt.min()), "seg_cnt_max": int(seg_cnt.max()),
            "codes_gib": n_segs * mb * SEG / 2**30}


def release() -> None:
    """Return the card memory of dropped objects. The HTTP handler class
    closes over the engine, so a served index sits in a reference cycle
    that only the cyclic collector frees."""
    gc.collect()
    torch.cuda.empty_cache()


def open_index(art: Path, n_rows: int, seed: int, phase: str, **kw):
    """Write, then load (device storage), one artifact; emits the phase
    line."""

    shutil.rmtree(art, ignore_errors=True)
    t = time.perf_counter()
    info = write_index(art, n_rows, seed, **kw)
    t_write = time.perf_counter() - t
    idx, load = open_storage(art, "device")
    emit({"phase": phase, **info, "write_seconds": t_write, **load,
          "seconds": time.perf_counter() - t})
    return idx


# -- serve -------------------------------------------------------------------------


def reconstructions(idx, n: int, seed: int):
    """n corpus rows decoded back to vectors (c_list + decode(codes),
    un-rotated): a query that should find its own row. -> (queries
    [n, D], positions [n])."""

    rng = np.random.default_rng(seed + 1)
    p = idx.packed
    segs = rng.choice(np.nonzero(p.seg_valid)[0], n)
    within = (rng.random(n) * p.seg_valid[segs]).astype(np.int64)
    # an empty list shares its start with the next list, so "right"
    # finds the list that owns the segment
    lists = np.searchsorted(p.seg_start, segs, side="right") - 1
    # from the memmap, so any storage serves: [n, MB]
    codes = torch.from_numpy(np.asarray(p.data[segs, :, within] if p.transposed
                                        else p.data[segs, within])).cuda()
    if codes.shape[1] * 2 == idx.pq_m:            # nibble-packed 4-bit codes
        codes = torch.stack([codes & 15, codes >> 4], dim=2).reshape(n, idx.pq_m)
    m = torch.arange(idx.pq_m, device=idx.device)
    resid = idx._pq_cent[m[None, :], codes.long()]                           # [n, M, dsub]
    v = idx._cent[torch.from_numpy(lists).cuda()] + resid.reshape(n, DIM)
    q = v @ idx._rot.T          # search rotates by q @ rot; rot is orthogonal
    return q.cpu().numpy(), np.asarray(p.row_ids[segs, within], np.int64)


def probe_near_ties(idx, q, nprobe, tol=1e-5):
    """Queries whose kernel and plain probe sets differ, each checked to
    be a valid top-nprobe under exact f64 scores within ``tol``.
    -> (queries with differing probes, of which invalid)."""

    from abstracts_search_tpu_torch.index.ivfpq import _normalize_rows

    qt = torch.from_numpy(_normalize_rows(np.asarray(q, np.float32))).cuda()
    sets = {}
    for impl in ("cuda", "torch"):
        idx.impl = impl
        sets[impl] = idx._probe(qt, nprobe)[0].long()
    idx.impl = "cuda"
    diff = (sets["cuda"].sort(1).values != sets["torch"].sort(1).values).any(1)
    rows = diff.nonzero().flatten().tolist()
    qr = (qt @ idx._rot).to(torch.bfloat16)       # the probe's own operand
    bad = 0
    for r in rows:
        s = idx._cent_bf16[: idx.n_lists].double() @ qr[r].double()
        cut = s.sort(descending=True).values[nprobe - 1]
        bad += int(any(s[sets[impl][r]].min() < cut - tol for impl in sets))
    return rows, bad


def hold_against_plain(idx, q_sets: dict, own) -> dict:
    """The kernel path against the plain path on the same resident index
    at nprobe 2 and 16, and self-hit@10 for the reconstructions."""

    res = {}
    for nprobe in (2, 16):
        for name, q in q_sets.items():
            v, p = idx.search(q, 10, nprobe=nprobe)
            idx.impl, idx.scan_impl = "torch", "torch"
            pv, pp = idx.search(q, 10, nprobe=nprobe)
            idx.impl, idx.scan_impl = "cuda", "cuda"
            differ = (p != pp).any(axis=1)
            if differ.any():
                rows, bad = probe_near_ties(idx, q, nprobe)
                if bad or not set(np.nonzero(differ)[0]) <= set(rows):
                    raise AssertionError(
                        f"kernel path disagrees with the plain path ({name}, "
                        f"nprobe {nprobe}): {int(differ.sum())} queries")
            same = ~differ
            err = float(np.abs(v[same] - pv[same]).max()) if same.any() else 0.0
            if err > 1e-5 or not np.isfinite(v).all():
                raise AssertionError(f"scores differ by {err} ({name}, nprobe {nprobe})")
            res[f"{name}_np{nprobe}"] = {
                "queries_differing_by_probe_near_ties": int(differ.sum()),
                "max_abs_err": err, "live_slots": idx.last_scan_stats["live_slots"]}
            if name == "recon":
                res[f"{name}_np{nprobe}"]["self_hit_at_10"] = float(
                    np.mean([own[i] in p[i] for i in range(len(own))]))
    return res


def engine_times(engine, q_text, texts, batch16: bool = False) -> dict:
    """Batch-256 QPS and single-query p50 through the engine (host
    clock); batch-16 times too where asked."""

    engine.search_batch_encoded(q_text, 10)
    batch_s = []
    for _ in range(5):
        t = time.perf_counter()
        out = engine.search_batch_encoded(q_text, 10)
        batch_s.append(time.perf_counter() - t)
    assert len(out) == 256 and all(len(r) == 10 for r in out)
    single_s = []
    for i in range(50):
        t = time.perf_counter()
        r = engine.search(texts[i % len(texts)], 10)
        single_s.append(time.perf_counter() - t)
    assert len(r) == 10
    res = {"qps_batch256": 256 / statistics.median(batch_s),
           "batch256_ms_median": statistics.median(batch_s) * 1e3,
           "single_query_p50_ms": statistics.median(single_s) * 1e3}
    if batch16:
        b16 = []
        for i in range(10):
            t = time.perf_counter()
            engine.search_batch_encoded(q_text[16 * i:16 * (i + 1)], 10)
            b16.append(time.perf_counter() - t)
        res.update(qps_batch16=16 / statistics.median(b16),
                   batch16_ms_median=statistics.median(b16) * 1e3)
    return res


def profile_batches(engine, q, reps: int = 3) -> dict:
    """torch.profiler over ``reps`` batch searches: the device's busy
    time (union of kernel and copy intervals) against the host clock,
    and the device time by kernel name, per batch."""
    from torch.profiler import ProfilerActivity, profile

    engine.search_batch_encoded(q, 10)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            engine.search_batch_encoded(q, 10)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            a, b = e.time_range.start, e.time_range.end
            spans.append((a, b))
            by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + (b - a)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_us / reps / 1e3, "device_busy_ms": busy / reps / 1e3,
            "device_idle_share": 1.0 - busy / wall_us, "device_events": len(spans),
            "top_device_ms": [[n, t / reps / 1e3] for n, t in top]}


class _LazyIds:
    """Position -> "W<position>" without a 207M-entry array in RAM."""

    def __getitem__(self, p):
        return f"W{int(p)}"


def queries(idx, seed: int):
    from abstracts_search_tpu_torch.models.registry import HashEmbedder

    emb = HashEmbedder(DIM)
    texts = [f"semantic search query number {i} about topic {i % 97}" for i in range(256)]
    q_rec, own = reconstructions(idx, 256, seed)
    return emb, texts, emb.queries(texts), q_rec, own


def serve(idx, seed: int, by_path: dict, *, http: bool, path: str, must_launch,
          kept=None, batch16: bool = False):
    """The search path through SearchEngine, counted as ``path``; held
    against the plain path, and against ``kept`` (another storage's
    results on the same queries) where given. -> (context: engine,
    texts, query sets; the phase's results)."""

    from abstracts_search_tpu_torch.serve.engine import SearchEngine

    emb, texts, q_text, q_rec, own = queries(idx, seed)
    engine = SearchEngine(idx, _LazyIds(), emb, nprobe=16)
    q_sets = {"text": q_text, "recon": q_rec}

    def run():
        t0 = time.perf_counter()
        res = hold_against_plain(idx, q_sets, own)
        if kept is not None:
            res["vs_device_storage"] = hold_against_kept(idx, q_sets, kept)
        res.update(engine_times(engine, q_text, texts, batch16=batch16))
        res["profile_batch256"] = profile_batches(engine, q_text)
        if idx.storage != "device":
            idx.search(q_text, 10, nprobe=16)
            res["scan_stats_batch256_np16"] = dict(idx.last_scan_stats)
        if http:
            res["http"] = http_round_trip(engine, texts)
        res["seconds"] = time.perf_counter() - t0
        return res

    res = drive(path, run, must_launch, by_path)
    res["launches"] = by_path[path]
    return {"engine": engine, "texts": texts, "q_sets": q_sets}, res


def keep_results(idx, q_sets: dict) -> dict:
    """The kernel path's results on the serve queries at nprobe 2 and
    16, kept to hold another storage against."""
    return {(name, nprobe): idx.search(q, 10, nprobe=nprobe)
            for nprobe in (2, 16) for name, q in q_sets.items()}


def hold_against_kept(idx, q_sets: dict, kept: dict) -> dict:
    """This storage against the kept results of the device storage on
    the same queries: scores bit for bit; positions identical except
    among equal scores (a group of equal scores holds the same
    positions, in any order; at the k-th place any of them)."""

    res = {}
    for (name, nprobe), (kv, kp) in kept.items():
        v, p = idx.search(q_sets[name], 10, nprobe=nprobe)
        if not np.array_equal(v, kv):
            raise AssertionError(f"{idx.storage} scores differ from the device storage's "
                                 f"({name}, nprobe {nprobe})")
        reordered = 0
        for r in np.nonzero((p != kp).any(axis=1))[0]:
            for u in np.unique(v[r][p[r] != kp[r]]):
                same = v[r] == u
                if u != v[r, -1] and (same.sum() < 2
                                      or set(p[r, same]) != set(kp[r, same])):
                    raise AssertionError(
                        f"{idx.storage} positions differ from the device storage's "
                        f"beyond equal scores ({name}, nprobe {nprobe}, query {r})")
            reordered += 1
        res[f"{name}_np{nprobe}"] = {"scores_bit_equal": True,
                                     "queries_reordered_among_equal_scores": reordered}
    return res


def stage_split(ctx: dict, nprobe: int = 16, k: int = 10, reps: int = 5) -> dict:
    """One batch-256 search of the engine split by StageTimer into the
    steps IVFPQIndex.search and the engine run, each ended by a
    synchronize; the rep of median host-clock time is reported. The
    stages must sum to within 10% of that time."""

    from abstracts_search_tpu_torch.index.ivfpq import _normalize_rows
    from abstracts_search_tpu_torch.utils.trace import StageTimer

    engine, texts = ctx["engine"], ctx["texts"]
    idx = engine.index

    def one():
        timer = StageTimer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timer.stage("encode"):
            q = engine.encode_queries(texts)
        with torch.inference_mode():
            with timer.stage("probe"):
                qt = torch.from_numpy(_normalize_rows(np.asarray(q, np.float32))).cuda()
                probes, bias, luts = idx._probe(qt, nprobe)
                torch.cuda.synchronize()
            with timer.stage("slot_list"):
                slots = idx._slots(probes, nprobe)
                torch.cuda.synchronize()
            with timer.stage("scan_merge"):
                v, rows = idx._scan_slots(idx._codes, luts, bias, slots, k)
                torch.cuda.synchronize()
            with timer.stage("device_to_host"):
                v, rows = v.cpu().numpy(), rows.cpu().numpy()
        with timer.stage("row_resolve"):
            pos = idx._rows_to_pos(rows, idx._seg_map)
        with timer.stage("id_strings"):
            hits = [[(float(a), int(b)) for a, b in zip(v[i], pos[i]) if b >= 0]
                    for i in range(len(texts))]
            names = iter(engine._resolve_with(engine.ids, [b for row in hits for _, b in row]))
            out = [[{"id": next(names), "score": a} for a, _ in row] for row in hits]
        return timer.report(), time.perf_counter() - t0, out

    one()
    runs = sorted((one() for _ in range(reps)), key=lambda r: r[1])
    report, total_s, out = runs[len(runs) // 2]
    want = engine.search_batch(texts, k)
    if [[r["id"] for r in row] for row in out] != [[r["id"] for r in row] for row in want]:
        raise AssertionError("the split batch does not return the engine's results")
    stage_s = sum(st["seconds"] for st in report["stages"])
    share = abs(stage_s - total_s) / total_s
    batch_s = []
    for _ in range(reps):
        t = time.perf_counter()
        engine.search_batch(texts, k)
        batch_s.append(time.perf_counter() - t)
    res = {"nprobe": nprobe, "k": k, "batch": len(texts),
           "stages_ms": {st["stage"]: st["seconds"] * 1e3 for st in report["stages"]},
           "stages_sum_ms": stage_s * 1e3, "batch_ms": total_s * 1e3,
           "unaccounted_share": share, "batch_ms_all_reps": [r[1] * 1e3 for r in runs],
           "engine_search_batch_ms_median": statistics.median(batch_s) * 1e3,
           "live_slots": idx.last_scan_stats.get("live_slots")}
    if share > 0.10:
        raise AssertionError(f"stages sum to {stage_s * 1e3:.3f} ms of a "
                             f"{total_s * 1e3:.3f} ms batch")
    return res


def open_storage(art: Path, storage: str, **kw):
    """Reopen an artifact in another storage. -> (index, load info)."""

    from abstracts_search_tpu_torch.index.ivfpq import IVFPQIndex

    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    idx = IVFPQIndex.load(art, storage=storage, **kw)
    info = {"storage": idx.storage, "load_seconds": time.perf_counter() - t,
            "resident_gib": torch.cuda.memory_allocated() / 2**30,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if idx.storage == "hybrid":
        info.update(hot_lists=int((idx._seg_cnt > 0).sum()),
                    hot_segments=int(idx._codes.shape[0]),
                    hot_gib=idx._codes.numel() / 2**30,
                    codes_gib=float(np.prod(idx.packed.data.shape)) / 2**30)
    return idx, info


def http_round_trip(engine, texts) -> str:
    """run_server in a thread on a free port: GET, batched POST, healthz."""

    from abstracts_search_tpu_torch.serve.app import run_server

    box = []
    th = threading.Thread(target=run_server, kwargs=dict(
        engine=engine, port=0, on_bound=box.append), daemon=True)
    th.start()
    for _ in range(200):
        if box:
            break
        time.sleep(0.05)
    url = f"http://127.0.0.1:{box[0].server_address[1]}"
    try:
        for t in texts[:4]:
            with urllib.request.urlopen(
                    f"{url}/search?q={urllib.parse.quote(t)}&k=10", timeout=60) as r:
                assert r.status == 200 and len(json.loads(r.read())["results"]) == 10
        req = urllib.request.Request(f"{url}/search", data=json.dumps(
            {"queries": texts, "k": 10}).encode(), headers={"Content-Type":
                                                            "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
            assert r.status == 200 and len(body["results"]) == 256
            assert all(len(x) == 10 for x in body["results"])
        with urllib.request.urlopen(f"{url}/healthz", timeout=10) as r:
            assert r.status == 200
    finally:
        box[0].shutdown()
        th.join(timeout=30)
    torch.cuda.synchronize()
    return "ok"


# -- the kernels line -----------------------------------------------------------------


def main_path_inputs(idx, q, nprobe):
    from abstracts_search_tpu_torch.index.ivfpq import _normalize_rows

    qt = torch.from_numpy(_normalize_rows(np.asarray(q, np.float32))).cuda()
    probes, bias, luts = idx._probe(qt, nprobe)
    slots = idx._slots(probes, nprobe)
    return qt, luts, slots.seg_ids, slots.q_ids, slots.valid


def probe_and_scan_rows(idx, q, nprobe, k):
    """Rows for the probe kernel and the fused scan, timed and bounded
    at the inputs the batch-256 search gave them."""

    from abstracts_search_tpu_torch.ops import adc, topk

    qt, luts, seg_ids, q_ids, valid = main_path_inputs(idx, q, nprobe)
    qr = (qt @ idx._rot).to(torch.bfloat16)
    x = idx._cent_bf16
    tk = lambda impl: topk.streaming_topk(qr, x, N_LISTS, nprobe, impl=impl)  # noqa: E731
    got, ref = tk("cuda"), tk("torch")
    t_err, t_bad, _ = compare_topk(qr, x, nprobe, got, ref, 1e-5)
    if t_bad:
        raise AssertionError("streaming_topk disagrees at the main path's inputs")
    t_bound, t_by = bound(x.numel() * 2 + qr.numel() * 2 + qr.shape[0] * nprobe * 8,
                          2 * qr.shape[0] * N_LISTS * DIM, "bf16")
    rows = {"topk": {"max_abs_err": t_err, "index_mismatches": t_bad,
                     "shape": [qr.shape[0], N_LISTS, DIM, nprobe],
                     "ms": cuda_ms(lambda: tk("cuda")),
                     "device_ms": device_ms(lambda: tk("cuda"), DEVICE_NAMES["topk"]),
                     "plain_ms": cuda_ms(lambda: tk("torch"), reps=3, warmup=1),
                     "bound_ms": t_bound, "bound_by": t_by,
                     "library_ms": cuda_ms(lambda: torch.topk(qr @ x.T, nprobe))}}

    args = (idx._codes, luts, seg_ids, q_ids, valid, min(k, SEG))
    kv, ki = adc.adc_topk(*args, impl="cuda")
    pv, pi = adc.adc_topk(*args, impl="torch")
    fin = torch.isfinite(pv)
    if not (torch.equal(ki, pi) and torch.equal(kv, pv)):
        raise AssertionError("adc_topk disagrees at the main path's inputs")
    n_slots = seg_ids.numel()
    mb = idx._codes.shape[1]
    a_bound, a_by = bound(n_slots * (mb * SEG + 12 + min(k, SEG) * 8) + luts.numel() * 4,
                          n_slots * SEG * PQ_M, "f32")
    rows["adc_topk"] = {"max_abs_err": float((kv[fin] - pv[fin]).abs().max()),
                        "index_mismatches": int((ki != pi).sum()),
                        "shape": [n_slots, mb, SEG, min(k, SEG)],
                        "ms": cuda_ms(lambda: adc.adc_topk(*args, impl="cuda")),
                        "device_ms": device_ms(lambda: adc.adc_topk(*args, impl="cuda"),
                                               DEVICE_NAMES["adc_topk"]),
                        "plain_ms": cuda_ms(lambda: adc.adc_topk(*args, impl="torch"),
                                            reps=3, warmup=1),
                        "bound_ms": a_bound, "bound_by": a_by, "library_ms": None}
    return rows


def raw_scan_row(idx, q, nprobe, key):
    """The row-major scan kernel ``key`` at the batch-256 search's
    inputs."""

    from abstracts_search_tpu_torch.ops import adc

    _, luts, seg_ids, q_ids, _ = main_path_inputs(idx, q, nprobe)
    run = lambda impl: adc.adc_scan(idx._codes, luts, seg_ids, q_ids,  # noqa: E731
                                    transposed=False, impl=impl)
    if not torch.equal(run("cuda"), run("torch")):
        raise AssertionError("adc_scan disagrees at the main path's inputs")
    n_slots, mb = seg_ids.numel(), idx._codes.shape[2]
    b, by = bound(n_slots * (mb * SEG + 4 * SEG + 8) + luts.numel() * 4,
                  n_slots * SEG * idx.pq_m, "f32")
    return {"max_abs_err": 0.0, "shape": [n_slots, SEG, mb, idx.pq_m, idx.ksub],
            "ms": cuda_ms(lambda: run("cuda")),
            "device_ms": device_ms(lambda: run("cuda"), DEVICE_NAMES[key]),
            "plain_ms": cuda_ms(lambda: run("torch"), reps=3, warmup=1),
            "bound_ms": b, "bound_by": by, "library_ms": None}


def tile_row(idx, q, nprobe, key):
    """Kernel ``key`` (the fused scan, or the row-major byte scan) over
    the tiles a host-storage batch gathers from the memmap (every
    probed segment in host storage, the cold ones in hybrid; seg_ids =
    tile indices), against its plain version, timed and bounded."""

    from abstracts_search_tpu_torch.index.ivfpq import _normalize_rows
    from abstracts_search_tpu_torch.index.lists import ragged_ranges
    from abstracts_search_tpu_torch.ops import adc

    qt = torch.from_numpy(_normalize_rows(np.asarray(q, np.float32))).cuda()
    probes, _, luts = idx._probe(qt, nprobe)
    pl = probes.cpu().numpy().reshape(-1).astype(np.int64)
    sidx, pair = ragged_ranges(idx._seg_start_h[pl], idx._host_cnt[pl])
    codes = idx._stage(idx.packed.data, sidx)
    n = len(sidx)
    seg_ids = torch.arange(n, dtype=torch.int32, device=idx.device)
    q_ids = torch.from_numpy((pair // nprobe).astype(np.int32)).cuda()
    valid = torch.from_numpy(np.asarray(idx.packed.seg_valid)[sidx].astype(np.int32)).cuda()
    torch.cuda.synchronize()
    if key == "adc_topk":
        kp = 10
        run = lambda impl: adc.adc_topk(codes, luts, seg_ids, q_ids, valid, kp,  # noqa: E731
                                        impl=impl)
        mb, seg = codes.shape[1], codes.shape[2]
        moved = n * (mb * seg + 12 + kp * 8)
    else:
        run = lambda impl: (adc.adc_scan(codes, luts, seg_ids, q_ids,  # noqa: E731
                                         transposed=False, impl=impl),)
        seg, mb = codes.shape[1], codes.shape[2]
        moved = n * (mb * seg + 4 * seg + 8)
    got, ref = run("cuda"), run("torch")
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise AssertionError(f"{key} disagrees with its plain version over gathered tiles")
    b, by = bound(moved + luts.numel() * 4, n * seg * idx.pq_m, "f32")
    return {"tiles": n, "shape": [n, *codes.shape[1:], idx.pq_m, idx.ksub],
            "max_abs_err": 0.0, "gathered_bytes": int(codes.numel()),
            "ms": cuda_ms(lambda: run("cuda")),
            "device_ms": device_ms(lambda: run("cuda"), DEVICE_NAMES[key]),
            "plain_ms": cuda_ms(lambda: run("torch"), reps=3, warmup=1),
            "bound_ms": b, "bound_by": by, "library_ms": None}


def kernels_line(rows: dict, by_path: dict) -> list:
    out = []
    for key, (name, source, replaces) in KERNELS.items():
        row = dict(rows[key])
        if key != "adc_kernel_t":
            paths = {p: c[key] for p, c in by_path.items() if c.get(key)}
            row["launches"] = sum(paths.values())
            row["launches_by_path"] = paths
        if row["launches"] <= 0:
            raise AssertionError(f"{key} never launched")
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    **row})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-rows", type=int, default=206_962_688)
    ap.add_argument("--phases",
                    default="device,build,kernels,flat,index,serve,stages_batch256,hybrid,"
                            "host,legacy",
                    help="comma-separated subset, for development runs")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]

    import abstracts_search_tpu_torch  # noqa: F401  (pins TF32 off)
    from abstracts_search_tpu_torch.device import assert_exact_f32
    from abstracts_search_tpu_torch.ops import _build

    assert_exact_f32()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    if "build" in phases:
        t = time.perf_counter()
        libs = _build.build_all()
        # the bf16 top-k must run on tensor cores, and every ADC kernel
        # must stage by bulk async copies: count both in the SASS
        hmma = sum(sass_count(text, "HMMA", "HGMMA")
                   for text in sass_by_function(libs["topk"]._name).values())
        bulk = {name: {fn: sass_count(text, "UBLKCP")
                       for fn, text in sass_by_function(libs[name]._name).items()}
                for name in ("adc_topk", "adc_scan")}
        emit({"phase": "build", "seconds": time.perf_counter() - t,
              "nvcc_seconds": _build.build_seconds, "libraries": sorted(libs),
              "topk_tensor_core_instructions": hmma,
              "bulk_copy_instructions": {
                  name: {"kernel_functions": len(c), "min_per_function": min(c.values(), default=0),
                         "total": sum(c.values())} for name, c in bulk.items()}})
        if hmma == 0:
            raise AssertionError("no HMMA/HGMMA instruction in the top-k library")
        unstaged = [fn for c in bulk.values() for fn, n in c.items() if n == 0]
        if unstaged or not all(bulk.values()):
            raise AssertionError(f"ADC kernel functions without a bulk copy (UBLKCP): "
                                 f"{unstaged or bulk}")

    rows, by_path = {}, {}
    if "kernels" in phases:
        t = time.perf_counter()
        res, rows["adc_kernel_t"] = check_kernels(args.seed)
        emit({"phase": "kernels", "seconds": time.perf_counter() - t, **res})

    if "flat" in phases:
        t = time.perf_counter()
        res, flat_rows = flat_phase(args.seed, by_path)
        rows["topk_fast"] = flat_rows["topk_fast"]
        emit({"phase": "flat", "seconds": time.perf_counter() - t, **res})

    art = Path(__file__).resolve().parent / "build" / "smoke_index"
    try:
        kept = None
        if "index" in phases:
            idx = open_index(art, args.n_rows, args.seed, "index")
            if "serve" in phases:
                ctx, res = serve(idx, args.seed, by_path, http=True, path="serve",
                                 must_launch=("topk", "adc_topk"))
                emit({"phase": "serve", "nprobe": 16, "k": 10, **res})
                rows.update(probe_and_scan_rows(idx, ctx["q_sets"]["text"], 16, 10))
                if "flat" in phases:
                    rows["topk"]["flat"] = flat_rows["topk_flat"]
                if "stages_batch256" in phases:
                    t = time.perf_counter()
                    res = stage_split(ctx)
                    emit({"phase": "stages_batch256", **res,
                          "seconds": time.perf_counter() - t})
                kept = keep_results(idx, ctx["q_sets"])
                del ctx
            del idx
            release()

        if kept is not None and "hybrid" in phases:
            t = time.perf_counter()
            idx, info = open_storage(art, "hybrid", hot_budget_bytes=HYBRID_HOT_BYTES)
            ctx, res = serve(idx, args.seed, by_path, http=False, path="hybrid",
                             must_launch=("topk", "adc_topk"), kept=kept)
            st = res["scan_stats_batch256_np16"]
            info["cold_share_of_live_slots_np16"] = st["cold_live_slots"] / (
                st["live_slots"] + st["cold_live_slots"])
            rows["adc_topk"]["hybrid_cold_tiles"] = tile_row(
                idx, ctx["q_sets"]["text"], 16, "adc_topk")
            emit({"phase": "hybrid", "hot_budget_bytes": HYBRID_HOT_BYTES, **info,
                  "nprobe": 16, "k": 10, **res, "seconds": time.perf_counter() - t})
            del idx, ctx
            release()

        if kept is not None and "host" in phases:
            t = time.perf_counter()
            idx, info = open_storage(art, "host")
            ctx, res = serve(idx, args.seed, by_path, http=False, path="host",
                             must_launch=("topk", "adc_topk"), kept=kept, batch16=True)
            rows["adc_topk"]["host_tiles"] = tile_row(idx, ctx["q_sets"]["text"], 16,
                                                      "adc_topk")
            emit({"phase": "host", **info, "nprobe": 16, "k": 10, **res,
                  "seconds": time.perf_counter() - t})
            del idx, ctx
            release()

        if "legacy" in phases:
            t = time.perf_counter()
            idx = open_index(art, args.n_rows, args.seed, "legacy_index", transposed=False)
            ctx, res = serve(idx, args.seed, by_path, http=False, path="legacy",
                             must_launch=("topk", "adc_kernel_packed4"))
            rows["adc_kernel_packed4"] = raw_scan_row(idx, ctx["q_sets"]["text"], 16,
                                                      "adc_kernel_packed4")
            del idx, ctx
            release()
            idx = open_index(art, PQ8["n_rows"], args.seed + 3, "legacy_pq8_index",
                             n_lists=PQ8["n_lists"], pq_m=PQ8["pq_m"],
                             pq_nbits=PQ8["pq_nbits"], transposed=False)
            ctx, res8 = serve(idx, args.seed, by_path, http=False, path="legacy_pq8",
                              must_launch=("topk", "adc_kernel"))
            rows["adc_kernel"] = raw_scan_row(idx, ctx["q_sets"]["text"], 16, "adc_kernel")
            kept8 = keep_results(idx, ctx["q_sets"])
            del idx, ctx
            release()
            emit({"phase": "legacy", "nprobe": 16, "k": 10, "pq128x4_rows": res,
                  "pq64x8_rows": res8, "seconds": time.perf_counter() - t})
            if "host" in phases:
                t = time.perf_counter()
                idx, info = open_storage(art, "host")
                ctx, res = serve(idx, args.seed, by_path, http=False, path="host_pq8",
                                 must_launch=("topk", "adc_kernel"), kept=kept8,
                                 batch16=True)
                rows["adc_kernel"]["host_pq8_tiles"] = tile_row(
                    idx, ctx["q_sets"]["text"], 16, "adc_kernel")
                emit({"phase": "host_pq8", **info, "nprobe": 16, "k": 10, **res,
                      "seconds": time.perf_counter() - t})
                del idx, ctx
                release()
    finally:
        shutil.rmtree(art, ignore_errors=True)

    if set(KERNELS) <= set(rows):
        emit({"kernels": kernels_line(rows, by_path)})
    elif {"kernels", "flat", "index", "serve", "hybrid", "host", "legacy"} <= phases:
        raise AssertionError(f"kernel rows missing: {set(KERNELS) - set(rows)}")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
