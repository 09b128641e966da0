#!/usr/bin/env python3
"""Time the staged ADC kernels against an earlier tree's, on one card.

    python3 tools/adc_ab.py --parent DIR [--seed 0] [--ptxas] [--phases]
                            [--sass DIR]

DIR is a checkout of an earlier commit (``git archive`` unpacked), whose
``abstracts_search_tpu_torch/csrc/adc_topk.cu`` and ``adc_scan.cu`` still
have the unstaged launchers (one thread per row, ``slots_per_block``).
Both trees' kernels run on the same synthetic inputs of the serve cell's
shape: 51,642 slots of 256 queries (query-major, ~202 slots each) over
131,072 random segments of PQ128x4 codes (2 GiB per layout, far past the
50 MB L2), 80% of slots full. Kernel 3 (fused scan + top-10) reads the
transposed [64, 256] tiles, kernel 5 (row-major packed scan) the [256,
64] ones. Each pair is timed in turns (parent, change, change, parent; the
median of 20 CUDA-event timings each), the outputs compared bit for bit
with each other and with the plain version. ``--ptxas`` also prints
nvcc's register and spill report for both sources, and the bulk-copy
(UBLKCP) and mbarrier lines in the fused scan's SASS. ``--phases`` builds
both sources again with -DADC_PHASES and runs each staged kernel once
more: the clock64 cycles its consumer warps spent waiting for chunks,
waiting for the LUT, summing and selecting, as shares of their total.
``--sass DIR`` writes both libraries' SASS there. Prints one JSON line and
the card's nvidia-smi line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import cuda_ms  # noqa: E402

N_SLOTS, QN, N_SEGS, MB, SEG, M, KP = 51_642, 256, 131_072, 64, 256, 128, 10


def build_parent(parent: Path) -> dict:
    from abstracts_search_tpu_torch.ops import _build

    out = ROOT / "build" / "ab_parent"
    out.mkdir(parents=True, exist_ok=True)
    csrc = parent / "abstracts_search_tpu_torch" / "csrc"
    libs, procs = {}, []
    for name in ("adc_topk", "adc_scan"):
        so = out / f"{name}.so"
        procs.append((name, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(so),
             str(csrc / f"{name}.cu")])))
    for name, so, p in procs:
        if p.wait() != 0:
            raise RuntimeError(f"parent {name}.cu failed to build")
        libs[name] = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    libs["adc_topk"].adc_topk_launch.argtypes = [vp] * 5 + [i] * 8 + [vp] * 3
    libs["adc_scan"].adc_scan_launch.argtypes = [vp] * 4 + [i] * 8 + [vp] * 2
    return libs


def ptxas_report() -> dict:
    """Registers and spills per kernel (nvcc -Xptxas -v), and the fused
    scan's SASS lines by mnemonic family."""
    from abstracts_search_tpu_torch.ops import _build

    rep = {}
    for name in ("adc_topk", "adc_scan"):
        src = _build.CSRC / f"{name}.cu"
        log = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                              str(_build.CSRC), "-o", "/dev/null", str(src)],
                             capture_output=True, text=True).stderr
        rep[name] = [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln]
    lib = _build.library("adc_topk")._name
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True).stdout
    ops = re.findall(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", sass)
    rep["adc_topk_sass"] = {k: sum(1 for o in ops if o.startswith(k))
                            for k in ("UBLKCP", "SYNCS", "LDS", "SHFL", "FADD")}
    return rep


def phase_shares(args_topk, args_rows) -> dict:
    """Run each staged kernel once from a -DADC_PHASES build: the share of
    its consumer warps' cycles in each phase."""
    from abstracts_search_tpu_torch.ops import _build

    out = ROOT / "build" / "ab_phases"
    out.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name in ("adc_topk", "adc_scan"):
        so = out / f"{name}.so"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DADC_PHASES", "-I",
                        str(_build.CSRC), "-o", str(so), str(_build.CSRC / f"{name}.cu")],
                       check=True)
        libs[name] = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    libs["adc_topk"].adc_topk_launch.argtypes = [vp] * 5 + [i] * 13 + [vp] * 4
    libs["adc_scan"].adc_rows_packed_launch.argtypes = [vp] * 4 + [i] * 9 + [vp] * 2
    res = {}
    for key, lib, launch, read, names, a in (
            ("kernel3_adc_topk", libs["adc_topk"], "adc_topk_launch", "adc_topk_phases",
             ("chunk_wait", "lut_wait", "sums", "selection"), args_topk),
            ("kernel5_rows_packed", libs["adc_scan"], "adc_rows_packed_launch",
             "adc_scan_phases", ("chunk_wait", "lut_wait", "sums"), args_rows)):
        buf = (ctypes.c_ulonglong * 8)()
        getattr(lib, read)(buf)                       # zero
        assert getattr(lib, launch)(*a) == 0
        torch.cuda.synchronize()
        assert getattr(lib, read)(buf) == 0
        tot = sum(buf[:len(names)])
        res[key] = {n: buf[j] / tot for j, n in enumerate(names)}
        res[key]["cycles_per_warp"] = tot
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--sass", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("adc_ab: no CUDA device", file=sys.stderr)
        return 2
    from abstracts_search_tpu_torch.ops import adc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    old = build_parent(args.parent)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    codes_t = torch.randint(0, 256, (N_SEGS, MB, SEG), dtype=torch.uint8, device="cuda",
                            generator=g)
    codes_r = torch.randint(0, 256, (N_SEGS, SEG, MB), dtype=torch.uint8, device="cuda",
                            generator=g)
    luts = torch.randn((QN, M, 16), device="cuda", generator=g)
    seg_ids = torch.randint(0, N_SEGS, (N_SLOTS,), dtype=torch.int32, device="cuda",
                            generator=g)
    q_ids = (torch.arange(N_SLOTS, device="cuda") * QN // N_SLOTS).int()
    full = torch.rand((N_SLOTS,), device="cuda", generator=g) < 0.8
    valid = torch.where(full, SEG, torch.randint(0, SEG + 1, (N_SLOTS,), device="cuda",
                                                 generator=g)).int()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def parent_topk():
        ov = torch.empty((N_SLOTS, KP), device="cuda")
        oi = torch.empty((N_SLOTS, KP), dtype=torch.int32, device="cuda")
        err = old["adc_topk"].adc_topk_launch(
            codes_t.data_ptr(), luts.data_ptr(), seg_ids.data_ptr(), q_ids.data_ptr(),
            valid.data_ptr(), N_SLOTS, MB, SEG, M, 16, 1, KP, max(1, N_SLOTS // (sms * 16)),
            ov.data_ptr(), oi.data_ptr(), stream())
        assert err == 0, err
        return ov, oi

    def parent_rows():
        out = torch.empty((N_SLOTS, SEG), device="cuda")
        per_sm = max(1, min(16, 232_448 // (4 * M * 16)))
        err = old["adc_scan"].adc_scan_launch(
            codes_r.data_ptr(), luts.data_ptr(), seg_ids.data_ptr(), q_ids.data_ptr(),
            N_SLOTS, MB, SEG, M, 16, 1, 0, max(1, N_SLOTS // (sms * per_sm)), out.data_ptr(),
            stream())
        assert err == 0, err
        return out

    new_topk = lambda: adc.adc_topk(codes_t, luts, seg_ids, q_ids, valid, KP,  # noqa: E731
                                    impl="cuda")
    new_rows = lambda: adc.adc_scan(codes_r, luts, seg_ids, q_ids,  # noqa: E731
                                    transposed=False, impl="cuda")
    res = {"card": smi, "slots": N_SLOTS, "segments": N_SEGS,
           "plan_topk": adc._launch_plan("topk", codes_t, MB, SEG, M, 16, N_SLOTS)._asdict(),
           "plan_rows": adc._launch_plan("rows", codes_r, MB, SEG, M, 16, N_SLOTS)._asdict()}
    pv, pi = adc.adc_topk(codes_t, luts, seg_ids, q_ids, valid, KP, impl="torch")
    for key, new, par, plain in (
            ("kernel3_adc_topk", new_topk, parent_topk, (pv, pi)),
            ("kernel5_rows_packed", new_rows, parent_rows,
             (adc.adc_scan(codes_r, luts, seg_ids, q_ids, transposed=False, impl="torch"),))):
        got, was = new(), par()
        got = got if isinstance(got, tuple) else (got,)
        was = was if isinstance(was, tuple) else (was,)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(got, plain)) and \
            all(torch.equal(a, b) for a, b in zip(was, plain))
        times = [cuda_ms(f) for f in (par, new, new, par)]
        res[key] = {"bit_equal_to_plain_both": equal, "parent_ms": [times[0], times[3]],
                    "ms": [times[1], times[2]]}
        if not equal:
            print(json.dumps(res), flush=True)
            raise AssertionError(f"{key}: a kernel disagrees with the plain version")
    if args.ptxas:
        res["ptxas"] = ptxas_report()
    if args.phases:
        pt, pr = res["plan_topk"], res["plan_rows"]
        ov = torch.empty((N_SLOTS, KP), device="cuda")
        oi = torch.empty((N_SLOTS, KP), dtype=torch.int32, device="cuda")
        out = torch.empty((N_SLOTS, SEG), device="cuda")
        res["phases"] = phase_shares(
            (codes_t.data_ptr(), luts.data_ptr(), seg_ids.data_ptr(), q_ids.data_ptr(),
             valid.data_ptr(), N_SLOTS, MB, SEG, M, 16, 1, KP, pt["rows"], pt["warps"],
             pt["depth"], pt["chunk"], pt["n_luts"], pt["grid"], None, ov.data_ptr(),
             oi.data_ptr(), stream()),
            (codes_r.data_ptr(), luts.data_ptr(), seg_ids.data_ptr(), q_ids.data_ptr(),
             N_SLOTS, MB, SEG, M, pr["warps"], pr["depth"], pr["chunk"], pr["n_luts"],
             pr["grid"], out.data_ptr(), stream()))
        for key in res["phases"]:
            plan = pt if key.startswith("kernel3") else pr
            res["phases"][key]["cycles_per_warp"] /= plan["grid"] * plan["warps"]
        if not (torch.equal(ov, pv) and torch.equal(oi, pi)):
            raise AssertionError("the phase-counter build of kernel 3 disagrees")
    if args.sass:
        from abstracts_search_tpu_torch.ops import _build

        args.sass.mkdir(parents=True, exist_ok=True)
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        for name in ("adc_topk", "adc_scan"):
            (args.sass / f"{name}.sass").write_text(subprocess.run(
                [tool, "-sass", _build.library(name)._name], capture_output=True,
                text=True).stdout)
    print(json.dumps(res), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
