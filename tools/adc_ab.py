#!/usr/bin/env python3
"""Time the ADC kernels of this tree against another tree's, on one card.

    python3 tools/adc_ab.py --parent DIR [--seed 0] [--serve N_ROWS]
                            [--ptxas] [--phases] [--sass DIR]

DIR is a checkout of another commit (``git archive`` unpacked). Each
tree's kernels are called through its own wrappers,
``abstracts_search_tpu_torch.ops.adc.adc_topk`` and ``adc_scan``: this
tree's in this process, DIR's in a child process (this script run with
``--tree DIR``) that answers requests over a pipe. So the A/B needs
nothing of either tree's C interface, and each tree builds its own
kernels into its own ``build/kernels``. Both processes make the same
inputs on the card from the seed: 2 GiB of random codes (131,072
segments, far past the 50 MB L2), read as transposed [64, 256] or
row-major [256, 64] tiles, with slots query-major over 256 queries:

- kernel 3 (fused scan + top-10) and kernel 5 (row-major packed scan) at
  the serve cell's shape: 51,642 slots of PQ128x4 (80% of slots full);
- kernel 4 (transposed raw scan) at 8,192 and 51,642 PQ128x4 slots;
- kernel 6 (row-major byte-code scan) at the legacy PQ64x8 path's shape:
  10,177 slots with a 64 KiB LUT;
- kernels 3 and 4 at PQ64x8 transposed, 8,192 slots.

Each case is timed in turns (parent, change, change, parent): the median
of 20 CUDA-event timings, and the kernels' device time under
torch.profiler. Both trees' outputs must equal the plain version's bit
for bit (compared by digest). ``--serve N_ROWS`` writes the serve cell's
index (``chip_smoke.write_index``) once, loads it in both processes with
each tree's ``IVFPQIndex.load`` and ``SearchEngine``, and times
batch-256 QPS and single-query p50 (host clock) in three rounds of turns.

The rest runs this tree's kernels alone, through its own C interface:
kernel 6's plan beside one LUT buffer with 13 warps and two buffers with
12 warps of 2 stages; ``--ptxas``: nvcc's register and spill report and
SASS counts by mnemonic family; ``--phases``: a -DADC_PHASES build, the
clock64 cycles the consumer warps spent waiting for chunks, waiting for
the LUT, summing, and selecting or storing, as shares of their total
(kernel 6 also with every slot on one query, so that its LUT loads once
per block), then kernel 6 over codes laid out so that a warp's 32
lookups take 1 (equal codes, or 32 banks), ~3.15 (random) and 8 (8 codes
in one bank) shared-memory wavefronts, from which a linear fit gives the
clocks per wavefront; ``--sass DIR``: both libraries' SASS written there.
Prints one JSON line and the card's nvidia-smi line.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (imports numpy and torch only)

N_SEGS, QN, MB, SEG, KP = 131_072, 256, 64, 256, 10
N_SLOTS, K4_SLOTS, PQ8_SLOTS = 51_642, 8_192, 10_177
PQ4, PQ8 = (128, 16), (64, 256)          # (M, ksub): nibble-packed, a code a byte
NAMES = ("adc_",)                        # every ADC kernel of either tree
TEXTS = [f"semantic search query number {i} about topic {i % 97}" for i in range(256)]
vp, i32 = ctypes.c_void_p, ctypes.c_int


class Trial:
    """One tree's ADC wrappers over the A/B's inputs, made on the card
    from the seed (the same in every process)."""

    def __init__(self, seed: int):
        from abstracts_search_tpu_torch.ops import _build, adc

        _build.build_all()
        self.adc = adc
        dev = "cuda"
        g = torch.Generator(device=dev).manual_seed(seed)
        codes = torch.randint(0, 256, (N_SEGS, MB * SEG), dtype=torch.uint8, device=dev,
                              generator=g)
        self.cols, self.rows = codes.view(N_SEGS, MB, SEG), codes.view(N_SEGS, SEG, MB)
        self.luts = {pq: torch.randn((QN, *pq), device=dev, generator=g) for pq in (PQ4, PQ8)}
        self.slots = {}
        for n in (N_SLOTS, K4_SLOTS, PQ8_SLOTS):
            seg_ids = torch.randint(0, N_SEGS, (n,), dtype=torch.int32, device=dev, generator=g)
            self.slots[n] = seg_ids, (torch.arange(n, device=dev) * QN // n).int()
        full = torch.rand((N_SLOTS,), device=dev, generator=g) < 0.8
        self.valid = torch.where(full, SEG, torch.randint(0, SEG + 1, (N_SLOTS,), device=dev,
                                                          generator=g)).int()

        def topk(pq, n):
            return lambda impl: adc.adc_topk(self.cols, self.luts[pq], *self.slots[n],
                                             self.valid[:n], KP, impl=impl)

        def scan(pq, n, transposed):
            return lambda impl: (adc.adc_scan(self.cols if transposed else self.rows,
                                              self.luts[pq], *self.slots[n],
                                              transposed=transposed, impl=impl),)

        self.cases = {"kernel3_adc_topk": topk(PQ4, N_SLOTS),
                      "kernel3_adc_topk_pq64x8": topk(PQ8, K4_SLOTS),
                      "kernel4_cols_8192": scan(PQ4, K4_SLOTS, True),
                      "kernel4_cols_51642": scan(PQ4, N_SLOTS, True),
                      "kernel4_cols_pq64x8": scan(PQ8, K4_SLOTS, True),
                      "kernel5_rows_packed": scan(PQ4, N_SLOTS, False),
                      "kernel6_rows_bytes": scan(PQ8, PQ8_SLOTS, False)}

    def call(self, op: str, *args):
        return getattr(self, op)(*args)

    def digest(self, case: str, impl: str = "cuda") -> str:
        h = hashlib.sha256()
        for t in self.cases[case](impl):
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()

    def time(self, case: str) -> dict:
        run = lambda: self.cases[case]("cuda")  # noqa: E731
        return {"ms": cs.cuda_ms(run), "device_ms": cs.device_ms(run, NAMES)}

    def open_engine(self, art: str) -> bool:
        from abstracts_search_tpu_torch.index.ivfpq import IVFPQIndex
        from abstracts_search_tpu_torch.models.registry import HashEmbedder
        from abstracts_search_tpu_torch.serve.engine import SearchEngine

        emb = HashEmbedder(cs.DIM)
        self.engine = SearchEngine(IVFPQIndex.load(art), cs._LazyIds(), emb, nprobe=16)
        self.q_text = emb.queries(TEXTS)
        return True

    def serve_times(self) -> dict:
        return cs.engine_times(
            self.engine, lambda s: self.engine.search_batch_encoded(self.q_text[s], 10), TEXTS)


class Remote:
    """A Trial of another tree in a child process, one JSON request and
    one JSON reply a line."""

    def __init__(self, tree: Path, seed: int):
        self.tree = tree
        self.p = subprocess.Popen([sys.executable, __file__, "--tree", str(tree), "--seed",
                                   str(seed)],
                                  stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def recv(self):
        line = self.p.stdout.readline()
        if not line:
            raise RuntimeError(f"the process of {self.tree} ended (rc {self.p.wait()})")
        return json.loads(line)

    def send(self, op: str, *args) -> None:
        self.p.stdin.write(json.dumps({"op": op, "args": list(args)}) + "\n")
        self.p.stdin.flush()

    def call(self, op: str, *args):
        self.send(op, *args)
        return self.recv()

    def close(self) -> None:
        if self.p.poll() is None:
            self.p.stdin.close()
            try:
                self.p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.p.kill()
                self.p.wait()


def child(tree: Path, seed: int) -> int:
    """Answer requests for a Trial of ``tree``'s own package."""
    reply = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)                    # whatever else prints goes to stderr
    sys.path.insert(0, str(tree.resolve()))
    trial = Trial(seed)
    if not Path(trial.adc.__file__).resolve().is_relative_to(tree.resolve()):
        raise RuntimeError(f"imported {trial.adc.__file__}, not {tree}'s package")
    reply.write(json.dumps(True) + "\n")
    reply.flush()
    for line in sys.stdin:
        req = json.loads(line)
        reply.write(json.dumps(trial.call(req["op"], *req["args"])) + "\n")
        reply.flush()
    return 0


# -- this tree alone, through its C interface ---------------------------------------------


def nvcc(csrc: Path, name: str, out: Path, *flags: str) -> subprocess.Popen:
    """Start one nvcc of csrc/<name>.cu into out/<name>.so."""
    from abstracts_search_tpu_torch.ops import _build

    out.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I", str(csrc), "-o",
                             str(out / f"{name}.so"), str(csrc / f"{name}.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def start(out: Path, *flags: str) -> dict:
    from abstracts_search_tpu_torch.ops import _build

    return {name: (nvcc(_build.CSRC, name, out, *flags), out / f"{name}.so")
            for name in ("adc_topk", "adc_scan")}


def load(procs: dict) -> dict:
    """Wait for nvcc runs {name: (Popen, so path)} -> {name: CDLL}."""
    libs = {}
    for name, (p, so) in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{so} failed to build:\n{err}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def type_libs(libs: dict) -> None:
    libs["adc_topk"].adc_topk_launch.argtypes = [vp] * 5 + [i32] * 13 + [vp] * 4
    libs["adc_scan"].adc_cols_launch.argtypes = [vp] * 4 + [i32] * 12 + [vp] * 2
    libs["adc_scan"].adc_rows_launch.argtypes = [vp] * 4 + [i32] * 11 + [vp] * 2


def ptxas_report(procs: dict) -> dict:
    """Registers and spills per kernel (nvcc -Xptxas -v), and SASS lines
    of both libraries by mnemonic family."""
    from abstracts_search_tpu_torch.ops import _build

    rep = {}
    for name, (p, _) in procs.items():
        log = p.communicate()[1]
        rep[name] = [ln.strip() for ln in log.splitlines()
                     if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in ("adc_topk", "adc_scan"):
        sass = subprocess.run([tool, "-sass", _build.library(name)._name], capture_output=True,
                              text=True).stdout
        ops = re.findall(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", sass)
        rep[f"{name}_sass"] = {k: sum(1 for o in ops if o.startswith(k))
                               for k in ("UBLKCP", "SYNCS", "LDS", "SHFL", "FADD", "PRMT")}
    return rep


def run_phases(lib, read: str, launch: str, args, names) -> dict:
    """One launch of a -DADC_PHASES build: each phase's share of the
    consumer warps' cycles, and their total."""
    buf = (ctypes.c_ulonglong * 8)()
    getattr(lib, read)(buf)                       # zero
    assert getattr(lib, launch)(*args) == 0
    torch.cuda.synchronize()
    assert getattr(lib, read)(buf) == 0
    tot = sum(buf[:len(names)])
    return {**{n: buf[j] / tot for j, n in enumerate(names)}, "cycles": tot}


def wavefronts(tiles: torch.Tensor, g, samples: int = 1024) -> float:
    """Mean shared-memory wavefronts of a warp's 32 byte lookups over
    row-major [n, SEG, MB] byte tiles: lanes read byte j of 32
    neighbouring rows; a lookup takes as many wavefronts as the most
    distinct codes that share a bank (code mod 32)."""
    t = tiles[torch.randint(0, tiles.shape[0], (samples,), device="cuda", generator=g)]
    grp = t.view(samples, SEG // 32, 32, tiles.shape[2]).permute(0, 1, 3, 2).reshape(-1, 32)
    present = torch.zeros((grp.shape[0], 256), dtype=torch.int32, device="cuda")
    present.scatter_(1, grp.long(), 1)
    return float(present.view(-1, 8, 32).sum(1).max(1).values.float().mean())


def kernel6_plans(cur: Trial, sms: int) -> dict:
    """Kernel 6 under its own plan and two others: (warps, stages, LUT
    buffers), in two turns."""
    adc, lib = cur.adc, cur.adc._scan_lib()
    sid, qid = cur.slots[PQ8_SLOTS]
    luts = cur.luts[PQ8]
    ref = cur.cases["kernel6_rows_bytes"]("cuda")[0]

    def launch(warps, depth, n_luts):
        assert adc._stage_smem(warps, depth, 64 * MB, 4 * PQ8[0] * PQ8[1],
                               n_luts) <= adc._SMEM_LIMIT

        def run():
            out = torch.empty((PQ8_SLOTS, SEG), device="cuda")
            err = lib.adc_rows_launch(cur.rows.data_ptr(), luts.data_ptr(), sid.data_ptr(),
                                      qid.data_ptr(), PQ8_SLOTS, MB, SEG, PQ8[0], PQ8[1], 0,
                                      warps, depth, 64, n_luts, sms, out.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
            return out
        return run

    p8 = adc._adc_plan("rows", MB, SEG, *PQ8, PQ8_SLOTS, sms)
    variants = {"default": (p8.warps, p8.depth, p8.n_luts), "one_buffer": (13, 3, 1),
                "two_buffers_depth2": (12, 2, 2)}
    runs = {k: launch(*v) for k, v in variants.items()}
    for k, run in runs.items():
        if not torch.equal(run(), ref):
            raise AssertionError(f"kernel 6 under the {k} plan disagrees")
    res = {k: {"plan": v, "ms": [], "device_ms": []} for k, v in variants.items()}
    for turn in (list(runs), list(runs)[::-1]):
        for k in turn:
            res[k]["ms"].append(cs.cuda_ms(runs[k]))
            res[k]["device_ms"].append(cs.device_ms(runs[k], NAMES))
    return res


def phases(cur: Trial, procs: dict, sms: int, seed: int) -> dict:
    adc = cur.adc
    ph = load(procs)
    type_libs(ph)
    ph["adc_topk"].adc_topk_phases.argtypes = [vp]
    ph["adc_scan"].adc_scan_phases.argtypes = [vp]
    stream = torch.cuda.current_stream().cuda_stream
    plan = lambda kind, pq, n: adc._adc_plan(kind, MB, SEG, *pq, n, sms)  # noqa: E731
    pt, pc = plan("topk", PQ4, N_SLOTS), plan("cols", PQ4, N_SLOTS)
    pr, p8 = plan("rows", PQ4, N_SLOTS), plan("rows", PQ8, PQ8_SLOTS)
    sid, qid = cur.slots[N_SLOTS]
    sid8, qid8 = cur.slots[PQ8_SLOTS]
    l4, l8 = cur.luts[PQ4], cur.luts[PQ8]
    ov = torch.empty((N_SLOTS, KP), device="cuda")
    oi = torch.empty((N_SLOTS, KP), dtype=torch.int32, device="cuda")
    big = torch.empty((N_SLOTS, SEG), device="cuda")
    ring = lambda p: (p.warps, p.depth, p.chunk, p.n_luts, p.grid)  # noqa: E731
    out = {"kernel3_adc_topk": run_phases(
        ph["adc_topk"], "adc_topk_phases", "adc_topk_launch",
        (cur.cols.data_ptr(), l4.data_ptr(), sid.data_ptr(), qid.data_ptr(),
         cur.valid.data_ptr(), N_SLOTS, MB, SEG, *PQ4, 1, KP, pt.rows, *ring(pt), None,
         ov.data_ptr(), oi.data_ptr(), stream), ("chunk_wait", "lut_wait", "sums", "selection"))}
    ref = cur.cases["kernel3_adc_topk"]("cuda")
    if not (torch.equal(ov, ref[0]) and torch.equal(oi, ref[1])):
        raise AssertionError("the phase-counter build of kernel 3 disagrees")
    out["kernel4_cols"] = run_phases(
        ph["adc_scan"], "adc_scan_phases", "adc_cols_launch",
        (cur.cols.data_ptr(), l4.data_ptr(), sid.data_ptr(), qid.data_ptr(),
         N_SLOTS, MB, SEG, *PQ4, 1, pc.rows, *ring(pc), big.data_ptr(), stream),
        ("chunk_wait", "lut_wait", "sums", "stores"))
    out["kernel5_rows_packed"] = run_phases(
        ph["adc_scan"], "adc_scan_phases", "adc_rows_launch",
        (cur.rows.data_ptr(), l4.data_ptr(), sid.data_ptr(), qid.data_ptr(),
         N_SLOTS, MB, SEG, *PQ4, 1, *ring(pr), big.data_ptr(), stream),
        ("chunk_wait", "lut_wait", "sums"))

    def k6_phases(codes, s, q):
        return run_phases(
            ph["adc_scan"], "adc_scan_phases", "adc_rows_launch",
            (codes.data_ptr(), l8.data_ptr(), s.data_ptr(), q.data_ptr(),
             PQ8_SLOTS, MB, SEG, *PQ8, 0, *ring(p8), big.data_ptr(), stream),
            ("chunk_wait", "lut_wait", "sums"))

    out["kernel6_rows_bytes"] = k6_phases(cur.rows, sid8, qid8)
    # every slot of one query: a block loads its LUT once, at launch
    out["kernel6_one_query"] = k6_phases(cur.rows, sid8, torch.zeros_like(qid8))
    # kernel 6 over codes whose warp lookups take known wavefronts
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    n_pat = 16_384       # 256 MiB of tiles per pattern
    seg_pat = sid8 % n_pat
    t = torch.arange(n_pat, device="cuda")[:, None, None]
    r = torch.arange(SEG, device="cuda")[None, :, None]
    j = torch.arange(MB, device="cuda")[None, None, :]
    patterns = {"equal_codes": lambda: (t + j) % 256 + 0 * r,
                "32_banks": lambda: r % 32 + 32 * ((t + j) % 8),
                "random": lambda: torch.randint(0, 256, (n_pat, SEG, MB), device="cuda",
                                                generator=g),
                "8_in_one_bank": lambda: 32 * (r % 8) + (t + j) % 32}
    lookups_per_block = PQ8_SLOTS * SEG * PQ8[0] / 32 / p8.grid
    sweep = {}
    for name, make in patterns.items():
        codes = make().to(torch.uint8).contiguous()
        run = lambda impl: adc.adc_scan(codes, l8, seg_pat, qid8,  # noqa: E731
                                        transposed=False, impl=impl)
        if not torch.equal(run("cuda"), run("torch")):
            raise AssertionError(f"kernel 6 disagrees on the {name} codes")
        c = k6_phases(codes, seg_pat, qid8)
        cycles_per_warp = c["cycles"] / (p8.grid * p8.warps)
        sweep[name] = {"wavefronts_per_lookup": wavefronts(codes, g),
                       "ms": cs.cuda_ms(lambda: run("cuda")),
                       "device_ms": cs.device_ms(lambda: run("cuda"), NAMES),
                       "sums_share": c["sums"], "cycles_per_warp": cycles_per_warp,
                       "clk_per_warp_lookup": cycles_per_warp / lookups_per_block}
        del codes
    x = torch.tensor([v["wavefronts_per_lookup"] for v in sweep.values()], dtype=torch.float64)
    y = torch.tensor([v["clk_per_warp_lookup"] for v in sweep.values()], dtype=torch.float64)
    slope = float(((x - x.mean()) * (y - y.mean())).sum() / ((x - x.mean()) ** 2).sum())
    out["kernel6_bank_sweep"] = {**sweep, "clk_per_wavefront": slope,
                                 "clk_at_zero_wavefronts": float(y.mean() - slope * x.mean())}
    for key, p in (("kernel3_adc_topk", pt), ("kernel4_cols", pc), ("kernel5_rows_packed", pr),
                   ("kernel6_rows_bytes", p8), ("kernel6_one_query", p8)):
        out[key]["cycles_per_warp"] = out[key].pop("cycles") / (p.grid * p.warps)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--serve", type=int, default=0, metavar="N_ROWS")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--sass", type=Path)
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("adc_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.tree:
        return child(args.tree, args.seed)
    if args.parent is None:
        ap.error("--parent DIR is required")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    par = Remote(args.parent, args.seed)        # builds and makes its inputs meanwhile
    try:
        build = ROOT / "build"
        phase_procs = start(build / "ab_phases", "-DADC_PHASES") if args.phases else None
        ptxas_procs = start(build / "ab_ptxas", "-Xptxas", "-v") if args.ptxas else None
        cur = Trial(args.seed)
        par.recv()
        adc = cur.adc
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        plan = lambda kind, pq, n: adc._adc_plan(kind, MB, SEG, *pq, n, sms)._asdict()  # noqa
        res = {"card": smi, "parent": str(args.parent), "segments": N_SEGS,
               "plans": {"topk": plan("topk", PQ4, N_SLOTS), "cols": plan("cols", PQ4, N_SLOTS),
                         "topk_pq64x8": plan("topk", PQ8, K4_SLOTS),
                         "cols_pq64x8": plan("cols", PQ8, K4_SLOTS),
                         "rows_packed": plan("rows", PQ4, N_SLOTS),
                         "rows_bytes": plan("rows", PQ8, PQ8_SLOTS)}}
        for case in cur.cases:
            want = cur.digest(case, "torch")
            equal = cur.digest(case) == want and par.call("digest", case) == want
            res[case] = {"bit_equal_to_plain_both": equal}
            if not equal:
                print(json.dumps(res), flush=True)
                raise AssertionError(f"{case}: a kernel disagrees with the plain version")
            t = [side.call("time", case) for side in (par, cur, cur, par)]
            res[case].update({"parent_ms": [t[0]["ms"], t[3]["ms"]],
                              "ms": [t[1]["ms"], t[2]["ms"]],
                              "parent_device_ms": [t[0]["device_ms"], t[3]["device_ms"]],
                              "device_ms": [t[1]["device_ms"], t[2]["device_ms"]]})
        res["kernel6_plans"] = kernel6_plans(cur, sms)

        if args.serve:
            art = build / "ab_index"
            try:
                cs.write_index(art, args.serve, args.seed)
                par.send("open_engine", str(art))      # both load at once
                cur.open_engine(str(art))
                par.recv()
                turns = [par, cur, cur, par] * 3
                times = [side.call("serve_times") for side in turns]
                res["serve"] = {"n_rows": args.serve, "nprobe": 16, "k": 10,
                                "parent": [x for x, s in zip(times, turns) if s is par],
                                "change": [x for x, s in zip(times, turns) if s is cur]}
            finally:
                shutil.rmtree(art, ignore_errors=True)
    finally:
        par.close()

    if args.ptxas:
        res["ptxas"] = ptxas_report(ptxas_procs)
    if args.phases:
        res["phases"] = phases(cur, phase_procs, sms, args.seed)
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
