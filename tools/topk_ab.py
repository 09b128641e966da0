#!/usr/bin/env python3
"""Time kernel 1 (the streaming top-k) of this tree against another
tree's, on one card.

    python3 tools/topk_ab.py --parent DIR [--seed 0] [--crossover]

DIR is a checkout of another commit (``git archive`` unpacked). Each
tree's kernel is called through its own wrapper,
``abstracts_search_tpu_torch.ops.topk.streaming_topk``: this tree's in
this process, DIR's in a child process (this script run with ``--tree
DIR``) that answers requests over a pipe, so each tree builds its own
kernels into its own ``build/kernels``. Both processes make the same
inputs on the card from the seed, at these shapes:

- ``build_k1``: the index build's assignment, Q 131,072 x 65,536 x 1,024
  bf16, k 1 (unit rows);
- ``ivf_flat_probe``: IVF-Flat's plain-L2 probe, Q 256 x 4,096 x 1,152
  f32 (1,024 dims, the bias column, zero padding), k 16;
- ``plain_l2_kmeans``: plain-L2 k-means' window, Q 262,144 x 4,096 x
  1,152 f32, k 1;
- ``probe_k16``, ``probe_k64``, ``probe_k256``: the IVF-PQ serve probe,
  Q 256 x 65,536 x 1,024 bf16 at nprobe 16, 64 and 256;
- ``oracle_k10``: tune's exact oracle, Q 256 x 131,072 x 1,024 bf16, k 10;
- ``flat_k10``, ``flat_k100``: flat search (FlatIndex, exact mode), Q 128
  x 2,097,152 x 1,024 bf16 at k 10 and the HTTP API's largest k, 100;
  ``flat_k10_fast``: the same at k 10 in fast mode, chunk 4,096 (kernel 2,
  bench.py's).

Each shape is first held against the plain version (``impl="torch"``) on
small integers with 64 distinct rows repeated, where every sum is exact
and ties are everywhere: both trees' (values, rows) must equal the plain
version's, compared by digest. On the real-valued inputs both trees'
rows must agree but for near-ties (f64 scores within 1e-5). Then each is
timed in turns (parent, change, change, parent): the median of CUDA-event
timings and the device time of the kernels under torch.profiler. Beside
them, this tree's plan, the bound, and the library call that computes the
same function (``torch.max(q @ x.T, 1)`` over 16,384-row sub-windows at
k 1, ``torch.topk(q @ x.T, k)`` otherwise; f32 with TF32 off).
``--crossover``: this tree alone, kernel 1 at k 1 over the 65,536
centroids at Q from 256 to 32,768 with the k-1 scan forced on and off
(``_K1_MIN_Q``), in turns. Prints one JSON line and the card's
nvidia-smi line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (imports numpy and torch only)

# kernel 1's functions in either tree
NAMES = ("range_kernel", "topk_merge_kernel", "topk_select_kernel")
SUB = 16_384                                      # library sub-window rows at k 1
# case -> (queries, rows, dims, valid dims, k, dtype)
SHAPES = {"build_k1": (131_072, 65_536, 1024, 1024, 1, torch.bfloat16),
          "ivf_flat_probe": (256, 4096, 1152, 1025, 16, torch.float32),
          "plain_l2_kmeans": (262_144, 4096, 1152, 1025, 1, torch.float32),
          "probe_k16": (256, 65_536, 1024, 1024, 16, torch.bfloat16),
          "probe_k64": (256, 65_536, 1024, 1024, 64, torch.bfloat16),
          "probe_k256": (256, 65_536, 1024, 1024, 256, torch.bfloat16),
          "oracle_k10": (256, 131_072, 1024, 1024, 10, torch.bfloat16),
          "flat_k10": (128, 2_097_152, 1024, 1024, 10, torch.bfloat16),
          "flat_k10_fast": (128, 2_097_152, 1024, 1024, 10, torch.bfloat16),
          "flat_k100": (128, 2_097_152, 1024, 1024, 100, torch.bfloat16)}
REPS = {"build_k1": 5, "ivf_flat_probe": 20, "plain_l2_kmeans": 3, "probe_k16": 20,
        "probe_k64": 20, "probe_k256": 20, "oracle_k10": 20, "flat_k10": 10,
        "flat_k10_fast": 10, "flat_k100": 10}
# case -> (mode, chunk): fast mode at bench.py's chunk, else exact
MODES = {"flat_k10_fast": ("fast", 4096)}


def make(case: str, g, ints: bool):
    """One shape's (q, x) on the card from the generator. Real-valued:
    unit rows (bf16), or the plain-L2 augmentation of Gaussian rows and
    centroids (f32). Integers: small values, 64 distinct rows repeated."""
    qn, n, d, dv, _, dtype = SHAPES[case]
    if ints:
        q = torch.randint(-3, 4, (qn, d), device="cuda", generator=g).to(dtype)
        x = torch.randint(-3, 4, (64, d), device="cuda", generator=g)[
            torch.randint(0, 64, (n,), device="cuda", generator=g)].to(dtype)
        return q.contiguous(), x.contiguous()
    if dtype == torch.bfloat16:
        return cs.unit_rows(qn, g), cs.unit_rows(n, g)
    xs = torch.randn((qn, dv - 1), device="cuda", generator=g)
    cents = torch.randn((n, dv - 1), device="cuda", generator=g)
    q = torch.zeros((qn, d), device="cuda")
    q[:, :dv - 1], q[:, dv - 1] = xs, 1.0
    x = torch.zeros((n, d), device="cuda")
    x[:, :dv - 1], x[:, dv - 1] = cents, -0.5 * (cents * cents).sum(1)
    return q, x


class Trial:
    """One tree's kernel 1 over the A/B's inputs, made on the card from
    the seed (the same in every process)."""

    def __init__(self, seed: int):
        from abstracts_search_tpu_torch.ops import _build, topk

        _build.build_all()
        self.topk = topk
        self.seed = seed
        self.inputs = {}

    def _inputs(self, case: str, ints: bool):
        key = (case, ints)
        if key not in self.inputs:
            self.inputs.clear()        # one shape on the card at a time
            torch.cuda.empty_cache()
            g = torch.Generator(device="cuda").manual_seed(self.seed + len(case) + ints)
            self.inputs[key] = make(case, g, ints)
        return self.inputs[key]

    def run(self, case: str, ints: bool = False, impl: str = "cuda"):
        q, x = self._inputs(case, ints)
        k = SHAPES[case][4]
        mode, chunk = MODES.get(case, ("exact", 1024))
        return self.topk.streaming_topk(q, x, x.shape[0], k, chunk=chunk, impl=impl, mode=mode)

    def call(self, op: str, *args):
        return getattr(self, op)(*args)

    def digest(self, case: str, ints: bool = True, impl: str = "cuda") -> str:
        h = hashlib.sha256()
        for t in self.run(case, ints, impl):
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()

    def rows(self, case: str) -> list:
        return self.run(case)[1].cpu().tolist()

    def time(self, case: str) -> dict:
        fn = lambda: self.run(case)  # noqa: E731
        return {"ms": cs.cuda_ms(fn, reps=REPS[case], warmup=1),
                "device_ms": cs.device_ms(fn, NAMES, reps=max(3, REPS[case] // 2))}


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

    def call(self, op: str, *args):
        self.p.stdin.write(json.dumps({"op": op, "args": list(args)}) + "\n")
        self.p.stdin.flush()
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
    if not Path(trial.topk.__file__).resolve().is_relative_to(tree.resolve()):
        raise RuntimeError(f"imported {trial.topk.__file__}, not {tree}'s package")
    reply.write(json.dumps(True) + "\n")
    reply.flush()
    for line in sys.stdin:
        req = json.loads(line)
        reply.write(json.dumps(trial.call(req["op"], *req["args"])) + "\n")
        reply.flush()
    return 0


def near_tie_rows(q, x, a: torch.Tensor, b: torch.Tensor, tol: float = 1e-5) -> dict:
    """Rows where two trees' index lists differ, and how many of them are
    not near-ties (their f64 scores on the operands more than ``tol``
    apart, sorted)."""
    bad = (a != b).any(dim=1).nonzero().flatten()
    far = 0
    for r in bad.tolist():
        qd = q[r].double()
        sa = (x[a[r].long()].double() @ qd).sort(descending=True).values
        sb = (x[b[r].long()].double() @ qd).sort(descending=True).values
        far += int((sa - sb).abs().max() > tol)
    return {"rows_differing": int(len(bad)), "not_near_ties": far}


def library_ms(case: str, q, x) -> float:
    k = SHAPES[case][4]
    if k == 1:
        def fn():
            for lo in range(0, q.shape[0], SUB):
                torch.max(q[lo:lo + SUB] @ x.T, 1)
    else:
        def fn():
            torch.topk(q @ x.T, k)
    return cs.cuda_ms(fn, reps=3 if k == 1 else 20, warmup=1)


def bound_of(case: str) -> tuple:
    """The least time: each input byte read once and each output written
    once, or the products of the valid dims at the type's peak."""
    qn, n, d, dv, k, dtype = SHAPES[case]
    size = 2 if dtype == torch.bfloat16 else 4
    return cs.bound((qn + n) * dv * size + qn * k * 8, 2 * qn * n * dv,
                    "bf16" if size == 2 else "f32")


def crossover(cur: Trial, seed: int) -> dict:
    """Kernel 1 at k 1 over 65,536 bf16 centroids, the k-1 scan forced on
    and off, in turns (off, on, on, off)."""
    topk = cur.topk
    g = torch.Generator(device="cuda").manual_seed(seed + 99)
    x = cs.unit_rows(65_536, g)
    saved, out = topk._K1_MIN_Q, {}
    try:
        for qn in (256, 512, 1024, 2048, 4096, 8192, 16_384, 32_768):
            q = cs.unit_rows(qn, g)
            fn = lambda: topk.streaming_topk(q, x, 65_536, 1, impl="cuda")  # noqa: E731
            res = {"k1_scan_ms": [], "wgmma_scan_ms": []}
            for on in (False, True, True, False):
                topk._K1_MIN_Q = 1 if on else 1 << 30
                topk._launch_plan.cache_clear()
                res["k1_scan_ms" if on else "wgmma_scan_ms"].append(cs.cuda_ms(fn))
            out[qn] = res
    finally:
        topk._K1_MIN_Q = saved
        topk._launch_plan.cache_clear()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--crossover", action="store_true")
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("topk_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.tree:
        return child(args.tree, args.seed)
    if args.parent is None:
        ap.error("--parent DIR is required")

    import abstracts_search_tpu_torch  # noqa: F401  (pins TF32 off)
    from abstracts_search_tpu_torch.device import assert_exact_f32
    from abstracts_search_tpu_torch.ops import _build

    assert_exact_f32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    par = Remote(args.parent, args.seed)        # builds meanwhile
    try:
        cur = Trial(args.seed)
        par.recv()
        topk = cur.topk
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        res = {"card": smi, "parent": str(args.parent),
               "ptxas": {fn: r for fn, r in _build.ptxas_report("topk").items()
                         if "4kone" in fn or "4simt" in fn}}
        for case, (qn, n, d, dv, k, dtype) in SHAPES.items():
            want = cur.digest(case, True, "torch")
            row = {"shape": [qn, n, d, k], "dtype": str(dtype).split(".")[-1],
                   "mode": MODES.get(case, ("exact",))[0],
                   "plan": topk._plan(qn, n, k, dtype, sms,
                                      fast=case in MODES)._asdict(),
                   "ints_equal_to_plain": {"change": cur.digest(case) == want,
                                           "parent": par.call("digest", case) == want}}
            res[case] = row
            if not all(row["ints_equal_to_plain"].values()):
                print(json.dumps(res), flush=True)
                raise AssertionError(f"{case}: a kernel disagrees with the plain version")
            q, x = cur._inputs(case, False)
            mine = cur.run(case)[1]
            theirs = torch.tensor(par.call("rows", case), device="cuda")
            # fast mode: truncated values tie within a step, not 1e-5
            row["parent_vs_change"] = near_tie_rows(q, x, mine, theirs,
                                                    1e-4 if case in MODES else 1e-5)
            if row["parent_vs_change"]["not_near_ties"]:
                print(json.dumps(res), flush=True)
                raise AssertionError(f"{case}: the trees disagree beyond near-ties")
            t = [side.call("time", case) for side in (par, cur, cur, par)]
            b, by = bound_of(case)
            row.update({"parent_ms": [t[0]["ms"], t[3]["ms"]], "ms": [t[1]["ms"], t[2]["ms"]],
                        "parent_device_ms": [t[0]["device_ms"], t[3]["device_ms"]],
                        "device_ms": [t[1]["device_ms"], t[2]["device_ms"]],
                        "merge_pass_device_ms": cs.device_ms(
                            lambda: cur.run(case), ("topk_merge_kernel", "topk_select_kernel"),
                            reps=3) if row["plan"]["n_ranges"] > 1 or k > 1 else 0.0,
                        "bound_ms": b, "bound_by": by,
                        "library_ms": library_ms(case, q, x)})
            print(json.dumps({case: row}), file=sys.stderr, flush=True)
    finally:
        par.close()
    if args.crossover:
        res["crossover"] = crossover(cur, args.seed)
    print(json.dumps(res), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
