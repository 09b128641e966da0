#!/usr/bin/env python3
"""Time the routes a host row group of the fill can take to the card, alone
and inside the fill cell's jobs, on one card.

    python3 tools/upload_ab.py [--seed 0] [--groups 16] [--rounds 3]
                               [--routes pageable,staged_16,...] [--out FILE]

Rates alone (no encode), over ``--groups`` host f32 row groups of the
fill cell's size (65,536 x 1,024, 256 MiB; made on the card and brought
down, so their pages exist), each the median of three passes:

- ``pageable``: ``torch.from_numpy(g).to("cuda")``, the route before the
  pinned staging;
- ``read_np``: the host's read of each group into pinned memory, numpy's
  copy split over t threads (``_copy_rows``), at t = 1, 2, 4, ... up to
  ``torch.get_num_threads()``; ``read_torch``: ``Tensor.copy_`` into a
  pinned view at ``torch.set_num_threads(t)``;
- ``pinned_dma``: a pinned group's copy to the card;
- ``registered``: ``cudaHostRegister`` of each group in place, its copy,
  ``cudaHostUnregister``, with each step's seconds;
- ``staged``: ``_RowStager.upload`` of every group, at each piece size
  from 8 to 128 MiB.

Fill jobs: the fill cell's job (``portbench``'s ``ivfpq_fill_delta``,
set up from the seed) in ``--rounds`` rounds of turns over the routes
of ``--routes``: ``pageable`` (no stager: the route before it),
``staged_<MiB>`` (the stager at that piece size) and ``registered``
(each group pinned in place, copied on the stager's stream and unpinned
once its copy has landed, inside the call). Each job's rows/s, its
``fill_stats`` and the card's memory peak, and after the jobs the pinned
host memory torch holds; every job's lists must equal the first's (a
digest). The rates run after the jobs (none at ``--groups 0``). Prints
one JSON line (``--out`` writes it to a file too) and the card's
nvidia-smi line.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from abstracts_search_tpu_torch.index import ivfpq as mod  # noqa: E402

GROUP = (65_536, 1024)
MiB = 1 << 20


def timed(fn) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def gbps(fn, nbytes: int, passes: int = 3) -> float:
    return nbytes / statistics.median(timed(fn) for _ in range(passes)) / 1e9


def check(err) -> None:
    if int(err) != 0:
        raise RuntimeError(f"CUDA runtime error {err}")


def upload_registered(self, x: np.ndarray) -> torch.Tensor:
    """``_RowStager.upload`` with the caller's rows pinned in place
    (``cudaHostRegister``) instead of read into pinned buffers, unpinned
    once their copy has landed, before the call returns."""
    w = self.last = (self.last + 1) % self.WINDOWS
    compute = torch.cuda.current_stream(self.device)
    if self.windows[w] is None or self.windows[w].numel() < x.size:
        self.windows[w] = torch.empty(x.size, dtype=torch.float32, device=self.device)
        self.free[w].record(compute)
    out = self.windows[w][:x.size].view(x.shape)
    self.stream.wait_event(self.free[w])
    cudart = torch.cuda.cudart()
    check(cudart.cudaHostRegister(x.ctypes.data, x.nbytes, 0))
    with torch.cuda.stream(self.stream):
        out.copy_(torch.from_numpy(x), non_blocking=True)
    done = torch.cuda.Event()
    done.record(self.stream)
    done.synchronize()
    check(cudart.cudaHostUnregister(x.ctypes.data))
    compute.wait_stream(self.stream)
    return out


@contextlib.contextmanager
def route(name: str):
    """The fill's host-row route ``name`` for the jobs inside."""
    saved = (mod.IVFPQIndex._row_stager, mod._RowStager.upload, mod._RowStager.PIECE_BYTES)
    try:
        if name == "pageable":
            mod.IVFPQIndex._row_stager = lambda self: None
        elif name == "registered":
            mod._RowStager.upload = upload_registered
        else:
            mod._RowStager.PIECE_BYTES = int(name.split("_")[1]) * MiB
        yield
    finally:
        mod.IVFPQIndex._row_stager, mod._RowStager.upload, mod._RowStager.PIECE_BYTES = saved


def rates(groups: list) -> dict:
    dev = torch.device("cuda")
    total = sum(g.nbytes for g in groups)
    out = {"pageable": gbps(lambda: [torch.from_numpy(g).to(dev) for g in groups], total)}
    pinned = torch.empty(GROUP, dtype=torch.float32, pin_memory=True)
    dst = pinned.numpy()
    threads = torch.get_num_threads()
    counts = sorted({t for t in (1, 2, 4, 6, 8, 12, 16) if t <= threads} | {threads})
    out["read_np"], out["read_torch"] = {}, {}
    for t in counts:
        with ThreadPoolExecutor(max(t - 1, 1)) as pool:
            out["read_np"][t] = gbps(lambda: [mod._copy_rows(dst, g, pool, t) for g in groups],
                                     total)
        torch.set_num_threads(t)
        out["read_torch"][t] = gbps(lambda: [pinned.copy_(torch.from_numpy(g)) for g in groups],
                                    total)
    torch.set_num_threads(threads)
    card = torch.empty(GROUP, dtype=torch.float32, device=dev)
    out["pinned_dma"] = gbps(lambda: [card.copy_(pinned, non_blocking=True) for _ in groups],
                             total)
    cudart = torch.cuda.cudart()
    steps = {"register_s": 0.0, "copy_s": 0.0, "unregister_s": 0.0}
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for g in groups:
        t0 = time.perf_counter()
        check(cudart.cudaHostRegister(g.ctypes.data, g.nbytes, 0))
        t1 = time.perf_counter()
        card.copy_(torch.from_numpy(g), non_blocking=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(cudart.cudaHostUnregister(g.ctypes.data))
        t3 = time.perf_counter()
        for k, s in zip(steps, (t1 - t0, t2 - t1, t3 - t2)):
            steps[k] += s
    out["registered"] = {"gbps": total / (time.perf_counter() - t_all) / 1e9, **steps}
    del card
    out["staged"] = {}
    for piece in (8, 16, 32, 64, 128):
        with route(f"staged_{piece}"):
            st = mod._RowStager(dev)

            def run():
                for g in groups:
                    st.upload(g)
                    st.used()

            out["staged"][piece] = gbps(run, total)
            st.release()
    return out


def digest(packed) -> str:
    h = hashlib.sha256()
    for f in ("data", "row_ids", "seg_cnt"):
        h.update(memoryview(np.ascontiguousarray(getattr(packed, f))).cast("B"))
    return h.hexdigest()[:16]


def jobs(seed: int, rounds: int, names: list) -> dict:
    from portbench import harness

    spec = harness.benchmark()
    work, config, traffic = harness.cell_files(spec, "ivfpq_fill_delta")
    cell = harness.driver(traffic["driver"]).Cell(config, traffic, seed=seed, device="cuda")
    t0 = time.perf_counter()
    cell.setup()
    setup_s = time.perf_counter() - t0
    out = {n: {"rows_per_s": [], "peak_bytes": []} for n in names}
    first = None
    for _ in range(rounds):
        for name in names:
            torch.cuda.reset_peak_memory_stats()
            with route(name):
                idx, secs = cell.job(cell.groups)
            got = out[name]
            got["rows_per_s"].append(idx.n / secs)
            got["peak_bytes"].append(torch.cuda.max_memory_allocated())
            got["stats"] = {k: v for k, v in idx.fill_stats.items()
                            if k.endswith("_s") or k in ("rows", "upload_pinned_rows")}
            d = digest(idx.packed)
            first = first or d
            if d != first:
                raise SystemExit(f"{name}: the lists differ from the first job's")
            del idx
    for got in out.values():
        got["median"] = statistics.median(got["rows_per_s"])
    stats = getattr(torch.cuda, "host_memory_stats", None)
    return {"setup_s": setup_s, "routes": out, "lists": first,
            "host_memory": stats() if stats else "not available"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--groups", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--routes", default="pageable,staged_16,staged_32,staged_64,registered")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("upload_ab: needs a CUDA card", file=sys.stderr)
        return 2
    from abstracts_search_tpu_torch.ops import _build

    _build.build_all()
    res = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "threads": torch.get_num_threads(), "cpus": len(os.sched_getaffinity(0)),
           "jobs": jobs(args.seed, args.rounds, args.routes.split(","))}
    if args.groups:
        g = torch.Generator(device="cuda").manual_seed(args.seed)
        groups = [torch.randn(GROUP, device="cuda", generator=g).cpu().numpy()
                  for _ in range(args.groups)]
        res["rates_gbps"] = rates(groups)
    line = json.dumps(res)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
