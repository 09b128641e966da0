#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's query path once on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--n-rows 206962688]

Phases, each printing one JSON line; any failure exits non-zero:

  device  the card (nvidia-smi name and power limit), torch/CUDA
          versions, TF32 asserted off. Exits non-zero without CUDA.
  build   both kernels from abstracts_search_tpu_torch/csrc with nvcc
          (sm_90a), all sources compiled in parallel.
  kernels each kernel against its plain PyTorch version on the card at
          the probe's and the scan's shapes (index mismatches beyond
          ties within f32 accumulation error fail), with CUDA-event times.
  index   seeded IVF-PQ artifacts at the production geometry (D 1024,
          65,536 lists, OPQ rotation, PQ128x4 nibble-packed transposed,
          SEG 256, 206,962,688 rows, lognormal-skewed list sizes), written
          through the port's save path and opened with IVFPQIndex.load.
  serve   SearchEngine over the loaded index: the kernel path against
          the plain path on the same index (hash-embedded texts and
          reconstructions of corpus rows), batch-256 QPS, single-query
          p50, and an HTTP round trip through run_server.

Then a ``{"kernels": [...]}`` line for the kernels as the serve phase
drove them (launch counts from the main path; times and bounds at its
batch-256 inputs), the card's nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
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
TOPK_SRC = "abstracts_search_tpu_torch/csrc/topk.cu"
ADC_SRC = "abstracts_search_tpu_torch/csrc/adc_topk.cu"
TOPK_TPU = "abstracts_search_tpu/ops/topk.py:184"
ADC_TPU = "abstracts_search_tpu/ops/adc.py:333"


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


def bound(bytes_moved: float, ops: float, kind: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def check_kernels(seed: int):
    """Each kernel against its plain version at the main path's shapes."""

    from abstracts_search_tpu_torch.ops import adc, topk

    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {"topk": [], "adc_topk": []}
    x = torch.randn((N_LISTS, DIM), device="cuda", generator=g)
    x = torch.nn.functional.normalize(x, dim=1).to(torch.bfloat16)
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

    n_segs, n_slots, qn = 24_576, 8_192, 256
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
                    "max_abs_err": float((kv[fin] - pv[fin]).abs().max()),
                    "index_mismatches": int((ki != pi).sum()),
                    "inf_mismatches": int((torch.isfinite(kv) != fin).sum()),
                    "ms": cuda_ms(lambda: adc.adc_topk(*args, impl="cuda")),
                    "plain_ms": cuda_ms(lambda: adc.adc_topk(*args, impl="torch"),
                                        reps=3, warmup=1)}
            out["adc_topk"].append(case)
            if case["index_mismatches"] or case["inf_mismatches"] or case["max_abs_err"]:
                raise AssertionError(f"adc_topk kernel disagrees: {case}")
        del codes
    return out


# -- index artifacts at the production geometry -----------------------------------


def list_sizes(n_rows: int, seed: int):
    """Lognormal (sigma 1) list sizes summing to n_rows, each >= 1: the
    mass-weighted mean list is ~e times the plain mean, like real IVF
    lists under skewed data."""

    w = np.random.default_rng(seed).lognormal(0.0, 1.0, N_LISTS)
    raw = w / w.sum() * (n_rows - N_LISTS)
    sizes = np.floor(raw).astype(np.int64) + 1
    short = n_rows - int(sizes.sum())
    sizes[np.argsort(raw - np.floor(raw))[::-1][:short]] += 1
    return sizes


class _SeededCodes:
    """Random uint8 codes [n_segs, MB, SEG], made on the card chunk by
    chunk as save_lists reads them, so the 12.9 GiB payload never sits
    in host memory. A slice's content depends only on (seed, start)."""

    dtype = np.dtype(np.uint8)

    def __init__(self, shape, seed: int):
        self.shape = shape
        self.seed = seed

    def __getitem__(self, sl: slice):

        lo, hi, _ = sl.indices(self.shape[0])
        g = torch.Generator(device="cuda").manual_seed(self.seed * 1_000_003 + lo)
        return torch.randint(0, 256, (hi - lo,) + tuple(self.shape[1:]),
                             dtype=torch.uint8, device="cuda", generator=g).cpu().numpy()


def write_index(out: Path, n_rows: int, seed: int) -> dict:
    """Seeded artifacts through the port's own save path: centroids,
    rotation and codebooks via IVFPQIndex.save, lists via save_lists."""

    from abstracts_search_tpu_torch.index.ivfpq import IVFPQIndex
    from abstracts_search_tpu_torch.index.lists import CSRLists, save_lists

    g = torch.Generator(device="cuda").manual_seed(seed)
    sizes = list_sizes(n_rows, seed)
    seg_cnt = -(-sizes // SEG)
    seg_start = np.concatenate([[0], np.cumsum(seg_cnt)[:-1]])
    n_segs = int(seg_cnt.sum())
    seg_list = np.repeat(np.arange(N_LISTS), seg_cnt)
    seg_valid = np.clip(sizes[seg_list] - (np.arange(n_segs) - seg_start[seg_list]) * SEG,
                        0, SEG).astype(np.int32)

    cent = torch.nn.functional.normalize(
        torch.randn((N_LISTS, DIM), device="cuda", generator=g), dim=1)
    rot, _ = torch.linalg.qr(torch.randn((DIM, DIM), device="cuda", generator=g))
    # residual codebooks small next to the unit centroids (|r| ~ 0.3)
    pqc = 0.01 * torch.randn((PQ_M, 1 << PQ_NBITS, DIM // PQ_M), device="cuda",
                             generator=g)
    idx = IVFPQIndex(N_LISTS, DIM, pq_m=PQ_M, pq_nbits=PQ_NBITS, use_opq=True,
                     seg_size=SEG, device="cuda")
    idx.set_params(cent.cpu().numpy(), pqc.cpu().numpy(), rot.cpu().numpy())
    idx.n = n_rows
    idx.save(out, include_lists=False)
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
    mb = PQ_M // 2
    csr = CSRLists(data=_SeededCodes((n_segs, mb, SEG), seed),
                   row_ids=rows.view(n_segs, SEG).cpu().numpy(),
                   seg_valid=seg_valid, seg_start=seg_start.astype(np.int64),
                   seg_cnt=seg_cnt.astype(np.int32), seg_size=SEG, n_lists=N_LISTS,
                   n_rows=n_rows, transposed=True)
    save_lists(csr, out / "lists")
    del rows
    torch.cuda.empty_cache()
    return {"n_rows": n_rows, "n_segs": n_segs, "seg_cnt_min": int(seg_cnt.min()),
            "seg_cnt_max": int(seg_cnt.max()),
            "codes_gib": n_segs * mb * SEG / 2**30}


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
    codes = idx._codes[torch.from_numpy(segs).cuda(), :, torch.from_numpy(within).cuda()]
    codes = torch.stack([codes & 15, codes >> 4], dim=2).reshape(n, PQ_M).long()
    resid = idx._pq_cent[torch.arange(PQ_M, device="cuda")[None, :], codes]  # [n, M, dsub]
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
        s = idx._cent_bf16[:N_LISTS].double() @ qr[r].double()
        cut = s.sort(descending=True).values[nprobe - 1]
        bad += int(any(s[sets[impl][r]].min() < cut - tol for impl in sets))
    return rows, bad


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


def serve(idx, seed: int, counts_reset):

    from abstracts_search_tpu_torch.models.registry import HashEmbedder
    from abstracts_search_tpu_torch.serve.app import run_server
    from abstracts_search_tpu_torch.serve.engine import SearchEngine

    ids = _LazyIds()
    emb = HashEmbedder(DIM)
    engine = SearchEngine(idx, ids, emb, nprobe=16)
    texts = [f"semantic search query number {i} about topic {i % 97}" for i in range(256)]
    q_text = emb.queries(texts)
    q_rec, own = reconstructions(idx, 256, seed)

    counts_reset()
    res = {}
    t0 = time.perf_counter()
    # kernel path vs plain path on the same resident index
    for nprobe in (2, 16):
        for name, q in (("text", q_text), ("recon", q_rec)):
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

    # throughput and latency through the engine
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

    res["profile_batch256"] = profile_batches(engine, q_text)

    # HTTP: run_server in a thread on a free port
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
    res.update({
        "qps_batch256": 256 / statistics.median(batch_s),
        "batch256_ms_median": statistics.median(batch_s) * 1e3,
        "single_query_p50_ms": statistics.median(single_s) * 1e3,
        "http": "ok", "seconds": time.perf_counter() - t0,
    })
    return engine, q_text, res


class _LazyIds:
    """Position -> "W<position>" without a 207M-entry array in RAM."""

    def __getitem__(self, p):
        return f"W{int(p)}"


def main_path_kernels(idx, q, nprobe, k, launches):
    """The kernels line: each kernel timed and bounded at the inputs the
    batch-256 search gave it."""

    from abstracts_search_tpu_torch.index.ivfpq import _normalize_rows
    from abstracts_search_tpu_torch.ops import adc, topk

    qt = torch.from_numpy(_normalize_rows(np.asarray(q, np.float32))).cuda()
    qr = (qt @ idx._rot).to(torch.bfloat16)
    x = idx._cent_bf16
    tk = lambda impl: topk.streaming_topk(qr, x, N_LISTS, nprobe, impl=impl)  # noqa: E731
    got, ref = tk("cuda"), tk("torch")
    t_err, t_bad, _ = compare_topk(qr, x, nprobe, got, ref, 1e-5)
    t_bound, t_by = bound(x.numel() * 2 + qr.numel() * 2 + qr.shape[0] * nprobe * 8,
                          2 * qr.shape[0] * N_LISTS * DIM, "bf16")
    rows = [{"name": "streaming_topk", "route": "cuda", "source": TOPK_SRC,
             "replaces": TOPK_TPU, "launches": launches["topk"], "max_abs_err": t_err,
             "index_mismatches": t_bad, "shape": [qr.shape[0], N_LISTS, DIM, nprobe],
             "ms": cuda_ms(lambda: tk("cuda")),
             "plain_ms": cuda_ms(lambda: tk("torch"), reps=3, warmup=1),
             "bound_ms": t_bound, "bound_by": t_by,
             "library_ms": cuda_ms(lambda: torch.topk(qr @ x.T, nprobe))}]

    probes, bias, luts = idx._probe(qt, nprobe)
    seg_ids, q_ids, valid, _, _ = idx._slots(probes, nprobe)
    args = (idx._codes, luts, seg_ids, q_ids, valid, min(k, SEG))
    kv, ki = adc.adc_topk(*args, impl="cuda")
    pv, pi = adc.adc_topk(*args, impl="torch")
    fin = torch.isfinite(pv)
    if not (torch.equal(ki, pi) and torch.equal(torch.isfinite(kv), fin)):
        raise AssertionError("adc_topk disagrees at the main path's inputs")
    n_slots = seg_ids.numel()
    mb = idx._codes.shape[1]
    a_bound, a_by = bound(n_slots * (mb * SEG + 12 + min(k, SEG) * 8) + luts.numel() * 4,
                          n_slots * SEG * PQ_M, "f32")
    rows.append({"name": "adc_topk", "route": "cuda", "source": ADC_SRC,
                 "replaces": ADC_TPU, "launches": launches["adc_topk"],
                 "max_abs_err": float((kv[fin] - pv[fin]).abs().max()),
                 "index_mismatches": int((ki != pi).sum()),
                 "shape": [n_slots, mb, SEG, min(k, SEG)],
                 "ms": cuda_ms(lambda: adc.adc_topk(*args, impl="cuda")),
                 "plain_ms": cuda_ms(lambda: adc.adc_topk(*args, impl="torch"),
                                     reps=3, warmup=1),
                 "bound_ms": a_bound, "bound_by": a_by, "library_ms": None})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-rows", type=int, default=206_962_688)
    ap.add_argument("--phases", default="device,build,kernels,index,serve",
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
    from abstracts_search_tpu_torch.ops import _build, adc, topk

    assert_exact_f32()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    if "build" in phases:
        t = time.perf_counter()
        _build.build_all()
        emit({"phase": "build", "seconds": time.perf_counter() - t,
              "nvcc_seconds": _build.build_seconds,
              "libraries": sorted(_build.build_all())})

    if "kernels" in phases:
        t = time.perf_counter()
        res = check_kernels(args.seed)
        emit({"phase": "kernels", "seconds": time.perf_counter() - t, **res})

    if "index" not in phases:
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    from abstracts_search_tpu_torch.index.ivfpq import IVFPQIndex

    art = Path(__file__).resolve().parent / "build" / "smoke_index"
    shutil.rmtree(art, ignore_errors=True)
    try:
        t = time.perf_counter()
        info = write_index(art, args.n_rows, args.seed)
        t_write = time.perf_counter() - t
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        idx = IVFPQIndex.load(art)
        t_load = time.perf_counter() - t
        emit({"phase": "index", **info, "write_seconds": t_write,
              "load_seconds": t_load,
              "resident_gib": torch.cuda.memory_allocated() / 2**30,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30})

        if "serve" in phases:
            def reset():
                topk.launches = 0
                adc.launches = 0

            _, q_text, res = serve(idx, args.seed, reset)
            launches = {"topk": topk.launches, "adc_topk": adc.launches}
            res["launches"] = launches
            emit({"phase": "serve", "nprobe": 16, "k": 10, **res})
            if min(launches.values()) <= 0:
                raise AssertionError(f"a kernel never launched on the main path: {launches}")
            emit({"kernels": main_path_kernels(idx, q_text, 16, 10, launches)})
    finally:
        shutil.rmtree(art, ignore_errors=True)

    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
