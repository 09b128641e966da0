"""Back-to-back batches of query vectors from one caller (a closed loop).

``system`` in the traffic file picks the entry the window drives:

- ``"flat"``: ``FlatIndex.search`` over the configuration's shard, made
  on the card from the seed (unit rows in the shard's dtype);
- ``"ivfpq"``: ``SearchEngine.search_batch_encoded`` over the
  configuration's IVF-PQ index (built in memory from the seed, no
  encoder), at the traffic's nprobe; the queries are seeded
  reconstructions of corpus rows plus Gaussian noise.

The queries are a pool of ``pool_batches`` batches made from the seed,
sent in turn. The check takes ``check_queries`` queries drawn from the
seed out of ``check_batches`` batches of the first turn, and judges
their answers with ``reference/flat.py`` or ``reference/ivfpq.py``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..harness import Slice
from ..reference import flat as ref_flat
from ..reference import ivfpq as ref_ivfpq
from ..yardstick import corpus, peaks
from .common import IVFPQInputs, LazyIds, OpRanges, adc_cost, served, sync, topk_cost

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Cell:
    def __init__(self, config: dict, traffic: dict, *, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.system = traffic["system"]
        r = corpus.rng(seed, "check_batches")
        self.keep = sorted(r.choice(traffic["pool_batches"], traffic["check_batches"],
                                    replace=False).tolist())

    # -- set-up ---------------------------------------------------------------------

    def pool(self) -> np.ndarray:
        """[pool_batches, batch, D] f32 host queries."""
        tr = self.traffic
        n = tr["pool_batches"] * tr["batch"]
        if self.system == "flat":
            d = self.config["flat"]["dim"]
            q = torch.nn.functional.normalize(torch.randn(
                (n, d), device=self.device,
                generator=corpus.generator(self.seed, "queries", device=self.device)), dim=1)
        else:
            q, _ = corpus.reconstructions(self.inputs.codes, self.inputs.layout,
                                          self.inputs.rid, self.inputs.cent, self.inputs.rot,
                                          self.inputs.pqc, n, self.seed, noise=tr["noise"])
        return q.cpu().numpy().reshape(tr["pool_batches"], tr["batch"], -1)

    def shard(self) -> torch.Tensor:
        f = self.config["flat"]
        return corpus.unit_rows(f["n_rows"], f["dim"], self.seed, self.device,
                                DTYPES[f["dtype"]])

    def setup(self) -> None:
        tr = self.traffic
        if self.system == "flat":
            from abstracts_search_tpu_torch.index.flat import FlatIndex

            f = self.config["flat"]
            self.flat = FlatIndex(chunk=f["chunk"], dtype=DTYPES[f["dtype"]],
                                  device=self.device)
            x = self.shard()
            self.flat.add(x)
            del x
            self.search = lambda q: self.flat.search(q, tr["k"])
        else:
            from abstracts_search_tpu_torch.serve.engine import SearchEngine

            self.inputs = IVFPQInputs(self.config, self.seed, self.device)
            self.index = self.inputs.index()
            self.engine = SearchEngine(self.index, LazyIds(), None, nprobe=tr["nprobe"])
            self.search = lambda q: self.engine.search_batch_encoded(q, tr["k"])
        self.queries = self.pool()
        for q in self.queries[:3]:
            self.search(q)
        sync(self.device)

    # -- the window -----------------------------------------------------------------

    def window(self, seconds: float, run) -> None:
        tr = self.traffic
        sl = Slice(run, tr["trace_start"] * seconds, tr["trace_length_s"])
        ranges = self._trace_on(run, sl) if run.trace else []
        self.kept = {}
        n_pool, batch = len(self.queries), self.traffic["batch"]
        i = 0
        t0 = time.perf_counter()
        while (el := time.perf_counter() - t0) < seconds:
            sl.poll(el)
            out = self.search(self.queries[i % n_pool])
            if i in self.keep:
                self.kept[i] = out
            i += 1
        sync(self.device)
        run.window_s = time.perf_counter() - t0
        sl.finish()
        for r in ranges:
            r.close()
        run.queries = i * batch
        run.attempted = i
        run.counters["batches"] = i
        run.counters["batch"] = batch

    def _trace_on(self, run, sl) -> list:
        """Synchronising spans around each batch and (IVF-PQ) the index
        search, live slots per search, and kernel 1's and kernel 3's calls
        in profiler ranges of their own, counted."""
        dev = self.device
        if self.system == "flat":
            from abstracts_search_tpu_torch.index import flat as mod

            search = self.search
            self.search = lambda q: _spanned(run, "batch", dev, search, q)
            ranges = [OpRanges(run, "k1", mod, "streaming_topk", topk_cost, sl.active)]
        else:
            from abstracts_search_tpu_torch.index import ivfpq as mod

            idx_search = self.index.search
            slots = run.counters.setdefault("live_slots", [])

            def index_search(q, k, **kw):
                out = _spanned(run, "index", dev, idx_search, q, k, **kw)
                slots.append(self.index.last_scan_stats["live_slots"])
                return out

            self.index.search = index_search
            search = self.search
            self.search = lambda q: _spanned(run, "batch", dev, search, q)
            ranges = [OpRanges(run, "k1", mod, "streaming_topk", topk_cost, sl.active),
                      OpRanges(run, "k3", mod, "adc_topk", adc_cost, sl.active)]
            self._other_costs(run)
        for r in ranges:
            r.on = True
        return ranges

    def _other_costs(self, run) -> None:
        """The f32 products of each IVF-PQ batch outside the kernels
        (rotation, LUTs, the probed lists' bias), per batch."""
        ix, tr = self.config["index"], self.traffic
        q, d, m = tr["batch"], ix["dim"], ix["pq_m"]
        ksub, p = 1 << ix["pq_nbits"], tr["nprobe"]
        ops = 2.0 * q * d * d + 2.0 * q * m * ksub * (d // m) + 2.0 * q * p * d
        moved = 4.0 * (2 * q * d + d * d + m * ksub * (d // m) + q * m * ksub + q * p * d)
        run.counters["other_least_s"] = peaks.least_seconds(ops, moved, "f32")[0]

    def free(self) -> None:
        for name in ("flat", "engine", "index", "search"):
            if hasattr(self, name):
                delattr(self, name)

    # -- the check ------------------------------------------------------------------

    def picked(self, batches: dict):
        """(queries [n, D], answers [(positions, scores)]) drawn from the
        seed out of the kept batches ``{batch: answers or None}``."""
        r = corpus.rng(self.seed, "check_queries")
        per = max(1, self.traffic["check_queries"] // max(1, len(self.keep)))
        qs, rows = [], []
        for i in sorted(batches):
            sel = np.sort(r.choice(self.traffic["batch"], per, replace=False))
            qs.append(self.queries[i % len(self.queries)][sel])
            ans = batches[i]
            if ans is None:
                continue
            if self.system == "flat":
                rows += [(ans[1][j], ans[0][j]) for j in sel]
            else:
                rows += [served([ans[j]])[0] for j in sel]
        return torch.from_numpy(np.concatenate(qs)) if qs else None, rows

    def check(self, run) -> dict:
        lim = self.traffic["limits"]
        q, rows = self.picked(self.kept)
        if q is None:
            got = {"score_err": float("inf"), "rank_gap": float("inf")}
        else:
            got = self.judge(q, rows)
        return {k: (got[k], lim[k]) for k in ("score_err", "rank_gap")}

    def judge(self, q, rows) -> dict:
        tr = self.traffic
        if self.system == "flat":
            x = self.shard()
            return ref_flat.judge(x, q.to(self.device), rows, tr["k"])
        return ref_ivfpq.judge(self.inputs.reference(), q, rows, tr["nprobe"], tr["k"])

    # -- the control ----------------------------------------------------------------

    def control(self, seconds: float) -> dict:
        """Flat: the program's own lower-precision path (the top-k in fast
        mode, its scores truncated to 11 mantissa bits) in place of the
        exact one. IVF-PQ: the reference in the program's place with
        TF32 for its f32 products. Judged on the queries a run checks."""
        tr = self.traffic
        if self.system == "flat":
            from abstracts_search_tpu_torch.ops.topk import streaming_topk

            self.setup()
            f = self.flat
            qs, _ = self.picked(dict.fromkeys(self.keep))
            with torch.inference_mode():
                v, i = streaming_topk(qs.to(self.device).to(f.dtype), f._x, f._rows, tr["k"],
                                      chunk=f.chunk, mode="fast")
            rows = list(zip(i.long().cpu().numpy(), v.cpu().numpy()))
            self.free()
            return self.judge(qs, rows)
        self.inputs = IVFPQInputs(self.config, self.seed, self.device)
        self.queries = self.pool()
        qs, _ = self.picked(dict.fromkeys(self.keep))
        rows = ref_ivfpq.search(self.inputs.reference(), qs, tr["nprobe"], tr["k"], "tf32")
        return self.judge(qs, rows)


def _spanned(run, name, dev, fn, *args, **kw):
    with run.span(name, sync=lambda: sync(dev)):
        return fn(*args, **kw)
