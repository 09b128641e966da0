"""What the drivers share: the IVF-PQ index built in memory from the
seed, the id map, and the thin wrappers of traced runs."""

from __future__ import annotations

import numpy as np
import torch

from ..yardstick import corpus, peaks


class LazyIds:
    """Corpus position -> "W<position>", with no table of ids in memory."""

    def resolve(self, positions):
        return [f"W{int(p)}" for p in positions]

    def __getitem__(self, p):
        return f"W{int(p)}"


def served(rows: list) -> list:
    """Engine rows [[{"id": "W<pos>", "score": s}]] -> [(positions, scores)]."""
    return [(np.array([int(r["id"][1:]) for r in row], np.int64),
             np.array([r["score"] for r in row], np.float64)) for row in rows]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class IVFPQInputs:
    """The IVF-PQ corpus of a configuration under a seed: the layout (of
    the configuration's fixed geometry), the trained state (f32 on the
    device), the row ids and the seeded codes."""

    def __init__(self, config: dict, seed: int, device):
        ix = config["index"]
        self.ix = ix
        self.device = torch.device(device)
        sizes = corpus.list_sizes(ix["n_rows"], ix["geometry_seed"], ix["n_lists"])
        self.layout = corpus.Layout.of(sizes, ix["seg_size"])
        self.cent, self.rot, self.pqc = corpus.trained_params(
            ix["n_lists"], ix["dim"], ix["pq_m"], 1 << ix["pq_nbits"], seed, device)
        self.rid = corpus.row_ids(self.layout, seed, device)
        mb = ix["pq_m"] // 2 if ix["pq_nbits"] == 4 else ix["pq_m"]
        self.codes = corpus.SeededCodes((self.layout.n_segs, mb, ix["seg_size"]), seed, device)

    def index(self, impl: str = "auto"):
        """A served IVFPQIndex holding this corpus on the device, installed
        the way ``IVFPQIndex.load`` installs lists (no artifact on disk)."""
        from abstracts_search_tpu_torch.index.ivfpq import IVFPQIndex
        from abstracts_search_tpu_torch.index.lists import CSRLists

        ix, lay = self.ix, self.layout
        idx = IVFPQIndex(ix["n_lists"], ix["dim"], pq_m=ix["pq_m"], pq_nbits=ix["pq_nbits"],
                         use_opq=ix["opq"], seg_size=ix["seg_size"], storage=ix["storage"],
                         impl=impl, scan_impl=impl, device=self.device)
        idx.set_params(self.cent.cpu().numpy(), self.pqc.cpu().numpy(), self.rot.cpu().numpy())
        packed = CSRLists(data=self.codes, row_ids=self.rid, seg_valid=lay.seg_valid,
                          seg_start=lay.seg_start, seg_cnt=lay.seg_cnt.astype(np.int32),
                          seg_size=ix["seg_size"], n_lists=ix["n_lists"],
                          n_rows=int(lay.sizes.sum()), transposed=True)
        # the install IVFPQIndex.load runs on an opened artifact
        idx._install(packed)
        return idx

    def reference(self):
        """The plain judge's view of this corpus (made once)."""
        from ..reference.ivfpq import Corpus

        if getattr(self, "_ref", None) is None:
            self._ref = Corpus(self.cent, self.rot, self.pqc, self.layout, self.codes, self.rid,
                               self.ix["pq_m"])
        return self._ref


class OpRanges:
    """Traced runs: wraps a module's binding of an op so that each call on
    the card runs inside a profiler range of its own
    (``portbench::<name>#<call>``, which labels the trace's idle gaps) and
    is counted. While the profiler slice is on (``active()``), each call
    is also timed on the device by CUDA events around it, on its stream,
    and ``cost(args)`` keeps what its count needs (-> a callable that
    returns (ops, bytes, kind), or None for a call not to count); once
    the window has closed, ``close`` counts each such call's operations
    and bytes. Nothing here waits for the device inside the window. The
    events time every kernel and copy the call launched, whatever their
    names: the profiler does not link the port's kernels (launched
    through ctypes) to the range open at their launch, so the trace
    cannot attribute them by call."""

    def __init__(self, run, name: str, module, attr: str, cost, active=lambda: True):
        self.run, self.name, self.module, self.attr, self.cost = run, name, module, attr, cost
        self.orig = getattr(module, attr)
        self.kept: dict = {}
        self.calls = 0
        self.on = False

        def wrapped(*args, **kw):
            if not self.on or not args[0].is_cuda:
                return self.orig(*args, **kw)
            i = self.calls
            self.calls += 1
            with torch.profiler.record_function(f"portbench::{self.name}#{i}"):
                if not active():
                    return self.orig(*args, **kw)
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                out = self.orig(*args, **kw)
                e.record()
            self.kept[i] = (self.cost(args), s, e)
            return out

        setattr(module, attr, wrapped)

    def close(self) -> None:
        """Restore the binding; -> run.op_costs[name] {call: (ops, bytes,
        kind)} and run.op_device_s[name] {call: seconds} of the timed
        calls, run.counters["calls"][name] the calls in the window."""
        setattr(self.module, self.attr, self.orig)
        if self.kept:
            torch.cuda.synchronize()
        costs = self.run.op_costs.setdefault(self.name, {})
        secs = self.run.op_device_s.setdefault(self.name, {})
        for i, (count, s, e) in self.kept.items():
            if count is not None:
                costs[i], secs[i] = count(), s.elapsed_time(e) / 1e3
        self.kept = {}
        self.run.counters.setdefault("calls", {})[self.name] = self.calls


def topk_cost(args):
    """streaming_topk(q, x, n_valid, k, ...): its shapes."""
    q, x, n_valid, k = args[:4]
    nq, d, elt = q.shape[0], x.shape[1], x.element_size()
    kind = "bf16" if x.dtype == torch.bfloat16 else "f32"
    return lambda: peaks.topk_cost(nq, int(n_valid), d, int(k), elt) + (kind,)


def adc_cost(args):
    """adc_topk(codes3, luts, seg_ids, q_ids, valid_cnt, kp, ...): the
    distinct probed segments counted once the window has closed."""
    codes3, luts, seg_ids, _q_ids, _valid, kp = args[:6]
    _, mb, seg = codes3.shape
    q, m, ksub = luts.shape
    return lambda: peaks.adc_cost(int(torch.unique(seg_ids).numel()), mb * seg, seg_ids.shape[0],
                                  q, m, ksub, seg, int(kp)) + ("f32",)
