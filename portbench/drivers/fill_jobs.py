"""Back-to-back fill jobs: the operator's build and sync of a delta.

Set-up makes the trained state of the configuration's index from the
seed (centroids, rotation, codebooks) and the job's rows once, as host
f32 row groups of the size the port's ``Driver`` passes to
``fill_stream`` (each row a centroid, drawn by the lognormal list
weights, plus Gaussian spread, rotated back). Every job builds a fresh
``IVFPQIndex`` with that trained state and fills it from the row groups
in memory (``fill_stream`` with no ``lists_dir``: encode on the card,
the pack on the host, the install), so a run writes nothing to disk.

The window runs jobs back to back; a job started inside it runs to its
end and counts whole. The check judges the last job's lists with
``reference/fill.py``: their layout, exactly, and the list and codes of
every row.
"""

from __future__ import annotations

import time

import torch

from ..harness import Slice
from ..reference import fill as ref_fill
from ..yardstick import corpus, peaks
from .common import OpRanges, sync, topk_cost


class Cell:
    def __init__(self, config: dict, traffic: dict, *, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.ix = config["index"]

    def inputs(self) -> None:
        ix, tr = self.ix, self.traffic
        self.cent, self.rot, self.pqc = corpus.trained_params(
            ix["n_lists"], ix["dim"], ix["pq_m"], 1 << ix["pq_nbits"], self.seed, self.device)
        weights = corpus.list_sizes(ix["n_rows"], ix["geometry_seed"], ix["n_lists"])
        self.groups = corpus.fill_rows(tr["rows"], tr["row_group"], self.cent, self.rot, weights,
                                       self.seed, tr["spread"])

    def setup(self) -> None:
        self.inputs()
        self.params = (self.cent.cpu().numpy(), self.pqc.cpu().numpy(), self.rot.cpu().numpy())
        self.job(self.groups[: self.traffic["warm_groups"]])
        sync(self.device)

    def job(self, groups):
        """One fill job -> (its index, seconds)."""
        from abstracts_search_tpu_torch.index.ivfpq import IVFPQIndex

        ix = self.ix
        t0 = time.perf_counter()
        idx = IVFPQIndex(ix["n_lists"], ix["dim"], pq_m=ix["pq_m"], pq_nbits=ix["pq_nbits"],
                         use_opq=ix["opq"], seg_size=ix["seg_size"], storage=ix["storage"],
                         device=self.device)
        idx.set_params(*self.params)
        idx.fill_stream(iter(groups))
        sync(self.device)
        return idx, time.perf_counter() - t0

    def window(self, seconds: float, run) -> None:
        tr = self.traffic
        sl = Slice(run, 0.0, 0.0)
        ranges = None
        if run.trace:
            from abstracts_search_tpu_torch.index import ivfpq as mod

            # the assignment's calls (k 1), not the install's kernel checks
            ranges = OpRanges(run, "k1", mod, "streaming_topk",
                              lambda a: topk_cost(a) if int(a[3]) == 1 else None, sl.active)
            ranges.on = True
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            traced = run.trace and len(run.jobs) == tr["trace_job"]
            if traced:
                sl.begin()
            idx, secs = self.job(self.groups)
            if traced:
                sl.end()
            run.jobs.append((int(idx.n), secs, dict(idx.fill_stats)))
            self.last = idx.packed
            del idx
        run.window_s = time.perf_counter() - t0
        sl.finish()
        if ranges is not None:
            ranges.close()
            ix = self.ix
            mb = ix["pq_m"] // 2 if ix["pq_nbits"] == 4 else ix["pq_m"]
            run.counters["job_least_s"] = sum(
                peaks.least_seconds(ops, moved, kind)[0] for _, ops, moved, kind in
                peaks.fill_costs(tr["rows"], ix["dim"], ix["n_lists"], ix["pq_m"],
                                 1 << ix["pq_nbits"], mb))
        run.attempted = len(run.jobs)

    def free(self) -> None:
        pass

    def row_blocks(self):
        """(rows [g, D] f32 on the device, their positions) of every row
        group: the check judges every row of the job."""
        for x, pos in self.groups:
            yield torch.from_numpy(x).to(self.device), torch.from_numpy(pos).to(self.device)

    def judge(self, encoded) -> dict:
        """Every row's list and codes (``encoded(x, pos) -> (lists,
        codes [n, M])``) against the reference: the rows put in another
        list than the reference's best, and the widest code gap."""
        flips, cg = 0.0, 0.0
        for x, pos in self.row_blocks():
            a, c = encoded(x, pos)
            got = ref_fill.encode_gaps(x, a, c, self.cent, self.rot, self.pqc)
            flips += got["assign_flips"]
            cg = max(cg, got["code_gap"])
        return {"assign_flips": flips, "code_gap": cg}

    def check(self, run) -> dict:
        lim, ix = self.traffic["limits"], self.ix
        p = self.last
        assign, codes = ref_fill.program_output(p.data, p.row_ids, p.seg_cnt, self.traffic["rows"],
                                                self.device)
        packed = {"data": p.data, "row_ids": p.row_ids, "seg_valid": p.seg_valid,
                  "seg_start": p.seg_start, "seg_cnt": p.seg_cnt}
        bad = ref_fill.layout_mismatches(packed, assign, codes, ix["n_lists"], ix["seg_size"])
        got = self.judge(lambda x, pos: (assign[pos], corpus.decode_codes(codes[pos], ix["pq_m"])))
        return {"layout_mismatches": (float(bad), float(lim["layout_mismatches"])),
                **{k: (got[k], lim[k]) for k in ("assign_flips", "code_gap")}}

    def control(self, seconds: float) -> dict:
        """The reference's encode in the program's place with TF32 for its
        f32 products (rotation, residual codes), on the rows a run
        checks; judged as a run is."""
        self.inputs()
        return self.judge(lambda x, pos: ref_fill.encode(x, self.cent, self.rot, self.pqc, "tf32"))
