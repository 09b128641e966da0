"""OPQ + IVF-PQ search index on PyTorch — the production query path.

Because score(q, row) = q_rot . (c_list + decode(code)), a row's score
is the per-list bias q_rot . c_list plus a lookup-table sum over one
shared LUT [M, ksub] per query. One search batch:

  1. probe: rotate the queries (f32), streaming top-nprobe over the
     bf16 centroids (the ``streaming_topk`` kernel), then the exact f32
     bias for the chosen lists and the residual LUTs;
  2. slots: exactly sum(seg_cnt[probed lists]) (query, segment) pairs,
     query-major, derived on the device from the resident CSR;
  3. scan: over transposed lists (what every fill writes), fused ADC +
     per-slot top-kp (the ``adc_topk`` kernel); the bias is constant
     within a slot, so it is added to the kp winners. Over row-major
     lists (legacy format<=2 artifacts), raw ADC sums (the ``adc_scan``
     kernel), then bias, row mask and a per-slot top-kp;
  4. merge: a ragged per-query top-k over the slot winners, in slot
     order, the lowest candidate winning ties;
  5. positions: flat rows resolve to corpus positions on the host
     through the ``row_ids`` memmap, so row ids never occupy the card.

Artifacts are the JAX package's (``meta.json``, ``centroids.npy``,
``pq_centroids.npy``, ``rotation.npy``, ``lists/``); ``load`` opens
them and ``save`` writes them.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import torch

from ..device import assert_exact_f32, resolve_device
from ..ops import _build
from ..ops.adc import adc_scan, adc_topk
from ..ops.topk import streaming_topk
from .lists import CSRLists, load_lists, save_lists

logger = logging.getLogger(__name__)

NEG_INF = float("-inf")


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _normalize_rows(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(n, 1e-12)


def _upload(arr: np.ndarray, device: torch.device,
            chunk_bytes: int = 256 << 20) -> torch.Tensor:
    """Copy a (possibly memmapped) array into a preallocated device
    tensor chunk by chunk, never holding a whole host copy. On the card
    two pinned staging buffers alternate, so reading the next chunk
    overlaps the transfer of the previous one."""
    out = torch.empty(arr.shape, dtype=torch.uint8, device=device)
    n = arr.shape[0]
    row_bytes = int(np.prod(arr.shape[1:], dtype=np.int64))
    flat = out.view(n, row_bytes)
    rows = max(1, chunk_bytes // max(row_bytes, 1))
    if device.type != "cuda":
        for lo in range(0, n, rows):
            hi = min(lo + rows, n)
            flat[lo:hi] = torch.from_numpy(
                np.array(arr[lo:hi]).reshape(hi - lo, row_bytes))
        return out
    bufs = [torch.empty((min(rows, n), row_bytes), dtype=torch.uint8, pin_memory=True)
            for _ in range(2)]
    done = [None, None]
    stream = torch.cuda.current_stream(device)
    for i, lo in enumerate(range(0, n, rows)):
        b = i % 2
        if done[b] is not None:
            done[b].synchronize()
        hi = min(lo + rows, n)
        np.copyto(bufs[b].numpy()[: hi - lo], arr[lo:hi].reshape(hi - lo, row_bytes))
        flat[lo:hi].copy_(bufs[b][: hi - lo], non_blocking=True)
        done[b] = torch.cuda.Event()
        done[b].record(stream)
    torch.cuda.synchronize(device)
    return out


class IVFPQIndex:
    def __init__(
        self,
        n_lists: int,
        dim: int,
        *,
        pq_m: int = 64,
        pq_nbits: int = 8,
        use_opq: bool = True,
        seg_size: int = 512,
        chunk: int = 1024,
        spherical: bool = True,
        impl: str = "auto",
        scan_impl: str = "auto",
        storage: str = "device",
        device=None,
    ):
        if dim % pq_m:
            raise ValueError(f"dim={dim} not divisible by pq_m={pq_m}")
        if pq_nbits == 4 and pq_m % 2:
            raise ValueError("pq_nbits=4 requires even pq_m (nibble packing)")
        for name, val in (("impl", impl), ("scan_impl", scan_impl)):
            if val not in ("auto", "cuda", "torch"):
                raise ValueError(f"{name}={val!r}")
        # storage: "device" keeps the lists in device memory ("auto"
        # resolves to it: the 207M PQ128x4 artifact, 12.9 GiB of codes,
        # fits one 80 GB card). "host"/"hybrid" serve from the memmap in
        # the JAX package and are still to be ported.
        if storage not in ("device", "auto"):
            raise NotImplementedError(f"storage={storage!r}: not yet ported")
        # Scan hits always resolve to corpus positions on the host (the
        # JAX package's pos_map="host"); its device-resident row ids
        # serve multi-controller runs, which one card does not need.
        self.device = resolve_device(device)
        self.n_lists = n_lists
        self.dim = dim
        self.pq_m = pq_m
        self.pq_nbits = pq_nbits
        self.ksub = 1 << pq_nbits
        self.dsub = dim // pq_m
        self.use_opq = use_opq
        self.seg_size = seg_size
        self.chunk = chunk
        self.spherical = spherical
        self.impl = impl
        self.scan_impl = scan_impl
        self.centroids: np.ndarray | None = None      # [n_lists, D]
        self.pq_centroids: np.ndarray | None = None   # [M, ksub, dsub]
        self.rotation = np.eye(dim, dtype=np.float32)
        self.train_stats: dict = {}
        self.packed: CSRLists | None = None
        self.n = 0
        self.last_scan_stats: dict = {}

    @property
    def code_bytes(self) -> int:
        """Stored bytes per vector: 4-bit codes are nibble-packed."""
        return self.pq_m // 2 if self.pq_nbits == 4 else self.pq_m

    def set_params(self, centroids, pq_centroids, rotation) -> None:
        """Install trained state: centroids [n_lists, D], PQ codebooks
        [M, ksub, dsub] and the (OPQ) rotation [D, D], all f32."""
        c = np.asarray(centroids, np.float32)
        pqc = np.asarray(pq_centroids, np.float32)
        rot = np.asarray(rotation, np.float32)
        if c.shape != (self.n_lists, self.dim):
            raise ValueError(f"centroids {c.shape} != ({self.n_lists}, {self.dim})")
        if pqc.shape != (self.pq_m, self.ksub, self.dsub):
            raise ValueError(f"pq_centroids {pqc.shape} != "
                             f"({self.pq_m}, {self.ksub}, {self.dsub})")
        if rot.shape != (self.dim, self.dim):
            raise ValueError(f"rotation {rot.shape} != ({self.dim}, {self.dim})")
        self.centroids, self.pq_centroids, self.rotation = c, pqc, rot
        k_pad = _round_up(self.n_lists, self.chunk)
        cp = torch.zeros((k_pad, self.dim), dtype=torch.float32, device=self.device)
        cp[: self.n_lists] = torch.from_numpy(c).to(self.device)
        self._cent = cp
        # resident bf16 copy for the probe; equal to a per-call cast
        self._cent_bf16 = cp.to(torch.bfloat16)
        self._pq_cent = torch.from_numpy(pqc).to(self.device)
        self._rot = torch.from_numpy(rot).to(self.device)

    def _install(self, packed: CSRLists) -> None:
        if packed.seg_size != self.seg_size:
            raise ValueError(
                f"index meta seg_size={self.seg_size} != packed lists "
                f"seg_size={packed.seg_size}; the artifact directory is "
                f"inconsistent")
        shape = packed.data.shape
        mb = shape[1] if packed.transposed else shape[-1]
        if packed.data.dtype != np.uint8 or len(shape) != 3 or mb != self.code_bytes:
            raise ValueError(f"payload {shape} {packed.data.dtype} does "
                             f"not hold {self.code_bytes}-byte codes")
        dev = self.device
        self.packed = packed
        self.n = packed.n_rows
        self._codes = _upload(packed.data, dev)        # [n_segs, MB, SEG] | [n_segs, SEG, MB]
        self._seg_valid = torch.from_numpy(
            np.asarray(packed.seg_valid, np.int32)).to(dev)
        self._seg_start = torch.from_numpy(
            np.asarray(packed.seg_start, np.int64)).to(dev)
        self._seg_cnt = torch.from_numpy(
            np.asarray(packed.seg_cnt, np.int64)).to(dev)
        if dev.type == "cuda" and (self.impl, self.scan_impl) != ("torch", "torch"):
            self._check_kernels()

    def _check_kernels(self) -> None:
        """Build the kernels and hold each against its plain version on
        a few of this index's own inputs, so a faulty kernel fails the
        load instead of a request."""
        _build.build_all()
        x = self._cent_bf16
        # the probe's k at search's and the engine's nprobe, on the
        # 128-query tile (Q 4, 5) and on the 256-query tile of batched
        # probes (Q 129), each Q no multiple of its tile: every index list
        # must be the plain one, except where the two sums in another
        # order swap scores equal to within 1e-5
        for qn, k in ((4, 8), (5, 16), (129, 16)):
            q = x[: min(qn, self.n_lists)]
            k = min(k, self.n_lists)
            kv, ki = streaming_topk(q, x, self.n_lists, k, chunk=self.chunk, impl="cuda")
            pv, pi = streaming_topk(q, x, self.n_lists, k, chunk=self.chunk, impl="torch")
            own = torch.einsum("qd,qkd->qk", q.float(), x[ki.long()].float())
            if not (torch.allclose(kv, pv, rtol=1e-5, atol=1e-5)
                    and torch.equal(ki[:, 0], pi[:, 0])
                    and bool(((ki == pi) | ((own - pv).abs() <= 1e-5)).all())):
                raise RuntimeError("streaming_topk kernel disagrees with its plain version")
        n_slots = min(8, self._codes.shape[0])
        luts = torch.randn((2, self.pq_m, self.ksub), device=self.device,
                           generator=torch.Generator(device=self.device).manual_seed(0))
        seg_ids = torch.arange(n_slots, dtype=torch.int32, device=self.device)
        q_ids = seg_ids % 2
        transposed = self.packed.transposed
        ks = [adc_scan(self._codes, luts, seg_ids, q_ids, transposed=transposed, impl=impl)
              for impl in ("cuda", "torch")]
        if not torch.equal(*ks):
            raise RuntimeError("adc_scan kernel disagrees with its plain version")
        if transposed:
            valid = self._seg_valid[:n_slots].contiguous()
            kp = min(10, self.seg_size)
            kv, ki = adc_topk(self._codes, luts, seg_ids, q_ids, valid, kp, impl="cuda")
            pv, pi = adc_topk(self._codes, luts, seg_ids, q_ids, valid, kp, impl="torch")
            if not (torch.equal(kv, pv) and torch.equal(ki, pi)):
                raise RuntimeError("adc_topk kernel disagrees with its plain version")

    # -- search ----------------------------------------------------------------

    def _probe(self, q: torch.Tensor, nprobe: int):
        """queries -> (probes [Q, P] i32, bias [Q, P] f32, LUTs [Q, M,
        ksub] f32). Probe selection runs in bf16; the bias feeds the
        scores, so it is recomputed in exact f32 for the chosen lists."""
        qn = q.shape[0]
        qr = q @ self._rot
        _, probes = streaming_topk(qr.to(torch.bfloat16), self._cent_bf16,
                                   self.n_lists, nprobe, chunk=self.chunk,
                                   impl=self.impl)
        c_sel = self._cent[probes.long()]                        # [Q, P, D]
        bias = torch.einsum("qpd,qd->qp", c_sel, qr)
        luts = torch.einsum("qmd,mkd->qmk", qr.reshape(qn, self.pq_m, self.dsub),
                            self._pq_cent)
        return probes, bias, luts.contiguous()

    def _slots(self, probes, nprobe: int):
        """The scan's slot list: exactly the probed segments, query-major
        (query, then probe rank, then segment). -> (seg_ids [S] i32,
        q_ids [S] i32, valid_cnt [S] i32, pair [S] i64 = the slot's
        (query, probe) index, percnt [Q] slots per query)."""
        dev = self.device
        qn = probes.shape[0]
        pl = probes.reshape(-1).long()                           # [Q*P]
        cnt = self._seg_cnt[pl]
        percnt = cnt.view(qn, nprobe).sum(dim=1)                 # [Q]
        total = int(cnt.sum())
        # (The JAX package pads this list to a speculative bucket shape,
        # fuses probe and scan into one dispatch and splits batches past
        # SEARCH_QP_MAX / SCAN_BUCKET_MAX, for the TPU's static shapes
        # and SMEM; eager PyTorch needs none of that.)
        pair = torch.repeat_interleave(torch.arange(qn * nprobe, device=dev), cnt,
                                       output_size=total)
        first = torch.cumsum(cnt, 0) - cnt
        within = torch.arange(total, device=dev) - first[pair]
        seg_ids = (self._seg_start[pl][pair] + within).int()
        return (seg_ids, (pair // nprobe).int(), self._seg_valid[seg_ids.long()],
                pair, percnt)

    def _scan(self, probes, bias, luts, k: int, nprobe: int):
        """-> (values [Q, k] f32, flat rows [Q, k] int64, -1 where no hit)."""
        dev = self.device
        qn = probes.shape[0]
        seg = self.seg_size
        seg_ids, q_ids, valid, pair, percnt = self._slots(probes, nprobe)
        maxcnt = int(percnt.max())
        self.last_scan_stats = {"live_slots": len(seg_ids), "maxcnt": maxcnt}
        if len(seg_ids) == 0:
            return (torch.full((qn, k), NEG_INF, device=dev),
                    torch.full((qn, k), -1, dtype=torch.int64, device=dev))
        kp = min(k, seg)
        slot_bias = bias.reshape(-1)[pair][:, None]
        if self.packed.transposed:
            sv, si = adc_topk(self._codes, luts, seg_ids, q_ids, valid, kp,
                              impl=self.scan_impl)
            sv = sv + slot_bias                                  # [S, kp]
        else:
            scores = adc_scan(self._codes, luts, seg_ids, q_ids, transposed=False,
                              impl=self.scan_impl) + slot_bias   # [S, SEG]
            rows = torch.arange(seg, device=dev)
            scores = torch.where(rows[None, :] < valid[:, None], scores, NEG_INF)
            # per-slot top-kp under (value desc, row asc)
            sv, si = torch.sort(scores, dim=1, descending=True, stable=True)
            sv, si = sv[:, :kp], si[:, :kp]
        srows = seg_ids.long()[:, None] * seg + si.long()

        # ragged per-query merge over the query's slots in slot order
        ar = torch.arange(maxcnt, device=dev)
        live = ar[None, :] < percnt[:, None]                     # [Q, maxcnt]
        slot = torch.where(live, (torch.cumsum(percnt, 0) - percnt)[:, None] + ar, 0)
        qv = torch.where(live[:, :, None], sv[slot], NEG_INF).reshape(qn, -1)
        qrow = srows[slot].reshape(qn, -1)
        if qv.shape[1] < k:
            qv = torch.nn.functional.pad(qv, (0, k - qv.shape[1]), value=NEG_INF)
            qrow = torch.nn.functional.pad(qrow, (0, k - qrow.shape[1]))
        v, order = torch.sort(qv, dim=1, descending=True, stable=True)
        v = v[:, :k]
        rows = torch.gather(qrow, 1, order[:, :k])
        # (The JAX package gathers per-device top-k over its mesh here;
        # one card holds every list.)
        return v, torch.where(v > NEG_INF, rows, -1)

    def _rows_to_pos(self, rows: np.ndarray) -> np.ndarray:
        """Flat rows (segment * SEG + within) -> corpus positions through
        the canonical row_ids (a memmap read of at most Q*k int32s)."""
        seg = self.seg_size
        r = np.clip(rows, 0, None)
        pos = np.asarray(self.packed.row_ids[r // seg, r % seg], np.int64)
        return np.where(rows >= 0, pos, np.int64(-1))

    def search(self, queries: np.ndarray, k: int, *, nprobe: int = 8):
        """-> (scores [Q, k] f32, corpus positions [Q, k] int64, -1
        padded) as numpy arrays."""
        if self.packed is None:
            raise RuntimeError("no lists installed: load a filled index")
        assert_exact_f32()
        q = np.asarray(queries, np.float32)
        if self.spherical:
            q = _normalize_rows(q)
        nprobe = min(nprobe, self.n_lists)
        qt = torch.from_numpy(np.ascontiguousarray(q)).to(self.device)
        with torch.inference_mode():
            probes, bias, luts = self._probe(qt, nprobe)
            v, rows = self._scan(probes, bias, luts, k, nprobe)
        # one device -> host copy of the winners; the JAX package packs
        # values and positions into one int32 transfer because the TPU
        # flushes f32 denormals, which the card does not
        v, rows = v.cpu().numpy(), rows.cpu().numpy()
        return v, self._rows_to_pos(rows)

    # -- artifacts -------------------------------------------------------------

    def save(self, directory: str | Path, *, include_lists: bool = True) -> None:
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        np.save(d / "centroids.npy", self.centroids)
        np.save(d / "pq_centroids.npy", self.pq_centroids)
        np.save(d / "rotation.npy", self.rotation)
        meta = {
            "type": "ivf_pq",
            "n_lists": self.n_lists,
            "dim": self.dim,
            "pq_m": self.pq_m,
            "pq_nbits": self.pq_nbits,
            "use_opq": self.use_opq,
            "seg_size": self.seg_size,
            "spherical": self.spherical,
            "n": self.n,
            "train_stats": self.train_stats,
        }
        (d / "meta.json").write_text(json.dumps(meta, indent=2))
        if include_lists and self.packed is not None:
            save_lists(self.packed, d / "lists")

    @classmethod
    def load(cls, directory: str | Path, *, device=None, **kw) -> "IVFPQIndex":
        """Open JAX- or port-written artifacts on ``device`` (default:
        the CUDA card). The lists stream from the memmap to the device."""
        d = Path(directory)
        meta = json.loads((d / "meta.json").read_text())
        if not meta["spherical"]:
            logger.warning("%s was built without -N; serving it with the "
                           "semantics it was built with", d)
        idx = cls(meta["n_lists"], meta["dim"], pq_m=meta["pq_m"],
                  pq_nbits=meta["pq_nbits"], use_opq=meta["use_opq"],
                  seg_size=meta["seg_size"], spherical=meta["spherical"],
                  device=device, **kw)
        idx.set_params(np.load(d / "centroids.npy"), np.load(d / "pq_centroids.npy"),
                       np.load(d / "rotation.npy"))
        idx.train_stats = meta.get("train_stats", {})
        if (d / "lists").is_dir():
            idx._install(load_lists(d / "lists", mmap=True))
        return idx
