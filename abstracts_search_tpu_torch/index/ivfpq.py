"""OPQ + IVF-PQ search index on PyTorch — the production query path.

Because score(q, row) = q_rot . (c_list + decode(code)), a row's score
is the per-list bias q_rot . c_list plus a lookup-table sum over one
shared LUT [M, ksub] per query. One search batch:

  1. probe: rotate the queries (f32), streaming top-nprobe over the
     bf16 centroids (the ``streaming_topk`` kernel), then the exact f32
     bias for the chosen lists and the residual LUTs;
  2. slots: exactly sum(seg_cnt[probed lists]) (query, segment) pairs,
     query-major;
  3. scan: over transposed lists (what every fill writes), fused ADC +
     per-slot top-kp (the ``adc_topk`` kernel); the bias is constant
     within a slot, so it is added to the kp winners. Over row-major
     lists (legacy format<=2 artifacts), raw ADC sums (the ``adc_scan``
     kernel), then bias, row mask and a per-slot top-kp;
  4. merge: a ragged per-query top-k over the slot winners, in slot
     order, the lowest candidate winning ties;
  5. positions: flat rows resolve to corpus positions on the host
     through the ``row_ids`` memmap, so row ids never occupy the card.

Where the codes live (``storage``):

- ``"device"``: every list on the card; the slot list is derived there
  from the resident CSR.
- ``"host"``: the codes stay in the (memmapped) artifact. Each batch
  builds its slot list on the host from the probes, gathers exactly the
  probed segments through two reused pinned buffers, uploads them and
  scans the tiles with ``seg_ids`` = tile indices.
- ``"hybrid"``: the largest lists, up to ``hot_budget_bytes``, sit on the
  card in a compacted buffer with its own CSR; the cold tail is gathered
  as in host mode while the hot scan runs, and the two top-k lists merge
  on the host by a stable sort.
- ``"auto"``: ``"device"`` where the payload fits the card's free memory
  less ``AUTO_HEADROOM_BYTES``, else ``"hybrid"`` with the hot budget at
  that ceiling less the centroids; ``"device"`` on the CPU.

Every storage runs the same scan body (``_scan_slots``). Artifacts are
the JAX package's (``meta.json``, ``centroids.npy``,
``pq_centroids.npy``, ``rotation.npy``, ``lists/``); ``load`` opens them
and ``save`` writes them.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..device import assert_exact_f32, resolve_device
from ..ops import _build
from ..ops.adc import adc_scan, adc_topk
from ..ops.topk import streaming_topk
from .lists import CSRLists, load_lists, ragged_ranges, save_lists

logger = logging.getLogger(__name__)

NEG_INF = float("-inf")
STORAGES = ("device", "host", "hybrid", "auto")


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _normalize_rows(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(n, 1e-12)


def _take(arr: np.ndarray, rows, lo: int, hi: int, out=None):
    """Rows lo:hi of ``arr``, or of its row selection ``rows``."""
    if rows is None:
        if out is None:
            return arr[lo:hi]
        np.copyto(out, arr[lo:hi])
        return out
    # mode="clip" writes straight into ``out`` ("raise" buffers it)
    return np.take(arr, rows[lo:hi], axis=0, out=out, mode="clip")


class _PinnedRing:
    """Two pinned host buffers that alternate, so reading the next chunk
    of an array into one overlaps the card's copy out of the other. A
    buffer is refilled only once the copy out of it has finished (one
    event per buffer), so the ring carries over from call to call."""

    def __init__(self, chunk_bytes: int):
        self.chunk_bytes = chunk_bytes
        self.bufs = [torch.empty(chunk_bytes, dtype=torch.uint8, pin_memory=True)
                     for _ in range(2)]
        self.done = [None, None]
        self.turn = 0

    def copy(self, arr: np.ndarray, rows, out: torch.Tensor) -> None:
        """Enqueue the copy of ``arr`` (or of its rows ``rows``) into the
        device bytes ``out`` [n, row_bytes] on the current stream. Returns
        once the last chunk is read into pinned memory."""
        n, row_bytes = out.shape
        per = self.chunk_bytes // row_bytes
        if per < 1:
            raise ValueError(f"{row_bytes}-byte rows do not fit {self.chunk_bytes}-byte "
                             f"staging buffers")
        stream = torch.cuda.current_stream(out.device)
        for lo in range(0, n, per):
            hi = min(lo + per, n)
            b = self.turn
            self.turn ^= 1
            if self.done[b] is not None:
                self.done[b].synchronize()
            buf = self.bufs[b][: (hi - lo) * row_bytes]
            _take(arr, rows, lo, hi,
                  out=buf.numpy().view(arr.dtype).reshape((hi - lo,) + arr.shape[1:]))
            out[lo:hi].copy_(buf.view(hi - lo, row_bytes), non_blocking=True)
            self.done[b] = torch.cuda.Event()
            self.done[b].record(stream)


def _upload(arr: np.ndarray, device: torch.device, *, rows=None,
            chunk_bytes: int = 256 << 20) -> torch.Tensor:
    """Copy a (possibly memmapped) uint8 array, or its rows ``rows``,
    into a new device tensor chunk by chunk, never holding a whole host
    copy. On the card two pinned buffers alternate (``_PinnedRing``)."""
    n = arr.shape[0] if rows is None else len(rows)
    out = torch.empty((n,) + tuple(arr.shape[1:]), dtype=torch.uint8, device=device)
    row_bytes = int(np.prod(arr.shape[1:], dtype=np.int64))
    if n == 0:
        return out
    per = max(1, chunk_bytes // max(row_bytes, 1))
    if device.type != "cuda":
        for lo in range(0, n, per):
            hi = min(lo + per, n)
            out[lo:hi] = torch.from_numpy(np.array(_take(arr, rows, lo, hi)))
        return out
    _PinnedRing(min(per, n) * row_bytes).copy(arr, rows, out.view(n, row_bytes))
    torch.cuda.synchronize(device)
    return out


def auto_storage(payload_bytes: int, free_bytes: int, centroid_bytes: int,
                 headroom_bytes: int) -> tuple[str, int | None]:
    """storage="auto" on the card -> (storage, hot budget or None):
    "device" where the payload fits the free memory less the headroom,
    else "hybrid" with the hot budget at that ceiling less the
    centroids."""
    ceiling = free_bytes - headroom_bytes
    if payload_bytes <= ceiling:
        return "device", None
    return "hybrid", max(ceiling - centroid_bytes, 0)


class Slots(NamedTuple):
    """A scan's slot list, on the device. Slots are query-major (query,
    then probe rank, then segment)."""

    seg_ids: torch.Tensor    # [S] i32: segment of the scanned codes
    q_ids: torch.Tensor      # [S] i32
    valid: torch.Tensor      # [S] i32: live rows of the segment
    pair: torch.Tensor       # [S] i64: the slot's (query, probe) index
    percnt: torch.Tensor     # [Q] i64: slots per query
    maxcnt: int              # max(percnt)


class IVFPQIndex:
    # storage="auto" on the card: memory kept free beside a full install
    # for the search's own buffers (slot lists, a host batch's gathered
    # tiles: 0.85 GB at batch 256, nprobe 16 over PQ128x4 SEG 256) and
    # for the query encoder that shares the card (~3.1 GB of bf16 weights
    # at 1.5B parameters)
    AUTO_HEADROOM_BYTES = 8 << 30
    # pinned staging buffers of the host and cold gathers (two, reused)
    STAGE_CHUNK_BYTES = 64 << 20

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
        hot_budget_bytes: int = 1 << 30,
        device=None,
    ):
        if dim % pq_m:
            raise ValueError(f"dim={dim} not divisible by pq_m={pq_m}")
        if pq_nbits == 4 and pq_m % 2:
            raise ValueError("pq_nbits=4 requires even pq_m (nibble packing)")
        for name, val in (("impl", impl), ("scan_impl", scan_impl)):
            if val not in ("auto", "cuda", "torch"):
                raise ValueError(f"{name}={val!r}")
        if storage not in STORAGES:
            raise ValueError(f"storage={storage!r}: one of {STORAGES}")
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
        self.storage = storage
        self.hot_budget_bytes = hot_budget_bytes
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

    # -- install -----------------------------------------------------------------

    def _install(self, packed: CSRLists) -> None:
        if packed.seg_size != self.seg_size:
            raise ValueError(
                f"index meta seg_size={self.seg_size} != packed lists "
                f"seg_size={packed.seg_size}; the artifact directory is "
                f"inconsistent")
        shape = packed.data.shape
        mb = shape[1] if packed.transposed else shape[-1]
        # 4-bit codes are nibble-packed (MB = M/2), or one a byte in legacy
        # artifacts (MB = M); every later step takes the width from the
        # payload itself
        widths = (self.pq_m // 2, self.pq_m) if self.pq_nbits == 4 else (self.pq_m,)
        if packed.data.dtype != np.uint8 or len(shape) != 3 or mb not in widths:
            raise ValueError(f"payload {shape} {packed.data.dtype} does not hold "
                             f"{self.pq_m} {self.pq_nbits}-bit codes")
        dev = self.device
        self.packed = packed
        self.n = packed.n_rows
        seg_bytes = int(np.prod(shape[1:]))
        if self.storage == "auto":
            self.storage = self._resolve_auto_storage(packed, seg_bytes)
        self._codes = self._seg_map = None
        self._has_cold = False
        self._seg_start_h = np.asarray(packed.seg_start, np.int64)
        if self.storage == "device":
            self._install_resident(packed, hot=None)
        else:
            if self.storage == "hybrid":
                hot = self._pick_hot_lists(packed, seg_bytes)
                self._install_resident(packed, hot=hot)
                cnt = np.where(hot, 0, packed.seg_cnt)
                self._has_cold = bool(cnt.any())
            else:
                cnt = packed.seg_cnt
            # the CSR counts of the lists served from the memmap
            self._host_cnt = np.asarray(cnt, np.int64)
            self._stage_lock = threading.Lock()
            if dev.type == "cuda":
                self._ring = _PinnedRing(max(self.STAGE_CHUNK_BYTES, seg_bytes))
        if dev.type == "cuda" and (self.impl, self.scan_impl) != ("torch", "torch"):
            if self._codes is not None and self._codes.shape[0]:
                self._check_kernels(self._codes, self._seg_valid)
            else:
                rows = np.arange(min(8, packed.n_segs))
                self._check_kernels(_upload(packed.data, dev, rows=rows),
                                    torch.from_numpy(np.asarray(packed.seg_valid, np.int32)[rows])
                                    .to(dev))

    def _install_resident(self, packed: CSRLists, hot) -> None:
        """Upload every list (``hot`` None) or only the ``hot`` lists'
        segments, compacted, with a device CSR in which the other lists
        count 0; ``_seg_map`` maps a compacted segment to its canonical
        one, so rows still resolve through ``row_ids``."""
        dev = self.device
        if hot is None:
            self._codes = _upload(packed.data, dev)      # [n_segs, MB, SEG] | [n_segs, SEG, MB]
            valid, start, cnt = packed.seg_valid, packed.seg_start, packed.seg_cnt
        else:
            cnt = np.where(hot, packed.seg_cnt, 0).astype(np.int64)
            segs, _ = ragged_ranges(packed.seg_start, cnt)   # list order: sorted
            self._codes = _upload(packed.data, dev, rows=segs)
            start = np.cumsum(cnt) - cnt
            valid = np.asarray(packed.seg_valid)[segs]
            self._seg_map = segs
        self._seg_valid = torch.from_numpy(np.asarray(valid, np.int32)).to(dev)
        self._seg_start = torch.from_numpy(np.asarray(start, np.int64)).to(dev)
        self._seg_cnt = torch.from_numpy(np.asarray(cnt, np.int64)).to(dev)

    def _resolve_auto_storage(self, packed: CSRLists, seg_bytes: int) -> str:
        if self.device.type != "cuda":
            return "device"
        payload = int(np.asarray(packed.seg_cnt, np.int64).sum()) * seg_bytes
        free, _ = torch.cuda.mem_get_info(self.device)
        storage, budget = auto_storage(payload, free, self.n_lists * self.dim * 4,
                                       self.AUTO_HEADROOM_BYTES)
        if storage == "hybrid":
            self.hot_budget_bytes = budget
            logger.info("storage=auto: %.2f GiB of codes exceed %.2f GiB free less "
                        "%.1f GiB headroom; serving hybrid with a %.2f GiB hot budget",
                        payload / 2**30, free / 2**30, self.AUTO_HEADROOM_BYTES / 2**30,
                        budget / 2**30)
        return storage

    def _pick_hot_lists(self, packed: CSRLists, seg_bytes: int) -> np.ndarray:
        """Largest lists first until the hot budget is spent (big lists
        are probed most and cost most). Row ids stay on the host, so a
        segment costs its payload bytes; one card holds every hot list."""
        cnt = np.asarray(packed.seg_cnt, np.int64)
        order = np.argsort(-cnt, kind="stable")
        cum = np.cumsum(cnt[order] * seg_bytes)
        hot = np.zeros(packed.n_lists, bool)
        hot[order[cum <= self.hot_budget_bytes]] = True
        return hot

    def _check_kernels(self, codes: torch.Tensor, seg_valid: torch.Tensor) -> None:
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
        n_slots = min(8, codes.shape[0])
        luts = torch.randn((2, self.pq_m, self.ksub), device=self.device,
                           generator=torch.Generator(device=self.device).manual_seed(0))
        seg_ids = torch.arange(n_slots, dtype=torch.int32, device=self.device)
        q_ids = seg_ids % 2
        transposed = self.packed.transposed
        ks = [adc_scan(codes, luts, seg_ids, q_ids, transposed=transposed, impl=impl)
              for impl in ("cuda", "torch")]
        if not torch.equal(*ks):
            raise RuntimeError("adc_scan kernel disagrees with its plain version")
        if transposed:
            valid = seg_valid[:n_slots].contiguous()
            kp = min(10, self.seg_size)
            kv, ki = adc_topk(codes, luts, seg_ids, q_ids, valid, kp, impl="cuda")
            pv, pi = adc_topk(codes, luts, seg_ids, q_ids, valid, kp, impl="torch")
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

    def _slots(self, probes, nprobe: int) -> Slots:
        """The resident scan's slot list, derived on the device from the
        resident CSR: exactly the probed segments (the hot ones in hybrid
        storage). One host sync, for the slot total and the widest query."""
        dev = self.device
        qn = probes.shape[0]
        pl = probes.reshape(-1).long()                           # [Q*P]
        cnt = self._seg_cnt[pl]
        percnt = cnt.view(qn, nprobe).sum(dim=1)                 # [Q]
        total, maxcnt = torch.stack([cnt.sum(), percnt.max()]).tolist()
        # (The JAX package pads this list to a speculative bucket shape,
        # fuses probe and scan into one dispatch and splits batches past
        # SEARCH_QP_MAX / SCAN_BUCKET_MAX, for the TPU's static shapes
        # and SMEM; eager PyTorch needs none of that.)
        pair = torch.repeat_interleave(torch.arange(qn * nprobe, device=dev), cnt,
                                       output_size=total)
        first = torch.cumsum(cnt, 0) - cnt
        within = torch.arange(total, device=dev) - first[pair]
        seg_ids = (self._seg_start[pl][pair] + within).int()
        return Slots(seg_ids, (pair // nprobe).int(), self._seg_valid[seg_ids.long()],
                     pair, percnt, maxcnt)

    def _scan_slots(self, codes, luts, bias, slots: Slots, k: int):
        """The scan body of every storage: per-slot ADC + top-kp over
        ``codes`` (resident segments, or gathered tiles whose seg_ids are
        their indices), then the ragged per-query merge over each query's
        slots in slot order. -> (values [Q, k] f32, flat rows [Q, k] int64
        in ``codes``' segment space, -1 where no hit)."""
        dev = self.device
        qn = slots.percnt.shape[0]
        seg = self.seg_size
        if len(slots.seg_ids) == 0:
            return (torch.full((qn, k), NEG_INF, device=dev),
                    torch.full((qn, k), -1, dtype=torch.int64, device=dev))
        kp = min(k, seg)
        slot_bias = bias.reshape(-1)[slots.pair][:, None]
        if self.packed.transposed:
            sv, si = adc_topk(codes, luts, slots.seg_ids, slots.q_ids, slots.valid, kp,
                              impl=self.scan_impl)
            sv = sv + slot_bias                                  # [S, kp]
        else:
            scores = adc_scan(codes, luts, slots.seg_ids, slots.q_ids, transposed=False,
                              impl=self.scan_impl) + slot_bias   # [S, SEG]
            rows = torch.arange(seg, device=dev)
            scores = torch.where(rows[None, :] < slots.valid[:, None], scores, NEG_INF)
            # per-slot top-kp under (value desc, row asc)
            sv, si = torch.sort(scores, dim=1, descending=True, stable=True)
            sv, si = sv[:, :kp], si[:, :kp]
        srows = slots.seg_ids.long()[:, None] * seg + si.long()

        # ragged per-query merge over the query's slots in slot order
        percnt = slots.percnt
        ar = torch.arange(slots.maxcnt, device=dev)
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
        # one card holds every resident list.)
        return v, torch.where(v > NEG_INF, rows, -1)

    def _stage(self, arr: np.ndarray, rows=None) -> torch.Tensor:
        """``arr`` (or its rows ``rows``) as a device uint8 tensor. On the
        card through the index's pinned ring, the copy enqueued on the
        current stream, not awaited."""
        if self.device.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(
                arr if rows is None else np.take(arr, rows, axis=0)))
        n = arr.shape[0] if rows is None else len(rows)
        out = torch.empty((n,) + tuple(arr.shape[1:]), dtype=torch.uint8, device=self.device)
        if n:
            with self._stage_lock:
                self._ring.copy(arr, rows, out.view(n, -1))
        return out

    def _scan_host_lists(self, probes_h: np.ndarray, bias, luts, k: int, nprobe: int):
        """Scan the probed lists that live in the memmap (every list in
        host storage, the cold ones in hybrid): the slot list built on the
        host from the probes, exactly the live segments gathered from the
        memmap, uploaded, scanned as tiles. The scan is enqueued, not
        awaited. -> (values [Q, k], tile rows [Q, k], canonical segment
        of each tile, stats)."""
        dev = self.device
        qn = probes_h.shape[0]
        pl = probes_h.reshape(-1).astype(np.int64)
        cnt = self._host_cnt[pl]
        sidx, pair = ragged_ranges(self._seg_start_h[pl], cnt)
        percnt = cnt.reshape(qn, nprobe).sum(axis=1)
        n = len(sidx)
        t0 = time.perf_counter()
        codes = self._stage(self.packed.data, sidx)
        # each tile's pair, query and live rows, then each query's slot
        # count, in one upload
        meta = np.concatenate([pair, pair // nprobe, np.asarray(self.packed.seg_valid)[sidx],
                               percnt]).astype(np.int64)
        meta = self._stage(meta.view(np.uint8).reshape(-1, 8)).view(torch.int64).reshape(-1)
        stats = {"tiles": n, "gathered_bytes": int(codes.numel()),
                 "gather_ms": (time.perf_counter() - t0) * 1e3}
        slots = Slots(seg_ids=torch.arange(n, dtype=torch.int32, device=dev),
                      q_ids=meta[n:2 * n].int(), valid=meta[2 * n:3 * n].int(),
                      pair=meta[:n], percnt=meta[3 * n:], maxcnt=int(percnt.max()))
        v, rows = self._scan_slots(codes, luts, bias, slots, k)
        return v, rows, sidx, stats

    def _rows_to_pos(self, rows: np.ndarray, seg_map=None) -> np.ndarray:
        """Flat rows (segment * SEG + within) -> corpus positions through
        the canonical row_ids (a memmap read of at most Q*k int32s).
        ``seg_map`` maps the scanned segments (hot or gathered tiles) to
        canonical ones."""
        seg = self.seg_size
        pos = np.full(rows.shape, -1, np.int64)
        live = rows >= 0
        r = rows[live]
        s = r // seg if seg_map is None else seg_map[r // seg]
        pos[live] = self.packed.row_ids[s, r % seg]
        return pos

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
        cold = None
        with torch.inference_mode():
            probes, bias, luts = self._probe(qt, nprobe)
            if self.storage == "host":
                v, rows, sidx, st = self._scan_host_lists(probes.cpu().numpy(), bias, luts, k,
                                                          nprobe)
                self.last_scan_stats = {"live_slots": st["tiles"], **st}
                # one device -> host copy of the winners
                return v.cpu().numpy(), self._rows_to_pos(rows.cpu().numpy(), sidx)
            slots = self._slots(probes, nprobe)     # waits for the probe
            self.last_scan_stats = {"live_slots": len(slots.seg_ids), "maxcnt": slots.maxcnt}
            # hybrid: the probes come to the host while the card is idle
            probes_h = probes.cpu().numpy() if self._has_cold else None
            v, rows = self._scan_slots(self._codes, luts, bias, slots, k)
            if self._has_cold:
                # the cold tail's host slot list and gather run while the
                # hot scan does; its scan is enqueued behind the hot one
                cold = self._scan_host_lists(probes_h, bias, luts, k, nprobe)
            # one device -> host copy of the winners; the JAX package packs
            # values and positions into one int32 transfer because the TPU
            # flushes f32 denormals, which the card does not
            v, rows = v.cpu().numpy(), rows.cpu().numpy()
            if cold is not None:
                vc, rc, sidx, st = cold
                vc, rc = vc.cpu().numpy(), rc.cpu().numpy()
        pos = self._rows_to_pos(rows, self._seg_map)
        if self.storage == "hybrid":
            self.last_scan_stats["cold_live_slots"] = 0 if cold is None else st["tiles"]
        if cold is None:
            return v, pos
        self.last_scan_stats.update(gathered_bytes=st["gathered_bytes"],
                                    gather_ms=st["gather_ms"])
        # hot and cold lists are disjoint: one stable sort of both top-k
        # lists, hot first, is the merge of every probed slot
        av = np.concatenate([v, vc], axis=1)
        ap = np.concatenate([pos, self._rows_to_pos(rc, sidx)], axis=1)
        sel = np.argsort(-av, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(av, sel, axis=1), np.take_along_axis(ap, sel, axis=1)

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
        the CUDA card). ``kw`` goes to the constructor (``storage``,
        ``hot_budget_bytes``, ``impl``, ...). Resident lists stream from
        the memmap to the device."""
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
