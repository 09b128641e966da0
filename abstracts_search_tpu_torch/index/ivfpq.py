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

Every storage runs the same scan body (``_scan_slots``).

Over a mesh (``mesh=``, ``parallel/mesh.py``), rank ``r`` of ``W`` holds
only the lists ``l % W == r``, in any storage: the resident install
gathers just its own segments from the memmap, and the host and cold
gathers read just its own lists. The probe is replicated (every rank
runs it on the same queries); each rank scans its own slots, resolves
its winners to corpus positions through the memmap, and one all-gather
merges the ranks' top-k lists (``merge_topk_all_gather``), so every
rank returns the same answer. ``W = 1`` without a process group is the
single-card path, with no collective. Artifacts are
the JAX package's (``meta.json``, ``centroids.npy``,
``pq_centroids.npy``, ``rotation.npy``, ``lists/``); ``load`` opens them
and ``save`` writes them.

The build (``train`` -> ``save`` -> ``load`` -> ``fill_stream`` ->
``save``, as ``astpu index train`` / ``fill`` run it):

- train: OPQ on a sub-sample (``opq.py``), coarse spherical k-means on
  the rotated sample (``kmeans.py``: kernel 1 at k 1), PQ codebooks on
  the sub-sample's residuals (``pq.py``). Three k-means modes by sample:
  staged on the card ("device"), a rotated disk memmap re-read every
  iteration ("streamed"), or a chunked device source rotated chunk by
  chunk ("device_streamed", the production build);
- fill: per chunk, one fused encode on the card (rotate, kernel-1
  assignment on bf16 operands, residual, PQ argmin, nibble pack), host
  rows first uploaded window by window through pinned buffers on a copy
  stream, so a window's upload overlaps the encode before it; the codes,
  assignments and positions then take one tail, picked once per fill:
  spilled to disk and packed into transposed CSR lists (``lists.py``)
  written straight to the artifact (``lists_dir``), or collected in
  memory and packed there. Codes bound for the host download one chunk behind the encode,
  through pinned memory. An in-memory fill on the card whose pack fits
  its free memory keeps the codes there and packs them there; the host
  keeps one download of the lists, and the install keeps the packed
  payload where the lists stay on the card.

The build over a mesh (every rank calls ``train`` and ``fill_stream``
with the same arguments):

- train: OPQ, k-means and PQ each sum their rank's block of rows and
  reduce the sums over the ranks in rank order, so every rank ends with
  the same rotation, centroids and codebooks, bit for bit;
- fill: the chunks of the stream are dealt round-robin before they are
  read, chunk ``i`` to rank ``i % W`` (``deal``; the driver deals the
  reader's row groups), and each rank encodes its chunks exactly as one
  process does and spills them to ``<parent>/.astpu_spill/p<rank>/``
  (with an ``.owner_p<rank>.json`` breadcrumb in the lists dir), as one
  process spills to ``p0/``. After a barrier rank 0 merges the spills
  back into stream order and runs the one external pack (a single
  writer), so the lists are byte for byte one process's; after a second
  barrier every rank installs its own lists.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import logging
import mmap
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..device import assert_exact_f32
from ..ops import _build, launch_counts
from ..ops.adc import adc_scan, adc_topk
from ..ops.topk import streaming_topk
from ..parallel.mesh import Mesh, index_mesh, process_barrier, shard_rows
from ..parallel.topk_merge import merge_topk_all_gather
from ..utils import trace
from ..utils.trace import StageTimer
from .kmeans import KMeans, _normalize_rows, _normalize_rows_t, _round_up
from .lists import (CSRLists, load_lists, pack_lists_external, ragged_ranges, rank_shard,
                    save_lists)
# the in-memory fill's one pack, where its codes are (on the host or on
# the card): ``lists.pack_lists_torch``, not ``lists.pack_lists``. The
# benchmark's planted pack fault (portbench/tests/test_portbench_cells.py)
# patches it under this name.
from .lists import pack_lists_torch as pack_lists
from .opq import OPQ, _rotate
from .pq import ProductQuantizer

logger = logging.getLogger(__name__)

NEG_INF = float("-inf")
STORAGES = ("device", "host", "hybrid", "auto")


@contextlib.contextmanager
def _timed(timing: dict, key: str, name: str, **counts):
    """A ``trace.measure`` span whose host seconds add to ``timing[key]``
    (the fill's stage seconds in ``fill_stats``)."""
    with trace.measure(name, **counts) as sp:
        yield sp
    timing[key] = timing.get(key, 0.0) + sp.host_s


def _to_host(v) -> np.ndarray:
    """``v`` as a host array. A card tensor lands in anonymous memory
    mapped with ``MAP_POPULATE``, its pages made in that one call: left to
    the copy, one thread faults them in one at a time, at a fraction of
    the copy's speed."""
    if not isinstance(v, torch.Tensor):
        return np.asarray(v)
    if v.device.type == "cpu" or not v.numel():
        return v.cpu().numpy()
    buf = mmap.mmap(-1, v.numel() * v.element_size(),
                    flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS | mmap.MAP_POPULATE)
    out = torch.frombuffer(buf, dtype=v.dtype).view(v.shape)
    out.copy_(v)
    return out.numpy()


def _on_host(chunks, timing: dict):
    """``(assignments, codes, positions)`` chunks -> the same chunks as
    host arrays, one chunk behind: a card chunk's copy into pinned memory
    is enqueued as it arrives, and the chunk before it is handed on once
    its own copy has landed, so the card encodes the next chunk while the
    host takes this one. A CPU tensor becomes its numpy view and a host
    array passes as it is. Each chunk's wait is one ``fill.download``
    span, whose host seconds add to ``timing["download_s"]``."""

    def landed(chunk, done):
        with _timed(timing, "download_s", "fill.download"):
            if done is not None:
                done.synchronize()
        assign, codes, positions = chunk
        return _to_host(assign), _to_host(codes), np.asarray(positions)

    pending = None
    for assign, codes, positions in chunks:
        done = None
        if isinstance(codes, torch.Tensor) and codes.is_cuda:
            stream = torch.cuda.current_stream(codes.device)
            assign, codes = [torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                             .copy_(v, non_blocking=True) for v in (assign, codes)]
            done = torch.cuda.Event()
            done.record(stream)
        if pending is not None:
            yield landed(*pending)
        pending = (assign, codes, positions), done
    if pending is not None:
        yield landed(*pending)


def _append(buf: torch.Tensor | None, n: int, v: torch.Tensor) -> torch.Tensor:
    """``buf`` with ``v`` at rows ``n:``, or, where ``v`` does not fit, a
    new buffer of twice the rows holding ``buf[:n]`` and ``v``. The card
    pack collects a fill's chunks so: each chunk kept as an allocation of
    its own would split the cached blocks that the next chunk's encode
    takes again, and kernel 1's call would then wait on ``cudaMalloc``."""
    m = n + len(v)
    if buf is None or m > len(buf):
        grown = torch.empty((2 * m,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
        if buf is not None:
            grown[:n] = buf[:n]
        buf = grown
    buf[n:m] = v
    return buf


def _take(arr: np.ndarray, rows, lo: int, hi: int, out=None):
    """Rows lo:hi of ``arr``, or of its row selection ``rows``."""
    if rows is None:
        if out is None:
            return arr[lo:hi]
        np.copyto(out, arr[lo:hi])
        return out
    # mode="clip" writes straight into ``out`` ("raise" buffers it)
    return np.take(arr, rows[lo:hi], axis=0, out=out, mode="clip")


def _pieces(n: int, row_bytes: int, piece_bytes: int) -> list[tuple[int, int]]:
    """Rows ``0:n`` of ``row_bytes`` each cut into consecutive ``(lo,
    hi)`` pieces of at most ``piece_bytes``: every row once, in order."""
    per = piece_bytes // row_bytes
    if per < 1:
        raise ValueError(f"{row_bytes}-byte rows do not fit {piece_bytes}-byte "
                         f"staging buffers")
    return [(lo, min(lo + per, n)) for lo in range(0, n, per)]


def _copy_rows(out: np.ndarray, src: np.ndarray, pool: ThreadPoolExecutor,
               threads: int) -> None:
    """``out[:] = src``, its rows split over ``threads`` threads: the
    caller's and ``threads - 1`` of ``pool``'s (numpy's copy releases the
    interpreter's lock)."""
    (lo, hi), *rest = _pieces(len(src), 1, -(-len(src) // threads))
    parts = [pool.submit(np.copyto, out[a:b], src[a:b]) for a, b in rest]
    np.copyto(out[lo:hi], src[lo:hi])
    for p in parts:
        p.result()


class _PinnedRing:
    """Two pinned host buffers that alternate, so reading the next chunk
    of an array into one overlaps the card's copy out of the other. A
    buffer is refilled only once the copy out of it has finished (one
    event per buffer), so the ring carries over from call to call. With
    ``threads`` > 1 a chunk of plain rows is read by that many threads at
    once (``_copy_rows``); a row selection is read by one."""

    def __init__(self, chunk_bytes: int, *, threads: int = 1):
        self.chunk_bytes = chunk_bytes
        self.bufs = [torch.empty(chunk_bytes, dtype=torch.uint8, pin_memory=True)
                     for _ in range(2)]
        self.done = [None, None]
        self.turn = 0
        self.threads = threads
        self.pool = ThreadPoolExecutor(threads - 1) if threads > 1 else None

    def copy(self, arr: np.ndarray, rows, out: torch.Tensor, stream=None) -> None:
        """Enqueue the copy of ``arr`` (or of its rows ``rows``) into the
        device bytes ``out`` [n, row_bytes] on ``stream`` (the current
        stream by default). Returns once the last chunk is read into
        pinned memory."""
        n, row_bytes = out.shape
        if stream is None:
            stream = torch.cuda.current_stream(out.device)
        for lo, hi in _pieces(n, row_bytes, self.chunk_bytes):
            b = self.turn
            self.turn ^= 1
            if self.done[b] is not None:
                self.done[b].synchronize()
            buf = self.bufs[b][: (hi - lo) * row_bytes]
            dst = buf.numpy().view(arr.dtype).reshape((hi - lo,) + arr.shape[1:])
            if self.pool is None or rows is not None:
                _take(arr, rows, lo, hi, out=dst)
            else:
                _copy_rows(dst, arr[lo:hi], self.pool, self.threads)
            with torch.cuda.stream(stream):
                out[lo:hi].copy_(buf.view(hi - lo, row_bytes), non_blocking=True)
            self.done[b] = torch.cuda.Event()
            self.done[b].record(stream)


class _RowStager:
    """Host f32 rows onto the card off the compute stream: the fill's host
    route (``IVFPQIndex.encode``). Each window is read piece by piece into
    a ``_PinnedRing`` of ``PIECE_BYTES`` buffers, by the process's
    intra-op threads, and copied across the link on a stream of its own
    into one of ``WINDOWS`` card windows taken in turn. The compute stream
    waits for each window's copy and nothing else waits for the compute stream,
    so the card encodes one window while the next crosses the link. A
    window is written again only after the compute stream's last use of
    it (``used``), so the stager carries over from call to call. The
    caller's rows are read and never kept: the pinned buffers are the
    stager's own, and the windows go at ``release``."""

    # a piece of the pinned ring: the host's read of one piece overlaps
    # the link's copy of the one before
    PIECE_BYTES = 32 << 20
    # card windows, taken in turn: a window's copy waits for the encode of
    # the rows copied into it before (a third bought nothing on the card)
    WINDOWS = 2

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.ring = _PinnedRing(self.PIECE_BYTES, threads=torch.get_num_threads())
        self.windows = [None] * self.WINDOWS
        self.free = [torch.cuda.Event() for _ in range(self.WINDOWS)]
        self.last = self.WINDOWS - 1

    def upload(self, x: np.ndarray) -> torch.Tensor:
        """Rows ``x`` [n, D] (contiguous f32) -> the same rows in a card
        window, the current stream ordered after their copy."""
        w = self.last = (self.last + 1) % self.WINDOWS
        compute = torch.cuda.current_stream(self.device)
        if self.windows[w] is None or self.windows[w].numel() < x.size:
            self.windows[w] = torch.empty(x.size, dtype=torch.float32, device=self.device)
            # the block's earlier users on the compute stream come first
            self.free[w].record(compute)
        out = self.windows[w][:x.size].view(x.shape)
        self.stream.wait_event(self.free[w])
        self.ring.copy(x, None, out.view(len(x), -1).view(torch.uint8), stream=self.stream)
        compute.wait_stream(self.stream)
        return out

    def used(self) -> None:
        """The compute stream's last use of the window ``upload`` returned
        is enqueued: the window is written again only after it."""
        self.free[self.last].record(torch.cuda.current_stream(self.device))

    def release(self) -> None:
        """Drop the card windows (kept from one ``upload`` to the next for
        one fill)."""
        self.windows = [None] * self.WINDOWS


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
        seed: int = 0,
        device=None,
        mesh: Mesh | None = None,
        _legacy_unnormalized: bool = False,
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
        # JAX package's pos_map="host"); over a mesh each rank resolves
        # its own winners before the merge, so no rank needs another's
        # layout or device-resident row ids.
        self.mesh = index_mesh(mesh, device)
        self.device = self.mesh.device
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
        self.seed = seed
        # The ADC scan ranks by inner product, which is not L2 on
        # unnormalized rows: a new non-spherical index is refused, as in
        # the JAX package. Artifacts built that way before still open
        # through load() (``_legacy_unnormalized``), serve-only.
        if not spherical and not _legacy_unnormalized:
            raise ValueError(
                "IVFPQIndex requires normalize/-N (spherical) mode: its "
                "ADC scan ranks by inner product, which is not L2 on "
                "unnormalized rows. Pass -N (the reference TRAINFLAGS "
                "always do) or use IVFFlatIndex for exact plain-L2 search.")
        self.kmeans = KMeans(n_lists, spherical=True, chunk=chunk, impl=impl, seed=seed,
                             mesh=self.mesh)
        self.pq = ProductQuantizer(dim, pq_m, pq_nbits, seed=seed, mesh=self.mesh)
        self.opq = OPQ(dim, pq_m, pq_nbits, seed=seed, mesh=self.mesh) if use_opq else None
        self.centroids: np.ndarray | None = None      # [n_lists, D]
        self.pq_centroids: np.ndarray | None = None   # [M, ksub, dsub]
        self.rotation = np.eye(dim, dtype=np.float32)
        self.train_stats: dict = {}
        # seconds and rows of the last fill (see fill_stream)
        self.fill_stats: dict = {}
        # host rows' staging onto the card (encode), made at first use
        self._stager: _RowStager | None = None
        self.packed: CSRLists | None = None
        self.n = 0
        self.last_scan_stats: dict = {}

    @property
    def code_bytes(self) -> int:
        """Stored bytes per vector: 4-bit codes are nibble-packed."""
        return self.pq_m // 2 if self.pq_nbits == 4 else self.pq_m

    @property
    def is_trained(self) -> bool:
        return self.kmeans.centroids is not None and self.pq.is_trained

    @property
    def resident_bytes(self) -> int:
        """Bytes of codes installed on the device: this rank's resident
        lists (all of them in device storage on one rank, the hot ones in
        hybrid, none in host storage)."""
        codes = getattr(self, "_codes", None)
        return 0 if codes is None else codes.numel()

    def _refuse_mutation(self, op: str) -> None:
        """A legacy non-spherical artifact is serve-only: building new
        data under its semantics hits the error a new construction gets."""
        if not self.spherical:
            raise ValueError(
                f"cannot {op}() a legacy non-spherical IVFPQIndex: this "
                "mode is serve-only (search/save). Rebuild with -N, or "
                "use IVFFlatIndex for exact plain-L2.")

    def set_params(self, centroids, pq_centroids, rotation) -> None:
        """Install trained state: centroids [n_lists, D], PQ codebooks
        [M, ksub, dsub] and the (OPQ) rotation [D, D], all f32. The
        k-means, PQ and OPQ members take the same arrays, and the card
        keeps the padded f32 and bf16 centroids, the codebooks and the
        rotation for the probe and the fused encode."""
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
        self.kmeans.centroids = c
        self.pq.centroids = pqc
        if self.opq is not None:
            self.opq.rotation = rot
            self.opq.pq.centroids = pqc
        k_pad = _round_up(self.n_lists, self.chunk)
        cp = torch.zeros((k_pad, self.dim), dtype=torch.float32, device=self.device)
        cp[: self.n_lists] = torch.from_numpy(c).to(self.device)
        self._cent = cp
        # resident bf16 copy for the probe; equal to a per-call cast
        self._cent_bf16 = cp.to(torch.bfloat16)
        self._pq_cent = torch.from_numpy(pqc).to(self.device)
        self._rot = torch.from_numpy(rot).to(self.device)

    # -- train -------------------------------------------------------------------

    # Samples above this byte size train in bounded-memory mode: OPQ/PQ
    # on an in-RAM sub-sample, k-means on the card or streaming a
    # rotated disk memmap
    TRAIN_INRAM_BYTES = 1 << 30
    # OPQ/PQ sub-sample rows (codebooks need ~hundreds of points per
    # code, not 10M rows)
    PQ_TRAIN_ROWS = 1 << 18
    # rows per kernel-1 call of the residual assignment and the encode
    ENCODE_ROWS = 1 << 18
    # rows of a k-means window in the streamed mode (a rank sums whole ones)
    TRAIN_WINDOW_ROWS = 1 << 18

    def train(self, sample, *, kmeans_iters: int = 10, opq_iters: int = 3,
              pq_iters: int = 10, workdir: str | Path | None = None) -> dict:
        """Train OPQ + coarse k-means + PQ.

        ``sample`` is an [N, D] array, an np.memmap (the production
        10M-row sample, ~40 GB f32, never lands in host RAM whole), or a
        chunked device source (``storage/virtual.py``). Small in-RAM
        samples train whole; the rest take ``_train_big``. ``train_stats``
        then holds each step's seconds and kernel launches under
        ``stages`` (``opq``, ``kmeans``, ``pq_residuals``)."""
        self._refuse_mutation("train")
        assert_exact_f32()
        timer = StageTimer(counters=launch_counts)
        big = (
            hasattr(sample, "device_chunk")
            or isinstance(sample, np.memmap)
            or sample.nbytes > self.TRAIN_INRAM_BYTES
        )
        if big:
            return self._train_big(sample, timer, kmeans_iters=kmeans_iters,
                                   opq_iters=opq_iters, pq_iters=pq_iters, workdir=workdir)
        sample = np.asarray(sample, np.float32)
        if self.spherical:
            sample = _normalize_rows(sample)
        if self.use_opq:
            with timer.stage("opq"):
                self.opq.train(sample, outer_iters=opq_iters, pq_iters=max(4, pq_iters // 2))
            self.rotation = self.opq.rotation
        xr = _rotate(sample, self.rotation, self.device)
        with timer.stage("kmeans"):
            self.kmeans.fit(xr, iters=kmeans_iters)
        with timer.stage("pq_residuals"):
            _, assign = self.kmeans.assign(xr)
            residuals = xr - self.kmeans.centroids[assign]
            self.pq.train(residuals, iters=pq_iters)
        self._finish_train_stats(timer)
        return self.train_stats

    def _train_big(self, sample, timer, *, kmeans_iters, opq_iters, pq_iters, workdir):
        import tempfile

        n, dim = sample.shape
        rng = np.random.default_rng(self.seed)
        device_src = hasattr(sample, "device_chunk")

        # 1) OPQ on an in-RAM sub-sample, staged on the card once; with
        # keep_staged, step 4 reuses the staged rows for the residuals
        sub_idx = np.sort(rng.choice(n, min(self.PQ_TRAIN_ROWS, n), replace=False))
        if device_src:
            sub = sample.gather_rows(sub_idx)      # only the sub-sample rows
        else:
            sub = np.asarray(sample[sub_idx], np.float32)
        if self.spherical:
            sub = _normalize_rows(sub)
        if self.use_opq:
            with timer.stage("opq"):
                self.opq.train(sub, outer_iters=opq_iters, pq_iters=max(4, pq_iters // 2),
                               keep_staged=True)
            self.rotation = self.opq.rotation

        # 2+3) coarse k-means over the full sample, in one of three modes
        rotated_rows = None
        device_fit = (
            not device_src
            and not isinstance(sample, np.memmap)
            and n * dim * 4 <= self.kmeans.DEVICE_BUDGET_BYTES
        )
        if device_src:
            # chunks (re)made on the card each iteration, rotated there;
            # the accumulators never leave it (kmeans._fit_device_stream)
            from ..storage.virtual import RotatedDeviceSource

            src = (RotatedDeviceSource(sample, self.rotation, self.device)
                   if self.use_opq else sample)
            with timer.stage("kmeans"):
                self.kmeans.fit(src, iters=kmeans_iters)
            mode = "device_streamed"
        elif device_fit:
            with timer.stage("kmeans"):
                self._kmeans_device_resident(sample, kmeans_iters=kmeans_iters)
            mode = "device"
        else:
            # rotate the rows this rank sums (its block of the one-process
            # windows; every row in one process) into a disk memmap,
            # re-read every iteration; host RSS stays O(window)
            owns_workdir = workdir is None
            workdir = (Path(tempfile.mkdtemp(prefix="astpu_train_")) if owns_workdir
                       else Path(workdir))
            workdir.mkdir(parents=True, exist_ok=True)
            rot_path = workdir / ("train_rot.f32" if self.mesh.size == 1
                                  else f"train_rot.p{self.mesh.rank}.f32")
            step = self.TRAIN_WINDOW_ROWS
            lo, hi, _ = shard_rows(-(-n // step), self.mesh)
            src = None
            try:
                src = _RotatedSample(sample, self.rotation, self.device, self.spherical,
                                     lo * step, min(hi * step, n), rot_path, step)
                with timer.stage("kmeans"):
                    self.kmeans.fit([src], iters=kmeans_iters, batch_rows=step,
                                    prenormalized=True)
            finally:
                del src
                if owns_workdir:
                    shutil.rmtree(workdir, ignore_errors=True)
                else:
                    rot_path.unlink(missing_ok=True)
            mode = "streamed"
            rotated_rows = min(hi * step, n) - lo * step

        # 4) PQ on the sub-sample's residuals, computed on the card
        with timer.stage("pq_residuals"):
            self._train_pq_residuals(sub, pq_iters=pq_iters)

        self._finish_train_stats(timer)
        self.train_stats["train_mode"] = mode
        self.train_stats["pq_train_rows"] = int(len(sub))
        if rotated_rows is not None:    # the rows this rank rotated to disk
            self.train_stats["rotated_rows"] = int(rotated_rows)
        return self.train_stats

    def _stage_rows(self, x: np.ndarray):
        """Host rows -> (x [n, D] f32 on the card, n)."""
        x = np.ascontiguousarray(np.asarray(x, np.float32))
        return torch.from_numpy(x).to(self.device), len(x)

    def _kmeans_device_resident(self, sample, *, kmeans_iters):
        """Stage the sample once, normalize and rotate it in place window
        by window (one live copy of the sample), then Lloyd on it."""
        x, n = self._stage_rows(sample)
        rot = torch.from_numpy(self.rotation).to(self.device)
        for lo in range(0, n, self.ENCODE_ROWS):
            xs = x[lo:lo + self.ENCODE_ROWS]
            if self.spherical:
                xs = _normalize_rows_t(xs)
            x[lo:lo + self.ENCODE_ROWS] = xs @ rot
        self.kmeans.fit_staged(x, n, iters=kmeans_iters)

    def _train_pq_residuals(self, sub: np.ndarray, *, pq_iters: int):
        """Residual PQ training on the card: rotate, coarse-assign
        (kernel 1 at k 1 on bf16 operands) and subtract, then the PQ
        Lloyd loop on the residuals. Reuses the rows OPQ staged."""
        staged = self.opq.staged() if self.use_opq else None
        xj, nsub = self._stage_rows(sub) if staged is None else staged
        rot = torch.from_numpy(self.rotation).to(self.device)
        c_pad = self.kmeans._centroids_padded()
        c_bf16 = c_pad.to(torch.bfloat16)
        res = torch.empty_like(xj)
        for lo in range(0, nsub, self.ENCODE_ROWS):
            xr = xj[lo:lo + self.ENCODE_ROWS] @ rot
            _, idx = streaming_topk(xr.to(torch.bfloat16), c_bf16, self.n_lists, 1,
                                    chunk=self.chunk, impl=self.impl)
            res[lo:lo + self.ENCODE_ROWS] = xr - c_pad[idx[:, 0].long()]
        del xj, staged, c_pad, c_bf16
        if self.use_opq:
            self.opq.drop_staged()
        self.pq.train_staged(res.view(nsub, self.pq_m, self.dsub), nsub, iters=pq_iters)

    def _finish_train_stats(self, timer: StageTimer) -> None:
        self.train_stats = {
            "kmeans": self.kmeans.stats,
            "pq": self.pq.stats,
            "opq": self.opq.stats if self.use_opq else None,
            "pq_m": self.pq_m,
            "pq_nbits": self.pq_nbits,
            "stages": timer.stages,
        }
        # the trained arrays become the index's own, on the card too
        self.set_params(self.kmeans.centroids, self.pq.centroids, self.rotation)

    # -- fill --------------------------------------------------------------------

    def _encode_fused(self, x: torch.Tensor):
        """One pass on the card per window of ``ENCODE_ROWS`` rows: rotate
        (f32), coarse-assign (kernel 1 at k 1 on bf16 operands), take the
        residual against the f32 centroid, PQ argmin, and nibble-pack
        4-bit codes to the storage format. -> (assignments [n] i64, codes
        [n, code_bytes] u8), on the card."""
        n = x.shape[0]
        m = self.pq_m
        assign = torch.empty(n, dtype=torch.int64, device=self.device)
        codes = torch.empty((n, self.code_bytes), dtype=torch.uint8, device=self.device)
        for lo in range(0, n, self.ENCODE_ROWS):
            xr = x[lo:lo + self.ENCODE_ROWS] @ self._rot
            _, idx = streaming_topk(xr.to(torch.bfloat16), self._cent_bf16, self.n_lists, 1,
                                    chunk=self.chunk, impl=self.impl)
            a = idx[:, 0].long()
            res = (xr - self._cent[a]).view(-1, m, self.dsub)
            del xr
            c = self.pq.assign(res, self._pq_cent).to(torch.uint8)
            if self.pq_nbits == 4:
                c3 = c.view(-1, m // 2, 2)
                c = c3[..., 0] | (c3[..., 1] << 4)
            assign[lo:lo + len(a)] = a
            codes[lo:lo + len(a)] = c
        return assign, codes

    def encode(self, vectors, *, batch_rows: int = 1 << 18, timing: dict | None = None):
        """-> (list assignment [N] i64, residual PQ codes [N, code_bytes]
        u8 in the storage format: 4-bit codes arrive nibble-packed). The
        fill's one encode step, for every chunk: the benchmark's planted
        code and assignment faults patch this method to reach the fill's
        lists, so the fill calls nothing below it. A tensor goes to the
        device whole. Host rows go up as they are, ``batch_rows`` at a
        time, each window under a ``fill.upload`` span and its
        normalisation under a ``fill.normalize`` span; on the card through
        this index's ``_RowStager`` (pinned buffers, a copy stream), so a
        window's copy overlaps the encode of the window, or the call,
        before it. Either is normalised on the device when spherical and
        takes the fused encode there.

        ``timing``: a fill's stage seconds (``fill_stream``'s call). The
        windows' spans add their host seconds (the upload's: the wait for
        a pinned buffer, the read into it and the enqueue; the
        normalisation's: the enqueue) to its ``upload_s`` and
        ``normalize_s``, the rows staged through pinned memory to its
        ``upload_pinned_rows``, and the outputs stay tensors on this
        index's device for the fill's tail, which downloads them once
        where the host takes them (``_on_host``); the fill releases the
        stager's card windows at its end. Without it the outputs download
        once and return as numpy arrays, and the windows go at once."""
        if not self.is_trained:
            raise RuntimeError("train() before encode()")
        if isinstance(vectors, torch.Tensor):
            x = vectors.to(self.device, torch.float32)
            assign, codes = self._encode_fused(_normalize_rows_t(x) if self.spherical else x)
        else:
            x = np.asarray(vectors, np.float32)
            assign = torch.empty(len(x), dtype=torch.int64, device=self.device)
            codes = torch.empty((len(x), self.code_bytes), dtype=torch.uint8, device=self.device)
            spans = {} if timing is None else timing
            stager = self._row_stager()
            for lo in range(0, len(x), batch_rows):
                xh = np.ascontiguousarray(x[lo:lo + batch_rows])
                with _timed(spans, "upload_s", "fill.upload", bytes=xh.nbytes,
                            pinned=int(stager is not None)):
                    xc = torch.from_numpy(xh).to(self.device) if stager is None \
                        else stager.upload(xh)
                if self.spherical:
                    with _timed(spans, "normalize_s", "fill.normalize", rows=len(xc)):
                        xc = _normalize_rows_t(xc)
                assign[lo:lo + len(xc)], codes[lo:lo + len(xc)] = self._encode_fused(xc)
                if stager is not None:
                    stager.used()
                    spans["upload_pinned_rows"] = spans.get("upload_pinned_rows", 0) + len(xh)
            if stager is not None and timing is None:
                stager.release()
        if timing is not None:
            return assign, codes
        return assign.cpu().numpy(), codes.cpu().numpy()

    def _row_stager(self) -> _RowStager | None:
        """This index's ``_RowStager``, made at its first host rows on the
        card; None off the card."""
        if self.device.type != "cuda":
            return None
        if self._stager is None:
            self._stager = _RowStager(self.device)
        return self._stager

    def fill(self, vectors: np.ndarray, positions: np.ndarray | None = None) -> None:
        if positions is None:
            positions = np.arange(len(vectors), dtype=np.int64)
        self.fill_stream([(vectors, positions)])

    def fill_stream(self, chunks, *, lists_dir: str | Path | None = None) -> None:
        """Stream (vectors, positions) chunks, the rows numpy arrays or
        tensors: each chunk is encoded onto this index's device
        (``encode``), and the encoded chunks take the tail that
        ``fill_encoded_stream`` picks: spilled to ``lists_dir`` (the
        production path: host RSS stays O(corpus/80)), or packed in
        memory, on the card where the pack fits. Two chunks are pulled
        ahead on a reader thread.

        Over a mesh of several ranks each rank passes only its own chunks,
        chunk ``i`` of the stream to rank ``i % W`` (dealt before they are
        read: ``deal``), and the same ``lists_dir`` (required; module
        docstring).

        ``fill_stats`` then holds rows, rows_per_s and the host seconds of
        each stage's ``fill.<stage>`` spans (the ``fill.job`` span's
        children): encode (each chunk's encode; on the card, its enqueue
        and its host rows' uploads), download (each chunk's wait for its
        codes on the host, ``_on_host``: none where the card packs), spill
        (``fill.collect``: the chunks' codes kept in memory, or spilled to
        disk, and where the card pack gives way midway, the move of what
        the card had collected to the host), pack, install, and, for host
        rows, upload (the host's side of the host-to-card copies: on the
        card the wait for a pinned buffer, the read into it and the
        enqueue) and normalize (rows to unit norm on the card: the
        enqueue), both inside encode; ``upload_pinned_rows`` counts the
        host rows staged through pinned memory (0 off the card) and
        ``pack_on_card`` the rows the card packed."""
        from ..utils import prefetch_iterator

        self._refuse_mutation("fill")
        assert_exact_f32()
        with trace.span("fill.job"):
            stream = prefetch_iterator(iter(chunks), depth=2)
            timing = {**dict.fromkeys(("normalize_s", "upload_s", "encode_s"), 0.0),
                      "upload_pinned_rows": 0}

            def encoded():
                try:
                    for vectors, positions in stream:
                        with _timed(timing, "encode_s", "fill.encode"):
                            assign, codes = self.encode(vectors, timing=timing)
                        yield assign, codes, np.asarray(positions)
                finally:
                    if self._stager is not None:
                        self._stager.release()

            self.fill_encoded_stream(encoded(), lists_dir=lists_dir)
            self.fill_stats.update(timing)

    def fill_encoded_stream(self, chunks, *, lists_dir: str | Path | None = None) -> None:
        """Fill from encoded ``(assignments, codes, positions)`` chunks,
        host arrays or tensors (``fill_stream``'s own, on this index's
        device). A filled index is not filled again: refills go through
        the empty (trained) artifact. Over a mesh each rank passes its own
        chunks, ``i % W == rank`` of the stream, in order, and the same
        ``lists_dir`` (required at W > 1).

        The tail is picked here. With ``lists_dir`` the chunks spill to
        disk (``_fill_spilled``). Without it they collect in memory and
        one ``lists.pack_lists_torch`` packs them where they are: chunks
        that arrive as tensors on this index's device collect there while
        the pack's bytes (``_card_pack_bytes``) fit the card's room
        (``_card_room``). At the first chunk that does not fit, or that
        arrives on the host, the collection moves to the host. Every
        chunk that the host takes comes through ``_on_host``."""
        self._refuse_mutation("fill")
        if not self.is_trained:
            raise RuntimeError("train() before fill()")
        if self.packed is not None:
            raise RuntimeError(
                "index already filled; load the empty (trained) artifacts "
                "and re-fill the full corpus instead of appending")
        if self.mesh.size > 1 and lists_dir is None:
            raise ValueError(
                f"a fill over a mesh of {self.mesh.size} ranks needs lists_dir: each "
                "rank spills beside it and rank 0 packs the lists there")
        timing = dict.fromkeys(("download_s", "spill_s", "pack_s"), 0.0)
        if lists_dir is not None:
            return self._fill_spilled(_on_host(chunks, timing), Path(lists_dir), timing)
        t_start = time.perf_counter()
        room = self._card_room()
        chunks = iter(chunks)
        parts = ([], [], [])    # codes, assignments and positions on the host
        card = [None, None]     # codes and assignments on the card, rows :n
        n, rest = 0, None
        for assign, codes, positions in chunks:
            m = n + len(codes)
            # on the host, or past the room at the fewest segments these
            # rows can take: the rest of the stream packs on the host
            if (room is None or not isinstance(codes, torch.Tensor)
                    or codes.device.type != self.device.type
                    or self._card_pack_bytes(m, -(-m // self.seg_size)) > room):
                rest = itertools.chain([(assign, codes, positions)], chunks)
                break
            with _timed(timing, "spill_s", "fill.collect"):
                parts[2].append(np.asarray(positions))
                card = [_append(buf, n, v) for buf, v in zip(card, (codes, assign))]
            n = m
        on_card = rest is None and n > 0
        if on_card:
            with _timed(timing, "spill_s", "fill.collect"):
                counts = torch.bincount(card[1][:n], minlength=self.n_lists)
                n_segs = int(((counts + self.seg_size - 1) // self.seg_size).sum())
            on_card = self._card_pack_bytes(n, max(n_segs, 1)) <= room
        if not on_card:
            counts = None
            if n:
                with _timed(timing, "spill_s", "fill.collect"):
                    for p, buf in zip(parts, card):
                        p.append(_to_host(buf[:n]))
            card = None
            for assign, codes, positions in _on_host(rest or (), timing):
                with _timed(timing, "spill_s", "fill.collect"):
                    # copies in pageable memory: a card chunk lands in pinned
                    # memory, which so goes back at once, not at the pack
                    for p, v in zip(parts, (codes, assign, positions)):
                        p.append(np.array(v))
                n += len(codes)
        payload = []    # the packed payload on the card, for the install alone
        with _timed(timing, "pack_s", "fill.pack", rows=n, on_card=int(on_card)):
            if on_card:
                codes, assign = (buf[:n] for buf in card)
                card = None
                positions = torch.as_tensor(np.concatenate(parts[2]), dtype=torch.int64,
                                            device=codes.device)
            else:
                codes, assign, positions = (
                    torch.from_numpy(np.concatenate(p).astype(t, copy=False))
                    for p, t in zip(parts, (np.uint8, np.int64, np.int64)))
            lists = pack_lists(codes, positions, assign, self.n_lists,
                               seg_size=self.seg_size, counts=counts)
            del codes, assign, positions
            packed = dataclasses.replace(lists, **{
                f: _to_host(getattr(lists, f))
                for f in ("data", "row_ids", "seg_valid", "seg_start", "seg_cnt")})
            if on_card:
                payload.append(lists.data)
            del lists
        seconds = time.perf_counter() - t_start
        with _timed(timing, "install_s", "fill.install"):
            # the payload's one reference passes to the install, which drops
            # it before any upload where the lists do not stay on the card
            self._install(packed, payload.pop() if payload else None)
        self.fill_stats = {"rows": int(packed.n_rows), "seconds": seconds,
                           "rows_per_s": packed.n_rows / seconds if seconds else 0.0, **timing,
                           "pack_on_card": n if on_card else 0}

    def _card_room(self) -> int | None:
        """Bytes of this index's card that an in-memory fill may take for
        its card pack, its free memory less ``AUTO_HEADROOM_BYTES``; None
        off the card."""
        if self.device.type != "cuda":
            return None
        free, _ = torch.cuda.mem_get_info(self.device)
        return free - self.AUTO_HEADROOM_BYTES

    def _card_pack_bytes(self, n: int, n_segs: int) -> int:
        """A bound on the card's bytes that an in-memory fill of ``n`` rows
        in ``n_segs`` segments holds from its collection to the end of its
        card pack: the collection's buffers, which double and so hold up to
        2n rows of codes and i64 assignments (3n while they grow: less than
        the rest of the bound); the i64 positions; the pack's i64 vectors
        of n (the sort's keys, indices and buffers, then the slots and their
        temporaries: 6 at most); the stage, the transposed payload and the
        row ids."""
        mb = self.code_bytes
        return n * (2 * (mb + 8) + 8 + 6 * 8) + n_segs * self.seg_size * (2 * mb + 4)

    def _fill_spilled(self, stream, lists_dir: Path, timing: dict) -> None:
        """The fill's tail with ``lists_dir`` (the production path, in one
        process or over a mesh), over host chunks (``_on_host``), adding
        to the stage seconds ``timing``: each rank spills its chunks'
        codes, assignments and positions to ``<parent>/.astpu_spill/
        p<rank>/``; rank 0 packs them into ``lists_dir`` with the external
        pack (a single writer), straight from its own spill at W = 1, else
        from every rank's spill merged back into stream order (chunk ``i``
        from rank ``i % W``), so the lists equal one process's byte for
        byte; then every rank installs its own lists. Over a group each
        rank also leaves an ``.owner_p<rank>.json`` breadcrumb in
        ``lists_dir`` and the ranks meet at a barrier before and after the
        pack (the JAX package's ``_fill_encoded_multihost``)."""
        t_start = time.perf_counter()
        w, rank = self.mesh.size, self.mesh.rank
        spill_root = lists_dir.parent / ".astpu_spill"
        mine = spill_root / f"p{rank}"
        if mine.exists():
            shutil.rmtree(mine)
        mine.mkdir(parents=True)
        lists_dir.mkdir(parents=True, exist_ok=True)
        rows = []
        with open(mine / "codes.u8", "wb") as cf, open(mine / "assign.i32", "wb") as af, \
             open(mine / "pos.i64", "wb") as pf:
            for assign, codes, positions in stream:
                with _timed(timing, "spill_s", "fill.collect"):
                    np.ascontiguousarray(codes, np.uint8).tofile(cf)
                    np.asarray(assign).astype(np.int32).tofile(af)
                    np.asarray(positions, np.int64).tofile(pf)
                rows.append(len(codes))
        n_local = int(sum(rows))
        if self.mesh.collective:
            np.asarray(rows, np.int64).tofile(mine / "rows.i64")
            logger.info("fill[rank %d/%d]: spilled %d rows of %d chunks", rank, w, n_local,
                        len(rows))
            (lists_dir / f".owner_p{rank}.json").write_text(json.dumps(
                {"process": rank, "rows": n_local, "chunks": len(rows)}))
        t0 = time.perf_counter()
        process_barrier(self.mesh)
        wait_s = time.perf_counter() - t0
        if rank == 0:
            with _timed(timing, "pack_s", "fill.pack"):
                try:
                    src = mine
                    if w > 1:
                        _merge_spills(spill_root, w, self.code_bytes)
                        src = spill_root
                    n_total = (src / "pos.i64").stat().st_size // 8
                    # all three spill streams stay memmapped: the pack's count
                    # and routing passes read assignments slab by slab
                    pack_lists_external(
                        np.memmap(src / "codes.u8", dtype=np.uint8, mode="r",
                                  shape=(n_total, self.code_bytes)),
                        np.memmap(src / "pos.i64", dtype=np.int64, mode="r", shape=(n_total,)),
                        np.memmap(src / "assign.i32", dtype=np.int32, mode="r",
                                  shape=(n_total,)),
                        self.n_lists, seg_size=self.seg_size, out_dir=lists_dir,
                        transposed=True)
                finally:
                    shutil.rmtree(spill_root, ignore_errors=True)
        t0 = time.perf_counter()
        process_barrier(self.mesh)
        wait_s += time.perf_counter() - t0
        seconds = time.perf_counter() - t_start
        packed = load_lists(lists_dir, mmap=True)
        with _timed(timing, "install_s", "fill.install"):
            self._install(packed)
        self.fill_stats = {"rows": int(packed.n_rows), "seconds": seconds,
                           "rows_per_s": packed.n_rows / seconds if seconds else 0.0,
                           **timing, "pack_on_card": 0, "barrier_s": wait_s, "rank": rank,
                           "mesh_size": w, "rank_rows": n_local, "rank_chunks": len(rows)}

    # -- install -----------------------------------------------------------------

    def _install(self, packed: CSRLists, data: torch.Tensor | None = None) -> None:
        """Serve ``packed`` in this index's storage. ``data``: its payload
        already on this card (the in-memory fill's card pack), which "auto"
        counts as free: kept as it is where the storage is "device",
        instead of uploaded again, and dropped otherwise."""
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
        # this rank's lists: every list on one rank
        owned = self.mesh.owned(packed.n_lists)
        if self.storage == "auto":
            self.storage = self._resolve_auto_storage(
                packed, seg_bytes, owned, 0 if data is None else data.nbytes)
        if self.storage != "device":
            data = None
        self._codes = self._seg_map = None
        self._has_cold = False
        self._seg_start_h = np.asarray(packed.seg_start, np.int64)
        if self.storage == "device":
            self._install_resident(packed, None if self.mesh.size == 1 else owned, data)
        else:
            if self.storage == "hybrid":
                hot = self._pick_hot_lists(packed, seg_bytes, owned)
                self._install_resident(packed, hot)
                cnt = np.where(owned & ~hot, packed.seg_cnt, 0)
                self._has_cold = bool(cnt.any())
            else:
                cnt = np.where(owned, packed.seg_cnt, 0)
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

    def _install_resident(self, packed: CSRLists, lists, data=None) -> None:
        """Upload every list (``lists`` None; ``data``: the payload
        already there) or only the segments of the ``lists`` (a [n_lists]
        mask: this rank's lists, of those the hot ones in hybrid storage),
        compacted in list order, with a device CSR in which the other
        lists count 0; ``_seg_map`` maps a compacted segment to its
        canonical one, so rows still resolve through ``row_ids``."""
        dev = self.device
        if lists is None:
            # [n_segs, MB, SEG] | [n_segs, SEG, MB]
            self._codes = _upload(packed.data, dev) if data is None else data
            valid, start, cnt = packed.seg_valid, packed.seg_start, packed.seg_cnt
        else:
            # the masked lists' part of the mesh's shard: only these
            # segments are read from the memmap
            shard = rank_shard(packed.seg_start, np.where(lists, packed.seg_cnt, 0),
                               self.mesh.size, self.mesh.rank)
            self._codes = _upload(packed.data, dev, rows=shard.segs)
            start, cnt = shard.seg_start, shard.seg_cnt
            valid = np.asarray(packed.seg_valid)[shard.segs]
            self._seg_map = shard.segs
        self._seg_valid = torch.from_numpy(np.asarray(valid, np.int32)).to(dev)
        self._seg_start = torch.from_numpy(np.asarray(start, np.int64)).to(dev)
        self._seg_cnt = torch.from_numpy(np.asarray(cnt, np.int64)).to(dev)

    def _resolve_auto_storage(self, packed: CSRLists, seg_bytes: int, owned,
                              held: int = 0) -> str:
        """"device" or "hybrid" by this rank's lists against its own card,
        of which ``held`` bytes (the payload already there) count as free."""
        if self.device.type != "cuda":
            return "device"
        payload = int(np.asarray(packed.seg_cnt, np.int64)[owned].sum()) * seg_bytes
        free, _ = torch.cuda.mem_get_info(self.device)
        storage, budget = auto_storage(payload, free + held, self.n_lists * self.dim * 4,
                                       self.AUTO_HEADROOM_BYTES)
        if storage == "hybrid":
            self.hot_budget_bytes = budget
            logger.info("storage=auto: %.2f GiB of codes exceed %.2f GiB free less "
                        "%.1f GiB headroom; serving hybrid with a %.2f GiB hot budget",
                        payload / 2**30, free / 2**30, self.AUTO_HEADROOM_BYTES / 2**30,
                        budget / 2**30)
        return storage

    def _pick_hot_lists(self, packed: CSRLists, seg_bytes: int, owned) -> np.ndarray:
        """This rank's largest lists first until the hot budget (of its
        own card) is spent: big lists are probed most and cost most. Row
        ids stay on the host, so a segment costs its payload bytes."""
        cnt = np.where(owned, packed.seg_cnt, 0).astype(np.int64)
        order = np.argsort(-cnt, kind="stable")
        cum = np.cumsum(cnt[order] * seg_bytes)
        hot = np.zeros(packed.n_lists, bool)
        hot[order[cum <= self.hot_budget_bytes]] = True
        return hot & owned

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
        with trace.span("ivfpq.slots"):
            qn = probes_h.shape[0]
            pl = probes_h.reshape(-1).astype(np.int64)
            cnt = self._host_cnt[pl]
            sidx, pair = ragged_ranges(self._seg_start_h[pl], cnt)
            percnt = cnt.reshape(qn, nprobe).sum(axis=1)
            n = len(sidx)
        seg_bytes = int(np.prod(self.packed.data.shape[1:]))
        with trace.measure("ivfpq.gather", bytes=n * seg_bytes) as gather:
            codes = self._stage(self.packed.data, sidx)
            # each tile's pair, query and live rows, then each query's slot
            # count, in one upload
            meta = np.concatenate([pair, pair // nprobe, np.asarray(self.packed.seg_valid)[sidx],
                                   percnt]).astype(np.int64)
            meta = self._stage(meta.view(np.uint8).reshape(-1, 8)).view(torch.int64).reshape(-1)
        stats = {"tiles": n, "gathered_bytes": int(codes.numel()),
                 "gather_ms": gather.host_s * 1e3}
        slots = Slots(seg_ids=torch.arange(n, dtype=torch.int32, device=dev),
                      q_ids=meta[n:2 * n].int(), valid=meta[2 * n:3 * n].int(),
                      pair=meta[:n], percnt=meta[3 * n:], maxcnt=int(percnt.max()))
        with trace.span("ivfpq.scan", device=dev, slots=n):
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
        padded) as numpy arrays. Over a mesh this is a collective: every
        rank calls it with the same arguments, scans its own lists, and
        gets the merged answer."""
        if self.packed is None:
            raise RuntimeError("no lists installed: load a filled index")
        assert_exact_f32()
        nprobe = min(nprobe, self.n_lists)
        with trace.span("ivfpq.search", queries=len(queries), nprobe=nprobe):
            v, pos = self._search_shard(queries, k, nprobe)
            if not self.mesh.collective:
                return v, pos
            st = self.last_scan_stats
            mine = torch.tensor([st["live_slots"], st.get("cold_live_slots", 0)])
            v, pos, ranks = merge_topk_all_gather(torch.from_numpy(v), torch.from_numpy(pos), k,
                                                  self.mesh, stats=mine)
        st.update(live_slots=int(ranks[:, 0].sum()), live_slots_by_rank=ranks[:, 0].tolist())
        if "cold_live_slots" in st:
            st["cold_live_slots"] = int(ranks[:, 1].sum())
        return v.numpy(), pos.numpy()

    def _search_shard(self, queries: np.ndarray, k: int, nprobe: int):
        """This rank's lists' top-k (every list on one rank): the probe,
        the slot list, the scan and the merge of its slots, then the
        winners' corpus positions. -> numpy (scores, positions)."""
        q = np.asarray(queries, np.float32)
        if self.spherical:
            q = _normalize_rows(q)
        qt = torch.from_numpy(np.ascontiguousarray(q)).to(self.device)
        cold = None
        dev = self.device
        with torch.inference_mode():
            with trace.span("ivfpq.probe", device=dev):
                probes, bias, luts = self._probe(qt, nprobe)
            if self.storage == "host":
                v, rows, sidx, st = self._scan_host_lists(probes.cpu().numpy(), bias, luts, k,
                                                          nprobe)
                self.last_scan_stats = {"live_slots": st["tiles"], **st}
                # one device -> host copy of the winners
                with trace.span("ivfpq.winners"):
                    v, rows = v.cpu().numpy(), rows.cpu().numpy()
                with trace.span("ivfpq.positions"):
                    return v, self._rows_to_pos(rows, sidx)
            with trace.span("ivfpq.slots", device=dev):
                slots = self._slots(probes, nprobe)     # waits for the probe
            self.last_scan_stats = {"live_slots": len(slots.seg_ids), "maxcnt": slots.maxcnt}
            # hybrid: the probes come to the host while the card is idle
            probes_h = probes.cpu().numpy() if self._has_cold else None
            with trace.span("ivfpq.scan", device=dev, slots=len(slots.seg_ids)):
                v, rows = self._scan_slots(self._codes, luts, bias, slots, k)
            if self._has_cold:
                # the cold tail's host slot list and gather run while the
                # hot scan does; its scan is enqueued behind the hot one
                cold = self._scan_host_lists(probes_h, bias, luts, k, nprobe)
            # one device -> host copy of the winners; the JAX package packs
            # values and positions into one int32 transfer because the TPU
            # flushes f32 denormals, which the card does not
            with trace.span("ivfpq.winners"):
                v, rows = v.cpu().numpy(), rows.cpu().numpy()
                if cold is not None:
                    vc, rc, sidx, st = cold
                    vc, rc = vc.cpu().numpy(), rc.cpu().numpy()
        with trace.span("ivfpq.positions"):
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
        with trace.span("ivfpq.positions"):
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
            "train_stats": _json_safe(self.train_stats),
        }
        (d / "meta.json").write_text(json.dumps(meta, indent=2))
        if include_lists and self.packed is not None:
            target = d / "lists"
            # when fill_stream(lists_dir=...) already wrote the memmap
            # artifact in place, saving again would read and write the
            # same file: skip the copy
            existing = getattr(self.packed.data, "filename", None)
            if existing is not None and Path(existing).resolve().parent == target.resolve():
                return
            save_lists(self.packed, target)

    @classmethod
    def load(cls, directory: str | Path, *, device=None, mesh: Mesh | None = None,
             **kw) -> "IVFPQIndex":
        """Open JAX- or port-written artifacts on ``device`` (default:
        the CUDA card), or on this rank of ``mesh`` (its device; the
        canonical layout reopens on any mesh size, each rank reading only
        its own lists). ``kw`` goes to the constructor (``storage``,
        ``hot_budget_bytes``, ``impl``, ...). Resident lists stream from
        the memmap to the device. An empty (trained, unfilled) artifact
        opens ready for ``fill_stream``."""
        d = Path(directory)
        meta = json.loads((d / "meta.json").read_text())
        if not meta["spherical"]:
            logger.warning("%s was built without -N; serving it with the "
                           "semantics it was built with", d)
        idx = cls(meta["n_lists"], meta["dim"], pq_m=meta["pq_m"],
                  pq_nbits=meta["pq_nbits"], use_opq=meta["use_opq"],
                  seg_size=meta["seg_size"], spherical=meta["spherical"],
                  device=device, mesh=mesh, _legacy_unnormalized=not meta["spherical"],
                  **kw)
        idx.set_params(np.load(d / "centroids.npy"), np.load(d / "pq_centroids.npy"),
                       np.load(d / "rotation.npy"))
        idx.train_stats = meta.get("train_stats", {})
        if (d / "lists").is_dir():
            idx._install(load_lists(d / "lists", mmap=True))
        return idx


class _RotatedSample:
    """The rotated training sample as ``KMeans.fit`` reads it in the
    streamed mode: the rows ``[lo, hi)`` that it sums here (a rank's
    block; every row in one process) rotated once, ``step`` rows at a time
    on the one-process grid, into a disk memmap re-read every iteration;
    a row selection (the init rows) gathered from the sample and rotated
    on demand, the same way on every rank."""

    def __init__(self, sample, rotation, device, spherical: bool, lo: int, hi: int,
                 path: Path, step: int):
        self.sample, self.lo, self.hi = sample, lo, hi
        self.shape = sample.shape
        self._rot = torch.from_numpy(rotation).to(device)
        self._device, self._spherical = device, spherical
        self._mm = None
        if hi > lo:
            self._mm = np.memmap(path, dtype=np.float32, mode="w+",
                                 shape=(hi - lo, sample.shape[1]))
            for a in range(lo, hi, step):
                b = min(a + step, hi)
                self._mm[a - lo:b - lo] = self._rotate(sample[a:b])
            self._mm.flush()

    def _rotate(self, x) -> np.ndarray:
        x = np.asarray(x, np.float32)
        if self._spherical:     # the rotation is orthogonal: norms persist
            x = _normalize_rows(x)
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(self._device)
        return (xt @ self._rot).cpu().numpy()

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, key):
        if isinstance(key, slice):
            if not self.lo <= key.start <= key.stop <= self.hi:
                raise IndexError(f"rows {key.start}:{key.stop} outside {self.lo}:{self.hi}")
            return self._mm[key.start - self.lo:key.stop - self.lo]
        return self._rotate(self.sample[np.asarray(key)])


def _merge_spills(spill_root: Path, w: int, code_bytes: int) -> None:
    """Every rank's spill (``p<rank>/``: codes, assignments, positions and
    the rows of each of its chunks) merged into ``spill_root`` in stream
    order: chunk ``i`` is the next chunk of rank ``i % W``. Each input is
    read front to back and the output is appended."""
    names = (("codes.u8", code_bytes), ("assign.i32", 4), ("pos.i64", 8))
    rows = [np.fromfile(spill_root / f"p{r}" / "rows.i64", np.int64) for r in range(w)]
    srcs = [[open(spill_root / f"p{r}" / name, "rb") for name, _ in names] for r in range(w)]
    outs = [open(spill_root / name, "wb") for name, _ in names]
    try:
        for i in range(sum(len(r) for r in rows)):
            r, j = i % w, i // w
            for src, out, (_, width) in zip(srcs[r], outs, names):
                out.write(src.read(int(rows[r][j]) * width))
    finally:
        for f in outs + [f for fs in srcs for f in fs]:
            f.close()


def _json_safe(obj):
    """numpy scalars and arrays inside train stats -> JSON types."""
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj
