"""IVF-Flat index: coarse quantizer + CSR lists of raw rows, on one card
or sharded over a mesh.

The port of the JAX package's ``index/ivf.py`` (faiss ``IndexIVFFlat``'s
place). Train = k-means (``index/kmeans.py``, spherical or plain L2);
fill = assign + pack into CSR segmented lists (``index/lists.py``, the
same format 3 on disk); search is two-phase and work-proportional:

1. probe: kernel 1 (``ops/topk.py``) selects the top-``nprobe``
   centroids, through the metric's operands (``kmeans._assign_operands``:
   bf16 for spherical, the f32 bias-augmented FMA route for plain L2);
2. host: the probed lists expand through the CSR into a per-query list
   of live segments;
3. scan: per window of queries, gather the probed [SEG, D] tiles and
   score them with one exact f32 product (TF32 stays off and is
   asserted), then a top-k under (score desc, candidate order asc), the
   order ``lax.top_k`` keeps: probe order, then row within the list.

The JAX package computes the scan outside any Pallas kernel (an XLA
einsum at HIGHEST precision under ``lax.map``); here it is a plain f32
``torch.matmul`` over the gathered tiles, windowed so that no batch's
tiles materialize at once. Plain-L2 lists carry a ``-||x||^2 / 2`` bias
column (padded to a 128-column multiple, as the JAX package pads it) and
queries a ones column, so the inner product ranks by exact L2.

Over a mesh (``parallel/mesh.py``) rank ``r`` of ``W`` installs only the
lists ``l % W == r`` (``rank_shard``: its segments gathered from the
memmap), probes like every rank, scans its own probed tiles, and one
all-gather merges the ranks' top-k lists (``merge_topk_all_gather``).
Every rank trains and fills with the same rows: k-means sums its block
of rows and reduces over the mesh (``kmeans.py``), and the fill assigns
each rank's block, gathers every assignment and packs the same lists on
every rank before each installs its own.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..device import assert_exact_f32
from ..ops.topk import streaming_topk
from ..parallel.mesh import Mesh, index_mesh
from ..parallel.topk_merge import merge_topk_all_gather
from .ivfpq import _json_safe
from .kmeans import KMeans, _assign_operands, _normalize_rows, _round_up
from .lists import CSRLists, load_lists, pack_lists, ragged_ranges, rank_shard, save_lists

NEG_INF = float("-inf")


class IVFFlatIndex:
    """Inverted-file index with an exact (f32) scan of raw rows."""

    # bytes of gathered [SEG, D] f32 tiles per scan window
    SCAN_WINDOW_BYTES = 1 << 30
    # segments uploaded per step of the install
    INSTALL_SEGS = 1024

    def __init__(self, n_lists: int, *, seg_size: int = 512, chunk: int = 1024,
                 spherical: bool = True, impl: str = "auto", seed: int = 0, device=None,
                 mesh: Mesh | None = None):
        if impl not in ("auto", "cuda", "torch"):
            raise ValueError(f"impl={impl!r}")
        self.mesh = index_mesh(mesh, device)
        self.device = self.mesh.device
        self.n_lists = n_lists
        self.seg_size = seg_size
        self.chunk = chunk
        self.spherical = spherical
        self.impl = impl
        self.seed = seed
        self.kmeans = KMeans(n_lists, spherical=spherical, chunk=chunk, impl=impl, seed=seed,
                             mesh=self.mesh)
        self.packed: CSRLists | None = None
        self._data = None
        self.n = 0

    @property
    def centroids(self) -> np.ndarray | None:
        return self.kmeans.centroids

    @property
    def is_trained(self) -> bool:
        return self.centroids is not None

    # -- train / fill --------------------------------------------------------

    def train(self, sample: np.ndarray, *, iters: int = 10) -> dict:
        """Train the coarse quantizer; returns its stats (the
        ``untuned.json`` analog)."""
        self.kmeans.fit(sample, iters=iters)
        return self.kmeans.stats

    def fill(self, vectors: np.ndarray, positions: np.ndarray | None = None) -> None:
        """Assign and pack every vector into the CSR lists."""
        if not self.is_trained:
            raise RuntimeError("train() before fill()")
        if self.packed is not None:
            raise RuntimeError("index already filled; re-fill a freshly trained/loaded index")
        vectors = np.asarray(vectors, np.float32)
        if self.spherical:
            vectors = _normalize_rows(vectors)
        if positions is None:
            positions = np.arange(len(vectors), dtype=np.int64)
        _, assign = self.kmeans.assign(vectors)
        self._install(pack_lists(vectors, positions, assign, self.n_lists,
                                 seg_size=self.seg_size))

    def _install(self, packed: CSRLists) -> None:
        """Lists to the card: [n_segs, SEG, D] f32, or [n_segs, SEG,
        round_up(D + 1, 128)] with the plain-L2 bias column. Dead padding
        rows are zero (bias 0) and stay masked by ``seg_valid``. Over a
        mesh of several ranks only this rank's segments, compacted, with
        its local CSR."""
        self.packed = packed
        self.n = packed.n_rows
        n_segs, seg, d = packed.data.shape
        segs = None
        start, cnt = packed.seg_start, packed.seg_cnt
        if self.mesh.size > 1:
            segs, start, cnt = rank_shard(packed.seg_start, packed.seg_cnt, self.mesh.size,
                                          self.mesh.rank)
            n_segs = len(segs)
        width = d if self.spherical else _round_up(d + 1, 128)
        data = torch.zeros((n_segs, seg, width), dtype=torch.float32, device=self.device)
        for lo in range(0, n_segs, self.INSTALL_SEGS):
            rows = (slice(lo, lo + self.INSTALL_SEGS) if segs is None
                    else segs[lo:lo + self.INSTALL_SEGS])
            x = torch.from_numpy(np.array(packed.data[rows], np.float32)).to(self.device)
            data[lo:lo + len(x), :, :d] = x
            if not self.spherical:
                data[lo:lo + len(x), :, d] = -0.5 * (x * x).sum(-1)
        self._data = data
        rows = slice(None) if segs is None else segs
        self._row_ids = torch.from_numpy(np.array(packed.row_ids[rows], np.int64)).to(
            self.device)
        self._seg_valid = torch.from_numpy(np.array(np.asarray(packed.seg_valid)[rows],
                                                    np.int64)).to(self.device)
        self._seg_start_h = np.asarray(start, np.int64)
        self._seg_cnt_h = np.asarray(cnt, np.int64)
        self._c_pad = self.kmeans._centroids_padded()

    # -- search --------------------------------------------------------------

    def _probe(self, q: torch.Tensor, nprobe: int) -> np.ndarray:
        """Kernel 1 over the centroids -> probed lists [Q, nprobe]."""
        qq, cc = _assign_operands(q, self._c_pad, self.spherical)
        _, probes = streaming_topk(qq, cc, self.n_lists, nprobe, chunk=self.chunk,
                                   impl=self.impl)
        return probes.cpu().numpy()

    def _slots(self, probes: np.ndarray) -> np.ndarray:
        """Per-query live segments [Q, maxcnt] (-1 pads), in probe order
        and, within a list, segment order."""
        qn, nprobe = probes.shape
        pl = probes.reshape(-1).astype(np.int64)
        cnt = self._seg_cnt_h[pl]
        seg_ids, _ = ragged_ranges(self._seg_start_h[pl], cnt)
        percnt = cnt.reshape(qn, nprobe).sum(axis=1)
        maxcnt = max(int(percnt.max()) if qn else 0, 1)
        soq = np.full((qn, maxcnt), -1, np.int64)
        qoff = np.concatenate([[0], np.cumsum(percnt)])[:-1]
        ar = np.arange(maxcnt, dtype=np.int64)
        live = ar[None, :] < percnt[:, None]
        soq[live] = seg_ids[(qoff[:, None] + ar[None, :])[live]]
        return soq

    def _scan(self, q: torch.Tensor, soq: np.ndarray, k: int):
        """Exact f32 scores of each query's gathered tiles, top-k under
        (score desc, candidate order asc). -> (values, positions)."""
        qn, maxcnt = soq.shape
        seg, width = self._data.shape[1], self._data.shape[2]
        if self._data.shape[0] == 0:        # a rank that holds no list
            return (torch.full((qn, k), NEG_INF, device=self.device),
                    torch.full((qn, k), -1, dtype=torch.int64, device=self.device))
        per_q = maxcnt * seg * width * 4
        win = max(1, self.SCAN_WINDOW_BYTES // per_q)
        vals = torch.empty((qn, k), dtype=torch.float32, device=self.device)
        pos = torch.empty((qn, k), dtype=torch.int64, device=self.device)
        soq_d = torch.from_numpy(soq).to(self.device)
        row_iota = torch.arange(seg, device=self.device)
        for lo in range(0, qn, win):
            s = soq_d[lo:lo + win]                                  # [w, maxcnt]
            segs = s.clamp_min(0)
            tiles = self._data[segs]                                # [w, maxcnt, SEG, W]
            w = len(s)
            scores = torch.matmul(tiles.view(w, maxcnt * seg, width),
                                  q[lo:lo + w, :, None]).view(w, maxcnt, seg)
            del tiles
            live = (s >= 0)[:, :, None] & (row_iota < self._seg_valid[segs][:, :, None])
            flat = torch.where(live, scores, NEG_INF).view(w, -1)
            rows = self._row_ids[segs].view(w, -1)
            if flat.shape[1] < k:
                padn = k - flat.shape[1]
                flat = torch.cat([flat, flat.new_full((w, padn), NEG_INF)], 1)
                rows = torch.cat([rows, rows.new_full((w, padn), -1)], 1)
            v, order = torch.sort(flat, dim=1, descending=True, stable=True)
            v = v[:, :k]
            p = torch.gather(rows, 1, order[:, :k])
            vals[lo:lo + w] = v
            pos[lo:lo + w] = torch.where(v > NEG_INF, p, -1)
        return vals, pos

    def search(self, queries: np.ndarray, k: int, *, nprobe: int = 8):
        """-> (scores [Q, k] f32, corpus positions [Q, k] int64; -1 = no
        candidate) as numpy arrays. Over a mesh this is a collective:
        every rank calls it with the same arguments."""
        if self._data is None:
            raise RuntimeError("fill() before search()")
        assert_exact_f32()
        q = np.asarray(queries, np.float32)
        if self.spherical:
            q = _normalize_rows(q)
        nprobe = min(nprobe, self.n_lists)
        qt = torch.from_numpy(np.ascontiguousarray(q)).to(self.device)
        with torch.inference_mode():
            soq = self._slots(self._probe(qt, nprobe))
            if not self.spherical:
                width = self._data.shape[2]
                qa = torch.zeros((len(qt), width), dtype=torch.float32, device=self.device)
                qa[:, :qt.shape[1]] = qt
                qa[:, qt.shape[1]] = 1.0
                qt = qa
            v, pos = self._scan(qt, soq, k)
            if self.mesh.collective:
                v, pos, _ = merge_topk_all_gather(v, pos, k, self.mesh)
        return v.cpu().numpy(), pos.cpu().numpy()

    # -- artifacts -----------------------------------------------------------

    def save(self, directory: str | Path) -> None:
        """Persist the trained (and filled) state; the JAX package's
        files."""
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        np.save(d / "centroids.npy", self.centroids)
        meta = {"type": "ivf_flat", "n_lists": self.n_lists, "seg_size": self.seg_size,
                "spherical": self.spherical, "n": self.n,
                "kmeans_stats": _json_safe(self.kmeans.stats)}
        (d / "meta.json").write_text(json.dumps(meta, indent=2))
        if self.packed is not None:
            save_lists(self.packed, d / "lists")

    @classmethod
    def load(cls, directory: str | Path, *, device=None, mesh: Mesh | None = None,
             **kw) -> "IVFFlatIndex":
        """Open JAX- or port-written artifacts on ``device`` (default: the
        card), or on this rank of ``mesh``, which reads only its own
        lists; ``kw`` goes to the constructor."""
        d = Path(directory)
        meta = json.loads((d / "meta.json").read_text())
        idx = cls(meta["n_lists"], seg_size=meta["seg_size"], spherical=meta["spherical"],
                  device=device, mesh=mesh, **kw)
        idx.kmeans.centroids = np.load(d / "centroids.npy")
        idx.kmeans.stats = meta.get("kmeans_stats", {})
        if (d / "lists").is_dir():
            idx._install(load_lists(d / "lists", mmap=True))
        return idx
