"""Virtual (device-generated) corpus source, and the chunked device
sources of the index build.

The production data path is parquet shards read by
``storage.shards.ShardReader``. ``VirtualShardReader`` is a drop-in
reader over a deterministic synthetic corpus made on the device chunk by
chunk, so the driver's targets (``astpu index train/fill/tune``) run at
the full 206,962,688-row scale where streaming ~850 GB of host vectors
is out of reach, and where no corpus is at hand. A data dir holding a
``virtual.json`` spec (``write_spec``) opens as one
(``open_data_source``).

Corpus model, as in the JAX package's ``storage/virtual.py``: a
two-level clustered mixture with planted near-neighbour structure, so
recall@k is meaningful.

- ``n_clusters`` macro clusters: centers N(0, I) (times
  ``center_scale``) in a ``d_int``-dimensional latent space, mapped
  through a fixed random orthonormal basis to ``dim``; cluster masses
  follow Zipf(``zipf``).
- micro-groups of ``group_size`` consecutive rows share an anchor
  (center + ``noise``·N(0, I) per latent component); each row is its
  anchor plus a full-space perturbation of total norm ``group_noise``
  (the first ``group_core`` CORE rows) or ``group_noise_outer`` (the
  OUTER rows). For a core query at k = group_core the exact top-k set is
  exactly the core set.

The host-side draws are the JAX package's, bit for bit: the mixture
parameters (``_host_params``), the ``sample`` indices, the
``holdout_queries`` group choice and the ``train_view`` chunk ids all
come from numpy. The device-side draws are not: ``jax.random``
(threefry, XLA's erfinv) cannot be reproduced in PyTorch, so a chunk
here is drawn with a ``torch.Generator`` on the reader's device, seeded
from (spec seed, chunk index). Its numbers also differ between the CPU
(mt19937) and CUDA (Philox). ``generator_tag`` names the package and the
device type; the driver folds it into a virtual dir's data fingerprint,
so an oracle or fill stamp written by the other package, or on the other
device type, never matches.

Every consumer (the fill's encode, the k-means stream, the tune oracle,
the query draw) calls the same ``device_chunk``, so all see identical
rows.

``RotatedDeviceSource`` applies the OPQ rotation on the card for the
device-streamed k-means of ``IVFPQIndex._train_big``.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device

SPEC_NAME = "virtual.json"
# chunk ci of a corpus with spec seed s draws from seed s * _SEED_STRIDE + ci;
# held-out query jitter from keys counted down from 2**31 - 1
_SEED_STRIDE = 1_000_003
_QUERY_KEY_TOP = 2**31 - 1


def generator_tag(device) -> str:
    """Which generator made a virtual corpus's rows: the package and the
    device type (CPU and CUDA generators draw different numbers)."""
    return f"abstracts_search_tpu_torch/torch.Generator/{torch.device(device).type}"


@dataclass(frozen=True)
class VirtualSpec:
    n: int
    dim: int = 1024
    d_int: int = 64
    n_clusters: int = 4096
    zipf: float = 1.1
    noise: float = 0.5          # anchor jitter, per component in latent space
    group_size: int = 16        # rows per planted micro-group
    group_core: int = 10        # leading CORE rows per group (tight)
    group_noise: float = 0.05   # total L2 norm of a CORE row's jitter
    group_noise_outer: float = 0.5  # total L2 norm of an OUTER row's jitter
    seed: int = 0
    chunk_rows: int = 131072    # generation / row-group granule
    # center_scale < 1 makes clusters overlap; query_noise (total L2
    # norm, default group_noise) pushes held-out queries toward list
    # boundaries while the exact top-k set stays the core set
    center_scale: float = 1.0
    query_noise: float | None = None

    def validate(self) -> None:
        if self.n % self.chunk_rows != 0:
            raise ValueError(
                f"n={self.n} must be a multiple of chunk_rows={self.chunk_rows}")
        if self.chunk_rows % self.group_size != 0:
            raise ValueError(
                f"chunk_rows={self.chunk_rows} must be a multiple of "
                f"group_size={self.group_size}")
        if not 1 <= self.group_core <= self.group_size:
            raise ValueError(
                f"group_core={self.group_core} must be in "
                f"[1, group_size={self.group_size}]")
        if self.center_scale <= 0:
            raise ValueError(f"center_scale={self.center_scale} must be > 0")
        q = self.query_noise
        if q is not None and not (self.group_noise <= q < self.group_noise_outer):
            raise ValueError(
                f"query_noise={q} must lie in [group_noise={self.group_noise}, "
                f"group_noise_outer={self.group_noise_outer}) or the exact "
                f"top-k set stops being the planted core set")


def write_spec(data_dir: str | Path, spec: VirtualSpec) -> Path:
    spec.validate()
    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    path = data_dir / SPEC_NAME
    path.write_text(json.dumps(asdict(spec), indent=2))
    return path


def read_spec(data_dir: str | Path) -> VirtualSpec:
    spec = VirtualSpec(**json.loads((Path(data_dir) / SPEC_NAME).read_text()))
    spec.validate()
    return spec


def open_data_source(data_dir: str | Path, *, device=None):
    """ShardReader for a parquet dir, VirtualShardReader (rows made on
    ``device``) when the dir holds a ``virtual.json`` spec instead. The
    driver routes every read through here."""
    if (Path(data_dir) / SPEC_NAME).exists():
        return VirtualShardReader(data_dir, device=device)
    from .shards import ShardReader

    return ShardReader(data_dir)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=1, keepdim=True).clamp_min(1e-12)


class VirtualShardReader:
    """ShardReader-protocol reader over the generated corpus.

    ``iter_row_groups`` yields chunks as f32 unit-row tensors on the
    reader's device (the card by default); the fill and the k-means
    stream consume them there without a host round trip.
    ``sample``/``gather_rows`` download only the requested rows."""

    def __init__(self, data_dir: str | Path, *, device=None):
        self.data_dir = Path(data_dir)
        self.spec = read_spec(self.data_dir)
        self.device = resolve_device(device)
        self.dim = self.spec.dim
        self.chunk_rows = self.spec.chunk_rows
        self.num_chunks = self.spec.n // self.spec.chunk_rows
        self._params = None

    def __len__(self) -> int:
        return self.spec.n

    @property
    def num_shards(self) -> int:
        return 1

    # -- generation ----------------------------------------------------------

    def _host_params(self):
        """Mixture parameters, drawn on the host as the JAX package draws
        them: (basis [D, d_int], centers [n_clusters, d_int], masses)."""
        s = self.spec
        rng = np.random.default_rng(s.seed)
        basis, _ = np.linalg.qr(rng.standard_normal((s.dim, s.d_int)).astype(np.float64))
        centers = (s.center_scale
                   * rng.standard_normal((s.n_clusters, s.d_int))).astype(np.float32)
        p = 1.0 / np.arange(1, s.n_clusters + 1) ** s.zipf
        return basis.astype(np.float32), centers, (p / p.sum()).astype(np.float32)

    def _ensure_params(self):
        if self._params is None:
            s = self.spec
            sig = np.full(s.group_size, s.group_noise, np.float32)
            sig[s.group_core:] = s.group_noise_outer
            dev = self.device
            self._params = (*(torch.from_numpy(a).to(dev) for a in self._host_params()),
                            torch.from_numpy(sig / np.float32(np.sqrt(s.dim))).to(dev))
        return self._params

    def _generator(self, key: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(key))

    def _anchors(self, g: torch.Generator) -> torch.Tensor:
        """The chunk's group anchors [chunk_rows / group_size, D]: its
        first draws from its generator."""
        s = self.spec
        basis, centers, p, _ = self._ensure_params()
        mg = s.chunk_rows // s.group_size
        labels = torch.multinomial(p, mg, replacement=True, generator=g)
        low = centers[labels] + s.noise * torch.randn((mg, s.d_int), device=self.device,
                                                      generator=g)
        return _unit(low @ basis.T)

    def device_chunk(self, ci: int) -> torch.Tensor:
        """[chunk_rows, dim] f32 unit rows on the reader's device; a pure
        function of (spec, ci, device type)."""
        if not 0 <= ci < self.num_chunks:
            raise IndexError(ci)
        s = self.spec
        sig = self._ensure_params()[3]
        g = self._generator(s.seed * _SEED_STRIDE + int(ci))
        rows = self._anchors(g).repeat_interleave(s.group_size, 0)
        mg = s.chunk_rows // s.group_size
        rows += sig.repeat(mg)[:, None] * torch.randn((s.chunk_rows, s.dim),
                                                      device=self.device, generator=g)
        return _unit(rows)

    # -- ShardReader protocol ------------------------------------------------

    def iter_row_groups(self, *, with_ids: bool = True, start_row: int = 0):
        ch = self.chunk_rows
        for ci in range(start_row // ch, self.num_chunks):
            x = self.device_chunk(ci)
            lo = ci * ch
            if lo < start_row:          # partial first group
                x = x[start_row - lo:]
                lo = start_row
            ids = [f"W{j}" for j in range(lo, ci * ch + ch)] if with_ids else None
            yield ids, x

    def read_all(self, *, with_ids: bool = True):
        ids_all, parts = [], []
        for ids, x in self.iter_row_groups(with_ids=with_ids):
            if with_ids:
                ids_all.extend(ids)
            parts.append(x.cpu().numpy())
        return (ids_all if with_ids else None), np.concatenate(parts, axis=0)

    def gather_rows(self, idx) -> np.ndarray:
        """Host gather of arbitrary global rows (sorted or not); only the
        requested rows leave the device."""
        return _gather_from_chunks(self.device_chunk, self.chunk_rows,
                                   np.asarray(idx, np.int64), self.dim)

    def sample(self, n: int, *, seed: int = 0, out: np.ndarray | None = None) -> np.ndarray:
        """Uniform row sample (ShardReader.sample semantics)."""
        n = min(n, len(self))
        rng = np.random.default_rng(seed)
        rows = self.gather_rows(np.sort(rng.choice(len(self), size=n, replace=False)))
        if out is not None:
            out[:n] = rows
            return out
        return rows

    def holdout_queries(self, n: int, *, seed: int = 0) -> np.ndarray:
        """Held-out queries: a fresh draw at CORE noise (or
        ``query_noise``) around n random group anchors. Query i's exact
        top-``group_core`` set is exactly group g_i's core rows, so
        recall@k at k = group_core measures the probe and the PQ ranking,
        not tie-breaking (``tune.make_holdout_queries`` prefers this)."""
        s = self.spec
        mg = s.chunk_rows // s.group_size
        rng = np.random.default_rng(seed)
        groups = np.sort(rng.choice(len(self) // s.group_size, size=n, replace=False))
        qn = s.group_noise if s.query_noise is None else s.query_noise
        out = np.empty((n, s.dim), np.float32)
        cis = groups // mg
        lo = 0
        while lo < n:
            ci = int(cis[lo])
            hi = lo + int(np.searchsorted(cis[lo:], ci, side="right"))
            # exactly the corpus chunk's anchors, then jitter from a
            # generator disjoint from every chunk's
            a = self._anchors(self._generator(s.seed * _SEED_STRIDE + ci))[
                torch.from_numpy(groups[lo:hi] % mg).to(self.device)]
            g = self._generator(s.seed * _SEED_STRIDE + _QUERY_KEY_TOP - ci - seed)
            q = a + float(qn / np.sqrt(s.dim)) * torch.randn(a.shape, device=self.device,
                                                        generator=g)
            out[lo:hi] = _unit(q).cpu().numpy()
            lo = hi
        return out

    def train_view(self, n: int) -> "VirtualTrainSample":
        """Training subset as a device-streamable view: evenly spaced
        whole chunks totalling >= n rows (rows are i.i.d. by
        construction, so whole-chunk selection is an unbiased sample)."""
        want = min(-(-n // self.chunk_rows), self.num_chunks)
        cids = np.unique(np.linspace(0, self.num_chunks - 1, num=want, dtype=np.int64))
        return VirtualTrainSample(self, cids)


class VirtualTrainSample:
    """Device-streamable training sample: a fixed set of corpus chunks.
    The device-source protocol of ``KMeans._fit_device_stream`` and
    ``IVFPQIndex._train_big``: ``shape``/``__len__``, ``chunk_rows``,
    ``num_chunks``, ``device_chunk(j)``, ``gather_rows(idx)``."""

    prenormalized = True

    def __init__(self, reader: VirtualShardReader, chunk_ids: np.ndarray):
        self.reader = reader
        self.chunk_ids = np.asarray(chunk_ids, np.int64)
        self.chunk_rows = reader.chunk_rows
        self.num_chunks = len(self.chunk_ids)
        self.shape = (self.num_chunks * self.chunk_rows, reader.dim)

    def __len__(self) -> int:
        return self.shape[0]

    def device_chunk(self, j: int) -> torch.Tensor:
        return self.reader.device_chunk(int(self.chunk_ids[j]))

    def gather_rows(self, idx) -> np.ndarray:
        return _gather_from_chunks(self.device_chunk, self.chunk_rows,
                                   np.asarray(idx, np.int64), self.shape[1])


class RotatedDeviceSource:
    """Device-source view with an orthogonal rotation applied on the
    card (norms persist, so rows stay unit). Used by the
    device-streamed k-means branch of ``IVFPQIndex._train_big``."""

    prenormalized = True

    def __init__(self, src, rotation: np.ndarray, device):
        self.src = src
        self.chunk_rows = src.chunk_rows
        self.num_chunks = src.num_chunks
        self.shape = src.shape
        self._rot = torch.from_numpy(np.asarray(rotation, np.float32)).to(device)

    def __len__(self) -> int:
        return self.shape[0]

    def device_chunk(self, j: int) -> torch.Tensor:
        return self.src.device_chunk(j) @ self._rot

    def gather_rows(self, idx) -> np.ndarray:
        return _gather_from_chunks(self.device_chunk, self.chunk_rows,
                                   np.asarray(idx, np.int64), self.shape[1])


def _gather_from_chunks(device_chunk, chunk_rows: int, idx: np.ndarray,
                        dim: int) -> np.ndarray:
    """Gather rows by global index from a chunked device source: per
    involved chunk, gather on the device and download only the picks."""
    out = np.empty((len(idx), dim), np.float32)
    order = np.argsort(idx, kind="stable")
    sidx = idx[order]
    cis = sidx // chunk_rows
    lo = 0
    while lo < len(sidx):
        hi = lo
        ci = cis[lo]
        while hi < len(sidx) and cis[hi] == ci:
            hi += 1
        x = device_chunk(int(ci))
        local = torch.from_numpy(sidx[lo:hi] - ci * chunk_rows).to(x.device)
        out[order[lo:hi]] = x[local].float().cpu().numpy()
        lo = hi
    return out
