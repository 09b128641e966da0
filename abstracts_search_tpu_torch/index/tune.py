"""Search-time parameter tuning -> ``params.json``.

The port of the JAX package's ``index/tune.py`` (faiss ``ParameterSpace``
autotune behind the reference's ``sidecar-search index tune``): sweep
``nprobe`` operating points on held-out queries, measuring recall@k
against an exact oracle and wall-clock QPS, then pick the cheapest point
that meets the recall target.

Position spaces: ``index.search`` returns GLOBAL corpus positions, so
the oracle must be computed in the same space. When tuning a
full-corpus index, pass the corpus *source* (a reader with
``iter_row_groups``/``sample``/``__len__``): the oracle then streams
every row group through the exact top-k (kernel 1, ``ops/topk.py``),
numbering rows exactly as the fill did. Passing only a sample of a
larger corpus gives sample-local oracle positions and meaningless
recall.

The streamed oracle runs in bf16 on the card (as the JAX package runs it
on the TPU) and in f32 on the CPU. ``qps`` and ``ms_per_batch`` in
``params.json`` are host-clock times of this package's search.

Over a mesh (``mesh=``, or the tuned index's) every rank calls the same
functions: the array oracle searches a row-sharded ``FlatIndex``, the
streamed oracle streams each rank's row groups (dealt round-robin) and
merges the ranks' top-k lists, rank 0 alone writes the oracle cache
behind a barrier, and the sweep searches
the sharded index, so every rank sees the same recall and picks the same
nprobe.
"""

from __future__ import annotations

import json
import time
import zipfile
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..ops.topk import streaming_topk
from ..parallel.mesh import all_gather, broadcast, deal, index_mesh, process_barrier
from .flat import FlatIndex

DEFAULT_NPROBES = (1, 2, 4, 8, 16, 32, 64, 128, 256)
NEG_INF = float("-inf")


def _is_reader(source) -> bool:
    return hasattr(source, "iter_row_groups")


def make_holdout_queries(source, n_queries: int, *, noise: float = 0.0,
                         seed: int = 0) -> np.ndarray:
    """Held-out queries: the source's own held-out draw where it has one
    (the virtual corpus's planted groups), else sampled corpus rows,
    optionally perturbed. ``source`` is an [N, D] array or a reader."""
    rng = np.random.default_rng(seed)
    if hasattr(source, "holdout_queries"):
        q = np.asarray(source.holdout_queries(min(n_queries, len(source)), seed=seed),
                       np.float32)
    elif _is_reader(source):
        q = np.asarray(source.sample(min(n_queries, len(source)), seed=seed),
                       np.float32).copy()
    else:
        picks = rng.choice(len(source), size=min(n_queries, len(source)), replace=False)
        q = source[picks].astype(np.float32).copy()
    if noise > 0:
        q += noise * rng.standard_normal(q.shape).astype(np.float32)
    return q


def exact_ground_truth(source, queries: np.ndarray, k: int, *, device=None,
                       chunk: int = 1024, mesh=None):
    """Top-k oracle in GLOBAL corpus positions -> (scores, positions).

    ``source``: an [N, D] array (positions = array indices, searched by
    ``FlatIndex``, row-sharded over ``mesh``) or a reader, whose row
    groups stream through the exact top-k with positions numbered in
    reader order, as the fill numbers them."""
    if not _is_reader(source):
        flat = FlatIndex(chunk=chunk, device=device, mesh=mesh)
        flat.add(np.asarray(source, np.float32))
        return flat.search(queries, k)
    return _exact_ground_truth_stream(source, queries, k, chunk=chunk, device=device,
                                      mesh=mesh)


def _exact_ground_truth_stream(reader, queries: np.ndarray, k: int, *, chunk: int = 1024,
                               device=None, mesh=None):
    """Stream the corpus once through kernel 1 (``n_valid`` masks each
    row group's padding); merge a running top-k on the host with a
    stable sort, so ties go to the earlier row group. The corpus never
    lands in host RAM whole. Over a mesh each rank streams only its row
    groups (``deal``) and the ranks' top-k lists merge under (score desc,
    position asc), one process's order."""
    mesh = index_mesh(mesh, device)
    device = resolve_device(getattr(reader, "device", None) if device is None else device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    qd = torch.from_numpy(np.asarray(queries, np.float32)).to(device, dtype)
    qn = qd.shape[0]
    kk = min(k, chunk)
    best_v = np.full((qn, k), NEG_INF, np.float32)
    best_p = np.full((qn, k), -1, np.int64)
    starts = np.cumsum([0, *reader.row_group_rows()])
    mine = deal(len(starts) - 1, mesh)
    with torch.inference_mode():
        for g, (_, embs) in zip(mine, reader.iter_row_groups(with_ids=False, groups=mine)):
            n = len(embs)
            x = (embs if isinstance(embs, torch.Tensor)
                 else torch.from_numpy(np.array(embs, np.float32))).to(device, dtype)
            pad = -(-n // chunk) * chunk - n
            if pad:
                x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
            v, i = streaming_topk(qd, x, n, kk, chunk=chunk)
            v = v.cpu().numpy()
            p = i.cpu().numpy().astype(np.int64) + starts[g]
            p[v == NEG_INF] = -1
            all_v = np.concatenate([best_v, v], axis=1)
            all_p = np.concatenate([best_p, p], axis=1)
            sel = np.argsort(-all_v, axis=1, kind="stable")[:, :k]
            best_v = np.take_along_axis(all_v, sel, axis=1)
            best_p = np.take_along_axis(all_p, sel, axis=1)
    if mesh.collective:
        v = all_gather(mesh, torch.from_numpy(best_v)).numpy()      # [W, Q, k]
        p = all_gather(mesh, torch.from_numpy(best_p)).numpy()
        all_v = v.transpose(1, 0, 2).reshape(qn, -1)
        all_p = p.transpose(1, 0, 2).reshape(qn, -1)
        # ties to the lower position; the empty slots (-inf, -1) last
        sel = np.lexsort((np.where(all_p < 0, np.iinfo(np.int64).max, all_p), -all_v),
                         axis=1)[:, :k]
        best_v = np.take_along_axis(all_v, sel, axis=1)
        best_p = np.take_along_axis(all_p, sel, axis=1)
    return best_v, best_p


def load_oracle_cache(path, key: dict):
    """(queries, ref positions) from a cache written by
    ``save_oracle_cache``, or None when absent, unreadable or keyed
    otherwise."""
    path = Path(path)
    if not path.is_file():
        return None
    try:
        z = np.load(path, allow_pickle=False)
        if json.loads(str(z["key"])) != key:
            return None
        return np.asarray(z["queries"], np.float32), np.asarray(z["ref"], np.int64)
    except (OSError, ValueError, KeyError, zipfile.BadZipFile):
        return None


def save_oracle_cache(path, key: dict, queries, ref) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp.npz")
    np.savez(tmp, key=json.dumps(key, sort_keys=True),
             queries=np.asarray(queries, np.float32), ref=np.asarray(ref, np.int64))
    tmp.replace(path)


def _oracle(source, n_queries: int, seed: int, spherical: bool, k: int, *, device,
            chunk: int, mesh=None):
    """(queries, exact top-k positions). Over a mesh rank 0 draws the
    queries (a reader's sample reads every row group) and broadcasts
    them."""
    mesh = index_mesh(mesh, device)
    if mesh.rank == 0:
        queries = make_holdout_queries(source, n_queries, seed=seed)
    else:
        dim = source.dim if _is_reader(source) else source.shape[1]
        queries = np.empty((min(n_queries, len(source)), dim), np.float32)
    queries = broadcast(mesh, torch.from_numpy(queries)).numpy()
    if spherical:
        queries = queries / np.maximum(np.linalg.norm(queries, axis=1, keepdims=True), 1e-12)
    _, ref = exact_ground_truth(source, queries, k, device=device, chunk=chunk, mesh=mesh)
    return queries, ref


def _load_cache_everywhere(path, key: dict, mesh):
    """``load_oracle_cache`` on every rank, then a barrier: no rank
    writes the cache before every rank has looked, so all see the same
    hit or miss."""
    cached = load_oracle_cache(path, key)
    process_barrier(mesh)
    return cached


def _save_cache_on_rank0(path, key: dict, queries, ref, mesh) -> None:
    """The cache file has one writer, rank 0; the others wait for it."""
    if mesh.rank == 0:
        save_oracle_cache(path, key, queries, ref)
    process_barrier(mesh)


def ensure_oracle_cache(path, key: dict, source, *, k: int, device=None,
                        chunk: int = 1024, spherical: bool = True, mesh=None) -> bool:
    """Compute and persist the (queries, exact top-k) oracle when the
    cache misses; a no-op on a hit. Split out of ``tune_index`` so the
    driver can run the corpus-streaming oracle before the filled index
    is installed on the card. Returns True when it computed one. Over a
    mesh every rank calls it."""
    mesh = index_mesh(mesh, device)
    if _load_cache_everywhere(path, key, mesh) is not None:
        return False
    queries, ref = _oracle(source, key["n_queries"], key["seed"], spherical, k,
                           device=mesh.device, chunk=chunk, mesh=mesh)
    _save_cache_on_rank0(path, key, queries, ref, mesh)
    return True


def tune_index(index, source, *, n_queries: int = 256, k: int = 10,
               target_recall: float = 0.95, nprobes=DEFAULT_NPROBES, seed: int = 0,
               timing_reps: int = 3, oracle_cache=None, oracle_key: dict | None = None,
               stop_after: int | None = 2) -> dict:
    """Sweep nprobe; return the ``params.json`` payload.

    ``source`` must cover the SAME rows, in the same order, that the
    index was filled with: an array for a sample-filled index, the
    reader for a full-corpus index. ``oracle_cache``/``oracle_key``: the
    ground truth depends only on (data fingerprint, query seed,
    n_queries, k), so a cached oracle makes a re-tune cost seconds; the
    key must hold the data fingerprint so a stale cache never matches.
    The sweep stops once ``stop_after`` consecutive points meet the
    target (None: the whole ladder). Over a mesh (the index's) every
    rank calls it and gets the same payload but for the timings."""
    mesh = index.mesh
    cached = (_load_cache_everywhere(oracle_cache, oracle_key, mesh)
              if oracle_cache is not None else None)
    if cached is not None:
        queries, ref = cached
    else:
        queries, ref = _oracle(source, n_queries, seed, getattr(index, "spherical", False),
                               k, device=index.device, chunk=index.chunk, mesh=mesh)
        if oracle_cache is not None:
            _save_cache_on_rank0(oracle_cache, oracle_key, queries, ref, mesh)

    points = []
    for nprobe in nprobes:
        if nprobe > index.n_lists:
            break
        _, got = index.search(queries, k, nprobe=nprobe)
        recall = float(np.mean([len(set(got[i]) & set(ref[i])) / k
                                for i in range(len(queries))]))
        t0 = time.perf_counter()
        for _ in range(timing_reps):
            index.search(queries, k, nprobe=nprobe)
        dt = (time.perf_counter() - t0) / timing_reps
        points.append({"nprobe": int(nprobe), "recall": recall,
                       "qps": len(queries) / dt, "ms_per_batch": dt * 1e3})
        if stop_after is not None:
            tail = [p["recall"] >= target_recall for p in points[-stop_after:]]
            if len(tail) == stop_after and all(tail):
                break

    chosen = next((p for p in points if p["recall"] >= target_recall), None)
    if chosen is None:
        chosen = max(points, key=lambda p: p["recall"])
    return {"nprobe": chosen["nprobe"], "k": k, "target_recall": target_recall,
            "achieved_recall": chosen["recall"], "operating_points": points}


def write_params(path: str | Path, params: dict) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(params, indent=2))


def read_params(path: str | Path) -> dict:
    return json.loads(Path(path).read_text())
