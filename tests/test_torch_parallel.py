"""The port's corpus mesh against the JAX package's, on the CPU.

The port's ranks are real processes: ``tests/torch_mesh_worker.py`` joins
a gloo group on the CPU (free ports) at W 2 and 4 and runs one job of
tasks; the JAX package runs the same searches on a 2- and 4-device CPU
mesh (``build_mesh(jax.devices()[:W])``). Held here:

- ``shard_lists`` equal to the JAX function byte for byte at ndev 1, 2,
  3, 8; ``rank_shard`` is each rank's part of it;
- ``merge_topk_all_gather`` equal to the JAX one inside ``shard_map``,
  over candidates with planted ties within and across ranks;
- IVF-PQ, flat and IVF-Flat search at W 2 and 4 against the JAX mesh:
  positions equal, scores within rtol=atol=1e-5 (the tolerance of
  ``test_torch_ivfpq.py``); the port at W against the port at W = 1 in
  one process (no group): positions and scores equal, in device, host
  and hybrid storage; a rank holding no list (3 lists over 4 ranks);
- the mesh's refusals: nccl on the CPU or with more ranks than cards,
  a second sharded ``FlatIndex.add``.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from abstracts_search_tpu.index.flat import FlatIndex as JaxFlat
from abstracts_search_tpu.index.ivf import IVFFlatIndex as JaxIVFFlat
from abstracts_search_tpu.index.ivfpq import IVFPQIndex as JaxIVFPQ
from abstracts_search_tpu.index.lists import pack_lists as jax_pack_lists
from abstracts_search_tpu.index.lists import shard_lists as jax_shard_lists
from abstracts_search_tpu.parallel import build_mesh as jax_build_mesh
from abstracts_search_tpu.parallel.topk_merge import merge_topk_all_gather as jax_merge
from abstracts_search_tpu_torch.index import FlatIndex, IVFFlatIndex, IVFPQIndex
from abstracts_search_tpu_torch.index.lists import pack_lists, rank_shard, shard_lists
from abstracts_search_tpu_torch.parallel import Mesh, build_mesh, init_distributed, shard_rows

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_mesh_worker.py")
DIM, N_LISTS, CHUNK = 32, 8, 128
PQ_CASES = [(10, 4), (5, 1), (300, 1)]
IVF_CASES = [(10, 3), (7, 1)]
FLAT_K = 10


def _normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int, job_dir: Path, tasks: list, timeout: float = 240) -> list:
    """The job on ``world`` gloo ranks; -> each rank's results."""
    (job_dir / "job.json").write_text(json.dumps({"tasks": tasks}))
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(world), str(port),
                               str(job_dir)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return [dict(np.load(job_dir / f"out{r}.npz")) for r in range(world)]


# -- shard_lists, byte for byte ---------------------------------------------------


@pytest.fixture(scope="module")
def csr_pair():
    rng = np.random.default_rng(3)
    n, n_lists = 700, 11
    payloads = rng.integers(0, 256, (n, 8), dtype=np.uint8)
    # lists of very different sizes, two of them empty
    assign = rng.choice(n_lists, n, p=np.r_[[0.3, 0.0, 0.2], [0.5 / 7] * 7, [0.0]])
    positions = rng.permutation(n).astype(np.int64)
    kw = dict(seg_size=32, transposed=True)
    return (pack_lists(payloads, positions, assign, n_lists, **kw),
            jax_pack_lists(payloads, positions, assign, n_lists, **kw))


@pytest.mark.parametrize("ndev", [1, 2, 3, 8])
@pytest.mark.parametrize("with_row_ids", [True, False])
def test_shard_lists_bytes_equal_jax(csr_pair, ndev, with_row_ids):
    csr, jcsr = csr_pair
    got = shard_lists(csr, ndev, with_row_ids=with_row_ids)
    want = jax_shard_lists(jcsr, ndev, with_row_ids=with_row_ids)
    for f in ("data", "row_ids", "seg_valid", "seg_start", "seg_cnt", "seg_canon"):
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, f
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    for d in range(ndev):
        sh = rank_shard(csr.seg_start, csr.seg_cnt, ndev, d)
        np.testing.assert_array_equal(sh.segs, got.seg_canon[d, :len(sh.segs)])
        np.testing.assert_array_equal(sh.seg_cnt, got.seg_cnt[d])


# -- the ranks' jobs (one launch per mesh size) -------------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The artifacts and inputs, the JAX results at W 2 and 4, and the
    port's ranks' results at W 2 and 4."""
    root = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(11)
    x = _normed(rng, 1200, DIM)
    q = x[rng.choice(len(x), 16, replace=False)] + \
        0.1 * rng.standard_normal((16, DIM)).astype(np.float32)
    np.save(root / "q.npy", q)
    np.save(root / "corpus.npy", x)

    jpq = JaxIVFPQ(N_LISTS, DIM, pq_m=8, pq_nbits=4, use_opq=True, mesh=jax_build_mesh(),
                   seg_size=32, chunk=CHUNK, seed=0, scan_impl="map")
    jpq.train(x, kmeans_iters=4, opq_iters=2, pq_iters=4)
    jpq.fill(x)
    jpq.save(root / "ivfpq")
    # 3 lists over 4 ranks: rank 3 holds none
    small = IVFPQIndex(3, DIM, pq_m=8, pq_nbits=4, use_opq=False, seg_size=32,
                       chunk=CHUNK, device="cpu")
    small.train(x[:600], kmeans_iters=3, pq_iters=3)
    small.fill(x[:600])
    small.save(root / "ivfpq3")
    for name, n_lists, spherical in (("ivf", N_LISTS, True), ("ivf_l2", 3, False)):
        jivf = JaxIVFFlat(n_lists, mesh=jax_build_mesh(), seg_size=32, chunk=CHUNK,
                          spherical=spherical, seed=0)
        jivf.train(x, iters=4)
        jivf.fill(x)
        jivf.save(root / name)

    # per-rank candidate lists with ties planted within and across ranks
    vals = np.round(rng.standard_normal((4, 6, 5)), 1).astype(np.float32)
    vals[:, :, 1] = vals[:, :, 0]
    vals[1:, 2, :] = vals[0, 2, :]
    vals = -np.sort(-vals, axis=2)
    vals[3, 4, 3:] = -np.inf
    idx = rng.permutation(4 * 6 * 5).reshape(4, 6, 5).astype(np.int64)

    res = {"root": root, "q": q, "x": x, "merge": (vals, idx), "jax": {}, "port": {}}
    for w in (2, 4):
        jmesh = jax_build_mesh(jax.devices()[:w])
        jres = {}
        j = JaxIVFPQ.load(root / "ivfpq", mesh=jmesh, chunk=CHUNK, scan_impl="map")
        for k, nprobe in PQ_CASES:
            jres[("ivfpq", k, nprobe)] = j.search(q, k, nprobe=nprobe)
        for name in ("ivf", "ivf_l2"):
            j = JaxIVFFlat.load(root / name, mesh=jmesh, chunk=CHUNK)
            for k, nprobe in IVF_CASES:
                jres[(name, k, nprobe)] = j.search(q, k, nprobe=nprobe)
        jf = JaxFlat(jmesh, chunk=CHUNK)
        jf.add(x)
        jres[("flat",)] = jf.search(q, FLAT_K)
        res["jax"][w] = jres

        art = lambda name: str(root / name)  # noqa: E731
        np.savez(root / f"merge{w}.npz", values=vals[:w], indices=idx[:w])
        tasks = [{"name": "merge", "kind": "merge", "inputs": str(root / f"merge{w}.npz"),
                  "k": 7}]
        # hybrid: 8 segments of 4 x 32 code bytes hot on each rank's card
        for storage, hot in (("device", 0), ("host", 0), ("hybrid", 8 * 4 * 32)):
            tasks.append({"name": f"ivfpq_{storage}", "kind": "ivfpq", "art": art("ivfpq"),
                          "queries": str(root / "q.npy"), "chunk": CHUNK, "cases": PQ_CASES,
                          "storage": storage, "hot_budget_bytes": hot})
        tasks.append({"name": "ivfpq3", "kind": "ivfpq", "art": art("ivfpq3"),
                      "queries": str(root / "q.npy"), "chunk": CHUNK, "cases": PQ_CASES})
        for name in ("ivf", "ivf_l2"):
            tasks.append({"name": name, "kind": "ivf", "art": art(name),
                          "queries": str(root / "q.npy"), "chunk": CHUNK, "cases": IVF_CASES})
        tasks.append({"name": "flat", "kind": "flat", "corpus": str(root / "corpus.npy"),
                      "queries": str(root / "q.npy"), "chunk": CHUNK, "k": FLAT_K})
        job = root / f"w{w}"
        job.mkdir()
        res["port"][w] = run_ranks(w, job, tasks)
    return res


W = pytest.mark.parametrize("w", [2, 4])


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])
    return ranks[0][key]


@W
def test_merge_topk_all_gather_matches_jax(world, w):
    vals, idx = world["merge"]
    mesh = JaxMesh(np.asarray(jax.devices()[:w]), ("shard",))
    f = shard_map(lambda v, i: jax_merge(v[0], i[0], 7, "shard"), mesh=mesh,
                  in_specs=(P("shard"), P("shard")), out_specs=(P(), P()), check_vma=False)
    jv, ji = f(vals[:w], idx[:w])
    ranks = world["port"][w]
    np.testing.assert_array_equal(_same_on_every_rank(ranks, "merge/v"), np.asarray(jv))
    np.testing.assert_array_equal(_same_on_every_rank(ranks, "merge/i"), np.asarray(ji))
    np.testing.assert_array_equal(ranks[0]["merge/stats"], [[r, 1] for r in range(w)])


@W
@pytest.mark.parametrize("case", PQ_CASES, ids=lambda c: f"k{c[0]}-np{c[1]}")
def test_ivfpq_search_matches_jax_mesh(world, w, case):
    k, nprobe = case
    jv, jp = world["jax"][w][("ivfpq", k, nprobe)]
    ranks = world["port"][w]
    p = _same_on_every_rank(ranks, f"ivfpq_device/{k}_{nprobe}/p")
    v = _same_on_every_rank(ranks, f"ivfpq_device/{k}_{nprobe}/v")
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-5)


@W
@pytest.mark.parametrize("storage", ["device", "host", "hybrid"])
def test_ivfpq_sharded_equals_one_process(world, w, storage):
    """Every storage over W ranks against one process (no group): the
    same per-slot sums and bias, so the same scores bit for bit. Each
    rank installs only its own lists."""
    one = IVFPQIndex.load(world["root"] / "ivfpq", device="cpu", chunk=CHUNK)
    ranks = world["port"][w]
    for k, nprobe in PQ_CASES:
        v, p = one.search(world["q"], k, nprobe=nprobe)
        key = f"ivfpq_{storage}/{k}_{nprobe}"
        np.testing.assert_array_equal(_same_on_every_rank(ranks, f"{key}/p"), p)
        np.testing.assert_array_equal(_same_on_every_rank(ranks, f"{key}/v"), v)
    # the last case's live slots, split over the ranks' own lists (hot
    # and cold in hybrid storage)
    live = ranks[0][f"ivfpq_{storage}/live_slots_by_rank"]
    assert len(live) == w
    assert sum(live) + ranks[0][f"ivfpq_{storage}/cold_live_slots"] == \
        one.last_scan_stats["live_slots"]
    resident = [int(r[f"ivfpq_{storage}/resident_bytes"]) for r in ranks]
    if storage == "device":
        seg_bytes = int(np.prod(one.packed.data.shape[1:]))
        want = [int(one.packed.seg_cnt[d::w].sum()) * seg_bytes for d in range(w)]
        assert resident == want and sum(resident) == one.resident_bytes
    elif storage == "host":
        assert resident == [0] * w
    else:
        assert 0 < sum(resident) < one.resident_bytes


@W
def test_ivfpq_rank_without_lists(world, w):
    one = IVFPQIndex.load(world["root"] / "ivfpq3", device="cpu", chunk=CHUNK)
    ranks = world["port"][w]
    for k, nprobe in PQ_CASES:
        v, p = one.search(world["q"], k, nprobe=nprobe)
        np.testing.assert_array_equal(ranks[0][f"ivfpq3/{k}_{nprobe}/p"], p)
        np.testing.assert_array_equal(ranks[0][f"ivfpq3/{k}_{nprobe}/v"], v)
    if w == 4:
        assert int(ranks[3]["ivfpq3/resident_bytes"]) == 0
        assert ranks[0]["ivfpq3/live_slots_by_rank"][3] == 0


@W
@pytest.mark.parametrize("name", ["ivf", "ivf_l2"])
def test_ivf_flat_search_matches_jax_mesh(world, w, name):
    """Spherical, and plain L2 over 3 lists (at W 4 rank 3 holds none)."""
    ranks = world["port"][w]
    one = IVFFlatIndex.load(world["root"] / name, device="cpu", chunk=CHUNK)
    for k, nprobe in IVF_CASES:
        jv, jp = world["jax"][w][(name, k, nprobe)]
        p = _same_on_every_rank(ranks, f"{name}/{k}_{nprobe}/p")
        v = _same_on_every_rank(ranks, f"{name}/{k}_{nprobe}/v")
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-5)
        ov, op = one.search(world["q"], k, nprobe=nprobe)
        np.testing.assert_array_equal(p, op)
        np.testing.assert_array_equal(v, ov)


@W
def test_flat_search_matches_jax_mesh(world, w):
    jv, jp = world["jax"][w][("flat",)]
    ranks = world["port"][w]
    p = _same_on_every_rank(ranks, "flat/p")
    v = _same_on_every_rank(ranks, "flat/v")
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-5)
    one = FlatIndex(chunk=CHUNK, device="cpu")
    one.add(world["x"])
    ov, op = one.search(world["q"], FLAT_K)
    np.testing.assert_array_equal(p, op)
    np.testing.assert_allclose(v, ov, rtol=1e-6, atol=1e-6)
    # each rank holds its own block of rows
    n = len(world["x"])
    assert [int(r["flat/rows"]) for r in ranks] == [
        shard_rows(n, Mesh(d, w, torch.device("cpu")), CHUNK)[1]
        - shard_rows(n, Mesh(d, w, torch.device("cpu")), CHUNK)[0] for d in range(w)]


# -- the mesh's contracts, in this process -----------------------------------------


def test_build_mesh_without_a_group_is_one_rank():
    m = build_mesh("cpu")
    assert (m.rank, m.size, m.group, m.collective) == (0, 1, None, False)
    assert m.owned(5).all()
    idx = FlatIndex(chunk=CHUNK, device="cpu")
    assert idx.mesh.size == 1 and not idx.mesh.collective


@pytest.mark.parametrize("n,w,chunk", [(1000, 4, 128), (1000, 2, 128), (10, 4, 8),
                                       (5, 8, 1)])
def test_shard_rows_is_the_jax_row_sharding(n, w, chunk):
    """Blocks of ceil(n / W) rows rounded up to chunk (the JAX package's
    ``_set_corpus``), covering [0, n) in rank order."""
    per = -(-(-(-n // w)) // chunk) * chunk
    got = [shard_rows(n, Mesh(r, w, torch.device("cpu")), chunk) for r in range(w)]
    assert all(g[2] == per and g[0] == r * per for r, g in enumerate(got))
    assert sum(hi - lo for lo, hi, _ in got) == n


def test_nccl_is_refused_up_front(monkeypatch):
    """Before any rank blocks in a rendezvous: nccl on the CPU, and nccl
    with more ranks on this host than cards."""
    with pytest.raises(ValueError, match="CUDA devices"):
        init_distributed("127.0.0.1:1", 2, 0, "nccl", device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one rank per card"):
        init_distributed("127.0.0.1:1", 4, 0, "nccl", device="cuda:0")
    with pytest.raises(ValueError, match="one of"):
        init_distributed("127.0.0.1:1", 2, 0, "mpi", device="cpu")
    with pytest.raises(ValueError, match="outside"):
        init_distributed("127.0.0.1:1", 2, 2, device="cpu")


def test_sharded_flat_index_keeps_its_block_and_device(world):
    """A sharded FlatIndex keeps its rank's block of one add, refuses a
    second, and refuses a device other than its mesh's. (The build over
    a mesh: tests/test_torch_build_mesh.py.)"""
    mesh = Mesh(1, 2, torch.device("cpu"), group=object(), backend="gloo")
    flat = FlatIndex(chunk=CHUNK, mesh=mesh)
    flat.add(world["x"][:300])
    assert flat._lo == 256 and flat._rows == 44
    with pytest.raises(ValueError, match="one add"):
        flat.add(world["x"][:10])
    with pytest.raises(ValueError, match="not the mesh's"):
        FlatIndex(device="cuda:1", mesh=Mesh(0, 2, torch.device("cuda", 0)))
