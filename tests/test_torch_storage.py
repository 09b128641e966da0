"""The port's host and hybrid storage against the JAX package's, on the
CPU.

The JAX package builds an index on a skewed corpus (so the hot set
means something), in PQ8x4 and PQ8x8, saved in transposed and in
row-major lists. Each artifact opens in both packages in host storage
and in hybrid storage at hot budgets 0 (every list cold), 2,000 bytes (a
large list hot: none here), half the payload (the largest lists hot, a
real cold tail) and 10**9 (every list hot). JAX runs on a one-device
mesh, so ``hot_budget_bytes`` means the same in both (one card), with
its XLA oracles (``impl="xla"``, ``scan_impl="map"``). Positions must be
identical and scores agree to rtol=1e-5, atol=1e-5; the hot list set and
the live slot counts must be the JAX package's.
"""

import dataclasses
import shutil

import jax
import numpy as np
import pytest

from abstracts_search_tpu.index.ivfpq import IVFPQIndex as JaxIVFPQ
from abstracts_search_tpu.index.lists import save_lists as jax_save_lists
from abstracts_search_tpu.parallel import build_mesh
from abstracts_search_tpu_torch.index import IVFPQIndex
from abstracts_search_tpu_torch.index.ivfpq import auto_storage

N, DIM, N_LISTS = 2500, 16, 8
STORAGES = [("host", None), ("hybrid", 0), ("hybrid", 2_000), ("hybrid", "half"),
            ("hybrid", 10**9)]
STORAGE_IDS = ["host", "hybrid0", "hybrid2000", "hybrid_half", "hybrid1e9"]
# (nprobe, k): k 300 exceeds every query's candidates at nprobe 1, so
# the (-inf, -1) tail is held too
SEARCHES = [(4, 6), (N_LISTS, 10), (1, 300)]


def _skewed(rng):
    hot = 0.05 * rng.standard_normal((2000, DIM)).astype(np.float32)
    hot[:, 0] += 1.0
    cold = rng.standard_normal((500, DIM)).astype(np.float32)
    x = np.concatenate([hot, cold])
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module", params=[4, 8], ids=["pq8x4", "pq8x8"])
def artifacts(request, tmp_path_factory):
    """-> (queries, {"transposed": dir, "row-major": dir})"""
    rng = np.random.default_rng(0)
    x = _skewed(rng)
    jidx = JaxIVFPQ(N_LISTS, DIM, pq_m=8, pq_nbits=request.param, use_opq=False,
                    mesh=build_mesh(), seg_size=32, chunk=128, seed=0)
    jidx.train(x, kmeans_iters=5, pq_iters=5)
    jidx.fill(x)
    root = tmp_path_factory.mktemp(f"storage{request.param}")
    jidx.save(root / "t")
    shutil.copytree(root / "t", root / "r")
    blocks = np.ascontiguousarray(np.asarray(jidx.packed.data).transpose(0, 2, 1))
    jax_save_lists(dataclasses.replace(jidx.packed, data=blocks, transposed=False),
                   root / "r" / "lists")
    q = x[rng.choice(N, 9, replace=False)] \
        + 0.02 * rng.standard_normal((9, DIM)).astype(np.float32)
    return q, {"transposed": root / "t", "row-major": root / "r"}


def _budget(art, budget):
    """"half": half the artifact's payload bytes"""
    if budget == "half":
        return (art / "lists" / "codes.bin").stat().st_size // 2
    return budget


def _open_both(art, storage, budget):
    kw = {"storage": storage}
    if budget is not None:
        kw["hot_budget_bytes"] = _budget(art, budget)
    j = JaxIVFPQ.load(art, mesh=build_mesh(jax.devices()[:1]), chunk=128,
                      scan_impl="map", impl="xla", **kw)
    t = IVFPQIndex.load(art, device="cpu", chunk=128, **kw)
    return j, t


@pytest.mark.parametrize("storage,budget", STORAGES, ids=STORAGE_IDS)
@pytest.mark.parametrize("layout", ["transposed", "row-major"])
def test_storage_matches_jax(artifacts, layout, storage, budget):
    q, arts = artifacts
    j, t = _open_both(arts[layout], storage, budget)
    assert t.storage == j.storage == storage
    assert t.packed.transposed == (layout == "transposed")
    if storage == "hybrid":
        hot = j._pick_hot_lists(j.packed)
        np.testing.assert_array_equal(
            t._seg_cnt.numpy(), np.where(hot, j.packed.seg_cnt, 0))
        assert t._has_cold == j._has_cold
        # the compacted hot segments map back to the hot lists' segments
        assert sorted(t._seg_map.tolist()) == [
            s for lst in np.nonzero(hot)[0]
            for s in range(j.packed.seg_start[lst],
                           j.packed.seg_start[lst] + j.packed.seg_cnt[lst])]
    for nprobe, k in SEARCHES:
        jv, jp = j.search(q, k, nprobe=nprobe)
        v, p = t.search(q, k, nprobe=nprobe)
        np.testing.assert_array_equal(p, jp, err_msg=f"nprobe {nprobe}, k {k}")
        np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-5)
        for key in ("live_slots", "cold_live_slots"):
            assert t.last_scan_stats.get(key) == j.last_scan_stats.get(key), key
    if budget == 0:
        assert t.last_scan_stats["live_slots"] == 0
        assert t.last_scan_stats["cold_live_slots"] > 0
    if budget == 10**9:
        assert t.last_scan_stats["cold_live_slots"] == 0 and not t._has_cold
    if budget == "half":
        assert 0 < t._codes.shape[0] < t.packed.n_segs and t._has_cold
        assert 0 < t.last_scan_stats["live_slots"]


@pytest.mark.parametrize("storage,budget", STORAGES, ids=STORAGE_IDS)
def test_storage_matches_device_storage(artifacts, storage, budget):
    """Every storage returns the device storage's scores bit for bit and
    its positions: the same per-slot sums, merged in another grouping."""
    q, arts = artifacts
    dev = IVFPQIndex.load(arts["transposed"], device="cpu", chunk=128)
    other = IVFPQIndex.load(arts["transposed"], device="cpu", chunk=128, storage=storage,
                            hot_budget_bytes=_budget(arts["transposed"], budget) or 0)
    for nprobe, k in SEARCHES:
        dv, dp = dev.search(q, k, nprobe=nprobe)
        v, p = other.search(q, k, nprobe=nprobe)
        np.testing.assert_array_equal(v, dv)
        np.testing.assert_array_equal(p, dp)


def test_host_storage_gathers_only_the_probed_segments(artifacts):
    q, arts = artifacts
    t = IVFPQIndex.load(arts["transposed"], device="cpu", chunk=128, storage="host")
    assert t._codes is None
    t.search(q[:3], 5, nprobe=2)
    st = t.last_scan_stats
    seg_bytes = int(np.prod(t.packed.data.shape[1:]))
    assert st["gathered_bytes"] == st["tiles"] * seg_bytes == st["live_slots"] * seg_bytes
    assert st["gather_ms"] >= 0


def test_auto_storage_resolves_to_device_on_the_cpu(artifacts):
    _, arts = artifacts
    t = IVFPQIndex.load(arts["transposed"], device="cpu", chunk=128, storage="auto")
    assert t.storage == "device" and t._seg_map is None


@pytest.mark.parametrize("payload,free,want", [
    (10 << 30, 80 << 30, ("device", None)),                 # fits beside the headroom
    (72 << 30, 80 << 30, ("device", None)),                 # exactly the ceiling
    (73 << 30, 80 << 30, ("hybrid", (72 << 30) - 1024)),    # past it: hybrid
    (10 << 30, 4 << 30, ("hybrid", 0)),                     # no room at all
])
def test_auto_storage_rule(payload, free, want):
    assert auto_storage(payload, free, 1024, 8 << 30) == want


def test_storage_is_checked():
    with pytest.raises(ValueError, match="storage"):
        IVFPQIndex(8, 16, pq_m=4, pq_nbits=4, storage="bogus", device="cpu")
