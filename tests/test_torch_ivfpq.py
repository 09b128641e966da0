"""The port's IVF-PQ search against the JAX package's, on the CPU.

Small indexes are trained and filled by the JAX package, carried into
the port by both routes (artifact save -> port ``load``, and
``index_from_numpy``), and searched by both. Positions must be
identical. Scores agree to rtol=1e-5, atol=1e-5: both sides compute the
same f32 bias and LUT sums, but in another accumulation order.
"""

import dataclasses
import shutil

import numpy as np
import pytest

from abstracts_search_tpu.index.ivfpq import IVFPQIndex as JaxIVFPQ
from abstracts_search_tpu.index.lists import save_lists as jax_save_lists
from abstracts_search_tpu.parallel import build_mesh
from abstracts_search_tpu_torch.index import IVFPQIndex, index_from_numpy

N_LISTS, DIM = 8, 32


def _normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def jax_meta(jidx):
    return {"n_lists": jidx.n_lists, "dim": jidx.dim, "pq_m": jidx.pq.m,
            "pq_nbits": jidx.pq.nbits, "use_opq": jidx.use_opq,
            "seg_size": jidx.seg_size, "spherical": jidx.spherical}


def port_from_jax(jidx, **kw):
    return index_from_numpy(jax_meta(jidx), jidx.kmeans.centroids,
                            jidx.pq.centroids, jidx.rotation, jidx.packed,
                            device="cpu", chunk=jidx.chunk, **kw)


@pytest.fixture(scope="module", params=[(4, False), (8, True), (4, True)],
                ids=["pq8x4", "pq8x8-opq", "pq8x4-opq"])
def built(request, tmp_path_factory):
    nbits, use_opq = request.param
    rng = np.random.default_rng(7)
    x = _normed(rng, 1500, DIM)
    jidx = JaxIVFPQ(N_LISTS, DIM, pq_m=8, pq_nbits=nbits, use_opq=use_opq,
                    mesh=build_mesh(), seg_size=32, chunk=128, seed=0,
                    scan_impl="map")
    jidx.train(x, kmeans_iters=4, opq_iters=2, pq_iters=4)
    jidx.fill(x)
    art = tmp_path_factory.mktemp("ivfpq") / "index"
    jidx.save(art)
    q = x[rng.choice(len(x), 12, replace=False)] \
        + 0.1 * rng.standard_normal((12, DIM)).astype(np.float32)
    return jidx, art, q


@pytest.mark.parametrize("route", ["load", "numpy"])
def test_search_matches_jax(built, route):
    jidx, art, q = built
    if route == "load":
        idx = IVFPQIndex.load(art, device="cpu", chunk=128)
    else:
        idx = port_from_jax(jidx)
    assert idx.packed.transposed and idx.n == jidx.n
    # k=300 exceeds every query's candidate count at nprobe 1: the tail
    # must come back as (-inf, -1) on both sides
    for nprobe, k in ((1, 5), (4, 10), (N_LISTS, 10), (1, 300)):
        jv, jp = jidx.search(q, k, nprobe=nprobe)
        v, p = idx.search(q, k, nprobe=nprobe)
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-5)
        if k == 300:
            assert (p == -1).any() and np.isneginf(v[p == -1]).all()


def test_row_major_artifact_matches_jax(built, tmp_path):
    """A legacy row-major artifact (segment blocks [SEG, MB], written by
    the JAX package's save_lists) searched by both packages: the JAX
    scores branch (adc_scan_xla) against the port's (adc_scan)."""
    jidx, art, q = built
    rows_art = tmp_path / "rows"
    shutil.copytree(art, rows_art)
    blocks = np.ascontiguousarray(np.asarray(jidx.packed.data).transpose(0, 2, 1))
    jax_save_lists(dataclasses.replace(jidx.packed, data=blocks, transposed=False),
                   rows_art / "lists")
    j2 = JaxIVFPQ.load(rows_art, mesh=build_mesh(), chunk=128, scan_impl="map")
    idx = IVFPQIndex.load(rows_art, device="cpu", chunk=128)
    assert not idx.packed.transposed and idx._codes.shape == blocks.shape
    for nprobe, k in ((1, 5), (4, 10), (N_LISTS, 10), (1, 300)):
        jv, jp = j2.search(q, k, nprobe=nprobe)
        v, p = idx.search(q, k, nprobe=nprobe)
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-5)
    # and the same hits as the transposed artifact the blocks came from
    v, p = idx.search(q, 10, nprobe=4)
    tv, tp = IVFPQIndex.load(art, device="cpu", chunk=128).search(q, 10, nprobe=4)
    np.testing.assert_array_equal(p, tp)
    np.testing.assert_array_equal(v, tv)


def test_save_load_roundtrip_is_bit_identical(built, tmp_path):
    """The port writes the artifact the JAX package reads, and back."""
    jidx, art, q = built
    idx = IVFPQIndex.load(art, device="cpu", chunk=128)
    idx.save(tmp_path / "again")
    j2 = JaxIVFPQ.load(tmp_path / "again", mesh=build_mesh(), chunk=128,
                       scan_impl="map")
    for name in ("codes.bin", "row_ids.bin"):
        assert (tmp_path / "again" / "lists" / name).read_bytes() == \
            (art / "lists" / name).read_bytes()
    jv, jp = jidx.search(q, 5, nprobe=4)
    v2, p2 = j2.search(q, 5, nprobe=4)
    np.testing.assert_array_equal(p2, jp)
    np.testing.assert_array_equal(v2, jv)


def test_entry_points_refuse_what_is_not_ported(built):
    jidx, art, _ = built
    with pytest.raises(NotImplementedError):
        IVFPQIndex.load(art, device="cpu", storage="host")
    with pytest.raises(ValueError):
        IVFPQIndex.load(art, device="cpu", impl="pallas")
