"""The port's IVF-Flat index against the JAX package's, spherical and
plain L2.

- Train: one seed gives the same centroids (atol 1e-5) and iterations.
- Search: with the same trained state, the port's fill packs the JAX
  package's lists byte for byte, and search returns the same positions
  with scores within 1e-5 (the JAX scan is an f32 einsum at HIGHEST
  precision, the port's an f32 matmul with TF32 off), at every nprobe,
  with a window of one query or of all of them.
- Artifacts: each package opens the other's saved index and searches it
  to the same results.
- Guards and edges: k past the candidates pads with -1, unfilled and
  refilled indexes refuse.

Scores are held within 1e-5 absolute or 1e-6 relative: plain-L2 scores
(q.x - ||x||^2/2) reach ~60 on these rows, where 1e-5 is two f32 ulps.
"""

import numpy as np
import pytest

from abstracts_search_tpu.index.ivf import IVFFlatIndex as JaxIVF
from abstracts_search_tpu.parallel import build_mesh
from abstracts_search_tpu_torch.index import IVFFlatIndex

N_LISTS, DIM, SEG, CHUNK = 16, 24, 32, 128
ARGS = dict(seg_size=SEG, chunk=CHUNK, seed=0)
LIST_FILES = ("codes.bin", "row_ids.bin", "seg_valid.npy", "seg_start.npy", "seg_cnt.npy",
              "lists_meta.json")
TOL, RTOL = 1e-5, 1e-6


def corpus(seed, n=1500, spherical=True):
    """Clustered rows (unit for spherical; norms spread over 0.5-3 for
    plain L2, where the bias column matters)."""
    rng = np.random.default_rng(seed)
    cs = rng.standard_normal((40, DIM)).astype(np.float32)
    x = cs[rng.integers(0, 40, n)] + 0.3 * rng.standard_normal((n, DIM)).astype(np.float32)
    if spherical:
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    return (x * rng.uniform(0.5, 3.0, (n, 1))).astype(np.float32)


def queries(x, seed, n=40):
    rng = np.random.default_rng(seed)
    return (x[rng.choice(len(x), n, replace=False)]
            + 0.05 * rng.standard_normal((n, DIM))).astype(np.float32)


@pytest.fixture(scope="module", params=[True, False], ids=["spherical", "plain_l2"])
def built(request, tmp_path_factory):
    """A JAX-trained, JAX-filled index, saved; the port's index filled
    from the same trained state."""
    sph = request.param
    x = corpus(0, spherical=sph)
    j = JaxIVF(N_LISTS, mesh=build_mesh(), spherical=sph, **ARGS)
    j.train(x, iters=6)
    j.fill(x)
    art = tmp_path_factory.mktemp("ivf") / "jax"
    j.save(art)
    t = IVFFlatIndex(N_LISTS, spherical=sph, device="cpu", **ARGS)
    t.kmeans.centroids = j.centroids.copy()
    t.fill(x)
    return sph, x, j, t, art


@pytest.mark.parametrize("spherical", [True, False])
def test_train_equals_jax(spherical):
    x = corpus(1, spherical=spherical)
    j = JaxIVF(N_LISTS, mesh=build_mesh(), spherical=spherical, **ARGS)
    t = IVFFlatIndex(N_LISTS, spherical=spherical, device="cpu", **ARGS)
    j.train(x, iters=6)
    stats = t.train(x, iters=6)
    assert stats["iters_run"] == j.kmeans.stats["iters_run"]
    np.testing.assert_allclose(t.centroids, j.centroids, atol=TOL)


def test_fill_packs_jax_lists(built, tmp_path):
    _, _, j, t, art = built
    t.save(tmp_path / "port")
    for f in LIST_FILES:
        assert (tmp_path / "port" / "lists" / f).read_bytes() == \
            (art / "lists" / f).read_bytes(), f
    assert t.n == j.n


@pytest.mark.parametrize("nprobe", [1, 3, 16])
def test_search_equals_jax(built, nprobe):
    _, x, j, t, _ = built
    q = queries(x, 2)
    jv, jp = j.search(q, 10, nprobe=nprobe)
    tv, tp = t.search(q, 10, nprobe=nprobe)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(tv, jv, atol=TOL, rtol=RTOL)


def test_scan_window_does_not_change_results(built, monkeypatch):
    _, x, _, t, _ = built
    q = queries(x, 3)
    want = t.search(q, 10, nprobe=4)
    monkeypatch.setattr(IVFFlatIndex, "SCAN_WINDOW_BYTES", 1)
    got = t.search(q, 10, nprobe=4)
    # a one-query window changes the BLAS batch, not the candidates
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=TOL, rtol=RTOL)


def test_artifacts_open_across_packages(built, tmp_path):
    sph, x, j, t, art = built
    q = queries(x, 4)
    jv, jp = j.search(q, 10, nprobe=4)
    # the JAX artifact in the port
    pv, pp = IVFFlatIndex.load(art, device="cpu", chunk=CHUNK).search(q, 10, nprobe=4)
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_allclose(pv, jv, atol=TOL, rtol=RTOL)
    # the port's artifact in the JAX package
    t.save(tmp_path / "port")
    back = JaxIVF.load(tmp_path / "port", mesh=build_mesh(), chunk=CHUNK)
    assert back.spherical == sph and back.n == len(x)
    bv, bp = back.search(q, 10, nprobe=4)
    np.testing.assert_array_equal(bp, jp)
    np.testing.assert_allclose(bv, jv, atol=TOL, rtol=RTOL)


def test_k_past_the_candidates_pads(built):
    _, x, j, t, _ = built
    q = queries(x, 5, n=4)
    jv, jp = j.search(q, 200, nprobe=1)
    tv, tp = t.search(q, 200, nprobe=1)
    np.testing.assert_array_equal(tp, jp)
    assert (tp == -1).any() and np.isneginf(tv[tp == -1]).all()


def test_guards():
    x = corpus(6)
    t = IVFFlatIndex(N_LISTS, device="cpu", **ARGS)
    with pytest.raises(RuntimeError, match="train"):
        t.fill(x)
    t.train(x, iters=2)
    with pytest.raises(RuntimeError, match="fill"):
        t.search(x[:2], 5)
    t.fill(x)
    with pytest.raises(RuntimeError, match="already filled"):
        t.fill(x)
    with pytest.raises(ValueError):
        IVFFlatIndex(N_LISTS, device="cpu", impl="xla")
