"""The port's list packing against the JAX package's, on the CPU.

Given the same inputs, the port's ``pack_lists`` (row-major and
transposed), ``pack_lists_external`` (the one-pass sorted scatter, and
the two-pass distribution sort under a small ``bucket_bytes``) and
``resegment_lists`` must equal the JAX package's bit for bit: the
arrays they return and every file they write. ``prefetch_iterator``
keeps order and forwards the producer's error.
"""

import numpy as np
import pytest

from abstracts_search_tpu.index import lists as jl
from abstracts_search_tpu.utils import prefetch_iterator as jax_prefetch
from abstracts_search_tpu_torch.index import lists as tl
from abstracts_search_tpu_torch.utils import prefetch_iterator

FIELDS = ("data", "row_ids", "seg_valid", "seg_start", "seg_cnt")
FILES = ("codes.bin", "row_ids.bin", "seg_valid.npy", "seg_start.npy", "seg_cnt.npy",
         "lists_meta.json")


def assert_same_csr(a, b):
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.seg_size, a.n_lists, a.n_rows, a.transposed) == \
        (b.seg_size, b.n_lists, b.n_rows, b.transposed)


def assert_same_files(da, db):
    for name in FILES:
        assert (da / name).read_bytes() == (db / name).read_bytes(), name


def skewed(rng, n, n_lists, mb):
    """Payloads, positions and zipf-skewed assignments with empty lists."""
    codes = rng.integers(0, 256, (n, mb), dtype=np.uint8)
    pos = rng.permutation(n).astype(np.int64)
    p = 1 / np.arange(1, n_lists + 1) ** 1.2
    assign = rng.choice(n_lists, n, p=p / p.sum()).astype(np.int64)
    assign[assign == 5] = 0          # list 5 empty
    return codes, pos, assign


@pytest.mark.parametrize("transposed", [False, True], ids=["row-major", "transposed"])
def test_pack_lists_matches_jax(transposed):
    rng = np.random.default_rng(1)
    codes, pos, assign = skewed(rng, 7000, 37, 16)
    for seg in (32, 64):
        assert_same_csr(tl.pack_lists(codes, pos, assign, 37, seg_size=seg,
                                      transposed=transposed),
                        jl.pack_lists(codes, pos, assign, 37, seg_size=seg,
                                      transposed=transposed))
    # no rows: one dead segment on both sides
    e = np.zeros((0, 16), np.uint8)
    z = np.zeros(0, np.int64)
    assert_same_csr(tl.pack_lists(e, z, z, 4, seg_size=32, transposed=transposed),
                    jl.pack_lists(e, z, z, 4, seg_size=32, transposed=transposed))


@pytest.mark.parametrize("bucket_bytes", [1 << 30, 24_576], ids=["sorted-scatter",
                                                                  "distribution"])
@pytest.mark.parametrize("transposed", [False, True], ids=["row-major", "transposed"])
def test_pack_external_matches_jax_file_for_file(tmp_path, bucket_bytes, transposed):
    """Spill inputs on disk as the fill leaves them (int32 assignments);
    the small bucket forces the distribution sort, with the zipf-hot
    list bigger than a bucket."""
    rng = np.random.default_rng(2)
    n, mb, n_lists = 20_000, 8, 64
    codes, pos, assign = skewed(rng, n, n_lists, mb)
    codes.tofile(tmp_path / "codes.u8")
    assign.astype(np.int32).tofile(tmp_path / "assign.i32")
    codes_mm = np.memmap(tmp_path / "codes.u8", dtype=np.uint8, mode="r", shape=(n, mb))
    assign_mm = np.memmap(tmp_path / "assign.i32", dtype=np.int32, mode="r", shape=(n,))
    kw = dict(seg_size=32, slab_rows=3000, bucket_bytes=bucket_bytes, transposed=transposed)
    got = tl.pack_lists_external(codes_mm, pos, assign_mm, n_lists,
                                 out_dir=tmp_path / "port", **kw)
    ref = jl.pack_lists_external(codes_mm, pos, assign_mm, n_lists,
                                 out_dir=tmp_path / "jax", **kw)
    assert_same_csr(got, ref)
    assert_same_files(tmp_path / "port", tmp_path / "jax")
    # and the same as the in-RAM pack
    assert_same_csr(got, jl.pack_lists(codes, pos, assign, n_lists, seg_size=32,
                                       transposed=transposed))
    assert not list(tmp_path.glob("astpu_pack_*"))


@pytest.mark.parametrize("transposed", [False, True], ids=["row-major", "transposed"])
def test_resegment_matches_jax_file_for_file(tmp_path, transposed):
    rng = np.random.default_rng(3)
    codes, pos, assign = skewed(rng, 5000, 13, 8)
    jl.save_lists(jl.pack_lists(codes, pos, assign, 13, seg_size=128,
                                transposed=transposed), tmp_path / "big")
    for seg in (64, 32):
        tl.resegment_lists(tmp_path / "big", tmp_path / f"port{seg}", seg, slab=7)
        jl.resegment_lists(tmp_path / "big", tmp_path / f"jax{seg}", seg, slab=7)
        assert_same_files(tmp_path / f"port{seg}", tmp_path / f"jax{seg}")
        assert_same_csr(tl.load_lists(tmp_path / f"port{seg}"),
                        jl.pack_lists(codes, pos, assign, 13, seg_size=seg,
                                      transposed=transposed))
    with pytest.raises(ValueError, match="divide"):
        tl.resegment_lists(tmp_path / "big", tmp_path / "bad", 48)


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetch_iterator_order_and_errors(depth):
    assert list(prefetch_iterator(iter(range(100)), depth=depth)) == \
        list(jax_prefetch(iter(range(100)), depth=depth)) == list(range(100))

    def boom():
        yield 1
        yield 2
        raise ValueError("boom")

    it = prefetch_iterator(boom(), depth=depth)
    assert [next(it), next(it)] == [1, 2]
    with pytest.raises(ValueError, match="boom"):
        next(it)
