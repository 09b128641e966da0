"""CSR list artifacts: the port and the JAX package read each other's
format-3 directories bit for bit, and share the slot helpers."""

import numpy as np
import pytest

from abstracts_search_tpu.index import lists as jlists
from abstracts_search_tpu_torch.index import lists as tlists

FILES = ("codes.bin", "row_ids.bin", "seg_valid.npy", "seg_start.npy", "seg_cnt.npy",
         "lists_meta.json")


def _packed(transposed, seed=0):
    rng = np.random.default_rng(seed)
    n, n_lists = 700, 9
    payload = rng.integers(0, 256, (n, 8), dtype=np.uint8)
    assign = rng.integers(0, n_lists - 1, n)       # the last list stays empty
    return jlists.pack_lists(payload, rng.permutation(n), assign, n_lists,
                             seg_size=32, transposed=transposed)


def _assert_same(a, b):
    for f in ("data", "row_ids", "seg_valid", "seg_start", "seg_cnt"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y)
    for f in ("seg_size", "n_lists", "n_rows", "transposed", "n_segs"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("transposed", [True, False], ids=["transposed", "row_major"])
@pytest.mark.parametrize("mmap", [True, False])
def test_jax_written_loads_in_port(tmp_path, transposed, mmap):
    csr = _packed(transposed)
    jlists.save_lists(csr, tmp_path / "j")
    _assert_same(tlists.load_lists(tmp_path / "j", mmap=mmap), csr)


@pytest.mark.parametrize("transposed", [True, False], ids=["transposed", "row_major"])
def test_port_written_loads_in_jax(tmp_path, transposed):
    csr = tlists.load_lists(_save_jax(tmp_path, transposed), mmap=True)
    tlists.save_lists(csr, tmp_path / "t")
    _assert_same(jlists.load_lists(tmp_path / "t", mmap=False), csr)
    for name in FILES:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name


def _save_jax(tmp_path, transposed):
    jlists.save_lists(_packed(transposed), tmp_path / "j")
    return tmp_path / "j"


@pytest.mark.parametrize("v", [0, 1, 8, 9, 100, 1000, 12345])
def test_bucket_size_matches(v):
    assert tlists.bucket_size(v) == jlists.bucket_size(v)


def test_ragged_ranges_matches():
    rng = np.random.default_rng(1)
    starts = rng.integers(0, 100, 20)
    counts = rng.integers(0, 5, 20)
    for a, b in zip(tlists.ragged_ranges(starts, counts),
                    jlists.ragged_ranges(starts, counts)):
        np.testing.assert_array_equal(a, b)
    assert all(len(a) == 0 for a in tlists.ragged_ranges(starts[:0], counts[:0]))
