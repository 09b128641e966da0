"""The port's streaming top-k (plain PyTorch version) against the JAX
package's ``streaming_topk`` (``impl="xla"`` and ``"pallas_interpret"``).

Same numpy inputs, made from a seed, go through both. Indices must be
identical (ties go to the lowest row on both sides). Values agree to
rtol=1e-5, atol=1e-6: both accumulate in f32, in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abstracts_search_tpu.ops.topk import streaming_topk as jax_topk
from abstracts_search_tpu_torch.ops.topk import streaming_topk

CASES = {
    #            Q, D,  N,   chunk, n_valid, k,  dtype
    "f32":      (5, 32, 512, 128, 512, 10, "f32"),
    "bf16":     (5, 32, 512, 128, 512, 10, "bf16"),
    "n_valid":  (4, 16, 512, 128, 300, 10, "f32"),
    "k_gt_valid": (4, 16, 128, 128, 5, 16, "f32"),
    "k_gt_16":  (3, 16, 256, 64, 256, 32, "bf16"),
    "dup_rows": (6, 16, 256, 64, 250, 12, "f32"),
}


def _inputs(case):
    qn, d, n, chunk, n_valid, k, dtype = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q = rng.standard_normal((qn, d)).astype(np.float32)
    if case == "dup_rows":
        # every row repeats one of 20 distinct rows: exact ties everywhere
        x = rng.standard_normal((20, d)).astype(np.float32)[rng.integers(0, 20, n)]
    else:
        x = rng.standard_normal((n, d)).astype(np.float32)
    return q, x, n_valid, k, chunk, dtype


@pytest.mark.parametrize("jax_impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax(case, jax_impl):
    q, x, n_valid, k, chunk, dtype = _inputs(case)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    v, i = streaming_topk(torch.from_numpy(q).to(tdt), torch.from_numpy(x).to(tdt),
                          n_valid, k, chunk=chunk, impl="torch")
    jv, ji = jax_topk(jnp.asarray(q, jdt), jnp.asarray(x, jdt), jnp.int32(n_valid),
                      k, chunk=chunk, impl=jax_impl)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    if k > n_valid:
        assert np.isneginf(v.numpy()[:, n_valid:]).all()
        assert (i.numpy()[:, n_valid:] == 0).all()


def test_auto_takes_the_plain_version_on_cpu():
    q, x, n_valid, k, chunk, _ = _inputs("f32")
    a = streaming_topk(torch.from_numpy(q), torch.from_numpy(x), n_valid, k, chunk=chunk)
    b = streaming_topk(torch.from_numpy(q), torch.from_numpy(x), n_valid, k, chunk=chunk,
                       impl="torch")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_validates_args():
    q = torch.zeros((2, 8))
    with pytest.raises(ValueError):
        streaming_topk(q, torch.zeros((100, 8)), 100, 5, chunk=64)   # 100 % 64
    with pytest.raises(ValueError):
        streaming_topk(q, torch.zeros((64, 8)), 64, 65, chunk=64)    # k > chunk
    with pytest.raises(ValueError, match="power-of-two"):
        streaming_topk(q, torch.zeros((300, 8)), 300, 5, chunk=100, mode="fast")
    with pytest.raises(ValueError):
        streaming_topk(q, torch.zeros((64, 8)), 64, 5, chunk=64, mode="nope")
    with pytest.raises(ValueError):
        streaming_topk(q, torch.zeros((64, 8)), 64, 5, chunk=64, impl="pallas")


def test_fast_mode_waits_for_its_kernel():
    with pytest.raises(NotImplementedError, match="fast mode"):
        streaming_topk(torch.zeros((2, 8)), torch.zeros((64, 8)), 64, 5, chunk=64,
                       mode="fast")


def test_cuda_impl_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        streaming_topk(torch.zeros((2, 8)), torch.zeros((64, 8)), 64, 5, chunk=64,
                       impl="cuda")
