"""The port's kernel wrappers (``repro_torch.kernels.ops``) on the CPU,
where they run the plain PyTorch versions, against the JAX package's
Pallas kernels in interpret mode, on the same numpy inputs.

Tolerances: both sides compute distances in fp32 but sum the product in
different orders (XLA's dot vs PyTorch's matmul), so distances agree to
rtol 1e-5 / atol 1e-4 (values of order 2*D) and indices agree except at
near-ties within that tolerance. Exact ties (integer features) must
agree exactly: the lowest index wins on both sides. MRConv is one
subtraction and a max per element, so it must agree bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.kernels import launch_counts, ops, reset_launch_counts  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4


def _jax_topk(x, y, k, dilation):
    idx, dist = jops.digc_topk(jnp.asarray(x), jnp.asarray(y), k=k,
                               dilation=dilation, return_dists=True,
                               interpret=True)
    return np.asarray(idx), np.asarray(dist)


# (B, N, M, D, k, dilation): N == M, N != M, ragged N and M (off any
# tile multiple), dilations 1-3, and kd = k*d = 144.
DIGC_CASES = [
    (1, 64, 64, 16, 4, 1),
    (2, 50, 37, 8, 3, 2),
    (2, 100, 70, 24, 9, 3),
    (1, 37, 200, 12, 16, 9),
    (3, 9, 130, 5, 4, 3),
]


@pytest.mark.parametrize("b,n,m,d,k,dil", DIGC_CASES)
def test_digc_topk_matches_jax_pallas(b, n, m, d, k, dil):
    x = testing.features(n + m, b, n, d)
    y = testing.features(m + d, b, m, d)
    ref_i, ref_d = _jax_topk(x, y, k, dil)
    reset_launch_counts()
    idx, dist = ops.digc_topk(torch.from_numpy(x), torch.from_numpy(y), k=k,
                              dilation=dil, return_dists=True)
    assert launch_counts()["digc_topk"] == 0  # CPU tensors: plain version
    assert idx.dtype == torch.int32 and idx.shape == (b, n, k)
    testing.assert_topk_match(idx.numpy(), dist.numpy(), ref_i, ref_d,
                              rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k,dil", [(1, 1), (5, 2), (24, 3)])
def test_digc_topk_exact_ties_lowest_index(k, dil):
    x, y = testing.tied_inputs(k, 2, 40, 90, 6)
    ref_i, ref_d = _jax_topk(x, y, k, dil)
    idx, dist = ops.digc_topk(torch.from_numpy(x), torch.from_numpy(y), k=k,
                              dilation=dil, return_dists=True)
    np.testing.assert_array_equal(idx.numpy(), ref_i)
    np.testing.assert_array_equal(dist.numpy(), ref_d)


def test_digc_topk_unbatched_and_self_graph():
    x = testing.features(3, 30, 8)
    ref_i, ref_d = _jax_topk(x, x, 4, 2)
    idx, dist = ops.digc_topk(torch.from_numpy(x), torch.from_numpy(x), k=4,
                              dilation=2, return_dists=True)
    assert idx.shape == (30, 4)
    testing.assert_topk_match(idx.numpy(), dist.numpy(), ref_i, ref_d,
                              rtol=RTOL, atol=ATOL)


def test_digc_topk_kd_beyond_m_raises_like_jax():
    x = testing.features(0, 1, 8, 4)
    y = testing.features(1, 1, 5, 4)
    with pytest.raises(ValueError, match="exceeds"):
        jops.digc_topk(jnp.asarray(x), jnp.asarray(y), k=3, dilation=2,
                       interpret=True)
    with pytest.raises(ValueError, match="exceeds"):
        ops.digc_topk(torch.from_numpy(x), torch.from_numpy(y), k=3,
                      dilation=2)


def test_dispatch_rejects_other_devices():
    x = torch.empty(1, 4, 2, device="meta")
    with pytest.raises(ValueError, match="not supported"):
        ops.digc_topk(x, x, k=1)


# The shape sweep of tests/test_mrconv_kernel.py, plus a batched case
# with ids outside [0, M) (they contribute nothing).
@pytest.mark.parametrize("n,m,d,k", [
    (8, 128, 8, 1), (64, 256, 32, 4), (100, 300, 48, 9),
    (196, 196, 192, 16), (33, 513, 7, 5),
])
def test_mrconv_bitwise_jax(n, m, d, k):
    rng = np.random.default_rng(n + m)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.standard_normal((m, d)).astype(np.float32)
    idx = rng.integers(0, m, (n, k)).astype(np.int32)
    ref = jops.mrconv(jnp.asarray(x), jnp.asarray(y), jnp.asarray(idx),
                      block_n=32, block_m=128, interpret=True)
    out = ops.mrconv(torch.from_numpy(x), torch.from_numpy(y),
                     torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_mrconv_out_of_range_ids_bitwise_jax():
    # M = 128 is a whole co-node block, so the JAX wrapper pads nothing
    # and its kernel sees the same [0, M) range as the port.
    b, n, m, d, k = 2, 40, 128, 12, 6
    x = testing.features(1, b, n, d)
    y = testing.features(2, b, m, d)
    idx = testing.neighbour_ids(3, b, n, k, m)
    idx[:, ::3, 0] = -1
    idx[:, ::4, -1] = m + 2
    idx[:, 5, :] = -7  # a row with no neighbour in range: -1e30
    ref = jops.mrconv(jnp.asarray(x), jnp.asarray(y), jnp.asarray(idx),
                      block_n=8, block_m=128, interpret=True)
    out = ops.mrconv(torch.from_numpy(x), torch.from_numpy(y),
                     torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert (out[:, 5] == -1e30).all()


@pytest.mark.parametrize("m", [50, 600])
def test_mrconv_ids_in_jax_pad_rows_match(m):
    """The JAX wrapper pads M to its co-node block (128 for M = 50, 1024
    for M = 600): an id in [M, M_pad) gathers a zero pad row and
    contributes -x; an id at or beyond M_pad contributes nothing. The
    port gives the same, bit for bit."""
    x = testing.features(7, 1, 4, 3)
    y = testing.features(8, 1, m, 3)
    m_pad = 128 if m == 50 else 1024
    idx = np.array([[[0, m + 2], [1, 1], [2, m_pad - 1], [3, m_pad]]], np.int32)
    ref = np.asarray(jops.mrconv(jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(idx), interpret=True))
    out = ops.mrconv(torch.from_numpy(x), torch.from_numpy(y),
                     torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(out, ref)
    own = y[0, [0, 1, 2, 3]] - x[0]
    np.testing.assert_array_equal(out[0, [1, 3]], own[[1, 3]])
    np.testing.assert_array_equal(out[0, [0, 2]],
                                  np.maximum(own[[0, 2]], -x[0, [0, 2]]))


def test_mrconv_returns_x_dtype_like_jax():
    x = testing.features(4, 48, 24)
    y = testing.features(5, 160, 24)
    idx = testing.neighbour_ids(6, 1, 48, 4, 160)[0]
    ref = jops.mrconv(jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16),
                      jnp.asarray(idx), block_n=16, block_m=128, interpret=True)
    out = ops.mrconv(torch.from_numpy(x).bfloat16(),
                     torch.from_numpy(y).bfloat16(), torch.from_numpy(idx))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref, np.float32))
