"""The DIGC kernel's variants (packed keys, bf16 operands, positional bias,
causal masking), the ``cuda`` builder's knobs, KNN attention and the ViG
forward through the packed bf16 kernel, on the CPU (the kernels' plain
versions) against the JAX package (its Pallas kernel in interpret mode).

Tolerances:
- fp32 distances are sums taken in another order on each side: rtol 1e-5,
  atol 1e-4 (values of order 2*D), indices equal except at near-ties;
- ``mxu_bf16``: both sides round x and y to bf16 to nearest even and take
  norms and products from the rounded values (bf16 products are exact in
  fp32): the same fp32 tolerance;
- ``packed``: distances keep 32 - idx_bits bits (idx_bits of the true M),
  so values within fp32 rounding can truncate one quantum apart: relative
  tolerance 2**(idx_bits - 23) on top of the fp32 one;
- small-integer features (and an integer bias) make every distance exact,
  so there the variants equal JAX bit for bit, ties included;
- BIG lanes (causally excluded) carry exactly BIG (its truncation when
  packed) and an index the two kernels may choose differently when
  tiles are skipped: only their distance is compared with JAX;
- KNN attention outputs are softmax-weighted sums of the same gathered
  values: rtol 1e-5, atol 1e-6; ViG logits within 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import knn_attention as jknn  # noqa: E402
from repro.core.digc import digc as jdigc  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import vig as jvig  # noqa: E402
from repro.models.module import init_params as jax_init_params  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.core import DigcSpec, knn_attention as knn  # noqa: E402
from repro_torch.core.digc import BIG, digc  # noqa: E402
from repro_torch.core.packedkey import idx_bits_for  # noqa: E402
from repro_torch.kernels import launch_counts, ops, reset_launch_counts  # noqa: E402
from repro_torch.kernels.digc_topk import digc_topk_plain  # noqa: E402
from repro_torch.models import convert, vig  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4

# name -> ops.digc_topk variant keywords ("pos_bias": per image; "shared":
# one (N, M) bias for the batch).
VARIANTS = {
    "packed": dict(packed=True),
    "mxu_bf16": dict(mxu_bf16=True),
    "packed_bf16": dict(packed=True, mxu_bf16=True),
    "pos_bias": dict(pos_bias="image"),
    "shared_pos_bias": dict(pos_bias="shared"),
    "causal": dict(causal=True),
    "causal_pos_bias": dict(causal=True, pos_bias="image"),
    "causal_packed_bf16": dict(causal=True, packed=True, mxu_bf16=True),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bias(kind, b, n, m, integer=False):
    shape = (n, m) if kind == "shared" else (b, n, m)
    if integer:
        return np.random.default_rng(n).integers(-3, 4, shape).astype(np.float32)
    return testing.features(n * m, *shape)


def _both(x, y, k, dil, kw):
    """(port idx, dist), (JAX idx, dist) through ops.digc_topk; JAX's tiles
    are small (8 x 128) so causal tile skipping is exercised."""
    jkw = dict(kw)
    tkw = dict(kw)
    if "pos_bias" in kw:
        jkw["pos_bias"] = jnp.asarray(kw["pos_bias"])
        tkw["pos_bias"] = _t(kw["pos_bias"])
    ref_i, ref_d = jops.digc_topk(jnp.asarray(x), jnp.asarray(y), k=k,
                                  dilation=dil, return_dists=True,
                                  interpret=True, block_n=8, block_m=128, **jkw)
    reset_launch_counts()
    idx, dist = ops.digc_topk(_t(x), _t(y), k=k, dilation=dil,
                              return_dists=True, **tkw)
    assert sum(launch_counts().values()) == 0  # CPU tensors: plain versions
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32
    return (idx.numpy(), dist.numpy()), (np.asarray(ref_i), np.asarray(ref_d))


def _split_big(got, ref):
    """Live-lane masks after checking that BIG lanes agree in distance."""
    (idx, dist), (ref_i, ref_d) = got, ref
    live = ref_d < BIG / 2
    np.testing.assert_array_equal(dist < BIG / 2, live)
    np.testing.assert_array_equal(dist[~live], ref_d[~live])
    return live


def _kw(name, b, n, m, integer=False):
    kw = dict(VARIANTS[name])
    if "pos_bias" in kw:
        kw["pos_bias"] = _bias(kw["pos_bias"], b, n, m, integer)
    return kw


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_plain_matches_jax_pallas(name):
    b, n, m, d, k, dil = 2, 40, 150, 20, 6, 2
    x = testing.features(1, b, n, d)
    y = testing.features(2, b, m, d)
    kw = _kw(name, b, n, m)
    got, ref = _both(x, y, k, dil, kw)
    live = _split_big(got, ref)
    rtol = RTOL + (2.0 ** (idx_bits_for(m) - 23) if kw.get("packed") else 0)
    fill = -1 - np.arange(k, dtype=np.int32)
    testing.assert_topk_match(np.where(live, got[0], fill),
                              np.where(live, got[1], 0),
                              np.where(live, ref[0], fill),
                              np.where(live, ref[1], 0), rtol=rtol, atol=ATOL)
    if kw.get("causal"):
        assert live[:, 0].sum(-1).tolist() == [1, 1]  # row 0 sees column 0
        assert ((got[0] >= 0) & (got[0] < m)).all()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_integer_features_bitwise_jax(name):
    """Exact distances with duplicated co-nodes: bit equality, the lowest
    index winning every tie."""
    b, n, m = 2, 24, 64
    x, y = testing.tied_inputs(7, b, n, m, 6)
    kw = _kw(name, b, n, m, integer=True)
    got, ref = _both(x, y, 9, 2, kw)
    live = _split_big(got, ref)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(np.where(live, got[0], -1),
                                  np.where(live, ref[0], -1))


def test_causal_plain_big_lanes_are_the_stable_sort():
    """Causal BIG lanes hold exactly BIG (the truncation of BIG when
    packed) and the lowest excluded columns, in order."""
    x = testing.features(3, 1, 20, 4)
    dist, idx = digc_topk_plain(_t(x), _t(x), 8, causal=True)
    for row in range(7):
        np.testing.assert_array_equal(idx[0, row, row + 1:].numpy(),
                                      np.arange(row + 1, 8))
        assert (dist[0, row, row + 1:] == BIG).all()
    dist, idx = digc_topk_plain(_t(x), _t(x), 8, causal=True, packed=True)
    assert (dist[0, 0, 1:] < BIG).all() and (dist[0, 0, 1:] > BIG / 2).all()
    np.testing.assert_array_equal(idx[0, 0].numpy(), np.arange(8))


def test_shared_pos_bias_equals_per_image():
    b, n, m = 3, 12, 30
    x = _t(testing.features(4, b, n, 8))
    y = _t(testing.features(5, b, m, 8))
    p = _t(testing.features(6, n, m))
    shared = ops.digc_topk(x, y, k=5, pos_bias=p, return_dists=True)
    tiled = ops.digc_topk(x, y, k=5, pos_bias=p.expand(b, n, m).contiguous(),
                          return_dists=True)
    for a, c in zip(shared, tiled):
        assert torch.equal(a, c)


def test_cuda_builder_variant_knobs_match_jax_pallas():
    b, n, d = 2, 36, 12
    x = testing.features(8, b, n, d)
    pb = testing.features(9, n, n)
    knobs = dict(packed=True, mxu_bf16=True)
    ref_i, ref_d = jdigc(jnp.asarray(x), k=5, dilation=2, impl="pallas",
                         causal=True, pos_bias=jnp.asarray(pb),
                         return_dists=True, interpret=True, **knobs)
    idx, dist = digc(_t(x), k=5, dilation=2, impl="cuda", causal=True,
                     pos_bias=_t(pb), return_dists=True,
                     kernel_merge="bitonic", **knobs)
    got, ref = (idx.numpy(), dist.numpy()), (np.asarray(ref_i), np.asarray(ref_d))
    live = _split_big(got, ref)
    testing.assert_topk_match(
        np.where(live, got[0], -1 - np.arange(5)), np.where(live, got[1], 0),
        np.where(live, ref[0], -1 - np.arange(5)), np.where(live, ref[1], 0),
        rtol=RTOL + 2.0 ** (idx_bits_for(n) - 23), atol=ATOL)


def test_cuda_builder_legacy_merge_not_ported():
    x = torch.zeros(1, 8, 4)
    with pytest.raises(NotImplementedError, match="queue 2"):
        digc(x, k=2, impl="cuda", kernel_merge="legacy")
    with pytest.raises(NotImplementedError, match="queue 2"):
        digc(x, k=2, impl="cuda", packed=True, bucket_rounds=2)
    with pytest.raises(ValueError, match="unknown kernel_merge"):
        digc(x, k=2, impl="cuda", kernel_merge="heap")
    with pytest.raises(ValueError, match="u16"):
        digc_topk_plain(torch.zeros(1, 2, 2), torch.zeros(1, 65537, 2), 2,
                        packed=True)


# ---------------------------------------------------------------------------
# KNN attention

KNN_IMPLS = [("reference", "reference"), ("blocked", "blocked"),
             ("cuda", "pallas")]


@pytest.mark.parametrize("impl,jimpl", KNN_IMPLS, ids=[i for i, _ in KNN_IMPLS])
def test_knn_attention_matches_jax(impl, jimpl):
    s, dh = 48, 16
    q, k, v = (testing.features(i, s, dh) for i in (1, 2, 3))
    for causal in (True, False):
        ref = jknn.knn_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 num_neighbors=8, causal=causal, impl=jimpl)
        out = knn.knn_attention(_t(q), _t(k), _t(v), num_neighbors=8,
                                causal=causal, impl=impl)
        assert out.shape == (s, dh) and torch.isfinite(out).all()
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("impl,jimpl", KNN_IMPLS, ids=[i for i, _ in KNN_IMPLS])
def test_knn_attention_mha_matches_jax(impl, jimpl):
    s, h, dh = 40, 3, 8
    q, k, v = (testing.features(i, s, h, dh) for i in (4, 5, 6))
    ref = jknn.knn_attention_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 num_neighbors=6, impl=jimpl)
    out = knn.knn_attention_mha(_t(q), _t(k), _t(v), num_neighbors=6, impl=impl)
    assert out.shape == (s, h, dh)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("cache_len", [1, 25, 40])
def test_knn_attention_decode_matches_jax(cache_len):
    t, h, dh = 40, 3, 8
    q = testing.features(7, h, dh)
    kc, vc = testing.features(8, t, h, dh), testing.features(9, t, h, dh)
    kc[10:20] = kc[:10]  # exact distance ties: the lowest index wins
    ref = jknn.knn_attention_decode(jnp.asarray(q), jnp.asarray(kc),
                                    jnp.asarray(vc), jnp.asarray(cache_len),
                                    num_neighbors=8)
    out = knn.knn_attention_decode(_t(q), _t(kc), _t(vc), cache_len,
                                   num_neighbors=8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the ViG forward through the packed bf16 kernel


def test_vig_forward_packed_bf16_kernel_matches_jax_pallas():
    kw = dict(image_size=96, embed_dims=(32,), depths=(6,), k=4,
              num_classes=10)
    jcfg = jvig.VIG_VARIANTS["vig_ti_iso"].replace(**kw)
    cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(**kw)
    tree = jax.tree.map(np.asarray, jax_init_params(jvig.vig_param_spec(jcfg),
                                                    jax.random.PRNGKey(6)))
    imgs = testing.images(8, 2, cfg.image_size)
    jspec = jvig.DigcSpec(impl="pallas", packed=True, mxu_bf16=True,
                          interpret=True)
    ref = jvig.vig_forward(tree, jnp.asarray(imgs), jcfg, digc_impl=jspec)
    spec = DigcSpec(impl="cuda", packed=True, mxu_bf16=True)
    params = convert.params_from_numpy(cfg, tree, device="cpu")
    out = vig.vig_forward(params, _t(imgs), cfg, digc_impl=spec)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
