"""The port's blocked tier (``repro_torch.core.engine`` / ``packedkey`` /
``digc_blocked``), the degradation ladder and the ViG forward through the
config's default tier, against the JAX package on the same numpy inputs.

Tolerances:
- exact merges ("select", "topk"): distances are fp32 sums taken in
  another order on each side (rtol 1e-5, atol 1e-4, values of order 2*D),
  indices equal except at near-ties within that tolerance;
- ``fuse_norms`` sums the norms inside the product and ``mxu_bf16``
  multiplies bf16-rounded operands (both sides round to nearest even, so
  the operands are equal and the products exact): the same fp32 tolerance;
- ``packed``: distances keep 32 - idx_bits bits, so two fp32 values within
  rounding of each other can truncate one quantum apart: relative
  tolerance 2**(idx_bits - 23) on top of the fp32 one;
- small-integer features make every distance exact in any order, so there
  every tier must equal JAX bit for bit, ties included;
- BIG lanes (causally excluded or masked) carry BIG and an index the
  tiers may choose differently: only their distance is compared.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import builder as jbuilder  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import packedkey as jpk  # noqa: E402
from repro.core.digc import digc as jdigc  # noqa: E402
from repro.models import vig as jvig  # noqa: E402
from repro.models.module import init_params as jax_init_params  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.core import builder, engine, packedkey as pk  # noqa: E402
from repro_torch.core.digc import BIG, digc  # noqa: E402
from repro_torch.models import convert, vig  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4
MERGES = ("select", "topk", "packed")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_lanes_match(idx, dist, ref_i, ref_d, rtol=RTOL, atol=ATOL):
    """Top-k match on the live lanes; BIG lanes must be BIG on both sides
    (distance only)."""
    idx, dist = np.asarray(idx), np.asarray(dist)
    ref_i, ref_d = np.asarray(ref_i), np.asarray(ref_d)
    live = ref_d < BIG / 2
    np.testing.assert_array_equal(dist < BIG / 2, live)
    fill = -1 - np.arange(idx.shape[-1], dtype=np.int32)  # distinct placeholders
    testing.assert_topk_match(np.where(live, idx, fill), np.where(live, dist, 0),
                              np.where(live, ref_i, fill),
                              np.where(live, ref_d, 0), rtol=rtol, atol=atol)
    np.testing.assert_array_equal(dist[~live], ref_d[~live])


# ---------------------------------------------------------------------------
# packed keys


@pytest.mark.parametrize("idx_bits", [1, 6, 11, 16, 20])
def test_packed_keys_bitwise_jax(idx_bits):
    rng = np.random.default_rng(idx_bits)
    d = np.concatenate([
        rng.standard_normal(200).astype(np.float32) * 100,
        np.array([0.0, -0.0, 1e-38, -1e-38, 1e30, -1e30, 3.0e38, 7.5, -7.5],
                 np.float32),
    ])
    idx = rng.integers(0, 1 << idx_bits, d.shape).astype(np.int32)
    keys = pk.pack_keys(_t(d), _t(idx), idx_bits)
    ref = np.asarray(jpk.pack_keys(jnp.asarray(d), jnp.asarray(idx), idx_bits))
    np.testing.assert_array_equal(keys.numpy(), ref)
    # The unpacked truncated distances and indices, the sentinel included.
    keys = np.concatenate([ref, np.array([jpk.INT_BIG], np.int32)])
    dist, ids = pk.unpack_keys(_t(keys), idx_bits)
    ref_d, ref_i = jpk.unpack_keys(jnp.asarray(keys), idx_bits)
    np.testing.assert_array_equal(dist.numpy().view(np.int32),
                                  np.asarray(ref_d).view(np.int32))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_i))
    # Integer order is the (truncated distance, index) order.
    order = np.lexsort((ids.numpy()[:-1], dist.numpy()[:-1]))
    assert (np.diff(keys[:-1][order]) > 0).all()


def test_packed_constants_and_networks_match_jax():
    assert (pk.INT_BIG, pk.MAX_IDX_BITS, pk.IDX_FILL) == (
        jpk.INT_BIG, jpk.MAX_IDX_BITS, jpk.IDX_FILL)
    for m in (1, 2, 3, 196, 1024, 1025, 1 << 20):
        assert pk.idx_bits_for(m) == jpk.idx_bits_for(m)
    for v in (0, 1, 2, 9, 27, 32, 33, 144):
        assert pk.next_pow2(v) == jpk.next_pow2(v)
    with pytest.raises(ValueError, match="at most"):
        pk.idx_bits_for((1 << 20) + 1)
    rng = np.random.default_rng(5)
    keys = rng.permutation(1 << 12)[:2 * 3 * 40].reshape(2, 3, 40).astype(np.int32)
    for k_pad in (8, 64):
        np.testing.assert_array_equal(
            pk.topk_keys(_t(keys), k_pad).numpy(),
            np.asarray(jax.jit(jpk.topk_keys, static_argnums=1)(
                jnp.asarray(keys), k_pad)))
    a = np.sort(keys[..., :16], -1)
    b = np.sort(keys[..., 16:32], -1)
    np.testing.assert_array_equal(
        pk.merge_sorted(_t(a), _t(b)).numpy(),
        np.asarray(jax.jit(jpk.merge_sorted)(jnp.asarray(a), jnp.asarray(b))))


# ---------------------------------------------------------------------------
# stream_topk against the JAX engine

# case -> stream_topk keywords beyond the tiling. (B, N, M, D, kd) = (2,
# 37, 45, 12, 7) with block_m 16: three co-node tiles, the last ragged.
ENGINE_CASES = ["plain", "fuse_norms", "mxu_bf16", "causal", "pos_bias",
                "m_valid", "block_n"]


def _engine_inputs(case, x, y):
    b, n, m = x.shape[0], x.shape[1], y.shape[1]
    kw = {"block_m": 16}
    if case == "fuse_norms":
        kw["fuse_norms"] = True
    elif case == "mxu_bf16":
        kw["mxu_bf16"] = True
    elif case == "causal":
        kw.update(causal=True, block_n=8)
    elif case == "pos_bias":
        kw["pos_bias"] = testing.features(9, b, n, m)
    elif case == "m_valid":
        mv = np.ones((b, m), bool)
        mv[0, 30:] = False
        mv[1, ::3] = False
        kw["m_valid"] = mv
    elif case == "block_n":
        kw["block_n"] = 10
    return kw


def _run_both(x, y, kd, merge, kw):
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tkw = {k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    pos_j, pos_t = jkw.pop("pos_bias", None), tkw.pop("pos_bias", None)
    ref_d, ref_i = jengine.stream_topk(jnp.asarray(x), jnp.asarray(y), pos_j,
                                       kd=kd, merge=merge, **jkw)
    dist, idx = engine.stream_topk(_t(x), _t(y), pos_t, kd=kd, merge=merge,
                                   **tkw)
    assert dist.dtype == torch.float32 and idx.dtype == torch.int32
    return idx, dist, np.asarray(ref_i), np.asarray(ref_d)


@pytest.mark.parametrize("case", ENGINE_CASES)
@pytest.mark.parametrize("merge", MERGES)
def test_stream_topk_matches_jax(merge, case):
    b, n, m, d, kd = 2, 37, 45, 12, 7
    x = testing.features(1, b, n, d)
    y = testing.features(2, b, m, d)
    kw = _engine_inputs(case, x, y)
    idx, dist, ref_i, ref_d = _run_both(x, y, kd, merge, kw)
    rtol = RTOL
    if merge == "packed":
        rtol += 2.0 ** (pk.idx_bits_for(48) - 23)  # m_pad = 48
    assert_lanes_match(idx, dist, ref_i, ref_d, rtol=rtol)


@pytest.mark.parametrize("case", ["plain", "fuse_norms", "mxu_bf16", "causal",
                                  "block_n"])
@pytest.mark.parametrize("merge", MERGES)
def test_stream_topk_integer_features_bitwise_jax(merge, case):
    """Exact distances with duplicated co-nodes: every tier equals JAX bit
    for bit, the lowest index winning each tie."""
    x, y = testing.tied_inputs(3, 2, 30, 40, 6)
    kw = _engine_inputs(case, x, y)
    idx, dist, ref_i, ref_d = _run_both(x, y, 9, merge, kw)
    live = ref_d < BIG / 2
    np.testing.assert_array_equal(dist.numpy(), ref_d)
    np.testing.assert_array_equal(np.where(live, idx.numpy(), -1),
                                  np.where(live, ref_i, -1))


def test_engine_pieces_match_jax():
    rng = np.random.default_rng(0)
    d = (rng.standard_normal((2, 5, 40)) * 10).astype(np.float32)
    d[:, :, 7] = d[:, :, 3]  # a tie: the lower column first
    vals, cols = engine.select_topkd(_t(d), 9)
    ref_v, ref_c = jengine.select_topkd(jnp.asarray(d), 9)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(ref_c))
    run_d, run_i = np.sort(d[..., :20], -1)[..., :9], np.tile(
        np.arange(9, dtype=np.int32), (2, 5, 1))
    blk_i = np.tile(np.arange(20, 40, dtype=np.int32), (2, 5, 1))
    got = engine.merge_topk_xla(_t(run_d), _t(run_i), _t(d[..., 20:]),
                                _t(blk_i), 9)
    want = jengine.merge_topk_xla(jnp.asarray(run_d), jnp.asarray(run_i),
                                  jnp.asarray(d[..., 20:]), jnp.asarray(blk_i), 9)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    keys = np.asarray(jpk.pack_keys(jnp.asarray(d), jnp.asarray(
        np.broadcast_to(np.arange(40, dtype=np.int32), d.shape)), 6))
    run_k = np.sort(keys[..., :20], -1)[..., :9]
    np.testing.assert_array_equal(
        engine.merge_packed_xla(_t(run_k), _t(keys[..., 20:]), 9).numpy(),
        np.asarray(jax.jit(jengine.merge_packed_xla, static_argnums=2)(
            jnp.asarray(run_k), jnp.asarray(keys[..., 20:]), 9)))


def test_stream_topk_self_graph_sq_y_and_errors():
    x = testing.features(4, 2, 33, 8)
    sq = (x.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    for kw in ({}, {"sq_y": sq}):
        ref_d, ref_i = jengine.stream_topk(
            jnp.asarray(x), None, kd=5, block_m=8,
            **{k: jnp.asarray(v) for k, v in kw.items()})
        dist, idx = engine.stream_topk(_t(x), None, kd=5, block_m=8,
                                       **{k: _t(v) for k, v in kw.items()})
        testing.assert_topk_match(idx.numpy(), dist.numpy(), np.asarray(ref_i),
                                  np.asarray(ref_d), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="unknown merge"):
        engine.stream_topk(_t(x), kd=3, merge="heap")
    with pytest.raises(ValueError, match="group_w"):
        engine.stream_topk(_t(x), kd=3, group_w=65)
    with pytest.raises(ValueError, match="exceeds"):
        engine.stream_topk(_t(x), kd=34)
    with pytest.raises(ValueError, match="m_valid has"):
        engine.stream_topk(_t(x), kd=3, m_valid=torch.ones(5, dtype=torch.bool))


# ---------------------------------------------------------------------------
# the blocked tier through digc()


@pytest.mark.parametrize("knobs", [
    {}, {"merge": "topk", "block_n": 16}, {"merge": "packed", "block_m": 64},
    {"fuse_norms": True, "group_w": 48}, {"mxu_bf16": True, "block_m": 32},
])
def test_blocked_tier_matches_jax(knobs):
    x = testing.features(7, 3, 50, 16)
    y = testing.features(8, 3, 100, 16)
    pb = testing.features(9, 50, 100)
    for yy, p, causal in ((None, None, False), (y, pb, False), (y, None, True)):
        jargs = dict(k=4, dilation=3, impl="blocked", causal=causal,
                     return_dists=True, **knobs)
        ref_i, ref_d = jdigc(jnp.asarray(x), None if yy is None else jnp.asarray(yy),
                             pos_bias=None if p is None else jnp.asarray(p), **jargs)
        idx, dist = digc(_t(x), None if yy is None else _t(yy),
                         pos_bias=None if p is None else _t(p), **jargs)
        assert idx.shape == (3, 50, 4)
        rtol = RTOL + (2.0 ** (pk.idx_bits_for(128) - 23)
                       if knobs.get("merge") == "packed" else 0.0)
        assert_lanes_match(idx, dist, ref_i, ref_d, rtol=rtol)
    # unbatched in, unbatched out
    idx = digc(_t(x[0]), k=4, **knobs)
    assert idx.shape == (50, 4)


def test_blocked_tier_pad_masks_match_jax():
    x = testing.features(10, 2, 40, 8)
    mv = np.ones((2, 40), bool)
    mv[:, 31:] = False
    ref_i, ref_d = jdigc(jnp.asarray(x), k=6, impl="blocked", return_dists=True,
                         m_valid=jnp.asarray(mv), block_m=16)
    idx, dist = digc(_t(x), k=6, impl="blocked", return_dists=True,
                     m_valid=_t(mv), block_m=16)
    assert_lanes_match(idx, dist, ref_i, ref_d)
    assert (idx.numpy() < 31).all()


def test_blocked_tier_reuse_and_state_not_ported():
    """Named for the stub it once pinned; the blocked tier now takes
    ``state_entry=`` and the reuse knobs. A reuse spec without a state
    builds exactly as JAX's; with an entry the build returns a bumped
    copy and leaves the input entry as it was."""
    from repro.core.state import state_entry as jstate_entry
    from repro_torch.core.state import state_entry

    x = testing.features(3, 2, 8, 4)
    y = testing.features(4, 2, 12, 4)
    got = digc(torch.from_numpy(x), k=2, impl="blocked", reuse="layer")
    want = jdigc(jnp.asarray(x), k=2, impl="blocked", reuse="layer")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    blocked = builder.get_builder("blocked")
    assert blocked.supports_state == jbuilder.get_builder("blocked").supports_state
    entry = state_entry(sq_y_shape=(2, 12), rows=2, device="cpu")
    idx, dist, new = blocked.build(torch.from_numpy(x), torch.from_numpy(y),
                                   None, builder.DigcSpec(k=2),
                                   state_entry=entry)
    jidx, jdist, jnew = jbuilder.get_builder("blocked").build(
        jnp.asarray(x), jnp.asarray(y), None, jbuilder.DigcSpec(k=2),
        state_entry=jstate_entry(sq_y_shape=(2, 12), rows=2))
    testing.assert_topk_match(idx.numpy(), dist.numpy(), np.asarray(jidx),
                              np.asarray(jdist), rtol=RTOL, atol=ATOL)
    assert (int(new.step), new.row_step.tolist()) == (1, [1, 1])
    assert int(entry.step) == 0 and not entry.sq_y.any()  # input untouched
    np.testing.assert_allclose(new.sq_y.numpy(), np.asarray(jnew.sq_y),
                               rtol=1e-6)


def test_registry_and_degradation_ladder_match_jax():
    """The ladder's rungs are the JAX package's with the fused kernel
    named after its language (pallas there, cuda here)."""
    rename = {"pallas": "cuda"}
    assert builder.DEGRADATION_LADDER == tuple(
        rename.get(n, n) for n in jbuilder.DEGRADATION_LADDER)
    for impl in ("pallas", "blocked", "reference", "cluster", "ring"):
        assert builder.fallback_chain(rename.get(impl, impl)) == tuple(
            rename.get(n, n) for n in jbuilder.fallback_chain(impl))
    spec = builder.DigcSpec(impl="cuda", k=9, dilation=2, causal=True,
                            packed=True, mxu_bf16=True)
    jspec = jbuilder.DigcSpec(impl="pallas", k=9, dilation=2, causal=True,
                              packed=True, mxu_bf16=True, reuse="layer")
    got, want = builder.degraded_spec(spec, "blocked"), jbuilder.degraded_spec(
        jspec, "blocked")
    assert (got.impl, got.k, got.dilation, got.causal, got.knobs()) == (
        want.impl, want.k, want.dilation, want.causal, {})
    names = [b.name for b in builder.list_builders()]
    assert names == ["axial", "blocked", "cluster", "cuda", "reference", "ring"]
    jblocked = jbuilder.get_builder("blocked")
    blocked = builder.get_builder("blocked")
    assert blocked.knobs == jblocked.knobs
    assert (blocked.supports_pos_bias, blocked.supports_causal,
            blocked.supports_pad) == (True, True, True)


# ---------------------------------------------------------------------------
# the ViG forward through the config's default tier

FORWARD_CASES = [
    ("vig_ti_iso", dict(image_size=96, embed_dims=(32,), depths=(6,), k=4,
                        num_classes=10)),
    ("vig_ti_pyr", dict(image_size=64, embed_dims=(8, 16, 24, 32),
                        depths=(1, 1, 1, 1), num_classes=10)),
]


@pytest.mark.parametrize("name,kw", FORWARD_CASES, ids=[c[0] for c in FORWARD_CASES])
def test_vig_forward_default_blocked_tier_matches_jax(name, kw):
    jcfg = jvig.VIG_VARIANTS[name].replace(**kw)
    cfg = vig.VIG_VARIANTS[name].replace(**kw)
    assert cfg.digc_impl == jcfg.digc_impl == "blocked"
    tree = jax.tree.map(np.asarray, jax_init_params(jvig.vig_param_spec(jcfg),
                                                    jax.random.PRNGKey(4)))
    imgs = testing.images(5, 2, cfg.image_size)
    ref = jax.jit(lambda t, i: jvig.vig_forward(t, i, jcfg))(tree,
                                                            jnp.asarray(imgs))
    params = convert.params_from_numpy(cfg, tree, device="cpu")
    out = vig.vig_forward(params, _t(imgs), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
