"""The port's ViG model (``repro_torch.models``) against the JAX package,
on the same numpy weights and images.

Tolerances: the pieces below reorder fp32 sums (means, variances, matrix
products) relative to XLA, so they agree to 1e-5/1e-6; the logits of a
whole forward, where those differences compound over every block, agree
within 1e-4; per-layer neighbour lists agree except at near-ties
(distances rtol 1e-5, atol 1e-4). Stage plans and workload counts are
integer geometry and must be equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.digc import digc_reference as jax_digc_reference  # noqa: E402
from repro.models import vig as jvig  # noqa: E402
from repro.models.module import init_params as jax_init_params  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import convert, vig  # noqa: E402

FWD_ATOL = 1e-4


def _jax_params(cfg, seed=0):
    params = jax_init_params(jvig.vig_param_spec(cfg), jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params)


def _tiny(name, **kw):
    return (jvig.VIG_VARIANTS[name].replace(**kw),
            vig.VIG_VARIANTS[name].replace(**kw))


def test_converter_round_trip_and_shape_checks():
    jcfg, cfg = _tiny("vig_ti_pyr", image_size=32, embed_dims=(8, 16, 24, 32),
                      depths=(1, 2, 1, 1), num_classes=5)
    tree = _jax_params(jcfg)
    params = convert.params_from_numpy(cfg, tree, device="cpu")
    back = convert.params_to_numpy(params)
    flat_a, flat_b = convert.flatten(tree), convert.flatten(back)
    assert flat_a.keys() == flat_b.keys()
    for path in flat_a:
        np.testing.assert_array_equal(flat_a[path], flat_b[path])
    del tree["stage1"]["block1"]
    with pytest.raises(ValueError, match="missing.*stage1/block1/fc1"):
        convert.params_from_numpy(cfg, tree, device="cpu")
    tree = _jax_params(jcfg)
    tree["head"] = tree["head"].T
    with pytest.raises(ValueError, match="head: shape"):
        convert.params_from_numpy(cfg, tree, device="cpu")


def test_seeded_init_follows_jax_initializers():
    _, cfg = _tiny("vig_ti_iso", image_size=32, embed_dims=(64,), depths=(1,))
    a = convert.init_params(cfg, generator=torch.Generator().manual_seed(3),
                            device="cpu")
    b = convert.init_params(cfg, generator=torch.Generator().manual_seed(3),
                            device="cpu")
    flat = convert.flatten(a)
    spec = convert.flatten(convert.vig_param_spec(cfg))
    assert flat.keys() == spec.keys()
    for path, t in flat.items():
        assert tuple(t.shape) == spec[path].shape
        assert torch.equal(t, convert.flatten(b)[path])
    assert torch.equal(flat["stage0/block0/ln_g/scale"], torch.ones(64))
    # fan-in normal: sd 1/sqrt(fan_in); pos: sd 0.02
    assert abs(float(flat["stage0/block0/fc1"].std()) - 64 ** -0.5) < 0.01
    assert abs(float(flat["pos"].std()) - 0.02) < 0.003


def test_forward_pieces_match_jax():
    x = testing.features(1, 2, 64, 12)
    scale = testing.features(2, 12)
    np.testing.assert_allclose(
        vig._ln(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jvig._ln(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-5, atol=1e-5)
    imgs = testing.images(3, 2, 16)
    np.testing.assert_array_equal(
        vig.patchify(torch.from_numpy(imgs), 4).numpy(),
        np.asarray(jvig.patchify(jnp.asarray(imgs), 4)))
    np.testing.assert_allclose(
        vig._pool_conodes(torch.from_numpy(x), 8, 4).numpy(),
        np.asarray(jvig._pool_conodes(jnp.asarray(x), 8, 4)),
        rtol=1e-6, atol=1e-6)
    assert vig._pool_conodes(torch.from_numpy(x), 8, 1) is None
    w = testing.features(4, 48, 7)
    np.testing.assert_allclose(
        vig._downsample(torch.from_numpy(x), 8, torch.from_numpy(w)).numpy(),
        np.asarray(jvig._downsample(jnp.asarray(x), 8, jnp.asarray(w))),
        rtol=1e-5, atol=1e-5)
    with pytest.raises(vig.VigGridError):
        vig._downsample(torch.from_numpy(x[:, :49]), 7, torch.from_numpy(w))


def _plan_tuple(p):
    return (p.index, p.depth, p.grid, p.r, p.m, p.n, p.key, p.spec.k,
            p.spec.impl, p.dilations, p.k_effs)


@pytest.mark.parametrize("name", sorted(jvig.VIG_VARIANTS))
def test_stage_plans_and_work_match_jax(name):
    jcfg, cfg = jvig.VIG_VARIANTS[name], vig.VIG_VARIANTS[name]
    assert cfg == vig.VigConfig(**{
        f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    # native, tiny (k and dilation clamps at small M) and off-native grids
    for grid in (None, 2, 4, 8, 28, 32):
        try:
            want = jvig.vig_stage_plans(jcfg, grid=grid)
        except jvig.VigGridError as e:
            with pytest.raises(vig.VigGridError) as got:
                vig.vig_stage_plans(cfg, grid=grid)
            assert str(got.value) == str(e)
            continue
        got = vig.vig_stage_plans(cfg, grid=grid)
        assert [_plan_tuple(p) for p in got] == [_plan_tuple(p) for p in want]
        assert (vig.count_digc_work(cfg, grid=grid)
                == jvig.count_digc_work(jcfg, grid=grid))


@pytest.mark.parametrize("dilation", [3, 5])
def test_grapher_block_clamps_k_and_dilation_at_tiny_m(dilation):
    """grapher_block's own k_eff / dilation clamp (on top of the plans'):
    M = 4 co-nodes with k = 9 give k_eff 1, keeping dilation 3 and
    dropping dilation 5 to 1."""
    jcfg, cfg = _tiny("vig_ti_iso", image_size=8, patch=4, embed_dims=(8,),
                      depths=(1,), num_classes=3)
    tree = _jax_params(jcfg)
    params = convert.params_from_numpy(cfg, tree, device="cpu")
    x = testing.features(5, 2, 4, 8)
    bp = params["stage0"]["block0"]
    out, state = vig.grapher_block(bp, torch.from_numpy(x), cfg, 2, 1,
                                   dilation,
                                   digc_spec=vig.resolve_digc_spec(cfg, "cuda"))
    assert state is None
    ref, _ = jvig.grapher_block(tree["stage0"]["block0"], jnp.asarray(x), jcfg,
                                2, 1, dilation,
                                digc_spec=jvig.resolve_digc_spec(jcfg, "reference"))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_forward_rejects_bad_grids_like_jax():
    _, cfg = _tiny("vig_ti_pyr", image_size=64, embed_dims=(8, 16, 24, 32),
                   depths=(1, 1, 1, 1), num_classes=5)
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device="cpu")
    with pytest.raises(vig.VigGridError, match="square"):
        vig.vig_forward(params, torch.zeros(1, 64, 32, 3), cfg, digc_impl="cuda")
    with pytest.raises(vig.VigGridError, match="divisible by patch"):
        vig.vig_forward(params, torch.zeros(1, 62, 62, 3), cfg, digc_impl="cuda")
    # 40 / 4 = grid 10: stage 0's reduce ratio 4 does not divide it.
    with pytest.raises(vig.VigGridError, match="reduce ratio"):
        vig.vig_forward(params, torch.zeros(1, 40, 40, 3), cfg, digc_impl="cuda")
    # The config's default tier (blocked) runs, at the native grid and off
    # it (32 / 4 = grid 8: every stage divides); only the grid is checked.
    assert vig.vig_forward(params, torch.zeros(1, 64, 64, 3), cfg).shape == (1, 5)
    assert vig.vig_forward(params, torch.zeros(1, 32, 32, 3), cfg).shape == (1, 5)


# (variant, overrides): vig_ti_iso at image 96 with k 4 and depth 6, so
# blocks 4-5 run dilation 2; a narrow vig_ti_pyr at image 64, so every
# stage pools or clamps (stage 3 has M = 4 < k = 9).
FORWARD_CASES = [
    ("vig_ti_iso", dict(image_size=96, embed_dims=(32,), depths=(6,), k=4,
                        num_classes=10)),
    ("vig_ti_pyr", dict(image_size=64, embed_dims=(8, 16, 24, 32),
                        depths=(1, 1, 1, 1), num_classes=10)),
]


@pytest.mark.parametrize("name,kw", FORWARD_CASES, ids=[c[0] for c in FORWARD_CASES])
def test_vig_forward_matches_jax_pallas(name, kw):
    jcfg, cfg = _tiny(name, **kw)
    tree = _jax_params(jcfg)
    imgs = testing.images(1, 2, cfg.image_size)
    jcap = []
    ref = jvig.vig_forward(tree, jnp.asarray(imgs), jcfg, digc_impl="pallas",
                           digc_capture=jcap)
    model = vig.Vig(cfg, convert.params_from_numpy(cfg, tree, device="cpu"),
                    device="cpu")
    cap = []
    out = model(torch.from_numpy(imgs), digc_capture=cap)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=FWD_ATOL)
    plans = vig.vig_stage_plans(cfg, "cuda")
    geo = [(p.key, d, k) for p in plans
           for d, k in zip(p.dilations, p.k_effs)]
    assert len(cap) == len(jcap) == len(geo)
    for (key, h, cond), (jkey, jh, jcond), (pkey, dil, k_eff) in zip(cap, jcap, geo):
        assert key == jkey == pkey
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-4,
                                   atol=1e-4)
        y, jy = (h, jh) if cond is None else (cond, jcond)
        dil = dil if k_eff * dil <= y.shape[1] else 1
        idx, dist = ops.digc_topk(h, y, k=k_eff, dilation=dil,
                                  return_dists=True)
        ref_i, ref_d = jax_digc_reference(jh, jy, k=k_eff, dilation=dil,
                                          return_dists=True)
        testing.assert_topk_match(idx.numpy(), dist.numpy(), np.asarray(ref_i),
                                  np.asarray(ref_d), rtol=1e-5, atol=1e-4)
