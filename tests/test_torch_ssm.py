"""The port's Mamba-2 SSD layer (``repro_torch/models/ssm.py``) against the
JAX package's (``repro/models/ssm.py``) on the same inputs and weights, at
the ``mamba2-370m`` SMOKE widths.

Tolerances: fp32 rtol 2e-3, atol 2e-4, JAX's own for the LM (the chunked
einsums contract in other orders). bf16, ROADMAP queue 3, item 13 (XLA
fuses bf16 chains where torch rounds after each operation): a piece
within rtol = atol = 2e-2; the whole block (its output and state, after
the in-projection, the rounded conv and gated norm and the
out-projection) within 2% of the reference's RMS in RMS error, item 13's
rule for logits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.module import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = {"float32": dict(rtol=2e-3, atol=2e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = ("float32", "bfloat16")


def _cfgs(dtype="float32", **kw):
    return (jax_smoke("mamba2-370m").replace(dtype=dtype, **kw),
            get_smoke("mamba2-370m").replace(dtype=dtype, **kw))


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)


def _close(got, want, dtype="float32"):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def _close_block(got, want, dtype):
    """A whole block's output or state: fp32 as ``_close``; bf16 by RMS."""
    if dtype == "float32":
        return _close(got, want)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert np.sqrt(np.mean((got - want) ** 2)) <= 0.02 * np.sqrt(np.mean(want ** 2))


def _weights(cfg, seed):
    """JAX's init of the layer with the zero and one leaves (biases,
    ``a_log``, ``dt_bias``, ``d_skip``, ``norm``) moved off their
    constants, so that every path is exercised: (JAX tree, torch tree)."""
    tree = jax.tree.map(np.asarray, jax_init_params(jssm.ssm_spec(cfg),
                                                    jax.random.PRNGKey(seed)))
    for i, name in enumerate(sorted(tree)):
        a = tree[name]
        if not a.any() or (a == 1).all():
            tree[name] = a + _rand(seed + i, *a.shape, scale=0.3)
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


def test_dims_spec_and_split_match_jax():
    jcfg, cfg = _cfgs()
    s, d_in, heads, conv_dim = ssm._dims(cfg)
    assert (d_in, heads, conv_dim) == jssm._dims(jcfg)[1:]
    want = jssm.ssm_spec(jcfg)
    got = ssm.ssm_spec(cfg)
    assert got.keys() == want.keys()
    for name, sp in got.items():
        assert (sp.shape, sp.init, sp.scale) == (want[name].shape,
                                                 want[name].init,
                                                 want[name].scale), name
    zx = _rand(1, 2, 3, got["in_proj"].shape[1])
    for a, b in zip(ssm._split(torch.from_numpy(zx), cfg),
                    jssm._split(jnp.asarray(zx), jcfg)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seq", [1, 2, 7])
def test_causal_conv_matches_jax(seq):
    """Depthwise causal conv with silu after the bias; S below, at and
    above the kernel's K - 1."""
    x, w, b = _rand(2, 2, seq, 24), _rand(3, 4, 24), _rand(4, 24)
    got = ssm._causal_conv(*map(torch.from_numpy, (x, w, b)))
    want = jssm._causal_conv(*map(jnp.asarray, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_softplus_is_jax_logaddexp_past_torch_threshold():
    """``jax.nn.softplus`` is logaddexp(x, 0) everywhere; the port's too,
    also above ``F.softplus``'s threshold of 20."""
    x = np.linspace(-40, 40, 161, dtype=np.float32)
    got = ssm._softplus(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.nn.softplus(x)),
                               rtol=1e-6, atol=1e-7)
    big = torch.tensor([20.5], dtype=torch.float64)
    assert float(ssm._softplus(big)) != float(big)  # not the identity


@pytest.mark.parametrize("dtype", DTYPES)
def test_gated_norm_matches_jax(dtype):
    jcfg, cfg = _cfgs(dtype)
    y, z, scale = _rand(5, 2, 3, 128, scale=2.0), _rand(6, 2, 3, 128), _rand(7, 128)
    got = ssm._gated_norm(torch.from_numpy(y).to(cfg.compute_dtype),
                          torch.from_numpy(z).to(cfg.compute_dtype),
                          torch.from_numpy(scale))
    assert got.dtype == cfg.compute_dtype
    want = jssm._gated_norm(jnp.asarray(y).astype(jcfg.compute_dtype),
                            jnp.asarray(z).astype(jcfg.compute_dtype),
                            jnp.asarray(scale))
    _close(got, want, dtype)


def _ssd_inputs(seed, s, h=4, p=8, n=16, dt_scale=0.5):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((2, s, h, p)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((2, s, h))) * dt_scale).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    bm = rng.standard_normal((2, s, n)).astype(np.float32)
    cm = rng.standard_normal((2, s, n)).astype(np.float32)
    return xh, dt, a, bm, cm


@pytest.mark.parametrize("seq,chunk", [(64, 16), (32, 32), (24, 16), (12, 32)],
                         ids=["4-chunks", "one-chunk", "halved-to-8",
                              "short-prompt"])
def test_ssd_chunked_matches_jax(seq, chunk):
    """S a multiple of the chunk, S shorter than it, and S that forces
    the chunk to halve until it divides S (24 with chunk 16 -> 8)."""
    args = _ssd_inputs(8, seq)
    y, h = ssm._ssd_chunked(*map(torch.from_numpy, args), chunk)
    jy, jh = jssm._ssd_chunked(*map(jnp.asarray, args), chunk)
    assert y.shape == (2, seq, 4, 8) and h.shape == (2, 4, 16, 8)
    assert h.dtype == torch.float32
    _close(y, jy)
    _close(h, jh)


def test_ssd_chunked_decays_past_fp32_overflow_stay_finite():
    """exp(cum_i - cum_j) overflows to inf above the diagonal when the
    decay is steep; the select drops it (a product with the mask would
    make nan)."""
    args = _ssd_inputs(9, 32, dt_scale=60.0)
    xh, dt, a, _, _ = args
    assert (np.cumsum(dt * a, axis=1)[:, 0] - np.cumsum(dt * a, axis=1)[:, -1]
            ).max() > 89  # exp of it is inf in fp32
    y, h = ssm._ssd_chunked(*map(torch.from_numpy, args), 32)
    jy, jh = jssm._ssd_chunked(*map(jnp.asarray, args), 32)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    _close(y, jy)
    _close(h, jh)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seq", [2, 9])
def test_ssm_apply_prefill_matches_jax(seq, dtype):
    """The block's output and final state: ``h`` fp32, the conv tail
    ``xbc_raw`` in the compute dtype (zero-padded when S < K - 1)."""
    jcfg, cfg = _cfgs(dtype)
    jp, tp = _weights(jcfg, 10)
    x = _rand(11, 2, seq, cfg.d_model)
    out, st = ssm.ssm_apply(tp, torch.from_numpy(x).to(cfg.compute_dtype), cfg)
    jout, jst = jssm.ssm_apply(jp, jnp.asarray(x).astype(jcfg.compute_dtype), jcfg)
    assert out.dtype == cfg.compute_dtype
    assert st["h"].dtype == torch.float32 and st["conv"].dtype == cfg.compute_dtype
    assert st.keys() == jst.keys()
    _close_block(out, jout, dtype)
    for name in st:
        assert tuple(st[name].shape) == jst[name].shape
        _close_block(st[name], jst[name], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_apply_decode_matches_jax(dtype):
    """Three one-token steps from a nonzero fp32 state: ``h`` stays fp32
    and the conv tail takes the previous tail's dtype."""
    jcfg, cfg = _cfgs(dtype)
    jp, tp = _weights(jcfg, 12)
    s, _, heads, conv_dim = ssm._dims(cfg)
    h0 = _rand(13, 2, heads, s.d_state, s.head_dim, scale=0.5)
    c0 = _rand(14, 2, s.d_conv - 1, conv_dim)
    st = {"h": torch.from_numpy(h0), "conv": torch.from_numpy(c0)}
    jst = {"h": jnp.asarray(h0), "conv": jnp.asarray(c0)}
    for t in range(3):
        x = _rand(15 + t, 2, 1, cfg.d_model)
        out, st = ssm.ssm_apply(tp, torch.from_numpy(x).to(cfg.compute_dtype),
                                cfg, state=st)
        jout, jst = jssm.ssm_apply(jp, jnp.asarray(x).astype(jcfg.compute_dtype),
                                   jcfg, state=jst)
        assert st["h"].dtype == st["conv"].dtype == torch.float32
        _close_block(out, jout, dtype)
        for name in st:
            _close_block(st[name], jst[name], dtype)


def test_prefill_state_then_decode_matches_longer_prefill():
    """fp32: prefill of S - 1 tokens, then one decode step from its state,
    equals the prefill of all S at the last position."""
    _, cfg = _cfgs()
    _, tp = _weights(_cfgs()[0], 16)
    x = torch.from_numpy(_rand(17, 2, 8, cfg.d_model))
    full, fst = ssm.ssm_apply(tp, x, cfg)
    _, st = ssm.ssm_apply(tp, x[:, :-1], cfg)
    last, st = ssm.ssm_apply(tp, x[:, -1:], cfg, state=st)
    torch.testing.assert_close(last, full[:, -1:], **TOL["float32"])
    torch.testing.assert_close(st["h"], fst["h"], **TOL["float32"])
    torch.testing.assert_close(st["conv"], fst["conv"], **TOL["float32"])


def test_ssm_init_state_matches_jax():
    jcfg, cfg = _cfgs()
    got = ssm.ssm_init_state(cfg, 3, device="cpu")
    want = jssm.ssm_init_state(jcfg, 3)
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape and t.dtype == torch.float32
        assert not t.any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ssm.ssm_init_state(cfg, 1)
