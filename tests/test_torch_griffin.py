"""The port's RG-LRU block (``repro_torch/models/griffin.py``) against the
JAX package's (``repro/models/griffin.py``) on the same inputs and
weights, at the ``recurrentgemma-9b`` SMOKE widths.

Tolerances: fp32 rtol 2e-3, atol 2e-4, JAX's own for the LM (the port's
log-depth scan sums in another order than ``lax.associative_scan``). bf16,
ROADMAP queue 3, item 13: a piece within rtol = atol = 2e-2, the whole
block within 2% of the reference's RMS in RMS error (item 13's rule for
logits).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import griffin as jgr  # noqa: E402
from repro.models.module import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import griffin  # noqa: E402

TOL = {"float32": dict(rtol=2e-3, atol=2e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = ("float32", "bfloat16")


def _cfgs(dtype="float32", **kw):
    return (jax_smoke("recurrentgemma-9b").replace(dtype=dtype, **kw),
            get_smoke("recurrentgemma-9b").replace(dtype=dtype, **kw))


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
    """JAX's init of the block with the zero-initialised biases redrawn:
    (JAX tree, torch tree)."""
    tree = jax.tree.map(np.asarray, jax_init_params(jgr.rglru_spec(cfg),
                                                    jax.random.PRNGKey(seed)))
    for i, name in enumerate(sorted(tree)):
        if not tree[name].any():
            tree[name] = _rand(seed + i, *tree[name].shape, scale=0.3)
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


def test_spec_matches_jax():
    jcfg, cfg = _cfgs()
    assert griffin._lru_width(cfg) == jgr._lru_width(jcfg)
    want, got = jgr.rglru_spec(jcfg), griffin.rglru_spec(cfg)
    assert got.keys() == want.keys()
    for name, sp in got.items():
        assert (sp.shape, sp.init, sp.scale) == (want[name].shape,
                                                 want[name].init,
                                                 want[name].scale), name


@pytest.mark.parametrize("seq", [1, 3, 8])
def test_causal_conv_matches_jax(seq):
    """No activation after the bias (the SSM's conv has silu)."""
    x, w, b = _rand(1, 2, seq, 16), _rand(2, 4, 16), _rand(3, 16)
    got = griffin._causal_conv(*map(torch.from_numpy, (x, w, b)))
    want = jgr._causal_conv(*map(jnp.asarray, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gates_match_jax_in_fp32(dtype):
    """``a`` and ``beta`` come out fp32 from an input in the compute dtype,
    with the gate weights read in fp32."""
    jcfg, cfg = _cfgs(dtype)
    jp, tp = _weights(jcfg, 4)
    u = _rand(5, 2, 6, griffin._lru_width(cfg), scale=2.0)
    a, beta = griffin._gates(tp, torch.from_numpy(u).to(cfg.compute_dtype), cfg)
    ja, jbeta = jgr._gates(jp, jnp.asarray(u).astype(jcfg.compute_dtype), jcfg,
                           jcfg.compute_dtype)
    assert a.dtype == beta.dtype == torch.float32
    assert bool(((a > 0) & (a < 1)).all())
    _close(a, ja)
    _close(beta, jbeta)


@pytest.mark.parametrize("seq", [1, 2, 5, 16, 33])
def test_linear_scan_equals_the_sequential_recurrence(seq):
    """The log-depth scan against h_t = a_t h_{t-1} + beta_t step by step
    and against JAX's ``lax.associative_scan`` with the same combine."""
    rng = np.random.default_rng(seq)
    a = rng.uniform(0.5, 1.0, (2, seq, 8)).astype(np.float32)
    beta = rng.standard_normal((2, seq, 8)).astype(np.float32)
    got = griffin._linear_scan(torch.from_numpy(a), torch.from_numpy(beta))
    h, want = np.zeros((2, 8), np.float32), []
    for t in range(seq):
        h = a[:, t] * h + beta[:, t]
        want.append(h)
    _close(got, np.stack(want, 1))
    _, jh = jax.lax.associative_scan(
        lambda l, r: (l[0] * r[0], l[1] * r[0] + r[1]),
        (jnp.asarray(a), jnp.asarray(beta)), axis=1)
    _close(got, jh)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seq", [2, 9])
def test_rglru_apply_prefill_matches_jax(seq, dtype):
    """Output and final state: ``h`` the last step's, the conv tail ``ub``,
    both fp32 (zero-padded when S < K - 1)."""
    jcfg, cfg = _cfgs(dtype)
    jp, tp = _weights(jcfg, 6)
    x = _rand(7, 2, seq, cfg.d_model)
    out, st = griffin.rglru_apply(tp, torch.from_numpy(x).to(cfg.compute_dtype), cfg)
    jout, jst = jgr.rglru_apply(jp, jnp.asarray(x).astype(jcfg.compute_dtype), jcfg)
    assert out.dtype == cfg.compute_dtype
    assert st.keys() == jst.keys()
    assert st["h"].dtype == st["conv"].dtype == torch.float32
    _close_block(out, jout, dtype)
    for name in st:
        assert tuple(st[name].shape) == jst[name].shape
        _close_block(st[name], jst[name], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_apply_decode_matches_jax(dtype):
    """Three one-token steps from a nonzero fp32 state."""
    jcfg, cfg = _cfgs(dtype)
    jp, tp = _weights(jcfg, 8)
    w, k = griffin._lru_width(cfg), cfg.hybrid.d_conv
    h0, c0 = _rand(9, 2, w, scale=0.5), _rand(10, 2, k - 1, w)
    st = {"h": torch.from_numpy(h0), "conv": torch.from_numpy(c0)}
    jst = {"h": jnp.asarray(h0), "conv": jnp.asarray(c0)}
    for t in range(3):
        x = _rand(11 + t, 2, 1, cfg.d_model)
        out, st = griffin.rglru_apply(
            tp, torch.from_numpy(x).to(cfg.compute_dtype), cfg, state=st)
        jout, jst = jgr.rglru_apply(
            jp, jnp.asarray(x).astype(jcfg.compute_dtype), jcfg, state=jst)
        assert st["h"].dtype == st["conv"].dtype == torch.float32
        _close_block(out, jout, dtype)
        for name in st:
            _close_block(st[name], jst[name], dtype)


def test_prefill_state_then_decode_matches_longer_prefill():
    """fp32: prefill of S - 1 tokens, then one decode step from its state,
    equals the prefill of all S at the last position."""
    jcfg, cfg = _cfgs()
    _, tp = _weights(jcfg, 12)
    x = torch.from_numpy(_rand(13, 2, 8, cfg.d_model))
    full, fst = griffin.rglru_apply(tp, x, cfg)
    _, st = griffin.rglru_apply(tp, x[:, :-1], cfg)
    last, st = griffin.rglru_apply(tp, x[:, -1:], cfg, state=st)
    torch.testing.assert_close(last, full[:, -1:], **TOL["float32"])
    for name in st:
        torch.testing.assert_close(st[name], fst[name], **TOL["float32"])


def test_rglru_init_state_matches_jax():
    jcfg, cfg = _cfgs()
    got = griffin.rglru_init_state(cfg, 3, device="cpu")
    want = jgr.rglru_init_state(jcfg, 3)
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape and t.dtype == torch.float32
        assert not t.any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            griffin.rglru_init_state(cfg, 1)
