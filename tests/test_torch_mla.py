"""The port's Multi-head Latent Attention (``repro_torch/models/mla.py``)
against the JAX package's (``repro/models/mla.py``) at deepseek-v2-lite's
SMOKE widths (4 heads, kv_lora 32, qk 16 + 8, v 16) on the same inputs
and weights: prefill (keys and values expanded from the latent) and the
absorbed decode, at a scalar and a (B,) per-slot position.

Tolerances: fp32 rtol = atol = 1e-5 (the same fp32 operations, sums in
other orders); bf16 within 2e-2 of the compared tensor's RMS elementwise
(``tests/test_torch_lm_layers.py``'s 2e-2 at unit scale). The absorbed
decode against the expanded prefill: JAX's own 2e-3 / 2e-4
(``tests/test_archs.py::test_decode_matches_forward_fp32``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models.module import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from repro_torch.models.module import leaves  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
DTYPES = ("float32", "bfloat16")
B, T = 2, 10


def _setup(dtype, seed=0):
    """(JAX cfg, port cfg, JAX params, port params): the JAX init of one
    MLA layer with the latent norm's scale drawn off 1, through numpy."""
    jcfg = jax_smoke(ARCH).replace(dtype=dtype)
    cfg = get_smoke(ARCH).replace(dtype=dtype)
    tree = jax.tree.map(np.asarray, jax_init_params(jmla.mla_spec(jcfg),
                                                    jax.random.PRNGKey(seed)))
    tree["kv_norm"] = 1.0 + 0.5 * _rand(seed + 100, *tree["kv_norm"].shape)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree))


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _f32(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def _close(got, want, dtype):
    got, want = _f32(got), _f32(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        rms = float(np.sqrt(np.mean(want ** 2)))
        np.testing.assert_allclose(got / rms, want / rms, rtol=2e-2, atol=2e-2)


def _cast(a, cfg):
    if isinstance(cfg.compute_dtype, torch.dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cfg.compute_dtype)
    return jnp.asarray(a).astype(cfg.compute_dtype)


def test_mla_spec_equals_jax():
    jcfg, cfg, _, _ = _setup("float32")
    want = {tuple(k.key for k in path): (s.shape, s.init)
            for path, s in jax.tree_util.tree_leaves_with_path(
                jmla.mla_spec(jcfg), is_leaf=lambda x: hasattr(x, "axes"))}
    got = {path: (s.shape, s.init) for path, s in leaves(mla.mla_spec(cfg)).items()}
    assert got == want


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_matches_jax(dtype):
    jcfg, cfg, jp, tp = _setup(dtype)
    x = _rand(1, B, T, cfg.d_model)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    want, (jc, jk) = jmla.mla_apply(jp, _cast(x, jcfg), jcfg,
                                    positions=jnp.asarray(pos))
    got, (c, k) = mla.mla_apply(tp, _cast(x, cfg), cfg,
                                positions=torch.from_numpy(pos))
    assert got.dtype == cfg.compute_dtype
    assert c.shape == (B, T, cfg.mla.kv_lora) and k.shape == (B, T, cfg.mla.qk_rope_dim)
    _close(got, want, dtype)
    _close(c, jc, dtype)
    _close(k, jk, dtype)


def _cache(cfg, seed):
    return {"c_kv": _rand(seed, B, T, cfg.mla.kv_lora),
            "k_pe": _rand(seed + 1, B, T, cfg.mla.qk_rope_dim)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pos", [5, (3, 7)], ids=["scalar", "vector"])
def test_absorbed_decode_matches_jax(pos, dtype):
    jcfg, cfg, jp, tp = _setup(dtype, seed=1)
    cache = _cache(cfg, 2)
    x = _rand(3, B, 1, cfg.d_model)
    pv = np.broadcast_to(np.asarray(pos, np.int32), (B,)).copy()
    jpos = jnp.int32(pos) if np.ndim(pos) == 0 else jnp.asarray(pv)
    want, jc = jmla.mla_apply(jp, _cast(x, jcfg), jcfg,
                              positions=jnp.asarray(pv[:, None]),
                              cache={n: _cast(a, jcfg) for n, a in cache.items()},
                              pos=jpos)
    tc = {n: _cast(a, cfg) for n, a in cache.items()}
    got, out_cache = mla.mla_apply(tp, _cast(x, cfg), cfg,
                                   positions=torch.from_numpy(pv[:, None]),
                                   cache=tc, pos=torch.as_tensor(pos))
    assert out_cache is tc  # written in place
    _close(got, want, dtype)
    for name in ("c_kv", "k_pe"):
        _close(tc[name], jc[name], dtype)


def test_decode_writes_only_the_named_rows():
    _, cfg, _, tp = _setup("float32", seed=4)
    ref = _cache(cfg, 5)
    ref = {n: np.concatenate([a, a[:1]]) for n, a in ref.items()}  # 3 rows
    cache = {n: torch.from_numpy(a.copy()) for n, a in ref.items()}
    x = torch.from_numpy(_rand(6, 3, 1, cfg.d_model))
    pos = torch.tensor([2, 5, 6])
    mla.mla_apply(tp, x, cfg, positions=pos[:, None], cache=cache, pos=pos,
                  rows=torch.tensor([1]))
    for name, want in ref.items():
        got = cache[name].numpy()
        np.testing.assert_array_equal(got[[0, 2]], want[[0, 2]])
        changed = np.nonzero((got[1] != want[1]).any(-1))[0]
        assert changed.tolist() == [5]


def test_absorbed_decode_equals_expanded_prefill():
    """Token by token from an empty latent cache, rows at positions three
    apart: each step's output equals the expanded form's at that position
    (JAX's tolerance for decode against forward), and the cache equals
    the prefill's latents."""
    _, cfg, _, tp = _setup("float32", seed=7)
    x = torch.from_numpy(_rand(8, B, T, cfg.d_model))
    pos = torch.arange(T).expand(B, T)
    full, (c, k) = mla.mla_apply(tp, x, cfg, positions=pos)
    cache = {"c_kv": torch.zeros(B, T, cfg.mla.kv_lora),
             "k_pe": torch.zeros(B, T, cfg.mla.qk_rope_dim)}
    lag = 3
    for t in range(T):
        rows = [r for r, p in enumerate((t, t - lag)) if p >= 0]
        pv = torch.tensor([t, max(t - lag, 0)])
        xt = torch.stack([x[0, t], x[1, max(t - lag, 0)]])[:, None]
        out, _ = mla.mla_apply(tp, xt, cfg, positions=pv[:, None], cache=cache,
                               pos=pv, rows=torch.tensor(rows))
        for r in rows:
            np.testing.assert_allclose(out[r, 0].numpy(), full[r, int(pv[r])].numpy(),
                                       rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(cache["c_kv"][0].numpy(), c[0].numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cache["k_pe"][1, :T - lag].numpy(),
                               k[1, :T - lag].numpy(), rtol=1e-5, atol=1e-6)
