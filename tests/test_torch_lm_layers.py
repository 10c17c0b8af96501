"""The port's LM layers (``repro_torch/models/layers.py``) against the JAX
package's (``repro/models/layers.py``) on the same inputs and weights.

Tolerances: fp32 rtol = atol = 1e-5 (both sides run the same fp32
operations; sums in other orders differ in the last bits). bf16 rtol =
atol = 2e-2, about five bf16 ulps at 1: XLA fuses bf16 elementwise chains
and rounds once where torch rounds after each operation.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.module import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = ("float32", "bfloat16")


def _cfgs(arch, **kw):
    return jax_smoke(arch).replace(**kw), get_smoke(arch).replace(**kw)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)


def _j(a, cfg):
    return jnp.asarray(a).astype(cfg.compute_dtype)


def _t(a, cfg):
    return torch.from_numpy(np.ascontiguousarray(a)).to(cfg.compute_dtype)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def _weights(spec_tree, seed):
    """The JAX init of ``spec_tree`` with every zero-initialised leaf (the
    biases) redrawn, so that bias paths are exercised: (JAX tree, torch
    tree) holding the same fp32 values."""
    tree = jax.tree.map(np.asarray, jax_init_params(spec_tree,
                                                    jax.random.PRNGKey(seed)))
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    leaves = [a if a.any() else _rand(seed + i, *a.shape, scale=0.1)
              for i, a in enumerate(leaves)]
    tree = jax.tree_util.tree_unflatten(treedef, leaves)
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_norms_match_jax(norm, dtype):
    jcfg, cfg = _cfgs("olmo-1b", norm=norm, dtype=dtype)
    jp, tp = _weights(jl.norm_spec(jcfg), 1)
    jp = jax.tree.map(lambda a: a + 0.5, jp)  # scales off 1
    tp = {k: v + 0.5 for k, v in tp.items()}
    x = _rand(2, 2, 5, 64, scale=3.0) + 1.0
    got = tl.norm_apply(tp, _t(x, cfg), cfg)
    assert got.dtype == cfg.compute_dtype
    _close(got, jl.norm_apply(jp, _j(x, jcfg), jcfg), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sections", [None, (2, 3, 3)])
def test_rope_and_mrope_match_jax(sections, dtype):
    dh, theta = 16, 1e6
    pos = np.random.default_rng(3).integers(0, 300, (3, 2, 7)).astype(np.int32)
    p = pos if sections else pos[0]
    ang_t = tl.rope_angles(torch.from_numpy(p), dh, theta, sections)
    ang_j = jl.rope_angles(jnp.asarray(p), dh, theta, sections)
    np.testing.assert_allclose(ang_t.numpy(), np.asarray(ang_j), rtol=1e-6)
    jcfg, cfg = _cfgs("olmo-1b", dtype=dtype)
    x = _rand(4, 2, 7, 3, dh)
    got = tl.apply_rope(_t(x, cfg), ang_t)
    _close(got, jl.apply_rope(_j(x, jcfg), ang_j), dtype)


def test_mrope_rejects_bad_positions_and_sections():
    with pytest.raises(ValueError, match=r"\(3, B, S\)"):
        tl.rope_angles(torch.zeros(2, 5, dtype=torch.int32), 16, 1e4, (2, 3, 3))
    with pytest.raises(ValueError, match="do not sum"):
        tl.rope_angles(torch.zeros(3, 2, 5, dtype=torch.int32), 16, 1e4, (2, 3, 2))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["qwen1.5-4b", "qwen3-32b", "qwen2-vl-72b"])
def test_qkv_with_bias_qk_norm_and_mrope_matches_jax(arch, dtype):
    jcfg, cfg = _cfgs(arch, dtype=dtype)
    jp, tp = _weights(jl.attention_spec(jcfg), 5)
    x = _rand(6, 2, 9, jcfg.d_model)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    if cfg.mrope_sections:  # distinct t / h / w position streams
        pos = np.stack([pos, pos // 3, pos % 3])
    got = tl._qkv(tp, _t(x, cfg), cfg, torch.from_numpy(np.ascontiguousarray(pos)))
    want = jl._qkv(jp, _j(x, jcfg), jcfg, jnp.asarray(pos))
    for g, w in zip(got, want):
        _close(g, w, dtype)


MHA_CASES = {
    "causal": dict(causal=True),
    "window": dict(causal=True, window=3),
    "kv_len": dict(causal=False, kv_len=7),
    "q_chunk_halves": dict(causal=True, q_chunk=8),  # 12 -> 4
    "offset": dict(causal=True, q_offset=4),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(MHA_CASES))
def test_mha_chunked_matches_jax(case, dtype):
    kw = MHA_CASES[case]
    jcfg, cfg = _cfgs("olmo-1b", dtype=dtype)
    sq, skv = 12, 16 if "q_offset" in kw else 12
    q = _rand(7, 2, sq, 8, 16)
    k = _rand(8, 2, skv, 2, 16)  # grouped: 4 query heads per kv head
    v = _rand(9, 2, skv, 2, 16)
    got = tl.mha_chunked(_t(q, cfg), _t(k, cfg), _t(v, cfg), **kw)
    want = jl.mha_chunked(_j(q, jcfg), _j(k, jcfg), _j(v, jcfg), **kw)
    _close(got, want, dtype)


def _prefilled_cache(cfg, b, t, seed):
    k = _rand(seed, b, t, cfg.num_kv_heads, cfg.dh)
    v = _rand(seed + 1, b, t, cfg.num_kv_heads, cfg.dh)
    return k, v


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pos", [5, (3, 7)], ids=["scalar", "vector"])
def test_attention_decode_matches_jax(pos, dtype):
    jcfg, cfg = _cfgs("qwen3-32b", dtype=dtype)  # GQA 8 / 2, qk-norm
    jp, tp = _weights(jl.attention_spec(jcfg), 11)
    k, v = _prefilled_cache(cfg, 2, 10, 12)
    x = _rand(13, 2, 1, jcfg.d_model)
    pv = np.broadcast_to(np.asarray(pos, np.int32), (2,)).copy()
    positions = pv.reshape(2, 1)
    jpos = jnp.int32(pos) if np.ndim(pos) == 0 else jnp.asarray(pv)
    want, jc = jl.attention_apply(jp, _j(x, jcfg), jcfg,
                                  positions=jnp.asarray(positions),
                                  cache={"k": _j(k, jcfg), "v": _j(v, jcfg)},
                                  pos=jpos)
    cache = {"k": _t(k, cfg), "v": _t(v, cfg)}
    got, tc = tl.attention_apply(tp, _t(x, cfg), cfg,
                                 positions=torch.from_numpy(positions),
                                 cache=cache, pos=torch.as_tensor(pos))
    assert tc is cache  # written in place
    _close(got, want, dtype)
    for name in ("k", "v"):
        _close(tc[name], jc[name], dtype)


def test_attention_decode_writes_only_the_named_rows():
    _, cfg = _cfgs("olmo-1b", dtype="float32")
    _, tp = _weights(jl.attention_spec(_cfgs("olmo-1b")[0]), 14)
    k, v = _prefilled_cache(cfg, 3, 8, 15)
    cache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    x = torch.from_numpy(_rand(16, 3, 1, cfg.d_model))
    pos = torch.tensor([2, 5, 6])
    tl.attention_apply(tp, x, cfg, positions=pos[:, None], cache=cache, pos=pos,
                       rows=torch.tensor([1]))
    for name, ref in (("k", k), ("v", v)):
        got = cache[name].numpy()
        np.testing.assert_array_equal(got[[0, 2]], ref[[0, 2]])
        changed = np.nonzero((got[1] != ref[1]).any((1, 2)))[0]
        assert changed.tolist() == [5]


@pytest.mark.parametrize("dtype", DTYPES)
def test_local_rolling_buffer_past_the_window_matches_jax(dtype):
    jcfg, cfg = _cfgs("olmo-1b", attention="local", window=4, dtype=dtype)
    jp, tp = _weights(jl.attention_spec(jcfg), 17)
    t = jcfg.window  # init_cache's rolling buffer length
    jc = {"k": jnp.zeros((2, t, 4, 16), jcfg.compute_dtype),
          "v": jnp.zeros((2, t, 4, 16), jcfg.compute_dtype)}
    tc = {"k": torch.zeros(2, t, 4, 16, dtype=cfg.compute_dtype),
          "v": torch.zeros(2, t, 4, 16, dtype=cfg.compute_dtype)}
    for step in range(11):  # the rows run 3 positions apart, past T = 4
        pv = np.asarray([step, step + 3], np.int32)
        x = _rand(100 + step, 2, 1, jcfg.d_model)
        want, jc = jl.attention_apply(jp, _j(x, jcfg), jcfg,
                                      positions=jnp.asarray(pv[:, None]),
                                      cache=jc, pos=jnp.asarray(pv))
        got, tc = tl.attention_apply(tp, _t(x, cfg), cfg,
                                     positions=torch.from_numpy(pv[:, None]),
                                     cache=tc, pos=torch.from_numpy(pv))
        _close(got, want, dtype)
    for name in ("k", "v"):
        _close(tc[name], jc[name], dtype)


def test_knn_attention_prefill_and_decode_match_jax():
    jcfg, cfg = _cfgs("qwen3-32b", attention="knn", knn_neighbors=4,
                      dtype="float32")
    jp, tp = _weights(jl.attention_spec(jcfg), 19)
    s = 10
    x = _rand(20, 2, s, jcfg.d_model)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    want, (jk, jv) = jl.knn_attention_apply(jp, jnp.asarray(x), jcfg,
                                            positions=jnp.asarray(pos))
    got, (tk, tv) = tl.knn_attention_apply(tp, torch.from_numpy(x), cfg,
                                           positions=torch.from_numpy(pos))
    _close(got, want, "float32")
    _close(tk, jk, "float32")
    # decode against a 16-slot cache holding the prompt, rows at 10 and 7
    pad = ((0, 0), (0, 6), (0, 0), (0, 0))
    kc, vc = np.pad(np.asarray(jk), pad), np.pad(np.asarray(jv), pad)
    kc[1, 7:] = 0.0
    vc[1, 7:] = 0.0
    pv = np.asarray([10, 7], np.int32)
    xd = _rand(21, 2, 1, jcfg.d_model)
    want, jc = jl.knn_attention_apply(
        jp, jnp.asarray(xd), jcfg, positions=jnp.asarray(pv[:, None]),
        cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)}, pos=jnp.asarray(pv))
    got, tc = tl.knn_attention_apply(
        tp, torch.from_numpy(xd), cfg, positions=torch.from_numpy(pv[:, None]),
        cache={"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())},
        pos=torch.from_numpy(pv))
    _close(got, want, "float32")
    _close(tc["k"], jc["k"], "float32")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_mlp_matches_jax(activation, dtype):
    jcfg, cfg = _cfgs("olmo-1b", activation=activation, dtype=dtype)
    jp, tp = _weights(jl.mlp_spec(jcfg), 23)
    x = _rand(24, 2, 5, jcfg.d_model)
    _close(tl.mlp_apply(tp, _t(x, cfg), cfg),
           jl.mlp_apply(jp, _j(x, jcfg), jcfg), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tie,softcap", [(True, 0.0), (False, 0.0), (True, 5.0)])
def test_embed_and_unembed_match_jax(tie, softcap, dtype):
    jcfg, cfg = _cfgs("olmo-1b", tie_embeddings=tie, logit_softcap=softcap,
                      dtype=dtype)
    jp, tp = _weights(jl.embed_spec(jcfg), 25)
    assert ("unembed" in tp) is not tie
    toks = np.random.default_rng(26).integers(0, cfg.vocab_size, (2, 6))
    x = tl.embed_apply(tp, torch.from_numpy(toks), cfg)
    jx = jl.embed_apply(jp, jnp.asarray(toks, jnp.int32), jcfg)
    _close(x, jx, dtype)
    h = _rand(27, 2, 6, jcfg.d_model)
    _close(tl.unembed_apply(tp, _t(h, cfg), cfg),
           jl.unembed_apply(jp, _j(h, jcfg), jcfg), dtype)
