"""The port's decoder LM (``repro_torch/models/transformer.py``, the configs,
the param specs and the converter) against the JAX package on the SMOKE
configs of the seven ported archs (dense, VLM and MoE with or without
MLA), with JAX's init converted through numpy.

Tolerances: fp32 logits rtol 2e-3, atol 2e-4, JAX's own for decode
against forward (``tests/test_archs.py``); MoE metrics within 1e-6; bf16
logits within 2% of the logits' RMS in RMS error (per-op rounding differs
from XLA's fused bf16 chains: a few bf16 ulps a layer), after checking
that every MoE layer selected the same experts on both sides (a routing
flip at a near-tie changes an expert, not a rounding). Ports of
``tests/test_archs.py`` and ``tests/test_model_invariants.py`` keep their
tolerances.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.module import init_params as jax_init_params  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.api import get_api  # noqa: E402
from repro_torch.models import convert, module  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

MOE = ["deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"]
PORTED = ["olmo-1b", "qwen1.5-4b", "qwen3-32b", "granite-34b", "qwen2-vl-72b",
          *MOE]
UNPORTED = {"mamba2-370m": "7c", "recurrentgemma-9b": "7d", "whisper-tiny": "7e"}
# Leaves the compute tree holds in fp32 (transformer._FP32_KEYS).
FP32_LEAVES = ("q_norm", "k_norm", "kv_norm", "router")
RTOL, ATOL = 2e-3, 2e-4
B, S = 2, 12


def _setup(arch, dtype="float32", **kw):
    jcfg = jconfigs.get_smoke(arch).replace(dtype=dtype, **kw)
    cfg = configs.get_smoke(arch).replace(dtype=dtype, **kw)
    jp = jax_init_params(jtr.param_spec(jcfg), jax.random.PRNGKey(0))
    p = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    return jcfg, cfg, jp, p


def _tokens(cfg, seed, b=B, s=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (b, s)).astype(np.int32)


def _positions(cfg, b=B, s=S):
    """M-RoPE archs get distinct t / h / w streams; None elsewhere."""
    if not cfg.mrope_sections:
        return None, None
    p = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    p = np.ascontiguousarray(np.stack([p, p // 4, p % 4]))
    return jnp.asarray(p), torch.from_numpy(p)


def _f32(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else a,
                      np.float32)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_configs_equal_jax_field_for_field(arch):
    for get in ("get_config", "get_smoke"):
        mine = getattr(configs, get)(arch)
        theirs = getattr(jconfigs, get)(arch)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs), (arch, get)
        assert (mine.dh, mine.sub_quadratic) == (theirs.dh, theirs.sub_quadratic)
        assert mine.compute_dtype == (torch.bfloat16 if theirs.dtype == "bfloat16"
                                      else torch.float32)
        for shape in configs.SHAPES:
            assert (configs.cell_supported(mine, shape)
                    == jconfigs.cell_supported(theirs, shape))
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert configs.SHAPES == jconfigs.SHAPES


@pytest.mark.parametrize("arch", PORTED)
def test_forward_matches_jax(arch):
    jcfg, cfg, jp, p = _setup(arch)
    toks = _tokens(cfg, 0)
    jpos, tpos = _positions(cfg)
    want, jmetrics = jtr.forward(jp, jnp.asarray(toks), jcfg, positions=jpos)
    got, metrics = tr.forward(p, torch.from_numpy(toks), cfg, positions=tpos)
    assert got.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(_f32(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert metrics.keys() == jmetrics.keys() == {"moe_aux", "moe_drop_frac"}
    for name, value in metrics.items():
        assert value.shape == () and value.dtype == torch.float32
        assert abs(float(value) - float(jmetrics[name])) <= 1e-6, name
    assert (float(metrics["moe_aux"]) > 0) == (arch in MOE)


def _recorded_routes(monkeypatch, mod, run):
    """``run()`` with ``mod._router`` recording each MoE layer's selected
    experts (numpy, in call order)."""
    routes, real = [], mod._router

    def record(*args):
        out = real(*args)
        routes.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(mod, "_router", record)
    result = run()
    monkeypatch.setattr(mod, "_router", real)
    return result, routes


@pytest.mark.parametrize("arch", PORTED)
def test_bf16_forward_and_compute_params_match_jax(arch, monkeypatch):
    # JAX unrolled (scan_layers=False: the same operations) so that its
    # routing is recorded as arrays, not traced
    jcfg, cfg, jp, p = _setup(arch, dtype="bfloat16", scan_layers=False)
    toks = _tokens(cfg, 1)
    jpos, tpos = _positions(cfg)
    (want, _), jroutes = _recorded_routes(monkeypatch, jmoe, lambda: jtr.forward(
        jp, jnp.asarray(toks), jcfg, positions=jpos))
    want = np.asarray(want, np.float32)
    (got, _), routes = _recorded_routes(monkeypatch, moe, lambda: tr.forward(
        p, torch.from_numpy(toks), cfg, positions=tpos))
    assert len(routes) == len(jroutes) == (cfg.num_layers if cfg.moe else 0)
    for layer, (r, jr) in enumerate(zip(routes, jroutes)):
        np.testing.assert_array_equal(r, jr, err_msg=f"layer {layer} routing")
    rms = float(np.sqrt(np.mean(want ** 2)))
    assert float(np.sqrt(np.mean((_f32(got) - want) ** 2))) < 0.02 * rms
    # a compute-dtype copy gives the per-use casts' values bit for bit
    cp = tr.compute_params(p, cfg)
    for path, t in module.leaves(cp).items():
        fp32 = (path[0] == "final_norm" or path[1] in ("ln1", "ln2")
                or path[-1] in FP32_LEAVES)
        assert t.dtype == (torch.float32 if fp32 else torch.bfloat16), path
    again, _ = tr.forward(cp, torch.from_numpy(toks), cfg, positions=tpos)
    assert torch.equal(again, got)


@pytest.mark.parametrize("arch", PORTED)
def test_decode_sequence_matches_jax_and_own_forward(arch):
    jcfg, cfg, jp, p = _setup(arch)
    toks = _tokens(cfg, 2)
    jc = jtr.init_cache(jcfg, B, S)
    tc = tr.init_cache(cfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        want, jc = jtr.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                   jnp.int32(t), jcfg)
        before = {k: v.clone() for k, v in tc.items()}
        got, new = tr.decode_step(p, tc, torch.from_numpy(toks[:, t:t + 1]), t, cfg)
        assert all(torch.equal(tc[k], before[k]) for k in tc)  # functional
        tc = new
        np.testing.assert_allclose(_f32(got), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
        outs.append(got[:, 0])
    assert tc.keys() == jc.keys()
    for name in tc:
        np.testing.assert_allclose(_f32(tc[name]), np.asarray(jc[name]),
                                   rtol=RTOL, atol=ATOL)
    full, _ = tr.forward(p, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(_f32(torch.stack(outs, 1)), _f32(full),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_then_decode_matches_forward(arch):
    """Port of ``tests/test_archs.py::test_prefill_then_decode_matches_forward``
    on every ported arch, with JAX's cache beside it."""
    jcfg, cfg, jp, p = _setup(arch)
    toks = _tokens(cfg, 3)
    full, _ = tr.forward(p, torch.from_numpy(toks), cfg)
    logits_p, cache = tr.prefill(p, torch.from_numpy(toks[:, :-1]), cfg, max_len=S)
    np.testing.assert_allclose(_f32(logits_p), _f32(full[:, :-1]), rtol=RTOL,
                               atol=ATOL)
    _, jcache = jtr.prefill(jp, jnp.asarray(toks[:, :-1]), jcfg, max_len=S)
    assert cache.keys() == jcache.keys()
    for name in cache:
        assert cache[name].shape == jcache[name].shape
        np.testing.assert_allclose(_f32(cache[name]), np.asarray(jcache[name]),
                                   rtol=RTOL, atol=ATOL)
    lg, _ = tr.decode_step(p, cache, torch.from_numpy(toks[:, -1:]), S - 1, cfg)
    np.testing.assert_allclose(_f32(lg[:, 0]), _f32(full[:, -1]), rtol=RTOL,
                               atol=ATOL)


def test_vector_positions_decode_matches_jax():
    """A mixed-length slot batch: rows at different positions in one call."""
    _vector_positions_decode("qwen2-vl-72b")


def test_vector_positions_decode_matches_jax_mla():
    """The same through MLA's latent cache."""
    _vector_positions_decode("deepseek-v2-lite-16b")


def _vector_positions_decode(arch):
    jcfg, cfg, jp, p = _setup(arch)
    toks = _tokens(cfg, 4)
    jc = jtr.init_cache(jcfg, B, S)
    tc = tr.init_cache(cfg, B, S, device="cpu")
    for t in range(S - 3):
        pv = np.asarray([t, t + 3], np.int32)
        tok = toks[:, t:t + 1]
        want, jc = jtr.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pv), jcfg)
        got, tc = tr.decode_step(p, tc, torch.from_numpy(tok), torch.from_numpy(pv),
                                 cfg)
        np.testing.assert_allclose(_f32(got), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    for name in tc:
        np.testing.assert_allclose(_f32(tc[name]), np.asarray(jc[name]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("attention,kw", [("knn", dict(knn_neighbors=4)),
                                          ("local", dict(window=4))])
def test_sparse_and_local_attention_olmo_match_jax(attention, kw):
    """kNN with fewer neighbours than positions (sparse from position 4 on)
    and the local rolling buffer: forward, prefill + decode and a decode
    sequence against JAX."""
    jcfg, cfg, jp, p = _setup("olmo-1b", attention=attention, **kw)
    toks = _tokens(cfg, 5)
    want, _ = jtr.forward(jp, jnp.asarray(toks), jcfg)
    got, _ = tr.forward(p, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(_f32(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    split = 8  # the local window divides it: JAX's prefill keeps slot = pos % T
    jl, jc = jtr.prefill(jp, jnp.asarray(toks[:, :split]), jcfg, max_len=S)
    tl, tc = tr.prefill(p, torch.from_numpy(toks[:, :split]), cfg, max_len=S)
    np.testing.assert_allclose(_f32(tl), np.asarray(jl), rtol=RTOL, atol=ATOL)
    for t in range(split, S):
        want, jc = jtr.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                   jnp.int32(t), jcfg)
        got, tc = tr.decode_step(p, tc, torch.from_numpy(toks[:, t:t + 1]), t, cfg)
        np.testing.assert_allclose(_f32(got), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("arch", PORTED)
def test_causality(arch):
    """Port of ``tests/test_model_invariants.py::test_causality``."""
    _, cfg, _, p = _setup(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    t_cut = S // 2
    toks2 = toks.copy()
    toks2[:, t_cut + 1:] = rng.integers(0, cfg.vocab_size, (B, S - t_cut - 1))
    l1, _ = tr.forward(p, torch.from_numpy(toks), cfg)
    l2, _ = tr.forward(p, torch.from_numpy(toks2), cfg)
    np.testing.assert_allclose(_f32(l1[:, :t_cut + 1]), _f32(l2[:, :t_cut + 1]),
                               rtol=1e-5, atol=1e-5)


def test_determinism():
    """Port of ``tests/test_model_invariants.py::test_determinism`` (olmo,
    bf16)."""
    _, cfg, _, p = _setup("olmo-1b", dtype="bfloat16")
    toks = torch.from_numpy(_tokens(cfg, 1))
    l1, _ = tr.forward(p, toks, cfg)
    l2, _ = tr.forward(p, toks, cfg)
    assert torch.equal(l1, l2)


@pytest.mark.parametrize("arch", ["qwen3-32b", "granite-34b", *MOE])
def test_batch_independence(arch):
    """Port of ``tests/test_model_invariants.py::test_batch_independence``."""
    _, cfg, _, p = _setup(arch)
    rng = np.random.default_rng(2)
    a = rng.integers(0, cfg.vocab_size, (2, S))
    b = a.copy()
    b[1] = rng.integers(0, cfg.vocab_size, S)
    la, _ = tr.forward(p, torch.from_numpy(a), cfg)
    lb, _ = tr.forward(p, torch.from_numpy(b), cfg)
    np.testing.assert_allclose(_f32(la[0]), _f32(lb[0]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", sorted(UNPORTED))
def test_unported_families_raise_naming_their_item(arch):
    cfg = configs.get_smoke(arch)
    item = f"ROADMAP queue 1, item {UNPORTED[arch]}"
    calls = [lambda: tr.param_spec(cfg), lambda: get_api(cfg),
             lambda: tr.init_cache(cfg, 1, 4, device="cpu"),
             lambda: tr.forward({}, torch.zeros(1, 4, dtype=torch.int32), cfg),
             lambda: tr.decode_step({}, {}, torch.zeros(1, 1, dtype=torch.int32),
                                    0, cfg)]
    for call in calls:
        with pytest.raises(NotImplementedError, match=item):
            call()


def test_init_params_kinds_scales_and_stacking():
    cfg = configs.get_smoke("qwen1.5-4b").replace(num_layers=3, d_model=128)
    spec = tr.param_spec(cfg)
    a = module.init_params(spec, generator=torch.Generator().manual_seed(7),
                           device="cpu")
    b = module.init_params(spec, generator=torch.Generator().manual_seed(7),
                           device="cpu")
    specs, got = module.leaves(spec), module.leaves(a)
    assert specs.keys() == got.keys()
    for path, t in got.items():
        assert tuple(t.shape) == specs[path].shape and t.dtype == torch.float32
        assert torch.equal(t, module.leaves(b)[path])
    layers = a["layers"]
    assert layers["mix"]["wq"].shape == (3, 128, 4, 16)
    assert torch.equal(layers["ln1"]["scale"], torch.ones(3, 128))
    assert torch.equal(layers["mix"]["bq"], torch.zeros(3, 4, 16))
    # the embedding: sd 0.02; stacked fan-in: JAX takes shape[0], the layers
    assert abs(float(a["embed"]["tokens"].std()) - 0.02) < 0.002
    assert abs(float(layers["mlp"]["wi_up"].std()) - 3 ** -0.5) < 0.01
    assert abs(float(a["embed"]["unembed"].std()) - 128 ** -0.5) < 0.005
    olmo = tr.param_spec(configs.get_smoke("olmo-1b"))
    assert olmo["layers"]["ln1"] == {} and "unembed" not in olmo["embed"]
    with pytest.raises(ValueError, match="unknown init"):
        module.init_leaf(module.spec((2,), init="uniform"), torch.Generator())


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-vl-72b", *MOE])
def test_converter_round_trip_and_shape_checks(arch):
    jcfg, cfg, jp, p = _setup(arch)
    tree = jax.tree.map(np.asarray, jp)
    back = convert.lm_params_to_numpy(p)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat_a) == len(module.leaves(back))
    for path, a in flat_a:
        keys = tuple(k.key for k in path)
        np.testing.assert_array_equal(module.leaves(back)[keys], a)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    assert p["layers"]["mix"]["wq"].dtype == torch.float32
    bad = jax.tree.map(np.asarray, jp)
    del bad["layers"]["mix"]["wq"]
    with pytest.raises(ValueError, match="missing.*layers/mix/wq"):
        convert.lm_params_from_numpy(cfg, bad, device="cpu")
    bad = jax.tree.map(np.asarray, jp)
    bad["embed"]["tokens"] = bad["embed"]["tokens"].T
    with pytest.raises(ValueError, match="embed/tokens: shape"):
        convert.lm_params_from_numpy(cfg, bad, device="cpu")


@pytest.mark.parametrize("arch", ["qwen3-32b", "deepseek-v2-lite-16b"])
def test_init_params_in_compute_dtypes(arch, monkeypatch):
    """``init_params(dtype_of=)`` draws each leaf straight into the compute
    tree's dtype, a slice of its leading axis at a time when narrower than
    its fp32 draw: the compute tree's dtypes and the spec's shapes, the
    init's scales, and ``compute_params`` of it copies no leaf. Without
    ``dtype_of`` the draw is the fp32 one, unchanged."""
    cfg = configs.get_smoke(arch)
    spec = tr.param_spec(cfg)
    monkeypatch.setattr(module, "_DRAW_ELEMS", 64 * 64)  # many slices a leaf

    def draw(**kw):
        return module.init_params(spec, generator=torch.Generator().manual_seed(3),
                                  device="cpu", **kw)

    p = draw(dtype_of=lambda path: tr.compute_dtype(path, cfg))
    specs = module.leaves(spec)
    for path, t in module.leaves(p).items():
        fp32 = (path[0] == "final_norm" or path[1] in ("ln1", "ln2")
                or path[-1] in FP32_LEAVES)
        assert t.dtype == (torch.float32 if fp32 else torch.bfloat16), path
        assert tuple(t.shape) == specs[path].shape, path
    assert torch.equal(p["final_norm"]["scale"], torch.ones(cfg.d_model))
    assert abs(float(p["embed"]["tokens"].float().std()) - 0.02) < 0.002
    w = p["layers"]["mlp"]["w_up" if cfg.moe else "wi_up"].float()
    assert abs(float(w.std()) - cfg.num_layers ** -0.5) < 0.02
    assert not torch.equal(w[0], w[1])  # each slice its own draw
    cp = tr.compute_params(p, cfg)
    assert all(cp_t is t for cp_t, t in zip(module.leaves(cp).values(),
                                            module.leaves(p).values()))
    gen, fp32 = torch.Generator().manual_seed(3), module.leaves(draw())
    for path in sorted(specs):  # each leaf whole, in fp32, in path order
        s = specs[path]
        assert fp32[path].dtype == torch.float32
        if s.init not in ("zeros", "ones"):
            want = torch.randn(s.shape, generator=gen) * module._leaf_sd(s)
            assert torch.equal(fp32[path], want), path
