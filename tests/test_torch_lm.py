"""The port's decoder LM (``repro_torch/models/transformer.py``, the configs,
the param specs and the converter) against the JAX package on the SMOKE
configs of the nine ported archs (dense, VLM and MoE with or without MLA;
the recurrent ``mamba2-370m`` and ``recurrentgemma-9b``, the hybrid also
at 5 layers: one (rec, rec, attn) group and two ``rem`` layers), with
JAX's init converted through numpy.

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
# Families once refused with the ROADMAP item that ports them. The
# encoder-decoder (item 7e) is ported (``models/encdec.py``); the LM
# serving and training drivers refuse it with JAX's ``SystemExit``.
UNPORTED = {"whisper-tiny": "7e"}
# The recurrent families: SSM, the Griffin hybrid, and the hybrid with a
# remainder (one group and two ``rem`` layers).
RECURRENT = [("mamba2-370m", {}), ("recurrentgemma-9b", {}),
             ("recurrentgemma-9b", dict(num_layers=5))]
RECURRENT_IDS = ["mamba2", "recurrentgemma", "recurrentgemma-5l"]
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


def _flat(tree, path=()):
    """{path: tensor} of a nested tree of dicts and tuples (a tuple's
    index is the key), the port's caches."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    if isinstance(tree, tuple):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (i,)))
        return out
    return {path: tree}


def _jflat(tree):
    """{path: array} of a JAX tree, with the paths of ``_flat``."""
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): a
            for path, a in jax.tree_util.tree_leaves_with_path(tree)}


def _trees_close(got, want, exact=False):
    """Equal paths, shapes and dtypes; each leaf's values within rtol 2e-3
    and atol 2e-4 times the leaf's largest magnitude (at least 1), or
    equal when ``exact``: fp32 sums in other orders round relative to
    their operands, and a cache leaf holds keys and states of a residual
    stream that the stacked fan-in init grows (the hybrid's group weights
    have fan-in = the group count, 1 at SMOKE depth)."""
    got, want = _flat(got), _jflat(want)
    assert got.keys() == want.keys()
    for path, t in got.items():
        w = np.asarray(want[path], np.float32)
        assert tuple(t.shape) == w.shape, path
        assert str(t.dtype).split(".")[-1] == str(want[path].dtype), path
        scale = 0.0 if exact else max(1.0, float(np.abs(w).max(initial=0)))
        np.testing.assert_allclose(_f32(t), w, err_msg=str(path),
                                   rtol=0 if exact else RTOL, atol=ATOL * scale)


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
    """Since item 7e the family is ported: ``get_api`` gives the
    encoder-decoder's spec and loss, and only the drivers that cannot take
    it refuse it, with the JAX package's messages."""
    from repro.launch import serve as jserve
    from repro.launch import train as jtrain
    from repro_torch.launch import serve, train
    from repro_torch.models import encdec

    cfg = configs.get_smoke(arch)
    tr.check_ported(cfg)
    a = get_api(cfg)
    assert a.loss_fn is encdec.encdec_loss_fn
    assert "enc" in a.param_spec() and "dec_pos" in a.param_spec()
    for mine, theirs in ((serve.main, jserve.main), (train.main, jtrain.main)):
        with pytest.raises(SystemExit) as jexc:
            theirs(["--arch", arch, "--smoke"])
        with pytest.raises(SystemExit) as exc:
            mine(["--arch", arch, "--smoke", "--device", "cpu"])
        assert str(exc.value) == str(jexc.value)
    with pytest.raises(NotImplementedError, match="family 'encdec'"):
        tr.check_ported(cfg.replace(family="encdec"))


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


# ---------------------------------------------------------------------------
# The recurrent families (SSM and the Griffin hybrid)


@pytest.mark.parametrize("arch,kw", RECURRENT, ids=RECURRENT_IDS)
def test_recurrent_families_are_ported(arch, kw):
    cfg = configs.get_smoke(arch).replace(**kw)
    tr.check_ported(cfg)
    api = get_api(cfg)
    assert module.leaves(api.param_spec()).keys() == module.leaves(
        tr.param_spec(cfg)).keys()
    jcfg = jconfigs.get_smoke(arch).replace(**kw)
    want = {tuple(k.key for k in path): s.shape for path, s in
            jax.tree_util.tree_leaves_with_path(
                jtr.param_spec(jcfg), is_leaf=lambda x: hasattr(x, "axes"))}
    got = {path: s.shape for path, s in module.leaves(tr.param_spec(cfg)).items()}
    assert got == want


@pytest.mark.parametrize("arch,kw", RECURRENT, ids=RECURRENT_IDS)
def test_recurrent_forward_matches_jax(arch, kw):
    """Logits, zero MoE metrics, and ``return_cache``'s tree: the SSM's
    stacked {"h", "conv"}, the hybrid's {"groups", "rem"} with raw (k, v)
    attention tuples."""
    jcfg, cfg, jp, p = _setup(arch, **kw)
    toks = _tokens(cfg, 0)
    want, jcaches, jmetrics = jtr.forward(jp, jnp.asarray(toks), jcfg,
                                          return_cache=True)
    got, caches, metrics = tr.forward(p, torch.from_numpy(toks), cfg,
                                      return_cache=True)
    np.testing.assert_allclose(_f32(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert all(float(v) == 0.0 == float(jmetrics[k]) for k, v in metrics.items())
    _trees_close(caches, jcaches)
    if cfg.family == "hybrid":
        assert isinstance(caches["groups"]["l2_attn"], tuple)
        assert len(caches["rem"]) == kw.get("num_layers", 3) % 3


@pytest.mark.parametrize("arch,kw", RECURRENT, ids=RECURRENT_IDS)
def test_recurrent_decode_matches_jax_and_forward(arch, kw):
    """Port of ``tests/test_archs.py::test_decode_matches_forward_fp32`` for
    the recurrent archs, JAX's decode beside it: logits every step, the
    functional form leaves the whole nested cache as it was, the final
    cache equals JAX's leaf for leaf (fp32 states)."""
    jcfg, cfg, jp, p = _setup(arch, **kw)
    toks = _tokens(cfg, 1)
    jc = jtr.init_cache(jcfg, B, S)
    tc = tr.init_cache(cfg, B, S, device="cpu")
    _trees_close(tc, jc, exact=True)
    outs = []
    for t in range(S):
        want, jc = jtr.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                   jnp.int32(t), jcfg)
        before = {k: v.clone() for k, v in _flat(tc).items()}
        got, new = tr.decode_step(p, tc, torch.from_numpy(toks[:, t:t + 1]), t, cfg)
        assert all(torch.equal(v, before[k]) for k, v in _flat(tc).items())
        tc = new
        np.testing.assert_allclose(_f32(got), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
        outs.append(got[:, 0])
    _trees_close(tc, jc)
    full, _ = tr.forward(p, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(_f32(torch.stack(outs, 1)), _f32(full),
                               rtol=RTOL, atol=ATOL)


def test_ssm_prefill_then_decode_matches_forward():
    """The SSM's prefill cache is decode-ready (JAX's too): prefill S - 1
    tokens, its tree equal to JAX's (``h`` fp32, the conv tail in the
    compute dtype), then decode the last token against ``forward``; the
    recurrent layers ignore ``pos``."""
    jcfg, cfg, jp, p = _setup("mamba2-370m")
    toks = _tokens(cfg, 3)
    full, _ = tr.forward(p, torch.from_numpy(toks), cfg)
    logits_p, cache = tr.prefill(p, torch.from_numpy(toks[:, :-1]), cfg, max_len=S)
    np.testing.assert_allclose(_f32(logits_p), _f32(full[:, :-1]), rtol=RTOL,
                               atol=ATOL)
    _, jcache = jtr.prefill(jp, jnp.asarray(toks[:, :-1]), jcfg, max_len=S)
    _trees_close(cache, jcache)
    for pos in (S - 1, 0, torch.tensor([3, 9])):
        lg, _ = tr.decode_step(p, cache, torch.from_numpy(toks[:, -1:]), pos, cfg)
        np.testing.assert_allclose(_f32(lg[:, 0]), _f32(full[:, -1]), rtol=RTOL,
                                   atol=ATOL)
    bf = configs.get_smoke("mamba2-370m")
    _, c16 = tr.prefill(tr.compute_params(p, bf), torch.from_numpy(toks[:, :4]), bf)
    assert c16["h"].dtype == torch.float32 and c16["conv"].dtype == torch.bfloat16


def _fp32_path(path) -> bool:
    """The leaves the compute tree holds in fp32, as JAX uses them: the
    layer norms' scales and biases, the SSM's decay, step bias, skip and
    gated-norm scale, the RG-LRU's gates."""
    return (path[0] == "final_norm" or any(k in ("ln1", "ln2") for k in path)
            or path[-1] in FP32_LEAVES + ("a_log", "dt_bias", "d_skip", "norm",
                                          "w_input_gate", "b_input_gate",
                                          "w_rec_gate", "b_rec_gate", "lam"))


@pytest.mark.parametrize("arch,kw", RECURRENT, ids=RECURRENT_IDS)
def test_recurrent_bf16_forward_and_compute_params_match_jax(arch, kw):
    """bf16 logits against JAX's bf16 and fp32 logits; the compute tree's
    fp32 leaves; a compute-dtype copy gives the per-use casts' values bit
    for bit.

    Item 13's 2% of the logits' RMS does not hold here: the port's bf16
    logits are 4.8-5.0% of the RMS from JAX's, because the reference's own
    bf16 is far from its fp32 on these archs (8.5% of the RMS for mamba2,
    27% for the hybrid, against 3.1% for olmo). So the bound is the
    reference's own bf16 error: the port's RMS error against JAX's bf16 is
    at most JAX's bf16 against JAX's fp32, and the port's bf16 against
    JAX's fp32 at most 1.25 times that."""
    jcfg, cfg, jp, p = _setup(arch, dtype="bfloat16", **kw)
    toks = _tokens(cfg, 1)
    want = np.asarray(jtr.forward(jp, jnp.asarray(toks), jcfg)[0], np.float32)
    want32 = np.asarray(jtr.forward(jp, jnp.asarray(toks),
                                    jcfg.replace(dtype="float32"))[0])
    got, _ = tr.forward(p, torch.from_numpy(toks), cfg)

    def rms(a):
        return float(np.sqrt(np.mean(a ** 2)))

    ref_err = rms(want - want32)
    assert rms(_f32(got) - want) <= ref_err
    assert rms(_f32(got) - want32) <= 1.25 * ref_err
    cp = tr.compute_params(p, cfg)
    for path, t in module.leaves(cp).items():
        assert t.dtype == (torch.float32 if _fp32_path(path) else torch.bfloat16), path
    again, _ = tr.forward(cp, torch.from_numpy(toks), cfg)
    assert torch.equal(again, got)


def test_fp32_keys_match_by_key_and_norm_is_only_the_ssm_leaf():
    """``compute_dtype`` matches ``_FP32_KEYS`` anywhere in a path; the key
    ``norm`` is a leaf only in the SSM (the layer norms are ``ln1``, ``ln2``
    and ``final_norm``, with leaves ``scale`` and ``bias``), so no other
    leaf of any ported arch is kept fp32 by it."""
    assert {"a_log", "dt_bias", "d_skip", "norm", "w_input_gate",
            "b_input_gate", "w_rec_gate", "b_rec_gate", "lam"} <= tr._FP32_KEYS
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch)
        if arch in UNPORTED:
            continue
        for path in module.leaves(tr.param_spec(cfg)):
            if "norm" in path:
                assert path[-2:] == ("ssm", "norm"), (arch, path)
            assert (tr.compute_dtype(path, cfg) == torch.float32) == _fp32_path(path), (
                arch, path)


@pytest.mark.parametrize("arch,kw", RECURRENT, ids=RECURRENT_IDS)
def test_causality_recurrent(arch, kw):
    """Port of ``tests/test_model_invariants.py::test_causality`` for the
    recurrent archs."""
    _, cfg, _, p = _setup(arch, **kw)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    t_cut = S // 2
    toks2 = toks.copy()
    toks2[:, t_cut + 1:] = rng.integers(0, cfg.vocab_size, (B, S - t_cut - 1))
    l1, _ = tr.forward(p, torch.from_numpy(toks), cfg)
    l2, _ = tr.forward(p, torch.from_numpy(toks2), cfg)
    np.testing.assert_allclose(_f32(l1[:, :t_cut + 1]), _f32(l2[:, :t_cut + 1]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_determinism_recurrent(arch):
    """Port of ``tests/test_model_invariants.py::test_determinism`` for the
    recurrent archs (bf16, their SMOKE dtype)."""
    _, cfg, _, p = _setup(arch, dtype="bfloat16")
    toks = torch.from_numpy(_tokens(cfg, 1))
    l1, _ = tr.forward(p, toks, cfg)
    l2, _ = tr.forward(p, toks, cfg)
    assert torch.equal(l1, l2)


@pytest.mark.parametrize("arch,kw", RECURRENT, ids=RECURRENT_IDS)
def test_converter_round_trip_nested_recurrent_trees(arch, kw):
    """``lm_params_from_numpy`` / ``lm_params_to_numpy`` carry the stacked
    SSM tree and the hybrid's ``groups`` / ``rem`` trees leaf for leaf, and
    name a missing or misshapen nested leaf."""
    jcfg, cfg, jp, p = _setup(arch, **kw)
    tree = jax.tree.map(np.asarray, jp)
    back = convert.lm_params_to_numpy(p)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for path, a in jax.tree_util.tree_leaves_with_path(tree):
        np.testing.assert_array_equal(module.leaves(back)[tuple(k.key for k in path)], a)
    if cfg.family == "ssm":
        missing, where = ("layers", "ssm", "a_log"), "layers/ssm/a_log"
    else:
        missing, where = ("groups", "l0_rec", "mix", "lam"), "groups/l0_rec/mix/lam"
    bad = jax.tree.map(np.asarray, jp)
    node = bad
    for key in missing[:-1]:
        node = node[key]
    del node[missing[-1]]
    with pytest.raises(ValueError, match=f"missing.*{where}"):
        convert.lm_params_from_numpy(cfg, bad, device="cpu")
    if "rem" in tree:
        bad = jax.tree.map(np.asarray, jp)
        bad["rem"]["l1_rec"]["mix"]["conv_w"] = bad["rem"]["l1_rec"]["mix"]["conv_w"].T
        with pytest.raises(ValueError, match="rem/l1_rec/mix/conv_w: shape"):
            convert.lm_params_from_numpy(cfg, bad, device="cpu")


# ---------------------------------------------------------------------------
# A decode write past the end of the cache (ROADMAP queue 3, item 17)


@pytest.mark.parametrize("arch,kw", [
    ("olmo-1b", {}), ("olmo-1b", dict(attention="knn", knn_neighbors=3)),
    ("deepseek-v2-lite-16b", {})], ids=["olmo", "olmo-knn", "deepseek"])
@pytest.mark.parametrize("pos", [4, [4, 1]], ids=["scalar", "vector"])
def test_decode_past_the_cache_end_matches_jax(arch, kw, pos):
    """At T = 4, after four steps fill the cache: a scalar ``pos = 4``
    clamps the write to slot 3 (JAX's ``dynamic_update_slice``); the vector
    ``[4, 1]`` writes nothing for row 0 and slot 1 for row 1 (JAX's
    ``hit`` mask). Logits and every cache entry as JAX's, nothing raises;
    in place (``rows=``) too."""
    jcfg, cfg, jp, p = _setup(arch, **kw)
    toks = _tokens(cfg, 6, s=5)
    jc = jtr.init_cache(jcfg, B, 4)
    tc = tr.init_cache(cfg, B, 4, device="cpu")
    for t in range(4):
        _, jc = jtr.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                jnp.int32(t), jcfg)
        _, tc = tr.decode_step(p, tc, torch.from_numpy(toks[:, t:t + 1]), t, cfg)
    jpos = jnp.int32(pos) if np.ndim(pos) == 0 else jnp.asarray(pos, jnp.int32)
    want, jnew = jtr.decode_step(jp, jc, jnp.asarray(toks[:, 4:]), jpos, jcfg)
    got, new = tr.decode_step(p, tc, torch.from_numpy(toks[:, 4:]),
                              torch.tensor(pos), cfg)
    np.testing.assert_allclose(_f32(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    _trees_close(new, jnew)
    changed = {k: (~torch.isclose(new[k], tc[k])).flatten(3).any(-1).any(0)
               for k in tc}  # (B, T): the slots each row wrote
    want_hit = torch.zeros(B, 4, dtype=torch.bool)
    if np.ndim(pos) == 0:
        want_hit[:, 3] = True
    else:
        want_hit[1, 1] = True
    for k, hit in changed.items():
        assert torch.equal(hit, want_hit), k
    _, in_place = tr.decode_step(p, {k: v.clone() for k, v in tc.items()},
                                 torch.from_numpy(toks[:, 4:]), torch.tensor(pos),
                                 cfg, rows=torch.arange(B))
    assert all(torch.equal(in_place[k], new[k]) for k in new)
