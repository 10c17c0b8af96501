"""The port's training path against the JAX package: the losses
(``transformer.softmax_xent`` / ``loss_fn``, ``encdec_loss_fn``,
``vig.vig_loss_fn``) and their grads, the optimizer and schedule, the
train step (remat, accumulation), the drivers, and the MRConv kernel's
missing backward (ROADMAP queue 3, item 20). Parameters are JAX's init
converted through numpy, or the port's seeded init where a test needs no
JAX side.

Tolerances, fp32: the loss within 1e-6 relative; each leaf's grad within
1e-4 of the leaf's RMS in RMS error, plus 1e-6 of the largest leaf RMS
(a key bias's grad is zero up to rounding: softmax ignores a shift that
is the same for every key). ``whisper-tiny`` and ``recurrentgemma-9b`` at
SMOKE depth are held at 1e-2: their stacked fan-in init (the layer count
as the fan-in) leaves fp32 ill-conditioned, so that both packages' fp32
grads are ~1e-3 of the RMS from an fp64 evaluation
(``tools/grad_fp64_gap.py``). bf16: each leaf's grad nearer JAX's bf16
grad than JAX's bf16 grad is to its fp32 one (ROADMAP queue 3, item 13).
``adamw_update`` on the same grads within 1e-6.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import api as japi  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models import vig as jvig  # noqa: E402
from repro.models.module import init_params as jax_init_params  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data.pipeline import DataConfig, synth_image_batch, synth_lm_batch  # noqa: E402
from repro_torch.launch import api, train, train_vig  # noqa: E402
from repro_torch.models import convert, module, vig  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.trainer import (  # noqa: E402
    init_train_state,
    make_train_step,
    value_and_grad,
)

B, S = 2, 16
# fp32 grad tolerance (relative to each leaf's RMS) by arch
ILL_CONDITIONED = {"whisper-tiny", "recurrentgemma-9b"}


def _batch(cfg, seed=0):
    """``tests/test_archs.py::_batch`` as numpy arrays."""
    rng = np.random.default_rng(seed)
    batch = {
        "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "mask": np.ones((B, S), np.float32),
    }
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if cfg.mrope_sections:
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        batch["positions"] = np.ascontiguousarray(np.broadcast_to(pos, (3, B, S)))
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _setup(arch, dtype="float32"):
    jcfg = jconfigs.get_smoke(arch).replace(dtype=dtype)
    cfg = configs.get_smoke(arch).replace(dtype=dtype)
    ja, a = japi.get_api(jcfg), api.get_api(cfg)
    jp = jax_init_params(ja.param_spec(), jax.random.PRNGKey(0))
    p = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    return jcfg, cfg, ja, a, jp, p


def _jax_grads(loss_fn, params, batch, cfg):
    (loss, _), grads = jax.value_and_grad(
        lambda q: loss_fn(q, batch, cfg), has_aux=True)(params)
    return float(loss), module.leaves(jax.tree.map(
        lambda g: np.asarray(g.astype(jnp.float32)), grads))


def _rms(a):
    return float(np.sqrt(np.mean(np.asarray(a, np.float64) ** 2)))


def _assert_grads_close(got: dict, want: dict, tol: float):
    assert got.keys() == want.keys()
    floor = 1e-6 * max(_rms(w) for w in want.values())
    for path, g in got.items():
        err = _rms(g.float().numpy() - want[path])
        assert err <= tol * _rms(want[path]) + floor, (path, err, _rms(want[path]))


def test_softmax_xent_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 5, 97)) * 4).astype(np.float32)
    labels = rng.integers(0, 97, (3, 5)).astype(np.int32)
    got = tr.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jtr.softmax_xent(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    bf = torch.from_numpy(logits).bfloat16()
    assert tr.softmax_xent(bf, torch.from_numpy(labels)).dtype == torch.float32


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_loss_and_grads_match_jax_fp32(arch):
    jcfg, cfg, ja, a, jp, p = _setup(arch)
    batch = _batch(cfg)
    jloss, jgrads = _jax_grads(ja.loss_fn, jp, _jax(batch), jcfg)
    loss, metrics, grads = value_and_grad(a.loss_fn, p, _torch(batch), cfg)
    assert abs(float(loss) - jloss) <= 1e-6 * abs(jloss)
    tol = 1e-2 if arch in ILL_CONDITIONED else 1e-4
    _assert_grads_close(module.leaves(grads), jgrads, tol)
    for leaf in module.leaves(grads).values():
        assert leaf.dtype == torch.float32
    if cfg.moe:
        jm = jtr.forward(jp, jnp.asarray(batch["tokens"]), jcfg)[1]
        assert abs(float(metrics["moe_aux"]) - float(jm["moe_aux"])) < 1e-6


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-32b"])
def test_bf16_loss_and_grads_match_jax(arch):
    """bf16 parameters give bf16 grads, as ``jax.value_and_grad`` does;
    each leaf's is nearer JAX's bf16 grad than that is to JAX's fp32
    grad."""
    jcfg, cfg, ja, a, jp, p = _setup(arch, dtype="bfloat16")
    batch = _batch(cfg)
    jpb = jax.tree.map(lambda t: t.astype(jnp.bfloat16), jp)
    pb = module.map_tree(lambda _, t: t.bfloat16(), p)
    jloss, jgrads = _jax_grads(ja.loss_fn, jpb, _jax(batch), jcfg)
    jloss32, jgrads32 = _jax_grads(ja.loss_fn, jp, _jax(batch),
                                   jcfg.replace(dtype="float32"))
    loss, _, grads = value_and_grad(a.loss_fn, pb, _torch(batch), cfg)
    assert abs(float(loss) - jloss) < abs(jloss - jloss32) + 1e-3 * abs(jloss)
    for path, g in module.leaves(grads).items():
        assert g.dtype == torch.bfloat16
        err = _rms(g.float().numpy() - jgrads[path])
        assert err < _rms(jgrads32[path] - jgrads[path]), path


def _tiny_vig(impl, k=4):
    """``tests/test_vig.py::_tiny_iso`` on tier ``impl``, in both packages."""
    kw = dict(image_size=64, embed_dims=(32,), depths=(2,), num_classes=7, k=k,
              digc_impl=impl)
    return (jvig.VIG_VARIANTS["vig_ti_iso"].replace(**kw),
            vig.VIG_VARIANTS["vig_ti_iso"].replace(**kw))


@pytest.mark.parametrize("impl", ["reference", "blocked"])
def test_vig_loss_and_grads_match_jax(impl):
    jcfg, cfg = _tiny_vig(impl)
    jp = jax_init_params(jvig.vig_param_spec(jcfg), jax.random.PRNGKey(0))
    p = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    batch = synth_image_batch(DataConfig(1, 4, 1, seed=0), 0, image_size=64,
                              num_classes=7)
    jloss, jgrads = _jax_grads(jvig.vig_loss_fn, jp, _jax(batch), jcfg)
    loss, _, grads = value_and_grad(vig.vig_loss_fn, p, _torch(batch), cfg)
    assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss)
    _assert_grads_close(module.leaves(grads), jgrads, 1e-4)


def test_ssm_grads_finite_where_jaxs_are_nan():
    """ROADMAP queue 3, item 23: past one SSD chunk of decay, JAX's
    intra-chunk ``exp`` overflows above the diagonal and its backward
    turns the select's zero gradient into NaN grads. The port selects
    before the ``exp``: the same loss, finite grads."""
    jcfg, cfg, ja, a, jp, p = _setup("mamba2-370m")
    batch = {k: v for k, v in synth_lm_batch(
        DataConfig(2 * cfg.ssm.chunk, 2, cfg.vocab_size), 0).items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda q: ja.loss_fn(q, _jax(batch), jcfg), has_aux=True)(jp)
    loss, _, grads = value_and_grad(a.loss_fn, p, _torch(batch), cfg)
    assert abs(float(loss) - float(jloss)) <= 1e-6 * abs(float(jloss))
    assert any(bool(jnp.isnan(g).any()) for g in jax.tree.leaves(jgrads))
    assert all(bool(torch.isfinite(g).all()) for g in module.leaves(grads).values())


def test_vig_build_under_no_grad_keeps_indices_and_grads():
    """The graph build runs under ``torch.no_grad()``: forcing it to record
    (``enable_grad`` around ``digc``) gives the same indices and bit for
    bit the same grads."""
    _, cfg = _tiny_vig("blocked")
    p = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    batch = _torch(synth_image_batch(DataConfig(1, 4, 1, seed=0), 0,
                                     image_size=64, num_classes=7))
    real = vig.digc

    def run(ctx):
        seen = []

        def recording(*args, **kw):
            with ctx():
                out = real(*args, **kw)
            seen.append(out)
            return out

        vig.digc = recording
        try:
            return value_and_grad(vig.vig_loss_fn, p, batch, cfg)[2], seen
        finally:
            vig.digc = real

    grads, idx = run(contextlib.nullcontext)
    grads_rec, idx_rec = run(torch.enable_grad)
    assert all(torch.equal(a, b) for a, b in zip(idx, idx_rec)) and len(idx) == 2
    for path, g in module.leaves(grads).items():
        assert torch.equal(g, module.leaves(grads_rec)[path]), path


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 150])
def test_lr_schedule_matches_jax(step):
    oc = opt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    joc = jopt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    got = float(opt.lr_at(torch.tensor(step, dtype=torch.int32), oc))
    assert abs(got - float(jopt.lr_at(jnp.int32(step), joc))) <= 1e-6


def test_lr_schedule():
    """Port of ``tests/test_substrates.py::test_lr_schedule``."""
    oc = opt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    assert float(opt.lr_at(0, oc)) == 0.0
    assert abs(float(opt.lr_at(10, oc)) - 1.0) < 1e-6
    assert float(opt.lr_at(100, oc)) == pytest.approx(0.1, rel=1e-3)


@pytest.mark.parametrize("params_dtype", [None, "bfloat16"])
def test_adamw_update_matches_jax_on_identical_grads(params_dtype):
    """Two steps from the same state on the same numpy grads (the second
    large enough to clip): moments, master, parameters and metrics within
    1e-6."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal((5,)).astype(np.float32)}, "n": {}}
    grads = [jax.tree.map(lambda t: (rng.standard_normal(t.shape) * s).astype(np.float32),
                          tree) for s in (0.1, 10.0)]
    oc = opt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    joc = jopt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jdt = None if params_dtype is None else jnp.bfloat16
    dt = None if params_dtype is None else torch.bfloat16
    jstate = jopt.init_opt_state(jax.tree.map(jnp.asarray, tree))
    state = opt.init_opt_state(module.map_tree(lambda _, t: torch.from_numpy(t), tree))
    for g in grads:
        jp, jstate, jm = jopt.adamw_update(jax.tree.map(jnp.asarray, g), jstate,
                                           joc, params_dtype=jdt)
        p, state, m = opt.adamw_update(
            module.map_tree(lambda _, t: torch.from_numpy(t), g), state, oc,
            params_dtype=dt)
        assert int(state.step) == int(jstate.step)
        for name in ("grad_norm", "lr"):
            assert abs(float(m[name]) - float(jm[name])) <= 1e-6 * max(1, abs(float(jm[name])))
        for mine, theirs in ((p, jp), (state.mu, jstate.mu), (state.nu, jstate.nu),
                             (state.master, jstate.master)):
            ref = module.leaves(jax.tree.map(lambda t: np.asarray(t.astype(jnp.float32)),
                                             theirs))
            got = module.leaves(mine)
            assert got.keys() == ref.keys()
            for path, t in got.items():
                np.testing.assert_allclose(t.float().numpy(), ref[path], rtol=1e-6,
                                           atol=1e-6 if t.dtype == torch.float32 else 0)
    assert state.mu["n"] == {} and p["b"]["c"].dtype == (dt or torch.float32)
    assert state.step.dtype == torch.int32 and opt.OptState._fields == jopt.OptState._fields


@pytest.mark.parametrize("arch,policy", [("olmo-1b", "full"), ("olmo-1b", "dots"),
                                         ("whisper-tiny", "full"),
                                         ("recurrentgemma-9b", "full"),
                                         ("deepseek-v2-lite-16b", "dots")])
def test_remat_grads_equal_no_remat(arch, policy):
    """``remat="full"`` / ``"dots"`` recompute the same operations on the
    same inputs: the loss and every grad bit for bit ``"none"``'s."""
    cfg = configs.get_smoke(arch).replace(dtype="float32")
    a = api.get_api(cfg)
    p = module.init_params(a.param_spec(), device="cpu",
                           generator=torch.Generator().manual_seed(0))
    batch = _torch(_batch(cfg))
    runs = [value_and_grad(a.loss_fn, p, batch, cfg.replace(remat=r))
            for r in ("none", policy)]
    assert torch.equal(runs[0][0], runs[1][0])
    want = module.leaves(runs[0][2])
    for path, g in module.leaves(runs[1][2]).items():
        assert torch.equal(g, want[path]), path


def test_remat_applies_only_under_grad():
    cfg = configs.get_smoke("olmo-1b").replace(remat="full")
    body = lambda x: x
    assert tr._remat(body, cfg) is not body
    with torch.no_grad():
        assert tr._remat(body, cfg) is body
    assert tr._remat(body, cfg.replace(remat="none")) is body
    with pytest.raises(ValueError, match="remat"):
        tr._remat(body, cfg.replace(remat="some"))


def test_grad_accumulation_equivalence():
    """Port of ``tests/test_substrates.py::test_grad_accumulation_equivalence``."""
    cfg = configs.get_smoke("olmo-1b").replace(dtype="float32")
    a = api.get_api(cfg)
    params = module.init_params(a.param_spec(), device="cpu",
                                generator=torch.Generator().manual_seed(0))
    oc = opt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    dc = DataConfig(seq_len=16, global_batch=4, vocab_size=cfg.vocab_size, seed=0)
    batch = _torch(synth_lm_batch(dc, 0))
    s1 = make_train_step(cfg, oc, loss_fn=a.loss_fn, accum_steps=1,
                         param_dtype=torch.float32)
    s2 = make_train_step(cfg, oc, loss_fn=a.loss_fn, accum_steps=2,
                         param_dtype=torch.float32)
    p1, _, m1 = s1(params, init_train_state(params), batch)
    p2, _, m2 = s2(params, init_train_state(params), batch)
    assert set(m2) == {"loss", "grad_norm", "lr"} and "moe_aux" in m1
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5
    for path, t in module.leaves(p1).items():
        np.testing.assert_allclose(t.numpy(), module.leaves(p2)[path].numpy(),
                                   rtol=1e-3, atol=1e-5)


@pytest.mark.slow
def test_training_reduces_loss():
    """Port of ``tests/test_substrates.py::test_training_reduces_loss``."""
    cfg = configs.get_smoke("olmo-1b")
    a = api.get_api(cfg)
    params = module.init_params(a.param_spec(), device="cpu",
                                generator=torch.Generator().manual_seed(0))
    oc = opt.OptConfig(lr=3e-3, warmup_steps=5, total_steps=60)
    step_fn = make_train_step(cfg, oc, loss_fn=a.loss_fn)
    state = init_train_state(params)
    dc = DataConfig(seq_len=32, global_batch=8, vocab_size=cfg.vocab_size, seed=0)
    losses = []
    for s in range(60):
        params, state, m = step_fn(params, state, _torch(synth_lm_batch(dc, s)))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.5, losses[::10]


@pytest.mark.slow
def test_vig_training_reduces_loss():
    """Port of ``tests/test_vig.py::test_vig_training_reduces_loss``."""
    _, cfg = _tiny_vig("blocked")
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device="cpu")
    oc = opt.OptConfig(lr=1e-3, warmup_steps=5, total_steps=40, weight_decay=0.0)
    step_fn = make_train_step(cfg, oc, loss_fn=vig.vig_loss_fn,
                              param_dtype=torch.float32)
    state = init_train_state(params)
    dc = DataConfig(seq_len=1, global_batch=8, vocab_size=1, seed=0)
    losses = []
    for s in range(40):
        b = synth_image_batch(dc, s, image_size=64, num_classes=cfg.num_classes)
        params, state, m = step_fn(params, state, _torch(b))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-8:]) < np.mean(losses[:8]) - 0.2, losses[::8]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_train_step_no_nans(arch):
    """Port of ``tests/test_archs.py::test_train_step_no_nans``."""
    cfg = configs.get_smoke(arch)
    a = api.get_api(cfg)
    params = module.init_params(a.param_spec(), device="cpu",
                                generator=torch.Generator().manual_seed(0))
    oc = opt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, oc, loss_fn=a.loss_fn)
    params2, state, metrics = step(params, init_train_state(params),
                                   _torch(_batch(cfg)))
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert float(metrics["grad_norm"]) > 0
    l0 = next(iter(module.leaves(params).values()))
    l1 = next(iter(module.leaves(params2).values()))
    assert l1.dtype == torch.bfloat16 and int(state.step) == 1
    assert not torch.allclose(l0.float(), l1.float())


def test_jax_pallas_mrconv_has_no_gradient():
    """ROADMAP queue 3, item 20, JAX's side: ``jax.grad`` through the
    ``pallas`` aggregate raises (interpret mode on the CPU), while the
    plain aggregate differentiates. The port's ``cuda`` aggregate raises
    likewise under grad (``tests/test_torch_train_gpu.py``)."""
    from repro.core.graph import mr_aggregate

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((1, 16, 8)), jnp.float32)
    idx = jnp.asarray(rng.integers(0, 16, (1, 16, 4)), jnp.int32)
    with pytest.raises(AssertionError):
        jax.grad(lambda x: jops.mrconv(x, x, idx).sum())(x)
    assert jax.grad(lambda x: mr_aggregate(x, x, idx).sum())(x).shape == x.shape


def test_port_mrconv_on_the_cpu_differentiates():
    """On CPU tensors the ``cuda`` builder's aggregate is its plain
    version, which has a backward; the guard is for CUDA tensors only."""
    from repro_torch.kernels import ops

    x = torch.randn(1, 16, 8, requires_grad=True)
    idx = torch.randint(0, 16, (1, 16, 4), dtype=torch.int32)
    ops.mrconv(x, x, idx).sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape


def test_launch_train_main_checkpoints_and_resumes(tmp_path, capsys):
    """The driver on SMOKE olmo: 8 steps with a checkpoint every 3, then a
    second run on the same directory resumes at step 6 and its losses
    equal the first run's bit for bit (the CPU's backward is
    deterministic): the parameters restore in bf16, as the step left
    them (ROADMAP queue 3, item 22)."""
    flags = ["--smoke", "--steps", "8", "--batch", "2", "--seq", "16",
             "--ckpt-dir", str(tmp_path), "--ckpt-every", "3", "--device", "cpu"]
    first = train.main(flags)
    assert len(first) == 8 and all(np.isfinite(first))
    assert sorted(d.name for d in tmp_path.iterdir()) == ["step_00000003",
                                                          "step_00000006"]
    resumed = train.main(flags)
    out = capsys.readouterr().out
    assert "resumed from step 6" in out and "loss first-mean" in out
    assert resumed == first[6:]


def test_launch_train_refuses_audio_as_jax():
    with pytest.raises(SystemExit) as jexc:
        jtrain.main(["--arch", "whisper-tiny", "--smoke"])
    with pytest.raises(SystemExit) as exc:
        train.main(["--arch", "whisper-tiny", "--smoke", "--device", "cpu"])
    assert str(exc.value) == str(jexc.value)


def test_launch_train_vig_main_on_cpu(tmp_path, capsys):
    out = train_vig.main(["--steps", "3", "--batch", "2", "--image-size", "32",
                          "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert out["cfg"].digc_impl == "blocked"
    assert "ViG (reduced)" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        train_vig.main(["--digc-impl", "no-such-tier", "--device", "cpu"])
