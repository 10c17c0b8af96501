"""The routed MoE path (``models/moe.py::_routed_moe`` through
``kernels/moe_experts.py``'s dispatch and plain version) against the dense
form (``_dense_moe``, JAX's single-device path) in fp32 on the CPU, on the
SMOKE configs of both MoE archs with normalised and unnormalised top-k
gates.

Tolerances: fp32 outputs rtol = atol = 1e-5 (the same products, summed in
other orders: the dense form adds the zero-gated experts too). Where a
row's value must not depend on the other rows (dead rows, ``live=None``),
it is held bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from repro_torch import kernels, spans  # noqa: E402
from repro_torch.configs import deepseek_v2_lite as dsv2, get_smoke  # noqa: E402
from repro_torch.kernels import moe_experts as mx  # noqa: E402
from repro_torch.models import module, moe, transformer  # noqa: E402
from repro_torch.models.config import DeepSeekV2Config  # noqa: E402

ARCHS = ["deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(arch, norm_topk=True, **moe_kw):
    """The arch's SMOKE config in fp32, with its gates normalised or not."""
    cfg = get_smoke(arch).replace(dtype="float32")
    if moe_kw:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return DeepSeekV2Config(**fields, norm_topk=norm_topk)


def _params(cfg, seed=0):
    return module.init_params(moe.moe_spec(cfg), device="cpu",
                              generator=torch.Generator().manual_seed(seed))


def _x(cfg, seed, b=3, s=5):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32))


def _shared(p, x):
    if "shared" not in p:
        return torch.zeros_like(x)
    sh = p["shared"]
    return (F.silu(x @ sh["wi_gate"]) * (x @ sh["wi_up"])) @ sh["wo"]


def _dense_calls():
    return spans.RECORDER.counters.get(spans.MOE_DENSE_CALLS, 0)


@pytest.mark.parametrize("norm", [True, False], ids=["normalised", "unnormalised"])
@pytest.mark.parametrize("arch", ARCHS)
def test_routed_equals_dense(arch, norm):
    cfg = _cfg(arch, norm)
    p, x = _params(cfg), _x(cfg, 1)
    with torch.no_grad():
        before = _dense_calls()
        out, metrics = moe.moe_apply(p, x, cfg)
        assert _dense_calls() == before  # routed
        dense, dm = moe._dense_moe(p, x, cfg)
    torch.testing.assert_close(out, dense + _shared(p, x), **TOL)
    assert torch.equal(metrics["moe_aux"], dm["moe_aux"])
    assert float(metrics["moe_drop_frac"]) == 0.0
    assert metrics["moe_drop_frac"].dtype == torch.float32
    if not norm:  # the gates are the softmax's, not summing to 1
        gates, _, _, _ = moe._router(p, x.reshape(-1, cfg.d_model), cfg.moe, False)
        assert float(gates.sum(-1).max()) < 1.0


@pytest.mark.parametrize("norm", [True, False], ids=["normalised", "unnormalised"])
@pytest.mark.parametrize("arch", ARCHS)
def test_router_ties_and_experts_with_no_rows(arch, norm):
    """A zero router ties every expert: each token takes the k lowest
    indices (``lax.top_k``), so every other expert has no row; the routed
    form still equals the dense one."""
    cfg = _cfg(arch, norm)
    p, x = _params(cfg), _x(cfg, 2)
    p = {**p, "router": torch.zeros_like(p["router"])}
    m = cfg.moe
    tokens = x.reshape(-1, cfg.d_model)
    _, sel, _, _ = moe._router(p, tokens, m, norm)
    assert sel.tolist() == [list(range(m.top_k))] * tokens.shape[0]
    perm, row_off = mx.dispatch(sel, None, m.num_experts)
    counts = (row_off[1:] - row_off[:-1]).tolist()
    assert counts == [tokens.shape[0]] * m.top_k + [0] * (m.num_experts - m.top_k)
    with torch.no_grad():
        out, _ = moe.moe_apply(p, x, cfg)
        dense, _ = moe._dense_moe(p, x, cfg)
    torch.testing.assert_close(out, dense + _shared(p, x), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_is_a_stable_sort_with_dead_rows_last(arch):
    cfg = _cfg(arch)
    m = cfg.moe
    rng = np.random.default_rng(3)
    t = 11
    sel = torch.from_numpy(np.stack([rng.choice(m.num_experts, m.top_k, replace=False)
                                     for _ in range(t)])).long()
    live = torch.from_numpy(rng.random(t) < 0.6)
    perm, row_off = mx.dispatch(sel, live, m.num_experts)
    assert perm.dtype == torch.int64 and row_off.dtype == torch.int32
    flat = sel.reshape(-1).tolist()
    alive = [bool(live[i // m.top_k]) for i in range(t * m.top_k)]
    key = [e if a else m.num_experts for e, a in zip(flat, alive)]
    assert perm.tolist() == sorted(range(len(key)), key=lambda i: key[i])
    for e in range(m.num_experts):
        group = perm[row_off[e]:row_off[e + 1]].tolist()
        assert group == [i for i in range(len(key)) if key[i] == e]
    assert int(row_off[-1]) == sum(alive)  # dead pairs in no group


@pytest.mark.parametrize("arch", ARCHS)
def test_drop_frac_is_zero_when_every_token_picks_one_expert(arch):
    """All of a batch's tokens routed to the same top-k experts (a planted
    router): no capacity, nothing dropped, still the dense answer."""
    cfg = _cfg(arch)
    p, x = _params(cfg), _x(cfg, 4, b=4, s=8)
    router = torch.zeros_like(p["router"])
    router[:, cfg.moe.num_experts - 1] = 1.0
    x = x.abs()  # every token's logit for the last expert is positive
    p = {**p, "router": router}
    with torch.no_grad():
        out, metrics = moe.moe_apply(p, x, cfg)
        dense, _ = moe._dense_moe(p, x, cfg)
    assert float(metrics["moe_drop_frac"]) == 0.0
    torch.testing.assert_close(out, dense + _shared(p, x), **TOL)


@pytest.mark.parametrize("norm", [True, False], ids=["normalised", "unnormalised"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dead_rows_get_no_routed_output_and_move_no_live_row(arch, norm):
    cfg = _cfg(arch, norm)
    p, x = _params(cfg), _x(cfg, 5, b=8, s=1)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        every, _ = moe.moe_apply(p, x, cfg)
        assert torch.equal(moe.moe_apply(p, x, cfg,
                                         live=torch.ones(8, dtype=torch.bool))[0],
                           every)
        for _ in range(4):
            live = torch.from_numpy(rng.random(8) < 0.5)
            out, _ = moe.moe_apply(p, x, cfg, live=live)
            assert torch.equal(out[live], every[live])
            dead = ~live
            torch.testing.assert_close(out[dead], _shared(p, x)[dead], **TOL)
    # the dense form (under grad) honours live the same way
    before = _dense_calls()
    x_g = x.clone().requires_grad_(True)
    out_g, _ = moe.moe_apply(p, x_g, cfg, live=live)
    assert _dense_calls() == before + 1
    torch.testing.assert_close(out_g[dead], _shared(p, x)[dead], **TOL)
    torch.testing.assert_close(out_g[live], every[live], **TOL)


def _decode_params(cfg, seed=0):
    return module.init_params(transformer.param_spec(cfg), device="cpu",
                              generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("cfg", [get_smoke("deepseek-v2-lite-16b"),
                                 get_smoke("qwen3-moe-235b-a22b"),
                                 dsv2.PUBLISHED_SMOKE],
                         ids=["deepseek", "qwen3-moe", "deepseek-published"])
def test_decode_step_live(cfg, monkeypatch):
    """``live=None`` is every row live, bit for bit, and today's dense
    decode within fp32's rounding; dead rows leave live rows' logits and
    cache rows bit for bit."""
    cfg = cfg.replace(dtype="float32")
    params = _decode_params(cfg)
    b, t = 4, 6
    rng = np.random.default_rng(6)
    cache = transformer.init_cache(cfg, b, t + 2, device="cpu")
    with torch.no_grad():
        for i in range(t):  # fill positions [0, t) row by row
            tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1)))
            _, cache = transformer.decode_step(params, cache, tok, i, cfg)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1)))
        pos = torch.tensor([t, t - 1, t, 2])
        rows = torch.arange(b)
        run = lambda live: transformer.decode_step(  # noqa: E731
            params, {k: v.clone() for k, v in cache.items()}, tok, pos, cfg,
            rows=rows, live=live)
        base, base_cache = run(None)
        every, _ = run(torch.ones(b, dtype=torch.bool))
        assert torch.equal(base, every)
        live = torch.tensor([True, False, True, False])
        part, part_cache = run(live)
        assert torch.equal(part[live], base[live])
        for name in base_cache:
            assert torch.equal(part_cache[name][:, live], base_cache[name][:, live])
        monkeypatch.setattr(moe, "_routes", lambda *_: False)
        dense, _ = run(None)
    torch.testing.assert_close(base, dense, **TOL)


def test_grad_path_stays_dense_by_the_counters():
    """Under autograd the MoE takes the dense form (the kernel has no
    backward) and its gradients flow; without grad, the routed one."""
    cfg = _cfg("deepseek-v2-lite-16b")
    p, x = _params(cfg), _x(cfg, 7)
    before = _dense_calls()
    xg = x.clone().requires_grad_(True)
    out, _ = moe.moe_apply(p, xg, cfg)
    out.sum().backward()
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())
    pg = {**p, "w_gate": p["w_gate"].clone().requires_grad_(True)}
    out, _ = moe.moe_apply(pg, x, cfg)
    (g,) = torch.autograd.grad(out.sum(), [pg["w_gate"]])
    assert float(g.abs().sum()) > 0
    assert _dense_calls() == before + 2
    with torch.no_grad():  # grad off: requires_grad is not recorded
        moe.moe_apply(pg, xg, cfg)
    moe.moe_apply(p, x, cfg)  # nothing requires grad
    assert _dense_calls() == before + 2
    # the whole-model loss under grad: every layer dense, none routed
    lcfg = get_smoke("qwen3-moe-235b-a22b").replace(dtype="float32")
    lp = module.map_tree(lambda _, t: t.requires_grad_(True), _decode_params(lcfg))
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, lcfg.vocab_size, (2, 5)))
    before = _dense_calls()
    loss, _ = transformer.loss_fn(lp, {"tokens": tokens, "labels": tokens}, lcfg)
    loss.backward()
    assert _dense_calls() == before + lcfg.num_layers


def test_meta_tensors_keep_the_dense_form():
    """The dry-run's shape-only tensors cannot be grouped by a routing."""
    cfg = _cfg("qwen3-moe-235b-a22b")
    p = module.map_tree(lambda _, t: t.to("meta"), _params(cfg))
    before = _dense_calls()
    with torch.no_grad():
        out, _ = moe.moe_apply(p, torch.empty(2, 3, cfg.d_model, device="meta"), cfg)
    assert out.shape == (2, 3, cfg.d_model) and out.device.type == "meta"
    assert _dense_calls() == before + 1


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    cfg = _cfg("deepseek-v2-lite-16b")
    p, x = _params(cfg), _x(cfg, 8)
    kernels.reset_launch_counts()
    with torch.no_grad():
        moe.moe_apply(p, x, cfg)
    assert kernels.launch_counts()["moe_experts"] == 0
    tokens = x.reshape(-1, cfg.d_model)
    gates, sel, _, _ = moe._router(p, tokens, cfg.moe)
    perm, row_off = mx.dispatch(sel, None, cfg.moe.num_experts)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        mx.moe_experts_cuda(tokens, p["w_gate"], p["w_up"], p["w_down"],
                            perm, row_off, gates.contiguous())


@pytest.mark.parametrize("t", [1, 5, 40])
def test_plain_rows_do_not_depend_on_group_size(t):
    """One token's output alone equals its row among ``t`` others (the
    plain version multiplies in fixed tiles of ``PLAIN_BM`` rows)."""
    cfg = _cfg("qwen3-moe-235b-a22b")
    p = _params(cfg)
    x = _x(cfg, 9, b=1, s=t)[0]
    gates, sel, _, _ = moe._router(p, x, cfg.moe)
    full = mx.moe_experts(x, p["w_gate"], p["w_up"], p["w_down"], sel, gates)
    one = mx.moe_experts(x[:1], p["w_gate"], p["w_up"], p["w_down"], sel[:1],
                         gates[:1])
    assert torch.equal(full[:1], one)


@pytest.mark.parametrize("t,k,e,want", [(64, 6, 64, 16), (170, 6, 64, 16),
                                        (171, 6, 64, 64), (512, 6, 64, 64),
                                        (1024, 6, 64, 128), (4096, 8, 128, 128)])
def test_tile_rows_follow_the_mean_pairs_an_expert(t, k, e, want):
    tokens = torch.zeros(t, 8, dtype=torch.bfloat16)
    assert mx.tile_rows(tokens, k, e) == want
    assert mx.tile_rows(tokens.float(), k, e) == 16  # fp32: one tile
