"""The port's MoE layer (``repro_torch/models/moe.py``) against the JAX
package's (``repro/models/moe.py``) on the same inputs and weights, on the
SMOKE configs of both MoE archs (deepseek-v2-lite: 8 experts top-2 with a
shared expert; qwen3-moe: 8 experts top-2, none shared).

Tolerances: fp32 outputs rtol = atol = 1e-5 (the same fp32 operations,
sums in other orders), ``moe_aux`` within 1e-6. bf16 outputs within
2e-2 of the output's RMS elementwise (``tests/test_torch_lm_layers.py``'s
2e-2 at unit scale, about five bf16 ulps; these outputs run to ~20, and a
bf16 sum's rounding scales with its terms, not with its result), after
checking that both sides selected the same experts: a routing flip at a
near-tie changes an expert, not a rounding.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.module import init_params as jax_init_params  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.module import leaves  # noqa: E402

ARCHS = ["deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"]
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _setup(arch, dtype="float32", seed=0):
    """(JAX cfg, port cfg, JAX params, port params): the JAX init of one
    MoE layer, converted through numpy."""
    jcfg = jax_smoke(arch).replace(dtype=dtype)
    cfg = get_smoke(arch).replace(dtype=dtype)
    jp = jax_init_params(jmoe.moe_spec(jcfg), jax.random.PRNGKey(seed))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, cfg, jp, tp


def _x(cfg, seed, b=2, s=5):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _f32(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else a,
                      np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_spec_equals_jax(arch):
    jcfg, cfg, _, _ = _setup(arch)
    want = {tuple(k.key for k in path): (s.shape, s.dtype, s.init)
            for path, s in jax.tree_util.tree_leaves_with_path(
                jmoe.moe_spec(jcfg),
                is_leaf=lambda x: hasattr(x, "axes"))}
    got = {path: (s.shape, s.dtype, s.init)
           for path, s in leaves(moe.moe_spec(cfg)).items()}
    assert got.keys() == want.keys()
    for path, (shape, dtype, init) in got.items():
        assert (shape, init) == want[path][::2], path
        assert str(dtype).split(".")[-1] == str(np.dtype(want[path][1])), path
    assert got[("router",)][1] == torch.float32
    assert (("shared", "wo") in got) == bool(cfg.moe.num_shared)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_matches_jax(arch):
    jcfg, cfg, jp, tp = _setup(arch)
    tokens = _x(cfg, 1).reshape(-1, cfg.d_model)
    gates, sel, aux, probs = moe._router(tp, torch.from_numpy(tokens), cfg.moe)
    jg, js, ja, jpr = jmoe._router(jp, jnp.asarray(tokens), jcfg.moe)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(js))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), **TOL["float32"])
    np.testing.assert_allclose(probs.numpy(), np.asarray(jpr), **TOL["float32"])
    assert abs(float(aux) - float(ja)) <= 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_and_dense_moe_match_jax_fp32(arch):
    jcfg, cfg, jp, tp = _setup(arch)
    x = _x(cfg, 2)
    out, metrics = moe.moe_apply(tp, torch.from_numpy(x), cfg)
    jout, jmetrics = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(_f32(out), np.asarray(jout), **TOL["float32"])
    assert abs(float(metrics["moe_aux"]) - float(jmetrics["moe_aux"])) <= 1e-6
    assert float(metrics["moe_drop_frac"]) == float(jmetrics["moe_drop_frac"]) == 0.0
    assert metrics["moe_aux"].dtype == torch.float32
    dense, dm = moe._dense_moe(tp, torch.from_numpy(x), cfg)
    jdense, jdm = jmoe._dense_moe(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(_f32(dense), np.asarray(jdense), **TOL["float32"])
    assert abs(float(dm["moe_aux"]) - float(jdm["moe_aux"])) <= 1e-6
    if cfg.moe.num_shared:  # the shared experts add to the routed output
        assert not torch.allclose(dense, out)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_bf16_matches_jax_on_equal_routing(arch):
    jcfg, cfg, jp, tp = _setup(arch, dtype="bfloat16")
    x = _x(cfg, 3)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    d = cfg.d_model
    _, sel, _, _ = moe._router(tp, xt.reshape(-1, d), cfg.moe)
    _, jsel, _, _ = jmoe._router(jp, xj.reshape(-1, d), jcfg.moe)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    out, metrics = moe.moe_apply(tp, xt, cfg)
    jout, jmetrics = jmoe.moe_apply(jp, xj, jcfg)
    assert out.dtype == torch.bfloat16
    rms = float(np.sqrt(np.mean(_f32(jout) ** 2)))
    np.testing.assert_allclose(_f32(out) / rms, _f32(jout) / rms,
                               **TOL["bfloat16"])
    assert abs(float(metrics["moe_aux"]) - float(jmetrics["moe_aux"])) <= 1e-6


@pytest.mark.parametrize("ties", [
    {},  # a zero router: every expert ties
    {3: 2.0, 5: 2.0, 1: 1.0, 6: 1.0},  # two tied pairs above the rest
])
def test_router_ties_go_to_the_lowest_index_as_in_jax(ties):
    """Planted exact ties in the router's probabilities: the selection is
    ``lax.top_k``'s, lowest index first, never torch.topk's order."""
    jcfg, cfg, _, _ = _setup("qwen3-moe-235b-a22b")
    m = dataclasses.replace(cfg.moe, top_k=3)
    jm = dataclasses.replace(jcfg.moe, top_k=3)
    router = np.zeros((cfg.d_model, cfg.moe.num_experts), np.float32)
    for e, v in ties.items():
        router[0, e] = v
    tokens = np.zeros((4, cfg.d_model), np.float32)
    tokens[:, 0] = 1.0
    _, sel, _, probs = moe._router({"router": torch.from_numpy(router)},
                                   torch.from_numpy(tokens), m)
    _, jsel, _, _ = jmoe._router({"router": jnp.asarray(router)},
                                 jnp.asarray(tokens), jm)
    want = [0, 1, 2] if not ties else [3, 5, 1]
    assert (probs[:, want[0]] == probs[:, want[1]]).all()
    assert sel.tolist() == [want] * 4
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    vals, idx = moe.top_k(torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]]), 4)
    assert idx.tolist() == [[1, 2, 4, 3]] and vals.tolist() == [[3, 3, 3, 2]]


def test_moe_apply_on_a_mesh_raises_naming_item_6():
    """The raise is gone: a model axis of 2 runs expert-parallel on two
    gloo ranks, equal to the dense function when nothing drops (the
    expert-parallel tests against JAX are in test_torch_distributed.py)."""
    _, cfg, _, tp = _setup("deepseek-v2-lite-16b")
    x = torch.from_numpy(_x(cfg, 4))
    outs = testing.run_ranks("""
        import dataclasses, torch
        from repro_torch.configs import get_smoke
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import moe
        from repro_torch.models.module import init_params
        cfg = get_smoke("deepseek-v2-lite-16b").replace(dtype="float32")
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=8.0))
        p = init_params(moe.moe_spec(cfg),
                        generator=torch.Generator().manual_seed(0),
                        device="cpu")
        x = torch.randn(4, 8, cfg.d_model,
                        generator=torch.Generator().manual_seed(1))
        mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
        out, met = moe.moe_apply(p, x, cfg, mesh=mesh)
        ref, _ = moe.moe_apply(p, x, cfg)
        print(float((out - ref).abs().max()), float(met["moe_drop_frac"]))
    """, 2, timeout=120)
    for line in outs:
        err, drop = map(float, line.split())
        assert err < 1e-4 and drop == 0.0
    # one model shard, or no model axis, is the single-device function
    ref, _ = moe.moe_apply(tp, x, cfg)
    for mesh in (types.SimpleNamespace(axis_names=("data", "model"),
                                       shape={"data": 4, "model": 1}),
                 types.SimpleNamespace(axis_names=("data",),
                                       shape={"data": 4})):
        out, _ = moe.moe_apply(tp, x, cfg, mesh=mesh)
        assert torch.equal(out, ref)
