"""The port's distributed pieces on 4 gloo ranks (``testing.run_ranks``)
against the JAX package on 4 forced host devices (``tests/_subproc.py``),
both fed the same seeded numpy inputs and JAX's initial weights:

* expert-parallel MoE (``models/moe.py``) on a (2, 2) ("data", "model")
  mesh: at capacity 8 nothing drops and the output equals the port's
  ``_dense_moe`` within 1e-4 (and JAX's expert-parallel output); at
  capacity 0.25 the drop fraction equals JAX's and the output is within
  1e-4 of JAX's;
* ``pipeline_apply`` over 4 stages, 3 microbatches: within 1e-5 of the
  sequential loop and of JAX's result;
* ``compressed_allreduce_tree`` over 4 ranks: within 0.02 (relative to
  the largest entry) of 4 g, and JAX's result within 1e-6 relative;
* in-process: ``quantize_int8`` rounds half to even as JAX's does, and
  ``ErrorFeedback`` gives JAX's compressed grads and residual.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _subproc import run_snippet  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402

JAX_BODY = """
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax import lax
from repro.configs import get_smoke
from repro.distributed.compression import compressed_allreduce_tree
from repro.distributed.pipeline import pipeline_apply
from repro.launch.mesh import make_mesh
from repro.models.moe import moe_apply, moe_spec
from repro.models.module import init_params, use_mesh
assert jax.device_count() == 4
inp = dict(np.load({d!r} + "/inputs.npz"))
out = {{}}
cfg = get_smoke("qwen3-moe-235b-a22b").replace(dtype="float32")
params = init_params(moe_spec(cfg), jax.random.PRNGKey(0))
for k, v in params.items():
    out["p_" + k] = np.asarray(v)
mesh = make_mesh((2, 2), ("data", "model"))
for tag, cf, x in (("big", 8.0, inp["x8"]), ("small", 0.25, inp["x16"])):
    c = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    with use_mesh(mesh):
        o, m = jax.jit(lambda p, x: moe_apply(p, x, c, mesh=mesh))(
            params, jnp.asarray(x))
    out["moe_" + tag] = np.asarray(o)
    out["drop_" + tag] = np.asarray(m["moe_drop_frac"])
    out["aux_" + tag] = np.asarray(m["moe_aux"])
w, b = jnp.asarray(inp["pw"]), jnp.asarray(inp["pb"])
layer_fn = lambda lp, h: jnp.tanh(h @ lp[0] + lp[1])
out["pipe"] = np.asarray(pipeline_apply(
    layer_fn, (w, b), jnp.asarray(inp["px"]), mesh=make_mesh((4,), ("stage",)),
    num_microbatches=3))
g = {{"w": jnp.asarray(inp["gw"]), "b": jnp.asarray(inp["gb"])}}
summed = compressed_allreduce_tree(g, make_mesh((4,), ("pod",)),
                                   axis_name="pod")
out["sum_w"], out["sum_b"] = np.asarray(summed["w"]), np.asarray(summed["b"])
np.savez({d!r} + "/jax.npz", **out)
print("JAX_OK")
"""

RANK_BODY = """
import dataclasses
import numpy as np, torch
from repro_torch.configs import get_smoke
from repro_torch.distributed.compression import compressed_allreduce_tree
from repro_torch.distributed.pipeline import pipeline_apply
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
inp = dict(np.load({d!r} + "/inputs.npz"))
jx = dict(np.load({d!r} + "/jax.npz"))
t = lambda a: torch.from_numpy(np.asarray(a))
out = {{}}
cfg = get_smoke("qwen3-moe-235b-a22b").replace(dtype="float32")
params = {{k[2:]: t(v) for k, v in jx.items() if k.startswith("p_")}}
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
for tag, cf, x in (("big", 8.0, inp["x8"]), ("small", 0.25, inp["x16"])):
    c = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    o, m = moe.moe_apply(params, t(x), c, mesh=mesh)
    out["moe_" + tag] = o
    out["dense_" + tag] = moe._dense_moe(params, t(x), c)[0]
    out["drop_" + tag], out["aux_" + tag] = m["moe_drop_frac"], m["moe_aux"]
w, b = t(inp["pw"]), t(inp["pb"])
layer_fn = lambda lp, h: torch.tanh(h @ lp[0] + lp[1])
out["pipe"] = pipeline_apply(layer_fn, (w, b), t(inp["px"]),
                             mesh=make_mesh((4,), ("stage",), device="cpu"),
                             num_microbatches=3)
h = t(inp["px"])
for i in range(w.shape[0]):
    h = layer_fn((w[i], b[i]), h)
out["seq"] = h
g = {{"w": t(inp["gw"]), "b": t(inp["gb"])}}
summed = compressed_allreduce_tree(
    g, make_mesh((4,), ("pod",), device="cpu"), axis_name="pod")
out["sum_w"], out["sum_b"] = summed["w"], summed["b"]
rank = torch.distributed.get_rank()
np.savez({d!r} + f"/port{{rank}}.npz", **{{k: v.numpy() for k, v in out.items()}})
print("RANK_OK", rank)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX first (the port loads its MoE weights), then the 4 ranks:
    ({rank: outputs}, JAX's outputs, inputs)."""
    tmp = tmp_path_factory.mktemp("dist4")
    rng = np.random.default_rng(0)
    d_model = 64  # qwen3-moe-235b-a22b's SMOKE width
    inp = {"x8": rng.standard_normal((4, 8, d_model)),
           "x16": rng.standard_normal((4, 16, d_model)),
           "pw": rng.standard_normal((8, 16, 16)) * 0.2,
           "pb": rng.standard_normal((8, 16)) * 0.1,
           "px": rng.standard_normal((12, 16)),
           "gw": rng.standard_normal((64, 32)), "gb": rng.standard_normal(17)}
    inp = {k: v.astype(np.float32) for k, v in inp.items()}
    np.savez(tmp / "inputs.npz", **inp)
    out = run_snippet(JAX_BODY.format(d=str(tmp)), devices=4,
                      timeout=300).stdout
    assert "JAX_OK" in out
    ranks = testing.run_ranks(RANK_BODY.format(d=str(tmp)), 4, timeout=120)
    assert all("RANK_OK" in r for r in ranks)
    port = {r: dict(np.load(tmp / f"port{r}.npz")) for r in range(4)}
    return port, dict(np.load(tmp / "jax.npz")), inp


def test_ranks_return_the_same_global_values(runs):
    """Every rank returns the same value, but for the compressed sum: a
    rank keeps the chunk it reduced exact and receives the others through
    int8, as each JAX device does (JAX's replicated result is device
    0's), so ranks agree within the int8 noise there."""
    port, _, _ = runs
    for r in range(1, 4):
        for k, v in port[0].items():
            if k.startswith("sum_"):
                scale = np.abs(v).max()
                assert np.abs(port[r][k] - v).max() / scale < 0.02, k
            else:
                np.testing.assert_array_equal(port[r][k], v, err_msg=k)


def test_moe_expert_parallel_matches_dense(runs):
    port, jx, _ = runs
    p = port[0]
    assert float(p["drop_big"]) == 0.0 == float(jx["drop_big"])
    assert np.abs(p["moe_big"] - p["dense_big"]).max() < 1e-4
    assert np.abs(p["moe_big"] - jx["moe_big"]).max() < 1e-4
    np.testing.assert_allclose(p["aux_big"], jx["aux_big"], rtol=1e-6)


def test_moe_capacity_drops_tokens_as_jax(runs):
    port, jx, _ = runs
    p = port[0]
    drop = float(p["drop_small"])
    assert 0.0 < drop < 1.0
    assert drop == float(jx["drop_small"])
    assert np.isfinite(p["moe_small"]).all()
    assert np.abs(p["moe_small"] - jx["moe_small"]).max() < 1e-4


def test_pipeline_matches_sequential_and_jax(runs):
    port, jx, _ = runs
    p = port[0]
    assert np.abs(p["pipe"] - p["seq"]).max() < 1e-5
    assert np.abs(p["pipe"] - jx["pipe"]).max() < 1e-5


@pytest.mark.parametrize("leaf", ["w", "b"])
def test_int8_ring_allreduce_close_to_sum_and_jax(runs, leaf):
    port, jx, inp = runs
    got, ref = port[0][f"sum_{leaf}"], 4 * inp[f"g{leaf}"]
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < 0.02  # int8 noise bound
    assert np.abs(got - jx[f"sum_{leaf}"]).max() / scale < 1e-6


def test_quantize_int8_rounds_half_to_even_as_jax():
    x = np.array([254.0, 1.0, 3.0, -5.0, 0.0], np.float32)  # scale 2.0
    q, s = compression.quantize_int8(torch.from_numpy(x))
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    assert q.tolist() == [127, 0, 2, -2, 0] == np.asarray(jq).tolist()
    assert float(s) == float(js) == 2.0
    np.testing.assert_array_equal(
        compression.dequantize_int8(q, s).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js)))


def test_error_feedback_residual_matches_jax():
    rng = np.random.default_rng(3)
    g = {"a": rng.standard_normal((5, 7)).astype(np.float32),
         "b": [rng.standard_normal(9).astype(np.float32)]}
    tg = {"a": torch.from_numpy(g["a"]), "b": [torch.from_numpy(g["b"][0])]}
    res = compression.ErrorFeedback.init(tg)
    jres = jcomp.ErrorFeedback.init(jax.tree_util.tree_map(jnp.asarray, g))
    for _ in range(3):  # the residual carries across steps
        q, res = compression.ErrorFeedback.apply(tg, res)
        jq, jres = jcomp.ErrorFeedback.apply(
            jax.tree_util.tree_map(jnp.asarray, g), jres)
    for got, want in ((q["a"], jq["a"]), (q["b"][0], jq["b"][0]),
                      (res["a"], jres["a"]), (res["b"][0], jres["b"][0])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    # one step from a zero residual: compressed + residual = the gradient
    q1, r1 = compression.ErrorFeedback.apply(
        tg, compression.ErrorFeedback.init(tg))
    np.testing.assert_allclose((q1["a"] + r1["a"]).numpy(), g["a"], rtol=0,
                               atol=1e-6)
