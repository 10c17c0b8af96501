"""The port's ring DIGC (``repro_torch.core.ring``) against the JAX
package's (``repro.core.ring``).

In-process on a one-rank mesh (gloo, an in-process store): parity with
the reference tier, the functional-state contract, the self-graph
counters, the shared gallery, the tuner key, and the poisoned-warm-norm
contract (the JAX test of it fails under JAX 0.9's typed shardings before
it checks anything, so the port is held to its stated contract: a
poisoned carried norm pushes its co-node out of every list, a cold row
ignores it).

Then one group of 4 gloo ranks (``testing.run_ranks``) against JAX's
4-device ring (forced host devices, ``tests/_subproc.py``), both fed the
same seeded numpy inputs: stateless, cold, warm and mixed rows, a placed
entry that stays placed through a warm round trip, a ragged M kept
whole, the (2, 2) rows x ring mesh, the cases of ``test_ring_digc_exact``
and the self-graph, and tied inputs (hop order breaks ties, as JAX's).
Indices are compared bit for bit; distances within rtol 1e-5, atol 1e-4
(``tests/test_ring.py``'s tolerance); every rank returns the same result.
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _subproc import run_snippet  # noqa: E402
from repro.core import DigcSpec as JSpec  # noqa: E402
from repro.core import digc as jdigc  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.core import DigcSpec, digc, workload_key  # noqa: E402
from repro_torch.core.builder import fallback_chain, get_builder  # noqa: E402
from repro_torch.core.ring import ring_digc  # noqa: E402
from repro_torch.core.state import DigcState, state_entry  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-4
EXACT_CASES = [(64, 64, 16, 4, 1), (120, 100, 32, 4, 2), (16, 24, 8, 2, 1)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh((1,), ("data",), device=CPU)


# ---------------------------------------------------------------------------
# One rank, in-process


def test_ring_builder_flags_and_ladder():
    b = get_builder("ring")
    assert b.distributed and b.supports_state and b.supports_pad and b.exact
    assert b.knobs == frozenset({"mesh", "axis_name", "batch_axis", "reuse",
                                 "drift_tau", "max_stale"})
    assert fallback_chain("ring") == ("blocked", "reference")
    with pytest.raises(ValueError, match="explicit mesh"):
        ring_digc(torch.zeros(4, 2), k=1)


def test_ring_one_rank_parity_and_state_contract(mesh1):
    """tests/test_ring.py:20-93 on the port: ring == reference, a frozen
    gallery entry advances its counters and carries the true norms, the
    self-graph carries none, a shared 2-D gallery broadcasts; JAX's
    one-device ring gives the same lists."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 48, 12).astype(np.float32)
    y = rng.randn(2, 40, 12).astype(np.float32)
    i_ref = digc(_t(x), _t(y), k=4, impl="reference")
    spec = DigcSpec(impl="ring", k=4, mesh=mesh1)
    st = DigcState.init({"ring0": state_entry(sq_y_shape=(2, 40), rows=2,
                                              mesh=mesh1, device=CPU)})
    i_ring = digc(_t(x), _t(y), spec=spec)
    i_cold, st1 = digc(_t(x), _t(y), spec=spec, state=st, state_key="ring0")
    i_warm, st2 = digc(_t(x), _t(y), spec=spec, state=st1, state_key="ring0")
    for got in (i_ring, i_cold, i_warm):
        assert torch.equal(got, i_ref)
    assert st1.steps() == {"ring0": 1} and st2.steps() == {"ring0": 2}
    assert st1.row_steps() == {"ring0": [1, 1]}
    np.testing.assert_allclose(st1.entries["ring0"].full().sq_y.numpy(),
                               (y.astype(np.float64) ** 2).sum(-1), rtol=1e-6)
    i_shared = ring_digc(_t(x), _t(y[0]), k=4, mesh=mesh1)
    assert torch.equal(i_shared, digc(
        _t(x), _t(np.broadcast_to(y[0], y.shape).copy()), k=4,
        impl="reference"))
    # self-graph: counters advance, norms are never carried
    xs = np.random.RandomState(6).randn(32, 8).astype(np.float32)
    st_s = DigcState.init({"r": state_entry(sq_y_shape=(1, 32), device=CPU)})
    _, new_st = digc(_t(xs), spec=DigcSpec(impl="ring", k=3, mesh=mesh1),
                     state=st_s, state_key="r")
    assert new_st.steps() == {"r": 1}
    assert (new_st.entries["r"].sq_y == 0).all()
    jmesh = jax.make_mesh((1,), ("data",))
    with jmesh:
        j_ring = jdigc(jnp.asarray(x), jnp.asarray(y),
                       spec=JSpec(impl="ring", k=4, mesh=jmesh))
    np.testing.assert_array_equal(i_ring.numpy(), np.asarray(j_ring))


def test_ring_mesh_shape_in_workload_key(mesh1):
    spec = DigcSpec(impl="ring", k=4, mesh=mesh1)
    assert spec.mesh_shape() == (1,)
    assert DigcSpec(impl="blocked", k=4).mesh_shape() is None
    base = workload_key(1, 64, 64, 16, 4)
    assert workload_key(1, 64, 64, 16, 4, mesh_shape=(4,)) == base + ":mesh4"
    assert workload_key(1, 64, 64, 16, 4, mesh_shape=None) == base


def test_ring_warm_gate_reads_the_carried_norms(mesh1):
    """The warm path reads the carried norms (no silent recompute): a
    poisoned norm on a warm entry pushes that co-node out of every list,
    and a cold row ignores the poison."""
    rng = np.random.RandomState(9)
    x = _t(rng.randn(1, 24, 8).astype(np.float32))
    y = _t(rng.randn(1, 16, 8).astype(np.float32))
    spec = DigcSpec(impl="ring", k=4, mesh=mesh1)
    st = DigcState.init({"r": state_entry(sq_y_shape=(1, 16), rows=1,
                                          mesh=mesh1, device=CPU)})
    i_ref, st1 = digc(x, y, spec=spec, state=st, state_key="r")
    victim = int(i_ref[0, 0, 0])
    entry = st1.entries["r"]
    sq = entry.sq_y.clone()
    sq[:, victim] += 1e9
    poisoned = dataclasses.replace(entry, sq_y=sq)
    i_pois, _ = digc(x, y, spec=spec, state=st1.set("r", poisoned),
                     state_key="r")
    assert victim not in i_pois.numpy()
    cold = dataclasses.replace(poisoned,
                               row_step=torch.zeros(1, dtype=torch.int32))
    i_cold, _ = digc(x, y, spec=spec, state=st1.set("r", cold), state_key="r")
    assert torch.equal(i_cold, i_ref)


def test_ring_errors_match_jax(mesh1):
    x = torch.zeros(3, 8, 4)
    with pytest.raises(ValueError, match="exceeds number of co-nodes M=8"):
        ring_digc(x, k=9, mesh=mesh1)
    mesh2 = make_mesh((1,), ("data",), device=CPU)
    assert mesh2 is mesh1  # one mesh per (shape, axes, device type)


# ---------------------------------------------------------------------------
# Four ranks against JAX's four-device ring


RANK_BODY = """
import dataclasses
import numpy as np, torch
from repro_torch import testing
from repro_torch.core import DigcSpec, digc
from repro_torch.core.ring import ring_digc
from repro_torch.core.state import DigcState, state_entry
from repro_torch.launch.mesh import make_mesh
inp = dict(np.load({inputs!r}))
t = lambda a: torch.from_numpy(np.asarray(a))
out = {{}}
mesh = make_mesh((4,), ("data",), device="cpu")
x, y = t(inp["x"]), t(inp["y"])
spec = DigcSpec(impl="ring", k=4, mesh=mesh)
out["s_i"], out["s_d"] = digc(x, y, spec=spec, return_dists=True)
e = state_entry(sq_y_shape=(2, 40), rows=2, mesh=mesh, device="cpu")
assert e.sq_y.shape == (2, 10) and e.sq_y_placement is not None
st = DigcState.init({{"r": e}})
out["c_i"], out["c_d"], st1 = digc(x, y, spec=spec, state=st, state_key="r",
                                   return_dists=True)
assert st1.entries["r"].sq_y.shape == (2, 10)
out["w_i"], out["w_d"], st2 = digc(x, y, spec=spec, state=st1,
                                   state_key="r", return_dists=True)
assert st2.entries["r"].sq_y_placement is not None
out["w_sq"] = st2.entries["r"].full().sq_y
out["steps"] = torch.tensor(st2.steps()["r"])
mixed = dataclasses.replace(st1.entries["r"],
                            row_step=torch.tensor([1, 0], dtype=torch.int32))
out["m_i"], _ = digc(x, y, spec=spec, state=st1.set("r", mixed),
                     state_key="r")
ragged = state_entry(sq_y_shape=(1, 7), rows=1, mesh=mesh, device="cpu")
assert ragged.sq_y_placement is None and ragged.sq_y.shape == (1, 7)
xr, yr = t(inp["xr"]), t(inp["yr"])
st = DigcState.init({{"g": ragged}})
out["rc_i"], st_r = digc(xr, yr, spec=spec, state=st, state_key="g")
out["rw_i"], st_r = digc(xr, yr, spec=spec, state=st_r, state_key="g")
out["rw_sq"] = st_r.entries["g"].sq_y
mesh2 = make_mesh((2, 2), ("rows", "ring"), device="cpu")
spec2 = DigcSpec(impl="ring", k=4, mesh=mesh2, axis_name="ring",
                 batch_axis="rows")
out["t_i"], out["t_d"] = digc(x, y, spec=spec2, return_dists=True)
for c, (n, m, d, k, dil) in enumerate({cases!r}):
    out[f"e{{c}}_i"], out[f"e{{c}}_d"] = ring_digc(
        t(inp[f"ex{{c}}"]), t(inp[f"ey{{c}}"]), k=k, dilation=dil, mesh=mesh,
        return_dists=True)
out["self_i"] = ring_digc(t(inp["xs"]), k=5, mesh=mesh)
out["tie_i"], out["tie_d"] = ring_digc(t(inp["tx"]), t(inp["ty"]), k=6,
                                       mesh=mesh, return_dists=True)
rank = torch.distributed.get_rank()
np.savez({outdir!r} + f"/port{{rank}}.npz",
         **{{k: v.numpy() for k, v in out.items()}})
print("RANK_OK", rank)
"""

JAX_BODY = """
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.core import DigcSpec, digc
from repro.core.ring import ring_digc
from repro.core.state import DigcState, state_entry
assert jax.device_count() == 4
inp = dict(np.load({inputs!r}))
out = {{}}
mesh = jax.make_mesh((4,), ("data",))
x, y = jnp.asarray(inp["x"]), jnp.asarray(inp["y"])
spec = DigcSpec(impl="ring", k=4, mesh=mesh)
out["s_i"], out["s_d"] = digc(x, y, spec=spec, return_dists=True)
st = DigcState.init({{"r": state_entry(sq_y_shape=(2, 40), rows=2,
                                       mesh=mesh)}})
out["c_i"], out["c_d"], st1 = digc(x, y, spec=spec, state=st, state_key="r",
                                   return_dists=True)
out["w_i"], out["w_d"], st2 = digc(x, y, spec=spec, state=st1,
                                   state_key="r", return_dists=True)
assert len(st2.entries["r"].sq_y.addressable_shards) == 4
out["w_sq"] = st2.entries["r"].sq_y
mixed = dataclasses.replace(st1.entries["r"],
                            row_step=jnp.asarray([1, 0], jnp.int32))
out["m_i"], _ = digc(x, y, spec=spec, state=st1.set("r", mixed),
                     state_key="r")
# A ragged M through a stateful entry fails under JAX 0.9's typed
# shardings (the norms' [:, :m] slice); the stateless ring serves it.
out["r_i"] = digc(jnp.asarray(inp["xr"]), jnp.asarray(inp["yr"]), spec=spec)
mesh2 = jax.make_mesh((2, 2), ("rows", "ring"))
spec2 = DigcSpec(impl="ring", k=4, mesh=mesh2, axis_name="ring",
                 batch_axis="rows")
out["t_i"], out["t_d"] = digc(x, y, spec=spec2, return_dists=True)
for c, (n, m, d, k, dil) in enumerate({cases!r}):
    with mesh:
        out[f"e{{c}}_i"], out[f"e{{c}}_d"] = ring_digc(
            jnp.asarray(inp[f"ex{{c}}"]), jnp.asarray(inp[f"ey{{c}}"]), k=k,
            dilation=dil, mesh=mesh, return_dists=True)
with mesh:
    out["self_i"] = ring_digc(jnp.asarray(inp["xs"]), k=5, mesh=mesh)
    out["tie_i"], out["tie_d"] = ring_digc(
        jnp.asarray(inp["tx"]), jnp.asarray(inp["ty"]), k=6, mesh=mesh,
        return_dists=True)
out["steps"] = np.asarray(st2.steps()["r"])
np.savez({outdir!r} + "/jax.npz", **{{k: np.asarray(v) for k, v in out.items()}})
print("JAX_OK")
"""


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The port on 4 gloo ranks and JAX on 4 host devices, run side by
    side on the same inputs: ({rank: outputs}, JAX's outputs, inputs)."""
    tmp = tmp_path_factory.mktemp("ring4")
    rng = np.random.RandomState(2)
    inp = {"x": rng.randn(2, 48, 12), "y": rng.randn(2, 40, 12),
           "xr": rng.randn(1, 8, 12), "yr": rng.randn(1, 7, 12),
           "xs": rng.randn(80, 24)}
    for c, (n, m, d, _, _) in enumerate(EXACT_CASES):
        inp[f"ex{c}"], inp[f"ey{c}"] = rng.randn(n, d), rng.randn(m, d)
    inp = {k: v.astype(np.float32) for k, v in inp.items()}
    inp["tx"], inp["ty"] = testing.tied_inputs(4, 2, 20, 36, 6)
    np.savez(tmp / "inputs.npz", **inp)
    fmt = dict(inputs=str(tmp / "inputs.npz"), outdir=str(tmp),
               cases=EXACT_CASES)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jax_run = pool.submit(run_snippet, JAX_BODY.format(**fmt), devices=4,
                              timeout=300)
        ranks = testing.run_ranks(RANK_BODY.format(**fmt), 4, timeout=120)
        assert "JAX_OK" in jax_run.result().stdout
    assert all("RANK_OK" in r for r in ranks)
    port = {r: dict(np.load(tmp / f"port{r}.npz")) for r in range(4)}
    return port, dict(np.load(tmp / "jax.npz")), inp


def test_ring_4_ranks_agree_with_each_other(four):
    port, _, _ = four
    for r in range(1, 4):
        for k, v in port[0].items():
            np.testing.assert_array_equal(port[r][k], v, err_msg=k)


@pytest.mark.parametrize("case", ["s", "c", "w", "t"])
def test_ring_4_ranks_match_jax(four, case):
    """s stateless, c cold, w warm (placed entry), t the (2, 2) rows x
    ring mesh: indices bit for bit JAX's, distances within tolerance."""
    port, jx, _ = four
    p = port[0]
    np.testing.assert_array_equal(p[f"{case}_i"], jx[f"{case}_i"])
    np.testing.assert_allclose(p[f"{case}_d"], jx[f"{case}_d"], rtol=RTOL,
                               atol=ATOL)


def test_ring_4_ranks_state_contract(four):
    """Mixed warm/cold rows, the placed entry's gathered norms, the step
    counters and a ragged M kept whole: JAX's values (the ragged entry
    against JAX's stateless ring, which is all JAX 0.9 runs of it); every
    exact result is also the reference tier's."""
    port, jx, inp = four
    p = port[0]
    ref = digc(_t(inp["x"]), _t(inp["y"]), k=4, impl="reference").numpy()
    for key in ("s_i", "c_i", "w_i", "m_i", "t_i"):
        np.testing.assert_array_equal(p[key], ref, err_msg=key)
    np.testing.assert_array_equal(p["m_i"], jx["m_i"])
    np.testing.assert_allclose(p["w_sq"], jx["w_sq"], rtol=1e-6)
    assert int(p["steps"]) == int(jx["steps"]) == 2
    for key in ("rc_i", "rw_i"):  # the ragged entry, cold then warm
        np.testing.assert_array_equal(p[key], jx["r_i"])
    np.testing.assert_allclose(
        p["rw_sq"], (inp["yr"].astype(np.float64) ** 2).sum(-1), rtol=1e-6)


@pytest.mark.parametrize("c", range(len(EXACT_CASES)))
def test_ring_4_ranks_exact_cases(four, c):
    """test_ring_digc_exact's (N, M, D, k, dilation) cases, (N, D) in and
    out: JAX's ring and the reference tier."""
    port, jx, inp = four
    _, _, _, k, dil = EXACT_CASES[c]
    np.testing.assert_array_equal(port[0][f"e{c}_i"], jx[f"e{c}_i"])
    np.testing.assert_allclose(port[0][f"e{c}_d"], jx[f"e{c}_d"], rtol=RTOL,
                               atol=ATOL)
    ref = digc(_t(inp[f"ex{c}"]), _t(inp[f"ey{c}"]), k=k, dilation=dil,
               impl="reference")
    np.testing.assert_array_equal(port[0][f"e{c}_i"], ref.numpy())


def test_ring_4_ranks_self_graph(four):
    port, jx, inp = four
    np.testing.assert_array_equal(port[0]["self_i"], jx["self_i"])
    np.testing.assert_array_equal(
        port[0]["self_i"], digc(_t(inp["xs"]), k=5, impl="reference").numpy())


def test_ring_4_ranks_tie_order_is_hop_order(four):
    """Exact integer distances with repeated co-node rows: the port breaks
    each tie as JAX's ring does (the shard met first), which is not the
    lowest index the single-device tiers keep."""
    port, jx, inp = four
    np.testing.assert_array_equal(port[0]["tie_i"], jx["tie_i"])
    np.testing.assert_array_equal(port[0]["tie_d"], jx["tie_d"])
    lowest = digc(_t(inp["tx"]), _t(inp["ty"]), k=6, impl="reference")
    assert not np.array_equal(port[0]["tie_i"], lowest.numpy())
