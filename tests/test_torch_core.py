"""The port's DIGC core (``repro_torch.core``: spec registry, reference
tier, graph ops) against the JAX package on the same numpy inputs.

Tolerances: distances are fp32 sums taken in another order on each side
(rtol 1e-5, atol 1e-4, values of order 2*D); indices agree except at
near-ties. Gathers and the max aggregation are exact; the sum and mean
aggregations reorder fp32 adds (1e-6); the positional bias is exact
arithmetic on the same fp32 grid coordinates (1e-7).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro_torch import testing  # noqa: E402

# The packages re-export the function ``digc`` under the module's name,
# so the modules are taken from the import system.
jdigc = importlib.import_module("repro.core.digc")
jgraph = importlib.import_module("repro.core.graph")
builder = importlib.import_module("repro_torch.core.builder")
digc = importlib.import_module("repro_torch.core.digc")
graph = importlib.import_module("repro_torch.core.graph")

RTOL, ATOL = 1e-5, 1e-4


def test_registry_lists_ported_tiers_and_rejects_the_rest():
    assert builder.available_impls() == (
        "axial", "blocked", "cluster", "cuda", "reference")
    assert builder.get_builder("cuda").aggregate is not None
    with pytest.raises(ValueError, match=r"unknown DIGC impl: 'ring'.*cuda"):
        builder.get_builder("ring")


# Knobs of other tiers (the engine's group width and merge knobs, the JAX
# pallas builder's interpret mode, stale-graph reuse) that the kernel does
# not take.
@pytest.mark.parametrize("knob", [
    {"group_w": 8}, {"interpret": True}, {"merge": "select"},
    {"fuse_norms": True}, {"max_stale": 2}, {"reuse": "layer"},
])
def test_cuda_builder_rejects_unported_knobs(knob):
    x = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="does not accept knob"):
        digc.digc(x, spec=builder.DigcSpec(impl="cuda", k=2, **knob))


def test_cuda_builder_rejects_causal_pos_bias_and_pad_masks():
    """The kernel takes causal masks and positional bias (its variants);
    pad masks (m_valid) stay with the pad-capable tiers."""
    x = torch.zeros(1, 8, 4)
    assert digc.digc(x, k=2, impl="cuda", causal=True).shape == (1, 8, 2)
    assert digc.digc(x, k=2, impl="cuda",
                     pos_bias=torch.zeros(8, 8)).shape == (1, 8, 2)
    with pytest.raises(ValueError,
                       match="pad-capable impls: \\['blocked', 'reference'\\]"):
        digc.digc(x, k=2, impl="cuda", m_valid=torch.ones(8, dtype=torch.bool))


def test_resolve_spec_and_promote_batch_errors():
    with pytest.raises(TypeError, match="requires k"):
        builder.resolve_spec(impl="cuda")
    with pytest.raises(ValueError, match="unknown DIGC knob"):
        builder.resolve_spec(k=3, nonsense=1)
    spec = builder.resolve_spec(builder.DigcSpec(impl="cuda"), k=5, dilation=2)
    assert (spec.k, spec.dilation, spec.knobs()) == (5, 2, {})
    with pytest.raises(ValueError, match="batch mismatch"):
        builder.promote_batch(torch.zeros(2, 3, 4), torch.zeros(3, 3, 4))
    x3, y3, p3, squeeze = builder.promote_batch(
        torch.zeros(3, 4), None, torch.zeros(3, 3))
    assert x3.shape == (1, 3, 4) and y3 is x3 and p3.shape == (1, 3, 3)
    assert squeeze


@pytest.mark.parametrize("case", ["plain", "m_valid", "causal", "pos_bias"])
def test_digc_reference_matches_jax(case):
    b, n, m, d, k, dil = 2, 24, 24, 8, 4, 2
    x = testing.features(11, b, n, d)
    y = testing.features(12, b, m, d)
    kw_j, kw_t = {}, {}
    if case == "m_valid":
        mv = np.ones((b, m), bool)
        mv[:, 17:] = False
        kw_j["m_valid"], kw_t["m_valid"] = jnp.asarray(mv), torch.from_numpy(mv)
    elif case == "causal":
        kw_j["causal"] = kw_t["causal"] = True
    elif case == "pos_bias":
        pb = np.array(jgraph.grid_pos_bias(4, 6, scale=0.5))
        kw_j["pos_bias"], kw_t["pos_bias"] = jnp.asarray(pb), torch.from_numpy(pb)
    ref_i, ref_d = jdigc.digc_reference(jnp.asarray(x), jnp.asarray(y), k=k,
                                        dilation=dil, return_dists=True, **kw_j)
    idx, dist = digc.digc_reference(torch.from_numpy(x), torch.from_numpy(y),
                                    k=k, dilation=dil, return_dists=True, **kw_t)
    if case == "causal":
        # Causally excluded lanes carry BIG and unspecified indices.
        keep = np.asarray(ref_d) < digc.BIG / 2
        np.testing.assert_array_equal(keep, dist.numpy() < digc.BIG / 2)
        fill = -1 - np.arange(k, dtype=np.int32)  # distinct placeholders
        ref_i = np.where(keep, ref_i, fill)
        idx = torch.from_numpy(np.where(keep, idx.numpy(), fill))
    testing.assert_topk_match(idx.numpy(), dist.numpy(), np.asarray(ref_i),
                              np.asarray(ref_d), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("impl", ["reference", "cuda"])
def test_digc_entry_matches_jax_reference(impl):
    x = testing.features(21, 3, 30, 16)
    ref_i, ref_d = jdigc.digc(jnp.asarray(x), k=5, dilation=3,
                              impl="reference", return_dists=True)
    idx, dist = digc.digc(torch.from_numpy(x), k=5, dilation=3, impl=impl,
                          return_dists=True)
    testing.assert_topk_match(idx.numpy(), dist.numpy(), np.asarray(ref_i),
                              np.asarray(ref_d), rtol=RTOL, atol=ATOL)


def test_graph_ops_match_jax():
    b, n, m, d, k = 2, 20, 15, 6, 4
    x = testing.features(31, b, n, d)
    y = testing.features(32, b, m, d)
    idx = testing.neighbour_ids(33, b, n, k, m)
    jx, jy, ji = jnp.asarray(x), jnp.asarray(y), jnp.asarray(idx)
    tx, ty, ti = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(idx)
    np.testing.assert_array_equal(graph.knn_gather(ty, ti).numpy(),
                                  np.asarray(jgraph.knn_gather(jy, ji)))
    np.testing.assert_array_equal(graph.knn_gather(ty[0], ti[0]).numpy(),
                                  np.asarray(jgraph.knn_gather(jy[0], ji[0])))
    np.testing.assert_array_equal(graph.mr_aggregate(tx, ty, ti).numpy(),
                                  np.asarray(jgraph.mr_aggregate(jx, jy, ji)))
    for name in ("sum", "mean"):
        np.testing.assert_allclose(
            graph.AGGREGATORS[name](tx, ty, ti).numpy(),
            np.asarray(jgraph.AGGREGATORS[name](jx, jy, ji)),
            rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(graph.edge_list(ti[0]).numpy(),
                                  np.asarray(jgraph.edge_list(ji[0])))
    np.testing.assert_array_equal(graph.degree_histogram(ti[0], m).numpy(),
                                  np.asarray(jgraph.degree_histogram(ji[0], m)))
    np.testing.assert_allclose(
        graph.grid_pos_bias(4, 6, 2, 3, scale=0.7, device="cpu").numpy(),
        np.asarray(jgraph.grid_pos_bias(4, 6, 2, 3, scale=0.7)),
        rtol=1e-7, atol=1e-7)
