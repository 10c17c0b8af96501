"""The approximate DIGC tiers of the port (``repro_torch.core.strategies``,
``repro_torch.core.prng``) against the JAX package's
(``repro.core.strategies``) on the same numpy inputs, on the CPU.

* ``prng.permutation`` equals ``jax.random.permutation(PRNGKey(seed), m)``
  bit for bit (m = 3136 takes two sort rounds).
* ``_segment_ranks`` is exact; ``kmeans`` centroids agree within
  rtol = atol = 1e-5.
* ``cluster_digc`` (cold, warm, scalar and per-row ``init_valid``, shared
  co-nodes, ``return_state``): on well-separated clustered data the
  indices are equal; on random data they are equal except at fp32
  near-ties (``testing.topk_mismatch``, distances within rtol 1e-5 /
  atol 1e-4) and the recall is within 0.01 of JAX's. Lanes with no
  finite candidate (distance BIG) are equal, index included.
* ``axial_digc`` at square and non-square grids and with k*d above the
  H + W candidates (index 0 / BIG padding) equals JAX's exactly.
* The stateful builder through ``digc(state=)``: warm starts, per-row
  gating against B = 1 replays, a stale shape, the read-free branch a
  captured graph takes, and ``init_vig_state``'s centroid buffers.
* Ports of the six tests of ``tests/test_strategies.py``.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import builder as jbuilder  # noqa: E402
from repro.core import strategies as js  # noqa: E402
from repro.core.state import DigcState as JaxState  # noqa: E402
from repro.core.state import state_entry as jax_state_entry  # noqa: E402
from repro.models import vig as jvig  # noqa: E402
from repro.models.module import init_params as jax_init_params  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.core import DigcSpec, builder, prng, strategies as ts  # noqa: E402
from repro_torch.core.state import DigcState, state_entry  # noqa: E402
from repro_torch.models import convert, vig  # noqa: E402

jdigc_fn = importlib.import_module("repro.core").digc
tdigc = importlib.import_module("repro_torch.core.digc")
CPU = "cpu"
BIG = 1e30
RTOL, ATOL = 1e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _clustered(seed, b, n, d, centers=8, spread=2):
    """Points around ``centers`` well-separated centres: integer features
    (centres a multiple of 10 apart per axis, offsets in [-spread,
    spread]), so every point-to-point distance is an exact integer in any
    summation order and only exact ties remain, which both packages give
    to the lowest index."""
    rng = np.random.default_rng(seed)
    c = rng.integers(-3, 4, (b, centers, d)) * 10
    lab = rng.integers(0, centers, (b, n))
    pts = np.take_along_axis(c, lab[..., None], axis=1)
    return (pts + rng.integers(-spread, spread + 1, (b, n, d))).astype(np.float32)


def _assert_like_jax(it, dt, ij, dj, *, exact: bool):
    """The port's (idx, dist) against JAX's: BIG lanes equal, index
    included; live lanes equal (``exact``) or equal except at near-ties."""
    it, dt = it.numpy(), dt.numpy()
    ij, dj = np.asarray(ij), np.asarray(dj)
    big = dj >= BIG / 2
    np.testing.assert_array_equal(dt >= BIG / 2, big)
    np.testing.assert_array_equal(it[big], ij[big])
    np.testing.assert_array_equal(dt[big], dj[big])
    if exact:
        np.testing.assert_array_equal(it, ij)
    fill = -1 - np.arange(it.shape[-1])  # distinct placeholders
    testing.assert_topk_match(np.where(big, fill, it), np.where(big, 0, dt),
                              np.where(big, fill, ij), np.where(big, 0, dj),
                              rtol=RTOL, atol=ATOL)


# -- prng --------------------------------------------------------------------


@pytest.mark.parametrize("m", [16, 49, 196, 784, 3136])
@pytest.mark.parametrize("seed", [0, 3, 7])
def test_permutation_equals_jax_bit_for_bit(m, seed):
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), m))
    got = prng.permutation(seed, m, CPU)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert prng._rounds(m) == (2 if m == 3136 else 1)


def test_split_and_bits_equal_jax():
    key = prng.prng_key(5)
    jkey = jax.random.PRNGKey(5)
    assert key == tuple(int(v) for v in np.asarray(jkey))
    a, b = prng.split(key)
    ja, jb = jax.random.split(jkey)
    assert a == tuple(int(v) for v in np.asarray(ja))
    assert b == tuple(int(v) for v in np.asarray(jb))
    want = np.asarray(jax.random.bits(jb, (300,)), np.int64)
    np.testing.assert_array_equal(prng.bits(b, 300, CPU).numpy(), want)
    with pytest.raises(ValueError, match="seed must be in"):
        prng.prng_key(-1)


def test_permutation_is_cached_per_seed_and_size():
    a = prng.permutation(11, 64, CPU)
    assert prng.permutation(11, 64, CPU) is a
    assert prng.permutation(12, 64, CPU) is not a


# -- the index build -------------------------------------------------------


@pytest.mark.parametrize("shape,classes", [((300,), 7), ((3, 128), 4),
                                           ((1, 9), 1)])
def test_segment_ranks_exact(shape, classes):
    lab = np.random.default_rng(1).integers(0, classes, shape).astype(np.int32)
    want = np.stack([np.asarray(js._segment_ranks(jnp.asarray(r)))
                     for r in lab.reshape(-1, shape[-1])]).reshape(shape)
    got = ts._segment_ranks(_t(lab).long())
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("iters,warm", [(1, False), (5, False), (2, True)])
def test_kmeans_matches_jax(iters, warm):
    rng = np.random.default_rng(2)
    y = rng.standard_normal((2, 200, 24)).astype(np.float32)
    init = rng.standard_normal((2, 8, 24)).astype(np.float32) if warm else None
    want = np.stack([np.asarray(js.kmeans(
        jnp.asarray(y[i]), 8, iters=iters, seed=4,
        init=None if init is None else jnp.asarray(init[i]))) for i in range(2)])
    got = ts.kmeans(_t(y), 8, iters=iters, seed=4,
                    init=None if init is None else _t(init))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cluster_index_members_match_jax():
    y = _clustered(3, 1, 150, 12)[0]
    cj, mj = js._cluster_index(jnp.asarray(y), n_clusters=6, cap=20, seed=1)
    ct, mt = ts._cluster_index(_t(y), n_clusters=6, cap=20, seed=1)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def test_default_cluster_params_match_jax():
    for args in [(196, None, None), (784, None, None), (16, None, None),
                 (16, 3, 3), (100, 200, 9), (49, 5, None)]:
        assert ts.default_cluster_params(*args) == js.default_cluster_params(*args)


# -- cluster_digc ------------------------------------------------------------

CLUSTER_CASES = [
    ("k5", dict(k=5)),
    ("probe3_dil2", dict(k=4, dilation=2, n_clusters=10, n_probe=3)),
    ("short_lists", dict(k=9, dilation=3, n_clusters=20, n_probe=2,
                         capacity_factor=1.0)),
    ("seed9", dict(k=3, n_clusters=6, n_probe=2, seed=9)),
]


@pytest.mark.parametrize("data", ["clustered", "random"])
@pytest.mark.parametrize("name,kw", CLUSTER_CASES, ids=[c[0] for c in CLUSTER_CASES])
def test_cluster_digc_cold_matches_jax(data, name, kw):
    if data == "clustered":
        x = _clustered(4, 3, 160, 16)
    else:
        x = np.random.default_rng(4).standard_normal((3, 160, 16)).astype(np.float32)
    ij, dj = js.cluster_digc(jnp.asarray(x), return_dists=True, **kw)
    it, dt = ts.cluster_digc(_t(x), return_dists=True, **kw)
    assert it.dtype == torch.int32 and it.shape == ij.shape
    _assert_like_jax(it, dt, ij, dj, exact=data == "clustered")
    k = kw["k"]
    rj = js.recall_vs_exact(jnp.asarray(x), jnp.asarray(x), ij, k)
    rt = ts.recall_vs_exact(_t(x), _t(x), it, k)
    assert abs(rt - rj) <= 0.01


def test_cluster_digc_unbatched_and_explicit_conodes():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((90, 12)).astype(np.float32)
    y = rng.standard_normal((120, 12)).astype(np.float32)
    ij, dj = js.cluster_digc(jnp.asarray(x), jnp.asarray(y), k=4,
                             return_dists=True)
    it, dt = ts.cluster_digc(_t(x), _t(y), k=4, return_dists=True)
    assert it.shape == (90, 4)
    _assert_like_jax(it, dt, ij, dj, exact=False)


def test_cluster_digc_shared_conodes_index_once():
    """(M, D) co-nodes beside (B, N, D) queries: one index, broadcast."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 50, 8)).astype(np.float32)
    y = _clustered(6, 1, 100, 8)[0]
    ij, dj, sj = js.cluster_digc(jnp.asarray(x), jnp.asarray(y), k=4,
                                 n_clusters=8, n_probe=3, return_dists=True,
                                 return_state=True)
    it, dt, st = ts.cluster_digc(_t(x), _t(y), k=4, n_clusters=8, n_probe=3,
                                 return_dists=True, return_state=True)
    _assert_like_jax(it, dt, ij, dj, exact=False)
    c = st["centroids"]
    assert c.shape == (3, 8, 8) and c.is_contiguous()
    np.testing.assert_array_equal(c[0].numpy(), c[2].numpy())
    np.testing.assert_allclose(c.numpy(), np.asarray(sj["centroids"]),
                               rtol=1e-5, atol=1e-5)


def _warm_inputs(seed=7, b=3):
    """Clustered frames and the next ones, each point moved by an integer
    step on a few axes (the drift a warm start follows)."""
    x1 = _clustered(seed, b, 128, 16)
    rng = np.random.default_rng(seed + 1)
    step = rng.integers(-1, 2, x1.shape) * (rng.random(x1.shape) < 0.2)
    return x1, (x1 + step).astype(np.float32)


WARM_KW = dict(k=4, n_clusters=8, n_probe=3, capacity_factor=2.0)


@pytest.mark.parametrize("valid", ["none", "true", "false", "rows"])
def test_cluster_digc_warm_start_matches_jax(valid):
    """Warm (init_valid True, or init_centroids alone), cold (False) and
    per-row mixed builds against JAX's ``lax.cond`` branches."""
    x1, x2 = _warm_inputs()
    _, sj = js.cluster_digc(jnp.asarray(x1), return_state=True, **WARM_KW)
    init = np.asarray(sj["centroids"])
    flag = {"none": None, "true": True, "false": False,
            "rows": np.array([True, False, True])}[valid]
    ij, dj, sj2 = js.cluster_digc(
        jnp.asarray(x2), init_centroids=jnp.asarray(init),
        init_valid=None if flag is None else jnp.asarray(flag),
        return_dists=True, return_state=True, **WARM_KW)
    before = tdigc.gate_reads()
    it, dt, st2 = ts.cluster_digc(
        _t(x2), init_centroids=_t(init),
        init_valid=None if flag is None else torch.as_tensor(flag),
        return_dists=True, return_state=True, **WARM_KW)
    assert tdigc.gate_reads() - before == (0 if flag is None else 1)
    _assert_like_jax(it, dt, ij, dj, exact=True)
    np.testing.assert_allclose(st2["centroids"].numpy(),
                               np.asarray(sj2["centroids"]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("flag", [True, False, [True, False, True],
                                  [True, True, True]])
@pytest.mark.parametrize("shared", [False, True])
def test_cluster_capture_branch_equals_read_branch(monkeypatch, flag, shared):
    """While a CUDA graph is captured the tier reads no flag: it builds
    warm and cold and selects, which gives the read branch's bits."""
    x1, x2 = _warm_inputs(9)
    y = _t(x1[0]) if shared else None
    _, _, st = ts.cluster_digc(_t(x1), y, return_dists=True, return_state=True,
                               **WARM_KW)
    init = st["centroids"]
    valid = torch.as_tensor(flag)

    def run():
        return ts.cluster_digc(_t(x2), y, init_centroids=init, init_valid=valid,
                               return_dists=True, return_state=True, **WARM_KW)

    i_read, d_read, s_read = run()
    monkeypatch.setattr(ts, "capturing", lambda t: True)
    before = tdigc.gate_reads()
    i_cap, d_cap, s_cap = run()
    assert tdigc.gate_reads() == before
    assert torch.equal(i_cap, i_read) and torch.equal(d_cap, d_read)
    assert torch.equal(s_cap["centroids"], s_read["centroids"])


def test_cluster_search_empty_nearest_cluster_clamps_pad_id():
    """A query whose nearest cluster is empty and whose probed clusters
    hold fewer than kd members: its BIG lanes read column 0 of the
    candidate list, the empty cluster's pad id M. JAX returns M there
    (its gather then reads row M - 1); the port returns M - 1, the row
    both aggregate. Every other lane is equal."""
    rng = np.random.default_rng(14)
    x = rng.standard_normal((5, 4)).astype(np.float32)
    y = rng.standard_normal((6, 4)).astype(np.float32)
    cents = np.stack([x.mean(0), y[:3].mean(0), y[3:].mean(0)]).astype(np.float32)
    members = np.array([[6, 6, 6], [0, 1, 2], [3, 4, 6]], np.int32)  # 6 = pad
    ij, dj = js._cluster_search(jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(cents), jnp.asarray(members),
                                kd=5, n_probe=2)
    it, dt = ts._cluster_search(_t(x)[None], _t(y)[None], _t(cents)[None],
                                _t(members).long()[None], kd=5, n_probe=2)
    ij, dj = np.asarray(ij), np.asarray(dj)
    big = dj >= BIG / 2
    assert (ij[big] == 6).any()  # the pad id JAX returns
    np.testing.assert_array_equal(it[0].numpy(), np.where(ij == 6, 5, ij))
    np.testing.assert_allclose(dt[0].numpy(), dj, rtol=1e-6, atol=1e-5)


# -- axial_digc ----------------------------------------------------------------

AXIAL_CASES = [(8, 8, 4, 1), (6, 10, 3, 2), (10, 6, 5, 1), (4, 4, 5, 2),
               (3, 5, 4, 3)]


@pytest.mark.parametrize("h,w,k,dil", AXIAL_CASES)
def test_axial_digc_matches_jax(h, w, k, dil):
    x = np.random.default_rng(h * w + k).standard_normal(
        (2, h * w, 8)).astype(np.float32)
    ij, dj = js.axial_digc(jnp.asarray(x), grid_h=h, grid_w=w, k=k,
                           dilation=dil, return_dists=True)
    it, dt = ts.axial_digc(_t(x), grid_h=h, grid_w=w, k=k, dilation=dil,
                           return_dists=True)
    assert it.dtype == torch.int32
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6, atol=1e-6)
    if k * dil > h + w:  # the lists were padded with index 0 at BIG
        assert (dt.numpy()[..., -1] == BIG).all()


def test_build_axial_pooled_fallback_and_grid_errors():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 16, 8)).astype(np.float32)
    y = rng.standard_normal((2, 4, 8)).astype(np.float32)
    spec = DigcSpec(impl="axial", k=3)
    jspec = jbuilder.DigcSpec(impl="axial", k=3)
    it, dt = ts._build_axial(_t(x), _t(y), None, spec)
    want = tdigc.digc_blocked(_t(x), _t(y), k=3, return_dists=True)
    assert torch.equal(it, want[0]) and torch.equal(dt, want[1])
    ij, _ = js._build_axial(jnp.asarray(x), jnp.asarray(y), None, jspec)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    x15 = rng.standard_normal((1, 15, 8)).astype(np.float32)
    for s, js_ in ((spec, jspec), (spec.replace(grid_w=4), jspec.replace(grid_w=4))):
        with pytest.raises(ValueError) as got:
            ts._build_axial(_t(x15), None, None, s)
        with pytest.raises(ValueError) as want:
            js._build_axial(jnp.asarray(x15), None, None, js_)
        assert str(got.value) == str(want.value)


# -- the registry and the stateful builder --------------------------------


@pytest.mark.parametrize("impl", ["cluster", "axial"])
def test_registry_entries_match_jax(impl):
    b, jb = builder.get_builder(impl), jbuilder.get_builder(impl)
    assert b.knobs == jb.knobs
    assert (b.exact, b.supports_state, b.supports_pad, b.supports_pos_bias,
            b.supports_causal) == (jb.exact, jb.supports_state,
                                   jb.supports_pad, jb.supports_pos_bias,
                                   jb.supports_causal)
    assert b.aggregate is None and builder.fallback_chain(impl) == (
        "blocked", "reference")
    x = torch.zeros(1, 16, 4)
    with pytest.raises(ValueError, match="does not support pad-node"):
        tdigc.digc(x, k=2, impl=impl, m_valid=torch.ones(16, dtype=torch.bool))


def test_digc_state_warm_start_matches_jax():
    """Cold then warm through ``digc(state=)``: centroids written, steps
    counted, the warm call a 2-iteration refinement, as in JAX."""
    x1, x2 = _warm_inputs(13, b=2)
    spec = DigcSpec(impl="cluster", k=4, n_clusters=8, n_probe=8,
                    capacity_factor=8.0)
    jspec = jbuilder.DigcSpec(impl="cluster", k=4, n_clusters=8, n_probe=8,
                              capacity_factor=8.0)
    st = DigcState.init({"s0": state_entry(centroids_shape=(2, 8, 16),
                                           device=CPU)})
    jst = JaxState.init({"s0": jax_state_entry(centroids_shape=(2, 8, 16))})
    for x in (x1, x2):
        i, st = tdigc.digc(_t(x), spec=spec, state=st, state_key="s0")
        ji, jst = jdigc_fn(jnp.asarray(x), spec=jspec, state=jst,
                           state_key="s0")
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(st.entries["s0"].centroids.numpy(),
                                   np.asarray(jst.entries["s0"].centroids),
                                   rtol=1e-5, atol=1e-5)
        assert ts.recall_vs_exact(_t(x), _t(x), i, 4) == js.recall_vs_exact(
            jnp.asarray(x), jnp.asarray(x), ji, 4)
    assert st.steps() == jst.steps() == {"s0": 2}


def test_cluster_rowwise_warm_gate_matches_b1_replay():
    """A batch mixing warm rows with a reset (cold) row gives each row
    what a B = 1 call with that row's own history gives."""
    x1, x2 = _warm_inputs(40)
    spec = DigcSpec(impl="cluster", k=4, n_clusters=4, n_probe=4,
                    capacity_factor=8.0)
    st = DigcState.init({"s": state_entry(centroids_shape=(3, 4, 16), rows=3,
                                          device=CPU)})
    _, st1 = tdigc.digc(_t(x1), spec=spec, state=st, state_key="s")
    i_mixed, st2 = tdigc.digc(_t(x2), spec=spec, state=st1.reset_rows([2]),
                              state_key="s")
    assert st2.row_steps() == {"s": [2, 2, 1]}

    def replay(row, warm):
        s = DigcState.init({"s": state_entry(centroids_shape=(1, 4, 16),
                                             rows=1, device=CPU)})
        if warm:
            _, s = tdigc.digc(_t(x1[row:row + 1]), spec=spec, state=s,
                              state_key="s")
        return tdigc.digc(_t(x2[row:row + 1]), spec=spec, state=s,
                          state_key="s")[0][0]

    for row, warm in ((0, True), (1, True), (2, False)):
        assert torch.equal(i_mixed[row], replay(row, warm)), row


def test_cluster_state_shape_mismatch_is_cold_and_safe():
    x = _warm_inputs(6, b=2)[0]
    spec = DigcSpec(impl="cluster", k=4, n_clusters=8, n_probe=8,
                    capacity_factor=8.0)
    st = DigcState.init({"s0": state_entry(centroids_shape=(2, 5, 16),
                                           device=CPU)})
    idx, st1 = tdigc.digc(_t(x), spec=spec, state=st, state_key="s0")
    assert st1.steps() == {"s0": 1}
    assert not st1.entries["s0"].centroids.any()  # untouched
    stateless = tdigc.digc(_t(x), spec=spec)
    assert torch.equal(idx, stateless)


def _vig_models(image_size=32):
    kw = dict(image_size=image_size, embed_dims=(16,), depths=(2,),
              num_classes=3, k=3, digc_impl="cluster")
    jcfg = jvig.VIG_VARIANTS["vig_ti_iso"].replace(**kw)
    cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(**kw)
    tree = jax.tree.map(np.asarray, jax_init_params(
        jvig.vig_param_spec(jcfg), jax.random.PRNGKey(0)))
    return jcfg, cfg, tree, convert.params_from_numpy(cfg, tree, device=CPU)


def test_vig_forward_state_roundtrip_matches_jax():
    """Two stateful ``vig_forward`` calls on the cluster tier: logits and
    centroids against JAX's, the warm start engaging on the second."""
    jcfg, cfg, tree, params = _vig_models()
    imgs = testing.images(1, 2, 32)
    imgs2 = (imgs + 0.1 * testing.images(2, 2, 32)).astype(np.float32)
    st = vig.init_vig_state(cfg, 2, "cluster", device=CPU)
    jst = jvig.init_vig_state(jcfg, 2, "cluster")
    cents = []
    for im in (imgs, imgs2):
        logits, st = vig.vig_forward(params, _t(im), cfg, state=st)
        jlogits, jst = jvig.vig_forward(tree, jnp.asarray(im), jcfg, state=jst)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4)
        c = st.entries["stage0"].centroids
        np.testing.assert_allclose(c.numpy(),
                                   np.asarray(jst.entries["stage0"].centroids),
                                   rtol=1e-4, atol=1e-4)
        cents.append(c)
    assert st.steps() == jst.steps() == {"stage0": 4}
    assert cents[0].abs().sum() > 0 and not torch.equal(*cents)
    back = convert.state_from_numpy(convert.state_to_numpy(st), device=CPU)
    assert torch.equal(back.entries["stage0"].centroids, cents[1])


def test_cluster_under_the_reuse_gate_matches_jax():
    """The cluster tier behind the drift-gated reuse gate (``tick``): the
    same gate decisions, cached graphs and logits as JAX over three
    stateful forwards of slowly drifting images."""
    jcfg, cfg, tree, params = _vig_models()
    knobs = dict(impl="cluster", k=3, reuse="tick", drift_tau=0.5,
                 max_stale=2)
    spec, jspec = DigcSpec(**knobs), jbuilder.DigcSpec(**knobs)
    st = vig.init_vig_state(cfg, 2, spec, per_slot=True, device=CPU)
    jst = jvig.init_vig_state(jcfg, 2, jspec, per_slot=True)
    img = testing.images(3, 2, 32)
    for t in range(3):
        im = (img + 0.001 * t * testing.images(4 + t, 2, 32)).astype(np.float32)
        logits, st = vig.vig_forward(params, _t(im), cfg, digc_impl=spec,
                                     state=st)
        jlogits, jst = jvig.vig_forward(tree, jnp.asarray(im), jcfg,
                                        digc_impl=jspec, state=jst)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4)
        e, je = st.entries["stage0"], jst.entries["stage0"]
        np.testing.assert_array_equal(e.graph_age.numpy(),
                                      np.asarray(je.graph_age))
        np.testing.assert_array_equal(e.graph_idx.numpy(),
                                      np.asarray(je.graph_idx))
    assert int(e.graph_age.max()) > 0  # the gate served cached graphs


@pytest.mark.parametrize("variant,impl,per_slot", [
    ("vig_ti_iso", "cluster", True), ("vig_ti_iso", "cluster", False),
    ("vig_ti_pyr", "cluster", False), ("vig_ti_pyr", "axial", False)])
def test_init_vig_state_centroid_buffers_match_jax(variant, impl, per_slot):
    kw = (dict(image_size=32, embed_dims=(16,), depths=(2,)) if variant ==
          "vig_ti_iso" else dict(image_size=32, embed_dims=(8, 12, 16, 24),
                                 depths=(1, 1, 1, 1)))
    cfg = vig.VIG_VARIANTS[variant].replace(num_classes=3, k=3, **kw)
    jcfg = jvig.VIG_VARIANTS[variant].replace(num_classes=3, k=3, **kw)
    st = vig.init_vig_state(cfg, 4, impl, per_slot=per_slot, device=CPU)
    jst = jvig.init_vig_state(jcfg, 4, impl, per_slot=per_slot)
    assert sorted(st.entries) == sorted(jst.entries)
    for key, e in st.entries.items():
        je = jst.entries[key]
        for f in ("centroids", "row_step"):
            got, want = getattr(e, f), getattr(je, f)
            assert (None if got is None else tuple(got.shape)) == (
                None if want is None else tuple(want.shape)), (key, f)


def test_init_vig_state_sizes_centroids_per_grid():
    cfg = _vig_models()[1]
    for grid in (4, 8, 12):
        st = vig.init_vig_state(cfg, 2, "cluster", grid=grid, device=CPU)
        nc, _ = ts.default_cluster_params(grid * grid, None, None)
        assert tuple(st.entries["stage0"].centroids.shape) == (2, nc, 16)


# -- ports of tests/test_strategies.py ----------------------------------------


def test_kmeans_reduces_quantization_error():
    rng = np.random.default_rng(0)
    y = _t(rng.standard_normal((256, 16)).astype(np.float32))
    c1 = ts.kmeans(y, 8, iters=1)
    c8 = ts.kmeans(y, 8, iters=8)

    def qerr(c):
        return float(((y[:, None] - c[None]) ** 2).sum(-1).min(1).values.mean())

    assert qerr(c8) <= qerr(c1) + 1e-5


def test_cluster_recall_improves_with_probes():
    x = _t(np.random.default_rng(1).standard_normal((400, 48)).astype(np.float32))
    i_lo = ts.cluster_digc(x, k=8, n_clusters=20, n_probe=2)
    i_hi = ts.cluster_digc(x, k=8, n_clusters=20, n_probe=16)
    r_lo = ts.recall_vs_exact(x, x, i_lo, 8)
    r_hi = ts.recall_vs_exact(x, x, i_hi, 8)
    assert r_hi > r_lo
    assert r_hi > 0.85


def test_cluster_full_probe_is_near_exact():
    x = _t(np.random.default_rng(2).standard_normal((200, 24)).astype(np.float32))
    idx = ts.cluster_digc(x, k=5, n_clusters=8, n_probe=8, capacity_factor=8.0)
    assert ts.recall_vs_exact(x, x, idx, 5) == 1.0


def test_cluster_clustered_data_high_recall_few_probes():
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((8, 24)) * 10
    pts = np.concatenate(
        [centers[i] + 0.1 * rng.standard_normal((50, 24)) for i in range(8)])
    x = _t(pts.astype(np.float32))
    idx = ts.cluster_digc(x, k=5, n_clusters=8, n_probe=2, capacity_factor=2.0)
    assert ts.recall_vs_exact(x, x, idx, 5) > 0.95


def test_axial_support_and_exactness_within_support():
    rng = np.random.default_rng(4)
    h, w, d, k = 8, 8, 16, 4
    xn = rng.standard_normal((h * w, d)).astype(np.float32)
    idx = ts.axial_digc(_t(xn), grid_h=h, grid_w=w, k=k).numpy()
    for i in range(h * w):
        r, c = divmod(i, w)
        for j in idx[i]:
            jr, jc = divmod(int(j), w)
            assert jr == r or jc == c, (i, j)
    for i in range(0, h * w, 7):
        r, c = divmod(i, w)
        support = [r * w + cc for cc in range(w)] + [rr * w + c for rr in range(h)]
        ds = {j: float(np.sum((xn[j] - xn[i]) ** 2)) for j in support}
        best = sorted(set(ds), key=lambda j: ds[j])[:k]
        got = sorted(idx[i].tolist(), key=lambda j: ds[int(j)])[:k]
        assert sorted(ds[j] for j in best) == pytest.approx(
            sorted(ds[int(j)] for j in got), rel=1e-5)


def test_axial_self_first():
    x = _t(np.random.default_rng(5).standard_normal((36, 8)).astype(np.float32))
    idx = ts.axial_digc(x, grid_h=6, grid_w=6, k=3)
    np.testing.assert_array_equal(idx[:, 0].numpy(), np.arange(36))


def test_vig_runs_with_all_strategies():
    cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(
        image_size=64, embed_dims=(32,), depths=(1,), num_classes=5, k=3)
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=CPU)
    imgs = _t(testing.images(1, 1, 64))
    for impl in ("blocked", "cluster", "axial"):
        out = vig.vig_forward(params, imgs, cfg, digc_impl=impl)
        assert out.shape == (1, 5)
        assert bool(torch.isfinite(out).all()), impl
