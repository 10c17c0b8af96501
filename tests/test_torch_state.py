"""The port's functional DIGC state (``repro_torch.core.state``) against
the JAX package's ``repro.core.state`` on the same numpy values: the row
lifecycle (take / put / reset) and its no-mutation contract, the crc32
fingerprints (equal to JAX's, byte for byte), ``rows_finite``, the
state's pass-through for stateless tiers, the blocked tier's frozen
gallery norms, ``init_vig_state``'s layout and ``vig_forward(state=)``.

Tolerances: indices equal up to the near-tie helper
(``repro_torch.testing``); distances and norms within fp32 rounding
(rtol 1e-5, atol 1e-4); logits within 1e-4 (fp32 sums reordered across
the network, as in test_torch_vig.py). Step counters and fingerprints
are integers and compared exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.digc import digc as jdigc  # noqa: E402
from repro.core.state import DigcState as JState  # noqa: E402
from repro.core.state import DigcStateEntry as JEntry  # noqa: E402
from repro.core.state import state_entry as jstate_entry  # noqa: E402
from repro.models import vig as jvig  # noqa: E402
from repro.models.module import init_params as jax_init_params  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.core import DigcSpec, digc  # noqa: E402
from repro_torch.core.state import (  # noqa: E402
    FIELDS,
    DigcState,
    DigcStateEntry,
    entry_row_finite,
    entry_row_fingerprint,
    prefetch_park_rows,
    state_entry,
)
from repro_torch.models import convert, vig  # noqa: E402

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-4


def jax_tree(state: JState) -> dict:
    """A JAX DigcState as the nested numpy arrays ``convert`` takes."""
    return {k: {f: None if getattr(e, f) is None else np.asarray(getattr(e, f))
                for f in FIELDS}
            for k, e in state.entries.items()}


def jax_state(tree: dict) -> JState:
    return JState.init({
        k: JEntry(**{f: None if v is None else jnp.asarray(v)
                     for f, v in fields.items()})
        for k, fields in tree.items()
    })


def _marked_tree(seed: int = 0) -> dict:
    """One entry with every row buffer, rows distinguishable."""
    rng = np.random.default_rng(seed)
    return {"s": {
        "step": np.int32(7),
        "centroids": rng.standard_normal((4, 2, 3)).astype(np.float32),
        "sq_y": rng.standard_normal((4, 5)).astype(np.float32),
        "row_step": np.array([3, 0, 2, 1], np.int32),
        "graph_idx": rng.integers(0, 5, (4, 6, 3)).astype(np.int32),
        "graph_dist": rng.standard_normal((4, 6, 3)).astype(np.float32),
        "graph_snap": rng.standard_normal(4).astype(np.float32),
        "graph_age": np.array([1, 0, 2, 3], np.int32),
    }}


def _assert_tree_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        for f in FIELDS:
            if a[k][f] is None or b[k][f] is None:
                assert a[k][f] is None and b[k][f] is None, (k, f)
            else:
                np.testing.assert_array_equal(a[k][f], b[k][f], err_msg=f)


# ---------------------------------------------------------------------------
# The value: functional updates and counters


def test_state_is_functional_and_counts():
    st = DigcState.init({"a": state_entry(centroids_shape=(1, 4, 8), device=CPU),
                         "b": state_entry(device=CPU)})
    st2 = st.set("b", st.entries["b"].bump())
    assert st.steps() == {"a": 0, "b": 0}  # original untouched
    assert st2.steps() == {"a": 0, "b": 1}
    assert st.get("missing") is None and st.get(None) is None
    assert len(st2) == 2
    e = state_entry(centroids_shape=(3, 2, 4), rows=3, device=CPU)
    assert not bool(e.warm) and bool(e.bump().warm)
    assert not e.row_warm.any() and e.bump().row_warm.all()
    assert e.bump().row_step.tolist() == [1, 1, 1]
    assert state_entry(device=CPU).row_step is None
    assert state_entry(device=CPU).row_warm is None


@pytest.mark.parametrize("kw", [
    dict(centroids_shape=(3, 2, 4), rows=3),
    dict(sq_y_shape=(2, 9), graph_shape=(2, 5, 3)),
    dict(graph_shape=(4, 6, 2), rows=4),
])
def test_state_entry_layout_matches_jax(kw):
    got = convert.state_to_numpy(DigcState.init({"e": state_entry(**kw, device=CPU)}))
    want = jax_tree(JState.init({"e": jstate_entry(**kw)}))
    _assert_tree_equal(got, want)
    for f in FIELDS:
        if want["e"][f] is not None:
            assert got["e"][f].dtype == want["e"][f].dtype, f


def test_state_entry_rejects_a_mesh_and_a_missing_card():
    # a mesh without the placement axis is refused with JAX's message
    from repro_torch.launch.mesh import abstract_mesh

    with pytest.raises(ValueError, match="not an axis"):
        state_entry(sq_y_shape=(1, 8), mesh=abstract_mesh((1,), ("data",)),
                    axis_name="ring", device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            state_entry()


# ---------------------------------------------------------------------------
# Row lifecycle against JAX


def test_row_lifecycle_take_put_reset_matches_jax():
    """Gather slot rows into a bucket (repeats are padding lanes), write
    the served rows back (padding dropped), cold-reset a reassigned slot:
    every step equal to JAX's, and no input ever mutated."""
    tree = _marked_tree()
    st = convert.state_from_numpy(tree, device=CPU)
    jst = jax_state(tree)
    lanes, rows = [2, 0], [2, 0, 2, 2]

    bucket = st.take_rows(rows)
    jbucket = jst.take_rows(rows)
    _assert_tree_equal(convert.state_to_numpy(bucket), jax_tree(jbucket))
    # take_rows copies: writing the taken rows leaves the source alone
    for f in FIELDS:
        v = getattr(bucket.entries["s"], f)
        assert v.data_ptr() != getattr(st.entries["s"], f).data_ptr()
    bucket.entries["s"].centroids.add_(1.0)
    bucket.entries["s"].step.add_(1)
    _assert_tree_equal(convert.state_to_numpy(st), tree)

    bucket = st.take_rows(rows)
    b = bucket.entries["s"]
    served = bucket.set("s", b.bump(centroids=b.centroids + 100.0,
                                    graph_age=b.graph_age + 1))
    jb = jbucket.entries["s"]
    jserved = jbucket.set("s", jb.bump(centroids=jb.centroids + 100.0,
                                       graph_age=jb.graph_age + 1))
    back = st.put_rows(served, lanes)
    jback = jst.put_rows(jserved, lanes)
    _assert_tree_equal(convert.state_to_numpy(back), jax_tree(jback))
    a = back.entries["s"]
    assert a.row_step.tolist() == [4, 0, 3, 1] and int(a.step) == 8
    for s in (1, 3):  # padding lanes dropped: untouched slots identical
        np.testing.assert_array_equal(a.centroids[s].numpy(),
                                      tree["s"]["centroids"][s])
        np.testing.assert_array_equal(a.graph_idx[s].numpy(),
                                      tree["s"]["graph_idx"][s])

    reset = back.reset_rows([0])
    jreset = jback.reset_rows([0])
    _assert_tree_equal(convert.state_to_numpy(reset), jax_tree(jreset))
    assert reset.row_steps() == jreset.row_steps() == {"s": [0, 0, 3, 1]}
    # none of the operations wrote into its input
    _assert_tree_equal(convert.state_to_numpy(st), tree)
    _assert_tree_equal(convert.state_to_numpy(back), jax_tree(jback))


def test_state_conversion_round_trip():
    tree = _marked_tree(1)
    jst = jax_state(tree)
    st = convert.state_from_numpy(jax_tree(jst), device=CPU)
    _assert_tree_equal(jax_tree(jax_state(convert.state_to_numpy(st))), tree)
    with pytest.raises(ValueError, match="fields"):
        convert.state_from_numpy({"s": {"step": np.int32(0), "bogus": None}},
                                 device=CPU)


# ---------------------------------------------------------------------------
# Integrity guards


def test_fingerprints_equal_jax_for_converted_state():
    from repro.core.state import entry_row_fingerprint as jfp

    tree = _marked_tree(2)
    st = convert.state_from_numpy(tree, device=CPU)
    jst = jax_state(tree)
    rows = [0, 1, 2, 3]
    assert st.row_fingerprints(rows) == jst.row_fingerprints(rows)
    for r in rows:
        assert (entry_row_fingerprint(st.entries["s"], r)
                == jfp(jst.entries["s"], r))
    # one flipped bit in one row changes that row's token only
    flipped = st.entries["s"].graph_idx.clone()
    flipped[2, 0, 0] ^= 1
    bad = st.set("s", DigcStateEntry(**{**{f: getattr(st.entries["s"], f)
                                            for f in FIELDS},
                                         "graph_idx": flipped}))
    before, after = st.row_fingerprints(rows)["s"], bad.row_fingerprints(rows)["s"]
    assert [before[r] == after[r] for r in rows] == [True, True, False, True]


def test_rows_finite_matches_jax():
    from repro.core.state import entry_row_finite as jfinite

    tree = _marked_tree(3)
    tree["s"]["graph_dist"][1, 2, 0] = np.nan
    tree["s"]["sq_y"][3, 0] = np.inf
    st = convert.state_from_numpy(tree, device=CPU)
    jst = jax_state(tree)
    rows = [0, 1, 2, 3]
    assert st.rows_finite(rows) == jst.rows_finite(rows) == {
        0: True, 1: False, 2: True, 3: False}
    for r in rows:
        assert entry_row_finite(st.entries["s"], r) == jfinite(jst.entries["s"], r)


def test_prefetch_park_rows_keeps_structure_and_values():
    tree = _marked_tree(4)
    host = convert.state_from_numpy(tree, device=CPU).take_rows([1])
    for parked in (host, {224: host}):
        out = prefetch_park_rows(parked, CPU)
        assert type(out) is type(parked)
        got = out if isinstance(out, DigcState) else out[224]
        _assert_tree_equal(convert.state_to_numpy(got),
                           convert.state_to_numpy(host))


# ---------------------------------------------------------------------------
# digc(..., state=)


@pytest.mark.parametrize("impl", ["reference", "cuda"])
def test_state_passes_through_stateless_tiers(impl):
    """A builder without state (reference; the cuda tier, whose plain
    version runs on the CPU) returns the state unchanged: the same
    entries, step 0, and indices equal to the stateless call's."""
    x = torch.from_numpy(testing.features(0, 2, 20, 6))
    st = DigcState.init({"k0": state_entry(rows=2, graph_shape=(2, 20, 3),
                                           device=CPU)})
    idx, new = digc(x, k=3, impl=impl, state=st, state_key="k0")
    assert new.entries["k0"] is st.entries["k0"]
    assert new.steps() == {"k0": 0}
    assert torch.equal(idx, digc(x, k=3, impl=impl))
    jidx, jnew = jdigc(jnp.asarray(x.numpy()), k=3, impl="reference",
                       state=JState.init({"k0": jstate_entry()}),
                       state_key="k0")
    assert jnew.steps() == {"k0": 0}
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_state_missing_entry_passes_through():
    x = torch.from_numpy(testing.features(1, 2, 20, 6))
    idx, new = digc(x, k=3, impl="blocked", state=DigcState.init({}),
                    state_key="k0")
    assert len(new) == 0
    assert torch.equal(idx, digc(x, k=3, impl="blocked"))


def test_blocked_gallery_norms_exact_and_counted():
    """Frozen-gallery norms: exact indices on every call, sq_y filled on
    the cold call and carried, the step counting calls; as in JAX."""
    x, y = testing.features(3, 2, 40, 8), testing.features(4, 2, 64, 8)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    ref_i, ref_d = digc(tx, ty, k=5, impl="reference", return_dists=True)
    st = DigcState.init({"gal": state_entry(sq_y_shape=(2, 64), device=CPU)})
    jst = JState.init({"gal": jstate_entry(sq_y_shape=(2, 64))})
    for _ in range(2):
        i, d, st = digc(tx, ty, k=5, impl="blocked", return_dists=True,
                        state=st, state_key="gal")
        ji, jst = jdigc(jnp.asarray(x), jnp.asarray(y), k=5, impl="blocked",
                        state=jst, state_key="gal")
        testing.assert_topk_match(i.numpy(), d.numpy(), ref_i.numpy(),
                                  ref_d.numpy(), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert st.steps() == jst.steps() == {"gal": 2}
    np.testing.assert_allclose(st.entries["gal"].sq_y.numpy(),
                               np.asarray(jst.entries["gal"].sq_y), rtol=1e-6)


def test_blocked_gallery_norms_warm_branch_engages():
    """A warm entry seeded with wrong norms must change the distances:
    proof the warm branch reads the carried norms."""
    x = torch.from_numpy(testing.features(5, 1, 24, 4))
    y = torch.from_numpy(testing.features(6, 1, 32, 4))
    wrong = torch.linspace(100.0, 1000.0, 32)[None]
    warm = DigcStateEntry(step=torch.ones((), dtype=torch.int32), sq_y=wrong)
    _, d_warm, _ = digc(x, y, k=3, impl="blocked", return_dists=True,
                        state=DigcState.init({"g": warm}), state_key="g")
    _, d_true = digc(x, y, k=3, impl="blocked", return_dists=True)
    assert not torch.allclose(d_warm, d_true)


def test_blocked_rowwise_gallery_norms_exact_after_reset():
    """Per-row counters: warm rows read their carried norms, a reset row
    recomputes its own; indices stay exact and equal JAX's."""
    x, y = testing.features(41, 2, 20, 6), testing.features(42, 2, 32, 6)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    st = DigcState.init({"g": state_entry(sq_y_shape=(2, 32), rows=2,
                                          device=CPU)})
    jst = JState.init({"g": jstate_entry(sq_y_shape=(2, 32), rows=2)})
    i1, st = digc(tx, ty, k=3, impl="blocked", state=st, state_key="g")
    ji1, jst = jdigc(jnp.asarray(x), jnp.asarray(y), k=3, impl="blocked",
                     state=jst, state_key="g")
    i2, st = digc(tx, ty, k=3, impl="blocked", state=st.reset_rows([0]),
                  state_key="g")
    ji2, jst = jdigc(jnp.asarray(x), jnp.asarray(y), k=3, impl="blocked",
                     state=jst.reset_rows([0]), state_key="g")
    ref = digc(tx, ty, k=3, impl="reference")
    for i, ji in ((i1, ji1), (i2, ji2)):
        assert torch.equal(i, ref)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert st.row_steps() == jst.row_steps() == {"g": [1, 2]}
    np.testing.assert_allclose(st.entries["g"].sq_y.numpy(),
                               (y * y).sum(-1), rtol=1e-6)


# ---------------------------------------------------------------------------
# init_vig_state and vig_forward(state=)


def _cfgs(name: str, **kw):
    return (jvig.VIG_VARIANTS[name].replace(**kw),
            vig.VIG_VARIANTS[name].replace(**kw))


@pytest.mark.parametrize("name,kw", [
    ("vig_ti_iso", dict(image_size=32, embed_dims=(16,), depths=(2,),
                        num_classes=3, k=3)),
    ("vig_ti_pyr", dict(image_size=32, embed_dims=(8, 12, 16, 24),
                        depths=(1, 1, 1, 1), num_classes=3, k=3)),
])
@pytest.mark.parametrize("reuse", [None, "tick"])
@pytest.mark.parametrize("per_slot", [False, True])
def test_init_vig_state_layout_matches_jax(name, kw, reuse, per_slot):
    """One entry per stage: counters, per-slot rows when asked, and the
    stale-graph buffers sized by each stage's first block under a reuse
    policy; every shape and dtype as JAX allocates them."""
    jcfg, cfg = _cfgs(name, **kw)
    spec = DigcSpec(impl="blocked", reuse=reuse)
    jspec = jvig.DigcSpec(impl="blocked", reuse=reuse)
    st = vig.init_vig_state(cfg, 4, spec, per_slot=per_slot, device=CPU)
    jst = jvig.init_vig_state(jcfg, 4, jspec, per_slot=per_slot)
    _assert_tree_equal(convert.state_to_numpy(st), jax_tree(jst))
    assert sorted(st.entries) == [f"stage{i}" for i in range(len(cfg.depths))]
    if reuse is not None:
        for plan in vig.vig_stage_plans(cfg, spec):
            assert tuple(st.entries[plan.key].graph_idx.shape) == (
                4, plan.n, plan.k_effs[0])


def test_init_vig_state_takes_only_the_native_grid():
    """Any grid the stage plans accept (the native one and off-native
    ones) sizes the state as JAX's ``init_vig_state(grid=)`` does; a grid
    the plans refuse raises the same ``VigGridError``."""
    jcfg, cfg = _cfgs("vig_ti_iso", image_size=32, patch=4, embed_dims=(16,),
                      depths=(2,), num_classes=3, k=3)
    spec = DigcSpec(impl="blocked", reuse="tick")
    jspec = jvig.DigcSpec(impl="blocked", reuse="tick")
    for grid in (cfg.base_grid, cfg.base_grid * 2, cfg.base_grid - 2):
        st = vig.init_vig_state(cfg, 2, spec, per_slot=True, grid=grid,
                                device=CPU)
        jst = jvig.init_vig_state(jcfg, 2, jspec, per_slot=True, grid=grid)
        _assert_tree_equal(convert.state_to_numpy(st), jax_tree(jst))
    pjcfg, pcfg = _cfgs("vig_ti_pyr", image_size=32, embed_dims=(8, 12, 16, 24),
                        depths=(1, 1, 1, 1), num_classes=3, k=3)
    with pytest.raises(jvig.VigGridError) as want:
        jvig.init_vig_state(pjcfg, 1, grid=10)
    with pytest.raises(vig.VigGridError) as got:
        vig.init_vig_state(pcfg, 1, grid=10, device=CPU)
    assert str(got.value) == str(want.value)


def test_vig_forward_state_exact_tier_matches_stateless_and_jax():
    """For the exact blocked tier the state is observationally inert:
    state-threaded logits equal the stateless ones bit for bit, and JAX's
    within 1e-4; the counters count blocks x requests in both."""
    jcfg, cfg = _cfgs("vig_ti_iso", image_size=32, embed_dims=(16,),
                      depths=(2,), num_classes=3, k=3)
    tree = jax.tree.map(np.asarray, jax_init_params(
        jvig.vig_param_spec(jcfg), jax.random.PRNGKey(0)))
    params = convert.params_from_numpy(cfg, tree, device=CPU)
    imgs = testing.images(1, 2, 32)
    st = vig.init_vig_state(cfg, 2, "blocked", device=CPU)
    jst = jvig.init_vig_state(jcfg, 2, "blocked")
    base = vig.vig_forward(params, torch.from_numpy(imgs), cfg,
                           digc_impl="blocked")
    for _ in range(2):
        logits, st = vig.vig_forward(params, torch.from_numpy(imgs), cfg,
                                     digc_impl="blocked", state=st)
        jlogits, jst = jvig.vig_forward(tree, jnp.asarray(imgs), jcfg,
                                        digc_impl="blocked", state=jst)
        assert torch.equal(logits, base)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4)
    assert st.steps() == jst.steps() == {"stage0": 4}
    # the module form threads the same state
    model = vig.Vig(cfg, params, digc_impl="blocked", device=CPU)
    out, st2 = model(torch.from_numpy(imgs),
                     state=vig.init_vig_state(cfg, 2, "blocked", device=CPU))
    assert torch.equal(out, base) and st2.steps() == {"stage0": 2}
    assert torch.equal(model(torch.from_numpy(imgs)), base)
