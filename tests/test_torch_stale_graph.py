"""Stale-graph serving in the port: the drift-gated reuse gate of
``repro_torch.core.digc``, the reuse search ``tune_reuse`` and
``VigSchedule.with_reuse``, against the JAX package on the same numpy
inputs.

* Identity: ``drift_tau=0`` is bit for bit ``reuse`` off, at the
  ``digc`` level and through the model.
* Engagement: a warm entry seeded with a corrupted cached graph is served
  when the gate reuses and hidden when drift or the staleness bound
  forces a rebuild.
* Per-row independence: co-batched rows gate on their own, each equal to
  its B = 1 replay.
* Parity with JAX: the same ``graph_age`` and reuse decisions on one
  drifting stream, the same ``ReuseTuneResult``s on one captured trace,
  the same ``overlap`` outputs. The two packages sum ``drift_stat`` in
  other orders (ulps apart), so these streams keep every drift at least
  10% away from tau.

Tolerances: indices equal (the streams are seeded normal features with
no fp32 near-tie in their top-k), logits within 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import builder as jbuilder  # noqa: E402
from repro.core import tuner as jtuner  # noqa: E402
from repro.core.digc import digc as jdigc  # noqa: E402
from repro.core.state import DigcState as JState  # noqa: E402
from repro.core.state import DigcStateEntry as JEntry  # noqa: E402
from repro.core.state import state_entry as jstate_entry  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.core import DigcSpec, builder, digc  # noqa: E402
from repro_torch.core.digc import drift_stat, gate_reads, reset_gate_reads  # noqa: E402
from repro_torch.core.state import DigcState, state_entry  # noqa: E402
from repro_torch.core.tuner import DigcTuner, TileConfig, VigSchedule, tune_reuse  # noqa: E402
from repro_torch.models import convert, vig  # noqa: E402

CPU = "cpu"


def _spec(**kw):
    return DigcSpec(impl="blocked", k=3, **kw)


def _jspec(**kw):
    return jbuilder.DigcSpec(impl="blocked", k=3, **kw)


def _stream(spec, xs, entry, reuse_first=True):
    """Stateful digc over a list of (B, N, D) arrays: per-call indices and
    the state after each call."""
    st = DigcState.init({"g": entry})
    outs, states = [], []
    for x in xs:
        idx, st = digc(torch.from_numpy(x), spec=spec, state=st,
                       state_key="g", reuse_first=reuse_first)
        outs.append(idx.numpy())
        states.append(st)
    return outs, states


def _jstream(spec, xs, entry, reuse_first=True):
    st = JState.init({"g": entry})
    fn = jax.jit(lambda a, s: jdigc(a, spec=spec, state=s, state_key="g",
                                    reuse_first=reuse_first))
    outs, states = [], []
    for x in xs:
        idx, st = fn(jnp.asarray(x), st)
        outs.append(np.asarray(idx))
        states.append(st)
    return outs, states


def _drifting(seed, b, n, d, ticks, scale):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((b, n, d)).astype(np.float32)]
    for _ in range(ticks - 1):
        xs.append((xs[-1] + scale * rng.standard_normal((b, n, d)))
                  .astype(np.float32))
    return xs


# ---------------------------------------------------------------------------
# The knobs: validate and the ladder


@pytest.mark.parametrize("knobs", [
    dict(reuse="sometimes"),
    dict(reuse="layer", drift_tau=-0.1),
    dict(reuse="layer", max_stale=0),
    dict(drift_tau=0.05),  # a gate threshold without a gate
    dict(reuse="off", max_stale=4),
])
def test_validate_rejects_bad_reuse_knobs(knobs):
    """The same ValueError, message for message, as the JAX package."""
    x = np.zeros((1, 8, 4), np.float32)
    with pytest.raises(ValueError) as got:
        digc(torch.from_numpy(x), spec=_spec(**knobs))
    with pytest.raises(ValueError) as want:
        jdigc(jnp.asarray(x), spec=_jspec(**knobs))
    assert str(got.value) == str(want.value)


def test_stateless_kernel_tier_rejects_reuse_and_ladder_drops_it():
    x = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="does not accept knob"):
        digc(x, spec=DigcSpec(impl="cuda", k=3, reuse="layer"))
    assert not builder.get_builder("cuda").supports_state
    deg = builder.degraded_spec(_spec(reuse="tick", drift_tau=0.1,
                                      max_stale=2), "reference")
    assert (deg.reuse, deg.drift_tau, deg.max_stale) == (None, None, None)
    assert builder.reuse_params(_spec()) == jbuilder.reuse_params(_jspec())
    assert builder.REUSE_POLICIES == jbuilder.REUSE_POLICIES


# ---------------------------------------------------------------------------
# Identity: drift_tau = 0 is reuse off, bit for bit


@pytest.mark.parametrize("policy", ["layer", "tick"])
@pytest.mark.parametrize("rows", [None, 2])
def test_tau_zero_bit_identical_to_off(policy, rows):
    b, n, d = 2, 24, 8
    xs = _drifting(0, b, n, d, 4, 0.05)
    off, _ = _stream(_spec(), xs, state_entry(graph_shape=(b, n, 3),
                                              rows=rows, device=CPU))
    reset_gate_reads()
    zero, states = _stream(_spec(reuse=policy, drift_tau=0.0), xs,
                           state_entry(graph_shape=(b, n, 3), rows=rows,
                                       device=CPU))
    assert gate_reads() == 0  # the static short-circuit: no gate ran
    for a, c in zip(off, zero):
        np.testing.assert_array_equal(a, c)
    joff, _ = _jstream(_jspec(), xs, jstate_entry(graph_shape=(b, n, 3)))
    for a, c in zip(off, joff):
        np.testing.assert_array_equal(a, c)


def test_tau_zero_bit_identical_at_model_level():
    kw = dict(image_size=16, patch=4, embed_dims=(16,), depths=(2,),
              num_classes=3, k=3)
    cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(**kw)
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=CPU)
    imgs = [torch.from_numpy(testing.images(s, 1, 16)) for s in (1, 2)]

    def run(spec):
        state = vig.init_vig_state(cfg, 1, spec, device=CPU)
        outs = []
        for im in imgs:
            logits, state = vig.vig_forward(params, im, cfg, digc_impl=spec,
                                            state=state)
            outs.append(logits)
        return outs

    for a, c in zip(run(_spec()), run(_spec(reuse="layer", drift_tau=0.0))):
        assert torch.equal(a, c)


# ---------------------------------------------------------------------------
# Engagement proofs with a corrupted cached graph


def _corrupt(exact, snap, age, rows=None):
    """A warm entry whose cached graph is the exact one rolled by one
    neighbour: served output equal to it proves the cache was read."""
    corrupt = np.roll(exact, 1, axis=-1).astype(np.int32)
    b = exact.shape[0]
    tree = {"step": np.int32(1), "graph_idx": corrupt,
            "graph_dist": np.zeros(corrupt.shape, np.float32),
            "graph_snap": np.asarray(snap, np.float32),
            "graph_age": np.full((b,), age, np.int32)}
    if rows is not None:
        tree["row_step"] = np.ones((b,), np.int32)
    port = convert.state_from_numpy({"g": tree}, device=CPU)
    jax_st = JState.init({"g": JEntry(**{f: jnp.asarray(v)
                                          for f, v in tree.items()})})
    return port, jax_st, corrupt


@pytest.mark.parametrize("rows", [None, 2])
@pytest.mark.parametrize("case,snap_scale,age,served", [
    ("serve", 1.0, 0, True),          # zero drift, fresh: cache served
    ("drift", 10.0, 0, False),        # forced drift: rebuild
    ("expiry", 1.0, 4, False),        # age at the bound: rebuild
])
def test_gate_serves_corrupt_cache_or_rebuilds(rows, case, snap_scale, age,
                                               served):
    x = testing.features(2, 2, 24, 8)
    spec = _spec(reuse="layer", drift_tau=0.05, max_stale=4)
    exact = digc(torch.from_numpy(x), spec=_spec()).numpy()
    snap = drift_stat(torch.from_numpy(x)).numpy() * snap_scale
    port, jst, corrupt = _corrupt(exact, snap, age, rows)
    idx, st = digc(torch.from_numpy(x), spec=spec, state=port, state_key="g")
    jidx, jst2 = jdigc(jnp.asarray(x), spec=_jspec(reuse="layer",
                                                   drift_tau=0.05,
                                                   max_stale=4),
                       state=jst, state_key="g")
    np.testing.assert_array_equal(idx.numpy(), corrupt if served else exact)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    e, je = st.entries["g"], jst2.entries["g"]
    np.testing.assert_array_equal(e.graph_age.numpy(), np.asarray(je.graph_age))
    np.testing.assert_array_equal(e.graph_idx.numpy(), np.asarray(je.graph_idx))
    if not served:  # the rebuild repaired the cache and reset the age
        np.testing.assert_array_equal(e.graph_idx.numpy(), exact)
        assert not e.graph_age.any()


def test_max_stale_expiry_cycles_age():
    """Identical inputs, max_stale 2: build, reuse twice, rebuild."""
    x = testing.features(3, 1, 24, 8)
    spec = _spec(reuse="layer", drift_tau=0.05, max_stale=2)
    _, states = _stream(spec, [x] * 6, state_entry(graph_shape=(1, 24, 3),
                                                   device=CPU))
    assert [int(s.entries["g"].graph_age[0]) for s in states] == [0, 1, 2, 0, 1, 2]


@pytest.mark.parametrize("seed,max_stale", [(0, 1), (1, 2), (2, 3), (3, 2)])
def test_reuse_never_serves_older_than_max_stale(seed, max_stale):
    """Under random drift (none, small or large each tick), no row's
    cached graph ages past the staleness bound."""
    rng = np.random.default_rng(seed)
    spec = _spec(reuse="layer", drift_tau=0.1, max_stale=max_stale)
    st = DigcState.init({"g": state_entry(graph_shape=(2, 16, 3), device=CPU)})
    x = rng.standard_normal((2, 16, 4)).astype(np.float32)
    for _ in range(6):
        x = (x + float(rng.choice([0.0, 0.01, 1.0]))
             * rng.standard_normal(x.shape)).astype(np.float32)
        _, st = digc(torch.from_numpy(x), spec=spec, state=st, state_key="g")
        assert int(st.entries["g"].graph_age.max()) <= max_stale


def test_per_row_gate_matches_solo_replay():
    """Row 2 churns every tick while rows 0 and 1 hold still: the batched
    stream serves rows 0/1 from cache and rebuilds row 2, each equal to
    its own B = 1 replay, one host read per gated call."""
    rng = np.random.default_rng(4)
    n, d = 24, 8
    hold = rng.standard_normal((2, n, d)).astype(np.float32)
    xs = [np.concatenate([hold, rng.standard_normal((1, n, d))
                          .astype(np.float32)]) for _ in range(4)]
    spec = _spec(reuse="layer", drift_tau=0.05, max_stale=8)
    reset_gate_reads()
    batched, states = _stream(spec, xs, state_entry(graph_shape=(3, n, 3),
                                                    rows=3, device=CPU))
    assert gate_reads() == len(xs)
    for row in range(3):
        solo, _ = _stream(spec, [x[row:row + 1] for x in xs],
                          state_entry(graph_shape=(1, n, 3), rows=1,
                                      device=CPU))
        for t in range(4):
            np.testing.assert_array_equal(batched[t][row], solo[t][0])
    assert states[-1].entries["g"].graph_age.tolist() == [3, 3, 0]


# ---------------------------------------------------------------------------
# Parity with JAX on drifting streams


@pytest.mark.parametrize("policy", ["layer", "tick"])
def test_graph_age_and_reuse_sequence_match_jax(policy):
    """One drifting stream, per-row counters, a reset mid-stream: the
    served indices and every state buffer equal JAX's at every call. The
    drift per tick alternates between ~2% and ~40% of |x|^2 (tau 0.1)."""
    b, n, d = 3, 24, 8
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal((b, n, d)).astype(np.float32)]
    for t in range(7):
        scale = 0.01 if t % 3 else 0.6
        xs.append((xs[-1] * (1.0 + scale)).astype(np.float32))
    spec = _spec(reuse=policy, drift_tau=0.1, max_stale=3)
    jspec = _jspec(reuse=policy, drift_tau=0.1, max_stale=3)
    st = DigcState.init({"g": state_entry(graph_shape=(b, n, 3), rows=b,
                                          device=CPU)})
    jst = JState.init({"g": jstate_entry(graph_shape=(b, n, 3), rows=b)})
    ages = []
    for t, x in enumerate(xs):
        if t == 4:
            st, jst = st.reset_rows([1]), jst.reset_rows([1])
        first = policy == "layer" or t % 2 == 0
        idx, st = digc(torch.from_numpy(x), spec=spec, state=st,
                       state_key="g", reuse_first=first)
        jidx, jst = jdigc(jnp.asarray(x), spec=jspec, state=jst,
                          state_key="g", reuse_first=first)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        e, je = st.entries["g"], jst.entries["g"]
        for f in ("graph_idx", "graph_age", "row_step"):
            np.testing.assert_array_equal(getattr(e, f).numpy(),
                                          np.asarray(getattr(je, f)), err_msg=f)
        np.testing.assert_allclose(e.graph_snap.numpy(),
                                   np.asarray(je.graph_snap), rtol=1e-6)
        ages.append(e.graph_age.tolist())
    assert any(a > 0 for row in ages for a in row)  # reuse happened
    assert ages[4][1] == 0  # the reset row rebuilt


def test_overlap_policy_matches_jax():
    """``overlap`` serves the previous call's graph to warm rows (cold
    rows build) and refreshes the cache every call; equal to JAX's."""
    b, n, d = 2, 24, 8
    xs = _drifting(8, b, n, d, 4, 0.3)
    spec = _spec(reuse="overlap")
    outs, states = _stream(spec, xs, state_entry(graph_shape=(b, n, 3),
                                                 rows=b, device=CPU))
    jouts, jstates = _jstream(_jspec(reuse="overlap"), xs,
                              jstate_entry(graph_shape=(b, n, 3), rows=b))
    exact = [digc(torch.from_numpy(x), spec=_spec()).numpy() for x in xs]
    np.testing.assert_array_equal(outs[0], exact[0])  # cold: built
    for t in range(1, len(xs)):
        np.testing.assert_array_equal(outs[t], exact[t - 1])  # one call stale
        np.testing.assert_array_equal(states[t].entries["g"].graph_idx.numpy(),
                                      exact[t])  # refreshed
    for a, c in zip(outs, jouts):
        np.testing.assert_array_equal(a, c)
    assert all(not s.entries["g"].graph_age.any() for s in states)


# ---------------------------------------------------------------------------
# The reuse search


def _trace(seed, ticks, drift, n=24, d=8):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((1, n, d)).astype(np.float32)
    out = []
    for _ in range(ticks):
        h = (h + drift * rng.standard_normal(h.shape)).astype(np.float32)
        out.append(h)
    return out


def _both(hs, key="s0"):
    return ([[(key, torch.from_numpy(h), None)] for h in hs],
            [[(key, jnp.asarray(h), None)] for h in hs])


@pytest.mark.parametrize("policy", ["layer", "tick", "overlap"])
@pytest.mark.parametrize("drift,taus", [
    (0.0, (0.02, 0.1)),
    (2.0, (10.0,)),
    (0.05, (0.001, 0.3)),
])
def test_tune_reuse_matches_jax(policy, drift, taus):
    """The same ``ReuseTuneResult``s and tuned spec as JAX on one trace
    (taus chosen far from every tick's drift)."""
    hs = _trace(9, 6, drift)
    stats = [float(drift_stat(torch.from_numpy(h))[0]) for h in hs]
    rel = [abs(b - a) / a for a, b in zip(stats, stats[1:])]
    for tau in taus:
        assert all(abs(r - tau) > 0.1 * tau for r in rel), (rel, tau)
    ticks, jticks = _both(hs)
    tuned, results = tune_reuse(ticks, spec=_spec(), policy=policy, taus=taus,
                                max_stale=3, recall_floor=0.95)
    jtuned, jresults = jtuner.tune_reuse(jticks, spec=_jspec(), policy=policy,
                                         taus=taus, max_stale=3,
                                         recall_floor=0.95)
    assert [r.as_dict() for r in results] == [r.as_dict() for r in jresults]
    assert ((tuned.reuse, tuned.drift_tau, tuned.max_stale)
            == (jtuned.reuse, jtuned.drift_tau, jtuned.max_stale))


def test_tune_reuse_on_captured_vig_trace_matches_jax():
    """Features captured from the port's ViG forward on a video-like
    stream (frame t + 1 = frame t + N(0, 0.02^2) noise), fed to both
    searches: the same results, at taus 10% or more away from the
    relative drift of any two captured calls of the stage."""
    kw = dict(image_size=16, patch=4, embed_dims=(16,), depths=(2,),
              num_classes=3, k=3)
    cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(**kw)
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=CPU)
    rng = np.random.default_rng(11)
    frame = testing.images(11, 2, 16)
    ticks = []
    for _ in range(4):
        cap: list = []
        vig.vig_forward(params, torch.from_numpy(frame), cfg,
                        digc_impl="blocked", digc_capture=cap)
        ticks.append(cap)
        frame = (frame + 0.02 * rng.standard_normal(frame.shape)).astype(
            np.float32)
    stats = np.stack([drift_stat(h).numpy() for t in ticks for _, h, _ in t])
    rel = np.abs(stats[:, None] - stats[None]) / np.abs(stats[None])
    taus = [t for t in (0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0)
            if (np.abs(rel - t) > 0.1 * t).all()]
    assert len(taus) >= 2, rel
    jticks = [[(k, jnp.asarray(h.numpy()), None) for k, h, _ in t] for t in ticks]
    for policy in ("layer", "tick"):
        tuned, results = tune_reuse(ticks, spec=_spec(), policy=policy,
                                    taus=taus)
        jtuned, jresults = jtuner.tune_reuse(jticks, spec=_jspec(),
                                             policy=policy, taus=taus)
        assert [r.as_dict() for r in results] == [r.as_dict() for r in jresults]
        assert (tuned.reuse, tuned.drift_tau) == (jtuned.reuse, jtuned.drift_tau)


def test_tune_reuse_rejects_below_recall_floor_and_unknown_policy():
    ticks, _ = _both(_trace(9, 5, 2.0))
    tuned, results = tune_reuse(ticks, spec=_spec(), policy="layer",
                                taus=(10.0,), recall_floor=0.99)
    assert not results[0].admitted and tuned.reuse is None
    with pytest.raises(ValueError, match="unknown policy"):
        tune_reuse(ticks, spec=_spec(), policy="always")


def test_schedule_with_reuse_skips_cuda_stages():
    sched = VigSchedule(stages=(DigcSpec(impl="blocked", k=3),
                                DigcSpec(impl="cuda", k=3)))
    jsched = jtuner.VigSchedule(stages=(jbuilder.DigcSpec(impl="blocked", k=3),
                                        jbuilder.DigcSpec(impl="pallas", k=3)))
    out = sched.with_reuse("tick", 0.05, 4)
    jout = jsched.with_reuse("tick", 0.05, 4)
    assert [d["reuse"] for d in out.describe()] == [
        d["reuse"] for d in jout.describe()] == ["tick", None]
    assert out.stages[1] == sched.stages[1]  # the kernel stage untouched
    assert (out.stages[0].drift_tau, out.stages[0].max_stale) == (0.05, 4)
    assert all(s.reuse is None for s in out.with_reuse(None).stages)


def test_tuner_keeps_reuse_knobs_on_kernel_candidates_like_jax():
    """``TileConfig.apply`` keeps a spec's reuse knobs on a kernel
    candidate in both packages, and the stateless kernel tier rejects
    them, so tuning a reuse-carrying spec raises the same ValueError in
    both once a kernel candidate is measured: tune without reuse, then
    overlay ``with_reuse``."""
    knobs = dict(reuse="tick", drift_tau=0.1)
    got = TileConfig(16, 64, "kernel", impl="cuda",
                     kernel_merge="bitonic").apply(_spec(**knobs))
    want = jtuner.TileConfig(16, 64, "kernel", impl="pallas",
                             kernel_merge="bitonic").apply(_jspec(**knobs))
    assert (got.reuse, got.drift_tau) == (want.reuse, want.drift_tau) == (
        "tick", 0.1)
    x = testing.features(12, 1, 32, 8)
    with pytest.raises(ValueError) as err:
        DigcTuner(None, max_measure=100, device=CPU).tune(
            torch.from_numpy(x), spec=_spec(**knobs))
    with pytest.raises(ValueError) as jerr:
        jtuner.DigcTuner(None, max_measure=100).tune(jnp.asarray(x),
                                                      spec=_jspec(**knobs))
    assert str(err.value) == str(jerr.value).replace("'pallas'", "'cuda'").replace(
        "'interpret', ", "")
    tuned, _ = DigcTuner(None, max_measure=100, device=CPU).tune(
        torch.from_numpy(x), spec=_spec())
    sched = VigSchedule(stages=(tuned,)).with_reuse("tick", 0.1)
    assert sched.stages[0].reuse == ("tick" if tuned.impl == "blocked" else None)
