"""Fault injection, quarantine, recovery and the degradation ladder in the
port (``repro_torch.core.faults``, ``repro_torch.serve.engine``;
DESIGN.md §11), held against the JAX package's ``VigServeEngine``.

The fault matrix: tenants A, B and C co-batched in one bucket (4,) for
four ticks, video-like (frame t + 1 = frame t + N(0, 0.001^2) pixel
noise), on the ``blocked`` tier with ``reuse="tick"``; one injector armed
per row. Both engines get the same trace and a ``FaultPlan`` of the same
seed. For every row:

* both plans fired the same faults (kind, site, tenant, tick, detail);
* both engines quarantined the same (tick, tenant) lanes with the same
  fault kind, logged the same detected faults and count the same
  ``stats()`` counters;
* every served request's logits agree with JAX's within ATOL = 1e-4 (the
  tolerance of ``tests/test_torch_serve_state.py``);
* within the port, healthy lanes are bit for bit its fault-free replay
  (for a ladder row: a fault-free engine at the tier it degraded to).

The drift gate's tau (0.5) sits orders of magnitude above every drift of
the trace (~1e-5), so both packages take the same gate branches although
their drift statistics differ by ulps.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import builder as jbuilder  # noqa: E402
from repro.core.faults import FaultError as JaxFaultError  # noqa: E402
from repro.core.faults import FaultPlan as JaxPlan  # noqa: E402
from repro.core.state import DigcState as JaxState  # noqa: E402
from repro.models import vig as jvig  # noqa: E402
from repro.models.module import init_params as jax_init_params  # noqa: E402
from repro.serve.engine import VigRequest as JaxRequest  # noqa: E402
from repro.serve.engine import VigServeEngine as JaxEngine  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.core import DigcSpec, digc  # noqa: E402
from repro_torch.core.faults import SITES, FaultError, FaultInfo, FaultPlan  # noqa: E402
from repro_torch.core.state import DigcState  # noqa: E402
from repro_torch.models import convert, vig  # noqa: E402
from repro_torch.serve.engine import VigRequest, VigServeEngine  # noqa: E402

CPU = "cpu"
ATOL = 1e-4
KW = dict(image_size=16, patch=4, embed_dims=(16,), depths=(2,),
          num_classes=3, k=3)
TENANTS = ("A", "B", "C")
TICKS = 4
REUSE = dict(reuse="tick", drift_tau=0.5, max_stale=16)
COUNTERS = ("quarantines", "state_resets", "deadline_misses", "park_losses",
            "retries", "requests_failed", "fallback_level", "park_hits",
            "requests_served", "slot_row_steps")


def _spec():
    return DigcSpec(impl="blocked", k=3, **REUSE)


def _jspec():
    return jbuilder.DigcSpec(impl="blocked", k=3, **REUSE)


@pytest.fixture(scope="module")
def models():
    jcfg = jvig.VIG_VARIANTS["vig_ti_iso"].replace(**KW)
    cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(**KW)
    tree = jax.tree.map(np.asarray, jax_init_params(
        jvig.vig_param_spec(jcfg), jax.random.PRNGKey(0)))
    return jcfg, cfg, tree, convert.params_from_numpy(cfg, tree, device=CPU)


def _frames() -> dict:
    rng = np.random.default_rng(5)
    out = {}
    for i, t in enumerate(TENANTS):
        img = testing.images(40 + i, 1, 16)[0]
        for tick in range(1, TICKS + 1):
            out[(tick, t)] = img
            img = (img + 0.001 * rng.standard_normal(img.shape)).astype(
                np.float32)
    return out


IMAGES = _frames()


def _run(eng, request_cls, images=IMAGES, ticks=TICKS, tenants=TENANTS):
    """One request per (tick, tenant), one step per tick; the requests by
    (tick, tenant)."""
    reqs = {}
    uid = 0
    for tick in range(1, ticks + 1):
        for t in tenants:
            reqs[(tick, t)] = r = request_cls(uid, images[(tick, t)], tenant=t)
            eng.submit(r)
            uid += 1
        eng.step()
    return reqs


def _engines(models, plan_of, *, spec=None, jspec=None, buckets=(4,), **kw):
    """The port's and JAX's engines, each with its own package's plan from
    ``plan_of(FaultPlanClass)`` (None: no plan)."""
    jcfg, cfg, tree, params = models
    plan = None if plan_of is None else plan_of(FaultPlan)
    jplan = None if plan_of is None else plan_of(JaxPlan)
    eng = VigServeEngine(cfg, params, digc_impl=spec or _spec(),
                         autotune=False, buckets=buckets, fault_plan=plan,
                         device=CPU, **kw)
    jeng = JaxEngine(jcfg, tree, digc_impl=jspec or _jspec(), autotune=False,
                     buckets=buckets, fault_plan=jplan, **kw)
    return eng, plan, jeng, jplan


def _fired(plan):
    return [(f.kind, f.site, f.tenant, f.tick, f.detail) for f in plan.fired]


def _assert_like_jax(eng, plan, reqs, jeng, jplan, jreqs):
    assert _fired(plan) == _fired(jplan)
    assert ({k: r.fault.kind for k, r in reqs.items() if r.fault}
            == {k: r.fault.kind for k, r in jreqs.items() if r.fault})
    s, js = eng.stats(), jeng.stats()
    for key in COUNTERS:
        assert s[key] == js[key], (key, s[key], js[key])
    assert s.get("fallback_impl") == js.get("fallback_impl")
    assert [f["kind"] for f in s["faults"]] == [f["kind"] for f in js["faults"]]
    for key, r in reqs.items():
        assert r.done == jreqs[key].done, key
        if r.fault is None:
            np.testing.assert_allclose(r.logits, jreqs[key].logits,
                                       rtol=ATOL, atol=ATOL, err_msg=str(key))


@pytest.fixture(scope="module")
def clean(models):
    """The port's fault-free replay of the trace."""
    _, cfg, _, params = models
    eng = VigServeEngine(cfg, params, digc_impl=_spec(), autotune=False,
                         buckets=(4,), device=CPU)
    reqs = _run(eng, VigRequest)
    st = eng.stats()
    assert st["graph_reuses"] > 0 and st["graph_rebuilds"] > 0
    return reqs


AFFECTED_B = {(2, "B"), (3, "B"), (4, "B")}

# (row, plan factory, lanes whose logits may differ from the fault-free
# replay, expected quarantined lanes, engine keywords)
MATRIX = [
    ("nonfinite_input", lambda P: P(seed=1).inject_nonfinite_input("B", tick=2),
     AFFECTED_B, {(2, "B"): "nonfinite_input"}, {}),
    ("state_nan", lambda P: P(seed=2).inject_state_corruption(
        field="graph_snap", row=1, tick=2, mode="nan"),
     AFFECTED_B, {(2, "B"): "nonfinite_state"}, {}),
    ("state_bitflip", lambda P: P(seed=3).inject_state_corruption(
        field="graph_idx", row=1, tick=2, mode="bitflip"),
     AFFECTED_B, {}, {}),
    ("transient_build", lambda P: P(seed=4).inject_build_failure(times=1),
     set(), {}, dict(retry_backoff=0.0)),
    ("persistent_build", lambda P: P(seed=5).inject_build_failure(
        impl="blocked", times=None), None, {}, dict(retry_backoff=0.0)),
]


@pytest.mark.parametrize("row,plan_of,affected,quarantined,kw", MATRIX,
                         ids=[m[0] for m in MATRIX])
def test_fault_matrix_matches_jax(models, clean, row, plan_of, affected,
                                  quarantined, kw):
    eng, plan, jeng, jplan = _engines(models, plan_of, **kw)
    reqs = _run(eng, VigRequest)
    jreqs = _run(jeng, JaxRequest)
    _assert_like_jax(eng, plan, reqs, jeng, jplan, jreqs)
    assert plan.fired, "the injector never fired"
    assert {k: r.fault.kind for k, r in reqs.items() if r.fault} == quarantined
    for key, r in reqs.items():
        assert r.done
        if key in quarantined:
            assert r.logits is None and r.fault.tenant == "B"
    st = eng.stats()
    if affected is None:
        # Every build on the blocked tier fails: the ladder serves the
        # whole trace on the reference tier, bit for bit a fault-free
        # engine there.
        assert st["fallback_level"] == 1 and st["fallback_impl"] == "reference"
        assert st["retries"] >= eng.retry_attempts
        _, cfg, _, params = models
        ref = _run(VigServeEngine(
            cfg, params, digc_impl=DigcSpec(impl="reference", k=3),
            autotune=False, buckets=(4,), device=CPU), VigRequest)
        for key, r in reqs.items():
            assert np.array_equal(r.logits, ref[key].logits), key
        return
    assert st["fallback_level"] == 0
    for key, r in reqs.items():
        if key not in affected:
            assert np.array_equal(r.logits, clean[key].logits), key
    if row == "state_bitflip":  # recovery, not quarantine: B served cold
        assert st["quarantines"] == 0 and st["state_resets"] >= 1
        assert any(f["kind"] == "state_corruption" for f in st["faults"])
    if row == "transient_build":
        assert st["retries"] == 1 and plan.counts() == {"compile_failure": 1}


def test_exhausted_ladder_reraises_like_jax(models):
    def plan_of(P):
        return P(seed=6).inject_build_failure(times=None)

    eng, plan, jeng, jplan = _engines(models, plan_of, retry_attempts=1,
                                      retry_backoff=0.0)
    eng.submit(VigRequest(0, IMAGES[(1, "A")], tenant="A"))
    jeng.submit(JaxRequest(0, IMAGES[(1, "A")], tenant="A"))
    with pytest.raises(FaultError):
        eng.step()
    with pytest.raises(JaxFaultError):
        jeng.step()
    assert eng.fallback_level == jeng.fallback_level == 1
    assert _fired(plan) == _fired(jplan)
    assert [f.kind for f in eng.fault_log] == [f.kind for f in jeng.fault_log]


# -- deadline strikes (stubbed programs: no build, no timing of a forward)


class _Stub(VigServeEngine):
    def _build_program(self, bucket):
        def fake(imgs, state):
            new = DigcState(entries={k: e.bump()
                                     for k, e in state.entries.items()})
            return torch.zeros(imgs.shape[0], self.cfg.num_classes), new

        return fake


class _JaxStub(JaxEngine):
    def _build_program(self, bucket):
        def fake(params, imgs, state):
            new = JaxState(entries={k: e.bump()
                                    for k, e in state.entries.items()})
            return jnp.zeros((imgs.shape[0], self.cfg.num_classes)), new

        return fake


def _stubs(models, plan_of, **kw):
    jcfg, cfg, tree, params = models
    plan, jplan = plan_of(FaultPlan), plan_of(JaxPlan)
    eng = _Stub(cfg, params, digc_impl=_spec(), autotune=False, buckets=(2,),
                fault_plan=plan, device=CPU, **kw)
    jeng = _JaxStub(jcfg, tree, digc_impl=_jspec(), autotune=False,
                    buckets=(2,), fault_plan=jplan, **kw)
    return eng, plan, jeng, jplan


def test_deadline_strikes_descend_ladder_like_jax(models):
    eng, plan, jeng, jplan = _stubs(
        models, lambda P: P(seed=7).inject_slow_tick(seconds=0.05, times=3),
        deadline_ms=5.0, deadline_strikes=2)
    for e, req_cls in ((eng, VigRequest), (jeng, JaxRequest)):
        for tick in range(1, 4):
            e.submit(req_cls(tick, IMAGES[(1, "A")], tenant="A"))
            assert e.step() == 1
    s, js = eng.stats(), jeng.stats()
    # Tick 1 is the program's first (build and capture): never a deadline
    # signal; ticks 2 and 3 miss and the second miss degrades.
    assert s["deadline_misses"] == js["deadline_misses"] == 2
    assert s["fallback_level"] == js["fallback_level"] == 1
    assert s["fallback_impl"] == js["fallback_impl"] == "reference"
    assert ([f["kind"] for f in s["faults"]] == [f["kind"] for f in js["faults"]]
            == ["deadline_miss", "deadline_miss", "deadline_degrade"])
    assert _fired(plan) == _fired(jplan)
    assert plan.counts() == {"slow_tick": 3}
    assert eng._programs == {} and eng._program_ticks == {}


def test_fast_ticks_never_miss_deadline(models):
    _, cfg, _, params = models
    eng = _Stub(cfg, params, digc_impl=_spec(), autotune=False, buckets=(2,),
                deadline_ms=250.0, device=CPU)
    for tick in range(1, 4):
        eng.submit(VigRequest(tick, IMAGES[(1, "A")], tenant="A"))
        eng.step()
    st = eng.stats()
    assert st["deadline_misses"] == 0 and st["fallback_level"] == 0


# -- parking faults


def _parking(eng, request_cls):
    """slots = 2: A and B bind; C evicts A (parked); A returns."""
    frames = {k: IMAGES[(t, ten)] for k, t, ten in (
        ("A1", 1, "A"), ("B1", 1, "B"), ("C2", 2, "C"), ("A3", 3, "A"))}
    r = {}
    for uid, key in enumerate(("A1", "B1")):
        r[key] = request_cls(uid, frames[key], tenant=key[0])
        eng.submit(r[key])
    eng.step()
    r["C2"] = request_cls(2, frames["C2"], tenant="C")
    eng.submit(r["C2"])
    eng.step()
    assert "A" in eng.stats()["parked_tenants"]
    r["A3"] = request_cls(3, frames["A3"], tenant="A")
    eng.submit(r["A3"])
    eng.step()
    return r


@pytest.mark.parametrize("row", ["parking_loss", "park_restore_error"])
def test_parking_faults_match_jax(models, row):
    def plan_of(P):
        if row == "parking_loss":
            return P(seed=8).inject_parking_loss("A")
        return P(seed=9).inject_park_restore_error("A", times=1)

    eng, plan, jeng, jplan = _engines(models, plan_of, buckets=(2,),
                                      retry_backoff=0.0)
    r, jr = _parking(eng, VigRequest), _parking(jeng, JaxRequest)
    _assert_like_jax(eng, plan, r, jeng, jplan, jr)
    assert (eng.last_resets, eng.last_restores) == (jeng.last_resets,
                                                    jeng.last_restores)
    _, cfg, _, params = models
    st = eng.stats()
    cold = vig.init_vig_state(cfg, 1, _spec(), per_slot=True, device=CPU)
    state = cold
    if row == "parking_loss":
        assert plan.counts() == {"parking_loss": 1}
        assert st["park_losses"] == 1 and st["park_hits"] == 0
        assert eng._tenant_slot["A"] in eng.last_resets
    else:
        assert plan.counts() == {"parking_transient": 1}
        assert st["retries"] == 1 and st["park_hits"] == 1
        assert st["park_losses"] == 0
        # A warm restore: A3 continues from A1's state
        _, state = vig.vig_forward(
            params, torch.from_numpy(r["A1"].image[None]), cfg,
            digc_impl=_spec(), state=cold)
    want, _ = vig.vig_forward(params, torch.from_numpy(r["A3"].image[None]),
                              cfg, digc_impl=_spec(), state=state)
    np.testing.assert_allclose(r["A3"].logits, want[0].numpy(), rtol=1e-5,
                               atol=1e-5)
    assert r["A3"].fault is None  # a loss is recovery, not a failed request


# -- the kernel tier's state fault (its plain version on the CPU)


def test_cuda_tier_row_step_bitflip_serves_cold(models):
    """On the stateless ``cuda`` tier the entries carry ``row_step`` only:
    the default field raises as in JAX, and a ``row_step`` bitflip is
    detected by the tokens and served cold, bit for bit the fault-free
    trace (the tier reads no state)."""
    _, cfg, _, params = models
    with pytest.raises(ValueError, match="carries field 'centroids'"):
        FaultPlan(0).inject_state_corruption().fire(
            "state.rows", value=vig.init_vig_state(cfg, 4, "cuda",
                                                   per_slot=True, device=CPU))
    clean_eng = VigServeEngine(cfg, params, digc_impl="cuda", autotune=False,
                               buckets=(4,), device=CPU)
    ref = _run(clean_eng, VigRequest)
    plan = FaultPlan(seed=10).inject_state_corruption(
        field="row_step", row=1, tick=2, mode="bitflip")
    eng = VigServeEngine(cfg, params, digc_impl="cuda", autotune=False,
                         buckets=(4,), fault_plan=plan, device=CPU)
    reqs = _run(eng, VigRequest)
    st = eng.stats()
    assert plan.counts() == {"state_corruption": 1}
    assert st["state_resets"] == 1 and st["quarantines"] == 0
    assert [f["kind"] for f in st["faults"]] == ["state_corruption"]
    for key, r in reqs.items():
        assert np.array_equal(r.logits, ref[key].logits), key


# -- FaultPlan mechanics (ported from tests/test_faults.py)


def test_plan_rejects_unknown_site():
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultPlan()._add("no.such.site", lambda v, c: v, {}, 1)


def test_plan_times_bounds_firing():
    plan = FaultPlan(seed=0).inject_nonfinite_input(times=2)
    img = np.zeros((4, 4), np.float32)
    for _ in range(5):
        plan.fire("admit.image", value=img, tenant="T")
    assert plan.counts() == {"nonfinite_input": 2}


def test_plan_criteria_scope_tenant_and_tick():
    plan = FaultPlan(seed=0).inject_nonfinite_input("B", tick=3, times=None)
    img = np.zeros((2, 2), np.float32)
    assert np.isfinite(plan.fire("admit.image", value=img, tenant="A",
                                 tick=3)).all()
    assert np.isfinite(plan.fire("admit.image", value=img, tenant="B",
                                 tick=2)).all()
    assert not np.isfinite(plan.fire("admit.image", value=img, tenant="B",
                                     tick=3)).all()
    assert plan.counts() == {"nonfinite_input": 1}


def test_plan_draws_like_jax_plan_of_the_same_seed(models):
    """The same seed plants the same positions and flips the same bits as
    the JAX package's plan, on images and on state rows."""
    jcfg, cfg, _, _ = models
    img = np.zeros((8, 8, 3), np.float32)
    for seed in (0, 17):
        got = FaultPlan(seed).inject_nonfinite_input(count=4, times=None)
        want = JaxPlan(seed).inject_nonfinite_input(count=4, times=None)
        for _ in range(3):
            np.testing.assert_array_equal(
                np.isnan(got.fire("admit.image", value=img, tenant="T")),
                np.isnan(want.fire("admit.image", value=img, tenant="T")))
    state = vig.init_vig_state(cfg, 4, _spec(), per_slot=True, device=CPU)
    jstate = jvig.init_vig_state(jcfg, 4, _jspec(), per_slot=True)
    for field, mode in (("graph_idx", "bitflip"), ("graph_dist", "bitflip"),
                        ("graph_snap", "nan"), ("row_step", "bitflip")):
        got = FaultPlan(31).inject_state_corruption(
            field=field, row=2, mode=mode).fire("state.rows", value=state)
        want = JaxPlan(31).inject_state_corruption(
            field=field, row=2, mode=mode).fire("state.rows", value=jstate)
        np.testing.assert_array_equal(
            getattr(got.entries["stage0"], field).numpy(),
            np.asarray(getattr(want.entries["stage0"], field)))


def test_sites_registry_is_closed_and_equal_to_jax():
    from repro.core.faults import SITES as JAX_SITES

    assert set(SITES) == {
        "admit.image", "state.rows", "program.build", "park.restore",
        "tick.serve", "digc.x",
    }
    assert SITES == JAX_SITES


def test_fault_info_as_dict_stringifies_tenant():
    info = FaultInfo(kind="k", site="admit.image", tenant=("t", 1), tick=2)
    d = info.as_dict()
    assert d["tenant"] == str(("t", 1)) and d["tick"] == 2


def test_digc_x_site_corrupts_eager_features():
    x = torch.from_numpy(testing.features(0, 2, 16, 8))
    clean = digc(x, k=3, impl="reference")
    plan = FaultPlan(seed=20).inject_nonfinite_input(site="digc.x")
    faulty = digc(x, k=3, impl="reference", fault_plan=plan)
    assert plan.counts() == {"nonfinite_input": 1}
    assert not torch.equal(clean, faulty)


def test_digc_without_plan_is_unchanged():
    x = torch.from_numpy(testing.features(1, 16, 8))
    assert torch.equal(digc(x, k=3, impl="reference"),
                       digc(x, k=3, impl="reference", fault_plan=None))


def test_row_fingerprint_sees_single_row_changes(models):
    _, cfg, _, _ = models
    state = vig.init_vig_state(cfg, 4, _spec(), per_slot=True, device=CPU)
    before = state.row_fingerprints([0, 1, 2, 3])
    plan = FaultPlan(seed=21).inject_state_corruption(
        field="graph_dist", row=2, mode="bitflip")
    after = plan.fire("state.rows", value=state).row_fingerprints([0, 1, 2, 3])
    for key in before:
        changed = [r for r in range(4) if before[key][r] != after[key][r]]
        assert changed == [2], (key, changed)


def test_rows_finite_flags_nan_rows(models):
    _, cfg, _, _ = models
    state = vig.init_vig_state(cfg, 4, _spec(), per_slot=True, device=CPU)
    assert all(state.rows_finite([0, 1, 2, 3]).values())
    plan = FaultPlan(seed=22).inject_state_corruption(
        field="graph_snap", row=3, mode="nan")
    finite = plan.fire("state.rows", value=state).rows_finite([0, 1, 2, 3])
    assert finite == {0: True, 1: True, 2: True, 3: False}


@pytest.mark.parametrize("field, mode", [
    ("graph_dist", "bitflip"), ("graph_idx", "bitflip"),
    ("row_step", "bitflip"), ("graph_age", "bitflip"),
    ("graph_snap", "nan"), ("graph_dist", "nan")])
def test_row_checks_flag_the_corrupted_row(models, field, mode):
    """The engine's one-pull screen (``DigcState.row_checks``) sees what
    the crc32 fingerprints and ``rows_finite`` see: a bit flip changes
    only the corrupted row's checksum, a NaN clears only its flag."""
    _, cfg, _, _ = models
    rows = [0, 1, 2, 3]
    state = vig.init_vig_state(cfg, 4, _spec(), per_slot=True, device=CPU)
    # warm, distinct rows: one served tick's worth of values
    state = DigcState(entries={k: e.map(
        lambda t: t + torch.arange(t.shape[0]).reshape(
            (-1,) + (1,) * (t.dim() - 1)).to(t.dtype) if t.dim() else t)
        for k, e in state.entries.items()})
    plan = FaultPlan(seed=24).inject_state_corruption(
        field=field, row=1, mode=mode)
    bad = plan.fire("state.rows", value=state)
    (ok, before), (bad_ok, after) = state.row_checks(), bad.row_checks()
    assert before.dtype == torch.int64 and before.shape == (4,)
    assert ok.tolist() == [True] * 4
    finite = bad.rows_finite(rows)
    assert bad_ok.tolist() == [finite[r] for r in rows]
    if mode == "bitflip":
        assert (after != before).tolist() == [False, True, False, False]
    else:
        assert after[[0, 2, 3]].equal(before[[0, 2, 3]])


def test_row_checks_see_every_single_bit_flip(models):
    """Every bit of a row's word changes its checksum."""
    _, cfg, _, _ = models
    state = vig.init_vig_state(cfg, 2, _spec(), per_slot=True, device=CPU)
    key = next(iter(state.entries))
    entry = state.entries[key]
    base = state.row_checks()[1]
    for field in ("graph_dist", "row_step"):
        for bit in range(32):
            buf = getattr(entry, field).clone()
            word = buf.reshape(2, -1)[1:, -1:].view(torch.int32)
            word ^= torch.tensor(1 << bit if bit < 31 else -(1 << 31),
                                 dtype=torch.int32)
            flipped = state.set(key, dataclasses.replace(entry, **{field: buf}))
            got = flipped.row_checks()[1]
            assert got[0] == base[0] and got[1] != base[1], (field, bit)


def test_guards_off_restores_unguarded_path(models):
    """guards=False: no fingerprinting, no screening: an injected NaN
    image reaches the (stub) program."""
    _, cfg, _, params = models
    plan = FaultPlan(seed=23).inject_nonfinite_input("A")
    eng = _Stub(cfg, params, digc_impl=_spec(), autotune=False, buckets=(2,),
                fault_plan=plan, guards=False, device=CPU)
    req = VigRequest(0, IMAGES[(1, "A")], tenant="A")
    eng.submit(req)
    assert eng.step() == 1
    assert req.done and req.logits is not None and req.fault is None
    assert plan.counts() == {"nonfinite_input": 1}
    st = eng.stats()
    assert st["quarantines"] == 0 and st["state_resets"] == 0
    assert eng._row_tokens == {}
