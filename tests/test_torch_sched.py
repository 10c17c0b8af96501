"""SLO-bounded admission (``repro_torch.serve``: ``slo_ms``, ``clock``,
``prefetch``; ``serve/sched.py``) against the JAX engine on the same
traces, all under a ``VirtualClock`` so every deadline comparison is exact
and every run deterministic. The cases of ``tests/test_serve_sched.py``,
each also held against the JAX engine:

* ``VirtualClock`` and ``arrival_trace`` equal JAX's (the same list for a
  seed).
* Deadline bound: no request dispatches later than arrival + its class
  SLO, and each dispatches at the same virtual time as in JAX.
* Per-tenant FIFO, full-width dispatch without waiting, deferral then
  deadline dispatch, ``run()`` draining under the clock.
* Padding accounting: ``padded_lanes`` is the sum over ticks of (width -
  live); bucket sets re-derived from the trace are deterministic and
  round-trip through the tuner cache (``buckets="auto"``).
* ``slo_ms=0`` serves a ragged trace bit for bit as the default engine.
* Prefetched parking restores change counters only, never logits, and
  count as JAX's do.
* A mixed-size trace (two image sizes, two classes) replayed through
  ``replay`` dispatches the same cells at the same times as JAX's.

Scheduler-order tests run on stubbed programs (no forward); the parity
and prefetch tests run the blocked tier with ``reuse="layer"`` at a tau
no drift reaches, so warm state shows in the logits. The hypothesis
properties of the JAX file stay properties. Marked ``gpu``: the
prefetched restore from pinned host memory on the card, bit for bit a
``prefetch=False`` engine.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _hypothesis_compat import given, settings, st  # noqa: E402

from repro.core import DigcSpec as JSpec  # noqa: E402
from repro.core.state import DigcState as JState  # noqa: E402
from repro.models import vig as jvig  # noqa: E402
from repro.models.module import init_params as jax_init_params  # noqa: E402
from repro.serve import sched as jsched  # noqa: E402
from repro.serve.engine import VigRequest as JaxRequest  # noqa: E402
from repro.serve.engine import VigServeEngine as JaxEngine  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.core import DigcSpec  # noqa: E402
from repro_torch.core.state import DigcState  # noqa: E402
from repro_torch.models import convert, vig  # noqa: E402
from repro_torch.serve import engine as engine_mod  # noqa: E402
from repro_torch.serve.engine import VigRequest, VigServeEngine  # noqa: E402
from repro_torch.serve.sched import (  # noqa: E402
    Arrival,
    VirtualClock,
    arrival_trace,
    replay,
)

CPU = "cpu"
ATOL = 1e-4
KW = dict(image_size=16, patch=4, embed_dims=(16,), depths=(2,),
          num_classes=3, k=3)
REUSE = dict(reuse="layer", drift_tau=1e9, max_stale=2)
_ZERO = np.zeros((16, 16, 3), np.float32)


def _models():
    jcfg = jvig.VIG_VARIANTS["vig_ti_iso"].replace(**KW)
    cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(**KW)
    tree = jax.tree.map(np.asarray, jax_init_params(
        jvig.vig_param_spec(jcfg), jax.random.PRNGKey(0)))
    return jcfg, cfg, tree, convert.params_from_numpy(cfg, tree, device=CPU)


MODELS = _models()


class _Stub(VigServeEngine):
    def _build_program(self, bucket, size=None, masked=False):
        def fake(imgs, *rest):
            state = rest[-1]
            new = DigcState(entries={k: e.bump()
                                     for k, e in state.entries.items()})
            return torch.zeros(imgs.shape[0], self.cfg.num_classes), new

        return fake


class _JaxStub(JaxEngine):
    def _build_program(self, bucket, size=None, masked=False):
        def fake(params, imgs, state, *mask):
            new = JState(entries={k: e.bump()
                                  for k, e in state.entries.items()})
            return jnp.zeros((imgs.shape[0], self.cfg.num_classes)), new

        return fake


def _stubs(**kw):
    """A port stub engine and a JAX stub engine with the same knobs; each
    gets its own clock when ``slo_ms`` is set. Returns ((engine, clock),
    (jax engine, jax clock))."""
    jcfg, cfg, tree, params = MODELS
    kw.setdefault("autotune", False)
    kw.setdefault("buckets", (1, 2, 4))
    kw.setdefault("batch", 4)
    clock, jclock = VirtualClock(), jsched.VirtualClock()
    eng = _Stub(cfg, params, digc_impl="blocked", clock=clock, device=CPU,
                **kw)
    jeng = _JaxStub(jcfg, tree, digc_impl="blocked", clock=jclock, **kw)
    return (eng, clock), (jeng, jclock)


def _drain(eng, clock, arrivals, request=VigRequest, image=_ZERO):
    """Replay ``arrivals`` (deadline wakeups between arrivals, as
    ``serve.sched.replay``), stamping each request's dispatch time;
    returns the requests and the order they completed in."""
    reqs, order = [], []

    def _tick():
        served = eng.step()
        if served:
            for r in reqs:
                if r.done and not hasattr(r, "_done_t"):
                    r._done_t = clock.now()
                    order.append(r)
        return served

    for uid, arr in enumerate(arrivals):
        t_arr = arr.t_ms / 1e3
        while eng.queue:
            dl = eng.next_deadline()
            if dl is None or dl >= t_arr:
                break
            clock.advance_to(dl)
            _tick()
        clock.advance_to(t_arr)
        img = image(arr) if callable(image) else image
        req = request(uid, img, tenant=arr.tenant, tclass=arr.tclass)
        reqs.append(req)
        eng.submit(req)
        _tick()
    guard = 0
    while eng.queue:
        if _tick() == 0:
            dl = eng.next_deadline()
            assert dl is not None, "deferred with no deadline"
            clock.advance_to(dl)
            guard += 1
            assert guard < 10_000, "drain stalled"
    return reqs, order


def _drain_both(arrivals, **kw):
    """The same arrivals through a port and a JAX stub engine: every
    request dispatches at the same virtual time, in the same order, and
    the scheduler counters end equal."""
    (eng, clock), (jeng, jclock) = _stubs(**kw)
    reqs, order = _drain(eng, clock, arrivals)
    jreqs, jorder = _drain(jeng, jclock, arrivals, request=JaxRequest)
    assert [r._done_t for r in reqs] == [r._done_t for r in jreqs]
    assert [r.uid for r in order] == [r.uid for r in jorder]
    s, js = eng.stats(), jeng.stats()
    for k in ("deferrals", "queue_depth", "live_lanes", "padded_lanes",
              "lane_hist", "bucket_ticks", "cell_ticks", "util",
              "prefetch_issued", "prefetch_hits", "park_hits"):
        assert s[k] == js[k], k
    return eng, reqs, order


# ---------------------------------------------------------------------------
# VirtualClock / arrival_trace


def test_virtual_clock_monotonic():
    for clk in (VirtualClock(), jsched.VirtualClock()):
        assert clk.now() == 0.0 and clk() == 0.0
        assert clk.advance(0.25) == 0.25
        # advance_to into the past is a no-op, never a rewind
        assert clk.advance_to(0.1) == 0.25
        assert clk.advance_to(1.5) == 1.5
        with pytest.raises(ValueError):
            clk.advance(-1.0)
    assert VirtualClock(start=3.0).now() == 3.0


def test_arrival_trace_deterministic_and_equal_to_jax():
    kw = dict(seed=7, tenants=4, poisson_n=20, burst_n=2, burst_size=3,
              classes=("gold", "default"))
    a, b = arrival_trace(**kw), arrival_trace(**kw)
    assert a == b
    assert len(a) == 20 + 2 * 3
    assert all(x.t_ms <= y.t_ms for x, y in zip(a, a[1:]))
    assert {x.tclass for x in a} == {"gold", "default"}
    assert {x.tenant for x in a} <= {f"t{i}" for i in range(4)}
    c = arrival_trace(**{**kw, "seed": 8})
    assert [x.t_ms for x in c] != [x.t_ms for x in a]
    for trace_kw in (kw, dict(seed=0, tenants=8, classes=("gold", "default"),
                              sizes=(224, 448))):
        ours = arrival_trace(**trace_kw)
        theirs = jsched.arrival_trace(**trace_kw)
        assert [(x.t_ms, x.tenant, x.tclass, x.size) for x in ours] == [
            (x.t_ms, x.tenant, x.tclass, x.size) for x in theirs]
    assert Arrival(1.0, "t0") == Arrival(1.0, "t0", "default", None)


# ---------------------------------------------------------------------------
# Deadline bound


def _assert_deadline_bound(reqs, eng):
    for r in reqs:
        assert r.done
        assert r._done_t <= r._enq_t + eng._slo_s(r) + 1e-9, (
            f"uid {r.uid} dispatched {r._done_t:.6f}, deadline "
            f"{r._enq_t + eng._slo_s(r):.6f}")


def test_deadline_bound_on_bursty_trace():
    arrivals = arrival_trace(seed=3, tenants=6, poisson_n=40,
                             poisson_ms=30.0, burst_n=3, burst_size=4)
    eng, reqs, _ = _drain_both(arrivals, slo_ms=50.0)
    _assert_deadline_bound(reqs, eng)
    assert eng.deferrals > 0  # the trickle actually waited
    assert eng.stats()["queue_depth"] == 0


def test_deadline_bound_per_class_slo():
    """A dict slo: a gold request's tighter budget binds it, and a gold
    request queued behind a lax one pulls its tenant's head forward."""
    arrivals = [Arrival(t_ms=0.0, tenant="a", tclass="default"),
                Arrival(t_ms=1.0, tenant="a", tclass="gold"),
                Arrival(t_ms=2.0, tenant="b", tclass="default")]
    eng, reqs, _ = _drain_both(arrivals,
                               slo_ms={"gold": 10.0, "default": 200.0})
    _assert_deadline_bound(reqs, eng)
    assert reqs[0]._done_t <= (1.0 + 10.0) / 1e3 + 1e-9
    # an unknown class falls back to "default"
    assert eng._slo_s(VigRequest(9, _ZERO, tenant="x",
                                 tclass="nope")) == pytest.approx(0.2)


@settings(max_examples=25)
@given(gaps=st.lists(st.integers(0, 120), min_size=1, max_size=24),
       slo=st.integers(1, 200))
def test_property_deadline_bound(gaps, slo):
    t, arrivals = 0.0, []
    for i, g in enumerate(gaps):
        t += g
        arrivals.append(Arrival(t_ms=t, tenant=f"t{i % 5}"))
    eng, reqs, _ = _drain_both(arrivals, slo_ms=float(slo))
    _assert_deadline_bound(reqs, eng)


# ---------------------------------------------------------------------------
# Per-tenant FIFO / dispatch policy


def _assert_fifo(order):
    per_tenant: dict = {}
    for r in order:
        per_tenant.setdefault(r.tenant, []).append(r.uid)
    for t, uids in per_tenant.items():
        assert uids == sorted(uids), f"tenant {t} served out of order"


def test_per_tenant_fifo_across_deferrals():
    arrivals = arrival_trace(seed=11, tenants=3, poisson_n=30,
                             poisson_ms=15.0, burst_n=2, burst_size=5)
    _, _, order = _drain_both(arrivals, slo_ms=40.0)
    _assert_fifo(order)


@settings(max_examples=20)
@given(tenants=st.lists(st.integers(0, 3), min_size=2, max_size=20))
def test_property_per_tenant_fifo(tenants):
    arrivals = [Arrival(t_ms=5.0 * i, tenant=f"t{t}")
                for i, t in enumerate(tenants)]
    _, _, order = _drain_both(arrivals, slo_ms=25.0)
    _assert_fifo(order)


def test_full_width_dispatches_without_waiting():
    (eng, clock), (jeng, _) = _stubs(slo_ms=10_000.0)
    for e, cls in ((eng, VigRequest), (jeng, JaxRequest)):
        for i in range(e.slots):
            e.submit(cls(i, _ZERO, tenant=f"t{i}"))
        assert e.step() == e.slots
        assert e.deferrals == 0
    assert clock.now() == 0.0  # no time passed


def test_deferral_then_deadline_dispatch():
    (eng, clock), (jeng, jclock) = _stubs(slo_ms=50.0)
    for e, c, cls in ((eng, clock, VigRequest), (jeng, jclock, JaxRequest)):
        e.submit(cls(0, _ZERO, tenant="a"))
        tick = e._tick
        assert e.step() == 0  # a lone sub-width arrival waits
        assert e.deferrals == 1 and e._tick == tick  # no tick was taken
        assert e._next_deadline == pytest.approx(0.05)
        assert e.next_deadline() == pytest.approx(0.05)
        c.advance_to(0.049)
        assert e.step() == 0  # still early
        c.advance_to(0.05)
        assert e.step() == 1
        assert e.stats()["queue_depth"] == 0 and e._tick == tick + 1
    assert eng.stats()["deferrals"] == jeng.stats()["deferrals"] == 2


def test_run_drains_under_virtual_clock():
    (eng, clock), (jeng, jclock) = _stubs(slo_ms=30.0)
    for e, cls in ((eng, VigRequest), (jeng, JaxRequest)):
        for i in range(2):
            e.submit(cls(i, _ZERO, tenant=f"t{i}"))
        assert [r.uid for r in e.run()] == [0, 1]
    assert clock.now() == jclock.now() >= 0.03


# ---------------------------------------------------------------------------
# Padding accounting / bucket-set determinism


def test_padding_accounting_sums_exactly():
    """padded_lanes == sum over dispatched ticks of (width - live), from
    the replay's own tick log; the log equals JAX's."""
    (eng, clock), (jeng, jclock) = _stubs(slo_ms=60.0)
    arrivals = arrival_trace(seed=5, tenants=5, poisson_n=32,
                             poisson_ms=25.0, burst_n=2, burst_size=4)
    ticks = replay(eng, arrivals, _ZERO, clock=clock)
    assert ticks == jsched.replay(jeng, arrivals, _ZERO, clock=jclock)
    assert sum(served for served, _, _ in ticks) == len(arrivals)
    assert eng.live_lanes == sum(live for _, live, _ in ticks)
    assert eng.padded_lanes == sum(w - live for _, live, w in ticks)
    s = eng.stats()
    assert s["util"] == pytest.approx(
        eng.live_lanes / (eng.live_lanes + eng.padded_lanes))
    assert sum(s["lane_hist"].values()) == len(ticks)
    assert sum(int(k.split("x")[1]) * n
               for k, n in s["lane_hist"].items()) == eng.live_lanes


def test_bucket_sets_deterministic_for_fixed_trace(tmp_path):
    """The same trace always re-derives the same bucket set (JAX's), and
    ``buckets="auto"`` reads it back from the tuner cache."""
    arrivals = arrival_trace(seed=9, tenants=6, poisson_n=40, burst_n=3,
                             burst_size=4)
    sets = []
    for _ in range(2):
        (eng, clock), (jeng, jclock) = _stubs(slo_ms=60.0)
        replay(eng, arrivals, _ZERO, clock=clock)
        jsched.replay(jeng, arrivals, _ZERO, clock=jclock)
        sets.append(eng.retune_buckets())
        assert sets[-1] == jeng.retune_buckets()
    assert sets[0] == sets[1]
    assert eng.buckets == sets[1]  # retune takes effect live
    assert len(sets[0]) <= eng.bucket_cap and max(sets[0]) == eng.slots
    path = tmp_path / "tune.json"
    (tuned, clock), _ = _stubs(slo_ms=60.0, tuner_path=path)
    replay(tuned, arrivals, _ZERO, clock=clock)
    assert tuned.retune_buckets() == sets[0]
    (auto, _), _ = _stubs(buckets="auto", tuner_path=path)
    assert auto.buckets == sets[0]


def test_auto_buckets_fallback_without_cache(tmp_path):
    for kw, want in ((dict(), (1, 2, 4)), (dict(batch=8), (1, 2, 4, 8)),
                     (dict(tuner_path=tmp_path / "t.json"), (1, 2, 4))):
        (eng, _), (jeng, _) = _stubs(buckets="auto", **kw)
        assert eng.buckets == jeng.buckets == want
    with pytest.raises(ValueError, match="'auto'"):
        _stubs(buckets="nonsense")


@settings(max_examples=15)
@given(seed=st.integers(0, 50))
def test_property_bucket_set_seed_stability(seed):
    (eng, clock), _ = _stubs(slo_ms=45.0)
    replay(eng, arrival_trace(seed=seed, tenants=5, poisson_n=24), _ZERO,
           clock=clock)
    first = eng.retune_buckets()
    assert first == eng.retune_buckets()  # idempotent on the same hist
    assert max(first) == eng.slots


# ---------------------------------------------------------------------------
# slo_ms=0 legacy parity and the counters on the legacy path


def _serve_waves(eng, waves, seed, request=VigRequest):
    rng = np.random.default_rng(seed)
    out, uid = [], 0
    for wave in waves:
        reqs = [request(uid + i, rng.standard_normal((16, 16, 3))
                        .astype(np.float32), tenant=t)
                for i, t in enumerate(wave)]
        uid += len(wave)
        for r in reqs:
            eng.submit(r)
        assert eng.step() == len(wave)
        out.extend(reqs)
    return out


def test_slo_zero_is_bitwise_legacy():
    """slo_ms=0 with a clock and prefetch serves a ragged trace bit for
    bit as the default engine: same logits, bucket ticks and programs,
    and the scheduler never ran; within 1e-4 of JAX's."""
    jcfg, cfg, tree, params = MODELS
    spec = DigcSpec(impl="blocked", k=3, **REUSE)
    waves = [["A"], ["B", "C"], ["A", "B"], ["C"], ["A", "B", "C"]]

    def _engine(**kw):
        return VigServeEngine(cfg, params, digc_impl=spec, autotune=False,
                              buckets=(1, 2, 4), device=CPU, **kw)

    base_eng, sched_eng = _engine(), _engine(slo_ms=0.0, clock=VirtualClock(),
                                             prefetch=True)
    base = _serve_waves(base_eng, waves, 41)
    sched = _serve_waves(sched_eng, waves, 41)
    assert sched_eng._sched_active is False
    for b, s in zip(base, sched):
        assert b.logits.tobytes() == s.logits.tobytes()
    assert base_eng.stats()["bucket_ticks"] == sched_eng.stats()["bucket_ticks"]
    assert base_eng.compile_count == sched_eng.compile_count
    assert sched_eng.deferrals == 0 and sched_eng.prefetch_issued == 0
    jeng = JaxEngine(jcfg, tree, digc_impl=JSpec(impl="blocked", k=3, **REUSE),
                     autotune=False, buckets=(1, 2, 4), slo_ms=0.0,
                     clock=jsched.VirtualClock())
    for s, j in zip(sched, _serve_waves(jeng, waves, 41, JaxRequest)):
        np.testing.assert_allclose(s.logits, j.logits, rtol=ATOL, atol=ATOL)


def test_legacy_path_reports_queue_and_util():
    (eng, _), (jeng, _) = _stubs()  # slo_ms=0 default
    for e, cls in ((eng, VigRequest), (jeng, JaxRequest)):
        for i in range(3):
            e.submit(cls(i, _ZERO, tenant=f"t{i}"))
        assert e.stats()["queue_depth"] == 3
        e.step()  # 3 live on bucket 4: 1 padded lane
    for s in (eng.stats(), jeng.stats()):
        assert s["queue_depth"] == 0
        assert s["live_lanes"] == 3 and s["padded_lanes"] == 1
        assert s["util"] == pytest.approx(0.75)
        assert s["lane_hist"] == {"16x3": 1}
        assert s["deferrals"] == 0 and s["slo_ms"] == 0.0
        assert s["image_sizes"] == (16,) and s["cell_ticks"] == {"16x4": 1}
        assert s["prefetch_issued"] == s["prefetch_hits"] == 0


# ---------------------------------------------------------------------------
# Prefetched parking restore


PREFETCH_WAVES = [["A"], ["B", "C"], ["D", "E"], ["A"]]


def test_prefetch_counters_and_bitwise_parity():
    """Evict and park a tenant, resubmit it: the upload is issued at
    submit and bound by the restoring tick; logits are bit for bit a
    prefetch=False engine's, and the counters equal JAX's."""
    jcfg, cfg, tree, params = MODELS
    spec = DigcSpec(impl="blocked", k=3, **REUSE)
    jspec = JSpec(impl="blocked", k=3, **REUSE)

    def _serve(prefetch, jax_engine=False):
        kw = dict(autotune=False, buckets=(1, 2), park_capacity=4,
                  prefetch=prefetch)
        eng = (JaxEngine(jcfg, tree, digc_impl=jspec, **kw) if jax_engine
               else VigServeEngine(cfg, params, digc_impl=spec, device=CPU,
                                   **kw))
        return eng, _serve_waves(eng, PREFETCH_WAVES, 17,
                                 JaxRequest if jax_engine else VigRequest)

    pre_eng, pre = _serve(True)
    base_eng, base = _serve(False)
    jeng, jpre = _serve(True, jax_engine=True)
    assert pre_eng.prefetch_issued >= 1 and pre_eng.prefetch_hits >= 1
    assert pre_eng.park_hits >= 1
    assert base_eng.prefetch_issued == 0 and base_eng.prefetch_hits == 0
    for p, b, j in zip(pre, base, jpre):
        assert p.logits.tobytes() == b.logits.tobytes()
        np.testing.assert_allclose(p.logits, j.logits, rtol=ATOL, atol=ATOL)
    for k in ("prefetch_issued", "prefetch_hits", "park_hits",
              "graph_reuses", "graph_rebuilds"):
        assert pre_eng.stats()[k] == jeng.stats()[k], k
    assert pre_eng.graph_reuses > 0


def test_prefetch_is_dropped_when_the_restore_is_replaced(monkeypatch):
    """A ``park.restore`` fault site that returns other rows than the
    parked ones makes the engine re-upload: the prefetched copy is not
    bound (no hit) and the replaced rows are restored."""
    (eng, _), _ = _stubs(buckets=(1, 2), batch=2, park_capacity=4)
    for wave in PREFETCH_WAVES[:3]:
        for t in wave:
            eng.submit(VigRequest(0, _ZERO, tenant=t))
        eng.step()
    parked = eng._parked["A"]
    replaced = parked.to(CPU)
    monkeypatch.setattr(eng, "_fire", lambda site, value=None, **ctx: (
        replaced if site == "park.restore" else value))
    eng.submit(VigRequest(9, _ZERO, tenant="A"))
    assert "A" in eng._park_prefetch and eng.prefetch_issued == 1
    eng.step()
    assert eng.park_hits == 1 and eng.prefetch_hits == 0
    assert not eng._park_prefetch


def test_prefetch_scheduler_path_counts():
    """Under the scheduler the peek names the admitting cell; a parked
    tenant among its requests is uploaded before the tick that restores
    it, as in JAX."""
    arrivals = [Arrival(t_ms=0.0, tenant="A"), Arrival(t_ms=30.0, tenant="B"),
                Arrival(t_ms=31.0, tenant="C"), Arrival(t_ms=60.0, tenant="A")]
    eng, reqs, _ = _drain_both(arrivals, slo_ms=20.0, buckets=(1, 2),
                               batch=2, park_capacity=4)
    assert all(r.done for r in reqs)
    assert eng.prefetch_issued >= 1 and eng.prefetch_hits >= 1


# ---------------------------------------------------------------------------
# A mixed-size, two-class trace through replay (real programs)


def test_mixed_size_class_trace_matches_jax():
    """``arrival_trace`` over two image sizes and two classes, replayed on
    virtual clocks: the same ticks (served, live, width), cells and
    dispatch order as JAX's engine, per-class deadlines held, logits
    within 1e-4."""
    jcfg, cfg, tree, params = MODELS
    arrivals = arrival_trace(seed=0, tenants=6, poisson_n=20, burst_n=2,
                             burst_size=5, classes=("gold", "default"),
                             sizes=(16, 24))
    images = {f"t{i}": testing.images(60 + i, 1, 16 if i % 2 == 0 else 24)[0]
              for i in range(6)}
    slo = {"gold": 20.0, "default": 80.0}
    kw = dict(autotune=False, buckets=(1, 2, 4), image_sizes=(16, 24),
              slo_ms=slo, park_capacity=4)
    clock, jclock = VirtualClock(), jsched.VirtualClock()
    eng = VigServeEngine(cfg, params, digc_impl=DigcSpec(impl="blocked", k=3,
                                                         **REUSE),
                         clock=clock, device=CPU, **kw)
    jeng = JaxEngine(jcfg, tree, digc_impl=JSpec(impl="blocked", k=3, **REUSE),
                     clock=jclock, **kw)
    cells: list = []
    jcells: list = []
    step, jstep = eng.step, jeng.step

    def logged(fn, e, log):
        def wrapped():
            n = fn()
            if n:
                log.append((e.last_cell, tuple(e.last_lanes)))
            return n
        return wrapped

    eng.step = logged(step, eng, cells)
    jeng.step = logged(jstep, jeng, jcells)
    ticks = replay(eng, arrivals, images, clock=clock)
    assert ticks == jsched.replay(jeng, arrivals, images, clock=jclock)
    assert cells == jcells and {c[0][0] for c in cells} == {16, 24}
    s, js = eng.stats(), jeng.stats()
    for k in ("cell_ticks", "deferrals", "padded_lanes", "park_hits",
              "prefetch_issued", "prefetch_hits", "graph_reuses"):
        assert s[k] == js[k], k
    assert s["deferrals"] > 0


# ---------------------------------------------------------------------------
# On the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_prefetched_restore_from_pinned_memory_on_card(cuda, monkeypatch):
    """On the card parked rows sit in pinned host memory and the
    prefetch uploads them without blocking; the restoring tick binds that
    copy, and the captured engine's logits equal a prefetch=False
    engine's bit for bit."""
    _, cfg, tree, _ = MODELS
    params = convert.params_from_numpy(cfg, tree, device=cuda)
    spec = DigcSpec(impl="blocked", k=3, **REUSE)
    uploads = []
    real = engine_mod.prefetch_park_rows

    def spy(host, device):
        uploads.append(all(t.is_pinned() for e in host.entries.values()
                           for t in (e.row_step, e.graph_idx)))
        return real(host, device)

    monkeypatch.setattr(engine_mod, "prefetch_park_rows", spy)
    out = {}
    for prefetch in (True, False):
        eng = VigServeEngine(cfg, params, digc_impl=spec, autotune=False,
                             buckets=(1, 2), park_capacity=4,
                             prefetch=prefetch, device=cuda)
        out[prefetch] = (eng, _serve_waves(eng, PREFETCH_WAVES, 17))
    eng, reqs = out[True]
    assert uploads and all(uploads)
    assert eng.prefetch_hits >= 1 and out[False][0].prefetch_hits == 0
    for a, b in zip(reqs, out[False][1]):
        assert a.logits.tobytes() == b.logits.tobytes()
