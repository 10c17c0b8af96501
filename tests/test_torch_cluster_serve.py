"""Serving the approximate tiers (``cluster``, ``axial``) through the port's
``VigServeEngine``, held against the JAX package's engine on the same
traces, at the tiny config of ``tests/test_serve_multitenant.py`` (16^2
images, patch 4: N = 16, D = 16, two blocks, k = 3; the cluster tier
runs 4 clusters at full probe).

* Bucketed ragged traces with an eviction: both engines bind the same
  lanes, reset and restore the same slots and count the same row steps;
  logits agree within 1e-4 (the tolerance of the other serving parity
  files), carried centroids within 1e-4; every request equals its
  tenant's B = 1 stateful replay within 1e-5, and warm starts engage.
* A user ``VigSchedule`` sizes the slot centroids; the (B, N) lattice
  serves (tenant, size) streams equal to their replays.
* The fault matrix of ``tests/test_faults.py`` on ``cluster``: both
  engines get the same trace and a ``FaultPlan`` of the same seed, fire
  the same faults (positions and bits included), quarantine or recover
  the same lanes and count the same counters; healthy lanes are bit for
  bit the port's fault-free replay, recovered ones a cold replay.
* On a card (marker ``gpu``): captured bucket programs equal the eager
  engine bit for bit on ``cluster``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import builder as jbuilder  # noqa: E402
from repro.core.faults import FaultPlan as JaxPlan  # noqa: E402
from repro.core.tuner import VigSchedule as JaxSchedule  # noqa: E402
from repro.models import vig as jvig  # noqa: E402
from repro.models.module import init_params as jax_init_params  # noqa: E402
from repro.serve.engine import VigRequest as JaxRequest  # noqa: E402
from repro.serve.engine import VigServeEngine as JaxEngine  # noqa: E402
from repro_torch.core import DigcSpec, VigSchedule  # noqa: E402
from repro_torch.core.faults import FaultPlan  # noqa: E402
from repro_torch.core.strategies import default_cluster_params  # noqa: E402
from repro_torch.models import convert, vig  # noqa: E402
from repro_torch.serve.engine import VigRequest, VigServeEngine  # noqa: E402

CPU = "cpu"
ATOL = 1e-4
KW = dict(image_size=16, patch=4, embed_dims=(16,), depths=(2,),
          num_classes=3, k=3)


def _models(impl):
    jcfg = jvig.VIG_VARIANTS["vig_ti_iso"].replace(digc_impl=impl, **KW)
    cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(digc_impl=impl, **KW)
    tree = jax.tree.map(np.asarray, jax_init_params(
        jvig.vig_param_spec(jcfg), jax.random.PRNGKey(0)))
    return jcfg, cfg, tree, convert.params_from_numpy(cfg, tree, device=CPU)


@pytest.fixture(scope="module")
def cluster_models():
    return _models("cluster")


def _image(rng, size=16):
    return rng.standard_normal((size, size, 3)).astype(np.float32)


def _replay(cfg, params, impl, images, *, size=16, state=None):
    """B = 1 stateful replay of one tenant's images (cold unless
    ``state``); returns the logits and the final state."""
    if state is None:
        state = vig.init_vig_state(cfg, 1, impl, per_slot=True,
                                   grid=size // cfg.patch, device=CPU)
    outs = []
    for img in images:
        logits, state = vig.vig_forward(params, torch.from_numpy(img[None]),
                                        cfg, digc_impl=impl, state=state)
        outs.append(logits[0].numpy())
    return outs, state


# Ticks of tenants on 4 slots: "e" arrives late and evicts the least
# recently used tenant, which returns (parked and restored).
TRACE = [["a", "b", "c", "d"], ["a", "b", "d"], ["a", "c", "d"],
         ["e", "d", "b"], ["a", "d"], ["a", "b", "c", "d"], ["e"],
         ["a", "b", "c", "d"]]


@pytest.mark.parametrize("impl", ["cluster", "axial"])
def test_bucketed_trace_matches_jax_and_b1_replay(impl):
    jcfg, cfg, tree, params = _models(impl)
    eng = VigServeEngine(cfg, params, digc_impl=impl, autotune=False,
                         buckets=(1, 2, 4), device=CPU)
    jeng = JaxEngine(jcfg, tree, digc_impl=impl, autotune=False,
                     buckets=(1, 2, 4))
    rng = np.random.default_rng(7)
    per_tenant: dict = {}
    uid = 0
    for tick in TRACE:
        mine, theirs = [], []
        for t in tick:
            img = _image(rng)
            mine.append(VigRequest(uid, img, tenant=t))
            theirs.append(JaxRequest(uid, img, tenant=t))
            per_tenant.setdefault(t, []).append(mine[-1])
            eng.submit(mine[-1])
            jeng.submit(theirs[-1])
            uid += 1
        assert eng.step() == jeng.step() == len(tick)
        assert (eng.last_lanes, eng.last_bucket, eng.last_resets,
                eng.last_restores) == (jeng.last_lanes, jeng.last_bucket,
                                       jeng.last_resets, jeng.last_restores)
        for r, jr in zip(mine, theirs):
            np.testing.assert_allclose(r.logits, jr.logits, rtol=ATOL,
                                       atol=ATOL)
    s, js = eng.stats(), jeng.stats()
    for key in ("slot_row_steps", "slot_tenants", "park_hits",
                "park_evictions", "parked_tenants", "fallback_level"):
        assert s[key] == js[key], key
    assert s["park_hits"] > 0 and s["fallback_level"] == 0
    ent = eng._slot_state.entries["stage0"]
    jent = jeng._slot_state.entries["stage0"]
    if impl == "cluster":
        np.testing.assert_allclose(ent.centroids.numpy(),
                                   np.asarray(jent.centroids), rtol=ATOL,
                                   atol=ATOL)
        # warm starts engaged: every bound slot carries real centroids
        for slot in eng._tenant_slot.values():
            assert int(ent.row_step[slot]) > 0
            assert ent.centroids[slot].abs().sum() > 0
        # one warm/cold read per DIGC call of each tick
        assert s["gate_reads"] == len(TRACE) * sum(cfg.depths)
    else:
        assert ent.centroids is None and s["gate_reads"] == 0
    # A parked tenant comes back with its rows as they were: every request
    # is its tenant's B = 1 replay, evictions included.
    for t, reqs in per_tenant.items():
        want, _ = _replay(cfg, params, impl, [r.image for r in reqs])
        for r, w in zip(reqs, want):
            np.testing.assert_allclose(r.logits, w, rtol=1e-5, atol=1e-5)


def test_user_schedule_sizes_slot_state(cluster_models):
    """A user ``VigSchedule`` with a cluster stage spec sizes the per-slot
    centroid buffers, and the warm start engages through the program."""
    jcfg, cfg, tree, params = cluster_models
    knobs = dict(impl="cluster", k=3, n_clusters=3, n_probe=3,
                 capacity_factor=8.0)
    eng = VigServeEngine(cfg, params,
                         digc_impl=VigSchedule(stages=(DigcSpec(**knobs),)),
                         autotune=False, buckets=(1, 2), device=CPU)
    jeng = JaxEngine(jcfg, tree, autotune=False, buckets=(1, 2),
                     digc_impl=JaxSchedule(stages=(jbuilder.DigcSpec(**knobs),)))
    ent = eng._ensure_slot_state().entries["stage0"]
    nc, _ = default_cluster_params(16, 3, 3)
    assert tuple(ent.centroids.shape) == (2, nc, 16) == tuple(
        jeng._ensure_slot_state().entries["stage0"].centroids.shape)
    rng = np.random.default_rng(29)
    for uid in range(2):
        img = _image(rng)
        r, jr = VigRequest(uid, img, tenant="A"), JaxRequest(uid, img, tenant="A")
        eng.submit(r)
        jeng.submit(jr)
        eng.step()
        jeng.step()
        np.testing.assert_allclose(r.logits, jr.logits, rtol=ATOL, atol=ATOL)
    slot = eng._tenant_slot["A"]
    assert eng.slot_row_steps()["stage0"][slot] == 2 * sum(cfg.depths)
    assert eng._slot_state.entries["stage0"].centroids[slot].abs().sum() > 0


def test_lattice_tenant_size_streams_match_replay(cluster_models):
    """Tenants x sizes (16/24/32) on a 2-slot lattice engine: every
    request equals its (tenant, size) B = 1 replay and JAX's engine, and
    the programs stay within |buckets| x |image_sizes|."""
    jcfg, cfg, tree, params = cluster_models
    kw = dict(digc_impl="cluster", autotune=False, buckets=(1, 2),
              image_sizes=(16, 24, 32))
    eng = VigServeEngine(cfg, params, device=CPU, **kw)
    jeng = JaxEngine(jcfg, tree, **kw)
    rng = np.random.default_rng(11)
    waves = [[("A", 16)], [("B", 24), ("C", 16)], [("A", 16), ("B", 24)],
             [("C", 32)], [("A", 24)], [("A", 16), ("C", 16)], [("B", 24)]]
    streams: dict = {}
    uid = 0
    for wave in waves:
        for t, s in wave:
            img = _image(rng, s)
            r, jr = VigRequest(uid, img, tenant=t), JaxRequest(uid, img, tenant=t)
            streams.setdefault((t, s), []).append((r, jr))
            eng.submit(r)
            jeng.submit(jr)
            uid += 1
        while eng.queue:
            eng.step()
            jeng.step()
            assert eng.last_cell == jeng.last_cell
    for (t, s), pairs in streams.items():
        want, _ = _replay(cfg, params, "cluster", [r.image for r, _ in pairs],
                          size=s)
        for (r, jr), w in zip(pairs, want):
            assert r.done and r.fault is None
            np.testing.assert_allclose(r.logits, w, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(r.logits, jr.logits, rtol=ATOL, atol=ATOL)
    assert eng.compile_count == jeng.compile_count <= 6
    assert eng.park_hits == jeng.park_hits
    assert eng.stats()["slot_row_steps"] == jeng.stats()["slot_row_steps"]


# -- the fault matrix on the cluster tier ------------------------------------

TENANTS = ("A", "B", "C")
TICKS = 4


def _trace_images():
    rng = np.random.default_rng(0)
    return {(tick, t): _image(rng)
            for tick in range(1, TICKS + 1) for t in TENANTS}


IMAGES = _trace_images()


def _run(eng, request_cls, images=IMAGES):
    reqs = {}
    uid = 0
    for tick in range(1, TICKS + 1):
        for t in TENANTS:
            reqs[(tick, t)] = r = request_cls(uid, images[(tick, t)], tenant=t)
            eng.submit(r)
            uid += 1
        eng.step()
    return reqs


def _fired(plan):
    return [(f.kind, f.site, f.tenant, f.tick, f.detail) for f in plan.fired]


def _engines(models, plan_of, buckets=(4,), **kw):
    jcfg, cfg, tree, params = models
    plan, jplan = plan_of(FaultPlan), plan_of(JaxPlan)
    eng = VigServeEngine(cfg, params, digc_impl="cluster", autotune=False,
                         buckets=buckets, fault_plan=plan, device=CPU, **kw)
    jeng = JaxEngine(jcfg, tree, digc_impl="cluster", autotune=False,
                     buckets=buckets, fault_plan=jplan, **kw)
    return eng, plan, jeng, jplan


COUNTERS = ("quarantines", "state_resets", "park_losses", "retries",
            "requests_failed", "fallback_level", "park_hits",
            "requests_served", "slot_row_steps")


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
            np.testing.assert_allclose(r.logits, jreqs[key].logits, rtol=ATOL,
                                       atol=ATOL, err_msg=str(key))


@pytest.fixture(scope="module")
def clean(cluster_models):
    """The port's fault-free replay of the trace."""
    _, cfg, _, params = cluster_models
    eng = VigServeEngine(cfg, params, digc_impl="cluster", autotune=False,
                         buckets=(4,), device=CPU)
    return _run(eng, VigRequest)


AFFECTED_B = {(2, "B"), (3, "B"), (4, "B")}

# (row, plan factory, quarantined lanes, the ticks from which B is a cold
# replay, engine keywords)
MATRIX = [
    ("nonfinite_input", lambda P: P(seed=1).inject_nonfinite_input("B", tick=2),
     {(2, "B"): "nonfinite_input"}, (3, 4), {}),
    ("state_nan", lambda P: P(seed=2).inject_state_corruption(
        field="centroids", row=1, tick=2, mode="nan"),
     {(2, "B"): "nonfinite_state"}, (3, 4), {}),
    ("state_bitflip", lambda P: P(seed=3).inject_state_corruption(
        field="centroids", row=1, tick=2, mode="bitflip"), {}, (2, 3, 4), {}),
    ("default_field_bitflip", lambda P: P(seed=12).inject_state_corruption(
        row=1, tick=2), {}, (2, 3, 4), {}),
    ("persistent_build", lambda P: P(seed=5).inject_build_failure(
        impl="cluster", times=None), {}, None, dict(retry_backoff=0.0)),
]


@pytest.mark.parametrize("row,plan_of,quarantined,cold_from,kw", MATRIX,
                         ids=[m[0] for m in MATRIX])
def test_cluster_fault_matrix_matches_jax(cluster_models, clean, row, plan_of,
                                          quarantined, cold_from, kw):
    eng, plan, jeng, jplan = _engines(cluster_models, plan_of, **kw)
    reqs = _run(eng, VigRequest)
    jreqs = _run(jeng, JaxRequest)
    _assert_like_jax(eng, plan, reqs, jeng, jplan, jreqs)
    assert plan.fired, "the injector never fired"
    assert {k: r.fault.kind for k, r in reqs.items() if r.fault} == quarantined
    _, cfg, _, params = cluster_models
    st = eng.stats()
    if cold_from is None:
        # Every cluster build fails: the ladder serves the whole trace on
        # the blocked tier, bit for bit a fault-free engine there.
        assert st["fallback_level"] == 1 and st["fallback_impl"] == "blocked"
        assert st["retries"] >= eng.retry_attempts
        assert any(f["kind"] == "compile_degrade" for f in st["faults"])
        ref = _run(VigServeEngine(cfg, params, digc_impl=DigcSpec(
            impl="blocked", k=3), autotune=False, buckets=(4,), device=CPU),
            VigRequest)
        for key, r in reqs.items():
            assert np.array_equal(r.logits, ref[key].logits), key
        return
    assert st["fallback_level"] == 0 and st["state_resets"] >= 1
    for key, r in reqs.items():
        assert r.done
        if key in quarantined:
            assert r.logits is None and r.fault.tenant == "B"
        elif key not in AFFECTED_B:
            assert np.array_equal(r.logits, clean[key].logits), key
    if not quarantined:  # recovery, not quarantine: B served cold
        assert st["quarantines"] == 0 and st["requests_failed"] == 0
        assert any(f["kind"] == "state_corruption" for f in st["faults"])
        assert "centroids[1]" in plan.fired[0].detail
    want, _ = _replay(cfg, params, "cluster",
                      [IMAGES[(t, "B")] for t in cold_from])
    for tick, w in zip(cold_from, want):
        np.testing.assert_allclose(reqs[(tick, "B")].logits, w, rtol=1e-5,
                                   atol=1e-5)


def test_cluster_parking_loss_readmits_cold(cluster_models):
    """slots = 2: A and B bind, C evicts A (parked), A returns to find its
    parked rows lost: it re-admits cold, as in JAX."""
    eng, plan, jeng, jplan = _engines(
        cluster_models, lambda P: P(seed=8).inject_parking_loss("A"),
        buckets=(2,))
    rng = np.random.default_rng(11)
    imgs = {k: _image(rng) for k in ("A1", "B1", "C2", "A3")}
    out = []
    for e, cls in ((eng, VigRequest), (jeng, JaxRequest)):
        r = {}
        for uid, key in enumerate(("A1", "B1", "C2", "A3")):
            r[key] = cls(uid, imgs[key], tenant=key[0])
            e.submit(r[key])
            if key != "A1":
                e.step()
        out.append(r)
    (r, jr) = out
    _assert_like_jax(eng, plan, r, jeng, jplan, jr)
    st = eng.stats()
    assert plan.counts() == {"parking_loss": 1}
    assert st["park_losses"] == 1 and st["park_hits"] == 0
    slot = eng._tenant_slot["A"]
    assert slot in eng.last_resets and slot not in eng.last_restores
    _, cfg, _, params = cluster_models
    want, _ = _replay(cfg, params, "cluster", [imgs["A3"]])
    np.testing.assert_allclose(r["A3"].logits, want[0], rtol=1e-5, atol=1e-5)
    assert r["A3"].fault is None


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


class _Eager(VigServeEngine):
    """The same engine with its bucket programs run eagerly on the card."""

    def _captures(self):
        return False


@pytest.mark.gpu
def test_cluster_captured_equals_eager_bitwise_on_card(cuda):
    """The captured cluster programs take the read-free warm/cold branch
    and give the eager engine's logits and centroids bit for bit."""
    cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(digc_impl="cluster", **KW)
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=cuda)

    def serve(cls):
        eng = cls(cfg, params, digc_impl="cluster", autotune=False,
                  buckets=(1, 2, 4), device=cuda)
        rng = np.random.default_rng(7)
        reqs = []
        for uid, tick in enumerate(TRACE):
            for t in tick:
                reqs.append(VigRequest(len(reqs), _image(rng), tenant=t))
                eng.submit(reqs[-1])
            eng.step()
        return eng, reqs

    eager, want = serve(_Eager)
    graph, got = serve(VigServeEngine)
    for r, w in zip(got, want):
        assert np.array_equal(r.logits, w.logits), r.uid
    assert torch.equal(graph._slot_state.entries["stage0"].centroids,
                       eager._slot_state.entries["stage0"].centroids)
    assert graph.compile_count == len(graph._captured) == 3
    assert graph.stats()["fallback_level"] == 0 and not graph.fault_log
    assert 0 < graph.gate_reads < eager.gate_reads
