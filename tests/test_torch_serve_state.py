"""The port's stateful multi-tenant engine (``repro_torch.serve``): per-slot
DIGC state rows, stale-graph reuse counters, LRU parking and
``release()``, against the JAX ``VigServeEngine`` on the same trace and
against B = 1 replays of each tenant.

* Parity with JAX: on one ragged trace of video-like tenants (frame t + 1
  = frame t + N(0, 0.001^2) pixel noise), one tenant whose every frame is
  a new image and slot churn with parking, both engines bind the same
  lanes, reset and restore the same slots, count the same graph reuses
  and rebuilds, and serve logits within 1e-4. The drift per tick stays
  10% or more away from tau (the packages' statistics differ by ulps).
* Lifecycle properties (stubbed programs): padding lanes never mutate
  live rows, admission never evicts an active tenant, parking is LRU
  bounded and ``release()`` drops the parked copy.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import builder as jbuilder  # noqa: E402
from repro.models import vig as jvig  # noqa: E402
from repro.models.module import init_params as jax_init_params  # noqa: E402
from repro.serve.engine import VigRequest as JaxRequest  # noqa: E402
from repro.serve.engine import VigServeEngine as JaxEngine  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.core import DigcSpec  # noqa: E402
from repro_torch.core.digc import drift_stat  # noqa: E402
from repro_torch.core.state import DigcState  # noqa: E402
from repro_torch.models import convert, vig  # noqa: E402
from repro_torch.serve.engine import VigRequest, VigServeEngine  # noqa: E402

CPU = "cpu"
ATOL = 1e-4
TAU = 0.002
KW = dict(image_size=16, patch=4, embed_dims=(16,), depths=(2,),
          num_classes=3, k=3)


def _spec(**kw):
    return DigcSpec(impl="blocked", k=3, **kw)


def _models():
    jcfg = jvig.VIG_VARIANTS["vig_ti_iso"].replace(**KW)
    cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(**KW)
    tree = jax.tree.map(np.asarray, jax_init_params(
        jvig.vig_param_spec(jcfg), jax.random.PRNGKey(0)))
    return jcfg, cfg, tree, convert.params_from_numpy(cfg, tree, device=CPU)


def _frames(seed: int, n: int, sigma: float) -> list:
    """A tenant's frames: a seeded image, then N(0, sigma^2) pixel noise
    added per frame; sigma None gives a new image every frame."""
    rng = np.random.default_rng(seed)
    if sigma is None:
        return [testing.images(seed * 100 + t, 1, 16)[0] for t in range(n)]
    out = [testing.images(seed, 1, 16)[0]]
    for _ in range(n - 1):
        out.append((out[-1] + sigma * rng.standard_normal(out[-1].shape))
                   .astype(np.float32))
    return out


# Ticks of tenants; "n" sends a new image every frame, "e" arrives late
# and evicts the least recently used tenant on 4 slots, which returns.
TRACE = [["a", "b", "c", "n"], ["a", "b", "n"], ["a", "c", "n"],
         ["e", "n", "b"], ["a", "n"], ["a", "b", "c", "n"], ["e"],
         ["a", "b", "c", "n"]]


def _requests():
    frames = {t: _frames(i + 1, 8, None if t == "n" else 0.001)
              for i, t in enumerate("abcen")}
    seen: dict = {}
    ticks = []
    for uid_base, tick in enumerate(TRACE):
        reqs = []
        for t in tick:
            i = seen.get(t, 0)
            seen[t] = i + 1
            reqs.append((10 * uid_base + len(reqs), t, frames[t][i]))
        ticks.append(reqs)
    return ticks


def test_reuse_trace_matches_jax_engine():
    jcfg, cfg, tree, params = _models()
    ticks = _requests()
    # Every gated drift is 10% or more away from tau: each tenant's block-0
    # statistic between any two of its frames.
    per_tenant: dict = {}
    for reqs in ticks:
        for _, t, img in reqs:
            cap: list = []
            vig.vig_forward(params, torch.from_numpy(img[None]), cfg,
                            digc_impl="blocked", digc_capture=cap)
            per_tenant.setdefault(t, []).append(float(drift_stat(cap[0][1])[0]))
    for t, stats in per_tenant.items():
        s = np.asarray(stats)
        rel = np.abs(s[:, None] - s[None]) / np.abs(s[None])
        assert (np.abs(rel - TAU) > 0.1 * TAU).all(), (t, rel)

    spec = _spec(reuse="tick", drift_tau=TAU, max_stale=3)
    jspec = jbuilder.DigcSpec(impl="blocked", k=3, reuse="tick",
                              drift_tau=TAU, max_stale=3)
    eng = VigServeEngine(cfg, params, digc_impl=spec, autotune=False,
                         buckets=(1, 2, 4), device=CPU)
    jeng = JaxEngine(jcfg, tree, digc_impl=jspec, autotune=False,
                     buckets=(1, 2, 4))
    for reqs in ticks:
        mine, theirs = [], []
        for uid, t, img in reqs:
            mine.append(VigRequest(uid, img, tenant=t))
            theirs.append(JaxRequest(uid, img, tenant=t))
            eng.submit(mine[-1])
            jeng.submit(theirs[-1])
        assert eng.step() == jeng.step() == len(reqs)
        assert (eng.last_lanes, eng.last_bucket, eng.last_resets,
                eng.last_restores) == (jeng.last_lanes, jeng.last_bucket,
                                       jeng.last_resets, jeng.last_restores)
        for r, jr in zip(mine, theirs):
            np.testing.assert_allclose(r.logits, jr.logits, rtol=ATOL,
                                       atol=ATOL)
        ent = eng._slot_state.entries["stage0"]
        jent = jeng._slot_state.entries["stage0"]
        np.testing.assert_array_equal(ent.graph_age.numpy(),
                                      np.asarray(jent.graph_age))
        np.testing.assert_array_equal(ent.graph_idx.numpy(),
                                      np.asarray(jent.graph_idx))
        if "n" in eng._tenant_slot:  # the new-image tenant rebuilt
            assert int(ent.graph_age[eng._tenant_slot["n"]]) == 0
    s, js = eng.stats(), jeng.stats()
    for key in ("graph_reuses", "graph_rebuilds", "park_hits",
                "park_evictions", "parked_tenants", "slot_row_steps",
                "slot_tenants"):
        assert s[key] == js[key], key
    assert s["drift"]["mean"] == pytest.approx(js["drift"]["mean"], rel=1e-3)
    assert s["graph_reuses"] > 0 and s["park_hits"] > 0
    # one host read per gated DIGC call: each block of each tick
    assert s["gate_reads"] == len(ticks) * sum(cfg.depths)


def test_reuse_tenant_equals_its_solo_replay_through_eviction():
    """Every request of every tenant equals a B = 1 stateful replay of
    that tenant's own stream, bit for bit: warm state follows the tenant
    across buckets, padding lanes and a park / restore."""
    _, cfg, _, params = _models()
    spec = _spec(reuse="tick", drift_tau=TAU, max_stale=3)
    eng = VigServeEngine(cfg, params, digc_impl=spec, autotune=False,
                         buckets=(1, 2, 4), device=CPU)
    per_tenant: dict = {}
    for reqs in _requests():
        for uid, t, img in reqs:
            r = VigRequest(uid, img, tenant=t)
            per_tenant.setdefault(t, []).append(r)
            eng.submit(r)
        eng.step()
    for t, reqs in per_tenant.items():
        state = vig.init_vig_state(cfg, 1, spec, per_slot=True, device=CPU)
        for r in reqs:
            logits, state = vig.vig_forward(
                params, torch.from_numpy(r.image[None]), cfg, digc_impl=spec,
                state=state)
            np.testing.assert_allclose(r.logits, logits[0].numpy(), rtol=1e-5,
                                       atol=1e-5)


def test_cuda_tier_passes_state_through_and_matches_bucket_forward():
    """The stateless kernel tier (its plain version on the CPU): the slot
    rows never change, and every request's logits equal, bit for bit, a
    stateless forward of the tick's bucket batch (lanes sorted by slot,
    padding replicating lane 0)."""
    _, cfg, _, params = _models()
    eng = VigServeEngine(cfg, params, digc_impl="cuda", autotune=False,
                         buckets=(1, 2, 4), device=CPU)
    for reqs in _requests()[:4]:
        mine = [VigRequest(uid, img, tenant=t) for uid, t, img in reqs]
        for r in mine:
            eng.submit(r)
        eng.step()
        order = sorted(mine, key=lambda r: eng._tenant_slot[r.tenant])
        imgs = [r.image for r in order]
        imgs += [imgs[0]] * (eng.last_bucket - len(imgs))
        ref = vig.vig_forward(params, torch.from_numpy(np.stack(imgs)), cfg,
                              digc_impl="cuda")
        for i, r in enumerate(order):
            assert np.array_equal(r.logits, ref[i].numpy())
    assert eng.slot_row_steps() == {"stage0": [0, 0, 0, 0]}
    assert eng.stats()["graph_reuses"] == eng.stats()["gate_reads"] == 0


def test_reuse_off_keeps_counters_zero_and_direct_path_keeps_state():
    _, cfg, _, params = _models()
    eng = VigServeEngine(cfg, params, digc_impl="blocked", autotune=False,
                         buckets=(1,), device=CPU)
    img = testing.images(6, 1, 16)[0]
    for uid in range(2):
        eng.submit(VigRequest(uid, img, tenant="A"))
        eng.step()
    s = eng.stats()
    assert (s["graph_reuses"], s["graph_rebuilds"]) == (0, 0)
    assert s["drift"] == {"mean": 0.0, "last": {}}
    assert s["slot_row_steps"] == {"stage0": [4]}  # 2 blocks x 2 requests
    # the direct path: one state per exact batch size
    batch = testing.images(7, 2, 16)
    out = eng.infer(batch)
    eng.infer(batch)
    eng.infer(batch[:1])
    assert eng.state_steps() == {2: {"stage0": 4}, 1: {"stage0": 2}}
    assert torch.equal(out, vig.vig_forward(params, torch.from_numpy(batch),
                                            cfg, digc_impl="blocked"))


def test_padding_lanes_keep_warm_gate_and_idle_rows():
    """One tenant on a bucket-4 engine (three padding lanes a tick): its
    second tick serves the cached graph, idle slots stay zero and
    ``release`` cold-resets its slot."""
    _, cfg, _, params = _models()
    spec = _spec(reuse="tick", drift_tau=TAU, max_stale=8)
    eng = VigServeEngine(cfg, params, digc_impl=spec, autotune=False,
                         buckets=(4,), device=CPU)
    frames = _frames(3, 3, 0.001)
    for uid in range(2):
        eng.submit(VigRequest(uid, frames[uid], tenant="A"))
        eng.step()
    slot = eng._tenant_slot["A"]
    ent = eng._slot_state.entries["stage0"]
    assert int(ent.graph_age[slot]) == 1  # tick 2 served the cache
    assert eng.stats()["graph_reuses"] == 1
    for s in range(eng.slots):
        if s != slot:
            assert int(ent.row_step[s]) == 0 and not ent.graph_idx[s].any()
    eng.release("A")
    ent = eng._slot_state.entries["stage0"]
    assert eng.slot_tenant[slot] is None
    assert int(ent.row_step[slot]) == 0 and not ent.graph_idx[slot].any()


def test_park_readmit_serves_cached_graph_like_jax():
    """Evict a warm tenant (its rows are parked), re-admit it: its first
    tick back serves its cached graph (no rebuild, age grows), as in
    JAX, and its logits equal an uninterrupted B = 1 replay."""
    jcfg, cfg, tree, params = _models()
    spec = _spec(reuse="tick", drift_tau=TAU, max_stale=16)
    jspec = jbuilder.DigcSpec(impl="blocked", k=3, reuse="tick",
                              drift_tau=TAU, max_stale=16)
    eng = VigServeEngine(cfg, params, digc_impl=spec, autotune=False,
                         buckets=(1, 2), device=CPU)
    jeng = JaxEngine(jcfg, tree, digc_impl=jspec, autotune=False,
                     buckets=(1, 2))
    imgs = {t: testing.images(20 + i, 1, 16)[0] for i, t in enumerate("ABC")}
    waves = [["A", "B"], ["A", "B"], ["B"], ["C"], ["A"]]
    history = []
    for uid, wave in enumerate(waves):
        for t in wave:
            eng.submit(VigRequest(uid, imgs[t], tenant=t))
            jeng.submit(JaxRequest(uid, imgs[t], tenant=t))
            if t == "A":
                history.append(eng.queue[-1])
        if wave == ["A"]:
            assert "A" in eng._parked and "A" in jeng._parked
            rebuilds = eng.graph_rebuilds
        eng.step()
        jeng.step()
    assert eng.park_hits == jeng.park_hits == 1
    assert eng.graph_rebuilds == rebuilds  # served from the parked graph
    slot = eng._tenant_slot["A"]
    assert int(eng._slot_state.entries["stage0"].graph_age[slot]) > 0
    assert eng.stats()["graph_rebuilds"] == jeng.stats()["graph_rebuilds"]
    state = vig.init_vig_state(cfg, 1, spec, per_slot=True, device=CPU)
    for r in history:
        logits, state = vig.vig_forward(params, torch.from_numpy(r.image[None]),
                                        cfg, digc_impl=spec, state=state)
    np.testing.assert_allclose(history[-1].logits, logits[0].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_eviction_readmits_cold_when_parking_is_off():
    _, cfg, _, params = _models()
    spec = _spec(reuse="tick", drift_tau=TAU)
    eng = VigServeEngine(cfg, params, digc_impl=spec, autotune=False,
                         buckets=(1, 2), park_capacity=0, device=CPU)
    img = testing.images(30, 1, 16)[0]
    for uid, wave in enumerate([["A", "B"], ["C"], ["A"]]):
        for t in wave:
            eng.submit(VigRequest(uid, img, tenant=t))
        eng.step()
    assert not eng._parked and eng.park_hits == 0
    assert eng.last_resets and not eng.last_restores


# ---------------------------------------------------------------------------
# Lifecycle properties on stubbed programs (no forward runs)


class _StubEngine(VigServeEngine):
    def _build_program(self, bucket):
        def fake(imgs, state):
            new = DigcState(entries={
                k: e.bump(graph_age=e.graph_age + 1)
                for k, e in state.entries.items()})
            return torch.zeros(imgs.shape[0], self.cfg.num_classes), new

        return fake


def _stub(buckets, park=8):
    cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(**KW)
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=CPU)
    return _StubEngine(cfg, params, digc_impl=_spec(reuse="tick"),
                       autotune=False, buckets=buckets, park_capacity=park,
                       device=CPU)


def _rows(state, slot):
    e = state.entries["stage0"]
    return [getattr(e, f)[slot].clone() for f in (
        "row_step", "graph_idx", "graph_dist", "graph_snap", "graph_age")]


@pytest.mark.parametrize("seed", range(6))
def test_padding_never_mutates_live_rows(seed):
    """Arrivals of tenants 0-5 on 4 slots (padding, eviction, parking and
    restores all occur): after every tick, slots that neither served nor
    were reset or restored are bit for bit unchanged, served slots
    advanced once from their base (0 after a reset, the parked value
    after a restore), and the bucket was the smallest that fits."""
    rng = np.random.default_rng(seed)
    eng = _stub((1, 2, 4))
    img = np.zeros((16, 16, 3), np.float32)
    arrivals = rng.integers(0, 6, 14).tolist()
    for i, t in enumerate(arrivals):
        eng.submit(VigRequest(i, img, tenant=t))
    served_total = 0
    while eng.queue:
        state = eng._ensure_slot_state()
        before = {s: _rows(state, s) for s in range(eng.slots)}
        parked = {t: int(st.entries["stage0"].row_step[0])
                  for t, st in eng._parked.items()}
        served = eng.step()
        served_total += served
        assert served == len(eng.last_lanes) >= 1
        assert eng.last_bucket == eng.bucket_for(served)
        touched = set(eng.last_lanes) | set(eng.last_resets) | set(eng.last_restores)
        after = eng._slot_state
        for s in range(eng.slots):
            if s not in touched:
                for a, b in zip(before[s], _rows(after, s)):
                    assert torch.equal(a, b)
            elif s in eng.last_lanes:
                if s in eng.last_resets:
                    base = 0
                elif s in eng.last_restores:
                    base = parked[eng.slot_tenant[s]]
                else:
                    base = int(before[s][0])
                assert int(after.entries["stage0"].row_step[s]) == base + 1
    assert served_total == len(arrivals)


def test_parking_lru_capacity_and_release():
    eng = _stub((1, 2), park=2)
    img = np.zeros((16, 16, 3), np.float32)
    for uid, t in enumerate("ABCDE"):
        eng.submit(VigRequest(uid, img, tenant=t))
        eng.step()
    assert list(eng._parked) == ["B", "C"]  # A dropped at capacity
    assert eng.park_evictions == 1
    parked_b = eng._parked["B"].entries["stage0"]
    assert parked_b.row_step.device.type == "cpu"
    eng.release("C")
    assert "C" not in eng._parked
    eng.submit(VigRequest(9, img, tenant="B"))
    eng.step()
    assert eng.park_hits == 1 and "B" not in eng._parked
    assert eng.last_restores and not eng.last_resets
    slot = eng._tenant_slot["B"]
    # restored from its parked row, then served once more
    assert int(eng._slot_state.entries["stage0"].row_step[slot]) == int(
        parked_b.row_step[0]) + 1
    assert eng.stats()["parked_tenants"] == ["D"]  # B evicted D


def test_anonymous_requests_free_slots_and_active_tenants_keep_theirs():
    eng = _stub((1, 2))
    img = np.zeros((16, 16, 3), np.float32)
    eng.submit(VigRequest(0, img, tenant="A"))
    eng.step()
    for uid in range(1, 4):  # one-shots churn the other slot, cold
        eng.submit(VigRequest(uid, img))
        eng.step()
        assert eng.last_resets
    a_slot = eng._tenant_slot["A"]
    assert eng.slot_row_steps()["stage0"][a_slot] == 1
    # queue [C, A] on a full engine: A keeps its slot, C evicts idle B
    eng.submit(VigRequest(5, img, tenant="B"))
    eng.step()
    eng.submit(VigRequest(6, img, tenant="C"))
    eng.submit(VigRequest(7, img, tenant="A"))
    assert eng.step() == 2
    assert eng._tenant_slot["A"] == a_slot
    assert eng.slot_row_steps()["stage0"][a_slot] == 2
    assert "B" not in eng._tenant_slot and "B" in eng._parked
