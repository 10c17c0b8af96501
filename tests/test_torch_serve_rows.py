"""The serving engine's slot-row lifecycle without host round trips
(``repro_torch.serve.engine``): a tick stages its row ids (the padded
lanes, then the slots admission bound cold) in one index, resets the cold
slots in one batch after admission, and skips the scatter after a program
that passed its state through.

* Against the per-request path (``_PerRequestRows``: each admission
  resets its slot at once and the tick gathers and scatters through
  ``core.state``'s functional API by Python lists, every tick): one
  mixed trace of named tenants, one-shot requests, LRU evictions with
  parking and restores, a quarantined image and an injected state fault,
  on the ``cuda`` tier and on ``blocked`` with ``reuse="tick"``; logits,
  every slot row and the integrity tokens are equal bit for bit after
  every tick. The same trace against the JAX engine (lanes, resets,
  restores, faults, row counters, cached graphs; logits within 1e-4) and
  against B = 1 stateful replays of the clean tenants.
* The lattice: an admitted slot is cold at every allocated size.
* The row counters: ``rows_reset``, ``row_index_uploads`` and
  ``scatter_skipped`` on known traces.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import builder as jbuilder  # noqa: E402
from repro.core.faults import FaultPlan as JaxPlan  # noqa: E402
from repro.models import vig as jvig  # noqa: E402
from repro.models.module import init_params as jax_init_params  # noqa: E402
from repro.serve.engine import VigRequest as JaxRequest  # noqa: E402
from repro.serve.engine import VigServeEngine as JaxEngine  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.core import DigcSpec  # noqa: E402
from repro_torch.core.faults import FaultPlan  # noqa: E402
from repro_torch.core.state import FIELDS, DigcState, state_entry  # noqa: E402
from repro_torch.models import convert, vig  # noqa: E402
from repro_torch.serve.engine import VigRequest, VigServeEngine  # noqa: E402

CPU = "cpu"
ATOL = 1e-4
KW = dict(image_size=16, patch=4, embed_dims=(16,), depths=(2,),
          num_classes=3, k=3)
REUSE = dict(reuse="tick", drift_tau=0.5, max_stale=16)
# Ticks of requests on 4 slots: a letter is a named tenant, None a
# one-shot request. Tenants are evicted (b, a at tick 3), parked and
# restored (b at 4, a at 5, e at 7).
TRACE = [["a", "b", None, None], ["a", "c", None], ["d", "e", None],
         ["b", None], ["a", "b", "c", None], ["d", None, None],
         ["a", "e", "c", "b"]]
# Tier -> (its spec for each package, its fault plan): a non-finite image
# from c at tick 5 is quarantined; at tick 2 a's row is corrupted, NaN in
# the cached graph's snapshot on blocked (quarantined) and a bit of its
# row counter on the stateless tier (served cold).
TIERS = {
    "cuda": (lambda: DigcSpec(impl="cuda", k=3),
             lambda: jbuilder.DigcSpec(impl="pallas", k=3),
             lambda P: P(seed=7).inject_nonfinite_input("c", tick=5)
             .inject_state_corruption(field="row_step", row=0, tick=2,
                                      mode="bitflip")),
    "blocked-tick": (lambda: DigcSpec(impl="blocked", k=3, **REUSE),
                     lambda: jbuilder.DigcSpec(impl="blocked", k=3, **REUSE),
                     lambda P: P(seed=8).inject_nonfinite_input("c", tick=5)
                     .inject_state_corruption(field="graph_snap", row=0,
                                              tick=2, mode="nan")),
}


@pytest.fixture(scope="module")
def models():
    jcfg = jvig.VIG_VARIANTS["vig_ti_iso"].replace(**KW)
    cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(**KW)
    tree = jax.tree.map(np.asarray, jax_init_params(
        jvig.vig_param_spec(jcfg), jax.random.PRNGKey(0)))
    return jcfg, cfg, tree, convert.params_from_numpy(cfg, tree, device=CPU)


class _PerRequestRows(VigServeEngine):
    """The row lifecycle one request at a time, through ``core.state``'s
    functional list API: an admission resets its slot at every allocated
    size at once, the tick gathers and scatters by Python lists, and
    every tick scatters."""

    def _admit(self, tenant_key, used):
        slot = super()._admit(tenant_key, used)
        if slot is not None and self.last_resets[-1:] == [slot]:
            for size, st in self._slot_states.items():
                self._slot_states[size] = st.reset_rows([slot])
        return slot

    def _row_index(self, lanes, resets=()):
        pad = self._tick_width(self.bucket_for(len(lanes))) - len(lanes)
        return lanes + [lanes[0]] * pad, []

    def _scatter(self, size, state, served, bucket_state, lanes):
        self._slot_states[size] = state.put_rows(served, list(lanes))


def _images(seed: int, n: int) -> list:
    """A named tenant's frames: a seeded image, then N(0, 0.001^2) pixel
    noise per frame."""
    rng = np.random.default_rng(seed)
    out = [testing.images(seed, 1, 16)[0]]
    for _ in range(n - 1):
        out.append((out[-1] + 0.001 * rng.standard_normal(out[-1].shape))
                   .astype(np.float32))
    return out


def _trace() -> list:
    """[(uid, tenant, image)] per tick."""
    frames = {t: _images(50 + i, len(TRACE)) for i, t in enumerate("abcde")}
    seen: dict = {}
    ticks = []
    for n, tick in enumerate(TRACE):
        reqs = []
        for t in tick:
            uid = 10 * n + len(reqs)
            if t is None:
                img = testing.images(500 + uid, 1, 16)[0]
            else:
                img = frames[t][seen.get(t, 0)]
                seen[t] = seen.get(t, 0) + 1
            reqs.append((uid, t, img))
        ticks.append(reqs)
    return ticks


def _assert_rows_equal(eng, ref):
    assert set(eng._slot_states) == set(ref._slot_states)
    for size, st in eng._slot_states.items():
        rst = ref._slot_states[size]
        assert set(st.entries) == set(rst.entries)
        for key, e in st.entries.items():
            for f in FIELDS:
                a, b = getattr(e, f), getattr(rst.entries[key], f)
                assert (a is None) == (b is None), (size, key, f)
                if a is not None:
                    assert torch.equal(a, b), (size, key, f)
    assert eng._row_tokens == ref._row_tokens
    assert eng._tokens_due == ref._tokens_due


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_mixed_trace_rows_equal_the_per_request_path(models, tier):
    jcfg, cfg, tree, params = models
    spec, jspec, plan_of = TIERS[tier]
    kw = dict(autotune=False, buckets=(1, 2, 4), device=CPU)
    eng = VigServeEngine(cfg, params, digc_impl=spec(),
                         fault_plan=plan_of(FaultPlan), **kw)
    ref = _PerRequestRows(cfg, params, digc_impl=spec(),
                          fault_plan=plan_of(FaultPlan), **kw)
    jeng = JaxEngine(jcfg, tree, digc_impl=jspec(), autotune=False,
                     buckets=(1, 2, 4), fault_plan=plan_of(JaxPlan))
    served: dict = {}
    for reqs in _trace():
        mine, refs, theirs = [], [], []
        for uid, t, img in reqs:
            mine.append(VigRequest(uid, img, tenant=t))
            refs.append(VigRequest(uid, img, tenant=t))
            theirs.append(JaxRequest(uid, img, tenant=t))
            eng.submit(mine[-1])
            ref.submit(refs[-1])
            jeng.submit(theirs[-1])
        assert eng.step() == ref.step() == jeng.step()
        got = (eng.last_lanes, eng.last_bucket, eng.last_resets,
               eng.last_restores, eng.last_quarantined)
        assert got == (ref.last_lanes, ref.last_bucket, ref.last_resets,
                       ref.last_restores, ref.last_quarantined)
        assert got == (jeng.last_lanes, jeng.last_bucket, jeng.last_resets,
                       jeng.last_restores, jeng.last_quarantined)
        for r, p, j in zip(mine, refs, theirs):
            assert r.done and p.done and j.done
            kinds = [None if x.fault is None else x.fault.kind
                     for x in (r, p, j)]
            assert kinds[0] == kinds[1] == kinds[2], (r.uid, kinds)
            if r.fault is None:
                assert np.array_equal(r.logits, p.logits), r.uid
                np.testing.assert_allclose(r.logits, j.logits, rtol=ATOL,
                                           atol=ATOL)
                served.setdefault(r.tenant, []).append(r)
            else:
                assert r.logits is None and p.logits is None
        _assert_rows_equal(eng, ref)
        if tier != "cuda":
            ent = eng._slot_state.entries["stage0"]
            jent = jeng._slot_state.entries["stage0"]
            for f in ("graph_idx", "graph_age", "row_step"):
                np.testing.assert_array_equal(getattr(ent, f).numpy(),
                                              np.asarray(getattr(jent, f)))
    s, rs, js = eng.stats(), ref.stats(), jeng.stats()
    for key in ("quarantines", "state_resets", "requests_failed",
                "park_hits", "park_evictions", "parked_tenants",
                "slot_row_steps", "slot_tenants", "graph_reuses",
                "graph_rebuilds"):
        assert s[key] == rs[key] == js[key], key
    assert s["quarantines"] >= 1 and s["park_hits"] >= 3
    assert [f["kind"] for f in s["faults"]] == [f["kind"]
                                               for f in js["faults"]]
    if tier != "cuda":
        assert s["graph_reuses"] > 0
    # The clean tenants (no fault on their rows): every request equals a
    # B = 1 stateful replay of the tenant's own stream.
    for t in ("d", "e"):
        state = vig.init_vig_state(cfg, 1, spec(), per_slot=True, device=CPU)
        for r in served[t]:
            logits, state = vig.vig_forward(
                params, torch.from_numpy(r.image[None]), cfg,
                digc_impl=spec(), state=state)
            np.testing.assert_allclose(r.logits, logits[0].numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_admitted_slot_is_cold_at_every_allocated_size(models):
    """On the lattice (16 and 24 px) tenant A warms slot 0 at both sizes;
    C, admitted into it after A's eviction (no parking), starts cold at
    both: its 16 px row served once from zero, its 24 px rows all zero,
    bit for bit the per-request path."""
    _, cfg, _, params = models
    kw = dict(digc_impl=DigcSpec(impl="blocked", k=3, **REUSE),
              autotune=False, buckets=(1, 2), image_sizes=(16, 24),
              park_capacity=0, device=CPU)
    eng = VigServeEngine(cfg, params, **kw)
    ref = _PerRequestRows(cfg, params, **kw)
    waves = [("A", 16), ("A", 24), ("B", 16), ("C", 16)]
    for uid, (t, size) in enumerate(waves):
        for e in (eng, ref):
            e.submit(VigRequest(uid, testing.images(60 + uid, 1, size)[0],
                                tenant=t))
            assert e.step() == 1
        _assert_rows_equal(eng, ref)
    assert eng._tenant_slot["C"] == 0 and eng.last_resets == [0]
    depth = sum(cfg.depths)
    assert eng.slot_row_steps(16)["stage0"][0] == depth
    cold = eng._slot_states[24].entries["stage0"]
    for f in ("row_step", "graph_idx", "graph_dist", "graph_snap",
              "graph_age"):
        assert not getattr(cold, f)[0].any(), f
    assert eng.stats()["rows_reset"] == len(waves) - 1  # all but A's return


def test_reset_rows_at_equals_reset_rows():
    """The device-index reset writes the values ``reset_rows`` writes, in
    every per-row buffer, and copies (its input is untouched)."""
    g = torch.Generator().manual_seed(3)
    e = state_entry(centroids_shape=(6, 2, 4), sq_y_shape=(6, 5),
                    graph_shape=(6, 7, 3), rows=6, device=CPU)
    e = e.map(lambda t: (torch.randn(t.shape, generator=g) * 9).to(t.dtype))
    before = e.map(lambda t: t.clone())
    st = DigcState.init({"s": e})
    want = st.reset_rows([4, 1])
    got = st.reset_rows_at(torch.tensor([4, 1]))
    for f in FIELDS:
        assert torch.equal(getattr(got.entries["s"], f),
                           getattr(want.entries["s"], f)), f
        assert torch.equal(getattr(e, f), getattr(before, f)), f
    assert got.entries["s"].row_step[[1, 4]].eq(0).all()


@pytest.mark.parametrize("tier", ["cuda", "blocked-tick"])
def test_row_counters_on_a_known_trace(models, tier):
    """One-shot ticks of 4 then 3 requests and two named ticks: every
    admission that resets counts in ``rows_reset``, each tick stages one
    index, and only the stateless tier skips its scatters."""
    _, cfg, _, params = models
    eng = VigServeEngine(cfg, params, digc_impl=TIERS[tier][0](),
                         autotune=False, buckets=(1, 2, 4), device=CPU)
    waves = [[None] * 4, [None] * 3, ["A", "B"], ["A", "B", None]]
    resets = 0
    for n, wave in enumerate(waves):
        for i, t in enumerate(wave):
            eng.submit(VigRequest(10 * n + i,
                                  testing.images(70 + 10 * n + i, 1, 16)[0],
                                  tenant=t))
        eng.step()
        resets += len(eng.last_resets)
    s = eng.stats()
    assert resets == 4 + 3 + 2 + 1
    assert s["rows_reset"] == resets
    assert s["row_index_uploads"] == len(waves)
    assert s["scatter_skipped"] == (len(waves) if tier == "cuda" else 0)


def test_a_quarantine_restages_the_index_once(models):
    """A tick whose screen drops a lane stages its index again: one more
    upload, no more resets than admissions."""
    _, cfg, _, params = models
    plan = FaultPlan(seed=9).inject_nonfinite_input("B", tick=1)
    eng = VigServeEngine(cfg, params, digc_impl="cuda", autotune=False,
                         buckets=(1, 2, 4), fault_plan=plan, device=CPU)
    for i, t in enumerate("ABC"):
        eng.submit(VigRequest(i, testing.images(80 + i, 1, 16)[0], tenant=t))
    assert eng.step() == 2 and eng.last_bucket == 2
    s = eng.stats()
    assert (s["quarantines"], s["rows_reset"], s["row_index_uploads"],
            s["scatter_skipped"]) == (1, 3, 2, 1)
