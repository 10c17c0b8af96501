"""The multi-resolution (B, N) lattice of the port (``repro_torch``):
off-native grids, ``valid_mask`` pad nodes and the engine's
``image_sizes`` cells, against the JAX package on the same inputs.

* ``_pos_for_grid`` equals JAX's bilinear ``jax.image.resize`` of the
  positional embedding within 1e-6, shrinking and growing (14 -> 10,
  14 -> 28, and the pyramid's 56 -> 48 and 56 -> 64).
* ``vig_forward`` off the native grid and with ``valid_mask`` (numpy or
  tensor, (N,) or (B, N)) equals JAX's within rtol / atol 1e-5; pad nodes
  never enter a live row's top-k; a pooled or multi-stage model refuses
  the mask with JAX's ``VigGridError``.
* The engine on a tiny model (16^2 / patch 4, one stage, r = 1, 2 blocks):
  a mixed 16/24/32 trace on 2 slots (evictions, parking at two sizes)
  serves the same cells, lanes, resets and restores as the JAX engine
  with logits within 1e-4 (blocked tier, ``reuse="layer"`` at a tau no
  drift reaches, so each row's reuse depends on its age only and the
  warm state shows in the logits), and every request equals its own
  (tenant, size) B = 1 replay within 1e-5; B = 1 cells and padded cells
  equal their replays bit for bit; construction and submit errors carry
  JAX's messages; ``buckets=None`` serves exact batch sizes as JAX; the
  bind-on-next-tick cell order equals JAX's tick by tick (a hypothesis
  property on stubbed programs).

Marked ``gpu`` (skipped without a card): a padded cell captured as a CUDA
graph, its mask a static input refilled each tick, bit for bit the eager
engine; a device mask and a host mask give equal results.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _hypothesis_compat import given, settings, st  # noqa: E402

from repro.core import DigcSpec as JSpec  # noqa: E402
from repro.core import digc as jdigc  # noqa: E402
from repro.core.state import DigcState as JState  # noqa: E402
from repro.models import vig as jvig  # noqa: E402
from repro.models.module import init_params as jax_init_params  # noqa: E402
from repro.serve.engine import VigRequest as JaxRequest  # noqa: E402
from repro.serve.engine import VigServeEngine as JaxEngine  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.core import DigcSpec, digc  # noqa: E402
from repro_torch.core.engine import live_mask  # noqa: E402
from repro_torch.core.state import DigcState  # noqa: E402
from repro_torch.models import convert, vig  # noqa: E402
from repro_torch.serve.engine import VigRequest, VigServeEngine  # noqa: E402

CPU = "cpu"
ATOL = 1e-4  # logits across the packages (fp32 sums in other orders)
KW = dict(image_size=16, patch=4, embed_dims=(16,), depths=(2,),
          num_classes=3, k=3)
# A tau no drift reaches: a warm row reuses its graph until it is
# max_stale old, so reuse depends on the row's age only.
REUSE = dict(reuse="layer", drift_tau=1e9, max_stale=2)


def _models(**kw):
    kw = {**KW, **kw}
    jcfg = jvig.VIG_VARIANTS["vig_ti_iso"].replace(**kw)
    cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(**kw)
    tree = jax.tree.map(np.asarray, jax_init_params(
        jvig.vig_param_spec(jcfg), jax.random.PRNGKey(0)))
    return jcfg, cfg, tree, convert.params_from_numpy(cfg, tree, device=CPU)


def _image(seed: int, size: int) -> np.ndarray:
    return testing.images(seed, 1, size)[0]


def _pair(cfg, params, jcfg, tree, spec, jspec, **kw):
    eng = VigServeEngine(cfg, params, digc_impl=spec, autotune=False,
                         device=CPU, **kw)
    jeng = JaxEngine(jcfg, tree, digc_impl=jspec, autotune=False, **kw)
    return eng, jeng


def _replay(cfg, params, spec, reqs, size):
    """The port's B = 1 stateful replay of one (tenant, size) stream."""
    state = vig.init_vig_state(cfg, 1, spec, per_slot=True,
                               grid=size // cfg.patch, device=CPU)
    out = []
    for r in reqs:
        logits, state = vig.vig_forward(params, torch.from_numpy(r.image[None]),
                                        cfg, digc_impl=spec, state=state)
        out.append(logits[0].numpy())
    return out


# ---------------------------------------------------------------------------
# Off-native grids and valid_mask in the model


@pytest.mark.parametrize("base,grid", [(14, 10), (14, 28), (56, 48), (56, 64)])
def test_pos_for_grid_matches_jax_resize(base, grid):
    pos = testing.features(base + grid, base * base, 48)
    want = np.asarray(jvig._pos_for_grid(jnp.asarray(pos), base, grid))
    got = vig._pos_for_grid(torch.from_numpy(pos), base, grid)
    assert got.shape == (grid * grid, 48) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # deterministic, and the identity at the native grid
    assert torch.equal(got, vig._pos_for_grid(torch.from_numpy(pos), base,
                                              grid))
    same = torch.from_numpy(pos)
    assert vig._pos_for_grid(same, base, base) is same


@pytest.mark.parametrize("name,kw,size", [
    ("vig_ti_iso", {}, 24),  # grows: k and the dilation ramp
    ("vig_ti_iso", {}, 8),  # shrinks
    ("vig_ti_pyr", dict(image_size=32, embed_dims=(8, 12, 16, 24),
                        depths=(1, 1, 1, 1)), 64),
])
def test_off_native_forward_matches_jax(name, kw, size):
    kw = {**KW, **kw}
    jcfg = jvig.VIG_VARIANTS[name].replace(**kw)
    cfg = vig.VIG_VARIANTS[name].replace(**kw)
    tree = jax.tree.map(np.asarray, jax_init_params(
        jvig.vig_param_spec(jcfg), jax.random.PRNGKey(1)))
    params = convert.params_from_numpy(cfg, tree, device=CPU)
    imgs = testing.images(3, 2, size)
    want = np.asarray(jvig.vig_forward(tree, jnp.asarray(imgs), jcfg,
                                       digc_impl="blocked"))
    got = vig.vig_forward(params, torch.from_numpy(imgs), cfg,
                          digc_impl="blocked")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _ragged_batch(sizes, size):
    """Images zero-padded to ``size`` and their (B, N) live masks."""
    imgs, masks = [], []
    for i, s in enumerate(sizes):
        canvas = np.zeros((size, size, 3), np.float32)
        canvas[:s, :s] = _image(40 + i, s)
        g, g0 = size // 4, s // 4
        m = np.zeros((g, g), bool)
        m[:g0, :g0] = True
        imgs.append(canvas)
        masks.append(m.reshape(-1))
    return np.stack(imgs), np.stack(masks)


@pytest.mark.parametrize("spec_kw", [{}, REUSE])
def test_valid_mask_forward_matches_jax(spec_kw):
    jcfg, cfg, tree, params = _models()
    imgs, masks = _ragged_batch([20, 12, 24], 24)
    spec = DigcSpec(impl="blocked", k=3, **spec_kw)
    jspec = JSpec(impl="blocked", k=3, **spec_kw)
    st = vig.init_vig_state(cfg, 3, spec, per_slot=True, grid=6, device=CPU)
    jst = jvig.init_vig_state(jcfg, 3, jspec, per_slot=True, grid=6)
    for _ in range(2):  # the second call runs warm
        want, jst = jvig.vig_forward(tree, jnp.asarray(imgs), jcfg,
                                     digc_impl=jspec, state=jst,
                                     valid_mask=jnp.asarray(masks))
        got, st = vig.vig_forward(params, torch.from_numpy(imgs), cfg,
                                  digc_impl=spec, state=st, valid_mask=masks)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    # a numpy mask, a tensor mask and Vig.forward agree bit for bit; a
    # (N,) mask broadcasts over the batch
    t_mask = torch.from_numpy(masks)
    a = vig.vig_forward(params, torch.from_numpy(imgs), cfg,
                        digc_impl="blocked", valid_mask=masks)
    b = vig.vig_forward(params, torch.from_numpy(imgs), cfg,
                        digc_impl="blocked", valid_mask=t_mask)
    model = vig.Vig(cfg, params, digc_impl="blocked", device=CPU)
    c = model(torch.from_numpy(imgs), valid_mask=t_mask)
    assert torch.equal(a, b) and torch.equal(a, c)
    one = vig.vig_forward(params, torch.from_numpy(imgs[:1]), cfg,
                          digc_impl="blocked", valid_mask=masks[0])
    assert torch.equal(one, vig.vig_forward(
        params, torch.from_numpy(imgs[:1]), cfg, digc_impl="blocked",
        valid_mask=masks[:1]))
    assert live_mask(t_mask, torch.device(CPU)) is t_mask  # no copy


def test_valid_mask_refused_by_pooled_and_multistage_models():
    for name, kw in [("vig_ti_iso", dict(reduce_ratios=(2,))),
                     ("vig_ti_pyr", dict(image_size=32,
                                         embed_dims=(8, 12, 16, 24),
                                         depths=(1, 1, 1, 1)))]:
        kw = {**KW, **kw}
        jcfg = jvig.VIG_VARIANTS[name].replace(**kw)
        cfg = vig.VIG_VARIANTS[name].replace(**kw)
        tree = jax.tree.map(np.asarray, jax_init_params(
            jvig.vig_param_spec(jcfg), jax.random.PRNGKey(0)))
        params = convert.params_from_numpy(cfg, tree, device=CPU)
        n = (cfg.image_size // cfg.patch) ** 2
        img = testing.images(0, 1, cfg.image_size)
        with pytest.raises(jvig.VigGridError) as want:
            jvig.vig_forward(tree, jnp.asarray(img), jcfg,
                             valid_mask=jnp.ones(n, bool))
        with pytest.raises(vig.VigGridError) as got:
            vig.vig_forward(params, torch.from_numpy(img), cfg,
                            valid_mask=np.ones(n, bool))
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("impl", ["reference", "blocked"])
def test_pad_nodes_never_enter_live_topk(impl):
    """Garbage pad nodes under a mask leave every live row's top-k as the
    live-only build's, and the port's lists equal JAX's."""
    n0, n_pad, d = 20, 12, 8
    x_live = testing.features(1, 2, n0, d)
    pads = 100.0 * testing.features(2, 2, n_pad, d)
    x_pad = np.concatenate([x_live, pads], axis=1)
    mask = np.zeros(n0 + n_pad, bool)
    mask[:n0] = True
    spec = DigcSpec(impl=impl, k=4)
    idx_live = digc(torch.from_numpy(x_live), spec=spec).numpy()
    idx_pad = digc(torch.from_numpy(x_pad), spec=spec,
                   m_valid=torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(idx_pad[:, :n0], idx_live)
    assert (idx_pad < n0).all()  # no pad index selected, in any row
    jidx = np.asarray(jdigc(jnp.asarray(x_pad), spec=JSpec(impl=impl, k=4),
                            m_valid=jnp.asarray(mask)))
    np.testing.assert_array_equal(idx_pad, jidx)


def test_live_mask_copies_nothing_and_refuses_host_masks_under_capture(
        monkeypatch):
    """A bool tensor on the device is used as it is (a captured graph
    reads the caller's buffer); under capture a host mask, which would be
    copied once into the graph, raises."""
    mask = torch.tensor([True, False, True])
    assert live_mask(mask, torch.device(CPU)) is mask
    assert torch.equal(live_mask(np.array([1, 0, 1]), torch.device(CPU)), mask)
    assert torch.equal(live_mask(mask.int(), torch.device(CPU)), mask)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(ValueError, match="capturing device"):
        live_mask(np.array([True, False]), torch.device("cuda", 0))


def test_pad_mask_refused_by_the_kernel_tier():
    x = torch.from_numpy(testing.features(2, 1, 16, 8))
    with pytest.raises(ValueError, match="pad-node masking"):
        digc(x, spec=DigcSpec(impl="cuda", k=3), m_valid=torch.ones(16, dtype=bool))


# ---------------------------------------------------------------------------
# The engine's lattice against the JAX engine


# Waves of (tenant, size) on 2 slots: tenants move between sizes, so LRU
# eviction parks rows of several sizes.
WAVES = [[("A", 16)], [("B", 24), ("C", 16)], [("A", 16), ("B", 24)],
         [("C", 32)], [("A", 24)], [("A", 16), ("C", 16)], [("B", 24)],
         [("A", 24), ("B", 16)]]


def test_mixed_trace_matches_jax_and_same_resolution_replay():
    jcfg, cfg, tree, params = _models()
    spec = DigcSpec(impl="blocked", k=3, **REUSE)
    jspec = JSpec(impl="blocked", k=3, **REUSE)
    compiled, jcompiled = [], []
    eng = VigServeEngine(cfg, params, digc_impl=spec, autotune=False,
                         buckets=(1, 2), image_sizes=(16, 24, 32),
                         on_compile=compiled.append, device=CPU)
    jeng = JaxEngine(jcfg, tree, digc_impl=jspec, autotune=False,
                     buckets=(1, 2), image_sizes=(16, 24, 32),
                     on_compile=jcompiled.append)
    streams: dict = {}
    uid = 0
    for wave in WAVES:
        for t, s in wave:
            img = _image(100 + uid, s)
            req = VigRequest(uid, img, tenant=t)
            streams.setdefault((t, s), []).append(req)
            eng.submit(req)
            jreq = JaxRequest(uid, img, tenant=t)
            jeng.submit(jreq)
            req._jax = jreq
            uid += 1
        while eng.queue or jeng.queue:  # a wave may span several cells
            assert eng.step() == jeng.step()
            assert (eng.last_cell, eng.last_lanes, eng.last_resets,
                    eng.last_restores) == (jeng.last_cell, jeng.last_lanes,
                                           jeng.last_resets,
                                           jeng.last_restores)
            size, bucket = eng.last_cell
            assert bucket == eng.bucket_for(len(eng.last_lanes))
    for (t, s), reqs in streams.items():
        for req, ref in zip(reqs, _replay(cfg, params, spec, reqs, s)):
            assert req.done and req.fault is None
            np.testing.assert_allclose(req.logits, ref, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(req.logits, req._jax.logits,
                                       rtol=ATOL, atol=ATOL)
    assert compiled == jcompiled
    assert eng.compile_count == len(set(compiled)) <= 2 * 3
    assert all(s in eng.image_sizes and b in eng.buckets for s, b in compiled)
    s, js = eng.stats(), jeng.stats()
    for k in ("cell_ticks", "bucket_ticks", "lane_hist", "park_hits",
              "park_evictions", "parked_tenants", "graph_reuses",
              "graph_rebuilds", "live_lanes", "padded_lanes", "util",
              "image_sizes"):
        assert s[k] == js[k], k
    assert s["graph_reuses"] > 0 and s["park_hits"] > 0
    for size in eng.image_sizes:
        assert eng.slot_row_steps(size) == jeng.slot_row_steps(size)


def test_eviction_parks_and_restores_every_n_bucket():
    """A tenant warm at two sizes, LRU-evicted, comes back warm at both:
    the parked copy is {size: rows}, as in JAX."""
    jcfg, cfg, tree, params = _models()
    spec = DigcSpec(impl="blocked", k=3)
    eng, jeng = _pair(cfg, params, jcfg, tree, spec, JSpec(impl="blocked", k=3),
                      buckets=(1,), image_sizes=(16, 24))
    plan = [("A", 16), ("A", 24), ("B", 16), ("C", 16)]
    for uid, (t, s) in enumerate(plan):
        for e, cls in ((eng, VigRequest), (jeng, JaxRequest)):
            e.submit(cls(uid, _image(uid, s), tenant=t))
            e.run()
    assert set(eng._parked["A"]) == set(jeng._parked["A"]) == {16, 24}
    for size in (16, 24):
        assert isinstance(eng._parked["A"][size], DigcState)
        assert eng._parked["A"][size].row_steps() == {
            k: [int(v) for v in np.asarray(e.row_step)]
            for k, e in jeng._parked["A"][size].entries.items()}
    for e, cls in ((eng, VigRequest), (jeng, JaxRequest)):
        e.submit(cls(20, _image(20, 16), tenant="A"))
        e.run()
    assert eng.park_hits == jeng.park_hits == 1
    a_slot = eng._tenant_slot["A"]
    assert eng.slot_row_steps(16)["stage0"][a_slot] == 4
    assert eng.slot_row_steps(24)["stage0"][a_slot] == 2
    for size in (16, 24):
        assert eng.slot_row_steps(size) == jeng.slot_row_steps(size)


def test_b1_cells_bitwise_identical_to_replay():
    jcfg, cfg, tree, params = _models()
    spec = DigcSpec(impl="blocked", k=3, **REUSE)
    eng = VigServeEngine(cfg, params, digc_impl=spec, autotune=False,
                         buckets=(1,), image_sizes=(16, 24), device=CPU)
    streams: dict = {}
    for uid, (t, s) in enumerate([("A", 16), ("B", 24), ("A", 16), ("B", 24),
                                  ("A", 24), ("A", 16)]):
        req = VigRequest(uid, _image(200 + uid, s), tenant=t)
        streams.setdefault((t, s), []).append(req)
        eng.submit(req)
    eng.run()
    for (t, s), reqs in streams.items():
        for req, ref in zip(reqs, _replay(cfg, params, spec, reqs, s)):
            np.testing.assert_array_equal(req.logits, ref)


def test_padded_requests_match_masked_replay_and_jax():
    """Ragged 20, 24 and 12 px requests served through the 32 and 16 px
    cells' padded programs (20 and 24 share a padded tick): a B = 1 tick
    bit for bit a masked forward of the same canvas, a bucket-2 tick
    within 1e-5, and within 1e-4 of the JAX engine, which pads, masks and
    counts the same."""
    jcfg, cfg, tree, params = _models()
    spec, jspec = DigcSpec(impl="blocked", k=3), JSpec(impl="blocked", k=3)
    eng, jeng = _pair(cfg, params, jcfg, tree, spec, jspec, buckets=(1, 2),
                      image_sizes=(16, 32))
    plan = [("P", 20), ("S", 24), ("Q", 12), ("P", 20), ("R", 32), ("Q", 16)]
    reqs = []
    for uid, (t, s) in enumerate(plan):
        img = _image(300 + uid, s)
        req = VigRequest(uid, img, tenant=t)
        req._jax = JaxRequest(uid, img, tenant=t)
        eng.submit(req)
        jeng.submit(req._jax)
        reqs.append(req)
        assert req._serve_size == req._jax._serve_size
        np.testing.assert_array_equal(req._serve_mask, req._jax._serve_mask)
    assert reqs[0]._serve_size == 32 and reqs[0]._serve_mask.sum() == 25
    assert reqs[2]._serve_size == 16 and reqs[2]._serve_mask.sum() == 9
    compiled = []
    eng.on_compile = compiled.append
    bucket = {}
    while eng.queue:
        assert eng.step() == jeng.step()
        assert (eng.last_cell, eng.last_lanes) == (jeng.last_cell,
                                                   jeng.last_lanes)
        for r in reqs:
            bucket.setdefault(r.uid, eng.last_bucket if r.done else None)
            if bucket[r.uid] is None and r.done:
                bucket[r.uid] = eng.last_bucket
    assert compiled == [(32, 2, "pad"), (16, 1, "pad"), (32, 1, "pad"),
                        (32, 1), (16, 1)]
    assert [bucket[r.uid] for r in reqs] == [2, 2, 1, 1, 1, 1]
    for req in reqs:
        size, mask = req._serve_size, req._serve_mask
        canvas = np.zeros((size, size, 3), np.float32)
        h = req.image.shape[0]
        canvas[:h, :h] = req.image
        ref = vig.vig_forward(params, torch.from_numpy(canvas[None]), cfg,
                              digc_impl=spec, valid_mask=None if mask is None
                              else mask[None])
        if bucket[req.uid] == 1:
            np.testing.assert_array_equal(req.logits, ref[0].numpy())
        np.testing.assert_allclose(req.logits, ref[0].numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(req.logits, req._jax.logits, rtol=ATOL,
                                   atol=ATOL)
    assert eng.stats()["cell_ticks"] == jeng.stats()["cell_ticks"]


# ---------------------------------------------------------------------------
# Typed errors, with JAX's messages


def _same_error(fn, jfn, exc=ValueError, jexc=ValueError):
    with pytest.raises(jexc) as want:
        jfn()
    with pytest.raises(exc) as got:
        fn()
    assert str(got.value) == str(want.value)
    return str(got.value)


def test_odd_grid_pyramid_raises_at_engine_construction():
    for kw, sizes, match in [
            (dict(embed_dims=(16, 16), depths=(1, 1)), (16, 20), "downsample"),
            (dict(reduce_ratios=(4,)), (24,), "reduce ratio")]:
        jcfg, cfg, tree, params = _models(**kw)
        msg = _same_error(
            lambda: VigServeEngine(cfg, params, autotune=False,
                                   image_sizes=sizes, device=CPU),
            lambda: JaxEngine(jcfg, tree, autotune=False, image_sizes=sizes),
            vig.VigGridError, jvig.VigGridError)
        assert match in msg


def test_construction_errors_match_jax():
    jcfg, cfg, tree, params = _models()
    for kw in (dict(image_sizes=(2,)), dict(image_sizes=(18,)),
               dict(image_sizes=()), dict(buckets="sometimes"),
               dict(slo_ms=-1.0), dict(slo_ms={"gold": -5})):
        _same_error(
            lambda: VigServeEngine(cfg, params, autotune=False, device=CPU,
                                   **kw),
            lambda: JaxEngine(jcfg, tree, autotune=False, **kw))


def test_submit_typed_errors_on_the_lattice():
    jcfg, cfg, tree, params = _models()
    eng, jeng = _pair(cfg, params, jcfg, tree, "blocked", "blocked",
                      image_sizes=(16, 24))
    for uid, img in enumerate([np.zeros((16, 24, 3), np.float32),
                               np.zeros((32, 32, 3), np.float32),
                               np.zeros((18, 18, 3), np.float32),
                               np.zeros((16, 16), np.float32),
                               np.zeros((16, 16, 4), np.float32),
                               np.zeros((20, 20, 3), np.int32)]):
        _same_error(lambda: eng.submit(VigRequest(uid, img)),
                    lambda: jeng.submit(JaxRequest(uid, img)))
    # a pooled model cannot take pad nodes; nor can the kernel tier
    jpool, pool, ptree, pparams = _models(reduce_ratios=(2,))
    eng2, jeng2 = _pair(pool, pparams, jpool, ptree, "blocked", "blocked",
                        image_sizes=(16, 32))
    img = np.zeros((24, 24, 3), np.float32)
    msg = _same_error(lambda: eng2.submit(VigRequest(3, img)),
                      lambda: jeng2.submit(JaxRequest(3, img)))
    assert "pad nodes" in msg
    kern = VigServeEngine(cfg, params, digc_impl="cuda", autotune=False,
                          image_sizes=(16, 24), device=CPU)
    with pytest.raises(ValueError, match="does not support pad-node masking"):
        kern.submit(VigRequest(4, np.zeros((20, 20, 3), np.float32)))
    assert not kern.queue and not eng2.queue
    # without image_sizes= the exact-shape contract holds
    legacy = VigServeEngine(cfg, params, digc_impl="blocked", autotune=False,
                            device=CPU)
    with pytest.raises(ValueError, match="does not match the engine config"):
        legacy.submit(VigRequest(5, np.zeros((8, 8, 3), np.float32)))


# ---------------------------------------------------------------------------
# The exact-size policy


def test_buckets_none_serves_exact_batch_sizes_like_jax():
    jcfg, cfg, tree, params = _models()
    spec, jspec = DigcSpec(impl="blocked", k=3), JSpec(impl="blocked", k=3)
    compiled, jcompiled = [], []
    eng = VigServeEngine(cfg, params, digc_impl=spec, autotune=False,
                         buckets=None, batch=4, on_compile=compiled.append,
                         device=CPU)
    jeng = JaxEngine(jcfg, tree, digc_impl=jspec, autotune=False,
                     buckets=None, batch=4, on_compile=jcompiled.append)
    assert eng.slots == jeng.slots == 4
    uid = 0
    for wave in (["a", "b", "c"], ["a"], ["b", "c", "d"], ["e", "a"]):
        mine, theirs = [], []
        for t in wave:
            img = _image(400 + uid, 16)
            mine.append(VigRequest(uid, img, tenant=t))
            theirs.append(JaxRequest(uid, img, tenant=t))
            eng.submit(mine[-1])
            jeng.submit(theirs[-1])
            uid += 1
        assert eng.step() == jeng.step() == len(wave)
        assert eng.last_bucket == len(wave)  # no padding lane
        for r, jr in zip(mine, theirs):
            np.testing.assert_allclose(r.logits, jr.logits, rtol=ATOL,
                                       atol=ATOL)
    assert compiled == jcompiled == [3, 1, 2]
    assert eng.stats()["padded_lanes"] == 0
    assert eng.stats()["buckets"] is None


# ---------------------------------------------------------------------------
# The bind-on-next-tick cell order, tick by tick (stubbed programs)


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


SIZES = (12, 16, 20, 24)  # 12 and 20 pad up to the 16 and 24 cells


@settings(max_examples=20)
@given(events=st.lists(st.tuples(st.integers(0, 4), st.sampled_from(SIZES),
                                 st.booleans()), min_size=1, max_size=24))
def test_property_legacy_cell_trace_equals_jax(events):
    """Random (tenant, size) arrivals with ticks between some of them:
    both engines serve the same cell, lanes and bucket every tick, and
    their slot, parking and lane counters end equal."""
    jcfg, cfg, tree, params = _MODELS
    eng = _Stub(cfg, params, digc_impl="blocked", autotune=False,
                buckets=(1, 2), image_sizes=(16, 24), device=CPU)
    jeng = _JaxStub(jcfg, tree, digc_impl="blocked", autotune=False,
                    buckets=(1, 2), image_sizes=(16, 24))
    for uid, (t, size, tick) in enumerate(events):
        img = np.zeros((size, size, 3), np.float32)
        eng.submit(VigRequest(uid, img, tenant=f"t{t}"))
        jeng.submit(JaxRequest(uid, img, tenant=f"t{t}"))
        if tick:
            assert eng.step() == jeng.step()
            assert (eng.last_cell, eng.last_lanes) == (jeng.last_cell,
                                                       jeng.last_lanes)
    while eng.queue or jeng.queue:
        assert eng.step() == jeng.step()
        assert (eng.last_cell, eng.last_lanes, eng.last_resets,
                eng.last_restores) == (jeng.last_cell, jeng.last_lanes,
                                       jeng.last_resets, jeng.last_restores)
    s, js = eng.stats(), jeng.stats()
    for k in ("cell_ticks", "lane_hist", "padded_lanes", "slot_tenants",
              "parked_tenants", "park_hits", "park_evictions", "deferrals"):
        assert s[k] == js[k], k
    assert eng.compile_count == jeng.compile_count


_MODELS = _models()


# ---------------------------------------------------------------------------
# On the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


class _Eager(VigServeEngine):
    def _captures(self):
        return False


@pytest.mark.gpu
def test_captured_padded_cell_equals_eager_on_card(cuda):
    """Ragged 20, 24 and 12 px requests share the 32 / 16 px padded cells'
    captured programs (the (32, 2) padded cell sees two different masks):
    the mask is a static input refilled before each replay, and every
    request's logits equal the eager engine's bit for bit."""
    _, cfg, tree, _ = _models()
    params = convert.params_from_numpy(cfg, tree, device=cuda)
    plan = [[("P", 20), ("Q", 24)], [("P", 20), ("Q", 20)], [("R", 12)],
            [("P", 32), ("Q", 20)], [("R", 16), ("S", 12)]]
    out = {}
    for cls in (VigServeEngine, _Eager):
        eng = cls(cfg, params, digc_impl="blocked", autotune=False,
                  buckets=(1, 2), image_sizes=(16, 32), device=cuda)
        reqs = []
        for uid, wave in enumerate(plan):
            for i, (t, s) in enumerate(wave):
                reqs.append(VigRequest(10 * uid + i, _image(uid + i, s),
                                       tenant=t))
                eng.submit(reqs[-1])
            eng.run()
        out[cls] = (eng, reqs)
    cap, reqs = out[VigServeEngine]
    _, ereqs = out[_Eager]
    for r, e in zip(reqs, ereqs):
        assert r.fault is None and np.array_equal(r.logits, e.logits), r.uid
    masked = [k for k in cap._captured if len(k) == 3]
    assert masked and all(cap._captured[k].mask is cap._mask_staging[k][1]
                          for k in masked)
    assert cap.compile_count == len(cap._captured) <= 2 * 2 * 2


@pytest.mark.gpu
def test_device_mask_equals_host_mask_on_card(cuda):
    _, cfg, tree, _ = _models()
    params = convert.params_from_numpy(cfg, tree, device=cuda)
    imgs, masks = _ragged_batch([20, 12], 24)
    x = torch.from_numpy(imgs).to(cuda)
    dev_mask = torch.from_numpy(masks).to(cuda)
    with torch.inference_mode():
        a = vig.vig_forward(params, x, cfg, digc_impl="blocked",
                            valid_mask=masks)
        b = vig.vig_forward(params, x, cfg, digc_impl="blocked",
                            valid_mask=dev_mask)
        c = vig.vig_forward(params, x, cfg, digc_impl="blocked",
                            valid_mask=torch.from_numpy(masks))
    assert torch.equal(a, b) and torch.equal(a, c)
    assert live_mask(dev_mask, dev_mask.device) is dev_mask
