"""Autotuned ViG serving in the port (``repro_torch.serve``) on the CPU:
narrowed ``vig_ti_iso`` and ``vig_ti_pyr`` served through the config's
``blocked`` tier with the tuner on, against the JAX model on the same
numpy weights. Tolerance: logits within 1e-4, as in test_torch_vig.py
(fp32 sums reordered across the whole network)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import DigcSpec as JaxSpec  # noqa: E402
from repro.core import tuner as jtuner  # noqa: E402
from repro.models import vig as jvig  # noqa: E402
from repro.models.module import init_params as jax_init_params  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.core import DigcSpec  # noqa: E402
from repro_torch.core.tuner import VigSchedule  # noqa: E402
from repro_torch.models import convert, vig  # noqa: E402
from repro_torch.serve.engine import VigRequest, VigServeEngine  # noqa: E402

ATOL = 1e-4
BUCKETS = (1, 2, 4)
# Ticks of (uid, tenant): bucket 4, 1, 2, 4, 1.
TRACE = [[(0, "a"), (1, "b"), (2, "c")], [(3, "a")], [(4, "d"), (5, "e")],
         [(6, "a"), (7, "b"), (8, "c"), (9, "d")], [(10, None)]]

MODELS = {
    "vig_ti_iso": dict(image_size=64, embed_dims=(16,), depths=(2,),
                       num_classes=5, k=3),
    "vig_ti_pyr": dict(image_size=64, embed_dims=(8, 16, 24, 32),
                       depths=(1, 1, 1, 1), num_classes=5, k=3),
}


def _models(name):
    kw = MODELS[name]
    jcfg = jvig.VIG_VARIANTS[name].replace(**kw)
    cfg = vig.VIG_VARIANTS[name].replace(**kw)
    tree = jax.tree.map(np.asarray, jax_init_params(
        jvig.vig_param_spec(jcfg), jax.random.PRNGKey(1)))
    return jcfg, cfg, tree


def _jax_schedule(schedule: VigSchedule) -> jtuner.VigSchedule:
    """The JAX package's schedule with the same tiers and tiles (the
    ``cuda`` kernel's counterpart is the Pallas kernel, interpreted)."""
    stages = []
    for s in schedule.stages:
        kw = {f: getattr(s, f) for f in ("k", "dilation", "block_n", "block_m",
                                         "merge", "fuse_norms", "kernel_merge",
                                         "packed", "bucket_rounds")}
        if s.impl == "cuda":
            stages.append(JaxSpec(impl="pallas", interpret=True, **kw))
        else:
            stages.append(JaxSpec(impl=s.impl, **kw))
    return jtuner.VigSchedule(stages=tuple(stages))


def _serve(eng, images):
    reqs, bucket_of = [], {}
    for tick in TRACE:
        for uid, tenant in tick:
            req = VigRequest(uid, images[uid], tenant=tenant)
            eng.submit(req)
            reqs.append(req)
        eng.step()
        for uid, _ in tick:
            bucket_of[uid] = eng.last_bucket
    return reqs, bucket_of


@pytest.mark.parametrize("name", sorted(MODELS))
def test_tuned_serving_matches_jax_and_persists(tmp_path, name):
    jcfg, cfg, tree = _models(name)
    params = convert.params_from_numpy(cfg, tree, device="cpu")
    path = tmp_path / "tune.json"
    images = [testing.images(100 + uid, 1, cfg.image_size)[0]
              for uid in range(11)]
    eng = VigServeEngine(cfg, params, batch=4, tuner_path=path,
                         buckets=BUCKETS, device="cpu")
    assert eng.spec.impl == "blocked"
    eng.warmup()
    stages = len(cfg.depths)
    assert len(eng.tuned) == stages
    assert all(r.source == "measured" for r in eng.tuned)
    reqs, bucket_of = _serve(eng, images)
    # The first tick tuned every configured bucket, one schedule each.
    assert sorted(eng._bucket_schedules) == list(BUCKETS)
    assert all(len(eng._bucket_tuned[b]) == stages for b in BUCKETS)
    assert eng.compile_count == len(BUCKETS)
    stats = eng.stats()
    assert len(stats["tuned"]) == stages
    assert stats["lane_hist"] == {"64x1": 2, "64x2": 1, "64x3": 1, "64x4": 1}
    # Logits through each bucket's schedule equal the JAX model's through
    # the same tiers and tiles.
    for b, sched in eng._bucket_schedules.items():
        uids = [r.uid for r in reqs if bucket_of[r.uid] == b]
        want = jvig.vig_forward(tree, jnp.asarray(np.stack(
            [images[u] for u in uids])), jcfg, digc_impl=_jax_schedule(sched))
        got = np.stack([next(r for r in reqs if r.uid == u).logits
                        for u in uids])
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    # A second engine on the same cache tunes nothing.
    eng2 = VigServeEngine(cfg, params, batch=4, tuner_path=path,
                          buckets=BUCKETS, device="cpu")
    eng2.warmup()
    _serve(eng2, images)
    assert all(r.source == "cached" for r in eng2.tuned)
    assert all(r.source == "cached" for b in BUCKETS
               for r in eng2._bucket_tuned[b])
    assert [eng2._bucket_schedules[b].describe() for b in BUCKETS] == \
        [eng._bucket_schedules[b].describe() for b in BUCKETS]
    # retune_buckets() on the served trace's histogram is JAX's optimum
    # of the same histogram, and buckets="auto" reads it back.
    hist = {}
    for (size, live), ticks in eng.lane_hist.items():
        hist.setdefault(size, {})[live] = ticks
    new = eng.retune_buckets(max_programs=2)
    assert new == jtuner.optimal_bucket_set(
        hist, slots=4, max_programs=2,
        costs={cfg.image_size: (cfg.image_size // cfg.patch) ** 2})
    assert eng.buckets == new
    auto = VigServeEngine(cfg, params, batch=4, tuner_path=path,
                          buckets="auto", bucket_cap=2, device="cpu")
    assert auto.buckets == new
    fresh = VigServeEngine(cfg, params, batch=4, tuner_path=tmp_path / "x",
                           buckets="auto", device="cpu")
    assert fresh.buckets == (1, 2, 4)


def test_direct_path_tunes_lazily_and_user_schedule_applies_everywhere(
        tmp_path):
    jcfg, cfg, tree = _models("vig_ti_iso")
    params = convert.params_from_numpy(cfg, tree, device="cpu")
    imgs = testing.images(7, 2, cfg.image_size)
    eng = VigServeEngine(cfg, params, batch=2, tuner_path=tmp_path / "t.json",
                         device="cpu")
    assert eng.tuned is None
    out = eng.infer(imgs)  # tunes first
    assert eng.tuned is not None and eng.schedule is not None
    want = jvig.vig_forward(tree, jnp.asarray(imgs), jcfg,
                            digc_impl=_jax_schedule(eng.schedule))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    # A user schedule of the kernel's legacy merge: nothing is tuned, every
    # bucket runs it, and the logits equal the JAX model's through the
    # Pallas kernel with the same merge and tiles.
    sched = VigSchedule(stages=(DigcSpec(impl="cuda", k=cfg.k, block_n=16,
                                         block_m=64, kernel_merge="legacy"),))
    user = VigServeEngine(cfg, params, digc_impl=sched, buckets=(1, 2),
                          tuner_path=tmp_path / "u.json", device="cpu")
    assert user.warmup() is None
    for uid in range(3):
        user.submit(VigRequest(uid, imgs[uid % 2], tenant=uid))
    reqs = user.run()
    assert not (tmp_path / "u.json").exists()
    assert user._bucket_schedules == {}
    want = jvig.vig_forward(tree, jnp.asarray(imgs), jcfg,
                            digc_impl=_jax_schedule(sched))
    got = np.stack([r.logits for r in reqs[:2]])
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    # digc_impl="cuda" keeps working unchanged: no tuning.
    plain = VigServeEngine(cfg, params, digc_impl="cuda", device="cpu")
    assert plain.warmup() is None and plain.spec.impl == "cuda"


def test_vig_forward_resolves_a_schedule_per_stage():
    jcfg, cfg, tree = _models("vig_ti_pyr")
    params = convert.params_from_numpy(cfg, tree, device="cpu")
    sched = VigSchedule(stages=(
        DigcSpec(impl="blocked", k=3, block_m=8, merge="topk"),
        DigcSpec(impl="cuda", k=3, kernel_merge="legacy", block_m=16),
        DigcSpec(impl="reference", k=3),
        DigcSpec(impl="cuda", k=3, packed=True, bucket_rounds=1, block_m=6)))
    plans = vig.vig_stage_plans(cfg, sched)
    assert [p.spec.impl for p in plans] == ["blocked", "cuda", "reference",
                                            "cuda"]
    assert plans[3].spec.bucket_rounds == 1
    imgs = testing.images(3, 2, cfg.image_size)
    out = vig.Vig(cfg, params, digc_impl=sched, device="cpu")(
        torch.from_numpy(imgs))
    want = jvig.vig_forward(tree, jnp.asarray(imgs), jcfg,
                            digc_impl=_jax_schedule(sched))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
