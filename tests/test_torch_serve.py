"""The port's bucketed multi-tenant engine (``repro_torch.serve``) on the
CPU against the JAX ``VigServeEngine`` on the same trace: the same slot
and bucket choice every tick, at most |buckets| programs, and every
request's logits equal to a JAX B=1 ``vig_forward`` within 1e-4 (fp32
sums reordered across the whole network, as in test_torch_vig.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import vig as jvig  # noqa: E402
from repro.models.module import init_params as jax_init_params  # noqa: E402
from repro.serve.engine import VigRequest as JaxRequest  # noqa: E402
from repro.serve.engine import VigServeEngine as JaxEngine  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.models import convert, vig  # noqa: E402
from repro_torch.serve.engine import VigRequest, VigServeEngine  # noqa: E402

ATOL = 1e-4
BUCKETS = (1, 2, 4)

# Ticks of arrivals: (uid, tenant); tenant None is a one-shot request.
# Ragged tick sizes, a tenant with two queued requests (one lane per
# tenant per tick), more tenants than slots (LRU eviction), one-shots.
TRACE = [
    [(0, "a"), (1, "b"), (2, "c")],
    [(3, "a")],
    [(4, "d"), (5, "e"), (6, "b"), (7, None)],
    [(8, "f"), (9, "f"), (10, "a")],
    [],
    [(11, None), (12, "c"), (13, "g")],
]


def _models():
    kw = dict(image_size=16, patch=4, embed_dims=(16,), depths=(2,),
              num_classes=3, k=3)
    jcfg = jvig.VIG_VARIANTS["vig_ti_iso"].replace(**kw)
    cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(**kw)
    tree = jax.tree.map(np.asarray, jax_init_params(
        jvig.vig_param_spec(jcfg), jax.random.PRNGKey(0)))
    return jcfg, cfg, tree


def test_trace_matches_jax_engine_and_b1_forwards():
    jcfg, cfg, tree = _models()
    compiled = []
    eng = VigServeEngine(cfg, convert.params_from_numpy(cfg, tree, device="cpu"),
                         buckets=BUCKETS, on_compile=compiled.append,
                         device="cpu")
    jeng = JaxEngine(jcfg, tree, digc_impl="reference", autotune=False,
                     buckets=BUCKETS)
    images = {uid: testing.images(uid, 1, 16)[0]
              for tick in TRACE for uid, _ in tick}
    reqs = []
    for tick in TRACE:
        for uid, tenant in tick:
            req = VigRequest(uid, images[uid], tenant=tenant)
            eng.submit(req)
            jeng.submit(JaxRequest(uid, images[uid], tenant=tenant))
            reqs.append(req)
        served = eng.step()
        assert served == jeng.step()
        if served:
            assert eng.last_lanes == jeng.last_lanes
            assert eng.last_bucket == jeng.last_bucket
    while eng.queue or jeng.queue:
        assert eng.step() == jeng.step()
        assert (eng.last_lanes, eng.last_bucket) == (jeng.last_lanes,
                                                     jeng.last_bucket)
    assert all(r.done for r in reqs)
    assert eng.compile_count == len(compiled) <= len(BUCKETS)
    assert sorted(compiled) == sorted(eng.bucket_ticks)
    stats = eng.stats()
    assert stats["requests_served"] == len(reqs)
    assert stats["live_lanes"] == len(reqs)
    assert stats["padded_lanes"] == sum(
        (b * n for b, n in stats["bucket_ticks"].items())) - len(reqs)
    fwd = jax.jit(lambda im: jvig.vig_forward(tree, im, jcfg,
                                              digc_impl="reference"))
    for r in reqs:
        ref = np.asarray(fwd(jnp.asarray(images[r.uid])[None]))[0]
        np.testing.assert_allclose(r.logits, ref, rtol=0, atol=ATOL)


def test_submit_rejects_malformed_images_and_infer_batches():
    _, cfg, tree = _models()
    eng = VigServeEngine(cfg, convert.params_from_numpy(cfg, tree, device="cpu"),
                         device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        eng.submit(VigRequest(0, np.zeros((16, 8, 3), np.float32)))
    with pytest.raises(ValueError, match="not a float dtype"):
        eng.submit(VigRequest(1, np.zeros((16, 16, 3), np.int32)))
    with pytest.raises(ValueError, match="outside"):
        eng.bucket_for(9)
    imgs = testing.images(2, 3, 16)
    out = eng.infer(imgs)
    assert out.shape == (3, 3) and eng.requests_served == 3
    for i in range(3):
        eng.submit(VigRequest(10 + i, imgs[i]))
    done = eng.run()
    np.testing.assert_allclose(np.stack([r.logits for r in done]),
                               out.numpy(), rtol=0, atol=1e-6)
    assert eng.slot_tenant == [None] * eng.slots  # one-shots free slots
