"""The legacy eager ``DigcCache`` (``repro_torch/core/engine.py``) and its
uses: ``digc(cache=, cache_key=)``, the ``cluster`` builder's warm start,
``vig_forward(cache=)`` and ``VigServeEngine(mode="eager")``'s shim.

Against the JAX package on the CPU, at the tiny config of
``tests/test_torch_cluster_serve.py`` (16^2 images, patch 4, D = 16, two
blocks, k = 3): the same ``infer`` calls through JAX's and the port's
eager engines on ``cluster`` give logits within 1e-4 (that file's rule for
the tier) and ``stats()["digc_cache"]`` equal (entries, hits, misses)
after every call; the cache's centroids within 1e-4; a tier without
``supports_cache`` keeps the port's eager path and never engages the
cache. The JAX package is imported inside a fixture, so the file's
``gpu`` test (``usable()`` is false while a CUDA graph is captured) runs
on a card without JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import DigcSpec, digc, get_builder, list_builders  # noqa: E402
from repro_torch.core.engine import DigcCache  # noqa: E402
from repro_torch.core.state import DigcState, state_entry  # noqa: E402
from repro_torch.models import convert, vig  # noqa: E402
from repro_torch.serve.engine import VigServeEngine  # noqa: E402

CPU = "cpu"
ATOL = 1e-4
KW = dict(image_size=16, patch=4, embed_dims=(16,), depths=(2,),
          num_classes=3, k=3)
# Calls of the direct path: batch sizes, each with new images; the key
# holds the batch size, so B = 1 starts cold and B = 2 warm.
BATCHES = (2, 2, 1, 2, 1, 2)


@pytest.fixture(scope="module")
def jax_side():
    jax = pytest.importorskip("jax")
    from repro.core.engine import DigcCache as JaxCache
    from repro.models import vig as jvig
    from repro.models.module import init_params as jax_init_params
    from repro.serve.engine import VigServeEngine as JaxEngine

    def models(impl):
        jcfg = jvig.VIG_VARIANTS["vig_ti_iso"].replace(digc_impl=impl, **KW)
        cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(digc_impl=impl, **KW)
        tree = jax.tree.map(np.asarray, jax_init_params(
            jvig.vig_param_spec(jcfg), jax.random.PRNGKey(0)))
        return jcfg, cfg, tree, convert.params_from_numpy(cfg, tree, device=CPU)

    return dict(models=models, JaxEngine=JaxEngine, JaxCache=JaxCache)


def _images(seed, b):
    return np.random.default_rng(seed).standard_normal(
        (b, 16, 16, 3)).astype(np.float32)


def test_eager_shim_matches_jax_engine_and_its_cache_stats(jax_side):
    jcfg, cfg, tree, params = jax_side["models"]("cluster")
    jeng = jax_side["JaxEngine"](jcfg, tree, digc_impl="cluster",
                                 autotune=False, mode="eager")
    eng = VigServeEngine(cfg, params, digc_impl="cluster", autotune=False,
                         mode="eager", device=CPU)
    for i, b in enumerate(BATCHES):
        img = _images(i, b)
        want = np.asarray(jeng.infer(img))
        got = eng.infer(img)
        np.testing.assert_allclose(got.numpy(), want, rtol=ATOL, atol=ATOL)
        assert eng.stats()["digc_cache"] == jeng.stats()["digc_cache"], i
    stats = eng.stats()["digc_cache"]
    # one centroid entry per (stage, batch size); every later block and
    # call of the same key warm-starts
    assert stats == {"entries": 2, "hits": 2 * len(BATCHES) - 2, "misses": 2}
    assert eng.requests_served == sum(BATCHES)
    assert eng._direct == {}  # the shim serves outside the stateful path
    ours = {k: v for k, v in eng.cache._store.items()}
    theirs = {k: np.asarray(v) for k, v in jeng.cache._store.items()}
    assert ours.keys() == theirs.keys()
    for key in ours:
        np.testing.assert_allclose(ours[key].numpy(), theirs[key], rtol=ATOL,
                                   atol=ATOL)


def test_eager_shim_equals_vig_forward_with_a_cache():
    cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(digc_impl="cluster", **KW)
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=CPU)
    eng = VigServeEngine(cfg, params, digc_impl="cluster", autotune=False,
                         mode="eager", device=CPU)
    cache = DigcCache()
    for i, b in enumerate(BATCHES):
        img = torch.from_numpy(_images(10 + i, b))
        assert torch.equal(eng.infer(img),
                           vig.vig_forward(params, img, cfg, cache=cache))
    assert eng.cache.stats() == cache.stats()
    # a cold forward differs from the warm-started one: the cache engaged
    cold = vig.vig_forward(params, img, cfg)
    assert not torch.equal(cold, vig.vig_forward(params, img, cfg, cache=cache))


def test_other_tiers_keep_the_eager_path(jax_side):
    _, cfg, _, params = jax_side["models"]("blocked")
    eager = VigServeEngine(cfg, params, digc_impl="blocked", autotune=False,
                           mode="eager", device=CPU)
    jit = VigServeEngine(cfg, params, digc_impl="blocked", autotune=False,
                         device=CPU)
    img = _images(3, 2)
    assert torch.equal(eager.infer(img), jit.infer(img))
    assert eager.stats()["digc_cache"] == {"entries": 0, "hits": 0, "misses": 0}


def test_supports_cache_is_clusters_alone_as_in_jax(jax_side):
    from repro.core.builder import list_builders as jax_builders

    ours = {b.name for b in list_builders() if b.supports_cache}
    theirs = {b.name for b in jax_builders() if b.supports_cache}
    assert ours == theirs == {"cluster"}
    assert not get_builder("cuda").supports_cache


def test_digc_cache_unit_against_jax(jax_side):
    ours, theirs = DigcCache(max_entries=2), jax_side["JaxCache"](max_entries=2)
    y = np.random.default_rng(0).standard_normal((2, 5, 4)).astype(np.float32)
    for key in ("g1", "g1", "g2", "g3", "g1"):
        a = ours.norms(key, torch.from_numpy(y)).numpy()
        b = np.asarray(theirs.norms(key, y))
        np.testing.assert_allclose(a, b, rtol=1e-6)
        assert ours.stats() == theirs.stats(), key
    # eviction of the oldest entry: g1 was dropped by g3, so its last
    # lookup missed
    assert ours.stats() == {"entries": 2, "hits": 1, "misses": 4}
    assert ours.get("sq_y", "nope") is None and ours.misses == 5
    ours.clear()
    assert ours.stats()["entries"] == 0


def test_cache_bypassed_for_meta_and_exclusive_with_state():
    meta = torch.empty((2, 8, 4), device="meta")
    assert not DigcCache.usable(meta)
    assert DigcCache.usable(torch.zeros(2))
    cache = DigcCache()
    cache.put("sq_y", "g", meta.sum(-1))
    assert cache.stats()["entries"] == 0
    assert cache.norms("g", meta).shape == (2, 8)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 16, 8)).astype(np.float32))
    st = DigcState.init({"s": state_entry(device=CPU)})
    with pytest.raises(ValueError, match="not both"):
        digc(x, spec=DigcSpec(impl="cluster", k=3), state=st, state_key="s",
             cache=cache, cache_key="s")
    # a tier without supports_cache ignores the cache; cluster needs a key
    digc(x, spec=DigcSpec(impl="blocked", k=3), cache=cache, cache_key="b")
    digc(x, spec=DigcSpec(impl="cluster", k=3), cache=cache)
    assert cache.stats() == {"entries": 0, "hits": 0, "misses": 0}
    digc(x, spec=DigcSpec(impl="cluster", k=3), cache=cache, cache_key="c")
    assert cache.stats() == {"entries": 1, "hits": 0, "misses": 1}


@pytest.mark.gpu
def test_usable_is_false_while_a_cuda_graph_captures():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    x = torch.randn(2, 16, 8, device=dev)
    cache = DigcCache()
    spec = DigcSpec(impl="cluster", k=3)
    digc(x, spec=spec, cache=cache, cache_key="c")  # warm-up, writes once
    seen = []
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        digc(x, spec=spec)  # the capture's warm-up on its stream
    torch.cuda.current_stream().wait_stream(stream)
    with torch.cuda.graph(graph):
        seen.append(DigcCache.usable(x))
        digc(x, spec=spec, cache=cache, cache_key="c")
    assert seen == [False]
    assert DigcCache.usable(x)
    # the captured call neither read nor wrote the cache
    assert cache.stats() == {"entries": 1, "hits": 0, "misses": 1}
