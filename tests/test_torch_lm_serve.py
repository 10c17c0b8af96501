"""The port's LM ``ServeEngine`` and serving driver against the JAX
package's on the same requests, in fp32 at the SMOKE widths with JAX's
init converted through numpy: equal ``out_tokens`` (greedy argmax of
logits that agree to ~1e-5) and equal ``decode_calls``. Ports of the
LM-engine tests of ``tests/test_substrates.py`` and
``tests/test_serve_multitenant.py``, for every ported family: dense, VLM,
MoE and MLA, the SSM and the Griffin hybrid (its nested ``groups`` /
``rem`` cache). Two faults of the reference that the port reproduces by
design (ROADMAP queue 3, items 18-19) and the decode write past the cache
(item 17) are pinned against JAX here. The card's engine is held to the
CPU's in ``tests/test_torch_lm_gpu.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.module import init_params as jax_init_params  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import convert, module  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402


def _setup(arch="olmo-1b", **kw):
    jcfg = jconfigs.get_smoke(arch).replace(dtype="float32", **kw)
    cfg = configs.get_smoke(arch).replace(dtype="float32", **kw)
    jp = jax_init_params(jtr.param_spec(jcfg), jax.random.PRNGKey(0))
    p = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    return jcfg, cfg, jp, p


def _prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lengths]


def _flat(tree, path=()):
    """{path: tensor} of a nested cache of dicts and tuples."""
    if isinstance(tree, (dict, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


def _jflat(tree):
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): a
            for path, a in jax.tree_util.tree_leaves_with_path(tree)}


def _serve(eng, make, prompts, budgets):
    for uid, (p, n) in enumerate(zip(prompts, budgets)):
        eng.submit(make(uid=uid, prompt=p, max_new_tokens=n))
    return {r.uid: r.out_tokens for r in eng.run()}


@pytest.mark.parametrize("arch,kw", [
    ("olmo-1b", {}),
    ("qwen3-32b", {}),
    ("qwen2-vl-72b", {}),
    ("olmo-1b", dict(attention="knn", knn_neighbors=3)),
    ("olmo-1b", dict(attention="local", window=4)),
    ("deepseek-v2-lite-16b", {}),
    ("qwen3-moe-235b-a22b", {}),
    ("mamba2-370m", {}),
    ("recurrentgemma-9b", {}),
    ("recurrentgemma-9b", dict(num_layers=5)),
], ids=["olmo", "qwen3", "qwen2-vl", "olmo-knn", "olmo-local", "deepseek",
        "qwen3-moe", "mamba2", "recurrentgemma", "recurrentgemma-5l"])
def test_engine_matches_jax_engine(arch, kw):
    """More requests than slots, mixed prompt lengths and budgets: slots
    prefill while others decode at overlapping positions."""
    jcfg, cfg, jp, p = _setup(arch, **kw)
    prompts = _prompts(cfg, [3, 6, 1, 4, 5])
    budgets = [4, 2, 5, 1, 3]
    jeng = jengine.ServeEngine(jcfg, jp, slots=2, max_len=16)
    want = _serve(jeng, jengine.Request, prompts, budgets)
    eng = ServeEngine(cfg, p, slots=2, max_len=16, device="cpu")
    got = _serve(eng, Request, prompts, budgets)
    assert got == want
    assert eng.decode_calls == jeng.decode_calls
    assert all(len(got[u]) == n for u, n in enumerate(budgets))


def test_greedy_matches_direct_decode():
    """Port of ``tests/test_substrates.py::test_serve_greedy_matches_direct_decode``."""
    _, cfg, _, p = _setup()
    prompt = np.asarray([5, 9, 2], np.int32)
    eng = ServeEngine(cfg, p, slots=1, max_len=16, device="cpu")
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=4))
    out = eng.run()[0].out_tokens
    cache = tr.init_cache(cfg, 1, 16, device="cpu")
    toks = list(prompt)
    ref = []
    for t in range(len(prompt) + 3):
        cur = torch.tensor([[toks[t] if t < len(toks) else ref[-1]]])
        lg, cache = tr.decode_step(p, cache, cur, t, cfg)
        if t >= len(prompt) - 1:
            nxt = int(lg[0, -1].argmax())
            ref.append(nxt)
            if t >= len(prompt):
                toks.append(nxt)
    assert out == ref[:4]


def test_mixed_length_slots_match_solo():
    """Port of ``tests/test_serve_multitenant.py::test_serve_engine_mixed_length_slots_match_solo``."""
    _, cfg, _, p = _setup()
    prompts = {0: np.asarray([5, 9, 2], np.int32),
               1: np.asarray([7, 1, 4, 3, 8], np.int32)}
    eng = ServeEngine(cfg, p, slots=2, max_len=32, device="cpu")
    for uid, pr in prompts.items():
        eng.submit(Request(uid=uid, prompt=pr, max_new_tokens=4))
    got = {r.uid: r.out_tokens for r in eng.run()}
    for uid, pr in prompts.items():
        solo = ServeEngine(cfg, p, slots=1, max_len=32, device="cpu")
        solo.submit(Request(uid=uid, prompt=pr, max_new_tokens=4))
        assert got[uid] == solo.run()[0].out_tokens, uid


def test_prefill_leaves_other_slots_cache_bit_for_bit():
    """A slot prefilling while another is mid-decode at overlapping
    positions, and a third idle, writes only its own rows."""
    _prefill_leaves_other_slots("olmo-1b")


def test_prefill_leaves_other_slots_latents_bit_for_bit():
    """The same for MLA's latent cache (``c_kv``, ``k_pe``)."""
    _prefill_leaves_other_slots("deepseek-v2-lite-16b")


def _prefill_leaves_other_slots(arch):
    _, cfg, _, p = _setup(arch)
    eng = ServeEngine(cfg, p, slots=3, max_len=16, device="cpu")
    eng.submit(Request(uid=0, prompt=np.asarray([5, 9, 2, 7], np.int32),
                       max_new_tokens=8))
    eng.step()
    eng.step()  # slot 0 now holds positions 0-5
    before = {k: v.clone() for k, v in eng.cache.items()}
    req = Request(uid=1, prompt=np.asarray([3, 1, 4], np.int32), max_new_tokens=2)
    eng.slot_req[1] = req
    eng._prefill_one(1, req)  # writes positions 0-2 of slot 1
    for name, t in eng.cache.items():
        assert torch.equal(t[:, [0, 2]], before[name][:, [0, 2]])
        assert torch.equal(t[:, 1, 3:], before[name][:, 1, 3:])
        assert not torch.equal(t[:, 1, :3], before[name][:, 1, :3])


def test_submit_errors_match_jax_messages():
    jcfg, cfg, jp, p = _setup()
    jeng = jengine.ServeEngine(jcfg, jp, slots=1, max_len=8)
    eng = ServeEngine(cfg, p, slots=1, max_len=8, device="cpu")
    for kw in (dict(prompt=np.asarray([], np.int32)),
               dict(prompt=np.asarray([5], np.int32), max_new_tokens=0)):
        with pytest.raises(ValueError) as want:
            jeng.submit(jengine.Request(uid=3, **kw))
        with pytest.raises(ValueError) as got:
            eng.submit(Request(uid=3, **kw))
        assert str(got.value) == str(want.value)
    assert not eng.queue


def test_one_decode_call_per_tick_and_one_token_budget():
    """Ports of ``test_serve_engine_one_decode_call_per_tick_pinned`` and
    ``test_serve_engine_respects_one_token_budget``."""
    _, cfg, _, p = _setup()
    eng = ServeEngine(cfg, p, slots=2, max_len=32, device="cpu")
    eng.submit(Request(uid=0, prompt=np.asarray([5], np.int32), max_new_tokens=4))
    eng.submit(Request(uid=1, prompt=np.asarray([7, 1, 4], np.int32),
                       max_new_tokens=4))
    eng.step()
    before = eng.decode_calls
    eng.step()
    assert eng.decode_calls == before + 1  # mixed lengths, one call
    one = ServeEngine(cfg, p, slots=1, max_len=16, device="cpu")
    one.submit(Request(uid=0, prompt=np.asarray([5, 9], np.int32),
                       max_new_tokens=1))
    out = one.run()
    assert len(out) == 1 and len(out[0].out_tokens) == 1
    assert one.decode_calls == 2  # prefill only, no decode tick


def test_engine_holds_compute_dtype_params_and_needs_a_card_or_cpu():
    cfg = configs.get_smoke("qwen3-32b")  # bf16, qk-norm scales stay fp32
    p = _setup("qwen3-32b")[3]  # fp32 tensors
    eng = ServeEngine(cfg, p, slots=1, max_len=8, device="cpu")
    assert eng.params["layers"]["mix"]["wq"].dtype == torch.bfloat16
    assert eng.params["layers"]["mix"]["q_norm"].dtype == torch.float32
    assert eng.cache["k"].dtype == torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(cfg, p, slots=1, max_len=8)


def test_launch_serve_main_smoke_on_cpu(capsys):
    finished = serve.main(["--smoke", "--device", "cpu"])
    cfg = configs.get_smoke("olmo-1b")
    assert sorted(r.uid for r in finished) == list(range(8))
    assert all(len(r.out_tokens) == 16 and all(0 <= t < cfg.vocab_size
                                               for t in r.out_tokens)
               for r in finished)
    assert "served 8 requests / 128 tokens" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="item 7e"):
        serve.main(["--arch", "whisper-tiny", "--smoke", "--device", "cpu"])


def test_launch_serve_main_deepseek_smoke_on_cpu(capsys, monkeypatch):
    """The MoE + MLA arch through ``launch.serve``: its tree drawn in the
    compute dtypes, held by the engine as drawn (no copy), the latent
    cache."""
    engines = []

    class Kept(ServeEngine):
        def __init__(self, cfg, params, **kw):
            super().__init__(cfg, params, **kw)
            engines.append((self, params))

    monkeypatch.setattr(serve, "ServeEngine", Kept)
    finished = serve.main(["--arch", "deepseek-v2-lite-16b", "--smoke",
                           "--device", "cpu", "--requests", "3"])
    cfg = configs.get_smoke("deepseek-v2-lite-16b")
    assert sorted(r.uid for r in finished) == [0, 1, 2]
    assert all(len(r.out_tokens) == 16 and all(0 <= t < cfg.vocab_size
                                               for t in r.out_tokens)
               for r in finished)
    assert "served 3 requests / 48 tokens" in capsys.readouterr().out
    eng, drawn = engines[0]
    for path, t in module.leaves(eng.params).items():
        assert t is module.leaves(drawn)[path], path
        assert t.dtype == tr.compute_dtype(path, cfg), path
    assert eng.params["layers"]["mlp"]["router"].dtype == torch.float32
    assert eng.params["layers"]["mix"]["kv_norm"].dtype == torch.float32
    assert eng.params["layers"]["mlp"]["w_gate"].dtype == torch.bfloat16
    assert set(eng.cache) == {"c_kv", "k_pe"}
    assert eng.cache["c_kv"].shape == (cfg.num_layers, 4, 40, cfg.mla.kv_lora)



# ---------------------------------------------------------------------------
# The recurrent families


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b", "olmo-1b"])
def test_recurrent_state_carries_into_the_next_request_in_a_slot(arch):
    """ROADMAP queue 3, item 18, a fault of the reference reproduced by
    design: JAX's ``_prefill_one`` feeds a new prompt through
    ``decode_step`` from t = 0 and never zeroes the slot, so a recurrent
    state (SSM, RG-LRU) carries the finished request's into the next
    request in the slot. On ``slots=1`` the second request's tokens equal
    JAX's engine's and differ from the same request alone in a fresh
    engine, in both packages; attention masks by position, so ``olmo``'s
    are equal. The final caches equal JAX's engine's."""
    jcfg, cfg, jp, p = _setup(arch)
    first, second = _prompts(cfg, [5, 5], seed=3)
    jtwo = jengine.ServeEngine(jcfg, jp, slots=1, max_len=16)
    want = _serve(jtwo, jengine.Request, [first, second], [4, 4])
    two = ServeEngine(cfg, p, slots=1, max_len=16, device="cpu")
    got = _serve(two, Request, [first, second], [4, 4])
    assert got == want
    jsolo = _serve(jengine.ServeEngine(jcfg, jp, slots=1, max_len=16),
                   jengine.Request, [second], [4])
    solo = _serve(ServeEngine(cfg, p, slots=1, max_len=16, device="cpu"),
                  Request, [second], [4])
    assert solo == jsolo
    carried = cfg.family in ("ssm", "hybrid")
    assert (got[1] != solo[0]) == (want[1] != jsolo[0]) == carried
    flat, jflat = _flat(two.cache), _jflat(jtwo.cache)
    assert flat.keys() == jflat.keys()
    for path, t in flat.items():
        w = np.asarray(jflat[path], np.float32)
        np.testing.assert_allclose(t.float().numpy(), w, rtol=2e-3,
                                   atol=2e-4 * max(1.0, float(np.abs(w).max())),
                                   err_msg=str(path))


def test_hybrid_prefill_cache_is_jax_tree_and_decode_raises_as_jax():
    """ROADMAP queue 3, item 19, a fault of the reference reproduced by
    design: the hybrid's ``prefill`` returns ``forward``'s caches as they
    are, so its attention entries are raw (k, v) tuples over the whole
    prompt, (groups, B, S, KVH, dh), never trimmed to the window; JAX's
    ``decode_step`` cannot read them and raises ``TypeError``, and so does
    the port's, functional or in place, with JAX's message."""
    jcfg, cfg, jp, p = _setup("recurrentgemma-9b", num_layers=5)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    logits, cache = tr.prefill(p, torch.from_numpy(toks[:, :-1]), cfg, max_len=16)
    jlogits, jcache = jtr.prefill(jp, jax.numpy.asarray(toks[:, :-1]), jcfg,
                                  max_len=16)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=2e-3,
                               atol=2e-4)
    flat, jflat = _flat(cache), _jflat(jcache)
    assert flat.keys() == jflat.keys()
    for path, t in flat.items():
        w = np.asarray(jflat[path], np.float32)
        assert tuple(t.shape) == w.shape, path
        np.testing.assert_allclose(t.numpy(), w, rtol=2e-3,
                                   atol=2e-4 * max(1.0, float(np.abs(w).max())),
                                   err_msg=str(path))
    k, v = cache["groups"]["l2_attn"]
    assert k.shape == (1, 2, 10, cfg.num_kv_heads, cfg.dh) and 10 > cfg.window
    tok = toks[:, -1:]
    with pytest.raises(TypeError) as want:
        jtr.decode_step(jp, jcache, jax.numpy.asarray(tok), jax.numpy.int32(10), jcfg)
    for rows in (None, torch.tensor([0])):
        with pytest.raises(TypeError) as got:
            tr.decode_step(p, cache, torch.from_numpy(tok), 10, cfg, rows=rows)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch,kw", [("mamba2-370m", {}),
                                     ("recurrentgemma-9b", dict(num_layers=5))],
                         ids=["mamba2", "recurrentgemma-5l"])
def test_prefill_leaves_other_slots_state_bit_for_bit(arch, kw):
    """A slot prefilling while another is mid-decode, and a third idle:
    every cache leaf's other rows stay bit for bit, on the batch axis 1 of
    a stacked leaf (SSM layers, the hybrid's ``groups``) and 0 of a ``rem``
    leaf; the prefilling row's recurrent states are replaced whole."""
    _, cfg, _, p = _setup(arch, **kw)
    eng = ServeEngine(cfg, p, slots=3, max_len=16, device="cpu")
    eng.submit(Request(uid=0, prompt=np.asarray([5, 9, 2, 7], np.int32),
                       max_new_tokens=8))
    eng.step()
    eng.step()
    before = {k: v.clone() for k, v in _flat(eng.cache).items()}
    req = Request(uid=1, prompt=np.asarray([3, 1, 4], np.int32), max_new_tokens=2)
    eng.slot_req[1] = req
    eng._prefill_one(1, req)
    after = _flat(eng.cache)
    assert after.keys() == before.keys()
    seen = set()
    for path, t in after.items():
        axis = 0 if path[0] == "rem" else 1
        seen.add(axis)
        old = before[path]
        for r in (0, 2):
            assert torch.equal(t.select(axis, r), old.select(axis, r)), (path, r)
        assert not torch.equal(t.select(axis, 1), old.select(axis, 1)), path
    assert seen == ({0, 1} if cfg.family == "hybrid" else {1})


@pytest.mark.parametrize("arch,kw", [
    ("olmo-1b", {}), ("olmo-1b", dict(attention="knn", knn_neighbors=3)),
    ("deepseek-v2-lite-16b", {})], ids=["olmo", "olmo-knn", "deepseek"])
def test_engine_prompt_longer_than_max_len_matches_jax(arch, kw):
    """ROADMAP queue 3, item 17: a 12-token prompt into an engine with
    ``max_len=8`` (neither engine's ``submit`` checks the length): the
    per-slot vector writes past the cache are dropped as JAX's engine drops
    them, and its 4 tokens and decode calls are JAX's, not an error."""
    jcfg, cfg, jp, p = _setup(arch, **kw)
    prompt = _prompts(cfg, [12], seed=5)[0]
    jeng = jengine.ServeEngine(jcfg, jp, slots=1, max_len=8)
    want = _serve(jeng, jengine.Request, [prompt], [4])
    eng = ServeEngine(cfg, p, slots=1, max_len=8, device="cpu")
    got = _serve(eng, Request, [prompt], [4])
    assert got == want and len(got[0]) == 4
    assert eng.decode_calls == jeng.decode_calls == 15


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_launch_serve_main_recurrent_smoke_on_cpu(arch, capsys, monkeypatch):
    """The recurrent archs through ``launch.serve`` (no new flag): the tree
    drawn in the compute dtypes (the SSM's and RG-LRU's fp32 leaves kept)
    and held by the engine as drawn, the recurrent states fp32."""
    engines = []

    class Kept(ServeEngine):
        def __init__(self, cfg, params, **kw):
            super().__init__(cfg, params, **kw)
            engines.append((self, params))

    monkeypatch.setattr(serve, "ServeEngine", Kept)
    finished = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--requests", "3"])
    cfg = configs.get_smoke(arch)
    assert sorted(r.uid for r in finished) == [0, 1, 2]
    assert all(len(r.out_tokens) == 16 and all(0 <= t < cfg.vocab_size
                                               for t in r.out_tokens)
               for r in finished)
    assert "served 3 requests / 48 tokens" in capsys.readouterr().out
    eng, drawn = engines[0]
    for path, t in module.leaves(eng.params).items():
        assert t is module.leaves(drawn)[path], path
        assert t.dtype == tr.compute_dtype(path, cfg), path
    for path, t in _flat(eng.cache).items():
        want = (torch.bfloat16 if path[-1] in ("k", "v") else torch.float32)
        assert t.dtype == want, path
    if cfg.family == "ssm":
        assert eng.params["layers"]["ssm"]["a_log"].dtype == torch.float32
        assert eng.cache["h"].shape[:2] == (cfg.num_layers, 4)
    else:
        assert eng.params["groups"]["l0_rec"]["mix"]["lam"].dtype == torch.float32
        assert eng.cache["groups"]["l2_attn"]["k"].shape[2] == min(cfg.window, 40)
