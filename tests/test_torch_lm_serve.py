"""The port's LM ``ServeEngine`` and serving driver against the JAX
package's on the same requests, in fp32 at the SMOKE widths with JAX's
init converted through numpy: equal ``out_tokens`` (greedy argmax of
logits that agree to ~1e-5) and equal ``decode_calls``. Ports of the
LM-engine tests of ``tests/test_substrates.py`` and
``tests/test_serve_multitenant.py``. The card's engine is held to the
CPU's in ``tests/test_torch_gpu.py``.
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
], ids=["olmo", "qwen3", "qwen2-vl", "olmo-knn", "olmo-local", "deepseek",
        "qwen3-moe"])
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

