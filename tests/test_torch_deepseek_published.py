"""DeepSeek-V2-Lite as published (``configs/deepseek_v2_lite.py``:
``PUBLISHED``, ``PUBLISHED_SMOKE``): a dense layer 0 ahead of the MoE
stack, the top-k gates unnormalised, YaRN on the rotary dims with its
softmax mscale, and the whole-prompt slot prefill of ``ServeEngine``.

Held against the benchmark's plain reference
(``vigbench/reference/deepseek_v2_plain.py``, which imports nothing of
the port) on the same seeded weights, against the published equations'
numbers, and against the token-by-token prefill of JAX's engine.
"""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import deepseek_v2_lite as dsv2, get_smoke  # noqa: E402
from repro_torch.models import layers, mla, module, moe  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from vigbench import lm_shapes  # noqa: E402
from vigbench.families import lm  # noqa: E402
from vigbench.reference import deepseek_v2_plain as plain  # noqa: E402

FULL = json.loads((ROOT / "vigbench/configs/deepseek_v2_lite.json").read_text())
# PUBLISHED_SMOKE's widths in the configuration file's keys.
SMALL = dict(FULL, num_hidden_layers=3, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, kv_lora_rank=32, n_routed_experts=8, num_experts_per_tok=3,
             moe_intermediate_size=32, intermediate_size=96, vocab_size=256)


def _fp32(weights: dict) -> dict:
    return {path: leaf.float() for path, leaf in weights.items()}


def test_the_configuration_file_is_the_published_config():
    """The benchmark's file, read by its family, is ``PUBLISHED``, and the
    small file ``PUBLISHED_SMOKE``: every field, YaRN and the gates."""
    assert lm.model_config(FULL) == dsv2.PUBLISHED.replace(name=FULL["name"])
    small = lm.model_config(SMALL)
    assert small == dsv2.PUBLISHED_SMOKE.replace(name=FULL["name"])
    assert (small.dense_layers, small.norm_topk, small.yarn.factor) == (1, False, 40.0)


def test_parameter_count_from_the_tree_without_materialising_it():
    """15.71 B parameters (31.4 GB in bf16), 2.45 B active a token: counted
    from the spec's shapes, and by the benchmark's frozen arithmetic."""
    spec = module.leaves(tr.param_spec(dsv2.PUBLISHED))
    total = sum(math.prod(s.shape) for s in spec.values())
    assert total == 15_706_484_224 == lm_shapes.parameters(FULL)
    assert round(total / 1e9, 2) == 15.71
    assert round(lm_shapes.active_matmul_parameters(FULL) / 1e9, 2) == 2.45
    assert spec[("dense", "mlp", "wi_gate")].shape == (1, 2048, 10_944)
    assert spec[("layers", "mlp", "w_gate")].shape == (26, 64, 2048, 1408)
    assert {k: s[0] for k, s in lm.leaf_shapes(FULL).items()} == {
        k: s.shape for k, s in spec.items()}


def test_yarn_frequencies_and_softmax_mscale_match_the_published_numbers():
    """low = floor(64 ln(4096 / (32 2 pi)) / (2 ln 1e4)) = 10, high = 23;
    pairs below 10 keep theta^(-2i/64), pairs from 23 on take it over 40,
    a linear blend between; m = 0.1 * 0.707 * ln 40 + 1 = 1.26080 and the
    softmax scale 192^-1/2 * m^2 with m^2 = 1.58963."""
    yarn = dsv2.PUBLISHED.yarn
    assert layers.yarn_band(64, 1e4, yarn) == (10, 23)
    got = layers.yarn_freqs(64, 1e4, yarn).double()
    i = torch.arange(32, dtype=torch.float64)
    extra = 1e4 ** (-2 * i / 64)
    keep = 1 - ((i - 10) / 13).clamp(0, 1)
    want = extra / 40 * (1 - keep) + extra * keep
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    torch.testing.assert_close(got[:11], extra[:11], rtol=1e-6, atol=0)
    torch.testing.assert_close(got[23:], extra[23:] / 40, rtol=1e-6, atol=0)
    m = layers.yarn_mscale(40.0, 0.707)
    assert m == pytest.approx(1.26080, abs=5e-6) and m * m == pytest.approx(1.58963, abs=5e-6)
    assert mla.softmax_scale(dsv2.PUBLISHED) == pytest.approx(192 ** -0.5 * 1.5896262, rel=1e-7)
    assert mla.softmax_scale(dsv2.CONFIG) == 192 ** -0.5
    cos, _ = plain.rope_tables(FULL, torch.tensor([1]))
    torch.testing.assert_close(cos[0].double(), torch.cos(got), rtol=0, atol=1e-6)


def test_gates_are_the_top_k_softmax_mass_unless_normalised():
    cfg = dsv2.PUBLISHED_SMOKE
    p = module.init_params(moe.moe_spec(cfg), generator=torch.Generator().manual_seed(3),
                           device="cpu")
    x = torch.randn(40, cfg.d_model, generator=torch.Generator().manual_seed(4))
    gates, sel, _, probs = moe._router(p, x, cfg.moe, norm_topk=False)
    top = probs.sort(-1, descending=True).values[:, :cfg.moe.top_k]
    torch.testing.assert_close(gates.sum(-1), top.sum(-1))
    assert float(gates.sum(-1).max()) < 0.99
    normed, nsel, _, _ = moe._router(p, x, cfg.moe)
    assert torch.equal(sel, nsel)
    torch.testing.assert_close(normed.sum(-1), torch.ones(40))


def test_published_tree_has_a_dense_layer_ahead_of_the_moe_stack():
    spec = tr.param_spec(dsv2.PUBLISHED_SMOKE)
    assert spec["dense"]["mlp"]["wi_gate"].shape == (1, 64, 96)
    assert "router" in spec["layers"]["mlp"] and spec["layers"]["mlp"]["w_gate"].shape[0] == 2
    cache = tr.init_cache(dsv2.PUBLISHED_SMOKE, 2, 8, device="cpu")
    assert cache["c_kv"].shape == (3, 2, 8, 32)  # one stack over all layers


def _served(cfg_json, seed, prompts, budgets, slots=2, max_len=40):
    """The small model served in fp32 through ``ServeEngine`` with the
    whole-prompt prefill, on the family's seeded weights."""
    weights, _, _ = lm.setup(cfg_json, seed, "cpu")
    weights = _fp32(weights)
    model = lm.model_config(cfg_json).replace(dtype="float32")
    eng = ServeEngine(model, lm._tree(weights), slots=slots, max_len=max_len,
                      device="cpu", prefill="whole")
    for uid, (prompt, n) in enumerate(zip(prompts, budgets)):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
    return weights, {r.uid: r for r in eng.run()}, eng


def test_published_smoke_through_the_engine_matches_the_plain_reference():
    """Prefill, then decode through the latent cache (absorbed form),
    against the reference's full forward (expanded form) teacher-forced
    on the program's tokens, both in fp32 on the same weights: each
    emitted token's logit and its row's log-sum-exp agree within 2e-4
    (fp32 sums taken in other orders through 3 layers: the two forms
    differ at ~1e-5 of logits of magnitude ~3), and each token is the
    reference's argmax or within 2e-4 of it. The prompts reach past the
    YaRN band's shortest interpolated wavelength."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (7, 30, 1, 12)]
    budgets = [6, 3, 5, 1]
    weights, got, _ = _served(SMALL, 21, prompts, budgets)
    fwd = plain.Forward(SMALL, weights)
    for uid, req in got.items():
        seq = torch.as_tensor(np.concatenate([prompts[uid], req.out_tokens[:-1]]))
        rows = fwd.logits(fwd.run({0: (seq, len(prompts[uid]) - 1)})[0])
        assert len(req.out_tokens) == budgets[uid]
        logit = torch.tensor([s[0] for s in req.out_scores])
        lse = torch.tensor([s[1] for s in req.out_scores])
        at = rows.gather(1, torch.tensor(req.out_tokens)[:, None])[:, 0]
        torch.testing.assert_close(logit, at, rtol=0, atol=2e-4)
        torch.testing.assert_close(lse, torch.logsumexp(rows, -1), rtol=0, atol=2e-4)
        assert float((rows.max(-1).values - at).max()) <= 2e-4


def test_published_prefill_logits_match_the_plain_reference():
    """The port's forward (the whole-prompt prefill's) on a 40-token
    prompt equals the reference's at every position within 2e-4."""
    weights, pool, _ = lm.setup(SMALL, 8, "cpu")
    weights = _fp32(weights)
    model = lm.model_config(SMALL).replace(dtype="float32")
    seq = torch.randint(0, 256, (40,), generator=torch.Generator().manual_seed(2))
    got, _ = tr.forward(lm._tree(weights), seq[None], model)
    fwd = plain.Forward(SMALL, weights)
    want = fwd.logits(fwd.run({0: (seq, 0)})[0])
    torch.testing.assert_close(got[0], want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-v2-lite-16b"])
def test_whole_prompt_prefill_equals_token_by_token(arch):
    """More requests than slots, mixed lengths: the same tokens, scores
    within fp32 rounding (5e-5), one prefill call per request in place of
    one decode call per prompt token; the final caches agree."""
    cfg = get_smoke(arch).replace(dtype="float32")
    params = module.init_params(tr.param_spec(cfg), generator=torch.Generator().manual_seed(0),
                                device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (3, 6, 1, 4, 5)]
    budgets = (4, 2, 5, 1, 3)
    runs = {}
    for mode in ("token", "whole"):
        eng = ServeEngine(cfg, params, slots=2, max_len=16, device="cpu", prefill=mode)
        for uid, (p, n) in enumerate(zip(prompts, budgets)):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=n))
        runs[mode] = ({r.uid: r for r in eng.run()}, eng)
    (tok, teng), (whole, weng) = runs["token"], runs["whole"]
    assert {u: r.out_tokens for u, r in tok.items()} == {u: r.out_tokens for u, r in whole.items()}
    for uid in tok:
        np.testing.assert_allclose(np.array(whole[uid].out_scores),
                                   np.array(tok[uid].out_scores), rtol=0, atol=5e-5)
    assert weng.prefill_calls == len(prompts) and teng.prefill_calls == 0
    assert teng.decode_calls - weng.decode_calls == sum(map(len, prompts))
    for name, t in weng.cache.items():
        torch.testing.assert_close(t, teng.cache[name], rtol=0, atol=5e-5)


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-v2-lite-16b"])
def test_prefill_into_writes_only_its_rows(arch):
    cfg = get_smoke(arch).replace(dtype="float32")
    params = module.init_params(tr.param_spec(cfg), generator=torch.Generator().manual_seed(0),
                                device="cpu")
    cache = tr.init_cache(cfg, 3, 12, device="cpu")
    for t in cache.values():
        t.normal_(generator=torch.Generator().manual_seed(9))
    before = {k: v.clone() for k, v in cache.items()}
    logits = tr.prefill_into(params, cache, torch.tensor([[5, 9, 2, 7, 1]]), 1, cfg)
    want, _ = tr.forward(params, torch.tensor([[5, 9, 2, 7, 1]]), cfg)
    assert torch.equal(logits, want)
    for name, t in cache.items():
        assert torch.equal(t[:, [0, 2]], before[name][:, [0, 2]])
        assert torch.equal(t[:, 1, 5:], before[name][:, 1, 5:])
        assert not torch.equal(t[:, 1, :5], before[name][:, 1, :5])


def test_whole_prefill_refuses_what_its_cache_cannot_hold():
    cfg = get_smoke("olmo-1b").replace(dtype="float32")
    params = module.init_params(tr.param_spec(cfg), generator=torch.Generator().manual_seed(0),
                                device="cpu")
    eng = ServeEngine(cfg, params, slots=1, max_len=4, device="cpu", prefill="whole")
    with pytest.raises(ValueError, match="exceed max_len 4"):
        eng.submit(Request(uid=0, prompt=np.arange(5, dtype=np.int32), max_new_tokens=1))
    # A prompt that fits, but whose answer would decode past the cache:
    # its later tokens would be computed without its last keys.
    with pytest.raises(ValueError, match="a 3-token prompt and 3 new tokens exceed"):
        eng.submit(Request(uid=1, prompt=np.arange(3, dtype=np.int32), max_new_tokens=3))
    assert not eng.queue
    eng.submit(Request(uid=2, prompt=np.arange(3, dtype=np.int32), max_new_tokens=2))
    (done,) = eng.run()
    assert len(done.out_tokens) == 2 and eng.slot_pos[0] == 4
    with pytest.raises(ValueError, match="prefill must be"):
        ServeEngine(cfg, params, slots=1, max_len=4, device="cpu", prefill="chunked")
    ssm = get_smoke("mamba2-370m").replace(dtype="float32")
    p = module.init_params(tr.param_spec(ssm), generator=torch.Generator().manual_seed(0),
                           device="cpu")
    assert not ServeEngine(ssm, p, slots=1, max_len=8, device="cpu", prefill="whole").whole
    with pytest.raises(ValueError, match="token by token"):
        tr.prefill_into(p, tr.init_cache(ssm, 1, 8, device="cpu"),
                        torch.tensor([[1, 2]]), 0, ssm)
