"""The LM ``ServeEngine`` on the card against the same engine on the CPU.
Every test takes the ``cuda`` fixture, which skips where there is no
card; run them on a GPU host with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_lm_gpu.py

Weights come from the port's seeded init (no JAX on the card's host).
fp32 at SMOKE widths with TF32 off: the tokens are greedy argmaxes of
logits that agree to fp32 rounding, so they and the decode calls must be
equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import griffin, mla, module, moe, ssm, transformer  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("arch,kw", [("olmo-1b", {}), ("qwen2-vl-72b", {}),
                                     ("olmo-1b", dict(attention="knn",
                                                      knn_neighbors=3)),
                                     ("deepseek-v2-lite-16b", {}),
                                     ("qwen3-moe-235b-a22b", {}),
                                     ("mamba2-370m", {}),
                                     ("recurrentgemma-9b", dict(num_layers=5))],
                         ids=["olmo", "qwen2-vl", "olmo-knn", "deepseek",
                              "qwen3-moe", "mamba2", "recurrentgemma-5l"])
def test_engine_on_card_equals_cpu(cuda, arch, kw):
    """The LM ServeEngine at SMOKE widths in fp32: the card's tokens and
    decode calls equal the CPU's on mixed prompts, more requests than
    slots."""
    cfg = get_smoke(arch).replace(dtype="float32", **kw)
    params = module.init_params(transformer.param_spec(cfg), device="cpu",
                                generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 6, 1, 4, 5)]
    runs = {}
    for dev in ("cpu", cuda):
        eng = ServeEngine(cfg, params, slots=2, max_len=16, device=dev)
        for uid, (p, n) in enumerate(zip(prompts, (4, 2, 5, 1, 3))):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=n))
        runs[str(dev)] = ({r.uid: r.out_tokens for r in eng.run()},
                          eng.decode_calls)
    assert runs["cuda"] == runs["cpu"]


def _on(tree, dev):
    return module.map_tree(lambda _, t: t.to(dev), tree)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"])
def test_moe_layer_on_card_equals_cpu(cuda, arch):
    """fp32, TF32 off: the same expert selection and outputs within 1e-5
    (sums in other orders)."""
    cfg = get_smoke(arch).replace(dtype="float32")
    p = module.init_params(moe.moe_spec(cfg), device="cpu",
                           generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 5, cfg.d_model)).astype(np.float32))
    want, wm = moe.moe_apply(p, x, cfg)
    got, gm = moe.moe_apply(_on(p, cuda), x.to(cuda), cfg)
    _, sel, _, _ = moe._router(p, x.reshape(-1, cfg.d_model), cfg.moe)
    _, dsel, _, _ = moe._router(_on(p, cuda), x.to(cuda).reshape(-1, cfg.d_model),
                                cfg.moe)
    assert torch.equal(dsel.cpu(), sel)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    assert abs(float(gm["moe_aux"]) - float(wm["moe_aux"])) <= 1e-6


def test_mla_layer_on_card_equals_cpu(cuda):
    """fp32 prefill and the absorbed decode at (B,) positions with a
    member-row commit: outputs and latents within 1e-5."""
    cfg = get_smoke("deepseek-v2-lite-16b").replace(dtype="float32")
    p = module.init_params(mla.mla_spec(cfg), device="cpu",
                           generator=torch.Generator().manual_seed(2))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32))
    pos = torch.arange(9).expand(2, 9)
    runs = {}
    for dev in ("cpu", cuda):
        pd = _on(p, dev)
        out, (c, k) = mla.mla_apply(pd, x.to(dev), cfg, positions=pos.to(dev))
        cache = {"c_kv": torch.nn.functional.pad(c, (0, 0, 0, 3)),
                 "k_pe": torch.nn.functional.pad(k, (0, 0, 0, 3))}
        pv = torch.tensor([9, 4], device=dev)
        dec, _ = mla.mla_apply(pd, x[:, :1].to(dev), cfg, positions=pv[:, None],
                               cache=cache, pos=pv,
                               rows=torch.tensor([0], device=dev))
        runs[str(dev)] = [t.cpu() for t in (out, c, k, dec[:1], *cache.values())]
    for got, want in zip(runs["cuda"], runs["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_recurrent_layer_on_card_equals_cpu(cuda, arch):
    """fp32, TF32 off: the SSD or RG-LRU block's prefill and two decode
    steps from its final state, outputs and states within rtol 1e-4, atol
    1e-5 (sums in other orders)."""
    cfg = get_smoke(arch).replace(dtype="float32")
    mod = ssm if cfg.family == "ssm" else griffin
    spec = ssm.ssm_spec(cfg) if mod is ssm else griffin.rglru_spec(cfg)
    apply = ssm.ssm_apply if mod is ssm else griffin.rglru_apply
    p = module.init_params(spec, device="cpu",
                           generator=torch.Generator().manual_seed(3))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32))
    runs = {}
    for dev in ("cpu", cuda):
        pd = _on(p, dev)
        out, st = apply(pd, x[:, :7].to(dev), cfg)
        outs = [out]
        for t in (7, 8):
            o, st = apply(pd, x[:, t:t + 1].to(dev), cfg, state=st)
            outs.append(o)
        runs[str(dev)] = [t.cpu() for t in (*outs, *st.values())]
    for got, want in zip(runs["cuda"], runs["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_hybrid_decode_commit_on_card_equals_cpu(cuda):
    """The hybrid's nested cache through ``decode_step(rows=)`` on the
    card: a member-row commit at (B,) positions, one group and two ``rem``
    layers; logits of the member rows and every cache leaf within JAX's
    LM tolerance, rtol 2e-3 and atol 2e-4 times the leaf's largest
    magnitude (at least 1), of the CPU's: the group's stacked init has
    fan-in 1, so its saturated RG-LRU gates carry the rounding of sums in
    other orders into the state (``tools/hybrid_fp32_gap.py``); non-member
    rows untouched."""
    cfg = get_smoke("recurrentgemma-9b").replace(dtype="float32", num_layers=5)
    p = module.init_params(transformer.param_spec(cfg), device="cpu",
                           generator=torch.Generator().manual_seed(4))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (3, 6)).astype(np.int32))
    runs = {}
    for dev in ("cpu", cuda):
        pd, cache = _on(p, dev), transformer.init_cache(cfg, 3, 8, device=dev)
        for t in range(6):
            pos = torch.tensor([t, t + 1, 0], device=dev)
            lg, cache = transformer.decode_step(
                pd, cache, toks[:, t:t + 1].to(dev), pos, cfg,
                rows=torch.tensor([0, 1], device=dev))
        leaves = module.leaves(cache)
        for path, t in leaves.items():
            assert not t.select(0 if path[0] == "rem" else 1, 2).any(), path
        runs[str(dev)] = [lg[:2].cpu(), *(t.cpu() for t in leaves.values())]
    for got, want in zip(runs["cuda"], runs["cpu"]):
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-4 * scale)


def test_init_in_compute_dtype_on_card(cuda):
    """A CUDA generator draws the serving tree straight into bf16 with the
    fp32 leaves (norms, router, latent norm) kept, and the engine holds it
    without a copy."""
    cfg = get_smoke("deepseek-v2-lite-16b")
    p = module.init_params(transformer.param_spec(cfg), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(0),
                           dtype_of=lambda path: transformer.compute_dtype(path, cfg))
    for path, t in module.leaves(p).items():
        fp32 = (path[0] == "final_norm" or path[1] in ("ln1", "ln2")
                or path[-1] in ("kv_norm", "router"))
        assert t.is_cuda and t.dtype == (torch.float32 if fp32 else torch.bfloat16), path
    eng = ServeEngine(cfg, p, slots=2, max_len=8, device=cuda)
    assert all(a is b for a, b in zip(module.leaves(eng.params).values(),
                                      module.leaves(p).values()))
