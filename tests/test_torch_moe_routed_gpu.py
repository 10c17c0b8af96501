"""The routed expert kernel (``kernels/csrc/moe_experts.cu``) on the card
against its plain PyTorch version (``moe_experts_plain``, run on the same
card tensors), at DeepSeek-V2-Lite's and qwen3-moe's widths in bf16, at the
SMOKE configurations' small widths (a partial column tile and depth stage)
in bf16 and fp32, and through ``moe_apply`` at the SMOKE configurations in
bf16 against the dense form. Every test takes the ``cuda`` fixture, which skips
where there is no card; run them on a GPU host with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_moe_routed_gpu.py

Tolerances: bf16, the two sides round h, y and the output to bf16 from
fp32 sums taken in other orders, so an element may differ by a few bf16
ulps (up to 0.8% each) of itself or of the terms it sums: within 2e-2 of
itself plus 2e-2 of the output's RMS (``tests/test_torch_moe.py``'s bf16
tolerance), and the mean |diff| within 2e-3 of the RMS (a wrong row or
expert moves it by ~1).
fp32 (TF32 off): rtol = atol = 1e-5.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import deepseek_v2_lite as dsv2, get_smoke  # noqa: E402
from repro_torch.kernels import moe_experts as mx  # noqa: E402
from repro_torch.models import module, moe  # noqa: E402

pytestmark = pytest.mark.gpu

# (D, F, E, k, gates normalised): the cells' and qwen3-moe's widths
DSV2 = (2048, 1408, 64, 6, False)
QWEN3 = (4096, 1536, 128, 8, True)
# the SMOKE configurations' widths: qwen3-moe's, DeepSeek-V2-Lite's
# PUBLISHED_SMOKE, and widths of 8 past a 16-deep step
QWEN3_SMOKE = (64, 96, 8, 2, True)
DSV2_PUB_SMOKE = (64, 32, 8, 3, False)
ODD = (72, 40, 4, 2, True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _layer(dev, shape, dtype, seed=0):
    """One layer's experts in ``dtype`` and an fp32 router, each of sd
    1 / sqrt(fan-in), and the generator that drew them."""
    d, f, e, k, norm = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(*s, fan):
        return (torch.randn(*s, generator=g, device=dev) / fan ** 0.5).to(dtype)

    w = {"w_gate": draw(e, d, f, fan=d), "w_up": draw(e, d, f, fan=d),
         "w_down": draw(e, f, d, fan=f),
         "router": torch.randn(d, e, generator=g, device=dev) / d ** 0.5}
    return w, g


def _route(w, tokens, k, norm):
    m = type("M", (), {"top_k": k})
    gates, sel, _, _ = moe._router(w, tokens, m, norm)
    return sel, gates.contiguous()


def _run(fn, w, tokens, sel, gates, live=None):
    perm, row_off = mx.dispatch(sel, live, w["w_gate"].shape[0])
    return fn(tokens, w["w_gate"], w["w_up"], w["w_down"], perm, row_off,
              gates, live)


def _close_bf16(got, want):
    rms = float(want.float().pow(2).mean().sqrt())
    torch.testing.assert_close(got.float() / rms, want.float() / rms,
                               rtol=2e-2, atol=2e-2)
    diff = float((got.float() - want.float()).abs().mean())
    assert diff <= 2e-3 * rms, (diff, rms)


@pytest.mark.parametrize("shape,t,n_live", [
    (DSV2, 64, 7),     # the cell's decode: 64 slot rows, 7 live
    (DSV2, 128, None),  # prefills
    (DSV2, 1024, None),
    (DSV2, 4096, None),
    (QWEN3, 64, 7),
    (QWEN3, 512, None),
    (QWEN3_SMOKE, 37, 20),
    (DSV2_PUB_SMOKE, 37, None),
    (ODD, 300, 200),
], ids=["dsv2-decode", "dsv2-128", "dsv2-1024", "dsv2-4096", "qwen3-decode",
        "qwen3-512", "qwen3-smoke", "dsv2-published-smoke", "odd-widths"])
def test_kernel_equals_plain_bf16(cuda, shape, t, n_live):
    d, f, e, k, norm = shape
    w, g = _layer(cuda, shape, torch.bfloat16)
    tokens = torch.randn(t, d, generator=g, device=cuda).to(torch.bfloat16)
    sel, gates = _route(w, tokens, k, norm)
    live = None
    if n_live is not None:
        live = torch.zeros(t, dtype=torch.bool, device=cuda)
        live[torch.randperm(t, generator=g, device=cuda)[:n_live]] = True
    kernels.reset_launch_counts()
    got = _run(mx.moe_experts_cuda, w, tokens, sel, gates, live)
    assert kernels.launch_counts()["moe_experts"] == 1
    want = _run(mx.moe_experts_plain, w, tokens, sel, gates, live)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (t, d)
    if live is None:
        _close_bf16(got, want)
        return
    _close_bf16(got[live], want[live])
    assert not bool(got[~live].any())  # a dead row's output is 0
    # live rows bit for bit the call where every row is live
    every = _run(mx.moe_experts_cuda, w, tokens, sel, gates)
    assert torch.equal(got[live], every[live])


@pytest.mark.parametrize("shape", [(64, 32, 8, 3, False), (64, 96, 8, 2, True),
                                   (128, 64, 16, 4, False), ODD])
def test_kernel_equals_plain_fp32(cuda, shape):
    d, f, e, k, norm = shape
    w, g = _layer(cuda, shape, torch.float32, seed=1)
    tokens = torch.randn(37, d, generator=g, device=cuda)
    sel, gates = _route(w, tokens, k, norm)
    live = torch.rand(37, generator=g, device=cuda) < 0.7
    got = _run(mx.moe_experts_cuda, w, tokens, sel, gates, live)
    want = _run(mx.moe_experts_plain, w, tokens, sel, gates, live)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_captured_equals_eager(cuda):
    """The dispatch and the kernel recorded in a CUDA graph (no host read)
    and replayed on new tokens and liveness: bit for bit an eager call."""
    d, f, e, k, norm = DSV2
    w, g = _layer(cuda, DSV2, torch.bfloat16, seed=2)
    tokens = torch.randn(64, d, generator=g, device=cuda).to(torch.bfloat16)
    live = torch.zeros(64, dtype=torch.bool, device=cuda)
    out = torch.empty_like(tokens)

    def step():
        sel, gates = _route(w, tokens, k, norm)
        out.copy_(mx.moe_experts(tokens, w["w_gate"], w["w_up"], w["w_down"],
                                 sel, gates, live))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    for n_live in (7, 64, 0):
        tokens.copy_(torch.randn(64, d, generator=g, device=cuda))
        live.zero_()
        live[torch.randperm(64, generator=g, device=cuda)[:n_live]] = True
        graph.replay()
        sel, gates = _route(w, tokens, k, norm)
        eager = mx.moe_experts(tokens, w["w_gate"], w["w_up"], w["w_down"],
                               sel, gates, live)
        assert torch.equal(out, eager), n_live


@pytest.mark.parametrize("cfg", [get_smoke("qwen3-moe-235b-a22b"),
                                 get_smoke("deepseek-v2-lite-16b"),
                                 dsv2.PUBLISHED_SMOKE],
                         ids=["qwen3-moe", "deepseek", "deepseek-published"])
def test_smoke_configs_route_in_bf16(cuda, cfg, monkeypatch):
    """``moe_apply`` at the SMOKE configurations' widths in bf16 (as they
    serve): the routed kernel, against the dense form on the same card."""
    p = module.init_params(moe.moe_spec(cfg), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(4))
    x = torch.randn(3, 5, cfg.d_model, generator=torch.Generator(
        device=cuda).manual_seed(5), device=cuda).to(torch.bfloat16)
    kernels.reset_launch_counts()
    with torch.no_grad():
        out, _ = moe.moe_apply(p, x, cfg)
        assert kernels.launch_counts()["moe_experts"] == 1
        monkeypatch.setattr(moe, "_routes", lambda *_: False)
        dense, _ = moe.moe_apply(p, x, cfg)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    _close_bf16(out.reshape(-1, cfg.d_model), dense.reshape(-1, cfg.d_model))


def test_wrapper_raises_on_what_the_kernel_cannot_take(cuda):
    w, g = _layer(cuda, (100, 64, 4, 2, True), torch.bfloat16)
    tokens = torch.randn(5, 100, device=cuda).to(torch.bfloat16)
    sel, gates = _route(w, tokens, 2, True)
    with pytest.raises(ValueError, match="multiples of 8"):
        _run(mx.moe_experts_cuda, w, tokens, sel, gates)
    w16 = {n: t.half() for n, t in w.items()}
    with pytest.raises(TypeError, match="bf16 or fp32"):
        _run(mx.moe_experts_cuda, w16, tokens.half(), sel, gates)
    w2, _ = _layer(cuda, (64, 64, 4, 2, True), torch.bfloat16)
    with pytest.raises(TypeError, match="w_gate must be torch.float32"):
        _run(mx.moe_experts_cuda, w2, torch.randn(5, 64, device=cuda), sel, gates)
    with pytest.raises(ValueError, match="is on cpu"):
        _run(mx.moe_experts_cuda, w2, tokens[:, :64].contiguous(), sel.cpu(),
             gates)
