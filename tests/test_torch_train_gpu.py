"""The training path and the encoder-decoder on the card. Every test takes
the ``cuda`` fixture, which skips where there is no card; run them on a
GPU host with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_train_gpu.py

Weights come from the port's seeded init (no JAX on the card's host).
fp32 with TF32 off: the card's loss and grad norm equal the CPU's within
1e-4 relative, the decode loop's logits the teacher-forced pass's within
JAX's family tolerance (rtol 2e-3, atol 2e-4).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data.pipeline import DataConfig, synth_image_batch, synth_lm_batch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.api import get_api  # noqa: E402
from repro_torch.models import convert, encdec, module, vig  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.trainer import init_train_state, make_train_step, value_and_grad  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_mrconv_kernel_raises_under_grad(cuda):
    """ROADMAP queue 3, item 20: the kernel has no backward, so the
    ``cuda`` aggregate refuses inputs that require grad while grad mode is
    on; without grad (serving) it launches as before."""
    x = torch.randn(2, 16, 8, device=cuda)
    idx = torch.randint(0, 16, (2, 16, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="item 20"):
        ops.mrconv(x.requires_grad_(), x, idx)
    with torch.no_grad():
        assert ops.mrconv(x, x, idx).shape == (2, 16, 8)
    with torch.inference_mode():
        assert ops.mrconv(x.detach(), x.detach(), idx).shape == (2, 16, 8)
    cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(
        image_size=64, embed_dims=(32,), depths=(2,), num_classes=7, k=4,
        digc_impl="cuda")
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=cuda)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in synth_image_batch(
        DataConfig(1, 2, 1), 0, image_size=64, num_classes=7).items()}
    with pytest.raises(NotImplementedError, match="item 20"):
        value_and_grad(vig.vig_loss_fn, params, batch, cfg)


def test_olmo_train_step_on_card_equals_cpu(cuda):
    """The step's loss and grad norm, and each leaf's grad within 1e-4 of
    its RMS. The parameters after the step are not compared elementwise:
    at step 1 AdamW moves a parameter by ~lr x sign(g), so a grad that
    differs in sign near zero moves it the other way."""
    cfg = get_smoke("olmo-1b").replace(dtype="float32")
    api = get_api(cfg)
    p_cpu = module.init_params(api.param_spec(), device="cpu",
                               generator=torch.Generator().manual_seed(0))
    batch = synth_lm_batch(DataConfig(16, 4, cfg.vocab_size), 0)
    step = make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=1, total_steps=10),
                           loss_fn=api.loss_fn, param_dtype=torch.float32)
    out = {}
    for dev in ("cpu", cuda):
        params = module.map_tree(lambda _, t: t.to(dev), p_cpu)
        on_dev = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        _, _, m = step(params, init_train_state(params), on_dev)
        grads = value_and_grad(api.loss_fn, params, on_dev, cfg)[2]
        out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]),
                         {k: t.cpu() for k, t in module.leaves(grads).items()})
    (l_cpu, g_cpu, gr_cpu), (l_dev, g_dev, gr_dev) = out["cpu"], out["cuda"]
    assert abs(l_dev - l_cpu) <= 1e-4 * abs(l_cpu)
    assert abs(g_dev - g_cpu) <= 1e-4 * g_cpu
    for path, g in gr_cpu.items():
        rms = float(g.pow(2).mean().sqrt())
        assert float((gr_dev[path] - g).pow(2).mean().sqrt()) <= 1e-4 * rms, path


def test_encdec_decode_loop_equals_decode_forward_on_card(cuda):
    cfg = get_smoke("whisper-tiny").replace(dtype="float32")
    api = get_api(cfg)
    params = module.init_params(api.param_spec(), device=cuda,
                                generator=torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(rng.standard_normal((2, 24, cfg.d_model)).astype(
        np.float32)).to(cuda)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12)).astype(
        np.int32)).to(cuda)
    with torch.inference_mode():
        memory = encdec.encode(params, frames, cfg)
        full, (_, (mk, mv)) = encdec.decode_forward(params, tokens, memory, cfg,
                                                    return_cache=True)
        cache = api.init_cache(2, 12, enc_len=24, device=cuda)
        cache["mk"].copy_(mk)
        cache["mv"].copy_(mv)
        outs = []
        for t in range(12):
            lg, cache = api.decode_fn(params, cache, tokens[:, t:t + 1], t)
            outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).cpu().numpy(),
                               full.cpu().numpy(), rtol=2e-3, atol=2e-4)
