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
from repro_torch.models import module, transformer  # noqa: E402
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
                                                      knn_neighbors=3))],
                         ids=["olmo", "qwen2-vl", "olmo-knn"])
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
