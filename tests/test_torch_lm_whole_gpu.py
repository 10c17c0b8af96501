"""``ServeEngine(prefill="whole")`` on the card: its decode step captured
as a CUDA graph when the engine is built, against the same step run
eagerly on the card and against the engine on the CPU. Every test takes
the ``cuda`` fixture, which skips where there is no card; run them on a
GPU host with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_lm_whole_gpu.py

fp32 at small widths with TF32 off, weights from the port's seeded init.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import deepseek_v2_lite as dsv2, get_smoke  # noqa: E402
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


def _serve(cfg, params, device, eager=False):
    """Six requests through three slots; also returns the slots that each
    tick's decode served (fewer than three: idle slots in that step)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 9, 1, 4, 6, 2)]
    eng = ServeEngine(cfg, params, slots=3, max_len=24, device=device, prefill="whole")
    if eager:
        eng._graph = None
    for uid, (p, n) in enumerate(zip(prompts, (4, 2, 6, 1, 3, 5))):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=n))
    done, served = {}, []
    while eng.queue or any(r is not None and not r.done for r in eng.slot_req):
        served.append(eng.step())
        for s, r in enumerate(eng.slot_req):
            if r is not None and r.done:
                done[r.uid] = (r.out_tokens, r.out_scores)
                eng.slot_req[s] = None
    return done, eng, served


@pytest.mark.parametrize("cfg", [dsv2.PUBLISHED_SMOKE, get_smoke("olmo-1b")],
                         ids=["deepseek-published", "olmo"])
def test_captured_decode_equals_eager_and_the_cpu(cuda, cfg):
    """The graph's tokens, scores and every cache row bit for bit the
    eager step's on the card, steps with idle slots among them (the MoE
    leaves an idle slot's tokens out of every expert group); the tokens
    the CPU's."""
    cfg = cfg.replace(dtype="float32")
    params = module.init_params(transformer.param_spec(cfg), device="cpu",
                                generator=torch.Generator().manual_seed(0))
    graph, geng, served = _serve(cfg, params, cuda)
    eager, eeng, eserved = _serve(cfg, params, cuda, eager=True)
    assert served == eserved and any(0 < n < geng.slots for n in served)
    assert geng._graph is not None and graph == eager
    assert geng.decode_calls == eeng.decode_calls
    for name, t in geng.cache.items():
        assert torch.equal(t, eeng.cache[name]), name
    cpu, _, _ = _serve(cfg, params, "cpu")
    assert {u: t for u, (t, _) in graph.items()} == {u: t for u, (t, _) in cpu.items()}
