"""On the card: the engine's spans and the profiler's device trace share a
clock. Thirty captured bucket-8 ticks of a small ViG run under
``torch.profiler`` (CUDA activity); each tick's device-to-host copy of
its logits (the ``cudaMemcpyAsync`` call whose copy the trace marks
``DtoH``) lies inside the tick's exported ``engine.pull`` span, within
20 us. Run on a card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_spans_gpu.py
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans, testing  # noqa: E402
from repro_torch.models import convert, vig  # noqa: E402
from repro_torch.serve.engine import VigRequest, VigServeEngine  # noqa: E402

pytestmark = pytest.mark.gpu

TICKS = 30
SLACK_US = 20.0
KW = dict(image_size=64, patch=8, embed_dims=(48,), depths=(2,),
          num_classes=10, k=9, digc_impl="cuda")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tick(eng, imgs, uid0):
    for i in range(8):
        eng.submit(VigRequest(uid=uid0 + i, image=imgs[i]))
    assert eng.step() == 8


def test_each_ticks_logits_copy_lies_inside_its_pull_span(cuda, tmp_path, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    rec = spans.Recorder()
    monkeypatch.setattr(spans, "RECORDER", rec)

    cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(**KW)
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device="cpu")
    eng = VigServeEngine(cfg, params, buckets=(8,), guards=True, device=cuda)
    imgs = testing.images(1, 8, 64)
    for w in range(2):  # the capture, then a replay
        _tick(eng, imgs, 1000 * w)
    torch.cuda.synchronize()
    first = eng._tick + 1
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for t in range(TICKS):
            _tick(eng, imgs, 10_000 + 8 * t)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    d2h = {e["args"]["correlation"] for e in events
           if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]}
    calls = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "cuda_runtime"
                   and e["name"] == "cudaMemcpyAsync"
                   and e["args"].get("correlation") in d2h)
    pulls = [e for e in rec.chrome_events(int(trace["baseTimeNanoseconds"]))
             if e["name"] == "engine.pull" and e["args"]["id"] >= first]
    assert [p["args"]["id"] for p in pulls] == list(range(first, first + TICKS))
    assert len(calls) >= TICKS, (len(calls), len(d2h))
    for p in pulls:
        lo, hi = p["ts"] - SLACK_US, p["ts"] + p["dur"] + SLACK_US
        inside = [c for c in calls if lo <= c[0] and c[1] <= hi]
        near = min(calls, key=lambda c: abs(c[0] - p["ts"]))
        assert len(inside) == 1, (p["args"]["id"], p["ts"], p["dur"], near)
    starts = np.array([p["ts"] for p in pulls])
    assert np.all(np.diff(starts) > 0)
