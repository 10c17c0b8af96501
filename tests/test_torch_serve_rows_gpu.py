"""On the card: the serving engine's slot-row lifecycle makes no host
round trip. Bucket-8 ticks of one-shot requests on the ``cuda`` tier at
the ``vig_ti_pyr`` shape (224 px, four stages, so four state entries) run
under ``torch.profiler`` (CUDA activity). Inside each profiled tick's
``engine.select``, ``engine.stage`` and ``engine.scatter`` spans no
``cudaStreamSynchronize`` starts and no copy reads pageable memory; each
tick copies two things to the card, its images and its row index (16
int64 ids: 8 lanes, then 8 slots admission bound cold); the counters read
8 resets, one index copy and one skipped scatter a tick; and every
request's logits equal an eager engine's bit for bit. Run on a card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_serve_rows_gpu.py
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans, testing  # noqa: E402
from repro_torch.models import convert, vig  # noqa: E402
from repro_torch.serve.engine import VigRequest, VigServeEngine  # noqa: E402

pytestmark = pytest.mark.gpu

WARM = 2  # the capture, then a replay
TICKS = 10
LANES = 8
SIZE = 224
# The trace's clock and the spans' agree within ~20-30 us: a call is
# counted in a span when it starts in the span less this at its end.
SLACK_US = 30.0
CHECKED = ("engine.select", "engine.stage", "engine.scatter")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


class _Eager(VigServeEngine):
    """The same engine with its bucket program run eagerly."""

    def _captures(self):
        return False


def _serve(eng, ticks, first_uid=0):
    out = []
    for t in range(ticks):
        imgs = testing.images(first_uid + t, LANES, SIZE)
        reqs = [VigRequest(uid=first_uid + 100 * t + i, image=imgs[i])
                for i in range(LANES)]
        for r in reqs:
            eng.submit(r)
        assert eng.step() == LANES
        out += reqs
    return out


def test_one_shot_tick_stages_one_index_and_never_waits(cuda, tmp_path,
                                                        monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    rec = spans.Recorder()
    monkeypatch.setattr(spans, "RECORDER", rec)
    cfg = vig.VIG_VARIANTS["vig_ti_pyr"]
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device="cpu")
    kw = dict(digc_impl="cuda", autotune=False, buckets=(LANES,),
              guards=True, device=cuda)
    eng = VigServeEngine(cfg, params, **kw)
    warm = _serve(eng, WARM)
    torch.cuda.synchronize()
    first = eng._tick + 1
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = _serve(eng, TICKS, first_uid=1000)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())

    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    calls = [e for e in events if e.get("cat") == "cuda_runtime"]
    copies = {e["args"]["correlation"]: e for e in events
              if e.get("cat") == "gpu_memcpy"}
    held = [e for e in rec.chrome_events(int(trace["baseTimeNanoseconds"]))
            if e["args"]["id"] >= first]
    steps = [e for e in held if e["name"] == "engine.step"]
    assert [e["args"]["id"] for e in steps] == list(range(first, first + TICKS))
    assert all(e["args"]["syncs"] == 2 for e in steps)

    def starts_in(call, span):
        return span["ts"] <= call["ts"] <= span["ts"] + span["dur"] - SLACK_US

    checked = [e for e in held if e["name"] in CHECKED]
    assert len(checked) == len(CHECKED) * TICKS
    for span in checked:
        inside = [c for c in calls if starts_in(c, span)]
        syncs = [c for c in inside if c["name"] == "cudaStreamSynchronize"]
        pageable = [copies[c["args"]["correlation"]]["name"] for c in inside
                    if c["args"].get("correlation") in copies
                    and "Pageable" in copies[c["args"]["correlation"]]["name"]]
        assert not syncs and not pageable, (span["name"], span["args"]["id"],
                                            len(syncs), pageable)
    # The logits' pull reads into pageable memory: the check sees such
    # copies where they are.
    assert any("Pageable" in c["name"] for c in copies.values())

    index_bytes = 2 * LANES * 8
    image_bytes = LANES * SIZE * SIZE * cfg.in_chans * 4
    for step in steps:
        h2d = sorted(int(copies[c["args"]["correlation"]]["args"]["bytes"])
                     for c in calls
                     if step["ts"] <= c["ts"] <= step["ts"] + step["dur"]
                     and c["args"].get("correlation") in copies
                     and "HtoD" in copies[c["args"]["correlation"]]["name"])
        assert h2d == [index_bytes, image_bytes], (step["args"]["id"], h2d)

    ticks = WARM + TICKS
    s = eng.stats()
    assert (s["rows_reset"], s["row_index_uploads"], s["scatter_skipped"]) == (
        LANES * ticks, ticks, ticks)
    for name, n in ((spans.ROWS_RESET, LANES * ticks),
                    (spans.ROW_INDEX_UPLOADS, ticks),
                    (spans.SCATTER_SKIPPED, ticks)):
        assert rec.counters[name] == n, name
    assert eng.slot_row_steps() == {k: [0] * LANES
                                    for k in eng._slot_state.entries}

    eager = _Eager(cfg, params, **kw)
    want = _serve(eager, WARM) + _serve(eager, TICKS, first_uid=1000)
    for r, w in zip(warm + got, want):
        assert r.uid == w.uid and np.array_equal(r.logits, w.logits), r.uid
