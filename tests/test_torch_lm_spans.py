"""The span tree of ``ServeEngine.step`` (``repro_torch.spans``): each
tick one ``lm.step`` holding an ``lm.prefill`` per admitted prompt, one
``lm.decode`` when a slot decodes and one ``lm.pull``; their ids and
attributes; the token counters; ``engine.submit``; one device read a
tick with the whole-prompt prefill; the same tokens with the recorder on
and off."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.configs import deepseek_v2_lite as dsv2  # noqa: E402
from repro_torch.models import module  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

PROMPTS = (5, 3, 7, 2)
BUDGETS = (3, 1, 4, 2)
READS = ("tolist", "item", "cpu", "numpy", "__int__", "__float__", "__bool__",
         "__index__")


@pytest.fixture
def rec(monkeypatch):
    fresh = spans.Recorder()
    monkeypatch.setattr(spans, "RECORDER", fresh)
    return fresh


def _engine(prefill="whole"):
    cfg = dsv2.PUBLISHED_SMOKE.replace(dtype="float32")
    params = module.init_params(tr.param_spec(cfg), generator=torch.Generator().manual_seed(0),
                                device="cpu")
    eng = ServeEngine(cfg, params, slots=2, max_len=16, device="cpu", prefill=prefill)
    rng = np.random.default_rng(0)
    for uid, (n, budget) in enumerate(zip(PROMPTS, BUDGETS)):
        eng.submit(Request(uid=uid, prompt=rng.integers(0, 256, n).astype(np.int32),
                           max_new_tokens=budget))
    return eng


def _ticks(eng):
    out = []
    while eng.queue or any(r is not None and not r.done for r in eng.slot_req):
        out.append(eng.step())
    return out


@pytest.mark.parametrize("prefill", ["whole", "token"])
def test_step_span_tree_ids_attrs_and_counters(rec, prefill):
    eng = _engine(prefill)
    _ticks(eng)
    held = rec.spans()
    submits = [s for s in held if s.name == "engine.submit"]
    assert [s.key for s in submits] == [0, 1, 2, 3]
    steps = [s for s in held if s.name == "lm.step"]
    assert [s.key for s in steps] == list(range(1, eng.ticks + 1))
    kids = {s.seq: [] for s in steps}
    for s in held:
        if s.parent in kids:
            kids[s.parent].append(s)
    prefilled, decoded = [], 0
    for step in steps:
        names = sorted(k.name for k in kids[step.seq])
        a = spans.attr_dict(step.attrs)
        assert names.count("lm.pull") == 1 and names.count("lm.decode") <= 1
        assert names.count("lm.prefill") == a["prefills"]
        assert set(names) <= {"lm.prefill", "lm.decode", "lm.pull"}
        for k in kids[step.seq]:
            assert step.t0 <= k.t0 <= k.t1 <= step.t1
            ka = spans.attr_dict(k.attrs)
            if k.name == "lm.prefill":
                prefilled.append(k.key)
                assert ka["tokens"] == PROMPTS[k.key] and len(ka["slot"]) == 1
                assert ka["device_ms"] == pytest.approx((k.t1 - k.t0) / 1e6)
            elif k.name == "lm.decode":
                assert k.key == step.key and ka["rows"] == a["slots"]
                assert ka["kv"] >= len(ka["rows"]) and ka["device_ms"] >= 0
                decoded += len(ka["rows"])
            else:
                assert k.key == step.key
        if "lm.decode" not in names:
            assert a["slots"] == []
    assert prefilled == [0, 1, 2, 3]
    assert rec.counters[spans.PREFILL_TOKENS] == sum(PROMPTS)
    # every token but each request's first comes from a decode row
    assert rec.counters[spans.DECODE_TOKENS] == decoded == sum(BUDGETS) - len(BUDGETS)


def test_one_device_read_a_whole_prompt_tick(rec, monkeypatch):
    """Every value the host takes from a tensor during ``step()`` is one
    read of the tick's scores: the prefills' first tokens and the decode's
    rows together."""
    eng = _engine()
    reads = []
    for name in READS:
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **kw):
            reads.append(_name)
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counted)
    step = eng.step
    per_tick = []

    def counting():
        reads.clear()
        out = step()
        per_tick.append(list(reads))
        return out

    eng.step = counting
    _ticks(eng)
    assert per_tick and all(r == ["tolist"] for r in per_tick), per_tick


def test_tokens_and_scores_equal_with_the_recorder_on_and_off(rec):
    on = _engine()
    _ticks(on)
    held = len(rec.spans())
    rec.enabled = False
    off = _engine()
    _ticks(off)
    assert len(rec.spans()) == held
    for a, b in zip(on.slot_req, off.slot_req):
        assert a.out_tokens == b.out_tokens and a.out_scores == b.out_scores
