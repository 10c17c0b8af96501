"""The ``lm`` family (``families/lm.py``) at a small size on the CPU:
DeepSeek-V2's published structure at ``PUBLISHED_SMOKE``'s widths served
in bf16 through ``ServeEngine`` with the whole-prompt prefill; its runs,
its readings against its controls, its frozen shape arithmetic and the
readers of its six metrics on a synthetic recorder."""

from __future__ import annotations

import json
import math
import time
import types
from pathlib import Path

import numpy as np
import pytest

from vigbench import control, harness, lm_shapes
from vigbench.families import lm

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
CELL = "dsv2lite-poisson"
FULL = json.loads((HERE / "configs" / "deepseek_v2_lite.json").read_text())
SMALL = dict(FULL, num_hidden_layers=3, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, kv_lora_rank=32, n_routed_experts=8, num_experts_per_tok=3,
             moe_intermediate_size=32, intermediate_size=96, vocab_size=256, slots=4,
             max_len=40, pool_prompts=8,
             prompt_tokens={"median": 12, "sigma_log": 0.7, "min": 4, "max": 24},
             answer_tokens={"median": 6, "sigma_log": 0.6, "min": 2, "max": 12, "cycle": 16})
MIX = dict(json.loads((HERE / "traffic" / "poisson_dsv2lite.json").read_text()),
           rate_per_s=24, trace_ticks=4, steady_s=0.5)
# Set from control.readings at this size on the CPU, seeds 2**31 + 11 and
# 9001-9013, 0.5 s windows of 12 requests: the program's widest gaps
# reached 0.161 (token) and 0.212 nats (log-probability); the fp8
# control's least were 0.578 and 0.453.
LIMITS = {"missing": 0, "token_gap_max": 0.35, "logprob_gap_max": 0.33}
SEED = 2**31 + 11


def _run(seed=SEED, trace=False):
    return harness.run_cell(
        cfg=SMALL, mix=MIX, limits=LIMITS,
        metrics=harness.cell_metrics(BENCH, CELL, trace), seed=seed, seconds=0.5,
        trace=trace, device="cpu", t_process=time.perf_counter())


def test_a_sound_bf16_run_is_correct():
    result = _run()
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] == round(MIX["rate_per_s"] * 0.5)
    assert set(result["checks"]) == set(LIMITS)
    assert {"latency_p95_ms", "latency_p50_ms", "setup_s"} == set(result["metrics"])


@pytest.mark.parametrize("seed", [SEED, 9013])
def test_readings_hold_the_program_and_refuse_each_control(seed):
    out = control.readings(SMALL, MIX, LIMITS, seed, 0.5, "cpu")
    program = out["program"]
    assert program["missing"] == 0
    for name in program.keys() & LIMITS.keys():
        assert program[name] <= LIMITS[name], name
    assert set(out) == {"seed", "requests", "reference_s", "program", *lm.CONTROL_BREAKS}
    for name, number in lm.CONTROL_BREAKS.items():
        assert out[name][number] > LIMITS[number], name


def test_answers_rolled_onto_the_next_request_are_not_correct(monkeypatch):
    step = lm.System.step
    carry = []

    def rolled(self):
        done = step(self)
        answers = carry + [a for _, a, _ in done]
        carry[:] = answers[-1:]
        return [(uid, a, lane) for (uid, _, lane), a in zip(done, answers)]

    monkeypatch.setattr(lm.System, "step", rolled)
    result = _run()
    assert result["correct"] is False
    assert result["checks"]["token_gap_max"]["value"] > LIMITS["token_gap_max"]


def test_a_perturbed_logit_is_not_correct(monkeypatch):
    """A program that reports each token's logit 0.5 too high (its
    tokens and log-sum-exps right) fails the log-probability limit."""
    step = lm.System.step

    def shifted(self):
        out = []
        for uid, a, lane in step(self):
            a = a.copy()
            a[:, 2] += 0.5
            out.append((uid, a, lane))
        return out

    monkeypatch.setattr(lm.System, "step", shifted)
    result = _run()
    assert result["correct"] is False
    assert result["checks"]["logprob_gap_max"]["value"] > LIMITS["logprob_gap_max"]


def test_the_pool_and_the_answers_follow_the_stated_distributions():
    lengths = lm._lognormal_quantiles(FULL["prompt_tokens"], 64)
    assert lengths.min() >= 128 and lengths.max() <= 4096
    assert np.median(lengths) == pytest.approx(1024, rel=0.03)
    # The cycle is a window's request count: every window offers each of
    # the answer distribution's quantiles once, as it offers the arrivals'.
    mix = json.loads((HERE / "traffic" / "poisson_dsv2lite.json").read_text())
    cycle = FULL["answer_tokens"]["cycle"]
    assert cycle == round(mix["rate_per_s"] * BENCH["run_seconds"])
    answers = [lm.answer_tokens(FULL, uid) for uid in range(cycle)]
    assert sorted(answers) == sorted(lm._lognormal_quantiles(FULL["answer_tokens"], cycle))
    assert 16 <= min(answers) and max(answers) <= 512
    assert np.median(answers) == pytest.approx(128, rel=0.05)
    assert answers == [lm.answer_tokens(FULL, uid + cycle) for uid in range(cycle)]
    assert max(lengths) + max(answers) <= FULL["max_len"]
    _, _, one = lm.setup(SMALL, 5, "cpu")
    _, _, two = lm.setup(SMALL, 6, "cpu")
    assert [len(p) for p in one] == [len(p) for p in two]
    assert any(not np.array_equal(a, b) for a, b in zip(one, two))


def test_the_window_starts_from_the_steady_load_and_returns_none_of_it():
    """``warm`` leaves the steady load's requests in flight; the System
    ticks for them, counts them as queued and returns only the window's."""
    weights, _, host = lm.setup(SMALL, SEED, "cpu")
    system = lm.System(SMALL, weights, host, "cpu")
    lm.warm(system, MIX, len(host))
    assert system._load and system.queued() == len(system._load)
    assert all(uid < -len(host) for uid in system._load)
    window = harness.open_loop(system, MIX, 0.5, SEED, len(host))
    assert system.queued() == 0
    assert sorted(r.uid for r in window.requests) == list(range(len(window.requests)))
    assert all(r.answer is not None and len(r.answer) == lm.answer_tokens(SMALL, r.uid)
               for r in window.requests)


def test_moved_answers_keep_their_lengths_and_are_not_correct():
    """The rolled control: every answer the length its request asked
    for, the tokens another request's; ``token_gap_max`` alone refuses
    it (no inf from the length check)."""
    answers = [np.arange(n * 4, dtype=np.float64).reshape(n, 4) for n in (3, 5, 2, 5)]
    moved = lm._moved(answers)
    assert [len(a) for a in moved] == [3, 5, 2, 5]
    assert np.array_equal(moved[2], answers[0][:2]) and np.array_equal(moved[0], answers[1][:3])
    assert np.array_equal(moved[1], answers[3]) and moved[3] is answers[3]
    out = control.readings(SMALL, MIX, LIMITS, SEED, 0.5, "cpu")
    rolled = out["answers_rolled"]
    assert math.isfinite(rolled["token_gap_max"]) and rolled["missing"] == 0
    assert rolled["token_gap_max"] > LIMITS["token_gap_max"]


def test_shapes_by_hand():
    c = SMALL
    d, v, h, lora = 64, 256, 4, 32
    attention = d * h * 24 + d * lora + d * 8 + lora * h * 32 + h * 16 * d
    assert lm_shapes.parts(c)["attention"] == 3 * attention
    expert = 3 * d * 32
    active = d * v + 3 * attention + 3 * d * 96 + 2 * (3 * d * 64 + d * 8 + 3 * expert)
    assert lm_shapes.active_matmul_parameters(c) == active
    assert lm_shapes.attention_flops_per_position(c) == 2 * h * (24 + 16) * 3
    assert lm_shapes.prefill_flops(c, 10) == 2 * active * 10 + 2 * h * 40 * 3 * 55
    assert lm_shapes.experts_selected(c, 1) == pytest.approx(3)
    assert lm_shapes.experts_selected(c, 1000) == pytest.approx(8)
    weights = 2 * (d * v + 3 * attention + 3 * d * 96 + 2 * 3 * d * 64) + 4 * (
        2 * d * 8 + 3 * (2 * d + lora) + d)
    want = weights + 2 * 2 * 3 * expert + 2 * 1 * d + 2 * 40 * 7 * 3
    assert lm_shapes.decode_bytes(c, 1, 7) == pytest.approx(want)


# -- the readers on a synthetic recorder --------------------------------------


def _ctx(monkeypatch, trace=None):
    """A recorder holding two ticks in a window from 1 s to 3 s: tick 1
    admits uid 5 (submitted at 1.0 s, a 2,000-token prompt, 40 ms on the
    card) and decodes 2 rows over 30 positions; tick 2 decodes the same
    rows over 32 positions, 20 ms on the card, and starts after the
    profiler's lead."""
    from repro_torch import spans

    rec = spans.Recorder()
    monkeypatch.setattr(spans, "RECORDER", rec)
    ms = 1_000_000
    rec.add("engine.submit", 1000 * ms, 1000 * ms, 5)
    s1 = rec.open(1100 * ms)
    rec.add("lm.pull", 1170 * ms, 1200 * ms, 1, s1)
    rec.add("lm.prefill", 1100 * ms, 1150 * ms, 5, s1, (("tokens", "device_ms", "slot"),
                                                           2000, 40.0, 0))
    rec.add("lm.decode", 1150 * ms, 1160 * ms, 1, s1, (("kv", "device_ms", "rows"),
                                                          30, 25.0, 0, 1))
    rec.add("lm.step", 1100 * ms, 1200 * ms, 1, seq=s1, attrs=(("prefills", "slots"), 1, 0, 1))
    s2 = rec.open(2500 * ms)
    rec.add("lm.pull", 2510 * ms, 2530 * ms, 2, s2)
    rec.add("lm.decode", 2500 * ms, 2505 * ms, 2, s2, (("kv", "device_ms", "rows"),
                                                          32, 20.0, 0, 1))
    rec.add("lm.step", 2500 * ms, 2530 * ms, 2, seq=s2, attrs=(("prefills", "slots"), 0, 0, 1))
    window = harness.Window(start=1.0, seconds=2.0, requests=[], ticks=[],
                            host_until=None if trace is None else 2.2)
    return types.SimpleNamespace(cfg=FULL, mix=MIX, window=window, setup_s=0.0, trace=trace)


def test_lm_readers_on_a_synthetic_recorder(monkeypatch):
    ctx = _ctx(monkeypatch)
    read = {m["name"]: harness.load_metric(m["name"]).read
            for m in harness.cell_metrics(BENCH, CELL, trace=True)}
    assert read["lm.ttft_ms_p95"](ctx) == pytest.approx(200.0)  # submit -> pull's end
    assert read["lm.prefill_ms_per_ktok_p50"](ctx) == pytest.approx(20.0)
    assert read["lm.decode_step_ms_p50"](ctx) == pytest.approx(30.0)  # tick 2 only
    moved = (lm_shapes.decode_bytes(FULL, 2, 30) + lm_shapes.decode_bytes(FULL, 2, 32))
    assert read["step.decode_hbm_share"](ctx) == pytest.approx(
        100 * moved / 0.045 / lm_shapes.PEAK_HBM_BYTES)
    assert read["step.lm_mfu"](ctx) is None and read["device.idle_share.lm"](ctx) is None
    traced = _ctx(monkeypatch, trace={"window_s": 0.5, "busy_s": 0.4, "ticks": [(64, 0)]})
    assert read["device.idle_share.lm"](traced) == pytest.approx(20.0)
    assert read["step.lm_mfu"](traced) == pytest.approx(
        100 * lm_shapes.decode_flops(FULL, 2, 32) / 0.5 / lm_shapes.PEAK_BF16_FLOPS)


def test_lm_readers_read_nothing_from_a_program_without_lm_spans(monkeypatch):
    from repro_torch import spans

    monkeypatch.setattr(spans, "RECORDER", spans.Recorder())
    ctx = types.SimpleNamespace(cfg=FULL, mix=MIX, setup_s=0.0,
                                window=harness.Window(start=1.0, seconds=2.0, requests=[],
                                                      ticks=[], host_until=2.2),
                                trace={"window_s": 0.5, "busy_s": 0.4, "ticks": [(64, 0)]})
    for m in harness.cell_metrics(BENCH, CELL, trace=True):
        value = harness.load_metric(m["name"]).read(ctx)
        assert value is None or m["name"] == "device.idle_share.lm", m["name"]
    assert math.isfinite(harness.load_metric("device.idle_share.lm").read(ctx))
