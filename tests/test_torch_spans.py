"""The span recorder (``repro_torch.spans``) and what records into it.

The recorder alone: nesting and self time, the ring's wrap and its flag,
set-up spans that outlive a wrap, the off switch, and the export onto a
profiler trace's clock (against stubbed anchors, and against this host's
``torch.profiler``). A guarded CPU tick of a tiny ViG: the span tree
``VigServeEngine.step`` records, its ids and attributes, the same logits
with the recorder on and off; the kernel build's span and the
``build_seconds`` read from it. The benchmark's span readers
(``vigbench/metrics``) against a synthetic recorder.
"""

import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans, testing  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import convert, vig  # noqa: E402
from repro_torch.serve.engine import VigRequest, VigServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

KW = dict(image_size=16, patch=4, embed_dims=(16,), depths=(2,),
          num_classes=3, k=3, digc_impl="cuda")
CHILDREN = ["engine.select", "engine.stage", "engine.screen", "engine.replay",
            "engine.scatter", "engine.pull", "engine.account"]


@pytest.fixture
def rec(monkeypatch):
    """A fresh process recorder for the test."""
    fresh = spans.Recorder()
    monkeypatch.setattr(spans, "RECORDER", fresh)
    return fresh


def _engine(seed=0, **kw):
    cfg = vig.VIG_VARIANTS["vig_ti_iso"].replace(**KW)
    params = convert.init_params(cfg, generator=torch.Generator().manual_seed(seed),
                                 device="cpu")
    return VigServeEngine(cfg, params, buckets=(1, 2, 4, 8), guards=True,
                          device="cpu", **kw)


def _serve(eng, ticks=2, lanes=8):
    imgs = testing.images(3, lanes, 16)
    out = []
    for tick in range(ticks):
        reqs = [VigRequest(uid=100 * tick + i, image=imgs[i]) for i in range(lanes)]
        for r in reqs:
            eng.submit(r)
        assert eng.step() == lanes
        out.append(np.stack([r.logits for r in reqs]))
    return out


# -- the recorder ----------------------------------------------------------


def test_nesting_and_self_time():
    r = spans.Recorder()
    step = r.open(100)
    a = r.add("engine.select", 100, 140, 1, step)
    scr = r.open(140)
    r.add("engine.screen.wait", 150, 170, 1, scr)
    r.add("engine.screen", 140, 180, 1, step, seq=scr)
    r.add("engine.step", 100, 200, 1, attrs=(("live", "uids"), 2, 7, 8), seq=step)
    held = r.spans()
    assert [s.seq for s in held] == [step, a, scr, scr + 1]
    by = {s.name: s for s in held}
    assert by["engine.step"].parent == -1
    assert by["engine.select"].parent == by["engine.screen"].parent == step
    assert by["engine.screen.wait"].parent == scr
    own = spans.self_ns(held)
    # The step: 100 ns less its children (40 + 40); the screen: 40 less
    # its wait (20).
    assert own[step] == 20 and own[scr] == 20 and own[a] == 40
    tick, = r.ticks(0, 1000)
    # The wait is found two levels down; the last attribute takes the rest.
    assert tick == (100, 200, 20, {"live": 2, "uids": [7, 8]})
    assert r.ticks(101, 1000) == []


def test_ring_wraps_and_sets_its_flag():
    r = spans.Recorder(capacity=4)
    for i in range(3):
        r.add("s", i, i + 1, i)
    assert not r.wrapped and [s.key for s in r.spans()] == [0, 1, 2]
    for i in range(3, 7):
        r.add("s", i, i + 1, i)
    assert r.wrapped
    assert [s.key for s in r.spans()] == [3, 4, 5, 6]


def test_setup_spans_survive_a_wrap():
    r = spans.Recorder(capacity=2, keep=1)
    r.add("kernels.build", 0, 10, keep=True)
    r.add("engine.capture", 10, 20, 1, keep=True)  # past keep: into the ring
    for i in range(5):
        r.add("engine.step", 20 + i, 21 + i, i)
    names = [s.name for s in r.spans()]
    assert names == ["kernels.build", "engine.step", "engine.step"]


def test_the_off_switch_records_nothing(rec):
    rec.enabled = False
    eng = _engine()
    _serve(eng)
    assert rec.spans() == [] and rec.counters == {}


def test_ts_lands_on_the_profiler_clock_through_the_anchors():
    r = spans.Recorder()
    r._anchors = [(1_000, 5_000_000), (2_000_000_000, 7_000_001_000)]
    r.add("early", 500, 1_500)  # before the first anchor: mapped through it
    r.add("late", 2_000_000_500, 2_000_001_500)
    ev = r.chrome_events(4_000_000)
    assert [e["ts"] for e in ev] == [pytest.approx(999.5),
                                     pytest.approx(7_000_001_500e-3 - 4_000e0)]
    assert [e["dur"] for e in ev] == [1.0, 1.0]
    assert ev[0]["ph"] == "X" and ev[0]["pid"] == os.getpid()
    assert ev[0]["args"] == {"id": -1, "seq": 0, "parent": -1}


def test_the_anchor_is_retaken_once_a_second():
    r = spans.Recorder()
    first = r._anchor_perf
    r.open(first + spans.ANCHOR_NS // 2)
    assert len(r._anchors) == 1
    r.open(first + spans.ANCHOR_NS)
    assert len(r._anchors) == 2


def test_exported_spans_contain_the_profiled_ops_on_this_host(rec):
    """On this host's profiler (CPU activity): an op run inside a span
    lies inside the span once both are on the trace's clock."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(20):
            t0 = spans.now()
            torch.add(x, i)
            rec.lap("probe", t0, i)
            time.sleep(1e-4)
    trace = json.loads(_export(prof))
    adds = sorted(e["ts"] for e in trace["traceEvents"]
                  if e.get("name") == "aten::add" and e.get("ph") == "X")
    mine = rec.chrome_events(int(trace["baseTimeNanoseconds"]))
    assert len(adds) == len(mine) == 20
    for ts, span in zip(adds, mine):
        assert span["ts"] - 20 <= ts <= span["ts"] + span["dur"] + 20


def _export(prof) -> str:
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(out))
        return out.read_text()


# -- the engine ------------------------------------------------------------


def test_a_guarded_cpu_tick_records_the_span_tree(rec):
    eng = _engine()
    t_before = spans.now()
    _serve(eng, ticks=2, lanes=8)
    held = [s for s in rec.spans() if s.t0 >= t_before]
    steps = [s for s in held if s.name == "engine.step"]
    assert [s.key for s in steps] == [1, 2]
    for step, phase in zip(steps, ("engine.capture", "engine.replay")):
        kids = sorted((s for s in held if s.parent == step.seq), key=lambda s: s.t0)
        want = [phase if n == "engine.replay" else n for n in CHILDREN]
        assert [k.name for k in kids] == want
        assert all(k.key == step.key for k in kids)
        # The phases tile the tick: each starts where the last ended.
        assert kids[0].t0 == step.t0 and kids[-1].t1 == step.t1
        assert all(a.t1 == b.t0 for a, b in zip(kids, kids[1:]))
        # No card: the screen waits on no event, nothing syncs.
        assert not [s for s in held if s.parent in {k.seq for k in kids}]
        assert spans.attr_dict(step.attrs) == {
            "bucket": 8, "live": 8, "syncs": 0,
            "uids": [100 * (step.key - 1) + i for i in range(8)]}
    assert spans.self_ns(held)[steps[1].seq] == 0
    submits = [s for s in held if s.name == "engine.submit"]
    assert [s.key for s in submits] == list(range(8)) + list(range(100, 108))
    assert all(s.parent == -1 for s in submits)
    assert rec.counters == {}
    # The capture is a set-up span: kept, however the ring wraps.
    for _ in range(rec.capacity):
        rec.add("engine.submit", 0, 1)
    assert [s.name for s in rec.spans() if s.name != "engine.submit"] == [
        "engine.capture"]


def test_the_cyclic_gc_stops_tracking_the_spans(rec):
    """A tick's spans hold no container: one pass of the young
    generation untracks each tick's attributes, so none is promoted to
    the oldest generation, whose full collections pause the process."""
    import gc

    eng = _engine()
    gc.disable()  # every record stays young until the pass below
    try:
        _serve(eng, ticks=3, lanes=4)
        gc.collect(0)
    finally:
        gc.enable()
    held = [a for a in rec._attrs if a is not None]
    assert len(held) == 3 and not [a for a in held if gc.is_tracked(a)]


def test_logits_are_bit_equal_with_the_recorder_on_and_off(rec):
    on = _serve(_engine(seed=5), ticks=3, lanes=4)
    rec.enabled = False
    off = _serve(_engine(seed=5), ticks=3, lanes=4)
    for a, b in zip(on, off):
        assert np.array_equal(a, b)
        assert a.tobytes() == b.tobytes()


def test_the_build_span_gives_build_seconds(rec, monkeypatch, tmp_path):
    """The kernel build with nvcc, the link and the loader stubbed: one
    kept ``kernels.build`` span, and ``build_seconds`` is its length."""

    def link(cmd, **_):
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        time.sleep(0.01)
        return subprocess.CompletedProcess(cmd, 0, "", "")

    class Lib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build, "_compile", lambda nvcc, csrc, tmp: ([], {}))
    monkeypatch.setattr(_build.subprocess, "run", link)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Lib())
    lib = _build.build.__wrapped__(_build.CSRC, tmp_path)
    span, = rec.spans()
    assert span.name == "kernels.build" and span.parent == -1
    assert lib.build_seconds == (span.t1 - span.t0) / 1e9 >= 0.01
    for _ in range(rec.capacity + 1):
        rec.add("engine.submit", 0, 1)
    assert rec.spans()[0] == span  # kept past a wrap


# -- the benchmark's span readers -----------------------------------------


def _window(start_s, seconds, host_until=None):
    from vigbench import harness

    return harness.Window(start=start_s, seconds=seconds, requests=[], ticks=[],
                          host_until=host_until)


def _tick(r, t0, ms, wait_ms, pull_ms, syncs, key):
    """One synthetic tick from ``t0`` (ns): ``ms`` long, its screen
    waiting ``wait_ms`` and its pull ``pull_ms``."""
    ns = lambda v: int(v * 1e6)  # noqa: E731
    step = r.open(t0)
    scr = r.open(t0)
    r.add("engine.screen.wait", t0 + ns(0.1), t0 + ns(0.1 + wait_ms), key, scr)
    r.add("engine.screen", t0, t0 + ns(0.2 + wait_ms), key, step, seq=scr)
    end = t0 + ns(ms)
    r.add("engine.pull", end - ns(pull_ms + 0.1), end - ns(0.1), key, step)
    r.add("engine.step", t0, end, key, seq=step, attrs=(("syncs", "uids"), syncs))
    return end


@pytest.fixture
def synthetic(rec):
    """Ticks of 4 ms every 5 ms from 1 s, waits 0.5 + 1.0 ms, 2 syncs; a
    tick before the window (at 0.9 s) and after the slice's start (2 s)
    carry other numbers; two kernel builds of 1.5 and 2.5 s."""
    _tick(rec, int(0.9e9), 50.0, 1.0, 1.0, 9, 0)
    for i in range(100):  # 1.000 .. 1.495 s
        _tick(rec, int(1e9) + i * 5_000_000, 4.0, 0.5, 1.0 + (i % 2) * 0.2, 2, i + 1)
    _tick(rec, int(2.0e9), 90.0, 1.0, 1.0, 7, 101)
    rec.add("kernels.build", 0, int(1.5e9), keep=True)
    rec.add("kernels.build", 0, int(2.5e9), keep=True)
    return _window(1.0, 2.0, host_until=2.0)


def _read(name, window):
    from vigbench import harness

    return harness.load_metric(name).read(types.SimpleNamespace(window=window))


@pytest.mark.parametrize("name", ["engine.host_ms_p50.backlog",
                                  "engine.host_ms_p50.poisson"])
def test_host_ms_reads_the_step_less_its_waits(synthetic, name):
    # 4 ms less 0.5 (screen wait) less 1.0 or 1.2 (pull): the nearest-rank
    # median of 50 ticks at 2.5 and 50 at 2.3 is 2.3.
    assert _read(name, synthetic) == pytest.approx(2.3)


def test_between_ticks_reads_the_gaps(synthetic):
    # 99 gaps of 1 ms and the first window tick's 50 ms one, back to the
    # tick before the window.
    assert _read("engine.between_ticks_ms_p50", synthetic) == pytest.approx(1.0)


def test_between_ticks_reads_the_gap_before_a_lone_tick(rec):
    _tick(rec, int(0.9e9), 50.0, 1.0, 1.0, 2, 0)
    _tick(rec, int(1.0e9), 4.0, 1.0, 1.0, 2, 1)
    _tick(rec, int(2.1e9), 4.0, 1.0, 1.0, 2, 2)  # after the slice's start
    window = _window(1.0, 2.0, host_until=2.0)
    assert _read("engine.between_ticks_ms_p50", window) == pytest.approx(50.0)


def test_syncs_per_tick_reads_the_window_s_ticks(synthetic):
    assert _read("engine.syncs_per_tick", synthetic) == 2.0


def test_kernel_build_reads_the_build_spans(synthetic, monkeypatch):
    assert _read("setup.kernel_build_s", synthetic) == pytest.approx(4.0)
    monkeypatch.setattr(spans, "RECORDER", spans.Recorder())
    assert _read("setup.kernel_build_s", synthetic) == 0.0


def test_the_readers_read_the_window_or_the_whole_run(synthetic):
    """Without a slice the window's end bounds the ticks: the one at 2 s
    (90 ms long, 7 syncs) then counts."""
    whole = _window(1.0, 1.5)
    assert _read("engine.syncs_per_tick", whole) == pytest.approx((200 + 7) / 101)


SPAN_READERS = ["engine.host_ms_p50.backlog", "engine.host_ms_p50.poisson",
                "engine.between_ticks_ms_p50", "engine.syncs_per_tick",
                "setup.kernel_build_s"]


@pytest.mark.parametrize("name", SPAN_READERS)
def test_a_program_without_spans_reads_nothing(monkeypatch, synthetic, name):
    import repro_torch

    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    monkeypatch.delattr(repro_torch, "spans", raising=False)
    assert _read(name, synthetic) is None


@pytest.mark.parametrize("name", SPAN_READERS)
def test_a_recorder_turned_off_reads_nothing(rec, name):
    rec.enabled = False
    assert _read(name, _window(0.0, 1e9)) is None


# -- tools/idle_by_span.py ---------------------------------------------------


def _tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "idle_by_span", ROOT / "tools" / "idle_by_span.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_idle_gaps_go_to_the_innermost_span_at_their_middle():
    tool = _tool()

    def ev(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    device = [ev("k", "kernel", 0, 10), ev("k", "kernel", 100, 10),  # before
              ev("k", "kernel", 1000, 10), ev("m", "gpu_memcpy", 1050, 10),
              ev("k", "kernel", 1200, 100), ev("k", "kernel", 1500, 10)]
    marks = [ev("engine.step", "repro_torch", 990, 400),
             ev("engine.replay", "repro_torch", 990, 60),
             ev("engine.pull", "repro_torch", 1050, 300),
             ev("engine.submit", "repro_torch", 1450, 20)]
    out = tool.idle_by_span(device, marks, since_us=500)
    # 1010-1050 (middle 1030: replay), 1060-1200 (1130: pull),
    # 1300-1500 (1400: after the step, before the submit).
    assert out == {tool.OUTSIDE: pytest.approx(200e-6),
                   "engine.pull": pytest.approx(140e-6),
                   "engine.replay": pytest.approx(40e-6)}


def test_phase_ms_splits_each_tick(rec):
    tool = _tool()
    for i in range(3):
        _tick(rec, 1_000_000_000 + i * 10_000_000, 8.0, 1.0, 2.0, 2, i)
    out = tool.phase_ms(rec.spans(), 0, 2_000_000_000)
    assert out["ticks"] == 3
    assert out["engine.step"] == pytest.approx(8.0)
    assert out["engine.pull"] == pytest.approx(2.0)
    assert out["host (step less waits)"] == pytest.approx(5.0)
    assert out[tool.OUTSIDE] == pytest.approx(2.0)


def test_idle_gaps_by_span_and_cuda_call():
    tool = _tool()

    def ev(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    events = [ev("k", "kernel", 1000, 10), ev("k", "kernel", 1100, 10),
              ev("cudaGraphLaunch", "cuda_runtime", 1040, 40)]
    marks = [ev("engine.replay", "repro_torch", 1000, 200)]
    out = tool.idle_by_span(events, marks, since_us=0, by_call=True)
    assert out == {"engine.replay | cudaGraphLaunch": pytest.approx(90e-6)}


def test_cuda_calls_are_counted_per_tick_by_span():
    tool = _tool()

    def ev(name, cat, ts, dur, corr=None):
        out = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
        if corr is not None:
            out["args"] = {"correlation": corr}
        return out

    events = [ev("cudaMemcpyAsync", "cuda_runtime", 1010, 50, 7),
              ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1020, 5, 7),
              ev("cudaMemcpyAsync", "cuda_runtime", 2010, 30, 9),
              ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 2020, 5, 9),
              ev("cudaGraphLaunch", "cuda_runtime", 3000, 100, 11)]
    marks = [ev("engine.scatter", "repro_torch", 1000, 100),
             ev("engine.scatter", "repro_torch", 2000, 100)]
    out = tool.calls_by_span(events, marks, since_us=0, ticks=2)
    copy = "engine.scatter | cudaMemcpyAsync / Memcpy HtoD (Pageable -> Device)"
    assert out == {f"{tool.OUTSIDE} | cudaGraphLaunch": [0.5, pytest.approx(0.05)],
                   copy: [1.0, pytest.approx(0.04)]}


def test_device_ops_are_moved_onto_the_host_calls_clock():
    """A device clock that runs 1% fast: each window's least gap from a
    pageable copy's call to the copy gives its offset (a reading that
    jumps is dropped), and the ops move back onto the host clock."""
    tool = _tool()
    events = []
    for i in range(60):  # one copy every ms, launched 5 us before it ran
        host = 1000.0 * i
        drift = 0.01 * host
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
                       "ts": host, "dur": 3.0, "args": {"correlation": i}})
        events.append({"ph": "X", "cat": "gpu_memcpy",
                       "name": "Memcpy HtoD (Pageable -> Device)",
                       "ts": host + 5.0 - drift - (5e5 if i == 35 else 0.0),
                       "dur": 1.0, "args": {"correlation": i}})
    offsets = tool.device_offsets(events, window_us=10_000.0)
    assert offsets[0] == (9_000.0, pytest.approx(5.0 - 90.0))
    assert offsets[-1] == (59_000.0, pytest.approx(5.0 - 590.0))
    assert len(offsets) == 5  # the reading at 35 ms jumped half a second
    moved = tool.host_aligned(events, offsets)
    # Between the first and the last reading, within a launch's latency.
    late = [e["ts"] - h["ts"] for h, e in zip(moved[::2], moved[1::2])
            if offsets[0][0] <= h["ts"] <= offsets[-1][0]]
    assert len(late) == 51
    assert sorted(abs(x) for x in late)[-2] < 6.0  # all but the jumped one
    assert moved[0] is events[0]  # host calls stay


def test_pull_leads_read_the_copy_calls_inside_each_pull():
    tool = _tool()
    events = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
               "ts": 1003.0, "dur": 9.0, "args": {"correlation": 1}},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)",
               "ts": 1005.0, "dur": 2.0, "args": {"correlation": 1}}]
    marks = [{"name": "engine.pull", "ts": 1000.0, "dur": 50.0},
             {"name": "engine.pull", "ts": 5000.0, "dur": 50.0}]  # no copy
    assert tool.pull_leads(events, marks, since_us=0) == [(1000.0, 3.0)]


def test_device_offsets_read_copies_from_pinned_memory():
    """The engine's row index is copied from pinned memory: such copies
    give the clocks' offset too, and copies to the host give none."""
    tool = _tool()
    events = []
    for i in range(20):  # one tick a ms: its index, then a logits pull
        host = 1000.0 * i
        for j, (name, late) in enumerate((
                ("Memcpy HtoD (Pinned -> Device)", 4.0),
                ("Memcpy DtoH (Device -> Pageable)", -400.0))):
            c = 2 * i + j
            events.append({"ph": "X", "cat": "cuda_runtime",
                           "name": "cudaMemcpyAsync", "ts": host + 500 * j,
                           "dur": 3.0, "args": {"correlation": c}})
            events.append({"ph": "X", "cat": "gpu_memcpy", "name": name,
                           "ts": host + 500 * j + late - 30.0, "dur": 1.0,
                           "args": {"correlation": c}})
    offsets = tool.device_offsets(events, window_us=5_000.0)
    assert offsets == [(5_000.0 * w, pytest.approx(-26.0))
                       for w in range(4)]
