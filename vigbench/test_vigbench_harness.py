"""The harness: what it finds by name, what it refuses, its runs on the
CPU at a small size, and the faults that its comparison must catch."""

import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from vigbench import harness
from vigbench.families import vig as family

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_name_is_found_and_every_file_agrees():
    cells = {w["name"] for w in BENCH["workloads"]}
    for conf in BENCH["configs"]:
        cfg = json.loads((ROOT / conf["file"]).read_text())
        assert cfg["name"] == conf["name"]
        assert (HERE / "limits" / f"{conf['name']}.json").is_file()
        assert harness.load_family(cfg["family"]).System
    for cell in BENCH["workloads"]:
        mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
        assert mix["loop"] in harness.LOOPS
        e2e = harness.cell_metrics(BENCH, cell["name"], trace=False)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert harness.cell_metrics(BENCH, cell["name"], trace=True)
    for m in BENCH["per_layer"]:
        mod = harness.load_metric(m["name"])
        assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
        assert set(m["workloads"]) <= cells
        moved = {e["name"]: e for e in BENCH["end_to_end"]}[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for m in BENCH["end_to_end"]:
        assert callable(harness.load_metric(m["name"]).read)


def test_the_file_keeps_the_contracts_limits():
    named = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"])
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(entry["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_no_card_means_no_result(capsys):
    with pytest.raises(harness.NoCard):
        harness.require_cards(1)
    rc = harness.main(["--workload", BENCH["workloads"][0]["name"], "--seed",
                       "1", "--seconds", "1", "--trace", "0"], time.perf_counter())
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA card" in out.err


def test_the_benchmark_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, vigbench.harness as h, vigbench.reference.vig_plain, "
        "vigbench.families.vig, vigbench.control, vigbench.sweep, vigbench.trace\n"
        "import repro_torch.serve.engine, repro_torch.models.vig\n"
        "[h.load_metric(p.stem) for p in h.HERE.joinpath('metrics').glob('*.py')]\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))")
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in loaded


def test_without_the_program_a_run_fails_and_prints_nothing(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "vigbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.')\n"
            "from vigbench import harness\n"
            "cfg = harness.load_json(harness.HERE / 'configs' / 'vig_ti_iso.json')\n"
            "cfg.update(image_size=32, patch=8, embed_dims=[8], depths=[2], pool_images=4)\n"
            "mix = harness.load_json(harness.HERE / 'traffic' / 'backlog.json')\n"
            "lim = harness.load_json(harness.HERE / 'limits' / 'vig_ti_iso.json')\n"
            "print(harness.run_cell(cfg=cfg, mix=mix, limits=lim, metrics=[], seed=1,"
            " seconds=0.2, trace=False, device='cpu', t_process=time.perf_counter()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "repro_torch" in out.stderr


# -- runs on the CPU at a small size ---------------------------------------


def small_cell(name, traffic):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    if cfg["variant"] == "isotropic":
        cfg.update(image_size=64, patch=8, embed_dims=[24], depths=[3], num_classes=10)
    else:
        cfg.update(image_size=64, embed_dims=[8, 16, 24, 32], depths=[1, 1, 1, 1],
                   num_classes=10)
    cfg.update(pool_images=8, reference_block=8)
    mix = json.loads((HERE / "traffic" / f"{traffic}.json").read_text())
    mix.update(trace_ticks=4)
    if mix["loop"] == "open":
        mix["rate_per_s"] = 150
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    # At this width no image lies near a neighbour-set tie (every sound
    # gap is at rounding), so every lane is held however few its answers.
    limits["lane_min_answers"] = 1
    return cfg, mix, limits


def run_small(name, traffic, workload, trace=False, seed=2**31 + 7):
    cfg, mix, limits = small_cell(name, traffic)
    return harness.run_cell(
        cfg=cfg, mix=mix, limits=limits,
        metrics=harness.cell_metrics(BENCH, workload, trace), seed=seed,
        seconds=0.5, trace=trace, device="cpu", t_process=time.perf_counter())


@pytest.mark.parametrize("name,traffic,workload", [
    ("vig_ti_pyr", "backlog", "pyr224-backlog"),
    ("vig_ti_iso", "poisson_iso224", "iso224-poisson")])
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(name, traffic, workload, trace):
    result = run_small(name, traffic, workload, trace)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] > 0
    assert list(result)[-1] == "checks"
    names = {m["name"] for m in harness.cell_metrics(BENCH, workload, trace)}
    # A CPU run has no device trace: those readers find nothing to read.
    device_only = {m["name"] for m in BENCH["per_layer"] if m["source"] == "device_trace"}
    assert set(result["metrics"]) == names - device_only
    if not trace:
        assert result["metrics"]["setup_s"]["value"] > 0


def _roll_within_tick(done):
    """Each request gets the next request's logits (one answer of a
    one-request tick is negated)."""
    logits = [l for _, l, _ in done]
    if len(logits) == 1:
        return [(done[0][0], -logits[0], done[0][2])]
    return [(uid, logits[(i + 1) % len(done)], lane)
            for i, (uid, _, lane) in enumerate(done)]


def _half_left_out(done):
    keep = (len(done) + 1) // 2
    return done[:keep] + [(uid, None, None) for uid, _, _ in done[keep:]]


class _Stale:
    """Every tick returns the previous tick's answers: a replay that
    never ran, its outputs left as they were."""

    def __init__(self):
        self.last = None

    def __call__(self, done):
        prev, self.last = self.last, [l for _, l, _ in done]
        if prev is None:
            return done
        return [(uid, prev[i % len(prev)], lane) for i, (uid, _, lane) in enumerate(done)]


@pytest.mark.parametrize("fault", ["answers_altered", "half_the_batch_left_out",
                                   "outputs_left_unchanged", "upper_lanes_other",
                                   "upper_lanes_zero"])
@pytest.mark.parametrize("name,traffic,workload", [
    ("vig_ti_pyr", "backlog", "pyr224-backlog"),
    ("vig_ti_iso", "poisson_iso224", "iso224-poisson")])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, name, traffic, workload):
    from vigbench import control

    broken = {"answers_altered": _roll_within_tick,
              "half_the_batch_left_out": _half_left_out,
              "outputs_left_unchanged": _Stale(),
              "upper_lanes_other": lambda d: control.break_upper_lanes(d, "other"),
              "upper_lanes_zero": lambda d: control.break_upper_lanes(d, "zero")}[fault]
    step = family.System.step
    monkeypatch.setattr(family.System, "step", lambda self: broken(step(self)))
    result = run_small(name, traffic, workload)
    assert result["correct"] is False


def test_compare_counts_missing_answers_and_holds_the_quartile():
    reqs = [harness.Request(uid=i, item=i % 2, due=0.0, answer=np.ones(3) * (1 + i % 2),
                            lane=(1, 0)) for i in range(4)]
    reqs[3].failed, reqs[3].answer = True, None
    ref = np.array([[1.0, 1.0, 1.0], [2.0, 2.0, 2.0]])
    w = harness.Window(start=0.0, seconds=1.0, requests=reqs, ticks=[])
    limits = {"missing": 0, "gap_q25_worst_lane": 1e-3, "lane_min_answers": 2}
    out = family.compare(w, ref, limits)
    assert out["missing"] == {"value": 1.0, "limit": 0.0}
    assert out["gap_q25_worst_lane"]["value"] == 0.0


def test_compare_holds_each_lane_and_pools_the_small_ones():
    """A lane wrong on every answer shows though the other lanes are
    sound; lanes under ``lane_min_answers`` answers are held together."""
    ref = np.ones((1, 4))
    w = harness.Window(start=0.0, seconds=1.0, ticks=[], requests=[
        harness.Request(uid=i, item=0, due=0.0, lane=(8, i % 8),
                        answer=np.zeros(4) if i % 8 == 7 else np.ones(4))
        for i in range(80)])
    limits = {"missing": 0, "gap_q25_worst_lane": 1e-3, "lane_min_answers": 10}
    assert family.compare(w, ref, limits)["gap_q25_worst_lane"]["value"] == 1.0
    by_lane, _ = family.answer_gaps(w, ref)
    assert family.lane_quartiles(by_lane, 11) == {"other lanes": 0.0}


def test_trace_reduction_counts_from_the_marker():
    from vigbench import trace

    def ev(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    events = [
        ev("digc_topk_kernel<x>", "kernel", 0.0, 50.0),  # before the marker
        ev(trace.MARKER, "cuda_runtime", 100.0, 5.0),
        ev("cudaGraphLaunch", "cuda_runtime", 110.0, 20.0),
        ev("digc_topk_kernel<x>", "kernel", 120.0, 30.0),
        ev("Memcpy HtoD", "gpu_memcpy", 140.0, 20.0),   # overlaps: union
        ev("cudaMemcpyAsync", "cuda_runtime", 200.0, 5.0),
        ev("mrconv_kernel<float>", "kernel", 210.0, 40.0),
    ]
    out = trace.reduce_events(events, 0.001, [(8, 8)])
    assert out["busy_s"] == pytest.approx((160 - 120 + 40) * 1e-6)
    assert [n for n, _ in out["kernels"]] == ["digc_topk_kernel<x>", "mrconv_kernel<float>"]
    # the 50 us gap from 160 to 210 is host work before the next CUDA call
    assert out["idle_gaps"] == [["host work before cudaMemcpyAsync", pytest.approx(50e-6)]]


def test_roofline_scales_by_the_matched_share_and_refuses_fewer():
    from types import SimpleNamespace

    from vigbench import readers, shapes

    cfg = json.loads((HERE / "configs" / "vig_ti_iso.json").read_text())
    calls = shapes.digc_calls(cfg, 8)
    least = sum(shapes.digc_least_s(c) for c in calls) * 10
    kernels = [("digc_topk_kernel<false>", 1e-4)] * (12 * 10)
    ctx = SimpleNamespace(cfg=cfg, trace={"ticks": [(8, 8)] * 10, "kernels": kernels})
    full = readers.roofline(ctx, r"digc_topk_kernel", shapes.digc_calls, shapes.digc_least_s)
    assert full == pytest.approx(100 * least / 0.012)
    ctx.trace["kernels"] = kernels[:-2]  # 118 of 120: scaled
    part = readers.roofline(ctx, r"digc_topk_kernel", shapes.digc_calls, shapes.digc_least_s)
    assert part == pytest.approx(100 * least * 118 / 120 / (118e-4))
    ctx.trace["kernels"] = kernels[:-12]  # 108 of 120: not attributed
    assert readers.roofline(ctx, r"digc_topk_kernel", shapes.digc_calls,
                            shapes.digc_least_s) is None
