"""Where the device's idle time goes, by the engine's own spans.

    python3 tools/idle_by_span.py --workload <cell> --seed <n> [--seconds 20]

Runs one cell of the benchmark traced, as ``vigbench/run.py --trace 1``
does (``vigbench.harness.run_cell``), on a card. Then it merges the
profiler's trace of the slice with the spans the program recorded
(``repro_torch.spans.RECORDER.chrome_events``, on the trace's clock) and
prints:

- the slice's idle time (the gaps between the device's kernels, copies
  and sets, from the slice's marker on) summed by the innermost span at
  each gap's middle: a phase of ``VigServeEngine.step``, ``engine.step``'s
  own time outside its phases, an ``engine.submit``, or "outside step()".
  The trace's device clock drifts from its host clock (on torch 2.11 and
  an H100, by up to 6.8 ms a second), so the device's ops are first moved
  onto the host calls' clock by the calls that launched them
  (``device_offsets``); the split before that move is printed too;
- each phase's median milliseconds on the window's ticks before the
  profiler started and on the ticks inside the slice (what profiling
  costs a tick), and ``engine.step``'s time outside its phases over its
  median;
- the run's result line, as ``vigbench/run.py`` prints it.

It writes the same, as JSON, and the profiler's trace to
``results/idle_by_span/``.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from statistics import median as _median  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "results" / "idle_by_span"
OUTSIDE = "outside step()"
OWN = "engine.step (own)"
BACK = 64  # spans searched back from a gap's middle for one that holds it
TOP = 16  # (span, CUDA call) pairs shown
WINDOW_US = 5_000.0  # host time per device-clock offset reading
STEP_US, DRIFT = 100.0, 0.02  # the most an offset reading moves from the last
SLACK_US = 20.0


def idle_by_span(events: list, marks: list, since_us: float,
                 by_call: bool = False) -> dict:
    """The device's idle gaps from ``since_us`` on (between the union of
    its ``vigbench.trace.DEVICE_CATS`` events), each summed in seconds
    under the innermost of ``marks`` (Chrome ``"X"`` span events on the
    same clock) that holds its middle; ``engine.step`` itself counts as
    ``OWN``, no span as ``OUTSIDE``. ``by_call`` keys each by the span
    and the host's CUDA call there, as ``vigbench.trace`` labels it."""
    from vigbench import trace as tracing

    busy, host = [], []
    for e in events:
        if e.get("ph") != "X" or float(e["ts"]) < since_us:
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if e.get("cat") in tracing.DEVICE_CATS:
            busy.append(span)
        elif e.get("cat") in tracing.HOST_CATS:
            host.append((span, e["name"]))
    busy = tracing._union(busy)
    host.sort()
    host_starts = [a for (a, _), _ in host]
    marks = sorted((m["ts"], m["ts"] + m["dur"], m["name"]) for m in marks)
    starts = [m[0] for m in marks]
    out: dict = defaultdict(float)
    for (_, end), (start, _) in zip(busy, busy[1:]):
        mid = 0.5 * (end + start)
        name = innermost(marks, starts, mid)
        if by_call:
            name = f"{name} | {tracing._host_label(host, host_starts, mid)}"
        out[name] += (start - end) * 1e-6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def device_offsets(events: list, window_us: float = WINDOW_US) -> list:
    """How far the trace's device clock runs from its host clock, as
    (host time, offset) in us, one reading per ``window_us`` of host
    time: the least (device start - host call start) over the window's
    copies to the device, at the call that gave it. A tick's first copy,
    its row index, is made in ``engine.select`` on a device idle since
    the last tick's pull, so the least gap in a window is the copy's
    latency (a few us) plus the clocks' offset. A reading further than ``STEP_US`` plus ``DRIFT`` of
    the time since from the last one kept is dropped: a clock does not
    jump."""
    calls = {e["args"]["correlation"]: float(e["ts"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
             and "correlation" in e.get("args", {})}
    least: dict[int, tuple] = {}
    for e in events:
        if (e.get("ph") != "X" or e.get("cat") != "gpu_memcpy"
                or "HtoD" not in e.get("name", "")):
            continue
        host = calls.get(e.get("args", {}).get("correlation"))
        if host is None:
            continue
        w = int(host // window_us)
        gap = float(e["ts"]) - host
        if w not in least or gap < least[w][1]:
            least[w] = (host, gap)
    kept: list = []
    for w in sorted(least):
        t, o = least[w]
        if kept and abs(o - kept[-1][1]) > STEP_US + DRIFT * (t - kept[-1][0]):
            continue
        kept.append((t, o))
    return kept


def host_aligned(events: list, offsets: list) -> list:
    """``events`` with each device op moved onto the host calls' clock:
    less the offset ``device_offsets`` found at its time (interpolated)."""
    import numpy as np

    if not offsets:
        return events
    at, off = np.array(offsets).T
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset"):
            t = float(e["ts"])
            h = t - np.interp(t, at, off)  # host time, then once more from it
            e = dict(e, ts=t - float(np.interp(h, at, off)))
        out.append(e)
    return out


def pull_leads(events: list, marks: list, since_us: float) -> list:
    """For each ``engine.pull`` span from ``since_us`` on, (its start, how
    long after it the first device-to-host copy call began), in us: the
    spans and the trace's host calls on one clock read small leads."""
    d2h = {e["args"].get("correlation") for e in events
           if e.get("ph") == "X" and e.get("cat") == "gpu_memcpy"
           and "DtoH" in e.get("name", "") and "args" in e}
    calls = sorted(float(e["ts"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
                   and e.get("args", {}).get("correlation") in d2h)
    out = []
    for m in marks:
        if m["name"] != "engine.pull" or m["ts"] < since_us:
            continue
        i = bisect.bisect_left(calls, m["ts"] - SLACK_US)
        if i < len(calls) and calls[i] <= m["ts"] + m["dur"] + SLACK_US:
            out.append((m["ts"], calls[i] - m["ts"]))
    return out


def innermost(marks: list, starts: list, t: float) -> str:
    """The name of the innermost of ``marks`` ((start, end, name), sorted,
    with their ``starts``) that holds ``t``; ``OWN`` for ``engine.step``
    itself, ``OUTSIDE`` for none."""
    i = bisect.bisect_right(starts, t)
    held = [m for m in marks[max(0, i - BACK):i] if m[1] >= t]
    name = min(held, key=lambda m: m[1] - m[0])[2] if held else OUTSIDE
    return OWN if name == "engine.step" else name


def calls_by_span(events: list, marks: list, since_us: float,
                  ticks: int) -> dict:
    """The host's CUDA calls from ``since_us`` on, per tick, by the
    innermost span at each call's start: ``"span | call"`` -> [calls,
    milliseconds]. A copy's call names its kind (``Memcpy HtoD (Pageable
    -> Device)``...), found by the copy's correlation id."""
    from vigbench import trace as tracing

    kind = {e["args"].get("correlation"): e["name"] for e in events
            if e.get("ph") == "X" and e.get("cat") in ("gpu_memcpy", "gpu_memset")
            and "args" in e}
    marks = sorted((m["ts"], m["ts"] + m["dur"], m["name"]) for m in marks)
    starts = [m[0] for m in marks]
    out: dict = defaultdict(lambda: [0.0, 0.0])
    for e in events:
        if (e.get("ph") != "X" or e.get("cat") not in tracing.HOST_CATS
                or float(e["ts"]) < since_us):
            continue
        name = e["name"]
        corr = e.get("args", {}).get("correlation")
        if corr in kind:
            name = f"{name} / {kind[corr]}"
        row = out[f"{innermost(marks, starts, float(e['ts']))} | {name}"]
        row[0] += 1.0 / ticks
        row[1] += float(e["dur"]) * 1e-3 / ticks
    return dict(sorted(out.items(), key=lambda kv: -kv[1][1]))


def phase_ms(held: list, since_ns: int, until_ns: int) -> dict:
    """Median milliseconds per tick, over the ``engine.step`` spans that
    started in ``[since_ns, until_ns)``: the step, its host time (less
    its ``spans.WAITS``), its own time and each phase; the gap between
    ticks; and the median ``engine.submit``."""
    from repro_torch import spans

    from vigbench.readers import percentile

    own = spans.self_ns(held)
    steps = {s.seq: s for s in held
             if s.name == "engine.step" and since_ns <= s.t0 < until_ns}
    per: dict[str, list] = defaultdict(list)
    per_tick: dict[int, dict] = {q: defaultdict(int) for q in steps}
    for s in held:
        if s.parent in per_tick:
            per_tick[s.parent][s.name] += s.t1 - s.t0
    for q, s in steps.items():
        per["engine.step"].append(s.t1 - s.t0)
        per[OWN].append(own[q])
        for name, ns in per_tick[q].items():
            per[name].append(ns)
    for t in spans.ticks(held, since_ns, until_ns):
        per["host (step less waits)"].append(t.t1 - t.t0 - t.wait_ns)
    ordered = sorted(steps.values(), key=lambda s: s.t0)
    per[OUTSIDE] = [b.t0 - a.t1 for a, b in zip(ordered, ordered[1:])]
    per["engine.submit"] = [s.t1 - s.t0 for s in held if s.name == "engine.submit"
                            and since_ns <= s.t0 < until_ns]
    out = {name: 1e-6 * percentile(v, 0.5) for name, v in per.items() if v}
    out["ticks"] = len(steps)
    return out


def run(workload: str, seed: int, seconds: float, device: str = "cuda",
        cfg=None, mix=None, limits=None) -> dict:
    """Run the cell traced and split its slice; ``cfg``, ``mix`` and
    ``limits`` replace the cell's files (a small rehearsal off the card)."""
    from repro_torch import spans

    from vigbench import harness
    from vigbench import trace as tracing

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell, conf = harness.find_cell(bench, workload)
    if device == "cuda":
        harness.require_cards(int(cell["chips"]))
    cfg = cfg or harness.load_json(ROOT / conf["file"])
    mix = mix or harness.load_json(harness.HERE / "traffic" / f"{cell['traffic']}.json")
    limits = limits or harness.load_json(harness.HERE / "limits" / f"{conf['name']}.json")
    slices, windows = [], []

    class Kept(tracing.Slice):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            slices.append(self)

    loop = harness.LOOPS[mix["loop"]]

    def kept_loop(*a, **k):
        windows.append(loop(*a, **k))
        return windows[-1]

    slice_cls = tracing.Slice
    tracing.Slice = Kept
    harness.LOOPS[mix["loop"]] = kept_loop
    try:
        path = OUT / f"{workload}.seed{seed}.trace.json"
        result = harness.run_cell(
            cfg=cfg, mix=mix, limits=limits,
            metrics=harness.cell_metrics(bench, workload, True), seed=seed,
            seconds=seconds, trace=True, device=device, t_process=T_PROCESS,
            trace_path=path)
    finally:
        tracing.Slice = slice_cls
        harness.LOOPS[mix["loop"]] = loop
    sl, w = slices[0], windows[0]
    if sl.t0 is None or not sl.ticks:
        raise RuntimeError(f"{workload}: the profiled slice counted no tick; "
                           "run a longer window")
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    marks = [float(e["ts"]) for e in events
             if e.get("ph") == "X" and e.get("name") == tracing.MARKER]
    since = min(marks) if marks else -float("inf")
    mine = spans.RECORDER.chrome_events(int(trace["baseTimeNanoseconds"]))
    offsets = device_offsets(events)  # from the profiler's start, near 0
    raw = idle_by_span(events, mine, since)
    events = host_aligned(events, offsets)
    offsets = [(t, o) for t, o in offsets if t >= since]
    gaps = idle_by_span(events, mine, since)
    calls = idle_by_span(events, mine, since, by_call=True)
    cuda_calls = calls_by_span(events, mine, since, len(sl.ticks))
    leads = [lead for _, lead in pull_leads(events, mine, since)]
    quarter = max(1, len(leads) // 4)
    idle = sum(gaps.values())
    held = spans.RECORDER.spans()
    ns = lambda s: int(s * 1e9)  # noqa: E731
    before = phase_ms(held, ns(w.start), ns(sl.started))
    inside = phase_ms(held, ns(sl.t0), ns(sl.t1))
    step = before.get("engine.step")
    return {
        "workload": workload, "seed": seed,
        "idle_s": idle, "slice_s": sl.t1 - sl.t0,
        "idle_by_span_s": gaps,
        "idle_by_span_unaligned_s": raw,
        "device_offset_us": {"first": offsets[0][1] if offsets else None,
                             "last": offsets[-1][1] if offsets else None,
                             "least": min((o for _, o in offsets), default=None),
                             "most": max((o for _, o in offsets), default=None),
                             "readings": len(offsets)},
        "pull_lead_us": {"pulls": len(leads),
                         "least": min(leads, default=None),
                         "median_first_quarter": median(leads[:quarter]),
                         "median_last_quarter": median(leads[-quarter:])},
        "idle_by_span_and_call_s": dict(list(calls.items())[:TOP]),
        "cuda_calls_per_tick_by_span": dict(list(cuda_calls.items())[:2 * TOP]),
        "named_share": (1.0 - gaps.get(OWN, 0.0) / idle) if idle else None,
        "phase_ms_before": before, "phase_ms_inside": inside,
        "own_over_step": before.get(OWN, 0.0) / step if step else None,
        "ring_wrapped": spans.RECORDER.wrapped,
        "result": result,
    }


def median(values: list):
    return _median(values) if values else None


def show(rep: dict) -> None:
    print(f"{rep['workload']} seed {rep['seed']}: idle {rep['idle_s']:.4f} s "
          f"of a {rep['slice_s']:.4f} s slice")
    print(f"  device clock - host clock: {rep['device_offset_us']} us; "
          f"first D2H call after engine.pull's start: {rep['pull_lead_us']} us")
    for key in ("idle_by_span_s", "idle_by_span_and_call_s",
                "idle_by_span_unaligned_s"):
        print(f"  {key}:")
        for name, s in rep[key].items():
            share = 100 * s / rep["idle_s"] if rep["idle_s"] else 0.0
            print(f"  idle {name:<28} {s:9.4f} s {share:6.1f}%")
    b, i = rep["phase_ms_before"], rep["phase_ms_inside"]
    print(f"  {'median ms per tick':<30} {'before':>9} {'inside':>9}"
          f"  (ticks {b.get('ticks')} / {i.get('ticks')})")
    for name in b:
        if name != "ticks":
            print(f"  {name:<30} {b[name]:9.4f} {i.get(name, float('nan')):9.4f}")
    print(f"  engine.step own / median step: {rep['own_over_step']}")
    print(f"  {'CUDA calls per tick in the slice':<60} {'calls':>7} {'ms':>8}")
    for name, (n, ms) in rep["cuda_calls_per_tick_by_span"].items():
        print(f"  {name:<60} {n:7.2f} {ms:8.4f}")


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    rep = run(args.workload, args.seed, args.seconds)
    OUT.mkdir(parents=True, exist_ok=True)
    with open(OUT / f"{args.workload}.seed{args.seed}.json", "w") as f:
        json.dump(rep, f, indent=1)
    show(rep)
    print(json.dumps(rep["result"]))
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    sys.exit(main(sys.argv[1:]))
