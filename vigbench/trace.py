"""The profiled slice: ``torch.profiler`` over a fixed run of ticks, its
Chrome trace written to a file, and the reduction of that trace to the
device's busy time, its kernels and its idle gaps.

Only CUDA activity is recorded (the device's operations and the host's
CUDA calls): recording every host operation slows an open loop's host
enough to grow its queue."""

from __future__ import annotations

import bisect
import json
import math
import time
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime",)
TOP = 10
SHORT_GAP_US = 10.0  # shorter gaps are summed, not labelled
MARKER = "cudaDeviceSynchronize"  # the slice's start (``Slice``)


class Slice:
    """Profiles ``count`` ticks from the first tick that starts once
    ``start_share`` of the window has passed. Call ``before(now,
    window_start, seconds)`` and ``after(bucket, live)`` around each tick.

    The profiler records nothing for a while after it starts, so the
    counted ticks begin ``LEAD_S`` later, at a device synchronisation
    that marks the start in the trace; ``t0`` is then (None before).
    Stopping the profiler blocks the host while it collects its events,
    so what a window's host clock measures is read from before the
    profiler started (``started``). The device is idle between ticks (a
    tick ends with its logits on the host), so the slice's wall time runs
    from the marker to the end of its last tick."""

    LEAD_S = 0.25

    def __init__(self, start_share: float, count: int, path: Path):
        self.start_share, self.count, self.path = float(start_share), int(count), path
        self.prof = None
        self.started = self.t0 = self.t1 = None
        self.ticks: list[tuple[int, int]] = []  # (bucket, live) per tick

    @property
    def done(self) -> bool:
        return self.t1 is not None

    def before(self, now: float, window_start: float, seconds: float) -> None:
        if self.prof is None and now >= window_start + self.start_share * seconds:
            import torch
            from torch.profiler import ProfilerActivity, profile

            # A host without a card (the tests) records its host calls.
            act = (ProfilerActivity.CUDA if torch.cuda.is_available()
                   else ProfilerActivity.CPU)
            self.prof = profile(activities=[act])
            self.prof.__enter__()
            self.started = time.perf_counter()
        elif (self.prof is not None and self.t0 is None
              and now >= self.started + self.LEAD_S):
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()  # the marker
            self.t0 = time.perf_counter()

    def after(self, bucket, live: int) -> None:
        if self.t0 is None or self.done:
            return
        self.ticks.append((bucket, live))
        if len(self.ticks) >= self.count:
            self.finish()

    def finish(self) -> None:
        """Stop the profiler, if it runs: after ``count`` ticks, or at the
        end of the loop with the ticks counted so far."""
        if self.prof is not None and not self.done:
            self.t1 = time.perf_counter()
            self.prof.__exit__(None, None, None)

    def reduce(self) -> dict | None:
        """The slice's numbers, or None when it counted no tick."""
        if not self.done or not self.ticks:
            return None
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        return reduce_events(events, self.t1 - self.t0, self.ticks)


def warm_profiler() -> None:
    """Start and stop the profiler once in set-up: its first start
    initialises CUPTI, which takes seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if torch.cuda.is_available():
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce_events(events: list, window_s: float, ticks: list) -> dict:
    """From the first ``MARKER`` on (all events without one): device busy
    seconds (the union of kernels, copies and sets), the
    kernels as (name, seconds) in order, the top device operations by
    total time, and the idle gaps between device activity summed by what
    the host was doing at each gap's middle: the CUDA call it was in, or
    else the host work before its next CUDA call (gaps under
    ``SHORT_GAP_US`` are summed under one label)."""
    device, host = [], []
    marks = [float(e["ts"]) for e in events
             if e.get("ph") == "X" and e.get("name") == MARKER]
    since = min(marks) if marks else -math.inf
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if span[0] < since:
            continue
        if cat in DEVICE_CATS:
            device.append((span, e.get("name", "?"), cat))
        elif cat in HOST_CATS:
            host.append((span, e.get("name", "?")))
    busy = _union([s for s, _, _ in device])
    per_op: dict[str, float] = defaultdict(float)
    for (a, b), name, _ in device:
        per_op[name] += (b - a) * 1e-6
    host.sort()
    starts = [a for (a, _), _ in host]
    gaps: dict[str, float] = defaultdict(float)
    for (_, end), (start, _) in zip(busy, busy[1:]):
        if start - end < SHORT_GAP_US:
            gaps[f"gaps under {SHORT_GAP_US:g} us"] += (start - end) * 1e-6
            continue
        gaps[_host_label(host, starts, 0.5 * (end + start))] += (start - end) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "window_s": window_s,
        "kernels": [(name, (b - a) * 1e-6) for (a, b), name, cat in
                    sorted(device) if cat == "kernel"],
        "device_ops": top(per_op),
        "idle_gaps": top(gaps),
        "ticks": list(ticks),
    }


def _host_label(host: list, starts: list, t: float) -> str:
    i = bisect.bisect_right(starts, t)
    for (a, b), name in host[max(0, i - 4):i]:
        if a <= t <= b:
            return name
    return f"host work before {host[i][1]}" if i < len(host) else "host work"
