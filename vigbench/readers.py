"""Helpers that the metric readers in ``metrics/`` share."""

from __future__ import annotations

import math
import re
import sys

MATCHED = 0.98  # the least share of calls whose kernel the trace must hold


def percentile(values: list, q: float) -> float:
    """The nearest-rank ``q`` quantile (0 < q <= 1); inf counts as the
    largest value, so a failed request lies in the tail."""
    if not values:
        return math.nan
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def latencies_s(ctx) -> list:
    """Due time to logits on the host, for every request the window
    offered; a failed one never came (inf)."""
    return [math.inf if r.failed or r.done is None else r.done - r.due
            for r in ctx.window.requests]


def kernel_seconds(ctx, pattern: str) -> tuple[float, int]:
    """Device seconds and launches of the traced kernels whose name
    matches ``pattern``."""
    rx = re.compile(pattern)
    hits = [s for name, s in ctx.trace["kernels"] if rx.search(name)]
    return sum(hits), len(hits)


def roofline(ctx, pattern: str, calls, least_s) -> float | None:
    """The share (%) of its least time that the matched kernels took over
    the profiled ticks, each tick's calls from the frozen shape
    arithmetic at its bucket. The profiler drops a few kernel records in
    a slice (up to 1% seen), so when at least ``MATCHED`` of the calls
    have a kernel, their least time is the calls' scaled by that share;
    below it (or with none) the kernels cannot be attributed."""
    if ctx.trace is None:
        return None
    seconds, launches = kernel_seconds(ctx, pattern)
    expected = [c for bucket, _ in ctx.trace["ticks"]
                for c in calls(ctx.cfg, bucket)]
    if not expected or launches > len(expected) or launches < MATCHED * len(expected):
        print(f"vigbench: {launches} kernels match {pattern!r} against "
              f"{len(expected)} calls in the profiled ticks; not attributed",
              file=sys.stderr)
        return None
    least = sum(least_s(c) for c in expected) * launches / len(expected)
    return 100.0 * least / seconds
