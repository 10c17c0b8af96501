"""Straggler detection & step-time monitoring (the port's own copy of
``repro/distributed/straggler.py``, pure Python).

At thousand-node scale, a single slow host gates every synchronous
collective. The monitor keeps a rolling window of per-step wall times,
flags outliers (median + k*MAD), and exposes hooks the launcher uses to
(a) log offending hosts, (b) trigger elastic reconfiguration when a
host is persistently slow (drop it, reshard from checkpoint — see
ckpt.restore's elastic path)."""

from __future__ import annotations

import collections
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class StragglerConfig:
    window: int = 50
    mad_k: float = 5.0
    min_samples: int = 10
    persistent_threshold: int = 3  # consecutive flags before escalation


@dataclass
class StepTimer:
    """Context manager measuring one step."""

    monitor: "StragglerMonitor"
    _t0: float = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.monitor.record(time.perf_counter() - self._t0)
        return False


class StragglerMonitor:
    def __init__(self, cfg: StragglerConfig = StragglerConfig(),
                 host_id: int = 0,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.cfg = cfg
        self.host_id = host_id
        self.times: collections.deque = collections.deque(maxlen=cfg.window)
        self.flags = 0
        self.total_flags = 0
        self.on_straggler = on_straggler

    def step_timer(self) -> StepTimer:
        return StepTimer(self)

    def record(self, dt: float):
        self.times.append(dt)
        if self.is_straggler(dt):
            self.flags += 1
            self.total_flags += 1
            if self.on_straggler and self.flags >= self.cfg.persistent_threshold:
                self.on_straggler(self.host_id, dt)
        else:
            self.flags = 0

    def is_straggler(self, dt: float) -> bool:
        if len(self.times) < self.cfg.min_samples:
            return False
        med = statistics.median(self.times)
        mad = statistics.median(abs(t - med) for t in self.times) + 1e-9
        # relative floor: near-zero MAD (very stable steps) must not flag
        # sub-percent jitter
        return dt > med + max(self.cfg.mad_k * mad, 0.2 * med)

    def stats(self) -> dict:
        if not self.times:
            return {"median_s": 0.0, "p95_s": 0.0, "flags": self.total_flags}
        ts = sorted(self.times)
        return {
            "median_s": statistics.median(ts),
            "p95_s": ts[int(0.95 * (len(ts) - 1))],
            "flags": self.total_flags,
        }


def aggregate_host_times(step_times: dict[int, float],
                         cfg: StragglerConfig = StragglerConfig()) -> list[int]:
    """Cluster-level view: given {host_id: step_time} (collected via the
    coordination service), return host ids gating the step."""
    if len(step_times) < 2:
        return []
    vals = list(step_times.values())
    med = statistics.median(vals)
    mad = statistics.median(abs(v - med) for v in vals) + 1e-9
    thresh = med + max(cfg.mad_k * mad, 0.2 * med)
    return [h for h, v in step_times.items() if v > thresh]
