"""Serving-scheduler support (port of ``repro/serve/sched.py``; DESIGN.md
§14): the deterministic clock and the arrival-trace tooling behind the
engine's SLO-bounded admission queue. Plain Python and numpy; the port
keeps its own copy.

``VirtualClock`` replaces wall time in ``VigServeEngine`` (``clock=``):
time moves only when the caller advances it, so a replayed trace
dispatches the same way run after run and deadlines are exact
comparisons, not races.

``arrival_trace`` draws the seeded Poisson + bursty request stream: a
memoryless trickle of singletons with synchronized flash crowds on top,
the shape where exact-size programs spend their time on per-tick overhead
and bucketed programs on padding. For a seed it returns the same list as
the JAX package's generator.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


class VirtualClock:
    """Manually-advanced monotonic clock for deterministic scheduling.

    Duck-compatible with both call styles the engine accepts: it is a
    plain ``clock()`` callable and it exposes ``now()``; ``run()``'s
    deferral path additionally uses ``advance_to`` to jump straight to
    the next admission deadline instead of sleeping."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def __call__(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance a monotonic clock by {dt}")
        self._t += float(dt)
        return self._t

    def advance_to(self, t: float) -> float:
        # monotonic: advancing to the past is a no-op, never a rewind
        self._t = max(self._t, float(t))
        return self._t


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request of a generated trace (times in ms since start)."""

    t_ms: float
    tenant: str
    tclass: str = "default"      # tenant class: the slo_ms dict key
    size: Optional[int] = None   # image size; None = engine native


def arrival_trace(
    *,
    seed: int = 0,
    tenants: int = 8,
    poisson_ms: float = 40.0,
    poisson_n: int = 48,
    burst_every_ms: float = 400.0,
    burst_n: int = 3,
    burst_size: int = 6,
    classes: Sequence[str] = ("default",),
    sizes: Optional[Sequence[int]] = None,
) -> list[Arrival]:
    """Seeded Poisson + bursty arrival stream: ``poisson_n`` memoryless
    arrivals (exponential gaps, mean ``poisson_ms``) with ``burst_n``
    synchronized flash crowds layered on top — ``burst_size``
    back-to-back arrivals every ``burst_every_ms``. Tenants cycle round-robin over ``tenants``
    identities; classes and sizes cycle over their sequences.
    Deterministic for a fixed seed; the returned list is time-sorted.
    """
    rng = np.random.default_rng(seed)
    out: list[Arrival] = []
    t = 0.0
    for i in range(poisson_n):
        t += float(rng.exponential(poisson_ms))
        out.append(Arrival(
            t_ms=t,
            tenant=f"t{i % tenants}",
            tclass=classes[i % len(classes)],
            size=None if sizes is None else int(sizes[i % len(sizes)]),
        ))
    for b in range(burst_n):
        t0 = (b + 1) * burst_every_ms
        for j in range(burst_size):
            i = poisson_n + b * burst_size + j
            out.append(Arrival(
                t_ms=t0 + j * 1e-2,  # back-to-back, order preserved
                tenant=f"t{i % tenants}",
                tclass=classes[i % len(classes)],
                size=None if sizes is None else int(sizes[i % len(sizes)]),
            ))
    out.sort(key=lambda a: (a.t_ms, a.tenant))
    return out


def replay(engine, arrivals, images, *, clock: VirtualClock,
           max_idle_ticks: int = 10_000) -> list[tuple[int, int, int]]:
    """Replay a generated trace through an engine under a
    ``VirtualClock``: advance the clock to each arrival, submit it,
    offer the engine a tick, then drain — jumping the clock to the
    engine's next admission deadline whenever a tick defers. Works for
    scheduling engines (slo_ms > 0) and legacy ones alike (a legacy
    engine never defers, so the clock jumps never trigger).

    ``images`` is either a single HWC array or a ``{tenant: array}``
    dict. Returns one ``(served, live, width)`` triple per dispatched
    tick for utilization reporting. The engine must have been
    constructed with this same ``clock``."""
    from repro_torch.serve.engine import VigRequest

    ticks: list[tuple[int, int, int]] = []

    def _tick() -> int:
        served = engine.step()
        if served:
            ticks.append((served, len(engine.last_lanes),
                          engine._tick_width(engine.last_bucket)))
        return served

    for uid, arr in enumerate(arrivals):
        t_arr = arr.t_ms / 1e3
        # timer wakeups: serve every queued cell whose deadline ripens
        # before this arrival — a real scheduler loop wakes on its
        # deadline timer, not only on arrivals, and the SLO bound the
        # property tests pin depends on it.
        idle = 0
        while engine.queue and idle < max_idle_ticks:
            dl = engine.next_deadline()
            if dl is None or dl >= t_arr:
                break
            clock.advance_to(dl)
            idle = idle + 1 if _tick() == 0 else 0
        clock.advance_to(t_arr)
        img = images[arr.tenant] if isinstance(images, dict) else images
        engine.submit(VigRequest(uid=uid, image=img, tenant=arr.tenant,
                                 tclass=arr.tclass))
        _tick()
    idle = 0
    while engine.queue and idle < max_idle_ticks:
        if _tick() == 0:
            idle += 1
            dl = engine.next_deadline()
            if dl is not None:
                clock.advance_to(dl)
        else:
            idle = 0
    if engine.queue:
        raise RuntimeError(
            f"trace replay stalled with {len(engine.queue)} requests "
            f"queued after {max_idle_ticks} idle ticks")
    return ticks
