"""A flight recorder of the port's host-side spans and counters.

One recorder per process (``RECORDER``), on from import. A span is a
name, a start and an end on ``time.perf_counter_ns()`` (the clock a
caller's ``time.perf_counter()`` reads), an id (the engine's tick number,
a request's uid) and the sequence number of the span that contains it
(-1: none), and optional attributes (``attr_dict``). Counters are
cumulative named integers.

Sites stamp the clock once per boundary and pass the stamps in: a tick's
phases are recorded with ``lap``, each ending where the next begins, and
a parent whose children close before it reserves its sequence number
with ``open``. ``enabled = False`` turns every site off at the cost of
one attribute check; the recorder is not locked (the engine's tick runs
on one thread).

Memory is fixed when the recorder is made: a ring of ``capacity`` spans,
which overwrites the oldest once full (``wrapped`` says it did), and up
to ``keep`` set-up spans (kernel builds, captures) that are never
overwritten; past that, they go into the ring.

``chrome_events(base_ns)`` exports the spans as Chrome-trace complete
events on the clock of ``torch.profiler``'s exported trace, whose ``ts``
is ``(time.time_ns() - baseTimeNanoseconds) / 1e3`` (``baseTimeNanoseconds``
is in the trace's header). Stamps are mapped to the wall clock through
anchor pairs ``(perf_counter_ns, time_ns)``, taken again at least once a
second while spans are opened.
"""

from __future__ import annotations

import bisect
import os
import time
from typing import NamedTuple, Optional

now = time.perf_counter_ns

CAPACITY = 1 << 17  # ring slots: ~36 s of iso224-backlog's ~3,600 spans a second
KEEP = 1 << 12  # set-up spans kept for the life of the process
ANCHOR_NS = 1_000_000_000  # the longest stretch between two wall-clock anchors
ANCHORS = 1 << 14  # anchors kept (the older half is dropped past it)
SYNCS = "engine.syncs"  # host waits on the device inside VigServeEngine.step
# The engine's slot-row lifecycle (also in VigServeEngine.stats()):
ROWS_RESET = "engine.rows_reset"  # slots cold-reset by a tick's batched reset
ROW_INDEX_UPLOADS = "engine.row_index_uploads"  # staged row-index copies
SCATTER_SKIPPED = "engine.scatter_skipped"  # ticks whose program passed its state through
# Tokens through ServeEngine: prompt tokens prefilled, rows decoded.
PREFILL_TOKENS = "lm.prefill_tokens"
DECODE_TOKENS = "lm.decode_tokens"
# moe_apply's calls that ran every expert on every token (_dense_moe),
# counted on the host; the routed path's kernel launches are in
# kernels.launch_counts()["moe_experts"].
MOE_DENSE_CALLS = "moe.dense_calls"
WAITS = ("engine.screen.wait", "engine.pull")  # a tick's spans that wait on the device


class Span(NamedTuple):
    seq: int
    name: str
    t0: int  # perf_counter_ns
    t1: int
    key: object  # the tick number, the request's uid, or -1
    parent: int  # the containing span's seq, -1 for none
    attrs: Optional[tuple]  # flat: see ``attr_dict``


class Tick(NamedTuple):
    """One ``engine.step`` span with what it waited on the device
    (``wait_ns``: its ``WAITS`` descendants) and its attributes."""

    t0: int
    t1: int
    wait_ns: int
    attrs: dict


class Recorder:
    """The spans and counters of one process (``RECORDER``)."""

    __slots__ = ("enabled", "capacity", "wrapped", "counters", "_seqs",
                 "_names", "_t0s", "_t1s", "_keys", "_parents", "_attrs",
                 "_w", "_seq", "_kept", "_keep", "_anchors", "_anchor_perf")

    def __init__(self, capacity: int = CAPACITY, keep: int = KEEP):
        if capacity < 1 or keep < 0:
            raise ValueError(f"capacity must be >= 1 and keep >= 0: "
                             f"{capacity}, {keep}")
        self.enabled = True
        self.capacity = int(capacity)
        self._keep = int(keep)
        self.wrapped = False
        self.counters: dict[str, int] = {}
        # The ring, a list per field: a span allocates no container, so
        # the cyclic GC neither runs more often nor tracks more objects.
        self._seqs: list = [-1] * self.capacity  # -1: an empty slot
        self._names: list = [None] * self.capacity
        self._t0s: list = [0] * self.capacity
        self._t1s: list = [0] * self.capacity
        self._keys: list = [None] * self.capacity
        self._parents: list = [-1] * self.capacity
        self._attrs: list = [None] * self.capacity
        self._w = 0
        self._seq = 0
        self._kept: list = []
        self._anchors: list[tuple[int, int]] = []
        self._anchor_perf = 0
        self.anchor()

    # -- recording ------------------------------------------------------

    def open(self, t0: int) -> int:
        """Reserve the sequence number of a span whose children are
        recorded before it (pass it to ``add``/``lap`` as ``seq``); also
        retakes the wall-clock anchor when the last is ``ANCHOR_NS`` old."""
        if t0 - self._anchor_perf >= ANCHOR_NS:
            self.anchor()
        seq = self._seq
        self._seq = seq + 1
        return seq

    def add(self, name: str, t0: int, t1: int, key=-1, parent: int = -1,
            attrs: Optional[tuple] = None, seq: int = -1,
            keep: bool = False) -> int:
        """Record one span; returns its sequence number. ``attrs`` is a
        flat tuple of atoms (``attr_dict``)."""
        if seq < 0:
            seq = self._seq
            self._seq = seq + 1
        if keep and len(self._kept) < self._keep:
            self._kept.append(Span(seq, name, t0, t1, key, parent, attrs))
            return seq
        i = self._w
        self._seqs[i] = seq
        self._names[i] = name
        self._t0s[i] = t0
        self._t1s[i] = t1
        self._keys[i] = key
        self._parents[i] = parent
        self._attrs[i] = attrs
        i += 1
        if i == self.capacity:
            i = 0
            self.wrapped = True
        self._w = i
        return seq

    def lap(self, name: str, t0: int, key=-1, parent: int = -1,
            attrs: Optional[tuple] = None, seq: int = -1,
            keep: bool = False) -> int:
        """Record a span from ``t0`` to now; returns now (the next phase's
        start)."""
        t1 = now()
        self.add(name, t0, t1, key, parent, attrs, seq, keep)
        return t1

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def anchor(self) -> None:
        """Pair the span clock with the wall clock: ``time_ns`` between two
        ``perf_counter_ns`` reads, stamped at their midpoint; the closest
        bracket of three tries (a thread preempted inside one widens it)."""
        best = None
        for _ in range(3):
            p0 = now()
            wall = time.time_ns()
            p1 = now()
            if best is None or p1 - p0 < best[0]:
                best = (p1 - p0, (p0 + p1) // 2, wall)
        self._anchor_perf = best[1]
        self._anchors.append(best[1:])
        if len(self._anchors) > ANCHORS:
            del self._anchors[:ANCHORS // 2]

    # -- reading --------------------------------------------------------

    def spans(self) -> list[Span]:
        """Every span held, kept and in the ring, by sequence number."""
        ring = zip(self._seqs, self._names, self._t0s, self._t1s,
                   self._keys, self._parents, self._attrs)
        return sorted(self._kept + [Span(*r) for r in ring if r[0] >= 0],
                      key=lambda s: s.seq)

    def ticks(self, since_ns: int, until_ns: int) -> list[Tick]:
        """``ticks`` of the spans held."""
        return ticks(self.spans(), since_ns, until_ns)

    def _wall_ns(self, perf_ns: int) -> int:
        """``perf_ns`` on the wall clock, through the last anchor taken at
        or before it (the first anchor for earlier stamps)."""
        i = bisect.bisect_right(self._anchors, perf_ns, key=lambda a: a[0]) - 1
        p, wall = self._anchors[max(i, 0)]
        return wall + perf_ns - p

    def chrome_events(self, base_ns: int) -> list[dict]:
        """The spans as Chrome-trace ``"X"`` events on a profiler trace's
        clock: ``ts`` and ``dur`` in microseconds from ``base_ns`` (the
        trace's ``baseTimeNanoseconds``); ``args`` holds the id, the
        sequence numbers and the span's attributes."""
        pid = os.getpid()
        out = []
        for s in self.spans():
            args = {"id": s.key, "seq": s.seq, "parent": s.parent}
            args.update(attr_dict(s.attrs))
            out.append({"ph": "X", "cat": "repro_torch", "name": s.name,
                        "pid": pid, "tid": 0,
                        "ts": (self._wall_ns(s.t0) - base_ns) / 1e3,
                        "dur": (s.t1 - s.t0) / 1e3, "args": args})
        return out


def ticks(held: list[Span], since_ns: int, until_ns: int) -> list[Tick]:
    """The ``engine.step`` spans of ``held`` that started in ``[since_ns,
    until_ns)``, by start, each with the time its ``WAITS`` descendants
    took."""
    parent = {s.seq: s.parent for s in held}
    steps = {s.seq: s for s in held
             if s.name == "engine.step" and since_ns <= s.t0 < until_ns}
    waits = dict.fromkeys(steps, 0)
    for s in held:
        if s.name not in WAITS:
            continue
        up = s.parent
        while up >= 0 and up not in steps:
            up = parent.get(up, -1)
        if up >= 0:
            waits[up] += s.t1 - s.t0
    return sorted((Tick(s.t0, s.t1, waits[q], attr_dict(s.attrs))
                   for q, s in steps.items()), key=lambda t: t.t0)


def attr_dict(attrs: Optional[tuple]) -> dict:
    """A span's attributes by name. They are kept flat, ``(names,
    *values)``, the last name taking every value left: a tuple of atoms
    holds no container, so the cyclic GC stops tracking it at its first
    pass and never promotes it (a dict or list per span would be kept
    tracked and promoted while the ring fills, and bring sooner the full
    collections that pause the process for ~0.15 s)."""
    if not attrs:
        return {}
    names, last = attrs[0], len(attrs[0]) - 1
    out = dict(zip(names[:last], attrs[1:1 + last]))
    out[names[last]] = list(attrs[1 + last:])
    return out


def self_ns(held: list[Span]) -> dict[int, int]:
    """Each span's own time: its length less the union of its children's
    intervals (clipped to it), by sequence number."""
    kids: dict[int, list] = {}
    for s in held:
        kids.setdefault(s.parent, []).append((s.t0, s.t1))
    out = {}
    for s in held:
        covered, end = 0, s.t0
        for a, b in sorted(kids.get(s.seq, ())):
            a, b = max(a, end), min(b, s.t1)
            if b > a:
                covered += b - a
                end = b
        out[s.seq] = s.t1 - s.t0 - covered
    return out


RECORDER = Recorder()
