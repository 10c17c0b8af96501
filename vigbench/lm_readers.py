"""What the LM metrics read from the program's spans
(``repro_torch.spans``: ``ServeEngine``'s ``engine.submit``, ``lm.step``
and its ``lm.prefill``, ``lm.decode`` and ``lm.pull``). Each helper
gives nothing (None, or an empty list) where the program records no such
span."""

from __future__ import annotations


def held_spans():
    """Every span the program's recorder holds, or None without one."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans.RECORDER.spans()


def attrs(span) -> dict:
    from repro_torch import spans

    return spans.attr_dict(span.attrs)


def ticks(held, since_ns: int, until_ns: int) -> list:
    """The ``lm.step`` spans that started in [since_ns, until_ns), by
    start, each as (step, {child name: [child spans]})."""
    steps = {s.seq: (s, {}) for s in held
             if s.name == "lm.step" and since_ns <= s.t0 < until_ns}
    for s in held:
        if s.parent in steps:
            steps[s.parent][1].setdefault(s.name, []).append(s)
    return sorted(steps.values(), key=lambda st: st[0].t0)


def host_ticks(ctx) -> list:
    """``ticks`` of the window before the profiled slice (the whole
    window untraced)."""
    held = held_spans()
    if not held:
        return []
    w = ctx.window
    until = w.end if w.host_until is None else w.host_until
    return ticks(held, int(w.start * 1e9), int(until * 1e9))


def slice_ticks(ctx) -> list:
    """``ticks`` of the profiled slice: the ``len(trace["ticks"])`` ticks
    from the first that started once the profiler's lead had passed
    (``trace.Slice``)."""
    from vigbench.trace import Slice

    held = held_spans()
    w, t = ctx.window, ctx.trace
    if not held or t is None or w.host_until is None:
        return []
    found = ticks(held, int((w.host_until + Slice.LEAD_S) * 1e9), int(w.end * 1e9 + 1e12))
    return found[:len(t["ticks"])]
