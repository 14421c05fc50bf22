"""The program's own spans in a traced run.

The port marks its host phases with ``record_function("repro_torch.<name>")``
(``src/repro_torch/spans.py``), so the profiler records them among its host
events, on the device trace's clock, and keeps their counts in a buffer of
the program's, on the ``time.time_ns()`` clock that bounds the traced
stretch.  ``idle_s`` is the device-idle time inside the union of named
spans, clipped to the stretch; ``idle_ms_per`` is that time inside another
span per instance of it (per admission, per decode step), so that it does
not swing with how many of them the stretch holds; ``idle_by_span`` splits
the stretch's idle time by the innermost program span at each instant.  A
program without spans gives nothing to read: None, or an empty list.
"""
from __future__ import annotations

from benchlib import devtrace

PREFIX = "repro_torch."


def idle_intervals(trace) -> list:
    """The sorted stretches of [start, end) with nothing on the device."""
    out, t = [], trace.start
    for s, e in devtrace.merge([(s, e) for _, s, e in trace.kernels]):
        if s >= trace.end:
            break
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < trace.end:
        out.append((t, trace.end))
    return out


def _meet(a, b):
    """(index into a, start, end) of the overlap of each overlapping pair of
    two sorted lists of disjoint intervals (a's entries may carry more
    fields)."""
    i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            yield i, lo, hi
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1


def idle_s(trace, names) -> float | None:
    """Device-idle seconds inside the union of the program spans ``names``
    (without the prefix) within the stretch; None where the trace has no
    such span."""
    inside = _union(trace, names)
    if not inside:
        return None
    return _idle_ns(trace, inside) / 1e9


def _union(trace, names) -> list:
    full = {PREFIX + n for n in names}
    return devtrace.merge([(s, e) for n, s, e in trace.host if n in full])


def _idle_ns(trace, inside) -> int:
    return sum(hi - lo for _, lo, hi in _meet(inside, idle_intervals(trace)))


def idle_share(trace, names) -> float | None:
    """``idle_s`` over the traced stretch, in percent."""
    idle = idle_s(trace, names)
    return None if idle is None else 100.0 * idle / trace.window_s


def idle_ms_per(trace, names, per: str) -> float | None:
    """Device-idle ms inside the spans ``names`` where they lie inside a
    ``per`` span, per ``per`` span in the stretch; a ``per`` span cut by
    the stretch's edge counts by the share of it inside.  None where the
    trace has no ``names`` span or no ``per`` span in the stretch."""
    ivs = [(s, e) for n, s, e in trace.host if n == PREFIX + per and e > s]
    n = sum(max(0, min(e, trace.end) - max(s, trace.start)) / (e - s)
            for s, e in ivs)
    inside = _union(trace, names)
    if not n or not inside:
        return None
    both = [(lo, hi) for _, lo, hi in _meet(inside, devtrace.merge(ivs))]
    return _idle_ns(trace, both) / 1e6 / n


def innermost(trace) -> list:
    """(start, end, name) pieces of the timeline, each under the innermost
    program span that holds it (spans nest on the thread that opens
    them)."""
    evs = sorted(((s, -e, n[len(PREFIX):]) for n, s, e in trace.host
                  if n.startswith(PREFIX)))
    out, stack, t = [], [], None
    for s, neg_e, name in evs:
        while stack and stack[-1][1] <= s:
            n, end = stack.pop()
            out.append((t, end, n))
            t = end
        if stack:
            out.append((t, s, stack[-1][0]))
        stack.append((name, -neg_e))
        t = s
    while stack:
        n, end = stack.pop()
        out.append((t, end, n))
        t = end
    return [p for p in out if p[1] > p[0]]


def idle_by_span(trace) -> dict:
    """{innermost program span: device-idle seconds in the stretch}, the
    idle time outside every program span under ""."""
    idle = idle_intervals(trace)
    out = {"": sum(e - s for s, e in idle) / 1e9}
    pieces = innermost(trace)
    for i, lo, hi in _meet(pieces, idle):
        name = pieces[i][2]
        out[name] = out.get(name, 0.0) + (hi - lo) / 1e9
        out[""] -= (hi - lo) / 1e9
    return out


def records(trace, name: str) -> list:
    """The program's records named ``name`` inside the traced stretch."""
    try:
        from repro_torch import spans as program
    except ImportError:
        return []
    return [r for r in program.records(trace.start, trace.end)
            if r.name == name]
