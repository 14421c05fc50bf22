"""Spans of the port's host phases, on the profiler's clock.

``span(name)`` marks a phase (the engine's admission, a prefill chunk, the
serve step's model and sample, the learner's loss, grad and update).  With
no profiler recording it returns one shared null context, at the cost of a
flag read.  Under ``torch.profiler`` it enters
``record_function("repro_torch.<name>")``, so the span lies on the
profiler's timeline beside the device's work, and appends a record to a
bounded buffer: the name, start and end on the ``time.time_ns()`` clock and
the counts ``count`` adds.  Neither touches the device or synchronises with
it.  The port opens spans from one thread.
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch
from torch.autograd import profiler as _profiler

PREFIX = "repro_torch."
CAPACITY = 1 << 16
_NULL = contextlib.nullcontext()


class Record:
    __slots__ = ("name", "start", "end", "counts")

    def __init__(self, name, start):
        self.name, self.start, self.end, self.counts = name, start, None, {}


_buffer: collections.deque = collections.deque(maxlen=CAPACITY)
_open: list = []                    # the open records, innermost last
dropped = 0


def span(name: str):
    """A context for the phase ``name``: the shared null context (entered
    as None) unless a profiler is recording, else the phase's record."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _span(name)


@contextlib.contextmanager
def _span(name):
    global dropped
    rec = Record(name, time.time_ns())
    if len(_buffer) == _buffer.maxlen:
        dropped += 1
    _buffer.append(rec)
    _open.append(rec)
    try:
        with torch.profiler.record_function(PREFIX + name):
            yield rec
    finally:
        rec.end = time.time_ns()
        _open.pop()


def count(**n) -> None:
    """Add counts to the innermost open span (nothing when none is)."""
    if _open:
        c = _open[-1].counts
        for k, v in n.items():
            c[k] = c.get(k, 0) + v


def records(lo_ns: int = 0, hi_ns: int = 1 << 63) -> list:
    """The closed records that lie inside [lo_ns, hi_ns], oldest first."""
    return [r for r in _buffer
            if r.end is not None and lo_ns <= r.start and r.end <= hi_ns]


def clear() -> None:
    global dropped
    _buffer.clear()
    dropped = 0
