"""A device trace whose kernels keep the host call that launched them.

``devtrace.capture`` keeps device intervals and host events; the
profiler also pairs each device activity with its runtime call (a
``cudaLaunchKernel``, a copy or a set) by a correlation id, which it
drops.  ``capture`` here keeps it, so that ``launched_in`` gives the
device time of the work whose launch lay inside a program span, however
late the device ran it: where the host runs ahead of the card (a prefill
chunk over many rows) a span's work runs after the span has closed, and
a reading by the overlap of times would give it to later spans.
"""
from __future__ import annotations

import bisect
import time
from typing import Callable

from benchlib import devtrace, spans


class LinkedTrace(devtrace.Trace):
    def __init__(self, device_events, host_events, start_ns, end_ns,
                 launched_at):
        super().__init__(device_events, host_events, start_ns, end_ns)
        self.launched_at = launched_at    # a launch time each kernel, or None

    def launched_in(self, names) -> list:
        """[(start, end)] of the device activities whose runtime call lay
        inside the union of the program spans ``names`` (no prefix)."""
        inside = spans._union(self, names)
        starts = [s for s, _ in inside]
        out = []
        for (_, s, e), at in zip(self.kernels, self.launched_at):
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at < inside[i][1]:
                out.append((s, e))
        return out

    def busy_in(self, names) -> float:
        """Seconds of the stretch in which work launched inside the spans
        ``names`` ran (its intervals' union, clipped to the stretch)."""
        return devtrace.busy_ns(self.launched_in(names), self.start,
                                self.end) / 1e9


def link(events):
    """(device events, host events, each device event's launch time or
    None) of (name, start, end, on_device, correlation id) events."""
    events = list(events)
    host = [(n, s, e) for n, s, e, on_dev, _ in events if not on_dev]
    names = {n for n, _, _ in host}
    calls = {c: s for n, s, _, on_dev, c in events
             if not on_dev and c and n.startswith(("cuda", "cu"))}
    dev, at = [], []
    for n, s, e, on_dev, c in events:
        if on_dev and n not in names:
            dev.append((n, s, e))
            at.append(calls.get(c) if c else None)
    return dev, host, at


def capture(fn: Callable[[], None], sync: Callable[[], None]) -> LinkedTrace:
    """``devtrace.capture`` keeping each kernel's launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, record_shapes=False,
                 with_stack=False) as prof:
        t0 = time.time_ns()
        fn()
        sync()
        t1 = time.time_ns()
    cuda = torch.autograd.DeviceType.CUDA
    dev, host, at = link(
        (ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns(),
         ev.device_type() == cuda, ev.correlation_id())
        for ev in prof.profiler.kineto_results.events())
    return LinkedTrace(dev, host, t0, t1, at)
