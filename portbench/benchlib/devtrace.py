"""The profiler's device trace, reduced in memory.

``capture(fn)`` runs ``fn`` under ``torch.profiler`` (CPU and CUDA
activities) and keeps, from the profiler's own events: every device
activity (kernels, copies, sets) as (name, start, end) in ns, and every
host event.  Busy time is the union of the device intervals inside the
window, each stretch counted once however many streams overlap it; idle
is the rest.  The benchmark's spans inside the window are
``record_function`` annotations named ``portbench.<what>``.
"""
from __future__ import annotations

import bisect
import time
from typing import Callable, List, Tuple

ANNOT = "portbench."


def merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted union of [start, end) intervals."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy_ns(intervals, lo: int, hi: int) -> int:
    """Length of the union of the intervals clipped to [lo, hi)."""
    return sum(max(0, min(e, hi) - max(s, lo)) for s, e in merge(intervals))


class Trace:
    def __init__(self, device_events, host_events, start_ns: int,
                 end_ns: int):
        self.kernels = device_events          # [(name, start, end)]
        self.host = host_events               # [(name, start, end)]
        self.start, self.end = start_ns, end_ns

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def busy_s(self) -> float:
        return busy_ns([(s, e) for _, s, e in self.kernels], self.start,
                       self.end) / 1e9

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.window_s

    def time_of(self, match: Callable[[str], bool]) -> Tuple[int, float]:
        """(launches, seconds) of the device activities whose name
        matches."""
        sel = [(s, e) for n, s, e in self.kernels if match(n)]
        return len(sel), sum(e - s for s, e in sel) / 1e9

    def spans(self, what: str) -> List[Tuple[int, int]]:
        name = ANNOT + what
        return [(s, e) for n, s, e in self.host if n == name]

    def launches_in(self, spans) -> int:
        """Kernel launches (runtime calls) the host made inside the spans."""
        starts = sorted(s for n, s, _ in self.host if _is_launch(n))
        return sum(bisect.bisect_left(starts, e) -
                   bisect.bisect_left(starts, s) for s, e in spans)

    def top_ops(self, n: int = 10) -> list:
        tot: dict = {}
        for name, s, e in self.kernels:
            tot[name] = tot.get(name, 0) + (e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:200], v / 1e9] for k, v in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest stretches with nothing on the device, each named by
        the benchmark span and the innermost host operation at its middle
        ("python" where no operation holds it)."""
        busy = merge([(s, e) for _, s, e in self.kernels])
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = (s + e) // 2
            inner = [(he - hs, name) for name, hs, he in self.host
                     if hs <= mid < he and not _is_launch(name)]
            annot = [x for x in inner if x[1].startswith(ANNOT)]
            ops = [x for x in inner if not x[1].startswith(ANNOT)]
            label = min(annot)[1][len(ANNOT):] if annot else "window"
            label += "/" + (min(ops)[1] if ops else "python")
            out.append([label[:200], (e - s) / 1e9])
        return out

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}


def _is_launch(name: str) -> bool:
    return "LaunchKernel" in name or name == "cudaGraphLaunch"


def capture(fn: Callable[[], None], sync: Callable[[], None]) -> Trace:
    """Run ``fn`` under the profiler; ``sync`` waits for the device, before
    the window opens and before it closes."""
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
    dev, host = split_events(
        (ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns(),
         ev.device_type() == cuda)
        for ev in prof.profiler.kineto_results.events())
    return Trace(dev, host, t0, t1)


def split_events(events) -> Tuple[list, list]:
    """(device operations, host events) of (name, start, end, on_device)
    events.  The profiler mirrors host annotations (the benchmark's spans,
    c10d's "nccl:*") onto the device's timeline under the host's name; they
    are no operation of the device and are left out by that name."""
    events = list(events)
    host = [(n, s, e) for n, s, e, on_dev in events if not on_dev]
    names = {n for n, _, _ in host}
    dev = [(n, s, e) for n, s, e, on_dev in events
           if on_dev and n not in names]
    return dev, host
