"""The traced run's reading of ``torch.profiler``: device activity inside
the window, host ranges, and the two lists of the result's ``breakdown``.

Times are the profiler's, in seconds.  A device operation is any CUDA
activity the profiler records (kernels, copies, fills) that is not a
host range mirrored onto the device timeline.
"""

from __future__ import annotations

import bisect
import contextlib

import torch
from torch.autograd import DeviceType

WINDOW = "surfbench.window"


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


@contextlib.contextmanager
def host_range(name, sync=False):
    """A named host range; with ``sync`` it ends once the card has run what
    was launched in it, so that its kernels start inside it."""
    with torch.profiler.record_function(name):
        yield
        if sync:
            torch.cuda.synchronize()


class Trace:
    """The events of one profiled run, cut to the window range.  Read from
    the profiler's raw event list (``kineto_results``), which holds every
    host operation and device activity without building the tree of
    ``prof.events()``; times in nanoseconds."""

    def __init__(self, prof, range_names=()):
        names = set(range_names) | {WINDOW}
        host, device = [], []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                annotation = getattr(e, "is_user_annotation", None)
                if name not in names and not (annotation and annotation()):
                    device.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
            elif name in names:
                host.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        win = [r for r in host if r[2] == WINDOW]
        if not win:
            raise RuntimeError("the trace holds no window range")
        self.t0, self.t1 = win[0][0], win[0][1]
        self.ops = sorted(op for op in device if self.t0 <= op[0] < self.t1)
        self.ranges = sorted(r for r in host if r[2] != WINDOW)

    @property
    def window_s(self):
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self):
        """The union of the device operations' intervals, clipped to the
        window, as sorted (start, end) in nanoseconds."""
        out = []
        for a, b, _ in self.ops:
            b = min(b, self.t1)
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def device_ops(self, top=10):
        """The device operations that took most time: [[name, seconds]]."""
        by = {}
        for a, b, k in self.ops:
            by[k] = by.get(k, 0.0) + (b - a) / 1e9
        return [[k[:200], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top=10):
        """The device's idle time inside the window, summed by the innermost
        host range open where each gap begins ("outside" where none is):
        [[name, seconds]], the largest first."""
        gaps, last = [], self.t0
        for a, b in self.busy_intervals():
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        if self.t1 > last:
            gaps.append((last, self.t1))
        by = {}
        starts = [r[0] for r in self.ranges]
        longest = max((r[1] - r[0] for r in self.ranges), default=0)
        for a, b in gaps:
            # the ranges open at a began within the longest range's length
            lo = bisect.bisect_left(starts, a - longest)
            hi = bisect.bisect_right(starts, a)
            open_ = [r for r in self.ranges[lo:hi] if a < r[1]]
            name = min(open_, key=lambda r: r[1] - r[0])[2] if open_ else "outside"
            by[name] = by.get(name, 0.0) + (b - a) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def range_device_s(self, name):
        """Per occurrence of host range ``name``, the device seconds of the
        operations that start inside it."""
        starts = [s for s, _, _ in self.ops]
        cum = [0.0]
        for s, e, _ in self.ops:
            cum.append(cum[-1] + (e - s))
        out = []
        for a, b, k in self.ranges:
            if k == name:
                i, j = bisect.bisect_left(starts, a), bisect.bisect_left(starts, b)
                out.append((cum[j] - cum[i]) / 1e9)
        return out
