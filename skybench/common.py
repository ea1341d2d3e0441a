"""The yardstick's arithmetic: window statistics, the comparison and the
device trace's reduction."""

from __future__ import annotations

import collections
import math
import statistics
import sys
import time

import torch

# `torch.cuda._sleep`'s kernel, which opens and closes each traced group.
MARKER = "spin_kernel"
# Markers that open a group. A trace of some 35,000 activities can lose
# its earliest few records (seen on the H100: one to three); with several
# opening markers a group stays whole while any of them is left.
OPEN_MARKERS = 4
# The idle margins around a group grow after each group left out, to this.
MAX_MARGIN_S = 0.8
# Idle host time that opens and closes a traced group, so the profiler
# keeps the group's first and last device activities.
TRACE_MARGIN_S = 0.05


def window_mean_ms(total_s: float, count: int) -> float:
    """The window's wall time over the work it completed, in ms."""
    return total_s * 1e3 / count


def p99(values) -> float:
    """The 99th percentile (statistics.quantiles, exclusive method)."""
    return statistics.quantiles(values, n=100)[98]


def psnr_db(out, ref) -> float:
    """PSNR of out against ref, the peak being ref's largest |value|
    (the port's bench.py's definition); computed in float64."""
    out, ref = out.double(), ref.double()
    peak = max(float(ref.abs().max()), 1e-9)
    mse = float(((out - ref) ** 2).mean())
    return 10.0 * math.log10(peak * peak / max(mse, 1e-30))


def snr_db(out, ref) -> float:
    """20·log10(rms(ref) / rms(out − ref)), in float64: an image's error
    against its own level, steady whether or not the sun's disk is in it."""
    out, ref = out.double(), ref.double()
    err = float(((out - ref) ** 2).mean())
    return 10.0 * math.log10(max(float((ref ** 2).mean()), 1e-30) / max(err, 1e-30))


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for start, stop in sorted(intervals):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def idle_gaps(intervals, lo: float, hi: float):
    """The gaps in [lo, hi] that no (start, end) interval covers."""
    gaps, cursor = [], lo
    for start, stop in sorted(intervals):
        if start > cursor:
            gaps.append((cursor, min(start, hi)))
        cursor = max(cursor, stop)
        if cursor >= hi:
            break
    if cursor < hi:
        gaps.append((cursor, hi))
    return [(a, b) for a, b in gaps if b > a]


class TraceSummary:
    """The reduction of traced groups of calls: device-busy time (the union
    of the device activities between each group's markers), the traced
    wall time, activity counts, device time by kernel name, and the idle
    gaps by the harness span the host was in at the gap's midpoint."""

    def __init__(self):
        self.busy_s = 0.0
        self.window_s = 0.0
        self.activities = 0
        self.calls = 0
        self.kernel_s = collections.Counter()
        self.gap_s = collections.Counter()

    @staticmethod
    def _inner(events):
        """(inner activities, end of the last opening marker, start of the
        closing marker): the activities between a run of opening markers
        (one at least) that starts the sorted trace and the closing marker
        that ends it. Raises ValueError for any other shape."""
        events = sorted(events, key=lambda e: e[1])
        marks = [i for i, e in enumerate(events) if MARKER in e[0]]
        opening = marks[:-1]
        if (len(marks) < 2 or marks[-1] != len(events) - 1
                or opening != list(range(len(opening)))):
            raise ValueError(f"markers at {marks[:8]} of {len(events)} activities")
        inner = events[len(opening):-1]
        if not inner:
            raise ValueError("no device activity between the markers")
        return inner, events[len(opening) - 1][2], events[-1][1]

    def add_group(self, events, wall_s: float, calls: int) -> None:
        """events: a group's device activities (name, start µs, end µs),
        the markers included. Raises ValueError unless markers open and
        close the group."""
        inner = self._inner(events)[0]
        self.busy_s += union_us([(s, e) for _, s, e in inner]) * 1e-6
        self.window_s += wall_s
        self.activities += len(inner)
        self.calls += calls
        for name, s, e in inner:
            self.kernel_s[name] += (e - s) * 1e-6

    def add_gaps(self, events, spans) -> None:
        """Attribute a group's idle gaps to the harness spans (name, start
        µs, end µs) on the same clock: the innermost span holding the
        gap's midpoint."""
        inner, lo, hi = self._inner(events)
        for a, b in idle_gaps([(s, e) for _, s, e in inner], lo, hi):
            mid = 0.5 * (a + b)
            inside = [sp for sp in spans if sp[1] <= mid <= sp[2]]
            name = min(inside, key=lambda sp: sp[2] - sp[1])[0] if inside else "(between spans)"
            self.gap_s[name] += (b - a) * 1e-6

    def breakdown(self) -> dict:
        return {"device_ops": [[short_name(k), v] for k, v in self.kernel_s.most_common(10)],
                "idle_gaps": [[k, v] for k, v in self.gap_s.most_common(10)]}


def short_name(kernel: str, limit: int = 96) -> str:
    """A kernel's name without its leading `void ` and cut to `limit`."""
    name = kernel[5:] if kernel.startswith("void ") else kernel
    return name if len(name) <= limit else name[:limit - 3] + "..."


def _traced(call, first: int, size: int, span_of, margin: float, host: bool):
    """One traced group of calls first .. first + size − 1: (device
    activities, harness spans, the calls' wall seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        time.sleep(margin)
        for _ in range(OPEN_MARKERS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(first, first + size):
            if host:
                with record_function("sky:" + span_of(k)):
                    call(k)
            else:
                call(k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(margin)
    evs = prof.events()
    # The spans also appear on the device's timeline, as annotations.
    dev = [(e.name, e.time_range.start, e.time_range.end) for e in evs
           if e.device_type == DeviceType.CUDA and not e.name.startswith("sky:")]
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in evs
             if e.device_type == DeviceType.CPU and e.name.startswith("sky:")]
    return dev, spans, wall


def trace_groups(call, n: int, group: int, span_of, summary: TraceSummary) -> int:
    """Trace call(i) for i = 0, 1, ... in groups of `group` calls until n
    traced calls are in `summary`, then one group more for the idle gaps.

    The first pass traces the device alone (torch.profiler's CUDA
    activity), so the host runs at its untraced pace: busy and idle time,
    activities and kernel times come from it. The last group also traces
    the host, each call inside a `record_function` span named
    "sky:" + span_of(i) (read before the call), and only its idle gaps are
    kept, by span (the host's tracing slows it, so those gaps run long).
    Each group is opened by `OPEN_MARKERS` marker kernels and closed by
    one, with idle margins; a group that lost its closing marker or every
    opening one is left out and the next calls are traced, the margins
    grown fourfold up to `MAX_MARGIN_S`, up to six times. Returns the
    calls made."""
    i, done, failures, margin, gaps_done = 0, 0, 0, TRACE_MARGIN_S, False
    while not gaps_done:
        host = done >= n
        size = group if host else min(group, n - done)
        dev, spans, wall = _traced(call, i, size, span_of, margin, host)
        i += size
        try:
            if host:
                summary.add_gaps(dev, spans)
                gaps_done = True
            else:
                summary.add_group(dev, wall, size)
                done += size
        except ValueError as e:
            failures += 1
            margin = min(margin * 4, MAX_MARGIN_S)
            print(f"skybench: a traced group is left out ({e}); tracing the next calls with "
                  f"{margin:.2f}-s margins", file=sys.stderr)
            if failures > 6:
                raise
    return i
