"""Observability: per-stage timings, ray-throughput counters, device traces
and the program's own spans.

The port of `cloudscape_tpu.utils.profiling`. PyTorch returns from a call
on the card before the card has done its work, so a stage's wall clock
is honest only once the stage waits for its result: `StageTimer.stage(...,
fence=x)` and `StageTimer.fence(x)` synchronise the device of every CUDA
tensor in x (`torch.cuda.synchronize(device)`), and wait for nothing for
a CPU tensor, whose work is done when the call returns. `device_trace`
records a `torch.profiler` trace, with the card's activity when there is
one.

`span(name)` marks a stage of the engine's tick and cycle without
waiting for the card, so it can sit on the hot path. It records only
while a `torch.profiler` is recording: then it opens a
`record_function("sky:" + name)`, on the profiler's clock and in its
event list beside the card's activity, and adds its host duration to
in-memory aggregates (`span_stats`, `reset_spans`). Otherwise it costs
one flag check. The profiler's own trace (`device_trace`) is the
exporter; nothing is written here.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from cloudscape_tpu_torch.parallel.sharding import tree_map


def _wait_for(value: Any) -> Any:
    """Wait until the card has finished the work behind every CUDA tensor
    of `value` (a tensor, or a tree of them); returns value."""
    devices = set()
    tree_map(lambda t: devices.add(t.device) or t, value)
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    return value


class StageTimer:
    """Accumulates fenced wall-clock per named stage plus ray counters.

    Usage:
        timer = StageTimer()
        with timer.stage("tile_update", rays=96 * 96, fence=engine.cloud_ring):
            engine.update_sky()   # timed until the ring's device is done
        print(timer.report())
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.rays: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, rays: int = 0, fence: Any = None):
        """Time a stage; waits for `fence`'s device work (or nothing) before
        stopping the clock."""
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            if fence is not None:
                _wait_for(fence)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1
            self.rays[name] += rays

    def fence(self, value: Any) -> Any:
        """Wait for value's device work inside a stage block; returns value."""
        return _wait_for(value)

    def mrays_per_sec(self, name: str) -> Optional[float]:
        if self.totals[name] <= 0 or self.rays[name] == 0:
            return None
        return self.rays[name] / self.totals[name] / 1e6

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            total_ms = self.totals[name] * 1e3
            n = self.counts[name]
            line = f"{name:24s} {total_ms:9.2f} ms  ({n}x, {total_ms / n:8.3f} ms/call"
            mr = self.mrays_per_sec(name)
            if mr is not None:
                line += f", {mr:8.2f} Mrays/s"
            lines.append(line + ")")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "calls": self.counts[name],
                "mrays_per_sec": self.mrays_per_sec(name) or 0.0,
            }
            for name in self.totals
        }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A `torch.profiler` trace of the block (the host's activity, and the
    card's when one is present), written to `log_dir` as a TensorBoard /
    Chrome trace (`*.pt.trace.json`; open it in Perfetto or
    chrome://tracing). Yields the profiler (`key_averages()` etc.)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


# ------------------------------------------------------------------ spans

# The prefix of every span's profiler event. Trace readers take CPU events
# named "sky:*" as spans (an idle gap of the card is charged to the
# innermost one around it) and leave their annotations on the card's
# timeline out of its activity.
SPAN_PREFIX = "sky:"

# name -> [count, total s, self s, parent name]; updated under _SPAN_LOCK,
# since a mesh engine's shards open spans from threads of their own.
_span_totals: Dict[str, list] = {}
_SPAN_LOCK = threading.Lock()
# Each thread's stack of open spans.
_open_spans = threading.local()
# What `span` returns while no profiler records: stateless, so one
# instance serves every nesting and thread.
_NO_SPAN = contextlib.nullcontext()


class _Span:
    """One recorded span: the profiler's `record_function` and the host
    perf_counter interval inside it."""

    __slots__ = ("name", "event", "t0", "child_s")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "_Span":
        stack = getattr(_open_spans, "stack", None)
        if stack is None:
            stack = _open_spans.stack = []
        self.event = torch.profiler.record_function(SPAN_PREFIX + self.name)
        self.event.__enter__()
        self.child_s = 0.0
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dur = time.perf_counter() - self.t0
        stack = _open_spans.stack
        stack.pop()
        parent = stack[-1] if stack else None
        if parent is not None:
            parent.child_s += dur
        self.event.__exit__(*exc)
        with _SPAN_LOCK:
            agg = _span_totals.get(self.name)
            if agg is None:
                agg = _span_totals[self.name] = [
                    0, 0.0, 0.0, parent.name if parent is not None else None]
            agg[0] += 1
            agg[1] += dur
            agg[2] += dur - self.child_s
        return False


def device_activities(events) -> list:
    """The card's activities among a profiler's `events` (kernels, copies,
    fills): the events on a CUDA device, less the annotations that spans
    leave on its timeline, which cover whole span ranges."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not e.name.startswith(SPAN_PREFIX)]


def span(name: str):
    """A context manager over one stage named `name`. While a
    `torch.profiler` records (any activities), it is the profiler event
    "sky:" + name and its host duration counts in `span_stats()`; else it
    does nothing, and costs one check of the profiler's flag."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


def span_stats() -> Dict[str, Dict[str, Any]]:
    """{name: {"count", "total_s", "self_s", "parent"}} of the spans
    recorded since the last `reset_spans()`: how many closed, their summed
    host duration, that less the time their child spans covered, and the
    enclosing span's name the first time one closed (None at the top of
    its thread)."""
    with _SPAN_LOCK:
        return {name: {"count": c, "total_s": t, "self_s": s, "parent": p}
                for name, (c, t, s, p) in _span_totals.items()}


def reset_spans() -> None:
    """Forget every recorded span."""
    with _SPAN_LOCK:
        _span_totals.clear()
