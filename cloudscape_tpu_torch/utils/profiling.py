"""Observability: per-stage timings, ray-throughput counters, device traces.

The port of `cloudscape_tpu.utils.profiling`. PyTorch returns from a call
on the card before the card has done its work, so a stage's wall clock
is honest only once the stage waits for its result: `StageTimer.stage(...,
fence=x)` and `StageTimer.fence(x)` synchronise the device of every CUDA
tensor in x (`torch.cuda.synchronize(device)`), and wait for nothing for
a CPU tensor, whose work is done when the call returns. `device_trace`
records a `torch.profiler` trace, with the card's activity when there is
one.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import torch

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
