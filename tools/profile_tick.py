#!/usr/bin/env python3
"""Where the serving tick's time goes, on one CUDA card.

Run from the repository root:  python3 tools/profile_tick.py

Drives the engine of `chip_smoke.py` (fast3, 768² / 64 frames / 128 steps /
6 light steps, cone cache (32, 512, 512), procedural_noise_pack(0), a
1280×720 camera) and prints:

1. one line per tick over 70 ticks after the warm start: the prebake stage
   that tick ran, host ms of `update_sky` and of `render_view` (each
   followed by a synchronise), and their sum;
2. the median tick per stage;
3. a `torch.profiler` trace of one tick of each stage kind in the next
   cycle, from its boundary on: launches (device kernels, copies and
   fills) and device ms;
4. a trace of 10 steady ticks (no bake stage left): device ms per tick,
   launches per tick, the device's idle share against the same ticks
   unprofiled, and the 12 largest device kernels by time.

The profiler slows the host, so its wall times are not tick times; the idle
share divides profiled device time by unprofiled tick time.
"""

from __future__ import annotations

import collections
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEADY = 10


def tick(eng, eyedirs, now, torch):
    """One render_frame split into its two calls; host ms of each."""
    t0 = time.perf_counter()
    eng.update_sky(now)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng.render_view(eyedirs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3


def device_events(prof):
    from cloudscape_tpu_torch.utils.profiling import device_activities

    return device_activities(prof.events())


def main() -> int:
    os.environ["CUDA_VISIBLE_DEVICES"] = \
        os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_tick: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import camera_dirs, card_line
    from cloudscape_tpu_torch import CloudConfig, PerfConfig, SunState
    from cloudscape_tpu_torch.engine import CloudSkyEngine
    from cloudscape_tpu_torch.probe_prebake import stage_of

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    eyedirs = camera_dirs(1280, 720, dev)
    eng = CloudSkyEngine(perf=PerfConfig(), config=CloudConfig(cloud_coverage=0.45),
                         sun=SunState(direction=(0.3, 0.25, -0.9)), device=dev)
    eng.render_frame(eyedirs, now=0.0)  # warm start
    torch.cuda.synchronize()

    now = 0.0
    by_stage = collections.defaultdict(list)
    print("tick stage update_sky_ms render_view_ms total_ms", flush=True)
    for i in range(70):
        now += 1 / 60
        st = stage_of(eng)
        up, view = tick(eng, eyedirs, now, torch)
        by_stage[st].append(up + view)
        print(f"{i} {st} {up:.2f} {view:.2f} {up + view:.2f}", flush=True)
    print(f"median tick by stage, ms ({card}):", flush=True)
    for st, v in by_stage.items():
        print(f"  {st}: {statistics.median(v):.2f} over {len(v)} tick(s)", flush=True)

    # One traced tick of each stage kind in the next cycle, from its boundary.
    while stage_of(eng) != "boundary":
        now += 1 / 60
        tick(eng, eyedirs, now, torch)
    traced = set()
    print(f"one traced tick per stage ({card}):", flush=True)
    while stage_of(eng) != "steady" or "steady" not in traced:
        now += 1 / 60
        st = stage_of(eng)
        if st in traced:
            tick(eng, eyedirs, now, torch)
            continue
        traced.add(st)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tick(eng, eyedirs, now, torch)
        ev = device_events(prof)
        dev_ms = sum(e.time_range.elapsed_us() for e in ev) / 1e3
        print(f"  {st}: {len(ev)} launches, {dev_ms:.2f} ms device", flush=True)

    # Ten steady ticks, untraced then traced.
    while stage_of(eng) != "steady":
        now += 1 / 60
        tick(eng, eyedirs, now, torch)
    plain = []
    for _ in range(STEADY):
        now += 1 / 60
        up, view = tick(eng, eyedirs, now, torch)
        plain.append(up + view)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(STEADY):
            now += 1 / 60
            tick(eng, eyedirs, now, torch)
    ev = device_events(prof)
    if not ev:
        print("the profiler saw no device time", flush=True)
        return 1
    dev_ms = sum(e.time_range.elapsed_us() for e in ev) / 1e3 / STEADY
    tick_med = statistics.median(plain)
    print(f"steady ticks ({card}): unprofiled median {tick_med:.2f} ms; "
          f"device {dev_ms:.2f} ms and {len(ev) / STEADY:.0f} launches per tick; "
          f"device idle share {1 - dev_ms / tick_med:.3f}", flush=True)
    per_name = collections.defaultdict(float)
    for e in ev:
        per_name[e.name] += e.time_range.elapsed_us() / 1e3 / STEADY
    print("largest device kernels, ms per steady tick (share):", flush=True)
    for nm, v in sorted(per_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {v:.3f} ({v / dev_ms:.3f}) {nm[:110]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
