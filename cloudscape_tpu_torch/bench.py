"""Headline benchmark of the port: the full 1024×512 hemisphere re-render,
its referees and the serving point, on one CUDA card.

The counterpart of the repository's `bench.py` (JAX): run it as

    python -m cloudscape_tpu_torch.bench

It prints ONE JSON line with `bench.py`'s keys, plus `per_tile_arm_ms`.

- The headline is `march_bricks_v3` (ray cull, live-cell and hot-cell
  compaction from one stride-2 prepass) reading the per-cycle cone-density
  cache, with `v3_auto_policy`'s buckets; the cache build is timed apart as
  `cone_build_ms`, and `value_with_bake` is their sum.
- `quality_db_vs_exact` and `quality_db_vs_exact_high_coverage` (coverage
  0.7, with that scene's own policy and cone cache) hold the headline
  against the exact brick march (`march_bricks(chunk=32768,
  capacity_frac=0.2)`), by bench.py's PSNR: the peak is the exact image's
  largest |value|.
- The serving point is bench.py's: a fast3 `tile_cull` engine at
  `PerfConfig(768, 64, 128)`, coverage 0.35, the fused `render_frame` of a
  1280×720 view; one warm-start frame, 65 warm ticks, then 70 timed ticks
  across a cycle boundary. `per_tile_arm_ms` is the median timed tick of
  each tile arm the cycle took (`engine.tile_arm`).

Timing is device-complete: every timed call is followed by
`torch.cuda.synchronize()` and timed by the host's `time.perf_counter`.
The full readbacks are timed apart (`hemisphere_readback_ms`,
`per_tile_readback_ms`).

`per_tile_device_ms` is device-busy time, not a loop's wall time: the
union of the card's activity intervals in a `torch.profiler` trace of one
whole cycle of `render_frame` ticks (the tile, the prebake stage and the
composite of each), divided by the ticks; `fps_equivalent_device` is its
inverse. The JAX bench runs a cycle's tiles in one executable instead;
PyTorch has no such single dispatch. On a CPU run both are null: a CPU has
no device time.

Three keys differ from bench.py's: `vs_baseline` and
`vs_baseline_with_bake` are null (bench.py's 16 ms baseline is a TPU v5e
target, BASELINE.md), `device` is the card's name and power limit as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
them, and `quality_gate` names the port's test. Fields after the headline
are null when their capture fails (the error goes to stderr); the headline
itself raises. With `device="cuda"` and no card it raises: there is no CPU
fallback.
"""

from __future__ import annotations

import itertools
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from cloudscape_tpu_torch.utils.profiling import device_activities

WIDTH, HEIGHT = 1024, 512
STEPS = 128
CONE_RES = (32, 512, 512)
SUN = (0.3, 0.4, -0.85)
# The per-tile block's keys: all null when the block fails.
PER_TILE_KEYS = (
    "per_tile_kernel", "per_tile_finite", "per_tile_ms", "per_tile_max_ms",
    "per_tile_hitch", "per_tile_hitch_p95", "fps_equivalent",
    "per_tile_readback_ms", "per_tile_config", "tile_all_ms", "per_tile_arm_ms",
    "tile_bucket_hist", "per_tile_device_ms", "fps_equivalent_device")
# `per_tile_device_ms`: ticks a profiler session; the idle host time that
# opens and closes a session; and sessions tried a group. The profiler
# keeps a device activity only if its timestamp, converted to the host's
# clock, falls inside the session, and that conversion can run early (on
# an H100: after 330 s of chip_smoke.py by 0.1–0.4 s in the first session
# and 1.6–6.4 s by the third; once in a fresh process, 1.6–6.4 s in the
# seventh), losing a session's first activities: so the idle time that
# opens a session grows fourfold after each session that lost them.
TRACE_GROUP = 8
TRACE_MARGIN_S = 0.1
TRACE_TRIES = 5
# `torch.cuda._sleep`'s kernel: it opens and closes each traced group, so a
# session that lost the group's first or last activity is seen and traced
# again.
MARKER = "spin_kernel"


def hemisphere_dirs(width: int, height: int) -> np.ndarray:
    """Lat-long grid over the upper hemisphere: width azimuths × height
    elevations, y-up world frame — width*height independent rays."""
    az = (np.arange(width) + 0.5) / width * 2.0 * np.pi - np.pi
    el = (np.arange(height) + 0.5) / height * (np.pi / 2.0)
    cos_el = np.cos(el)[:, None]
    d = np.stack(
        [
            cos_el * np.cos(az)[None, :],
            np.broadcast_to(np.sin(el)[:, None], (height, width)),
            cos_el * np.sin(az)[None, :],
        ],
        axis=-1,
    )
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def view_dirs(width: int = 1280, height: int = 720) -> np.ndarray:
    """A 1280×720 pinhole camera looking at the horizon (the reference demo's
    window size, `project.godot`)."""
    xs = (np.arange(width) + 0.5) / width * 2.0 - 1.0
    ys = (np.arange(height) + 0.5) / height * 2.0 - 1.0
    d = np.stack(
        [
            np.broadcast_to(xs[None, :] * 0.84, (height, width)),  # ~80° hfov
            np.broadcast_to(-ys[:, None] * 0.47 + 0.25, (height, width)),
            np.full((height, width), -1.0),
        ],
        axis=-1,
    )
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def device_name(device) -> str:
    """The card's name and power limit (nvidia-smi's CSV line), or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but CUDA is not available")
    return dev


def sync(device) -> None:
    """Wait for the card's work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_ms(fn, device) -> tuple[float, object]:
    """(ms, result) of one device-complete fn() call."""
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return (time.perf_counter() - t0) * 1e3, out


def median_time(fn, device, reps: int = 5) -> tuple[float, list]:
    times = [timed_ms(fn, device)[0] for _ in range(reps)]
    return statistics.median(times), times


def psnr_vs_exact(out: np.ndarray, exact: np.ndarray) -> float:
    """bench.py's PSNR: the peak is the exact image's largest |value|."""
    peak = max(float(np.abs(exact).max()), 1e-9)
    mse = float(((out - exact) ** 2).mean())
    return 10.0 * math.log10(peak * peak / max(mse, 1e-20))


def scene_params(coverage: float, sun, device):
    """bench.py's scene at cloud coverage `coverage`, lit from the unit
    vector `sun`."""
    from cloudscape_tpu_torch.models.density import MarchParams

    return MarchParams.create(
        cloud_pos=np.array([1.5, -0.3]),
        detailed_pos=np.array([0.4, 0.2]),
        weather_pos=np.array([0.01, 0.02]),
        time=12.5,
        cloud_coverage=coverage,
        light_direction=sun,
        ground_color=np.array([0.27, 0.19, 0.027]),
        device=device,
    )


def run(device="cuda", *, width: int = WIDTH, height: int = HEIGHT,
        steps: int = STEPS, cone_res=CONE_RES, texture_size: int = 768,
        frames: int = 64, tile_steps: int = 128, timed_ticks: int = 70,
        view=(1280, 720), noise=None) -> dict:
    """bench.py's measurements on `device`, as one record (see the module
    docstring). The defaults are bench.py's sizes; the tests pass smaller
    ones. noise defaults to `reference_noise_pack` on the device."""
    from cloudscape_tpu_torch.models import atmosphere
    from cloudscape_tpu_torch.models.march_fast import (
        BrickPack, build_cone_cache, march_bricks, march_bricks_v3,
        ray_keep_fraction, v3_auto_policy)
    from cloudscape_tpu_torch.models.packs import reference_noise_pack

    dev = resolve_device(device)
    card = device_name(dev)
    if noise is None:
        noise = reference_noise_pack(device=dev)
    bricks = BrickPack.from_noise(noise)
    tlut = atmosphere.transmittance_lut(device=dev)
    sun = np.array(SUN)
    sun /= np.linalg.norm(sun)
    sky = atmosphere.sky_lut(tlut, torch.tensor(sun, dtype=torch.float32, device=dev))
    params = scene_params(0.35, sun, dev)
    dirs = torch.from_numpy(hemisphere_dirs(width, height)).to(dev)

    # The scene-adaptive buckets: the ray bucket from the prepass keep
    # fraction, the live-cell bucket from the coarse-cell occupancy within
    # kept rays, the hot-cell bucket from the pre > 0 fraction within live
    # cells.
    keep = float(ray_keep_fraction(dirs, params, bricks, steps=steps, ray_stride=2))
    ray_keep, cell_keep, hot_keep, cell_frac, hot_frac = v3_auto_policy(
        dirs, params, bricks, steps=steps)

    def build(p):
        return build_cone_cache(p, bricks, 6, res=cone_res, chunk=65536)

    cone = build(params)
    sync(dev)
    cone_ms, _ = median_time(lambda: build(params), dev, reps=3)

    def render(p, c, rk, ck, hk):
        return march_bricks_v3(dirs, p, bricks, sky, steps=steps, chunk=32768,
                               cell_keep_frac=ck, hot_keep_frac=hk, cone_cache=c,
                               ray_keep_frac=rk, ray_stride=2)

    def headline():
        return render(params, cone, ray_keep, cell_keep, hot_keep)

    out = headline().cpu().numpy()
    finite = bool(np.isfinite(out).all())
    clouds_frac = float((out[..., 3] > 0.1).mean())
    ms, all_ms = median_time(headline, dev)
    t0 = time.perf_counter()
    headline().cpu()
    readback_ms = (time.perf_counter() - t0) * 1e3 - ms

    # The headline is banked: every field below is null when its capture
    # fails.
    rec = {
        "metric": f"hemisphere_{width}x{height}_rerender",
        "value": ms,
        "unit": "ms",
        # bench.py's ratios are against a TPU v5e target (BASELINE.md).
        "vs_baseline": None,
        "vs_baseline_with_bake": None,
        "mrays_per_sec_per_chip": width * height / (ms * 1e-3) / 1e6,
        "march_steps": steps,
        "finite": finite,
        "clouds_frac": clouds_frac,
        "cone_build_ms": cone_ms,
        "cell_keep_frac": cell_keep,
        "hot_keep_frac": hot_keep,
        "cell_frac_measured": float(cell_frac),
        "hot_frac_measured": float(hot_frac),
        "ray_keep_frac": ray_keep,
        "ray_keep_measured": keep,
        "value_with_bake": ms + cone_ms,
        "hemisphere_readback_ms": max(readback_ms, 0.0),
        "quality_gate": "tests/test_torch_bench.py (v3 vs exact within 0.5 dB of "
                        "JAX's); chip_smoke.py phase 14 (>= 40 dB on the card)",
        "device": card,
        "all_ms": all_ms,
    }

    def exact(p):
        return march_bricks(dirs, p, bricks, sky, steps=steps, chunk=32768,
                            capacity_frac=0.2).cpu().numpy()

    try:
        rec["quality_db_vs_exact"] = psnr_vs_exact(out, exact(params))
    except Exception as e:
        print(f"quality capture failed: {e!r}", file=sys.stderr)
        rec["quality_db_vs_exact"] = None

    try:
        params_hc = scene_params(0.7, sun, dev)
        rk_h, ck_h, hk_h, _, _ = v3_auto_policy(dirs, params_hc, bricks, steps=steps)
        out_hc = render(params_hc, build(params_hc), rk_h, ck_h, hk_h).cpu().numpy()
        rec["quality_db_vs_exact_high_coverage"] = psnr_vs_exact(out_hc, exact(params_hc))
        rec["high_coverage_policy"] = [rk_h, ck_h, hk_h]
    except Exception as e:
        print(f"high-coverage quality capture failed: {e!r}", file=sys.stderr)
        rec["quality_db_vs_exact_high_coverage"] = None
        rec["high_coverage_policy"] = None

    try:
        _per_tile_metrics(rec, dev, sun, noise, cone_res, texture_size, frames,
                          tile_steps, timed_ticks, view)
    except Exception as e:
        print(f"per-tile metrics failed: {e!r}", file=sys.stderr)
        for k in PER_TILE_KEYS:
            rec.setdefault(k, None)
    return rec


def serving_engine(dev, sun, noise, cone_res=CONE_RES, texture_size: int = 768,
                   frames: int = 64, tile_steps: int = 128):
    """bench.py's serving engine: fast3 `tile_cull` at `PerfConfig(texture_size,
    frames, tile_steps)`, coverage 0.35, lit from the unit vector `sun`.
    Raises if it fails its validation."""
    from cloudscape_tpu_torch import CloudConfig, PerfConfig, SunState
    from cloudscape_tpu_torch.engine import CloudSkyEngine

    eng = CloudSkyEngine(
        perf=PerfConfig(texture_size=texture_size, frames_to_update=frames,
                        march_steps=tile_steps),
        config=CloudConfig(cloud_coverage=0.35, sun_disk_scale=2.0, wind_speed=10.0,
                           ground_color=(0.27, 0.19, 0.027, 1.0)),
        sun=SunState(direction=tuple(sun)), noise=noise, kernel="fast3",
        cone_res=cone_res, tile_cull=True, device=dev)
    if not eng.can_run:
        raise RuntimeError("the serving engine failed its validation")
    return eng


def _per_tile_metrics(rec: dict, dev, sun, noise, cone_res, texture_size: int,
                      frames: int, tile_steps: int, timed_ticks: int, view) -> None:
    """The amortized operating point at the reference's shipped defaults;
    fills rec in place, so a failure leaves the headline intact."""
    from cloudscape_tpu_torch.engine import tile_arm

    eng = serving_engine(dev, sun, noise, cone_res, texture_size, frames, tile_steps)
    eye = torch.from_numpy(view_dirs(*view)).to(dev)
    rec["per_tile_kernel"] = eng.kernel
    frame = eng.render_frame(eye, now=0.0)  # the warm start
    rec["per_tile_finite"] = bool(torch.isfinite(frame).all())
    # One warm cycle, then a timed window that crosses one boundary.
    n_warm = frames + 1
    for i in range(1, 1 + n_warm):
        eng.render_frame(eye, now=i / 60.0)
    sync(dev)
    tile_times, arms = [], []
    for i in range(1 + n_warm, 1 + n_warm + timed_ticks):
        ms, _ = timed_ms(lambda: eng.render_frame(eye, now=i / 60.0), dev)
        tile_times.append(ms)
        # The tick marched tile frame - 1 of the cycle's row-major sweep.
        arms.append(tile_arm(eng.kernel, eng._tile_buckets[eng.ring.frame - 1],
                             eng.perf.update_region_size ** 2))
    per_tile_ms = statistics.median(tile_times)
    per_tile_max_ms = max(tile_times)
    p95 = sorted(tile_times)[int(len(tile_times) * 0.95)]
    t0 = time.perf_counter()
    eng.render_frame(eye, now=(n_warm + timed_ticks + 5) / 60.0).cpu()
    rec["per_tile_readback_ms"] = (time.perf_counter() - t0) * 1e3
    rec["per_tile_ms"] = per_tile_ms
    rec["per_tile_max_ms"] = per_tile_max_ms
    rec["per_tile_hitch"] = per_tile_max_ms / per_tile_ms
    rec["per_tile_hitch_p95"] = p95 / per_tile_ms
    rec["fps_equivalent"] = 1000.0 / per_tile_ms
    rec["per_tile_config"] = (f"{texture_size}px_{frames}frames_{tile_steps}steps_"
                              f"fused_{view[0]}x{view[1]}_tilecull")
    rec["tile_all_ms"] = tile_times
    rec["per_tile_arm_ms"] = {
        a: statistics.median(t for t, b in zip(tile_times, arms) if b == a)
        for a in sorted(set(arms))}
    buckets = list(eng._tile_buckets or [1.0] * frames)
    rec["tile_bucket_hist"] = {str(b): buckets.count(b) for b in sorted(set(buckets))}

    if dev.type != "cuda":  # a CPU has no device time
        rec["per_tile_device_ms"] = rec["fps_equivalent_device"] = None
        return
    try:
        later = itertools.count(n_warm + timed_ticks + 6)

        def tick():
            eng.render_frame(eye, now=next(later) / 60.0)

        busy_ms, _ = device_busy_ms(tick, frames)
        rec["per_tile_device_ms"] = busy_ms / frames
        rec["fps_equivalent_device"] = frames / busy_ms * 1000.0
    except Exception as e:
        print(f"device-busy metric failed: {e!r}", file=sys.stderr)
        rec["per_tile_device_ms"] = rec["fps_equivalent_device"] = None


def busy_us(events) -> tuple[float, int]:
    """(µs, activities) of a traced group: the union of the intervals of the
    device activities between the first and the last MARKER kernel (each
    with `.name` and `.time_range.start` / `.end` in µs). Raises ValueError
    unless the group opens and closes with a marker and holds an activity
    between them: the profiler then lost the group's first or last
    activities, or saw none."""
    events = sorted(events, key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(events) if MARKER in e.name]
    if len(marks) != 2 or marks[0] != 0 or marks[1] != len(events) - 1:
        raise ValueError(f"the trace holds markers at {marks} of {len(events)} "
                         f"activities, not at both ends")
    inner = events[1:-1]
    if not inner:
        raise ValueError("the trace holds no device activity between its markers")
    total, end = 0.0, -math.inf
    for e in inner:
        start, stop = e.time_range.start, e.time_range.end
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total, len(inner)


def device_busy_ms(tick, n: int, group: int = TRACE_GROUP) -> tuple[float, list]:
    """(device-busy ms, [(µs, activities) a group]) of n tick() calls on
    the current card, traced by torch.profiler in sessions of `group` calls
    (`busy_us`); a session that lost activities is traced again on the
    next calls, opened by four times the idle time, TRACE_TRIES times in
    all."""
    from torch.profiler import ProfilerActivity, profile

    groups, i, lead = [], 0, TRACE_MARGIN_S
    while i < n:
        size = min(group, n - i)
        for attempt in range(1, TRACE_TRIES + 1):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                time.sleep(lead)
                torch.cuda._sleep(1000)
                for _ in range(size):
                    tick()
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                time.sleep(TRACE_MARGIN_S)
            try:
                groups.append(busy_us(device_activities(prof.events())))
                break
            except ValueError as e:
                print(f"device trace of calls {i}..{i + size - 1}, try {attempt} "
                      f"(opened by {lead:g} s): {e}", file=sys.stderr)
                lead *= 4
                if attempt == TRACE_TRIES:
                    raise RuntimeError(f"{TRACE_TRIES} traces of calls {i}.. lost "
                                       f"device activity") from e
        i += size
    return sum(us for us, _ in groups) / 1e3, groups


def main() -> None:
    print(json.dumps(run()), flush=True)


if __name__ == "__main__":
    main()
