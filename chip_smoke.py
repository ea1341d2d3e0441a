#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and exits nonzero; there is no CPU path):

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from cloudscape_tpu_torch/csrc with nvcc (sm_90a);
3. K1 (accumulate) against its plain version at the serving tile's shape
   [9216, 128] and at the shapes of K1_CASES (planes off 16-B alignment and
   102 or 30 steps, which take the scalar loads; 100 steps; one ray; a
   partly empty last block; 64, 16 and 256 steps), atol 2e-5, with empty
   and below-horizon rays exactly 0 (phase 9 adds config 4's [kept rays,
   64]);
4. K2 (compact) against its plain version, bitwise, with and without rank,
   at the cone-occupancy finalize's shape (8,388,608 cells, capacity
   3,801,088), plus empty, full and overflow masks, a length that is no
   multiple of 128, views at byte offsets 3 and 4, uint8 values, masks of
   one and two blocks' ranges, capacity 0, one and no elements and 40 M
   elements (more than the blocks' shared memory holds); then K4–K6
   (noise) against their plain versions at the shipped sizes
   (base 128³, detail 32³, weather 512², seed 0) and at sizes that are
   not powers of two (48³, 20³, 100², seed 7), atol 2e-5; and the
   engines' validation probe, which must launch K1–K3 once each;
5. the default engine (fast3, 768² / 64 frames / 128 steps / 6 light
   steps, cone cache (32, 512, 512), procedural_noise_pack(0), which K4–K6
   generate) on the card:
   construction and a first render_frame (warm start), then 70 more
   render_frame ticks of a 1280×720 camera (the fused display-pair path,
   `render_frame`'s default), crossing a
   cycle boundary that picks up a prebaked cone cache; the launch counts of
   K1, K2 and K4–K6 must show the path ran through those kernels; frames
   must be finite, nonnegative and not black, and the cloud ring must hold
   clouds;
6. K3 (segscan) against its plain version, atol 2e-4, 1-D and batched
   ([k, n]: k rows over one row of heads): at the phase-5 engine's v3
   hot-list capacity (random heads, one segment over every block, every
   element its own segment — bitwise), a ragged length, views off 16-B
   alignment, segments ~1 M long over ~490 blocks, one element; [3, n]
   random heads, [3, 1,000,003] (rows off alignment), [4, n] one segment,
   [1, n], and [2, 6,000,001] (ranges beyond the stash). Every case runs
   three times with bitwise-equal outputs, and each batched row equals
   the 1-D call on that row bitwise;
7. the full-hemisphere re-render of the phase-5 engine
   (`render_full_hemisphere`: v3 march at 768² × 128 steps, policy from
   `_v3_policy`): finite, K3 launched ≥ 2 (the 1-D log-transmittance
   scan and the [3, n] radiance scan) and K2 ≥ 3 times in the call,
   ≥ 30 dB against the dense march (`march_tile_dense`) over the same
   texel directions with the same cone cache and params (`V3_ENGINE_DB`
   says why not 40), and with every gate off ≥ 100 dB;
   7b. the composite traced on its own, on the phase-5 engine's state at
   1280×720: the split `composite` (`render_view`) and `composite_display`
   over the display-pair tables (CUDA-event ms, torch.profiler device ms
   and device launches a call; the two agree at atol 2e-5 / rtol 1e-5),
   and `_build_display_pair` (paid once a cycle);
8. the bench.py headline scene: 1024×512 hemisphere rays × 128 steps,
   coverage 0.35 and 0.7, sun (0.3, 0.4, −0.85), cone (32, 512, 512),
   procedural_noise_pack(0), `v3_auto_policy`, then
   `march_bricks_v3(chunk=32768, ray_stride=2)`: cone-build ms, the median
   of 5 renders, ≥ 40 dB against the dense march at both coverages; and
   bench.py's referee, the exact brick march (`march_bricks(chunk=32768,
   capacity_frac=0.2)`, no cone cache; its ms): v3 against it at
   ≥ V3_EXACT_DB (`quality_db_vs_exact` at 0.35,
   `quality_db_vs_exact_high_coverage` at 0.7), the dense march against it
   at ≥ EXACT_DENSE_DB, and its compaction (67,108,864 samples →
   13,434,880 slots) held bitwise against K2's plain version;
9. bench/sweep.py config 4, fully procedural: `procedural_noise_pack(0)`
   generated by K4–K6 (its ms), 512×256 hemisphere rays × 64 steps, sun
   (0.3, 0.4, −0.85), coverage 0.35, cone (32, 512, 512); the v2 render
   with `v2_auto_policy` buckets (`march_bricks_v2(chunk=32768,
   ray_stride=2)`, median of 3) and the v3 row (`v3_auto_policy`,
   `march_bricks_v3`), both ≥ 40 dB against the dense march, v2 with every
   gate off ≥ 100 dB; K1 and K2 launched in the v2 call, K3 ≥ 2 times in
   the v3 one;
   9b. bench/sweep.py config 5 (`run_config5`): `reference_noise_pack(seed=0)`
   (procedural where the reference's BMPs are absent), 2048×1024
   hemisphere rays × 128 adaptive steps, coarse 32, 4 row bands, the
   sweep's scene and a (32, 512, 512) cone cache; the v1 row
   (`march_hierarchical_banded`, capacity 0.08), the v3 row
   (`hier_v3_auto_policy` + `march_hierarchical_v3_banded`) and the v3flat
   row (per-band `v3_auto_policy` + `march_bricks_v3`), each the median of
   3 after a warm call; v1 and v3 ≥ C5_DB against a 512-step exact march
   on every 4th row and column; the kernel launches of each call of the
   path (the pack, the cone cache, each policy, each row's warm call)
   counted on their own; one band of each row marched again with its K2
   and K3 calls recorded and held against their plain versions;
10. a `kernel="fast2"` engine at PerfConfig() (every tile through the v2
   march): warm start, 20 render_frame ticks that launch K1 and K2, clouds
   in the ring, `render_full_hemisphere` (v2 over the map) ≥ 40 dB against
   the dense march;
11. a fast3 engine at PerfConfig(768, 4), whose 384² tiles (147,456 rays)
   take the v2 arm: warm start, one cycle and a boundary, K1 and K2
   launched by the ticks, frames finite and not black;
   11b. bench.py's serving point (`bench.py:272-323`): a fast3
   `tile_cull=True` engine at 768² / 64 frames / 128 steps, cone (32, 512,
   512), coverage 0.35, sun (0.3, 0.4, −0.85), procedural_noise_pack(0),
   served through the fused `render_frame` of the phase-5 camera: the warm
   start, 65 warm ticks, then 70 ticks timed by CUDA events that cross one
   rotation boundary, which must pick up the prebaked buckets; median,
   max, hitch (max / median), hitch_p95, the bucket histogram and the
   median tick per arm (skip / v3 bucket / dense 1.0) beside phase 5's
   median. The kernel counts are zeroed before its construction: K4–K6
   once each, K1 in the phase, K2 and K3 within the timed ticks, and at
   least one timed tick in a v3 bucket; frames finite, nonnegative and not
   black, every skip tile in the ring exactly 0. Then every tile of the
   cycle is marched again by its arm (those the ticks wrote must equal the
   ring's) and the culled map is held at ≥ TILE_CULL_DB against the dense
   march over the same texel grid; the first v3 tile's K2 and K3 calls are
   recorded, held against their plain versions (K2 bitwise, K3 atol 2e-4,
   three runs bitwise equal) and timed in phase 13;
   11c. a `kernel="fast"` engine (every tile through the exact brick
   march) at PerfConfig() on the phase-5 scene: warm start, 10
   render_frame ticks of the phase-5 camera that launch K2, frames finite,
   nonnegative and not black, clouds in the ring; one more tick whose
   tile compaction (1,179,648 → 589,824) is recorded and held bitwise
   against K2's plain version; `render_full_hemisphere`
   (the exact march over the map) finite, its compaction (75,497,472 →
   37,748,736) held bitwise against K2's plain version, and a second call,
   timed, bitwise equal to the first;
   11d. the scan march `march` (the "reference" kernel's) over the 768²
   texel grid at 128 steps with the phase-5 engine's params, pack and sky
   image: ms by CUDA events, device launches and ms per call by
   torch.profiler (from a 1- and a 2-step march: the steps are alike), and
   `march_bricks` on the same inputs ≥ 40 dB from it;
   11e. a `kernel="hier"` engine at PerfConfig() on the phase-5 scene:
   `can_run`, the warm start, 20 fused ticks within a cycle and 70 across
   a boundary (CUDA events), K2 and K3 launched by the ticks, frames
   finite, nonnegative and not black, clouds in the ring, and its
   4-band `render_full_hemisphere` ≥ V3_ENGINE_DB against the dense march;
   11f. (run after phase 8, on the phase-5 engine) `save_file` →
   `load_file` into a new engine (rings and the cone table bitwise, the
   next fused tick's frame and rings bitwise), `render_radiance_map(32)` sharp and
   prefiltered (finite, nonnegative, +Y brighter than −Y, the solid
   angles against 4π), and `set_performance(PerfConfig(384, 16))` on a
   new fast3 engine with the warm re-init that fills its ring;
   11g. the mesh (`run_mesh`): `render_hemisphere_sharded` at 768² × 128
   steps on `make_mesh(["cuda:0"] * 4)` (fast3 ≥ 60 dB from the
   single-card v3, K2 and K3 launched at least once a shard; fast2 at atol
   1e-6 from the single v2; 2 shards against 4 reported), the v3 prepass
   on 4 shards bitwise the unsharded one, the scan march sharded at 768² ×
   16 steps bitwise the single march and `full_frame_step_sharded`'s
   psum'd mean luminance at rtol 1e-6; a fast3 `tile_cull` engine at
   `PerfConfig()` on the 4-shard mesh in lockstep with a single-card twin
   for 70 `render_frame` ticks across a boundary (equal buckets, dense
   and skip tiles within atol 1e-6, rings ≥ 35 dB apart and a v3 tile at
   capacity 1.0 on the shards ≥ 100 dB from the card's, K1–K3 launched,
   the split path, medians by CUDA events beside a `StageTimer`); and a
   mixed [cuda:0, cpu] mesh's v3 render and tiny culled engine ≥ 50 dB
   from the CPU's (the engine's twin on a [cpu, cpu] mesh);
12. the fast3, fast2 and hier engines at a tiny size, without and with
   tile cull, and the fast and reference engines, on the card and on the CPU
   (where the wrappers take their plain versions): ring, view and
   (unculled) `render_full_hemisphere` ≥ 50 dB apart; and on the card,
   but for the reference engine, the fused `render_frame` against
   `update_sky` + `render_view` over 16 ticks across a boundary, frames at
   atol 2e-5 / rtol 1e-5, rings bitwise;
13. each kernel's device time with a cold L2 (`device_us`: torch.profiler
   over the last 20 complete calls of 40, which must be alike, a 64 MB
   read between them; and again with a 64 MB
   overwrite between them, `device_us_write_flush`) beside its bound (bytes
   over 3.35 TB/s or instructions over 33.5 T/s) at the shapes the paths
   above gave it: K1 [9216, 128] and config 4's [kept rays, 64]; K2 at the
   finalize's shape without rank (as the path asks) and with it (as v2's
   compaction asks) and at the compactions of one
   phase-7 re-render and of one phase-11b v3 tile, recorded as they ran
   (and held bitwise against the plain version there), and at the
   compactions of phase 8's referee (coverage 0.35) and phase 11c's
   whole map and tile, and of one band of each config-5 row (phase 9b),
   which serve the referee, the unstaged fast kernel and config 5, not the
   default engine, and so enter no pass;
   K3 1-D and [3, n] (one launch each) at the engine's and the headline's
   hot-list capacities and on the v3 tile's and config 5's recorded
   inputs;
   K4–K6 at the shipped sizes; K2's library yardstick,
   `torch.nonzero(mask).view(-1)` on the finalize's mask (CUDA events,
   its host synchronisation included). Then the ranking, launches per
   pass × (device time − bound), each launch at the time of the shape it
   ran at (K3: one 1-D and one [3, n] launch per v3 march), a JSON line
   with the kernels (each with `redesigned_in`, the change that
   redesigned it for the card, or null), and as the last line
   {"ok": true, "device": {...}}.

The kernels line's launch counts are read around the path each kernel
serves: K1 and K2 around phase 5, K3 around phases 7 and 8, K4–K6 around
phase 5's engine construction and config 4's pack; `launches_tile_cull`
around phase 11b; `launches_config5` by each call of config 5's path in
phase 9b (the pack, the cone cache, the two policies, each row's warm
call: zeroed just before the call, read just after); and
`launches_hier_engine` around phase 11e (the counts zeroed before each);
`launches_mesh` by phase 11g's mesh path (zeroed at its start, every
sharded call and the mesh engine read around the call, the single-card
references left out) and `launches_mesh_ticks` by its 70 mesh ticks.
`launches_per_pass` counts one pass: phase 5, phase 7's first
render_full_hemisphere and phase 11b's timed window, without the one
launch of K1–K3 of phase 5's validation probe (a tiny input, not a pass's
shape). Every engine the script builds must pass its validation
(`can_run`).

The process pins itself to one card (the first of CUDA_VISIBLE_DEVICES, or
card 0) before CUDA starts, so the device count it reports is the one card
it ran on.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# Ticks of the engine phase: more than one 64-frame cycle, so a boundary
# picks up a prebaked cone cache.
TICKS = 70
# The bench.py headline: hemisphere rays, march steps, cone-cache grid.
WIDTH, HEIGHT, STEPS = 1024, 512, 128
CONE_RES = (32, 512, 512)
# Gate of the engine's v3 render against the dense march. The JAX
# reference's own v3 policy misses 40 dB on the engine's octahedral texel
# grid: on the CPU, at 192² and coverage 0.45, JAX's v3 against JAX's dense
# march reaches 31.71 dB and the port matches JAX's render at 88 dB; on the
# card at 768² the port measured 33.66 dB. The loss is the reference's cell
# gate (with every gate off the port meets the dense march at ~159 dB), so
# the gate here is 30 dB, and the gates-off render is held at 100 dB.
V3_ENGINE_DB = 30.0
# Gates of the headline v3 render against bench.py's referee, the exact
# brick march (bench.py's record names 40 dB), and of the dense march (the
# cone-cache lookup in place of the sun march) against the referee. On the
# card v3 measured 42.10 / 41.96 dB and the dense march 48.07 / 42.48 dB at
# coverage 0.35 / 0.7 (NVIDIA H100 80GB HBM3, 700.00 W).
V3_EXACT_DB = 40.0
EXACT_DENSE_DB = 40.0
# Yardsticks of a kernel's bound (the H100 SXM's published peak rates):
# HBM at 3.35 TB/s, and 32-bit ALU instructions at 33.5 T/s, the
# float32 peak of 67 TFLOP/s counted as one instruction per FMA (132 SMs x
# 128 lanes x 1.98 GHz; the integer instructions of the noise kernels issue
# through the same 128 lanes).
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12 / 2
# Between timed calls a 64 MB tensor is read (a dot product with itself),
# so the 50 MB L2 holds none of a kernel's inputs, only clean lines, and HBM
# is the right yardstick. Overwriting the tensor instead (`zero_`) leaves
# the L2 full of dirty lines, and the timed kernel then pays for writing
# them back as it pulls its inputs in; each row also carries that time
# (`device_us_write_flush`), which is what the kernels were first measured
# with.
L2_FLUSH_BYTES = 64 << 20
# 32-bit instructions per lattice point of csrc/noise.cu, counted from its
# source: a PCG3D hash is 9 IMADs and 3 shift-xor pairs (15), its three
# to_unit conversions (shift, I2F, FMUL) 9 more; a Worley neighbour adds its
# offset, squared distance and min (10); a Perlin corner adds the gradient
# remap (3), its norm (3 + ~7 for the IEEE sqrtf), three IEEE divisions
# (~8 each), the dot product and the trilinear weight (~9).
WORLEY_NEIGHBOUR_OPS = 34
PERLIN_CORNER_OPS = 70
# (Perlin corners, Worley neighbours) per texel: K4 7 octaves x 8 corners and
# four 3-octave Worley FBMs x 27 neighbours; K5 three Worley octaves; K6
# 4 + 4 + 5 Perlin octaves.
NOISE_LATTICE = {"base": (56, 324), "detail": (0, 81), "weather": (104, 0)}
# Bytes per texel written, and dimensions: [n]^3 x 4, [n]^3 x 3, [n]^2 x 3.
NOISE_OUT = {"base": (16, 3), "detail": (12, 3), "weather": (12, 2)}
# The change (its number in PERF.md §6's Findings) that redesigned each
# kernel for the card after its first port; the ranking marks those.
REDESIGNED_IN = {"accumulate": 4, "compact": 4, "segscan": 5}
# Device kernel names of each wrapper, for picking its launches out of a
# profiler trace.
KERNEL_NAMES = {
    "accumulate": ("accumulate_kernel",),
    "compact": ("compact_kernel",),
    "segscan": ("segscan_kernel",),
    "noise_base": ("base_kernel",),
    "noise_detail": ("detail_kernel",),
    "noise_weather": ("weather_kernel",),
}


def require(cond, msg: str) -> None:
    """Fail the run (a check that `python -O` keeps)."""
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_time_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over `reps` runs after one warm-up, by CUDA
    events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_us(nbytes: int, ops: int = 0):
    """(µs, what bounds it): the least time the card could take, the larger
    of `nbytes` over the HBM rate and `ops` over the ALU rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e6
    by_ops = ops / ALU_OPS_PER_S * 1e6
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def accum_bytes(n: int, steps: int) -> int:
    """K1 reads three [n, steps] f32 planes, phase (f32), above (u8) and 12
    scalars once and writes [n, 4] f32."""
    return 12 * n * steps + 5 * n + 48 + 16 * n


def compact_bytes(n: int, capacity: int, with_rank: bool) -> int:
    """K2 reads the u8 mask once and writes idx [capacity] and, when asked,
    rank [n] (int32)."""
    return n + 4 * capacity + (4 * n if with_rank else 0)


def noise_work(name: str, size: int):
    """(bytes written, instructions) of one K4–K6 call at `size`: they read
    nothing, and their instructions are counted from csrc/noise.cu
    (NOISE_LATTICE)."""
    per_texel, dims = NOISE_OUT[name]
    texels = size ** dims
    corners, neighbours = NOISE_LATTICE[name]
    return texels * per_texel, texels * (corners * PERLIN_CORNER_OPS
                                         + neighbours * WORLEY_NEIGHBOUR_OPS)


# After the engine phases the profiler has been seen to lose a trace's
# first device events (on an H100: the first 2-3 of 20 calls of every
# phase-13 trace, once the first 5 calls and the next call's flush, once
# the first 9 calls and also the last call's kernel, once the first 25 of
# 40). So `device_us` runs TRACE_WARM calls in the profiler's warm-up step
# (traced, then discarded), profiles TRACE_PAD calls ahead of the measured
# ones and drops them, and traces again, up to TRACE_TRIES times in all,
# while the kept calls are not alike.
TRACE_WARM = 5
TRACE_PAD = 20
TRACE_TRIES = 3


def device_us(fn, names, write_flush: bool = False, reps: int = 20):
    """Device time of one fn() call with a cold L2, from torch.profiler.

    Runs TRACE_WARM calls in the profiler's warm-up step, then traces
    TRACE_PAD + `reps` calls, each after reading (or, with `write_flush`,
    overwriting) an L2-sized scratch tensor, picks out of the trace the
    device kernels whose names are in `names` (the flush's kernels between
    two calls separate them) and keeps the last `reps` complete calls,
    which must be alike (else it traces again, TRACE_TRIES times in all).
    Per call: `span_us` from the first kernel's start to the last
    one's end (the gaps between a multi-pass kernel's launches count) and
    `sum_us` the kernels' own times; the medians over the calls. If the
    profiler sees no device activity, each call is captured once in a CUDA
    graph and its replays are timed by CUDA events instead (`how` says
    which)."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    pat = re.compile(r"(?:^|[\s:])(?:%s)[<(]" % "|".join(map(re.escape, names)))
    scratch = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")

    def flush():
        if write_flush:
            scratch.zero_()
        else:
            torch.dot(scratch, scratch)

    def trace():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for n in (TRACE_WARM, TRACE_PAD + reps):
                for _ in range(n):
                    flush()
                    fn()
                torch.cuda.synchronize()
                prof.step()
        return sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                      key=lambda e: e.time_range.start)

    fn()
    for attempt in range(1, TRACE_TRIES + 1):
        events = trace()
        if not events:
            break
        # Only a leading prefix and a trailing suffix of the trace may be
        # lost: past its trailing flushes (a last call whose kernel was
        # lost), its tail must be `reps` alike call groups, each two
        # separated by alike flush groups, so no lost event in the middle
        # merges two calls into one.
        seq = "".join("k" if pat.search(e.name) else "." for e in events)
        tail = re.findall(r"k+|\.+", seq.rstrip("."))[-(2 * reps - 1):]
        if len(tail) == 2 * reps - 1 and tail[-1][0] == "k" \
                and len(set(tail[0::2])) == 1 and len(set(tail[1::2])) == 1:
            break
        print(f"profiler: trace {attempt} of {names} kept no {reps} alike calls "
              f"between alike flushes; device events in order (k: the kernel's): "
              f"{seq}", flush=True)
    else:
        raise RuntimeError(f"profiler: {TRACE_TRIES} traces of {names} lost calls")
    if events:
        calls, cur = [], []
        for e in events:
            if pat.search(e.name):
                cur.append(e)
            elif cur:
                calls.append(cur)
                cur = []
        if cur:
            calls.append(cur)
        calls = calls[-reps:]
        spans = [max(e.time_range.end for e in c) - min(e.time_range.start for e in c)
                 for c in calls]
        sums = [sum(e.time_range.elapsed_us() for e in c) for c in calls]
        return dict(span_us=statistics.median(spans), sum_us=statistics.median(sums),
                    kernels=len(calls[0]), how="profiler")
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        fn()
    us = []
    for _ in range(reps):
        flush()
        us.append(events_ms(graph.replay, 1)[0] * 1e3)
    return dict(span_us=statistics.median(us), sum_us=statistics.median(us),
                kernels=None, how="cuda graph")


def timed_row(shape: str, fn, names, nbytes: int, ops: int = 0, **extra):
    """One row of the kernel table: device µs (cold L2) against the bound."""
    d = device_us(fn, names)
    b, by = bound_us(nbytes, ops)
    return dict(shape=shape, device_us=d["span_us"], kernel_sum_us=d["sum_us"],
                kernels_per_call=d["kernels"], timing=d["how"], bound_us=b,
                bound_by=by, bound_share=b / d["span_us"],
                device_us_write_flush=device_us(fn, names, write_flush=True)["span_us"],
                **extra)


def events_ms(fn, reps: int):
    """Each of `reps` calls of fn() timed by CUDA events (ms)."""
    import torch

    ms = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return ms


# K1 cases (rays, steps, float offset of each plane's base, what it covers).
K1_CASES = (
    (9216, 128, 0, "the serving tile"),
    (9216, 128, 1, "planes 4 B past 16-B alignment: scalar loads"),
    (9216, 100, 0, "100 steps: 16-byte loads, 25 of 32 lanes"),
    (9216, 102, 0, "102 steps: scalar loads"),
    (50, 30, 0, "steps no multiple of 4: scalar loads, 8 lanes per ray"),
    (1, 128, 0, "one ray"),
    (1001, 128, 0, "a partly empty last block"),
    (4097, 64, 0, "64 steps, two rays per warp, odd count"),
    (333, 16, 0, "16 steps, eight rays per warp"),
    (257, 256, 0, "two 128-step windows"),
)


def accum_args(dev, n: int, steps: int, offset: int = 0):
    """K1 inputs: 1/8 of the rays empty, 1/8 below the horizon, the rest
    with an optical depth that saturates alpha; each [n, steps] plane's base
    `offset` floats into its buffer."""
    import torch

    rng = np.random.default_rng(1)
    A = -np.abs(rng.random((n, steps))) * (12.8 / steps) \
        * (rng.random((n, steps)) < 0.3)
    A[: n // 8] = 0.0                                   # empty rays
    cd3 = -rng.random((n, steps)) * 0.5
    hf = rng.random((n, steps))
    phase = rng.random(n)
    above = np.ones(n, bool)
    above[n // 8: n // 4] = False                       # below the horizon
    scal = rng.random(12)

    def plane(x):
        flat = torch.zeros(offset + x.size, dtype=torch.float32, device=dev)
        flat[offset:] = torch.from_numpy(x.astype(np.float32).reshape(-1)).to(dev)
        return flat[offset:].view(x.shape)

    def vec(x, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(dev)

    return (plane(A), plane(cd3), plane(hf), vec(phase), vec(above, bool), vec(scal))


def check_accumulate(dev, n: int, steps: int, offset: int = 0) -> float:
    """Phase 3: K1 against its plain version at [n, steps]; returns the max
    abs error."""
    import torch

    from cloudscape_tpu_torch.ops import accum

    args = accum_args(dev, n, steps, offset)
    got = accum.accumulate(*args)
    want = accum.accumulate_reference(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    what = f"K1 [{n},{steps}] offset {offset}"
    require(got.shape == (n, 4) and bool(torch.isfinite(got).all()),
            f"{what}: output has the wrong shape or is not finite")
    require(err <= 2e-5, f"{what}: max abs err {err} > 2e-5")
    require(bool((got[: n // 4] == 0).all()), f"{what}: empty/below-horizon rays not 0")
    require(float(want[n // 4:, 3].max()) > 0.5, f"{what}: test input saturates nothing")
    return err


def time_accumulate(dev, n: int, steps: int):
    """K1's device µs and bound at [n, steps], and the wrapper's and the
    plain version's CUDA-event ms (20 back-to-back calls)."""
    from cloudscape_tpu_torch.ops import accum

    args = accum_args(dev, n, steps)
    row = timed_row(f"[{n},{steps}]", lambda: accum.accumulate(*args),
                    KERNEL_NAMES["accumulate"], accum_bytes(n, steps))
    row["event_ms"] = cuda_time_ms(lambda: accum.accumulate(*args))
    row["plain_ms"] = cuda_time_ms(lambda: accum.accumulate_reference(*args))
    return row


# The cone-occupancy finalize's compaction: cells and slots.
K2_N, K2_CAP = 8_388_608, 3_801_088


def check_compact(dev):
    """Phase 4: K2 against its plain version, bitwise, with and without
    rank; returns the finalize-shaped mask for the timings."""
    import torch

    from cloudscape_tpu_torch.ops import compact

    n, cap = K2_N, K2_CAP
    g = torch.Generator(device=dev).manual_seed(2)

    def rand(k):
        return torch.rand(k, generator=g, device=dev)

    cases = [
        ("sparse", rand(n) < 0.3, cap),
        ("overflow", rand(n) < 0.6, cap),
        ("empty", torch.zeros(n, dtype=torch.bool, device=dev), cap),
        ("full", torch.ones(n, dtype=torch.bool, device=dev), cap),
        ("ragged", rand(1_000_003) < 0.5, 300_000),
        ("view at offset 3", (rand(1_000_006) < 0.5)[3:], 400_000),
        ("view at offset 4", (rand(1_000_007) < 0.5)[4:], 400_000),
        ("uint8 values 0-3", torch.randint(0, 4, (65_539,), generator=g, device=dev,
                                           dtype=torch.uint8), 30_000),
        ("shorter than one block's range", rand(3_001) < 0.5, 2_000),
        ("two blocks", rand(5_000) < 0.5, 4_000),
        ("capacity 0", rand(100_000) < 0.5, 0),
        ("one set element", torch.ones(1, dtype=torch.bool, device=dev), 1),
        ("one unset element", torch.zeros(1, dtype=torch.bool, device=dev), 3),
        ("no elements", torch.zeros(0, dtype=torch.bool, device=dev), 5),
        # Beyond what the blocks' shared memory holds at once.
        ("40 M elements", rand(40_000_000) < 0.1, 4_500_000),
    ]
    for name, mask, c in cases:
        total = mask.shape[0]
        ridx, rrank = compact.compact_reference(mask, c, total)
        idx, rank = compact.compact(mask, c, total)
        torch.cuda.synchronize()
        require(torch.equal(idx, ridx), f"K2 idx differs ({name})")
        require(torch.equal(rank, rrank), f"K2 rank differs ({name})")
        idx, rank = compact.compact(mask, c, total, with_rank=False)
        torch.cuda.synchronize()
        require(rank is None, f"K2 returned a rank it was not asked for ({name})")
        require(torch.equal(idx, ridx), f"K2 idx differs without rank ({name})")
    return cases[0][1]


def time_compact(mask, capacity: int, with_rank: bool, plain: bool = False):
    """K2's device µs and bound on `mask`; with `plain`, the wrapper's and
    the plain version's CUDA-event ms."""
    from cloudscape_tpu_torch.ops import compact

    n = mask.shape[0]

    def call():
        compact.compact(mask, capacity, n, with_rank=with_rank)

    row = timed_row(f"{n}->{capacity}{'' if with_rank else ', no rank'}", call,
                    KERNEL_NAMES["compact"], compact_bytes(n, capacity, with_rank))
    if plain:
        row["event_ms"] = cuda_time_ms(call)
        row["plain_ms"] = cuda_time_ms(
            lambda: compact.compact_reference(mask, capacity, n, with_rank))
    return row


NOISE_CASES = (  # (kernel, generator, shipped size, a size not a power of two)
    ("base", "generate_base_noise", 128, 48),
    ("detail", "generate_detail_noise", 32, 20),
    ("weather", "generate_weather", 512, 100),
)


def check_noise(dev):
    """Phase 4: K4–K6 against their plain versions (the `ops/noise.py`
    generators run on the card), at the shipped size with seed 0 and at a
    size that is not a power of two with seed 7; times at the shipped
    size."""
    import torch

    from cloudscape_tpu_torch.ops import noise, noise_kernel

    rows = {}
    for name, fn, size, odd in NOISE_CASES:
        err = 0.0
        for n, seed in ((size, 0), (odd, 7)):
            got = getattr(noise_kernel, fn)(n, seed, dev)
            want = getattr(noise, fn)(n, seed, device=dev)
            torch.cuda.synchronize()
            require(got.shape == want.shape and bool(torch.isfinite(got).all()),
                    f"K4–K6 {name} {n}: wrong shape or not finite")
            e = float((got - want).abs().max())
            require(e <= 2e-5, f"K4–K6 {name} {n} seed {seed}: max abs err {e} > 2e-5")
            err = max(err, e)
        ms = cuda_time_ms(lambda: getattr(noise_kernel, fn)(size, 0, dev))
        plain_ms = cuda_time_ms(lambda: getattr(noise, fn)(size, 0, device=dev),
                                reps=3)
        rows[name] = dict(err=err, ms=ms, plain_ms=plain_ms)
    return rows


def bitwise_equal(a, b) -> bool:
    """Same shape and the same f32 bits (torch.equal alone takes -0 for +0)."""
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_segscan(dev, n_hot: int):
    """Phase 6: K3 against its plain version, 1-D and batched. Each case runs
    three times and the outputs must be bitwise equal; each row of a
    batched case must equal the kernel's 1-D call on that row bitwise (the
    plan's block ranges depend on n alone, so both add the same floats in
    the same order). Values of the long segments are scaled so their
    running sums stay O(1) and f32 rounding stays far below the gate.
    Returns the max abs error and the number of cases."""
    import torch

    from cloudscape_tpu_torch.ops import segscan

    g = torch.Generator(device=dev).manual_seed(3)

    def normal(shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def flags(k, p):
        return torch.rand(k, generator=g, device=dev) < p

    def none(k):
        return torch.zeros(k, dtype=torch.bool, device=dev)

    big = 6_000_001
    cases = [
        ("random heads", normal(n_hot), flags(n_hot, 0.1)),
        ("one segment", normal(n_hot, 1e-3), none(n_hot)),
        ("own segments", normal(n_hot), torch.ones(n_hot, dtype=torch.bool, device=dev)),
        ("ragged", normal(1_000_003), flags(1_000_003, 0.01)),
        ("views at offsets 1 and 3: scalar loads", normal(n_hot + 1)[1:],
         flags(n_hot + 3, 0.1)[3:]),
        # Segments ~1M long: the carry walks back over several chunks of
        # 32 blocks; each block's range fits its stash.
        ("many blocks", normal(big, 1e-3), flags(big, 1e-6)),
        ("one element", normal(1), none(1)),
        ("[3, n] random heads", normal((3, n_hot)), flags(n_hot, 0.1)),
        ("[3, n] ragged: rows off 16-B alignment", normal((3, 1_000_003)),
         flags(1_000_003, 0.01)),
        ("[4, n] one segment", normal((4, n_hot), 1e-3), none(n_hot)),
        ("[1, n]", normal((1, n_hot)), flags(n_hot, 0.1)),
        # Ranges beyond the stash: loaded and scanned again after the
        # grid barrier.
        ("[2, n] many blocks: no stash", normal((2, big), 1e-3), flags(big, 1e-6)),
    ]
    err = 0.0
    for name, v, h in cases:
        want = segscan.segscan_reference(v, h)
        runs = [segscan.segscan(v, h) for _ in range(3)]
        torch.cuda.synchronize()
        got = runs[0]
        require(got.shape == v.shape and bool(torch.isfinite(got).all()),
                f"K3 output has the wrong shape or is not finite ({name})")
        require(all(bitwise_equal(r, got) for r in runs[1:]),
                f"K3 outputs of three runs differ ({name})")
        e = float((got - want).abs().max())
        require(e <= 2e-4, f"K3 max abs err {e} > 2e-4 ({name})")
        if v.dim() == 2:
            for r in range(v.shape[0]):
                require(bitwise_equal(segscan.segscan(v[r], h), got[r]),
                        f"K3 row {r} differs from its 1-D call ({name})")
        if name == "own segments":
            require(bitwise_equal(got, v), "K3 not bitwise on one-element segments")
        err = max(err, e)
    return err, len(cases)


def time_segscan(dev, n: int, rows: int = 1, plain: bool = False):
    """K3's device µs and bound at n elements of `rows` rows ([n] for 1):
    the f32 rows and the u8 heads read once and the f32 rows written,
    (8·rows + 1)·n bytes; with `plain`, the wrapper's and the plain
    version's CUDA-event ms."""
    import torch

    g = torch.Generator(device=dev).manual_seed(4)
    v = torch.randn((rows, n) if rows > 1 else (n,), generator=g, device=dev)
    h = torch.rand(n, generator=g, device=dev) < 0.1
    return time_segscan_on(v, h, plain)


def time_segscan_on(v, h, plain: bool = False):
    """K3's device µs and bound on the values v ([n] or [rows, n]) and heads
    h; see `time_segscan`."""
    from cloudscape_tpu_torch.ops import segscan

    rows, n = (1, v.shape[0]) if v.dim() == 1 else tuple(v.shape)
    row = timed_row(f"N={n}" if v.dim() == 1 else f"[{rows},{n}]",
                    lambda: segscan.segscan(v, h), KERNEL_NAMES["segscan"],
                    (8 * rows + 1) * n, rows=rows)
    require(row["timing"] != "profiler" or row["kernels_per_call"] == 1,
            f"K3 {row['shape']} ran {row['kernels_per_call']} kernels in a call")
    if plain:
        row["event_ms"] = cuda_time_ms(lambda: segscan.segscan(v, h))
        row["plain_ms"] = cuda_time_ms(lambda: segscan.segscan_reference(v, h))
    return row


def check_recorded(what: str, compactions, scans=()) -> float:
    """K2 and K3 against their plain versions on the inputs a path gave
    them, recorded as it ran: K2 bitwise (idx, and rank where the path
    asked for it), K3 at atol 2e-4 with three runs bitwise equal. Returns
    K3's max abs error (0.0 without scans)."""
    import torch

    from cloudscape_tpu_torch.ops import compact, segscan

    for i, (mask, cap, with_rank) in enumerate(compactions):
        total = mask.shape[0]
        ridx, rrank = compact.compact_reference(mask, cap, total, with_rank)
        idx, rank = compact.compact(mask, cap, total, with_rank=with_rank)
        torch.cuda.synchronize()
        require(torch.equal(idx, ridx), f"K2 idx differs ({what}, call {i}: "
                f"{total}->{cap})")
        require(not with_rank or torch.equal(rank, rrank),
                f"K2 rank differs ({what}, call {i}: {total}->{cap})")
    err = 0.0
    for i, (v, h) in enumerate(scans):
        want = segscan.segscan_reference(v, h)
        runs = [segscan.segscan(v, h) for _ in range(3)]
        torch.cuda.synchronize()
        require(all(bitwise_equal(r, runs[0]) for r in runs[1:]),
                f"K3 outputs of three runs differ ({what}, call {i})")
        e = float((runs[0] - want).abs().max())
        require(e <= 2e-4, f"K3 max abs err {e} > 2e-4 ({what}, call {i})")
        err = max(err, e)
    return err


def loss_per_pass_us(groups) -> float:
    """The redesign rule's rank: launches per pass × (device µs − bound µs),
    summed over a kernel's (launches per pass, row) groups, each group's
    launches at the time of the shape they ran at."""
    return sum(n * (row["device_us"] - row["bound_us"]) for n, row in groups)


def time_nonzero(mask) -> float:
    """ms of `torch.nonzero(mask).view(-1)`, the one PyTorch call that gives
    K2's ordered index list (it neither truncates nor fills to a capacity),
    by CUDA events over 20 calls; nonzero synchronises with the host to
    size its output, and that wait is inside the time."""
    import torch

    return cuda_time_ms(lambda: torch.nonzero(mask).view(-1))


def time_noise(dev, name: str, fn: str, size: int):
    """K4–K6's device µs at `size` against the instruction count."""
    from cloudscape_tpu_torch.ops import noise_kernel

    return timed_row(f"{size}^{NOISE_OUT[name][1]}",
                     lambda: getattr(noise_kernel, fn)(size, 0, dev),
                     KERNEL_NAMES[f"noise_{name}"], *noise_work(name, size))


def hemisphere_dirs(width: int, height: int) -> np.ndarray:
    """Lat-long grid over the upper hemisphere (bench.py's): width azimuths ×
    height elevations, y-up world frame."""
    az = (np.arange(width) + 0.5) / width * 2.0 * np.pi - np.pi
    el = (np.arange(height) + 0.5) / height * (np.pi / 2.0)
    cos_el = np.cos(el)[:, None]
    d = np.stack([cos_el * np.cos(az)[None, :],
                  np.broadcast_to(np.sin(el)[:, None], (height, width)),
                  cos_el * np.sin(az)[None, :]], axis=-1)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def run_v3_engine(eng):
    """Phase 7: render_full_hemisphere on the phase-5 engine, with K2/K3
    counts around the call, against the dense march."""
    import torch

    from cloudscape_tpu_torch.models.march_fast import (
        march_bricks_v3, march_tile_dense, v3_capacities)
    from cloudscape_tpu_torch.ops import accum, compact, segscan
    from cloudscape_tpu_torch.ops.octmap import texel_directions
    from cloudscape_tpu_torch.utils.image import psnr

    perf = eng.perf
    torch.cuda.synchronize()
    k1_0, k2_0, k3_0 = accum.launches, compact.launches, segscan.launches
    t0 = time.perf_counter()
    out = eng.render_full_hemisphere()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    k1 = accum.launches - k1_0
    k2, k3 = compact.launches - k2_0, segscan.launches - k3_0
    # One 1-D log-transmittance scan and one [3, n] radiance scan a march.
    require(k3 >= 2, f"render_full_hemisphere launched K3 {k3} < 2 times")
    require(k2 >= 3, f"render_full_hemisphere launched K2 {k2} < 3 times")
    n_tex = perf.texture_size
    require(out.shape == (n_tex, n_tex, 4) and bool(torch.isfinite(out).all()),
            "render_full_hemisphere output has the wrong shape or is not finite")
    ms = events_ms(eng.render_full_hemisphere, 3)
    # One more call with its compactions recorded, for the K2 timings at
    # the re-render's own shapes.
    _, compactions, _ = record_kernels(eng.render_full_hemisphere)
    check_recorded("phase-7 re-render", compactions)
    rk, ck, hk = policy = eng._v3_policy(eng._march_params)
    ps, _ = eng._v3_march_knobs()
    n = n_tex * n_tex
    caps = v3_capacities(n, perf.march_steps, min(n, 32768), ck, rk, ps, hk)
    dense = march_tile_dense(
        texel_directions(n_tex, device=eng.device), eng._march_params,
        eng._bricks, eng.sky_ring[eng.ring.cloud_kernel_sky_slot],
        steps=perf.march_steps, light_steps=perf.light_steps, chunk=16384,
        cone_cache=eng._cone_cache)
    db = psnr(out.cpu().numpy(), dense.cpu().numpy())
    require(db >= V3_ENGINE_DB,
            f"render_full_hemisphere vs dense march {db:.2f} dB < {V3_ENGINE_DB}")
    # Every gate off: the v3 machinery alone must reproduce the dense march.
    off = march_bricks_v3(
        texel_directions(n_tex, device=eng.device), eng._march_params,
        eng._bricks, eng.sky_ring[eng.ring.cloud_kernel_sky_slot],
        steps=perf.march_steps, chunk=min(n, 32768), cell_keep_frac=1.0,
        hot_keep_frac=1.0, cone_cache=eng._cone_cache, prepass_steps=ps,
        ray_stride=2, cell_margin=1e9)
    off_db = psnr(off.cpu().numpy(), dense.cpu().numpy())
    require(off_db >= 100.0, f"gates-off v3 vs dense march {off_db:.2f} dB < 100")
    return dict(policy=policy, caps=caps, first_ms=first_ms,
                ms=statistics.median(ms), db=db, off_db=off_db, k1=k1, k2=k2, k3=k3,
                compactions=compactions,
                cloud_frac=float((out[..., 3] > 0.1).float().mean()))


def record_kernels(fn):
    """Run fn() with every K2 call of `models/march_fast.py` recorded as
    (mask, capacity, rank asked for) and every K3 call as (values, heads);
    returns (fn's result, the K2 calls, the K3 calls)."""
    from cloudscape_tpu_torch.models import march_fast

    compactions, scans = [], []
    real_c, real_s = march_fast.compact, march_fast.segscan

    def rec_c(mask, capacity, total, with_rank=True):
        compactions.append((mask.clone(), capacity, with_rank))
        return real_c(mask, capacity, total, with_rank)

    def rec_s(v, h):
        scans.append((v.clone(), h.clone()))
        return real_s(v, h)

    march_fast.compact, march_fast.segscan = rec_c, rec_s
    try:
        return fn(), compactions, scans
    finally:
        march_fast.compact, march_fast.segscan = real_c, real_s


def zero_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from cloudscape_tpu_torch.ops import accum, compact, noise_kernel, segscan

    accum.launches = compact.launches = segscan.launches = 0
    noise_kernel.launches = dict.fromkeys(noise_kernel.launches, 0)


def read_counts() -> dict:
    """Every kernel's launch count, by its name in the kernels line."""
    from cloudscape_tpu_torch.ops import accum, compact, noise_kernel, segscan

    return dict(accumulate=accum.launches, compact=compact.launches,
                segscan=segscan.launches,
                **{f"noise_{k}": v for k, v in noise_kernel.launches.items()})


def counted(fn):
    """(fn's result, the kernel launches of that one call): the counts are
    zeroed just before the call and read just after it."""
    import torch

    zero_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts()


def run_headline(dev):
    """Phase 8: the bench.py headline scene, coverage 0.35 (timed) and 0.7,
    with bench.py's referee, the exact brick march (`march_bricks(chunk=
    32768, capacity_frac=0.2)`, no cone cache): v3 against it
    (`quality_db_vs_exact`, and `_high_coverage` at 0.7) and against the
    dense march, and the referee against the dense march. The referee's K2
    calls are recorded and held bitwise against the plain version."""
    import torch

    from cloudscape_tpu_torch.models import atmosphere
    from cloudscape_tpu_torch.models.density import MarchParams
    from cloudscape_tpu_torch.models.march_fast import (
        BrickPack, build_cone_cache, march_bricks, march_bricks_v3,
        march_tile_dense, v3_auto_policy, v3_capacities)
    from cloudscape_tpu_torch.models.packs import procedural_noise_pack
    from cloudscape_tpu_torch.utils.image import psnr

    bricks = BrickPack.from_noise(procedural_noise_pack(0, device=dev))
    sun = np.array([0.3, 0.4, -0.85])
    sun /= np.linalg.norm(sun)
    sky = atmosphere.sky_lut(atmosphere.transmittance_lut(device=dev),
                             torch.tensor(sun, dtype=torch.float32, device=dev))
    dirs = torch.from_numpy(hemisphere_dirs(WIDTH, HEIGHT)).to(dev)
    rows = []
    for cov in (0.35, 0.7):
        params = MarchParams.create(
            cloud_pos=np.array([1.5, -0.3]), detailed_pos=np.array([0.4, 0.2]),
            weather_pos=np.array([0.01, 0.02]), time=12.5, cloud_coverage=cov,
            light_direction=sun, ground_color=np.array([0.27, 0.19, 0.027]),
            device=dev)
        rk, ck, hk, cell_frac, hot_frac = v3_auto_policy(dirs, params, bricks,
                                                         steps=STEPS)

        def build():
            return build_cone_cache(params, bricks, 6, res=CONE_RES, chunk=65536)

        cone = build()
        cone_ms = events_ms(build, 1)[0]

        def render():
            return march_bricks_v3(dirs, params, bricks, sky, steps=STEPS,
                                   chunk=32768, cell_keep_frac=ck,
                                   hot_keep_frac=hk, cone_cache=cone,
                                   ray_keep_frac=rk, ray_stride=2)

        out = render()
        ms = events_ms(render, 5 if cov == 0.35 else 1)
        require(bool(torch.isfinite(out).all()), f"headline v3 not finite (cov {cov})")
        dense = march_tile_dense(dirs, params, bricks, sky, steps=STEPS,
                                 light_steps=6, chunk=16384, cone_cache=cone)
        db = psnr(out.cpu().numpy(), dense.cpu().numpy())
        require(db >= 40.0, f"headline v3 vs dense {db:.2f} dB < 40 (cov {cov})")

        def referee():
            return march_bricks(dirs, params, bricks, sky, steps=STEPS,
                                chunk=32768, capacity_frac=0.2)

        # The first call, recorded, also warms the allocator to this size.
        exact, compactions, _ = record_kernels(referee)
        exact_ms = events_ms(referee, 1)[0]
        require(len(compactions) == 1 and compactions[0][0].numel() == WIDTH
                * HEIGHT * STEPS, f"the referee made {len(compactions)} K2 calls")
        check_recorded(f"the referee at coverage {cov}", compactions)
        require(bool(torch.isfinite(exact).all()), f"referee not finite (cov {cov})")
        exact_np = exact.cpu().numpy()
        db_exact = psnr(out.cpu().numpy(), exact_np)
        exact_dense_db = psnr(dense.cpu().numpy(), exact_np)
        require(db_exact >= V3_EXACT_DB,
                f"headline v3 vs exact {db_exact:.2f} dB < {V3_EXACT_DB} (cov {cov})")
        require(exact_dense_db >= EXACT_DENSE_DB, f"dense vs exact march "
                f"{exact_dense_db:.2f} dB < {EXACT_DENSE_DB} (cov {cov})")
        caps = v3_capacities(WIDTH * HEIGHT, STEPS, 32768, ck, rk, 32, hk)
        mask = compactions[0][0]
        rows.append(dict(cov=cov, policy=(rk, ck, hk), cell_frac=cell_frac,
                         hot_frac=hot_frac, caps=caps, cone_ms=cone_ms,
                         ms=statistics.median(ms), all_ms=ms, db=db,
                         db_exact=db_exact, exact_dense_db=exact_dense_db,
                         exact_ms=exact_ms, exact_compactions=compactions,
                         active=int(mask.sum()),
                         cloud_frac=float((out[..., 3] > 0.1).float().mean())))
    return rows


def run_config4(dev):
    """Phase 9: bench/sweep.py config 4 (fully procedural noise), v2 and v3
    rows, each against the dense march."""
    import torch

    from cloudscape_tpu_torch.models import atmosphere
    from cloudscape_tpu_torch.models.density import MarchParams
    from cloudscape_tpu_torch.models.march_fast import (
        BrickPack, _ray_capacity, build_cone_cache, march_bricks_v2,
        march_bricks_v3, march_tile_dense, v2_auto_policy, v2_capacity,
        v3_auto_policy)
    from cloudscape_tpu_torch.models.packs import procedural_noise_pack
    from cloudscape_tpu_torch.ops import accum, compact, noise_kernel, segscan
    from cloudscape_tpu_torch.utils.image import psnr

    width, height, steps = 512, 256, 64
    noise_kernel.launches = dict.fromkeys(noise_kernel.launches, 0)
    torch.cuda.synchronize()
    pack = None

    def generate():
        nonlocal pack
        pack = procedural_noise_pack(0, device=dev)

    gen_ms = events_ms(generate, 1)[0]
    noise_launches = dict(noise_kernel.launches)
    require(all(v == 1 for v in noise_launches.values()),
            f"config 4's pack did not launch K4–K6 once each: {noise_launches}")
    bricks = BrickPack.from_noise(pack)
    sun = np.array([0.3, 0.4, -0.85])
    sun /= np.linalg.norm(sun)
    sky = atmosphere.sky_lut(atmosphere.transmittance_lut(device=dev),
                             torch.tensor(sun, dtype=torch.float32, device=dev))
    params = MarchParams.create(
        cloud_pos=np.array([1.5, -0.3]), detailed_pos=np.array([0.4, 0.2]),
        weather_pos=np.array([0.01, 0.02]), time=12.5, cloud_coverage=0.35,
        light_direction=sun, ground_color=np.array([0.27, 0.19, 0.027]),
        device=dev)
    dirs = torch.from_numpy(hemisphere_dirs(width, height)).to(dev)
    rk, cap, tc, occ = v2_auto_policy(dirs, params, bricks, steps=steps)
    cone = build_cone_cache(params, bricks, 6, res=CONE_RES, chunk=65536)

    def v2():
        return march_bricks_v2(dirs, params, bricks, sky, steps=steps,
                               chunk=32768, capacity_frac=cap, cone_cache=cone,
                               ray_keep_frac=rk, ray_stride=2, t_cutoff=tc)

    torch.cuda.synchronize()
    k1_0, k2_0 = accum.launches, compact.launches
    out2 = v2()
    torch.cuda.synchronize()
    k1, k2 = accum.launches - k1_0, compact.launches - k2_0
    require(k1 >= 1 and k2 >= 1, f"config-4 v2 launched K1 {k1}, K2 {k2} times")
    ms2 = events_ms(v2, 3)

    rk3, ck, hk, cell_frac, hot_frac = v3_auto_policy(dirs, params, bricks,
                                                      steps=steps)

    def v3():
        return march_bricks_v3(dirs, params, bricks, sky, steps=steps,
                               chunk=32768, cell_keep_frac=ck, hot_keep_frac=hk,
                               cone_cache=cone, ray_keep_frac=rk3, ray_stride=2)

    k3_0 = segscan.launches
    out3 = v3()
    torch.cuda.synchronize()
    k3 = segscan.launches - k3_0
    require(k3 >= 2, f"config-4 v3 launched K3 {k3} < 2 times")
    ms3 = events_ms(v3, 3)

    dense = march_tile_dense(dirs, params, bricks, sky, steps=steps,
                             light_steps=6, chunk=16384, cone_cache=cone)
    off = march_bricks_v2(dirs, params, bricks, sky, steps=steps, chunk=32768,
                          capacity_frac=1.0, cone_cache=cone, t_cutoff=0.0)
    dense_np = dense.cpu().numpy()
    for name, out in (("v2", out2), ("v3", out3)):
        require(bool(torch.isfinite(out).all()), f"config-4 {name} not finite")
    db2, db3 = psnr(out2.cpu().numpy(), dense_np), psnr(out3.cpu().numpy(), dense_np)
    off_db = psnr(off.cpu().numpy(), dense_np)
    require(db2 >= 40.0, f"config-4 v2 vs dense {db2:.2f} dB < 40")
    require(db3 >= 40.0, f"config-4 v3 vs dense {db3:.2f} dB < 40")
    require(off_db >= 100.0, f"config-4 gates-off v2 vs dense {off_db:.2f} dB < 100")
    cloud_frac = float((out2[..., 3] > 0.1).float().mean())
    require(cloud_frac > 0.0, "config 4 rendered no clouds")
    n = width * height
    n_kept = _ray_capacity(n, rk) if rk < 1.0 else n
    return dict(gen_ms=gen_ms, noise_launches=noise_launches,
                policy=(rk, cap, tc), occ=occ, n_kept=n_kept,
                capacity=v2_capacity(n_kept * steps, cap, min(32768, n_kept)),
                ms2=statistics.median(ms2), all_ms2=ms2, db2=db2, off_db=off_db,
                k1=k1, k2=k2, policy3=(rk3, ck, hk), ms3=statistics.median(ms3),
                all_ms3=ms3, db3=db3, k3=k3, cloud_frac=cloud_frac)


def camera_dirs(width, height, dev, fov_deg=75.0, pitch_deg=20.0, yaw_deg=-35.0):
    """[height, width, 3] unit view directions of a pinhole camera (y up)."""
    import torch

    f = 1.0 / math.tan(math.radians(fov_deg) / 2.0)
    xs = (torch.arange(width, device=dev) + 0.5) / width * 2.0 - 1.0
    ys = 1.0 - (torch.arange(height, device=dev) + 0.5) / height * 2.0
    x = xs[None, :].expand(height, width) * (width / height)
    y = ys[:, None].expand(height, width)
    d = torch.stack([x, y, torch.full_like(x, -f)], dim=-1)
    p, w = math.radians(pitch_deg), math.radians(yaw_deg)
    rx = torch.tensor([[1, 0, 0], [0, math.cos(p), -math.sin(p)],
                       [0, math.sin(p), math.cos(p)]], dtype=torch.float32, device=dev)
    ry = torch.tensor([[math.cos(w), 0, math.sin(w)], [0, 1, 0],
                       [-math.sin(w), 0, math.cos(w)]], dtype=torch.float32, device=dev)
    d = d @ (ry @ rx).T
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def run_engine(dev, ticks: int):
    """Phase 5: the default engine on the card through its serving API.
    Returns the engine beside the measurements, for phase 7."""
    import torch

    from cloudscape_tpu_torch import CloudConfig, PerfConfig, SunState
    from cloudscape_tpu_torch.engine import CloudSkyEngine
    from cloudscape_tpu_torch.ops import accum, compact, noise_kernel

    perf = PerfConfig()  # 768², 64 frames, 128 steps, 6 light steps
    eyedirs = camera_dirs(1280, 720, dev)
    accum.launches = 0
    compact.launches = 0
    noise_kernel.launches = dict.fromkeys(noise_kernel.launches, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = CloudSkyEngine(perf=perf, config=CloudConfig(cloud_coverage=0.45),
                         sun=SunState(direction=(0.3, 0.25, -0.9)),
                         device=dev)
    require(eng.can_run, "the default engine failed its validation")
    noise_launches = dict(noise_kernel.launches)
    require(all(v == 1 for v in noise_launches.values()),
            f"the engine's pack did not launch K4–K6 once each: {noise_launches}")
    # The first frame runs the warm start (two full cycles), then its tick.
    eng.render_frame(eyedirs, now=0.0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    k2_after_warm = compact.launches

    tick_ms, pickups, frame = [], 0, None
    for i in range(ticks):
        boundary = eng.ring.frame >= eng.perf.frames_to_update
        pend = eng._pending
        prebaked = boundary and pend is not None and pend.cone is not None \
            and pend.sky is not None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        frame = eng.render_frame(eyedirs, now=(i + 1) / 60.0)
        end.record()
        torch.cuda.synchronize()
        tick_ms.append(start.elapsed_time(end))
        if prebaked:
            require(eng._cone_cache is pend.cone,
                    "boundary did not pick up the prebake")
            pickups += 1
    k1_launches, k2_launches = accum.launches, compact.launches

    require(pickups >= 1, "no cycle boundary picked up a prebaked cone cache")
    require(k1_launches >= ticks, f"K1 launched {k1_launches} < {ticks} ticks")
    # The prebake finalize launches K2 during the ticks.
    require(k2_launches > k2_after_warm, "prebake finalize did not launch K2")
    require(frame.shape == (720, 1280, 3), f"frame shape {tuple(frame.shape)}")
    require(bool(torch.isfinite(frame).all()) and float(frame.min()) >= 0.0,
            "frame is not finite and nonnegative")
    require(float(frame.mean()) > 1e-3, "frame is black")
    ring = eng.cloud_ring
    require(bool(torch.isfinite(ring).all()), "cloud ring is not finite")
    cloud_frac = float((ring[..., 3] > 0.1).float().mean())
    require(cloud_frac > 0.0, "no clouds in the cloud ring")
    return eng, dict(warm_s=warm_s, tick_ms=tick_ms, pickups=pickups,
                     k1=k1_launches, k2=k2_launches, noise=noise_launches,
                     cloud_frac=cloud_frac, frame_mean=float(frame.mean()))


def run_staged_engine(dev, kernel: str, perf, ticks: int, hemisphere: bool):
    """Phases 10 and 11: an engine whose tiles take the v2 march, on the
    phase-5 scene through its serving API: warm start, then `ticks`
    render_frame ticks that must launch K1 and K2; with `hemisphere`,
    `render_full_hemisphere` against the dense march."""
    import torch

    from cloudscape_tpu_torch import CloudConfig, SunState
    from cloudscape_tpu_torch.engine import CloudSkyEngine
    from cloudscape_tpu_torch.models.march_fast import march_tile_dense
    from cloudscape_tpu_torch.ops import accum, compact
    from cloudscape_tpu_torch.ops.octmap import texel_directions
    from cloudscape_tpu_torch.utils.image import psnr

    eyedirs = camera_dirs(1280, 720, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = CloudSkyEngine(perf=perf, config=CloudConfig(cloud_coverage=0.45),
                         sun=SunState(direction=(0.3, 0.25, -0.9)),
                         kernel=kernel, device=dev)
    require(eng.can_run, f"the {kernel} engine failed its validation")
    eng.render_frame(eyedirs, now=0.0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    k1_0, k2_0 = accum.launches, compact.launches
    frame = None

    def tick():
        nonlocal frame
        frame = eng.render_frame(eyedirs, now=(len(tick_ms) + 1) / 60.0)

    tick_ms = []
    for _ in range(ticks):
        tick_ms += events_ms(tick, 1)
    k1, k2 = accum.launches - k1_0, compact.launches - k2_0
    require(k1 >= ticks and k2 >= ticks,
            f"{kernel} ticks launched K1 {k1}, K2 {k2} times (< {ticks})")
    require(bool(torch.isfinite(frame).all()) and float(frame.min()) >= 0.0,
            f"{kernel} frame is not finite and nonnegative")
    require(float(frame.mean()) > 1e-3, f"{kernel} frame is black")
    ring = eng.cloud_ring
    require(bool(torch.isfinite(ring).all()), f"{kernel} cloud ring is not finite")
    cloud_frac = float((ring[..., 3] > 0.1).float().mean())
    require(cloud_frac > 0.0, f"no clouds in the {kernel} cloud ring")
    r = dict(warm_s=warm_s, tick_ms=tick_ms, k1=k1, k2=k2, cloud_frac=cloud_frac,
             region=eng.perf.update_region_size)
    if hemisphere:
        out = eng.render_full_hemisphere()
        r["hemi_ms"] = statistics.median(events_ms(eng.render_full_hemisphere, 3))
        require(bool(torch.isfinite(out).all()),
                f"{kernel} render_full_hemisphere is not finite")
        dense = march_tile_dense(
            texel_directions(eng.perf.texture_size, device=dev), eng._march_params,
            eng._bricks, eng.sky_ring[eng.ring.cloud_kernel_sky_slot],
            steps=eng.perf.march_steps, light_steps=eng.perf.light_steps,
            chunk=16384, cone_cache=eng._cone_cache)
        r["hemi_db"] = psnr(out.cpu().numpy(), dense.cpu().numpy())
        require(r["hemi_db"] >= 40.0, f"{kernel} render_full_hemisphere vs dense "
                f"{r['hemi_db']:.2f} dB < 40")
    return r


def run_fast_engine(dev):
    """Phase 11c: a `kernel="fast"` engine (every tile through the exact
    brick march, K2 once a tile) at PerfConfig() on the phase-5 scene with
    `procedural_noise_pack(0)`: the warm start, then 10 `render_frame`
    ticks of the phase-5 camera that must launch K2; frames finite,
    nonnegative and not black, clouds in the ring; one more tick with its
    tile's K2 call recorded and held against the plain version; then
    `render_full_hemisphere` (the exact march over the 768² map) with its
    K2 call recorded, then once more, timed, which must equal the first
    render bitwise."""
    import torch

    from cloudscape_tpu_torch import CloudConfig, PerfConfig, SunState
    from cloudscape_tpu_torch.engine import CloudSkyEngine
    from cloudscape_tpu_torch.ops import compact

    eyedirs = camera_dirs(1280, 720, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = CloudSkyEngine(perf=PerfConfig(), config=CloudConfig(cloud_coverage=0.45),
                         sun=SunState(direction=(0.3, 0.25, -0.9)), kernel="fast",
                         device=dev)
    require(eng.can_run, "the fast engine failed its validation")
    eng.render_frame(eyedirs, now=0.0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    k2_0, frame, tick_ms = compact.launches, None, []

    def tick():
        nonlocal frame
        frame = eng.render_frame(eyedirs, now=(len(tick_ms) + 1) / 60.0)

    for _ in range(FAST_TICKS):
        tick_ms += events_ms(tick, 1)
    k2 = compact.launches - k2_0
    require(k2 >= FAST_TICKS, f"fast ticks launched K2 {k2} < {FAST_TICKS} times")
    require(bool(torch.isfinite(frame).all()) and float(frame.min()) >= 0.0,
            "fast frame is not finite and nonnegative")
    require(float(frame.mean()) > 1e-3, "fast frame is black")
    ring = eng.cloud_ring
    require(bool(torch.isfinite(ring).all()), "fast cloud ring is not finite")
    cloud_frac = float((ring[..., 3] > 0.1).float().mean())
    require(cloud_frac > 0.0, "no clouds in the fast cloud ring")
    # One more tick, untimed, with its K2 calls recorded: the tile's
    # compaction (region² rays × steps samples) against the plain version.
    region, steps = eng.perf.update_region_size, eng.perf.march_steps
    _, tile_calls, _ = record_kernels(tick)
    tile_calls = [c for c in tile_calls if c[0].numel() == region * region * steps]
    require(len(tile_calls) >= 1, "a fast tick made no K2 call at the tile's shape")
    check_recorded("a fast tick's tile", tile_calls)
    out = None

    def hemi():
        nonlocal out
        out = eng.render_full_hemisphere()

    # The first call, recorded, also warms the allocator to the map's size.
    again, compactions, _ = record_kernels(eng.render_full_hemisphere)
    hemi_ms = events_ms(hemi, 1)[0]
    n = eng.perf.texture_size ** 2 * eng.perf.march_steps
    require(len(compactions) == 1 and compactions[0][0].numel() == n,
            f"the fast map made {len(compactions)} K2 calls")
    check_recorded("the fast engine's whole map", compactions)
    require(bool(torch.isfinite(out).all()), "fast render_full_hemisphere not finite")
    require(bitwise_equal(again, out), "two fast render_full_hemisphere calls differ")
    return dict(warm_s=warm_s, tick_ms=tick_ms, k2=k2,
                cloud_frac=cloud_frac, region=region, hemi_ms=hemi_ms,
                compactions=compactions, tile_compactions=tile_calls[:1],
                active=int(compactions[0][0].sum()),
                hemi_cloud_frac=float((out[..., 3] > 0.1).float().mean()))


def run_scan_march(dev, params, noise, bricks, sky):
    """Phase 11d: the scan march (`march`, the "reference" kernel's) over the
    768² texel grid at 128 steps and 6 light steps with the phase-5
    engine's params, noise pack and sky image: its ms by CUDA events; its
    device launches and device ms per call from torch.profiler traces of a
    1- and a 2-step march on the same rays (every step launches the same
    kernels on the same shapes, so a call is its setup and `STEPS` steps;
    tracing a whole call's ~300,000 launches takes the profiler about a
    minute to collect); and ≥ 40 dB against the exact brick march
    `march_bricks` on the same inputs (the gate of tests/test_brick.py,
    which holds it against the scan march)."""
    import torch

    from cloudscape_tpu_torch.models.march import march
    from cloudscape_tpu_torch.models.march_fast import march_bricks
    from cloudscape_tpu_torch.ops.octmap import texel_directions
    from cloudscape_tpu_torch.utils.image import psnr

    dirs = texel_directions(768, device=dev)
    out = None

    def scan():
        nonlocal out
        out = march(dirs, params, noise, sky, steps=STEPS, light_steps=6)

    ms = events_ms(scan, 1)[0]
    require(out.shape == dirs.shape[:2] + (4,) and bool(torch.isfinite(out).all()),
            "the scan march's output has the wrong shape or is not finite")
    (ms1, n1), (ms2, n2) = (
        trace_calls(lambda k=k: march(dirs, params, noise, sky, steps=k, light_steps=6),
                    reps=1, pad=1) for k in (1, 2))
    device_ms = launches = None
    if n1 is not None:
        device_ms = ms1 + (STEPS - 1) * (ms2 - ms1)
        launches = n1 + (STEPS - 1) * (n2 - n1)
    exact = march_bricks(dirs, params, bricks, sky, steps=STEPS, light_steps=6)
    scan_np = out.cpu().numpy()
    db = psnr(exact.cpu().numpy(), scan_np)
    require(db >= 40.0, f"march_bricks vs the scan march {db:.2f} dB < 40")
    return dict(ms=ms, device_ms=device_ms, launches=launches, db=db,
                cloud_frac=float((scan_np[..., 3] > 0.1).mean()))


def tiny_schedule(kernel: str):
    """(frames per cycle, ticks, march steps) of phase 12's tiny engines.
    The scan march costs ~3,000 PyTorch operations a step, so the reference
    engine runs a 4-frame cycle for 6 ticks (one boundary) at 8 steps
    instead of 16 frames for 20 ticks at 16 steps."""
    return (4, 6, 8) if kernel == "reference" else (16, 20, 16)


def tiny_engine(d, noise, kernel: str, tile_cull: bool):
    """Phase 12's tiny engine on device `d`, with a copy of `noise` there."""
    from cloudscape_tpu_torch import CloudConfig, PerfConfig, SunState
    from cloudscape_tpu_torch.engine import CloudSkyEngine

    pack = type(noise)(large=tuple(l.to(d) for l in noise.large),
                       small=tuple(s.to(d) for s in noise.small),
                       weather=noise.weather.to(d))
    frames, _, steps = tiny_schedule(kernel)
    eng = CloudSkyEngine(perf=PerfConfig(32, frames, march_steps=steps, light_steps=2),
                         config=CloudConfig(cloud_coverage=0.6),
                         sun=SunState(direction=(0.3, 0.5, -0.8)), noise=pack,
                         cone_res=(8, 64, 64), kernel=kernel, tile_cull=tile_cull,
                         device=d)
    require(eng.can_run, f"the tiny {kernel} engine on {d} failed its validation")
    return eng


def tiny_parity(dev, kernel: str, tile_cull: bool = False):
    """Phase 12: a tiny engine on the card (kernels) and on the CPU (plain
    versions) from one procedural pack: PSNR of the cloud ring and a view
    (and, without tile cull, of `render_full_hemisphere`), and with tile
    cull whether both engines picked the same buckets."""
    import torch

    from cloudscape_tpu_torch.models.packs import procedural_noise_pack
    from cloudscape_tpu_torch.ops.octmap import texel_directions
    from cloudscape_tpu_torch.utils.image import psnr

    noise = procedural_noise_pack(1, 16, 16, 64, device=dev)
    out, hemis, buckets = [], [], []
    for d in (dev, torch.device("cpu")):
        e = tiny_engine(d, noise, kernel, tile_cull)
        for i in range(tiny_schedule(kernel)[1]):
            e.update_sky(now=i / 30.0)
        view = e.render_view(texel_directions(48, device=d) * torch.tensor(
            [1.0, 0.7, 1.0], device=d))
        out.append((e.cloud_ring.cpu().numpy(), view.cpu().numpy()))
        buckets.append(e._tile_buckets)
        if not tile_cull:
            # fast3, 16 steps: prepass_steps 4 < 8, the policy's rebase branch.
            # fast and reference: their tile march over the map.
            hemis.append(e.render_full_hemisphere().cpu().numpy())
    (ring_gpu, view_gpu), (ring_cpu, view_cpu) = out
    return dict(ring_db=psnr(ring_gpu, ring_cpu), view_db=psnr(view_gpu, view_cpu),
                hemi_db=psnr(hemis[0], hemis[1]) if hemis else None,
                same_buckets=buckets[0] == buckets[1],
                frac=float((ring_cpu[..., 3] > 0.1).mean()))


def tiny_fused(dev, kernel: str, tile_cull: bool):
    """Phase 12 on the card: the fused `render_frame` against `update_sky` +
    `render_view` on a copy of the engine taken after the warm start's
    tick, over 16 ticks that cross a cycle boundary: frames at atol 2e-5 /
    rtol 1e-5, rings bitwise. Returns the largest frame difference."""
    import copy

    import torch

    from cloudscape_tpu_torch.models.packs import procedural_noise_pack
    from cloudscape_tpu_torch.ops.octmap import texel_directions

    fused = tiny_engine(dev, procedural_noise_pack(1, 16, 16, 64, device=dev),
                        kernel, tile_cull)
    fused.update_sky(now=0.0)
    split = copy.deepcopy(fused)
    d = texel_directions(48, device=dev) * torch.tensor([1.0, 0.7, 1.0], device=dev)
    worst = 0.0
    for i in range(1, 17):
        f = fused.render_frame(d, now=i / 60.0)
        split.update_sky(now=i / 60.0)
        g = split.render_view(d)
        what = f"tiny {kernel}{' tile_cull' if tile_cull else ''} tick {i}"
        require(torch.allclose(f, g, atol=2e-5, rtol=1e-5),
                f"{what}: fused and split frames differ")
        require(torch.equal(fused.cloud_ring, split.cloud_ring),
                f"{what}: fused and split rings differ")
        worst = max(worst, float((f - g).abs().max()))
    require(fused._display_pair is not None, "the fused ticks built no pair tables")
    return worst


# Ticks of phase 11c's fast engine.
FAST_TICKS = 10


# bench.py's serving operating point (`bench.py:272-323`): a warm start, 65
# warm ticks, then 70 timed ticks that cross one rotation boundary.
CULL_WARM_TICKS, CULL_TIMED_TICKS = 65, 70
# Gate of phase 11b's culled cycle (skip tiles zero, v3 tiles at their cell
# bucket) against the dense march over the same 768² texel grid, which is
# what the unculled engine renders for 96² tiles. On the card the cycle
# measured 39.09 dB (NVIDIA H100 80GB HBM3, 700.00 W); the gate leaves 4 dB
# of that, as V3_ENGINE_DB does of its reading.
TILE_CULL_DB = 35.0


def tile_arm(bucket: float) -> str:
    """The fast3 tile arm a tile-cull bucket takes."""
    return "skip" if bucket == 0.0 else ("dense" if bucket >= 1.0 else "v3")


def run_tile_cull(dev):
    """Phase 11b: the fast3 tile-cull engine at bench.py's serving point,
    through the fused `render_frame`. The kernel counts are zeroed before
    the engine's construction and read after the timed window; K2 and K3
    must launch within the window. Then the cycle's tiles are marched
    again and the culled map is held against the dense march, and the
    first v3 tile's K2 and K3 calls are recorded and held against their
    plain versions (for phase 13's rows)."""
    import torch

    from cloudscape_tpu_torch import CloudConfig, PerfConfig, SunState
    from cloudscape_tpu_torch.engine import CloudSkyEngine, _march_tile
    from cloudscape_tpu_torch.models.march_fast import march_tile_dense
    from cloudscape_tpu_torch.ops import accum, compact, noise_kernel, segscan
    from cloudscape_tpu_torch.ops.octmap import texel_directions
    from cloudscape_tpu_torch.utils.image import psnr

    eye = camera_dirs(1280, 720, dev)
    accum.launches = compact.launches = segscan.launches = 0
    noise_kernel.launches = dict.fromkeys(noise_kernel.launches, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = CloudSkyEngine(
        perf=PerfConfig(texture_size=768, frames_to_update=64, march_steps=128),
        config=CloudConfig(cloud_coverage=0.35, sun_disk_scale=2.0, wind_speed=10.0,
                           ground_color=(0.27, 0.19, 0.027, 1.0)),
        sun=SunState(direction=(0.3, 0.4, -0.85)), kernel="fast3",
        cone_res=CONE_RES, tile_cull=True, device=dev)
    require(eng.can_run, "the tile-cull engine failed its validation")
    eng.render_frame(eye, now=0.0)  # the warm start
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    for i in range(1, 1 + CULL_WARM_TICKS):
        eng.render_frame(eye, now=i / 60.0)
    torch.cuda.synchronize()
    n_frames = eng.perf.frames_to_update
    k_warm = (accum.launches, compact.launches, segscan.launches)
    ticks, pickups, done_buckets, frame = [], 0, None, None
    for i in range(1 + CULL_WARM_TICKS, 1 + CULL_WARM_TICKS + CULL_TIMED_TICKS):
        boundary = eng.ring.frame >= n_frames
        pend = eng._pending
        if boundary:
            done_buckets = eng._tile_buckets  # the cycle this boundary completes
            require(pend is not None and pend.buckets is not None,
                    "the tile-cull prebake was not ready at the boundary")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        w0 = time.perf_counter()
        start.record()
        frame = eng.render_frame(eye, now=i / 60.0)
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - w0) * 1e3
        if boundary:
            require(eng._tile_buckets is pend.buckets,
                    "the boundary did not pick up the prebaked buckets")
            pickups += 1
        # The tick rendered tile frame - 1 of the row-major sweep.
        ticks.append((tile_arm(eng._tile_buckets[eng.ring.frame - 1]),
                      start.elapsed_time(end), wall_ms))
    k1, k2, k3 = (accum.launches - k_warm[0], compact.launches - k_warm[1],
                  segscan.launches - k_warm[2])
    phase = dict(k1=accum.launches, k2=compact.launches, k3=segscan.launches,
                 noise=dict(noise_kernel.launches))
    require(pickups == 1, f"{pickups} boundaries in the timed window, not 1")
    require(any(a == "v3" for a, _, _ in ticks), "no timed tick took a v3 bucket")
    require(k2 > 0 and k3 > 0, f"the timed ticks launched K2 {k2}, K3 {k3} times")
    require(all(v == 1 for v in phase["noise"].values()),
            f"the engine's pack did not launch K4–K6 once each: {phase['noise']}")
    require(phase["k1"] > 0, "the tile-cull phase launched no K1")
    require(frame.shape == eye.shape, f"frame shape {tuple(frame.shape)}")
    require(bool(torch.isfinite(frame).all()) and float(frame.min()) >= 0.0,
            "tile-cull frame is not finite and nonnegative")
    require(float(frame.mean()) > 1e-3, "tile-cull frame is black")

    # Skip tiles are exact zeros: the cycle the boundary completed (its
    # buckets) and this cycle's tiles so far.
    region = eng.perf.update_region_size
    tpr = eng.perf.texture_size // region
    ring = eng.cloud_ring
    for tex, buckets, count in ((eng.ring.texture_to_blend_to, done_buckets, n_frames),
                                (eng.ring.texture_to_update, eng._tile_buckets,
                                 eng.ring.frame)):
        for k in range(count):
            if buckets[k] == 0.0:
                y0, x0 = (k // tpr) * region, (k % tpr) * region
                require(not bool(ring[tex, y0:y0 + region, x0:x0 + region].any()),
                        f"skip tile {k} of ring slot {tex} is not zero")
    require(bool(torch.isfinite(ring).all()), "tile-cull cloud ring is not finite")
    cloud_frac = float((ring[..., 3] > 0.1).float().mean())
    require(cloud_frac > 0.0, "no clouds in the tile-cull cloud ring")

    # This cycle's culled map against the unculled one: every tile marched
    # again by its arm (skip tiles stay zero), those the ticks wrote already
    # equal to the ring's (the kernels are deterministic), and the whole map
    # against the dense march over the same texel grid, params, sky slot and
    # cone cache, which is what the unculled engine renders for tiles this
    # size. The first v3 tile's K2 and K3 calls are recorded and held
    # against their plain versions (phase 13 times them).
    v3_tiles = [j for j, b in enumerate(eng._tile_buckets) if tile_arm(b) == "v3"]
    require(v3_tiles, "this cycle's buckets hold no v3 tile")
    size, tex = eng.perf.texture_size, eng.ring.texture_to_update
    sky = eng.sky_ring[eng.ring.cloud_kernel_sky_slot]
    culled = torch.zeros((size, size, 4), dtype=torch.float32, device=dev)
    for k, b in enumerate(eng._tile_buckets):
        if b == 0.0:
            continue
        y0, x0 = (k // tpr) * region, (k % tpr) * region

        def march_one():
            return _march_tile(
                texel_directions(size, x0=x0, y0=y0, width=region, height=region,
                                 device=dev),
                eng._march_params, eng._noise_arg, sky,
                region=region, steps=eng.perf.march_steps,
                light_steps=eng.perf.light_steps, kernel="fast3",
                ray_keep_frac=b if b < 1.0 else None)

        if k == v3_tiles[0]:
            tile, compactions, scans = record_kernels(march_one)
        else:
            tile = march_one()
        require(k >= eng.ring.frame or torch.equal(
            tile, ring[tex, y0:y0 + region, x0:x0 + region]),
            f"tile {k} (bucket {b}) marched again differs from the tick's")
        culled[y0:y0 + region, x0:x0 + region] = tile
    k3_err = check_recorded("a phase-11b v3 tile", compactions, scans)
    dense = march_tile_dense(
        texel_directions(size, device=dev), eng._march_params, eng._bricks, sky,
        steps=eng.perf.march_steps, light_steps=eng.perf.light_steps, chunk=16384,
        cone_cache=eng._cone_cache)
    cull_db = psnr(culled.cpu().numpy(), dense.cpu().numpy())
    require(cull_db >= TILE_CULL_DB,
            f"the culled cycle vs the dense march {cull_db:.2f} dB < {TILE_CULL_DB}")
    arms = {a: [t for b, t, _ in ticks if b == a] for a in ("skip", "v3", "dense")}
    event = [t for _, t, _ in ticks]
    med = statistics.median(event)
    return eng, dict(
        warm_s=warm_s, event_ms=event, wall_ms=[w for _, _, w in ticks],
        median=med, max=max(event), hitch=max(event) / med,
        hitch_p95=sorted(event)[int(len(event) * 0.95)] / med,
        arm_median={a: statistics.median(v) if v else None for a, v in arms.items()},
        arm_ticks={a: len(v) for a, v in arms.items()},
        histogram={b: eng._tile_buckets.count(b) for b in sorted(set(eng._tile_buckets))},
        k1=k1, k2=k2, k3=k3, phase=phase, v3_tiles=len(arms["v3"]),
        v3_bucket=eng._tile_buckets[v3_tiles[0]], compactions=compactions,
        scans=scans, k3_err=k3_err, cull_db=cull_db, cloud_frac=cloud_frac,
        frame_mean=float(frame.mean()))


# bench/sweep.py's config 5 (`bench/sweep.py:183-259`): hemisphere rays,
# adaptive steps, coarse probes a ray and row bands.
C5_WIDTH, C5_HEIGHT, C5_STEPS, C5_COARSE, C5_BANDS = 2048, 1024, 128, 32, 4
# Every C5_GT_STRIDE-th row and column of config 5 is marched at C5_GT_STEPS
# steps by the exact march (rays are independent, so that is the converged
# render at those texels), and the v1 and v3 rows are held at C5_DB against
# it there (tests/test_hierarchical.py's gates).
C5_GT_STRIDE, C5_GT_STEPS, C5_DB = 4, 512, 40.0


def run_config5(dev):
    """Phase 9b: bench/sweep.py config 5 on the port. The pack is
    `reference_noise_pack(seed=0)`, which is `procedural_noise_pack(0)`
    (K4–K6) where the reference's two BMPs are absent, with the sweep's
    scene (sun (0.3, 0.4, −0.85), coverage 0.35), 2048×1024 hemisphere rays
    and a (32, 512, 512) cone cache. Three rows, each a warm call and the
    median of 3 by CUDA events: v1 (`march_hierarchical_banded`, capacity
    0.08), v3 (`hier_v3_auto_policy` over 4 bands, then
    `march_hierarchical_v3_banded`) and v3flat (`v3_auto_policy` and
    `march_bricks_v3(ray_stride=2)` on each 512×2048 band). Quality: the
    exact march at C5_GT_STEPS steps on every C5_GT_STRIDE-th row and
    column; v1 and v3 held at C5_DB there, v3flat reported. One band of
    each row is marched again with its K2 and K3 calls recorded (phase 13
    times them), and those are held against the plain versions. Each call
    of the path (the pack, the cone cache, the two policies and each row's
    warm call) has its kernel launches counted on their own: the counts
    are zeroed just before the call and read just after it."""
    import torch

    from cloudscape_tpu_torch.models import atmosphere
    from cloudscape_tpu_torch.models.density import MarchParams
    from cloudscape_tpu_torch.models.march_fast import (
        BrickPack, build_cone_cache, hier_v3_auto_policy, march_bricks,
        march_bricks_v3, march_hierarchical, march_hierarchical_banded,
        march_hierarchical_v3, march_hierarchical_v3_banded, v3_auto_policy)
    from cloudscape_tpu_torch.models.packs import REFERENCE_ASSET_DIR, reference_noise_pack
    from cloudscape_tpu_torch.utils.image import psnr

    procedural = not all(os.path.exists(os.path.join(REFERENCE_ASSET_DIR, f))
                         for f in ("worlnoise.bmp", "weather.bmp"))
    launches = {}
    bricks, launches["pack"] = counted(
        lambda: BrickPack.from_noise(reference_noise_pack(seed=0, device=dev)))
    require(all(v == 1 for k, v in launches["pack"].items() if k.startswith("noise_")),
            f"config 5's pack did not launch K4–K6 once each: {launches['pack']}")
    sun = np.array([0.3, 0.4, -0.85])
    sun /= np.linalg.norm(sun)
    sky = atmosphere.sky_lut(atmosphere.transmittance_lut(device=dev),
                             torch.tensor(sun, dtype=torch.float32, device=dev))
    params = MarchParams.create(
        cloud_pos=np.array([1.5, -0.3]), detailed_pos=np.array([0.4, 0.2]),
        weather_pos=np.array([0.01, 0.02]), time=12.5, cloud_coverage=0.35,
        light_direction=sun, ground_color=np.array([0.27, 0.19, 0.027]), device=dev)
    dirs = torch.from_numpy(hemisphere_dirs(C5_WIDTH, C5_HEIGHT)).to(dev)
    hb = C5_HEIGHT // C5_BANDS
    bands = [dirs[b * hb:(b + 1) * hb] for b in range(C5_BANDS)]
    cone, launches["cone_cache"] = counted(
        lambda: build_cone_cache(params, bricks, 6, res=CONE_RES, chunk=65536))
    common = dict(steps=C5_STEPS, chunk=32768, cone_cache=cone)
    hier = dict(common, coarse_steps=C5_COARSE)

    t0 = time.perf_counter()
    (rk, ck, hk, cell_frac, hot_frac), launches["hier_v3_auto_policy"] = counted(
        lambda: hier_v3_auto_policy(dirs, params, bricks, steps=C5_STEPS,
                                    coarse_steps=C5_COARSE, bands=C5_BANDS))
    hier_policy_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    flat_policies, launches["v3_auto_policy"] = counted(
        lambda: [v3_auto_policy(d, params, bricks, steps=C5_STEPS)[:3] for d in bands])
    flat_policy_ms = (time.perf_counter() - t0) * 1e3

    def flat_band(d, pol):
        return march_bricks_v3(d, params, bricks, sky, cell_keep_frac=pol[1],
                               hot_keep_frac=pol[2], ray_keep_frac=pol[0],
                               ray_stride=2, **common)

    v3_knobs = dict(cell_keep_frac=ck, hot_keep_frac=hk, ray_keep_frac=rk, **hier)
    # name: (the whole render, its first band alone)
    row_fns = {
        "hierarchical_2048x1024x128": (
            lambda: march_hierarchical_banded(dirs, params, bricks, sky, bands=C5_BANDS,
                                              capacity_frac=0.08, **hier),
            lambda: march_hierarchical(bands[0], params, bricks, sky,
                                       capacity_frac=0.08, **hier)),
        "hierarchical_2048x1024x128_v3": (
            lambda: march_hierarchical_v3_banded(dirs, params, bricks, sky,
                                                 bands=C5_BANDS, **v3_knobs),
            lambda: march_hierarchical_v3(bands[0], params, bricks, sky, **v3_knobs)),
        "hierarchical_2048x1024x128_v3flat": (
            lambda: torch.cat([flat_band(d, pol) for d, pol in zip(bands, flat_policies)]),
            lambda: flat_band(bands[0], flat_policies[0])),
    }
    rows, outs = {}, {}
    for name, (whole, _) in row_fns.items():
        out, launches[name] = counted(whole)
        k2, k3 = launches[name]["compact"], launches[name]["segscan"]
        ms = events_ms(whole, 3)
        require(out.shape == (C5_HEIGHT, C5_WIDTH, 4) and bool(torch.isfinite(out).all()),
                f"config 5 {name}: wrong shape or not finite")
        require(k2 >= C5_BANDS, f"config 5 {name} launched K2 {k2} times")
        require(name.endswith("x128") or k3 >= 2 * C5_BANDS,
                f"config 5 {name} launched K3 {k3} times")
        outs[name] = out
        rows[name] = dict(ms=statistics.median(ms), all_ms=ms, k2=k2, k3=k3,
                          cloud_frac=float((out[..., 3] > 0.1).float().mean()))
    s = C5_GT_STRIDE
    gt_dirs = dirs[::s, ::s].contiguous()
    t0 = time.perf_counter()
    gt = march_bricks(gt_dirs, params, bricks, sky, steps=C5_GT_STEPS, chunk=32768,
                      capacity_frac=0.5)
    torch.cuda.synchronize()
    gt_ms = (time.perf_counter() - t0) * 1e3
    require(bool(torch.isfinite(gt).all()), "config 5 ground truth not finite")
    gt_np = gt.cpu().numpy()
    for name, out in outs.items():
        rows[name]["db"] = psnr(out[::s, ::s].cpu().numpy(), gt_np)
    for name in ("hierarchical_2048x1024x128", "hierarchical_2048x1024x128_v3"):
        require(rows[name]["db"] >= C5_DB, f"config 5 {name} vs the {C5_GT_STEPS}-step "
                f"ground truth {rows[name]['db']:.2f} dB < {C5_DB}")
    recorded = {name: record_kernels(band)[1:] for name, (_, band) in row_fns.items()}
    k3_err = max(check_recorded(f"config 5 {name}, band 0", comps, scans)
                 for name, (comps, scans) in recorded.items())
    return dict(procedural=procedural, rows=rows, policy=(rk, ck, hk),
                cell_frac=cell_frac, hot_frac=hot_frac, hier_policy_ms=hier_policy_ms,
                flat_policies=flat_policies, flat_policy_ms=flat_policy_ms,
                gt_ms=gt_ms, gt_shape=tuple(gt.shape[:2]), recorded=recorded,
                launches=launches, k3_err=k3_err)


# Ticks of phase 11e's hier engine after its warm start: a window within one
# cycle, then one that crosses a boundary.
HIER_TICKS = (20, 70)


def run_hier_engine(dev):
    """Phase 11e: a `kernel="hier"` engine at PerfConfig() on the phase-5
    scene and camera: `can_run`, the warm start, then HIER_TICKS fused
    `render_frame` ticks (the first window crosses no cycle boundary, the
    second one), each timed by CUDA events. The kernel counts are zeroed
    before the construction: K4–K6 once each, K2 and K3 within the ticks.
    Frames finite, nonnegative and not black, clouds in the ring; then
    `render_full_hemisphere` (the 4-band window-lattice v3) finite and
    ≥ V3_ENGINE_DB against the dense march over the same texels."""
    import torch

    from cloudscape_tpu_torch import CloudConfig, PerfConfig, SunState
    from cloudscape_tpu_torch.engine import CloudSkyEngine
    from cloudscape_tpu_torch.models.march_fast import march_tile_dense
    from cloudscape_tpu_torch.ops import compact, segscan
    from cloudscape_tpu_torch.ops.octmap import texel_directions
    from cloudscape_tpu_torch.utils.image import psnr

    eye = camera_dirs(1280, 720, dev)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = CloudSkyEngine(perf=PerfConfig(), config=CloudConfig(cloud_coverage=0.45),
                         sun=SunState(direction=(0.3, 0.25, -0.9)), kernel="hier",
                         device=dev)
    require(eng.can_run, "the hier engine failed its validation")
    eng.render_frame(eye, now=0.0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    k_warm = (compact.launches, segscan.launches)
    windows, frame, i = [], None, 0

    def tick():
        nonlocal frame
        frame = eng.render_frame(eye, now=i / 60.0)

    for n in HIER_TICKS:
        ms, crossed = [], 0
        for _ in range(n):
            i += 1
            crossed += eng.ring.frame >= eng.perf.frames_to_update
            ms += events_ms(tick, 1)
        windows.append(dict(ms=ms, boundaries=crossed))
    require([w["boundaries"] for w in windows] == [0, 1],
             f"hier tick windows crossed {[w['boundaries'] for w in windows]} boundaries")
    launches = read_counts()
    k2, k3 = compact.launches - k_warm[0], segscan.launches - k_warm[1]
    require(k2 > 0 and k3 > 0, f"the hier ticks launched K2 {k2}, K3 {k3} times")
    require(all(v == 1 for k, v in launches.items() if k.startswith("noise_")),
            f"the hier engine's pack did not launch K4–K6 once each: {launches}")
    require(bool(torch.isfinite(frame).all()) and float(frame.min()) >= 0.0,
            "hier frame is not finite and nonnegative")
    require(float(frame.mean()) > 1e-3, "hier frame is black")
    ring = eng.cloud_ring
    require(bool(torch.isfinite(ring).all()), "hier cloud ring is not finite")
    cloud_frac = float((ring[..., 3] > 0.1).float().mean())
    require(cloud_frac > 0.0, "no clouds in the hier cloud ring")
    out = eng.render_full_hemisphere()
    hemi_ms = events_ms(eng.render_full_hemisphere, 1)[0]
    require(bool(torch.isfinite(out).all()), "hier render_full_hemisphere not finite")
    dense = march_tile_dense(
        texel_directions(eng.perf.texture_size, device=dev), eng._march_params,
        eng._bricks, eng.sky_ring[eng.ring.cloud_kernel_sky_slot],
        steps=eng.perf.march_steps, light_steps=eng.perf.light_steps, chunk=16384,
        cone_cache=eng._cone_cache)
    hemi_db = psnr(out.cpu().numpy(), dense.cpu().numpy())
    require(hemi_db >= V3_ENGINE_DB,
            f"hier render_full_hemisphere vs dense {hemi_db:.2f} dB < {V3_ENGINE_DB}")
    return dict(warm_s=warm_s, windows=windows, k2=k2, k3=k3, launches=launches,
                cloud_frac=cloud_frac, hemi_ms=hemi_ms, hemi_db=hemi_db,
                policy=eng._v3_policy_cache,
                hemi_cloud_frac=float((out[..., 3] > 0.1).float().mean()))


# Phase 11g: the mesh. Shards of one card (`make_mesh(["cuda:0"] * 4)`) run
# in threads of their own on the card's one stream; MESH_TICKS engine ticks
# in lockstep with a single-card twin, across one rotation boundary.
MESH_SHARDS, MESH_TICKS = 4, 70
# Steps of the sharded scan march (phase 11g step 3): its launches grow
# with steps and shards, not with rays.
MESH_SCAN_STEPS = 16
# Gate of the sharded v3 render against the single-card one with the same
# knobs (tests/test_sharding.py's). And of the culled mesh engine's rings
# against its single-card twin's: the v3 march sizes its capacities per
# shard, as the JAX package's does, so a 24-row shard holding more than a
# quarter of a tile's live cells drops its farthest ones where the whole
# tile does not. On the card the rings measured 39.85 dB apart while a v3
# tile of the cycle at capacity 1.0 on the 4 shards measured 178.00 dB from
# the single card's (NVIDIA H100 80GB HBM3, 700.00 W); the gate is phase
# 11b's floor for a culled map, TILE_CULL_DB, and phase 11g holds that v3
# tile at capacity 1.0 at 100 dB.
MESH_V3_DB, MESH_RING_DB = 60.0, 35.0


def run_mesh(dev):
    """Phase 11g: the port's mesh (`parallel/sharding.py`) on shards of the
    one card, and on a mixed card + CPU mesh. The mesh path's launches
    (steps 1–4: every sharded call and the mesh engine, not the single-card
    references) are summed into `launches` from the counts zeroed at the
    phase's start and read around each call.

    1. `render_hemisphere_sharded` at 768² × 128 steps on 4 shards: fast3
       (the default v3_policy) ≥ MESH_V3_DB from the single-card v3 march
       with the same knobs and K2 and K3 launched at least once a shard;
       fast2 at atol 1e-6 from the single-card v2 march; the fast3 render
       on 2 shards against the one on 4 (bitwise, or its max |Δ|); each
       call (one of each) timed by CUDA events.
    2. The v3 prepass's (prio, occ) on 4 shards, bitwise the unsharded one.
    3. The scan march sharded at 768² × MESH_SCAN_STEPS, bitwise the single
       `march`; `full_frame_step_sharded` at the same size: the psum'd mean
       luminance at rtol 1e-6 from the host's f64 mean.
    4. A fast3 `tile_cull` engine at `PerfConfig()` (96² tiles, 24 rows a
       shard) on bench.py's serving scene with a 4-shard mesh, and its
       single-card twin: the warm start, then MESH_TICKS `render_frame`
       ticks of the 1280×720 camera in lockstep (each timed by CUDA events,
       the mesh engine's also by a `StageTimer`): equal buckets, every
       dense and skip tile within atol 1e-6 of the twin's, the rings ≥
       MESH_RING_DB apart (a v3 tile at capacity 1.0 on the shards ≥ 100
       dB from the single card's), K2 and K3 launched by the ticks and K1
       by the engine, the split path taken (no display-pair tables),
       frames finite, nonnegative and not black.
    5. A mixed mesh [cuda:0, cpu] (replicated inputs and halo rows cross
       devices): the sharded fast3 render at 64² × 8 steps, ≥ 50 dB (phase
       12's gate) from the CPU's single-device v3, and a tiny fast3
       `tile_cull` engine (64², 4 frames, 6 ticks across a boundary), ≥ 50
       dB from its twin on a [cpu, cpu] mesh (the same per-shard
       capacities).
    6. The StageTimer's ms a tick against the CUDA events' (reported; a
       difference above 10% is flagged)."""
    import torch

    from cloudscape_tpu_torch import CloudConfig, PerfConfig, SunState
    from cloudscape_tpu_torch.engine import CloudSkyEngine
    from cloudscape_tpu_torch.models import atmosphere
    from cloudscape_tpu_torch.models.density import MarchParams
    from cloudscape_tpu_torch.models.march import march
    from cloudscape_tpu_torch.models.march_fast import (
        BrickPack, _cull_prepass, _ray_setup, build_cone_cache, march_bricks_v2,
        march_bricks_v3)
    from cloudscape_tpu_torch.models.packs import procedural_noise_pack
    from cloudscape_tpu_torch.ops.octmap import texel_directions
    from cloudscape_tpu_torch.parallel.sharding import (
        P, full_frame_step_sharded, make_mesh, render_hemisphere_sharded,
        shard_map, tree_map)
    from cloudscape_tpu_torch.utils.image import psnr
    from cloudscape_tpu_torch.utils.profiling import StageTimer

    size, steps, light = 768, 128, 6
    pack = procedural_noise_pack(0, device=dev)
    bricks = BrickPack.from_noise(pack)
    sun = np.array([0.3, 0.4, -0.85])
    sun /= np.linalg.norm(sun)
    sun_t = torch.tensor(sun, dtype=torch.float32, device=dev)
    tlut = atmosphere.transmittance_lut(device=dev)
    sky = atmosphere.sky_lut(tlut, sun_t)
    params = MarchParams.create(
        cloud_pos=np.array([1.5, -0.3]), detailed_pos=np.array([0.4, 0.2]),
        weather_pos=np.array([0.01, 0.02]), time=12.5, cloud_coverage=0.35,
        light_direction=sun, ground_color=np.array([0.27, 0.19, 0.027]),
        device=dev)
    cone = build_cone_cache(params, bricks, light, res=CONE_RES, chunk=65536)
    dirs = texel_directions(size, device=dev)
    mesh = make_mesh([dev] * MESH_SHARDS)
    mesh2 = make_mesh([dev] * 2)
    zero_counts()
    launches = read_counts()  # all zero
    out = dict(card=card_line(), step_s=[])
    t_step = time.perf_counter()

    def step_done():
        nonlocal t_step
        out["step_s"].append(time.perf_counter() - t_step)
        t_step = time.perf_counter()

    def mesh_call(fn, *args, **kw):
        """fn(*args, **kw) with its launches added to `launches`; returns
        (result, its launches)."""
        torch.cuda.synchronize()
        before = read_counts()
        res = fn(*args, **kw)
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in read_counts().items()}
        for k, v in delta.items():
            launches[k] += v
        return res, delta

    def sharded(kernel, m=mesh, noise=(bricks, cone)):
        return render_hemisphere_sharded(m, size, params, noise, sky, steps=steps,
                                         light_steps=light, kernel=kernel)

    # Step 1: the sharded v3 and v2 renders against the single card's, each
    # call timed by CUDA events.
    def timed(fn, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn(*args)
        end.record()
        torch.cuda.synchronize()
        return res, start.elapsed_time(end)

    (s3, out["v3_ms"]), d3 = mesh_call(timed, sharded, "fast3")
    require(d3["compact"] >= MESH_SHARDS and d3["segscan"] >= MESH_SHARDS,
            f"the sharded v3 render launched K2 {d3['compact']}, K3 {d3['segscan']} "
            f"times on {MESH_SHARDS} shards")
    require(bool(torch.isfinite(s3).all()), "the sharded v3 render is not finite")

    def single3():
        return march_bricks_v3(dirs, params, bricks, sky, steps=steps,
                               light_steps=light, chunk=16384, cell_keep_frac=0.75,
                               hot_keep_frac=0.75, cone_cache=cone,
                               ray_keep_frac=1.0, prepass_steps=32, ray_stride=2)

    v3, out["v3_single_ms"] = timed(single3)
    out["v3_db"] = psnr(s3.cpu().numpy(), v3.cpu().numpy())
    out["v3_equal"] = float((s3 == v3).all(-1).float().mean())
    require(out["v3_db"] >= MESH_V3_DB,
            f"sharded v3 vs single {out['v3_db']:.2f} dB < {MESH_V3_DB}")
    (s3_2, out["v3_2_ms"]), _ = mesh_call(timed, sharded, "fast3", mesh2)
    out["v3_2v4_diff"] = float((s3_2 - s3).abs().max())
    out["v3_2v4_texels"] = int((s3_2 != s3).any(-1).sum())
    (s2, out["v2_ms"]), d2 = mesh_call(timed, sharded, "fast2")

    def single2():
        return march_bricks_v2(dirs, params, bricks, sky, steps=steps,
                               light_steps=light, chunk=16384, capacity_frac=0.3,
                               cone_cache=cone)

    v2, out["v2_single_ms"] = timed(single2)
    out["v2_diff"] = float((s2 - v2).abs().max())
    require(out["v2_diff"] <= 1e-6, f"sharded v2 vs single: max |d| {out['v2_diff']:.3g}")
    require(d2["compact"] >= MESH_SHARDS and d2["accumulate"] >= MESH_SHARDS,
            f"the sharded v2 render launched K2 {d2['compact']}, K1 "
            f"{d2['accumulate']} times on {MESH_SHARDS} shards")
    out["k_v3"], out["k_v2"] = d3, d2
    del s3, s3_2, v3, s2, v2
    step_done()

    # Step 2: the v3 prepass gate on 4 shards.
    def prepass(d, axis_name=None):
        H, W = d.shape[0], d.shape[1]
        above, ndir, ss, p0, _, _ = _ray_setup(d.reshape(-1, 3), params, steps)
        prio, occ, _ = _cull_prepass(above, ndir, ss, p0, params, bricks, steps, 32,
                                     16384, (H, W), 2, 0.1, axis_name)
        return prio.reshape(H, W), occ.reshape(H // 2, W // 2, 32)

    (prio_s, occ_s), _ = mesh_call(shard_map(
        lambda d: prepass(d, "rays"), mesh, in_specs=(P("rays"),),
        out_specs=(P("rays"), P("rays"))), dirs)
    prio_1, occ_1 = prepass(dirs)
    require(bitwise_equal(prio_s, prio_1) and torch.equal(occ_s, occ_1),
            "the sharded v3 prepass differs from the unsharded one")
    require(bool(occ_1.any()) and not bool(occ_1.all()), "the v3 gate is vacuous")
    out["occ_frac"] = float(occ_1.float().mean())
    del prio_s, occ_s, prio_1, occ_1
    step_done()

    # Step 3: the scan march and the whole frame step, sharded.
    sr, _ = mesh_call(render_hemisphere_sharded, mesh, size, params, pack, sky,
                      steps=MESH_SCAN_STEPS, light_steps=light, kernel="reference")
    t0 = time.perf_counter()
    ref = march(dirs, params, pack, sky, steps=MESH_SCAN_STEPS, light_steps=light)
    torch.cuda.synchronize()
    out["scan_single_ms"] = (time.perf_counter() - t0) * 1e3
    out["scan_diff"] = float((sr - ref).abs().max())
    require(bitwise_equal(sr, ref), f"the sharded scan march differs from the single "
            f"one: max |d| {out['scan_diff']:.3g}")
    del sr, ref
    t0 = time.perf_counter()
    (tile, fsky, mean), _ = mesh_call(
        full_frame_step_sharded, params, pack, tlut, sun_t, texture_size=size,
        steps=MESH_SCAN_STEPS, light_steps=light, mesh=mesh)
    out["frame_step_ms"] = (time.perf_counter() - t0) * 1e3
    host = float(tile[..., :3].cpu().numpy().astype(np.float64).mean())
    out["mean_lum"], out["mean_lum_host"] = float(mean), host
    require(abs(float(mean) - host) <= 1e-6 * abs(host) and host > 0.0,
            f"psum'd mean luminance {float(mean)!r} vs the host's {host!r}")
    require(tuple(fsky.shape) == (100, 200, 4) and bool(torch.isfinite(tile).all()),
            "full_frame_step_sharded's outputs")
    del tile
    step_done()

    # Step 4: the culled mesh engine and its single-card twin in lockstep.
    eye = camera_dirs(1280, 720, dev)
    kw = dict(perf=PerfConfig(), kernel="fast3", cone_res=CONE_RES, tile_cull=True,
              config=CloudConfig(cloud_coverage=0.35, sun_disk_scale=2.0,
                                 wind_speed=10.0, ground_color=(0.27, 0.19, 0.027, 1.0)),
              sun=SunState(direction=(0.3, 0.4, -0.85)), device=dev)
    t0 = time.perf_counter()
    eng, k_start = mesh_call(lambda: CloudSkyEngine(**kw, mesh=mesh))
    require(eng.can_run, "the mesh engine failed its validation")
    _, k_warm = mesh_call(eng.render_frame, eye, now=0.0)  # the warm start
    out["warm_s"] = time.perf_counter() - t0
    twin = CloudSkyEngine(**kw)
    require(twin.can_run, "the mesh engine's twin failed its validation")
    twin.render_frame(eye, now=0.0)
    region = eng.perf.update_region_size
    tpr = eng.perf.texture_size // region
    timer = StageTimer()
    mesh_ms, twin_ms, dense_diff, arms, boundaries = [], [], 0.0, [], 0
    tick_launches = dict.fromkeys(launches, 0)
    frame = None
    for i in range(1, MESH_TICKS + 1):
        boundaries += eng.ring.frame >= eng.perf.frames_to_update

        def mesh_tick():
            nonlocal frame
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with timer.stage("mesh_tick", rays=region * region, fence=eng.cloud_ring):
                start.record()
                frame = eng.render_frame(eye, now=i / 60.0)
                end.record()
            mesh_ms.append(start.elapsed_time(end))

        _, d = mesh_call(mesh_tick)
        for k, v in d.items():
            tick_launches[k] += v
        twin_ms += events_ms(lambda: twin.render_frame(eye, now=i / 60.0), 1)
        require(eng._tile_buckets == twin._tile_buckets,
                f"tick {i}: the mesh engine's buckets differ from the twin's")
        k = eng.ring.frame - 1  # the tile this tick wrote
        b = eng._tile_buckets[k]
        arms.append(tile_arm(b))
        y0, x0 = (k // tpr) * region, (k % tpr) * region
        tex = eng.ring.texture_to_update
        a = eng.cloud_ring[tex, y0:y0 + region, x0:x0 + region]
        t = twin.cloud_ring[tex, y0:y0 + region, x0:x0 + region]
        if b >= 1.0 or b == 0.0:
            diff = float((a - t).abs().max())
            require(diff <= 1e-6, f"tick {i}: {tile_arm(b)} tile {k} differs from "
                    f"the twin's by {diff:.3g}")
            dense_diff = max(dense_diff, diff)
    require(boundaries == 1, f"{boundaries} boundaries in the mesh ticks, not 1")
    require(eng._display_pair is None, "the mesh engine's render_frame built the "
            "display-pair tables (it must take update_sky + render_view)")
    require(frame.shape == eye.shape and bool(torch.isfinite(frame).all())
            and float(frame.min()) >= 0.0, "mesh frame is not finite and nonnegative")
    require(float(frame.mean()) > 1e-3, "mesh frame is black")
    # The serving scene's tiles are skips and v3 buckets (K2, K3); K1 runs
    # in the construction's probe and the (unsharded) warm start's dense
    # tiles, and through the shards in step 1's v2 render.
    engine_launches = {k: k_start[k] + k_warm[k] + v for k, v in tick_launches.items()}
    require(tick_launches["compact"] > 0 and tick_launches["segscan"] > 0
            and engine_launches["accumulate"] > 0,
            f"the mesh engine launched {engine_launches}, its ticks {tick_launches}")
    out["ring_db"] = psnr(eng.cloud_ring.cpu().numpy(), twin.cloud_ring.cpu().numpy())
    require(out["ring_db"] >= MESH_RING_DB,
            f"mesh engine vs twin rings {out['ring_db']:.2f} dB < {MESH_RING_DB}")
    # A v3 tile of the cycle at capacity 1.0: on the shards as on one card
    # (no shard can overflow), but for K3's sums over other ranges.
    k = next(j for j, b in enumerate(twin._tile_buckets) if tile_arm(b) == "v3")
    out["v3_tile"] = k
    tile_dirs = texel_directions(size, x0=(k % tpr) * region, y0=(k // tpr) * region,
                                 width=region, height=region, device=dev)

    def full_v3(d, axis_name=None):
        return march_bricks_v3(d, twin._march_params, twin._bricks,
                               twin.sky_ring[twin.ring.cloud_kernel_sky_slot],
                               steps=steps, light_steps=light, chunk=16384,
                               cell_keep_frac=1.0, hot_keep_frac=1.0,
                               cone_cache=twin._cone_cache,
                               prepass_steps=twin._v3_march_knobs()[0],
                               ray_stride=2, axis_name=axis_name)

    full_s = shard_map(lambda d: full_v3(d, "rays"), mesh, (P("rays"),),
                       P("rays"))(tile_dirs)
    out["v3_tile_full_db"] = psnr(full_s.cpu().numpy(), full_v3(tile_dirs).cpu().numpy())
    require(out["v3_tile_full_db"] >= 100.0, f"a v3 tile at capacity 1.0 on the "
            f"shards vs the single card {out['v3_tile_full_db']:.2f} dB < 100")
    out.update(mesh_ms=mesh_ms, twin_ms=twin_ms, dense_diff=dense_diff,
               arms={a: arms.count(a) for a in ("skip", "v3", "dense")},
               tick_launches=tick_launches, engine_launches=engine_launches,
               timer_ms=timer.as_dict()["mesh_tick"]["total_s"] * 1e3 / MESH_TICKS,
               cloud_frac=float((eng.cloud_ring[..., 3] > 0.1).float().mean()))
    out["timer_vs_events"] = out["timer_ms"] / statistics.mean(mesh_ms) - 1.0
    out["launches"] = dict(launches)
    del eng, twin
    step_done()

    # Step 5: a mixed mesh, one card and the CPU.
    cpu = torch.device("cpu")
    mixed = make_mesh([dev, cpu])
    small = procedural_noise_pack(1, 16, 16, 64, device=dev)
    sb = BrickPack.from_noise(small)
    scone = build_cone_cache(params, sb, 2, res=(8, 64, 64), chunk=4096)
    mixed_out = render_hemisphere_sharded(mixed, 64, params, (sb, scone), sky, steps=8,
                                          light_steps=2, kernel="fast3")

    def to_cpu(x):
        return x.to(cpu)

    cpu_v3 = march_bricks_v3(
        texel_directions(64, device=cpu), tree_map(to_cpu, params),
        tree_map(to_cpu, sb), sky.cpu(), steps=8, light_steps=2, chunk=16384,
        cell_keep_frac=0.75, hot_keep_frac=0.75, cone_cache=tree_map(to_cpu, scone),
        ray_keep_frac=1.0, prepass_steps=2, ray_stride=2)
    out["mixed_render_db"] = psnr(mixed_out.cpu().numpy(), cpu_v3.numpy())
    require(out["mixed_render_db"] >= 50.0,
            f"mixed-mesh v3 vs the CPU's {out['mixed_render_db']:.2f} dB < 50")
    tiny = dict(perf=PerfConfig(64, 4, march_steps=8, light_steps=2),
                config=CloudConfig(cloud_coverage=0.6),
                sun=SunState(direction=(0.3, 0.5, -0.8)), cone_res=(8, 64, 64),
                kernel="fast3", tile_cull=True)
    me = CloudSkyEngine(**tiny, noise=small, device=dev, mesh=mixed)
    # Its CPU twin on a 2-shard CPU mesh: the same per-shard capacities.
    ce = CloudSkyEngine(**tiny, noise=tree_map(to_cpu, small), device=cpu,
                        mesh=make_mesh([cpu, cpu]))
    require(me.can_run and ce.can_run, "the tiny mixed-mesh engines' validation")
    for i in range(6):  # across a boundary
        me.update_sky(now=i / 30.0)
        ce.update_sky(now=i / 30.0)
    out["mixed_ring_db"] = psnr(me.cloud_ring.cpu().numpy(), ce.cloud_ring.numpy())
    out["mixed_same_buckets"] = me._tile_buckets == ce._tile_buckets
    out["mixed_v3_tiles"] = sum(0.0 < b < 1.0 for b in me._tile_buckets)
    require(out["mixed_ring_db"] >= 50.0,
            f"mixed-mesh engine vs the CPU's rings {out['mixed_ring_db']:.2f} dB < 50")
    step_done()
    return out


def run_api(dev, eng):
    """Phase 11f: the engine API on the card. `save_file` of the phase-5
    engine, `load_file` into a new engine (rings bitwise equal, and its
    one-pass cone cache bitwise the phase-5 engine's prebaked one), then the
    next fused tick of both (frames and rings bitwise equal);
    `render_radiance_map(32)` and its prefiltered chain (finite,
    nonnegative, the +Y face brighter than −Y; each mip's solid angles
    against their f64 formula and, at 32² and 16², 4π within 1e-3);
    `set_performance(PerfConfig(texture_size=384, frames_to_update=16))` on
    a new fast3 engine, then a warm re-init that fills the ring."""
    import torch

    from cloudscape_tpu_torch import CloudConfig, PerfConfig, SunState
    from cloudscape_tpu_torch.engine import CloudSkyEngine, cubemap_solid_angles

    path = os.path.join(ROOT, "build", "chip_smoke_state.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    eng.save_file(path)
    twin = CloudSkyEngine(perf=eng.perf, config=eng.config, sun=eng.sun,
                          noise=eng.noise, device=dev)
    require(twin.can_run, "the load_file engine failed its validation")
    twin.load_file(path)
    os.remove(path)
    require(bitwise_equal(twin.cloud_ring, eng.cloud_ring)
            and bitwise_equal(twin.sky_ring, eng.sky_ring), "load_file rings differ")
    # The restored engine bakes its cone cache in one pass; the phase-5
    # engine holds the one its prebake sliced: the same cells, the same bits.
    cone_diff = float((twin._cone_cache.table.table - eng._cone_cache.table.table)
                      .abs().max())
    require(bitwise_equal(twin._cone_cache.table.table, eng._cone_cache.table.table),
            f"the restored cone table differs from the prebaked one by {cone_diff:.3g}")
    eye = camera_dirs(1280, 720, dev)
    now = (TICKS + 1) / 60.0
    x0, y0 = eng.ring.update_position
    region, tex = eng.perf.update_region_size, eng.ring.texture_to_update
    fa, fb = eng.render_frame(eye, now=now), twin.render_frame(eye, now=now)
    tile_cloud = float((eng.cloud_ring[tex, y0:y0 + region, x0:x0 + region, 3] > 0.1)
                       .float().mean())
    require(bitwise_equal(twin.cloud_ring, eng.cloud_ring),
            "the next tick's rings differ after load_file")
    require(bitwise_equal(fa, fb), "the next tick's frames differ after load_file")
    del twin

    sharp = eng.render_radiance_map(32)
    radiance_ms = events_ms(lambda: eng.render_radiance_map(32), 1)[0]
    mips = eng.render_radiance_map(32, prefilter=True)
    prefilter_ms = events_ms(lambda: eng.render_radiance_map(32, prefilter=True), 1)[0]
    require([tuple(m.shape) for m in mips]
            == [(6, s, s, 3) for s in (32, 16, 8, 4)], "radiance mips have wrong shapes")
    for m in [sharp] + mips:
        require(bool(torch.isfinite(m).all()) and float(m.min()) >= 0.0,
                "radiance map not finite and nonnegative")
        require(float(m[2].mean()) > float(m[3].mean()),
                "radiance map's +Y face not brighter than -Y")
    require(bitwise_equal(sharp, mips[0]), "the sharp map differs from the chain's base")
    sa_dev = {}
    for size in (32, 16, 8, 4):
        t = (np.arange(size, dtype=np.float64) + 0.5) / size * 2.0 - 1.0
        u, v = np.meshgrid(t, t, indexing="xy")
        formula = 6.0 * float(np.sum((2.0 / size) ** 2 / (u * u + v * v + 1.0) ** 1.5))
        got = float(cubemap_solid_angles(size, device=dev).double().sum())
        sa_dev[size] = got / (4.0 * math.pi) - 1.0
        require(abs(got - formula) <= 1e-5 * formula,
                f"{size}² solid angles sum to {got}, their formula to {formula}")
        require(size < 16 or abs(sa_dev[size]) <= 1e-3,
                f"{size}² solid angles miss 4π by {sa_dev[size]:.3g}")

    fresh = CloudSkyEngine(perf=PerfConfig(), config=CloudConfig(cloud_coverage=0.45),
                           sun=SunState(direction=(0.3, 0.25, -0.9)), noise=eng.noise,
                           device=dev)
    require(fresh.can_run, "the set_performance engine failed its validation")
    fresh.set_performance(PerfConfig(texture_size=384, frames_to_update=16))
    require(fresh.can_run and fresh.needs_full_sky_init
            and tuple(fresh.cloud_ring.shape) == (3, 384, 384, 4),
            "set_performance did not rebuild at 384²/16")
    frame = None

    def reinit():
        nonlocal frame
        frame = fresh.render_frame(eye, now=0.0)

    reinit_ms = events_ms(reinit, 1)[0]
    require(bool(torch.isfinite(frame).all()) and float(frame.mean()) > 1e-3,
            "the re-initialized engine's frame is not finite or is black")
    cloud_frac = float((fresh.cloud_ring[..., 3] > 0.1).float().mean())
    require(cloud_frac > 0.0, "the warm re-init left no clouds in the ring")
    return dict(tile=(x0, y0), tile_cloud=tile_cloud,
                radiance_ms=radiance_ms, prefilter_ms=prefilter_ms,
                sa_dev=sa_dev, reinit_ms=reinit_ms, cloud_frac=cloud_frac,
                region=fresh.perf.update_region_size,
                up=float(sharp[2].mean()), down=float(sharp[3].mean()))


def trace_calls(fn, reps: int = 10, pad: int = TRACE_PAD):
    """(device ms, device launches) per fn() call from torch.profiler: every
    device activity the calls make, summed, over `reps` calls; (None, None)
    if the profiler sees no device activity. `pad` calls run first in the
    same trace (they also warm fn up), then the host idles 50 ms: the
    measured calls' events are those after the trace's longest gap. Only
    the card's activity is traced."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(pad):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if not events:
        return None, None
    gaps = [b.time_range.start - a.time_range.end for a, b in zip(events, events[1:])]
    require(gaps and max(gaps) >= 25e3, "trace_calls: no 50 ms gap in the trace")
    events = events[gaps.index(max(gaps)) + 1:]
    return (sum(e.time_range.elapsed_us() for e in events) / reps / 1e3,
            len(events) / reps)


def run_composite(eng, eyedirs):
    """Phase 7b: the composite traced on its own, on the phase-5 engine's
    state at the camera's resolution: the split `composite` (`render_view`)
    and `composite_display` over the pair tables, CUDA-event ms,
    profiler device ms and launches a call; and `_build_display_pair`
    (once a cycle). The two composites agree at atol 2e-5 / rtol 1e-5."""
    import torch

    from cloudscape_tpu_torch.engine import _build_display_pair
    from cloudscape_tpu_torch.models.compositor import composite_display

    pair = eng._display_pair_tables()
    b0, b1 = eng.ring.sky_back_textures

    def split():
        return eng.render_view(eyedirs)

    def display():
        return composite_display(eyedirs, *pair, eng.transmittance,
                                 eng._light_dir(eng.frame_data),
                                 eng.config.sun_disk_scale, eng.blend_amount)

    def build():
        return _build_display_pair(eng.cloud_ring, eng.ring.texture_to_blend_from,
                                   eng.ring.texture_to_blend_to, eng.sky_ring, b0, b1)

    a, b = split(), display()
    torch.cuda.synchronize()
    require(torch.allclose(b, a, atol=2e-5, rtol=1e-5),
            f"composite_display differs from composite by {float((b - a).abs().max())}")
    out = {}
    for name, fn in (("composite", split), ("composite_display", display),
                     ("build_display_pair", build)):
        dev_ms, launches = trace_calls(fn)
        out[name] = dict(event_ms=cuda_time_ms(fn), device_ms=dev_ms,
                         launches=launches)
    out["max_abs_diff"] = float((b - a).abs().max())
    return out


def main() -> int:
    # One card: pinned before torch starts CUDA.
    os.environ["CUDA_VISIBLE_DEVICES"] = \
        os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    require(torch.cuda.device_count() == 1, "more than one visible CUDA device")
    sys.path.insert(0, ROOT)
    from cloudscape_tpu_torch.ops import _cuda

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    start = time.perf_counter()

    def stamp(phases: str) -> None:
        print(f"[phases {phases} done at {time.perf_counter() - start:.1f} s]",
              flush=True)

    t0 = time.perf_counter()
    lib_path = _cuda.build()
    _cuda.lib()
    print(f"build: {lib_path} in {time.perf_counter() - t0:.1f} s", flush=True)
    with open(lib_path + ".log") as f:
        print(f.read(), flush=True)

    k1_err = 0.0
    for n, steps, offset, what in K1_CASES:
        e = check_accumulate(dev, n, steps, offset)
        print(f"K1 accumulate [{n},{steps}] ({what}): max_abs_err {e:.3g}", flush=True)
        k1_err = max(k1_err, e)
    k2_mask = check_compact(dev)
    print("K2 compact: bitwise with and without rank on every case", flush=True)
    noise_rows = check_noise(dev)
    for kname, _, size, odd in NOISE_CASES:
        nr = noise_rows[kname]
        print(f"K4–K6 noise {kname} {size} (and {odd}): max_abs_err {nr['err']:.3g}, "
              f"{nr['ms']:.4f} ms kernel vs {nr['plain_ms']:.4f} ms plain ({card})",
              flush=True)
    # Every engine on the card validates itself with one probe launch of
    # K1–K3 on a tiny input; those launches are counted here and kept out
    # of the per-pass counts, which price each launch at a pass's shape.
    from cloudscape_tpu_torch.engine import _probe_kernels

    _, probe = counted(lambda: _probe_kernels(dev))
    probe = {k: probe[k] for k in ("accumulate", "compact", "segscan")}
    require(all(v == 1 for v in probe.values()),
            f"the validation probe did not launch K1–K3 once each: {probe}")
    print(f"validation probe (every engine construction): launches {probe}", flush=True)
    stamp("1-4")

    eng, r = run_engine(dev, TICKS)
    ms = r["tick_ms"]
    print(f"engine start (construction + first render_frame, which runs the "
          f"warm start): {r['warm_s']:.2f} s ({card})", flush=True)
    print(f"engine tick (render_frame 1280x720): median {statistics.median(ms):.2f} ms, "
          f"min {min(ms):.2f}, max {max(ms):.2f} over {len(ms)} ticks, "
          f"{r['pickups']} prebaked pickup(s), cloud fraction "
          f"{r['cloud_frac']:.4f}, frame mean {r['frame_mean']:.4f}; pack "
          f"launches {r['noise']} ({card})", flush=True)
    print("tick ms: " + " ".join(f"{v:.1f}" for v in ms), flush=True)
    stamp("5")

    from cloudscape_tpu_torch.models.march_fast import v3_capacities

    n_tex = eng.perf.texture_size
    ps, _ = eng._v3_march_knobs()
    rk, ck, hk = eng._v3_policy(eng._march_params)
    _, _, cap_h = v3_capacities(n_tex * n_tex, eng.perf.march_steps,
                                min(n_tex * n_tex, 32768), ck, rk, ps, hk)
    k3_err, k3_cases = check_segscan(dev, cap_h)
    print(f"K3 segscan N={cap_h} (the engine's v3 hot-list capacity), {k3_cases} "
          f"cases 1-D and [k, n]: max_abs_err {k3_err:.3g}; three runs of each "
          f"bitwise equal, batched rows bitwise their 1-D calls", flush=True)

    from cloudscape_tpu_torch.ops import segscan
    segscan.launches = 0
    v = run_v3_engine(eng)
    print(f"render_full_hemisphere {n_tex}x{n_tex}x{eng.perf.march_steps}: policy "
          f"(ray, cell, hot) {v['policy']}, kept rays {v['caps'][0]}, cap_c "
          f"{v['caps'][1]}, cap_h {v['caps'][2]}; first call {v['first_ms']:.2f} ms, "
          f"then median {v['ms']:.2f} ms of 3; "
          f"{v['db']:.2f} dB vs dense ({v['off_db']:.2f} dB with every gate off); "
          f"K1 x{v['k1']}, K2 x{v['k2']}, K3 x{v['k3']} per call; "
          f"cloud fraction {v['cloud_frac']:.4f} ({card})", flush=True)
    comp = run_composite(eng, camera_dirs(1280, 720, dev))
    for cname in ("composite", "composite_display", "build_display_pair"):
        cr = comp[cname]
        dev_ms = "not measured" if cr["device_ms"] is None else f"{cr['device_ms']:.4f} ms"
        print(f"{cname} (phase-5 engine, 1280x720): {cr['event_ms']:.4f} ms by CUDA "
              f"events, {dev_ms} on the device by torch.profiler, "
              f"{cr['launches']} device launches a call ({card})", flush=True)
    print(f"composite_display vs composite: max abs diff {comp['max_abs_diff']:.3g}",
          flush=True)
    # Phase 11d's inputs: the phase-5 engine's params, pack and sky image.
    scan_inputs = (eng._march_params, eng.noise, eng._bricks,
                   eng.sky_ring[eng.ring.cloud_kernel_sky_slot].clone())
    stamp("6-7b")
    headline = run_headline(dev)
    for h in headline:
        print(f"headline v3 {WIDTH}x{HEIGHT}x{STEPS} coverage {h['cov']}: policy "
              f"{h['policy']} (cell_frac {h['cell_frac']:.4f}, hot_frac "
              f"{h['hot_frac']:.4f}), kept rays {h['caps'][0]}, cap_c {h['caps'][1]}, "
              f"cap_h {h['caps'][2]}; cone build {h['cone_ms']:.2f} ms; render "
              f"median {h['ms']:.2f} ms ({' '.join(f'{t:.2f}' for t in h['all_ms'])}); "
              f"{h['db']:.2f} dB vs dense; cloud fraction {h['cloud_frac']:.4f} "
              f"({card})", flush=True)
        key = "quality_db_vs_exact" + ("" if h["cov"] == 0.35 else "_high_coverage")
        print(f"headline referee (march_bricks, chunk 32768, capacity 0.2) coverage "
              f"{h['cov']}: {h['exact_ms']:.2f} ms, {h['active']} active samples of "
              f"{WIDTH * HEIGHT * STEPS} (K2 bitwise its plain version); {key} "
              f"{h['db_exact']:.2f} dB (gate {V3_EXACT_DB}); the dense march vs the "
              f"referee {h['exact_dense_db']:.2f} dB ({card})", flush=True)
    k3_launches = segscan.launches
    stamp("8")

    api = run_api(dev, eng)
    del eng
    print(f"save_file -> load_file (phase-5 engine): rings bitwise, the next fused "
          f"tick's frame and rings bitwise (its tile at {api['tile']}, cloud fraction "
          f"{api['tile_cloud']:.4f}; the prebaked and the restored cone tables "
          f"bitwise)", flush=True)
    print(f"render_radiance_map(32): {api['radiance_ms']:.2f} ms, +Y face mean "
          f"{api['up']:.4f} vs -Y {api['down']:.4f}; prefiltered chain 32/16/8/4: "
          f"{api['prefilter_ms']:.2f} ms; solid angles vs 4π (relative) "
          + ", ".join(f"{k}² {v:+.3g}" for k, v in api["sa_dev"].items())
          + f" ({card})", flush=True)
    print(f"set_performance(384, 16) on a fresh fast3 engine: warm re-init "
          f"({api['region']}² tiles) {api['reinit_ms']:.2f} ms, cloud fraction "
          f"{api['cloud_frac']:.4f} ({card})", flush=True)
    stamp("11f")

    c4 = run_config4(dev)
    print(f"config 4 pack (K4–K6, 128³ + 32³ + 512²): {c4['gen_ms']:.3f} ms, "
          f"launches {c4['noise_launches']} ({card})", flush=True)
    print(f"config 4 v2 512x256x64: policy (ray, capacity, t_cutoff) "
          f"{c4['policy']} (occupied {c4['occ']:.4f}), kept rays {c4['n_kept']}, "
          f"capacity {c4['capacity']}; median {c4['ms2']:.2f} ms "
          f"({' '.join(f'{t:.2f}' for t in c4['all_ms2'])}); {c4['db2']:.2f} dB vs "
          f"dense ({c4['off_db']:.2f} dB with every gate off); K1 x{c4['k1']}, "
          f"K2 x{c4['k2']}; cloud fraction {c4['cloud_frac']:.4f} ({card})",
          flush=True)
    print(f"config 4 v3 512x256x64: policy {c4['policy3']}; median {c4['ms3']:.2f} "
          f"ms ({' '.join(f'{t:.2f}' for t in c4['all_ms3'])}); {c4['db3']:.2f} dB "
          f"vs dense; K3 x{c4['k3']} ({card})", flush=True)
    k1_64_err = check_accumulate(dev, c4["n_kept"], 64)
    print(f"K1 accumulate [{c4['n_kept']},64] (config 4's kept rays): max_abs_err "
          f"{k1_64_err:.3g}", flush=True)
    stamp("9")

    c5 = run_config5(dev)
    print(f"config 5 pack: reference_noise_pack(seed=0), "
          f"{'procedural (the reference BMPs are absent)' if c5['procedural'] else 'the BMPs'}"
          f"; hier_v3_auto_policy (4 bands) {c5['policy']} (cell_frac "
          f"{c5['cell_frac']:.4f}, hot_frac {c5['hot_frac']:.4f}) in "
          f"{c5['hier_policy_ms']:.1f} ms; the flat bands' v3_auto_policy "
          f"{c5['flat_policies']} in {c5['flat_policy_ms']:.1f} ms; ground truth "
          f"{c5['gt_shape'][1]}x{c5['gt_shape'][0]}x{C5_GT_STEPS} in {c5['gt_ms']:.1f} ms "
          f"({card})", flush=True)
    for row_name, row in c5["rows"].items():
        comps, scans = c5["recorded"][row_name]
        print(f"config 5 {row_name}: median {row['ms']:.2f} ms "
              f"({' '.join(f'{t:.2f}' for t in row['all_ms'])}); {row['db']:.2f} dB vs "
              f"the {C5_GT_STEPS}-step ground truth; K2 x{row['k2']}, K3 x{row['k3']} a "
              f"call; band 0 K2 " + ", ".join(f"{m.numel()}->{cap}" for m, cap, _ in comps)
              + f"; K3 {[tuple(v.shape) for v, _ in scans]}; cloud fraction "
              f"{row['cloud_frac']:.4f} ({card})", flush=True)
    print(f"config 5 recorded K2 calls bitwise, K3 max_abs_err {c5['k3_err']:.3g}",
          flush=True)
    for call, n in c5["launches"].items():
        print(f"config 5 launches, {call} (one call): "
              + ", ".join(f"{k} {v}" for k, v in n.items() if v), flush=True)
    stamp("9b")

    from cloudscape_tpu_torch import PerfConfig

    for kernel, perf, ticks, hemi in (("fast2", PerfConfig(), 20, True),
                                      ("fast3", PerfConfig(768, 4), 5, False)):
        s = run_staged_engine(dev, kernel, perf, ticks, hemi)
        tm = s["tick_ms"]
        extra = (f"; render_full_hemisphere median {s['hemi_ms']:.2f} ms, "
                 f"{s['hemi_db']:.2f} dB vs dense" if hemi else "")
        print(f"{kernel} engine {perf.texture_size}²/{perf.frames_to_update} "
              f"({s['region']}² tiles through v2): start {s['warm_s']:.2f} s; tick "
              f"median {statistics.median(tm):.2f} ms, min {min(tm):.2f}, max "
              f"{max(tm):.2f} over {len(tm)}; K1 x{s['k1']}, K2 x{s['k2']} in the "
              f"ticks; cloud fraction {s['cloud_frac']:.4f}{extra} ({card})",
              flush=True)

    stamp("9-11")
    ceng, c = run_tile_cull(dev)
    ev = c["event_ms"]
    arms = ", ".join(
        f"{a} {c['arm_median'][a]:.2f} ms over {c['arm_ticks'][a]}"
        if c["arm_median"][a] is not None else f"{a} none"
        for a in ("skip", "v3", "dense"))
    print(f"tile-cull engine (fast3, 768²/64/128, cone {CONE_RES}, coverage 0.35, "
          f"fused render_frame 1280x720; bench.py's serving point): start "
          f"{c['warm_s']:.2f} s; tick median {c['median']:.2f} ms, max "
          f"{c['max']:.2f}, hitch {c['hitch']:.3f}, hitch_p95 {c['hitch_p95']:.3f} "
          f"over {len(ev)} ticks (CUDA events; host clock median "
          f"{statistics.median(c['wall_ms']):.2f} ms); median per arm: {arms}; "
          f"phase 5 median {statistics.median(ms):.2f} ms ({card})", flush=True)
    print(f"tile-cull buckets (this cycle): {c['histogram']}; timed window K1 "
          f"x{c['k1']}, K2 x{c['k2']}, K3 x{c['k3']}; one v3 tile (bucket "
          f"{c['v3_bucket']}) launches K2 x{len(c['compactions'])}, K3 "
          f"x{len(c['scans'])} (K2 bitwise, K3 max_abs_err {c['k3_err']:.3g} "
          f"against their plain versions); the culled cycle "
          f"{c['cull_db']:.2f} dB vs the dense march; cloud fraction "
          f"{c['cloud_frac']:.4f}, frame mean {c['frame_mean']:.4f} ({card})",
          flush=True)
    print("tile-cull tick ms: " + " ".join(f"{t:.1f}" for t in ev), flush=True)
    del ceng
    stamp("11b")

    fe = run_fast_engine(dev)
    tm = fe["tick_ms"]
    print(f"fast engine 768²/64/128 ({fe['region']}² tiles through the exact march): "
          f"start {fe['warm_s']:.2f} s; render_frame 1280x720 tick median "
          f"{statistics.median(tm):.2f} ms, min {min(tm):.2f}, max {max(tm):.2f} over "
          f"{len(tm)}; K2 x{fe['k2']} in the ticks (a tick's tile compaction "
          f"{fe['tile_compactions'][0][0].numel()}->{fe['tile_compactions'][0][1]} "
          f"K2 bitwise its plain version); cloud fraction "
          f"{fe['cloud_frac']:.4f}; render_full_hemisphere {fe['hemi_ms']:.2f} ms, "
          f"{fe['active']} active samples (K2 bitwise its plain version), cloud "
          f"fraction {fe['hemi_cloud_frac']:.4f} ({card})", flush=True)
    print("fast tick ms: " + " ".join(f"{t:.1f}" for t in tm), flush=True)
    stamp("11c")
    sm = run_scan_march(dev, *scan_inputs)
    del scan_inputs
    print(f"scan march (the reference kernel's) 768x768x{STEPS}, 6 light steps, "
          f"phase-5 params: {sm['ms']:.2f} ms by CUDA events; torch.profiler "
          f"{sm['launches']} device launches and {sm['device_ms']} device ms a call "
          f"(from 1- and 2-step traces); "
          f"march_bricks vs it {sm['db']:.2f} dB; cloud fraction "
          f"{sm['cloud_frac']:.4f} ({card})", flush=True)
    stamp("11d")

    he = run_hier_engine(dev)
    print(f"hier engine 768²/64/128 (96² tiles through the window-lattice v3): start "
          f"{he['warm_s']:.2f} s; render_frame 1280x720 ticks: " + "; ".join(
              f"{len(w['ms'])} across {w['boundaries']} boundary: median "
              f"{statistics.median(w['ms']):.2f} ms, max {max(w['ms']):.2f}"
              for w in he["windows"])
          + f"; K2 x{he['k2']}, K3 x{he['k3']} in the ticks; cloud fraction "
          f"{he['cloud_frac']:.4f}; render_full_hemisphere (4 bands, policy "
          f"{he['policy']}) {he['hemi_ms']:.2f} ms, {he['hemi_db']:.2f} dB vs dense, "
          f"cloud fraction {he['hemi_cloud_frac']:.4f} ({card})", flush=True)
    print("hier tick ms: " + " ".join(f"{t:.1f}" for w in he["windows"] for t in w["ms"]),
          flush=True)
    stamp("11e")

    mo = run_mesh(dev)
    print(f"mesh {MESH_SHARDS} shards of one card, 768x768x128 (bench.py's scene, "
          f"coverage 0.35): sharded v3 {mo['v3_ms']:.2f} ms (2 shards "
          f"{mo['v3_2_ms']:.2f}) vs single {mo['v3_single_ms']:.2f} ms, "
          f"{mo['v3_db']:.2f} dB from the single v3, {mo['v3_equal']:.4f} of "
          f"texels equal, K2 x{mo['k_v3']['compact']}, K3 x{mo['k_v3']['segscan']}; "
          f"2 vs 4 shards max |d| {mo['v3_2v4_diff']:.3g} on {mo['v3_2v4_texels']} "
          f"texels; sharded v2 {mo['v2_ms']:.2f} ms vs single "
          f"{mo['v2_single_ms']:.2f} ms, max |d| {mo['v2_diff']:.3g}, K1 "
          f"x{mo['k_v2']['accumulate']}, K2 x{mo['k_v2']['compact']} ({card})",
          flush=True)
    print(f"mesh v3 prepass 768²: (prio, occ) bitwise the unsharded ones, "
          f"{mo['occ_frac']:.4f} of the coarse cells live; scan march "
          f"768x768x{MESH_SCAN_STEPS} sharded bitwise the single march (single "
          f"{mo['scan_single_ms']:.1f} ms); full_frame_step_sharded "
          f"{mo['frame_step_ms']:.1f} ms, mean luminance {mo['mean_lum']!r} vs the "
          f"host's {mo['mean_lum_host']!r} ({card})", flush=True)
    flag = " (differs by more than 10%)" if abs(mo["timer_vs_events"]) > 0.1 else ""
    print(f"mesh engine (fast3 tile_cull, PerfConfig(), {MESH_SHARDS} shards of 24 "
          f"rows) vs its single-card twin over {MESH_TICKS} render_frame ticks "
          f"across a boundary: start {mo['warm_s']:.2f} s; tick median "
          f"{statistics.median(mo['mesh_ms']):.2f} ms (max {max(mo['mesh_ms']):.2f}) "
          f"vs the twin's {statistics.median(mo['twin_ms']):.2f} ms (max "
          f"{max(mo['twin_ms']):.2f}), CUDA events; StageTimer {mo['timer_ms']:.2f} "
          f"ms a tick vs the events' mean {statistics.mean(mo['mesh_ms']):.2f} "
          f"({mo['timer_vs_events']:+.1%}{flag}); arms {mo['arms']}; buckets equal "
          f"every tick; dense and skip tiles max |d| {mo['dense_diff']:.3g}; rings "
          f"{mo['ring_db']:.2f} dB apart (tile {mo['v3_tile']} at capacity 1.0: "
          f"{mo['v3_tile_full_db']:.2f} dB); split path (no pair tables); the ticks "
          f"launched {mo['tick_launches']} (the engine in all "
          f"{mo['engine_launches']}); cloud fraction {mo['cloud_frac']:.4f} "
          f"({card})", flush=True)
    print("mesh tick ms: " + " ".join(f"{t:.1f}" for t in mo["mesh_ms"]), flush=True)
    print(f"mixed mesh [cuda:0, cpu]: sharded v3 64x64x8 {mo['mixed_render_db']:.1f} dB "
          f"from the CPU's; tiny fast3 tile_cull engine rings "
          f"{mo['mixed_ring_db']:.1f} dB from its [cpu, cpu] twin's (same buckets "
          f"{mo['mixed_same_buckets']}, {mo['mixed_v3_tiles']} v3 tiles); the "
          f"mesh phase's steps took " + ", ".join(f"{t:.1f}" for t in mo["step_s"])
          + " s", flush=True)
    stamp("11g")

    for kernel, tile_cull in (("fast3", False), ("fast3", True), ("fast2", False),
                              ("fast2", True), ("hier", False), ("hier", True),
                              ("fast", False), ("reference", False)):
        t = tiny_parity(dev, kernel, tile_cull)
        what = f"tiny {kernel}{' tile_cull' if tile_cull else ''} engine"
        hemi = "" if t["hemi_db"] is None else \
            f", render_full_hemisphere {t['hemi_db']:.1f} dB"
        print(f"{what} card vs CPU: ring {t['ring_db']:.1f} dB, view "
              f"{t['view_db']:.1f} dB{hemi}, same buckets {t['same_buckets']} "
              f"(cloud fraction {t['frac']:.3f})", flush=True)
        require(t["ring_db"] >= 50.0 and t["view_db"] >= 50.0
                and (t["hemi_db"] is None or t["hemi_db"] >= 50.0),
                f"card and CPU {what}s disagree")
        require(t["frac"] > 0.0, f"the {what} rendered no clouds")
        if kernel == "reference":
            # Its tiles are slow (the scan march), and the fused tick writes
            # a tile through `_write_tile` as the split tick does.
            continue
        worst = tiny_fused(dev, kernel, tile_cull)
        print(f"{what} on the card, fused vs split over 16 ticks: rings bitwise, "
              f"frames max abs diff {worst:.3g}", flush=True)

    stamp("12")
    # Phase 13: each kernel's device time (cold L2) against its bound at the
    # shapes of the paths above; the first row of each is its main-path shape.
    rows = {
        "accumulate": [time_accumulate(dev, 9216, 128),
                       time_accumulate(dev, c4["n_kept"], 64)],
        # The finalize asks for no rank (`_compact_mask`); v2's direct call
        # takes the rank.
        "compact": [time_compact(k2_mask, K2_CAP, False, plain=True),
                    time_compact(k2_mask, K2_CAP, True)]
        + [time_compact(m, cap, wr) for m, cap, wr in v["compactions"]]
        + [time_compact(m, cap, wr) for m, cap, wr in c["compactions"]]
        # The referee's (phase 8, coverage 0.35), the fast engine's
        # whole-map and a fast tick's tile compactions (phase 11c): they
        # serve the referee and the unstaged fast kernel, not the default
        # engine's serving pass, so they are in no launches-per-pass group.
        + [time_compact(m, cap, wr)
           for m, cap, wr in headline[0]["exact_compactions"] + fe["compactions"]
           + fe["tile_compactions"]],
        # One 1-D and one [3, n] launch per v3 march: the engine's hot list
        # first, then the headline's, then a v3 tile's (as it ran).
        "segscan": [time_segscan(dev, cap_h, 1, plain=True),
                    time_segscan(dev, cap_h, 3, plain=True)]
        + [time_segscan(dev, h["caps"][2], k) for h in headline for k in (1, 3)]
        + [time_segscan_on(sv, sh) for sv, sh in c["scans"]],
    }
    # Config 5's band-0 calls (phase 9b), as they ran: config 5 is not the
    # default engine's pass, so they enter no launches-per-pass group.
    n_k3_pass = len(rows["segscan"])
    for name, (comps, scans) in c5["recorded"].items():
        rows["compact"] += [dict(time_compact(m, cap, wr), serves=f"config 5 {name}")
                            for m, cap, wr in comps]
        rows["segscan"] += [dict(time_segscan_on(sv, sh), serves=f"config 5 {name}")
                            for sv, sh in scans]
    # Phase 5 without its engine's validation probe.
    p5_k1, p5_k2 = r["k1"] - probe["accumulate"], r["k2"] - probe["compact"]
    # Launches per pass by the shape they ran at: phase 5 and the tile-cull
    # window's prebake finalize at the finalize's shape, phase 7's and the
    # v3 tiles' at theirs (K3: half 1-D, half [3, n] in phase 7).
    n7, nt = len(v["compactions"]), len(c["compactions"])
    k2_rows = rows["compact"]
    k2_finalize = p5_k2 + v["k2"] - n7 + max(c["k2"] - c["v3_tiles"] * nt, 0)
    groups = {
        "accumulate": [(p5_k1 + v["k1"] + c["k1"], rows["accumulate"][0])],
        "compact": [(k2_finalize, k2_rows[0])]
        + [(1, row) for row in k2_rows[2:2 + n7]]
        + [(c["v3_tiles"], row) for row in k2_rows[2 + n7:2 + n7 + nt]],
        "segscan": [(v["k3"] / 2, rows["segscan"][0]), (v["k3"] / 2, rows["segscan"][1])]
        + [(c["v3_tiles"], row)
           for row in rows["segscan"][2 + 2 * len(headline):n_k3_pass]],
    }
    nonzero_ms = time_nonzero(k2_mask)
    print(f"K2's library yardstick: torch.nonzero(mask).view(-1) on the "
          f"{K2_N}-cell mask {nonzero_ms:.4f} ms (CUDA events, its host "
          f"synchronisation included; no capacity, no fill) ({card})", flush=True)
    for kname, fn, size, _ in NOISE_CASES:
        row = time_noise(dev, kname, fn, size)
        row.update(event_ms=noise_rows[kname]["ms"],
                   plain_ms=noise_rows[kname]["plain_ms"])
        rows[f"noise_{kname}"] = [row]
    for kname, krows in rows.items():
        for row in krows:
            print(f"{kname} {row['shape']}: {row['device_us']:.2f} us device "
                  f"({row['kernels_per_call']} kernel(s), {row['kernel_sum_us']:.2f} us "
                  f"in kernels, {row['timing']}; {row['device_us_write_flush']:.2f} us "
                  f"after a write flush), bound {row['bound_us']:.2f} us by "
                  f"{row['bound_by']}, share {row['bound_share']:.3f} ({card})",
                  flush=True)

    # launches: the counts read around each kernel's path (K1, K2: the
    # engine ticks; K3: the full-hemisphere and headline renders; K4–K6:
    # the engine's construction and config 4's pack); launches_tile_cull:
    # the tile-cull phase's (construction, warm start and every tick).
    # launches_per_pass: phase 5 (construction but its validation probe,
    # warm start, the ticks), phase 7's first render_full_hemisphere and
    # the tile-cull timed window.
    meta = [
        ("accumulate", "accum.cu", "accum_pallas.py:101", r["k1"],
         p5_k1 + v["k1"] + c["k1"], c["phase"]["k1"], max(k1_err, k1_64_err)),
        ("compact", "compact.cu", "compact_pallas.py:184", r["k2"],
         p5_k2 + v["k2"] + c["k2"], c["phase"]["k2"], 0.0),
        ("segscan", "segscan.cu", "segscan_pallas.py:121", k3_launches,
         v["k3"] + c["k3"], c["phase"]["k3"], max(k3_err, c["k3_err"])),
    ]
    for (kname, _, _, _), line in zip(NOISE_CASES, (187, 214, 240)):
        meta.append((f"noise_{kname}", "noise.cu", f"noise_pallas.py:{line}",
                     r["noise"][kname] + c4["noise_launches"][kname],
                     r["noise"][kname], c["phase"]["noise"][kname],
                     noise_rows[kname]["err"]))
        groups[f"noise_{kname}"] = [(r["noise"][kname], rows[f"noise_{kname}"][0])]
    kernels = []
    for kname, src, tpu, launches, per_pass, cull_launches, err in meta:
        main_row = rows[kname][0]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"cloudscape_tpu_torch/csrc/{src}",
            "replaces": f"cloudscape_tpu/ops/{tpu}",
            "launches": launches, "launches_per_pass": per_pass,
            "launches_tile_cull": cull_launches,
            # Config 5 (phase 9b): each call of its path counted alone;
            # the hier engine (phase 11e): its construction, warm start and
            # ticks.
            "launches_config5": {call: n[kname] for call, n in c5["launches"].items()},
            "launches_hier_engine": he["launches"].get(kname, 0),
            # The mesh (phase 11g, steps 1–4): every sharded call and the
            # mesh engine's construction, warm start and ticks; and its
            # MESH_TICKS ticks alone, on MESH_SHARDS shards.
            "launches_mesh": mo["launches"][kname],
            "launches_mesh_ticks": mo["tick_launches"][kname],
            "max_abs_err": max(err, c5["k3_err"]) if kname == "segscan" else err, "shape": main_row["shape"],
            "ms": main_row["device_us"] / 1e3, "device_us": main_row["device_us"],
            "device_us_write_flush": main_row["device_us_write_flush"],
            "event_ms": main_row["event_ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_us"] / 1e3, "bound_us": main_row["bound_us"],
            "bound_by": main_row["bound_by"], "bound_share": main_row["bound_share"],
            "loss_per_pass_us": loss_per_pass_us(groups[kname]),
            "redesigned_in": REDESIGNED_IN.get(kname),
            # Only K2's function has a single PyTorch call (with the caveat
            # in `time_nonzero`).
            "library_ms": nonzero_ms if kname == "compact" else None,
            "shapes": rows[kname]})
    # The redesign rule: launches per pass x (device time - bound); a kernel
    # at or above half of its bound is left alone, and one already
    # redesigned is marked so.
    ranked = sorted(kernels, key=lambda k: -k["loss_per_pass_us"])
    print("ranking, launches per pass x (device us - bound us): " + "; ".join(
        f"{k['name']} {k['loss_per_pass_us'] / 1e3:.4f} ms (share "
        f"{k['bound_share']:.3f}"
        f"{', left alone' if k['bound_share'] >= 0.5 else ''}"
        f"{', redesigned' if k['redesigned_in'] else ''})" for k in ranked)
        + f" ({card})", flush=True)
    for kname in ("compact", "segscan"):
        print(f"{kname} launches per pass by shape: " + "; ".join(
            f"{n:g} x {row['shape']} ({row['device_us']:.2f} us, bound "
            f"{row['bound_us']:.2f} us)" for n, row in groups[kname]), flush=True)
    stamp("13")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
