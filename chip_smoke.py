#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and exits nonzero; there is no CPU path):

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from cloudscape_tpu_torch/csrc with nvcc (sm_90a);
3. K1 (accumulate) against its plain version at the serving tile's shape
   [9216, 128] and at the shapes of K1_CASES (planes off 16-B alignment and
   102 or 30 steps, which take the scalar loads; 100 steps; one ray; a
   partly empty last block; 64, 16 and 256 steps; [65536, 128], a pass
   chunk of `update_cycle`'s batched dense march; [16384, 128], the dense
   march's pass chunk of a tile of 16,384 rays or more; [147456, 128], a
   384² tile's v2 march at frames_to_update 4), atol 2e-5, with empty
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
   not powers of two (48³, 20³, 100², seed 7), atol 2e-5;
   4c. K11 (`transmittance_kernel`, the engine's 256 x 64 LUT) and K10
   (`sky_kernel`, the 200 x 100 sky-view LUT on K11's at ATMO_SUNS)
   against their plain versions on the same inputs within ATMO_TOL x the
   plain version's largest |value|, three runs bitwise alike; for every
   band height the schedule can pick (SKY_BANDS) the bands of every row0
   bitwise the whole call, and the first, horizon and last bands against
   the plain version's rows; then the engines' validation probe, which
   must launch K1–K3, each sampler kernel (K7 and K8 on a texture and on
   brick rows, K9), K11 and K10 once each;
5. the default engine (fast3, 768² / 64 frames / 128 steps / 6 light
   steps, cone cache (32, 512, 512), procedural_noise_pack(0), which K4–K6
   generate) on the card:
   construction and a first render_frame (warm start), then 70 more
   render_frame ticks of a 1280×720 camera (the fused display-pair path,
   `render_frame`'s default), crossing a
   cycle boundary that picks up a prebaked cone cache; the launch counts of
   K1, K2 and K4–K6 must show the path ran through those kernels; frames
   must be finite, nonnegative and not black, and the cloud ring must hold
   clouds; K7–K9 (the samplers: K7 and K8 on the engine's channel-last
   textures, K9 on the tiny mips) launched at least once each, K11 once
   for the engine's transmittance LUT and K10 for its sky LUTs;
   5b. K7–K9 (`csrc/sample.cu`) against their plain versions on every
   table the phase-5 engine samples: each mip of its pack (textures, the
   tiny ones through K9), the same pack in bfloat16, its weather texture,
   its cone cache and the display pair textures of its fused tick, at
   [587, 511] planes (299,957 samples, no multiple of a block) with texel
   centres and edges (the weather, the cone cache, large mip 0 and the
   4³ large mip 5 again at [65536, 128], the planes of a pass chunk of
   `update_cycle`'s batched dense march): a texture kernel within
   TEXTURE_TOL relative of its
   plain version, K9 bitwise, the brick kernels within SAMPLE_TOL · max(1,
   |plain|); three runs bitwise equal, a strided and a transposed view of
   the planes giving the same bits;
   each texture also packed into the JAX package's brick table and
   sampled by the brick kernel (K7, K8 on brick rows), which must give the
   texture kernel's bits; K9 on TINY_CASES (a (2, 1, 3) volume through
   the runtime-dims instantiation, sample counts of every residue mod 4,
   planes 4 and 12 B past 16-B alignment, coordinates with |q·4| ≥ 2^31
   of both signs), each bitwise; then the v3
   march of a V3_SMALL² octahedral map on the card ≥ V3_SMALL_DB from the
   same call on the CPU;
   5c. `update_cycle` on two deep copies of the phase-5 engine, one with
   the batched dense march (`_march_tiles_dense`) and one with the
   per-tile loop (`_update_tile` a tile): the rest of the current cycle
   (a partial batch), then a whole cycle after the rotation, each ring
   bitwise the loop's, with K1 launched once per BATCH_DENSE_CHUNK rays of
   the batch and the batch's peak allocation printed;
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
   1280×720: the split `composite` (`render_view`), `composite_display`
   over the display-pair tables (kernel K12: one launch, nothing else),
   its eager chain (`_composite_display_plain` on the card, the composite
   before K12) and `_build_display_pair` (paid once a cycle): CUDA-event
   ms, torch.profiler device ms and device launches a call; K12 agrees with
   the eager chain and the split composite at atol 2e-5 / rtol 1e-5. Each
   phase-5 tick launches K12 exactly once;
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
   13,434,880 slots) held bitwise against K2's plain version; K7–K9
   launched by each scene (its cone build, render and referee);
   8c. the v3 march stage by stage (`run_v3_stages`, `stage_trace`):
   phase 8's render at both coverages, called again with exactly its
   arguments and `debug_stage` k = 1…9 and 0 (2 only with the ray cull):
   per stage the launches of one call (the counts zeroed just before it),
   a finite probe (stage 1's −inf where a ray is below the horizon), the
   median of STAGE_REPS rounds of CUDA-event timings over all the stages
   in turn, its device ms and launches by torch.profiler, and each one's
   increment over the stage before; the stage-0 call bitwise phase 8's
   render with phase 8's launches, its idle share 1 − device / event ms.
   Phase 11b adds its first v3 tile, called as the
   engine's v3 arm calls it (no ray cull), against that arm's call; after
   phase 11b the three tables go out as one `v3_stages` JSON line;
   8d. phase 8's v3 render and its referee at each coverage (0.35, then
   0.7 with its own policy and cone cache) on a CROP² window of the grid,
   every CROP_STEP-th texel (16,384 rays; the window where that scene's
   referee has the most cloud), against `oracle/reference.py` in float64
   on the host (ORACLE_WORKERS processes; the pack's level-0 volumes with
   the oracle's own pyramids and LUTs): both ≥ ORACLE_DB, and v3 against
   the referee on those texels reported; the host seconds of each;
   8b. the baked density field (`models/field.py`, `run_field`) on the
   headline scene at coverage 0.35: `build_density_field` at (32, 768,
   768), cone (16, 192, 192), chunk 65536 (its ms; the table finite);
   `march_baked` at its defaults (median of 3), finite and inside the
   documented band, 15 < dB < 40, against phase 8's referee output (the
   negative result of tests/test_field.py); the sweep (16, 256²), (24,
   384²), (32, 512²), (32, 768²), (32, 1536²) reported (build ms, dB); its
   two K2 calls
   (524,288 → 524,288 rays, 67,108,864 → 33,554,432 samples) recorded and
   held bitwise against the plain version, and two launches counted; K7's
   first call on the field's table (2-ch 4×4×4 clamp) recorded, for phase
   13 to check and time;
   `occupied_ray_fraction` in (0, 1], and exactly 0 on an empty scene with
   margin 0; tests/test_torch_field.py's scene on the card and on the CPU
   ≥ 60 dB apart with bitwise-equal ray indices;
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
   once each, K1 in the phase, at least one timed tick in a v3 bucket,
   each v3 tick one graph replay (`engine.v3_graph_replays`), K7–K9 in
   the phase. A replay launches through no wrapper, so each bucket the
   window replayed is replayed once more under the profiler: its device
   trace must be the eager call's of that bucket on the same inputs,
   activity by activity, K2 and K3 among them, and match that call's
   wrapper counts; the window's counts for phase 13 add that call's for
   each replay of its bucket; frames
   finite, nonnegative and not black, every skip tile in the ring exactly
   0. Then every tile of the cycle is marched again by its arm (those the
   ticks wrote must equal the ring's) and the culled map is held at ≥
   TILE_CULL_DB against the dense march over the same texel grid; the first
   v3 tile's K2 and K3 calls are recorded, held against their plain
   versions (K2 bitwise, K3 atol 2e-4, three runs bitwise equal) and timed
   in phase 13;
   11h. (after 11b) `python -m cloudscape_tpu_torch.probe_prebake`'s run
   at the serving point (`run_probe`): each prebake stage timed alone at
   three slice sizes and fitted to a call and a unit cost, then 70
   labelled ticks across a boundary; every sky-band tick must launch K10
   exactly once, no other tick K10, and K10's plain version never run;
   11i. (after 11h) frames_to_update 4 on phase 11b's scene
   (`run_short_cycle`): the warm start, then three cycles of fused ticks
   by CUDA events, labelled by their grouped prebake steps and their 384²
   tile's arm; no synchronous bake and no dropped step, each rotation takes
   the pending cycle's cone cache and buckets, the cone bitwise
   `_build_cone` of the same snapshot; the warm start's K2 calls (its v2
   tiles' 18,874,368-sample compactions among them) held bitwise against
   their plain version and its first K1 call (a v2 tile's [147456, 128])
   against K1's plain version; one more tick, the first with a v3 tile,
   its K2 and K3 calls (the v3 march of 147,456 rays in 16,384-ray
   chunks, and the bake steps') recorded and held as phase 11b holds its
   tile's;
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
   `load_file` into a new engine (rings and the cone texture bitwise, the
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
   whole map and tile, of one band of each config-5 row (phase 9b) and of
   `march_baked` (phase 8b), which serve the referee, the unstaged fast
   kernel, config 5 and the baked field, not the default engine, and so
   enter no pass;
   K3 1-D and [3, n] (one launch each) at the engine's and the headline's
   hot-list capacities and on the v3 tile's and config 5's recorded
   inputs;
   K4–K6 at the shipped sizes; K7–K9 on the calls recorded as they ran,
   one per table (the headline render's, its cone build's tiny volumes,
   the composite's display pairs, from phase 7b's eager chain, and
   march_baked's field), each first
   held against its plain version as phase 5b holds its tables (a texture
   also as brick rows), bound by the coordinates read, the output written
   and the distinct source texels the samples weigh (one bound, whatever
   the layout), with the plain version's and the wrapper's CUDA-event ms;
   a texture's call also, on the brick table of the same texels, with the
   brick kernel (its row under sample_brick3 / sample_brick2); for the clamp tables `torch.nn.functional.grid_sample`
   on the texture (within LIBRARY_TOL of the kernel), its CUDA-event ms and
   device µs; for K9 the stream yardstick `torch.addcmul(qx, qy, qz)` on
   the same planes (the same 12 B read and 4 B written a sample; not K9's
   function, never called by the port); K10 on the schedule's sky band and
   a 5-row band, K11 on the engine's LUT (bound: the frozen work of a
   texel, SERIAL_WORK, at the issue rate or the SFU rate, whichever is
   slower), K12 on phase 7b's 1280×720 call (bound: the directions read,
   the frame written and the distinct texels of its two pair fetches and
   the LUT; its plain ms the eager chain's), and K7's 1-ch 32³ repeat row
   printed again as the anchor against earlier runs; K2's library yardstick,
   `torch.nonzero(mask).view(-1)` on the finalize's mask (CUDA events,
   its host synchronisation included). Then the ranking, launches per
   pass × (device time − bound), each launch at the time of the shape it
   ran at (K3: one 1-D and one [3, n] launch per v3 march; K7–K9 by their
   launches per pass in power-of-two buckets of sample count, each bucket
   timed at its mean size on the kernel's main-row call cut to that many
   samples);
14. the port's own bench and sweep (`cloudscape_tpu_torch/bench.py`,
   `cloudscape_tpu_torch/sweep.py`): `bench.run()` at bench.py's sizes and
   the sweep's configs 1–3 (configs 4 and 5 are phases 9 and 9b), the
   record and each row printed on a line of its own; the phase fails on a
   null bench field (but `vs_baseline*`, which bench.py rates against a
   TPU target), a render that is not finite, either
   `quality_db_vs_exact*` below 40 dB (tests/test_bench_config.py's
   gate), no v3 bucket in `tile_bucket_hist`, a `per_tile_device_ms` that
   is not positive, a v2 or v3 row of configs 2–3 below 40 dB against the
   exact march (tests/test_march_v2.py's and test_bench_config.py's
   gate), or a kernel of K1–K9 that the phase did not launch;
then a JSON line with the kernels (each with `redesigned_in`, the change
that redesigned it for the card, or null; the brick kernels, off the
engine's path, under their own names), and as the last line {"ok": true,
"device": {...}}.

The kernels line's launch counts are read around the path each kernel
serves: K1 and K2 around phase 5, K3 around phases 7 and 8, K4–K6 around
phase 5's engine construction and config 4's pack, K7–K11 around phase 5;
`launches_tile_cull` around phase 11b (the wrappers' launches: its v3
tiles' graph replays launch through none); `launches_config5` by each call of
config 5's path in phase 9b (the pack, the cone cache, the two policies,
each row's warm call: zeroed just before the call, read just after); and
`launches_hier_engine` around phase 11e (the counts zeroed before each);
`launches_mesh` by phase 11g's mesh path (zeroed at its start, every
sharded call and the mesh engine read around the call, the single-card
references left out) and `launches_mesh_ticks` by its 70 mesh ticks. Phase
8c counts each stage's call on its own (zeroed just before it), after phase
8's counts are read. `launches_per_pass` counts one pass: phase 5, phase
7's first render_full_hemisphere and phase 11b's timed window (its graph
replays counted as the eager call of their bucket, whose device trace
each replay's matched), without the
one launch of K1–K3 and of each sampler kernel of phase 5's validation
probe (a tiny input, not a pass's shape). `launches_bench` is phase 14's
(zeroed just before the bench, read just after the sweep). Every engine
the script builds must pass its validation (`can_run`).

The process pins itself to one card (the first of CUDA_VISIBLE_DEVICES, or
card 0) before CUDA starts, so the device count it reports is the one card
it ran on.
"""

from __future__ import annotations

import json
import math
import os
import re
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
# The special-function unit (MUFU: the reciprocal, square-root, exp2 and
# log2 approximations): 16 results a clock on each SM (132 x 16 x 1.98 GHz).
SFU_OPS_PER_S = 132 * 16 * 1.98e9
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
REDESIGNED_IN = {"accumulate": 4, "compact": 4, "segscan": 5, "sample_tex3": 13,
                 "sample_tex2": 13, "sample_tiny3": 14, "sky_lut": 17,
                 "transmittance_lut": 17}
# Device kernel names of each wrapper, for picking its launches out of a
# profiler trace.
KERNEL_NAMES = {
    "accumulate": ("accumulate_kernel",),
    "compact": ("compact_kernel",),
    "segscan": ("segscan_kernel",),
    "noise_base": ("base_kernel",),
    "noise_detail": ("detail_kernel",),
    "noise_weather": ("weather_kernel",),
    "sample_tex3": ("tex3_kernel",),
    "sample_tex2": ("tex2_kernel",),
    "sample_tiny3": ("tiny3_kernel",),
    "sample_brick3": ("brick3_kernel",),
    "sample_brick2": ("brick2_kernel",),
    "sky_lut": ("sky_kernel",),
    "transmittance_lut": ("transmittance_kernel",),
    "composite": ("composite_kernel",),
    "grid_sample": ("grid_sampler_2d_kernel", "grid_sampler_3d_kernel"),
    # K9's stream yardstick, torch.addcmul (the L2 flush before each call is
    # a read, cuBLAS's dot, whose kernels none of these names).
    "addcmul": ("vectorized_elementwise_kernel", "unrolled_elementwise_kernel",
                "elementwise_kernel"),
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


def bound_us(nbytes: int, ops: int = 0, sfu: int = 0):
    """(µs, what bounds it): the least time the card could take, the largest
    of `nbytes` over the HBM rate, `ops` instructions over the ALU rate and
    `sfu` special-function results over the SFU rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e6
    by_ops = max(ops / ALU_OPS_PER_S, sfu / SFU_OPS_PER_S) * 1e6
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
# The losses are a trace's leading calls (or, once, its last), late in a
# long run: the profiler keeps a device activity only if its timestamp,
# converted to the host's clock, lies inside the active step, and that
# conversion drifts by milliseconds (on an H100, one trace of 40 calls kept
# only its last). So the active step opens and closes with TRACE_MARGIN_S of
# host time and no device work (the device synchronised), which a drift
# smaller than the margin cannot move a call across.
TRACE_MARGIN_S = 0.05


def device_us(fn, names, write_flush: bool = False, reps: int = 20):
    """Device time of one fn() call with a cold L2, from torch.profiler.

    Runs TRACE_WARM calls in the profiler's warm-up step, then traces
    TRACE_PAD + `reps` calls (TRACE_MARGIN_S of idle host time at each end
    of the step), each after reading (or, with `write_flush`,
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
    from torch.profiler import ProfilerActivity, profile, schedule

    from cloudscape_tpu_torch.utils.profiling import device_activities

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
                time.sleep(TRACE_MARGIN_S)
                for _ in range(n):
                    flush()
                    fn()
                torch.cuda.synchronize()
                time.sleep(TRACE_MARGIN_S)
                prof.step()
        return sorted(device_activities(prof.events()), key=lambda e: e.time_range.start)

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


def timed_row(shape: str, fn, names, nbytes: int, ops: int = 0, sfu: int = 0,
              **extra):
    """One row of the kernel table: device µs (cold L2) against the bound."""
    d = device_us(fn, names)
    b, by = bound_us(nbytes, ops, sfu)
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
    (65536, 128, 0, "a pass chunk of update_cycle's batched dense march"),
    (16384, 128, 0, "the dense march's pass chunk of a tile of 16,384 rays or more"),
    (147456, 128, 0, "a 384² tile's v2 march (frames_to_update 4)"),
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


# K10–K11 (csrc/atmosphere.cu) against their plain versions
# (`_sky_lut_rows_plain`, `_transmittance_lut_plain` run on the card). The
# kernels round each product and sum as eager torch does (built with
# -fmad=false) and call the CUDA math library torch's kernels call; on an
# H100 they measured bitwise their plain versions, but a transcendental
# inlined into the kernel need not round as torch's own build of it does,
# so they are held at ATMO_TOL x the plain version's largest |value|; a
# band is the same rows of a whole call bitwise, and three runs are
# bitwise alike.
ATMO_TOL = 1e-5
# The suns of the checks: tests/test_torch_brick_atmo.py's two (one at
# the horizon, where the ground and atmosphere hits graze).
ATMO_SUNS = ((0.3, 0.5, -0.8), (0.0, -0.05, 1.0))
# Every band height the engine's schedule can pick: the divisors of the
# sky-view LUT's 100 rows.
SKY_BANDS = tuple(h for h in range(1, 101) if 100 % h == 0)
ATMO_KERNELS = ("sky_lut", "transmittance_lut")
# K10's second timed shape: a band of 5 rows (1,000 texels), where a launch
# is a few blocks and its time the latency of one texel's work.
ATMO_BAND = 5
# Steps of each atmosphere kernel's march (csrc/atmosphere.cu's
# kInScatteringSteps, kTransmittanceSteps).
ATMO_STEPS = {"sky_lut": 30, "transmittance_lut": 40}
# The work of one texel of K10 / K11, frozen so that every form of the
# kernels is held to one yardstick: (the fewest SASS instructions, the fewest
# MUFU instructions) a texel executes in the one-thread-a-texel form the
# kernels first took (one step loop; counted by `least_instructions` on its
# build with this repository's nvcc flags, -fmad=false included:
# tools/bench_atmosphere.py recounts them on that form's source). K10 276 +
# 30 x 697 + 38 instructions and 4 + 30 x 22 + 0 MUFU, K11 113 + 40 x 144 +
# 36 and 3 + 40 x 4 + 4 (an H100 run of the tool; NVIDIA H100 80GB HBM3,
# 700.00 W). The lane-group form adds barriers, shuffles and shared-memory
# traffic, which are overhead, not work.
SERIAL_WORK = {"sky_lut": (21224, 664), "transmittance_lut": (5909, 167)}
SASS_INSTRUCTION = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_functions(text: str) -> dict:
    """`cuobjdump -sass` output → {function name: [(address, predicate,
    opcode, operands)]}."""
    out = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split("\n", 1)[0].strip()
        out[name] = [(int(m.group(1), 16), (m.group(2) or "").strip(), m.group(3),
                      m.group(4).strip()) for m in SASS_INSTRUCTION.finditer(part)]
    return out


def least_instructions(ins, steps: int, counted=None) -> dict:
    """The fewest SASS instructions one thread of a one-loop kernel executes
    (ins from `sass_functions`): the shortest path from the entry to the
    step loop's head, then `steps` times through its body, then on to an
    EXIT, each data-dependent branch taken the short way (so no out-of-line
    slow path a CALL reaches, no special-case block) and no back edge but
    the step loop's. The step loop is the widest backward branch; it must
    count its trips one step at a time (an `IADD3 Rk, Rk, 0x1` and a
    compare of Rk with `steps`), else raises. With `counted` (a predicate
    on the opcode) only the instructions it accepts are counted, and the
    path is the one with the fewest of those. Returns {"per_texel", "pre",
    "body", "post", "static"}."""
    at = {a: i for i, (a, _, _, _) in enumerate(ins)}

    def target(k):
        return int(ins[k][3].split()[-1], 16)

    back = [k for k, (a, _, op, _) in enumerate(ins)
            if op.startswith("BRA") and target(k) < a]
    require(back, "no step loop in the SASS")
    tail = max(back, key=lambda k: ins[k][0] - target(k))
    head = at[target(tail)]
    body_ops = [f"{op} {args}" for _, _, op, args in ins[head:tail + 1]]
    counters = {m.group(1) for m in (re.match(r"IADD3 (R\d+), \1, 0x1, RZ$", t)
                                     for t in body_ops) if m}
    require(any(re.match(rf"ISETP\.NE\.AND P\d, PT, ({'|'.join(counters) or '-'}), "
                         rf"{steps:#x}, PT$", t) for t in body_ops),
            f"the step loop does not run one of {steps} steps a trip")

    weight = [1 if counted is None or counted(op) else 0 for _, _, op, _ in ins]

    def costs(start):
        """Fewest counted instructions executed from ins[start] until each
        later instruction is reached, forward edges only."""
        cost = [math.inf] * len(ins)
        cost[start] = 0
        for k in range(start, len(ins)):
            _, pred, op, _ = ins[k]
            ends = op == "EXIT" or op.startswith(("RET", "BRA"))
            nxt = [k + 1] if pred or not ends else []
            if op.startswith("BRA") and target(k) > ins[k][0]:
                nxt.append(at[target(k)])
            for j in nxt:
                if j < len(ins):
                    cost[j] = min(cost[j], cost[k] + weight[k])
        return cost

    pre = costs(0)[head]
    body = costs(head)[tail] + weight[tail]
    after = costs(tail + 1)
    post = min(after[k] + weight[k] for k, x in enumerate(ins) if x[2] == "EXIT")
    require(max(pre, body, post) < math.inf, "no path through the step loop to an EXIT")
    return dict(per_texel=pre + steps * body + post, pre=pre, body=body, post=post,
                static=len(ins))


def least_mufu(ins, steps: int) -> dict:
    """The fewest special-function (MUFU.*) instructions one thread of a
    one-loop kernel executes: `least_instructions` counting those alone."""
    return least_instructions(ins, steps, counted=lambda op: op.startswith("MUFU"))


def atmo_work(name: str, texels: int, lut_texels: int):
    """(bytes, instructions, MUFU instructions) of one K10 / K11 call over
    `texels` texels: K10 reads the [h, w, 4] f32 LUT once and the sun
    vector; both write 16 B a texel; the instructions are SERIAL_WORK's a
    texel."""
    nbytes = 16 * texels + (16 * lut_texels + 12 if name == "sky_lut" else 0)
    ins, mufu = SERIAL_WORK[name]
    return nbytes, texels * ins, texels * mufu


def check_atmosphere(dev) -> dict:
    """Phase 4c: K11 at the engine's 256 x 64 and K10 over the whole 200 x
    100 LUT at both ATMO_SUNS, each against its plain version on the same
    inputs (K10 on K11's LUT) within ATMO_TOL x its largest |value|, three
    runs bitwise alike; then for every height of SKY_BANDS the bands of
    every row0 concatenated bitwise the whole K10 call, and its first,
    horizon and last bands against the plain version's same rows. Returns
    the largest errors (absolute and as a share of the peak) and K11's
    LUT."""
    import torch

    from cloudscape_tpu_torch.models import atmosphere

    def held(what, got, want):
        torch.cuda.synchronize()
        require(got.shape == want.shape and bool(torch.isfinite(got).all()),
                f"{what}: wrong shape or not finite")
        e, peak = float((got - want).abs().max()), float(want.abs().max())
        require(e <= ATMO_TOL * peak,
                f"{what}: max abs err {e:.3g} > {ATMO_TOL} x peak {peak:.4g}")
        return e, e / peak

    def thrice(what, fn):
        runs = [fn() for _ in range(3)]
        require(all(bitwise_equal(r, runs[0]) for r in runs[1:]),
                f"{what}: three runs are not bitwise alike")
        return runs[0]

    out = {}
    tlut = thrice("K11", lambda: atmosphere.transmittance_lut(device=dev))
    out["transmittance_lut"] = held("K11 vs plain", tlut,
                                    atmosphere._transmittance_lut_plain(device=dev))
    sky_errs = []
    for sun in ATMO_SUNS:
        s = torch.tensor(sun, dtype=torch.float32, device=dev)
        s = s / torch.linalg.norm(s)
        whole = thrice(f"K10 sun {sun}",
                       lambda: atmosphere.sky_lut_rows(tlut, s, 0, rows=100))
        plain = atmosphere._sky_lut_rows_plain(tlut, s, 0, rows=100)
        errs = [held(f"K10 vs plain, sun {sun}", whole, plain)]
        peak = float(plain.abs().max())
        for h in SKY_BANDS:
            bands = torch.cat([atmosphere.sky_lut_rows(tlut, s, r0, rows=h)
                               for r0 in range(0, 100, h)])
            require(bitwise_equal(bands, whole),
                    f"K10 bands of {h} rows are not the whole call's bits (sun {sun})")
            for r0 in sorted({0, (50 // h) * h, 100 - h}):
                got = atmosphere.sky_lut_rows(tlut, s, r0, rows=h)
                want = atmosphere._sky_lut_rows_plain(tlut, s, r0, rows=h)
                torch.cuda.synchronize()
                e = float((got - want).abs().max())
                require(e <= ATMO_TOL * peak,
                        f"K10 band {r0}+{h} vs plain, sun {sun}: max abs err {e:.3g} "
                        f"> {ATMO_TOL} x peak {peak:.4g}")
                errs.append((e, e / peak))
        sky_errs += errs
    out["sky_lut"] = (max(e for e, _ in sky_errs), max(r for _, r in sky_errs))
    out["tlut"] = tlut
    return out


def time_atmosphere(dev, tlut, rows: int):
    """K10's device µs on a band of `rows` rows (the sun of the checks) and
    on a band of ATMO_BAND rows, and K11's, each against its frozen work
    (`atmo_work`: the larger of the issue-rate and the SFU term), with the
    wrapper's and the plain version's CUDA-event ms (no PyTorch call
    computes either LUT)."""
    import torch

    from cloudscape_tpu_torch.models import atmosphere

    sun = torch.tensor(ATMO_SUNS[0], dtype=torch.float32, device=dev)
    lut_texels = tlut.shape[0] * tlut.shape[1]

    def sky(n):
        return (f"{n} x 200 band of the 100 x 200 LUT", "sky_lut", n * 200, lut_texels,
                lambda: atmosphere.sky_lut_rows(tlut, sun, 0, rows=n),
                lambda: atmosphere._sky_lut_rows_plain(tlut, sun, 0, rows=n))

    calls = [sky(rows)] + ([sky(ATMO_BAND)] if rows != ATMO_BAND else []) + [
        ("64 x 256", "transmittance_lut", 64 * 256, 0,
         lambda: atmosphere.transmittance_lut(device=dev),
         lambda: atmosphere._transmittance_lut_plain(device=dev))]
    out = {k: [] for k in ATMO_KERNELS}
    for shape, k, texels, lut, fn, plain in calls:
        nbytes, ins, mufu = atmo_work(k, texels, lut)
        out[k].append(timed_row(shape, fn, KERNEL_NAMES[k], nbytes, ins, mufu,
                                issue_us=ins / ALU_OPS_PER_S * 1e6,
                                sfu_us=mufu / SFU_OPS_PER_S * 1e6,
                                event_ms=cuda_time_ms(fn),
                                plain_ms=cuda_time_ms(plain, reps=3)))
    return out


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
    s_0, n_0, z_0 = read_counts(), read_samples(), read_sizes()
    t0 = time.perf_counter()
    out = eng.render_full_hemisphere()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    k1 = accum.launches - k1_0
    k2, k3 = compact.launches - k2_0, segscan.launches - k3_0
    samples = {k: v - s_0[k] for k, v in read_counts().items() if k in SAMPLERS}
    sizes = {k: v - n_0[k] for k, v in read_samples().items()}
    size_counts = sizes_since(z_0)
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
                samples=samples, sample_sizes=sizes, size_counts=size_counts,
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


def record_accumulate(fn, limit: int = 1):
    """Run fn() with the first `limit` K1 calls of `models/march_fast.py`
    recorded as (inputs, output); returns (fn's result, the calls)."""
    from cloudscape_tpu_torch.models import march_fast

    calls, real = [], march_fast.accumulate

    def rec(*args):
        out = real(*args)
        if len(calls) < limit:
            calls.append((tuple(a.clone() for a in args), out.clone()))
        return out

    march_fast.accumulate = rec
    try:
        return fn(), calls
    finally:
        march_fast.accumulate = real


def check_recorded_accumulate(what: str, calls) -> float:
    """K1's recorded calls against its plain version on the same inputs,
    within phase 3's 2e-5 of the larger of 1 and the output's peak (a
    path's radiance can pass 1); returns the largest abs error."""
    import torch

    from cloudscape_tpu_torch.ops import accum

    err = 0.0
    for i, (args, got) in enumerate(calls):
        want = accum.accumulate_reference(*args)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        tol = 2e-5 * max(1.0, float(want.abs().max()))
        require(bool(torch.isfinite(got).all()) and e <= tol,
                f"K1 [{args[0].shape[0]},{args[0].shape[1]}] ({what}, call {i}): "
                f"max abs err {e} > {tol:.3g} or not finite")
        err = max(err, e)
    return err


def zero_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    import collections

    from cloudscape_tpu_torch.ops import (accum, atmosphere_kernel, brick, compact,
                                          composite_kernel, noise_kernel, segscan)

    accum.launches = compact.launches = segscan.launches = 0
    composite_kernel.launches = dict.fromkeys(composite_kernel.launches, 0)
    accum.sizes, compact.sizes, segscan.sizes = (collections.Counter() for _ in range(3))
    noise_kernel.launches = dict.fromkeys(noise_kernel.launches, 0)
    atmosphere_kernel.launches = dict.fromkeys(atmosphere_kernel.launches, 0)
    brick.launches = dict.fromkeys(brick.launches, 0)
    brick.samples = dict.fromkeys(brick.samples, 0)
    brick.sizes = {k: collections.Counter() for k in brick.sizes}


def read_counts() -> dict:
    """Every kernel's launch count, by its name in the kernels line."""
    from cloudscape_tpu_torch.ops import (accum, atmosphere_kernel, brick, compact,
                                          composite_kernel, noise_kernel, segscan)

    return dict(accumulate=accum.launches, compact=compact.launches,
                segscan=segscan.launches,
                **{f"noise_{k}": v for k, v in noise_kernel.launches.items()},
                **{f"sample_{k}": v for k, v in brick.launches.items()},
                sky_lut=atmosphere_kernel.launches["sky"],
                transmittance_lut=atmosphere_kernel.launches["transmittance"],
                composite=composite_kernel.launches["composite"])


def read_samples() -> dict:
    """The samples K7–K9's launches were given (counted where they launch,
    beside their launches), by kernel name."""
    from cloudscape_tpu_torch.ops import brick

    return {f"sample_{k}": v for k, v in brick.samples.items()}


def read_sizes() -> dict:
    """Each sampler kernel's launches by their sample count, and K1–K3's by
    their element count (a Counter of n → launches, counted where they
    launch), by kernel name."""
    import collections

    from cloudscape_tpu_torch.ops import accum, brick, compact, segscan

    return dict(accumulate=collections.Counter(accum.sizes),
                compact=collections.Counter(compact.sizes),
                segscan=collections.Counter(segscan.sizes),
                **{f"sample_{k}": collections.Counter(v) for k, v in brick.sizes.items()})


def sizes_since(before: dict) -> dict:
    """The K1–K3 and sampler launches by size since `before` (a
    `read_sizes()`)."""
    return {k: v - before[k] for k, v in read_sizes().items()}


def traced_kernels(fn):
    """(fn's result, the card's activities of that one call by name, and its
    hand-written kernels' launches by their name in the kernels line), from
    a torch.profiler trace of the card alone. A CUDA graph's replay is on
    it node by node. A trace can lose its earliest records, so idle
    margins and four marker kernels open it and one closes it; a trace
    that does not start and end with a marker is taken again (fn is
    called again) with margins four times as long (up to 0.8 s), five
    times at most."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from cloudscape_tpu_torch.utils.profiling import device_activities

    margin = TRACE_MARGIN_S
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(margin)
            for _ in range(4):
                torch.cuda._sleep(1000)
            out = fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(margin)
        events = sorted(device_activities(prof.events()), key=lambda e: e.time_range.start)
        if events and "spin_kernel" in events[0].name and "spin_kernel" in events[-1].name:
            break
        margin = min(4 * margin, 0.8)
    else:
        require(False, "traced_kernels: every trace lost its opening markers")
    names = collections.Counter(e.name for e in events if "spin_kernel" not in e.name)
    ours = collections.Counter()
    for name, n in names.items():
        m = re.search(r"(?:^|[\s:])(\w+)[<(]", name)
        for k in read_counts():
            if m and m.group(1) in KERNEL_NAMES[k]:
                ours[k] += n
    return out, names, ours


def split_copies(names):
    """(the copies and fills among a trace's activities by name, a Counter
    of the others): a copy is "Memcpy ..." where a stream runs it and a
    kernel "memcpy..." where a CUDA graph's copy node does."""
    import collections

    copies = sum(n for k, n in names.items() if k.lower().startswith(("memcpy", "memset")))
    return copies, collections.Counter(
        {k: n for k, n in names.items() if not k.lower().startswith(("memcpy", "memset"))})


def counted(fn):
    """(fn's result, the kernel launches of that one call): the counts are
    zeroed just before the call and read just after it."""
    import torch

    zero_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts()


# K7–K9 (csrc/sample.cu) against their plain versions. A texture kernel
# (K7 tex3_kernel, K8 tex2_kernel) and its plain version take the same
# steps in the same order and rounding, so they agree bitwise; they are held
# at TEXTURE_TOL relative, the most the brick kernels have differed from
# their plain versions on the card. So do K9 (tiny3_kernel) and its plain
# version, which are held bitwise. The brick kernels sum a channel's 8
# corners (4 in 2-D) in lane order where their plain versions' torch.sum
# reduces all 128 lanes in another tree: the two agree within a few ulps of
# the sample, not bitwise. So for them |kernel − plain| ≤ SAMPLE_TOL ·
# max(1, |plain|): 1e-6 absolute on the [0, 1] noise and weather tables, as
# tests/test_torch_brick_atmo.py holds the plain samplers to JAX's, and
# relative on the cone densities and the display pairs' HDR radiance. (The
# brick plain version multiplies every lane, so a non-finite texel anywhere
# in a row would turn its sample NaN where the kernel, which reads only the
# corners, would not; the tables are finite.) A texture kernel also gives
# the brick kernel's bits on the brick table of the same texels: it rounds
# its hat weights at the lanes that table gives them.
SAMPLE_TOL = 1e-6
TEXTURE_TOL = 2.4e-7
# The library yardstick (grid_sample, phase 13) against the kernel, scaled
# as SAMPLE_TOL is: grid_sample takes the coordinate through 2q − 1 and
# back, ((g + 1)·n − 1) / 2, which moves f by a few ulps of q·n (up to
# ~5e-5 at n = 768), so it is not held to SAMPLE_TOL; the gate shows that
# it computes the same function (a swapped axis or a half-texel shift is
# off by 1e-2 or more).
LIBRARY_TOL = 1e-3
# The checks' planes: [SAMPLE_ROWS, SAMPLE_COLS] samples (a [rays, steps]
# plane, 299,957 samples, no multiple of the kernels' 256-thread blocks).
SAMPLE_ROWS, SAMPLE_COLS = 587, 511
# The planes of a pass chunk of `update_cycle`'s batched dense march
# (BATCH_DENSE_CHUNK rays × 128 steps, 8,388,608 samples), and the tables
# that phase 5b checks again at that shape.
BATCH_ROWS, BATCH_COLS = 65536, 128
BATCH_TABLES = ("weather", "cone cache", "large mip 0", "large mip 5")
# The samplers' names in the kernels line: K7 and K8 on channel-last
# textures (the engine's tables), K9, then K7 and K8 on the JAX package's
# brick tables (the public `sample_brick*` API, off the engine's path).
SAMPLERS = ("sample_tex3", "sample_tex2", "sample_tiny3", "sample_brick3",
            "sample_brick2")
# The samplers of the engine's path: each must launch where the path runs.
MAIN_SAMPLERS = SAMPLERS[:3]
# Card against CPU on a small octahedral map: V3_SMALL² texels × STEPS
# steps of the v3 march, a procedural pack (16, 16, 64, seed 1), coverage
# 0.6 and a (8, 64, 64) cone cache; every input made on the card and
# copied to the CPU, one policy for both.
V3_SMALL = 192
V3_SMALL_DB = 60.0


def sampler_fns(kname: str):
    """(wrapper, plain version, coordinate planes) of a sampler kernel."""
    from cloudscape_tpu_torch.ops import brick

    return {"sample_tex3": (brick.sample_tex3_xyz, brick.sample_tex3_xyz_reference, 3),
            "sample_tex2": (brick.sample_tex2_xy, brick.sample_tex2_xy_reference, 2),
            "sample_brick3": (brick.sample_brick3_xyz,
                              brick.sample_brick3_xyz_reference, 3),
            "sample_brick2": (brick.sample_brick2_xy,
                              brick.sample_brick2_xy_reference, 2),
            "sample_tiny3": (brick.sample_tiny3_xyz,
                             brick.sample_tiny3_xyz_reference, 3)}[kname]


def sampler_of(tab) -> str:
    """The kernel that samples a table."""
    from cloudscape_tpu_torch.ops import brick

    for cls, kname in ((brick.Texture3D, "sample_tex3"), (brick.Texture2D, "sample_tex2"),
                       (brick.BrickTable3D, "sample_brick3"),
                       (brick.BrickTable2D, "sample_brick2")):
        if isinstance(tab, cls):
            return kname
    return "sample_tiny3"


def is_texture(tab) -> bool:
    return sampler_of(tab) in ("sample_tex3", "sample_tex2")


def table_values(tab):
    """The tensor that holds a table's values."""
    kname = sampler_of(tab)
    if kname == "sample_tiny3":
        return tab.row
    return tab.texels if is_texture(tab) else tab.table


def table_kind(tab) -> str:
    """A table's kind: channels, dims, layout (texture, tiny, or brick and
    stride), wrap and type."""
    dtype = str(table_values(tab).dtype).replace("torch.", "")
    dims = "x".join(map(str, tab.dims))
    if sampler_of(tab) == "sample_tiny3":
        return f"{tab.channels}-ch tiny {dims} {dtype}"
    if is_texture(tab):
        return f"{tab.channels}-ch {dims} texture, {tab.wrap}, {dtype}"
    return (f"{tab.channels}-ch {dims} in {'x'.join(map(str, tab.brick))} bricks, "
            f"stride {'x'.join(map(str, tab.stride))}, {tab.wrap}, {dtype}")


def brick_table(tex):
    """A texture packed into the JAX package's brick table of its (ndim,
    channels), in its texels' type: phases 5b and 13 hold and time the
    brick kernels on it, on the same texels and calls. Its stride is the
    texture's weight stride (`brick.weight_strides`), and its brick one
    texel wider."""
    from cloudscape_tpu_torch.ops import brick

    stride = brick.weight_strides(len(tex.dims), tex.channels)
    build = brick.build_brick3 if len(tex.dims) == 3 else brick.build_brick2
    return build(tex.texels, tuple(s + 1 for s in stride), stride, wrap=tex.wrap)


def sample_planes(dev, k: int, lo: float, hi: float, seed: int,
                  shape=(SAMPLE_ROWS, SAMPLE_COLS)):
    """k coordinate planes of `shape` (at least 72 columns), uniform in
    [lo, hi], with texel-centre and edge values in their first row."""
    import torch

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        q = rng.uniform(lo, hi, shape).astype(np.float32)
        q[0, :64] = (np.arange(64, dtype=np.float32) + 0.5) / 64.0
        q[0, 64:72] = (0.0, 1.0, -1e-9, 1.0 + 1e-7, -0.25, 1.25, 0.5 / 64, 1 - 0.5 / 64)
        out.append(torch.from_numpy(q).to(dev))
    return out


def check_sampler(what: str, tab, qs) -> tuple:
    """One sampler kernel against its plain version on `tab` at the planes
    `qs`: within TEXTURE_TOL (a texture) or SAMPLE_TOL (scaled as
    SAMPLE_TOL says), three runs bitwise equal, and the same bits from
    views of the planes (x a strided component of a stacked tensor, y a
    transposed view the wrapper copies); K9 bitwise its plain version.
    Returns (the largest |kernel − plain| / max(1, |plain|), the largest
    |kernel − plain|, the kernel's output)."""
    import torch

    fn, ref, _ = sampler_fns(sampler_of(tab))
    runs = [fn(tab, *qs) for _ in range(3)]
    want = ref(tab, *qs)
    views = [torch.stack([qs[0], -qs[0]], dim=-1)[..., 0],
             qs[1].transpose(0, -1).contiguous().transpose(0, -1)] + list(qs[2:])
    view_out = fn(tab, *views)
    torch.cuda.synchronize()
    c = tab.channels
    require(runs[0].shape == qs[0].shape + (c,) and runs[0].dtype == torch.float32,
            f"{what}: output {tuple(runs[0].shape)} {runs[0].dtype}")
    require(bool(torch.isfinite(runs[0]).all()), f"{what}: not finite")
    require(all(bitwise_equal(r, runs[0]) for r in runs[1:]),
            f"{what}: three runs differ")
    require(bitwise_equal(view_out, runs[0]), f"{what}: views differ from the planes")
    if sampler_of(tab) == "sample_tiny3":
        require(bitwise_equal(runs[0], want), f"{what}: K9 not bitwise its plain version")
    diff = (runs[0] - want).abs()
    err = float((diff / want.abs().clamp(min=1.0)).max())
    tol = TEXTURE_TOL if is_texture(tab) else SAMPLE_TOL
    require(err <= tol, f"{what}: |kernel - plain| {err:.3g} > {tol}")
    return err, float(diff.max()), runs[0]


def check_texture(what: str, tex, qs) -> list:
    """`check_sampler` on a texture and on its brick table (`brick_table`),
    whose kernel must give the texture kernel's bits. Returns both rows."""
    t_err, t_abs, t_out = check_sampler(what, tex, qs)
    bt = brick_table(tex)
    b_err, b_abs, b_out = check_sampler(f"{what} as brick rows", bt, qs)
    require(bitwise_equal(b_out, t_out),
            f"{what}: the brick kernel differs from the texture kernel")
    return [(sampler_of(tex), table_kind(tex), t_err, t_abs),
            (sampler_of(bt), table_kind(bt), b_err, b_abs)]


def run_sampler_checks(dev, eng) -> list:
    """Phase 5b: K7–K9 against their plain versions on every table the
    phase-5 engine samples: each mip of its pack's textures (tiny mips
    through K9), the same in bfloat16, the weather texture, its cone cache
    and the display pair textures of its fused tick; each texture also as
    the JAX package's brick table, through the brick kernels
    (`check_texture`)."""
    import torch

    from cloudscape_tpu_torch.models.march_fast import BrickPack

    bricks = eng._bricks
    bf16 = BrickPack.from_noise(eng.noise, dtype=torch.bfloat16)
    cp, sp = eng._display_pair_tables()
    tables = [(f"{name} mip {i}{suffix}", t)
              for pack, suffix in ((bricks, ""), (bf16, " bfloat16"))
              for name in ("large", "small")
              for i, t in enumerate(getattr(pack, name))]
    tables += [("weather", bricks.weather), ("cone cache", eng._cone_cache.table),
               ("display pair clouds", cp), ("display pair sky", sp)]
    rows = []
    for seed, (name, tab) in enumerate(tables):
        clamp = getattr(tab, "wrap", "repeat") == "clamp"
        k = sampler_fns(sampler_of(tab))[2]
        shapes = [(name, (SAMPLE_ROWS, SAMPLE_COLS))]
        if name in BATCH_TABLES:
            shapes.append((f"{name} at [{BATCH_ROWS}, {BATCH_COLS}]", (BATCH_ROWS, BATCH_COLS)))
        for what, shape in shapes:
            qs = sample_planes(dev, k, *((-0.25, 1.25) if clamp else (-1.5, 2.5)), seed,
                               shape=shape)
            if is_texture(tab):
                checked = check_texture(what, tab, qs)
            else:
                err, abs_err, _ = check_sampler(what, tab, qs)
                checked = [(sampler_of(tab), table_kind(tab), err, abs_err)]
            rows += [dict(table=what, kind=kind, kernel=kname, err=err, abs_err=abs_err)
                     for kname, kind, err, abs_err in checked]
    return rows


# Phase 5b's K9 cases beside the engine's tables (the engine's tiny volumes
# are 4³, 2³ and 1³, which take compile-time dims): (dims, channels, dtype,
# samples, each plane's float offset in its buffer, whether the planes
# start with FAR_Q, what it covers). Each is held bitwise (`check_sampler`).
TINY_CASES = (
    ((2, 1, 3), 1, "float32", 299957, 0, False,
     "runtime dims, float4 planes, a ragged tail"),
    ((2, 1, 3), 2, "bfloat16", 4099, 0, False, "runtime dims, 2 channels, bfloat16"),
    ((4, 4, 4), 1, "float32", 4097, 0, False,
     "n = 1 mod 4: the tail one sample at a time"),
    ((2, 2, 2), 2, "float32", 4098, 0, False, "n = 2 mod 4, 2 channels"),
    ((4, 4, 4), 1, "float32", 299957, 1, False,
     "planes 4 B past 16-B alignment: scalar loads"),
    ((1, 1, 1), 2, "bfloat16", 4096, 3, False, "planes 12 B past alignment, n = 0 mod 4"),
    ((4, 4, 4), 1, "float32", 4100, 0, True, "|q·4| ≥ 2^31 of both signs: the 64-bit mask"),
)
# Coordinates whose q·4 lies past 2^31 (below 2^63) on either side: the
# compile-time wrap's 64-bit branch.
FAR_Q = (2.0 ** 29, -2.0 ** 29, 2.0 ** 29 + 64, -(2.0 ** 29 + 64), 3e9, -3e9, 1e12,
         -1e12, 2.5e15, -2.5e15, 1e18, -1e18)


def run_tiny_cases(dev) -> list:
    """Phase 5b: K9 on TINY_CASES: a random volume (seeded) and planes of
    texel centres, edges and values in [−1.5, 2.5], each plane a view at its
    offset into a larger buffer (an offset view reaches the kernel as it
    is); bitwise its plain version, three runs and views bitwise."""
    import torch

    from cloudscape_tpu_torch.ops import brick

    rows = []
    for seed, (dims, c, dtype, n, offset, far, what) in enumerate(TINY_CASES):
        rng = np.random.default_rng(100 + seed)
        vol = torch.from_numpy(rng.random(dims + (c,)).astype(np.float32)).to(dev)
        tv = brick.build_tiny3(vol)
        tv = brick.TinyVolume3D(row=tv.row.to(getattr(torch, dtype)), dims=tv.dims,
                                channels=c)
        qs = []
        for j, q in enumerate(sample_planes(dev, 3, -1.5, 2.5, 200 + seed)):
            buf = torch.zeros(n + 8, dtype=torch.float32, device=dev)
            buf[offset:offset + n] = q.reshape(-1)[:n]
            if far:
                # Each plane's far values in another order, beside normal ones.
                buf[offset + 4 * j:offset + 4 * j + len(FAR_Q)] = torch.tensor(
                    FAR_Q[j:] + FAR_Q[:j], dtype=torch.float32)
            qs.append(buf[offset:offset + n])
        require(all(q.data_ptr() % 16 == 4 * offset % 16 for q in qs),
                f"K9 case {what}: plane alignment")
        err, abs_err, _ = check_sampler(f"K9 {what}", tv, qs)
        rows.append(dict(table=what, kind=table_kind(tv), samples=n, offset=offset,
                         err=err, abs_err=abs_err))
    return rows


def run_v3_small(dev) -> dict:
    """Phase 5b: the v3 march of a V3_SMALL² octahedral texel grid on the
    card against the same call on the CPU, ≥ V3_SMALL_DB; the card's call
    must launch K7–K9's texture and tiny wrappers (K9 in its cone cache's
    build)."""
    import dataclasses

    import torch

    from cloudscape_tpu_torch.models import atmosphere
    from cloudscape_tpu_torch.models.density import MarchParams
    from cloudscape_tpu_torch.models.march_fast import (
        BrickPack, ConeCache, build_cone_cache, march_bricks_v3, v3_auto_policy)
    from cloudscape_tpu_torch.models.packs import procedural_noise_pack
    from cloudscape_tpu_torch.ops.octmap import texel_directions
    from cloudscape_tpu_torch.utils.image import psnr

    cpu = torch.device("cpu")
    noise = procedural_noise_pack(1, 16, 16, 64, device=dev)
    sun = np.array([0.3, 0.4, -0.85])
    sun /= np.linalg.norm(sun)
    scene = dict(cloud_pos=np.array([1.5, -0.3]), detailed_pos=np.array([0.4, 0.2]),
                 weather_pos=np.array([0.01, 0.02]), time=12.5, cloud_coverage=0.6,
                 light_direction=sun, ground_color=np.array([0.27, 0.19, 0.027]))
    params = MarchParams.create(device=dev, **scene)
    bricks = BrickPack.from_noise(noise)
    sky = atmosphere.sky_lut(atmosphere.transmittance_lut(device=dev),
                             torch.tensor(sun, dtype=torch.float32, device=dev))
    zero_counts()
    cone = build_cone_cache(params, bricks, 6, res=(8, 64, 64), chunk=4096)
    torch.cuda.synchronize()
    cone_counts = read_counts()
    noise_cpu = type(noise)(large=tuple(v.cpu() for v in noise.large),
                            small=tuple(v.cpu() for v in noise.small),
                            weather=noise.weather.cpu())
    cone_cpu = ConeCache(table=dataclasses.replace(cone.table,
                                                   texels=cone.table.texels.cpu()),
                         extent=cone.extent)
    inputs = {dev: (params, bricks, sky, cone),
              cpu: (MarchParams.create(device=cpu, **scene),
                    BrickPack.from_noise(noise_cpu), sky.cpu(), cone_cpu)}
    dirs_cpu = texel_directions(V3_SMALL, device=cpu)
    rk, ck, hk, _, _ = v3_auto_policy(dirs_cpu, inputs[cpu][0], inputs[cpu][1],
                                      steps=STEPS)
    n = V3_SMALL * V3_SMALL

    def march(d):
        p, b, s, c = inputs[d]
        return march_bricks_v3(texel_directions(V3_SMALL, device=d), p, b, s,
                               steps=STEPS, chunk=min(n, 32768), cell_keep_frac=ck,
                               hot_keep_frac=hk, cone_cache=c, ray_keep_frac=rk,
                               ray_stride=2)

    card, counts = counted(lambda: march(dev))
    card, host = card.cpu().numpy(), march(cpu).numpy()
    require(np.isfinite(card).all(), "the small v3 map on the card is not finite")
    frac = float((host[..., 3] > 0.1).mean())
    require(frac > 0.0, "the small v3 map has no clouds")
    db = psnr(card, host)
    require(db >= V3_SMALL_DB, f"the small v3 map, card vs CPU {db:.2f} dB < "
            f"{V3_SMALL_DB}")
    samples = {k: counts[k] + cone_counts[k] for k in MAIN_SAMPLERS}
    require(all(v > 0 for v in samples.values()),
            f"the small v3 map (and its cone cache) launched K7–K9 {samples}")
    return dict(db=db, policy=(rk, ck, hk), cloud_frac=frac, launches=samples)


def record_samples(fn):
    """Run fn() with the first sampler call on each table kind recorded as
    (kernel, kind, table, its planes copied): the sampler names the
    marches, the baked field and the composite call through are replaced
    for the call. Returns (fn's result, the calls)."""
    from cloudscape_tpu_torch.models import field, march_fast
    from cloudscape_tpu_torch.ops import brick

    calls, seen = [], set()

    def wrap(kname, real):
        def rec(tab, *qs):
            kind = table_kind(tab)
            if (kname, kind) not in seen:
                seen.add((kname, kind))
                calls.append((kname, kind, tab, [q.clone() for q in qs]))
            return real(tab, *qs)
        return rec

    names = (("sample_tex3", "sample_tex3_xyz", (march_fast, field)),
             ("sample_tex2", "sample_tex2_xy", (march_fast, brick)),
             ("sample_tiny3", "sample_tiny3_xyz", (march_fast,)))
    saved = [(mod, attr, getattr(mod, attr)) for _, attr, mods in names for mod in mods]
    for kname, attr, mods in names:
        for mod in mods:
            setattr(mod, attr, wrap(kname, getattr(mod, attr)))
    try:
        return fn(), calls
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)


def sample_bytes(tab, qs) -> int:
    """The least bytes a sampler call moves, whatever the table's layout:
    its coordinate planes read once, its [n, C] f32 output written once, and
    the distinct source texels its samples weigh (each sample's 8 corners,
    4 in 2-D, in the texture's own dims, all C channels) read once; the
    whole row of a tiny volume. The texture kernel, the brick kernel on the
    same texels and grid_sample are held to this one bound."""
    import itertools

    import torch

    from cloudscape_tpu_torch.ops import brick

    n = qs[0].numel()
    c = tab.channels
    if sampler_of(tab) == "sample_tiny3":
        return 4 * len(qs) * n + 4 * c * n + tab.row.numel() * tab.row.element_size()
    axes = []
    # The planes are x first; the texture's dims z first.
    for q, dim in zip(reversed(qs), tab.dims):
        i0, _ = brick._axis_coords(q.reshape(-1), dim, tab.wrap)
        i1 = torch.where(i0 + 1 < dim, i0 + 1, dim - 1 if tab.wrap == "clamp" else 0)
        axes.append((i0, i1, dim))
    corners = []
    for d in itertools.product((0, 1), repeat=len(axes)):
        idx = torch.zeros(n, dtype=torch.int64, device=qs[0].device)
        for (i0, i1, dim), dk in zip(axes, d):
            idx = idx * dim + (i1 if dk else i0)
        corners.append(idx)
    texels = int(torch.unique(torch.cat(corners)).numel()) * c
    return 4 * len(qs) * n + 4 * c * n + texels * tab.texels.element_size()


def grid_sample_fn(tex, qs):
    """The one PyTorch call that computes a clamp-wrap sample:
    `torch.nn.functional.grid_sample` (bilinear, align_corners=False,
    padding_mode="border") on the texture's texels, the coordinates as one
    [1, (1,) 1, n, k] grid of 2q − 1."""
    import torch

    img = tex.texels
    src = img.permute(-1, *range(img.dim() - 1))[None].contiguous()  # [1, C, ...]
    grid = torch.stack([2.0 * q.reshape(-1) - 1.0 for q in qs], dim=-1)
    grid = grid.reshape((1,) * (src.dim() - 2) + (-1, len(qs)))

    def call():
        return torch.nn.functional.grid_sample(src, grid, mode="bilinear",
                                               padding_mode="border",
                                               align_corners=False)
    return call


def sampler_row(kname: str, kind: str, tab, qs, nbytes: int, **extra):
    """A sampler kernel's device µs (cold L2) on one call against the bound
    `nbytes`, with the wrapper's and the plain version's CUDA-event ms."""
    fn, ref, _ = sampler_fns(kname)
    row = timed_row(f"{kind}, {qs[0].numel()} samples", lambda: fn(tab, *qs),
                    KERNEL_NAMES[kname], nbytes, samples=qs[0].numel(), **extra)
    row["event_ms"] = cuda_time_ms(lambda: fn(tab, *qs))
    row["plain_ms"] = cuda_time_ms(lambda: ref(tab, *qs), reps=3)
    return row


def time_sampler(kname: str, kind: str, tab, qs, serves: str):
    """Phase 13 on one recorded call. The kernel's row (`sampler_row`) on
    the layout-free bound (`sample_bytes`); for a clamp texture the library
    yardstick, grid_sample, which must agree with the kernel within
    LIBRARY_TOL (relative, as SAMPLE_TOL scales): its CUDA-event ms and
    device µs; for a texture the brick kernel's row on the brick table of
    the same texels (`brick`), on the same bound."""
    import torch

    n = qs[0].numel()
    nbytes = sample_bytes(tab, qs)
    row = sampler_row(kname, kind, tab, qs, nbytes, serves=serves)
    row.update(library_ms=None, library_device_us=None,
               library="none: no repeat wrap in PyTorch")
    if kname == "sample_tiny3":
        # K9's stream yardstick: one elementwise kernel over the same
        # planes, reading the same 12 B and writing the same 4 B a sample.
        # Not K9's function, and the port never calls it.
        flat = [q.reshape(-1) for q in qs]
        row["addcmul_us"] = device_us(lambda: torch.addcmul(*flat),
                                      KERNEL_NAMES["addcmul"])["span_us"]
    fn = sampler_fns(kname)[0]
    if getattr(tab, "wrap", "repeat") == "clamp":
        call = grid_sample_fn(tab, qs)
        got = call().reshape(tab.channels, n).t()
        want = fn(tab, *qs).reshape(n, tab.channels)
        err = float(((got - want).abs() / want.abs().clamp(min=1.0)).max())
        require(err <= LIBRARY_TOL, f"grid_sample differs from {kname} on {kind} "
                f"by {err:.3g} > {LIBRARY_TOL}")
        row["library_ms"] = cuda_time_ms(call)
        row["library_device_us"] = device_us(call, KERNEL_NAMES["grid_sample"])["span_us"]
        row["library"] = (f"torch.nn.functional.grid_sample (bilinear, border, "
                          f"align_corners=False) on the texture; max rel diff "
                          f"{err:.3g}")
    if is_texture(tab):
        bt = brick_table(tab)
        bname = sampler_of(bt)
        row["brick"] = sampler_row(bname, table_kind(bt), bt, qs, nbytes, serves=serves)
        row["brick"].update({k: row[k] for k in ("library_ms", "library_device_us",
                                                 "library")})
    return row


def price_sizes(kname: str, tab, qs, sizes) -> dict:
    """Phase 13's price of a sampler kernel over a pass: its launches there
    by sample count (`sizes`, a Counter) in power-of-two buckets, each
    bucket timed at its mean size on the kernel's main-row call, its planes
    cut to that many samples (device µs, cold L2, against that cut call's
    bound). Returns the groups [(launches, row)] for `loss_per_pass_us`."""
    buckets = {}
    for m, count in sizes.items():
        if m > 0 and count > 0:
            b = buckets.setdefault(max(m - 1, 1).bit_length(), [0, 0])
            b[0] += count
            b[1] += count * m
    fn = sampler_fns(kname)[0]
    flat = [q.reshape(-1) for q in qs]
    groups = []
    for _, (count, total) in sorted(buckets.items()):
        m = min(max(round(total / count), 1), flat[0].numel())
        cut = [q[:m] for q in flat]
        groups.append((count, timed_row(f"{m} samples", lambda: fn(tab, *cut),
                                        KERNEL_NAMES[kname], sample_bytes(tab, cut))))
    return groups


def headline_params(dev, cov: float):
    """The bench.py headline scene's MarchParams at cloud coverage `cov`."""
    from cloudscape_tpu_torch.models.density import MarchParams

    sun = np.array([0.3, 0.4, -0.85])
    return MarchParams.create(
        cloud_pos=np.array([1.5, -0.3]), detailed_pos=np.array([0.4, 0.2]),
        weather_pos=np.array([0.01, 0.02]), time=12.5, cloud_coverage=cov,
        light_direction=sun / np.linalg.norm(sun),
        ground_color=np.array([0.27, 0.19, 0.027]), device=dev)


def run_headline(dev):
    """Phase 8: the bench.py headline scene, coverage 0.35 (timed) and 0.7,
    with bench.py's referee, the exact brick march (`march_bricks(chunk=
    32768, capacity_frac=0.2)`, no cone cache): v3 against it
    (`quality_db_vs_exact`, and `_high_coverage` at 0.7) and against the
    dense march, and the referee against the dense march. The referee's K2
    calls are recorded and held bitwise against the plain version."""
    import torch

    from cloudscape_tpu_torch.models import atmosphere
    from cloudscape_tpu_torch.models.march_fast import (
        BrickPack, build_cone_cache, march_bricks, march_bricks_v3,
        march_tile_dense, v3_auto_policy, v3_capacities)
    from cloudscape_tpu_torch.models.packs import procedural_noise_pack
    from cloudscape_tpu_torch.utils.image import psnr

    pack = procedural_noise_pack(0, device=dev)
    bricks = BrickPack.from_noise(pack)
    sun = np.array([0.3, 0.4, -0.85])
    sun /= np.linalg.norm(sun)
    sky = atmosphere.sky_lut(atmosphere.transmittance_lut(device=dev),
                             torch.tensor(sun, dtype=torch.float32, device=dev))
    dirs = torch.from_numpy(hemisphere_dirs(WIDTH, HEIGHT)).to(dev)
    rows = []
    for cov in (0.35, 0.7):
        params = headline_params(dev, cov)
        rk, ck, hk, cell_frac, hot_frac = v3_auto_policy(dirs, params, bricks,
                                                         steps=STEPS)

        def build():
            return build_cone_cache(params, bricks, 6, res=CONE_RES, chunk=65536)

        # The scene's sampler launches: its cone build, render and referee.
        s_0 = read_counts()
        cone, build_calls = record_samples(build)
        cone_ms = events_ms(build, 1)[0]

        def render():
            return march_bricks_v3(dirs, params, bricks, sky, steps=STEPS,
                                   chunk=32768, cell_keep_frac=ck,
                                   hot_keep_frac=hk, cone_cache=cone,
                                   ray_keep_frac=rk, ray_stride=2)

        # The first call's launches, by difference (the K3 count of phases
        # 7-8 runs on): phase 8c holds its stage-0 call to them.
        before = read_counts()
        out, render_calls = record_samples(render)
        torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in read_counts().items()}
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
        torch.cuda.synchronize()
        samples = {k: v - s_0[k] for k, v in read_counts().items() if k in SAMPLERS}
        require(all(samples[k] > 0 for k in MAIN_SAMPLERS),
                f"the headline at coverage {cov} launched K7–K9 {samples}")
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
                         samples=samples,
                         # Phase 13's sampler rows: the render's first call
                         # on each table, and the cone build's on the tiny
                         # volumes (the render samples none).
                         sample_calls=[c + ("the headline v3 render",)
                                       for c in render_calls]
                         + [c + ("the headline's cone build",) for c in build_calls
                            if c[0] == "sample_tiny3"] if cov == 0.35 else None,
                         exact=exact,
                         active=int(mask.sum()),
                         cloud_frac=float((out[..., 3] > 0.1).float().mean()),
                         # For phases 8c and 8d: the render, its inputs and
                         # its launches.
                         out=out, params=params, cone=cone, launches=launches,
                         scene=dict(pack=pack, bricks=bricks, sky=sky, dirs=dirs,
                                    sun=sun)))
    return rows


# Phase 8c: the v3 march's stages in the order they run; debug_stage 0 is
# the whole call. Each is timed in STAGE_REPS rounds (the median).
V3_STAGES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 0)
STAGE_REPS = 5
# What each debug_stage adds to the one before it (`_march_core3`).
STAGE_NAMES = {
    1: "ray setup + cull prepass", 2: "top-ray select",
    3: "live-cell compaction (K2) + lane positions", 4: "weather pass",
    5: "pre pass (weather + pre, less the weather pass)",
    6: "hot-cell compaction (K2) + hot positions", 7: "erosion pass",
    8: "cone lookup (erosion + cone, less the erosion pass)",
    9: "accumulation (K3 x2, segment ends K2)", 0: "scatter back to the rays",
}


def stage_trace(march, full, full_launches, cull: bool, all_above: bool) -> dict:
    """Phase 8c on one scene: `march(k)` is the scene's v3 call with
    debug_stage=k; stages V3_STAGES (2 only with the ray cull). Per stage:
    the launches of one call (the counts zeroed just before it) and its
    probe: finite, but for stage 1's where a ray is below the horizon (its
    priority is −inf, in JAX too); the stage-0 call bitwise `full` (the
    render the scene's phase made) with the launches it made. Then each
    stage timed by CUDA events, STAGE_REPS rounds over all the stages in
    turn (host jitter lands on every stage alike), the median; and its
    device time and device launches a call from torch.profiler; each with
    its increment over the stage before it. The idle share is the whole
    call's: 1 − device ms / event ms."""
    import torch

    stages = [k for k in V3_STAGES if k != 2 or cull]
    rows = []
    for k in stages:
        out, n = counted(lambda: march(k))
        probe, rest = out.reshape(-1)[0], out.reshape(-1)[1:]
        if k == 1 and not all_above:
            require(bool(torch.isfinite(rest).all()) and float(probe) == -math.inf,
                    f"v3 debug_stage 1 probe {float(probe)}, not -inf with rays "
                    f"below the horizon")
        else:
            require(bool(torch.isfinite(out).all()), f"v3 debug_stage {k} is not finite")
        if k == 0:
            require(torch.equal(out, full), "debug_stage 0 differs from the render")
            require(all(n[kn] == full_launches[kn] for kn in n),
                    f"debug_stage 0 launched {n}, the render {full_launches}")
        else:
            require(not bool(rest.any()), f"debug_stage {k}: probe entries past [0, 0]")
        rows.append(dict(stage=k, what=STAGE_NAMES[k], k1=n["accumulate"], k2=n["compact"],
                         k3=n["segscan"], k7=n["sample_tex3"], k8=n["sample_tex2"],
                         k9=n["sample_tiny3"], probe=float(probe) if k else None))
    times = {k: [] for k in stages}
    for _ in range(STAGE_REPS):
        for k in stages:
            times[k] += events_ms(lambda: march(k), 1)
    prev_ms = prev_dev = 0.0
    for r in rows:
        k = r["stage"]
        dev_ms, dev_launches = trace_calls(lambda: march(k), reps=2, pad=1)
        r.update(ms=statistics.median(times[k]), all_ms=times[k], device_ms=dev_ms,
                 device_launches=dev_launches)
        r["increment_ms"], prev_ms = r["ms"] - prev_ms, r["ms"]
        if dev_ms is not None:
            r["device_increment_ms"], prev_dev = dev_ms - prev_dev, dev_ms
    total, dev_total = rows[-1]["ms"], rows[-1]["device_ms"]
    for r in rows:
        r["share"] = r["increment_ms"] / total
        if dev_total is not None:
            r["device_share"] = r["device_increment_ms"] / dev_total
    return dict(stages=rows, total_ms=total, device_ms=dev_total,
                device_launches=rows[-1]["device_launches"],
                idle_share=None if dev_total is None else 1.0 - dev_total / total)


def print_stages(t: dict, card: str) -> None:
    """Phase 8c's table of one scene."""
    dev = ("not measured (no device activity in the trace)" if t["device_ms"] is None
           else f"{t['device_ms']:.2f} ms on the device in {t['device_launches']:g} "
                f"launches, idle share {t['idle_share']:.3f}")
    print(f"v3 stages, {t['scene']}: policy {t['policy']}; the whole call "
          f"{t['total_ms']:.2f} ms (CUDA events, median of {STAGE_REPS} rounds); "
          f"torch.profiler: {dev} ({card})", flush=True)
    for r in t["stages"]:
        dev = "" if r["device_ms"] is None else (
            f"; device {r['device_ms']:.3f} ms, +{r['device_increment_ms']:.3f} ms "
            f"({r['device_share']:.1%}) in {r['device_launches']:g} launches")
        print(f"  debug_stage {r['stage']} ({r['what']}): {r['ms']:.3f} ms, "
              f"+{r['increment_ms']:.3f} ms ({r['share']:.1%}){dev}; launches up to "
              f"it: K1 x{r['k1']}, K2 x{r['k2']}, K3 x{r['k3']}, K7 x{r['k7']}, "
              f"K8 x{r['k8']}, K9 x{r['k9']}", flush=True)


def run_v3_stages(headline) -> list:
    """Phase 8c: the headline v3 render of phase 8 at both coverages, stage
    by stage (`stage_trace`), with exactly phase 8's arguments."""
    from cloudscape_tpu_torch.models.march_fast import march_bricks_v3

    out = []
    for h in headline:
        sc, (rk, ck, hk) = h["scene"], h["policy"]

        def march(k, h=h, sc=sc, rk=rk, ck=ck, hk=hk):
            return march_bricks_v3(sc["dirs"], h["params"], sc["bricks"], sc["sky"],
                                   steps=STEPS, chunk=32768, cell_keep_frac=ck,
                                   hot_keep_frac=hk, cone_cache=h["cone"],
                                   ray_keep_frac=rk, ray_stride=2, debug_stage=k)

        t = stage_trace(march, h["out"], h["launches"], rk is not None and rk < 1.0,
                        bool((sc["dirs"][..., 1] > 0.0).all()))
        out.append(dict(t, scene=f"headline {WIDTH}x{HEIGHT}x{STEPS} coverage {h['cov']}",
                        policy=h["policy"], caps=h["caps"]))
    return out


# Phase 8d: a crop of the headline grid against the f64 oracle. CROP texels
# square, every CROP_STEP-th in each axis (128 x 128 = 16,384 rays); of the
# windows on a CROP/2 lattice, the one where phase 8's referee has the most
# cloud (alpha > 0.1). The oracle runs on the host in ORACLE_WORKERS
# processes (it measured 2.93 s per 1,024 rays x 128 steps on one core of a
# CPU host, ~47 s for the crop on one).
CROP, CROP_STEP = 256, 2
ORACLE_DB = 40.0
ORACLE_WORKERS = 8


def _oracle_init(large, small, weather, sky, params):
    """Worker initializer of phase 8d: the oracle's inputs, once a worker."""
    global _ORACLE_INPUTS
    _ORACLE_INPUTS = (large, small, weather, sky, params)


def _oracle_rays(dirs):
    """One worker's slice of phase 8d's rays through `cloud_march_ref`."""
    from oracle import reference as ref

    large, small, weather, sky, params = _ORACLE_INPUTS
    return ref.cloud_march_ref(dirs, params, large, small, weather, sky, steps=STEPS)


def run_oracle_crop(h) -> dict:
    """Phase 8d: one of phase 8's v3 renders (coverage 0.35 or 0.7, each
    with its own policy and cone cache) and its referee (the exact march)
    on the crop of its scene against `oracle/reference.py` in float64 on
    the host: the pack's level-0 volumes as f64 with the oracle's own
    pyramids, its own transmittance and sky LUTs, the render's params. v3
    and the exact march must each be ≥ ORACLE_DB from the oracle; v3
    against the exact march on the same texels is reported beside them."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from cloudscape_tpu_torch.utils.image import psnr
    from oracle import reference as ref

    t0 = time.perf_counter()
    sc = h["scene"]
    exact = h["exact"].cpu().numpy()
    alpha = exact[..., 3] > 0.1
    windows = [(r, c) for r in range(0, HEIGHT - CROP + 1, CROP // 2)
               for c in range(0, WIDTH - CROP + 1, CROP // 2)]
    r0, c0 = max(windows, key=lambda w: alpha[w[0]:w[0] + CROP, w[1]:w[1] + CROP].sum())
    crop = (slice(r0, r0 + CROP, CROP_STEP), slice(c0, c0 + CROP, CROP_STEP))
    dirs = sc["dirs"].cpu().numpy()[crop].astype(np.float64)
    params = {k: getattr(h["params"], k).cpu().numpy().astype(np.float64)
              for k in ("cloud_pos", "detailed_pos", "weather_pos", "time", "density",
                        "cloud_coverage", "light_direction", "light_energy",
                        "light_color", "ground_color")}
    pack = sc["pack"]
    large = ref.build_pyramid3d_np(pack.large[0].cpu().numpy().astype(np.float64))
    small = ref.build_pyramid3d_np(pack.small[0].cpu().numpy().astype(np.float64))
    weather = pack.weather.cpu().numpy().astype(np.float64)
    sky = ref.sky_lut_ref(ref.transmittance_lut_ref(), sc["sun"])
    flat = dirs.reshape(-1, 3)
    parts = np.array_split(flat, ORACLE_WORKERS * 4)
    t1 = time.perf_counter()
    with ProcessPoolExecutor(ORACLE_WORKERS, mp_context=multiprocessing.get_context("spawn"),
                             initializer=_oracle_init,
                             initargs=(large, small, weather, sky, params)) as pool:
        want = np.concatenate(list(pool.map(_oracle_rays, parts))).reshape(dirs.shape[:-1] + (4,))
    march_s = time.perf_counter() - t1
    v3 = h["out"].cpu().numpy()[crop]
    ex = exact[crop]
    require(np.isfinite(want).all(), "the oracle's crop is not finite")
    db_v3, db_exact, db_v3_exact = psnr(v3, want), psnr(ex, want), psnr(v3, ex)
    require(db_v3 >= ORACLE_DB, f"headline v3 at coverage {h['cov']} vs the f64 "
            f"oracle {db_v3:.2f} dB < {ORACLE_DB}")
    require(db_exact >= ORACLE_DB, f"the headline referee at coverage {h['cov']} vs "
            f"the f64 oracle {db_exact:.2f} dB < {ORACLE_DB}")
    return dict(window=(r0, c0), rays=flat.shape[0], db_v3=db_v3, db_exact=db_exact,
                db_v3_exact=db_v3_exact, cloud_frac=float((want[..., 3] > 0.1).mean()),
                host_s=time.perf_counter() - t0, oracle_s=march_s)


# The baked density field (`models/field.py`): JAX's defaults, the
# documented band of `march_baked` against the referee (tests/test_field.py),
# and the resolution sweep of docs/PERF_NOTES.md's round-2 negatives plus
# the default grid and one of 4x its cells (does the ceiling of the band
# move on the card's 80 GB?), each at the default cone grid.
FIELD_RES = (32, 768, 768)
FIELD_CONE_RES = (16, 192, 192)
FIELD_BAND_DB = (15.0, 40.0)
FIELD_SWEEP = ((16, 256, 256), (24, 384, 384), (32, 512, 512), FIELD_RES,
               (32, 1536, 1536))
# Card against CPU on tests/test_torch_field.py's scene.
FIELD_TINY_DB = 60.0


def timed_call(fn):
    """(fn()'s result, its ms by CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def run_field(dev, exact):
    """Phase 8b: the baked density field on the headline scene (coverage
    0.35): `build_density_field` at JAX's defaults (timed; the first call
    warms the allocator), `march_baked` at its defaults (median of 3
    after the first call), inside FIELD_BAND_DB of phase 8's referee output
    `exact`; the resolution sweep (build ms and dB each, reported); the
    two K2 calls of one `march_baked` recorded and held bitwise against the
    plain version; `occupied_ray_fraction` in (0, 1], and exactly 0 on an
    empty scene with margin 0; and tests/test_torch_field.py's scene on the
    card and on the CPU, ≥ FIELD_TINY_DB apart with bitwise-equal ray
    indices."""
    import torch

    from cloudscape_tpu_torch.models import atmosphere
    from cloudscape_tpu_torch.models.density import MarchParams
    from cloudscape_tpu_torch.models.field import (
        build_density_field, march_baked, occupied_ray_fraction)
    from cloudscape_tpu_torch.models.march_fast import BrickPack
    from cloudscape_tpu_torch.models.packs import make_noise_pack, procedural_noise_pack
    from cloudscape_tpu_torch.ops import compact, noise_kernel
    from cloudscape_tpu_torch.ops.octmap import texel_directions
    from cloudscape_tpu_torch.utils.image import psnr

    bricks = BrickPack.from_noise(procedural_noise_pack(0, device=dev))
    sun = np.array([0.3, 0.4, -0.85])
    sun /= np.linalg.norm(sun)
    sky = atmosphere.sky_lut(atmosphere.transmittance_lut(device=dev),
                             torch.tensor(sun, dtype=torch.float32, device=dev))
    dirs = torch.from_numpy(hemisphere_dirs(WIDTH, HEIGHT)).to(dev)
    scene = dict(cloud_pos=np.array([1.5, -0.3]), detailed_pos=np.array([0.4, 0.2]),
                 weather_pos=np.array([0.01, 0.02]), time=12.5,
                 light_direction=sun, ground_color=np.array([0.27, 0.19, 0.027]))
    params = MarchParams.create(cloud_coverage=0.35, device=dev, **scene)
    exact_np = exact.cpu().numpy()

    def build(res=FIELD_RES):
        return build_density_field(params, bricks, res=res,
                                   cone_res=FIELD_CONE_RES, chunk=65536)

    field = build()
    field, build_ms = timed_call(build)
    table = field.table.texels
    require(bool(torch.isfinite(table).all()), "the baked field is not finite")

    def render(f=field):
        return march_baked(dirs, params, bricks, f, sky, steps=STEPS)

    out = render()
    ms = events_ms(render, 3)
    require(bool(torch.isfinite(out).all()), "march_baked is not finite")
    db = psnr(out.cpu().numpy(), exact_np)
    lo, hi = FIELD_BAND_DB
    require(lo < db < hi, f"march_baked vs the referee {db:.2f} dB outside ({lo}, {hi})")
    _, compactions, _ = record_kernels(render)
    require(len(compactions) == 2, f"march_baked made {len(compactions)} K2 calls")
    check_recorded("march_baked", compactions)
    _, counts = counted(render)
    require(counts["compact"] == 2, f"march_baked launched K2 {counts['compact']} times")
    # The field's own table kind (a 2-ch clamp texture): march_baked's first
    # call on it, recorded for phase 13, which holds it against the plain
    # version and times it.
    _, calls = record_samples(render)
    field_calls = [c + ("march_baked",) for c in calls if c[2] is field.table]
    require(len(field_calls) == 1, "march_baked made no call on the field's table")

    sweep = []
    for res in FIELD_SWEEP:
        f, b_ms = (field, build_ms) if res == FIELD_RES else timed_call(
            lambda: build(res))
        o, r_ms = (out, statistics.median(ms)) if res == FIELD_RES else \
            timed_call(lambda: render(f))
        sweep.append(dict(res=res, build_ms=b_ms, ms=r_ms,
                          db=psnr(o.cpu().numpy(), exact_np),
                          table_mb=f.table.texels.numel() * 4 / 1e6))
        del f, o

    occ = float(occupied_ray_fraction(dirs, params, field))
    require(0.0 < occ <= 1.0, f"occupied_ray_fraction {occ} not in (0, 1]")
    empty = MarchParams.create(cloud_coverage=0.0, light_direction=sun, device=dev)
    field0 = build_density_field(empty, bricks, res=(8, 64, 64),
                                 cone_res=(8, 32, 32), chunk=4096)
    occ0 = float(occupied_ray_fraction(dirs, empty, field0, occupancy_margin=0.0))
    require(occ0 == 0.0, f"occupied_ray_fraction of an empty scene {occ0} != 0")
    del field, field0

    # tests/test_torch_field.py's scene: generators at 16/16/64, seeds 1/2/3.
    tiny = make_noise_pack(noise_kernel.generate_base_noise(16, 1, device=dev),
                           noise_kernel.generate_detail_noise(16, 2, device=dev),
                           noise_kernel.generate_weather(64, 3, device=dev))
    renders, ray_idx = [], []
    for d in (dev, torch.device("cpu")):
        pack = type(tiny)(large=tuple(v.to(d) for v in tiny.large),
                          small=tuple(v.to(d) for v in tiny.small),
                          weather=tiny.weather.to(d))
        tb = BrickPack.from_noise(pack)
        tp = MarchParams.create(cloud_coverage=0.6, light_color=(1.0, 0.98, 0.95),
                                device=d, **scene)
        ts = atmosphere.sky_lut(atmosphere.transmittance_lut(device=d),
                                torch.tensor(sun, dtype=torch.float32, device=d))
        tf = build_density_field(tp, tb, res=(8, 48, 48), cone_res=(4, 24, 24),
                                 chunk=4096)
        o, comps, _ = record_kernels(lambda: march_baked(
            texel_directions(32, device=d), tp, tb, tf, ts, steps=16, chunk=1024))
        renders.append(o.cpu().numpy())
        # The ray compaction's indices, by K2 on the card and by its plain
        # version on the CPU.
        mask, cap, _ = comps[0]
        ray_idx.append(compact.compact(mask, cap, mask.shape[0], with_rank=False)[0])
    tiny_db = psnr(renders[0], renders[1])
    require(tiny_db >= FIELD_TINY_DB,
            f"march_baked card vs CPU {tiny_db:.2f} dB < {FIELD_TINY_DB}")
    require(torch.equal(ray_idx[0].cpu(), ray_idx[1]),
            "march_baked's ray indices differ between the card and the CPU")
    return dict(build_ms=build_ms, ms=statistics.median(ms), all_ms=ms, db=db,
                compactions=compactions, occ=occ, sweep=sweep, tiny_db=tiny_db,
                sample_calls=field_calls,
                active=int(compactions[1][0].sum()),
                cloud_frac=float((out[..., 3] > 0.1).float().mean()),
                tiny_frac=float((renders[1][..., 3] > 0.1).mean()))


def run_config4(dev):
    """Phase 9: bench/sweep.py config 4 (fully procedural noise), v2 and v3
    rows, each against the dense march."""
    import torch

    from cloudscape_tpu_torch.models import atmosphere
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
    params = headline_params(dev, 0.35)
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
    from cloudscape_tpu_torch.ops import accum, compact, composite_kernel, noise_kernel

    perf = PerfConfig()  # 768², 64 frames, 128 steps, 6 light steps
    eyedirs = camera_dirs(1280, 720, dev)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = CloudSkyEngine(perf=perf, config=CloudConfig(cloud_coverage=0.45),
                         sun=SunState(direction=(0.3, 0.25, -0.9)),
                         device=dev)
    require(eng.can_run, "the default engine failed its validation")
    built = read_counts()  # the validation probe's launches
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
        k12 = composite_kernel.launches["composite"]
        start.record()
        frame = eng.render_frame(eyedirs, now=(i + 1) / 60.0)
        end.record()
        torch.cuda.synchronize()
        tick_ms.append(start.elapsed_time(end))
        require(composite_kernel.launches["composite"] - k12 == 1,
                f"tick {i + 1} launched K12 "
                f"{composite_kernel.launches['composite'] - k12} times, not once")
        if prebaked:
            require(eng._cone_cache is pend.cone,
                    "boundary did not pick up the prebake")
            pickups += 1
    k1_launches, k2_launches = accum.launches, compact.launches
    counts = read_counts()
    samples = {k: counts[k] for k in SAMPLERS}
    atmo = {k: counts[k] for k in ATMO_KERNELS}
    sample_sizes, size_counts = read_samples(), read_sizes()
    # K11 bakes the engine's transmittance LUT once at construction, and
    # its validation probes it once; K10 renders the sky LUTs in the ticks
    # (the warm start's, the prebake's bands).
    require(atmo["transmittance_lut"] == built["transmittance_lut"] == 2
            and atmo["sky_lut"] > built["sky_lut"],
            f"the engine phase launched K10–K11 {atmo}, by its construction {built}")

    require(pickups >= 1, "no cycle boundary picked up a prebaked cone cache")
    require(all(samples[k] > built[k] for k in MAIN_SAMPLERS),
            f"the engine phase launched K7–K9 {samples}, its validation {built}")
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
                     samples=samples, sample_sizes=sample_sizes, atmo=atmo,
                     size_counts=size_counts, composite=counts["composite"],
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


def run_tile_cull(dev):
    """Phase 11b: the fast3 tile-cull engine at bench.py's serving point,
    through the fused `render_frame`. The kernel counts are zeroed before
    the engine's construction and read after the timed window; K2 and K3
    must launch within the window. Then the cycle's tiles are marched
    again and the culled map is held against the dense march, and the
    first v3 tile's K2 and K3 calls are recorded and held against their
    plain versions (for phase 13's rows)."""
    import collections

    import torch

    from cloudscape_tpu_torch import CloudConfig, PerfConfig, SunState
    from cloudscape_tpu_torch import engine as engine_mod
    from cloudscape_tpu_torch.engine import (CloudSkyEngine, _march_tile, _prepass_steps,
                                             tile_arm)
    from cloudscape_tpu_torch.models.march_fast import march_bricks_v3, march_tile_dense
    from cloudscape_tpu_torch.ops import accum, compact, noise_kernel, segscan
    from cloudscape_tpu_torch.ops.octmap import texel_directions
    from cloudscape_tpu_torch.utils.image import psnr

    eye = camera_dirs(1280, 720, dev)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = CloudSkyEngine(
        perf=PerfConfig(texture_size=768, frames_to_update=64, march_steps=128),
        config=CloudConfig(cloud_coverage=0.35, sun_disk_scale=2.0, wind_speed=10.0,
                           ground_color=(0.27, 0.19, 0.027, 1.0)),
        sun=SunState(direction=(0.3, 0.4, -0.85)), kernel="fast3",
        cone_res=CONE_RES, tile_cull=True, device=dev)
    require(eng.can_run, "the tile-cull engine failed its validation")
    built = read_counts()  # the validation probe's launches
    rays = eng.perf.update_region_size ** 2
    eng.render_frame(eye, now=0.0)  # the warm start
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    for i in range(1, 1 + CULL_WARM_TICKS):
        eng.render_frame(eye, now=i / 60.0)
    torch.cuda.synchronize()
    n_frames = eng.perf.frames_to_update
    k_warm = (accum.launches, compact.launches, segscan.launches)
    s_warm = read_counts()
    r_warm = engine_mod.v3_graph_replays
    ticks, pickups, done_buckets, frame = [], 0, None, None
    v3_window = collections.Counter()  # the window's v3 tiles by cell bucket

    def window():
        nonlocal pickups, done_buckets, frame
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
            bucket = eng._tile_buckets[eng.ring.frame - 1]
            arm = tile_arm("fast3", bucket, rays)
            ticks.append((arm, start.elapsed_time(end), wall_ms))
            v3_window[bucket] += arm == "v3"

    # The samples the window's sampler launches were given (phase 13's
    # samples per pass).
    n_warm, z_warm = read_samples(), read_sizes()
    window()
    window_samples = {k: v - n_warm[k] for k, v in read_samples().items()}
    window_sizes = sizes_since(z_warm)
    k1, k2, k3 = (accum.launches - k_warm[0], compact.launches - k_warm[1],
                  segscan.launches - k_warm[2])
    counts = read_counts()
    phase = dict(k1=accum.launches, k2=compact.launches, k3=segscan.launches,
                 noise=dict(noise_kernel.launches),
                 samples={k: counts[k] for k in SAMPLERS},
                 atmo={k: counts[k] for k in ATMO_KERNELS}, composite=counts["composite"])
    samples = {k: counts[k] - s_warm[k] for k in SAMPLERS}
    atmo_window = {k: counts[k] - s_warm[k] for k in ATMO_KERNELS}
    # Those are the wrappers' launches; the window's v3 tiles were graph
    # replays, which launch through no wrapper (`tile_graphs.py`). Each
    # bucket's graph is replayed once more under the profiler, and the
    # eager arm's call of that bucket on the same inputs is traced and
    # counted: the replay's device trace must be the eager call's, activity
    # by activity, with K2 and K3 on it, and the eager call's wrapper counts
    # its kernels on the trace. The window's launches, samples and sizes
    # for phase 13 then add, for each replay, those of the eager call.
    replays = engine_mod.v3_graph_replays - r_warm
    require(replays == sum(v3_window.values()),
            f"{replays} graph replays in the window's {sum(v3_window.values())} v3 ticks")
    graphs, replay_kernels = eng._v3_graphs, {}
    for b, n in sorted(v3_window.items()):
        if not n:
            continue
        _, replay_names, replay_ours = traced_kernels(lambda b=b: graphs.replay(b))
        _, eager_names, _ = traced_kernels(lambda b=b: (zero_counts(), graphs.eager(b)))
        one = read_counts()
        # A graph's copy nodes run as kernels named memcpy*: the copies
        # are held by their number.
        (replay_copies, replay_rest), (eager_copies, eager_rest) = (
            split_copies(replay_names), split_copies(eager_names))
        require(replay_rest == eager_rest and replay_copies == eager_copies,
                f"bucket {b}: the replay's device trace {dict(replay_rest - eager_rest)} "
                f"more, {dict(eager_rest - replay_rest)} fewer than the eager call's, "
                f"{replay_copies} copies against {eager_copies}")
        require(replay_ours["compact"] > 0 and replay_ours["segscan"] > 0,
                f"bucket {b}: the replay ran K2 {replay_ours['compact']}, K3 "
                f"{replay_ours['segscan']} times")
        require(all(replay_ours[k] == v for k, v in one.items()),
                f"bucket {b}: the replay's kernels {dict(replay_ours)}, the eager "
                f"call's wrapper counts {one}")
        replay_kernels[b] = dict(replay_ours)
        k1, k2, k3 = k1 + n * one["accumulate"], k2 + n * one["compact"], \
            k3 + n * one["segscan"]
        for k in SAMPLERS:
            samples[k] += n * one[k]
        for k in ATMO_KERNELS:
            atmo_window[k] += n * one[k]
        for k, v in read_samples().items():
            window_samples[k] += n * v
        for k, z in read_sizes().items():
            window_sizes[k].update({size: n * m for size, m in z.items()})
    require(all(phase["samples"][k] > built[k] for k in MAIN_SAMPLERS),
            f"the tile-cull phase launched K7–K9 {phase['samples']}, its "
            f"validation {built}")
    require(pickups == 1, f"{pickups} boundaries in the timed window, not 1")
    require(any(a == "v3" for a, _, _ in ticks), "no timed tick took a v3 bucket")
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
    v3_tiles = [j for j, b in enumerate(eng._tile_buckets)
                if tile_arm("fast3", b, rays) == "v3"]
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
                tile_arm("fast3", b, rays),
                texel_directions(size, x0=x0, y0=y0, width=region, height=region,
                                 device=dev),
                eng._march_params, eng._noise_arg, sky,
                region=region, steps=eng.perf.march_steps,
                light_steps=eng.perf.light_steps, kernel="fast3",
                bucket=b if b < 1.0 else None)

        if k == v3_tiles[0]:
            tile, compactions, scans = record_kernels(march_one)
        else:
            tile = march_one()
        require(k >= eng.ring.frame or torch.equal(
            tile, ring[tex, y0:y0 + region, x0:x0 + region]),
            f"tile {k} (bucket {b}) marched again differs from the tick's")
        culled[y0:y0 + region, x0:x0 + region] = tile
    k3_err = check_recorded("a phase-11b v3 tile", compactions, scans)

    # Phase 8c's serving tile: the first v3 tile of the cycle stage by stage,
    # called with the arguments the engine's v3 arm passes (`_march_tile`'s
    # "v3" arm: no ray cull, so no stage 2), against
    # that arm's own call and its launches.
    k0 = v3_tiles[0]
    b0, ty, tx = eng._tile_buckets[k0], (k0 // tpr) * region, (k0 % tpr) * region
    tile_dirs = texel_directions(size, x0=tx, y0=ty, width=region, height=region,
                                 device=dev)
    steps = eng.perf.march_steps
    arm_tile, arm_launches = counted(lambda: _march_tile(
        "v3", tile_dirs, eng._march_params, eng._noise_arg, sky, region=region,
        steps=steps, light_steps=eng.perf.light_steps, kernel="fast3", bucket=b0))
    require(torch.equal(arm_tile, culled[ty:ty + region, tx:tx + region]),
            "the v3 tile marched again differs")

    def tile_march(k):
        return march_bricks_v3(
            tile_dirs, eng._march_params, eng._bricks, sky, steps=steps,
            light_steps=eng.perf.light_steps, chunk=min(region * region, 16384),
            cell_keep_frac=float(b0), hot_keep_frac=0.5, cone_cache=eng._cone_cache,
            ray_keep_frac=None, prepass_steps=_prepass_steps(steps), ray_stride=2,
            cell_margin=0.1, debug_stage=k)

    tile_stages = dict(stage_trace(tile_march, arm_tile, arm_launches, False,
                                   bool((tile_dirs[..., 1] > 0.0).all())),
                       scene=f"serving-point v3 tile {k0} ({region}x{region}x{steps}, "
                             f"bucket {b0})", policy=(None, b0, 0.5))
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
        k1=k1, k2=k2, k3=k3, samples=samples, window_samples=window_samples,
        window_sizes=window_sizes, atmo_window=atmo_window,
        composite_window=counts["composite"] - s_warm["composite"], phase=phase,
        v3_tiles=len(arms["v3"]), graph_replays=replays,
        replay_kernels=replay_kernels,
        v3_bucket=eng._tile_buckets[v3_tiles[0]], compactions=compactions,
        scans=scans, k3_err=k3_err, cull_db=cull_db, cloud_frac=cloud_frac,
        frame_mean=float(frame.mean()), tile_stages=tile_stages)


def run_probe(dev) -> dict:
    """Phase 11h: `python -m cloudscape_tpu_torch.probe_prebake`'s run at the
    serving point (its lines printed as they come), with K10's plain version
    counted: every sky-band tick of its labelled loop must launch K10 once,
    every other tick none, and the plain version must never run."""
    from cloudscape_tpu_torch import probe_prebake
    from cloudscape_tpu_torch.models import atmosphere

    plain_calls = []
    real = atmosphere._sky_lut_rows_plain

    def counting(*args, **kwargs):
        plain_calls.append(1)
        return real(*args, **kwargs)

    atmosphere._sky_lut_rows_plain = counting
    try:
        rec = probe_prebake.run(dev, log=lambda line: print(f"probe_prebake: {line}",
                                                            flush=True))
    finally:
        atmosphere._sky_lut_rows_plain = real
    bands = [t for t in rec["ticks"] if t["stage"] == "sky_band"]
    require(bands, "the probe's labelled ticks ran no sky-band tick")
    wrong = [t for t in rec["ticks"] if t["sky_launches"] != (t["stage"] == "sky_band")]
    require(not wrong, f"ticks whose K10 launches are not one a sky band: {wrong}")
    require(not plain_calls, f"K10's plain version ran {len(plain_calls)} times on the card")
    return rec


# Phase 11i's cycles of 4 ticks after the warm start.
SHORT_CYCLES = 3


def run_short_cycle(dev) -> dict:
    """Phase 11i: the upstream's fastest refresh, frames_to_update 4, on
    phase 11b's scene (fast3 `tile_cull`, 768², 128 steps, cone cache
    CONE_RES, the fused `render_frame` of a 1280x720 view): the warm start,
    then SHORT_CYCLES cycles of ticks timed by CUDA events, each labelled by
    its prebake steps (`probe_prebake.stage_of`: three ticks of grouped
    steps a cycle) and its 384² tile's arm (`tile_arm`: skip, v3 bucket,
    or v2 for a 1.0 bucket: a tile of V3_TILE_MIN_RAYS rays or more). No rotation may
    build synchronously and no bake step may be dropped (`engine.sync_bakes`,
    `engine.dropped_bake_steps`); each rotation must take the pending
    cycle's cone cache and buckets, and the cone table must be bitwise
    `_build_cone` of the same snapshot; frames finite, nonnegative and not
    black. The kernels at these shapes: the warm start's K2 calls and its
    first K1 call (its tiles take v2: 147,456 rays, no bucket) are recorded
    and held against their plain versions, and so are the K2 and K3 calls
    of one more tick, the first whose tile takes v3 (its time is not
    kept: the recording copies every input; the engine's v3 tile graphs
    are set aside for those ticks, since a replay calls no kernel wrapper).
    Before that, each timed v3 tick must be one graph replay, and the v3
    tiles the last cycle's ticks replayed (147,456 rays in 9 chunks) are
    marched again by the eager arm and must equal the ring's, bitwise."""
    import torch

    from cloudscape_tpu_torch import CloudConfig, PerfConfig, SunState, probe_prebake
    from cloudscape_tpu_torch import engine as tengine
    from cloudscape_tpu_torch.engine import CloudSkyEngine, _march_tile, tile_arm
    from cloudscape_tpu_torch.ops.octmap import texel_directions

    eye = camera_dirs(1280, 720, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = CloudSkyEngine(
        perf=PerfConfig(texture_size=768, frames_to_update=4, march_steps=128),
        config=CloudConfig(cloud_coverage=0.35, sun_disk_scale=2.0, wind_speed=10.0,
                           ground_color=(0.27, 0.19, 0.027, 1.0)),
        sun=SunState(direction=(0.3, 0.4, -0.85)), kernel="fast3",
        cone_res=CONE_RES, tile_cull=True, device=dev)
    require(eng.can_run, "the f4 engine failed its validation")
    (_, warm_k2, _), warm_k1 = record_accumulate(  # the warm start
        lambda: record_kernels(lambda: eng.render_frame(eye, now=0.0)))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    region = eng.perf.update_region_size
    steps = eng.perf.march_steps
    require(any(c[0].shape[0] == region * region * steps for c in warm_k2),
            "the f4 warm start compacted no v2 tile's samples")
    require([tuple(a[0].shape) for a, _ in warm_k1] == [(region * region, steps)],
            f"the f4 warm start's first K1 call is not a {region}² tile's")
    check_recorded("the f4 warm start", warm_k2)
    k1_err = check_recorded_accumulate("an f4 warm-start v2 tile", warm_k1)
    del warm_k2, warm_k1
    sync0, dropped0 = tengine.sync_bakes, tengine.dropped_bake_steps
    replays0 = tengine.v3_graph_replays
    rows, frame = [], None
    for i in range(1, 1 + 4 * SHORT_CYCLES):
        stage = probe_prebake.stage_of(eng)
        pend = eng._pending

        def tick():
            nonlocal frame
            frame = eng.render_frame(eye, now=i / 60.0)

        (ms,) = events_ms(tick, 1)
        bucket = eng._tile_buckets[eng.ring.frame - 1]
        arm = tile_arm("fast3", bucket, region * region)
        rows.append(dict(tick=i, stage=stage, arm=arm, bucket=bucket, ms=ms))
        if stage == "boundary":
            require(eng._cone_cache is pend.cone and eng._tile_buckets is pend.buckets,
                    f"tick {i}: the rotation did not take the pending cycle's bake")
            cone = eng._build_cone(pend.march_params)
            require(bitwise_equal(cone.table.texels, pend.cone.table.texels),
                    f"tick {i}: the prebaked cone table differs from _build_cone's")
        require(bool(torch.isfinite(frame).all()) and float(frame.min()) >= 0.0,
                f"tick {i}: the f4 frame is not finite and nonnegative")
    require(float(frame.mean()) > 1e-3, "the f4 frame is black")
    replays = tengine.v3_graph_replays - replays0
    v3_ticks = sum(r["arm"] == "v3" for r in rows)
    require(replays == v3_ticks, f"{replays} graph replays in {v3_ticks} f4 v3 ticks")
    tpr, tex = eng.perf.texture_size // region, eng.ring.texture_to_update
    sky = eng.sky_ring[eng.ring.cloud_kernel_sky_slot]
    replayed = [k for k in range(eng.ring.frame)
                if tile_arm("fast3", eng._tile_buckets[k], region * region) == "v3"]
    require(replayed, "the last f4 cycle's ticks replayed no v3 tile")
    for k in replayed:
        y0, x0 = (k // tpr) * region, (k % tpr) * region
        tile = _march_tile(
            "v3", texel_directions(eng.perf.texture_size, x0=x0, y0=y0, width=region,
                                   height=region, device=dev),
            eng._march_params, eng._noise_arg, sky, region=region, steps=steps,
            light_steps=eng.perf.light_steps, kernel="fast3",
            bucket=eng._tile_buckets[k])
        require(torch.equal(tile, eng.cloud_ring[tex, y0:y0 + region, x0:x0 + region]),
                f"f4 tile {k} (bucket {eng._tile_buckets[k]}) marched eagerly differs "
                f"from its replay")
    del tile
    v3_calls = None
    graphs, eng._v3_graphs = eng._v3_graphs, None
    for i in range(1 + 4 * SHORT_CYCLES, 5 + 4 * SHORT_CYCLES):
        _, comps, scans = record_kernels(lambda: eng.render_frame(eye, now=i / 60.0))
        if tile_arm("fast3", eng._tile_buckets[eng.ring.frame - 1],
                    region * region) == "v3":
            v3_calls = comps, scans
            break
    eng._v3_graphs = graphs
    require(v3_calls is not None and v3_calls[1],
            "no f4 tick after the timed ones marched a v3 tile")
    k3_err = check_recorded("an f4 v3 tick", *v3_calls)
    n_k2, n_k3 = len(v3_calls[0]), len(v3_calls[1])
    del v3_calls
    sync, dropped = tengine.sync_bakes - sync0, tengine.dropped_bake_steps - dropped0
    require(sync == 0 and dropped == 0,
            f"f4 ticks built {sync} times synchronously and dropped {dropped} bake steps")
    require(sum(r["stage"] == "boundary" for r in rows) == SHORT_CYCLES,
            "the f4 ticks did not rotate once a cycle")
    return dict(warm_s=warm_s, rows=rows, region=region,
                groups=probe_prebake.schedule(eng)["groups"], k1_err=k1_err,
                k3_err=k3_err, v3_k2=n_k2, v3_k3=n_k3, replays_checked=len(replayed))


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
    from cloudscape_tpu_torch.engine import CloudSkyEngine, tile_arm
    from cloudscape_tpu_torch.models import atmosphere
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
    params = headline_params(dev, 0.35)
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
        arms.append(tile_arm("fast3", b, region * region))
        y0, x0 = (k // tpr) * region, (k % tpr) * region
        tex = eng.ring.texture_to_update
        a = eng.cloud_ring[tex, y0:y0 + region, x0:x0 + region]
        t = twin.cloud_ring[tex, y0:y0 + region, x0:x0 + region]
        if b >= 1.0 or b == 0.0:
            diff = float((a - t).abs().max())
            require(diff <= 1e-6, f"tick {i}: {arms[-1]} tile {k} differs from "
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
    k = next(j for j, b in enumerate(twin._tile_buckets)
             if tile_arm("fast3", b, region * region) == "v3")
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
    got, want = twin._cone_cache.table, eng._cone_cache.table
    require((got.dims, got.channels, got.wrap) == (want.dims, want.channels, want.wrap),
            "the restored cone texture's geometry differs")
    cone_diff = float((got.texels - want.texels).abs().max())
    require(bitwise_equal(got.texels, want.texels),
            f"the restored cone texture differs from the prebaked one by {cone_diff:.3g}")
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
    from torch.profiler import ProfilerActivity, profile

    from cloudscape_tpu_torch.utils.profiling import device_activities

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(pad):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = sorted(device_activities(prof.events()), key=lambda e: e.time_range.start)
    if not events:
        return None, None
    gaps = [b.time_range.start - a.time_range.end for a, b in zip(events, events[1:])]
    require(gaps and max(gaps) >= 25e3, "trace_calls: no 50 ms gap in the trace")
    events = events[gaps.index(max(gaps)) + 1:]
    return (sum(e.time_range.elapsed_us() for e in events) / reps / 1e3,
            len(events) / reps)


# K12's bytes at a call (its bound): the directions in and the frame out,
# 12 B a pixel each, the distinct texels its two pair fetches weigh (those
# of the eager chain's K8 calls at the same uv, `sample_bytes` less their
# coordinates and output) and the LUT's 4 texels.
def composite_bytes(pixels: int, pair_calls, tlut) -> int:
    texels = sum(sample_bytes(tab, qs) - 4 * (len(qs) + tab.channels) * qs[0].numel()
                 for _, _, tab, qs in pair_calls)
    return 24 * pixels + texels + 4 * tlut.shape[-1] * 4


def run_composite(eng, eyedirs):
    """Phase 7b: the composite traced on its own, on the phase-5 engine's
    state at the camera's resolution: the split `composite` (`render_view`),
    `composite_display` over the pair tables (kernel K12, the sun as host
    floats), its eager chain (`_composite_display_plain` on the card, the
    form before K12) and `_build_display_pair` (once a cycle): CUDA-event
    ms, profiler device ms and launches a call. K12 is held against the
    eager chain and the split composite at atol 2e-5 / rtol 1e-5; the eager
    chain's K8 calls are recorded for phase 13's display-pair rows, and K12's
    call for its own."""
    import torch

    from cloudscape_tpu_torch.engine import _build_display_pair
    from cloudscape_tpu_torch.models.compositor import (_composite_display_plain,
                                                        composite_display)

    pair = eng._display_pair_tables()
    b0, b1 = eng.ring.sky_back_textures
    tlut, scale, blend = eng.transmittance, eng.config.sun_disk_scale, eng.blend_amount
    sun, sun_on_card = eng._light_floats(eng.frame_data), eng._light_dir(eng.frame_data)

    def split():
        return eng.render_view(eyedirs)

    def display():
        return composite_display(eyedirs, *pair, tlut, sun, scale, blend)

    def eager():
        return _composite_display_plain(eyedirs, *pair, tlut, sun_on_card, scale, blend)

    def build():
        return _build_display_pair(eng.cloud_ring, eng.ring.texture_to_blend_from,
                                   eng.ring.texture_to_blend_to, eng.sky_ring, b0, b1)

    a = split()
    torch.cuda.synchronize()
    before = read_counts()
    b = display()
    torch.cuda.synchronize()
    k12_counts = {k: v - before[k] for k, v in read_counts().items()}
    c, calls = record_samples(eager)
    torch.cuda.synchronize()
    require(len(calls) == 2 and all(x[0] == "sample_tex2" for x in calls),
            f"the eager chain made {[x[:2] for x in calls]}, not two K8 pair calls")
    require(k12_counts["composite"] == 1
            and sum(v for k, v in k12_counts.items() if k != "composite") == 0,
            f"composite_display launched {k12_counts}, not K12 once and nothing else")
    for what, ref in (("its eager chain", c), ("composite", a)):
        require(torch.allclose(b, ref, atol=2e-5, rtol=1e-5),
                f"K12 differs from {what} by {float((b - ref).abs().max())}")
    out = {}
    for name, fn in (("composite", split), ("composite_display", display),
                     ("composite_display_eager", eager), ("build_display_pair", build)):
        dev_ms, launches = trace_calls(fn)
        out[name] = dict(event_ms=cuda_time_ms(fn), device_ms=dev_ms,
                         launches=launches)
    out["max_abs_diff"] = float((b - a).abs().max())
    out["k12_err"] = float((b - c).abs().max())
    # Phase 13's display-pair rows: the eager chain's K8 calls; and K12's.
    out["sample_calls"] = [x + ("composite_display",) for x in calls]
    out["k12"] = dict(
        fn=display, plain=eager,
        nbytes=composite_bytes(eyedirs.numel() // 3, calls, tlut),
        shape=f"{eyedirs.shape[1]}x{eyedirs.shape[0]} (the fused composite)")
    return out


# Phase 14's gates: bench.py's record names 40 dB for its referee
# comparisons (tests/test_bench_config.py:118-138), and the v2 and v3
# marches are held at 40 dB against the exact march there and in
# tests/test_march_v2.py:79. The bench's fields that may be null: its
# ratios against bench.py's TPU target.
BENCH_DB = 40.0
BENCH_NULLABLE = ("vs_baseline", "vs_baseline_with_bake")


def run_bench() -> dict:
    """Phase 14: the port's bench (`cloudscape_tpu_torch.bench.run()` at
    bench.py's sizes) and its sweep's configs 1–3, each record printed on a
    line of its own as it is made, with the kernel counts zeroed just before
    the bench and read just after the sweep; every kernel of K1–K9 must
    launch. Returns the launches."""
    import torch

    from cloudscape_tpu_torch import bench, sweep
    from cloudscape_tpu_torch.engine import tile_arm

    zero_counts()
    rec = bench.run()
    print(json.dumps(rec), flush=True)
    rows = sweep.run((1, 2, 3))
    torch.cuda.synchronize()
    launches = read_counts()
    nulls = [k for k, v in rec.items() if v is None and k not in BENCH_NULLABLE]
    require(not nulls, f"the bench's fields {nulls} are null")
    require(rec["finite"] and rec["per_tile_finite"], "the bench rendered non-finite values")
    for key in ("quality_db_vs_exact", "quality_db_vs_exact_high_coverage"):
        require(rec[key] >= BENCH_DB, f"the bench's {key} {rec[key]:.2f} dB < {BENCH_DB}")
    require(any(tile_arm("fast3", float(b), 96 * 96) == "v3"  # bench.py's 96² tiles
                for b in rec["tile_bucket_hist"]),
            f"the bench's serving cycle has no v3 bucket: {rec['tile_bucket_hist']}")
    require(rec["per_tile_device_ms"] > 0.0,
            f"the bench's per_tile_device_ms is {rec['per_tile_device_ms']}")
    for row in rows:
        if row["config"] in (2, 3):
            require(row["quality_db_vs_exact"] >= BENCH_DB,
                    f"sweep row {row['metric']}: {row['quality_db_vs_exact']:.2f} dB "
                    f"vs the exact march < {BENCH_DB}")
    idle = [k for k, v in launches.items()
            if v == 0 and k not in ("sample_brick3", "sample_brick2")]
    require(not idle, f"phase 14 launched no {idle}: {launches}")
    print(f"phase 14 launches: {launches}", flush=True)
    return launches


def check_cycle_batch(eng, now: float) -> list:
    """Phase 5c: `update_cycle` on two deep copies of the phase-5 engine,
    one through the batched dense march and one through the per-tile loop
    (`_update_tile` a tile, as before the batch): the rest of the current
    cycle, then a whole cycle after the rotation. Each call's rings must be
    bitwise alike, and the batch must launch K1 once per BATCH_DENSE_CHUNK
    of its rays. Returns a row per call: tiles, K1 launches, both calls'
    CUDA-event ms and the batched call's peak allocation."""
    import copy

    import torch

    from cloudscape_tpu_torch import engine as engine_mod
    from cloudscape_tpu_torch.ops import accum

    batched, looped = copy.deepcopy(eng), copy.deepcopy(eng)
    region = eng.perf.update_region_size
    cols = eng.perf.texture_size // region

    def per_tile(tex_idx, start_tile, count):
        for k in range(count):
            row, col = divmod(start_tile + k, cols)
            looped._update_tile(tex_idx, col * region, row * region)

    looped._march_tiles_dense = per_tile
    rows = []
    for call in range(2):
        frames = batched.perf.frames_to_update
        want_tiles = frames if batched.ring.frame >= frames else frames - batched.ring.frame
        tiles0, k1_0 = engine_mod.batched_tiles, accum.launches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms_b = events_ms(lambda: batched.update_cycle(now=now + call), 1)[0]
        peak = torch.cuda.max_memory_allocated() - base
        tiles, k1 = engine_mod.batched_tiles - tiles0, accum.launches - k1_0
        ms_l = events_ms(lambda: looped.update_cycle(now=now + call), 1)[0]
        what = f"update_cycle call {call + 1} ({want_tiles} tiles)"
        require(tiles == want_tiles, f"{what}: the batch marched {tiles} tiles")
        chunks = -(-tiles * region * region // engine_mod.BATCH_DENSE_CHUNK)
        require(k1 == chunks, f"{what}: K1 launched {k1} times, not {chunks}")
        require(batched.ring.frame == looped.ring.frame == frames,
                f"{what}: frames {batched.ring.frame} and {looped.ring.frame}")
        require(float(looped.cloud_ring[looped.ring.texture_to_update][..., 3].max()) > 0,
                f"{what}: no clouds in the tiles compared")
        require(bitwise_equal(batched.cloud_ring, looped.cloud_ring),
                f"{what}: the batched ring differs from the per-tile loop's")
        rows.append(dict(tiles=tiles, k1=k1, batched_ms=ms_b, looped_ms=ms_l,
                         peak_bytes=peak))
    return rows


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
    device_kind = torch.cuda.get_device_name(0)
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
    atmo = check_atmosphere(dev)
    for kname in ("transmittance_lut", "sky_lut"):
        e, rel = atmo[kname]
        what = ("K11 transmittance_lut 64x256" if kname == "transmittance_lut" else
                f"K10 sky_lut 100x200 at suns {ATMO_SUNS} and bands of {SKY_BANDS} rows "
                f"(every band of each height bitwise the whole call)")
        print(f"{what}: max_abs_err {e:.3g} = {rel:.3g} x the plain version's peak "
              f"(gate {ATMO_TOL}); three runs bitwise", flush=True)
    # Every engine on the card validates itself with one probe launch of
    # K1–K3 on a tiny input; those launches are counted here and kept out
    # of the per-pass counts, which price each launch at a pass's shape.
    from cloudscape_tpu_torch.engine import _probe_kernels

    _, probe = counted(lambda: _probe_kernels(dev))
    probe_samples, probe_sizes = read_samples(), read_sizes()
    probe = {k: probe[k] for k in ("accumulate", "compact", "segscan") + SAMPLERS
             + ATMO_KERNELS + ("composite",)}
    require(all(v == (0 if k in SAMPLERS[3:] else 1) for k, v in probe.items()),
            f"the validation probe did not launch K1–K3, K7–K12 once each and the "
            f"brick kernels not at all: {probe}")
    print(f"validation probe (every engine construction): launches {probe}", flush=True)
    stamp("1-4")

    eng, r = run_engine(dev, TICKS)
    ms = r["tick_ms"]
    sky_rows = eng._sky_rows  # the schedule's band: K10's main-path shape
    print(f"engine start (construction + first render_frame, which runs the "
          f"warm start): {r['warm_s']:.2f} s ({card})", flush=True)
    print(f"engine tick (render_frame 1280x720): median {statistics.median(ms):.2f} ms, "
          f"min {min(ms):.2f}, max {max(ms):.2f} over {len(ms)} ticks, "
          f"{r['pickups']} prebaked pickup(s), cloud fraction "
          f"{r['cloud_frac']:.4f}, frame mean {r['frame_mean']:.4f}; pack "
          f"launches {r['noise']} ({card})", flush=True)
    print("tick ms: " + " ".join(f"{v:.1f}" for v in ms), flush=True)
    print(f"engine phase K7–K9 launches {r['samples']}, K10–K11 {r['atmo']} (sky "
          f"bands of {sky_rows} rows)", flush=True)
    stamp("5")

    sample_rows = run_sampler_checks(dev, eng)
    for row in sample_rows:
        texture = row["kernel"] in ("sample_tex3", "sample_tex2")
        gate = ("bitwise" if row["kernel"] == "sample_tiny3"
                else TEXTURE_TOL if texture else SAMPLE_TOL)
        print(f"{row['kernel']} {row['table']} ({row['kind']}): |kernel - plain| / "
              f"max(1, |plain|) {row['err']:.3g} (gate {gate}), three runs and views "
              f"bitwise" + ("; the brick kernel on its brick table bitwise"
                            if texture else ""), flush=True)
    tiny_rows = run_tiny_cases(dev)
    for row in tiny_rows:
        print(f"sample_tiny3 {row['kind']}, {row['samples']} samples, planes at float "
              f"offset {row['offset']} ({row['table']}): bitwise the plain version, "
              f"three runs and views bitwise", flush=True)
    vs = run_v3_small(dev)
    print(f"v3 march {V3_SMALL}x{V3_SMALL}x{STEPS} (octahedral, procedural pack "
          f"16/16/64, coverage 0.6), card vs CPU: {vs['db']:.2f} dB (gate "
          f"{V3_SMALL_DB}); policy {vs['policy']}, cloud fraction "
          f"{vs['cloud_frac']:.4f}; K7–K9 launches (cone build + march) "
          f"{vs['launches']}", flush=True)
    stamp("5b")

    for i, row in enumerate(check_cycle_batch(eng, now=(TICKS + 1) / 60.0)):
        print(f"update_cycle call {i + 1} on the phase-5 engine: {row['tiles']} tiles "
              f"batched, K1 x{row['k1']}, ring bitwise the per-tile loop's; "
              f"{row['batched_ms']:.2f} ms batched vs {row['looped_ms']:.2f} ms a tile at "
              f"a time (CUDA events, one call each), batch peak allocation "
              f"{row['peak_bytes']} B above its start ({card})", flush=True)
    stamp("5c")

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
          f"K1 x{v['k1']}, K2 x{v['k2']}, K3 x{v['k3']}, K7–K9 {v['samples']} per "
          f"call; cloud fraction {v['cloud_frac']:.4f} ({card})", flush=True)
    comp = run_composite(eng, camera_dirs(1280, 720, dev))
    for cname in ("composite", "composite_display", "composite_display_eager",
                  "build_display_pair"):
        cr = comp[cname]
        dev_ms = "not measured" if cr["device_ms"] is None else f"{cr['device_ms']:.4f} ms"
        print(f"{cname} (phase-5 engine, 1280x720): {cr['event_ms']:.4f} ms by CUDA "
              f"events, {dev_ms} on the device by torch.profiler, "
              f"{cr['launches']} device launches a call ({card})", flush=True)
    print(f"composite_display (K12) vs composite: max abs diff "
          f"{comp['max_abs_diff']:.3g}; vs its eager chain {comp['k12_err']:.3g} "
          f"(atol 2e-5 / rtol 1e-5)", flush=True)
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
        print(f"headline coverage {h['cov']} K7–K9 launches (cone build, render, "
              f"referee) {h['samples']}", flush=True)
    k3_launches = segscan.launches
    stamp("8")

    v3_stages = run_v3_stages(headline)
    for t in v3_stages:
        print_stages(t, card)
    stamp("8c")
    for h in headline:
        oc = run_oracle_crop(h)
        print(f"headline coverage {h['cov']} vs the f64 oracle on a {CROP}x{CROP} crop "
              f"(rows {oc['window'][0]}.., columns {oc['window'][1]}.., every "
              f"{CROP_STEP}nd texel: {oc['rays']} rays x {STEPS} steps; cloud fraction "
              f"{oc['cloud_frac']:.4f}): v3 {oc['db_v3']:.2f} dB, the exact march "
              f"(phase 8's referee) {oc['db_exact']:.2f} dB (gates {ORACLE_DB}); v3 vs "
              f"the exact march there {oc['db_v3_exact']:.2f} dB; the phase took "
              f"{oc['host_s']:.1f} s on the host, the oracle's march "
              f"{oc['oracle_s']:.1f} s in {ORACLE_WORKERS} processes ({card})",
              flush=True)
    headline[1].pop("exact")
    for h in headline:  # phases 8c-8d's inputs
        for key in ("out", "params", "cone", "scene", "launches"):
            h.pop(key)
    stamp("8d")

    fld = run_field(dev, headline[0].pop("exact"))
    (_, ray_cap, _), (_, e_cap, _) = fld["compactions"]
    print(f"baked field {FIELD_RES}, cone {FIELD_CONE_RES}, headline coverage 0.35: "
          f"build_density_field {fld['build_ms']:.2f} ms (CUDA events, second call); "
          f"march_baked {WIDTH}x{HEIGHT}x{STEPS} median {fld['ms']:.2f} ms "
          f"({' '.join(f'{t:.2f}' for t in fld['all_ms'])}), {fld['db']:.2f} dB vs the "
          f"referee (band {FIELD_BAND_DB}); K2 x2 ({WIDTH * HEIGHT}->{ray_cap}, "
          f"{fld['compactions'][1][0].numel()}->{e_cap}; {fld['active']} occupied "
          f"samples), bitwise its plain version; occupied_ray_fraction "
          f"{fld['occ']:.4f}, 0.0 on an empty scene; cloud fraction "
          f"{fld['cloud_frac']:.4f} ({card})", flush=True)
    for row in fld["sweep"]:
        print(f"baked field sweep {row['res']}: build {row['build_ms']:.2f} ms, table "
              f"{row['table_mb']:.1f} MB; march_baked {row['ms']:.2f} ms, "
              f"{row['db']:.2f} dB vs the referee ({card})", flush=True)
    print(f"march_baked on tests/test_torch_field.py's scene, card vs CPU: "
          f"{fld['tiny_db']:.2f} dB (gate {FIELD_TINY_DB}), ray indices bitwise equal; "
          f"cloud fraction {fld['tiny_frac']:.4f}", flush=True)
    stamp("8b")

    api = run_api(dev, eng)
    del eng
    print(f"save_file -> load_file (phase-5 engine): rings bitwise, the next fused "
          f"tick's frame and rings bitwise (its tile at {api['tile']}, cloud fraction "
          f"{api['tile_cloud']:.4f}; the prebaked and the restored cone textures "
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
          f"x{c['k1']}, K2 x{c['k2']}, K3 x{c['k3']} (the wrappers' launches and "
          f"{c['graph_replays']} graph replays of v3 tiles, each counted as the "
          f"eager call of its bucket whose device trace it matched; one replay's "
          f"kernels by bucket, from its trace: {c['replay_kernels']}); one v3 tile (bucket "
          f"{c['v3_bucket']}) launches K2 x{len(c['compactions'])}, K3 "
          f"x{len(c['scans'])} (K2 bitwise, K3 max_abs_err {c['k3_err']:.3g} "
          f"against their plain versions); the culled cycle "
          f"{c['cull_db']:.2f} dB vs the dense march; cloud fraction "
          f"{c['cloud_frac']:.4f}, frame mean {c['frame_mean']:.4f} ({card})",
          flush=True)
    print(f"tile-cull K7–K9 launches: timed window {c['samples']}, the phase "
          f"{c['phase']['samples']}", flush=True)
    print("tile-cull tick ms: " + " ".join(f"{t:.1f}" for t in ev), flush=True)
    del ceng
    print_stages(c["tile_stages"], card)
    v3_stages.append(c["tile_stages"])
    print(json.dumps({"v3_stages": v3_stages, "card": card}), flush=True)
    stamp("11b")
    pr = run_probe(dev)
    print(f"probe_prebake: fitted costs {pr['bake_costs']}, bake budget "
          f"{pr['bake_tick_ms']:.2f} ms, schedule {pr['schedule_now']}; labelled ticks "
          f"median {pr['median_ms']:.2f} ms, max {max(t['ms'] for t in pr['ticks']):.2f}; "
          f"{sum(t['stage'] == 'sky_band' for t in pr['ticks'])} sky-band tick(s), one "
          f"K10 launch each and no plain call ({card})", flush=True)
    stamp("11h")
    sc = run_short_cycle(dev)
    print(f"f4 engine (fast3 tile cull, 768²/4/128, cone {CONE_RES}, {sc['region']}² "
          f"tiles, fused render_frame 1280x720): start {sc['warm_s']:.2f} s; prebake "
          f"ticks {sc['groups']}; no synchronous bake, no dropped step, each "
          f"rotation's cone bitwise _build_cone's; every v3 tick a graph replay, "
          f"{sc['replays_checked']} replayed tiles bitwise the eager arm's; warm "
          f"start K2 bitwise, its v2 "
          f"tile's K1 max_abs_err {sc['k1_err']:.3g}; a v3 tick's K2 x{sc['v3_k2']} "
          f"bitwise, K3 x{sc['v3_k3']} max_abs_err {sc['k3_err']:.3g} ({card})",
          flush=True)
    print("f4 ticks: " + "; ".join(f"{r['tick']} {r['stage']} {r['arm']} ({r['bucket']}) "
                                   f"{r['ms']:.2f} ms" for r in sc["rows"]), flush=True)
    stamp("11i")

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
    # march_baked's two calls (phase 8b), as they ran: off the serving pass.
    rows["compact"] += [dict(time_compact(m, cap, wr), serves="march_baked")
                        for m, cap, wr in fld["compactions"]]
    # K7–K9 on their recorded calls, one per table: the headline render's
    # (phase 8, coverage 0.35; its cone build's for the tiny volumes), the
    # fused composite's display pairs (phase 7b) and march_baked's field
    # (phase 8b), each held against its plain version (`check_sampler`;
    # a texture also as brick rows, `check_texture`) before it is timed.
    # Each kernel's main-path row, first, is its largest call in the
    # headline. The brick kernels' rows are the same calls on the brick
    # tables of the same texels.
    sample_errs = {}
    sample_calls = {}
    for kname in MAIN_SAMPLERS:
        calls = [x for x in headline[0]["sample_calls"] + comp["sample_calls"]
                 + fld["sample_calls"] if x[0] == kname]
        calls.sort(key=lambda x: (x[4] not in ("the headline v3 render",
                                               "the headline's cone build"),
                                  -x[3][0].numel()))
        for _, tkind, tab, qs, serves in calls:
            what = f"{kname} on {tkind} ({serves})"
            if is_texture(tab):
                checked = check_texture(what, tab, qs)
            else:
                err, abs_err, _ = check_sampler(what, tab, qs)
                checked = [(kname, tkind, err, abs_err)]
            for k, k_kind, err, abs_err in checked:
                sample_errs.setdefault(k, []).append(abs_err)
                gate = ("bitwise" if k == "sample_tiny3" else TEXTURE_TOL
                        if k in ("sample_tex3", "sample_tex2") else SAMPLE_TOL)
                print(f"{k} {k_kind}, {qs[0].numel()} samples ({serves}, recorded): "
                      f"|kernel - plain| / max(1, |plain|) {err:.3g} (gate {gate}), "
                      f"three runs and views bitwise", flush=True)
        sample_calls[kname] = calls
        rows[kname] = [time_sampler(*x) for x in calls]
    for kname, tname in (("sample_brick3", "sample_tex3"), ("sample_brick2", "sample_tex2")):
        rows[kname] = [row["brick"] for row in rows[tname]]
        for row in rows[tname]:
            row["brick_us"] = row.pop("brick")["device_us"]
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
    # K7–K9's launches and samples per pass, counted where they launch, and
    # their launches by sample count: a pass's calls run from a few thousand
    # samples (a v3 tile's light steps) to millions (the cone build), so each
    # main-path sampler is priced by size bucket (`price_sizes`) on its
    # main-row call. The brick kernels are off the pass.
    sample_pass, pass_sizes = {}, {}
    for k in SAMPLERS:
        sample_pass[k] = (
            r["samples"][k] - probe[k] + v["samples"][k] + c["samples"][k],
            r["sample_sizes"][k] - probe_samples[k] + v["sample_sizes"][k]
            + c["window_samples"][k])
    for k in SAMPLERS + ("accumulate", "compact", "segscan"):
        pass_sizes[k] = (r["size_counts"][k] - probe_sizes[k] + v["size_counts"][k]
                         + c["window_sizes"][k])
    # K1–K3's launches a pass by element count, for pricing them by size
    # as K7–K9 are.
    for k in ("accumulate", "compact", "segscan"):
        print(f"{k} launches per pass by element count: "
              f"{dict(sorted(pass_sizes[k].items()))}", flush=True)
    for k in MAIN_SAMPLERS:
        _, _, tab, qs, _ = sample_calls[k][0]
        groups[k] = price_sizes(k, tab, qs, pass_sizes[k])
    # K10–K11: the engine's sky band and transmittance LUT; a pass is phase
    # 5 without its validation probe and the tile-cull window.
    for k, (ins, mufu) in SERIAL_WORK.items():
        print(f"{k}: bound by the frozen work of a texel, {ins} SASS instructions "
              f"and {mufu} MUFU at the least (the one-thread form's SASS)", flush=True)
    rows.update(time_atmosphere(dev, atmo["tlut"], sky_rows))
    atmo_pass = {k: r["atmo"][k] - probe[k] + c["atmo_window"][k] for k in ATMO_KERNELS}
    for k in ATMO_KERNELS:
        groups[k] = [(atmo_pass[k], rows[k][0])]
    # K12: the fused composite of phase 7b, one launch a tick; a pass is
    # phase 5 without its validation probe and the tile-cull window.
    k12 = comp["k12"]
    rows["composite"] = [timed_row(k12["shape"], k12["fn"], KERNEL_NAMES["composite"],
                                   k12["nbytes"], event_ms=cuda_time_ms(k12["fn"]),
                                   plain_ms=cuda_time_ms(k12["plain"], reps=3))]
    k12_pass = r["composite"] - probe["composite"] + c["composite_window"]
    groups["composite"] = [(k12_pass, rows["composite"][0])]
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
            serves = f" ({row['serves']})" if "serves" in row else ""
            extra = "" if kname not in SAMPLERS else (
                f"; events {row['event_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                f"library " + ("none: no repeat wrap in PyTorch"
                               if row["library_ms"] is None else
                               f"{row['library_ms']:.4f} ms, {row['library_device_us']:.2f} "
                               f"us device ({row['library']}; the kernel "
                               f"{row['library_device_us'] / row['device_us']:.2f}x "
                               f"faster by device time)"))
            if kname == "composite":
                extra = (f"; events {row['event_ms']:.4f} ms, plain (the eager chain) "
                         f"{row['plain_ms']:.4f} ms, library none: no PyTorch call "
                         f"composites the sky")
            if kname in ATMO_KERNELS:
                extra = (f"; issue term {row['issue_us']:.2f} us, SFU term "
                         f"{row['sfu_us']:.2f} us ("
                         f"{'SFU' if row['sfu_us'] > row['issue_us'] else 'issue'} binds)"
                         f"; events {row['event_ms']:.4f} ms, plain {row['plain_ms']:.4f} "
                         f"ms, library none: no PyTorch call computes the LUT")
            if "brick_us" in row:
                extra += f"; the brick kernel {row['brick_us']:.2f} us"
            if "addcmul_us" in row:
                extra += (f"; stream yardstick torch.addcmul(qx, qy, qz) "
                          f"{row['addcmul_us']:.2f} us, the kernel "
                          f"{row['device_us'] / row['addcmul_us']:.2f}x it")
            print(f"{kname} {row['shape']}{serves}: {row['device_us']:.2f} us device "
                  f"({row['kernels_per_call']} kernel(s), {row['kernel_sum_us']:.2f} us "
                  f"in kernels, {row['timing']}; {row['device_us_write_flush']:.2f} us "
                  f"after a write flush), bound {row['bound_us']:.2f} us by "
                  f"{row['bound_by']}, share {row['bound_share']:.3f}{extra} ({card})",
                  flush=True)

    # K7's 1-ch 32³ repeat row: code no later change touched, so it
    # anchors this run's device times against earlier runs' (PERF.md §6).
    anchor = [row for row in rows["sample_tex3"]
              if row["shape"].startswith("1-ch 32x32x32 texture, repeat, float32")]
    require(bool(anchor), "no K7 call on the 1-ch 32³ noise mip was recorded")
    print(f"anchor: sample_tex3 {anchor[0]['shape']}: {anchor[0]['device_us']:.2f} us "
          f"device, share {anchor[0]['bound_share']:.3f} ({card})", flush=True)

    # launches: the counts read around each kernel's path (K1, K2: the
    # engine ticks; K3: the full-hemisphere and headline renders; K4–K6:
    # the engine's construction and config 4's pack); launches_tile_cull:
    # the tile-cull phase's (construction, warm start and every tick).
    # launches_per_pass: phase 5 (construction but its validation probe,
    # warm start, the ticks), phase 7's first render_full_hemisphere and
    # the tile-cull timed window.
    meta = [
        ("accumulate", "accum.cu", "ops/accum_pallas.py:101", r["k1"],
         p5_k1 + v["k1"] + c["k1"], c["phase"]["k1"], max(k1_err, k1_64_err)),
        ("compact", "compact.cu", "ops/compact_pallas.py:184", r["k2"],
         p5_k2 + v["k2"] + c["k2"], c["phase"]["k2"], 0.0),
        ("segscan", "segscan.cu", "ops/segscan_pallas.py:121", k3_launches,
         v["k3"] + c["k3"], c["phase"]["k3"], max(k3_err, c["k3_err"])),
    ]
    for (kname, _, _, _), line in zip(NOISE_CASES, (187, 214, 240)):
        meta.append((f"noise_{kname}", "noise.cu", f"ops/noise_pallas.py:{line}",
                     r["noise"][kname] + c4["noise_launches"][kname],
                     r["noise"][kname], c["phase"]["noise"][kname],
                     noise_rows[kname]["err"]))
        groups[f"noise_{kname}"] = [(r["noise"][kname], rows[f"noise_{kname}"][0])]
    # K7–K9: JAX's XLA gather and lane-weight reduce, no pallas_call. The
    # launches: phase 5's; max_abs_err: phase 5b's checks and phase 8b's
    # field call.
    for kname, line in zip(SAMPLERS, (282, 323, 351, 282, 323)):
        errs = [x["abs_err"] for x in sample_rows if x["kernel"] == kname]
        errs += sample_errs[kname]
        meta.append((kname, "sample.cu", f"ops/brick.py:{line} (no pallas_call: XLA's "
                     f"gather and lane-weight reduce)", r["samples"][kname],
                     sample_pass[kname][0], c["phase"]["samples"][kname], max(errs)))
    # K10–K11: JAX jits the eager math of models/atmosphere.py, no
    # pallas_call. The launches: phase 5's; max_abs_err: phase 4c's checks.
    for kname, line in zip(ATMO_KERNELS, (208, 122)):
        meta.append((kname, "atmosphere.cu", f"models/atmosphere.py:{line} (no "
                     f"pallas_call: XLA's fusion of the jitted math)", r["atmo"][kname],
                     atmo_pass[kname], c["phase"]["atmo"][kname], atmo[kname][0]))
    # K12: JAX jits composite_display, no pallas_call. The launches: phase
    # 5's; max_abs_err: phase 7b's check against the eager chain.
    meta.append(("composite", "composite.cu", "models/compositor.py:111 (no pallas_call: "
                 "XLA's fusion of the jitted composite_display)", r["composite"],
                 k12_pass, c["phase"]["composite"], comp["k12_err"]))
    kernels = []
    for kname, src, tpu, launches, per_pass, cull_launches, err in meta:
        main_row = rows[kname][0]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"cloudscape_tpu_torch/csrc/{src}",
            "replaces": f"cloudscape_tpu/{tpu}",
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
            "loss_per_pass_us": loss_per_pass_us(groups[kname])
            if kname in groups else None,
            "samples_per_pass": sample_pass[kname][1] if kname in SAMPLERS else None,
            "redesigned_in": REDESIGNED_IN.get(kname),
            # K2's function has a single PyTorch call (with the caveat in
            # `time_nonzero`), and so has a clamp-wrap sample (grid_sample,
            # on a row that is not the main one: `library_row`).
            "library_ms": nonzero_ms if kname == "compact" else next(
                (x["library_ms"] for x in rows[kname] if x.get("library_ms")), None),
            "library_row": next((x["shape"] for x in rows[kname]
                                 if x.get("library_ms")), None),
            "library_device_us": next((x["library_device_us"] for x in rows[kname]
                                       if x.get("library_device_us")), None),
            "shapes": rows[kname]})
    # The redesign rule: launches per pass x (device time - bound); a kernel
    # at or above half of its bound is left alone, and one already
    # redesigned is marked so.
    ranked = sorted((k for k in kernels if k["loss_per_pass_us"] is not None),
                    key=lambda k: -k["loss_per_pass_us"])
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
    for kname in MAIN_SAMPLERS:
        n, n_samples = sample_pass[kname]
        print(f"{kname} per pass: {n} launches, {n_samples} samples "
              f"({n_samples / max(n, 1):.0f} a launch); by size bucket: " + "; ".join(
                  f"{k:g} x {row['shape']} ({row['device_us']:.2f} us, bound "
                  f"{row['bound_us']:.2f} us)" for k, row in groups[kname]), flush=True)
    stamp("13")

    bench_launches = run_bench()
    for k in kernels:
        k["launches_bench"] = bench_launches[k["name"]]
    stamp("14")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
