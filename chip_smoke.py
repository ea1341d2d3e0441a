#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and exits nonzero; there is no CPU path):

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from cloudscape_tpu_torch/csrc with nvcc (sm_90a);
3. K1 (accumulate) against its plain version at the serving tile's shape
   [9216, 128], atol 2e-5, with empty and below-horizon rays exactly 0;
4. K2 (compact) against its plain version, bitwise, at the cone-occupancy
   finalize's shape (8,388,608 cells, capacity 3,801,088), plus empty,
   full and overflow masks and a length that is no multiple of 128;
5. the default engine (fast3, 768² / 64 frames / 128 steps / 6 light
   steps, cone cache (32, 512, 512), procedural_noise_pack(0)) on the card:
   construction and a first render_frame (warm start), then 70 more
   render_frame ticks of a 1280×720 camera, crossing a
   cycle boundary that picks up a prebaked cone cache; the launch counts of
   K1 and K2 must show the path ran through both kernels; frames must be
   finite, nonnegative and not black, and the cloud ring must hold clouds;
6. K3 (segscan) against its plain version at the phase-5 engine's v3
   hot-list capacity (random heads, one segment over every tile, every
   element its own segment — bitwise), a ragged length, more tiles than
   the carry scan has threads, and one element, atol 2e-4;
7. the full-hemisphere re-render of the phase-5 engine
   (`render_full_hemisphere`: v3 march at 768² × 128 steps, policy from
   `_v3_policy`): finite, K3 launched ≥ 4 and K2 ≥ 3 times in the call,
   ≥ 30 dB against the dense march (`march_tile_dense`) over the same
   texel directions with the same cone cache and params (`V3_ENGINE_DB`
   says why not 40), and with every gate off ≥ 100 dB;
8. the bench.py headline scene: 1024×512 hemisphere rays × 128 steps,
   coverage 0.35 and 0.7, sun (0.3, 0.4, −0.85), cone (32, 512, 512),
   procedural_noise_pack(0), `v3_auto_policy`, then
   `march_bricks_v3(chunk=32768, ray_stride=2)`: cone-build ms, the median
   of 5 renders, ≥ 40 dB against the dense march at both coverages;
9. the same engine at a tiny size on the card and on the CPU (where the
   wrappers take their plain versions): ring, view and
   `render_full_hemisphere` ≥ 50 dB apart;
10. timings (warm start, median ms per tick, each kernel beside its plain
   version), a JSON line with the kernels, and as the last line
   {"ok": true, "device": {...}}.

The kernels line's launch counts are read around the path each kernel
serves: K1 and K2 around phase 5, K3 around phases 7 and 8.

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


def check_accumulate(dev):
    """Phase 3: K1 against its plain version at the serving tile's shape."""
    import torch

    from cloudscape_tpu_torch.ops import accum

    n, steps = 9216, 128
    rng = np.random.default_rng(1)
    A = -np.abs(rng.random((n, steps))) * 0.1 * (rng.random((n, steps)) < 0.3)
    A[: n // 8] = 0.0                                   # empty rays
    cd3 = -rng.random((n, steps)) * 0.5
    hf = rng.random((n, steps))
    phase = rng.random(n)
    above = np.ones(n, bool)
    above[n // 8: n // 4] = False                       # below the horizon
    scal = rng.random(12)
    t = [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
         for x in (A, cd3, hf, phase, scal)]
    above_t = torch.from_numpy(above).to(dev)
    args = (t[0], t[1], t[2], t[3], above_t, t[4])
    got = accum.accumulate(*args)
    want = accum.accumulate_reference(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    require(got.shape == (n, 4) and bool(torch.isfinite(got).all()),
            "K1 output has the wrong shape or is not finite")
    require(err <= 2e-5, f"K1 max abs err {err} > 2e-5")
    require(bool((got[: n // 4] == 0).all()), "empty/below-horizon rays not 0")
    require(float(want[n // 4:, 3].max()) > 0.5, "test input saturates nothing")
    ms = cuda_time_ms(lambda: accum.accumulate(*args))
    plain_ms = cuda_time_ms(lambda: accum.accumulate_reference(*args))
    return err, ms, plain_ms


def check_compact(dev):
    """Phase 4: K2 against its plain version, bitwise."""
    import torch

    from cloudscape_tpu_torch.ops import compact

    n, cap = 8_388_608, 3_801_088
    g = torch.Generator(device=dev).manual_seed(2)
    cases = [
        ("sparse", torch.rand(n, generator=g, device=dev) < 0.3, cap),
        ("overflow", torch.rand(n, generator=g, device=dev) < 0.6, cap),
        ("empty", torch.zeros(n, dtype=torch.bool, device=dev), cap),
        ("full", torch.ones(n, dtype=torch.bool, device=dev), cap),
        ("ragged", torch.rand(1_000_003, generator=g, device=dev) < 0.5, 300_000),
    ]
    err = 0.0
    for name, mask, c in cases:
        idx, rank = compact.compact(mask, c, mask.shape[0])
        ridx, rrank = compact.compact_reference(mask, c, mask.shape[0])
        torch.cuda.synchronize()
        require(torch.equal(idx, ridx), f"K2 idx differs ({name})")
        require(torch.equal(rank, rrank), f"K2 rank differs ({name})")
        err = max(err, float((idx - ridx).abs().max()),
                  float((rank - rrank).abs().max()))
    mask = cases[0][1]
    ms = cuda_time_ms(lambda: compact.compact(mask, cap, n))
    plain_ms = cuda_time_ms(lambda: compact.compact_reference(mask, cap, n))
    return err, ms, plain_ms


def check_segscan(dev, n_hot: int):
    """Phase 6: K3 against its plain version. Values of the long segment are
    scaled so its running sum stays O(1) and f32 rounding stays far below
    the gate."""
    import torch

    from cloudscape_tpu_torch.ops import segscan

    g = torch.Generator(device=dev).manual_seed(3)

    def normal(k, scale=1.0):
        return torch.randn(k, generator=g, device=dev) * scale

    def flags(k, p):
        return torch.rand(k, generator=g, device=dev) < p

    cases = [
        ("random heads", normal(n_hot), flags(n_hot, 0.1)),
        ("one segment", normal(n_hot, 1e-3), torch.zeros(n_hot, dtype=torch.bool,
                                                          device=dev)),
        ("own segments", normal(n_hot), torch.ones(n_hot, dtype=torch.bool,
                                                   device=dev)),
        ("ragged", normal(1_000_003), flags(1_000_003, 0.01)),
        # More tiles (1,465) than the carry scan's 1,024 threads, segments
        # ~1M long.
        ("many tiles", normal(6_000_001, 1e-3), flags(6_000_001, 1e-6)),
        ("one element", normal(1), torch.zeros(1, dtype=torch.bool, device=dev)),
    ]
    err = 0.0
    for name, v, h in cases:
        got = segscan.segscan(v, h)
        want = segscan.segscan_reference(v, h)
        torch.cuda.synchronize()
        require(got.shape == v.shape and bool(torch.isfinite(got).all()),
                f"K3 output has the wrong shape or is not finite ({name})")
        e = float((got - want).abs().max())
        require(e <= 2e-4, f"K3 max abs err {e} > 2e-4 ({name})")
        if name == "own segments":
            require(torch.equal(got, v), "K3 not bitwise on one-element segments")
        err = max(err, e)
    v, h = cases[0][1], cases[0][2]
    ms = cuda_time_ms(lambda: segscan.segscan(v, h))
    plain_ms = cuda_time_ms(lambda: segscan.segscan_reference(v, h))
    return err, ms, plain_ms


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
    from cloudscape_tpu_torch.ops import compact, segscan
    from cloudscape_tpu_torch.ops.octmap import texel_directions
    from cloudscape_tpu_torch.utils.image import psnr

    perf = eng.perf
    torch.cuda.synchronize()
    k2_0, k3_0 = compact.launches, segscan.launches
    t0 = time.perf_counter()
    out = eng.render_full_hemisphere()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    k2, k3 = compact.launches - k2_0, segscan.launches - k3_0
    require(k3 >= 4, f"render_full_hemisphere launched K3 {k3} < 4 times")
    require(k2 >= 3, f"render_full_hemisphere launched K2 {k2} < 3 times")
    n_tex = perf.texture_size
    require(out.shape == (n_tex, n_tex, 4) and bool(torch.isfinite(out).all()),
            "render_full_hemisphere output has the wrong shape or is not finite")
    ms = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        eng.render_full_hemisphere()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
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
                ms=statistics.median(ms), db=db, off_db=off_db, k2=k2, k3=k3,
                cloud_frac=float((out[..., 3] > 0.1).float().mean()))


def run_headline(dev):
    """Phase 8: the bench.py headline scene, coverage 0.35 (timed) and 0.7."""
    import torch

    from cloudscape_tpu_torch.models import atmosphere
    from cloudscape_tpu_torch.models.density import MarchParams
    from cloudscape_tpu_torch.models.march_fast import (
        BrickPack, build_cone_cache, march_bricks_v3, march_tile_dense,
        v3_auto_policy, v3_capacities)
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
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        cone = build()
        end.record()
        torch.cuda.synchronize()
        cone_ms = start.elapsed_time(end)

        def render():
            return march_bricks_v3(dirs, params, bricks, sky, steps=STEPS,
                                   chunk=32768, cell_keep_frac=ck,
                                   hot_keep_frac=hk, cone_cache=cone,
                                   ray_keep_frac=rk, ray_stride=2)

        out = render()
        ms = []
        for _ in range(5 if cov == 0.35 else 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            render()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        require(bool(torch.isfinite(out).all()), f"headline v3 not finite (cov {cov})")
        dense = march_tile_dense(dirs, params, bricks, sky, steps=STEPS,
                                 light_steps=6, chunk=16384, cone_cache=cone)
        db = psnr(out.cpu().numpy(), dense.cpu().numpy())
        require(db >= 40.0, f"headline v3 vs dense {db:.2f} dB < 40 (cov {cov})")
        caps = v3_capacities(WIDTH * HEIGHT, STEPS, 32768, ck, rk, 32, hk)
        rows.append(dict(cov=cov, policy=(rk, ck, hk), cell_frac=cell_frac,
                         hot_frac=hot_frac, caps=caps, cone_ms=cone_ms,
                         ms=statistics.median(ms), all_ms=ms, db=db,
                         cloud_frac=float((out[..., 3] > 0.1).float().mean())))
    return rows


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
    from cloudscape_tpu_torch.ops import accum, compact

    perf = PerfConfig()  # 768², 64 frames, 128 steps, 6 light steps
    eyedirs = camera_dirs(1280, 720, dev)
    accum.launches = 0
    compact.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = CloudSkyEngine(perf=perf, config=CloudConfig(cloud_coverage=0.45),
                         sun=SunState(direction=(0.3, 0.25, -0.9)),
                         device=dev)
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
                     k1=k1_launches, k2=k2_launches, cloud_frac=cloud_frac,
                     frame_mean=float(frame.mean()))


def tiny_parity(dev):
    """Phase 6: a tiny engine on the card (kernels) and on the CPU (plain
    versions) from one procedural pack: PSNR of the cloud ring and a view."""
    import torch

    from cloudscape_tpu_torch import CloudConfig, PerfConfig, SunState
    from cloudscape_tpu_torch.engine import CloudSkyEngine
    from cloudscape_tpu_torch.models.packs import procedural_noise_pack
    from cloudscape_tpu_torch.ops.octmap import texel_directions
    from cloudscape_tpu_torch.utils.image import psnr

    noise = procedural_noise_pack(1, 16, 16, 64)
    out = []
    hemis = []
    for d in (dev, torch.device("cpu")):
        pack = type(noise)(large=tuple(l.to(d) for l in noise.large),
                           small=tuple(s.to(d) for s in noise.small),
                           weather=noise.weather.to(d))
        e = CloudSkyEngine(perf=PerfConfig(32, 16, march_steps=16, light_steps=2),
                           config=CloudConfig(cloud_coverage=0.6),
                           sun=SunState(direction=(0.3, 0.5, -0.8)), noise=pack,
                           cone_res=(8, 64, 64), device=d)
        for i in range(20):
            e.update_sky(now=i / 30.0)
        view = e.render_view(texel_directions(48, device=d) * torch.tensor(
            [1.0, 0.7, 1.0], device=d))
        out.append((e.cloud_ring.cpu().numpy(), view.cpu().numpy()))
        # 16 steps: prepass_steps 4 < 8, the policy's rebase branch.
        hemis.append(e.render_full_hemisphere().cpu().numpy())
    (ring_gpu, view_gpu), (ring_cpu, view_cpu) = out
    return psnr(ring_gpu, ring_cpu), psnr(view_gpu, view_cpu), \
        psnr(hemis[0], hemis[1]), float((ring_cpu[..., 3] > 0.1).mean())


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
    name = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    lib_path = _cuda.build()
    _cuda.lib()
    print(f"build: {lib_path} in {time.perf_counter() - t0:.1f} s", flush=True)
    with open(lib_path + ".log") as f:
        print(f.read(), flush=True)

    k1_err, k1_ms, k1_plain = check_accumulate(dev)
    print(f"K1 accumulate [9216,128]: max_abs_err {k1_err:.3g}, "
          f"{k1_ms:.4f} ms kernel vs {k1_plain:.4f} ms plain ({card})", flush=True)
    k2_err, k2_ms, k2_plain = check_compact(dev)
    print(f"K2 compact 8388608→3801088: bitwise, {k2_ms:.4f} ms kernel vs "
          f"{k2_plain:.4f} ms plain ({card})", flush=True)

    eng, r = run_engine(dev, TICKS)
    ms = r["tick_ms"]
    print(f"engine start (construction + first render_frame, which runs the "
          f"warm start): {r['warm_s']:.2f} s ({card})", flush=True)
    print(f"engine tick (render_frame 1280x720): median {statistics.median(ms):.2f} ms, "
          f"min {min(ms):.2f}, max {max(ms):.2f} over {len(ms)} ticks, "
          f"{r['pickups']} prebaked pickup(s), cloud fraction "
          f"{r['cloud_frac']:.4f}, frame mean {r['frame_mean']:.4f} ({card})",
          flush=True)
    print("tick ms: " + " ".join(f"{v:.1f}" for v in ms), flush=True)

    from cloudscape_tpu_torch.models.march_fast import v3_capacities

    n_tex = eng.perf.texture_size
    ps, _ = eng._v3_march_knobs()
    rk, ck, hk = eng._v3_policy(eng._march_params)
    _, _, cap_h = v3_capacities(n_tex * n_tex, eng.perf.march_steps,
                                min(n_tex * n_tex, 32768), ck, rk, ps, hk)
    k3_err, k3_ms, k3_plain = check_segscan(dev, cap_h)
    print(f"K3 segscan N={cap_h} (the engine's v3 hot-list capacity): "
          f"max_abs_err {k3_err:.3g}, {k3_ms:.4f} ms kernel vs {k3_plain:.4f} ms "
          f"plain ({card})", flush=True)

    from cloudscape_tpu_torch.ops import segscan
    segscan.launches = 0
    v = run_v3_engine(eng)
    print(f"render_full_hemisphere {n_tex}x{n_tex}x{eng.perf.march_steps}: policy "
          f"(ray, cell, hot) {v['policy']}, kept rays {v['caps'][0]}, cap_c "
          f"{v['caps'][1]}, cap_h {v['caps'][2]}; first call {v['first_ms']:.2f} ms, "
          f"then median {v['ms']:.2f} ms of 3; "
          f"{v['db']:.2f} dB vs dense ({v['off_db']:.2f} dB with every gate off); "
          f"K2 x{v['k2']}, K3 x{v['k3']} per call; "
          f"cloud fraction {v['cloud_frac']:.4f} ({card})", flush=True)
    del eng
    for h in run_headline(dev):
        print(f"headline v3 {WIDTH}x{HEIGHT}x{STEPS} coverage {h['cov']}: policy "
              f"{h['policy']} (cell_frac {h['cell_frac']:.4f}, hot_frac "
              f"{h['hot_frac']:.4f}), kept rays {h['caps'][0]}, cap_c {h['caps'][1]}, "
              f"cap_h {h['caps'][2]}; cone build {h['cone_ms']:.2f} ms; render "
              f"median {h['ms']:.2f} ms ({' '.join(f'{t:.2f}' for t in h['all_ms'])}); "
              f"{h['db']:.2f} dB vs dense; cloud fraction {h['cloud_frac']:.4f} "
              f"({card})", flush=True)
    k3_launches = segscan.launches

    ring_db, view_db, hemi_db, frac = tiny_parity(dev)
    print(f"tiny engine card vs CPU: ring {ring_db:.1f} dB, view {view_db:.1f} dB, "
          f"render_full_hemisphere {hemi_db:.1f} dB (cloud fraction {frac:.3f})",
          flush=True)
    require(ring_db >= 50.0 and view_db >= 50.0 and hemi_db >= 50.0,
            "card and CPU engines disagree")
    require(frac > 0.0, "the tiny engine rendered no clouds")

    # launches: the counts read around each kernel's path (K1, K2: the
    # engine ticks; K3: the full-hemisphere and headline renders).
    kernels = [
        {"name": "accumulate", "route": "cuda",
         "source": "cloudscape_tpu_torch/csrc/accum.cu",
         "replaces": "cloudscape_tpu/ops/accum_pallas.py:101",
         "launches": r["k1"], "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "compact", "route": "cuda",
         "source": "cloudscape_tpu_torch/csrc/compact.cu",
         "replaces": "cloudscape_tpu/ops/compact_pallas.py:184",
         "launches": r["k2"], "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain},
        {"name": "segscan", "route": "cuda",
         "source": "cloudscape_tpu_torch/csrc/segscan.cu",
         "replaces": "cloudscape_tpu/ops/segscan_pallas.py:121",
         "launches": k3_launches, "max_abs_err": k3_err, "ms": k3_ms,
         "plain_ms": k3_plain},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
