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
6. the same engine at a tiny size on the card and on the CPU (where the
   wrappers take their plain versions): ≥ 50 dB apart;
7. timings (warm start, median ms per tick, each kernel beside its plain
   version), a JSON line with the kernels, and as the last line
   {"ok": true, "device": {...}}.

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
    """Phase 5: the default engine on the card through its serving API."""
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
    return dict(warm_s=warm_s, tick_ms=tick_ms, pickups=pickups,
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
    (ring_gpu, view_gpu), (ring_cpu, view_cpu) = out
    return psnr(ring_gpu, ring_cpu), psnr(view_gpu, view_cpu), \
        float((ring_cpu[..., 3] > 0.1).mean())


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

    r = run_engine(dev, TICKS)
    ms = r["tick_ms"]
    print(f"engine start (construction + first render_frame, which runs the "
          f"warm start): {r['warm_s']:.2f} s ({card})", flush=True)
    print(f"engine tick (render_frame 1280x720): median {statistics.median(ms):.2f} ms, "
          f"min {min(ms):.2f}, max {max(ms):.2f} over {len(ms)} ticks, "
          f"{r['pickups']} prebaked pickup(s), cloud fraction "
          f"{r['cloud_frac']:.4f}, frame mean {r['frame_mean']:.4f} ({card})",
          flush=True)
    print("tick ms: " + " ".join(f"{v:.1f}" for v in ms), flush=True)
    ring_db, view_db, frac = tiny_parity(dev)
    print(f"tiny engine card vs CPU: ring {ring_db:.1f} dB, view {view_db:.1f} dB "
          f"(cloud fraction {frac:.3f})", flush=True)
    require(ring_db >= 50.0 and view_db >= 50.0, "card and CPU engines disagree")
    require(frac > 0.0, "the tiny engine rendered no clouds")

    # launches: the counts read around the main-path run (run_engine).
    kernels = [
        {"name": "accumulate", "route": "cuda",
         "source": "cloudscape_tpu_torch/csrc/accum.cu",
         "replaces": "cloudscape_tpu/ops/accum_pallas.py:101",
         "launches": r["k1"], "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "compact", "route": "cuda",
         "source": "cloudscape_tpu_torch/csrc/compact.cu",
         "replaces": "cloudscape_tpu/ops/compact_pallas.py:184",
         "launches": r["k2"], "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
