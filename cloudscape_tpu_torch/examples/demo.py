"""Time-of-day demo: animated wind + sun sweep (BASELINE configs 2-3).

The PyTorch port of `examples/demo.py`: builds the engine, sweeps the sun
from dawn to dusk while ticking the amortized update loop, and writes
tonemapped camera frames as PNGs.

    python -m cloudscape_tpu_torch.examples.demo --frames 8 --out cloud_demo
    python -m cloudscape_tpu_torch.examples.demo --size 768 --frames-to-update 64

The default kernel is the serving path bench.py times — fast3 (cell-gated
v3 march; small tiles take the dense arm) with per-tile culling; `--serve`
runs the fused per-display-frame `render_frame` loop (tile tick +
composite), the analog of the reference's per-frame operating mode
(`cloud_sky.gd:129-163`).

Runs on the card; `--cpu` runs on the CPU instead (the kernels' plain
versions; slow at the default sizes: the 128³ noise volume and the cone
cache take minutes there).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from cloudscape_tpu_torch import CloudConfig, PerfConfig
from cloudscape_tpu_torch.engine import CloudSkyEngine
from cloudscape_tpu_torch.utils.image import tonemap_aces, write_png
from cloudscape_tpu_torch.utils.profiling import StageTimer


def camera_rays(width: int, height: int, yaw: float = 0.0,
                pitch: float = 0.25, fov: float = 1.2) -> np.ndarray:
    """Pinhole camera ray grid, y-up world."""
    xs = (np.arange(width) + 0.5) / width * 2.0 - 1.0
    ys = 1.0 - (np.arange(height) + 0.5) / height * 2.0
    aspect = height / width
    px = xs[None, :] * np.tan(fov / 2)
    py = ys[:, None] * np.tan(fov / 2) * aspect
    d = np.stack(
        [np.broadcast_to(px, (height, width)),
         np.broadcast_to(py, (height, width)),
         -np.ones((height, width))], axis=-1,
    )
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    rot_p = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    rot_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    d = d @ rot_p.T @ rot_y.T
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def tile_rays_serve(engine, args) -> int:
    """Rays marched per serving tick: one tile plus the camera composite."""
    return engine.perf.update_region_size ** 2 + args.width * args.height


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="cloud_demo")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=256,
                    help="hemisphere map edge (reference default: 768)")
    ap.add_argument("--frames-to-update", type=int, default=16,
                    choices=(4, 16, 64, 256))
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=300)
    ap.add_argument("--coverage", type=float, default=0.4)
    ap.add_argument("--wind-speed", type=float, default=30.0)
    ap.add_argument("--kernel", default="fast3",
                    choices=("fast3", "fast2", "fast", "reference"),
                    help="fast3 = the production serving path (v3 cell-gated "
                         "march; bench.py's path)")
    ap.add_argument("--tile-cull", dest="tile_cull", action="store_true",
                    default=None,
                    help="per-tile ray culling from the per-cycle priority "
                         "map (default: on for fast2/fast3)")
    ap.add_argument("--no-tile-cull", dest="tile_cull", action="store_false")
    ap.add_argument("--cone-res", default="32,512,512",
                    help="fast2 cone-cache resolution hf,z,x")
    ap.add_argument("--ticked", action="store_true",
                    help="per-frame tile ticks (display mode) instead of "
                         "one batched cycle dispatch per output frame")
    ap.add_argument("--serve", action="store_true",
                    help="serving mode: the fused per-display-frame "
                         "render_frame loop (tile tick + composite) — the "
                         "path bench.py's per_tile_ms times; writes every "
                         "(frames_to_update)-th display frame")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    if args.tile_cull is None:
        args.tile_cull = args.kernel in ("fast2", "fast3")
    return args


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    os.makedirs(args.out, exist_ok=True)
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")

    timer = StageTimer()
    with timer.stage("engine_init"):
        engine = CloudSkyEngine(
            perf=PerfConfig(texture_size=args.size,
                            frames_to_update=args.frames_to_update,
                            march_steps=args.steps),
            config=CloudConfig(cloud_coverage=args.coverage,
                               wind_speed=args.wind_speed, sun_disk_scale=2.0,
                               ground_color=(0.270588, 0.188235, 0.027451, 1.0)),
            kernel=args.kernel,
            cone_res=tuple(int(v) for v in args.cone_res.split(",")),
            tile_cull=args.tile_cull,
            device=device,
        )
        timer.fence(engine.transmittance)

    eyedirs = torch.tensor(camera_rays(args.width, args.height),
                           dtype=torch.float32, device=device)

    if args.serve:
        # Serving mode: one fused render_frame per display tick, the path
        # bench.py's per_tile_ms times. The sun sweeps across the whole run;
        # every frames_to_update-th display frame is written.
        total_ticks = args.frames * args.frames_to_update
        sim_t = 0.0
        for tick in range(total_ticks):
            elevation = np.pi * (0.12 + 0.55 * tick / max(total_ticks - 1, 1))
            sun = np.array([np.cos(elevation), np.sin(elevation), -0.35])
            sun /= np.linalg.norm(sun)
            engine.set_sun(tuple(sun), energy=1.0)
            sim_t += 1.0 / 60.0
            with timer.stage("render_frame",
                             rays=tile_rays_serve(engine, args)):
                img = engine.render_frame(eyedirs, now=sim_t)
                timer.fence(img)
            if tick % args.frames_to_update == args.frames_to_update - 1:
                frame = tick // args.frames_to_update
                path = os.path.join(args.out, f"frame_{frame:03d}.png")
                write_png(path, tonemap_aces(img.cpu().numpy() * 2.0))
                print(f"tick {tick}: sun {np.degrees(elevation):5.1f}°  → {path}")
        print("\n--- timings ---")
        print(timer.report())
        return

    # Dawn → dusk sweep; ticks per output frame = one full amortized cycle so
    # the sun motion stays below the blend window (README.md:22 of the
    # reference: "sun has to move slowly").
    ticks_per_frame = args.frames_to_update
    tile_rays = engine.perf.update_region_size ** 2
    sim_t = 0.0
    for frame in range(args.frames):
        elevation = np.pi * (0.12 + 0.55 * frame / max(args.frames - 1, 1))
        sun = np.array([np.cos(elevation), np.sin(elevation), -0.35])
        sun /= np.linalg.norm(sun)
        engine.set_sun(tuple(sun), energy=1.0)

        with timer.stage("update", rays=tile_rays * ticks_per_frame):
            if args.ticked:
                for _ in range(ticks_per_frame):
                    sim_t += 1.0 / 60.0
                    engine.update_sky(now=sim_t)
            else:
                sim_t += ticks_per_frame / 60.0
                engine.update_cycle(now=sim_t)
            timer.fence(engine.cloud_ring)

        with timer.stage("render_view", rays=args.width * args.height):
            img = engine.render_view(eyedirs)
            timer.fence(img)

        path = os.path.join(args.out, f"frame_{frame:03d}.png")
        write_png(path, tonemap_aces(img.cpu().numpy() * 2.0))
        print(f"frame {frame}: sun elevation {np.degrees(elevation):5.1f}°  → {path}")

    print("\n--- timings ---")
    print(timer.report())


if __name__ == "__main__":
    main()
