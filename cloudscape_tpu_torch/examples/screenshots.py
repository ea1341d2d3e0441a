"""Render the three golden scenes (the analogs of the reference's
screenshots/Clouds.png, Dusk.png, Sunset.png) through the full engine.

The PyTorch port of `examples/screenshots.py`:

    python -m cloudscape_tpu_torch.examples.screenshots --out cloud_screenshots

Runs on the card; `--cpu` runs on the CPU instead (slow at the default
sizes).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from cloudscape_tpu_torch import CloudConfig, PerfConfig, SunState
from cloudscape_tpu_torch.engine import CloudSkyEngine
from cloudscape_tpu_torch.examples.demo import camera_rays
from cloudscape_tpu_torch.utils.image import display_encode, write_png

SCENES = {
    # name: (sun elevation deg, sun azimuth deg, coverage)
    # Display chain = the reference scene's Environment (ACES white 3.53 +
    # sRGB OETF, utils/image.display_encode) — NO per-scene exposure.
    "clouds": (38.0, -25.0, 0.45),
    "dusk": (4.0, -95.0, 0.40),
    "sunset": (11.0, -60.0, 0.50),
}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="cloud_screenshots")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--steps", type=int, default=96)
    ap.add_argument("--width", type=int, default=768)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    os.makedirs(args.out, exist_ok=True)

    for name, (elev, azim, coverage) in SCENES.items():
        e, a = np.radians(elev), np.radians(azim)
        # Face the sun azimuth (low-sun scenes want the warm horizon in frame).
        eyedirs = torch.tensor(
            camera_rays(args.width, args.height, yaw=-a, pitch=0.22, fov=1.25),
            dtype=torch.float32, device=device)
        sun = np.array(
            [np.cos(e) * np.sin(a), np.sin(e), -np.cos(e) * np.cos(a)]
        )
        engine = CloudSkyEngine(
            perf=PerfConfig(texture_size=args.size, frames_to_update=16,
                            march_steps=args.steps),
            config=CloudConfig(cloud_coverage=coverage, sun_disk_scale=2.0,
                               ground_color=(0.270588, 0.188235, 0.027451, 1.0)),
            sun=SunState(direction=tuple(sun)),
            device=device,
        )
        engine.update_cycle(now=0.0)
        img = engine.render_view(eyedirs, deband=True).cpu().numpy()
        path = os.path.join(args.out, f"{name}.png")
        write_png(path, display_encode(img))
        print(f"{name}: sun elev {elev}° → {path}")


if __name__ == "__main__":
    main()
