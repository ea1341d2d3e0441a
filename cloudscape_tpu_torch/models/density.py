"""Noise inputs and per-cycle march parameters (torch).

`NoisePack` holds the three noise textures with their mip chains, and
`MarchParams` the per-cycle kernel inputs — the analog of the reference's
push-constant block (`clouds.glsl:18-40` / `cloud_sky.gd:251-289`),
snapshotted once per texture swap. Both mirror `cloudscape_tpu.models.density`;
the density math itself runs on the brick tables in `models/march_fast.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NoisePack:
    """Noise volumes with full mip chains, level 0 first.

    - large: Perlin-Worley base, [D, H, W, 4] RGBA levels.
    - small: Worley detail, [D, H, W, 3] RGB levels.
    - weather: [H, W, 3], mipless (R = cloud type, B = coverage).
    """

    large: Tuple[torch.Tensor, ...]
    small: Tuple[torch.Tensor, ...]
    weather: torch.Tensor


_PARAM_FIELDS = ("cloud_pos", "detailed_pos", "weather_pos", "time", "density",
                 "cloud_coverage", "light_direction", "light_energy",
                 "light_color", "ground_color")


@dataclasses.dataclass(frozen=True)
class MarchParams:
    """Per-cycle kernel inputs, each a float32 tensor on the engine's device."""

    cloud_pos: torch.Tensor  # [2] base wind integral
    detailed_pos: torch.Tensor  # [2] detail wind integral
    weather_pos: torch.Tensor  # [2] weather advection integral
    time: torch.Tensor  # scalar, seconds
    density: torch.Tensor  # scalar extinction scale
    cloud_coverage: torch.Tensor  # scalar
    light_direction: torch.Tensor  # [3] toward the sun, world y-up
    light_energy: torch.Tensor  # scalar
    light_color: torch.Tensor  # [3] linear RGB
    ground_color: torch.Tensor  # [3] linear RGB

    @staticmethod
    def create(cloud_pos=(0.0, 0.0), detailed_pos=(0.0, 0.0),
               weather_pos=(0.0, 0.0), time=0.0, density=0.05,
               cloud_coverage=0.25, light_direction=(0.0, 0.5, -1.0),
               light_energy=1.0, light_color=(1.0, 1.0, 1.0),
               ground_color=(1.0, 1.0, 1.0), device="cuda") -> "MarchParams":
        """Values are rounded to float32 on the host (as `jnp.asarray(v,
        float32)` does), then placed on `device`."""
        def f(v):
            return torch.from_numpy(np.asarray(v, np.float32).copy()).to(device)

        return MarchParams(
            cloud_pos=f(cloud_pos), detailed_pos=f(detailed_pos),
            weather_pos=f(weather_pos), time=f(time), density=f(density),
            cloud_coverage=f(cloud_coverage), light_direction=f(light_direction),
            light_energy=f(light_energy), light_color=f(light_color),
            ground_color=f(ground_color),
        )

    @staticmethod
    def from_numpy(values: dict, device="cuda") -> "MarchParams":
        """Build from a dict of the JAX `MarchParams` fields as numpy arrays
        or plain numbers (e.g. `{k: np.asarray(getattr(p, k)) ...}`)."""
        return MarchParams.create(**{k: values[k] for k in _PARAM_FIELDS},
                                  device=device)
