"""Schneider-style cloud density on mip pyramids (torch).

The port of `cloudscape_tpu.models.density`: `NoisePack` holds the three
noise textures with their mip chains, and `MarchParams` the per-cycle
kernel inputs — the analog of the reference's push-constant block
(`clouds.glsl:18-40` / `cloud_sky.gd:251-289`), snapshotted once per
texture swap. `sample_weather` and `density_at` are the density model
(`clouds.glsl:107-137`) on the pyramids, as the scan-based reference march
(`models/march.py`) samples it; the brick marches re-derive it on brick
tables in `models/march_fast.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from cloudscape_tpu_torch.config import SKY_B_RADIUS, SKY_T_RADIUS
from cloudscape_tpu_torch.ops import math as m
from cloudscape_tpu_torch.ops.sampling import sample2d, sample3d_lod


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


def sample_weather(noise: NoisePack, pxz, weather_pos):
    """Weather fetch (`clouds.glsl:169-174`): repeat-wrap bilinear at
    p.xz * 6e-5 + 0.5 + weather_pos. pxz: [..., 2] → [..., 3]."""
    uv = pxz * 0.00006 + 0.5 + weather_pos
    return sample2d(noise.weather, uv, wrap="repeat")


def density_at(p, weather, mip: float, params: MarchParams, noise: NoisePack):
    """Cloud density at world points p [..., 3] (`clouds.glsl:109-137`).

    weather: [..., 3] pre-fetched weather sample; mip: static lod (large
    noise at mip - 2, small at mip). Returns (density, height fraction)."""
    hf = m.height_fraction(m.norm3(p), SKY_B_RADIUS, SKY_T_RADIUS)

    # Base wind offset (`clouds.glsl:114`).
    offset = 20.0 * params.cloud_pos * 0.6
    p_base = torch.stack([p[..., 0] + offset[0], p[..., 1], p[..., 2] + offset[1]],
                         dim=-1)

    n = sample3d_lod(noise.large, p_base * 0.00008, mip - 2.0, wrap="repeat")
    fbm = n[..., 1] * 0.625 + n[..., 2] * 0.25 + n[..., 3] * 0.125

    g = m.density_height_gradient(hf, weather[..., 0])
    base_cloud = m.remap(n[..., 0], -(1.0 - fbm), 1.0, 0.0, 1.0)
    weather_coverage = params.cloud_coverage * weather[..., 2]
    # The GLSL remap divides by weather_coverage (`clouds.glsl:124`), which is
    # 0 where the weather map has no coverage; the GPU's NaN-absorbing
    # min/max clamps recover 0 there, so guard the denominator (the final
    # `* weather_coverage` then zeroes the texel identically).
    base_cloud = (base_cloud * g - (1.0 - weather_coverage)) / torch.clamp(
        weather_coverage, min=1e-6)
    base_cloud = base_cloud * weather_coverage

    # Detail wind + animated vertical drift (`clouds.glsl:128-129`).
    p_det = torch.stack([p_base[..., 0] - params.detailed_pos[0] * 40.0,
                         p_base[..., 1] - params.time * 40.0,
                         p_base[..., 2] - params.detailed_pos[1] * 40.0], dim=-1)
    hn = sample3d_lod(noise.small, p_det * 0.001, mip, wrap="repeat")
    hfbm = hn[..., 0] * 0.625 + hn[..., 1] * 0.25 + hn[..., 2] * 0.125
    hfbm = hfbm + (1.0 - 2.0 * hfbm) * torch.clamp(hf * 4.0, 0.0, 1.0)
    base_cloud = m.remap(base_cloud, hfbm * 0.4 * hf, 1.0, 0.0, 1.0)
    return torch.pow(torch.clamp(base_cloud, 0.0, 1.0), (1.0 - hf) * 0.8 + 0.5), hf
