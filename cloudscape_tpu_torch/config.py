"""Configuration dataclasses for the cloudscape engine (PyTorch port).

The same parameter surface as `cloudscape_tpu.config`: user-facing cloud and
sun parameters (`CloudConfig`, `SunState`), shape-affecting performance
settings (`PerfConfig`) with the reference's texture-size auto-correction,
and the cloud-shell geometry constants. Plain frozen dataclasses; nothing
here touches a tensor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

# Allowed amortization levels, mirroring the reference enum
# "Very Fast(4) / Fast(16) / Default(64) / Performance(256)"
# (`cloud_sky/cloud_sky.gd:36`).
FRAMES_TO_UPDATE_CHOICES = (4, 16, 64, 256)


@dataclasses.dataclass(frozen=True)
class CloudConfig:
    """Dynamic, user-tweakable cloud parameters.

    Defaults follow the script defaults of `cloud_sky/cloud_sky.gd:5-33`;
    `CloudConfig.demo_scene()` gives the shipped scene's overrides.
    """

    # Wind direction in radians; 0 = wind from +X (`cloud_sky.gd:7-10`).
    wind_direction: float = 0.0
    # Wind speed in m/s, nominally 0..120 (`cloud_sky.gd:12-17`).
    wind_speed: float = 1.0
    # Extinction scale (`cloud_sky.gd:19-20`).
    density: float = 0.05
    # Multiplies the weather-map coverage channel (`cloud_sky.gd:21-22`).
    cloud_coverage: float = 0.25
    # Extra weather scroll rate (`cloud_sky.gd:23-24`).
    time_offset: float = 0.0
    # Forwarded to the composite stage (`cloud_sky.gd:27-31`).
    sun_disk_scale: float = 1.0
    # Tints the cloud-bottom ambient term (`clouds.glsl:167`). RGBA, linear.
    ground_color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)

    @staticmethod
    def demo_scene() -> "CloudConfig":
        """The shipped demo-scene values (`cloud_sky/clouds_sky.tres:11-17`)."""
        return CloudConfig(
            cloud_coverage=0.2,
            sun_disk_scale=2.0,
            ground_color=(0.270588, 0.188235, 0.027451, 1.0),
        )


@dataclasses.dataclass(frozen=True)
class SunState:
    """Directional-light state (`cloud_sky.gd:76-79`): unit vector toward the
    sun (world frame, y-up), energy, and linear RGB color."""

    direction: Tuple[float, float, float] = (0.0, -1.0, 0.0)
    energy: float = 1.0
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)


@dataclasses.dataclass(frozen=True)
class PerfConfig:
    """Shape settings: texture size, amortization, march step counts."""

    # Hemisphere octahedral map edge length (`cloud_sky.gd:44-45`). Must
    # divide by sqrt(frames_to_update); `validate()` applies the reference's
    # auto-correction rule.
    texture_size: int = 768
    # Full map refreshed over this many frames (`cloud_sky.gd:35-42`).
    frames_to_update: int = 64
    # Primary march steps (`clouds.glsl:228-229`).
    march_steps: int = 128
    # Secondary (sun) cone samples (`clouds.glsl:186`), plus one distant
    # sample (`clouds.glsl:195`).
    light_steps: int = 6

    def validate(self) -> "PerfConfig":
        """Apply the reference's derived-config invariants: `texture_size`
        is clamped to a multiple of sqrt(frames_to_update)
        (`cloud_sky.gd:110-115`); an invalid frames_to_update raises."""
        if self.frames_to_update not in FRAMES_TO_UPDATE_CHOICES:
            raise ValueError(
                f"frames_to_update must be one of {FRAMES_TO_UPDATE_CHOICES}, "
                f"got {self.frames_to_update}"
            )
        frames_sqrt = int(math.isqrt(self.frames_to_update))
        if self.texture_size < frames_sqrt:
            raise ValueError(
                f"texture_size must be >= sqrt(frames_to_update) "
                f"({frames_sqrt}), got {self.texture_size}"
            )
        size = self.texture_size
        if size % frames_sqrt != 0:
            corrected = (size // frames_sqrt) * frames_sqrt
            return dataclasses.replace(self, texture_size=corrected)
        return self

    @property
    def update_region_size(self) -> int:
        """Edge of the square tile updated each frame (`cloud_sky.gd:110-111`)."""
        return self.texture_size // int(math.isqrt(self.frames_to_update))


# Geometry constants of the cloud shell (`clouds.glsl:42-45`), in meters.
GROUND_RADIUS = 6_000_000.0
SKY_B_RADIUS = 6_001_500.0  # bottom of cloud layer
SKY_T_RADIUS = 6_004_000.0  # top of cloud layer
