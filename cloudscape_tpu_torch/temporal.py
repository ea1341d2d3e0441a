"""Temporal amortization state: FrameData and the ring/cursor state.

The port of `cloudscape_tpu.temporal`. The hemisphere map is refreshed over
`frames_to_update` frames, one `update_region_size²` tile per frame swept
row-major (`cloud_sky.gd:156-162`), across three rotating textures — one
being updated, two being blended for display (`cloud_sky.gd:86-89,137-150`),
with `blend_amount = frame / frames_to_update` (`:152`). The sky LUT keeps its
own 3-slot ring, and the cloud kernel reads LUT slot `(current + 2) % 3`
(`cloud_sky.gd:242`). Kernel parameters are snapshotted once per cycle into a
`MarchParams` (FrameData semantics, `cloud_sky.gd:142`). Host-side state only.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from cloudscape_tpu_torch.config import CloudConfig, SunState
from cloudscape_tpu_torch.models.density import MarchParams
from cloudscape_tpu_torch.ops.math import srgb_to_linear


@dataclasses.dataclass
class FrameData:
    """Host-side mirror of the reference's FrameData (`cloud_sky.gd:56-79`):
    user params + integrated wind offsets + light snapshot, refreshed once per
    texture-swap cycle."""

    wind_direction: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 0.0]))
    wind_speed: float = 1.0
    density: float = 0.05
    cloud_coverage: float = 0.25
    time_offset: float = 0.0
    ground_color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 1.0, 1.0]))

    time: float = 0.0
    cloud_pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(2))
    detailed_pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(2))
    weather_pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(2))

    light_direction: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, -1.0, 0.0]))
    light_energy: float = 1.0
    light_color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 1.0, 1.0]))

    def update_config(self, config: CloudConfig) -> None:
        self.wind_direction = np.array(
            [np.cos(config.wind_direction), np.sin(config.wind_direction)])
        self.wind_speed = float(config.wind_speed)
        self.density = float(config.density)
        self.cloud_coverage = float(config.cloud_coverage)
        self.time_offset = float(config.time_offset)
        self.ground_color = np.asarray(config.ground_color[:3], dtype=np.float64)

    def update_light_data(self, sun: SunState, srgb_color: bool = False) -> None:
        """`cloud_sky.gd:76-79`: normalize direction; optionally convert an
        sRGB-specified color to linear as Godot does."""
        d = np.asarray(sun.direction, dtype=np.float64)
        self.light_direction = d / np.linalg.norm(d)
        self.light_energy = float(sun.energy)
        color = np.asarray(sun.color, dtype=np.float64)
        if srgb_color:
            color = srgb_to_linear(
                torch.as_tensor(color, dtype=torch.float32)).numpy().astype(np.float64)
        self.light_color = color

    def integrate_wind(self, now: float) -> None:
        """Wind integration (`cloud_sky.gd:175-185`): three scroll offsets
        advancing at different rates; `now` is wall-clock seconds."""
        delta = now - self.time
        delta2 = delta * 0.001 + 0.005 * self.time_offset
        w = self.wind_direction / np.linalg.norm(self.wind_direction)
        self.time = now
        self.detailed_pos = self.detailed_pos + delta * w
        self.cloud_pos = self.cloud_pos + delta * w * self.wind_speed
        self.weather_pos = self.weather_pos + delta2 * w * self.wind_speed

    def to_march_params(self, device="cuda") -> MarchParams:
        return MarchParams.create(
            cloud_pos=self.cloud_pos, detailed_pos=self.detailed_pos,
            weather_pos=self.weather_pos, time=self.time, density=self.density,
            cloud_coverage=self.cloud_coverage,
            light_direction=self.light_direction,
            light_energy=self.light_energy, light_color=self.light_color,
            ground_color=self.ground_color, device=device)


@dataclasses.dataclass
class RingState:
    """Rotation/cursor state of the amortized update (`cloud_sky.gd:82-97`)."""

    texture_to_update: int = 0
    texture_to_blend_from: int = 1
    texture_to_blend_to: int = 2
    update_position: Tuple[int, int] = (0, 0)
    frame: int = 0
    sky_lut_current: int = 0  # sky_lut.gd `current_texture`

    def rotate_cloud(self) -> None:
        """Cycle boundary (`cloud_sky.gd:137-150`)."""
        self.texture_to_update = (self.texture_to_update + 1) % 3
        self.texture_to_blend_from = (self.texture_to_blend_from + 1) % 3
        self.texture_to_blend_to = (self.texture_to_blend_to + 1) % 3
        self.frame = 0

    def reset(self) -> None:
        """Back to the first cycle's slots and cursor (a performance change
        tears the rings down); the sky-LUT slot is kept."""
        self.texture_to_update = 0
        self.texture_to_blend_from = 1
        self.texture_to_blend_to = 2
        self.update_position = (0, 0)
        self.frame = 0

    def advance_cursor(self, update_region_size: int, texture_size: int) -> None:
        """Row-major tile sweep (`cloud_sky.gd:156-162`)."""
        x, y = self.update_position
        x += update_region_size
        if x >= texture_size:
            x = 0
            y += update_region_size
        if y >= texture_size:
            x, y = 0, 0
        self.update_position = (x, y)
        self.frame += 1

    def advance_sky_lut(self) -> None:
        """`sky_lut.gd:143-146`: slot rotation after each LUT render."""
        self.sky_lut_current = (self.sky_lut_current + 1) % 3

    @property
    def sky_back_textures(self) -> Tuple[int, int]:
        """The two most recent completed LUT slots exposed for display blend
        (`sky_lut.gd:145-146`)."""
        return (self.sky_lut_current, (self.sky_lut_current + 1) % 3)

    @property
    def cloud_kernel_sky_slot(self) -> int:
        """LUT slot the cloud kernel samples (`cloud_sky.gd:242`)."""
        return (self.sky_lut_current + 2) % 3

    def blend_amount(self, frames_to_update: int) -> float:
        """`cloud_sky.gd:152`."""
        return self.frame / frames_to_update
