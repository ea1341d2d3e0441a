"""Shared cloud-march constants and the per-dispatch LUT colors (torch).

The part of `cloudscape_tpu.models.march` that the dense serving march uses:
the six cone-sampling offsets (`clouds.glsl:140`), the sky-LUT lookup
(`clouds.glsl:49-57`) and the three LUT-derived colors hoisted out of the
march (`clouds.glsl:162-167`). The scan-based reference march is not ported
yet (ROADMAP A5).
"""

from __future__ import annotations

import torch

from cloudscape_tpu_torch.ops import math as m
from cloudscape_tpu_torch.ops.sampling import sample2d

# The 6 hard-coded cone-sampling offsets (`clouds.glsl:140`).
RANDOM_VECTORS = (
    (0.38051305, 0.92453449, -0.02111345),
    (-0.50625799, -0.03590792, -0.86163418),
    (-0.32509218, -0.94557439, 0.01428793),
    (0.09026238, -0.27376545, 0.95755165),
    (0.28128598, 0.42443639, -0.86065785),
    (-0.16852403, 0.14748697, 0.97460106),
)

_PI_C = m.PI_CLOUDS


def sky_lut_lookup(sky_lut_img, ray_dir):
    """`clouds.glsl:49-57`: equirect decode with sqrt-warped elevation,
    clamp-to-edge bilinear. ray_dir [..., 3] world (y-up) → [..., 3]."""
    phi = torch.atan2(ray_dir[..., 2], ray_dir[..., 0])
    theta = torch.asin(torch.clamp(ray_dir[..., 1], -1.0, 1.0))
    u = phi / _PI_C * 0.5 + 0.5
    v = torch.sqrt(torch.abs(theta) / (_PI_C * 0.5)) * torch.sign(theta) * 0.5 + 0.5
    uv = torch.stack(torch.broadcast_tensors(u, v), dim=-1)
    return sample2d(sky_lut_img, uv, wrap="clamp")[..., :3]


def ambient_colors(params, sky_lut_img):
    """The three per-dispatch LUT-derived colors (`clouds.glsl:162-167`),
    constant across rays: (sun, ambient, ground), each [3]."""
    dev = sky_lut_img.device
    sqrt_half = float(torch.tensor(1.0) / torch.sqrt(torch.tensor(2.0)))
    atmosphere_sun = (sky_lut_lookup(sky_lut_img, params.light_direction)
                      * 0.1 * params.light_energy * params.light_color)
    amb = sky_lut_lookup(sky_lut_img, torch.tensor(
        [sqrt_half, sqrt_half, 0.0], dtype=torch.float32, device=dev)) * 0.05
    atmosphere_ambient = 0.5 * (amb + m.norm3(amb))
    gnd = sky_lut_lookup(sky_lut_img, torch.tensor(
        [sqrt_half, -sqrt_half, 0.0], dtype=torch.float32, device=dev)) * 5.0 * 0.05
    atmosphere_ground = 0.5 * (gnd + params.ground_color * m.norm3(gnd))
    return atmosphere_sun, atmosphere_ambient, atmosphere_ground
