"""Hemispherical octahedral map encode/decode (torch).

The same transforms as `cloudscape_tpu.ops.octmap`: decode in the compute
kernel (`cloud_sky/clouds.glsl:239-256`), encode in the display shader
(`cloud_sky/clouds.gdshader:15-32`); the oct frame is z-up, world space is
y-up, bridged by a `.xzy` swizzle. `texel_directions` keeps the reference's
no-half-texel mapping (uv = texel index / texture_size).
"""

from __future__ import annotations

import torch

from cloudscape_tpu_torch.ops.math import normalize


def _oct_wrap(vx, vy):
    """Fold the lower hemisphere (`clouds.glsl:239-244`): (x, y) →
    ((1 - |y|)·sign(x), (1 - |x|)·sign(y))."""
    sx = torch.where(vx >= 0.0, 1.0, -1.0)
    sy = torch.where(vy >= 0.0, 1.0, -1.0)
    return (1.0 - torch.abs(vy)) * sx, (1.0 - torch.abs(vx)) * sy


def oct_to_vec3(e):
    """Decode square uv in [0,1]² to a unit direction, oct (z-up) frame
    (`clouds.glsl:248-256`). e: [..., 2] → [..., 3]."""
    nx = e[..., 0] - e[..., 1]
    ny = (e[..., 0] + e[..., 1]) - 1.0
    nz = 1.0 - torch.abs(nx) - torch.abs(ny)
    wx, wy = _oct_wrap(nx, ny)
    keep = nz >= 0.0
    n = torch.stack([torch.where(keep, nx, wx), torch.where(keep, ny, wy), nz],
                    dim=-1)
    return normalize(n)


def vec3_to_oct(e):
    """Encode a direction (oct z-up frame) to square uv in [0,1]²
    (`clouds.gdshader:22-32`). e: [..., 3] → [..., 2]."""
    s = torch.abs(e[..., 0]) + torch.abs(e[..., 1]) + torch.abs(e[..., 2])
    e = e / s[..., None]
    wx, wy = _oct_wrap(e[..., 0], e[..., 1])
    keep = e[..., 2] >= 0.0
    ex = torch.where(keep, e[..., 0], wx)
    ey = torch.where(keep, e[..., 1], wy)
    ny = ey * 0.5 + 0.5
    nx = ex * 0.5 + ny
    ny = ex * -0.5 + ny
    return torch.stack([nx, ny], dim=-1)


def uv_to_world_dir(uv):
    """uv [..., 2] → world-frame (y-up) unit direction (`clouds.glsl:262`:
    `oct_to_vec3(uv).xzy`)."""
    n = oct_to_vec3(uv)
    return n[..., [0, 2, 1]]


def world_dir_to_uv(d):
    """World-frame (y-up) direction → oct uv (`clouds.gdshader:109`:
    `vec3_to_oct(norm.xzy)`)."""
    return vec3_to_oct(d[..., [0, 2, 1]])


def texel_directions(texture_size: int, x0: int = 0, y0: int = 0,
                     width: int | None = None, height: int | None = None,
                     device="cuda"):
    """[height, width, 3] world directions of a texel rectangle of the
    hemisphere map (`clouds.glsl:258-262`: uv = (texel index + update
    position) / texture_size, no texel-center offset)."""
    width = texture_size if width is None else width
    height = texture_size if height is None else height
    xs = torch.arange(width, dtype=torch.float32, device=device) + float(x0)
    ys = torch.arange(height, dtype=torch.float32, device=device) + float(y0)
    u = (xs / texture_size)[None, :].expand(height, width)
    v = (ys / texture_size)[:, None].expand(height, width)
    return uv_to_world_dir(torch.stack([u, v], dim=-1))
