"""The hemisphere map's texel directions (`clouds.glsl:239-262`) and the
display composite (`clouds.gdshader:22-116`) in plain tensor operations."""

from __future__ import annotations

import math

import torch

from skybench.reference.atmosphere import ray_sphere
from skybench.reference.sampling import sample2d

GROUND_RADIUS_MM = 6.360
ATMOSPHERE_RADIUS_MM = 6.460
TLUT_RES = (256.0, 64.0)


def _fold(x, y):
    """(1 − |y|)·sign(x), (1 − |x|)·sign(y)."""
    one = torch.ones_like(x)
    sx = torch.where(x >= 0.0, one, -one)
    sy = torch.where(y >= 0.0, one, -one)
    return (1.0 - torch.abs(y)) * sx, (1.0 - torch.abs(x)) * sy


def map_directions(size: int, *, dtype=torch.float64, device="cpu"):
    """[size, size, 3] world (y-up) directions of the hemisphere map's
    texels: uv = texel index / size (no half texel), decoded from the
    octahedral square and swizzled .xzy."""
    i = torch.arange(size, dtype=dtype, device=device) / size
    u, v = torch.broadcast_tensors(i[None, :], i[:, None])
    nx = u - v
    ny = (u + v) - 1.0
    nz = 1.0 - torch.abs(nx) - torch.abs(ny)
    fx, fy = _fold(nx, ny)
    keep = nz >= 0.0
    n = torch.stack([torch.where(keep, nx, fx), torch.where(keep, ny, fy), nz], dim=-1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return n[..., [0, 2, 1]]


def _oct_uv(e):
    """`clouds.gdshader:22-32`: a direction in the oct (z-up) frame → uv."""
    e = e / torch.abs(e).sum(-1, keepdim=True)
    fx, fy = _fold(e[..., 0], e[..., 1])
    keep = e[..., 2] >= 0.0
    ex = torch.where(keep, e[..., 0], fx)
    ey = torch.where(keep, e[..., 1], fy)
    ny = ey * 0.5 + 0.5
    return torch.stack([ex * 0.5 + ny, ex * -0.5 + ny], dim=-1)


def _smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def composite(eye, cloud_from, cloud_to, sky_from, sky_to, tlut, blend: float,
              sun_disk_scale: float, sun):
    """[..., 3] displayed colour of world view directions eye [..., 3]: the
    two cloud maps and the two sky-view LUTs blended by `blend`, the sun
    disk with its bloom through the transmittance LUT, the horizon fade.
    Computed in eye's dtype."""
    dtype, dev = eye.dtype, eye.device
    sun = torch.as_tensor(sun, dtype=dtype, device=dev)
    up = torch.stack([eye[..., 0], torch.clamp(eye[..., 1], min=0.0), eye[..., 2]], -1)
    n_len = torch.linalg.vector_norm(up, dim=-1, keepdim=True)
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=dev)
    up = torch.where(n_len > 0.0, up / torch.clamp(n_len, min=1e-300), x_axis)
    uv = _oct_uv(up[..., [0, 2, 1]])
    c0 = sample2d(cloud_from.to(dtype), uv, wrap="clamp")
    c1 = sample2d(cloud_to.to(dtype), uv, wrap="clamp")
    clouds = c0 + (c1 - c0) * blend

    phi = torch.atan2(eye[..., 2], eye[..., 0])
    theta = torch.asin(torch.clamp(eye[..., 1], -1.0, 1.0))
    suv = torch.stack([phi / math.pi * 0.5 + 0.5,
                       torch.sqrt(torch.abs(theta) / (math.pi * 0.5))
                       * torch.sign(theta) * 0.5 + 0.5], dim=-1)
    s0 = sample2d(sky_from.to(dtype), suv, wrap="clamp")[..., :3]
    s1 = sample2d(sky_to.to(dtype), suv, wrap="clamp")[..., :3]
    col = (s0 + (s1 - s0) * blend) / 50.0

    min_cos = math.cos(sun_disk_scale * 0.53 * math.pi / 180.0)
    cos_t = (eye * sun).sum(-1)
    off = torch.clamp(min_cos - cos_t, min=0.0)
    bloom = torch.exp(-off * 50000.0) * 0.5 + 1.0 / (0.02 + off * 300.0) * 0.01
    sun_lum = torch.where(cos_t >= min_cos, torch.ones_like(bloom), bloom)
    sun_lum = _smoothstep(0.002, 1.0, sun_lum)[..., None].expand(eye.shape)
    view = torch.tensor([0.0, GROUND_RADIUS_MM + 0.0002, 0.0], dtype=dtype, device=dev)
    hits_ground = ray_sphere(view.expand_as(eye), eye, GROUND_RADIUS_MM) >= 0.0
    height = torch.linalg.vector_norm(view)
    cos_z = ((view / height) * sun).sum()
    tuv = torch.stack([
        TLUT_RES[0] * torch.clamp(0.5 + 0.5 * cos_z, 0.0, 1.0) / TLUT_RES[0],
        TLUT_RES[1] * torch.clamp((height - GROUND_RADIUS_MM)
                                  / (ATMOSPHERE_RADIUS_MM - GROUND_RADIUS_MM), 0.0, 1.0)
        / TLUT_RES[1]])
    tl = sample2d(tlut.to(dtype), tuv, wrap="clamp")[..., :3]
    lit = torch.where(hits_ground[..., None], torch.zeros_like(sun_lum), sun_lum * tl)
    sun_lum = torch.where((torch.linalg.vector_norm(sun_lum, dim=-1) > 0.0)[..., None],
                          lit, sun_lum)
    background = col + sun_lum

    color = background * (1.0 - clouds[..., 3:4]) + clouds[..., :3]
    fade = _smoothstep(0.6, 1.0, 1.0 - eye[..., 1])[..., None]
    c = torch.clamp(color, 0.0, 100.0)
    return c + (torch.clamp(background, 0.0, 100.0) - c) * fade
