"""Float32 transcriptions of the reference's GLSL math helpers.

The same functions as `cloudscape_tpu.ops.math`, on torch tensors:

- remap                     `cloud_sky/clouds.glsl:67-69`
- smoothstep (GLSL)         GLSL built-in semantics
- hash_iq                   `cloud_sky/clouds.glsl:60-64` (iq's 3D hash)
- henyey_greenstein         `cloud_sky/clouds.glsl:72-75`
- height_fraction           `cloud_sky/clouds.glsl:77-80`
- mix_gradients             `cloud_sky/clouds.glsl:82-90`
- density_height_gradient   `cloud_sky/clouds.glsl:92-95`
- intersect_sphere_far      `cloud_sky/clouds.glsl:97-105`
- ray_sphere_first          `cloud_sky/sky-lut.glsl:100-109`
- srgb_to_linear            Godot Color.srgb_to_linear (`cloud_sky/cloud_sky.gd:79`)

Vectors live in a trailing axis of size 3. Three-term dot products are
written out left to right ((x + y) + z), the order the JAX package's
size-3 reductions take, so that values that feed thresholds (the march's
start jitter, `hash_iq(start * 10)` at ~6e7) round the same way.
"""

from __future__ import annotations

import torch

# k = 1/(4*pi) as spelled in the reference (`clouds.glsl:73`).
_HG_K = 0.0795774715459

# The cloud kernel's truncated PI (`clouds.glsl:47`); the sky-LUT kernel
# spells it in full (`sky-lut.glsl:44`).
PI_CLOUDS = 3.141592
PI = 3.14159265358979323846


def dot3(a, b):
    """Sum over the trailing size-3 axis of a * b, left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def norm3(v):
    """Euclidean length over the trailing size-3 axis."""
    return torch.sqrt(dot3(v, v))


def remap(value, original_min, original_max, new_min, new_max):
    """Linear range remap, unclamped (`clouds.glsl:67-69`)."""
    return new_min + (
        (value - original_min) / (original_max - original_min) * (new_max - new_min)
    )


def smoothstep(edge0, edge1, x):
    """GLSL smoothstep: clamped Hermite interpolation."""
    t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def fract(x):
    """GLSL fract(x) = x - floor(x)."""
    return x - torch.floor(x)


def hash_iq(p):
    """iq's 3D→1D hash (`clouds.glsl:60-64`): p is [..., 3], returns [...]."""
    p = fract(p * 0.3183099 + 0.1)
    p = p * 17.0
    return fract(p[..., 0] * p[..., 1] * p[..., 2]
                 * (p[..., 0] + p[..., 1] + p[..., 2]))


def henyey_greenstein(cos_theta, g):
    """HG phase with k = 1/4π (`clouds.glsl:72-75`)."""
    gg = g * g
    return _HG_K * (1.0 - gg) / torch.pow(1.0 + gg - 2.0 * g * cos_theta, 1.5)


def height_fraction(radial_distance, bottom_radius, top_radius):
    """Fraction of height within the cloud shell, clamped (`clouds.glsl:77-80`)."""
    h = (radial_distance - bottom_radius) / (top_radius - bottom_radius)
    return torch.clamp(h, 0.0, 1.0)


# Cloud-type vertical profiles (`clouds.glsl:83-85`).
_STRATUS_GRADIENT = (0.02, 0.05, 0.09, 0.11)
_STRATOCUMULUS_GRADIENT = (0.02, 0.2, 0.48, 0.625)
_CUMULUS_GRADIENT = (0.01, 0.0625, 0.78, 1.0)


def mix_gradients(cloud_type):
    """Blend the three cloud-type gradients by weather.r
    (`clouds.glsl:82-90`). cloud_type: [...] → list of four [...] tensors."""
    stratus = 1.0 - torch.clamp(cloud_type * 2.0, 0.0, 1.0)
    stratocumulus = 1.0 - torch.abs(cloud_type - 0.5) * 2.0
    cumulus = torch.clamp(cloud_type - 0.5, 0.0, 1.0) * 2.0
    return [
        stratus * s + stratocumulus * sc + cumulus * cu
        for s, sc, cu in zip(_STRATUS_GRADIENT, _STRATOCUMULUS_GRADIENT,
                             _CUMULUS_GRADIENT)
    ]


def density_height_gradient(height_frac, cloud_type):
    """Vertical density envelope (`clouds.glsl:92-95`)."""
    g = mix_gradients(cloud_type)
    return smoothstep(g[0], g[1], height_frac) - smoothstep(g[2], g[3], height_frac)


def intersect_sphere_far(pos, dir, radius):
    """Far-root ray/sphere solver (`clouds.glsl:97-105`); NaN on miss.
    pos, dir: [..., 3]; radius scalar."""
    a = dot3(dir, dir)
    b = 2.0 * dot3(dir, pos)
    c = dot3(pos, pos) - radius * radius
    d = torch.sqrt(b * b - 4.0 * a * c)
    return torch.maximum(-b - d, -b + d) / (2.0 * a)


def ray_sphere_first(ro, rd, radius):
    """First-hit ray/sphere with -1.0 miss sentinel (`sky-lut.glsl:100-109`).
    ro, rd: [..., 3]; radius scalar; rd normalized."""
    b = dot3(ro, rd)
    c = dot3(ro, ro) - radius * radius
    d = b * b - c
    sqrt_d = torch.sqrt(torch.clamp(d, min=0.0))
    inside_far = -b + sqrt_d
    outside_near = -b - sqrt_d
    hit = torch.where(d > b * b, inside_far, outside_near)
    miss = ((c > 0.0) & (b > 0.0)) | (d < 0.0)
    return torch.where(miss, torch.full_like(hit, -1.0), hit)


def srgb_to_linear(c):
    """Godot's Color.srgb_to_linear, per channel (`cloud_sky.gd:79`). c: a
    tensor or anything `torch.as_tensor` takes; computed in its float dtype,
    or in float32 for an integer or bool input."""
    c = torch.as_tensor(c)
    if not c.is_floating_point():
        c = c.to(torch.float32)
    return torch.where(c <= 0.04045, c / 12.92, torch.pow((c + 0.055) / 1.055, 2.4))


def normalize(v, axis: int = -1):
    """GLSL normalize along `axis`, its squares summed left to right (over
    the trailing size-3 axis, exactly `v / norm3(v)`)."""
    parts = v.unbind(axis)
    sq = parts[0] * parts[0]
    for p in parts[1:]:
        sq = sq + p * p
    return v / torch.sqrt(sq).unsqueeze(axis)
