"""Display composite stage (torch port of `cloudscape_tpu.models.compositor`).

The equivalent of `cloud_sky/clouds.gdshader`: octahedral-decodes the two
cloud blend buffers, blends the two sky-LUT backbuffers, draws the sun disk
with bloom attenuated by the transmittance LUT, and applies the horizon fade
(`clouds.gdshader:104-116`). View directions and the sun direction are
explicit inputs in place of Godot's `EYEDIR` / `LIGHT0_DIRECTION`.

Two entry points: `composite` (the split path: two bilinear fetches per
texture per pixel from the raw ring slots) and `composite_display` (the
fused serving tick: one fetch per texture per pixel from the cycle's
8-channel display-pair textures; over the engine's form, kernel K12 of
`ops/composite_kernel.py` on the card).
"""

from __future__ import annotations

import math

import torch

from cloudscape_tpu_torch.ops import composite_kernel
from cloudscape_tpu_torch.ops import math as m
from cloudscape_tpu_torch.ops.brick import (BrickTable2D, Texture2D, sample_brick2,
                                            sample_tex2)
from cloudscape_tpu_torch.ops.octmap import world_dir_to_uv
from cloudscape_tpu_torch.ops.sampling import sample2d

# Megameter-unit geometry of the composite shader (`clouds.gdshader:72-75`).
GROUND_RADIUS_MM = 6.360
ATMOSPHERE_RADIUS_MM = 6.460
VIEW_POS_MM = (0.0, GROUND_RADIUS_MM + 0.0002, 0.0)

_PI = math.pi  # Godot's shader PI built-in (full precision)


def _fetch_clamp(tex, uv):
    """Clamp-wrap bilinear fetch from a raw [H, W, C] image, a Texture2D
    (kernel K8 on the card) or a BrickTable2D (one brick row per fetch)."""
    if isinstance(tex, Texture2D):
        return sample_tex2(tex, uv)
    if isinstance(tex, BrickTable2D):
        return sample_brick2(tex, uv)
    return sample2d(tex, uv, wrap="clamp")


def _is_pair(tex) -> bool:
    return isinstance(tex, (Texture2D, BrickTable2D)) and tex.channels == 8


def _uv_equirect(ray_dir):
    phi = torch.atan2(ray_dir[..., 2], ray_dir[..., 0])
    theta = torch.asin(torch.clamp(ray_dir[..., 1], -1.0, 1.0))
    u = phi / _PI * 0.5 + 0.5
    v = torch.sqrt(torch.abs(theta) / (_PI * 0.5)) * torch.sign(theta) * 0.5 + 0.5
    return torch.stack(torch.broadcast_tensors(u, v), dim=-1)


def sky_lut_blend(sky_from, sky_to, ray_dir, blend_amount):
    """`clouds.gdshader:34-45`: blended equirect lookup with the /50 exposure
    normalization. sky_to=None reads either one pre-blended LUT or an
    8-channel pair table (from rgba ‖ to rgba in one row; fetched once,
    then lerped as the split path does). The engine reaches the pair and
    the two-LUT forms; the pre-blended one is kept for parity with the
    JAX function, which the tests hold it against."""
    uv = _uv_equirect(ray_dir)
    if sky_to is None and _is_pair(sky_from):
        r = _fetch_clamp(sky_from, uv)
        a = r[..., 0:3]
        return (a + (r[..., 4:7] - a) * blend_amount) / 50.0
    a = _fetch_clamp(sky_from, uv)[..., :3]
    if sky_to is None:
        return a / 50.0
    b = _fetch_clamp(sky_to, uv)[..., :3]
    return (a + (b - a) * blend_amount) / 50.0


def sun_with_bloom(ray_dir, sun_dir, sun_disk_scale):
    """Solid sun disk + gaussian/inverse bloom (`clouds.gdshader:47-59`)."""
    scale = torch.as_tensor(sun_disk_scale, dtype=torch.float32,
                            device=ray_dir.device)
    min_cos = torch.cos(scale * (0.53 * _PI / 180.0))
    cos_theta = m.dot3(ray_dir, sun_dir)
    offset = torch.clamp(min_cos - cos_theta, min=0.0)
    gaussian = torch.exp(-offset * 50000.0) * 0.5
    inv = 1.0 / (0.02 + offset * 300.0) * 0.01
    lum = torch.where(cos_theta >= min_cos, 1.0, gaussian + inv)
    return lum[..., None].expand(lum.shape + (3,))


def transmittance_lookup(tlut, pos_mm, sun_dir):
    """`clouds.gdshader:77-85` in megameter units; tlut is a raw image, a
    Texture2D or a BrickTable2D."""
    height = m.norm3(pos_mm)
    up = pos_mm / height[..., None]
    sun_cos_zenith = m.dot3(up, sun_dir)
    u = torch.clamp(0.5 + 0.5 * sun_cos_zenith, 0.0, 1.0)
    v = torch.clamp((height - GROUND_RADIUS_MM)
                    / (ATMOSPHERE_RADIUS_MM - GROUND_RADIUS_MM), 0.0, 1.0)
    uv = torch.stack(torch.broadcast_tensors(u, v), dim=-1)
    return _fetch_clamp(tlut, uv)[..., :3]


def get_atmo(eyedir, sky_from, sky_to, tlut, blend_amount, sun_dir,
             sun_disk_scale):
    """Background atmosphere + sun (`clouds.gdshader:87-102`). The view
    position is a constant, so the shader's per-pixel transmittance fetch
    (`clouds.gdshader:95`) is one fetch, broadcast. sky_to=None: see
    `sky_lut_blend`."""
    col = sky_lut_blend(sky_from, sky_to, eyedir, blend_amount)
    sun_lum = m.smoothstep(0.002, 1.0, sun_with_bloom(eyedir, sun_dir,
                                                      sun_disk_scale))
    view_pos = torch.tensor(VIEW_POS_MM, dtype=torch.float32,
                            device=eyedir.device)
    hits_ground = m.ray_sphere_first(view_pos.expand(eyedir.shape), eyedir,
                                     GROUND_RADIUS_MM) >= 0.0
    tl = transmittance_lookup(tlut, view_pos[None, :], sun_dir)[0]
    has_sun = (m.norm3(sun_lum) > 0.0)[..., None]
    sun_lum = torch.where(
        has_sun, torch.where(hits_ground[..., None], 0.0, sun_lum * tl), sun_lum)
    return col + sun_lum


def deband_dither(shape, device="cuda"):
    """Zero-mean screen-space dither (`clouds.gdshader:1-2`
    `render_mode use_debanding`): Jimenez interleaved gradient noise over the
    pixel lattice, ±0.5 of an 8-bit display LSB. Deterministic in the pixel
    coordinates, so it draws no random numbers and needs no generator.
    shape: the image shape (..., H, W)."""
    shape = tuple(shape)
    if len(shape) >= 2:
        y = torch.arange(shape[-2], dtype=torch.float32, device=device)[:, None]
        x = torch.arange(shape[-1], dtype=torch.float32, device=device)[None, :]
    else:
        x = torch.arange(shape[0], dtype=torch.float32, device=device)
        y = torch.zeros_like(x)
    ign = torch.frac(52.9829189 * torch.frac(0.06711056 * x + 0.00583715 * y))
    return ((ign - 0.5) / 255.0).expand(shape)


def _cloud_dir(eyedir):
    """The view direction clamped to the upper hemisphere and normalised.
    Straight-down view dirs clamp to the zero vector; their cloud sample is
    fully horizon-faded, so any valid direction works."""
    norm = torch.stack([eyedir[..., 0], torch.clamp(eyedir[..., 1], min=0.0),
                        eyedir[..., 2]], dim=-1)
    n_len = m.norm3(norm)[..., None]
    fallback = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32,
                            device=eyedir.device)
    return torch.where(n_len > 0.0, norm / torch.clamp(n_len, min=1e-12),
                       fallback)


def _finish(eyedir, clouds, background, deband: bool):
    """Clouds over the background, the horizon fade and the optional
    dither (`clouds.gdshader:104-116`)."""
    color = background * (1.0 - clouds[..., 3:4]) + clouds[..., :3]
    fade = m.smoothstep(0.6, 1.0, 1.0 - eyedir[..., 1])[..., None]
    c = torch.clamp(color, 0.0, 100.0)
    b = torch.clamp(background, 0.0, 100.0)
    out = c + (b - c) * fade
    if deband:
        dither = deband_dither(eyedir.shape[:-1], device=eyedir.device)
        out = torch.clamp(out + dither[..., None], min=0.0)
    return out


def _is_kernel_form(cloud, sky, tlut) -> bool:
    """Whether `composite_display`'s tables are the engine's form, which
    kernel K12 composites: 8-channel clamp pair textures and a raw LUT."""
    return all(isinstance(t, Texture2D) and t.channels == 8 and t.wrap == "clamp"
               for t in (cloud, sky)) and isinstance(tlut, torch.Tensor)


def composite_display(eyedir, cloud_blended, sky_blended, tlut, sun_dir,
                      sun_disk_scale, blend_amount=0.0, *,
                      deband: bool = False):
    """Serving-path composite over display-ready textures.

    - PAIR textures (Texture2D, 8 channels, the serving default; or JAX's
      8-channel BrickTable2D): each texel holds the blend pair (from rgba
      in channels 0-3, to rgba in 4-7), so one fetch per texture per pixel
      gives both, and the lerp by
      `blend_amount` follows the fetch, in the split `composite`'s order.
    - PRE-BLENDED tables or images (4 channels): the blend was applied
      before the fetch; `blend_amount` is ignored. The engine does not
      build these; the form is kept for parity with the JAX function,
      which the tests hold it against.

    tlut: the raw transmittance LUT or its table (one fetch a frame).

    The engine's form (clamp pair Texture2Ds, a raw LUT) goes to kernel K12
    (`ops/composite_kernel.composite_display_pair`: one launch on the card,
    `_composite_display_plain` for CPU tensors), which takes the sun as
    host values (a sequence, an array or a CPU tensor). The other forms,
    which no engine builds, take `_composite_display_plain` on every
    device."""
    eyedir = eyedir.to(torch.float32)
    if _is_kernel_form(cloud_blended, sky_blended, tlut):
        return composite_kernel.composite_display_pair(
            eyedir, cloud_blended, sky_blended, tlut, sun_dir, sun_disk_scale,
            blend_amount, deband=deband)
    return _composite_display_plain(eyedir, cloud_blended, sky_blended, tlut, sun_dir,
                                    sun_disk_scale, blend_amount, deband=deband)


def _composite_display_plain(eyedir, cloud_blended, sky_blended, tlut, sun_dir,
                             sun_disk_scale, blend_amount=0.0, *,
                             deband: bool = False):
    """`composite_display` in eager PyTorch, on every form: K12's plain
    version, and the pre-blended and brick-table forms' only one."""
    eyedir = eyedir.to(torch.float32)
    sun_dir = torch.as_tensor(sun_dir, dtype=torch.float32, device=eyedir.device)
    clouds = _fetch_clamp(cloud_blended, world_dir_to_uv(_cloud_dir(eyedir)))
    if _is_pair(cloud_blended):
        clouds = clouds[..., 0:4] + (clouds[..., 4:8] - clouds[..., 0:4]) \
            * blend_amount
    background = get_atmo(eyedir, sky_blended, None, tlut, blend_amount,
                          sun_dir, sun_disk_scale)
    return _finish(eyedir, clouds, background, deband)


def composite(eyedir, cloud_from, cloud_to, sky_from, sky_to, tlut,
              blend_amount, sun_dir, sun_disk_scale, *, deband: bool = False):
    """Full sky() entry point (`clouds.gdshader:104-116`).

    eyedir: [..., 3] world view directions. cloud_from/to: the two blending
    hemisphere maps [N, N, 4]; sky_from/to: the two sky-LUT backbuffers;
    tlut: transmittance LUT. Returns [..., 3] linear HDR color."""
    eyedir = eyedir.to(torch.float32)
    oct_uv = world_dir_to_uv(_cloud_dir(eyedir))
    blend_from = sample2d(cloud_from, oct_uv, wrap="clamp")
    blend_to = sample2d(cloud_to, oct_uv, wrap="clamp")
    clouds = blend_from + (blend_to - blend_from) * blend_amount
    background = get_atmo(eyedir, sky_from, sky_to, tlut, blend_amount,
                          sun_dir, sun_disk_scale)
    return _finish(eyedir, clouds, background, deband)
