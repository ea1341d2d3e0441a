"""Cloud raymarch: the scan-based reference march (torch).

The port of `cloudscape_tpu.models.march`: the six cone-sampling offsets
(`clouds.glsl:140`), the sky-LUT lookup (`clouds.glsl:49-57`), the three
LUT-derived colors hoisted out of the march (`clouds.glsl:162-167`), which
every march shares, and `march`, the restatement of
`cloud_sky/clouds.glsl:139-237` on the noise pyramids: rays are the batch
axis, the primary march is a loop over steps carrying (position,
transmittance, alpha, radiance), and the 6-sample secondary light march is
unrolled (its mip levels are per-iteration constants, `clouds.glsl:190`).

`march` is the numerics anchor: it is held against the f64 oracle
(`oracle/reference.py`), and the exact brick march `march_bricks`
(`models/march_fast.py`) is held against it. Each step is some 3,000
small PyTorch operations, so it is slow on the card; it is a referee, not
a serving path.
"""

from __future__ import annotations

import torch

from cloudscape_tpu_torch.config import GROUND_RADIUS, SKY_B_RADIUS, SKY_T_RADIUS
from cloudscape_tpu_torch.models.density import (MarchParams, NoisePack,
                                                 density_at, sample_weather)
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
# cos 45° as `ambient_colors` rounds it: 1 / sqrt(2) in float32, on the host.
_SQRT_HALF = float(torch.tensor(1.0) / torch.sqrt(torch.tensor(2.0)))
# The marches' constant vectors, one float32 tensor per (values, device),
# made on first use (`device_constant`).
_CONSTANTS = {}


def device_constant(values, device) -> torch.Tensor:
    """The float32 tensor of `values` (a tuple, or a tuple of tuples) on
    `device`, made once per device and shared: `torch.tensor(values,
    dtype=torch.float32, device=device)`, the same bits, without a copy
    from the host on every call (a copy that would wait on the stream, and
    that a CUDA graph cannot capture). Callers only read it."""
    key = (values, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS.setdefault(key, torch.tensor(values, dtype=torch.float32,
                                                    device=device))
    return t


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
    atmosphere_sun = (sky_lut_lookup(sky_lut_img, params.light_direction)
                      * 0.1 * params.light_energy * params.light_color)
    amb = sky_lut_lookup(sky_lut_img, device_constant(
        (_SQRT_HALF, _SQRT_HALF, 0.0), dev)) * 0.05
    atmosphere_ambient = 0.5 * (amb + m.norm3(amb))
    gnd = sky_lut_lookup(sky_lut_img, device_constant(
        (_SQRT_HALF, -_SQRT_HALF, 0.0), dev)) * 5.0 * 0.05
    atmosphere_ground = 0.5 * (gnd + params.ground_color * m.norm3(gnd))
    return atmosphere_sun, atmosphere_ambient, atmosphere_ground


def march(dirs, params: MarchParams, noise: NoisePack, sky_lut_img,
          steps: int = 128, light_steps: int = 6):
    """March world-space view directions [..., 3] (unit, y-up) through the
    cloud shell → [..., 4] = (L rgb, alpha); below-horizon rays return
    zeros (`clouds.glsl:221,232-234`). The sample position advances
    iteratively, p = p + ndir·ss, as in the shader; the reference's
    `if (t > 0)` lighting guard (`clouds.glsl:184`) is an exact no-op at
    t = 0, so the lighting runs unconditionally."""
    dirs = dirs.to(torch.float32)
    dev = dirs.device
    above = dirs[..., 1] > 0.0
    up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=dev)
    ndir = torch.where(above[..., None], dirs, up)

    cam = torch.tensor([0.0, GROUND_RADIUS, 0.0], dtype=torch.float32, device=dev)
    cam_b = cam.expand(ndir.shape)
    start = cam + ndir * m.intersect_sphere_far(cam_b, ndir, SKY_B_RADIUS)[..., None]
    end = cam + ndir * m.intersect_sphere_far(cam_b, ndir, SKY_T_RADIUS)[..., None]
    ss = m.norm3(end - start) / steps

    # Per-texel deterministic start jitter (`clouds.glsl:145`).
    p = start + ndir * (m.hash_iq(start * 10.0) * ss)[..., None]

    lss = (SKY_T_RADIUS - SKY_B_RADIUS) / 64.0
    ldir = params.light_direction / m.norm3(params.light_direction)
    costheta = m.dot3(ldir, ndir)
    phase = torch.maximum(
        torch.maximum(m.henyey_greenstein(costheta, 0.6),
                      m.henyey_greenstein(costheta, 0.4 - 1.4 * ldir[1])),
        m.henyey_greenstein(costheta, -0.2))
    atmosphere_sun, atmosphere_ambient, atmosphere_ground = ambient_colors(
        params, sky_lut_img)

    # The per-step cone offsets, hoisted: lp after j steps is
    # p + Σ_{k≤j} (ldir + RANDOM_VECTORS[k]·k)·lss (`clouds.glsl:187`).
    rv = torch.tensor(RANDOM_VECTORS[:light_steps], dtype=torch.float32, device=dev)
    k = torch.arange(light_steps, dtype=torch.float32, device=dev)
    light_offsets = torch.cumsum((ldir[None, :] + rv * k[:, None]) * lss, dim=0)
    distant_offset = ldir * (18.0 * lss)

    T = torch.ones_like(ss)
    alpha = torch.zeros_like(ss)
    L = torch.zeros_like(p)
    for _ in range(steps):
        p = p + ndir * ss[..., None]
        weather = sample_weather(noise, p[..., [0, 2]], params.weather_pos)
        hf = m.height_fraction(m.norm3(p), SKY_B_RADIUS, SKY_T_RADIUS)
        t, _ = density_at(p, weather, 0.0, params, noise)
        dt = torch.exp(-params.density * t * ss)

        # Secondary light march: 6 cone samples at mips 0..5 and one distant
        # sample at mip 5 (`clouds.glsl:184-199`).
        cd = torch.zeros_like(ss)
        for j in range(light_steps):
            lp = p + light_offsets[j]
            lweather = sample_weather(noise, lp[..., [0, 2]], params.weather_pos)
            lt, _ = density_at(lp, lweather, float(j), params, noise)
            cd = cd + lt
        lp = p + distant_offset
        lhf = m.height_fraction(m.norm3(lp), SKY_B_RADIUS, SKY_T_RADIUS)
        # Quirk preserved: the distant sample's weather omits + weather_pos
        # (`clouds.glsl:197`).
        lweather = sample2d(noise.weather, lp[..., [0, 2]] * 0.00006 + 0.5,
                            wrap="repeat")
        ldens, _ = density_at(lp, lweather, 5.0, params, noise)
        cd = cd + torch.pow(ldens, (1.0 - lhf) * 0.8 + 0.5)

        # Beer–powder (`clouds.glsl:201-204`).
        beers = torch.exp(-params.density * cd * lss * 3.0)
        powder = 1.0 - torch.exp(-params.density * cd * lss * 6.0)
        beers_total = 2.0 * beers * powder

        ambient = atmosphere_ground + (atmosphere_ambient - atmosphere_ground) * \
            m.smoothstep(0.0, 1.0, hf)[..., None]
        alpha = alpha + (1.0 - dt) * (1.0 - alpha)
        radiance = (ambient + (beers_total * phase)[..., None] * atmosphere_sun) \
            * t[..., None]
        L = L + T[..., None] * (radiance - radiance * dt[..., None]) / \
            torch.clamp(t, min=1e-7)[..., None]
        T = T * dt

    out = torch.cat([L, torch.clamp(alpha, 0.0, 1.0)[..., None]], dim=-1)
    return torch.where(above[..., None], out, 0.0)
