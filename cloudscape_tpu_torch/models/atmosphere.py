"""Physically-based atmosphere precompute stages (torch).

The port of `cloudscape_tpu.models.atmosphere`:

- `transmittance_lut()`  ← `cloud_sky/transmittance-lut.glsl` (256×64 ×
  40-step midpoint march of spectral extinction, baked once at startup);
- `sky_lut()` / `sky_lut_rows()` ← `cloud_sky/sky-lut.glsl` (200×100 ×
  30-step single + pseudo-multiple scattering, once per cycle; the banded
  form lets the engine spread the render over ticks, and every texel is
  elementwise in (u, v), so bands equal the whole render).

Spectral in 4 samples (630/560/490/430 nm) following Fernando García Liñán's
MIT-licensed model. The public functions dispatch by device through
`ops/atmosphere_kernel.py`: on the card each LUT is one launch of a
hand-written kernel (K10 the sky-view rows, K11 the transmittance LUT,
`csrc/atmosphere.cu`); on the CPU, and as the kernels' plain versions,
`_sky_lut_rows_plain` and `_transmittance_lut_plain` run the eager tensor
code below (a Python loop over the march steps: ~10k launches a sky call
on a card).
"""

from __future__ import annotations

import torch

from cloudscape_tpu_torch.ops import atmosphere_kernel
from cloudscape_tpu_torch.ops.math import dot3
from cloudscape_tpu_torch.ops.sampling import sample2d

EARTH_RADIUS = 6371.0  # km
ATMOSPHERE_THICKNESS = 100.0  # km
ATMOSPHERE_RADIUS = EARTH_RADIUS + ATMOSPHERE_THICKNESS
EYE_ALTITUDE = 0.5  # km
EYE_DISTANCE_TO_EARTH_CENTER = EARTH_RADIUS + EYE_ALTITUDE
GROUND_ALBEDO = 0.3

TRANSMITTANCE_STEPS = 40  # `transmittance-lut.glsl:45`
IN_SCATTERING_STEPS = 30  # `sky-lut.glsl:53`

TRANSMITTANCE_LUT_SIZE = (64, 256)  # (H, W)
SKY_LUT_SIZE = (100, 200)  # (H, W)

_PI = 3.14159265358979323846
_INV_4PI = 0.25 / _PI
_PHASE_ISOTROPIC = _INV_4PI
_RAYLEIGH_PHASE_SCALE = (3.0 / 16.0) / _PI
_AEROSOL_G = 0.8

_SUN_SPECTRAL_IRRADIANCE = (1.679, 1.828, 1.986, 1.307)
_MOLECULAR_SCATTERING_BASE = (6.605e-3, 1.067e-2, 1.842e-2, 3.156e-2)
_OZONE_CROSS_SECTION = (3.472e-21, 3.914e-21, 1.349e-21, 11.03e-23)
_OZONE_MEAN_DOBSON = 350.0
_AEROSOL_ABSORPTION_XS = (2.8722e-24, 4.6168e-24, 7.9706e-24, 1.3578e-23)
_AEROSOL_SCATTERING_XS = (1.5908e-22, 1.7711e-22, 2.0942e-22, 2.4033e-22)
_AEROSOL_BASE_DENSITY = 1.3681e20
_AEROSOL_BG_OVER_BASE = 2e6 / 1.3681e20
_AEROSOL_HEIGHT_SCALE = 0.73
_MS_SPECTRUM = (0.217, 0.347, 0.594, 1.0)

# Spectral → linear sRGB, rgb = M @ L_spectral, M [3, 4] (`sky-lut.glsl:207-217`).
SPECTRAL_TO_SRGB = (
    (137.672389239975, 32.549094028629234, -38.91428392614275, 8.572844237945445),
    (-8.632904716299537, 91.29801417199785, 34.31665471469816, -11.103384660054624),
    (-1.7181567391931372, -12.005406444382531, 29.89044807197628, 117.47585277566478),
)


def _vec4(values, like):
    """A float32 [4] constant on `like`'s device, rounded as the JAX
    package's f32 constant arrays are."""
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def _ray_sphere(ro, rd, radius):
    """First-hit/-1 solver (`sky-lut.glsl:100-109`); ro/rd [..., 3]."""
    b = dot3(ro, rd)
    c = dot3(ro, ro) - radius * radius
    d = b * b - c
    sqrt_d = torch.sqrt(torch.clamp(d, min=0.0))
    hit = torch.where(d > b * b, -b + sqrt_d, -b - sqrt_d)
    miss = ((c > 0.0) & (b > 0.0)) | (d < 0.0)
    return torch.where(miss, -1.0, hit)


def _atmosphere_coefficients(h):
    """(aerosol_scat, molecular_scat, extinction), each [..., 4]
    (`sky-lut.glsl:188-202`; absorption terms fold into extinction)."""
    h = torch.clamp(h, min=0.0)
    aerosol_density = _AEROSOL_BASE_DENSITY * (
        torch.exp(-h / _AEROSOL_HEIGHT_SCALE) + _AEROSOL_BG_OVER_BASE)
    aerosol_absorption = _vec4(_AEROSOL_ABSORPTION_XS, h) * aerosol_density[..., None]
    aerosol_scattering = _vec4(_AEROSOL_SCATTERING_XS, h) * aerosol_density[..., None]
    hh = h + 1e-4  # `sky-lut.glsl:172`: avoid log(0)
    t = torch.log(hh) - 3.22261
    ozone_density = 3.78547397e20 * (1.0 / hh) * torch.exp(-t * t * 5.55555555)
    ozone_xs = _vec4(_OZONE_CROSS_SECTION, h) * 1e-4
    molecular_absorption = ozone_xs * _OZONE_MEAN_DOBSON * ozone_density[..., None]
    molecular_scattering = _vec4(_MOLECULAR_SCATTERING_BASE, h) * torch.exp(
        -0.07771971 * torch.pow(h, 1.16364243))[..., None]
    extinction = (aerosol_absorption + aerosol_scattering
                  + molecular_absorption + molecular_scattering)
    return aerosol_scattering, molecular_scattering, extinction


def transmittance_lut(width: int = 256, height: int = 64, device="cuda"):
    """Bake the spectral sun-transmittance LUT, [height, width, 4] float32
    (`transmittance-lut.glsl:157-196`): kernel K11 on a card, the plain
    version on the CPU."""
    return atmosphere_kernel.transmittance_lut(width, height, device)


def _transmittance_lut_plain(width: int = 256, height: int = 64, device="cpu"):
    """K11's plain version: the eager tensor march of `transmittance_lut`."""
    u = (torch.arange(width, dtype=torch.float32, device=device) / width)[None, :]
    v = (torch.arange(height, dtype=torch.float32, device=device) / height)[:, None]
    u, v = torch.broadcast_tensors(u, v)

    sun_cos_theta = u * 2.0 - 1.0
    sun_dir = torch.stack([
        -torch.sqrt(torch.clamp(1.0 - sun_cos_theta * sun_cos_theta, min=0.0)),
        torch.zeros_like(sun_cos_theta),
        sun_cos_theta,
    ], dim=-1)
    dist_center = EARTH_RADIUS + (ATMOSPHERE_RADIUS - EARTH_RADIUS) * v
    ray_origin = torch.stack([torch.zeros_like(v), torch.zeros_like(v),
                              dist_center], dim=-1)

    t_d = _ray_sphere(ray_origin, sun_dir, ATMOSPHERE_RADIUS)
    dt = t_d / TRANSMITTANCE_STEPS
    tau = torch.zeros((height, width, 4), dtype=torch.float32, device=device)
    for i in range(TRANSMITTANCE_STEPS):
        t = (float(i) + 0.5) * dt
        x_t = ray_origin + sun_dir * t[..., None]
        altitude = torch.sqrt(dot3(x_t, x_t)) - EARTH_RADIUS
        _, _, extinction = _atmosphere_coefficients(altitude)
        tau = tau + extinction * dt[..., None]
    return torch.exp(-tau)


def _transmittance_from_lut(tlut, cos_theta, normalized_altitude):
    """`sky-lut.glsl:137-142`: clamp-to-edge bilinear lookup."""
    u = torch.clamp(cos_theta * 0.5 + 0.5, 0.0, 1.0)
    v = torch.clamp(normalized_altitude, 0.0, 1.0)
    uv = torch.stack(torch.broadcast_tensors(u, v), dim=-1)
    return sample2d(tlut, uv, wrap="clamp")


def _multiple_scattering(tlut, cos_theta, normalized_height, d):
    """Ground bounce + fitted Earth term (`sky-lut.glsl:144-164`)."""
    omega = 2.0 * _PI * (
        1.0 - torch.sqrt(torch.clamp(d * d - EARTH_RADIUS ** 2, min=0.0)) / d)
    zeros = torch.zeros_like(cos_theta)
    ones = torch.ones_like(cos_theta)
    t_to_ground = _transmittance_from_lut(tlut, cos_theta, zeros)
    t_ground_to_sample = _transmittance_from_lut(tlut, ones, zeros) / \
        _transmittance_from_lut(tlut, ones, normalized_height)
    l_ground = (_PHASE_ISOTROPIC * omega[..., None] * (GROUND_ALBEDO / _PI)
                * t_to_ground * t_ground_to_sample * cos_theta[..., None])
    l_ms = 0.02 * _vec4(_MS_SPECTRUM, cos_theta) * (
        1.0 / (1.0 + 5.0 * torch.exp(-17.92 * cos_theta)))[..., None]
    return l_ms + l_ground


def sky_lut(tlut, sun_direction, width: int = 200, height: int = 100):
    """Render the sky-view LUT, [height, width, 4] (linear sRGB + alpha 1)
    (`sky-lut.glsl:278-315`). `sun_direction` is the world (y-up) sun
    vector."""
    return sky_lut_rows(tlut, sun_direction, 0, rows=height, width=width,
                        height=height)


def sky_lut_rows(tlut, sun_direction, row0: int, *, rows: int,
                 width: int = 200, height: int = 100):
    """One row band [row0, row0+rows) of `sky_lut`, [rows, width, 4]: one
    launch of kernel K10 for a LUT on a card, the plain version on the CPU.
    Each texel is computed alone, so a band is the same rows of a whole
    call (on the card bitwise)."""
    return atmosphere_kernel.sky_lut_rows(tlut, sun_direction, row0, rows, width,
                                          height)


def _sky_lut_rows_plain(tlut, sun_direction, row0: int, *, rows: int,
                        width: int = 200, height: int = 100):
    """K10's plain version: the eager tensor march of `sky_lut_rows`."""
    dev = tlut.device
    s = torch.as_tensor(sun_direction, dtype=torch.float32, device=dev)
    sun_dir = torch.stack([-s[0], -s[2], s[1]])

    u = (torch.arange(width, dtype=torch.float32, device=dev) / width)[None, :]
    v = ((float(row0) + torch.arange(rows, dtype=torch.float32, device=dev))
         / height)[:, None]
    u, v = torch.broadcast_tensors(u, v)

    azimuth = 2.0 * _PI * u
    lv = v * 2.0 - 1.0
    elev = lv * lv * torch.sign(lv) * (_PI * 0.5)
    ray_dir = torch.stack([torch.cos(elev) * torch.cos(azimuth),
                           torch.cos(elev) * torch.sin(azimuth),
                           torch.sin(elev)], dim=-1)
    ray_origin = torch.tensor([0.0, 0.0, EYE_DISTANCE_TO_EARTH_CENTER],
                              dtype=torch.float32, device=dev).expand(ray_dir.shape)

    atmos_dist = _ray_sphere(ray_origin, ray_dir, ATMOSPHERE_RADIUS)
    ground_dist = _ray_sphere(ray_origin, ray_dir, EARTH_RADIUS)
    t_d = torch.where(ground_dist < 0.0, atmos_dist, ground_dist)

    cos_theta = dot3(-ray_dir, sun_dir)
    molecular_phase = _RAYLEIGH_PHASE_SCALE * (1.0 + cos_theta * cos_theta)
    den = 1.0 + _AEROSOL_G ** 2 + 2.0 * _AEROSOL_G * cos_theta
    aerosol_phase = _INV_4PI * (1.0 - _AEROSOL_G ** 2) / (den * torch.sqrt(den))
    sun_irr = _vec4(_SUN_SPECTRAL_IRRADIANCE, u)

    dt = t_d / IN_SCATTERING_STEPS
    l_in = torch.zeros((rows, width, 4), dtype=torch.float32, device=dev)
    transmittance = torch.ones((rows, width, 4), dtype=torch.float32, device=dev)
    for i in range(IN_SCATTERING_STEPS):
        t = (float(i) + 0.5) * dt
        x_t = ray_origin + ray_dir * t[..., None]
        dist_center = torch.sqrt(dot3(x_t, x_t))
        zenith_dir = x_t / dist_center[..., None]
        altitude = dist_center - EARTH_RADIUS
        normalized_altitude = altitude / ATMOSPHERE_THICKNESS
        sample_cos_theta = dot3(zenith_dir, sun_dir)

        aerosol_scattering, molecular_scattering, extinction = \
            _atmosphere_coefficients(altitude)
        t_sun = _transmittance_from_lut(tlut, sample_cos_theta, normalized_altitude)
        ms = _multiple_scattering(tlut, sample_cos_theta, normalized_altitude,
                                  dist_center)
        s_term = sun_irr * (
            molecular_scattering * (molecular_phase[..., None] * t_sun + ms)
            + aerosol_scattering * (aerosol_phase[..., None] * t_sun + ms))
        step_transmittance = torch.exp(-dt[..., None] * extinction)
        # Hillaire's energy-conserving analytic step (`sky-lut.glsl:261-272`).
        s_int = (s_term - s_term * step_transmittance) / torch.clamp(extinction,
                                                                     min=1e-7)
        l_in = l_in + transmittance * s_int
        transmittance = transmittance * step_transmittance

    rgb = torch.stack([sum(l_in[..., c] * m for c, m in enumerate(row))
                       for row in SPECTRAL_TO_SRGB], dim=-1)
    return torch.cat([rgb, torch.ones((rows, width, 1), dtype=torch.float32,
                                      device=dev)], dim=-1)
