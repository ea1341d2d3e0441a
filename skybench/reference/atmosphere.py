"""The transmittance LUT (`transmittance-lut.glsl:157-196`) and the
sky-view LUT (`sky-lut.glsl:219-315`) in plain tensor operations."""

from __future__ import annotations

import math

import torch

from skybench.reference.sampling import sample2d

EARTH_RADIUS = 6371.0
ATMOSPHERE_THICKNESS = 100.0
ATMOSPHERE_RADIUS = EARTH_RADIUS + ATMOSPHERE_THICKNESS
EYE_DISTANCE_TO_EARTH_CENTER = EARTH_RADIUS + 0.5
GROUND_ALBEDO = 0.3

SUN_SPECTRAL_IRRADIANCE = (1.679, 1.828, 1.986, 1.307)
MOLECULAR_SCATTERING_BASE = (6.605e-3, 1.067e-2, 1.842e-2, 3.156e-2)
OZONE_CROSS_SECTION = tuple(v * 1e-4 for v in (3.472e-21, 3.914e-21, 1.349e-21,
                                               11.03e-23))
OZONE_MEAN_DOBSON = 350.0
AEROSOL_ABSORPTION_CROSS_SECTION = (2.8722e-24, 4.6168e-24, 7.9706e-24, 1.3578e-23)
AEROSOL_SCATTERING_CROSS_SECTION = (1.5908e-22, 1.7711e-22, 2.0942e-22, 2.4033e-22)
AEROSOL_BASE_DENSITY = 1.3681e20
AEROSOL_BG_OVER_BASE = 2e6 / AEROSOL_BASE_DENSITY
AEROSOL_HEIGHT_SCALE = 0.73
# Spectral (630/560/490/430 nm) → linear sRGB (`sky-lut.glsl:207-217`):
# row k is spectral sample k's rgb.
SPECTRAL_TO_SRGB = (
    (137.672389239975, -8.632904716299537, -1.7181567391931372),
    (32.549094028629234, 91.29801417199785, -12.005406444382531),
    (-38.91428392614275, 34.31665471469816, 29.89044807197628),
    (8.572844237945445, -11.103384660054624, 117.47585277566478),
)
TRANSMITTANCE_STEPS = 40
IN_SCATTERING_STEPS = 30
AEROSOL_G = 0.8


def _vec(values, like):
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def ray_sphere(ro, rd, radius):
    """First hit of a ray from ro along rd on a sphere at the origin, −1 on
    a miss (`sky-lut.glsl:100-109`)."""
    b = (ro * rd).sum(-1)
    c = (ro * ro).sum(-1) - radius * radius
    d = b * b - c
    sq = torch.sqrt(torch.clamp(d, min=0.0))
    hit = torch.where(d > b * b, -b + sq, -b - sq)
    miss = ((c > 0.0) & (b > 0.0)) | (d < 0.0)
    return torch.where(miss, torch.full_like(hit, -1.0), hit)


def coefficients(h):
    """(aerosol scattering, molecular scattering, extinction), each [..., 4]
    (`sky-lut.glsl:188-202`)."""
    h = torch.clamp(h, min=0.0)
    ad = (AEROSOL_BASE_DENSITY * (torch.exp(-h / AEROSOL_HEIGHT_SCALE)
                                  + AEROSOL_BG_OVER_BASE))[..., None]
    a_abs = _vec(AEROSOL_ABSORPTION_CROSS_SECTION, h) * ad
    a_sca = _vec(AEROSOL_SCATTERING_CROSS_SECTION, h) * ad
    ho = h + 1e-4
    t = torch.log(ho) - 3.22261
    ozone = 3.78547397e20 * (1.0 / ho) * torch.exp(-t * t * 5.55555555)
    m_abs = _vec(OZONE_CROSS_SECTION, h) * OZONE_MEAN_DOBSON * ozone[..., None]
    m_sca = _vec(MOLECULAR_SCATTERING_BASE, h) * torch.exp(
        -0.07771971 * torch.pow(h, 1.16364243))[..., None]
    return a_sca, m_sca, a_abs + a_sca + m_abs + m_sca


def transmittance_lut(width: int = 256, height: int = 64, *, dtype=torch.float64,
                      device="cpu"):
    """[height, width, 4] sun transmittance: u is the sun's cos-zenith
    (2u − 1), v the start altitude; a 40-step midpoint march to the top."""
    u = (torch.arange(width, dtype=dtype, device=device) / width)[None, :]
    v = (torch.arange(height, dtype=dtype, device=device) / height)[:, None]
    u, v = torch.broadcast_tensors(u, v)
    cos_t = u * 2.0 - 1.0
    sun = torch.stack([-torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0)),
                       torch.zeros_like(cos_t), cos_t], dim=-1)
    r0 = EARTH_RADIUS + (ATMOSPHERE_RADIUS - EARTH_RADIUS) * v
    ro = torch.stack([torch.zeros_like(r0), torch.zeros_like(r0), r0], dim=-1)
    dt = ray_sphere(ro, sun, ATMOSPHERE_RADIUS) / TRANSMITTANCE_STEPS
    acc = torch.zeros(u.shape + (4,), dtype=dtype, device=device)
    for i in range(TRANSMITTANCE_STEPS):
        x = ro + sun * ((i + 0.5) * dt)[..., None]
        alt = torch.linalg.vector_norm(x, dim=-1) - EARTH_RADIUS
        acc = acc + coefficients(alt)[2] * dt[..., None]
    return torch.exp(-acc)


def _transmittance_at(tlut, cos_theta, alt01):
    u = torch.clamp(cos_theta * 0.5 + 0.5, 0.0, 1.0)
    v = torch.clamp(alt01, 0.0, 1.0)
    return sample2d(tlut, torch.stack(torch.broadcast_tensors(u, v), dim=-1),
                    wrap="clamp")


def _multiple_scattering(tlut, cos_theta, alt01, d):
    """`sky-lut.glsl:144-164`."""
    omega = 2.0 * math.pi * (1.0 - torch.sqrt(
        torch.clamp(d * d - EARTH_RADIUS ** 2, min=0.0)) / d)
    to_ground = _transmittance_at(tlut, cos_theta, torch.zeros_like(alt01))
    ones = torch.ones_like(alt01)
    ground_to_sample = (_transmittance_at(tlut, ones, torch.zeros_like(alt01))
                        / _transmittance_at(tlut, ones, alt01))
    l_ground = ((0.25 / math.pi) * omega[..., None] * (GROUND_ALBEDO / math.pi)
                * to_ground * ground_to_sample * cos_theta[..., None])
    l_ms = 0.02 * _vec((0.217, 0.347, 0.594, 1.0), d) * (
        1.0 / (1.0 + 5.0 * torch.exp(-17.92 * cos_theta)))[..., None]
    return l_ms + l_ground


def sky_lut(tlut, sun_world, width: int = 200, height: int = 100):
    """[height, width, 4] sky-view LUT (rgb, alpha 1) for the world (y-up)
    sun vector `sun_world` (`sky-lut.glsl:219-315`): azimuth 2πu, elevation
    (2v − 1)²·sign·π/2, a 30-step in-scattering march; in tlut's dtype."""
    dtype, device = tlut.dtype, tlut.device
    s = torch.as_tensor(sun_world, dtype=dtype, device=device)
    sun = torch.stack([-s[0], -s[2], s[1]])
    u = (torch.arange(width, dtype=dtype, device=device) / width)[None, :]
    v = (torch.arange(height, dtype=dtype, device=device) / height)[:, None]
    u, v = torch.broadcast_tensors(u, v)
    az = 2.0 * math.pi * u
    lv = v * 2.0 - 1.0
    el = lv * lv * torch.sign(lv) * (math.pi * 0.5)
    rd = torch.stack([torch.cos(el) * torch.cos(az), torch.cos(el) * torch.sin(az),
                      torch.sin(el)], dim=-1)
    ro = _vec((0.0, 0.0, EYE_DISTANCE_TO_EARTH_CENTER), tlut).expand_as(rd)
    atmos = ray_sphere(ro, rd, ATMOSPHERE_RADIUS)
    ground = ray_sphere(ro, rd, EARTH_RADIUS)
    t_d = torch.where(ground < 0.0, atmos, ground)

    cos_t = (-rd * sun).sum(-1)
    mol_phase = (3.0 / 16.0) / math.pi * (1.0 + cos_t * cos_t)
    den = 1.0 + AEROSOL_G ** 2 + 2.0 * AEROSOL_G * cos_t
    aer_phase = (0.25 / math.pi) * (1.0 - AEROSOL_G ** 2) / (den * torch.sqrt(den))
    dt = t_d / IN_SCATTERING_STEPS
    light = torch.zeros(rd.shape[:-1] + (4,), dtype=dtype, device=device)
    trans = torch.ones_like(light)
    irr = _vec(SUN_SPECTRAL_IRRADIANCE, tlut)
    for i in range(IN_SCATTERING_STEPS):
        x = ro + rd * ((i + 0.5) * dt)[..., None]
        dist = torch.linalg.vector_norm(x, dim=-1)
        alt = dist - EARTH_RADIUS
        alt01 = alt / ATMOSPHERE_THICKNESS
        cos_s = ((x / dist[..., None]) * sun).sum(-1)
        a_sca, m_sca, ext = coefficients(alt)
        to_sun = _transmittance_at(tlut, cos_s, alt01)
        ms = _multiple_scattering(tlut, cos_s, alt01, dist)
        s_term = irr * (m_sca * (mol_phase[..., None] * to_sun + ms)
                        + a_sca * (aer_phase[..., None] * to_sun + ms))
        step = torch.exp(-dt[..., None] * ext)
        light = light + trans * (s_term - s_term * step) / torch.clamp(ext, min=1e-7)
        trans = trans * step
    rgb = light @ _vec(SPECTRAL_TO_SRGB, tlut)
    return torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
