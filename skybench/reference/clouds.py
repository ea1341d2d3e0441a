"""The cloud march (`clouds.glsl:139-237`) in plain tensor operations.

`Scene` holds one snapshot of the kernel's inputs (the push constants);
`cloud_march` marches a batch of world directions through the cloud shell
with the shader's full 6-sample light cone and distant sample at every
step, on the noise mip chains that `Textures` builds from the level-0
volumes. The march is the shader's loop reorganised over whole rows:
the transmittance before step k is exp(−density·ss·Σ_{j<k} t_j) and the
alpha 1 − Π dt, which equal the loop's running products in exact
arithmetic; the light cone is evaluated only where the step's density
is above zero, where the shader's `if (t > 0)` guard
(`clouds.glsl:184`) leaves every update a no-op.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import torch

from skybench.reference.sampling import pyramid3d, sample2d, sample3d_lod

G_RADIUS = 6000000.0
SKY_B_RADIUS = 6001500.0
SKY_T_RADIUS = 6004000.0
PI_CLOUDS = 3.141592  # the truncated constant of `clouds.glsl:47`
RANDOM_VECTORS = (
    (0.38051305, 0.92453449, -0.02111345),
    (-0.50625799, -0.03590792, -0.86163418),
    (-0.32509218, -0.94557439, 0.01428793),
    (0.09026238, -0.27376545, 0.95755165),
    (0.28128598, 0.42443639, -0.86065785),
    (-0.16852403, 0.14748697, 0.97460106),
)  # `clouds.glsl:140`
WEATHER_SCALE = 0.00006
# Samples of one block of the march: bounds what a block materialises.
BLOCK_SAMPLES = 1 << 22


@dataclasses.dataclass(frozen=True)
class Textures:
    """The noise volumes' mip chains and the weather image, in one dtype."""

    large: List[torch.Tensor]
    small: List[torch.Tensor]
    weather: torch.Tensor

    @staticmethod
    def build(large, small, weather, dtype=torch.float64) -> "Textures":
        """From the level-0 [D, H, W, 4] base, [D, H, W, 3] detail and
        [H, W, 3] weather textures the program is handed."""
        return Textures(pyramid3d(large.to(dtype)), pyramid3d(small.to(dtype)),
                        weather.to(dtype))


@dataclasses.dataclass(frozen=True)
class Scene:
    """One snapshot of the march's inputs, as the shader receives them
    (float32 push constants, `cloud_sky.gd:251-289`)."""

    cloud_pos: tuple
    detailed_pos: tuple
    weather_pos: tuple
    time: float
    density: float
    cloud_coverage: float
    light_direction: tuple
    light_energy: float
    light_color: tuple
    ground_color: tuple


def hash13(p):
    """iq's hash (`clouds.glsl:60-64`), in float32 as on the GPU."""
    p = p.to(torch.float32)
    p = torch.remainder(p * 0.3183099 + 0.1, 1.0) * 17.0
    x, y, z = p.unbind(-1)
    return torch.remainder(x * y * z * (x + y + z), 1.0)


def _remap(v, lo, hi, nlo, nhi):
    return nlo + ((v - lo) / (hi - lo)) * (nhi - nlo)


def _smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _hg(cos_theta, g):
    return 0.0795774715459 * (1.0 - g * g) / torch.pow(
        1.0 + g * g - 2.0 * g * cos_theta, 1.5)


def _height_fraction(p):
    r = torch.linalg.vector_norm(p, dim=-1)
    return torch.clamp((r - SKY_B_RADIUS) / (SKY_T_RADIUS - SKY_B_RADIUS), 0.0, 1.0)


def _height_gradient(h, cloud_type):
    """`clouds.glsl:77-95`: stratus / stratocumulus / cumulus gradients."""
    stratus = 1.0 - torch.clamp(cloud_type * 2.0, 0.0, 1.0)
    strato = 1.0 - torch.abs(cloud_type - 0.5) * 2.0
    cumulus = torch.clamp(cloud_type - 0.5, 0.0, 1.0) * 2.0
    g = [a * stratus + b * strato + c * cumulus for a, b, c in
         ((0.02, 0.02, 0.01), (0.05, 0.2, 0.0625), (0.09, 0.48, 0.78),
          (0.11, 0.625, 1.0))]
    return _smoothstep(g[0], g[1], h) - _smoothstep(g[2], g[3], h)


def _far(pos, d, r):
    """Far root of |pos + t·d| = r (`clouds.glsl:97-105`)."""
    a = (d * d).sum(-1)
    b = 2.0 * (d * pos).sum(-1)
    c = (pos * pos).sum(-1) - r * r
    q = torch.sqrt(b * b - 4.0 * a * c)
    return torch.maximum(-b - q, -b + q) / (2.0 * a)


def density(p, weather, mip: float, sc: Scene, tex: Textures):
    """Schneider's density (`clouds.glsl:107-137`) at points p [..., 3]
    with their weather samples [..., 3]."""
    hf = _height_fraction(p)
    off_x, off_z = 20.0 * sc.cloud_pos[0] * 0.6, 20.0 * sc.cloud_pos[1] * 0.6
    pb = torch.stack([p[..., 0] + off_x, p[..., 1], p[..., 2] + off_z], dim=-1)
    n = sample3d_lod(tex.large, pb * 0.00008, mip - 2.0)
    fbm = n[..., 1] * 0.625 + n[..., 2] * 0.25 + n[..., 3] * 0.125
    g = _height_gradient(hf, weather[..., 0])
    base = _remap(n[..., 0], -(1.0 - fbm), 1.0, 0.0, 1.0)
    cover = sc.cloud_coverage * weather[..., 2]
    # The shader divides by the coverage, 0 where the weather map has none;
    # the GPU's clamps absorb the NaN, so the denominator is guarded.
    base = (base * g - (1.0 - cover)) / torch.clamp(cover, min=1e-6) * cover
    pd = torch.stack([pb[..., 0] - sc.detailed_pos[0] * 40.0,
                      pb[..., 1] - sc.time * 40.0,
                      pb[..., 2] - sc.detailed_pos[1] * 40.0], dim=-1)
    hn = sample3d_lod(tex.small, pd * 0.001, mip)
    hfbm = hn[..., 0] * 0.625 + hn[..., 1] * 0.25 + hn[..., 2] * 0.125
    hfbm = hfbm + (1.0 - 2.0 * hfbm) * torch.clamp(hf * 4.0, 0.0, 1.0)
    base = _remap(base, hfbm * 0.4 * hf, 1.0, 0.0, 1.0)
    return torch.pow(torch.clamp(base, 0.0, 1.0), (1.0 - hf) * 0.8 + 0.5)


def _weather(p, tex: Textures, weather_pos):
    uv = torch.stack([p[..., 0] * WEATHER_SCALE + 0.5 + weather_pos[0],
                      p[..., 2] * WEATHER_SCALE + 0.5 + weather_pos[1]], dim=-1)
    return sample2d(tex.weather, uv)


def sky_lut_value(sky, d):
    """`clouds.glsl:49-57`: the sky-view LUT at world direction d [3]."""
    phi = torch.atan2(d[..., 2], d[..., 0])
    theta = torch.asin(torch.clamp(d[..., 1], -1.0, 1.0))
    u = phi / PI_CLOUDS * 0.5 + 0.5
    v = torch.sqrt(torch.abs(theta) / (PI_CLOUDS * 0.5)) * torch.sign(theta) * 0.5 + 0.5
    return sample2d(sky, torch.stack([u, v], dim=-1), wrap="clamp")[..., :3]


def _lighting(sc: Scene, sky):
    """(sun, ambient, ground) colours of the snapshot (`clouds.glsl:151-167`)."""
    vec = _maker(sky)
    ldir = vec(sc.light_direction)
    sun = sky_lut_value(sky, ldir) * 0.1 * sc.light_energy * vec(sc.light_color)
    amb = sky_lut_value(sky, vec((1.0, 1.0, 0.0)) / math.sqrt(2.0)) * 0.05
    amb = 0.5 * (amb + torch.linalg.vector_norm(amb))
    gnd = sky_lut_value(sky, vec((1.0, -1.0, 0.0)) / math.sqrt(2.0)) * 0.25
    gnd = 0.5 * (gnd + vec(sc.ground_color) * torch.linalg.vector_norm(gnd))
    return sun, amb, gnd


def _maker(like):
    """A maker of 1-D tensors in like's dtype and device."""
    return lambda v: torch.tensor(v, dtype=like.dtype, device=like.device)


def cloud_march(dirs, sc: Scene, tex: Textures, sky, steps: int = 128,
                light_steps: int = 6):
    """[..., 4] (L rgb, alpha) of world (y-up) unit directions dirs [..., 3]
    in tex's dtype; zero below the horizon. sky: the snapshot's sky-view LUT
    [100, 200, 4]."""
    dtype, dev = tex.weather.dtype, tex.weather.device
    vec = _maker(tex.weather)
    shape = dirs.shape[:-1]
    flat = dirs.reshape(-1, 3).to(dtype)
    out = torch.zeros((flat.shape[0], 4), dtype=dtype, device=dev)
    ldir = vec(sc.light_direction)
    ldir = ldir / torch.linalg.vector_norm(ldir)
    sun, amb, gnd = _lighting(sc, sky.to(dtype))
    lss = (SKY_T_RADIUS - SKY_B_RADIUS) / 64.0
    cone = []
    acc = torch.zeros(3, dtype=dtype, device=dev)
    for j in range(light_steps):
        acc = acc + (ldir + vec(RANDOM_VECTORS[j]) * float(j)) * lss
        cone.append(acc)
    wpos = sc.weather_pos
    block = max(1, BLOCK_SAMPLES // steps)
    ks = torch.arange(1, steps + 1, dtype=dtype, device=dev)
    for r0 in range(0, flat.shape[0], block):
        d = flat[r0:r0 + block]
        above = d[:, 1] > 0.0
        if not bool(above.any()):
            continue
        d = d[above]
        cam = vec((0.0, G_RADIUS, 0.0)).expand_as(d)
        start = cam + d * _far(cam, d, SKY_B_RADIUS)[:, None]
        end = cam + d * _far(cam, d, SKY_T_RADIUS)[:, None]
        ss = torch.linalg.vector_norm(end - start, dim=-1) / steps
        p0 = start + d * (hash13(start * 10.0).to(dtype) * ss)[:, None]
        # [rays, steps, 3]: the shader steps before it samples.
        p = p0[:, None, :] + d[:, None, :] * (ks[None, :] * ss[:, None])[..., None]
        t = density(p, _weather(p, tex, wpos), 0.0, sc, tex)
        live = t > 0.0
        cos_t = (d * ldir).sum(-1)
        phase = torch.maximum(torch.maximum(_hg(cos_t, 0.6), _hg(cos_t, 0.4 - 1.4 * ldir[1])),
                              _hg(cos_t, -0.2))
        # The light cone and the distant sample at the live steps only.
        pl = p[live]
        cd = torch.zeros(pl.shape[0], dtype=dtype, device=dev)
        for j in range(light_steps):
            lp = pl + cone[j]
            cd = cd + density(lp, _weather(lp, tex, wpos), float(j), sc, tex)
        lp = pl + ldir * (18.0 * lss)
        far = density(lp, _weather(lp, tex, (0.0, 0.0)), 5.0, sc, tex)
        cd = cd + torch.pow(far, (1.0 - _height_fraction(lp)) * 0.8 + 0.5)
        beers = torch.exp(-sc.density * cd * lss * 3.0)
        powder = 1.0 - torch.exp(-sc.density * cd * lss * 3.0 * 2.0)
        hf = _height_fraction(pl)
        tl = t[live]
        ambient = gnd + (amb - gnd) * _smoothstep(0.0, 1.0, hf)[:, None]
        ray_live = live.nonzero()[:, 0]
        radiance = (ambient + (2.0 * beers * powder * phase[ray_live])[:, None] * sun) \
            * tl[:, None]
        optical = sc.density * t * ss[:, None]            # −log dt, [rays, steps]
        before = torch.cumsum(optical, dim=1) - optical    # Σ_{j<k}
        trans = torch.exp(-before[live])
        dt = torch.exp(-optical[live])
        contrib = trans[:, None] * (radiance - radiance * dt[:, None]) \
            / torch.clamp(tl, min=1e-7)[:, None]
        light = torch.zeros((d.shape[0], 3), dtype=dtype, device=dev)
        light.index_add_(0, ray_live, contrib)
        alpha = torch.clamp(1.0 - torch.exp(-optical.sum(1)), 0.0, 1.0)
        rows = above.nonzero()[:, 0] + r0
        out[rows] = torch.cat([light, alpha[:, None]], dim=-1)
    return out.reshape(shape + (4,))
