"""What the benchmark hands the program and the reference alike: the noise
textures, the direction grids, and the scene snapshots that the engine's
wind integration and sun pickup give at a time.

The noise generators are a frozen copy of the periodic Perlin-Worley
generators that the engine's procedural pack uses (PCG3D lattice hashes:
tileable, deterministic in size and seed), run in eager tensor
operations on the device that makes them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from skybench.reference.clouds import Scene

_M32 = 0xFFFFFFFF


def _mul32(a, b):
    """(a * b) mod 2^32 for int64 values in [0, 2^32), by 16-bit halves."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _pcg3d(x, y, z):
    x = (_mul32(x, 1664525) + 1013904223) & _M32
    y = (_mul32(y, 1664525) + 1013904223) & _M32
    z = (_mul32(z, 1664525) + 1013904223) & _M32
    x = (x + _mul32(y, z)) & _M32
    y = (y + _mul32(z, x)) & _M32
    z = (z + _mul32(x, y)) & _M32
    x, y, z = x ^ (x >> 16), y ^ (y >> 16), z ^ (z >> 16)
    x = (x + _mul32(y, z)) & _M32
    y = (y + _mul32(z, x)) & _M32
    z = (z + _mul32(x, y)) & _M32
    return x, y, z


def _unit(h):
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _lattice(cx, cy, cz, period: int, seed: int):
    s = (seed * 0x9E3779B9) & _M32
    h = _pcg3d(*((torch.remainder(c, period).to(torch.int64) + s) & _M32
                 for c in (cx, cy, cz)))
    return tuple(_unit(v) for v in h)


def _perlin(p, period: int, seed: int):
    pi = torch.floor(p)
    pf = p - pi
    pi = pi.to(torch.int32)
    u = pf * pf * pf * (pf * (pf * 6.0 - 15.0) + 10.0)
    total = None
    for cz in (0, 1):
        for cy in (0, 1):
            for cx in (0, 1):
                r = [v * 2.0 - 1.0 for v in _lattice(pi[..., 0] + cx, pi[..., 1] + cy,
                                                     pi[..., 2] + cz, period, seed)]
                n = torch.clamp(torch.sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2]),
                                min=1e-5)
                v = (r[0] / n * (pf[..., 0] - float(cx)) + r[1] / n * (pf[..., 1] - float(cy))
                     + r[2] / n * (pf[..., 2] - float(cz)))
                w = ((u[..., 0] if cx else 1.0 - u[..., 0])
                     * (u[..., 1] if cy else 1.0 - u[..., 1])
                     * (u[..., 2] if cz else 1.0 - u[..., 2]))
                total = v * w if total is None else total + v * w
    return total


def _perlin_fbm(p, base_period: int, octaves: int, seed: int):
    acc, amp, norm, freq = None, 1.0, 0.0, base_period
    for o in range(octaves):
        v = _perlin(p * float(freq), freq, seed * 31 + o) * amp
        acc = v if acc is None else acc + v
        norm += amp
        amp *= 0.5
        freq *= 2
    return acc / norm


def _worley(p, period: int, seed: int):
    q = p * float(period)
    qi = torch.floor(q).to(torch.int32)
    qf = q - torch.floor(q)
    best = None
    for cz in (-1, 0, 1):
        for cy in (-1, 0, 1):
            for cx in (-1, 0, 1):
                fx, fy, fz = _lattice(qi[..., 0] + cx, qi[..., 1] + cy, qi[..., 2] + cz,
                                      period, seed)
                dx = fx + float(cx) - qf[..., 0]
                dy = fy + float(cy) - qf[..., 1]
                dz = fz + float(cz) - qf[..., 2]
                d2 = dx * dx + dy * dy + dz * dz
                best = d2 if best is None else torch.minimum(best, d2)
    return 1.0 - torch.clamp(torch.sqrt(best), max=1.0)


def _worley_fbm(p, base_period: int, seed: int):
    return (_worley(p, base_period, seed) * 0.625
            + _worley(p, base_period * 2, seed + 7) * 0.25
            + _worley(p, base_period * 4, seed + 13) * 0.125)


def _remap(v, lo, hi, nlo, nhi):
    return nlo + ((v - lo) / (hi - lo)) * (nhi - nlo)


def _grid3(n: int, device):
    c = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n
    z, y, x = torch.meshgrid(c, c, c, indexing="ij")
    return torch.stack([x, y, z], dim=-1)


def noise_textures(seed: int, base: int, detail: int, weather: int, device):
    """(base [b, b, b, 4], detail [d, d, d, 3], weather [w, w, 3]) float32
    textures in [0, 1] on `device`: the Perlin-Worley base volume, the
    Worley detail volume and the weather map (R cloud type, B coverage)."""
    p = _grid3(base, device)
    pf = torch.clamp(_remap(_perlin_fbm(p, 4, 7, seed) * 0.5 + 0.5, 0.32, 0.68, 0.0, 1.0),
                     0.0, 1.0)
    raw = _remap(pf, _worley_fbm(p, 4, seed + 101) - 1.0, 1.0, 0.0, 1.0)
    large = torch.stack([torch.clamp(_remap(raw, 0.45, 0.95, 0.0, 1.0), 0.0, 1.0),
                         _worley_fbm(p, 8, seed + 211), _worley_fbm(p, 16, seed + 307),
                         _worley_fbm(p, 32, seed + 401)], dim=-1)
    del p, pf, raw
    q = _grid3(detail, device)
    small = torch.stack([_worley(q, 2, seed + 17), _worley(q, 4, seed + 23),
                         _worley(q, 8, seed + 29)], dim=-1)
    c = (torch.arange(weather, dtype=torch.float32, device=device) + 0.5) / weather
    y, x = torch.meshgrid(c, c, indexing="ij")
    pw = torch.stack([x, y, torch.full_like(x, 0.37)], dim=-1)
    t = torch.clamp((_perlin_fbm(pw, 4, 5, seed + 3) * 0.5 + 0.5 - 0.35) / 0.5, 0.0, 1.0)
    w = torch.stack([_perlin_fbm(pw, 3, 4, seed + 5) * 0.5 + 0.5,
                     _perlin_fbm(pw, 6, 4, seed + 11) * 0.5 + 0.5,
                     t * t * (3.0 - 2.0 * t)], dim=-1)
    return large, small, w


def config_noise(cfg: dict, device):
    """The noise textures a configuration file names (`noise`: seed and sizes)."""
    n = cfg["noise"]
    return noise_textures(n["seed"], n["base"], n["detail"], n["weather"], device)


def camera_views(width: int, height: int, yaws_deg, device) -> torch.Tensor:
    """[len(yaws), height, width, 3] float32 view directions of a pinhole
    camera (~80° horizontal field) that looks 14° above the horizon,
    turned by each yaw about the vertical axis, made on `device` at once."""
    xs = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) / width * 2.0 - 1.0
    ys = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) / height * 2.0 - 1.0
    x = (xs[None, :] * 0.84).expand(height, width)
    y = (-ys[:, None] * 0.47 + 0.25).expand(height, width)
    z = -torch.ones((height, width), dtype=torch.float32, device=device)
    d = torch.stack([x, y, z], dim=-1)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    yaw = torch.deg2rad(torch.tensor(list(yaws_deg), dtype=torch.float32,
                                     device=device))[:, None, None]
    c, s = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([c * d[..., 0] + s * d[..., 2], d[..., 1].expand_as(c * d[..., 0]),
                        -s * d[..., 0] + c * d[..., 2]], dim=-1).contiguous()


def sun_direction(elevation_deg: float, azimuth_deg: float) -> tuple:
    """The world (y-up) unit vector toward a sun at that elevation and azimuth."""
    el, az = math.radians(elevation_deg), math.radians(azimuth_deg)
    return (math.cos(el) * math.cos(az), math.sin(el), math.cos(el) * math.sin(az))


class WindState:
    """The engine's per-snapshot wind integration (`cloud_sky.gd:175-185`),
    kept as the harness's own model: each integration at time `now` adds
    the elapsed time along the wind to the three scroll offsets, in the
    same float64 order (the mixes leave the weather's `time_offset` at 0)."""

    def __init__(self, wind_direction_rad: float, wind_speed: float):
        w = np.array([np.cos(wind_direction_rad), np.sin(wind_direction_rad)])
        self.w = w / np.linalg.norm(w)
        self.speed = float(wind_speed)
        self.time = 0.0
        self.cloud_pos = np.zeros(2)
        self.detailed_pos = np.zeros(2)
        self.weather_pos = np.zeros(2)

    def integrate(self, now: float) -> None:
        delta = now - self.time
        delta2 = delta * 0.001
        self.time = now
        self.detailed_pos = self.detailed_pos + delta * self.w
        self.cloud_pos = self.cloud_pos + delta * self.w * self.speed
        self.weather_pos = self.weather_pos + delta2 * self.w * self.speed


def snapshot(wind: WindState, sun, *, density: float, coverage: float,
             ground_color) -> Scene:
    """The kernel inputs of a snapshot, rounded to float32 as the push
    constants are."""
    def f32(v):
        a = np.asarray(v, np.float32).astype(np.float64)
        return float(a) if a.ndim == 0 else tuple(a.tolist())

    d = np.asarray(sun, np.float64)
    return Scene(cloud_pos=f32(wind.cloud_pos), detailed_pos=f32(wind.detailed_pos),
                 weather_pos=f32(wind.weather_pos), time=f32(wind.time),
                 density=f32(density), cloud_coverage=f32(coverage),
                 light_direction=f32(d / np.linalg.norm(d)), light_energy=1.0,
                 light_color=(1.0, 1.0, 1.0), ground_color=f32(ground_color))
