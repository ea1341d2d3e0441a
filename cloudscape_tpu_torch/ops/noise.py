"""Procedural noise: periodic Perlin, Worley, Perlin-Worley, weather (torch).

The port of `cloudscape_tpu.ops.noise`. All generators are tileable (lattice
coordinates wrap at the period), deterministic in (size, seed), and run on
whatever device they are asked for, so the card generates its own noise.

Hashing is the PCG3D mix (Jarzynski & Olano, JCGT 2020) on wrapped uint32
lattice coordinates. torch has no uint32 `+`, `*`, `>>` or `<<` on the CPU,
so the hash is carried in int64 holding values in [0, 2^32) and masked back
to 32 bits after every operation. A product of two 32-bit values can exceed
int64, so `_mul32` multiplies by 16-bit halves: every partial product stays
below 2^48 and the low 32 bits are exact without relying on wrap-around.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mul32(a, b):
    """(a * b) mod 2^32 for int64 tensors (or ints) in [0, 2^32)."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _pcg3d(x, y, z):
    """PCG3D uint32 mix on three int64 planes holding uint32 values."""
    x = (_mul32(x, 1664525) + 1013904223) & _M32
    y = (_mul32(y, 1664525) + 1013904223) & _M32
    z = (_mul32(z, 1664525) + 1013904223) & _M32
    x = (x + _mul32(y, z)) & _M32
    y = (y + _mul32(z, x)) & _M32
    z = (z + _mul32(x, y)) & _M32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = (x + _mul32(y, z)) & _M32
    y = (y + _mul32(z, x)) & _M32
    z = (z + _mul32(x, y)) & _M32
    return x, y, z


def _hash_to_unit(h):
    """uint32 (in int64) → float32 in [0, 1)."""
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _lattice_rand3(cx, cy, cz, period: int, seed: int):
    """Random [0,1)³ per wrapped integer lattice cell (three int planes)."""
    s = (seed * 0x9E3779B9) & _M32
    hx, hy, hz = _pcg3d(*((torch.remainder(c, period).to(torch.int64) + s) & _M32
                          for c in (cx, cy, cz)))
    return _hash_to_unit(hx), _hash_to_unit(hy), _hash_to_unit(hz)


def _lattice_grad3(cx, cy, cz, period: int, seed: int):
    """Quasi-uniform unit gradient per lattice cell."""
    r = [v * 2.0 - 1.0 for v in _lattice_rand3(cx, cy, cz, period, seed)]
    n = torch.clamp(torch.sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2]),
                    min=1e-5)
    return r[0] / n, r[1] / n, r[2] / n


def _fade(t):
    """Perlin quintic fade t³(6t²-15t+10)."""
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin3(p, period: int, seed: int = 0):
    """Periodic 3D Perlin gradient noise, p: [..., 3] in lattice units.
    Returns [...] roughly in [-1, 1]."""
    pi = torch.floor(p)
    pf = p - pi
    pi = pi.to(torch.int32)
    u = _fade(pf)
    total = None
    for cz in (0, 1):
        for cy in (0, 1):
            for cx in (0, 1):
                gx, gy, gz = _lattice_grad3(pi[..., 0] + cx, pi[..., 1] + cy,
                                            pi[..., 2] + cz, period, seed)
                v = (gx * (pf[..., 0] - float(cx)) + gy * (pf[..., 1] - float(cy))
                     + gz * (pf[..., 2] - float(cz)))
                w = ((u[..., 0] if cx else (1.0 - u[..., 0]))
                     * (u[..., 1] if cy else (1.0 - u[..., 1]))
                     * (u[..., 2] if cz else (1.0 - u[..., 2])))
                total = v * w if total is None else total + v * w
    return total


def perlin_fbm3(p, base_period: int, octaves: int, seed: int = 0,
                persistence: float = 0.5):
    """Periodic Perlin FBM; p in [0,1)³; returns [...] roughly in [-1, 1]."""
    acc = None
    amp = 1.0
    norm = 0.0
    freq = base_period
    for o in range(octaves):
        v = perlin3(p * float(freq), freq, seed=seed * 31 + o) * amp
        acc = v if acc is None else acc + v
        norm += amp
        amp *= persistence
        freq *= 2
    return acc / norm


def worley3(p, period: int, seed: int = 0):
    """Periodic 3D Worley noise, inverted: 1 at feature points, 0 far away.
    p: [..., 3] in [0,1)³; one feature point per lattice cell."""
    q = p * float(period)
    qi = torch.floor(q).to(torch.int32)
    qf = q - torch.floor(q)
    min_d2 = None
    for cz in (-1, 0, 1):
        for cy in (-1, 0, 1):
            for cx in (-1, 0, 1):
                fx, fy, fz = _lattice_rand3(qi[..., 0] + cx, qi[..., 1] + cy,
                                            qi[..., 2] + cz, period, seed)
                dx = fx + float(cx) - qf[..., 0]
                dy = fy + float(cy) - qf[..., 1]
                dz = fz + float(cz) - qf[..., 2]
                d2 = dx * dx + dy * dy + dz * dz
                min_d2 = d2 if min_d2 is None else torch.minimum(min_d2, d2)
    return 1.0 - torch.clamp(torch.sqrt(min_d2), max=1.0)


def worley_fbm3(p, base_period: int, seed: int = 0):
    """Three-octave Worley FBM with the Schneider weights (`clouds.glsl:118,133`)."""
    return (worley3(p, base_period, seed) * 0.625
            + worley3(p, base_period * 2, seed + 7) * 0.25
            + worley3(p, base_period * 4, seed + 13) * 0.125)


def _remap(v, lo, hi, nlo, nhi):
    return nlo + ((v - lo) / (hi - lo)) * (nhi - nlo)


def _grid3(n: int, device):
    """Texel-center sample grid [n, n, n, 3] in [0,1)³ (x, y, z order)."""
    c = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n
    z, y, x = torch.meshgrid(c, c, c, indexing="ij")
    return torch.stack([x, y, z], dim=-1)


def generate_base_noise(size: int = 128, seed: int = 0, device=None):
    """The Perlin-Worley base volume, [size, size, size, 4] float32 in [0,1]:
    R = Perlin FBM dilated by low-frequency Worley, G/B/A = Worley FBM at
    rising frequencies."""
    p = _grid3(size, device)
    pfbm = perlin_fbm3(p, base_period=4, octaves=7, seed=seed) * 0.5 + 0.5
    pfbm = torch.clamp(_remap(pfbm, 0.32, 0.68, 0.0, 1.0), 0.0, 1.0)
    wlow = worley_fbm3(p, 4, seed=seed + 101)
    raw = _remap(pfbm, wlow - 1.0, 1.0, 0.0, 1.0)
    r = torch.clamp(_remap(raw, 0.45, 0.95, 0.0, 1.0), 0.0, 1.0)
    g = worley_fbm3(p, 8, seed=seed + 211)
    b = worley_fbm3(p, 16, seed=seed + 307)
    a = worley_fbm3(p, 32, seed=seed + 401)
    return torch.stack([r, g, b, a], dim=-1)


def generate_detail_noise(size: int = 32, seed: int = 0, device=None):
    """Worley detail volume, [size, size, size, 3] float32 in [0,1]: three
    Worley octaves at rising frequency."""
    p = _grid3(size, device)
    return torch.stack([worley3(p, 2, seed=seed + 17),
                        worley3(p, 4, seed=seed + 23),
                        worley3(p, 8, seed=seed + 29)], dim=-1)


def generate_weather(size: int = 512, seed: int = 0, device=None):
    """Procedural weather map, [size, size, 3] float32 in [0,1]:
    R = cloud type, G = spare FBM field, B = coverage."""
    c = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) / size
    y, x = torch.meshgrid(c, c, indexing="ij")
    p = torch.stack([x, y, torch.full_like(x, 0.37)], dim=-1)
    cloud_type = perlin_fbm3(p, base_period=3, octaves=4, seed=seed + 5) * 0.5 + 0.5
    spare = perlin_fbm3(p, base_period=6, octaves=4, seed=seed + 11) * 0.5 + 0.5
    coverage_raw = perlin_fbm3(p, base_period=4, octaves=5, seed=seed + 3) * 0.5 + 0.5
    t = torch.clamp((coverage_raw - 0.35) / (0.85 - 0.35), 0.0, 1.0)
    coverage = t * t * (3.0 - 2.0 * t)
    return torch.stack([cloud_type, spare, coverage], dim=-1)
