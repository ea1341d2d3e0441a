"""GL texture fetches in plain tensor operations: bilinear and trilinear
taps at texel centers (i + 0.5) / N, REPEAT or CLAMP_TO_EDGE, mip chains
by 2×2×2 box filter, `textureLod` blending the two straddling levels.
Images are [H, W, C] (u → W, v → H), volumes [D, H, W, C] (x → W, y → H,
z → D)."""

from __future__ import annotations

import torch


def _wrap(i, n: int, mode: str):
    return torch.remainder(i, n) if mode == "repeat" else torch.clamp(i, 0, n - 1)


def sample2d(tex, uv, wrap: str = "repeat"):
    """Bilinear fetch; tex [H, W, C], uv [..., 2] → [..., C]."""
    h, w, c = tex.shape
    cx = uv[..., 0] * w - 0.5
    cy = uv[..., 1] * h - 0.5
    fx0 = torch.floor(cx)
    fy0 = torch.floor(cy)
    fx = (cx - fx0)[..., None]
    fy = (cy - fy0)[..., None]
    ix0, iy0 = fx0.to(torch.int64), fy0.to(torch.int64)
    ix1, iy1 = _wrap(ix0 + 1, w, wrap), _wrap(iy0 + 1, h, wrap)
    ix0, iy0 = _wrap(ix0, w, wrap), _wrap(iy0, h, wrap)
    flat = tex.reshape(-1, c)
    c00, c10 = flat[iy0 * w + ix0], flat[iy0 * w + ix1]
    c01, c11 = flat[iy1 * w + ix0], flat[iy1 * w + ix1]
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


def sample3d(tex, p, wrap: str = "repeat"):
    """Trilinear fetch; tex [D, H, W, C], p [..., 3] = (x, y, z) → [..., C]."""
    d, h, w, c = tex.shape
    cs = [p[..., k] * n - 0.5 for k, n in enumerate((w, h, d))]
    f0 = [torch.floor(v) for v in cs]
    fr = [(v - f)[..., None] for v, f in zip(cs, f0)]
    i0 = [f.to(torch.int64) for f in f0]
    lo = [_wrap(i, n, wrap) for i, n in zip(i0, (w, h, d))]
    hi = [_wrap(i + 1, n, wrap) for i, n in zip(i0, (w, h, d))]
    flat = tex.reshape(-1, c)

    def row(iz, iy):
        base = (iz * h + iy) * w
        a, b = flat[base + lo[0]], flat[base + hi[0]]
        return a + (b - a) * fr[0]

    y0 = row(lo[2], lo[1])
    y0 = y0 + (row(lo[2], hi[1]) - y0) * fr[1]
    y1 = row(hi[2], lo[1])
    y1 = y1 + (row(hi[2], hi[1]) - y1) * fr[1]
    return y0 + (y1 - y0) * fr[2]


def pyramid3d(tex):
    """The mip chain of a [D, H, W, C] volume, level 0 first."""
    levels = [tex]
    while min(tex.shape[:3]) > 1:
        d, h, w, c = tex.shape
        tex = tex.reshape(d // 2, 2, h // 2, 2, w // 2, 2, c).mean(dim=(1, 3, 5))
        levels.append(tex)
    return levels


def sample3d_lod(pyr, p, lod: float, wrap: str = "repeat"):
    """`textureLod` with a linear mip filter at a constant lod."""
    lod = min(max(float(lod), 0.0), float(len(pyr) - 1))
    d0 = int(lod)
    f = lod - d0
    lo = sample3d(pyr[d0], p, wrap)
    if f == 0.0:
        return lo
    return lo + (sample3d(pyr[min(d0 + 1, len(pyr) - 1)], p, wrap) - lo) * f
