"""Texture-unit emulation: bilinear/trilinear fetches with mip chains (torch).

The port of `cloudscape_tpu.ops.sampling`, with GL conventions: texel
centers at (i + 0.5) / N, filtering coordinate c = uv * N - 0.5, REPEAT
wraps integer taps mod N, CLAMP_TO_EDGE clamps them to [0, N-1];
`textureLod` clamps its lod to [0, levels - 1] and blends the two
straddling levels. Every lod in the cloud kernel is a static per-call-site
constant, so `lod` here is a Python float. 2D textures are [H, W, C] with
u→W, v→H; 3D textures [D, H, W, C] with p.x→W, p.y→H, p.z→D; a mip
pyramid is a tuple of levels, level 0 first, each halving every spatial
dim by a box filter. Gathers take int64 indices.

The atmosphere, `ambient_colors` and the composite use `sample2d`; the
scan-based reference march (`models/march.py`) samples its noise pyramids
here; the brick marches sample through the tables of `ops/brick.py`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _wrap_idx(i, n: int, mode: str):
    if mode == "repeat":
        return torch.remainder(i, n)
    if mode == "clamp":
        return torch.clamp(i, 0, n - 1)
    raise ValueError(f"unknown wrap mode {mode!r}")


def sample2d(tex, uv, wrap: str = "repeat"):
    """Bilinear 2D fetch. tex: [H, W, C]; uv: [..., 2] → [..., C]."""
    h, w, c = tex.shape
    cx = uv[..., 0] * w - 0.5
    cy = uv[..., 1] * h - 0.5
    ix0 = torch.floor(cx)
    iy0 = torch.floor(cy)
    fx = (cx - ix0)[..., None]
    fy = (cy - iy0)[..., None]
    ix0 = ix0.to(torch.int64)
    iy0 = iy0.to(torch.int64)
    ix1 = _wrap_idx(ix0 + 1, w, wrap)
    iy1 = _wrap_idx(iy0 + 1, h, wrap)
    ix0 = _wrap_idx(ix0, w, wrap)
    iy0 = _wrap_idx(iy0, h, wrap)

    flat = tex.reshape(-1, c)

    def fetch(i):
        # Through a 1-D index: a 0-d index (one uv) would be read back to
        # the host, a wait that no CUDA graph can capture.
        return flat[i.reshape(-1)].reshape(i.shape + (c,))

    c00 = fetch(iy0 * w + ix0)
    c10 = fetch(iy0 * w + ix1)
    c01 = fetch(iy1 * w + ix0)
    c11 = fetch(iy1 * w + ix1)
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


def sample3d(tex, p, wrap: str = "repeat"):
    """Trilinear 3D fetch. tex: [D, H, W, C]; p: [..., 3] (x, y, z) →
    [..., C]: one gather of the 8 corners, lerped in x, then y, then z."""
    d, h, w, c = tex.shape
    cx = p[..., 0] * w - 0.5
    cy = p[..., 1] * h - 0.5
    cz = p[..., 2] * d - 0.5
    ix0 = torch.floor(cx)
    iy0 = torch.floor(cy)
    iz0 = torch.floor(cz)
    fx = (cx - ix0)[..., None]
    fy = (cy - iy0)[..., None]
    fz = (cz - iz0)[..., None]
    ix0 = ix0.to(torch.int64)
    iy0 = iy0.to(torch.int64)
    iz0 = iz0.to(torch.int64)
    ix1 = _wrap_idx(ix0 + 1, w, wrap)
    iy1 = _wrap_idx(iy0 + 1, h, wrap)
    iz1 = _wrap_idx(iz0 + 1, d, wrap)
    ix0 = _wrap_idx(ix0, w, wrap)
    iy0 = _wrap_idx(iy0, h, wrap)
    iz0 = _wrap_idx(iz0, d, wrap)

    base00 = (iz0 * h + iy0) * w
    base01 = (iz0 * h + iy1) * w
    base10 = (iz1 * h + iy0) * w
    base11 = (iz1 * h + iy1) * w
    idx = torch.stack([base00 + ix0, base00 + ix1, base01 + ix0, base01 + ix1,
                       base10 + ix0, base10 + ix1, base11 + ix0, base11 + ix1],
                      dim=-1)
    k = tex.reshape(-1, c)[idx]  # [..., 8, C]
    cx00 = k[..., 0, :] + (k[..., 1, :] - k[..., 0, :]) * fx
    cx01 = k[..., 2, :] + (k[..., 3, :] - k[..., 2, :]) * fx
    cx10 = k[..., 4, :] + (k[..., 5, :] - k[..., 4, :]) * fx
    cx11 = k[..., 6, :] + (k[..., 7, :] - k[..., 6, :]) * fx
    cy0 = cx00 + (cx01 - cx00) * fy
    cy1 = cx10 + (cx11 - cx10) * fy
    return cy0 + (cy1 - cy0) * fz


def build_pyramid3d(tex) -> Tuple[torch.Tensor, ...]:
    """Full mip chain of a [D, H, W, C] volume by 2×2×2 box filter, on the
    volume's own device."""
    levels = [tex]
    while min(tex.shape[:3]) > 1:
        d, h, w, c = tex.shape
        tex = tex.reshape(d // 2, 2, h // 2, 2, w // 2, 2, c).mean(dim=(1, 3, 5))
        levels.append(tex)
    return tuple(levels)


def build_pyramid2d(tex) -> Tuple[torch.Tensor, ...]:
    """Full mip chain of a [H, W, C] image by 2×2 box filter. For parity
    with the JAX API; no march of the port samples a 2-D chain."""
    levels = [tex]
    while min(tex.shape[:2]) > 1:
        h, w, c = tex.shape
        tex = tex.reshape(h // 2, 2, w // 2, 2, c).mean(dim=(1, 3))
        levels.append(tex)
    return tuple(levels)


def _lod_levels(n_levels: int, lod: float):
    """(level, next level, blend) of a static lod clamped to the chain."""
    max_level = n_levels - 1
    lod = min(max(float(lod), 0.0), float(max_level))
    d0 = int(lod)
    return d0, min(d0 + 1, max_level), lod - d0


def sample3d_lod(pyramid: Sequence, p, lod: float, wrap: str = "repeat"):
    """`textureLod` on a 3D mip pyramid with a static lod: one trilinear
    fetch at an integer lod, two blended linearly otherwise."""
    d0, d1, f = _lod_levels(len(pyramid), lod)
    lo = sample3d(pyramid[d0], p, wrap)
    if f == 0.0:
        return lo
    hi = sample3d(pyramid[d1], p, wrap)
    return lo + (hi - lo) * f


def sample2d_lod(pyramid: Sequence, uv, lod: float, wrap: str = "repeat"):
    """`textureLod` on a 2D mip pyramid with a static lod. For parity with
    the JAX API, as `build_pyramid2d`."""
    d0, d1, f = _lod_levels(len(pyramid), lod)
    lo = sample2d(pyramid[d0], uv, wrap)
    if f == 0.0:
        return lo
    hi = sample2d(pyramid[d1], uv, wrap)
    return lo + (hi - lo) * f
