"""Bilinear texture fetch with GL wrap semantics (torch).

The port of `cloudscape_tpu.ops.sampling.sample2d`: texel centers at
(i + 0.5) / N, filtering coordinate c = uv * N - 0.5, REPEAT wraps integer
taps mod N, CLAMP_TO_EDGE clamps them to [0, N-1]. 2D textures are
[H, W, C] with u→W, v→H. The atmosphere, `ambient_colors` and the composite
use it; the march samples its noise through the brick tables of `ops/brick.py`.
"""

from __future__ import annotations

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
    c00 = flat[iy0 * w + ix0]
    c10 = flat[iy0 * w + ix1]
    c01 = flat[iy1 * w + ix0]
    c11 = flat[iy1 * w + ix1]
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy
