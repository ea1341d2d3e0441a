"""Image metrics, the display chain and PNG output (numpy only), as in
`cloudscape_tpu.utils.image`; a tensor on the card is brought to the host
(`.cpu()`) first."""

from __future__ import annotations

import numpy as np


def psnr(a, b, peak: float | None = None) -> float:
    """PSNR in dB. peak defaults to the oracle image's max (HDR images)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0.0:
        return float("inf")
    if peak is None:
        peak = max(float(np.max(np.abs(b))), 1e-12)
    return float(10.0 * np.log10(peak * peak / mse))


def tonemap_aces(x, white: float = 3.53):
    """Filmic-ish tonemap for preview PNGs (the demo scene uses Godot's ACES
    tonemap with white=3.53, `cloud_sky/cloud-demo.tscn:9-10`)."""
    x = np.asarray(x, dtype=np.float64)
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    def f(v):
        return (v * (a * v + b)) / (v * (c * v + d) + e)
    return np.clip(f(x) / f(white), 0.0, 1.0)


def downsample2x(img: np.ndarray) -> np.ndarray:
    """2×2 box downsample of an [H, W, C] frame — the SSAA pattern for this
    engine (a pure ray renderer has no geometry edges for MSAA; the demo
    scene's `project.godot` MSAA maps to: render the view grid at 2× and
    box-filter down). An odd last row or column is dropped."""
    img = np.asarray(img)
    h, w = img.shape[0] & ~1, img.shape[1] & ~1
    img = img[:h, :w]
    return 0.25 * (img[0::2, 0::2] + img[1::2, 0::2]
                   + img[0::2, 1::2] + img[1::2, 1::2])


def srgb_encode(x):
    """Linear → sRGB OETF (Godot converts to sRGB after tonemapping when
    rendering to an 8-bit swapchain; previews must do the same or they come
    out ~2.2-gamma too dark)."""
    x = np.clip(np.asarray(x, dtype=np.float64), 0.0, 1.0)
    return np.where(x <= 0.0031308, 12.92 * x,
                    1.055 * np.power(x, 1.0 / 2.4) - 0.055)


def display_encode(img, white: float = 3.53):
    """The reference demo's display chain for an HDR linear frame: ACES
    tonemap (tonemap_mode=3, tonemap_white=3.53,
    `cloud_sky/cloud-demo.tscn:9-10`; Narkowicz fit as the ACES
    approximation) followed by the sRGB OETF. No per-scene exposure — the
    scene's Environment has none."""
    return srgb_encode(tonemap_aces(img, white=white))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a [H, W, 3] float image in [0,1] as PNG (zlib, no deps)."""
    import struct
    import zlib

    img8 = (np.clip(np.asarray(img), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w = img8.shape[:2]
    if img8.ndim == 2:
        img8 = np.repeat(img8[..., None], 3, axis=-1)
    raw = b"".join(b"\x00" + img8[y].tobytes() for y in range(h))

    def chunk(tag, payload):
        out = struct.pack(">I", len(payload)) + tag + payload
        return out + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    hdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", hdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)
