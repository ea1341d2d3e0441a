"""Asset decoding: BMP and TGA readers and Godot-style 3D texture slicing.

The port's own copy of `cloudscape_tpu.utils.assets`, in numpy. The
reference imports its noise textures through Godot's resource importer:
`worlnoise.bmp` (1024×32, 24 bpp) is sliced into a 32³ RGB volume and
`weather.bmp` (512², 24 bpp) stays 2-D (`cloud_sky/worlnoise.bmp.import:28-29`,
`cloud_sky/weather.bmp.import`). Only the Python decoders are here; the JAX
package's optional native (ctypes) decoder is not ported, and its results
are the Python decoder's.
"""

from __future__ import annotations

import struct

import numpy as np


def load_bmp(path: str) -> np.ndarray:
    """Decode an uncompressed 24/32-bpp BMP to float32 [H, W, C] in [0, 1].

    Rows are returned top-down (texture convention: v=0 at the top),
    channels RGB(A). BI_BITFIELDS files are accepted only with the BGR(A)
    masks this decoder assumes; others raise."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    pixel_offset = struct.unpack_from("<I", data, 10)[0]
    header_size = struct.unpack_from("<I", data, 14)[0]
    if header_size < 40:
        raise ValueError(f"{path}: unsupported BMP header size {header_size}")
    width, height = struct.unpack_from("<ii", data, 18)
    bpp = struct.unpack_from("<H", data, 28)[0]
    compression = struct.unpack_from("<I", data, 30)[0]
    if compression not in (0, 3) or bpp not in (24, 32):
        raise ValueError(f"{path}: unsupported BMP (bpp={bpp}, compression={compression})")
    if compression == 3:
        # The masks follow the 40-byte info header (the same offsets in V4
        # and V5 headers); the alpha mask exists only for V3+ headers.
        r_m, g_m, b_m = struct.unpack_from("<III", data, 54)
        a_m = (struct.unpack_from("<I", data, 66)[0]
               if header_size >= 56 and len(data) >= 70 else 0)
        if (r_m, g_m, b_m) != (0x00FF0000, 0x0000FF00, 0x000000FF) or (
                bpp == 32 and a_m not in (0xFF000000, 0)):
            raise ValueError(f"{path}: BI_BITFIELDS masks {(r_m, g_m, b_m, a_m)} "
                             "are not the assumed BGR(A) layout")
    bottom_up = height > 0
    height = abs(height)
    channels = bpp // 8
    stride = (width * channels + 3) & ~3
    rows = np.frombuffer(data, dtype=np.uint8, count=stride * height,
                         offset=pixel_offset).reshape(height, stride)[:, :width * channels]
    img = rows.reshape(height, width, channels)
    if bottom_up:
        img = img[::-1]
    return _to_rgb_float(img)


def _to_rgb_float(img: np.ndarray) -> np.ndarray:
    """BGR(A) uint8 [H, W, C] → RGB(A) float32 in [0, 1]."""
    img = img[..., ::-1] if img.shape[-1] == 3 else img[..., [2, 1, 0, 3]]
    return np.ascontiguousarray(img).astype(np.float32) / 255.0


def load_tga(path: str) -> np.ndarray:
    """Decode an uncompressed (type 2) or RLE (type 10) true-color TGA to
    float32 [H, W, C], top-down."""
    with open(path, "rb") as f:
        data = f.read()
    id_len, cmap_type, img_type = struct.unpack_from("<BBB", data, 0)
    width, height = struct.unpack_from("<HH", data, 12)
    bpp, descriptor = struct.unpack_from("<BB", data, 16)
    if cmap_type != 0 or img_type not in (2, 10) or bpp not in (24, 32):
        raise ValueError(f"{path}: unsupported TGA (type={img_type}, bpp={bpp})")
    channels = bpp // 8
    offset = 18 + id_len
    n_px = width * height
    if img_type == 2:
        px = np.frombuffer(data, dtype=np.uint8, count=n_px * channels,
                           offset=offset).reshape(n_px, channels)
    else:
        px = np.empty((n_px, channels), dtype=np.uint8)
        i, written = offset, 0
        while written < n_px:
            hdr = data[i]
            i += 1
            count = (hdr & 0x7F) + 1
            if hdr & 0x80:  # run-length packet: one pixel, repeated
                px[written:written + count] = np.frombuffer(
                    data, dtype=np.uint8, count=channels, offset=i)
                i += channels
            else:  # raw packet
                px[written:written + count] = np.frombuffer(
                    data, dtype=np.uint8, count=count * channels,
                    offset=i).reshape(count, channels)
                i += count * channels
            written += count
    img = px.reshape(height, width, channels)
    if not descriptor & 0x20:  # origin at the bottom: flip to top-down
        img = img[::-1]
    return _to_rgb_float(img)


def slice_horizontal_3d(img: np.ndarray, slices: int) -> np.ndarray:
    """Godot 3D-texture import: a [H, slices·S, C] strip of horizontal
    slices → a [slices, H, S, C] volume (`worlnoise.bmp.import:28-29`)."""
    h, w, c = img.shape
    s = w // slices
    return np.ascontiguousarray(img.reshape(h, slices, s, c).transpose(1, 0, 2, 3))
