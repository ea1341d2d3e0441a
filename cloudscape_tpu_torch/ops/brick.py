"""The engine's sampled tables: channel-last textures, and the brick-row
tables of `cloudscape_tpu.ops.brick` (torch port).

The engine's 3-D and 2-D tables are channel-last textures (`Texture3D`
[D, H, W, C], `Texture2D` [H, W, C], contiguous): the noise mips, weather,
the cone cache, the baked field and the display pairs. Volumes that fit
one row (≤ 128 values) are kept whole (`TinyVolume3D`).

The JAX package reshapes each texture into a table of 128-lane bricks,
which the public `build_brick*` / `sample_brick*` API here still builds
and samples, as JAX's layout:

- 3D, 2 channels:  4×4×4 texels × 2ch  = 128 lanes, brick stride 3
- 3D, 1 channel :  8×4×4 texels × 1ch  = 128 lanes, strides (7, 3, 3)
- 2D, 2 channels:  8×8 texels   × 2ch  = 128 lanes, brick stride 7
- 2D, 8 channels:  4×4 texels   × 8ch  = 128 lanes, brick stride 3 (the
  display pair tables of the fused serving tick, clamp wrap)

Brick stride ≤ brick_dim - 1 keeps any trilinear/bilinear footprint inside
one brick, so a filtered sample reads one brick row. A texture's sample
equals the brick table's of the same channel count bitwise: it rounds its
hat weights at the lane its texel would have in that table
(`WEIGHT_STRIDES`).

The samplers dispatch on the coordinates' device:

- a CUDA tensor launches a hand-written kernel of `csrc/sample.cu` on the
  whole plane — K7 `sample_tex3_xyz` (and `sample_brick3_xyz`), K8
  `sample_tex2_xy` (and `sample_brick2_xy`), K9 `sample_tiny3_xyz` —
  which reads only the 8 (4 in 2-D) texels that carry weight, or raises
  (also for a channel count or table type that no main-path table has:
  `KERNEL_KINDS`); `launches` counts the launches per kernel, `samples`
  the samples they were given and `sizes` the launches by sample count;
- a CPU tensor takes the plain version: for a texture and a tiny volume
  the 8-corner (4 in 2-D) gather and weighted sum, in the kernel's order;
  for a brick table the JAX package's lane-weight form, which gathers each
  sample's whole row, weighs every lane with hat weights and sums them. A 96² tile at
  128 steps is 1.18 M samples, so both run in chunks of `SAMPLE_CHUNK`
  samples to bound what they materialise.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import itertools
import math
from typing import Tuple

import torch

from cloudscape_tpu_torch.ops import _cuda

SAMPLE_CHUNK = 1 << 18

# Each kernel's launches, the samples those launches were given, and the
# launches by their sample count (n → launches).
launches = {"tex3": 0, "tex2": 0, "brick3": 0, "brick2": 0, "tiny3": 0}
samples = {"tex3": 0, "tex2": 0, "brick3": 0, "brick2": 0, "tiny3": 0}
sizes = {k: collections.Counter() for k in launches}

# The (channels, table dtype) pairs csrc/sample.cu compiles: those of the
# tables the marches, the baked field and the composite sample (the noise
# mips, optionally bfloat16, the cone cache and the field through K7 and K9;
# weather and the display pairs through K8). A CUDA call on another pair
# raises.
_F32, _BF16 = torch.float32, torch.bfloat16
KERNEL_KINDS = {
    "tex3": frozenset({(1, _F32), (2, _F32), (1, _BF16), (2, _BF16)}),
    "tex2": frozenset({(2, _F32), (8, _F32)}),
    "brick3": frozenset({(1, _F32), (2, _F32), (1, _BF16), (2, _BF16)}),
    "brick2": frozenset({(2, _F32), (8, _F32)}),
    "tiny3": frozenset({(1, _F32), (2, _F32), (1, _BF16), (2, _BF16)}),
}


@dataclasses.dataclass(frozen=True)
class BrickTable3D:
    """[n_bricks, lanes] table of 3D bricks. Lane order: channel-major
    blocks of (z*by + y)*bx + x."""

    table: torch.Tensor
    dims: Tuple[int, int, int]  # (D, H, W)
    brick: Tuple[int, int, int] = (4, 4, 4)  # (bz, by, bx)
    stride: Tuple[int, int, int] = (3, 3, 3)
    grid: Tuple[int, int, int] = (0, 0, 0)  # brick counts
    channels: int = 2
    wrap: str = "repeat"  # "repeat" | "clamp"


@dataclasses.dataclass(frozen=True)
class BrickTable2D:
    table: torch.Tensor
    dims: Tuple[int, int]  # (H, W)
    brick: Tuple[int, int] = (8, 8)  # (by, bx)
    stride: Tuple[int, int] = (7, 7)
    grid: Tuple[int, int] = (0, 0)
    channels: int = 2
    wrap: str = "repeat"


@dataclasses.dataclass(frozen=True)
class TinyVolume3D:
    """A whole ≤1-row volume as a flat row [C*D*H*W], channel-major."""

    row: torch.Tensor
    dims: Tuple[int, int, int]
    channels: int = 1


# The brick strides of the JAX package's table of each (ndim, channels):
# a texture rounds its hat weights at the lane its texel has there, a =
# float(i0 mod s) + f, so that its samples equal that table's bitwise (and
# JAX's within a few ulps). The kernels take them in their geometry.
WEIGHT_STRIDES = {(3, 1): (7, 3, 3), (3, 2): (3, 3, 3), (2, 2): (7, 7), (2, 8): (3, 3)}


def weight_strides(ndim: int, channels: int):
    """`WEIGHT_STRIDES` of a texture of `ndim` dims and `channels`; raises
    for a channel count that no table of the JAX package has."""
    try:
        return WEIGHT_STRIDES[(ndim, channels)]
    except KeyError:
        raise ValueError(f"no kernel for a {ndim}-D texture of {channels} channels; "
                         f"it has {sorted(WEIGHT_STRIDES)}") from None


@dataclasses.dataclass(frozen=True)
class Texture3D:
    """A contiguous channel-last volume [D, H, W, C]."""

    texels: torch.Tensor
    dims: Tuple[int, int, int]  # (D, H, W)
    channels: int = 2
    wrap: str = "repeat"  # "repeat" | "clamp"


@dataclasses.dataclass(frozen=True)
class Texture2D:
    """A contiguous channel-last image [H, W, C]."""

    texels: torch.Tensor
    dims: Tuple[int, int]  # (H, W)
    channels: int = 2
    wrap: str = "repeat"


def _texels(src):
    """`src` contiguous and 16-B aligned (the kernels' vector loads): the
    source itself where it already is, else a copy."""
    t = src.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def build_texture3(volume, wrap: str = "repeat") -> Texture3D:
    """volume: [D, H, W, C] tensor → its texture, on the volume's device
    (no gather: the volume itself where it is contiguous and aligned)."""
    d, h, w, c = volume.shape
    return Texture3D(texels=_texels(volume), dims=(d, h, w), channels=c, wrap=wrap)


def build_texture2(image, wrap: str = "repeat") -> Texture2D:
    """image: [H, W, C] tensor → its texture (as `build_texture3`)."""
    h, w, c = image.shape
    return Texture2D(texels=_texels(image), dims=(h, w), channels=c, wrap=wrap)


def _cdiv(a, b):
    return -(-a // b)


def brick3_grid(dims, stride=(3, 3, 3)):
    """Brick-grid shape (nz, ny, nx) of a volume of `dims`."""
    return tuple(_cdiv(d, s) for d, s in zip(dims, stride))


def _brick_idx(start, s: int, b: int, n: int, wrap: str):
    """Texel indices [len(start), b] of bricks starting at start*s."""
    i = start[:, None] * s + torch.arange(b, device=start.device)[None, :]
    return torch.clamp(i, 0, n - 1) if wrap == "clamp" else torch.remainder(i, n)


def build_brick3(volume, brick=(4, 4, 4), stride=(3, 3, 3),
                 wrap: str = "repeat") -> BrickTable3D:
    """volume: [D, H, W, C] float32 tensor → its brick table, on the
    volume's device. `wrap` fills texels past the edge by "repeat" (mod) or
    "clamp" (edge)."""
    d, h, w, c = volume.shape
    bz, by, bx = brick
    sz, sy, sx = stride
    assert sz <= bz - 1 and sy <= by - 1 and sx <= bx - 1
    nz, ny, nx = brick3_grid((d, h, w), stride)
    dev = volume.device
    zz = _brick_idx(torch.arange(nz, device=dev), sz, bz, d, wrap)
    yy = _brick_idx(torch.arange(ny, device=dev), sy, by, h, wrap)
    xx = _brick_idx(torch.arange(nx, device=dev), sx, bx, w, wrap)
    bricks = volume[zz[:, None, None, :, None, None],
                    yy[None, :, None, None, :, None],
                    xx[None, None, :, None, None, :]]  # [nz,ny,nx,bz,by,bx,c]
    lanes = bricks.permute(0, 1, 2, 6, 3, 4, 5).reshape(nz * ny * nx,
                                                        c * bz * by * bx)
    return BrickTable3D(table=lanes.contiguous(), dims=(d, h, w), brick=brick,
                        stride=stride, grid=(nz, ny, nx), channels=c, wrap=wrap)


# The JAX package's device-side builder (`build_brick3_device`) is the same
# gather; `build_brick3` already runs on the volume's device.
build_brick3_device = build_brick3


def build_brick3_rows(volume, b0: int, count: int, brick=(4, 4, 4),
                      stride=(3, 3, 3), wrap: str = "repeat"):
    """Rows [b0, b0 + count) of `build_brick3`'s table — the sliceable form
    the JAX engine uses to spread the cone-table build over ticks (the
    port's cone cache is a texture). Writing every row range reproduces the
    whole table. Needs b0 + count ≤ n_bricks."""
    d, h, w, c = volume.shape
    bz, by, bx = brick
    sz, sy, sx = stride
    nz, ny, nx = brick3_grid((d, h, w), stride)
    bi = b0 + torch.arange(count, device=volume.device)
    zz = _brick_idx(bi // (ny * nx), sz, bz, d, wrap)
    yy = _brick_idx((bi // nx) % ny, sy, by, h, wrap)
    xx = _brick_idx(bi % nx, sx, bx, w, wrap)
    rows = volume[zz[:, :, None, None], yy[:, None, :, None],
                  xx[:, None, None, :]]  # [count, bz, by, bx, c]
    return rows.permute(0, 4, 1, 2, 3).reshape(count, c * bz * by * bx)


def build_brick2(image, brick=(8, 8), stride=(7, 7),
                 wrap: str = "repeat") -> BrickTable2D:
    """image: [H, W, C] float32 tensor → its 2D brick table."""
    h, w, c = image.shape
    by, bx = brick
    sy, sx = stride
    assert sy <= by - 1 and sx <= bx - 1
    ny, nx = _cdiv(h, sy), _cdiv(w, sx)
    dev = image.device
    yy = _brick_idx(torch.arange(ny, device=dev), sy, by, h, wrap)
    xx = _brick_idx(torch.arange(nx, device=dev), sx, bx, w, wrap)
    bricks = image[yy[:, None, :, None], xx[None, :, None, :]]  # [ny,nx,by,bx,c]
    lanes = bricks.permute(0, 1, 4, 2, 3).reshape(ny * nx, c * by * bx)
    return BrickTable2D(table=lanes.contiguous(), dims=(h, w), brick=brick,
                        stride=stride, grid=(ny, nx), channels=c, wrap=wrap)


# The JAX package's device-side builder (`build_brick2_device`) is the same
# gather; `build_brick2` already runs on the image's device.
build_brick2_device = build_brick2


def build_tiny3(volume) -> TinyVolume3D:
    d, h, w, c = volume.shape
    return TinyVolume3D(row=volume.permute(3, 0, 1, 2).reshape(-1).contiguous(),
                        dims=(d, h, w), channels=c)


def _axis_coords(q, n: int, wrap: str = "repeat"):
    """GL filtering coords for one axis: (cell i0 [int64], fraction)."""
    cx = q * n - 0.5
    i0f = torch.floor(cx)
    f = cx - i0f
    i0 = i0f.to(torch.int64)
    if wrap == "clamp":
        f = torch.where(i0 < 0, 0.0, torch.where(i0 > n - 2, 1.0, f))
        i0 = torch.clamp(i0, 0, max(n - 2, 0))
    else:
        i0 = torch.remainder(i0, n)
    return i0, f


def _axis_weight(local0, frac, length: int):
    """[m, length] hat weights max(0, 1 - |local0 + f - lane|): (1-f) at
    local0, f at local0 + 1, 0 elsewhere."""
    a = local0.to(torch.float32) + frac
    lanes = torch.arange(length, device=a.device, dtype=torch.float32)
    return torch.clamp(1.0 - torch.abs(a[:, None] - lanes[None, :]), min=0.0)


def _chunked(fn, *planes):
    """Apply fn to flattened sample planes in SAMPLE_CHUNK pieces; returns
    [..., C] in the planes' shape."""
    shape = planes[0].shape
    flat = [p.reshape(-1) for p in planes]
    n = flat[0].shape[0]
    outs = [fn(*(p[i:i + SAMPLE_CHUNK] for p in flat))
            for i in range(0, n, SAMPLE_CHUNK)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
    return out.reshape(shape + out.shape[-1:])


def _texel_axis(q, n: int, wrap: str, s: int):
    """One texture axis: texels (i0, i0 + 1; past the edge n - 1 under
    clamp, 0 under repeat) and hat weights at lanes i0 mod s and its next,
    as csrc/sample.cu's `tex_axis`."""
    i0, f = _axis_coords(q, n, wrap)
    i1 = torch.where(i0 + 1 < n, i0 + 1, n - 1 if wrap == "clamp" else 0)
    lf = (i0 % s).to(torch.float32)
    a = lf + f
    w0 = torch.clamp(1.0 - torch.abs(a - lf), min=0.0)
    w1 = torch.clamp(1.0 - torch.abs(a - (lf + 1.0)), min=0.0)
    return (i0, i1), (w0, w1)


def _weigh_texels(texels, channels: int, axes):
    """Σ over corners (outer axis first) of (Π weights)·texel, summed from 0
    in corner order, per channel → [m, C] float32. axes: per axis from the
    outermost, ((i0, i1), (w0, w1), the texel stride of that axis)."""
    flat = texels.reshape(-1, channels)
    m = axes[0][0][0].shape[0]
    acc = torch.zeros((m, channels), dtype=torch.float32, device=flat.device)
    for corner in itertools.product((0, 1), repeat=len(axes)):
        # ((wx·wy)·wz): the innermost axis's weight first.
        wk, off = None, 0
        for (idx, wts, stride), dk in zip(reversed(axes), reversed(corner)):
            wk = wts[dk] if wk is None else wk * wts[dk]
            off = off + idx[dk] * stride
        acc = acc + wk[:, None] * flat[off].to(torch.float32)
    return acc


def sample_tex3_xyz_reference(tex: Texture3D, qx, qy, qz):
    """Plain version of K7 on a texture: the 8 corners gathered, weighed
    and summed in the kernel's order and rounding, in chunks."""
    d, h, w = tex.dims
    sz, sy, sx = weight_strides(3, tex.channels)

    def chunk(qx, qy, qz):
        return _weigh_texels(tex.texels, tex.channels, (
            (*_texel_axis(qz, d, tex.wrap, sz), h * w),
            (*_texel_axis(qy, h, tex.wrap, sy), w),
            (*_texel_axis(qx, w, tex.wrap, sx), 1)))

    return _chunked(chunk, qx, qy, qz)


def sample_tex2_xy_reference(tex: Texture2D, qu, qv):
    """Plain version of K8 on a texture: the 4 corners, as K7's."""
    h, w = tex.dims
    sy, sx = weight_strides(2, tex.channels)

    def chunk(qu, qv):
        return _weigh_texels(tex.texels, tex.channels, (
            (*_texel_axis(qv, h, tex.wrap, sy), w),
            (*_texel_axis(qu, w, tex.wrap, sx), 1)))

    return _chunked(chunk, qu, qv)


def sample_brick3_xyz_reference(bt: BrickTable3D, qx, qy, qz):
    """Plain version of K7: the lane-weight form, in chunks."""
    d, h, w = bt.dims
    bz, by, bx = bt.brick
    sz, sy, sx = bt.stride
    nz, ny, nx = bt.grid
    L = bz * by * bx

    def chunk(qx, qy, qz):
        ix0, fx = _axis_coords(qx, w, bt.wrap)
        iy0, fy = _axis_coords(qy, h, bt.wrap)
        iz0, fz = _axis_coords(qz, d, bt.wrap)
        fb = ((iz0 // sz) * ny + iy0 // sy) * nx + ix0 // sx
        rows = bt.table[fb].reshape(-1, bt.channels, L)
        wx = _axis_weight(ix0 % sx, fx, bx)
        wy = _axis_weight(iy0 % sy, fy, by)
        wz = _axis_weight(iz0 % sz, fz, bz)
        wgt = (wx[:, None, None, :] * wy[:, None, :, None]) * wz[:, :, None, None]
        return torch.sum(rows * wgt.reshape(-1, 1, L), dim=-1)

    return _chunked(chunk, qx, qy, qz)


def sample_brick2_xy_reference(bt: BrickTable2D, qu, qv):
    """Plain version of K8: the lane-weight form, in chunks."""
    h, w = bt.dims
    by, bx = bt.brick
    sy, sx = bt.stride
    ny, nx = bt.grid
    L = by * bx

    def chunk(qu, qv):
        ix0, fx = _axis_coords(qu, w, bt.wrap)
        iy0, fy = _axis_coords(qv, h, bt.wrap)
        fb = (iy0 // sy) * nx + ix0 // sx
        rows = bt.table[fb].reshape(-1, bt.channels, L)
        wgt = _axis_weight(ix0 % sx, fx, bx)[:, None, :] \
            * _axis_weight(iy0 % sy, fy, by)[:, :, None]
        return torch.sum(rows * wgt.reshape(-1, 1, L), dim=-1)

    return _chunked(chunk, qu, qv)


def _tiny_axis(q, n: int):
    """One axis of a tiny volume, as csrc/sample.cu's `tiny_axis`: lanes i0
    and (i0 + 1) mod n, weights 1 − f and f; an n = 1 axis reads lane 0
    twice, weighing (1 − f) + f and 0."""
    i0, f = _axis_coords(q, n)
    i1 = torch.remainder(i0 + 1, n)
    if n == 1:
        return (i0, i1), ((1.0 - f) + f, torch.zeros_like(f))
    return (i0, i1), (1.0 - f, f)


def sample_tiny3_xyz_reference(tv: TinyVolume3D, qx, qy, qz):
    """Plain version of K9: the 8 corners gathered, weighed and summed in
    the kernel's order and rounding, in chunks."""
    d, h, w = tv.dims
    texels = tv.row.reshape(tv.channels, d * h * w).t()  # [L, C], a view

    def chunk(qx, qy, qz):
        return _weigh_texels(texels, tv.channels, (
            (*_tiny_axis(qz, d), h * w),
            (*_tiny_axis(qy, h), w),
            (*_tiny_axis(qx, w), 1)))

    return _chunked(chunk, qx, qy, qz)


def kernel_args(name: str, table, values: int, geom, channels: int, planes):
    """(output, arguments, planes) of one sampler kernel call: the output
    [..., C] float32, allocated; the C entry's arguments but the stream
    (table, bfloat16 flag, geometry, each plane's address, output,
    samples); and the contiguous planes they point into, to be held until
    the launch (a copied view lives only there). Checks the inputs against
    `KERNEL_KINDS[name]`; `values`: the table's element count that `geom`
    implies."""
    what = f"sample_{name}"
    dev = planes[0].device
    if table.device != dev:
        raise ValueError(f"{what}: table on {table.device}, coordinates on {dev}")
    if not table.is_contiguous() or table.numel() != values:
        raise ValueError(f"{what}: table must be contiguous with {values} values, "
                         f"got {table.numel()}")
    if name.startswith("tex") and table.data_ptr() % 16:
        raise ValueError(f"{what}: texels must be 16-byte aligned (vector loads)")
    if (channels, table.dtype) not in KERNEL_KINDS[name]:
        raise ValueError(f"{what}: no kernel for {channels} channels of "
                         f"{table.dtype}; it has {sorted(map(str, KERNEL_KINDS[name]))}")
    n = planes[0].numel()
    for p in planes:
        if p.device != dev:
            raise ValueError(f"{what}: coordinates on {p.device} and {dev}")
        if p.dtype != torch.float32:
            raise ValueError(f"{what}: coordinates must be float32, got {p.dtype}")
        if p.numel() != n:
            raise ValueError(f"{what}: coordinate planes of {n} and {p.numel()} samples")
    planes = [p.contiguous() for p in planes]
    out = torch.empty(tuple(planes[0].shape) + (channels,), dtype=torch.float32,
                      device=dev)
    args = (table.data_ptr(), int(table.dtype == torch.bfloat16),
            (ctypes.c_int * len(geom))(*geom), *(p.data_ptr() for p in planes),
            out.data_ptr(), n)
    return out, args, planes


def _launch(name: str, table, values: int, geom, channels: int, planes):
    """Launch one sampler kernel on the planes' samples → [..., C] float32."""
    out, args, held = kernel_args(name, table, values, geom, channels, planes)
    if out.numel() == 0:
        return out
    dev = out.device
    with torch.cuda.device(dev):
        rc = getattr(_cuda.lib(), f"cs_sample_{name}")(*args, _cuda.stream_handle(dev))
    del held
    _cuda.check(rc, f"sample_{name}")
    if _cuda.capturing:
        return out
    with _cuda.COUNT_LOCK:
        launches[name] += 1
        samples[name] += args[-1]
        sizes[name][args[-1]] += 1
    return out


def _on_card(what: str, q) -> bool:
    """Whether the coordinates take a kernel (CUDA) or the plain version
    (CPU); any other device raises."""
    if q.device.type == "cuda":
        return True
    if q.device.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {q.device}")


def _tex_geom(tex):
    """The texture kernels' geometry: dims, channels, clamp, weight strides."""
    return (*tex.dims, tex.channels, int(tex.wrap == "clamp"),
            *weight_strides(len(tex.dims), tex.channels))


def sample_tex3_xyz(tex: Texture3D, qx, qy, qz):
    """Trilinear fetch from a texture on component planes (x, y, z uv) →
    [..., C] (kernel K7 on the card)."""
    if not _on_card("sample_tex3_xyz", qx):
        return sample_tex3_xyz_reference(tex, qx, qy, qz)
    return _launch("tex3", tex.texels, tex.channels * math.prod(tex.dims),
                   _tex_geom(tex), tex.channels, (qx, qy, qz))


def sample_tex2_xy(tex: Texture2D, qu, qv):
    """Bilinear fetch from a texture on component planes (u, v) → [..., C]
    (kernel K8 on the card)."""
    if not _on_card("sample_tex2_xy", qu):
        return sample_tex2_xy_reference(tex, qu, qv)
    return _launch("tex2", tex.texels, tex.channels * math.prod(tex.dims),
                   _tex_geom(tex), tex.channels, (qu, qv))


def sample_tex2(tex: Texture2D, uv):
    """Bilinear fetch at uv [..., 2] → [..., C] (the texture's wrap)."""
    return sample_tex2_xy(tex, uv[..., 0], uv[..., 1])


def sample_brick3_xyz(bt: BrickTable3D, qx, qy, qz):
    """Trilinear fetch on component planes (x, y, z uv) → [..., C] (kernel
    K7 on the card)."""
    if not _on_card("sample_brick3_xyz", qx):
        return sample_brick3_xyz_reference(bt, qx, qy, qz)
    geom = (*bt.dims, *bt.brick, *bt.stride, bt.grid[1], bt.grid[2], bt.channels,
            int(bt.wrap == "clamp"))
    values = math.prod(bt.grid) * bt.channels * math.prod(bt.brick)
    return _launch("brick3", bt.table, values, geom, bt.channels, (qx, qy, qz))


def sample_brick3(bt: BrickTable3D, q):
    """Trilinear fetch at q [..., 3] (x, y, z uv) → [..., C] (the table's
    wrap). For parity with the JAX API; the marches call
    `sample_brick3_xyz`."""
    return sample_brick3_xyz(bt, q[..., 0], q[..., 1], q[..., 2])


def sample_brick2_xy(bt: BrickTable2D, qu, qv):
    """Bilinear fetch on component planes (u, v) → [..., C] (kernel K8 on
    the card)."""
    if not _on_card("sample_brick2_xy", qu):
        return sample_brick2_xy_reference(bt, qu, qv)
    geom = (*bt.dims, *bt.brick, *bt.stride, bt.grid[1], bt.channels,
            int(bt.wrap == "clamp"))
    values = math.prod(bt.grid) * bt.channels * math.prod(bt.brick)
    return _launch("brick2", bt.table, values, geom, bt.channels, (qu, qv))


def sample_brick2(bt: BrickTable2D, uv):
    """Bilinear fetch at uv [..., 2] → [..., C] (the table's wrap)."""
    return sample_brick2_xy(bt, uv[..., 0], uv[..., 1])


def sample_tiny3_xyz(tv: TinyVolume3D, qx, qy, qz):
    """Gather-free trilinear fetch from a ≤1-row volume, modular wrap
    (kernel K9 on the card)."""
    if not _on_card("sample_tiny3_xyz", qx):
        return sample_tiny3_xyz_reference(tv, qx, qy, qz)
    return _launch("tiny3", tv.row, tv.channels * math.prod(tv.dims),
                   (*tv.dims, tv.channels), tv.channels, (qx, qy, qz))


def sample_tiny3(tv: TinyVolume3D, q):
    """Gather-free trilinear fetch at q [..., 3] → [..., C], modular wrap.
    For parity with the JAX API; the marches call `sample_tiny3_xyz`."""
    return sample_tiny3_xyz(tv, q[..., 0], q[..., 1], q[..., 2])
