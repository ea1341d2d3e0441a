"""Brick-row texture tables (torch port of `cloudscape_tpu.ops.brick`).

Each noise texture is reshaped into a table of 128-lane bricks:

- 3D, 2 channels:  4×4×4 texels × 2ch  = 128 lanes, brick stride 3
- 3D, 1 channel :  8×4×4 texels × 1ch  = 128 lanes, strides (7, 3, 3)
- 2D, 2 channels:  8×8 texels   × 2ch  = 128 lanes, brick stride 7
- 2D, 8 channels:  4×4 texels   × 8ch  = 128 lanes, brick stride 3 (the
  display pair tables of the fused serving tick, clamp wrap)

Brick stride ≤ brick_dim - 1 keeps any trilinear/bilinear footprint inside
one brick, so a filtered sample reads one brick row. Volumes that fit one
row (≤ 128 values) are kept whole (`TinyVolume3D`). The layout is the JAX
package's, kept as it is so that the port's tables match it.

The samplers dispatch on the coordinates' device:

- a CUDA tensor launches a hand-written kernel of `csrc/sample.cu` on the
  whole plane — K7 `sample_brick3_xyz`, K8 `sample_brick2_xy`, K9
  `sample_tiny3_xyz` — which reads only the 8 (4 in 2-D) texels that
  carry weight, or raises (also for a channel count or table type that
  no main-path table has: `KERNEL_KINDS`); `launches` counts the launches
  per kernel and `samples` the samples they were given;
- a CPU tensor takes the plain version, the JAX package's lane-weight form:
  it gathers each sample's whole row, weighs every lane with hat weights
  and sums them. A 96² tile at 128 steps is 1.18 M samples, so it runs in
  chunks of `SAMPLE_CHUNK` samples to bound the rows and weights it
  materialises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Tuple

import torch

from cloudscape_tpu_torch.ops import _cuda

SAMPLE_CHUNK = 1 << 18

# Each kernel's launches, and the samples those launches were given.
launches = {"brick3": 0, "brick2": 0, "tiny3": 0}
samples = {"brick3": 0, "brick2": 0, "tiny3": 0}

# The (channels, table dtype) pairs csrc/sample.cu compiles: those of the
# tables the marches, the baked field and the composite sample (the noise
# mips, optionally bfloat16, the cone cache and the field through K7 and K9;
# weather and the display pairs through K8). A CUDA call on another pair
# raises.
_F32, _BF16 = torch.float32, torch.bfloat16
KERNEL_KINDS = {
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
    the engine uses to spread the cone-table build over ticks. Writing every
    row range reproduces the whole table. Needs b0 + count ≤ n_bricks."""
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


def sample_tiny3_xyz_reference(tv: TinyVolume3D, qx, qy, qz):
    """Plain version of K9: weights over the whole row, in chunks."""
    d, h, w = tv.dims
    L = d * h * w
    row = tv.row.reshape(tv.channels, L)

    def axis_w(i0, f, n):
        lane = torch.arange(n, device=i0.device)[None, :]
        i0e = i0[:, None]
        fe = f[:, None]
        return torch.where(lane == i0e, 1.0 - fe, 0.0) + torch.where(
            lane == torch.remainder(i0e + 1, n), fe, 0.0)

    def chunk(qx, qy, qz):
        ix0, fx = _axis_coords(qx, w)
        iy0, fy = _axis_coords(qy, h)
        iz0, fz = _axis_coords(qz, d)
        wgt = (axis_w(ix0, fx, w)[:, None, None, :]
               * axis_w(iy0, fy, h)[:, None, :, None]) \
            * axis_w(iz0, fz, d)[:, :, None, None]
        return torch.sum(row[None] * wgt.reshape(-1, 1, L), dim=-1)

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
    with _cuda.COUNT_LOCK:
        launches[name] += 1
        samples[name] += args[-1]
    return out


def _on_card(what: str, q) -> bool:
    """Whether the coordinates take a kernel (CUDA) or the plain version
    (CPU); any other device raises."""
    if q.device.type == "cuda":
        return True
    if q.device.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {q.device}")


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
