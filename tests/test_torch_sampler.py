"""The brick samplers' kernels K7–K9 (`csrc/sample.cu`), mirrored in NumPy.

`csrc/sample.cu` reads, per sample, only the 8 (4 in 2-D) texels that carry
weight; it cannot run here. `mirror_*` below follow the kernels step by step
in float32: coordinates with every product and difference rounded (no FMA),
the hat weights from the rounded a = float(l0) + f (K9: 1 − f and f, summed
where the two lanes coincide), each corner's ((wx·wy)·wz)·texel and a
channel's corners summed in the kernel's order. Each mirror is held against
JAX's sampler and the port's plain version (the lane-weight form on brick
tables, the 8-corner form on tiny volumes) on every table kind the marches
and the composite sample:

- K7: 2-ch 4×4×4 stride 3 (the large-noise mips; the baked field with
  clamp), 1-ch 8×4×4 strides (7, 3, 3) (the small-noise mips; the cone
  cache with clamp), float32 and bfloat16, each with both wraps;
- K8: 2-ch 8×8 stride 7 (weather) and 8-ch 4×4 stride 3 (the display
  pairs), each with both wraps;
- K9: whole volumes of ≤ 128 values, 1 and 2 channels, float32 and
  bfloat16, modular wrap. `mirror_tiny3` follows K9's first form (one
  sample a thread, runtime dims); `mirror_tiny3_grouped` the redesigned
  `tiny3_kernel` (4 samples a thread, float4 planes where aligned, the
  ragged tail one sample at a time; compile-time dims 4³, 2³ and 1³ whose
  floor modulo is a mask of a power of two, runtime dims otherwise). The
  two and the plain version are held bitwise, and JAX's within 1e-6.

The coordinates cover negative values and values past 1, exact texel
centres (f = 0), fractions that round to 1 just below a cell, and both clamp
edges. Tolerance: 1e-6 absolute on the [0, 1] noise tables, as
tests/test_torch_brick_atmo.py holds the plain samplers to JAX's: the
brick plain version and JAX sum all 128 lanes, in another order than the
kernel's 8 corners, and XLA on the CPU may contract q·n − 0.5 into an FMA,
which moves a sample across a texel boundary where the filter is continuous.
The display pairs carry HDR radiance (here up to 40), so they are held at
1e-6 absolute plus 1e-6 relative.

The wrapper's plumbing is checked here too: `kernel_args` builds the C
entry's arguments from CPU tensors, and a stand-in entry that reads them
the way the `.cu` does (geometry order, contiguous planes, output layout) and
runs the mirror must give the mirror's samples; a (channels, type) pair no
kernel is compiled for raises.
"""

import ctypes
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudscape_tpu.ops import brick as jbrick
from cloudscape_tpu_torch.ops import brick as tbrick

# Several test workers share the host's cores: keep torch's intra-op
# thread pool small so they do not oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))

F = np.float32
ATOL = 1e-6
N_SAMPLES = 6000


# ---- the NumPy mirror of csrc/sample.cu ---------------------------------

def axis_coords(q, n: int, clamp: bool):
    """`axis_coords`: (i0 int32, f float32), q·n and − 0.5 each rounded; the
    clamp tests on the integral float i0f, the repeat wrap C's truncating %
    made a floor-mod, in 32 bits and, past 2^31, in 64 bits."""
    cx = (np.asarray(q, F) * F(n)).astype(F) - F(0.5)
    i0f = np.floor(cx)
    f = (cx - i0f).astype(F)
    if clamp:
        f = np.where(i0f < 0, F(0.0), np.where(i0f > F(n - 2), F(1.0), f)).astype(F)
        i = np.where(i0f < 0, 0, np.where(i0f > F(n - 2), max(n - 2, 0), i0f))
        return i.astype(np.int32), f
    small = np.abs(i0f) < 2.0 ** 31
    r32 = np.fmod(np.where(small, i0f, 0).astype(np.int32), np.int32(n))
    r64 = np.fmod(np.where(small, 0, i0f).astype(np.int64), np.int64(n))
    r = np.where(small, r32, r64)
    return np.where(r < 0, r + n, r).astype(np.int32), f


def hat(l0, f):
    """`hat`: max(0, 1 − |a − lane|) at lanes l0 and l0 + 1, a = l0 + f."""
    lf = l0.astype(F)
    a = (lf + f).astype(F)
    w0 = np.maximum(F(0.0), F(1.0) - np.abs(a - lf)).astype(F)
    w1 = np.maximum(F(0.0), F(1.0) - np.abs(a - (lf + F(1.0)))).astype(F)
    return w0, w1


def widen(table):
    """A float32 or bfloat16 (as uint16 bits) table as float32 texels."""
    table = np.asarray(table)
    if table.dtype == np.uint16:
        return (table.astype(np.uint32) << 16).view(F)
    return table.astype(F)


def weigh(rows, off, w, channels: int, lanes: int):
    """`weigh`: per channel, the corners' w·texel summed in corner order."""
    out = np.empty((rows.shape[0], channels), F)
    for c in range(channels):
        acc = np.zeros(rows.shape[0], F)
        for o, wk in zip(off, w):
            t = np.take_along_axis(rows, (c * lanes + o)[:, None], axis=1)[:, 0]
            acc = (acc + (wk * t).astype(F)).astype(F)
        out[:, c] = acc
    return out


def mirror_brick3(table, dims, brick, stride, grid, channels, clamp, qx, qy, qz):
    d, h, w = dims
    bz, by, bx = brick
    sz, sy, sx = stride
    _, ny, nx = grid
    ix, fx = axis_coords(qx, w, clamp)
    iy, fy = axis_coords(qy, h, clamp)
    iz, fz = axis_coords(qz, d, clamp)
    fb = ((iz // sz) * ny + iy // sy) * nx + ix // sx
    lx, ly, lz = ix % sx, iy % sy, iz % sz
    wx, wy, wz = hat(lx, fx), hat(ly, fy), hat(lz, fz)
    base = (lz * by + ly) * bx + lx
    off, wts = [], []
    for k in range(8):
        dz, dy, dx = k >> 2, (k >> 1) & 1, k & 1
        off.append(base + (dz * by + dy) * bx + dx)
        wts.append(((wx[dx] * wy[dy]).astype(F) * wz[dz]).astype(F))
    return weigh(widen(table)[fb], off, wts, channels, bz * by * bx)


def mirror_brick2(table, dims, brick, stride, grid, channels, clamp, qu, qv):
    h, w = dims
    by, bx = brick
    sy, sx = stride
    _, nx = grid
    ix, fx = axis_coords(qu, w, clamp)
    iy, fy = axis_coords(qv, h, clamp)
    fb = (iy // sy) * nx + ix // sx
    lx, ly = ix % sx, iy % sy
    wx, wy = hat(lx, fx), hat(ly, fy)
    base = ly * bx + lx
    off, wts = [], []
    for k in range(4):
        dy, dx = k >> 1, k & 1
        off.append(base + dy * bx + dx)
        wts.append((wx[dx] * wy[dy]).astype(F))
    return weigh(widen(table)[fb], off, wts, channels, by * bx)


def tiny_axis(q, n: int):
    """`tiny_axis`: lanes i0 and (i0 + 1) % n, weights 1 − f and f; for
    n = 1 one lane weighing (1 − f) + f and a second weighing 0."""
    i0, f = axis_coords(q, n, False)
    i1 = (i0 + 1) % n
    if n == 1:
        return (i0, i1), ((F(1.0) - f + f).astype(F), np.zeros_like(f))
    return (i0, i1), ((F(1.0) - f).astype(F), f)


def mirror_tiny3(row, dims, channels, qx, qy, qz):
    """K9's first form: one sample a thread, runtime dims."""
    d, h, w = dims
    (x0, x1), wx = tiny_axis(qx, w)
    (y0, y1), wy = tiny_axis(qy, h)
    (z0, z1), wz = tiny_axis(qz, d)
    xi, yi, zi = (x0, x1), (y0, y1), (z0, z1)
    off, wts = [], []
    for k in range(8):
        dz, dy, dx = k >> 2, (k >> 1) & 1, k & 1
        off.append((zi[dz] * h + yi[dy]) * w + xi[dx])
        wts.append(((wx[dx] * wy[dy]).astype(F) * wz[dz]).astype(F))
    rows = np.broadcast_to(widen(row)[None, :], (len(qx), widen(row).size))
    return weigh(rows, off, wts, channels, d * h * w)


# The redesigned K9: its compile-time dims, and samples a thread.
TINY_COMPILED = ((4, 4, 4), (2, 2, 2), (1, 1, 1))
TINY_PER = 4


def tiny_axis_masked(q, n: int, compiled: bool):
    """`tiny_axis<kN>`: with n at compile time (a power of two) i0 is the low
    bits of the two's-complement index, (int)i0f & (n − 1), in 64 bits past
    2^31, and i0 + 1 wraps by the same mask; at run time `axis_coords`'
    modulo and i0 + 1 wrapped to 0 at n. Weights as `tiny_axis`."""
    if not compiled:
        i0, f = axis_coords(q, n, False)
        i1 = np.where(i0 + 1 < n, i0 + 1, 0).astype(np.int32)
    else:
        assert n & (n - 1) == 0
        m = n - 1
        cx = (np.asarray(q, F) * F(n)).astype(F) - F(0.5)
        i0f = np.floor(cx)
        f = (cx - i0f).astype(F)
        small = np.abs(i0f) < 2.0 ** 31
        lo = np.where(small, i0f, 0).astype(np.int32) & np.int32(m)
        hi = (np.where(small, 0, i0f).astype(np.int64) & np.int64(m)).astype(np.int32)
        i0 = np.where(small, lo, hi).astype(np.int32)
        i1 = (i0 + 1) & np.int32(m)
    if n == 1:
        return (i0, i1), ((F(1.0) - f + f).astype(F), np.zeros_like(f))
    return (i0, i1), ((F(1.0) - f).astype(F), f)


def mirror_tiny3_grouped(row, dims, channels, qx, qy, qz, aligned: bool = True):
    """The redesigned `tiny3_kernel`: thread t takes samples [4t, 4t + 4);
    where the planes and output are 16-B aligned and all four are in range
    it reads each plane's four as one float4 and writes the outputs as one
    (two for 2 channels), else one sample at a time, reading sample 4t in
    place of those past n and writing only those below n (the ragged
    tail). Returns the [n, C] output and how often each sample was written."""
    d, h, w = dims
    compiled = tuple(dims) in TINY_COMPILED
    n = len(qx)
    threads = -(-n // TINY_PER)
    idx = np.arange(threads)[:, None] * TINY_PER + np.arange(TINY_PER)[None, :]
    vec = np.broadcast_to((idx[:, -1:] < n) & aligned, idx.shape)
    # A vector load reads [4t, 4t + 4); a scalar one sample 4t + j, or 4t
    # where that is past n.
    src = np.where(vec | (idx < n), idx, idx[:, :1])
    assert src.max() < n
    xs, ys, zs = (np.asarray(q, F)[src].reshape(-1) for q in (qx, qy, qz))
    (x0, x1), wx = tiny_axis_masked(xs, w, compiled)
    (y0, y1), wy = tiny_axis_masked(ys, h, compiled)
    (z0, z1), wz = tiny_axis_masked(zs, d, compiled)
    xi, yi, zi = (x0, x1), (y0, y1), (z0, z1)
    off, wts = [], []
    for k in range(8):
        dz, dy, dx = k >> 2, (k >> 1) & 1, k & 1
        off.append((zi[dz] * h + yi[dy]) * w + xi[dx])
        wts.append(((wx[dx] * wy[dy]).astype(F) * wz[dz]).astype(F))
    rows = np.broadcast_to(widen(row)[None, :], (xs.size, widen(row).size))
    got = weigh(rows, off, wts, channels, d * h * w)
    out = np.zeros((n, channels), F)
    writes = np.zeros(n, np.int64)
    stored = (vec | (idx < n)).reshape(-1)
    assert not (vec.reshape(-1) & (idx.reshape(-1) >= n)).any()
    out[idx.reshape(-1)[stored]] = got[stored]
    np.add.at(writes, idx.reshape(-1)[stored], 1)
    return out, writes


# ---- inputs ---------------------------------------------------------------

def coords(n_axis: int, rng, n: int = N_SAMPLES):
    """Random coordinates in [−1.5, 2.5], plus the edge cases of an axis of
    n_axis texels: texel centres (i + 0.5)/n (f = 0 where exact) and the
    float just below each (f rounds to 1 there), both clamp edges and past
    them, 0, 1, and large negative and positive values."""
    centres = (np.arange(n_axis, dtype=F) + F(0.5)) / F(n_axis)
    edges = np.array([0.0, 1.0, -1e-9, -1e-7, -0.25, 1.25, -3.7, 2.9,
                      0.5 / n_axis, 0.49 / n_axis, 0.51 / n_axis,
                      1.0 - 0.5 / n_axis, 1.0 - 0.49 / n_axis,
                      1.0 - 0.51 / n_axis, 1.0 + 1e-7], F)
    below = np.nextafter(centres, F(-np.inf))  # a hair under each centre
    special = np.concatenate([centres, below, edges, -centres, centres + F(1.0)])
    q = rng.uniform(-1.5, 2.5, n).astype(F)
    q[:special.size] = special[:n]
    return q


def planes(dims, seed: int):
    """One coordinate plane per axis (x first), each with its axis's edge
    cases, shuffled independently across the axes."""
    rng = np.random.default_rng(seed)
    out = []
    for n_axis in reversed(dims):  # dims are (z, y, x) or (y, x)
        q = coords(n_axis, rng)
        out.append(q[rng.permutation(q.size)] if out else q)
    return out


def bf16_bits(t):
    """A bfloat16 tensor's bits as uint16 (NumPy has no bfloat16)."""
    return t.view(torch.int16).numpy().view(np.uint16)


def to_jax(arr, bf16: bool):
    a = jnp.asarray(arr)
    return a.astype(jnp.bfloat16) if bf16 else a


# ---- K7 ---------------------------------------------------------------------

BRICK3_KINDS = {
    # kind: (volume dims, channels, brick, stride)
    "2ch_4x4x4": ((13, 16, 10), 2, (4, 4, 4), (3, 3, 3)),
    "1ch_8x4x4": ((16, 11, 14), 1, (8, 4, 4), (7, 3, 3)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wrap", ["repeat", "clamp"])
@pytest.mark.parametrize("kind", sorted(BRICK3_KINDS))
def test_brick3_mirror(kind, wrap, dtype):
    dims, c, brick, stride = BRICK3_KINDS[kind]
    rng = np.random.default_rng(zlib.crc32(f"{kind} {wrap} {dtype}".encode()))
    vol = rng.random(dims + (c,)).astype(F)
    bt = tbrick.build_brick3(torch.from_numpy(vol), brick, stride, wrap=wrap)
    bf16 = dtype == "bfloat16"
    if bf16:
        bt = tbrick.BrickTable3D(table=bt.table.to(torch.bfloat16), dims=bt.dims,
                                 brick=brick, stride=stride, grid=bt.grid,
                                 channels=c, wrap=wrap)
    table = bf16_bits(bt.table) if bf16 else bt.table.numpy()
    qx, qy, qz = planes(dims, 11)
    want = mirror_brick3(table, bt.dims, brick, stride, bt.grid, c,
                         wrap == "clamp", qx, qy, qz)
    plain = tbrick.sample_brick3_xyz(bt, *map(torch.from_numpy, (qx, qy, qz))).numpy()
    np.testing.assert_allclose(want, plain, atol=ATOL, rtol=0)
    jt = jbrick.BrickTable3D(table=to_jax(bt.table.float().numpy(), bf16),
                             dims=bt.dims, brick=brick, stride=stride,
                             grid=bt.grid, channels=c, wrap=wrap)
    jax_out = np.asarray(jbrick.sample_brick3_xyz(jt, *map(jnp.asarray, (qx, qy, qz))))
    np.testing.assert_allclose(want, jax_out, atol=ATOL, rtol=0)


def test_brick3_mirror_edges_are_reached():
    """The inputs reach f = 0 at texel centres, f = 1 under repeat just below
    0, and both clamp edges, on each axis."""
    for n in (10, 16, 13):
        q = coords(n, np.random.default_rng(0))
        _, f = axis_coords(q, n, False)
        assert (f == 0).sum() >= n // 2 and (f == 1).any()
        i, f = axis_coords(q, n, True)
        assert ((i == 0) & (f == 0)).any() and ((i == n - 2) & (f == 1)).any()


# ---- K8 ---------------------------------------------------------------------

BRICK2_KINDS = {
    # kind: (image dims, channels, brick, stride, value scale)
    "2ch_8x8": ((37, 64), 2, (8, 8), (7, 7), 1.0),
    "8ch_4x4": ((24, 29), 8, (4, 4), (3, 3), 40.0),
}


@pytest.mark.parametrize("wrap", ["repeat", "clamp"])
@pytest.mark.parametrize("kind", sorted(BRICK2_KINDS))
def test_brick2_mirror(kind, wrap):
    dims, c, brick, stride, scale = BRICK2_KINDS[kind]
    rng = np.random.default_rng(zlib.crc32(f"{kind} {wrap}".encode()))
    img = (rng.random(dims + (c,)) * scale).astype(F)
    bt = tbrick.build_brick2(torch.from_numpy(img), brick, stride, wrap=wrap)
    qu, qv = planes(dims, 12)
    want = mirror_brick2(bt.table.numpy(), bt.dims, brick, stride, bt.grid, c,
                         wrap == "clamp", qu, qv)
    rtol = ATOL if scale > 1.0 else 0.0
    plain = tbrick.sample_brick2_xy(bt, torch.from_numpy(qu), torch.from_numpy(qv))
    np.testing.assert_allclose(want, plain.numpy(), atol=ATOL, rtol=rtol)
    jt = jbrick.BrickTable2D(table=jnp.asarray(bt.table.numpy()), dims=bt.dims,
                             brick=brick, stride=stride, grid=bt.grid, channels=c,
                             wrap=wrap)
    jax_out = np.asarray(jbrick.sample_brick2_xy(jt, jnp.asarray(qu), jnp.asarray(qv)))
    np.testing.assert_allclose(want, jax_out, atol=ATOL, rtol=rtol)


# ---- K9 ---------------------------------------------------------------------

def bits(a):
    """float32 values as their bits, for bitwise comparisons."""
    return np.ascontiguousarray(a, F).view(np.uint32)


def tiny_volume(shape, dtype: str, seed: int):
    """A tiny volume of random [0, 1) texels (bfloat16 if asked) and its
    row as the kernel reads it (float32, or bfloat16 bits as uint16)."""
    vol = np.random.default_rng(seed).random(shape).astype(F)
    tv = tbrick.build_tiny3(torch.from_numpy(vol))
    if dtype == "bfloat16":
        tv = tbrick.TinyVolume3D(row=tv.row.to(torch.bfloat16), dims=tv.dims,
                                 channels=tv.channels)
        return tv, bf16_bits(tv.row)
    return tv, tv.row.numpy()


def jax_tiny3(tv, qs):
    jv = jbrick.TinyVolume3D(row=to_jax(tv.row.float().numpy(), tv.row.dtype
                                        == torch.bfloat16), dims=tv.dims,
                             channels=tv.channels)
    return np.asarray(jbrick.sample_tiny3_xyz(jv, *map(jnp.asarray, qs)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 4, 4, 2), (4, 4, 4, 1), (2, 2, 2, 1),
                                   (1, 1, 1, 2), (2, 1, 3, 1)])
def test_tiny3_mirror(shape, dtype):
    tv, row = tiny_volume(shape, dtype, sum(shape) + len(dtype))
    qx, qy, qz = planes(shape[:3], 13)
    want = mirror_tiny3(row, tv.dims, tv.channels, qx, qy, qz)
    plain = tbrick.sample_tiny3_xyz(tv, *map(torch.from_numpy, (qx, qy, qz))).numpy()
    np.testing.assert_array_equal(bits(want), bits(plain))
    np.testing.assert_allclose(want, jax_tiny3(tv, (qx, qy, qz)), atol=ATOL, rtol=0)


def huge(dims, rng, k: int = 24):
    """k coordinates a plane with |q·n| ≥ 2^31 on its axis (x first), of
    both signs: the kernels' 64-bit branch."""
    out = []
    for n_axis in reversed(dims):
        mag = rng.uniform(2.0 ** 31, 2.0 ** 40, k) / n_axis
        out.append((mag * rng.choice([-1.0, 1.0], k)).astype(F))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("dims", [(4, 4, 4), (2, 2, 2), (1, 1, 1), (2, 1, 3)])
def test_tiny3_redesign_mirror(dims, channels, dtype):
    """The redesigned K9, mirrored, bitwise K9's first form and the plain
    version on n ≡ 0, 1, 2, 3 (mod 4) samples, aligned and not, with texel
    centres, edges, fractions that round to 1 and |q·n| ≥ 2^31; within
    1e-6 of JAX but where |q·n| ≥ 2^31 (JAX casts i0 to int32, which
    saturates there; the port and its first form take the int64 floor
    modulo)."""
    seed = zlib.crc32(f"{dims} {channels} {dtype}".encode())
    tv, row = tiny_volume(dims + (channels,), dtype, seed)
    rng = np.random.default_rng(seed)
    base = [np.concatenate([q, h]) for q, h in zip(planes(dims, seed), huge(dims, rng))]
    assert base[0].size % TINY_PER == 0
    for extra in range(TINY_PER):
        n = base[0].size - TINY_PER + extra
        qs = [q[:n] for q in base]
        old = mirror_tiny3(row, tv.dims, channels, *qs)
        plain = tbrick.sample_tiny3_xyz(tv, *map(torch.from_numpy, qs)).numpy()
        for aligned in (True, False):
            got, writes = mirror_tiny3_grouped(row, tv.dims, channels, *qs,
                                               aligned=aligned)
            assert (writes == 1).all()
            np.testing.assert_array_equal(bits(got), bits(old))
        np.testing.assert_array_equal(bits(plain), bits(old))
        inside = np.ones(n, bool)
        for q, n_axis in zip(qs, reversed(dims)):
            inside &= np.abs(q.astype(np.float64) * n_axis) < 2.0 ** 31
        assert 0 < inside.sum() < n
        np.testing.assert_allclose(got[inside], jax_tiny3(tv, qs)[inside],
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_tiny3_mask_is_floor_modulo(n):
    """A power-of-two axis's mask, i & (n − 1) on the two's-complement
    index, is the floor modulo of every index, negatives included, in 32
    bits and on the 64-bit branch past 2^31; and the masked axis equals
    `axis_coords`' wrap on every coordinate."""
    i32 = np.arange(-70000, 70000, dtype=np.int32)
    np.testing.assert_array_equal(i32 & np.int32(n - 1), np.mod(i32, n))
    i64 = np.array([-2 ** 40 - 3, -2 ** 31 - 1, -2 ** 31, 2 ** 31, 2 ** 31 + 5,
                    2 ** 40 + 7], np.int64)
    np.testing.assert_array_equal(i64 & np.int64(n - 1), np.mod(i64, n))
    rng = np.random.default_rng(n)
    q = np.concatenate([coords(n, rng), huge((n,), rng)[0]])
    (i0, i1), _ = tiny_axis_masked(q, n, True)
    want, _ = axis_coords(q, n, False)
    np.testing.assert_array_equal(i0, want)
    np.testing.assert_array_equal(i1, (want + 1) % n)


@pytest.mark.parametrize("aligned", [True, False])
def test_tiny3_grouping(aligned):
    """4 samples a thread: every sample of every n written exactly once,
    with no read past n, and the grouped mirror equal to the first form."""
    tv, row = tiny_volume((2, 2, 2, 2), "float32", 21)
    qs = planes((2, 2, 2), 22)
    for n in range(1, 13):
        got, writes = mirror_tiny3_grouped(row, tv.dims, 2, *(q[:n] for q in qs),
                                           aligned=aligned)
        assert (writes == 1).all()
        want = mirror_tiny3(row, tv.dims, 2, *(q[:n] for q in qs))
        np.testing.assert_array_equal(bits(got), bits(want))


# ---- the wrapper's plumbing ---------------------------------------------------

def _floats(ptr: int, count: int, dtype=F):
    """`count` elements of `dtype` at a host address."""
    nbytes = count * np.dtype(dtype).itemsize
    return np.frombuffer((ctypes.c_char * nbytes).from_address(ptr), dtype).copy()


def _run_entry(entry: str, table, args):
    """Read a C entry's arguments as csrc/sample.cu does and run the mirror;
    returns the [n, C] samples it would write."""
    tbl = _floats(args[0], table.numel(), np.uint16 if args[1] else F)
    geom = list(args[2])
    n = args[-1]
    qs = [_floats(ptr, n) for ptr in args[3:-2]]
    if entry == "brick3":
        d, h, w, bz, by, bx, sz, sy, sx, ny, nx, c, clamp = geom
        return mirror_brick3(tbl.reshape(-1, c * bz * by * bx), (d, h, w),
                             (bz, by, bx), (sz, sy, sx), (0, ny, nx), c, clamp, *qs)
    if entry == "brick2":
        h, w, by, bx, sy, sx, nx, c, clamp = geom
        return mirror_brick2(tbl.reshape(-1, c * by * bx), (h, w), (by, bx),
                             (sy, sx), (0, nx), c, clamp, *qs)
    d, h, w, c = geom
    # cs_sample_tiny3 takes float4 planes and stores where every plane and
    # the output are 16-B aligned.
    aligned = all(ptr % 16 == 0 for ptr in args[3:-1])
    return mirror_tiny3_grouped(tbl, (d, h, w), c, *qs, aligned=aligned)[0]


def _views(q, layout: str):
    """The plane as the march or the composite hands it over: contiguous,
    a strided component of a stacked [..., k] tensor, or a transposed view,
    each of shape [40, 150]."""
    t = torch.from_numpy(q[:6000].copy()).reshape(40, 150)
    if layout == "component":
        return torch.stack([t, -t, t], dim=-1)[..., 0]
    if layout == "transposed":
        return t.reshape(150, 40).t()
    return t


@pytest.mark.parametrize("layout", ["contiguous", "component", "transposed"])
@pytest.mark.parametrize("entry", ["brick3", "brick2", "tiny3"])
def test_kernel_args_reach_the_mirror(entry, layout):
    rng = np.random.default_rng(5)
    if entry == "brick3":
        vol = torch.from_numpy(rng.random((13, 16, 10, 2)).astype(F))
        tab = tbrick.build_brick3(vol, wrap="clamp")
        geom = (*tab.dims, *tab.brick, *tab.stride, tab.grid[1], tab.grid[2],
                tab.channels, 1)
        table, dims = tab.table, tab.dims
    elif entry == "brick2":
        img = torch.from_numpy(rng.random((24, 29, 8)).astype(F))
        tab = tbrick.build_brick2(img, (4, 4), (3, 3), wrap="clamp")
        geom = (*tab.dims, *tab.brick, *tab.stride, tab.grid[1], tab.channels, 1)
        table, dims = tab.table, tab.dims
    else:
        tab = tbrick.build_tiny3(torch.from_numpy(rng.random((2, 1, 3, 2)).astype(F)))
        geom = (*tab.dims, tab.channels)
        table, dims = tab.row.to(torch.bfloat16), tab.dims
        tab = tbrick.TinyVolume3D(row=table, dims=tab.dims, channels=tab.channels)
    qs = [_views(q, layout) for q in planes(dims, 14)]
    if layout == "contiguous":
        assert all(q.is_contiguous() for q in qs)
    out, args, held = tbrick.kernel_args(entry, table, table.numel(), geom,
                                         tab.channels, qs)
    assert out.shape == qs[0].shape + (out.shape[-1],)
    # The kernel reads contiguous planes: a view is copied, a contiguous
    # plane passed as it is.
    assert all(h.is_contiguous() for h in held)
    assert list(args[3:-2]) == [h.data_ptr() for h in held]
    assert (args[3] == qs[0].data_ptr()) == (layout == "contiguous")
    got = _run_entry(entry, table, args)
    want = {"brick3": tbrick.sample_brick3_xyz, "brick2": tbrick.sample_brick2_xy,
            "tiny3": tbrick.sample_tiny3_xyz}[entry](tab, *qs)
    np.testing.assert_allclose(got.reshape(want.shape), want.numpy(), atol=ATOL,
                               rtol=ATOL if entry == "brick2" else 0)
    del held


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", [1, 2, 3, 8])
@pytest.mark.parametrize("entry", ["brick3", "brick2", "tiny3"])
def test_kernel_args_kinds(entry, channels, dtype):
    """The kernels are compiled for the (channels, type) pairs of the tables
    the main path samples: K7 and K9 1 or 2 channels, f32 or bfloat16; K8 2
    or 8 channels, f32. Any other pair raises before a launch."""
    torch_dtype = getattr(torch, dtype)
    want = {"brick3": channels in (1, 2), "tiny3": channels in (1, 2),
            "brick2": channels in (2, 8) and dtype == "float32"}[entry]
    assert ((channels, torch_dtype) in tbrick.KERNEL_KINDS[entry]) == want
    if entry == "brick3":
        tab = tbrick.build_brick3(torch.rand(8, 8, 8, channels))
        table, geom = tab.table, (*tab.dims, *tab.brick, *tab.stride, tab.grid[1],
                                  tab.grid[2], channels, 0)
    elif entry == "brick2":
        tab = tbrick.build_brick2(torch.rand(16, 16, channels))
        table, geom = tab.table, (*tab.dims, *tab.brick, *tab.stride, tab.grid[1],
                                  channels, 0)
    else:
        tab = tbrick.build_tiny3(torch.rand(2, 2, 2, channels))
        table, geom = tab.row, (*tab.dims, channels)
    table = table.to(torch_dtype)
    q = torch.rand(10)
    qs = [q] * (2 if entry == "brick2" else 3)
    if want:
        out, args, _ = tbrick.kernel_args(entry, table, table.numel(), geom,
                                          channels, qs)
        assert out.shape == (10, channels) and args[1] == int(dtype == "bfloat16")
    else:
        with pytest.raises(ValueError, match="no kernel"):
            tbrick.kernel_args(entry, table, table.numel(), geom, channels, qs)


@pytest.mark.parametrize("bad", ["float64", "length", "device", "table"])
def test_kernel_args_raise(bad):
    tab = tbrick.build_brick3(torch.rand(8, 8, 8, 2))
    geom = (*tab.dims, *tab.brick, *tab.stride, tab.grid[1], tab.grid[2], 2, 0)
    q = torch.rand(100)
    planes_ = [q, q, q]
    table, values = tab.table, tab.table.numel()
    if bad == "float64":
        planes_[1] = q.double()
    elif bad == "length":
        planes_[2] = q[:99]
    elif bad == "device":
        planes_[1] = torch.empty(100, device="meta")
    else:
        values += 1
    with pytest.raises(ValueError):
        tbrick.kernel_args("brick3", table, values, geom, 2, planes_)


def test_samplers_raise_off_cpu_and_cuda():
    """A plane on a device that is neither the CPU nor a card raises; there
    is no fallback."""
    tab = tbrick.build_brick3(torch.rand(8, 8, 8, 2))
    q = torch.empty(10, device="meta")
    with pytest.raises(ValueError):
        tbrick.sample_brick3_xyz(tab, q, q, q)
    with pytest.raises(ValueError):
        tbrick.sample_brick2_xy(tbrick.build_brick2(torch.rand(16, 16, 2)), q, q)
    with pytest.raises(ValueError):
        tbrick.sample_tiny3_xyz(tbrick.build_tiny3(torch.rand(2, 2, 2, 1)), q, q, q)


def test_cpu_planes_take_the_plain_version():
    """On CPU tensors the samplers are their plain versions, bitwise, and
    launch nothing."""
    rng = np.random.default_rng(9)
    tab = tbrick.build_brick3(torch.from_numpy(rng.random((10, 12, 9, 2)).astype(F)))
    qs = [torch.from_numpy(q) for q in planes((10, 12, 9), 15)]
    before = dict(tbrick.launches), dict(tbrick.samples)
    assert torch.equal(tbrick.sample_brick3_xyz(tab, *qs),
                       tbrick.sample_brick3_xyz_reference(tab, *qs))
    assert (tbrick.launches, tbrick.samples) == before
