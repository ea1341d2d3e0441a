"""The texture samplers K7 `tex3_kernel` and K8 `tex2_kernel`
(`csrc/sample.cu`), mirrored in NumPy.

The engine's tables are channel-last textures (`Texture3D` [D, H, W, C],
`Texture2D` [H, W, C]); the kernels cannot run here. `mirror_tex*` follow
them step by step in float32, with tests/test_torch_sampler.py's
coordinate and hat-weight steps: per axis the texels i0 and i0 + 1 (past
the edge n − 1 under clamp, 0 under repeat), hat weights rounded at lane
i0 mod s, s the brick stride of the JAX package's table of the same
channel count (`WEIGHT_STRIDES`), each corner's ((wx·wy)·wz)·texel and a
channel's corners summed from 0 in corner order. So a texture's sample is
the brick table's bitwise (the brick mirror's here), and the plain version
(`sample_tex*_reference`, the CPU's path) is the mirror bitwise.

Each mirror is held against JAX's sampler on the brick table JAX builds
from the same texels, on every table kind the engine samples:

- K7: 2-ch (the large-noise mips; the baked field with clamp) and 1-ch
  (the small-noise mips; the cone cache with clamp), float32 and bfloat16,
  each with both wraps;
- K8: 2-ch (weather) and 8-ch (the display pairs), each with both wraps.

The coordinates cover negative values and values past 1, exact texel
centres (f = 0), fractions that round to 1 just below a cell, and both
clamp edges. Tolerance against JAX: 1e-6 absolute on the [0, 1] tables
(JAX sums the 128 lanes in another order, and XLA on the CPU may contract
q·n − 0.5 into an FMA), 1e-6 absolute plus 1e-6 relative on the HDR pairs
(values up to 40 here).

The wrappers' plumbing is checked too: `kernel_args` builds the new C
entries' arguments from CPU tensors, and a stand-in entry that reads them
as the `.cu` does (geometry order, contiguous planes, output layout) and
runs the mirror gives the mirror's samples; a (channels, type) pair no
kernel is compiled for, or texels off 16-byte alignment, raise.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudscape_tpu.models import march_fast as jmf
from cloudscape_tpu.ops import brick as jbrick
from cloudscape_tpu_torch.ops import brick as tbrick
from test_torch_sampler import (ATOL, F, _floats, _views, axis_coords, bf16_bits,
                                hat, mirror_brick2, mirror_brick3, planes, to_jax,
                                widen)

# Several test workers share the host's cores.
torch.set_num_threads(min(2, torch.get_num_threads()))


# ---- the NumPy mirror of tex3_kernel / tex2_kernel ----------------------------

def tex_axis(q, n: int, clamp: bool, s: int):
    """`tex_axis`: texels (i0, i0 + 1 or past the edge n − 1 / 0) and the hat
    weights at lanes i0 mod s and its next."""
    i0, f = axis_coords(q, n, clamp)
    i1 = np.where(i0 + 1 < n, i0 + 1, n - 1 if clamp else 0).astype(np.int32)
    return (i0, i1), hat(i0 % s, f)


def weigh_texels(texels, channels: int, off, w):
    """`weigh_texels`: per channel, the corners' w·texel summed from 0 in
    corner order."""
    flat = widen(texels).reshape(-1, channels)
    acc = np.zeros((off[0].shape[0], channels), F)
    for o, wk in zip(off, w):
        acc = (acc + (wk[:, None] * flat[o]).astype(F)).astype(F)
    return acc


def mirror_tex3(texels, dims, channels, clamp, strides, qx, qy, qz):
    d, h, w = dims
    sz, sy, sx = strides
    xi, wx = tex_axis(qx, w, clamp, sx)
    yi, wy = tex_axis(qy, h, clamp, sy)
    zi, wz = tex_axis(qz, d, clamp, sz)
    off, wts = [], []
    for k in range(8):
        dz, dy, dx = k >> 2, (k >> 1) & 1, k & 1
        off.append((zi[dz] * h + yi[dy]) * w + xi[dx])
        wts.append(((wx[dx] * wy[dy]).astype(F) * wz[dz]).astype(F))
    return weigh_texels(texels, channels, off, wts)


def mirror_tex2(texels, dims, channels, clamp, strides, qu, qv):
    h, w = dims
    sy, sx = strides
    xi, wx = tex_axis(qu, w, clamp, sx)
    yi, wy = tex_axis(qv, h, clamp, sy)
    off, wts = [], []
    for k in range(4):
        dy, dx = k >> 1, k & 1
        off.append(yi[dy] * w + xi[dx])
        wts.append((wx[dx] * wy[dy]).astype(F))
    return weigh_texels(texels, channels, off, wts)


def _bits(t):
    """A texture's texels as the kernel reads them: float32, or bfloat16's
    bits as uint16."""
    return bf16_bits(t) if t.dtype == torch.bfloat16 else t.numpy()


# ---- K7 -----------------------------------------------------------------------

TEX3_KINDS = {
    # kind: (volume dims, channels, the JAX table's brick and stride)
    "2ch": ((13, 16, 10), 2, (4, 4, 4), (3, 3, 3)),
    "1ch": ((16, 11, 14), 1, (8, 4, 4), (7, 3, 3)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wrap", ["repeat", "clamp"])
@pytest.mark.parametrize("kind", sorted(TEX3_KINDS))
def test_tex3_mirror(kind, wrap, dtype):
    """The mirror against the plain version (bitwise), the brick kernel's
    mirror on the port's brick table of the same texels (bitwise) and
    JAX's `sample_brick3_xyz` on JAX's table (atol 1e-6)."""
    dims, c, brick, stride = TEX3_KINDS[kind]
    rng = np.random.default_rng(zlib.crc32(f"tex3 {kind} {wrap} {dtype}".encode()))
    vol = rng.random(dims + (c,)).astype(F)
    bf16 = dtype == "bfloat16"
    tex = tbrick.build_texture3(torch.from_numpy(vol), wrap=wrap)
    bt = tbrick.build_brick3(torch.from_numpy(vol), brick, stride, wrap=wrap)
    if bf16:
        tex = tbrick.Texture3D(texels=tex.texels.to(torch.bfloat16), dims=tex.dims,
                               channels=c, wrap=wrap)
        bt = tbrick.BrickTable3D(table=bt.table.to(torch.bfloat16), dims=bt.dims,
                                 brick=brick, stride=stride, grid=bt.grid,
                                 channels=c, wrap=wrap)
    assert tex.dims == dims and tex.channels == c
    qx, qy, qz = planes(dims, 21)
    want = mirror_tex3(_bits(tex.texels), dims, c, wrap == "clamp",
                       tbrick.WEIGHT_STRIDES[(3, c)], qx, qy, qz)
    plain = tbrick.sample_tex3_xyz(tex, *map(torch.from_numpy, (qx, qy, qz)))
    np.testing.assert_array_equal(want, plain.numpy())
    np.testing.assert_array_equal(want, mirror_brick3(
        _bits(bt.table), dims, brick, stride, bt.grid, c, wrap == "clamp", qx, qy, qz))
    jt = jbrick.build_brick3_device(to_jax(vol, bf16), brick, stride, wrap=wrap)
    jax_out = np.asarray(jbrick.sample_brick3_xyz(jt, *map(jnp.asarray, (qx, qy, qz))))
    np.testing.assert_allclose(want, jax_out, atol=ATOL, rtol=0)


# ---- K8 -----------------------------------------------------------------------

TEX2_KINDS = {
    # kind: (image dims, channels, the JAX table's brick and stride, scale)
    "2ch": ((37, 64), 2, (8, 8), (7, 7), 1.0),
    "8ch": ((24, 29), 8, (4, 4), (3, 3), 40.0),
}


@pytest.mark.parametrize("wrap", ["repeat", "clamp"])
@pytest.mark.parametrize("kind", sorted(TEX2_KINDS))
def test_tex2_mirror(kind, wrap):
    """As `test_tex3_mirror`, in 2-D; the 8-channel pairs carry HDR values,
    held to JAX at 1e-6 absolute plus 1e-6 relative."""
    dims, c, brick, stride, scale = TEX2_KINDS[kind]
    rng = np.random.default_rng(zlib.crc32(f"tex2 {kind} {wrap}".encode()))
    img = (rng.random(dims + (c,)) * scale).astype(F)
    tex = tbrick.build_texture2(torch.from_numpy(img), wrap=wrap)
    bt = tbrick.build_brick2(torch.from_numpy(img), brick, stride, wrap=wrap)
    qu, qv = planes(dims, 22)
    want = mirror_tex2(tex.texels.numpy(), dims, c, wrap == "clamp",
                       tbrick.WEIGHT_STRIDES[(2, c)], qu, qv)
    plain = tbrick.sample_tex2_xy(tex, torch.from_numpy(qu), torch.from_numpy(qv))
    np.testing.assert_array_equal(want, plain.numpy())
    np.testing.assert_array_equal(want, mirror_brick2(
        bt.table.numpy(), dims, brick, stride, bt.grid, c, wrap == "clamp", qu, qv))
    jt = jbrick.build_brick2_device(jnp.asarray(img), brick, stride, wrap=wrap)
    jax_out = np.asarray(jbrick.sample_brick2_xy(jt, jnp.asarray(qu), jnp.asarray(qv)))
    np.testing.assert_allclose(want, jax_out, atol=ATOL,
                               rtol=ATOL if scale > 1.0 else 0.0)
    uv = torch.from_numpy(np.stack([qu, qv], axis=-1))
    np.testing.assert_array_equal(tbrick.sample_tex2(tex, uv).numpy(), want)


def test_tex_mirror_edges_are_reached():
    """The inputs reach f = 0 at texel centres, f = 1 under repeat just below
    0, and under clamp both edges with their second texel clamped, on each
    axis; under repeat the second texel wraps to 0."""
    for n in (10, 16, 13):
        q = planes((n,), 0)[0]
        (i0, i1), _ = tex_axis(q, n, False, 3)
        assert ((i0 == n - 1) & (i1 == 0)).any()
        i, f = axis_coords(q, n, True)
        assert ((i == 0) & (f == 0)).any() and ((i == n - 2) & (f == 1)).any()
    (i0, i1), (w0, w1) = tex_axis(np.array([-0.5, 0.5, 1.5], F), 1, True, 3)
    np.testing.assert_array_equal(i1, 0)


def test_weight_strides_are_jax_tables():
    """`WEIGHT_STRIDES` are the strides of the tables JAX's `BrickPack` and
    engine build for each (ndim, channels): the large and small noise, the
    weather, the cone cache and the display pairs."""
    from cloudscape_tpu import engine as jengine
    from cloudscape_tpu.models.packs import make_noise_pack
    from cloudscape_tpu.ops.noise import (generate_base_noise, generate_detail_noise,
                                          generate_weather)
    jn = make_noise_pack(generate_base_noise(16, seed=1),
                         generate_detail_noise(16, seed=2), generate_weather(64, seed=3))
    jb = jmf.BrickPack.from_noise(jn)
    ring = jnp.zeros((3, 8, 8, 4))
    pair, _ = jengine._build_display_pair(ring, jnp.int32(0), jnp.int32(1), ring,
                                          jnp.int32(0), jnp.int32(1))
    tables = [jb.large[0], jb.small[0], jb.weather, pair]
    got = {(len(t.dims), t.channels): tuple(t.stride) for t in tables}
    got[(3, 1)] = tuple(jmf.CONE_STRIDE)
    assert got == tbrick.WEIGHT_STRIDES


# ---- the wrappers' plumbing ---------------------------------------------------

def _run_tex_entry(entry: str, texels, args):
    """Read a texture entry's arguments as csrc/sample.cu does and run the
    mirror: the [n, C] samples it would write, and the weight strides it
    was given."""
    tex = _floats(args[0], texels.numel(), np.uint16 if args[1] else F)
    geom = list(args[2])
    n = args[-1]
    qs = [_floats(ptr, n) for ptr in args[3:-2]]
    if entry == "tex3":
        d, h, w, c, clamp, *strides = geom
        return mirror_tex3(tex, (d, h, w), c, bool(clamp), strides, *qs), tuple(strides)
    h, w, c, clamp, *strides = geom
    return mirror_tex2(tex, (h, w), c, bool(clamp), strides, *qs), tuple(strides)


@pytest.mark.parametrize("wrap", ["repeat", "clamp"])
@pytest.mark.parametrize("layout", ["contiguous", "component", "transposed"])
@pytest.mark.parametrize("entry", ["tex3", "tex2"])
def test_tex_kernel_args_reach_the_mirror(entry, layout, wrap):
    """The wrappers' C arguments, read back by a stand-in entry, give the
    mirror's samples: the geometry (dims, C, clamp, and the weight strides
    `WEIGHT_STRIDES` gives the texture), contiguous planes (a view is
    copied), the output [..., C]."""
    rng = np.random.default_rng(6)
    if entry == "tex3":
        vol = torch.from_numpy(rng.random((13, 16, 10, 2)).astype(F))
        tex = tbrick.build_texture3(vol, wrap=wrap)
        tex = tbrick.Texture3D(texels=tex.texels.to(torch.bfloat16), dims=tex.dims,
                               channels=2, wrap=wrap)
        fn = tbrick.sample_tex3_xyz
    else:
        img = torch.from_numpy((rng.random((24, 29, 8)) * 40.0).astype(F))
        tex = tbrick.build_texture2(img, wrap=wrap)
        fn = tbrick.sample_tex2_xy
    qs = [_views(q, layout) for q in planes(tex.dims, 23)]
    geom = tbrick._tex_geom(tex)
    out, args, held = tbrick.kernel_args(entry, tex.texels, tex.texels.numel(), geom,
                                         tex.channels, qs)
    assert out.shape == qs[0].shape + (tex.channels,)
    assert all(h.is_contiguous() for h in held)
    assert list(args[3:-2]) == [h.data_ptr() for h in held]
    assert args[1] == int(tex.texels.dtype == torch.bfloat16)
    assert list(args[2])[len(tex.dims) + 1] == int(wrap == "clamp")
    got, strides = _run_tex_entry(entry, tex.texels, args)
    assert strides == tbrick.WEIGHT_STRIDES[(len(tex.dims), tex.channels)]
    want = fn(tex, *qs)
    np.testing.assert_array_equal(got.reshape(want.shape), want.numpy())
    del held


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", [1, 2, 3, 8])
@pytest.mark.parametrize("entry", ["tex3", "tex2"])
def test_tex_kernel_args_kinds(entry, channels, dtype):
    """The texture kernels are compiled for the main path's pairs: K7 1 or
    2 channels, f32 or bfloat16; K8 2 or 8 channels, f32. Any other pair
    raises before a launch."""
    torch_dtype = getattr(torch, dtype)
    want = {"tex3": channels in (1, 2),
            "tex2": channels in (2, 8) and dtype == "float32"}[entry]
    assert ((channels, torch_dtype) in tbrick.KERNEL_KINDS[entry]) == want
    if entry == "tex3":
        tex = tbrick.build_texture3(torch.rand(4, 5, 6, channels).to(torch_dtype))
    else:
        tex = tbrick.build_texture2(torch.rand(5, 6, channels).to(torch_dtype))
    qs = [torch.rand(10)] * len(tex.dims)
    if want:
        geom = tbrick._tex_geom(tex)
        out, args, _ = tbrick.kernel_args(entry, tex.texels, tex.texels.numel(), geom,
                                          channels, qs)
        assert out.shape == (10, channels) and tuple(args[2]) == geom
    else:
        with pytest.raises(ValueError, match="no kernel"):
            tbrick.kernel_args(entry, tex.texels, tex.texels.numel(),
                               tbrick._tex_geom(tex), channels, qs)


def test_textures_are_the_source_aligned():
    """A texture is its source when that is contiguous and 16-B aligned (no
    gather, no copy); an unaligned source is copied to an aligned one; and
    `kernel_args` raises on unaligned texels, which the kernels' vector
    loads cannot read."""
    vol = torch.rand(4, 5, 6, 2)
    assert tbrick.build_texture3(vol).texels.data_ptr() == vol.data_ptr()
    off = torch.rand(1 + 5 * 6 * 8)[1:].reshape(5, 6, 8)
    assert off.data_ptr() % 16 and off.is_contiguous()
    tex = tbrick.build_texture2(off, wrap="clamp")
    assert tex.texels.data_ptr() % 16 == 0 and torch.equal(tex.texels, off)
    bad = tbrick.Texture2D(texels=off, dims=(5, 6), channels=8, wrap="clamp")
    q = torch.rand(10)
    with pytest.raises(ValueError, match="aligned"):
        tbrick.kernel_args("tex2", bad.texels, bad.texels.numel(),
                           tbrick._tex_geom(bad), 8, [q, q])


def test_tex_samplers_raise_off_cpu_and_cuda():
    """A plane on a device that is neither the CPU nor a card raises; there
    is no fallback."""
    q = torch.empty(10, device="meta")
    with pytest.raises(ValueError):
        tbrick.sample_tex3_xyz(tbrick.build_texture3(torch.rand(4, 4, 4, 2)), q, q, q)
    with pytest.raises(ValueError):
        tbrick.sample_tex2_xy(tbrick.build_texture2(torch.rand(4, 4, 8)), q, q)


def test_tex_cpu_planes_take_the_plain_version():
    """On CPU tensors the texture samplers are their plain versions, bitwise,
    and launch nothing."""
    rng = np.random.default_rng(10)
    tex = tbrick.build_texture3(torch.from_numpy(rng.random((10, 12, 9, 1)).astype(F)),
                                wrap="clamp")
    qs = [torch.from_numpy(q) for q in planes((10, 12, 9), 24)]
    before = dict(tbrick.launches), dict(tbrick.samples)
    assert torch.equal(tbrick.sample_tex3_xyz(tex, *qs),
                       tbrick.sample_tex3_xyz_reference(tex, *qs))
    assert (tbrick.launches, tbrick.samples) == before
