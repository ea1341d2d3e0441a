"""PyTorch port ≡ JAX package: brick tables, brick samplers, atmosphere LUTs.

Tables are pure gathers and must equal the JAX ones bitwise; filtered
samples agree at 1e-6 (the 128-lane weight reduction sums in another order).
The transmittance and sky-view LUTs are held to ≥ 80 and ≥ 60 dB against the
JAX functions, the bars `test_atmosphere` sets against the f64 oracle.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cloudscape_tpu.models import atmosphere as jatmo
from cloudscape_tpu.ops import brick as jbrick
from cloudscape_tpu.utils.image import psnr
from cloudscape_tpu_torch.models import atmosphere as tatmo
from cloudscape_tpu_torch.ops import brick as tbrick
from cloudscape_tpu_torch.ops.sampling import sample2d as tsample2d
from cloudscape_tpu.ops.sampling import sample2d as jsample2d

# Several test workers share the host's cores: keep torch's intra-op
# thread pool small so they do not oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))
# The port's entry points default to the card: these tests ask for the CPU.
DEV = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _coords(n, seed, lo=-1.5, hi=2.5):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, hi, n).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape,brick,stride,wrap", [
    ((16, 16, 16, 2), (4, 4, 4), (3, 3, 3), "repeat"),
    ((8, 12, 20, 1), (8, 4, 4), (7, 3, 3), "repeat"),
    ((8, 64, 64, 1), (8, 4, 4), (7, 3, 3), "clamp"),
])
def test_brick3_table_and_samples(shape, brick, stride, wrap):
    vol = np.random.default_rng(0).random(shape).astype(np.float32)
    if wrap == "repeat":
        jt = jbrick.build_brick3(vol, brick, stride)
    else:
        jt = jbrick.build_brick3_device(jnp.asarray(vol), brick, stride, wrap=wrap)
    tt = tbrick.build_brick3(_t(vol), brick, stride, wrap=wrap)
    np.testing.assert_array_equal(tt.table.numpy(), np.asarray(jt.table))
    assert tt.grid == tuple(jt.grid)
    qx, qy, qz = _coords(20000, 1)
    want = np.asarray(jbrick.sample_brick3_xyz(jt, *map(jnp.asarray, (qx, qy, qz))))
    got = tbrick.sample_brick3_xyz(tt, *map(_t, (qx, qy, qz))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_brick3_rows_reassemble_table():
    vol = _t(np.random.default_rng(2).random((8, 64, 64, 1)).astype(np.float32))
    full = tbrick.build_brick3(vol, (8, 4, 4), (7, 3, 3), wrap="clamp").table
    nb = full.shape[0]
    rows = [tbrick.build_brick3_rows(vol, min(b0, nb - 300), 300, (8, 4, 4),
                                     (7, 3, 3), wrap="clamp")
            for b0 in range(0, nb, 300)]
    table = torch.zeros_like(full)
    for b0, r in zip(range(0, nb, 300), rows):
        table[min(b0, nb - 300):min(b0, nb - 300) + 300] = r
    assert torch.equal(table, full)


def test_brick2_and_tiny3_samples():
    rng = np.random.default_rng(3)
    img = rng.random((64, 64, 2)).astype(np.float32)
    jt = jbrick.build_brick2(img)
    tt = tbrick.build_brick2(_t(img))
    np.testing.assert_array_equal(tt.table.numpy(), np.asarray(jt.table))
    qu, qv, _ = _coords(20000, 4)
    np.testing.assert_allclose(
        tbrick.sample_brick2_xy(tt, _t(qu), _t(qv)).numpy(),
        np.asarray(jbrick.sample_brick2_xy(jt, jnp.asarray(qu), jnp.asarray(qv))),
        atol=1e-6, rtol=0)
    for shape in ((4, 4, 4, 2), (2, 2, 2, 1), (1, 1, 1, 2)):
        vol = rng.random(shape).astype(np.float32)
        jv, tv = jbrick.build_tiny3(vol), tbrick.build_tiny3(_t(vol))
        q = _coords(5000, shape[0])
        np.testing.assert_allclose(
            tbrick.sample_tiny3_xyz(tv, *map(_t, q)).numpy(),
            np.asarray(jbrick.sample_tiny3_xyz(jv, *map(jnp.asarray, q))),
            atol=1e-6, rtol=0)


@pytest.mark.parametrize("wrap", ["repeat", "clamp"])
def test_sample2d(wrap):
    rng = np.random.default_rng(6)
    tex = rng.random((24, 40, 3)).astype(np.float32)
    uv = rng.uniform(-0.5, 1.5, (5000, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tsample2d(_t(tex), _t(uv), wrap).numpy(),
        np.asarray(jsample2d(jnp.asarray(tex), jnp.asarray(uv), wrap)),
        atol=1e-6, rtol=0)


def test_transmittance_lut():
    want = np.asarray(jatmo.transmittance_lut())
    got = tatmo.transmittance_lut(device=DEV).numpy()
    assert got.shape == want.shape == (64, 256, 4)
    assert psnr(got, want) >= 80.0


@pytest.mark.parametrize("sun", [(0.3, 0.5, -0.8), (0.0, -0.05, 1.0)])
def test_sky_lut(sun):
    sun = np.asarray(sun, np.float32) / np.linalg.norm(sun)
    jt = jatmo.transmittance_lut()
    tt = _t(np.asarray(jt))
    want = np.asarray(jatmo.sky_lut(jt, jnp.asarray(sun)))
    got = tatmo.sky_lut(tt, _t(sun)).numpy()
    assert got.shape == want.shape == (100, 200, 4)
    assert np.isfinite(got).all()
    assert psnr(got, want) >= 60.0
    # Row bands are the whole render. Not bitwise: torch's CPU math kernels
    # take a vectorised path for most elements and a scalar one for the
    # tail, which can differ by an ulp, so a texel's bits depend on its
    # position in the tensor. The engine renders every LUT through the same
    # bands, so its prebaked and synchronous LUTs are the same bits.
    bands = torch.cat([tatmo.sky_lut_rows(tt, _t(sun), r0, rows=25)
                       for r0 in range(0, 100, 25)])
    np.testing.assert_allclose(bands.numpy(), got, rtol=1e-5, atol=1e-7)
