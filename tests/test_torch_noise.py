"""PyTorch port ≡ JAX package: procedural noise, math and octmap helpers.

The port carries the PCG3D hash in int64 masked to 32 bits and multiplies
by 16-bit halves (`_mul32`); the hash must equal the JAX uint32 hash
bitwise, wrap edges included. The generated volumes agree at atol 2e-5 (the
bar of tests/test_noise_pallas.py); both sides run the same f32 formulas,
and the measured gap is ~4e-7.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cloudscape_tpu.ops import math as jmath
from cloudscape_tpu.ops import noise as jnoise
from cloudscape_tpu.ops import octmap as joct
from cloudscape_tpu_torch.ops import math as tmath
from cloudscape_tpu_torch.ops import noise as tnoise
from cloudscape_tpu_torch.ops import octmap as toct

# Several test workers share the host's cores: keep torch's intra-op
# thread pool small so they do not oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))
# The port's entry points default to the card: these tests ask for the CPU.
DEV = torch.device("cpu")

_EDGES = np.array([
    [0, 0, 0],
    [2**32 - 1, 2**32 - 1, 2**32 - 1],
    [2**31, 2**31 - 1, 1],
    [2**32 - 1, 0, 2**32 - 1],
    [0xFFFF, 0x10000, 0xFFFF0000],
    [12345, 2**32 - 2, 7],
], dtype=np.uint64)


def _pcg_inputs(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([_EDGES, rng.integers(0, 2**32, (4096, 3),
                                                dtype=np.uint64)])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pcg3d_bitwise(seed):
    v = _pcg_inputs(seed)
    want = np.asarray(jnoise._pcg3d(jnp.asarray(v.astype(np.uint32))))
    got = tnoise._pcg3d(*(torch.from_numpy(v[:, i].astype(np.int64))
                          for i in range(3)))
    np.testing.assert_array_equal(
        np.stack([g.numpy() for g in got], -1), want.astype(np.int64))


def test_mul32_is_the_low_word_of_the_product():
    v = _pcg_inputs(3)
    a, b = v[:, 0], v[:, 1]
    want = (a.astype(object) * b.astype(object)) % (1 << 32)
    got = tnoise._mul32(torch.from_numpy(a.astype(np.int64)),
                        torch.from_numpy(b.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("period,seed", [(4, 0), (7, 101), (32, 0x7FFFFFFF)])
def test_lattice_rand3_bitwise(period, seed):
    """Negative cells and cells past the period wrap identically."""
    rng = np.random.default_rng(period)
    cells = rng.integers(-3 * period, 3 * period, (2048, 3)).astype(np.int32)
    want = np.asarray(jnoise._lattice_rand3(jnp.asarray(cells), period, seed))
    got = tnoise._lattice_rand3(*(torch.from_numpy(cells[:, i]) for i in range(3)),
                                period, seed)
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got], -1), want)


@pytest.mark.parametrize("fn,size,seed", [
    ("generate_base_noise", 16, 1),
    ("generate_detail_noise", 16, 2),
    ("generate_weather", 64, 3),
    ("generate_weather", 32, 11),
])
def test_volumes_match(fn, size, seed):
    want = np.asarray(getattr(jnoise, fn)(size, seed))
    got = getattr(tnoise, fn)(size, seed).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_hash_iq_and_gradients_bitwise():
    """Unfused f32 ops in the same order give the same bits."""
    rng = np.random.default_rng(4)
    p = (rng.standard_normal((4096, 3)) * 50).astype(np.float32)
    np.testing.assert_array_equal(tmath.hash_iq(torch.from_numpy(p)).numpy(),
                                  np.asarray(jmath.hash_iq(jnp.asarray(p))))
    ct = rng.random(4096).astype(np.float32)
    hf = rng.random(4096).astype(np.float32)
    np.testing.assert_allclose(
        tmath.density_height_gradient(torch.from_numpy(hf), torch.from_numpy(ct)).numpy(),
        np.asarray(jmath.density_height_gradient(jnp.asarray(hf), jnp.asarray(ct))),
        atol=1e-6, rtol=0)


def test_octmap_matches():
    got = toct.texel_directions(96, x0=96, y0=192, width=96, height=48,
                                device=DEV).numpy()
    want = np.asarray(joct.texel_directions(96, x0=96, y0=192, width=96, height=48))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    rng = np.random.default_rng(5)
    d = rng.standard_normal((4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(toct.world_dir_to_uv(torch.from_numpy(d)).numpy(),
                               np.asarray(joct.world_dir_to_uv(jnp.asarray(d))),
                               atol=1e-6, rtol=0)
