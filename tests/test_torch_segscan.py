"""Kernel K3's plain version ≡ the JAX segmented scan, on the CPU.

`cloudscape_tpu_torch.ops.segscan.segscan` takes its plain PyTorch version
(an f64 cumsum minus the cumsum at each segment start) for CPU tensors; the
CUDA kernel (`csrc/segscan.cu`) is held against that plain version on the
card by `chip_smoke.py`. Here the plain version meets, on
tests/test_segscan_pallas.py's five cases (inputs from numpy seeds):

- the Pallas kernel `segscan_sum_pallas` in interpret mode, atol 2e-4;
- the XLA `associative_scan` over the `seg_sum` monoid, atol 2e-4;
- a sequential f64 loop, rtol 1e-4 + atol 2e-4;
- on every-element-its-own-segment, `values` bit for bit.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax

from cloudscape_tpu.ops.segscan_pallas import LANES, ROWS, segscan_sum_pallas
from cloudscape_tpu_torch.ops.segscan import segscan

# Several test workers share the host's cores: keep torch's intra-op
# thread pool small so they do not oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))


def _single_tile():
    rng = np.random.default_rng(0)
    n = ROWS * LANES
    heads = rng.random(n) < 0.01
    heads[0] = True
    return rng.normal(size=n).astype(np.float32), heads


def _multi_tile():
    # One segment spanning tiles plus a few short ones: the cross-tile carry.
    rng = np.random.default_rng(1)
    n = 3 * ROWS * LANES
    heads = np.zeros(n, bool)
    heads[[0, 5, n - 100]] = True
    return (rng.normal(size=n) * 0.1).astype(np.float32), heads


def _mid_row_head():
    # A head mid-row: that row's earlier elements keep the earlier carry.
    n = ROWS * LANES
    heads = np.zeros(n, bool)
    heads[[0, LANES + 50]] = True
    return np.ones(n, np.float32), heads


def _ragged_tail():
    rng = np.random.default_rng(2)
    n = ROWS * LANES + 777
    heads = rng.random(n) < 0.002
    heads[0] = True
    return rng.normal(size=n).astype(np.float32), heads


def _own_segments():
    rng = np.random.default_rng(3)
    n = ROWS * LANES
    return rng.normal(size=n).astype(np.float32), np.ones(n, bool)


CASES = {
    "single_tile_random_segments": _single_tile,
    "multi_tile_cross_tile_carry": _multi_tile,
    "heads_mid_row_inherit_earlier_rows": _mid_row_head,
    "ragged_tail": _ragged_tail,
    "every_element_its_own_segment": _own_segments,
}


@functools.lru_cache(maxsize=None)
def _case(name):
    values, heads = CASES[name]()
    got = segscan(torch.from_numpy(values), torch.from_numpy(heads)).numpy()
    return values, heads, got


@jax.jit
def _xla_segscan_jit(values, heads):
    def seg_sum(a, b):
        return jnp.where(b[1], b[0], a[0] + b[0]), a[1] | b[1]

    return lax.associative_scan(seg_sum, (values, heads))[0]


def _xla_segscan(values, heads):
    return np.asarray(_xla_segscan_jit(jnp.asarray(values, jnp.float32),
                                       jnp.asarray(heads, bool)))


def _f64_loop(values, heads):
    out = np.zeros(values.shape, np.float64)
    run = 0.0
    for i, (v, h) in enumerate(zip(values.astype(np.float64), heads)):
        run = v if h else run + v
        out[i] = run
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_segscan_matches_pallas_interpret(name):
    values, heads, got = _case(name)
    want = np.asarray(segscan_sum_pallas(jnp.asarray(values), jnp.asarray(heads),
                                         interpret=True))
    assert got.dtype == np.float32 and got.shape == values.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("name", list(CASES))
def test_segscan_matches_xla_associative_scan(name):
    values, heads, got = _case(name)
    np.testing.assert_allclose(got, _xla_segscan(values, heads), rtol=0, atol=2e-4)


@pytest.mark.parametrize("name", list(CASES))
def test_segscan_matches_f64_loop(name):
    values, heads, got = _case(name)
    np.testing.assert_allclose(got, _f64_loop(values, heads), rtol=1e-4, atol=2e-4)


def test_segscan_own_segments_bitwise():
    values, _, got = _case("every_element_its_own_segment")
    np.testing.assert_array_equal(got, values)


def test_segscan_edges():
    """No head at all (one segment from the start), one element, none."""
    v = torch.tensor([1.0, 2.0, -0.5, 4.0])
    h = torch.zeros(4, dtype=torch.bool)
    np.testing.assert_array_equal(segscan(v, h).numpy(), [1.0, 3.0, 2.5, 6.5])
    np.testing.assert_array_equal(segscan(v[:1], h[:1]).numpy(), [1.0])
    assert segscan(v[:0], h[:0]).shape == (0,)
