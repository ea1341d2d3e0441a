"""Kernel K3's plain version ≡ the JAX segmented scan, on the CPU.

`cloudscape_tpu_torch.ops.segscan.segscan` takes its plain PyTorch version
(an f64 cumsum minus the cumsum at each segment start) for CPU tensors; the
CUDA kernel (`csrc/segscan.cu`) is held against that plain version on the
card by `chip_smoke.py`. Here the plain version meets, on
tests/test_segscan_pallas.py's five cases (inputs from numpy seeds):

- the Pallas kernel `segscan_sum_pallas` in interpret mode, atol 2e-4;
- the XLA `associative_scan` over the `seg_sum` monoid, atol 2e-4;
- a sequential f64 loop, rtol 1e-4 + atol 2e-4;
- on every-element-its-own-segment, `values` bit for bit;
- as a `[3, n]` call (the march's three radiance rows over one set of
  heads): each row bitwise the 1-D call and within atol 2e-4 of the Pallas
  kernel in interpret mode.

The kernel's launch plan (`segscan_plan`) is plain Python and is checked
here too.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax

from cloudscape_tpu.ops.segscan_pallas import LANES, ROWS, segscan_sum_pallas
from cloudscape_tpu_torch.ops import segscan as segscan_mod
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


@pytest.mark.parametrize("name", list(CASES))
def test_segscan_rows_match_1d_and_pallas(name):
    """A [3, n] call: the case's values scaled by 1, 0.5 and -1 (exact in
    f32). Each row equals the 1-D call bitwise and the Pallas kernel within
    atol 2e-4."""
    values, heads, _ = _case(name)
    rows = np.stack([values, values * np.float32(0.5), -values])
    h = torch.from_numpy(heads)
    got = segscan(torch.from_numpy(rows), h).numpy()
    assert got.dtype == np.float32 and got.shape == rows.shape
    for r in range(3):
        np.testing.assert_array_equal(got[r], segscan(torch.from_numpy(rows[r]), h).numpy())
        want = np.asarray(segscan_sum_pallas(jnp.asarray(rows[r]), jnp.asarray(heads),
                                             interpret=True))
        np.testing.assert_allclose(got[r], want, rtol=0, atol=2e-4)


def test_segscan_rows_edges():
    """[1, n] and [4, n] keep their shape and equal the 1-D calls; no
    elements gives an empty [k, 0]."""
    rng = np.random.default_rng(5)
    v = torch.from_numpy(rng.normal(size=(4, 333)).astype(np.float32))
    h = torch.from_numpy(rng.random(333) < 0.05)
    got = segscan(v, h)
    assert got.shape == (4, 333)
    for r in range(4):
        np.testing.assert_array_equal(got[r].numpy(), segscan(v[r], h).numpy())
    np.testing.assert_array_equal(segscan(v[:1], h).numpy(), got[:1].numpy())
    assert segscan(v[:2, :0], h[:0]).shape == (2, 0)


@pytest.mark.parametrize("values, heads", [
    (torch.zeros(5, 16), torch.zeros(16, dtype=torch.bool)),      # k = 5
    (torch.zeros(3, 16), torch.zeros(15, dtype=torch.bool)),      # heads' length
    (torch.zeros(2, 3, 16), torch.zeros(16, dtype=torch.bool)),   # 3-D values
    (torch.zeros(16, dtype=torch.float64), torch.zeros(16, dtype=torch.bool)),
    (torch.zeros(16), torch.zeros(16, dtype=torch.int32)),        # int heads
], ids=["k5", "heads_length", "values_3d", "values_f64", "heads_int32"])
def test_segscan_rejects_bad_inputs(values, heads):
    """Shape and dtype checks run for CPU tensors too."""
    with pytest.raises(ValueError):
        segscan(values, heads)


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 425_984, 819_200, 1_000_003,
                               1_736_704, 6_000_001])
@pytest.mark.parametrize("sms", [1, 132])
def test_segscan_plan_covers_every_element_once(n, sms):
    """The kernel's launch plan: the blocks' ranges cover [0, n) exactly
    once with no empty block, no more blocks than BLOCKS_PER_SM per SM, the
    ranges do not depend on the row count, and a block's stash holds all of
    its rows or nothing."""
    plans = [segscan_mod.segscan_plan(n, k, sms) for k in range(1, 5)]
    assert len({p[:2] for p in plans}) == 1
    rounds, blocks, _ = plans[0]
    per_block = rounds * segscan_mod.BLOCK_ROUND
    assert 1 <= blocks <= segscan_mod.BLOCKS_PER_SM * sms
    assert blocks * per_block >= n and (n == 0 or (blocks - 1) * per_block < n)
    for k, (_, _, stash) in enumerate(plans, 1):
        assert stash in (0, 4 * k * per_block) and stash <= segscan_mod.STASH_BYTES
