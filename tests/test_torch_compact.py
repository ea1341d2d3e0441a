"""Kernel K2's plain version ≡ the JAX compaction, bitwise, on the CPU.

`cloudscape_tpu_torch.ops.compact.compact` takes its plain PyTorch version
for CPU tensors; the CUDA kernel (`csrc/compact.cu`) is held against that
plain version, bitwise, on the card by `chip_smoke.py`. Here the plain
version meets `jnp.nonzero(size=, fill_value=)` and the XLA
`_compact_indices` of the JAX march on tests/test_compact_pallas.py's cases
(including overflow, empty and full masks), plus lengths that are no
multiple of 128; the rank is the exclusive cumsum of the mask, and asked
for no rank the wrapper returns the same idx and None.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cloudscape_tpu.models.march_fast import _compact_indices
from cloudscape_tpu_torch.models.march_fast import _compact_mask
from cloudscape_tpu_torch.ops import compact

# Several test workers share the host's cores: keep torch's intra-op
# thread pool small so they do not oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))

_CASES = [
    # (n, capacity, occupancy) — test_compact_pallas.py's, then ragged ones
    (256 * 128, 4 * 128, 0.1),
    (512 * 128, 8 * 128, 0.3),
    (512 * 128, 2 * 128, 0.5),    # overflow: capacity < active count
    (256 * 128, 4 * 128, 0.0),    # empty
    (256 * 128, 4 * 128, 1.0),    # full
    (10_007, 3_000, 0.2),         # n no multiple of 128
    (12_345, 9_000, 0.9),         # ragged and overflowing
    (777, 1_024, 0.5),            # capacity > n
]


@pytest.mark.parametrize("n,cap,p", _CASES)
def test_plain_matches_jax(n, cap, p):
    rng = np.random.default_rng(n + cap)
    mask = rng.random(n) < p
    want = np.asarray(jnp.nonzero(jnp.asarray(mask), size=cap, fill_value=n)[0])
    want_xla = np.asarray(_compact_indices(jnp.asarray(mask), cap, n))
    np.testing.assert_array_equal(want_xla, want)
    idx, rank = compact.compact(torch.from_numpy(mask), cap, n)
    assert idx.dtype == rank.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(rank.numpy(), np.cumsum(mask) - mask)
    np.testing.assert_array_equal(
        _compact_mask(torch.from_numpy(mask), cap, n).numpy(), want)


@pytest.mark.parametrize("n,cap,p", _CASES)
def test_without_rank_same_idx(n, cap, p):
    """`with_rank=False` gives the same idx and no rank, through the plain
    version and through `_compact_mask` (which asks for no rank)."""
    mask = torch.from_numpy(np.random.default_rng(n + cap + 1).random(n) < p)
    want, _ = compact.compact(mask, cap, n)
    idx, rank = compact.compact(mask, cap, n, with_rank=False)
    assert rank is None and torch.equal(idx, want)
    idx_ref, rank_ref = compact.compact_reference(mask, cap, n, with_rank=False)
    assert rank_ref is None and torch.equal(idx_ref, want)
    assert torch.equal(_compact_mask(mask, cap, n), want)


def test_uint8_mask_and_other_devices():
    mask = torch.tensor([0, 3, 0, 1, 1], dtype=torch.uint8)
    idx, rank = compact.compact(mask, 4, 5)
    assert idx.tolist() == [1, 3, 4, 5]
    assert rank.tolist() == [0, 0, 1, 1, 2]
    with pytest.raises(ValueError):
        compact.compact(torch.zeros(8, dtype=torch.bool, device="meta"), 4, 8)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 3_001, 5_000, 589_824, 8_388_608, 40_000_000])
@pytest.mark.parametrize("misalign", [0, 3, 4, 15])
@pytest.mark.parametrize("sms", [1, 132])
def test_compact_plan_covers_every_element_once(n, misalign, sms):
    """The kernel's launch plan: the blocks' word ranges cover the words
    [0, words) exactly once, the words cover the mask's n bytes from its
    16-B aligned start exactly once, no more blocks than BLOCKS_PER_SM per
    SM, and a block's stash is all of its range or nothing."""
    words, wpb, blocks, stash = compact.compact_plan(n, misalign, sms)
    assert 1 <= blocks <= compact.BLOCKS_PER_SM * sms
    starts = np.arange(blocks) * wpb
    ends = np.minimum(words, starts + wpb)
    covered = np.zeros(words, np.int64)
    for s, e in zip(starts, ends):
        covered[s:max(s, e)] += 1
    assert (covered == 1).all()
    # Word w holds elements 16w - misalign ... 16w - misalign + 15.
    elems = 16 * words - misalign if words else 0
    assert elems >= n and (words == 0 or 16 * (words - 1) - misalign < n)
    assert stash in (0, 16 * wpb) and stash <= compact.STASH_BYTES
    if n and n <= compact.MIN_WORDS_PER_BLOCK * 16 - misalign:
        assert blocks == 1
