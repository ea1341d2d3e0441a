"""Kernel K1's plain version ≡ the JAX accumulation, on the CPU.

`cloudscape_tpu_torch.ops.accum.accumulate` takes its plain PyTorch version
for CPU tensors; the CUDA kernel (`csrc/accum.cu`) is held against that plain
version on the card by `chip_smoke.py`. Here the plain version meets:

- `accumulate_reference` (the TPU kernel's jnp mirror) on the cases of
  tests/test_accum_pallas.py, plus rays masked by `above`, at atol 2e-5;
- the XLA `accum_chunk` the JAX march runs on a CPU (`t / max(1e-7, t)`
  where the kernel takes `A < 0`), through both packages'
  `_accumulate_phase3`, at atol 2e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cloudscape_tpu.models import march_fast as jmf
from cloudscape_tpu.models.density import MarchParams as JParams
from cloudscape_tpu.ops.accum_pallas import BLOCK, STEPS, accumulate_reference
from cloudscape_tpu_torch.models import march_fast as tmf
from cloudscape_tpu_torch.models.density import MarchParams as TParams
from cloudscape_tpu_torch.ops import accum

# Several test workers share the host's cores: keep torch's intra-op
# thread pool small so they do not oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))
# The port's entry points default to the card: these tests ask for the CPU.
DEV = torch.device("cpu")


def _inputs(n, seed=0, occ_frac=0.2):
    """test_accum_pallas.py's inputs, with phase kept per ray."""
    rng = np.random.default_rng(seed)
    A = (-np.abs(rng.random((n, STEPS))) * 0.1
         * (rng.random((n, STEPS)) < occ_frac)).astype(np.float32)
    cd3 = (-rng.random((n, STEPS)) * 0.5).astype(np.float32)
    hf = rng.random((n, STEPS)).astype(np.float32)
    ph = rng.random((n, 1)).astype(np.float32)
    scal = rng.random((1, 12)).astype(np.float32)
    return A, cd3, hf, ph, scal


def _both(A, cd3, hf, ph, scal, above):
    want = np.asarray(accumulate_reference(
        jnp.asarray(A), jnp.asarray(cd3), jnp.asarray(hf),
        jnp.asarray(np.broadcast_to(ph, A.shape)), jnp.asarray(scal)))
    want = np.where(above[:, None], want, 0.0)
    got = accum.accumulate(*(torch.from_numpy(x) for x in (A, cd3, hf)),
                           torch.from_numpy(ph[:, 0].copy()),
                           torch.from_numpy(above),
                           torch.from_numpy(scal.reshape(-1).copy())).numpy()
    return got, want


@pytest.mark.parametrize("case", ["two_blocks", "empty_rays", "dense", "above"])
def test_plain_matches_accumulate_reference(case):
    n = 2 * BLOCK if case == "two_blocks" else BLOCK
    A, cd3, hf, ph, scal = _inputs(n, seed={"two_blocks": 0, "empty_rays": 3,
                                            "dense": 7, "above": 9}[case],
                                   occ_frac=0.95 if case == "dense" else 0.2)
    above = np.ones(n, bool)
    if case == "empty_rays":
        A[: n // 2] = 0.0
    if case == "above":
        above[::3] = False  # below-horizon rays keep their (nonzero) A
    got, want = _both(A, cd3, hf, ph, scal, above)
    assert got.shape == (n, 4)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    if case == "empty_rays":
        np.testing.assert_array_equal(got[: n // 2], 0.0)
    if case == "above":
        np.testing.assert_array_equal(got[::3], 0.0)
        assert np.abs(want[1::3]).max() > 0.0
    if case == "dense":
        assert (want[:, 3] > 0.5).mean() > 0.5


@pytest.mark.parametrize("steps", [16, 128, 40])
def test_phase3_matches_accum_chunk(steps):
    """Both packages' `_accumulate_phase3` on the same planes: the port folds
    (A, cd3) and runs K1's plain version; the JAX package (on a CPU) runs
    its XLA `accum_chunk`. Includes t below 1e-7, the one place the two
    occupancy forms differ."""
    rng = np.random.default_rng(steps)
    n = 700
    t = (rng.random((n, steps)) * 2.0 * (rng.random((n, steps)) < 0.4))
    t[rng.random((n, steps)) < 0.01] = 5e-8
    t = t.astype(np.float32)
    cd = (rng.random((n, steps)) * 3.0).astype(np.float32)
    hf = rng.random((n, steps)).astype(np.float32)
    ss = (rng.random(n) * 40.0 + 20.0).astype(np.float32)
    phase = rng.random(n).astype(np.float32)
    above = rng.random(n) < 0.8
    atmos = [rng.random(3).astype(np.float32) for _ in range(3)]
    lss = (6_004_000.0 - 6_001_500.0) / 64.0
    jp = JParams.create(density=0.05)
    tp = TParams.create(density=0.05, device=DEV)
    want = np.asarray(jmf._accumulate_phase3(
        *(jnp.asarray(x) for x in (t, cd, hf, ss, phase, above)), jp,
        [jnp.asarray(a) for a in atmos], lss, steps, 256))
    got = tmf._accumulate_phase3(
        *(torch.from_numpy(x) for x in (t, cd, hf, ss, phase, above)), tp,
        [torch.from_numpy(a) for a in atmos], lss).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    np.testing.assert_array_equal(got[~above], 0.0)
    assert (want[:, 3] > 0.1).mean() > 0.3


def test_wrapper_rejects_other_devices():
    A = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError):
        accum.accumulate(A, A, A, A[:, 0], torch.ones(4, dtype=torch.bool,
                                                      device="meta"),
                         torch.zeros(12, device="meta"))


@pytest.mark.parametrize("steps", [1, 3, 4, 16, 30, 64, 100, 102, 128, 129, 256, 300])
def test_lanes_per_ray_windows_cover_every_step_once(steps):
    """K1's layout: a ray's group of `lanes_per_ray` lanes (a power of two
    dividing the warp) takes 4 steps a lane per window of 4·lanes steps;
    the windows cover the row's steps exactly once, and a row of at most
    128 steps is one window."""
    lanes = accum.lanes_per_ray(steps)
    assert lanes & (lanes - 1) == 0 and 32 % lanes == 0
    seen = np.zeros(steps, np.int64)
    windows = range(0, steps, 4 * lanes)
    for s0 in windows:
        for j in range(lanes):
            for k in range(4):
                if s0 + 4 * j + k < steps:
                    seen[s0 + 4 * j + k] += 1
    assert (seen == 1).all()
    assert (len(windows) == 1) == (steps <= 128)
    assert lanes == 32 or 4 * lanes >= steps > 2 * lanes or steps <= 4


def test_vector_loads_needs_aligned_rows():
    """16-byte loads only where every row of every plane starts 16-B
    aligned: steps a multiple of 4 and aligned bases."""
    flat = torch.zeros(4 + 8 * 128)
    aligned = flat[: 8 * 128].view(8, 128)
    assert flat.data_ptr() % 16 == 0
    assert accum.vector_loads(128, aligned, aligned, aligned)
    assert not accum.vector_loads(128, aligned, flat[1: 1 + 8 * 128].view(8, 128), aligned)
    assert not accum.vector_loads(102, *(flat[: 8 * 102].view(8, 102),) * 3)
