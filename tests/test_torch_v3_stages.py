"""The PyTorch port's `march_bricks_v3(debug_stage=k)` ≡ the JAX package's,
on the CPU.

The scene, geometry and policy are tests/test_torch_march_v3.py's (its
fixtures, imported): the tiny JAX-generated pack, `hemisphere_dirs(64,
32)`, 64 steps, 16 prepass steps, ray stride 2, a (8, 64, 64) cone cache
and `v3_auto_policy`'s buckets, with and without its ray cull, for both
`accum` arms. Each stage k returns a zero [..., 4] probe whose [0, 0] is
the sum of that stage's tensors; the sums include the capacities' fill
slots, so they agree only while the port's capacities and fill
conventions are JAX's.

Measured on the CPU (the largest relative difference of a probe from
JAX's over the four arms): the prepass 1.1e-7 (its priorities differ by
≤ 6e-4 on a few rays), the kept-ray indices of stage 2 none, the lane
positions 2.5e-7, the hot cells 2.2e-7 (6.7e-7 with the hot capacity at
1.0); the stages that sample the noise tables, weather 7.1e-6, pre
9.8e-6, erosion 3.8e-5, cone 1.8e-5 and the accumulation 2.4e-5
(segmented; JAX's CPU branch scatter-adds where the port takes segment
ends) and 4.4e-6 (planes), carry ulp-level differences of the samplers'
coordinates (XLA contracts multiply-adds into FMAs, torch does not; the
shell radius's x² + y² + z² moves a density by up to 7.3e-4:
tests/test_torch_exact.py). Each stage is held at a few times its
measured difference: the geometry stages at 1e-6 (3e-6 for the hot
cells), the sampling stages at 1e-4, and stage 2, a float32 sum of
integer ray indices, at 1e-7.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cloudscape_tpu.models import march_fast as jmf
from cloudscape_tpu.utils.image import psnr
from cloudscape_tpu_torch.models import march_fast as tmf
from test_torch_march_v3 import (CHUNK, PS, STEPS, STRIDE,  # noqa: F401
                                 policy, scene)

STAGES = range(1, 10)
# Relative tolerance of each stage's probe (the module docstring's
# measurements): geometry, integer ray indices, and the sampling stages.
RTOL = {1: 1e-6, 2: 1e-7, 3: 1e-6, 4: 1e-4, 5: 1e-4, 6: 3e-6, 7: 1e-4, 8: 1e-4,
        9: 1e-4}


def _knobs_of(pol, cull, kw):
    """A package's `v3_auto_policy` buckets as march keywords, the ray cull
    off unless `cull`, then `kw` on top."""
    rk, ck, hk = pol[:3]
    knobs = dict(ray_keep_frac=rk if cull else None, cell_keep_frac=ck,
                 hot_keep_frac=hk, ray_stride=STRIDE)
    knobs.update(kw)
    return knobs


def _jax(s, pol, cull, accum, **kw):
    return np.asarray(jmf.march_bricks_v3(
        jnp.asarray(s["d"]), s["jp"], s["jb"], s["jsky"], steps=STEPS, chunk=CHUNK,
        cone_cache=s["jc"], prepass_steps=PS, accum=accum,
        **_knobs_of(pol[0], cull, kw)))


def _port(s, pol, cull, accum, **kw):
    return tmf.march_bricks_v3(
        torch.from_numpy(s["d"]), s["tp"], s["tb"], s["tsky"], steps=STEPS,
        chunk=CHUNK, cone_cache=s["tc"], prepass_steps=PS, accum=accum,
        **_knobs_of(pol[1], cull, kw)).numpy()


def test_policy_culls(policy):
    """Both packages pick the same buckets, and the ray cull is on, so the
    culled arm below runs stage 2."""
    assert tuple(policy[0][:3]) == tuple(policy[1][:3])
    assert policy[0][0] < 1.0


@pytest.mark.parametrize("accum", ["segmented", "planes"])
@pytest.mark.parametrize("cull", [True, False], ids=["cull", "nocull"])
def test_stage_probes_match_jax(scene, policy, cull, accum):
    """Every stage's probe against JAX's: [0, 0] at the stage's tolerance,
    every other entry exactly 0 in both. Without the ray cull stage 2 is
    the full render, as in JAX (`test_quirks_match_jax`)."""
    for k in STAGES:
        if k == 2 and not cull:
            continue
        want = _jax(scene, policy, cull, accum, debug_stage=k)
        got = _port(scene, policy, cull, accum, debug_stage=k)
        assert got.shape == want.shape == scene["d"].shape[:-1] + (4,)
        g, w = got.reshape(-1)[0], want.reshape(-1)[0]
        assert np.isfinite(g) and w != 0.0, (k, g, w)
        np.testing.assert_allclose(g, w, rtol=RTOL[k], atol=0, err_msg=f"stage {k}")
        for probe in (got, want):
            assert not probe.reshape(-1)[1:].any(), f"stage {k}: entries past [0, 0]"


@pytest.mark.parametrize("accum", ["segmented", "planes"])
@pytest.mark.parametrize("cull", [True, False], ids=["cull", "nocull"])
def test_stage_zero_is_the_render(scene, policy, cull, accum):
    """debug_stage=0 is bitwise the call without the keyword."""
    plain = _port(scene, policy, cull, accum)
    np.testing.assert_array_equal(_port(scene, policy, cull, accum, debug_stage=0),
                                  plain)
    assert (plain[..., 3] > 0.1).mean() > 0.02


@pytest.mark.parametrize("stage", [2, 10, -1])
def test_quirks_match_jax(scene, policy, stage):
    """The probes JAX does not have: stage 2 without the ray cull, and a
    value outside 1–9, render in full in both packages; the port's render
    is bitwise its debug_stage=0 call and matches JAX's as the v3 test's
    renders do (≥ 60 dB; ~99 dB measured there)."""
    got = _port(scene, policy, False, "segmented", debug_stage=stage)
    want = _jax(scene, policy, False, "segmented", debug_stage=stage)
    np.testing.assert_array_equal(got, _port(scene, policy, False, "segmented"))
    assert psnr(got, want) >= 60.0
    assert (got.reshape(-1, 4)[1:] != 0).any()


@pytest.mark.parametrize("stage, kw", [
    (3, dict(cell_keep_frac=0.5)), (6, dict(cell_keep_frac=0.5)),
    (6, dict(hot_keep_frac=1.0))],
    ids=["live_half", "hot_overflow", "hot_fill"])
def test_capacities_match_jax(scene, policy, stage, kw):
    """The probes sum the capacities' fill slots (each at the last kept
    ray's cell 0) and lose the cells an overflow drops, as JAX's do. At the
    policy's buckets the live list (12,288 slots) holds 5,616 live cells.
    Halving it leaves 528 fill slots (stage 3), and its hot list then
    overflows, 842 hot cells for 768 slots (stage 6); a hot capacity of 1.0
    is mostly fill (stage 6). Each probe matches JAX's and differs from the
    policy's."""
    want = _jax(scene, policy, True, "segmented", debug_stage=stage, **kw)[0, 0, 0]
    got = _port(scene, policy, True, "segmented", debug_stage=stage, **kw)[0, 0, 0]
    policy_probe = _port(scene, policy, True, "segmented", debug_stage=stage)[0, 0, 0]
    assert got != policy_probe
    np.testing.assert_allclose(got, want, rtol=RTOL[stage], atol=0)
