"""The PyTorch port's staged v2 march ≡ the JAX package's, on the CPU.

The scene is tests/test_torch_march_v3.py's: the same tiny noise pack (the
JAX generators at base 16, detail 16, weather 64), march parameters,
`hemisphere_dirs(64, 32)`, 64 steps and a (8, 64, 64) cone cache. The
port runs its kernel wrappers' plain versions (K2 compaction, K1
accumulation); the JAX side runs its XLA forms.

Measured on the CPU: every v2 render below matches JAX's at 108.6–109.6
dB (max abs error 2.1e-4; the gate is 60 dB); the occupied-sample and
ray-keep fractions agree exactly (0.019287 at both cutoffs; 0.242676 and
0.3125 at ray strides 1 and 2) and both policies pick (0.4, 0.09, 0.0);
with every gate off the port's v2 equals its dense march bitwise (the gate
is 100 dB).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cloudscape_tpu.models import atmosphere as jatmo
from cloudscape_tpu.models import march_fast as jmf
from cloudscape_tpu.models.density import MarchParams as JParams
from cloudscape_tpu.models.packs import make_noise_pack
from cloudscape_tpu.ops.noise import (generate_base_noise, generate_detail_noise,
                                      generate_weather)
from cloudscape_tpu.utils.image import psnr
from cloudscape_tpu_torch.models import march_fast as tmf
from cloudscape_tpu_torch.models.density import MarchParams
from cloudscape_tpu_torch.models.packs import noise_pack_from_numpy

from test_torch_march_v3 import hemisphere_dirs

# Several test workers share the host's cores: keep torch's intra-op
# thread pool small so they do not oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))
# The port's entry points default to the card: these tests ask for the CPU.
DEV = torch.device("cpu")

STEPS, PS, CHUNK = 64, 16, 1024
RES = (8, 64, 64)
COVERAGE = 0.6
N_RAYS = 64 * 32


@pytest.fixture(scope="module")
def scene():
    jn = make_noise_pack(generate_base_noise(16, seed=1),
                         generate_detail_noise(16, seed=2),
                         generate_weather(64, seed=3))
    tn = noise_pack_from_numpy([np.asarray(a) for a in jn.large],
                               [np.asarray(a) for a in jn.small],
                               np.asarray(jn.weather), device=DEV)
    sun = np.array([0.3, 0.4, -0.85])
    sun /= np.linalg.norm(sun)
    jp = JParams.create(
        cloud_pos=np.array([1.5, -0.3]), detailed_pos=np.array([0.4, 0.2]),
        weather_pos=np.array([0.01, 0.02]), time=12.5, cloud_coverage=COVERAGE,
        light_direction=sun, ground_color=np.array([0.27, 0.19, 0.027]))
    tp = MarchParams.from_numpy({k: np.asarray(v) for k, v in vars(jp).items()},
                                device=DEV)
    jb, tb = jmf.BrickPack.from_noise(jn), tmf.BrickPack.from_noise(tn)
    sky = jatmo.sky_lut(jatmo.transmittance_lut(), jnp.asarray(jp.light_direction))
    jc = jmf.build_cone_cache(jp, jb, 6, res=RES, chunk=4096)
    tc = tmf.build_cone_cache(tp, tb, 6, res=RES, chunk=4096)
    d = hemisphere_dirs(64, 32)
    return dict(jp=jp, tp=tp, jb=jb, tb=tb, jsky=sky,
                tsky=torch.from_numpy(np.array(sky)), jc=jc, tc=tc, d=d)


def _jax_v2(s, **kw):
    kw.setdefault("chunk", CHUNK)
    return np.asarray(jmf.march_bricks_v2(jnp.asarray(s["d"]), s["jp"], s["jb"],
                                          s["jsky"], steps=STEPS,
                                          cone_cache=s["jc"], **kw))


def _port_v2(s, **kw):
    kw.setdefault("chunk", CHUNK)
    return tmf.march_bricks_v2(torch.from_numpy(s["d"]), s["tp"], s["tb"], s["tsky"],
                               steps=STEPS, cone_cache=s["tc"], **kw).numpy()


@pytest.fixture(scope="module")
def policy(scene):
    """(JAX's, the port's) `v2_auto_policy` on the scene."""
    s = scene
    jpol = jmf.v2_auto_policy(jnp.asarray(s["d"]), s["jp"], s["jb"], steps=STEPS)
    tpol = tmf.v2_auto_policy(torch.from_numpy(s["d"]), s["tp"], s["tb"],
                              steps=STEPS)
    return jpol, tpol


def _both(s, **kw):
    want, got = _jax_v2(s, **kw), _port_v2(s, **kw)
    assert got.shape == want.shape == (32, 64, 4)
    assert np.isfinite(got).all()
    return want, got


@pytest.mark.parametrize("t_cutoff", [1e-4, 0.0])
def test_march_bricks_v2_matches_jax(scene, t_cutoff):
    """Default v2 (no cull, capacity 0.5), with and without the occlusion
    cutoff: ≥ 60 dB against JAX's."""
    want, got = _both(scene, capacity_frac=0.5, t_cutoff=t_cutoff)
    assert (want[..., 3] > 0.1).mean() > 0.02
    assert psnr(got, want) >= 60.0


def test_v2_ray_cull_matches_jax(scene):
    """Ray cull at the `ray_keep_fraction` bucket (prepass, dilation bonus,
    histogram select): ≥ 60 dB against JAX's, and a real cull."""
    kf = jmf.ray_keep_fraction(jnp.asarray(scene["d"]), scene["jp"], scene["jb"],
                               steps=STEPS, prepass_steps=PS)
    rb = jmf.select_ray_keep_frac(float(kf))
    assert rb < 1.0
    want, got = _both(scene, chunk=256, capacity_frac=0.5, ray_keep_frac=rb,
                      prepass_steps=PS)
    assert psnr(got, want) >= 60.0


def test_v2_ray_cull_overflow_renders_empty_sky(scene):
    """ray_keep_frac 0.1 (256 rays) overflows here; 0.3, the JAX suite's
    value on its larger scene, keeps every cloudy ray of this one. The
    dropped rays are exactly empty, the kept ones equal the unculled
    render, and the result matches JAX's at ≥ 60 dB."""
    ok = _port_v2(scene, chunk=256, capacity_frac=0.5)
    want, got = _both(scene, chunk=256, capacity_frac=0.5, ray_keep_frac=0.1,
                      prepass_steps=PS)
    assert not np.array_equal(got, ok)
    assert got[..., 3].sum() <= ok[..., 3].sum() * (1.0 + 1e-6)
    kept = got[..., 3] > 0.0
    np.testing.assert_allclose(got[kept], ok[kept], rtol=1e-5, atol=1e-6)
    assert psnr(got, want) >= 60.0


def test_v2_capacity_overflow_fallback(scene):
    """A capacity of ~1% of the samples overflows: the overflowed samples
    take the ALU-only fallback (K2's rank ≥ capacity), as in JAX: ≥ 60 dB
    against JAX's, different from the ample-capacity render, alpha mass
    within a band of it."""
    ok = _port_v2(scene, chunk=256, capacity_frac=0.5)
    want, got = _both(scene, chunk=256, capacity_frac=0.01)
    assert not np.array_equal(got, ok)
    ratio = got[..., 3].sum() / ok[..., 3].sum()
    assert 0.5 < ratio < 1.5
    assert psnr(got, want) >= 60.0


def test_v2_given_cull_prio_matches_jax(scene):
    """A given per-ray priority map (`cull_prio`, no prepass): the same
    kept rays as JAX and ≥ 60 dB."""
    prio = np.random.default_rng(11).normal(scale=0.3, size=(32, 64)).astype(np.float32)
    want = _jax_v2(scene, capacity_frac=0.5, ray_keep_frac=0.5,
                   cull_prio=jnp.asarray(prio))
    got = _port_v2(scene, capacity_frac=0.5, ray_keep_frac=0.5,
                   cull_prio=torch.from_numpy(prio))
    np.testing.assert_array_equal(got[..., 3] > 0.0, want[..., 3] > 0.0)
    assert psnr(got, want) >= 60.0


def test_v2_weather_every_raises(scene):
    """A weather_every that does not divide the steps raises, as JAX's
    assertion does; the lerp itself is held against JAX below."""
    with pytest.raises(ValueError, match="weather_every"):
        _port_v2(scene, capacity_frac=0.5, weather_every=5)


def test_v2_weather_every_matches_jax(scene):
    """weather_every = 4 (weather at every 4th step, lerped between): ≥ 60 dB
    from JAX's render (107.46 dB measured)."""
    want = _jax_v2(scene, capacity_frac=0.5, weather_every=4)
    got = _port_v2(scene, capacity_frac=0.5, weather_every=4)
    assert (want[..., 3] > 0.1).mean() > 0.02
    assert psnr(got, want) >= 60.0


@pytest.mark.parametrize("t_cutoff", [1e-4, 0.0])
def test_occupied_sample_fraction_matches_jax(scene, t_cutoff):
    s = scene
    want = float(jmf.occupied_sample_fraction(jnp.asarray(s["d"]), s["jp"], s["jb"],
                                              t_cutoff=t_cutoff))
    got = tmf.occupied_sample_fraction(torch.from_numpy(s["d"]), s["tp"], s["tb"],
                                       t_cutoff=t_cutoff)
    assert 0.0 < want < 1.0
    assert abs(got - want) <= 2.0 / N_RAYS


@pytest.mark.parametrize("ray_stride", [1, 2])
def test_ray_keep_fraction_matches_jax(scene, ray_stride):
    s = scene
    want = float(jmf.ray_keep_fraction(jnp.asarray(s["d"]), s["jp"], s["jb"],
                                       steps=STEPS, prepass_steps=PS,
                                       ray_stride=ray_stride))
    got = tmf.ray_keep_fraction(torch.from_numpy(s["d"]), s["tp"], s["tb"],
                                steps=STEPS, prepass_steps=PS,
                                ray_stride=ray_stride)
    assert 0.0 < want < 1.0
    assert abs(got - want) <= 2.0 / N_RAYS


def test_select_capacity_frac_matches_jax():
    """Bucket edges (need == bucket exactly and one ulp either side), the
    overflow clamp, and the capacity expression."""
    assert tmf.CAPACITY_BUCKETS == jmf.CAPACITY_BUCKETS
    values = [0.0, 0.01, 0.5, 0.9, 2.0]
    for b in jmf.CAPACITY_BUCKETS:
        edge = b / 1.3
        values += [edge, np.nextafter(edge, 0.0), np.nextafter(edge, 1.0)]
    for v in values:
        assert tmf.select_capacity_frac(v) == jmf.select_capacity_frac(v)
        assert tmf.select_capacity_frac(v, margin=1.0) == \
            jmf.select_capacity_frac(v, margin=1.0)
    for total, frac, chunk in [(131072, 0.25, 1024), (1000, 0.01, 256),
                               (589824 * 128, 0.5, 9216)]:
        capacity = max(int(total * frac), chunk)
        assert tmf.v2_capacity(total, frac, chunk) == \
            capacity + (-capacity) % chunk


def test_v2_auto_policy_matches_jax(policy):
    """The same (ray, capacity, cutoff) buckets as JAX's `v2_auto_policy`,
    the occupied fraction within 2 / n_rays."""
    jpol, tpol = policy
    assert tpol[:3] == tuple(jpol[:3])
    assert abs(tpol[3] - float(jpol[3])) <= 2.0 / N_RAYS


def test_v2_policy_render_matches_jax(scene, policy):
    """v2 at the policy's knobs (as bench/sweep.py config 4 runs it, ray
    stride 2): ≥ 60 dB against JAX's."""
    rk, cap, tc, _ = policy[0]
    want, got = _both(scene, capacity_frac=cap, ray_keep_frac=rk, ray_stride=2,
                      t_cutoff=tc)
    assert psnr(got, want) >= 60.0


def test_v2_gates_off_matches_dense(scene):
    """No cull, no cutoff, capacity 1.0: the v2 machinery (compaction,
    staged passes, scatter back) reproduces the port's dense march at
    ≥ 100 dB."""
    got = _port_v2(scene, capacity_frac=1.0, t_cutoff=0.0)
    dense = tmf.march_tile_dense(torch.from_numpy(scene["d"]), scene["tp"],
                                 scene["tb"], scene["tsky"], steps=STEPS,
                                 chunk=CHUNK, cone_cache=scene["tc"]).numpy()
    assert psnr(got, dense) >= 100.0
