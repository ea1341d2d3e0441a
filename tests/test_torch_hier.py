"""The PyTorch port's hierarchical marches and "hier" engine ≡ the JAX
package's, on the CPU.

Both packages get the same tiny noise pack (the JAX generators at base 16,
detail 16, weather 64, as tests/test_torch_engine.py builds it, handed to
the port through `noise_pack_from_numpy`), the march parameters of
tests/test_hierarchical.py at coverage 0.6, and the octahedral texel grid
of a 32² map. The port runs its kernel wrappers' plain versions (K2
compaction, K3 segmented scan); the JAX side runs its XLA forms.

Measured on the CPU: the coarse windows (a, b, any_occ) of all 1,024 rays
are equal in both packages; `march_hierarchical` matches JAX's at
115.21 dB, `march_hierarchical_v3` at 103.63 dB and the banded v3 at
104.53 dB (gate 40 dB); `hier_v3_auto_policy` gives the same buckets and
fractions, monolithic and over 4 bands; the "hier" engine's ring, view and
`render_full_hemisphere` match JAX's at 95–103 dB with and without tile
cull (gate 50 dB).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cloudscape_tpu.config import CloudConfig as JCloud, PerfConfig as JPerf
from cloudscape_tpu.config import SunState as JSun
from cloudscape_tpu.engine import CloudSkyEngine as JEngine
from cloudscape_tpu.models import atmosphere as jatmo
from cloudscape_tpu.models import march_fast as jmf
from cloudscape_tpu.models.density import MarchParams as JParams
from cloudscape_tpu.models.packs import make_noise_pack
from cloudscape_tpu.ops.noise import (generate_base_noise, generate_detail_noise,
                                      generate_weather)
from cloudscape_tpu.ops.octmap import texel_directions as jdirs
from cloudscape_tpu.utils.image import psnr
from cloudscape_tpu_torch import CloudConfig, PerfConfig, SunState
from cloudscape_tpu_torch.engine import CloudSkyEngine
from cloudscape_tpu_torch.models import march_fast as tmf
from cloudscape_tpu_torch.models.density import MarchParams
from cloudscape_tpu_torch.models.packs import noise_pack_from_numpy

# Several test workers share the host's cores: keep torch's intra-op
# thread pool small so they do not oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))
# The port's entry points default to the card: these tests ask for the CPU.
DEV = torch.device("cpu")

STEPS, COARSE, CHUNK = 32, 8, 256
RES = (8, 64, 64)
SUN = np.array([0.3, 0.4, -0.85]) / np.linalg.norm([0.3, 0.4, -0.85])


def _pair_params(**kw):
    """The same march parameters for both packages (tests/test_hierarchical.py's
    scene unless kw overrides a field), the port's through `from_numpy`."""
    fields = dict(cloud_pos=np.array([1.5, -0.3]), detailed_pos=np.array([0.4, 0.2]),
                  weather_pos=np.array([0.01, 0.02]), time=12.5, cloud_coverage=0.6,
                  light_direction=SUN, ground_color=np.array([0.27, 0.19, 0.027]))
    fields.update(kw)
    jp = JParams.create(**fields)
    return jp, MarchParams.from_numpy({k: np.asarray(v) for k, v in vars(jp).items()},
                                      device=DEV)


@pytest.fixture(scope="module")
def scene():
    jn = make_noise_pack(generate_base_noise(16, seed=1),
                         generate_detail_noise(16, seed=2),
                         generate_weather(64, seed=3))
    tn = noise_pack_from_numpy([np.asarray(a) for a in jn.large],
                               [np.asarray(a) for a in jn.small],
                               np.asarray(jn.weather), device=DEV)
    jp, tp = _pair_params()
    jb, tb = jmf.BrickPack.from_noise(jn), tmf.BrickPack.from_noise(tn)
    sky = jatmo.sky_lut(jatmo.transmittance_lut(), jnp.asarray(jp.light_direction))
    return dict(jn=jn, tn=tn, jp=jp, tp=tp, jb=jb, tb=tb, jsky=sky,
                tsky=torch.from_numpy(np.array(sky)),
                jc=jmf.build_cone_cache(jp, jb, 6, res=RES, chunk=4096),
                tc=tmf.build_cone_cache(tp, tb, 6, res=RES, chunk=4096),
                d=np.array(jdirs(32)))


def _both(s, name, jp=None, tp=None, cone=False, **kw):
    """(JAX's, the port's) `march_fast.<name>` on the scene's directions and
    its (or the given) params, as numpy."""
    jargs = (jnp.asarray(s["d"]), s["jp"] if jp is None else jp, s["jb"], s["jsky"])
    targs = (torch.from_numpy(s["d"]), s["tp"] if tp is None else tp, s["tb"],
             s["tsky"])
    jkw, tkw = dict(kw), dict(kw)
    if cone:
        jkw["cone_cache"], tkw["cone_cache"] = s["jc"], s["tc"]
    return (np.asarray(getattr(jmf, name)(*jargs, **jkw)),
            getattr(tmf, name)(*targs, **tkw).numpy())


def _policy(s, bands):
    """(JAX's, the port's) `hier_v3_auto_policy` on the scene."""
    kw = dict(steps=STEPS, coarse_steps=COARSE, prepass_steps=8, bands=bands)
    jpol = jmf.hier_v3_auto_policy(jnp.asarray(s["d"]), s["jp"], s["jb"], **kw)
    tpol = tmf.hier_v3_auto_policy(torch.from_numpy(s["d"]), s["tp"], s["tb"], **kw)
    return [float(v) for v in jpol], list(tpol)


def test_hier_windows_match_jax(scene):
    """The coarse pass: each ray's window [a, b] and any_occ. An ulp of the
    radius (ROADMAP §C) could flip a coarse cell at the margin; on this
    scene no ray's window differs (0 of 1,024). The window lattice's step
    agrees to 3.43e-5 relative, which is `_ray_setup`'s own shell-segment
    difference between the packages (the far-intersection's cancellation
    at 6,000 km), and its origin to 0.23 m (an f32 ulp there is 0.5 m)."""
    s = scene
    flat = s["d"].reshape(-1, 3).copy()
    jw = jmf._hier_windows(jnp.asarray(flat), s["jp"], s["jb"], STEPS, COARSE,
                           CHUNK, 0.3)
    tw = tmf._hier_windows(torch.from_numpy(flat), s["tp"], s["tb"], STEPS, COARSE,
                           CHUNK, 0.3)
    ja, jb_, jocc = (np.asarray(x) for x in jw[6:9])
    ta, tb_, tocc = (x.numpy() for x in tw[6:9])
    differ = (ja != ta) | (jb_ != tb_)
    assert differ.sum() == 0
    np.testing.assert_array_equal(tocc[~differ], jocc[~differ])
    assert 0.3 < jocc.mean() < 1.0
    jl = jmf._hier_window_lattice(jnp.asarray(flat), s["jp"], s["jb"], STEPS, COARSE,
                                  CHUNK, 0.3)
    tl = tmf._hier_window_lattice(torch.from_numpy(flat), s["tp"], s["tb"], STEPS,
                                  COARSE, CHUNK, 0.3)
    np.testing.assert_array_equal(tl[0].numpy(), np.asarray(jl[0]))
    np.testing.assert_allclose(tl[2].numpy(), np.asarray(jl[2]), rtol=5e-5, atol=0)
    np.testing.assert_allclose(tl[3].numpy(), np.asarray(jl[3]), rtol=0, atol=0.5)


@pytest.mark.parametrize("bands", [1, 4])
def test_hier_v3_auto_policy_matches_jax(scene, bands):
    """The same buckets as JAX's, and the fractions within 1e-3."""
    jpol, tpol = _policy(scene, bands)
    assert tpol[:3] == jpol[:3]
    np.testing.assert_allclose(tpol[3:], jpol[3:], atol=1e-3)


@pytest.mark.parametrize("name,bands", [("march_hierarchical", 1),
                                        ("march_hierarchical_v3", 1),
                                        ("march_hierarchical_v3_banded", 4)])
def test_hierarchical_march_matches_jax(scene, name, bands):
    """v1 (capacity 0.5, no cone cache), v3 and the 4-band v3 at the JAX
    policy's buckets (with the cone cache): ≥ 40 dB from JAX's (115.21,
    103.63 and 104.53 dB measured)."""
    kw = dict(steps=STEPS, chunk=CHUNK, coarse_steps=COARSE)
    if name == "march_hierarchical":
        want, got = _both(scene, name, capacity_frac=0.5, **kw)
    else:
        rk, ck, hk = _policy(scene, bands)[0][:3]
        if bands > 1:
            kw["bands"] = bands
        want, got = _both(scene, name, cone=True, prepass_steps=8,
                          cell_keep_frac=ck, hot_keep_frac=hk, ray_keep_frac=rk, **kw)
    assert got.shape == want.shape == (32, 32, 4)
    assert (want[..., 3] > 0.1).mean() > 0.02
    assert psnr(got, want) >= 40.0


def test_v1_banded_equals_monolithic(scene):
    """At a sample capacity that cannot overflow, the 4-band v1 render is the
    monolithic one (tests/test_hierarchical.py's gate, atol 1e-5)."""
    s = scene
    kw = dict(steps=STEPS, chunk=CHUNK, capacity_frac=1.0, coarse_steps=COARSE)
    d = torch.from_numpy(s["d"])
    mono = tmf.march_hierarchical(d, s["tp"], s["tb"], s["tsky"], **kw)
    band = tmf.march_hierarchical_banded(d, s["tp"], s["tb"], s["tsky"], bands=4, **kw)
    np.testing.assert_allclose(band.numpy(), mono.numpy(), atol=1e-5, rtol=0.0)


@pytest.mark.parametrize("name", ["march_hierarchical", "march_hierarchical_v3"])
@pytest.mark.parametrize("case", ["empty sky", "below the horizon"])
def test_hierarchical_zero_cases(scene, name, case):
    """Coverage 0 renders exactly 0 everywhere; rays below the horizon
    render exactly 0 (tests/test_hierarchical.py's cases, for v1 and v3)."""
    s = scene
    if case == "empty sky":
        d, tp = s["d"], dataclasses.replace(s["tp"], cloud_coverage=torch.tensor(0.0))
    else:
        d = np.array([[0.2, -0.5, 0.6], [0.0, -1.0, 0.0]], np.float32)
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
        tp = s["tp"]
    kw = dict(steps=16, chunk=64, coarse_steps=COARSE)
    if name == "march_hierarchical_v3":
        kw["prepass_steps"] = 8
    out = getattr(tmf, name)(torch.from_numpy(d), tp, s["tb"], s["tsky"], **kw)
    assert float(out.abs().max()) == 0.0


def test_overcast_drops_what_jax_drops(scene):
    """tests/test_hierarchical.py's overcast scene (coverage 0.95, the
    default ray capacity 1.0) against the exact march, in both packages.
    On this tiny pack it covers 28.8% of the texels (alpha > 0.05), not the
    60% the JAX test asks of its asset pack, and JAX's v1 leaves one of
    them empty, texel (2, 26) with exact alpha 0.077: its coarse probes
    (16 a ray, margin 0.3) miss that ray's cloud (ROADMAP §C). The port
    drops exactly the texels JAX drops, matches JAX's render at > 100 dB
    (101.33 measured) and holds the JAX test's 30 dB against the exact
    march (37.53 measured in both)."""
    s = scene
    jp, tp = _pair_params(cloud_coverage=0.95, detailed_pos=np.zeros(2),
                          weather_pos=np.zeros(2), time=0.0)
    kw = dict(steps=64, chunk=1024, capacity_frac=0.5)
    j_exact, t_exact = _both(s, "march_bricks", jp=jp, tp=tp, **kw)
    j_hier, t_hier = _both(s, "march_hierarchical", jp=jp, tp=tp, **kw)
    dropped = []
    for exact, hier in ((j_exact, j_hier), (t_exact, t_hier)):
        occupied = exact[..., 3] > 0.05
        assert occupied.mean() > 0.25
        dropped.append(occupied & (hier[..., 3] == 0.0))
        assert psnr(hier, exact) > 30.0
    np.testing.assert_array_equal(dropped[1], dropped[0])
    assert dropped[0].sum() <= 1
    assert psnr(t_hier, j_hier) > 100.0


@pytest.mark.parametrize("tile_cull", [False, True])
def test_hier_engine_matches_jax(scene, tile_cull):
    """kernel="hier" at tests/test_engine.py's configuration (32² map, 16
    frames, 8 steps, 2 light steps, coverage 0.6, a (8, 64, 64) cone
    cache): the warm start and 18 ticks across a boundary, then the ring, a
    view and `render_full_hemisphere` against the JAX engine's at ≥ 50 dB,
    and with tile cull the same buckets (fast2's ray buckets; the hier arm
    skips the 0.0 tiles only). Measured: ring 95.31 / 96.26 dB (without /
    with tile cull), view 102.33 / 102.60 dB, `render_full_hemisphere`
    96.44 dB, buckets 0.0 and 0.25 with tile cull."""
    s = scene
    kw = dict(kernel="hier", cone_res=RES, tile_cull=tile_cull)
    je = JEngine(perf=JPerf(32, 16, march_steps=8, light_steps=2),
                 config=JCloud(cloud_coverage=0.6), sun=JSun(direction=(0.3, 0.5, -0.8)),
                 noise=s["jn"], **kw)
    te = CloudSkyEngine(perf=PerfConfig(32, 16, march_steps=8, light_steps=2),
                        config=CloudConfig(cloud_coverage=0.6),
                        sun=SunState(direction=(0.3, 0.5, -0.8)), noise=s["tn"],
                        device="cpu", **kw)
    assert te.can_run and te._staged and te.tile_cull == tile_cull
    for i in range(18):
        je.update_sky(now=i / 60.0)
        te.update_sky(now=i / 60.0)
    assert te._tile_buckets == je._tile_buckets
    if tile_cull:
        assert 0.0 in te._tile_buckets
    ring_j, ring_t = np.asarray(je.cloud_ring), te.cloud_ring.numpy()
    assert np.isfinite(ring_t).all() and (ring_j[..., 3] > 0.1).mean() > 0.02
    assert psnr(ring_t, ring_j) >= 50.0
    d = np.array(jdirs(40))
    d[..., 1] -= 0.3  # include below-horizon views
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    view_t = te.render_view(torch.from_numpy(d)).numpy()
    assert np.isfinite(view_t).all() and view_t.min() >= 0.0
    assert psnr(view_t, np.asarray(je.render_view(jnp.asarray(d)))) >= 50.0
    want = np.asarray(je.render_full_hemisphere())
    got = te.render_full_hemisphere().numpy()
    assert te._v3_policy_cache == je._v3_policy_cache is not None
    assert got.shape == want.shape == (32, 32, 4)
    assert (got[..., 3] > 0.0).mean() > 0.05
    assert psnr(got, want) >= 50.0
