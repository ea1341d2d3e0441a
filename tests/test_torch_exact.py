"""The PyTorch port's exact marches ≡ the JAX package's, on the CPU.

The texture samplers with mip chains (`ops/sampling.py`), the density on
the noise pyramids (`models/density.py`), the scan march `march`
(`models/march.py`), the exact brick march `march_bricks` and the cone
bake's one-pass API (`cone_occupancy_indices`, `assemble_cone_cache`;
`models/march_fast.py`). Both packages get the same tiny noise pack (the
JAX generators at base 16, detail 16, weather 64, as
tests/test_torch_march_v3.py builds it), the same march parameters at
coverage 0.6 and the 32² octahedral texel grid at 16 steps; the port runs
on the CPU, where K2 takes its plain version, and JAX its XLA forms.

Measured on the CPU: `march` 91.41 dB from JAX's and 61.10 dB from the f64
oracle (48², 32 steps); `march_bricks` 118.04 dB from JAX's and 65.31 dB
from the port's `march` (JAX's from JAX's `march`: 65.30 dB; at 128 steps
47.17 and 47.03 dB, the scan's f32 position drift); compact ≡
dense (max abs diff 0 at t_cutoff 0); the gates of tests/test_brick.py
hold as they do in JAX (the dB in each test's docstring).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cloudscape_tpu.models import atmosphere as jatmo
from cloudscape_tpu.models import density as jdensity
from cloudscape_tpu.models import march as jmarch
from cloudscape_tpu.models import march_fast as jmf
from cloudscape_tpu.models.density import MarchParams as JParams
from cloudscape_tpu.models.packs import make_noise_pack
from cloudscape_tpu.ops import brick as jbrick
from cloudscape_tpu.ops import sampling as jsampling
from cloudscape_tpu.ops.noise import (generate_base_noise, generate_detail_noise,
                                      generate_weather)
from cloudscape_tpu.ops.octmap import texel_directions as jdirs
from cloudscape_tpu.utils.image import psnr
from oracle import reference as ref
from cloudscape_tpu_torch.models import density as tdensity
from cloudscape_tpu_torch.models import march as tmarch
from cloudscape_tpu_torch.models import march_fast as tmf
from cloudscape_tpu_torch.models.density import MarchParams
from cloudscape_tpu_torch.models.packs import noise_pack_from_numpy
from cloudscape_tpu_torch.ops import brick as tbrick
from cloudscape_tpu_torch.ops import math as tmath
from cloudscape_tpu_torch.ops import sampling as tsampling

# Several test workers share the host's cores: keep torch's intra-op
# thread pool small so they do not oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))
# The port's entry points default to the card: these tests ask for the CPU.
DEV = torch.device("cpu")

STEPS = 16
RES = (8, 40, 32)
# tests/test_march.py's march parameters, at this pack's coverage.
PARAMS = dict(cloud_pos=np.array([1.5, -0.3]), detailed_pos=np.array([0.4, 0.2]),
              weather_pos=np.array([0.01, 0.02]), time=12.5, density=0.05,
              cloud_coverage=0.6, light_energy=1.0,
              light_color=np.array([1.0, 0.98, 0.95]),
              ground_color=np.array([0.27, 0.19, 0.027]))


def _t(a):
    return torch.from_numpy(np.array(a))


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
    prm = dict(PARAMS, light_direction=sun)
    jp = JParams.create(**prm)
    tp = MarchParams.from_numpy({k: np.asarray(v) for k, v in vars(jp).items()},
                                device=DEV)
    sky = np.asarray(jatmo.sky_lut(jatmo.transmittance_lut(),
                                   jnp.asarray(sun, jnp.float32)))
    return dict(jn=jn, tn=tn, prm=prm, jp=jp, tp=tp, jsky=jnp.asarray(sky),
                tsky=_t(sky), sky=sky, jb=jmf.BrickPack.from_noise(jn),
                tb=tmf.BrickPack.from_noise(tn), d=np.asarray(jdirs(32)))


@pytest.fixture(scope="module")
def exact(scene):
    """(JAX's, the port's) `march_bricks` at its defaults on the scene."""
    s = scene
    want = np.asarray(jmf.march_bricks(jnp.asarray(s["d"]), s["jp"], s["jb"],
                                       s["jsky"], steps=STEPS))
    got = tmf.march_bricks(_t(s["d"]), s["tp"], s["tb"], s["tsky"],
                           steps=STEPS).numpy()
    return want, got


def _port_bricks(s, **kw):
    return tmf.march_bricks(_t(s["d"]), s["tp"], s["tb"], s["tsky"], steps=STEPS,
                            **kw).numpy()


# ----------------------------------------------------------------- sampling

@pytest.mark.parametrize("wrap", ["repeat", "clamp"])
def test_sample3d_matches_jax(wrap):
    """Trilinear fetch on a non-cubic volume, points well outside [0, 1]:
    atol 1e-5."""
    rng = np.random.default_rng(11)
    vol = rng.uniform(size=(6, 8, 10, 3)).astype(np.float32)
    q = rng.uniform(-2, 2, size=(700, 3)).astype(np.float32)
    want = np.asarray(jsampling.sample3d(jnp.asarray(vol), jnp.asarray(q), wrap))
    got = tsampling.sample3d(_t(vol), _t(q), wrap).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_pyramids_match_jax():
    """`build_pyramid3d` / `build_pyramid2d`: the same levels, atol 1e-5."""
    rng = np.random.default_rng(12)
    vol = rng.uniform(size=(16, 16, 16, 2)).astype(np.float32)
    img = rng.uniform(size=(16, 32, 3)).astype(np.float32)
    for jfn, tfn, a in ((jsampling.build_pyramid3d, tsampling.build_pyramid3d, vol),
                        (jsampling.build_pyramid2d, tsampling.build_pyramid2d, img)):
        want, got = jfn(jnp.asarray(a)), tfn(_t(a))
        assert len(got) == len(want) == 5
        for w, g in zip(want, got):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


@pytest.mark.parametrize("lod", [-1.0, 0.0, 1.0, 1.5, 2.7, 9.0])
@pytest.mark.parametrize("wrap", ["repeat", "clamp"])
def test_sample_lod_matches_jax(lod, wrap):
    """`sample3d_lod` / `sample2d_lod` at integer and fractional lods, and
    lods clamped below 0 and above the chain: atol 1e-5."""
    rng = np.random.default_rng(13)
    vol = rng.uniform(size=(16, 16, 16, 2)).astype(np.float32)
    img = rng.uniform(size=(16, 32, 3)).astype(np.float32)
    p = rng.uniform(-1.5, 1.5, size=(500, 3)).astype(np.float32)
    jp3 = jsampling.build_pyramid3d(jnp.asarray(vol))
    jp2 = jsampling.build_pyramid2d(jnp.asarray(img))
    tp3, tp2 = tsampling.build_pyramid3d(_t(vol)), tsampling.build_pyramid2d(_t(img))
    want = np.asarray(jsampling.sample3d_lod(jp3, jnp.asarray(p), lod, wrap))
    got = tsampling.sample3d_lod(tp3, _t(p), lod, wrap).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    want = np.asarray(jsampling.sample2d_lod(jp2, jnp.asarray(p[:, :2]), lod, wrap))
    got = tsampling.sample2d_lod(tp2, _t(p[:, :2]), lod, wrap).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_point_samplers_match_jax():
    """The `q [..., 3]` brick forms `sample_brick3` and `sample_tiny3`
    against JAX's and against `sample3d` (atol 1e-5); `build_brick3_device`
    is the device-side `build_brick3`."""
    rng = np.random.default_rng(14)
    vol = rng.uniform(size=(16, 16, 16, 2)).astype(np.float32)
    tiny = rng.uniform(size=(4, 4, 4, 1)).astype(np.float32)
    q = rng.uniform(-2, 2, size=(600, 3)).astype(np.float32)
    assert tbrick.build_brick3_device is tbrick.build_brick3
    for jvol, tvol, a in (
            (jbrick.build_brick3(vol), tbrick.build_brick3_device(_t(vol)), vol),
            (jbrick.build_tiny3(tiny), tbrick.build_tiny3(_t(tiny)), tiny)):
        jfn, tfn = ((jbrick.sample_brick3, tbrick.sample_brick3) if a is vol
                    else (jbrick.sample_tiny3, tbrick.sample_tiny3))
        got = tfn(tvol, _t(q)).numpy()
        np.testing.assert_allclose(got, np.asarray(jfn(jvol, jnp.asarray(q))),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(got, tsampling.sample3d(_t(a), _t(q)).numpy(),
                                   atol=1e-5, rtol=0)


# ------------------------------------------------------------------ density

def test_density_matches_jax(scene):
    """`sample_weather` and `density_at` at random points of the cloud shell,
    at the march's mips 0, 1, 3 and 5 (lods clamped and past the large
    chain's end); some points carry no coverage, the denominator guard's
    case. The weather fetch matches at atol 1e-5. XLA on the CPU contracts the radius's x² + y² + z² into FMAs and
    torch does not, so the two f32 radii differ by an ulp (0.5 m at 6,000
    km) at 57 of the 600 points, which moves the height fraction of the
    2.5 km shell by 2e-4 and the density by up to 7.3e-4 there: the density
    is held at atol 1e-5 where the radii agree, and at tests/test_march.py's
    atol 2e-3 everywhere."""
    s = scene
    rng = np.random.default_rng(7)
    dirs = rng.normal(size=(600, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    p = (dirs * rng.uniform(ref.SKY_B_RADIUS, ref.SKY_T_RADIUS, size=(600, 1))
         ).astype(np.float32)
    wpos = np.asarray(s["jp"].weather_pos)
    jw = jdensity.sample_weather(s["jn"], jnp.asarray(p[:, [0, 2]]), jnp.asarray(wpos))
    tw = tdensity.sample_weather(s["tn"], _t(p[:, [0, 2]]), s["tp"].weather_pos)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5, rtol=0)
    same_radius = np.asarray(jnp.linalg.norm(jnp.asarray(p), axis=-1)) == \
        tmath.norm3(_t(p)).numpy()
    assert 0.8 < same_radius.mean() < 1.0
    weather = rng.uniform(0, 1, size=(600, 3)).astype(np.float32)
    weather[:50, 2] = 0.0
    for mip in (0.0, 1.0, 3.0, 5.0):
        want, want_hf = jdensity.density_at(jnp.asarray(p), jnp.asarray(weather),
                                            mip, s["jp"], s["jn"])
        got, got_hf = tdensity.density_at(_t(p), _t(weather), mip, s["tp"], s["tn"])
        want, got = np.asarray(want), got.numpy()
        np.testing.assert_allclose(got[same_radius], want[same_radius], atol=1e-5,
                                   rtol=0, err_msg=f"mip={mip}")
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=0, err_msg=f"mip={mip}")
        np.testing.assert_allclose(got_hf.numpy()[same_radius],
                                   np.asarray(want_hf)[same_radius], atol=1e-5)
        assert np.isfinite(got).all() and (want[same_radius] > 0).any()


def test_brick_density_wrappers_match_jax(scene):
    """The `[..., 3]` forms on the brick tables — `_weather_rb`,
    `_density_pre`, `_density_bricks` (mips 0 and 3) and `_cone_density`
    with and without `approx_weather` — against JAX's at random points of
    the upper shell: atol 1e-5, but for the radius effect of
    `test_density_matches_jax` (8 of the 500 radii differ by an ulp, and
    the density gradient turns their 2e-4 of height fraction into up to
    1.3e-3 of `pre`): there `pre` and the height fraction are held at
    atol 2e-3."""
    s = scene
    rng = np.random.default_rng(8)
    dirs = rng.normal(size=(500, 3))
    dirs[:, 1] = np.abs(dirs[:, 1])
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    p = (dirs * rng.uniform(ref.SKY_B_RADIUS, ref.SKY_T_RADIUS, size=(500, 1))
         ).astype(np.float32)
    jpp, tpp = jnp.asarray(p), _t(p)
    same_radius = np.asarray(jnp.sqrt(jpp[:, 0] * jpp[:, 0] + jpp[:, 1] * jpp[:, 1]
                                      + jpp[:, 2] * jpp[:, 2])) == \
        tmath.norm3(tpp).numpy()
    assert 0.9 < same_radius.mean() < 1.0
    jw = jmf._weather_rb(s["jb"], jpp[:, [0, 2]], s["jp"].weather_pos)
    tw = tmf._weather_rb(s["tb"], tpp[:, [0, 2]], s["tp"].weather_pos)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5, rtol=0)
    for mip in (0.0, 3.0):
        for jfn, tfn in ((jmf._density_pre, tmf._density_pre),
                         (jmf._density_bricks, tmf._density_bricks)):
            want = jfn(jpp, jw, mip, s["jp"], s["jb"])
            got = tfn(tpp, tw, mip, s["tp"], s["tb"])
            for g, w in zip(got, want):
                g, w = g.numpy(), np.asarray(w)
                what = f"{tfn.__name__} mip {mip}"
                np.testing.assert_allclose(g[same_radius], w[same_radius], atol=1e-5,
                                           rtol=0, err_msg=what)
                np.testing.assert_allclose(g, w, atol=2e-3, rtol=0, err_msg=what)
    ldir = s["tp"].light_direction / tmath.norm3(s["tp"].light_direction)
    offsets, distant, _ = tmf._light_offsets(ldir, 6)
    joffsets, jdistant, _ = jmf._light_offsets(
        s["jp"].light_direction / jnp.linalg.norm(s["jp"].light_direction), 6)
    for approx in (False, True):
        want = jmf._cone_density(jpp, s["jp"], s["jb"], joffsets, jdistant, 6,
                                 approx_weather=approx)
        got = tmf._cone_density(tpp, s["tp"], s["tb"], offsets, distant, 6,
                                approx_weather=approx)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        assert (np.asarray(want) > 0).any()


# -------------------------------------------------------------- scan march

def test_march_matches_jax(scene):
    """`march` against JAX's: ≥ 50 dB (91.41 dB measured); rays below the
    horizon exactly 0."""
    s = scene
    want = np.asarray(jmarch.march(jnp.asarray(s["d"]), s["jp"], s["jn"], s["jsky"],
                                   steps=STEPS))
    got = tmarch.march(_t(s["d"]), s["tp"], s["tn"], s["tsky"], steps=STEPS).numpy()
    assert got.shape == want.shape == (32, 32, 4)
    assert (want[..., 3] > 0.1).mean() > 0.03
    assert psnr(got, want) >= 50.0
    np.testing.assert_array_equal(got[s["d"][..., 1] <= 0.0], 0.0)


def test_march_matches_oracle(scene):
    """tests/test_march.py's oracle gate on this procedural pack (that test
    reads the reference's assets): `march` at 48², 32 steps against the f64
    `cloud_march_ref`, ≥ 40 dB (61.10 dB measured), alpha in [0, 1] and
    clouds in the scene."""
    s = scene
    d = np.asarray(jdirs(48))
    got = tmarch.march(_t(d), s["tp"], s["tn"], s["tsky"], steps=32).numpy()
    want = ref.cloud_march_ref(
        d.astype(np.float64), s["prm"],
        [np.asarray(a, np.float64) for a in s["jn"].large],
        [np.asarray(a, np.float64) for a in s["jn"].small],
        np.asarray(s["jn"].weather, np.float64), s["sky"].astype(np.float64),
        steps=32)
    assert got.shape == want.shape == (48, 48, 4)
    assert psnr(got, want) >= 40.0
    assert got[..., 3].min() >= 0.0 and got[..., 3].max() <= 1.0
    assert (got[..., 3] > 0.1).mean() > 0.05


# ------------------------------------------------------ exact brick march

def test_march_bricks_matches_jax(scene, exact):
    """`march_bricks` (compacted, capacity 0.25, cutoff 1e-4) against JAX's
    (≥ 50 dB, 118.04 dB measured) and against the port's `march`, the JAX
    gate of tests/test_brick.py (≥ 40 dB, 65.31 dB measured)."""
    s = scene
    want, got = exact
    assert got.shape == want.shape == (32, 32, 4)
    assert np.isfinite(got).all()
    assert psnr(got, want) >= 50.0
    scan = tmarch.march(_t(s["d"]), s["tp"], s["tn"], s["tsky"], steps=STEPS).numpy()
    assert psnr(got, scan) >= 40.0
    assert (scan[..., 3] > 0.1).mean() > 0.03


def test_march_bricks_vs_scan_at_128_steps(scene):
    """At 128 steps the exact brick march and the scan march drift apart in
    JAX as in the port: the scan's iterative position update p += ndir·ss
    accumulates f32 rounding that the brick march's closed form p0 +
    ndir·ss·i does not. Measured here: JAX 47.03 dB, the port 47.17 dB
    (65.30 / 65.31 at 16 steps, 57.91 / 58.01 at 64). The port holds
    tests/test_brick.py's 40 dB gate and stays within 0.5 dB of JAX."""
    s = scene
    d = jnp.asarray(s["d"])
    jscan = np.asarray(jmarch.march(d, s["jp"], s["jn"], s["jsky"], steps=128))
    jexact = np.asarray(jmf.march_bricks(d, s["jp"], s["jb"], s["jsky"], steps=128))
    tscan = tmarch.march(_t(s["d"]), s["tp"], s["tn"], s["tsky"], steps=128).numpy()
    texact = tmf.march_bricks(_t(s["d"]), s["tp"], s["tb"], s["tsky"],
                              steps=128).numpy()
    want, got = psnr(jexact, jscan), psnr(texact, tscan)
    assert got >= 40.0 and abs(got - want) <= 0.5
    assert psnr(texact, jexact) >= 50.0


def test_march_bricks_compact_matches_dense(scene):
    """The compacted march reproduces the dense one: atol 1e-6 at cutoff 0
    (max abs diff 0 measured), > 60 dB at the default 1e-4 (as in JAX; here
    equal too); the dense arm against JAX's dense arm ≥ 50 dB (118.04 dB
    measured)."""
    s = scene
    dense = _port_bricks(s, compact=False)
    comp = _port_bricks(s, capacity_frac=0.5, t_cutoff=0.0)
    np.testing.assert_allclose(comp, dense, atol=1e-6, rtol=0)
    assert psnr(_port_bricks(s, capacity_frac=0.5, t_cutoff=1e-4), dense) > 60.0
    want = np.asarray(jmf.march_bricks(jnp.asarray(s["d"]), s["jp"], s["jb"],
                                       s["jsky"], steps=STEPS, compact=False))
    assert psnr(dense, want) >= 50.0


@pytest.mark.parametrize("compact", [True, False])
def test_march_bricks_chunking_invariance(scene, compact):
    """One chunk against 64-ray chunks (the dense arm pads its last chunk
    with below-horizon rays): atol 1e-6."""
    s = scene
    d = _t(s["d"][:16, :20])
    a, b = (tmf.march_bricks(d, s["tp"], s["tb"], s["tsky"], steps=8, chunk=c,
                             compact=compact).numpy() for c in (1 << 20, 64))
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_march_bricks_approx_light(scene, exact):
    """approx_light (one weather fetch for the six cone samples) holds
    tests/test_brick.py's gate, > 45 dB from the exact march, in both
    packages (47.33 dB measured in each), and the two agree at ≥ 50 dB
    (118.04 dB)."""
    s = scene
    got = _port_bricks(s, approx_light=True)
    want = np.asarray(jmf.march_bricks(jnp.asarray(s["d"]), s["jp"], s["jb"],
                                       s["jsky"], steps=STEPS, approx_light=True))
    assert psnr(got, exact[1]) > 45.0 and psnr(want, exact[0]) > 45.0
    assert psnr(got, want) >= 50.0


def test_march_bricks_bf16_tables(scene, exact):
    """`BrickPack.from_noise(dtype=torch.bfloat16)`: the 3-D tables are
    bf16, the weather table f32, the samples f32 (bf16 rows times f32
    weights, summed in f32); the march holds tests/test_brick.py's gate,
    > 40 dB from the f32 tables (64.23 dB measured, JAX's 64.23 dB), and
    meets JAX's bf16 march at ≥ 50 dB (118.14 dB)."""
    s = scene
    bp16 = tmf.BrickPack.from_noise(s["tn"], dtype=torch.bfloat16)
    assert all((v.texels if isinstance(v, tbrick.Texture3D) else v.row).dtype
               == torch.bfloat16 for v in bp16.large + bp16.small)
    assert bp16.weather.texels.dtype == torch.float32
    q = torch.rand(300, 3, generator=torch.Generator().manual_seed(3))
    for vol in (bp16.large[0], bp16.small[0], bp16.large[-1]):
        assert tmf._sample_volume_xyz(vol, q[:, 0], q[:, 1], q[:, 2]).dtype \
            == torch.float32
    got = tmf.march_bricks(_t(s["d"]), s["tp"], bp16, s["tsky"], steps=STEPS).numpy()
    assert psnr(got, exact[1]) > 40.0
    want = np.asarray(jmf.march_bricks(
        jnp.asarray(s["d"]), s["jp"], jmf.BrickPack.from_noise(s["jn"], dtype=jnp.bfloat16),
        s["jsky"], steps=STEPS))
    assert psnr(got, want) >= 50.0


def test_march_bricks_cone_cache_res(scene):
    """cone_cache_res builds the cone cache `march_bricks` then looks up
    (chunk min(chunk, n)): equal to the march with that cache prebuilt, and
    ≥ 50 dB from JAX's `march_bricks(cone_cache_res=...)` (117.90 dB
    measured)."""
    s = scene
    prebuilt = tmf.build_cone_cache(s["tp"], s["tb"], 6, res=RES, chunk=1024)
    got = _port_bricks(s, cone_cache_res=RES)
    np.testing.assert_array_equal(got, _port_bricks(s, cone_cache=prebuilt))
    want = np.asarray(jmf.march_bricks(jnp.asarray(s["d"]), s["jp"], s["jb"],
                                       s["jsky"], steps=STEPS, cone_cache_res=RES))
    assert psnr(got, want) >= 50.0


# ------------------------------------------------------------ cone bake API

def test_cone_occupancy_indices_match(scene):
    """The one-pass occupancy (`cone_occupancy_indices`) is bitwise JAX's and
    the port's sliced form (`cone_occupancy_slice` → `cone_occupancy_finalize`),
    at the default capacity 0.45 (2,501 occupied cells of 10,240, the rest
    fill) and at 0.2, which the occupancy overflows (the same cells dropped)."""
    s = scene
    n = int(np.prod(RES))
    occ = torch.zeros(n, dtype=torch.bool)
    for i0 in range(0, n, 3000):
        tmf.cone_occupancy_slice(occ, min(i0, n - 3000), s["tp"], s["tb"], 3000,
                                 res=RES)
    for frac in (0.45, 0.2):
        want = np.asarray(jmf.cone_occupancy_indices(
            s["jp"], s["jb"], res=RES, chunk=512, sparse_capacity_frac=frac))
        got = tmf.cone_occupancy_indices(s["tp"], s["tb"], res=RES, chunk=512,
                                         sparse_capacity_frac=frac)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tmf.cone_occupancy_finalize(
            occ, res=RES, chunk=512, sparse_capacity_frac=frac).numpy(), want)
        assert ((want < n).all() if frac == 0.2 else 0 < (want < n).sum() < len(want))


def _meta(table):
    """A brick table's fields but the table itself."""
    return {f.name: getattr(table, f.name) for f in dataclasses.fields(table)
            if f.name != "table"}


def test_assemble_cone_cache_matches():
    """`assemble_cone_cache` holds a cone volume as a 1-channel clamp
    texture of its texels, which packed into JAX's layout (CONE_BRICK bricks
    at CONE_STRIDE) is JAX's table, metadata and all; the sliced
    `cone_table_rows` → `wrap_cone_table` gives the same texture."""
    rng = np.random.default_rng(15)
    vol = rng.uniform(size=RES).astype(np.float32)
    want = jmf.assemble_cone_cache(jnp.asarray(vol), extent=200e3)
    got = tmf.assemble_cone_cache(_t(vol), extent=200e3)
    tex = got.table
    assert (tex.dims, tex.channels, tex.wrap) == (RES, 1, "clamp")
    np.testing.assert_array_equal(tex.texels.numpy(), vol[..., None])
    packed = tbrick.build_brick3(tex.texels, tmf.CONE_BRICK, tmf.CONE_STRIDE,
                                 wrap="clamp")
    np.testing.assert_array_equal(packed.table.numpy(), np.asarray(want.table.table))
    assert _meta(packed) == _meta(want.table)
    assert got.extent == want.extent == 200e3
    n = int(np.prod(RES))
    rows = torch.cat([tmf.cone_table_rows(_t(vol), r0, min(100, n - r0))
                      for r0 in range(0, n, 100)])
    sliced = tmf.wrap_cone_table(rows, RES, extent=200e3)
    np.testing.assert_array_equal(sliced.table.texels.numpy(), tex.texels.numpy())
    assert (sliced.table.dims, sliced.table.channels, sliced.table.wrap) == \
        (tex.dims, tex.channels, tex.wrap) and sliced.extent == 200e3
