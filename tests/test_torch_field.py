"""The PyTorch port's baked density field ≡ the JAX package's, on the CPU.

`cloudscape_tpu_torch/models/field.py` against `cloudscape_tpu/models/field.py`:
the grid and warp helpers, `build_density_field`, `sample_field_xyz`,
`occupied_ray_fraction` and `march_baked` (with its two compactions, which
take K2's plain version here). Both packages get tests/test_torch_exact.py's
tiny scene: the JAX generators at base 16, detail 16, weather 64 (seeds
1/2/3), coverage 0.6, sun (0.3, 0.4, −0.85), the 32² octahedral texel grid
and 16 steps; the field at res (8, 48, 48), cone (4, 24, 24), chunk 4096.

Measured on the CPU: `march_baked` 150.28 dB from JAX's (151.08 with its
rays overflowing), the ray and erosion indices bitwise JAX's, and the
port's `march_baked` 20.13 dB from the port's `march_bricks` (JAX: 20.08).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cloudscape_tpu.models import atmosphere as jatmo
from cloudscape_tpu.models import field as jfield
from cloudscape_tpu.models import march_fast as jmf
from cloudscape_tpu.models.density import MarchParams as JParams
from cloudscape_tpu.models.packs import make_noise_pack
from cloudscape_tpu.ops.noise import (generate_base_noise, generate_detail_noise,
                                      generate_weather)
from cloudscape_tpu.ops.octmap import texel_directions as jdirs
from cloudscape_tpu.utils.image import psnr
from oracle import reference as ref
from cloudscape_tpu_torch.models import field as tfield
from cloudscape_tpu_torch.models import march_fast as tmf
from cloudscape_tpu_torch.models.density import MarchParams
from cloudscape_tpu_torch.models.packs import noise_pack_from_numpy
from cloudscape_tpu_torch.ops import brick as tbrick

torch.set_num_threads(min(2, torch.get_num_threads()))
DEV = torch.device("cpu")

STEPS = 16
RES = (8, 48, 48)
CONE_RES = (4, 24, 24)
EXTENT = 220e3
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
    jp = JParams.create(**PARAMS, light_direction=sun)
    tp = MarchParams.from_numpy({k: np.asarray(v) for k, v in vars(jp).items()},
                                device=DEV)
    sky = np.asarray(jatmo.sky_lut(jatmo.transmittance_lut(),
                                   jnp.asarray(sun, jnp.float32)))
    jb, tb = jmf.BrickPack.from_noise(jn), tmf.BrickPack.from_noise(tn)
    jf = jfield.build_density_field(jp, jb, res=RES, cone_res=CONE_RES, chunk=4096)
    tf = tfield.build_density_field(tp, tb, res=RES, cone_res=CONE_RES, chunk=4096)
    return dict(jp=jp, tp=tp, jb=jb, tb=tb, jf=jf, tf=tf, jsky=jnp.asarray(sky),
                tsky=_t(sky), d=np.asarray(jdirs(32)), sun=sun)


def _recorded(module, name, fn):
    """(fn's result, every (mask, capacity, total, indices) call of the
    compaction `module.name` made during it)."""
    calls = []
    real = getattr(module, name)

    def rec(mask, capacity, total):
        idx = real(mask, capacity, total)
        calls.append((np.asarray(mask), capacity, total, np.asarray(idx)))
        return idx

    setattr(module, name, rec)
    try:
        return fn(), calls
    finally:
        setattr(module, name, real)


def _jax_baked(s, **kw):
    return _recorded(jfield, "_compact_indices", lambda: np.asarray(
        jfield.march_baked(jnp.asarray(s["d"]), s["jp"], s["jb"], s["jf"],
                           s["jsky"], steps=STEPS, **kw)))


def _port_baked(s, **kw):
    return _recorded(tfield, "_compact_mask", lambda: tfield.march_baked(
        _t(s["d"]), s["tp"], s["tb"], s["tf"], s["tsky"], steps=STEPS,
        **kw).numpy())


@pytest.fixture(scope="module")
def baked(scene):
    """(JAX's, the port's) `march_baked` at chunk 1024, with their recorded
    compactions."""
    return _jax_baked(scene, chunk=1024), _port_baked(scene, chunk=1024)


# ------------------------------------------------------------ the field grid

def test_warp_unwarp_match_jax():
    """`_warp` and `_unwarp` over both signs and 0, rtol 1e-6."""
    rng = np.random.default_rng(21)
    v = np.concatenate([rng.uniform(-EXTENT, EXTENT, 500), [0.0, EXTENT, -EXTENT]]
                       ).astype(np.float32)
    c = np.concatenate([rng.uniform(0, 1, 500), [0.0, 0.5, 1.0]]).astype(np.float32)
    for jfn, tfn, a in ((jfield._warp, tfield._warp, v),
                        (jfield._unwarp, tfield._unwarp, c)):
        want = np.asarray(jfn(jnp.asarray(a), EXTENT))
        np.testing.assert_allclose(tfn(_t(a), EXTENT).numpy(), want, rtol=1e-6,
                                   atol=0)


def test_field_coords_match_jax():
    """`field_coords_xyz` at random points of the upper shell: x̃ and z̃ at
    rtol 1e-6; the height fraction at rtol 1e-6 where the two radii agree,
    else within one radius ulp (0.5 m at 6,000 km) over the shell's 2.5 km
    (the radius effect of tests/test_torch_exact.py)."""
    rng = np.random.default_rng(22)
    dirs = rng.normal(size=(600, 3))
    dirs[:, 1] = np.abs(dirs[:, 1]) + 0.5
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    p = (dirs * rng.uniform(ref.SKY_B_RADIUS, ref.SKY_T_RADIUS, size=(600, 1))
         ).astype(np.float32)
    want = [np.asarray(w) for w in jfield.field_coords_xyz(
        *(jnp.asarray(p[:, i]) for i in range(3)), EXTENT)]
    got = [g.numpy() for g in tfield.field_coords_xyz(
        *(_t(p[:, i]) for i in range(3)), EXTENT)]
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
    jp_, tp_ = jnp.asarray(p), _t(p)
    jr = np.asarray(jnp.sqrt(jp_[:, 0] * jp_[:, 0] + jp_[:, 1] * jp_[:, 1]
                             + jp_[:, 2] * jp_[:, 2]))
    tr = torch.sqrt(tp_[:, 0] * tp_[:, 0] + tp_[:, 1] * tp_[:, 1]
                    + tp_[:, 2] * tp_[:, 2]).numpy()
    same = jr == tr
    assert same.mean() > 0.8
    np.testing.assert_allclose(got[2][same], want[2][same], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=0.5 / 2500.0 * 1.01)


@pytest.mark.parametrize("res", [RES, CONE_RES, (3, 5, 7)])
def test_grid_positions_match_jax(res):
    """`_grid_positions`: the cell centres at rtol 1e-6."""
    want = jfield._grid_positions(res, EXTENT)
    got = tfield._grid_positions(res, EXTENT)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


# ------------------------------------------------------------------ the bake

def _channel(table, c):
    """Channel c's lanes of a 2-channel brick table (channel-major lanes)."""
    return np.asarray(table).reshape(table.shape[0], 2, -1)[:, c]


def test_field_table_matches_jax(scene):
    """`build_density_field`'s texture, packed into JAX's layout (2-channel
    4×4×4 bricks at stride 3, clamp), against JAX's brick table: the same
    dims and wrap, and ≥ 99% of entries
    within atol 1e-5. The rest is the grid's y: torch's float32 sqrt on the
    CPU is one ulp (0.5 m) off the correctly rounded root JAX takes at
    ~1.3% of the cells, which moves their height fraction by 2e-4, and the
    height gradient turns that into up to 4.79e-3 of `pre` (a one-ulp
    shift of any cell's y moves its `pre` by at most that on this scene;
    all entries held at 5e-3) and 2.4e-4 of the upsampled `cd` (held at
    2e-3). Given the
    port's own cell centres, JAX's `pre` is the port's channel 0 at
    atol 1e-5 everywhere."""
    s = scene
    jt, tex = s["jf"].table, s["tf"].table
    assert tex.dims == jt.dims and tex.channels == 2 and tex.wrap == jt.wrap == "clamp"
    tt = tbrick.build_brick3(tex.texels, (4, 4, 4), (3, 3, 3), wrap="clamp")
    assert tt.grid == jt.grid
    want, got = np.asarray(jt.table), tt.table.numpy()
    assert got.shape == want.shape == (int(np.prod(jt.grid)), 128)
    assert (np.abs(got - want) <= 1e-5).mean() >= 0.99
    np.testing.assert_allclose(_channel(got, 0), _channel(want, 0), atol=5e-3, rtol=0)
    np.testing.assert_allclose(_channel(got, 1), _channel(want, 1), atol=2e-3, rtol=0)
    assert (_channel(want, 0) > 0).any() and (_channel(want, 1) > 0).any()
    px, py, pz = (jnp.asarray(v.numpy()) for v in tfield._grid_positions(RES, EXTENT))
    w = jmf._weather_rb_xy(s["jb"], px, pz, s["jp"].weather_pos)
    jpre = np.asarray(jmf._density_pre_xyz(px, py, pz, w, 0.0, s["jp"], s["jb"])[0])
    vol = np.stack([jpre, np.zeros_like(jpre)], axis=-1).reshape(RES + (2,))
    jpre_table = tbrick.build_brick3(_t(vol), (4, 4, 4), (3, 3, 3), wrap="clamp")
    np.testing.assert_allclose(_channel(got, 0), _channel(jpre_table.table, 0),
                               atol=1e-5, rtol=0)


def test_sample_field_matches_density_pre(scene):
    """At every cell centre the field returns the baked `pre` (trilinear is
    exact there, up to the float32 warp → unwarp round trip nudging the
    query a fraction of a cell): the port's form of
    tests/test_field.py's `test_field_lookup_matches_bake_points`, against
    the port's own `_density_pre_xyz`, atol 5e-3 and rtol 1e-2."""
    s = scene
    px, py, pz = tfield._grid_positions(RES, EXTENT)
    f = tfield.sample_field_xyz(s["tf"], px, py, pz)
    assert tuple(f.shape) == (px.shape[0], 2)
    w = tmf._weather_rb_xy(s["tb"], px, pz, s["tp"].weather_pos)
    pre, _ = tmf._density_pre_xyz(px, py, pz, w, 0.0, s["tp"], s["tb"])
    np.testing.assert_allclose(f[..., 0].numpy(), pre.numpy(), atol=5e-3, rtol=1e-2)


def test_occupied_ray_fraction_matches_jax(scene):
    """Within 2/1024 of JAX's on the 32² grid (it lies in (0, 1]); an empty
    scene (coverage 0, margin 0) gives exactly 0, as tests/test_field.py's
    check does."""
    s = scene
    want = float(jfield.occupied_ray_fraction(jnp.asarray(s["d"]), s["jp"], s["jf"]))
    got = tfield.occupied_ray_fraction(_t(s["d"]), s["tp"], s["tf"])
    assert got.dim() == 0 and 0.0 < float(got) <= 1.0
    assert abs(float(got) - want) <= 2.0 / 1024
    empty = MarchParams.from_numpy({k: np.asarray(v) for k, v in vars(JParams.create(
        cloud_coverage=0.0, light_direction=s["sun"])).items()}, device=DEV)
    field0 = tfield.build_density_field(empty, s["tb"], res=(8, 64, 64),
                                        cone_res=(8, 32, 32), chunk=4096)
    assert float(tfield.occupied_ray_fraction(_t(s["d"]), empty, field0,
                                              occupancy_margin=0.0)) == 0.0


# ----------------------------------------------------------------- the march

@pytest.mark.parametrize("jitter", [True, False])
def test_march_baked_matches_jax(scene, jitter):
    """`march_baked` ≥ 40 dB from JAX's (150.28 dB measured), finite, with
    and without the start jitter. The jitter hashes the shell entry × 10,
    whose y (≥ 6e7) has no fraction in float32, so it is 0 in both packages
    and the two renders are alike."""
    s = scene
    (want, _), (got, _) = _jax_baked(s, chunk=1024, jitter=jitter), \
        _port_baked(s, chunk=1024, jitter=jitter)
    assert got.shape == want.shape == s["d"].shape[:-1] + (4,)
    assert np.isfinite(got).all() and (got[..., 3] > 0.1).any()
    assert psnr(got, want) >= 40.0


def test_compaction_indices_match_jax(baked):
    """Two compactions a call, through K2's wrapper: the rays (1024 → 1024)
    and the `pre > 0` samples (16,384 → 8,192). Both index lists bitwise
    JAX's."""
    (_, jcalls), (_, tcalls) = baked
    assert [c[1:3] for c in tcalls] == [c[1:3] for c in jcalls] == \
        [(1024, 1024), (8192, 16384)]
    for (jm, _, _, jidx), (tm, _, _, tidx) in zip(jcalls, tcalls):
        np.testing.assert_array_equal(tm, jm)
        assert tidx.dtype == np.int32
        np.testing.assert_array_equal(tidx, jidx)


def test_compactions_launch_k2(scene):
    """Each `march_baked` reaches `ops/compact.py:compact` (K2 on a CUDA
    tensor, its plain version here) exactly twice, without rank."""
    s = scene
    calls = []
    real = tmf.compact

    def spy(mask, capacity, total, with_rank=True):
        calls.append((mask.shape[0], capacity, with_rank))
        return real(mask, capacity, total, with_rank)

    tmf.compact = spy
    try:
        tfield.march_baked(_t(s["d"]), s["tp"], s["tb"], s["tf"], s["tsky"],
                           steps=STEPS, chunk=1024)
    finally:
        tmf.compact = real
    assert calls == [(1024, 1024, False), (16384, 8192, False)]


@pytest.mark.parametrize("overflow", ["erosion", "rays"])
def test_march_baked_overflow_matches_jax(scene, baked, overflow):
    """A capacity below what the scene occupies: at chunk 64, erosion
    capacity 0.01 (192 slots for 324 samples) or ray capacity 0.3 (320
    slots for 746 rays). The port ≥ 40 dB from JAX's render at the same
    settings (and its indices bitwise JAX's), and < 40 dB from the render
    without overflow (28.87 dB measured, both cases)."""
    s = scene
    kw = dict(chunk=64, erosion_capacity_frac=0.01) if overflow == "erosion" \
        else dict(chunk=64, ray_capacity_frac=0.3)
    (want, jcalls), (got, tcalls) = _jax_baked(s, **kw), _port_baked(s, **kw)
    which = 1 if overflow == "erosion" else 0
    mask, cap = tcalls[which][0], tcalls[which][1]
    assert mask.sum() > cap
    for (_, _, _, jidx), (_, _, _, tidx) in zip(jcalls, tcalls):
        np.testing.assert_array_equal(tidx, jidx)
    assert np.isfinite(got).all()
    assert psnr(got, want) >= 40.0
    assert psnr(got, baked[1][0]) < 40.0


def test_march_baked_band_vs_march_bricks(scene, baked):
    """The documented negative on the port: `march_baked` 15–40 dB from the
    port's exact `march_bricks` (20.13 dB measured; JAX's pair 20.08)."""
    s = scene
    exact = tmf.march_bricks(_t(s["d"]), s["tp"], s["tb"], s["tsky"],
                             steps=STEPS).numpy()
    assert 15.0 < psnr(baked[1][0], exact) < 40.0
