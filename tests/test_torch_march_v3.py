"""The PyTorch port's v3 cell-gated march ≡ the JAX package's, on the CPU.

Both packages get the same tiny noise pack (the JAX generators at base 16,
detail 16, weather 64, as tests/test_torch_engine.py builds it), the same
march parameters and the JAX v3 test's geometry: `hemisphere_dirs(64, 32)`,
64 steps, 16 prepass steps, ray stride 2, a (8, 64, 64) cone cache. The
port runs its kernel wrappers' plain versions (K2 compaction, K3 segmented
scan, K1 accumulation); the JAX side runs its XLA forms, so the port's
always-taken segment-end accumulation meets the JAX CPU branch's
scatter-adds.

Measured on the CPU: the port's prepass priorities agree with JAX's within
6e-4 and no coarse cell is gated differently on this scene; the v3 render
matches JAX's at ~99 dB (segmented, planes and the flat arm alike); the
port's segmented and planes accumulations agree at ~165 dB; with every
gate off the port's v3 meets its dense march at ~165 dB. On this scene
JAX's own v3 policy render reaches only 34.62 dB against the exact march
(the cell gate and ray cull lose cloud edges, as they do on the engine's
octahedral map, PERF.md), so the policy-vs-exact gate is held at what JAX
reaches, 34 dB, for both packages.
"""

import numpy as np
import jax
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

# Several test workers share the host's cores: keep torch's intra-op
# thread pool small so they do not oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))
# The port's entry points default to the card: these tests ask for the CPU.
DEV = torch.device("cpu")

STEPS, PS, STRIDE, CHUNK = 64, 16, 2, 1024
RES = (8, 64, 64)
COVERAGE = 0.6


def hemisphere_dirs(width: int, height: int) -> np.ndarray:
    """tests/test_march_v3.py's lat-long grid over the upper hemisphere."""
    az = (np.arange(width) + 0.5) / width * 2.0 * np.pi - np.pi
    el = (np.arange(height) + 0.5) / height * (np.pi / 2.0)
    cos_el = np.cos(el)[:, None]
    d = np.stack([cos_el * np.cos(az)[None, :],
                  np.broadcast_to(np.sin(el)[:, None], (height, width)),
                  cos_el * np.sin(az)[None, :]], axis=-1)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


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


def _jax_v3(s, dirs, **kw):
    return np.asarray(jmf.march_bricks_v3(jnp.asarray(dirs), s["jp"], s["jb"],
                                          s["jsky"], steps=STEPS, chunk=CHUNK,
                                          cone_cache=s["jc"], prepass_steps=PS,
                                          **kw))


def _port_v3(s, dirs, **kw):
    return tmf.march_bricks_v3(torch.from_numpy(dirs), s["tp"], s["tb"], s["tsky"],
                               steps=STEPS, chunk=CHUNK, cone_cache=s["tc"],
                               prepass_steps=PS, **kw).numpy()


@pytest.fixture(scope="module")
def policy(scene):
    """(JAX's, the port's) `v3_auto_policy` on the scene."""
    s = scene
    jpol = jmf.v3_auto_policy(jnp.asarray(s["d"]), s["jp"], s["jb"], steps=STEPS,
                              ray_stride=STRIDE, prepass_steps=PS)
    tpol = tmf.v3_auto_policy(torch.from_numpy(s["d"]), s["tp"], s["tb"],
                              steps=STEPS, ray_stride=STRIDE, prepass_steps=PS)
    return jpol, tpol


def _knobs(policy):
    rk, ck, hk = policy[0][:3]
    return dict(ray_keep_frac=rk, cell_keep_frac=ck, hot_keep_frac=hk,
                ray_stride=STRIDE)


def test_seg_end_reduce_matches_scatter_add():
    """The segment-end reduction (K3 scans + K2 end compaction + a unique
    write per ray) ≡ JAX's per-ray scatter-adds, on
    tests/test_march_v3.py's hot list: sorted ray ids in runs, a fill
    suffix tagged n − 1 that merges into the last segment."""
    rng = np.random.default_rng(7)
    n, cap_h, n_real = 256, 1024, 800
    ids = np.sort(rng.integers(0, n, size=n_real))
    ray_h = np.concatenate([ids, np.full(cap_h - n_real, n - 1)])
    valid = np.arange(cap_h) < n_real
    head = np.concatenate([[True], ray_h[1:] != ray_h[:-1]])
    cellsums = [np.where(valid, rng.normal(size=cap_h), 0.0).astype(np.float32)
                for _ in range(3)]
    logdt = np.where(valid, -np.abs(rng.normal(size=cap_h)), 0.0).astype(np.float32)

    head_t = torch.from_numpy(head)
    incl = tmf.segscan(torch.from_numpy(logdt), head_t)
    bufs, logT = tmf._seg_end_reduce(torch.from_numpy(np.stack(cellsums)), incl,
                                     head_t, torch.from_numpy(ray_h), n, cap_h)
    ridx = jnp.where(jnp.asarray(valid), jnp.asarray(ray_h, jnp.int32), n)
    for c in range(3):
        want = jnp.zeros((n,), jnp.float32).at[ridx].add(
            cellsums[c], mode="drop", indices_are_sorted=True)
        np.testing.assert_allclose(bufs[c].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    want_logT = jnp.zeros((n,), jnp.float32).at[ridx].add(
        logdt, mode="drop", indices_are_sorted=True)
    np.testing.assert_allclose(logT.numpy(), np.asarray(want_logT),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arm", ["grid_stride2", "grid_stride1", "flat"])
def test_cull_prepass_matches_jax(scene, arm):
    """`_cull_prepass`'s three arms (and its priority-only view
    `_cull_priority`) against JAX's: priorities within 1e-3
    (measured: at most 5.8e-4, on 6–24 of 2,048 rays more than 1e-5; −inf at
    the same rays), the same grid meta, and at most 0.1% of the coarse cells
    gated differently (0 measured in every arm)."""
    s = scene
    d = s["d"] if arm != "flat" else s["d"].reshape(-1, 3)
    shape = d.shape[:-1]
    cull_shape = shape if len(shape) == 2 else None
    stride = 2 if arm == "grid_stride2" else 1

    @jax.jit
    def jax_prepass(dirs, params, bp):
        above, ndir, ss, p0, _, _ = jmf._ray_setup(dirs.reshape(-1, 3), params, STEPS)
        return jmf._cull_prepass(above, ndir, ss, p0, params, bp, STEPS, PS, CHUNK,
                                 cull_shape, stride, 0.1)

    jprio, jocc, jmeta = jax_prepass(jnp.asarray(d), s["jp"], s["jb"])
    above, ndir, ss, p0, _, _ = tmf._ray_setup(torch.from_numpy(d).reshape(-1, 3),
                                               s["tp"], STEPS)
    tprio, tocc, tmeta = tmf._cull_prepass(above, ndir, ss, p0, s["tp"], s["tb"],
                                           STEPS, PS, CHUNK, cull_shape, stride, 0.1)
    jprio, jocc = np.asarray(jprio), np.asarray(jocc)
    tprio, tocc = tprio.numpy(), tocc.numpy()
    assert tmeta == (None if jmeta is None else tuple(int(v) for v in jmeta))
    assert tocc.shape == jocc.shape
    np.testing.assert_array_equal(np.isfinite(tprio), np.isfinite(jprio))
    fin = np.isfinite(jprio)
    np.testing.assert_allclose(tprio[fin], jprio[fin], rtol=0, atol=1e-3)
    assert (tocc != jocc).mean() <= 1e-3
    np.testing.assert_array_equal(tmf._cull_priority(
        above, ndir, ss, p0, s["tp"], s["tb"], STEPS, PS, CHUNK, cull_shape,
        stride).numpy(), tprio)
    assert jocc.any() and not jocc.all()


@pytest.mark.parametrize("ray_cap", [256, 1024, 4096])
def test_select_top_rays_matches_jax(ray_cap):
    """The histogram select ≡ JAX's, bitwise, including −inf rays and a cap
    the top bin overflows."""
    rng = np.random.default_rng(5)
    n = 8192
    prio = rng.normal(scale=0.3, size=n).astype(np.float32)
    prio[rng.random(n) < 0.1] = -np.inf
    prio[:300] = 0.6  # one crowded top bin
    want = np.asarray(jmf._select_top_rays(jnp.asarray(prio), ray_cap, n))
    got = tmf._select_top_rays(torch.from_numpy(prio), ray_cap, n).numpy()
    np.testing.assert_array_equal(got, want)


def test_policy_helpers_match_jax():
    """`_ray_capacity`, `_ceil_to` and the three bucket selectors ≡ JAX's."""
    for n in (1, 255, 256, 2048, 589824):
        for f in (0.01, 0.3, 0.55, 0.999, 1.0):
            assert tmf._ray_capacity(n, f) == jmf._ray_capacity(n, f)
    for v in (0.0, 0.05, 0.2, 0.31, 0.5, 0.77, 0.95, 1.2):
        assert tmf.select_ray_keep_frac(v) == jmf.select_ray_keep_frac(v)
        assert tmf.select_cell_keep_frac(v) == jmf.select_cell_keep_frac(v)
        assert tmf.select_cell_keep_frac(v, margin=1.2) == \
            jmf.select_cell_keep_frac(v, margin=1.2)
    assert tmf._ceil_to(1000, 128) == jmf._ceil_to(1000, 128) == 1024


def test_v3_auto_policy_matches_jax(policy):
    """The same buckets as JAX's `v3_auto_policy`, the fractions to ~1e-6."""
    jpol, tpol = policy
    assert tpol[:3] == tuple(jpol[:3])
    np.testing.assert_allclose(tpol[3:], jpol[3:], rtol=0, atol=1e-6)
    assert 0.0 < tpol[4] <= tpol[3] <= 1.0


@pytest.mark.parametrize("accum", ["segmented", "planes"])
def test_march_bricks_v3_matches_jax(scene, policy, accum):
    """`march_bricks_v3` at JAX's policy knobs against JAX's: ≥ 50 dB
    (~99 dB measured, with no cell gated differently by the two
    prepasses, test_cull_prepass_matches_jax)."""
    kw = _knobs(policy)
    want = _jax_v3(scene, scene["d"], accum=accum, **kw)
    got = _port_v3(scene, scene["d"], accum=accum, **kw)
    assert got.shape == want.shape == (32, 64, 4)
    assert np.isfinite(got).all()
    assert (want[..., 3] > 0.1).mean() > 0.02
    assert psnr(got, want) >= 50.0


def test_v3_segmented_matches_planes(scene, policy):
    """The port's two accumulations (hot-list segmented scans vs plane
    scatters + K1) are the same math: ≥ 80 dB (~165 dB measured)."""
    kw = _knobs(policy)
    seg = _port_v3(scene, scene["d"], accum="segmented", **kw)
    planes = _port_v3(scene, scene["d"], accum="planes", **kw)
    assert np.abs(seg - planes).max() < 1e-3
    assert psnr(seg, planes) >= 80.0


def test_v3_no_grid_matches_jax(scene):
    """The flat (no-grid) arm, margin-only gating at cell_margin 0.35, no
    ray cull: ≥ 50 dB against JAX's (~99 dB measured)."""
    flat = scene["d"].reshape(-1, 3)
    kw = dict(cell_keep_frac=0.9, hot_keep_frac=0.5, cell_margin=0.35)
    want = _jax_v3(scene, flat, **kw)
    got = _port_v3(scene, flat, **kw)
    assert got.shape == want.shape == (2048, 4)
    assert psnr(got, want) >= 50.0


def test_v3_gates_off_matches_dense(scene):
    """With every gate off (no cull, full capacities, cell margin 1e9) the
    v3 machinery — compactions, lane layout, hot list, segmented
    accumulation — reproduces the port's dense march: ≥ 100 dB (~165 dB
    measured)."""
    got = _port_v3(scene, scene["d"], cell_keep_frac=1.0, hot_keep_frac=1.0,
                   cell_margin=1e9, ray_stride=STRIDE)
    dense = tmf.march_tile_dense(torch.from_numpy(scene["d"]), scene["tp"],
                                 scene["tb"], scene["tsky"], steps=STEPS,
                                 chunk=CHUNK, cone_cache=scene["tc"]).numpy()
    assert psnr(got, dense) >= 100.0


def test_v3_policy_vs_exact(scene, policy):
    """The port's policy render against JAX's exact `march_bricks`. JAX's
    own v3 reaches 34.62 dB here, short of the 40 dB its bench scene holds,
    so both are gated at 34 dB and the port must be within 0.5 dB of JAX
    (34.62 dB measured)."""
    kw = _knobs(policy)
    exact = np.asarray(jmf.march_bricks(jnp.asarray(scene["d"]), scene["jp"],
                                        scene["jb"], scene["jsky"], steps=STEPS,
                                        chunk=CHUNK, capacity_frac=0.5))
    got = _port_v3(scene, scene["d"], **kw)
    want = _jax_v3(scene, scene["d"], **kw)
    p_port, p_jax = psnr(got, exact), psnr(want, exact)
    assert p_jax >= 34.0 and p_port >= 34.0
    assert abs(p_port - p_jax) <= 0.5
