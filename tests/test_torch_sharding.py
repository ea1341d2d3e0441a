"""The PyTorch port's multi-device sharding ≡ its single-device results and
the JAX package's sharded results, on the CPU.

Both packages get the same tiny noise pack (the JAX generators at base 16,
detail 16, weather 64, as tests/test_torch_engine.py builds it), the march
parameters and sun of tests/test_sharding.py, the JAX sky LUT, and a
(8, 64, 64) cone cache each. JAX runs on its virtual 8-device CPU mesh
(tests/conftest.py); the port on `make_mesh(["cpu"] * 8)` (and `* 2`),
one thread per shard, its kernel wrappers taking their plain versions.

Measured on the CPU: every sharded render of the port (reference, fast,
fast2, fast3) is bitwise its single-device render, and the fast3 render on
2 shards is bitwise the one on 8 (mesh-size invariance); the sharded v3
prepass gate and priority are bitwise the unsharded ones; the mesh engines
(fast3, fast2, hier, fast, reference, fast2 with tile cull) step bitwise
as their single-device twins, and fast3 with tile cull lies 39.19 dB from
its twin (capacities sized per shard, as in JAX). Against JAX's sharded
results the port meets the gates its unsharded marches are held to (the
dB in each test).
"""

import sys
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from cloudscape_tpu.config import CloudConfig as JCloud, PerfConfig as JPerf
from cloudscape_tpu.config import SunState as JSun
from cloudscape_tpu.engine import CloudSkyEngine as JEngine
from cloudscape_tpu.models import atmosphere as jatmo
from cloudscape_tpu.models import march_fast as jmf
from cloudscape_tpu.models.density import MarchParams as JParams
from cloudscape_tpu.models.packs import make_noise_pack
from cloudscape_tpu.ops.noise import (generate_base_noise, generate_detail_noise,
                                      generate_weather)
from cloudscape_tpu.parallel import sharding as jsh
from cloudscape_tpu.utils.image import psnr
from cloudscape_tpu_torch import CloudConfig, PerfConfig, SunState
from cloudscape_tpu_torch.engine import CloudSkyEngine
from cloudscape_tpu_torch.models import atmosphere as tatmo
from cloudscape_tpu_torch.models import march_fast as tmf
from cloudscape_tpu_torch.models.density import MarchParams
from cloudscape_tpu_torch.models.march import march
from cloudscape_tpu_torch.models.packs import noise_pack_from_numpy
from cloudscape_tpu_torch.ops import accum, compact, composite_kernel, noise_kernel, segscan
from cloudscape_tpu_torch.ops.octmap import texel_directions
from cloudscape_tpu_torch.parallel import sharding as tsh
from cloudscape_tpu_torch.parallel.sharding import P

# Several test workers share the host's cores: keep torch's intra-op
# thread pool small so the shard threads do not oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))
DEV = torch.device("cpu")
RES = (8, 64, 64)
N, STEPS, LIGHT = 64, 8, 2
SUN = np.array([0.3, 0.5, -0.8]) / np.linalg.norm([0.3, 0.5, -0.8])
# ROADMAP §C: the port's cull priorities differ from JAX's by float
# reassociation in the prepass's samplers, by at most 5.8e-4.
PRIO_ATOL = 5.8e-4


@pytest.fixture(scope="module")
def scene():
    jn = make_noise_pack(generate_base_noise(16, seed=1),
                         generate_detail_noise(16, seed=2),
                         generate_weather(64, seed=3))
    tn = noise_pack_from_numpy([np.asarray(a) for a in jn.large],
                               [np.asarray(a) for a in jn.small],
                               np.asarray(jn.weather), device=DEV)
    jt = jatmo.transmittance_lut()
    jsky = jatmo.sky_lut(jt, jnp.asarray(SUN, jnp.float32))
    jp = JParams.create(cloud_coverage=0.6, light_direction=SUN)
    tp = MarchParams.from_numpy({k: np.asarray(v) for k, v in vars(jp).items()},
                                device=DEV)
    jb, tb = jmf.BrickPack.from_noise(jn), tmf.BrickPack.from_noise(tn)
    return dict(
        jn=jn, tn=tn, jt=jt, jsky=jsky, tsky=torch.from_numpy(np.array(jsky)),
        jp=jp, tp=tp, jb=jb, tb=tb,
        jc=jmf.build_cone_cache(jp, jb, LIGHT, res=RES, chunk=4096),
        tc=tmf.build_cone_cache(tp, tb, LIGHT, res=RES, chunk=4096))


def _mesh(n=8):
    return tsh.make_mesh(["cpu"] * n)


def _noise(s, kernel, side):
    """The noise argument of `render_hemisphere_sharded` for a kernel, the
    JAX package's (side "j") or the port's ("t")."""
    if kernel == "reference":
        return s[side + "n"]
    if kernel == "fast":
        return s[side + "b"]
    return (s[side + "b"], s[side + "c"])


def _single(s, kernel):
    """The port's single-device march with the knobs of `_march_for`."""
    d = texel_directions(N, device=DEV)
    kw = dict(steps=STEPS, light_steps=LIGHT)
    if kernel == "reference":
        return march(d, s["tp"], s["tn"], s["tsky"], **kw)
    if kernel == "fast":
        return tmf.march_bricks(d, s["tp"], s["tb"], s["tsky"], chunk=16384,
                                capacity_frac=0.3, **kw)
    if kernel == "fast2":
        return tmf.march_bricks_v2(d, s["tp"], s["tb"], s["tsky"], chunk=16384,
                                   capacity_frac=0.3, cone_cache=s["tc"], **kw)
    return tmf.march_bricks_v3(d, s["tp"], s["tb"], s["tsky"], chunk=16384,
                               cell_keep_frac=0.75, hot_keep_frac=0.75,
                               cone_cache=s["tc"], ray_keep_frac=1.0,
                               prepass_steps=2, ray_stride=2, **kw)


@pytest.fixture(scope="module")
def renders(scene):
    """kernel → (the port's 8-shard render, the port's single render, JAX's
    8-shard render), numpy, built on first use."""
    cache = {}

    def get(kernel):
        if kernel not in cache:
            s = scene
            shard = tsh.render_hemisphere_sharded(
                _mesh(), N, s["tp"], _noise(s, kernel, "t"), s["tsky"],
                steps=STEPS, light_steps=LIGHT, kernel=kernel)
            jshard = jsh.render_hemisphere_sharded(
                jsh.make_mesh(), N, s["jp"], _noise(s, kernel, "j"), s["jsky"],
                steps=STEPS, light_steps=LIGHT, kernel=kernel)
            cache[kernel] = (shard.numpy(), _single(s, kernel).numpy(),
                             np.asarray(jshard))
        return cache[kernel]

    return get


# ------------------------------------------------------------ the mesh itself


def test_make_mesh_repeats_devices():
    m = tsh.make_mesh(["cpu"] * 4, axis_name="rows")
    assert m.size == 4 and m.axis_names == ("rows",)
    assert m.devices == (DEV,) * 4 and m.distinct_devices() == [DEV]
    with pytest.raises(ValueError):
        tsh.make_mesh([])


def test_collectives_on_eight_shards():
    """axis_index / axis_size, a ppermute ring (shard i → i + 1, and a
    shard that receives nothing gets zeros) and psum, on 8 shards."""
    def fn(x):
        i = tsh.axis_index("rays")
        ring = tsh.ppermute(x, "rays", [(j, (j + 1) % 8) for j in range(8)])
        partial = tsh.ppermute(x, "rays", [(0, 1)])
        total = tsh.psum(x, "rays")
        return ring, partial, total, torch.tensor([i, tsh.axis_size("rays")])

    x = torch.arange(16, dtype=torch.float32).reshape(8, 2)
    ring, partial, total, idx = tsh.shard_map(
        fn, _mesh(), in_specs=(P("rays"),),
        out_specs=(P("rays"), P("rays"), P(), P("rays")))(x)
    assert torch.equal(ring, torch.roll(x, 1, 0))
    want = torch.zeros_like(x)
    want[1] = x[0]
    assert torch.equal(partial, want)
    assert torch.equal(total, x.sum(0, keepdim=True))
    assert torch.equal(idx.reshape(8, 2), torch.stack(
        [torch.arange(8), torch.full((8,), 8)], dim=1))
    with pytest.raises(NameError):
        tsh.axis_size("rays")  # outside shard_map


def test_replicate_moves_once_per_distinct_device(scene):
    """A P() input is moved once to each distinct device and not copied
    where it already is (the meta device stands in for a second one)."""
    tp = scene["tp"]
    reps = tsh.replicate(tp, [DEV, DEV, torch.device("meta"), torch.device("meta")])
    assert reps[0] is reps[1] and reps[2] is reps[3]
    assert reps[0].cloud_coverage.data_ptr() == tp.cloud_coverage.data_ptr()
    assert reps[2].light_direction.device.type == "meta"
    bricks = tsh.replicate(scene["tb"], [DEV])[0]
    assert bricks.large[0].texels.data_ptr() == scene["tb"].large[0].texels.data_ptr()


# ----------------------------------------------------------- sharded renders


def test_sharded_reference_bitwise_equals_single(renders):
    """tests/test_sharding.py's gate: the scan march sharded over 8 devices
    is bitwise the single-device march."""
    shard, single, _ = renders("reference")
    assert shard.shape == (N, N, 4)
    np.testing.assert_array_equal(shard, single)
    assert (single[..., 3] > 0.1).mean() > 0.03


def test_sharded_reference_matches_jax(renders):
    """Against JAX's sharded scan march: ≥ 50 dB, the gate
    tests/test_torch_exact.py holds `march` to."""
    shard, _, jshard = renders("reference")
    assert psnr(shard, jshard) >= 50.0


@pytest.mark.parametrize("kernel,jax_db", [("fast", 50.0), ("fast2", 60.0)])
def test_sharded_fast_kernels(renders, kernel, jax_db):
    """The exact brick march ("fast") and the staged v2 march ("fast2", cone
    cache replicated) sharded: atol 1e-6 from the port's single march
    (tests/test_sharding.py's gates; bitwise measured), and against JAX's
    sharded render at the gates tests/test_torch_exact.py (50 dB) and
    tests/test_torch_march_v2.py (60 dB) hold the unsharded marches to."""
    shard, single, jshard = renders(kernel)
    np.testing.assert_allclose(shard, single, atol=1e-6, rtol=0)
    assert psnr(shard, jshard) >= jax_db
    assert np.abs(single).max() > 0.0


def _prepass(s, d, axis_name=None, jax_side=False):
    """tests/test_sharding.py's v3 prepass at 8 steps, 2 probes, stride 2,
    cell margin 0.1 → (prio [H, W], occ [H/2, W/2, 2])."""
    H, W = d.shape[0], d.shape[1]
    m = jmf if jax_side else tmf
    p, b = (s["jp"], s["jb"]) if jax_side else (s["tp"], s["tb"])
    flat = d.reshape(-1, 3)
    above, ndir, ss, p0, _, _ = m._ray_setup(flat, p, STEPS)
    prio, occ, _ = m._cull_prepass(above, ndir, ss, p0, p, b, STEPS, 2,
                                   min(16384, flat.shape[0]), (H, W), 2, 0.1,
                                   axis_name)
    return prio.reshape(H, W), occ.reshape(H // 2, W // 2, 2)


def test_sharded_v3_prepass_gate_bitwise(scene):
    """The v3 cell gate on 8 shards: the prepass dilations exchange one halo
    row (`_halo_rows`), so the sharded priority and cell occupancy are
    bitwise the unsharded ones (tests/test_sharding.py's gate), the
    occupancy bitwise JAX's sharded one, and the priority within PRIO_ATOL
    of JAX's (the same rays finite); the gate is not vacuous."""
    s = scene
    d = texel_directions(N, device=DEV)
    prio_s, occ_s = tsh.shard_map(
        lambda x: _prepass(s, x, "rays"), _mesh(), in_specs=(P("rays"),),
        out_specs=(P("rays"), P("rays")))(d)
    prio_1, occ_1 = _prepass(s, d)
    assert torch.equal(occ_s, occ_1) and torch.equal(prio_s, prio_1)
    assert bool(occ_1.any()) and not bool(occ_1.all())
    jprio, jocc = jax.shard_map(
        lambda x: _prepass(s, x, "rays", jax_side=True), mesh=jsh.make_mesh(),
        in_specs=(JP("rays"),), out_specs=(JP("rays"), JP("rays")))(
            jnp.asarray(d.numpy()))
    jprio, jocc = np.asarray(jprio), np.asarray(jocc)
    np.testing.assert_array_equal(occ_s.numpy(), jocc)
    fin = np.isfinite(jprio)
    np.testing.assert_array_equal(np.isfinite(prio_s.numpy()), fin)
    np.testing.assert_allclose(prio_s.numpy()[fin], jprio[fin], rtol=0,
                               atol=PRIO_ATOL)


def test_sharded_fast3_matches_single(renders):
    """The v3 march sharded over 8 devices against the single v3 march with
    the same knobs: tests/test_sharding.py's gates (atol 2e-2, > 60 dB,
    > 90% of texels equal, not vacuous); bitwise measured."""
    shard, single, _ = renders("fast3")
    np.testing.assert_allclose(shard, single, atol=2e-2, rtol=0)
    assert psnr(shard, single) > 60.0
    assert (shard == single).all(axis=-1).mean() > 0.9
    assert np.abs(single).max() > 0.0


def test_sharded_fast3_matches_jax(renders):
    """Against JAX's sharded v3 render: ≥ 60 dB."""
    shard, _, jshard = renders("fast3")
    assert psnr(shard, jshard) >= 60.0


def test_sharded_fast3_mesh_size_invariant(scene, renders):
    """2 shards ≡ 8 shards, bitwise, as tests/test_sharding.py asserts for
    JAX: the cell gate is bitwise on any mesh, and on the CPU the plain
    segmented scan and the other per-shard sums round alike whatever the
    shard's length (on the card: chip_smoke's mesh phase reports it)."""
    s = scene
    shard8 = renders("fast3")[0]
    shard2 = tsh.render_hemisphere_sharded(
        _mesh(2), N, s["tp"], _noise(s, "fast3", "t"), s["tsky"], steps=STEPS,
        light_steps=LIGHT, kernel="fast3").numpy()
    np.testing.assert_array_equal(shard2, shard8)


def test_sharded_fast3_sizes_per_shard_as_jax(scene):
    """The v3 march sizes its ray and cell capacities per shard, in JAX as
    in the port: with ray_keep 0.5 each shard keeps the top half of its
    own rays, not of the map's, so the sharded render leaves the single
    one (28.37 dB measured in both packages). The port's sharded-vs-single
    PSNR is within 0.1 dB of JAX's, and the two sharded renders ≥ 60 dB
    apart."""
    s = scene
    pol = (0.5, 0.25, 0.25)
    shard = tsh.render_hemisphere_sharded(
        _mesh(), N, s["tp"], _noise(s, "fast3", "t"), s["tsky"], steps=STEPS,
        light_steps=LIGHT, kernel="fast3", v3_policy=pol).numpy()
    single = tmf.march_bricks_v3(
        texel_directions(N, device=DEV), s["tp"], s["tb"], s["tsky"], steps=STEPS,
        light_steps=LIGHT, chunk=16384, cell_keep_frac=0.25, hot_keep_frac=0.25,
        cone_cache=s["tc"], ray_keep_frac=0.5, prepass_steps=2, ray_stride=2).numpy()
    jshard = np.asarray(jsh.render_hemisphere_sharded(
        jsh.make_mesh(), N, s["jp"], _noise(s, "fast3", "j"), s["jsky"],
        steps=STEPS, light_steps=LIGHT, kernel="fast3", v3_policy=pol))
    jsingle = np.asarray(jmf.march_bricks_v3(
        jnp.asarray(texel_directions(N, device=DEV).numpy()), s["jp"], s["jb"],
        s["jsky"], steps=STEPS, light_steps=LIGHT, chunk=16384,
        cell_keep_frac=0.25, hot_keep_frac=0.25, cone_cache=s["jc"],
        ray_keep_frac=0.5, prepass_steps=2, ray_stride=2))
    port_db, jax_db = psnr(shard, single), psnr(jshard, jsingle)
    assert jax_db < 60.0 and abs(port_db - jax_db) <= 0.1
    assert psnr(shard, jshard) >= 60.0


def test_full_frame_step_sharded(scene):
    """The sky LUT rendered once and replicated, the scan march sharded and
    the mean luminance `psum`'d: the mean equals the host reduction at rtol
    1e-6, the tile is bitwise the single march on that LUT, and the LUT
    meets JAX's at tests/test_torch_brick_atmo.py's 60 dB."""
    s = scene
    n = 32
    tt = torch.from_numpy(np.array(s["jt"]))
    sun = torch.tensor(SUN, dtype=torch.float32)
    tile, sky, mean = tsh.full_frame_step_sharded(
        s["tp"], s["tn"], tt, sun, texture_size=n, steps=STEPS,
        light_steps=LIGHT, mesh=_mesh())
    assert tile.shape == (n, n, 4) and sky.shape == (100, 200, 4)
    assert mean.dim() == 0 and bool(torch.isfinite(tile).all())
    np.testing.assert_allclose(float(mean), tile[..., :3].numpy().mean(), rtol=1e-6)
    single = march(texel_directions(n, device=DEV), s["tp"], s["tn"], sky,
                   steps=STEPS, light_steps=LIGHT)
    assert torch.equal(tile, single)
    assert psnr(sky.numpy(), np.asarray(jatmo.sky_lut(
        s["jt"], jnp.asarray(SUN, jnp.float32)))) >= 60.0
    assert torch.equal(sky, tatmo.sky_lut(tt, sun))


# ------------------------------------------------------------ the mesh engine


def _engines(s, kernel, perf, mesh, jax_too=True, **kw):
    """(port single, port mesh, JAX mesh or None) engines of one
    configuration (tests/test_sharding.py's scene)."""
    common = dict(config=CloudConfig(cloud_coverage=0.6),
                  sun=SunState(direction=tuple(SUN)), noise=s["tn"],
                  cone_res=RES, device="cpu", **kw)
    if kernel is not None:
        common["kernel"] = kernel
    a = CloudSkyEngine(perf=perf, **common)
    b = CloudSkyEngine(perf=perf, mesh=mesh, **common)
    j = None
    if jax_too:
        jkw = dict(kw, kernel=kernel) if kernel is not None else dict(kw)
        j = JEngine(perf=JPerf(perf.texture_size, perf.frames_to_update,
                               march_steps=perf.march_steps,
                               light_steps=perf.light_steps),
                    config=JCloud(cloud_coverage=0.6),
                    sun=JSun(direction=tuple(SUN)), noise=s["jn"], cone_res=RES,
                    mesh=jsh.make_mesh(), **jkw)
    return a, b, j


# (kernel, perf, ticks): tests/test_sharding.py's engine configurations.
ENGINE_CASES = {
    "default": (None, PerfConfig(32, 16, march_steps=4, light_steps=2), 3),
    "fast3": ("fast3", PerfConfig(32, 16, march_steps=4, light_steps=2), 3),
    "hier": ("hier", PerfConfig(32, 4, march_steps=8, light_steps=2), 1),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_mesh_engine_matches_single_and_jax(scene, case):
    """CloudSkyEngine(mesh=8 CPU shards) against the single-device engine:
    the default kernel and fast3 at atol 1e-6, hier at atol 2e-2 with
    > 90% of texels equal (tests/test_sharding.py's gates; bitwise
    measured); and against JAX's mesh engine at the 50 dB that
    tests/test_torch_engine.py holds the engines to. The default case
    ticks through `render_frame`, which takes `update_sky` + `render_view`
    on a mesh (no display-pair tables)."""
    kernel, perf, ticks = ENGINE_CASES[case]
    a, b, j = _engines(scene, kernel, perf, _mesh())
    assert b.can_run and b.kernel == (kernel or "fast3")
    eye = texel_directions(40, device=DEV)
    for k in range(ticks):
        if case == "default":
            fa = a.render_frame(eye, now=0.1 * k, fused=False)
            fb = b.render_frame(eye, now=0.1 * k)
            np.testing.assert_allclose(fb.numpy(), fa.numpy(), atol=1e-6, rtol=0)
        else:
            a.update_sky(now=0.1 * k)
            b.update_sky(now=0.1 * k)
        j.update_sky(now=0.1 * k)
    assert b._display_pair is None
    ar, br = a.cloud_ring.numpy(), b.cloud_ring.numpy()
    assert np.isfinite(br).all() and np.abs(ar).max() > 0.0
    if case == "hier":
        np.testing.assert_allclose(br, ar, atol=2e-2, rtol=0)
        assert (ar == br).mean() > 0.9
    else:
        np.testing.assert_allclose(br, ar, atol=1e-6, rtol=0)
    assert psnr(br, np.asarray(j.cloud_ring)) >= 50.0


@pytest.mark.parametrize("kernel", ["fast2", "fast", "reference"])
def test_mesh_engine_other_kernels_match_single(scene, kernel):
    """The other kernel modes on a 4-shard mesh step as their single-device
    engines, atol 1e-6 (bitwise measured): fast2's v2 tiles, fast's exact
    march and reference's scan march, each on its shard's rows."""
    perf = PerfConfig(32, 4, march_steps=4, light_steps=2)
    a, b, _ = _engines(scene, kernel, perf, _mesh(4), jax_too=False)
    for k in range(3):
        a.update_sky(now=0.1 * k)
        b.update_sky(now=0.1 * k)
    ar, br = a.cloud_ring.numpy(), b.cloud_ring.numpy()
    assert np.abs(ar).max() > 0.0
    np.testing.assert_allclose(br, ar, atol=1e-6, rtol=0)


# Gates of the culled mesh engine against the single culled engine and the
# unculled one. fast2: tests/test_sharding.py's 40 dB for both. fast3's
# bucketed tiles take the v3 march, whose capacities are sized per shard
# (v3_capacities of a shard's 2 rows × 16 rays), as JAX's are
# (test_sharded_fast3_sizes_per_shard_as_jax), so a shard overflows where
# the whole tile does not: the port's mesh engine measured 39.19 dB from
# its single culled engine here (ROADMAP §C); against the unculled engine
# fast3's tiles at 16 steps have 4 coarse probes a ray and meet 30 dB
# (tests/test_torch_serving.py's UNCULLED_DB, which the JAX engine misses
# 40 dB at as well).
SHARDED_DB = {"fast2": 40.0, "fast3": 38.0}
UNCULLED_DB = {"fast2": 40.0, "fast3": 30.0}


@pytest.mark.parametrize("kernel", ["fast2", "fast3"])
def test_mesh_engine_composes_with_tile_cull(scene, kernel):
    """tile_cull with a mesh (tests/test_sharding.py's configuration: 64²,
    16 frames, 16 steps, coverage 0.45, 18 ticks): the buckets equal the
    single engine's, at least one tile is truly culled, and the sharded
    culled ring is SHARDED_DB from the single culled ring and UNCULLED_DB
    from the unculled one. fast3's bucketed tiles take the v3 march with
    its prepass halo over the 8 shards."""
    s = scene
    common = dict(perf=PerfConfig(64, 16, march_steps=16, light_steps=2),
                  config=CloudConfig(cloud_coverage=0.45),
                  sun=SunState(direction=tuple(SUN)), noise=s["tn"],
                  cone_res=RES, device="cpu", kernel=kernel)
    plain = CloudSkyEngine(**common)
    culled = CloudSkyEngine(**common, tile_cull=True)
    mesh_culled = CloudSkyEngine(**common, tile_cull=True, mesh=_mesh())
    assert mesh_culled.tile_cull
    for _ in range(18):
        for e in (plain, culled, mesh_culled):
            e.update_sky(now=0.0)
    assert mesh_culled._tile_buckets == culled._tile_buckets
    assert any(0.0 < x < 1.0 for x in mesh_culled._tile_buckets), \
        "no tile culled: the test is vacuous"
    rp, rc, rm = (e.cloud_ring[e.ring.texture_to_blend_to].numpy()
                  for e in (plain, culled, mesh_culled))
    assert np.isfinite(rm).all()
    peak = max(float(np.abs(rp).max()), 1e-9)
    assert psnr(rm, rc, peak=peak) >= SHARDED_DB[kernel]
    assert psnr(rm, rp, peak=peak) >= UNCULLED_DB[kernel]


def test_indivisible_rows_raise(scene):
    """A row count that does not split over the mesh raises ValueError: the
    sharded render (60 rows on 8 shards), the engine's constructor and
    `set_performance` (an 8-row tile on 3 shards, a 10-row one on 4)."""
    s = scene
    with pytest.raises(ValueError):
        tsh.render_hemisphere_sharded(_mesh(), 60, s["tp"], s["tn"], s["tsky"])
    with pytest.raises(ValueError):
        tsh.shard_map(lambda x: x, _mesh(), (P("rays"),), P("rays"))(
            torch.zeros(12, 3))
    perf = PerfConfig(32, 16, march_steps=4, light_steps=2)  # 8² tiles
    with pytest.raises(ValueError):
        CloudSkyEngine(perf=perf, noise=s["tn"], cone_res=RES, device="cpu",
                       mesh=_mesh(3))
    eng = CloudSkyEngine(perf=perf, noise=s["tn"], cone_res=RES, device="cpu",
                         mesh=_mesh(4))
    with pytest.raises(ValueError):
        eng.set_performance(PerfConfig(40, 16, march_steps=4, light_steps=2))
    assert eng.perf == perf


def test_failed_shard_fails_the_call_promptly():
    """A shard that raises aborts the exchange: the shards waiting at a
    collective stop, and the call re-raises the failing shard's own
    exception within seconds (the exchange's timeout is a minute)."""
    def fn(x):
        if tsh.axis_index("rays") == 5:
            raise KeyError("shard 5 failed")
        return tsh.psum(x, "rays")

    t0 = time.perf_counter()
    with pytest.raises(KeyError, match="shard 5 failed"):
        tsh.shard_map(fn, _mesh(), (P("rays"),), P(), timeout=60.0)(
            torch.ones(8, 2))
    assert time.perf_counter() - t0 < 5.0
    assert not [t for t in threading.enumerate() if t.name.startswith("shard-")]


def test_collective_timeout_fails_the_call():
    """A shard that never reaches the collective: the others wait out the
    timeout and the call raises TimeoutError."""
    def fn(x):
        if tsh.axis_index("rays") == 0:
            return x
        return tsh.psum(x, "rays")

    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        tsh.shard_map(fn, _mesh(4), (P("rays"),), P("rays"), timeout=0.5)(
            torch.ones(4, 2))
    assert time.perf_counter() - t0 < 10.0


# ----------------------------------------------------------- launch counts


@pytest.mark.parametrize("module", [accum, compact, segscan, noise_kernel,
                                    composite_kernel])
def test_launch_counts_are_exact_from_threads(module):
    """Each wrapper's launch count (and K1–K3's launches by size) takes
    every increment from 8 threads (a bare `launches += 1` can lose some
    once shards launch from threads): 8 threads × 5,000 increments with a
    short switch interval."""
    threads, reps = 8, 5000
    key = {noise_kernel: "base", composite_kernel: "composite"}.get(module)
    # K1–K3 count each launch's element count; this one no launch has.
    size = 7
    before = module.launches[key] if key else module.launches
    sized = 0 if key else module.sizes[size]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(reps):
                if key:
                    module._count_launch(key)
                else:
                    module._count_launch(size)

        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(interval)
    after = module.launches[key] if key else module.launches
    assert after - before == threads * reps
    if not key:
        assert module.sizes[size] - sized == threads * reps
