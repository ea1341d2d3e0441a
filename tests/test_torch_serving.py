"""The port's serving tick ≡ the JAX package, on the CPU: the display-pair
fused `render_frame` and per-tile culling (`tile_cull`) for fast3 and fast2.

Each test gives the JAX function and its port the same inputs, made from
seeds with numpy, and states its tolerance. The engines run at
PerfConfig(32, 16, march_steps=16, light_steps=2) with a (8, 64, 64) cone
cache on the tiny noise pack of tests/test_torch_engine.py. The JAX
engine's compile warmers (`_warm_tile_cull_variants`,
`_warm_fused_variants`) are switched off in its culled runs: they compile
every bucket's executable on a scratch ring and change nothing the engine
computes, and the port has no counterpart.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudscape_tpu import engine as jengine
from cloudscape_tpu.config import CloudConfig as JCloud, PerfConfig as JPerf
from cloudscape_tpu.config import SunState as JSun
from cloudscape_tpu.engine import CloudSkyEngine as JEngine
from cloudscape_tpu.models import compositor as jcomp
from cloudscape_tpu.models import march_fast as jmf
from cloudscape_tpu.models.density import MarchParams as JParams
from cloudscape_tpu.models.packs import make_noise_pack
from cloudscape_tpu.ops import brick as jbrick
from cloudscape_tpu.ops.noise import (generate_base_noise, generate_detail_noise,
                                      generate_weather)
from cloudscape_tpu.ops.octmap import texel_directions as jdirs
from cloudscape_tpu.utils.image import psnr
from cloudscape_tpu_torch import CloudConfig, PerfConfig, SunState
from cloudscape_tpu_torch import engine as tengine
from cloudscape_tpu_torch.engine import CloudSkyEngine
from cloudscape_tpu_torch.models import compositor as tcomp
from cloudscape_tpu_torch.models import march_fast as tmf
from cloudscape_tpu_torch.models.density import MarchParams
from cloudscape_tpu_torch.models.packs import noise_pack_from_numpy
from cloudscape_tpu_torch.ops import brick as tbrick
from cloudscape_tpu_torch.ops.octmap import texel_directions

# Several test workers share the host's cores.
torch.set_num_threads(min(2, torch.get_num_threads()))
DEV = torch.device("cpu")
RES = (8, 64, 64)
SUN = (0.3, 0.5, -0.8)
# The port's cull priorities differ from JAX's by float reassociation in the
# prepass's samplers (ROADMAP §C: up to 5.8e-4 on a few rays).
PRIO_ATOL = 1e-3
# Engine ticks of the culled runs: 20 after the warm start, so the cycle
# boundary at tick 16 picks up the prebaked cull map.
TICKS = 20


@pytest.fixture(scope="module")
def packs():
    jn = make_noise_pack(generate_base_noise(16, seed=1),
                         generate_detail_noise(16, seed=2),
                         generate_weather(64, seed=3))
    tn = noise_pack_from_numpy([np.asarray(a) for a in jn.large],
                               [np.asarray(a) for a in jn.small],
                               np.asarray(jn.weather), device=DEV)
    return jn, tn


def _params():
    sun = np.array([0.3, 0.4, -0.85])
    jp = JParams.create(
        cloud_pos=np.array([1.5, -0.3]), detailed_pos=np.array([0.4, 0.2]),
        weather_pos=np.array([0.01, 0.02]), time=12.5, cloud_coverage=0.6,
        light_direction=sun / np.linalg.norm(sun),
        ground_color=np.array([0.27, 0.19, 0.027]))
    fields = {k: np.asarray(v) for k, v in vars(jp).items()}
    return jp, MarchParams.from_numpy(fields, device=DEV)


def _port_engine(tn, kernel, tile_cull=False):
    return CloudSkyEngine(perf=PerfConfig(32, 16, march_steps=16, light_steps=2),
                          config=CloudConfig(cloud_coverage=0.6),
                          sun=SunState(direction=SUN), noise=tn, cone_res=RES,
                          device="cpu", kernel=kernel, tile_cull=tile_cull)


def _jax_engine(jn, kernel, tile_cull=False):
    return JEngine(perf=JPerf(32, 16, march_steps=16, light_steps=2),
                   config=JCloud(cloud_coverage=0.6), sun=JSun(direction=SUN),
                   noise=jn, cone_res=RES, kernel=kernel, tile_cull=tile_cull)


def _view_dirs():
    d = np.array(jdirs(40))
    d[..., 1] -= 0.3  # include below-horizon views
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def warm_engine(packs):
    """A deep copy of the port engine of (kernel, tile_cull) after its warm
    start and tick 0 (`update_sky(now=0.0)`); each engine is built once a
    module, on first use, since its sky LUT and cone bakes dominate."""
    _, tn = packs
    built = {}

    def get(kernel, tile_cull):
        if (kernel, tile_cull) not in built:
            e = _port_engine(tn, kernel, tile_cull)
            e.update_sky(now=0.0)
            built[kernel, tile_cull] = e
        return copy.deepcopy(built[kernel, tile_cull])

    return get


@pytest.fixture
def no_jax_warmers(monkeypatch):
    monkeypatch.setattr(JEngine, "_warm_tile_cull_variants", lambda self: None)
    monkeypatch.setattr(JEngine, "_warm_fused_variants", lambda self, *a: None)


# ------------------------------------------------------------ pair tables

def test_display_pair_tables_match_jax():
    """`_build_display_pair` (8-channel clamp textures of the blend pair)
    against JAX's (`build_brick2_device` at (4, 4) / (3, 3), clamp) on the
    same rings: each texture packed into JAX's layout is JAX's table
    bitwise, and it is a copy that later in-place ring writes do not
    reach."""
    rng = np.random.default_rng(11)
    cloud = rng.uniform(0, 1, (3, 20, 20, 4)).astype(np.float32)
    sky = rng.uniform(0, 20, (3, 10, 16, 4)).astype(np.float32)
    jc, js = jengine._build_display_pair(jnp.asarray(cloud), jnp.int32(1),
                                         jnp.int32(2), jnp.asarray(sky),
                                         jnp.int32(0), jnp.int32(1))
    ring_t = torch.from_numpy(cloud.copy())
    tc, ts = tengine._build_display_pair(ring_t, 1, 2, torch.from_numpy(sky), 0, 1)
    for j, tex in ((jc, tc), (js, ts)):
        assert (tex.dims, tex.channels, tex.wrap) == (j.dims, j.channels, j.wrap)
        t = tbrick.build_brick2(tex.texels, (4, 4), (3, 3), wrap="clamp")
        assert (t.dims, t.brick, t.stride, t.grid, t.channels, t.wrap) == \
            (j.dims, j.brick, j.stride, j.grid, j.channels, j.wrap)
        np.testing.assert_array_equal(t.table.numpy(), np.asarray(j.table))
    before = tc.texels.clone()
    ring_t[1:] = -1.0  # the engine writes tiles into the ring in place
    assert torch.equal(tc.texels, before)


@pytest.mark.parametrize("channels,brick,stride", [(8, (4, 4), (3, 3)),
                                                   (4, (4, 8), (3, 7))])
def test_sample_brick2_clamp_matches_jax(channels, brick, stride):
    """`sample_brick2` on clamp-wrapped tables, uv beyond [0, 1] included,
    against JAX's at atol 1e-6, and against the raw image's clamp fetch."""
    rng = np.random.default_rng(12)
    img = rng.uniform(0, 1, (19, 37, channels)).astype(np.float32)
    uv = rng.uniform(-0.2, 1.2, (7, 9, 2)).astype(np.float32)
    jt = jbrick.build_brick2_device(jnp.asarray(img), brick, stride, wrap="clamp")
    tt = tbrick.build_brick2_device(torch.from_numpy(img), brick, stride,
                                    wrap="clamp")
    np.testing.assert_array_equal(tt.table.numpy(), np.asarray(jt.table))
    got = tbrick.sample_brick2(tt, torch.from_numpy(uv)).numpy()
    want = np.asarray(jbrick.sample_brick2(jt, jnp.asarray(uv)))
    assert got.shape == (7, 9, channels)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    raw = tcomp._fetch_clamp(torch.from_numpy(img), torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(got, raw, atol=1e-6, rtol=0)


# -------------------------------------------------------------- composite

@pytest.fixture(scope="module")
def textures():
    rng = np.random.default_rng(13)
    cloud = rng.uniform(0, 1, (2, 24, 24, 4)).astype(np.float32)
    sky = rng.uniform(0, 20, (2, 100, 200, 4)).astype(np.float32)
    tlut = rng.uniform(0.2, 1, (64, 256, 4)).astype(np.float32)
    d = rng.normal(size=(16, 40, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    sun = np.array([0.4, 0.35, -0.85])
    return cloud, sky, tlut, d, (sun / np.linalg.norm(sun)).astype(np.float32)


@pytest.mark.parametrize("form", ["pair", "preblended", "texture"])
@pytest.mark.parametrize("deband", [False, True])
def test_composite_display_matches(textures, form, deband):
    """`composite_display` over 8-channel pair tables and 4-channel
    pre-blended tables (the transmittance LUT as a table too), and over the
    engine's form (8-channel pair textures, the LUT a raw image; JAX's
    engine packs the same pairs into (4, 4) brick tables), against JAX's
    `composite_display` and the port's split `composite`: atol 2e-5 /
    rtol 1e-5."""
    cloud, sky, tlut, d, sun = textures
    blend = 0.40625
    if form == "preblended":
        cloud_img = cloud[0] + (cloud[1] - cloud[0]) * blend
        sky_img = sky[0] + (sky[1] - sky[0]) * blend
        brick, stride = (4, 8), (3, 7)
    else:
        cloud_img = np.concatenate([cloud[0], cloud[1]], axis=-1)
        sky_img = np.concatenate([sky[0], sky[1]], axis=-1)
        brick, stride = (4, 4), (3, 3)
    tables = []
    for build, conv in ((jbrick.build_brick2_device, jnp.asarray),
                        (tbrick.build_brick2_device, torch.from_numpy)):
        tables.append([build(conv(np.ascontiguousarray(x)), brick, stride,
                             wrap="clamp") for x in (cloud_img, sky_img, tlut)])
    if form == "texture":
        tables[0][2] = jnp.asarray(tlut)
        tables[1] = [tbrick.build_texture2(torch.from_numpy(x), wrap="clamp")
                     for x in (cloud_img, sky_img)] + [torch.from_numpy(tlut)]
    want = np.asarray(jax.jit(jcomp.composite_display, static_argnames="deband")(
        jnp.asarray(d), *tables[0], jnp.asarray(sun), jnp.float32(2.0),
        jnp.float32(blend), deband=deband))
    got = tcomp.composite_display(torch.from_numpy(d), *tables[1],
                                  torch.from_numpy(sun), 2.0, blend,
                                  deband=deband).numpy()
    split = tcomp.composite(
        torch.from_numpy(d), torch.from_numpy(cloud[0]), torch.from_numpy(cloud[1]),
        torch.from_numpy(sky[0]), torch.from_numpy(sky[1]), torch.from_numpy(tlut),
        blend, torch.from_numpy(sun), 2.0, deband=deband).numpy()
    assert got.shape == (16, 40, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got, split, atol=2e-5, rtol=1e-5)


# ------------------------------------------------------------- fused tick

@pytest.mark.parametrize("kernel,tile_cull", [("fast3", False), ("fast3", True),
                                              ("fast2", True)])
def test_fused_matches_split(warm_engine, kernel, tile_cull):
    """The fused `render_frame` (the default when amortized) against
    `update_sky` + `render_view` on the port: frames at atol 2e-5 /
    rtol 1e-5 and the rings bitwise, tick after tick across a cycle
    boundary (which drops and rebuilds the pair tables): the split engine
    is a copy of the fused one taken after the warm start and 12 more
    `update_sky` ticks, then both serve ticks 13-17."""
    d = torch.from_numpy(_view_dirs())
    fused = warm_engine(kernel, tile_cull)
    for i in range(1, 13):
        fused.update_sky(now=i / 60.0)
    split = copy.deepcopy(fused)
    for i in range(13, 18):  # tick 16 rotates the rings
        f = fused.render_frame(d, now=i / 60.0)
        split.update_sky(now=i / 60.0)
        g = split.render_view(d)
        np.testing.assert_allclose(f.numpy(), g.numpy(), atol=2e-5, rtol=1e-5,
                                   err_msg=f"frame {i}")
        assert torch.equal(fused.cloud_ring, split.cloud_ring), f"ring {i}"
    assert fused._display_pair is not None and split._display_pair is None
    assert float(g.mean()) > 1e-3


# --------------------------------------------------------------- cull map

@pytest.mark.parametrize("cell_margin", [None, 0.1])
def test_cull_priority_map_matches_jax(packs, cell_margin):
    """`cull_priority_map` over a 32² texel grid (16 steps, 4 probes,
    stride 2, 8² tiles), fast2's form (no cell margin) and fast3's: the
    same −inf set, finite priorities at PRIO_ATOL, and the per-tile keep
    and live-cell fractions equal."""
    jn, tn = packs
    jp, tp = _params()
    jb, tb = jmf.BrickPack.from_noise(jn), tmf.BrickPack.from_noise(tn)
    kw = dict(steps=16, prepass_steps=4, ray_stride=2, region=8,
              cell_margin=cell_margin)
    want = jmf.cull_priority_map(jdirs(32), jp, jb, **kw)
    got = tmf.cull_priority_map(texel_directions(32, device=DEV), tp, tb, **kw)
    assert len(got) == len(want) == (2 if cell_margin is None else 3)
    pj, pt = np.asarray(want[0]), got[0].numpy()
    fin = np.isfinite(pj)
    np.testing.assert_array_equal(np.isfinite(pt), fin)
    assert 0.2 < fin.mean() < 1.0
    np.testing.assert_allclose(pt[fin], pj[fin], atol=PRIO_ATOL, rtol=0)
    for j, t in zip(want[1:], got[1:]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    tile_keep = got[1].numpy()
    assert (tile_keep == 0).any() and (tile_keep > 0).any()


def test_sliced_cull_matches_one_shot(packs):
    """The engine's sliced prepass (`cull_raw_slice` in 100-ray slices, the
    last one clamped to overlap its predecessor, then `cull_finalize`)
    against the port's one-shot `cull_priority_map(cell_margin=0.1)`
    (prio at 1e-6, fractions equal), its raw buffer against JAX's
    `cull_raw_slice` at PRIO_ATOL, and `cull_finalize` against JAX's on
    the same raw buffer, bitwise."""
    jn, tn = packs
    jp, tp = _params()
    jb, tb = jmf.BrickPack.from_noise(jn), tmf.BrickPack.from_noise(tn)
    dirs = texel_directions(32, device=DEV)
    sub = dirs[::2, ::2].reshape(-1, 3)
    n_sub, count = sub.shape[0], 100
    raw = torch.zeros((n_sub, 4))
    for k in range(-(-n_sub // count)):
        tmf.cull_raw_slice(raw, sub, min(k * count, n_sub - count), tp, tb,
                           count=count, steps=16, prepass_steps=4)
    jraw = jmf.cull_raw_slice(jnp.zeros((n_sub, 4)), jnp.asarray(sub.numpy()), 0,
                              jp, jb, count=n_sub, steps=16, prepass_steps=4)
    np.testing.assert_allclose(raw.numpy(), np.asarray(jraw), atol=PRIO_ATOL, rtol=0)
    got = tmf.cull_finalize(raw, dirs, 8, 2)
    one = tmf.cull_priority_map(dirs, tp, tb, steps=16, prepass_steps=4,
                                ray_stride=2, region=8, cell_margin=0.1)
    np.testing.assert_array_equal(np.isfinite(got[0].numpy()),
                                  np.isfinite(one[0].numpy()))
    fin = np.isfinite(one[0].numpy())
    np.testing.assert_allclose(got[0].numpy()[fin], one[0].numpy()[fin],
                               atol=1e-6, rtol=0)
    for a, b in zip(got[1:], one[1:]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    want = jmf.cull_finalize(jnp.asarray(raw.numpy()), jnp.asarray(dirs.numpy()),
                             8, 2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------------ tile cull

@pytest.fixture(scope="module", params=["fast3", "fast2"])
def culled_runs(request, packs, warm_engine):
    """A JAX and a port engine with tile_cull=True (the JAX warmers off):
    the warm start and tick 0 (the JAX engine's first `render_frame`, a
    copy of the port's warm engine, whose ring the fused tick would write
    bitwise alike), then TICKS - 1 fused `render_frame` ticks with the same
    `now` values. Records both engines' buckets at every tick, whether the
    boundary picked up the prebaked buckets, and the last frames."""
    jn, _ = packs
    mp = pytest.MonkeyPatch()
    mp.setattr(JEngine, "_warm_tile_cull_variants", lambda self: None)
    mp.setattr(JEngine, "_warm_fused_variants", lambda self, *a: None)
    je = _jax_engine(jn, request.param, tile_cull=True)
    te = warm_engine(request.param, True)
    d = _view_dirs()
    je.render_frame(jnp.asarray(d), now=0.0)
    buckets, pickups = [(list(je._tile_buckets), list(te._tile_buckets))], []
    for i in range(1, TICKS):
        pend = te._pending
        boundary = te.ring.frame >= te.perf.frames_to_update
        fj = np.asarray(je.render_frame(jnp.asarray(d), now=i / 30.0))
        ft = te.render_frame(torch.from_numpy(d), now=i / 30.0).numpy()
        buckets.append((list(je._tile_buckets), list(te._tile_buckets)))
        if boundary:
            pickups.append(pend is not None and pend.buckets is not None
                           and te._tile_buckets is pend.buckets)
    mp.undo()
    return dict(kernel=request.param, je=je, te=te, buckets=buckets,
                pickups=pickups, frames=(fj, ft))


def test_tile_cull_engines_match_jax(culled_runs):
    """tile_cull=True for fast3 and fast2 through `render_frame` against
    the JAX engine: equal bucket lists at every tick, the boundary takes the
    prebaked buckets, some tiles are culled or skipped, and ring and frame
    ≥ 50 dB."""
    r = culled_runs
    for i, (bj, bt) in enumerate(r["buckets"]):
        assert bj == bt, f"tick {i}"
    assert r["pickups"] == [True]
    last = r["buckets"][-1][1]
    assert 0.0 in last and any(0.0 < b < 1.0 for b in last)
    ring_j, ring_t = np.asarray(r["je"].cloud_ring), r["te"].cloud_ring.numpy()
    assert (ring_j[..., 3] > 0.1).mean() > 0.02
    assert psnr(ring_t, ring_j) >= 50.0
    fj, ft = r["frames"]
    assert np.isfinite(ft).all() and ft.min() >= 0.0
    assert psnr(ft, fj) >= 50.0


# fast3's gate: its culled tiles take the v3 cell-gated march, whose cell
# gate at this size has 4 coarse probes a ray; the JAX engine misses 40 dB
# on this configuration as well (ROADMAP §C), so fast3 is held at 30 dB.
UNCULLED_DB = {"fast2": 40.0, "fast3": 30.0}


@pytest.mark.parametrize("kernel", ["fast2", "fast3"])
def test_tile_cull_matches_unculled(packs, kernel):
    """A culled port engine against the unculled march over a full cycle at
    the configuration of tests/test_engine.py::test_tile_cull_matches_unculled
    (64² map, 16 frames, 16 steps, coverage 0.45, `update_sky(now=0.0)`):
    after 16 ticks the cycle's 16 tiles are written and not yet rotated,
    and each is marched again by `_march_tile` without a bucket on the
    cycle's params, cone cache and sky slot, which is what the unculled
    engine writes for that cycle. PSNR (peak of the unculled map): fast2
    ≥ 40 dB, that test's gate; fast3 ≥ UNCULLED_DB. Some tiles are
    culled."""
    _, tn = packs
    b = CloudSkyEngine(perf=PerfConfig(64, 16, march_steps=16, light_steps=2),
                       config=CloudConfig(cloud_coverage=0.45),
                       sun=SunState(direction=SUN), noise=tn, cone_res=RES,
                       device="cpu", kernel=kernel, tile_cull=True)
    for _ in range(16):
        b.update_sky(now=0.0)
    assert b.ring.frame == b.perf.frames_to_update
    assert any(x < 1.0 for x in b._tile_buckets), "no tile culled"
    region, n = b.perf.update_region_size, b.perf.texture_size
    ra = torch.zeros((n, n, 4))
    for y0 in range(0, n, region):
        for x0 in range(0, n, region):
            ra[y0:y0 + region, x0:x0 + region] = tengine._march_tile(
                tengine.tile_arm(kernel, None, region * region),
                texel_directions(n, x0=x0, y0=y0, width=region, height=region,
                                 device=DEV),
                b._march_params, b._noise_arg,
                b.sky_ring[b.ring.cloud_kernel_sky_slot], region=region,
                steps=16, light_steps=2, kernel=kernel)
    ra = ra.numpy()
    rb = b.cloud_ring[b.ring.texture_to_update].numpy()
    assert np.isfinite(rb).all()
    mse = float(((ra - rb) ** 2).mean())
    peak = max(float(np.abs(ra).max()), 1e-9)
    db = 10.0 * np.log10(peak * peak / max(mse, 1e-20))
    assert db >= UNCULLED_DB[kernel], f"{kernel} culled vs unculled {db:.1f} dB"


@pytest.mark.parametrize("kernel", ["fast3", "fast2"])
def test_skip_bucket_writes_zeros(warm_engine, kernel):
    """Every bucket forced to 0.0: `update_sky` and the fused `render_frame`
    write their tile as exact zeros, over a tile that held ones."""
    te = warm_engine(kernel, True)  # after the warm start: cursor at tile 1
    te._tile_buckets = [0.0] * len(te._tile_buckets)
    d = torch.from_numpy(_view_dirs())
    for tick in (lambda: te.update_sky(now=0.0),
                 lambda: te.render_frame(d, now=0.0)):
        tex = te.ring.texture_to_update
        x0, y0 = te.ring.update_position
        te.cloud_ring[tex, y0:y0 + 8, x0:x0 + 8] = 1.0
        out = tick()
        assert out is None or bool(torch.isfinite(out).all())
        tile = te.cloud_ring[tex, y0:y0 + 8, x0:x0 + 8]
        assert torch.equal(tile, torch.zeros_like(tile))


def test_restore_jax_save_into_culled_engine(packs, no_jax_warmers):
    """A JAX fast3 save() after 5 culled ticks, restored into a fresh port
    tile_cull engine and a fresh JAX one: as in the JAX engine, the restore
    keeps the construction's cull map until the first rotation, which
    rebuilds it synchronously (the prebake restarts). Both then serve
    through the boundary with equal buckets and rings ≥ 50 dB."""
    jn, tn = packs
    d = _view_dirs()
    src = _jax_engine(jn, "fast3", tile_cull=True)
    for i in range(5):
        src.render_frame(jnp.asarray(d), now=i / 30.0)
    state = src.save()
    je, te = _jax_engine(jn, "fast3", tile_cull=True), \
        _port_engine(tn, "fast3", tile_cull=True)
    je.restore(state)
    te.restore(state)
    assert te._pending is None and te._display_pair is None
    assert te._tile_buckets == je._tile_buckets is not None
    syncs = []
    refresh = te._refresh_tile_cull
    te._refresh_tile_cull = lambda: (syncs.append(te.ring.frame), refresh())
    for i in range(5, TICKS):
        boundary = te.ring.frame >= te.perf.frames_to_update
        fj = np.asarray(je.render_frame(jnp.asarray(d), now=i / 30.0))
        ft = te.render_frame(torch.from_numpy(d), now=i / 30.0).numpy()
        assert te._tile_buckets == je._tile_buckets, f"tick {i}"
        if boundary:
            assert te._pending is not None and te._pending.buckets is None
    assert len(syncs) == 1  # the boundary's synchronous rebuild
    assert psnr(te.cloud_ring.numpy(), np.asarray(je.cloud_ring)) >= 50.0
    assert np.isfinite(ft).all() and psnr(ft, fj) >= 50.0
