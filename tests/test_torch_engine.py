"""The PyTorch port's serving slice ≡ the JAX package, on the CPU.

Both packages get the same tiny noise pack — made by the JAX generators
(base 16, detail 16, weather 64, as `__graft_entry__._tiny_inputs`) and
handed to the port unchanged through `noise_pack_from_numpy` — and run the
default "fast3" engine at PerfConfig(32, 16, march_steps=16, light_steps=2)
with a (8, 64, 64) cone cache and the prebake on. Measured on the CPU:
cloud ring ~104 dB and the composite ~102 dB after warm start + 20 ticks
(the gate is 50 dB); the cone cache table ~108 dB (gate 80) and a tile
~134 dB (gate 50). The "fast2" engine (the staged v2 march for every
tile): ring ~104 dB, view ~102 dB, `render_full_hemisphere` ~104 dB; the
fast3 v2 tile arm (a 40² map, threshold lowered to its 10² tiles): ring
~97 dB, view ~102 dB (gates 50 dB). The unstaged engines at PerfConfig(32,
4) after the warm start and 6 ticks: "fast" (the exact brick march) ring
119.28 dB, view 106.60 dB, `render_full_hemisphere` 119.45 dB; "reference"
(the scan march) ring 71.94 dB, view 94.65 dB, `render_full_hemisphere`
72.77 dB (gates 50 dB). The JAX side runs its XLA forms (a CPU backend),
so the port's kernel wrappers meet the JAX package's own CPU numerics
here.
"""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cloudscape_tpu.config import CloudConfig as JCloud, PerfConfig as JPerf
from cloudscape_tpu.config import SunState as JSun
from cloudscape_tpu import engine as jengine
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
from cloudscape_tpu_torch import engine as tengine
from cloudscape_tpu_torch.engine import CloudSkyEngine
from cloudscape_tpu_torch.models import march_fast as tmf
from cloudscape_tpu_torch.models.density import MarchParams
from cloudscape_tpu_torch.models.packs import noise_pack_from_numpy
from cloudscape_tpu_torch.ops import brick as tbrick

# Several test workers share the host's cores: keep torch's intra-op
# thread pool small so they do not oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))
# The port's entry points default to the card: these tests ask for the CPU.
DEV = torch.device("cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = (8, 64, 64)


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
    """The same march parameters for both packages, the port's through
    `MarchParams.from_numpy` of the JAX fields."""
    sun = np.array([0.3, 0.4, -0.85])
    jp = JParams.create(
        cloud_pos=np.array([1.5, -0.3]), detailed_pos=np.array([0.4, 0.2]),
        weather_pos=np.array([0.01, 0.02]), time=12.5, cloud_coverage=0.6,
        light_direction=sun / np.linalg.norm(sun),
        ground_color=np.array([0.27, 0.19, 0.027]))
    fields = {k: np.asarray(v) for k, v in vars(jp).items()}
    return jp, MarchParams.from_numpy(fields, device=DEV)


SUN = (0.3, 0.5, -0.8)


def _port_engine(tn, kernel="fast3", size=32, frames=16, **kw):
    return CloudSkyEngine(perf=PerfConfig(size, frames, march_steps=16, light_steps=2),
                          config=CloudConfig(cloud_coverage=0.6),
                          sun=SunState(direction=SUN), noise=tn, cone_res=RES,
                          device="cpu", kernel=kernel, **kw)


def _engines(packs, kernel="fast3", size=32, frames=16, **kw):
    jn, tn = packs
    je = JEngine(perf=JPerf(size, frames, march_steps=16, light_steps=2),
                 config=JCloud(cloud_coverage=0.6), sun=JSun(direction=SUN),
                 noise=jn, cone_res=RES, kernel=kernel, **kw)
    return je, _port_engine(tn, kernel, size, frames, **kw)


def _view_dirs():
    d = np.array(jdirs(40))
    d[..., 1] -= 0.3  # include below-horizon views
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_package_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "sys.modules['jax'] = None  # any `import jax` now fails\n"
        "import cloudscape_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from cloudscape_tpu_torch import CloudSkyEngine\n"
        "new = set(sys.modules) - before\n"
        "bad = [m for m in new if sys.modules[m] is not None and\n"
        "       m.split('.')[0] in ('jax', 'jaxlib', 'cloudscape_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_cone_cache_and_tile_match_jax(packs):
    """build_cone_cache (occupancy through K2's plain version) and the dense
    tile march (phase 3 through K1's plain version) against the JAX forms."""
    jn, tn = packs
    jp, tp = _params()
    jb, tb = jmf.BrickPack.from_noise(jn), tmf.BrickPack.from_noise(tn)
    jc = jmf.build_cone_cache(jp, jb, 2, res=RES, chunk=4096)
    tc = tmf.build_cone_cache(tp, tb, 2, res=RES, chunk=4096)
    # The port's texture packed into JAX's layout (CONE_BRICK at CONE_STRIDE).
    ta = tbrick.build_brick3(tc.table.texels, tmf.CONE_BRICK, tmf.CONE_STRIDE,
                             wrap="clamp").table.numpy()
    ja = np.asarray(jc.table.table)
    assert ta.shape == ja.shape and (ja > 0).any()
    assert psnr(ta, ja) >= 80.0
    sky = jatmo.sky_lut(jatmo.transmittance_lut(), jnp.asarray(jp.light_direction))
    d = _view_dirs()[:24, :24]
    want = np.asarray(jmf.march_tile_dense(jnp.asarray(d), jp, jb, sky, steps=16,
                                           light_steps=2, chunk=256, cone_cache=jc))
    got = tmf.march_tile_dense(torch.from_numpy(d), tp, tb,
                               torch.from_numpy(np.array(sky)), steps=16,
                               light_steps=2, chunk=256, cone_cache=tc).numpy()
    assert got.shape == want.shape == (24, 24, 4)
    assert (want[..., 3] > 0.1).mean() > 0.05
    assert psnr(got, want) >= 50.0
    np.testing.assert_array_equal(got[d[..., 1] <= 0.0], 0.0)


def test_sliced_bake_matches_sync_build(packs):
    """The engine's sliced cone bake (occupancy slices → K2 finalize →
    cone-march slices → texture rows) reproduces build_cone_cache."""
    _, tn = packs
    _, tp = _params()
    tb = tmf.BrickPack.from_noise(tn)
    n = int(np.prod(RES))
    occ = torch.zeros(n, dtype=torch.bool)
    for i0 in range(0, n, 10_000):
        tmf.cone_occupancy_slice(occ, min(i0, n - 10_000), tp, tb, 10_000, res=RES)
    idx = tmf.cone_occupancy_finalize(occ, res=RES, chunk=4096)
    cap = tmf.cone_capacity(n, 0.45, 4096)
    vol = torch.zeros(n + 1)
    for i0 in range(0, cap, 3_000):
        tmf.bake_cone_cells(vol, idx, min(i0, cap - 3_000), tp, tb, 3_000,
                            light_steps=2, res=RES)
    table = torch.cat([tmf.cone_table_rows(vol[:n].reshape(RES), r0,
                                           min(500, n - r0))
                       for r0 in range(0, n, 500)])
    sliced = tmf.wrap_cone_table(table, RES)
    sync = tmf.build_cone_cache(tp, tb, 2, res=RES, chunk=4096)
    np.testing.assert_allclose(sliced.table.texels.numpy(), sync.table.texels.numpy(),
                               atol=1e-5, rtol=0)


def test_one_pass_occupancy_equals_sliced_at_scale(packs):
    """At a (16, 256, 256) cone grid the one-pass occupancy
    (`cone_occupancy_indices`: the synchronous cone bake's, and so a
    restored engine's) keeps exactly the cells the sliced prebake keeps:
    both round a cell centre's shell height as r² − x² − z². Grouped as
    r² − (x² + z²), 5 of the 1,048,576 cells came out otherwise here (63
    of 8.4 M at (32, 512, 512)), and the card's restored cone table read
    0.00977 from the prebaked one."""
    _, tn = packs
    _, tp = _params()
    tb = tmf.BrickPack.from_noise(tn)
    res = (16, 256, 256)
    n = int(np.prod(res))
    occ = torch.zeros(n, dtype=torch.bool)
    for i0 in range(0, n, 1 << 18):
        tmf.cone_occupancy_slice(occ, i0, tp, tb, 1 << 18, res=res)
    sliced = tmf.cone_occupancy_finalize(occ, res=res, chunk=65536)
    one_pass = tmf.cone_occupancy_indices(tp, tb, res=res, chunk=65536)
    assert 0 < int((sliced < n).sum()) < sliced.numel()
    np.testing.assert_array_equal(one_pass.numpy(), sliced.numpy())


def test_engine_matches_jax(packs):
    """Warm start + 20 ticks with the same `now` values: the cloud ring and
    the composite agree at ≥ 50 dB, and the port picked up a prebaked cone
    cache at its cycle boundary. Then one `render_frame` tick on each, which
    both packages serve through their display-pair fused path by default
    (amortized, no mesh): the fused frames agree at ≥ 50 dB."""
    je, te = _engines(packs)
    pickups = 0
    for i in range(20):
        pend = te._pending
        boundary = te.ring.frame >= te.perf.frames_to_update
        je.update_sky(now=i / 30.0)
        te.update_sky(now=i / 30.0)
        if boundary and pend is not None and pend.cone is not None:
            assert te._cone_cache is pend.cone
            pickups += 1
    assert pickups == 1
    ring_j, ring_t = np.asarray(je.cloud_ring), te.cloud_ring.numpy()
    assert (ring_j[..., 3] > 0.1).mean() > 0.02
    assert psnr(ring_t, ring_j) >= 50.0
    d = _view_dirs()
    view_j = np.asarray(je.render_view(jnp.asarray(d)))
    view_t = te.render_view(torch.from_numpy(d)).numpy()
    assert np.isfinite(view_t).all() and view_t.min() >= 0.0
    assert psnr(view_t, view_j) >= 50.0
    assert te._display_pair is None and je._display_pair is None
    frame_t = te.render_frame(torch.from_numpy(d), now=21 / 30.0, deband=True)
    frame_j = np.asarray(je.render_frame(jnp.asarray(d), now=21 / 30.0,
                                         deband=True))
    assert te._display_pair is not None and je._display_pair is not None
    assert psnr(frame_t.numpy(), frame_j) >= 50.0


def test_restore_from_jax_save(packs):
    """The JAX engine's save() dict restores into the port: the same rings
    and schedule, then ticks that keep agreeing with the JAX engine."""
    je, te = _engines(packs)
    for i in range(5):
        je.update_sky(now=i / 30.0)
    te.restore(je.save())
    assert vars(te.ring) == vars(je.ring)
    assert te.blend_amount == je.blend_amount
    np.testing.assert_array_equal(te.cloud_ring.numpy(), np.asarray(je.cloud_ring))
    d = _view_dirs()
    assert psnr(te.render_view(torch.from_numpy(d)).numpy(),
                np.asarray(je.render_view(jnp.asarray(d)))) >= 50.0
    for i in range(5, 20):  # crosses a cycle boundary
        je.update_sky(now=i / 30.0)
        te.update_sky(now=i / 30.0)
    assert psnr(te.cloud_ring.numpy(), np.asarray(je.cloud_ring)) >= 50.0
    state = te.save()
    assert set(state) == set(je.save())
    assert isinstance(state["cloud_ring"], np.ndarray)


def test_render_full_hemisphere_matches_jax(packs):
    """render_full_hemisphere (the v3 march with the snapshot's measured
    buckets; 16 steps give prepass_steps 4 < 8, the policy's rebase branch)
    against the JAX engine's after the same warm start and ticks: the same
    buckets and ≥ 50 dB (~98 dB measured). The policy cache lives for one
    snapshot."""
    je, te = _engines(packs)
    for i in range(5):
        je.update_sky(now=i / 30.0)
        te.update_sky(now=i / 30.0)
    want = np.asarray(je.render_full_hemisphere())
    got = te.render_full_hemisphere().numpy()
    assert te._v3_march_knobs() == je._v3_march_knobs() == (4, 2)
    assert te._v3_policy_cache == je._v3_policy_cache is not None
    assert got.shape == want.shape == (32, 32, 4)
    assert np.isfinite(got).all() and (want[..., 3] > 0.1).mean() > 0.02
    assert psnr(got, want) >= 50.0
    te.restore(je.save())
    assert te._v3_policy_cache is None


def test_fast2_engine_matches_jax(packs):
    """kernel="fast2" (the staged v2 march for every tile, K2 and K1 on the
    card) against the JAX fast2 engine: warm start + 20 ticks, then the
    ring, a view and `render_full_hemisphere` (v2 over the whole map) at
    ≥ 50 dB."""
    je, te = _engines(packs, kernel="fast2")
    for i in range(20):
        je.update_sky(now=i / 30.0)
        te.update_sky(now=i / 30.0)
    ring_j, ring_t = np.asarray(je.cloud_ring), te.cloud_ring.numpy()
    assert (ring_j[..., 3] > 0.1).mean() > 0.02
    assert psnr(ring_t, ring_j) >= 50.0
    d = _view_dirs()
    view_t = te.render_view(torch.from_numpy(d)).numpy()
    assert np.isfinite(view_t).all() and view_t.min() >= 0.0
    assert psnr(view_t, np.asarray(je.render_view(jnp.asarray(d)))) >= 50.0
    want = np.asarray(je.render_full_hemisphere())
    got = te.render_full_hemisphere().numpy()
    assert got.shape == want.shape == (32, 32, 4)
    assert psnr(got, want) >= 50.0


# (kernel, bucket, rays, arm): every kernel unculled at a 96² and a 384²
# tile, the 0.0 skip, fast3's cell buckets and its 1.0 bucket on both sides
# of V3_TILE_MIN_RAYS (the 384² tile of frames_to_update 4 takes v2), and
# the culled fast2 and hier tiles.
SMALL, LARGE = 96 * 96, 384 * 384
TILE_ARMS = [
    ("fast3", None, SMALL, "dense"), ("fast3", None, LARGE, "v2"),
    ("fast2", None, SMALL, "v2"), ("fast2", None, LARGE, "v2"),
    ("hier", None, SMALL, "hier"), ("hier", None, LARGE, "hier"),
    ("fast", None, SMALL, "exact"), ("fast", None, LARGE, "exact"),
    ("reference", None, SMALL, "reference"), ("reference", None, LARGE, "reference"),
    ("fast3", 0.0, SMALL, "skip"), ("fast2", 0.0, SMALL, "skip"),
    ("hier", 0.0, SMALL, "skip"),
    ("fast3", 0.25, SMALL, "v3"), ("fast3", 0.8, LARGE, "v3"),
    ("fast3", 1.0, SMALL, "dense"), ("fast3", 1.0, LARGE, "v2"),
    ("fast2", 0.5, SMALL, "v2"), ("hier", 0.5, SMALL, "hier"),
]


@pytest.mark.parametrize("kernel,bucket,rays,arm", TILE_ARMS)
def test_tile_arm(kernel, bucket, rays, arm):
    """`tile_arm`, the engine's one decision of how a tile is marched."""
    assert tengine.tile_arm(kernel, bucket, rays) == arm


def test_fast3_v2_tile_arm_matches_jax(packs, monkeypatch):
    """fast3 tiles at or above V3_TILE_MIN_RAYS take the staged v2 march.
    The threshold is lowered to a 10² tile in both packages (a 40² map,
    which no other test traces, so JAX traces its tile kernel with the
    lowered threshold); both engines' tiles then call `march_bricks_v2`,
    and the ring and a view agree at ≥ 50 dB after warm start + 20 ticks."""
    monkeypatch.setattr(jengine, "V3_TILE_MIN_RAYS", 100)
    monkeypatch.setattr(tengine, "V3_TILE_MIN_RAYS", 100)
    calls = {"jax": 0, "port": 0}

    def spy(fn, key):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(jmf, "march_bricks_v2", spy(jmf.march_bricks_v2, "jax"))
    monkeypatch.setattr(tengine, "march_bricks_v2",
                        spy(tengine.march_bricks_v2, "port"))
    je, te = _engines(packs, size=40)
    assert te.perf.update_region_size == 10
    for i in range(20):
        je.update_sky(now=i / 30.0)
        te.update_sky(now=i / 30.0)
    assert calls["jax"] >= 1 and calls["port"] >= 20
    ring_j, ring_t = np.asarray(je.cloud_ring), te.cloud_ring.numpy()
    assert (ring_j[..., 3] > 0.1).mean() > 0.02
    assert psnr(ring_t, ring_j) >= 50.0
    d = _view_dirs()
    assert psnr(te.render_view(torch.from_numpy(d)).numpy(),
                np.asarray(je.render_view(jnp.asarray(d)))) >= 50.0


@pytest.mark.parametrize("kernel", ["fast", "reference"])
def test_unstaged_engine_matches_jax(packs, kernel):
    """kernel="fast" (the exact brick march, K2 on the card) and
    "reference" (the scan march) against the JAX engines, asked for
    `tile_cull` and `cone_prebake`, which both packages ignore for these
    kernels (no cone cache, no pending bake): the warm start and 6 ticks of
    a 4-frame cycle, across a boundary, then the ring, a view and
    `render_full_hemisphere` at ≥ 50 dB. A `save()` restored into a fresh
    engine re-renders the hemisphere bitwise and ticks on bitwise."""
    je, te = _engines(packs, kernel=kernel, frames=4, tile_cull=True,
                      cone_prebake=True)
    for e in (je, te):
        assert not e.tile_cull and not e.cone_prebake and not e._staged
    assert (te._bricks is None) == (kernel == "reference")
    for i in range(6):
        je.update_sky(now=i / 30.0)
        te.update_sky(now=i / 30.0)
    assert te._cone_cache is None and te._pending is None
    ring_j, ring_t = np.asarray(je.cloud_ring), te.cloud_ring.numpy()
    assert (ring_j[..., 3] > 0.1).mean() > 0.02
    assert psnr(ring_t, ring_j) >= 50.0
    d = _view_dirs()
    view_t = te.render_view(torch.from_numpy(d)).numpy()
    assert np.isfinite(view_t).all() and view_t.min() >= 0.0
    assert psnr(view_t, np.asarray(je.render_view(jnp.asarray(d)))) >= 50.0
    got = te.render_full_hemisphere().numpy()
    assert got.shape == (32, 32, 4)
    assert psnr(got, np.asarray(je.render_full_hemisphere())) >= 50.0

    back = _port_engine(packs[1], kernel, frames=4)
    back.restore(te.save())
    np.testing.assert_array_equal(back.render_full_hemisphere().numpy(), got)
    for i in range(6, 9):
        te.update_sky(now=i / 30.0)
        back.update_sky(now=i / 30.0)
    np.testing.assert_array_equal(back.cloud_ring.numpy(), te.cloud_ring.numpy())


def test_unported_modes_raise():
    """Every engine option of the JAX package is ported: the mesh since A15
    (tests/test_torch_sharding.py), kernel="hier" since A13
    (tests/test_torch_hier.py). What is neither raises: a mesh that is not
    a `parallel.sharding.Mesh` (TypeError) and an unknown kernel mode
    (ValueError)."""
    perf = PerfConfig(32, 16, march_steps=4, light_steps=2)
    with pytest.raises(TypeError, match="make_mesh"):
        CloudSkyEngine(perf=perf, cone_res=(4, 16, 16), device="cpu", mesh=object())
    with pytest.raises(ValueError, match="unknown kernel"):
        CloudSkyEngine(perf=perf, cone_res=(4, 16, 16), device="cpu", kernel="fast4")


def test_device_is_required():
    """`device` defaults to the card: with no device the engine lives on
    CUDA, and on a host without CUDA it raises rather than run on the CPU."""
    def build():
        return CloudSkyEngine(perf=PerfConfig(32, 16, march_steps=4, light_steps=2),
                              cone_res=(4, 16, 16))

    if torch.cuda.is_available():
        assert build().cloud_ring.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            build()
