"""End to end: the PyTorch port's engine chain against the f64 oracle chain,
on the CPU.

tests/test_integration.py's three checks, on the port: a frame of the
`kernel="reference"` engine (transmittance LUT → sky LUT → the amortized
cloud map → composite) against the chain built from `oracle/reference.py`
alone, at > 40 dB; the sunset chain at its PSNR and warm-shift gates; and
`save_file` → `load_file` bitwise. That test reads the reference's BMPs,
which this repository does not ship; here the pack comes from the JAX
package's own generators (base 16 seed 5 as there, detail 32 seed 2 and
weather 64 seed 3 as the other port tests seed them): the port's engine
takes their float32 arrays unchanged (`noise_pack_from_numpy`), the
oracle the same arrays in float64 with its own pyramids
(`build_pyramid3d_np`). The scenes are the JAX test's (a 48² map, 16
frames, 8 steps, 6 light steps, its suns and views) but for the
coverage: at the JAX test's 0.5 and 0.55 this pack's clouds (engine
alpha > 0.4) cover only 1.9% and 2.6% of the two views, so both are
raised by 0.1, the first common step of 0.05 at which each covers over
5%: 0.6 and 0.65.

Measured on the CPU: the frame 89.06 dB from the oracle chain (clouds on
8.35% of the view); the sunset 80.91 dB, clouds on 5.52% of the view
with R/B 1.0641 against the oracle's 1.0644. The R/B of clouded texels
at this sunset is the scene's more than the engine's: over four
procedural packs and coverages 0.55–0.85 the oracle read 0.83–1.08, and
the port followed it within 0.03% wherever both were read; so the
absolute gate (> 1.05) holds for this scene, and the gate that holds the
port to the oracle is the 5% one.
"""

import numpy as np
import pytest
import torch

from cloudscape_tpu.models.packs import make_noise_pack
from cloudscape_tpu.ops.noise import (generate_base_noise, generate_detail_noise,
                                      generate_weather)
from cloudscape_tpu.utils.image import psnr
from cloudscape_tpu_torch import CloudConfig, PerfConfig, SunState
from cloudscape_tpu_torch.engine import CloudSkyEngine
from cloudscape_tpu_torch.models.packs import noise_pack_from_numpy
from cloudscape_tpu_torch.ops.octmap import world_dir_to_uv
from cloudscape_tpu_torch.ops.sampling import sample2d
from oracle import reference as ref

# Several test workers share the host's cores: keep torch's intra-op
# thread pool small so they do not oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))

PERF = dict(texture_size=48, frames_to_update=16, march_steps=8, light_steps=6)
GROUND = (0.27, 0.19, 0.027, 1.0)


@pytest.fixture(scope="module")
def packs():
    """(the port's pack, the oracle's f64 pyramids: large, small, weather)."""
    jn = make_noise_pack(generate_base_noise(16, seed=5),
                         generate_detail_noise(32, seed=2),
                         generate_weather(64, seed=3))
    tn = noise_pack_from_numpy([np.asarray(a) for a in jn.large],
                               [np.asarray(a) for a in jn.small],
                               np.asarray(jn.weather), device="cpu")
    oracle = (ref.build_pyramid3d_np(np.asarray(jn.large[0], np.float64)),
              ref.build_pyramid3d_np(np.asarray(jn.small[0], np.float64)),
              np.asarray(jn.weather, np.float64))
    return tn, oracle


def _engine(noise, sun, coverage):
    eng = CloudSkyEngine(perf=PerfConfig(**PERF),
                         config=CloudConfig(cloud_coverage=coverage, sun_disk_scale=2.0,
                                            ground_color=GROUND),
                         sun=SunState(direction=tuple(sun)), noise=noise,
                         kernel="reference", device="cpu")
    assert eng.can_run
    eng.update_sky(now=0.0)  # warm start
    return eng


def _view(el_lo, el_hi):
    """tests/test_integration.py's 64 × 32 view grid over the upper
    hemisphere."""
    az = np.linspace(-np.pi, np.pi, 64, endpoint=False)
    el = np.linspace(el_lo, el_hi, 32)
    d = np.stack([np.cos(el)[:, None] * np.cos(az)[None, :],
                  np.broadcast_to(np.sin(el)[:, None], (32, 64)),
                  np.cos(el)[:, None] * np.sin(az)[None, :]], axis=-1)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _oracle_frame(eng, oracle, sun, d):
    """The oracle chain, all f64: LUTs → the cloud map over the engine's
    texel grid → composite. The engine is at a static scene, so both blend
    buffers are the one map."""
    tlut = ref.transmittance_lut_ref()
    sky = ref.sky_lut_ref(tlut, sun)
    fd = eng.frame_data
    params = dict(cloud_pos=np.asarray(fd.cloud_pos), detailed_pos=np.asarray(fd.detailed_pos),
                  weather_pos=np.asarray(fd.weather_pos), time=fd.time,
                  density=fd.density, cloud_coverage=fd.cloud_coverage,
                  light_direction=sun, light_energy=1.0, light_color=np.ones(3),
                  ground_color=np.asarray(fd.ground_color))
    n = eng.perf.texture_size
    ys, xs = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    dirs_map = ref.oct_to_vec3_np(np.stack([xs / n, ys / n], axis=-1))[..., [0, 2, 1]]
    cloud_map = ref.cloud_march_ref(dirs_map, params, *oracle, sky,
                                    steps=eng.perf.march_steps)
    return ref.composite_ref(d, cloud_map, cloud_map, sky, sky, tlut,
                             eng.blend_amount, 2.0, sun)


def _cloudy(eng, d):
    """The engine's cloud alpha at the view directions > 0.4."""
    ring = eng.cloud_ring[eng.ring.texture_to_blend_to]
    uv = world_dir_to_uv(torch.tensor(d, dtype=torch.float32))
    return sample2d(ring, uv, wrap="clamp")[..., 3].numpy() > 0.4


@pytest.fixture(scope="module")
def frame_engine(packs):
    sun = np.array([0.45, 0.35, -0.82])
    sun /= np.linalg.norm(sun)
    return _engine(packs[0], sun, 0.6), sun


def test_full_frame_vs_oracle_chain(packs, frame_engine):
    """The frame against the oracle chain at > 40 dB (tests/test_integration.py
    :45-99), finite, with clouds on part of the view."""
    eng, sun = frame_engine
    d = _view(0.05, 1.2)
    got = eng.render_view(torch.tensor(d, dtype=torch.float32)).numpy()
    want = _oracle_frame(eng, packs[1], sun, d)
    assert np.isfinite(got).all()
    assert _cloudy(eng, d).mean() > 0.05, "the scene rendered too few clouds to gate"
    p = psnr(got, want)
    assert p > 40.0, f"full-chain PSNR {p:.2f} dB < 40 dB gate"


def test_save_file_roundtrip(tmp_path, packs, frame_engine):
    """`save_file` → `load_file` into a new engine: the ring, the frame and
    a rendered view bitwise (tests/test_integration.py:101-117)."""
    eng, _ = frame_engine
    path = str(tmp_path / "ckpt.npz")
    eng.save_file(path)
    fresh = CloudSkyEngine(perf=eng.perf, noise=packs[0], kernel="reference",
                           device="cpu")
    fresh.load_file(path)
    assert torch.equal(fresh.cloud_ring, eng.cloud_ring)
    assert fresh.ring.frame == eng.ring.frame
    d = np.array([[0.1, 0.8, -0.3]])
    d = torch.tensor(d / np.linalg.norm(d), dtype=torch.float32)
    assert torch.equal(fresh.render_view(d), eng.render_view(d))


def test_sunset_composite_chain_warm_shift(packs):
    """At a sun 8° above the horizon the composited clouds take the oracle's
    warm shift: > 40 dB from the oracle chain, and on the clouded texels
    (engine alpha > 0.4, over 5% of the view) R/B > 1.05 and within 5% of
    the oracle's (tests/test_integration.py:120-196)."""
    sun = np.array([0.99, np.sin(np.deg2rad(8.0)), -0.1])
    sun /= np.linalg.norm(sun)
    eng = _engine(packs[0], sun, 0.65)
    d = _view(0.08, 0.9)
    got = eng.render_view(torch.tensor(d, dtype=torch.float32)).numpy()
    want = _oracle_frame(eng, packs[1], sun, d)
    p = psnr(got, want)
    assert p > 40.0, f"sunset full-chain PSNR {p:.2f} dB < 40 dB gate"
    cloudy = _cloudy(eng, d)
    assert cloudy.mean() > 0.05, "sunset scene rendered too few clouds to gate"
    rb_got = got[cloudy, 0].mean() / max(got[cloudy, 2].mean(), 1e-6)
    rb_want = want[cloudy, 0].mean() / max(want[cloudy, 2].mean(), 1e-6)
    assert rb_got > 1.05, f"sunset clouds not warm (R/B = {rb_got:.3f})"
    assert abs(rb_got - rb_want) / rb_want < 0.05, (
        f"warm shift diverges from the oracle: R/B {rb_got:.3f}, oracle {rb_want:.3f}")
