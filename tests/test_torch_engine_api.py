"""The PyTorch port's engine API beyond the serving loop ≡ the JAX package's,
on the CPU: the validate-then-enable `can_run` gate, `set_performance`,
`save_file` / `load_file` (across the packages both ways),
`render_radiance_map` with `cubemap_directions`, `cubemap_solid_angles`
and the prefiltered mips, the asset readers of `utils/assets.py` and
`reference_noise_pack`.

The engines are tests/test_engine.py's: a 32² map, 16 frames, 4 steps, 2
light steps, coverage 0.6, the exact brick march (`kernel="fast"`, whose
amortized tiles are a pure tiling of one march), on the tiny JAX-generated
pack of tests/test_torch_engine.py (base 16, detail 16, weather 64).
Measured on the CPU: a ring restored across the packages is bitwise the
saved one, and the next tick's ring is 155.62 dB from the other package's
(gate 100 dB); the radiance map (sharp, 8²) differs from JAX's by at most
4.8e-7 and the prefiltered chain of a 16² map (16², 8², 4²) by at most
1.2e-7 (gate 1e-5).
"""

import struct

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cloudscape_tpu import engine as jengine
from cloudscape_tpu.config import CloudConfig as JCloud, PerfConfig as JPerf
from cloudscape_tpu.config import SunState as JSun
from cloudscape_tpu.engine import CloudSkyEngine as JEngine
from cloudscape_tpu.models import packs as jpacks
from cloudscape_tpu.ops.noise import (generate_base_noise, generate_detail_noise,
                                      generate_weather)
from cloudscape_tpu.utils import assets as jassets
from cloudscape_tpu.utils.image import psnr
from cloudscape_tpu_torch import CloudConfig, PerfConfig, SunState
from cloudscape_tpu_torch import engine as tengine
from cloudscape_tpu_torch.engine import CloudSkyEngine
from cloudscape_tpu_torch.models import packs as tpacks
from cloudscape_tpu_torch.utils import assets as tassets

# Several test workers share the host's cores: keep torch's intra-op
# thread pool small so they do not oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))

SUN = (0.3, 0.5, -0.8)


@pytest.fixture(scope="module")
def packs():
    jn = jpacks.make_noise_pack(generate_base_noise(16, seed=1),
                                generate_detail_noise(16, seed=2),
                                generate_weather(64, seed=3))
    tn = tpacks.noise_pack_from_numpy([np.asarray(a) for a in jn.large],
                                      [np.asarray(a) for a in jn.small],
                                      np.asarray(jn.weather), device="cpu")
    return jn, tn


def _port(tn, perf=None, **kw):
    return CloudSkyEngine(perf=perf or PerfConfig(32, 16, march_steps=4, light_steps=2),
                          config=CloudConfig(cloud_coverage=0.6),
                          sun=SunState(direction=SUN), noise=tn, kernel="fast",
                          device="cpu", **kw)


def _jax(jn):
    return JEngine(perf=JPerf(32, 16, march_steps=4, light_steps=2),
                   config=JCloud(cloud_coverage=0.6), sun=JSun(direction=SUN),
                   noise=jn, kernel="fast")


def _view_dirs():
    d = np.array(jengine.texel_directions(24))
    d[..., 1] -= 0.3
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_can_run_gate(packs):
    """A disabled engine does no work: `update_sky` and `update_cycle` leave
    the schedule and the ring as they were, `render_frame` only composites
    (tests/test_engine.py's gate, and the port's render_frame beside it)."""
    e = _port(packs[1])
    assert e.can_run
    e.update_sky(now=0.0)
    frame, ring = e.ring.frame, e.cloud_ring.clone()
    e.can_run = False
    e.update_sky(now=1.0)
    e.update_cycle(now=1.0)
    d = torch.from_numpy(_view_dirs())
    for fused in (True, False):
        out = e.render_frame(d, now=1.0, fused=fused)
        assert torch.equal(out, e.render_view(d))
    assert e.ring.frame == frame and torch.equal(e.cloud_ring, ring)
    e.can_run = True
    e.update_sky(now=1.0)
    assert e.ring.frame != frame


def test_failed_validation_disables_engine(packs, monkeypatch, capsys):
    """A failing validation (here a shape check made to fail) gives
    can_run == False with one line on stderr, no snapshot is taken, and
    the loop no-ops instead of raising (tests/test_engine.py's mesh case)."""
    def boom(self):
        raise ValueError("deliberately broken tile kernel\nsecond line")

    monkeypatch.setattr(CloudSkyEngine, "_check_shapes", boom)
    e = _port(packs[1])
    err = capsys.readouterr().err
    assert not e.can_run
    assert err.count("\n") == 1 and "engine disabled" in err \
        and "deliberately broken" in err
    assert e._cone_cache is None and e._pending is None
    frame = e.ring.frame
    e.update_sky(now=0.0)
    e.render_frame(torch.from_numpy(_view_dirs()), now=0.1)
    assert e.ring.frame == frame and not e.cloud_ring.any()
    for kernel in ("fast2", "fast3", "hier"):
        bad = CloudSkyEngine(perf=PerfConfig(32, 16, march_steps=4, light_steps=2),
                             cone_res=(4, 16, 16), noise=packs[1], kernel=kernel,
                             device="cpu")
        assert not bad.can_run and bad._cone_cache is None


def test_shape_check_disables_engine(packs, capsys):
    """The CPU validation is the shape check: 7 light steps (the cone march
    has 6 offsets) disable the engine before its first snapshot, where the
    JAX engine raises from its cone bake."""
    e = _port(packs[1], perf=PerfConfig(32, 16, march_steps=4, light_steps=7))
    assert not e.can_run and "light_steps 7" in capsys.readouterr().err
    assert e._cone_cache is None


def test_set_performance_rebuilds(packs, capsys):
    """tests/test_engine.py's set_performance test on the port: the ring
    torn down and rebuilt at the new shapes by a warm re-init, and the
    divisibility auto-correction (38 → 36 at 16 frames) with its notice."""
    e = _port(packs[1])
    e.update_sky(now=0.0)
    e.set_performance(PerfConfig(texture_size=16, frames_to_update=4, march_steps=4,
                                 light_steps=2))
    assert e.can_run and e.needs_full_sky_init
    assert tuple(e.cloud_ring.shape) == (3, 16, 16, 4)
    assert e.ring.frame == 0 and e.ring.update_position == (0, 0)
    assert e._pending is None and e._display_pair is None
    e.update_sky(now=1.0)
    assert float(e.cloud_ring.abs().max()) > 0.0
    capsys.readouterr()
    e.set_performance(PerfConfig(texture_size=38, frames_to_update=16, march_steps=4,
                                 light_steps=2))
    assert e.perf.texture_size == 36
    assert "changing to: 36" in capsys.readouterr().out


def test_save_file_round_trip(packs, tmp_path):
    """save_file → load_file within the port: the rings bitwise and the
    next tick of both engines bitwise equal."""
    a = _port(packs[1])
    for i in range(5):
        a.update_sky(now=i / 30.0)
    path = str(tmp_path / "port.npz")
    a.save_file(path)
    b = _port(packs[1])
    b.load_file(path)
    assert vars(b.ring) == vars(a.ring)
    assert torch.equal(b.cloud_ring, a.cloud_ring) and torch.equal(b.sky_ring, a.sky_ring)
    a.update_sky(now=5 / 30.0)
    b.update_sky(now=5 / 30.0)
    assert torch.equal(b.cloud_ring, a.cloud_ring)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_file_across_packages(packs, tmp_path, writer):
    """A file written by one package loads in the other: the rings bitwise
    the writer's, the schedule the same, and the next tick's rings
    ≥ 100 dB apart (155.63 / 155.62 dB measured, JAX / port writing)."""
    jn, tn = packs
    je, te = _jax(jn), _port(tn)
    src, dst = (je, te) if writer == "jax" else (te, je)
    for i in range(5):
        src.update_sky(now=i / 30.0)
    path = str(tmp_path / f"{writer}.npz")
    src.save_file(path)
    dst.load_file(path)
    np.testing.assert_array_equal(np.asarray(dst.cloud_ring), np.asarray(src.cloud_ring))
    np.testing.assert_array_equal(np.asarray(dst.sky_ring), np.asarray(src.sky_ring))
    assert vars(dst.ring) == vars(src.ring)
    for e in (je, te):
        e.update_sky(now=5 / 30.0)
    assert psnr(te.cloud_ring.numpy(), np.asarray(je.cloud_ring)) >= 100.0


def test_restore_before_first_tick_warm_starts(packs, tmp_path):
    """tests/test_engine.py's case on the port: a checkpoint taken before
    the first tick restores to an engine that still warm-starts, and one
    taken after does not."""
    e1 = _port(packs[1])
    assert e1.needs_full_sky_init
    path = str(tmp_path / "pre_tick.npz")
    e1.save_file(path)
    e2 = _port(packs[1])
    e2.load_file(path)
    assert e2.needs_full_sky_init
    e2.update_sky(now=0.0)
    assert bool(e2.cloud_ring.any()), "warm start did not run"
    path2 = str(tmp_path / "post_tick.npz")
    e2.save_file(path2)
    e3 = _port(packs[1])
    e3.load_file(path2)
    assert not e3.needs_full_sky_init


# The cosine-cubed solid angles miss 4π by 1.53e-2 (4²), 3.83e-3 (8²) and
# 2.39e-4 (32²) of it: the form's own error, the same in both packages.
SOLID_ANGLE_RTOL = {4: 2e-2, 8: 5e-3, 32: 1e-3}


@pytest.mark.parametrize("size", sorted(SOLID_ANGLE_RTOL))
def test_cubemap_geometry_matches_jax(size):
    """Directions and solid angles equal to JAX's within 1e-6; the faces in
    GL order (+Y up, −Y down) and the solid angles summing to 4π within the
    form's error."""
    d = tengine.cubemap_directions(size, device="cpu")
    sa = tengine.cubemap_solid_angles(size, device="cpu")
    assert d.shape == (6, size, size, 3) and sa.shape == (6, size, size)
    np.testing.assert_allclose(d.numpy(), np.asarray(jengine.cubemap_directions(size)),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(sa.numpy(), np.asarray(jengine.cubemap_solid_angles(size)),
                               atol=1e-6, rtol=0)
    assert (d[2][..., 1] > 0).all() and (d[3][..., 1] < 0).all()
    np.testing.assert_allclose(float(sa.sum()), 4 * np.pi, rtol=SOLID_ANGLE_RTOL[size])


def test_render_radiance_map_matches_jax(packs):
    """The radiance map of the same sky (the port restored from the JAX
    engine's state after 5 ticks): sharp at 8², and the prefiltered mips
    of a 16² map, against JAX's at atol 1e-5 (4.8e-7 and 1.2e-7
    measured); finite, nonnegative, the +Y face brighter than −Y."""
    jn, tn = packs
    je, te = _jax(jn), _port(tn)
    for i in range(5):
        je.update_sky(now=i / 30.0)
    te.restore(je.save())
    sharp = te.render_radiance_map(size=8)
    assert sharp.shape == (6, 8, 8, 3)
    assert bool(torch.isfinite(sharp).all()) and float(sharp.min()) >= 0.0
    assert float(sharp[2].mean()) > float(sharp[3].mean())
    np.testing.assert_allclose(sharp.numpy(), np.asarray(je.render_radiance_map(size=8)),
                               atol=1e-5, rtol=0)
    mips = te.render_radiance_map(size=16, prefilter=True)
    want = je.render_radiance_map(size=16, prefilter=True)
    assert [tuple(m.shape) for m in mips] == [(6, 16, 16, 3), (6, 8, 8, 3), (6, 4, 4, 3)]
    for got, w in zip(mips, want):
        assert bool(torch.isfinite(got).all()) and float(got.min()) >= 0.0
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5, rtol=0)


# ------------------------------------------------------------------ assets


def _bmp(path, img8, bpp=24, top_down=False, masks=None, header_size=40):
    """An uncompressed BMP of img8 [H, W, C] (RGB(A)); masks: BI_BITFIELDS
    with these (r, g, b, a) masks, after a V4 (108-byte) header or appended
    to the classic 40-byte one."""
    h, w, c = img8.shape
    stride = (w * c + 3) & ~3
    px = img8[..., ::-1] if c == 3 else img8[..., [2, 1, 0, 3]]
    rows = px if top_down else px[::-1]
    data = b"".join(r.tobytes() + b"\0" * (stride - w * c) for r in rows)
    compression = 3 if masks else 0
    info = struct.pack("<IiiHHIIiiII", header_size, w, -h if top_down else h, 1, bpp,
                       compression, len(data), 2835, 2835, 0, 0)
    if masks and header_size == 40:
        extra = struct.pack("<III", *masks[:3])
    elif masks:
        extra = struct.pack("<IIII", *masks) + b"\0" * (header_size - 56)
    else:
        extra = b"\0" * (header_size - 40)
    offset = 14 + len(info) + len(extra)
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset)
                + info + extra + data)


def _tga(path, img8, rle=False, origin_top=True):
    """A type-2 (or, with rle, type-10) true-color TGA of img8 [H, W, C]."""
    h, w, c = img8.shape
    hdr = struct.pack("<BBBHHBHHHHBB", 0, 0, 10 if rle else 2, 0, 0, 0, 0, 0, w, h,
                      c * 8, 0x20 if origin_top else 0x00)
    px = img8[..., ::-1] if c == 3 else img8[..., [2, 1, 0, 3]]
    flat = (px if origin_top else px[::-1]).reshape(-1, c)
    if not rle:
        body = flat.tobytes()
    else:
        out, i = bytearray(), 0
        while i < len(flat):
            run = 1
            while i + run < len(flat) and run < 128 and (flat[i + run] == flat[i]).all():
                run += 1
            if run > 1:
                out += bytes([0x80 | (run - 1)]) + flat[i].tobytes()
            else:
                out += bytes([0]) + flat[i].tobytes()
            i += run
        body = bytes(out)
    with open(path, "wb") as f:
        f.write(hdr + body)


BGRA = (0x00FF0000, 0x0000FF00, 0x000000FF, 0xFF000000)
IMAGE_CASES = {
    "bmp 24 bpp bottom-up, odd width (row padding)": ("bmp", dict(bpp=24), 3, 7),
    "bmp 24 bpp top-down": ("bmp", dict(bpp=24, top_down=True), 3, 8),
    "bmp 32 bpp": ("bmp", dict(bpp=32), 4, 5),
    "bmp 32 bpp BI_BITFIELDS, V4 header": ("bmp", dict(bpp=32, masks=BGRA,
                                                       header_size=108), 4, 6),
    "bmp 32 bpp BI_BITFIELDS, 40-byte header": ("bmp", dict(bpp=32, masks=BGRA[:3] + (0,)),
                                                4, 6),
    "tga type 2, top origin": ("tga", dict(), 3, 9),
    "tga type 2, bottom origin (flipped)": ("tga", dict(origin_top=False), 4, 9),
    "tga type 10 (RLE)": ("tga", dict(rle=True), 3, 12),
}


@pytest.mark.parametrize("case", sorted(IMAGE_CASES))
def test_readers_match_jax(tmp_path, case):
    """The port's readers on files the test writes: bitwise equal to the JAX
    package's Python readers and to the image written."""
    kind, kw, c, w = IMAGE_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    img8 = rng.integers(0, 256, (5, w, c), dtype=np.uint8)
    if kind == "tga" and kw.get("rle"):
        img8 = np.repeat(img8[:, :3], 4, axis=1)  # runs of 4
    path = str(tmp_path / f"img.{kind}")
    (_bmp if kind == "bmp" else _tga)(path, img8, **kw)
    got = (tassets.load_bmp if kind == "bmp" else tassets.load_tga)(path)
    want = (jassets._load_bmp_py if kind == "bmp" else jassets.load_tga)(path)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img8.astype(np.float32) / 255.0)


def test_bmp_swapped_masks_rejected(tmp_path):
    """BI_BITFIELDS masks that are not BGR(A) raise in both packages rather
    than decode with swapped channels."""
    path = str(tmp_path / "rgba.bmp")
    _bmp(path, np.zeros((2, 2, 4), np.uint8), bpp=32,
         masks=(0x000000FF, 0x0000FF00, 0x00FF0000, 0xFF000000), header_size=108)
    for reader in (tassets.load_bmp, jassets._load_bmp_py):
        with pytest.raises(ValueError, match="BGR"):
            reader(path)


def test_slice_horizontal_3d_matches_jax():
    img = np.random.default_rng(0).random((4, 32 * 3, 3), dtype=np.float32)
    got = tassets.slice_horizontal_3d(img, 32)
    assert got.shape == (32, 4, 3, 3)
    np.testing.assert_array_equal(got, jassets.slice_horizontal_3d(img, 32))


def _tiny_generators(monkeypatch):
    """The port's noise generators at tiny sizes whatever size is asked
    (the 128³ base volume takes minutes through the plain version)."""
    from cloudscape_tpu_torch.ops import noise_kernel

    for name, size in (("generate_base_noise", 8), ("generate_detail_noise", 8),
                       ("generate_weather", 16)):
        real = getattr(noise_kernel, name)
        monkeypatch.setattr(noise_kernel, name,
                            lambda n, seed, device="cuda", real=real, size=size:
                            real(size, seed, device=device))


@pytest.mark.parametrize("seed", [0, 3])
def test_reference_pack_falls_back_to_procedural(tmp_path, monkeypatch, seed):
    """Without the two BMPs the pack is `procedural_noise_pack(seed)`, made
    on the asked device."""
    _tiny_generators(monkeypatch)
    got = tpacks.reference_noise_pack(str(tmp_path), seed=seed, device="cpu")
    want = tpacks.procedural_noise_pack(seed, device="cpu")
    for a, b in zip((*got.large, *got.small, got.weather),
                    (*want.large, *want.small, want.weather)):
        assert a.device.type == "cpu" and torch.equal(a, b)


def test_reference_pack_from_bmps_matches_jax(tmp_path, monkeypatch):
    """With a written worlnoise.bmp (32 slices of 4×4) and weather.bmp (8²)
    the port's pack equals JAX's `reference_noise_pack`, both given the
    same base volume in place of the generated 128³ one: the detail volume
    and weather bitwise, the mips within 1e-6."""
    rng = np.random.default_rng(5)
    _bmp(str(tmp_path / "worlnoise.bmp"), rng.integers(0, 256, (4, 128, 3), dtype=np.uint8))
    _bmp(str(tmp_path / "weather.bmp"), rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
    base = rng.random((8, 8, 8, 4), dtype=np.float32)
    monkeypatch.setattr(jpacks, "_generate_cached", lambda fn, name, size, seed: base)
    from cloudscape_tpu_torch.ops import noise_kernel

    monkeypatch.setattr(noise_kernel, "generate_base_noise",
                        lambda n, seed, device="cuda": torch.from_numpy(base).to(device))
    want = jpacks.reference_noise_pack(str(tmp_path), seed=0)
    got = tpacks.reference_noise_pack(str(tmp_path), seed=0, device="cpu")
    assert got.small[0].shape == (32, 4, 4, 3) and got.weather.shape == (8, 8, 3)
    np.testing.assert_array_equal(got.small[0].numpy(), np.asarray(want.small[0]))
    np.testing.assert_array_equal(got.weather.numpy(), np.asarray(want.weather))
    for a, b in zip((*got.large, *got.small), (*want.large, *want.small)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
