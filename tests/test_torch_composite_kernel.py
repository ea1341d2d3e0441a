"""Kernel K12 (`ops/composite_kernel.py`, `csrc/composite.cu`): the fused
tick's `composite_display` over the engine's form (8-channel pair
textures, the raw transmittance LUT) in one launch.

On the CPU: `composite_display` over that form is the eager body it ran
before the kernel, bit for bit; the wrapper's arguments (`kernel_args`)
and the checks that raise; no launch is counted. The `card` cases hold
K12 against the plain version (`_composite_display_plain`, run on the
card) at atol 2e-5 / rtol 1e-5 at 1280×720 and 16×40, with and without
deband, blend_amount 0, 0.40625 and 1, the sun above and below the
horizon and straight-down view directions (the [1, 0, 0] fallback); and
one fused tick's composite under `torch.cuda.set_sync_debug_mode("error")`.
They skip without a CUDA card; on the card, without the JAX test
configuration: `python -m pytest --noconftest
tests/test_torch_composite_kernel.py -m card -q`.
"""

import math

import pytest
import torch

from cloudscape_tpu_torch import CloudConfig, PerfConfig, SunState
from cloudscape_tpu_torch import engine as engine_mod
from cloudscape_tpu_torch.engine import CloudSkyEngine
from cloudscape_tpu_torch.models import compositor
from cloudscape_tpu_torch.models.compositor import composite_display
from cloudscape_tpu_torch.models.packs import make_noise_pack
from cloudscape_tpu_torch.ops import brick, composite_kernel
from cloudscape_tpu_torch.ops.noise import (generate_base_noise, generate_detail_noise,
                                            generate_weather)
from cloudscape_tpu_torch.ops.octmap import texel_directions, world_dir_to_uv

torch.set_num_threads(min(2, torch.get_num_threads()))

SUNS = {"above": (0.4, 0.35, -0.85), "below": (0.3, -0.2, 0.9)}
BLENDS = (0.0, 0.40625, 1.0)


def _unit(v):
    n = math.sqrt(sum(x * x for x in v))
    return tuple(x / n for x in v)


def _inputs(device, height: int, width: int, cloud_size: int, seed: int = 7):
    """View directions [height, width, 3] (unit, random; the first row
    straight down, the second on the horizon), the cloud and sky pair
    textures (clamp) and a [64, 256, 4] LUT, all float32 on `device`."""
    g = torch.Generator().manual_seed(seed)
    d = torch.randn((height, width, 3), generator=g)
    d[0] = torch.tensor([0.0, -1.0, 0.0])
    d[1, :, 1] = 0.0
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    cloud = torch.rand((cloud_size, cloud_size, 8), generator=g)
    sky = torch.rand((100, 200, 8), generator=g) * 20.0
    tlut = torch.rand((64, 256, 4), generator=g) * 0.8 + 0.2
    return (d.to(device), brick.build_texture2(cloud.to(device), wrap="clamp"),
            brick.build_texture2(sky.to(device), wrap="clamp"), tlut.to(device))


def _former_body(eyedir, cloud, sky, tlut, sun_dir, scale, blend, deband):
    """`composite_display`'s eager body as it ran before K12, step by step
    from the module's pieces (the pair form)."""
    sun_dir = torch.tensor(sun_dir, dtype=torch.float32)
    clouds = brick.sample_tex2(cloud, world_dir_to_uv(compositor._cloud_dir(eyedir)))
    clouds = clouds[..., 0:4] + (clouds[..., 4:8] - clouds[..., 0:4]) * blend
    background = compositor.get_atmo(eyedir, sky, None, tlut, blend, sun_dir, scale)
    return compositor._finish(eyedir, clouds, background, deband)


# ------------------------------------------------------------- the CPU


@pytest.mark.parametrize("sun", sorted(SUNS))
@pytest.mark.parametrize("blend", BLENDS)
@pytest.mark.parametrize("deband", [False, True])
def test_pair_form_on_the_cpu_is_the_former_body(sun, blend, deband):
    """On the CPU the engine's form takes the plain version: the eager
    body `composite_display` ran before K12, bit for bit, whether the sun
    comes as host floats (the engine's) or a tensor."""
    d, cloud, sky, tlut = _inputs("cpu", 16, 40, 24)
    s = _unit(SUNS[sun])
    want = _former_body(d, cloud, sky, tlut, s, 2.0, blend, deband)
    got = composite_display(d, cloud, sky, tlut, s, 2.0, blend, deband=deband)
    as_tensor = composite_display(d, cloud, sky, tlut, torch.tensor(s), 2.0, blend,
                                  deband=deband)
    assert got.shape == (16, 40, 3) and bool(torch.isfinite(got).all())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(as_tensor.view(torch.int32), want.view(torch.int32))


def test_cpu_calls_count_no_launch():
    """The plain version launches nothing, so `launches` stays put."""
    d, cloud, sky, tlut = _inputs("cpu", 4, 6, 8)
    before = dict(composite_kernel.launches)
    composite_display(d, cloud, sky, tlut, SUNS["above"], 2.0, 0.5)
    composite_kernel.composite_display_pair(d, cloud, sky, tlut, SUNS["above"], 2.0, 0.5)
    assert composite_kernel.launches == before


@pytest.mark.parametrize("shape,width,height", [
    ((16, 40), 40, 16), ((640,), 640, 1), ((2, 4, 5), 5, 4)],
    ids=["image", "row", "batch"])
def test_kernel_args(shape, width, height):
    """The C entry's arguments: the pixels, each pair's (h, w, clamp, weight
    strides), the LUT's dims, the dither lattice (the image's last two dims)
    and the scalars as the float32 values of the host's."""
    d, cloud, sky, tlut = _inputs("cpu", 4, 6, 24)
    d = torch.nn.functional.normalize(torch.ones(shape + (3,)), dim=-1)
    out, args, held = composite_kernel.kernel_args(
        d, cloud, sky, tlut, (0.1, 0.2, 0.3), 2.5, 0.40625, True)
    assert out.shape == shape + (3,) and out.dtype == torch.float32
    assert args[1] == math.prod(shape)
    assert list(args[2]) == [24, 24, 1, 3, 3, 100, 200, 1, 3, 3, 64, 256, 4, width,
                             height]
    assert args[3] == cloud.texels.data_ptr() and args[4] == sky.texels.data_ptr()
    want = torch.tensor([0.1, 0.2, 0.3, 2.5, 0.40625], dtype=torch.float32).tolist()
    assert list(args[6]) == want and args[7] == 1
    assert args[0] == held[0].data_ptr() and args[5] == held[1].data_ptr()


def _bad(case):
    d, cloud, sky, tlut = _inputs("cpu", 4, 6, 8)
    args = dict(eyedir=d, cloud_pair=cloud, sky_pair=sky, tlut=tlut,
                sun_dir=(0.0, 1.0, 0.0), sun_disk_scale=1.0, blend_amount=0.5,
                deband=False)
    four = brick.build_texture2(torch.rand(8, 8, 4), wrap="clamp")
    flat = torch.rand(8 * 8 * 8 + 1)
    bad = {
        "eyedir-f64": dict(eyedir=d.double()),
        "eyedir-4": dict(eyedir=torch.rand(4, 6, 4)),
        "cloud-4-channels": dict(cloud_pair=four),
        "sky-not-texture": dict(sky_pair=sky.texels),
        "cloud-unaligned": dict(cloud_pair=brick.Texture2D(
            flat[1:].view(8, 8, 8), (8, 8), 8, "clamp")),
        "cloud-f64": dict(cloud_pair=brick.Texture2D(
            cloud.texels.double(), cloud.dims, 8, "clamp")),
        "sky-repeat": dict(sky_pair=brick.build_texture2(sky.texels, wrap="repeat")),
        "lut-2d": dict(tlut=tlut[0]),
        "lut-2-channels": dict(tlut=tlut[..., :2]),
        "sun-on-another-device": dict(sun_dir=torch.zeros(3, device="meta")),
        "sun-4": dict(sun_dir=(0.0, 1.0, 0.0, 0.0)),
        "deband-int": dict(deband=1),
    }[case]
    return dict(args, **bad)


@pytest.mark.parametrize("case", [
    "eyedir-f64", "eyedir-4", "cloud-4-channels", "sky-not-texture", "cloud-unaligned",
    "cloud-f64", "sky-repeat", "lut-2d", "lut-2-channels", "sun-on-another-device", "sun-4",
    "deband-int"])
def test_kernel_args_raise(case):
    """What K12 does not take raises ValueError before any launch."""
    a = _bad(case)
    with pytest.raises(ValueError):
        composite_kernel.kernel_args(a["eyedir"], a["cloud_pair"], a["sky_pair"],
                                     a["tlut"], a["sun_dir"], a["sun_disk_scale"],
                                     a["blend_amount"], a["deband"])


def test_other_devices_raise():
    """A device that is neither the CPU nor CUDA raises."""
    d, cloud, sky, tlut = _inputs("cpu", 2, 2, 8)
    with pytest.raises(ValueError):
        composite_kernel.composite_display_pair(d.to("meta"), cloud, sky, tlut,
                                                (0.0, 1.0, 0.0), 1.0)


def test_other_forms_keep_the_plain_version(monkeypatch):
    """Pre-blended images, brick tables and repeat-wrapped pairs never reach
    the wrapper."""
    d, cloud, sky, tlut = _inputs("cpu", 3, 5, 8)
    called = []
    monkeypatch.setattr(composite_kernel, "composite_display_pair",
                        lambda *a, **k: called.append(1))
    out = composite_display(d, cloud.texels[..., :4], sky.texels[..., :4], tlut,
                            (0.0, 1.0, 0.0), 1.0, 0.5)
    table = brick.build_brick2_device(cloud.texels, (4, 4), (3, 3), wrap="clamp")
    out2 = composite_display(d, table, sky, tlut, (0.0, 1.0, 0.0), 1.0, 0.5)
    repeat = brick.build_texture2(cloud.texels, wrap="repeat")
    out3 = composite_display(d, repeat, sky, tlut, (0.0, 1.0, 0.0), 1.0, 0.5)
    assert called == [] and out.shape == out2.shape == out3.shape == (3, 5, 3)
    composite_display(d, cloud, sky, tlut, (0.0, 1.0, 0.0), 1.0, 0.5)
    assert called == [1]


# ------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("size", [(720, 1280, 768), (16, 40, 24)], ids=["1280x720", "40x16"])
@pytest.mark.parametrize("sun", sorted(SUNS))
@pytest.mark.parametrize("blend", BLENDS)
@pytest.mark.parametrize("deband", [False, True])
def test_kernel_matches_the_plain_version(card, size, sun, blend, deband):
    """K12 against its plain version on the card: atol 2e-5 / rtol 1e-5
    (the fused composite's tolerance against the split one), two calls
    bitwise, one launch counted a call and none by the plain version."""
    d, cloud, sky, tlut = _inputs(card, *size)
    s = _unit(SUNS[sun])
    before = composite_kernel.launches["composite"]
    got = composite_display(d, cloud, sky, tlut, s, 2.0, blend, deband=deband)
    again = composite_display(d, cloud, sky, tlut, s, 2.0, blend, deband=deband)
    assert composite_kernel.launches["composite"] - before == 2
    want = compositor._composite_display_plain(d, cloud, sky, tlut, s, 2.0, blend,
                                               deband=deband)
    assert composite_kernel.launches["composite"] - before == 2
    torch.cuda.synchronize()
    assert got.shape == want.shape == size[:2] + (3,)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.card
def test_fused_tick_composite_makes_no_synchronising_call(card, monkeypatch):
    """One fused tick's composite (the engine's own call, wrapped) under
    `torch.cuda.set_sync_debug_mode("error")`: no synchronising call, and
    exactly one K12 launch."""
    noise = make_noise_pack(generate_base_noise(16, seed=1, device=card),
                            generate_detail_noise(8, seed=2, device=card),
                            generate_weather(64, seed=3, device=card))
    eng = CloudSkyEngine(perf=PerfConfig(128, 16, march_steps=32, light_steps=6),
                         config=CloudConfig(cloud_coverage=0.6),
                         sun=SunState(direction=(0.3, 0.5, -0.8)), noise=noise,
                         cone_res=(16, 128, 128), device=card, kernel="fast3",
                         tile_cull=True)
    assert eng.can_run
    view = texel_directions(48, device=card)
    for i in range(3):
        eng.render_frame(view, now=i / 60)
    seen = []

    def strict(*args, **kwargs):
        before = composite_kernel.launches["composite"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = composite_display(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        seen.append(composite_kernel.launches["composite"] - before)
        return out

    monkeypatch.setattr(engine_mod, "composite_display", strict)
    frame = eng.render_frame(view, now=3 / 60)
    torch.cuda.synchronize()
    assert seen == [1]
    assert frame.shape == (48, 48, 3) and bool(torch.isfinite(frame).all())
