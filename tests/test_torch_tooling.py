"""The PyTorch port's tooling on the CPU: `StageTimer` and `device_trace`
(`utils/profiling.py`), the display helpers of `utils/image.py` against the
JAX package's, and the demo and screenshot scripts at a tiny size.
"""

import functools
import glob
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from cloudscape_tpu.utils import image as jimage
from cloudscape_tpu_torch.engine import CloudSkyEngine
from cloudscape_tpu_torch.examples import demo, screenshots
from cloudscape_tpu_torch.models.packs import procedural_noise_pack
from cloudscape_tpu_torch.utils import image as timage
from cloudscape_tpu_torch.utils.profiling import StageTimer, device_trace

torch.set_num_threads(min(2, torch.get_num_threads()))


# ------------------------------------------------------------- StageTimer


def test_stage_timer_accumulates():
    """tests/test_profiling.py on CPU tensors."""
    t = StageTimer()
    for _ in range(3):
        with t.stage("work", rays=100):
            x = torch.ones((64, 64)).sum()
            t.fence(x)
    assert t.counts["work"] == 3
    assert t.rays["work"] == 300
    assert t.totals["work"] > 0
    assert t.mrays_per_sec("work") > 0
    rep = t.report()
    assert "work" in rep and "Mrays/s" in rep
    d = t.as_dict()
    assert d["work"]["calls"] == 3 and d["work"]["total_s"] > 0


def test_stage_timer_fence_kwarg():
    t = StageTimer()
    x = torch.arange(10)
    with t.stage("fenced", fence=x):
        pass
    assert t.counts["fenced"] == 1
    assert t.mrays_per_sec("fenced") is None
    assert t.as_dict()["fenced"]["mrays_per_sec"] == 0.0


def test_stage_timer_fences_trees():
    """A fence may be a tree (tuples, dicts, dataclasses of tensors) and is
    returned as it was given."""
    t = StageTimer()
    tree = {"a": (torch.zeros(3), [torch.ones(2)]), "b": 1.5}
    assert t.fence(tree) is tree
    with t.stage("tree", rays=7, fence=tree):
        pass
    assert t.counts["tree"] == 1 and t.rays["tree"] == 7


def test_device_trace_writes_a_trace(tmp_path):
    """`device_trace` writes a torch.profiler trace of the block on the CPU,
    a Chrome trace that names the block's operators."""
    log_dir = tmp_path / "trace"
    with device_trace(str(log_dir)) as prof:
        torch.matmul(torch.ones(32, 32), torch.ones(32, 32))
    files = glob.glob(os.path.join(str(log_dir), "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any("matmul" in str(n) or "mm" in str(n) for n in names)
    assert prof.key_averages() is not None


# ---------------------------------------------------------- image helpers


@pytest.mark.parametrize("shape", [(6, 8, 3), (7, 9, 4)])
def test_downsample2x_matches_jax(shape):
    """The 2×2 box downsample (an odd last row and column dropped), atol
    1e-6 against the JAX package's."""
    img = np.random.default_rng(11).random(shape).astype(np.float32)
    got = timage.downsample2x(img)
    assert got.shape == (shape[0] // 2, shape[1] // 2, shape[2])
    np.testing.assert_allclose(got, jimage.downsample2x(img), atol=1e-6, rtol=0)


def test_srgb_and_display_encode_match_jax():
    """The sRGB OETF and the display chain (ACES white 3.53 + sRGB) over
    HDR values from −0.1 to 8, atol 1e-6 against the JAX package's."""
    x = np.random.default_rng(12).uniform(-0.1, 8.0, (32, 40, 3)).astype(np.float32)
    np.testing.assert_allclose(timage.srgb_encode(x / 8.0),
                               jimage.srgb_encode(x / 8.0), atol=1e-6, rtol=0)
    got = timage.display_encode(x)
    np.testing.assert_allclose(got, jimage.display_encode(x), atol=1e-6, rtol=0)
    np.testing.assert_allclose(timage.display_encode(x, white=2.0),
                               jimage.display_encode(x, white=2.0), atol=1e-6, rtol=0)
    assert got.min() >= 0.0 and got.max() <= 1.0


# ---------------------------------------------------------------- scripts


def _read_png(path):
    """Decode the 8-bit RGB PNG that `write_png` writes (filter 0 rows)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, (w, h) = 8, b"", (0, 0)
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


@pytest.fixture
def tiny_engines(monkeypatch):
    """The scripts' engines on a tiny procedural pack, and the screenshots'
    on a (8, 64, 64) cone cache (the demo takes `--cone-res`): the default
    128³ pack and (32, 512, 512) cache take minutes on the CPU."""
    pack = procedural_noise_pack(1, 16, 16, 64, device="cpu")
    monkeypatch.setattr(demo, "CloudSkyEngine",
                        functools.partial(CloudSkyEngine, noise=pack))
    monkeypatch.setattr(screenshots, "CloudSkyEngine", functools.partial(
        CloudSkyEngine, noise=pack, cone_res=(8, 64, 64)))


@pytest.mark.parametrize("mode", [[], ["--serve"], ["--ticked", "--kernel", "fast2"]])
def test_demo_writes_frames(tmp_path, tiny_engines, capsys, mode):
    """`demo.main` with --cpu at a 32² map, 8 steps, a (8, 64, 64) cone
    cache and 48×24 frames: batched cycles, the fused serving loop and
    per-frame ticks each write two PNGs that are not black, and print the
    stage timings."""
    out = tmp_path / "demo"
    demo.main(["--cpu", "--out", str(out), "--frames", "2", "--size", "32",
               "--frames-to-update", "4", "--steps", "8", "--width", "48",
               "--height", "24", "--coverage", "0.6", "--cone-res", "8,64,64"]
              + mode)
    pngs = sorted(glob.glob(str(out / "frame_*.png")))
    assert len(pngs) == 2
    for p in pngs:
        img = _read_png(p)
        assert img.shape == (24, 48, 3) and img.mean() > 10.0
    text = capsys.readouterr().out
    assert "device: cpu" in text and "--- timings ---" in text
    assert ("render_frame" if mode == ["--serve"] else "render_view") in text


def test_screenshots_write_scenes(tmp_path, tiny_engines):
    """`screenshots.main` with --cpu at a 32² map, 8 steps, 48×24 frames:
    the three scenes' PNGs, not black."""
    out = tmp_path / "shots"
    screenshots.main(["--cpu", "--out", str(out), "--size", "32", "--steps", "8",
                      "--width", "48", "--height", "24"])
    for name in screenshots.SCENES:
        img = _read_png(str(out / f"{name}.png"))
        assert img.shape == (24, 48, 3) and img.mean() > 10.0
