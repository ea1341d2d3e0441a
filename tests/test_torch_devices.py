"""The port's entry points run on the card unless the caller asks for the CPU.

Each entry point that makes tensors from nothing (no input tensor to take a
device from) defaults to `device="cuda"`. On a host without CUDA a call that
names no device raises, as torch does, and never returns CPU tensors; with
CUDA (decided inside the test) it returns CUDA tensors. Asked for the CPU,
each returns CPU tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from cloudscape_tpu_torch import PerfConfig
from cloudscape_tpu_torch import engine
from cloudscape_tpu_torch.engine import CloudSkyEngine
from cloudscape_tpu_torch.models import atmosphere, compositor, packs
from cloudscape_tpu_torch.models.density import MarchParams
from cloudscape_tpu_torch.ops import noise_kernel, octmap
from cloudscape_tpu_torch.temporal import FrameData

torch.set_num_threads(min(2, torch.get_num_threads()))


def _params_fields():
    p = MarchParams.create(device="cpu")
    return {f.name: getattr(p, f.name).numpy() for f in dataclasses.fields(p)}


def _tiny_engine(device=None):
    """A tiny engine on `device` (the default when None) with a tiny noise
    pack made where the engine lives: the default 128³ pack takes over a
    minute through the plain version on the CPU."""
    kw = {} if device is None else {"device": device}
    pack_device = device or ("cuda" if torch.cuda.is_available() else "cpu")
    noise = packs.procedural_noise_pack(0, 8, 8, 16, device=pack_device)
    return CloudSkyEngine(perf=PerfConfig(32, 16, march_steps=4, light_steps=2),
                          cone_res=(4, 16, 16), noise=noise, **kw)


ENTRY_POINTS = {
    "procedural_noise_pack": lambda **kw: packs.procedural_noise_pack(
        0, base_size=4, detail_size=4, weather_size=8, **kw),
    "noise_pack_from_numpy": lambda **kw: packs.noise_pack_from_numpy(
        [np.zeros((2, 2, 2, 4))], [np.zeros((2, 2, 2, 3))], np.zeros((4, 4, 3)), **kw),
    "generate_base_noise": lambda **kw: noise_kernel.generate_base_noise(4, 0, **kw),
    "generate_detail_noise": lambda **kw: noise_kernel.generate_detail_noise(4, 0, **kw),
    "generate_weather": lambda **kw: noise_kernel.generate_weather(8, 0, **kw),
    "transmittance_lut": lambda **kw: atmosphere.transmittance_lut(8, 4, **kw),
    "MarchParams.create": lambda **kw: MarchParams.create(**kw),
    "MarchParams.from_numpy": lambda **kw: MarchParams.from_numpy(_params_fields(), **kw),
    "deband_dither": lambda **kw: compositor.deband_dither((4, 6), **kw),
    "texel_directions": lambda **kw: octmap.texel_directions(8, **kw),
    "FrameData.to_march_params": lambda **kw: FrameData().to_march_params(**kw),
    "CloudSkyEngine": lambda **kw: _tiny_engine(**kw).cloud_ring,
    "cubemap_directions": lambda **kw: engine.cubemap_directions(4, **kw),
    "cubemap_solid_angles": lambda **kw: engine.cubemap_solid_angles(4, **kw),
    # With no asset folder the pack is the procedural one, at tiny sizes here.
    "reference_noise_pack": lambda **kw: _tiny_reference_pack(**kw),
}


def _tiny_reference_pack(**kw):
    """`reference_noise_pack` where its assets are absent, with the
    procedural pack it falls back to made at tiny sizes."""
    real = packs.procedural_noise_pack
    packs.procedural_noise_pack = lambda seed, device="cuda": real(
        seed, base_size=4, detail_size=4, weather_size=8, device=device)
    try:
        return packs.reference_noise_pack("/nonexistent", **kw)
    finally:
        packs.procedural_noise_pack = real


def _tensors(out):
    """Every tensor of an entry point's result (a tensor, a dataclass of
    tensors, or of tuples of tensors)."""
    if isinstance(out, torch.Tensor):
        return [out]
    ts = []
    for f in dataclasses.fields(out):
        v = getattr(out, f.name)
        ts += list(v) if isinstance(v, tuple) else [v]
    assert ts and all(isinstance(t, torch.Tensor) for t in ts)
    return ts


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    call = ENTRY_POINTS[name]
    assert all(t.device.type == "cpu" for t in _tensors(call(device="cpu")))
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in _tensors(call()))
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            call()
