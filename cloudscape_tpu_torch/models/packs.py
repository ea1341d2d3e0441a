"""NoisePack construction (torch).

`procedural_noise_pack` generates the three noise textures through
`ops/noise_kernel.py` on the requested device — on the card, kernels K4–K6
generate them; on the CPU, their plain versions; nothing is cached on
disk. `reference_noise_pack` takes the reference's two shipped BMPs
(the detail volume and the weather map) beside a generated base volume,
and falls back to the procedural pack where they are absent.
`noise_pack_from_numpy` takes the arrays of a JAX `NoisePack` (as numpy)
unchanged, so the port can be held against the JAX engine on identical
inputs.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from cloudscape_tpu_torch.models.density import NoisePack
from cloudscape_tpu_torch.ops import noise_kernel
from cloudscape_tpu_torch.ops.sampling import build_pyramid3d
from cloudscape_tpu_torch.utils.assets import load_bmp, slice_horizontal_3d

# The reference's `cloud_sky` asset folder, looked for inside the
# repository by default; pass asset_dir to read it from elsewhere.
REFERENCE_ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "reference", "cloud_sky")


def make_noise_pack(large_volume, small_volume, weather_image) -> NoisePack:
    """Assemble a pack from level-0 volumes, building the mip chains.

    large_volume: [D,H,W,4]; small_volume: [D,H,W,3]; weather: [H,W,3]
    (weather is sampled miplessly, `weather.bmp.import: mipmaps=false`).
    All three float32 tensors on one device."""
    return NoisePack(large=build_pyramid3d(large_volume.float()),
                     small=build_pyramid3d(small_volume.float()),
                     weather=weather_image.float())


def procedural_noise_pack(seed: int = 0, base_size: int = 128,
                          detail_size: int = 32, weather_size: int = 512,
                          device="cuda") -> NoisePack:
    """Fully procedural pack, generated on `device` (K4–K6 on the card)."""
    return make_noise_pack(
        noise_kernel.generate_base_noise(base_size, seed, device=device),
        noise_kernel.generate_detail_noise(detail_size, seed, device=device),
        noise_kernel.generate_weather(weather_size, seed, device=device),
    )


def reference_noise_pack(asset_dir: str = REFERENCE_ASSET_DIR, seed: int = 0,
                         device="cuda") -> NoisePack:
    """The shipped `worlnoise.bmp` (sliced into the 32³ detail volume) and
    `weather.bmp`, with a generated 128³ base volume (the reference's
    `perlworlnoise.tga` is not shipped), on `device`. Without the two BMPs
    in asset_dir, the fully procedural `procedural_noise_pack(seed)`."""
    worl_path = os.path.join(asset_dir, "worlnoise.bmp")
    weather_path = os.path.join(asset_dir, "weather.bmp")
    if not (os.path.exists(worl_path) and os.path.exists(weather_path)):
        return procedural_noise_pack(seed, device=device)
    small = torch.from_numpy(slice_horizontal_3d(load_bmp(worl_path), 32))
    weather = torch.from_numpy(load_bmp(weather_path))
    return make_noise_pack(noise_kernel.generate_base_noise(128, seed, device=device),
                           small.to(device), weather.to(device))


def noise_pack_from_numpy(large_levels: Sequence[np.ndarray],
                          small_levels: Sequence[np.ndarray],
                          weather: np.ndarray, device="cuda") -> NoisePack:
    """A pack from the mip levels of a JAX `NoisePack`, taken as they are."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    return NoisePack(large=tuple(t(a) for a in large_levels),
                     small=tuple(t(a) for a in small_levels),
                     weather=t(weather))
