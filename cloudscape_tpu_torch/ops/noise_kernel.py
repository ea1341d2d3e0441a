"""Procedural noise volumes: kernels K4–K6 and their plain versions.

The counterpart of `cloudscape_tpu.ops.noise_pallas`. Each generator takes
(size, seed, device) and returns float32 channel-interleaved texels:

  generate_base_noise    K4  [size, size, size, 4]  Perlin-Worley base volume
  generate_detail_noise  K5  [size, size, size, 3]  Worley detail volume
  generate_weather       K6  [size, size, 3]        weather map

A CPU device takes the plain version, the `ops/noise.py` generators; a
CUDA device launches `csrc/noise.cu` or raises; any other device raises
ValueError. `launches` counts kernel launches per kernel.
"""

from __future__ import annotations

import torch

from cloudscape_tpu_torch.ops import _cuda
from cloudscape_tpu_torch.ops import noise

launches = {"base": 0, "detail": 0, "weather": 0}


def _count_launch(name: str) -> None:
    """Add one to `launches[name]`, under `_cuda.COUNT_LOCK` (shards launch
    from threads)."""
    if _cuda.capturing:
        return
    with _cuda.COUNT_LOCK:
        launches[name] += 1


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"noise generators: unsupported device {dev}")
    return dev


def _launch(name: str, entry: str, shape, size: int, seed: int, dev):
    """Allocate the output and launch one noise kernel on `dev`'s current
    stream."""
    if size < 1:
        raise ValueError(f"noise generators: size {size} < 1")
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(_cuda.lib(), entry)(out.data_ptr(), size, seed & 0xFFFFFFFF,
                                         _cuda.stream_handle(dev))
    _cuda.check(rc, entry)
    _count_launch(name)
    return out


def generate_base_noise(size: int = 128, seed: int = 0, device="cuda"):
    """The Perlin-Worley base volume, [size]³ × RGBA (kernel K4)."""
    dev = _device(device)
    if dev.type == "cpu":
        return noise.generate_base_noise(size, seed, device=dev)
    return _launch("base", "cs_noise_base", (size, size, size, 4), size, seed, dev)


def generate_detail_noise(size: int = 32, seed: int = 0, device="cuda"):
    """The Worley detail volume, [size]³ × 3 (kernel K5)."""
    dev = _device(device)
    if dev.type == "cpu":
        return noise.generate_detail_noise(size, seed, device=dev)
    return _launch("detail", "cs_noise_detail", (size, size, size, 3), size, seed,
                   dev)


def generate_weather(size: int = 512, seed: int = 0, device="cuda"):
    """The weather map, [size]² × (type, spare, coverage) (kernel K6)."""
    dev = _device(device)
    if dev.type == "cpu":
        return noise.generate_weather(size, seed, device=dev)
    return _launch("weather", "cs_noise_weather", (size, size, 3), size, seed, dev)
