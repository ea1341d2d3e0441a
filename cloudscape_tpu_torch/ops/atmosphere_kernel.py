"""The atmosphere LUTs: kernels K10–K11 and the dispatch to their plain versions.

The port's own kernels for code the JAX package leaves to XLA (its
`models/atmosphere.py` is jitted eager math, no pallas_call):

  sky_lut_rows       K10  [rows, width, 4]    a row band of the sky-view LUT
  transmittance_lut  K11  [height, width, 4]  the sun-transmittance LUT

A CPU tensor (or device) takes the plain version, `models/atmosphere.py`'s
eager code; a CUDA one launches `csrc/atmosphere.cu` or raises; any other
device raises ValueError. `launches` counts kernel launches per kernel.
"""

from __future__ import annotations

import torch

from cloudscape_tpu_torch.ops import _cuda

launches = {"sky": 0, "transmittance": 0}

# csrc/atmosphere.cu's kThreads and kSkyLanes / kTransmittanceLanes, and the
# marches' steps: a block of THREADS threads takes THREADS // G texels, G =
# LANES[kernel] lanes a texel, lane j its steps j, j + G, j + 2G, ...
THREADS = 128
LANES = {"sky": 8, "transmittance": 8}
STEPS = {"sky": 30, "transmittance": 40}


def launch_geometry(texels: int, lanes: int,
                    threads: int = THREADS) -> tuple[int, int, int]:
    """(blocks, texels a block, lanes a texel) of a K10 / K11 launch over
    `texels` texels with `lanes` lanes a texel in blocks of `threads`; the
    C entry refuses any other geometry."""
    per_block = threads // lanes
    return -(-texels // per_block), per_block, lanes


def thread_work(geometry, texels: int, steps: int, block: int, thread: int):
    """(texel, its steps) that thread `thread` of block `block` marches, as
    the kernels deal them out (thread t is lane t // per_block of the block's
    texel t % per_block), or None for a lane of a texel past the last (it
    marches the last texel and stores nothing)."""
    _, per_block, lanes = geometry
    lane, slot = divmod(thread, per_block)
    texel = block * per_block + slot
    if texel >= texels:
        return None
    return texel, range(lane, steps, lanes)


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
        raise ValueError(f"atmosphere LUTs: unsupported device {dev}")
    return dev


def _plain():
    """`models/atmosphere.py`, which holds the plain versions (it imports
    this module, so the import waits for the first CPU call)."""
    from cloudscape_tpu_torch.models import atmosphere

    return atmosphere


def sky_lut_rows(tlut, sun_direction, row0: int, rows: int, width: int, height: int):
    """Rows [row0, row0 + rows) of the [height, width, 4] sky-view LUT against
    the transmittance LUT `tlut` [h, w, 4] (kernel K10). `sun_direction` is
    the world (y-up) sun vector, a tensor or a sequence of 3."""
    dev = _device(tlut.device)
    if dev.type == "cpu":
        return _plain()._sky_lut_rows_plain(tlut, sun_direction, row0, rows=rows,
                                            width=width, height=height)
    if tlut.dtype != torch.float32 or tlut.dim() != 3 or tlut.shape[-1] != 4:
        raise ValueError(f"sky_lut_rows: the transmittance LUT must be float32 "
                         f"[h, w, 4], not {tlut.dtype} {tuple(tlut.shape)}")
    if rows < 0 or width < 1 or height < 1:
        raise ValueError(f"sky_lut_rows: rows {rows}, width {width}, height {height}")
    tlut = tlut.contiguous()
    if tlut.data_ptr() % 16:
        raise ValueError("sky_lut_rows: the transmittance LUT must be 16-B aligned")
    sun = torch.as_tensor(sun_direction, dtype=torch.float32, device=dev)
    sun = sun.reshape(-1).contiguous()
    if sun.numel() != 3:
        raise ValueError(f"sky_lut_rows: sun_direction has {sun.numel()} values, not 3")
    out = torch.empty((rows, width, 4), dtype=torch.float32, device=dev)
    if rows == 0:
        return out
    geometry = launch_geometry(rows * width, LANES["sky"])
    with torch.cuda.device(dev):
        rc = _cuda.lib().cs_sky_lut(tlut.data_ptr(), tlut.shape[0], tlut.shape[1],
                                    sun.data_ptr(), row0, rows, width, height,
                                    *geometry, out.data_ptr(), _cuda.stream_handle(dev))
    _cuda.check(rc, "cs_sky_lut")
    _count_launch("sky")
    return out


def transmittance_lut(width: int, height: int, device):
    """The [height, width, 4] spectral sun-transmittance LUT (kernel K11)."""
    dev = _device(device)
    if dev.type == "cpu":
        return _plain()._transmittance_lut_plain(width, height, device=dev)
    if width < 1 or height < 1:
        raise ValueError(f"transmittance_lut: width {width}, height {height}")
    out = torch.empty((height, width, 4), dtype=torch.float32, device=dev)
    geometry = launch_geometry(width * height, LANES["transmittance"])
    with torch.cuda.device(dev):
        rc = _cuda.lib().cs_transmittance_lut(width, height, *geometry, out.data_ptr(),
                                              _cuda.stream_handle(dev))
    _cuda.check(rc, "cs_transmittance_lut")
    _count_launch("transmittance")
    return out
