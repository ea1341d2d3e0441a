"""The serving tick's display composite: kernel K12 and the dispatch to its
plain version.

  composite_display_pair  K12  [..., 3]  `models/compositor.py`'s
      `composite_display` over the engine's form: 8-channel clamp
      display-pair textures (`Texture2D`) and the raw transmittance LUT

A CPU tensor takes the plain version, `models/compositor.py`'s
`_composite_display_plain` (the eager body); a CUDA one launches
`csrc/composite.cu` or raises; any other device raises ValueError. The
sun, its disk scale and `blend_amount` travel as launch arguments, so the
sun must be host values: reading a CUDA tensor would wait for the card.
`launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from cloudscape_tpu_torch.ops import _cuda
from cloudscape_tpu_torch.ops.brick import Texture2D, weight_strides
from cloudscape_tpu_torch.utils.profiling import span

launches = {"composite": 0}


def _count_launch(name: str) -> None:
    """Add one to `launches[name]`, under `_cuda.COUNT_LOCK`; nothing while
    a CUDA graph is captured."""
    if _cuda.capturing:
        return
    with _cuda.COUNT_LOCK:
        launches[name] += 1


def _plain():
    """`models/compositor.py`, which holds the plain version (it imports
    this module, so the import waits for the first CPU call)."""
    from cloudscape_tpu_torch.models import compositor

    return compositor


def _host_sun(sun_dir) -> tuple:
    """The sun direction as three Python floats of its float32 values; a
    sequence, an array or a CPU tensor. A CUDA tensor raises: reading it
    would wait for the card."""
    if isinstance(sun_dir, torch.Tensor) and sun_dir.device.type != "cpu":
        raise ValueError(f"composite: sun_dir must be host values, not a tensor on "
                         f"{sun_dir.device} (reading it would wait for the card)")
    sun = torch.as_tensor(sun_dir, dtype=torch.float32).reshape(-1)
    if sun.numel() != 3:
        raise ValueError(f"composite: sun_dir has {sun.numel()} values, not 3")
    return tuple(sun.tolist())


def _pair_geom(what: str, tex, dev) -> tuple:
    """(h, w, clamp, sy, sx) of an 8-channel clamp pair texture on `dev`;
    raises on what K12 does not take."""
    if not isinstance(tex, Texture2D) or tex.channels != 8:
        raise ValueError(f"composite: the {what} pair must be an 8-channel Texture2D")
    t = tex.texels
    if t.device != dev or t.dtype != torch.float32:
        raise ValueError(f"composite: the {what} pair is {t.dtype} on {t.device}, "
                         f"not float32 on {dev}")
    if tuple(t.shape) != (*tex.dims, 8) or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"composite: the {what} pair must be a contiguous, 16-B "
                         f"aligned [{tex.dims[0]}, {tex.dims[1]}, 8] image")
    if tex.wrap != "clamp":
        raise ValueError(f"composite: the {what} pair wraps {tex.wrap!r}; K12 takes the "
                         f"engine's clamp pairs")
    return (*tex.dims, 1, *weight_strides(2, 8))


def kernel_args(eyedir, cloud_pair, sky_pair, tlut, sun_dir, sun_disk_scale,
                blend_amount, deband: bool):
    """(output, arguments, held) of one K12 call: the output [..., 3]
    float32, allocated on eyedir's device; the C entry's arguments but the
    stream (directions, pixels, geometry, the pair textures, the LUT, the
    scalars sun x, y, z, sun_disk_scale, blend_amount, deband, output);
    and the tensors they point into, to be held until the launch. The
    geometry: each pair's (h, w, clamp, weight strides; the kernel has 1 and
    `WEIGHT_STRIDES`' (3, 3) built in and checks them), the LUT's (h, w,
    channels) and the image's last two dims (width, height: the dither's
    lattice; height 1 for a row of pixels). Raises on what the kernel does
    not take."""
    dev = eyedir.device
    if eyedir.dtype != torch.float32 or eyedir.dim() < 1 or eyedir.shape[-1] != 3:
        raise ValueError(f"composite: eyedir must be float32 [..., 3], not "
                         f"{eyedir.dtype} {tuple(eyedir.shape)}")
    n = eyedir.numel() // 3
    if 3 * n >= 1 << 31:
        raise ValueError(f"composite: {n} pixels is past the kernel's 32-bit indices")
    geom = _pair_geom("cloud", cloud_pair, dev) + _pair_geom("sky", sky_pair, dev)
    if not isinstance(tlut, torch.Tensor) or tlut.dim() != 3 or tlut.shape[-1] < 3 \
            or tlut.dtype != torch.float32 or tlut.device != dev:
        raise ValueError("composite: the transmittance LUT must be a float32 [h, w, "
                         f"C >= 3] image on {dev}")
    if not isinstance(deband, bool):
        raise ValueError(f"composite: deband must be a bool, not {deband!r}")
    image = tuple(eyedir.shape[:-1])
    width = image[-1] if image else 1
    height = image[-2] if len(image) >= 2 else 1
    geom += (*tlut.shape, width, height)
    held = (eyedir.contiguous(), tlut.contiguous())
    scalars = (*_host_sun(sun_dir), float(sun_disk_scale), float(blend_amount))
    out = torch.empty(image + (3,), dtype=torch.float32, device=dev)
    args = (held[0].data_ptr(), n, (ctypes.c_int * len(geom))(*geom),
            cloud_pair.texels.data_ptr(), sky_pair.texels.data_ptr(), held[1].data_ptr(),
            (ctypes.c_float * len(scalars))(*scalars), int(deband), out.data_ptr())
    return out, args, held


def composite_display_pair(eyedir, cloud_pair, sky_pair, tlut, sun_dir,
                           sun_disk_scale, blend_amount=0.0, *, deband: bool = False):
    """The display composite over the engine's form (kernel K12): eyedir
    [..., 3] view directions, the cycle's 8-channel cloud and sky pair
    textures, the raw [h, w, 4] transmittance LUT, the sun direction (host
    values on the card), the sun disk scale and blend_amount → [..., 3]
    linear HDR. On the card one launch on the current stream, under the
    span `composite.kernel`; it copies nothing to the card and waits for
    nothing."""
    dev = eyedir.device
    if dev.type == "cpu":
        return _plain()._composite_display_plain(
            eyedir, cloud_pair, sky_pair, tlut, sun_dir, sun_disk_scale, blend_amount,
            deband=deband)
    if dev.type != "cuda":
        raise ValueError(f"composite: unsupported device {dev}")
    out, args, held = kernel_args(eyedir, cloud_pair, sky_pair, tlut, sun_dir,
                                  sun_disk_scale, blend_amount, deband)
    if out.numel() == 0:
        return out
    with span("composite.kernel"), torch.cuda.device(dev):
        rc = _cuda.lib().cs_composite(*args, _cuda.stream_handle(dev))
    del held
    _cuda.check(rc, "cs_composite")
    _count_launch("composite")
    return out
