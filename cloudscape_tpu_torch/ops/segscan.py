"""Segmented inclusive prefix sum: kernel K3 and its plain version.

`segscan` replaces the TPU kernel `segscan_sum_pallas`
(cloudscape_tpu/ops/segscan_pallas.py) and the XLA `associative_scan` over
the `seg_sum` monoid that the JAX march runs off the TPU. For flat f32
values and head flags of any length n:

  out[i] = values[i] + (heads[i] ? 0 : out[i - 1]),   out[-1] = 0.

A CPU tensor takes the plain version; a CUDA tensor launches
`csrc/segscan.cu` or raises. `launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from cloudscape_tpu_torch.ops import _cuda

launches = 0


def segscan_reference(values, heads):
    """Plain PyTorch version: an f64 cumsum minus the cumsum at each
    element's segment start (the latest head at or before it, by cummax),
    cast to f32. f64 keeps the difference of two global partial sums free of
    the f32 cancellation a plain cumsum would suffer; a head element is its
    value, bit for bit."""
    v = values.reshape(-1)
    h = heads.reshape(-1).to(torch.bool)
    v64 = v.to(torch.float64)
    excl = torch.cumsum(v64, 0) - v64
    pos = torch.arange(v.shape[0], device=v.device)
    start = torch.cummax(torch.where(h, pos, 0), 0).values
    out = (v64 + (excl - excl[start])).to(torch.float32)
    return torch.where(h, v, out)


def segscan(values, heads):
    """values: flat f32 tensor, heads: flat bool/uint8 tensor of the same
    length → [n] f32 segmented inclusive prefix sum."""
    global launches
    if values.device.type == "cpu":
        return segscan_reference(values, heads)
    if values.device.type != "cuda":
        raise ValueError(f"segscan: unsupported device {values.device}")
    if values.dim() != 1 or values.dtype != torch.float32:
        raise ValueError(f"segscan: values must be a flat float32 tensor, got "
                         f"{values.dtype} {tuple(values.shape)}")
    if heads.shape != values.shape or heads.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"segscan: heads must be bool/uint8 {tuple(values.shape)}, "
                         f"got {heads.dtype} {tuple(heads.shape)}")
    if heads.device != values.device:
        raise ValueError(f"segscan: heads on {heads.device}, values on {values.device}")
    if not (values.is_contiguous() and heads.is_contiguous()):
        raise ValueError("segscan: values and heads must be contiguous")
    n = values.shape[0]
    dev = values.device
    out = torch.empty_like(values)
    if n == 0:
        return out
    lib = _cuda.lib()
    scratch_len = lib.cs_segscan_scratch(n)
    scratch = torch.empty((scratch_len,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.cs_segscan(values.data_ptr(), heads.data_ptr(), n, out.data_ptr(),
                            scratch.data_ptr(), scratch_len, _cuda.stream_handle(dev))
    _cuda.check(rc, "segscan")
    launches += 1
    return out
