"""Stream compaction: kernel K2 and its plain version.

`compact` replaces the TPU kernel `compact_indices_pallas`
(cloudscape_tpu/ops/compact_pallas.py) and the XLA `_compact_indices` it
is bitwise equal to. For a flat mask of any length n it returns

  idx  [capacity] int32: flat indices of the first `capacity` set entries,
                         ascending, the rest filled with `total`;
  rank [n]        int32: each element's exclusive rank among set entries.

A CPU tensor takes the plain version; a CUDA tensor launches
`csrc/compact.cu` or raises. `launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from cloudscape_tpu_torch.ops import _cuda

launches = 0


def compact_reference(mask, capacity: int, total: int):
    """Plain PyTorch version: `torch.nonzero` truncated or filled to
    `capacity`, plus the exclusive cumsum rank."""
    m = mask.reshape(-1).to(torch.bool)
    nz = torch.nonzero(m).reshape(-1)[:capacity].to(torch.int32)
    idx = torch.full((capacity,), total, dtype=torch.int32, device=m.device)
    idx[:nz.shape[0]] = nz
    mi = m.to(torch.int64)
    rank = (torch.cumsum(mi, 0) - mi).to(torch.int32)
    return idx, rank


def compact(mask, capacity: int, total: int):
    """mask: flat bool/uint8 tensor → (idx [capacity], rank [n]), int32."""
    global launches
    if mask.device.type == "cpu":
        return compact_reference(mask, capacity, total)
    if mask.device.type != "cuda":
        raise ValueError(f"compact: unsupported device {mask.device}")
    if mask.dim() != 1 or mask.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"compact: mask must be a flat bool/uint8 tensor, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if not mask.is_contiguous():
        raise ValueError("compact: mask must be contiguous")
    n = mask.shape[0]
    if n >= 2 ** 31 or not 0 <= capacity < 2 ** 31:
        raise ValueError(f"compact: sizes exceed int32 (n={n}, capacity={capacity})")
    lib = _cuda.lib()
    dev = mask.device
    idx = torch.empty((capacity,), dtype=torch.int32, device=dev)
    rank = torch.empty((n,), dtype=torch.int32, device=dev)
    scratch_len = lib.cs_compact_scratch(n)
    scratch = torch.empty((scratch_len,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.cs_compact(mask.data_ptr(), n, capacity, int(total),
                            idx.data_ptr(), rank.data_ptr(), scratch.data_ptr(),
                            scratch_len, _cuda.stream_handle(dev))
    _cuda.check(rc, "compact")
    launches += 1
    return idx, rank
