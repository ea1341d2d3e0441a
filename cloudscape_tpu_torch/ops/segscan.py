"""Segmented inclusive prefix sum: kernel K3 and its plain version.

`segscan` replaces the TPU kernel `segscan_sum_pallas`
(cloudscape_tpu/ops/segscan_pallas.py) and the XLA `associative_scan` over
the `seg_sum` monoid that the JAX march runs off the TPU. For f32 values
`[n]` or `[k, n]` (1 ≤ k ≤ 4 rows that share one row of n head flags):

  out[..., i] = values[..., i] + (heads[i] ? 0 : out[..., i - 1]),
  out[..., -1] = 0.

A CPU tensor takes the plain version; a CUDA tensor launches
`csrc/segscan.cu` (one launch per call, whatever k) or raises.
`launches` counts kernel launches and `sizes` them by element count.
"""

from __future__ import annotations

import collections

import torch

from cloudscape_tpu_torch.ops import _cuda

launches = 0
# The launches by their element count, values (rows · n) → launches.
sizes = collections.Counter()


def _count_launch(n: int) -> None:
    """Add one to `launches` and to `sizes[n]`, under `_cuda.COUNT_LOCK`
    (shards launch from threads)."""
    global launches
    if _cuda.capturing:
        return
    with _cuda.COUNT_LOCK:
        launches += 1
        sizes[n] += 1

# The launch of csrc/segscan.cu: blocks of 256 threads, as many on one SM
# as its launch bounds promise, each scanning rounds of BLOCK_ROUND
# elements (8 warps × 32 lanes × 4), and the most shared memory a block
# keeps its scanned rows in (a longer range is loaded and scanned again;
# four blocks share the SM's 228 KB).
BLOCKS_PER_SM = 4
BLOCK_ROUND = 1024
STASH_BYTES = 48 * 1024
MAX_ROWS = 4


def segscan_plan(n: int, rows: int, sms: int):
    """(rounds, blocks, stash bytes) of one K3 launch over [rows, n]: block
    b scans elements [b·E, min(n, (b + 1)·E)), E = rounds·BLOCK_ROUND, with
    at most BLOCKS_PER_SM blocks per SM, so the cooperative launch's blocks
    are all resident. The ranges depend on n alone, so a row of a [k, n]
    call and the 1-D call on that row add the same floats in the same
    order."""
    rounds = max(1, -(-n // (BLOCKS_PER_SM * sms * BLOCK_ROUND)))
    per_block = rounds * BLOCK_ROUND
    blocks = max(1, -(-n // per_block))
    stash = 4 * rows * per_block
    return rounds, blocks, stash if stash <= STASH_BYTES else 0


def segscan_reference(values, heads):
    """Plain PyTorch version: an f64 cumsum minus the cumsum at each
    element's segment start (the latest head at or before it, by one cummax
    that the rows share), along the last axis, cast to f32. f64 keeps the
    difference of two global partial sums free of the f32 cancellation a
    plain cumsum would suffer; a head element is its value, bit for bit."""
    h = heads.to(torch.bool)
    v64 = values.to(torch.float64)
    excl = torch.cumsum(v64, -1) - v64
    pos = torch.arange(h.shape[0], device=h.device)
    start = torch.cummax(torch.where(h, pos, 0), 0).values
    out = (v64 + (excl - excl[..., start])).to(torch.float32)
    return torch.where(h, values, out)


def _check(values, heads) -> None:
    if (values.dtype != torch.float32 or values.dim() not in (1, 2)
            or (values.dim() == 2 and not 1 <= values.shape[0] <= MAX_ROWS)):
        raise ValueError(f"segscan: values must be float32 [n] or [k, n] with "
                         f"1 <= k <= {MAX_ROWS}, got {values.dtype} "
                         f"{tuple(values.shape)}")
    if (heads.dim() != 1 or heads.shape[0] != values.shape[-1]
            or heads.dtype not in (torch.bool, torch.uint8)):
        raise ValueError(f"segscan: heads must be bool/uint8 [{values.shape[-1]}], "
                         f"got {heads.dtype} {tuple(heads.shape)}")
    if heads.device != values.device:
        raise ValueError(f"segscan: heads on {heads.device}, values on {values.device}")


def segscan(values, heads):
    """values: f32 [n] or [k, n] (1 ≤ k ≤ 4); heads: bool/uint8 [n] → the
    segmented inclusive prefix sum of each row, f32 of values' shape."""
    _check(values, heads)
    if values.device.type == "cpu":
        return segscan_reference(values, heads)
    if values.device.type != "cuda":
        raise ValueError(f"segscan: unsupported device {values.device}")
    if not (values.is_contiguous() and heads.is_contiguous()):
        raise ValueError("segscan: values and heads must be contiguous")
    rows = 1 if values.dim() == 1 else values.shape[0]
    n = values.shape[-1]
    dev = values.device
    out = torch.empty_like(values)
    if n == 0:
        return out
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rounds, blocks, stash = segscan_plan(n, rows, sms)
    scratch_len = (rows + 1) * blocks
    scratch = torch.empty((scratch_len,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _cuda.lib().cs_segscan(
            values.data_ptr(), heads.data_ptr(), rows, n, rounds, blocks, stash,
            out.data_ptr(), scratch.data_ptr(), scratch_len, _cuda.stream_handle(dev))
    _cuda.check(rc, "segscan")
    _count_launch(values.numel())
    return out
