"""Stream compaction: kernel K2 and its plain version.

`compact` replaces the TPU kernel `compact_indices_pallas`
(cloudscape_tpu/ops/compact_pallas.py) and the XLA `_compact_indices` it
is bitwise equal to. For a flat mask of any length n it returns

  idx  [capacity] int32: flat indices of the first `capacity` set entries,
                         ascending, the rest filled with `total`;
  rank [n]        int32: each element's exclusive rank among set entries,
                         only when `with_rank` asks for it (else None).

A CPU tensor takes the plain version; a CUDA tensor launches
`csrc/compact.cu` or raises. `launches` counts kernel launches and `sizes`
them by element count.
"""

from __future__ import annotations

import collections

import torch

from cloudscape_tpu_torch.ops import _cuda

launches = 0
# The launches by their element count, mask elements → launches.
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

# The launch of csrc/compact.cu: blocks of 256 threads, as many on one SM
# as its launch bounds promise, the fewest 16-byte words a block takes
# before another block is worth it, and the most shared memory a block
# stashes its words in (a longer range is read from the mask twice; the
# kernel adds 16 KB for a round's slots, and four blocks share the SM's
# 228 KB).
BLOCKS_PER_SM = 4
MIN_WORDS_PER_BLOCK = 256
STASH_BYTES = 36 * 1024


def compact_plan(n: int, misalign: int, sms: int):
    """(words, words per block, blocks, stash bytes) of one K2
    launch over a mask of n bytes that starts `misalign` bytes past a 16-B
    boundary. The kernel sees the mask as 16-byte words from that boundary
    (word w holds elements 16w − misalign … 16w − misalign + 15) and gives
    block b words [b·wpb, min(words, (b + 1)·wpb)): at most BLOCKS_PER_SM
    blocks per SM, so the cooperative launch's blocks are all resident."""
    words = (misalign + n + 15) // 16 if n else 0
    blocks = max(1, min(BLOCKS_PER_SM * sms, -(-words // MIN_WORDS_PER_BLOCK)))
    wpb = -(-words // blocks)
    stash = 16 * wpb if 16 * wpb <= STASH_BYTES else 0
    return words, wpb, blocks, stash


def compact_reference(mask, capacity: int, total: int, with_rank: bool = True):
    """Plain PyTorch version: `torch.nonzero` truncated or filled to
    `capacity`, plus the exclusive cumsum rank when `with_rank`."""
    m = mask.reshape(-1).to(torch.bool)
    nz = torch.nonzero(m).reshape(-1)[:capacity].to(torch.int32)
    idx = torch.full((capacity,), total, dtype=torch.int32, device=m.device)
    idx[:nz.shape[0]] = nz
    if not with_rank:
        return idx, None
    mi = m.to(torch.int64)
    rank = (torch.cumsum(mi, 0) - mi).to(torch.int32)
    return idx, rank


def compact(mask, capacity: int, total: int, with_rank: bool = True):
    """mask: flat bool/uint8 tensor → (idx [capacity], rank [n] or None),
    int32."""
    if mask.device.type == "cpu":
        return compact_reference(mask, capacity, total, with_rank)
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
    dev = mask.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, wpb, blocks, stash = compact_plan(n, mask.data_ptr() % 16, sms)
    idx = torch.empty((capacity,), dtype=torch.int32, device=dev)
    rank = torch.empty((n,), dtype=torch.int32, device=dev) if with_rank else None
    counts = torch.empty((blocks,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _cuda.lib().cs_compact(
            mask.data_ptr(), n, capacity, int(total), wpb, blocks, stash,
            idx.data_ptr(), rank.data_ptr() if with_rank else None,
            counts.data_ptr(), blocks, _cuda.stream_handle(dev))
    _cuda.check(rc, "compact")
    _count_launch(n)
    return idx, rank
