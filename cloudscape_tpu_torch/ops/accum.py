"""Phase-3 accumulation of the dense march: kernel K1 and its plain version.

`accumulate` replaces the TPU kernel `accumulate_pallas`
(cloudscape_tpu/ops/accum_pallas.py). Inputs are pre-folded so the kernel
needs no per-sample constants:

  A     = −density·ss·t     [n, steps]  (dt = exp(A); A < 0 ⟺ t > 0)
  cd3   = −density·lss·3·cd [n, steps]  (beers = exp(cd3), powder = 1 − exp(2·cd3))
  hf                        [n, steps]  height fraction
  phase                     [n]         per-ray phase
  above                     [n] bool    rays below the horizon output 0
  scal                      [12]        sun rgb, ambient rgb, ground rgb, pad

Output [n, 4] = (L rgb, alpha). `occ = (A < 0)` as in the TPU kernel; it
differs from the march's `t / max(1e-7, t)` only for 0 < t < 1e-7, where a
sample contributes ≤ ~1e-5 of a radiance unit (accum_pallas.py:24-28).

A CPU tensor takes the plain version; a CUDA tensor launches
`csrc/accum.cu` or raises. `launches` counts kernel launches and `sizes`
them by element count.
"""

from __future__ import annotations

import collections

import torch

from cloudscape_tpu_torch.ops import _cuda

launches = 0
# The launches by their element count, samples (n · steps) → launches.
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


def accumulate_reference(A, cd3, hf, phase, above, scal):
    """Plain PyTorch version of the kernel (the correctness reference)."""
    scal = scal.reshape(-1)
    dt = torch.exp(A)
    inc = torch.cumprod(dt, dim=1)
    t_prefix = torch.cat([torch.ones_like(dt[:, :1]), inc[:, :-1]], dim=1)
    occ = (A < 0.0).to(torch.float32)
    beers = torch.exp(cd3)
    powder = 1.0 - torch.exp(2.0 * cd3)
    bt_phase = 2.0 * beers * powder * occ * phase[:, None]
    x = torch.clamp(hf, 0.0, 1.0)
    sm = x * x * (3.0 - 2.0 * x)
    shared = t_prefix * (1.0 - dt) * occ
    L = [torch.sum(shared * ((scal[6 + c] + (scal[3 + c] - scal[6 + c]) * sm)
                             + bt_phase * scal[c]), dim=1)
         for c in range(3)]
    alpha = torch.clamp(1.0 - inc[:, -1], 0.0, 1.0)
    out = torch.stack(L + [alpha], dim=-1)
    return torch.where(above[:, None], out, 0.0)


def _check_inputs(A, cd3, hf, phase, above, scal):
    n, steps = A.shape
    dev = A.device
    for name, t, shape, dtype in (
            ("A", A, (n, steps), torch.float32),
            ("cd3", cd3, (n, steps), torch.float32),
            ("hf", hf, (n, steps), torch.float32),
            ("phase", phase, (n,), torch.float32),
            ("above", above, (n,), torch.bool),
            ("scal", scal, (12,), torch.float32)):
        if t.device != dev:
            raise ValueError(f"accumulate: {name} on {t.device}, A on {dev}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"accumulate: {name} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"accumulate: {name} must be contiguous")


def lanes_per_ray(steps: int) -> int:
    """Lanes of a warp that share one ray in `csrc/accum.cu`: lane j of the
    group takes steps 4j..4j+3 of each window of 4·lanes steps. The smallest
    power of two whose window holds the row, at most 32 (a longer row takes
    several windows)."""
    lanes = 1
    while lanes < 32 and 4 * lanes < steps:
        lanes *= 2
    return lanes


def vector_loads(steps: int, *planes) -> bool:
    """Whether the kernel can load each lane's 4 steps with one 16-byte load:
    every row starts 16-B aligned."""
    return steps % 4 == 0 and all(p.data_ptr() % 16 == 0 for p in planes)


def accumulate(A, cd3, hf, phase, above, scal):
    """[n, steps] folded planes + per-ray phase/above + [12] scalars →
    [n, 4] (L rgb, alpha)."""
    if A.device.type == "cpu":
        return accumulate_reference(A, cd3, hf, phase, above, scal)
    if A.device.type != "cuda":
        raise ValueError(f"accumulate: unsupported device {A.device}")
    _check_inputs(A, cd3, hf, phase, above, scal)
    n, steps = A.shape
    out = torch.empty((n, 4), dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        rc = _cuda.lib().cs_accumulate(
            A.data_ptr(), cd3.data_ptr(), hf.data_ptr(), phase.data_ptr(),
            above.data_ptr(), scal.data_ptr(), out.data_ptr(), n, steps,
            lanes_per_ray(steps), int(vector_loads(steps, A, cd3, hf)),
            _cuda.stream_handle(A.device))
    _cuda.check(rc, "accumulate")
    _count_launch(A.numel())
    return out
