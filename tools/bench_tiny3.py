#!/usr/bin/env python3
"""K9 (`tiny3_kernel`, csrc/sample.cu) against an older tree's, on one CUDA card.

Run from the repository root:

    python3 tools/bench_tiny3.py --parent DIR

DIR is an unpacked older tree (for example `git archive` of a parent commit
under `build/`). Builds this tree's kernel library and, with the same nvcc
flags, DIR's `cloudscape_tpu_torch/csrc/sample.cu`; then prints:

1. each K9 instantiation's SASS instruction count (`cuobjdump -sass`) and
   registers (`-Xptxas -v`), per build, or "not measured" where the card's
   machine has no `cuobjdump`;
2. on the K9 calls of the headline's cone build (`chip_smoke.py` phase 8's
   scene at coverage 0.35: 1-ch 4³, 2³ and 1³ tiny mips, 3,801,088 samples
   a call), recorded as they ran, and on the 4³ call cut to 245,760 samples
   (the size of a pass's small calls): both builds' outputs bitwise the
   plain version's, then each build's device µs with a cold L2
   (`chip_smoke.device_us`) in turns (parent, this, this, parent): its two
   times and the call's bound (coordinates, output and the row, bytes over
   3.35 TB/s) over their mean;
3. the stream yardstick on the same planes: `torch.addcmul(qx, qy, qz)`,
   one elementwise kernel reading the same 12 B and writing the same 4 B a
   sample (the port never calls it).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_CALL = 245760


def tool(name: str):
    """A CUDA binary tool from the toolkit or Triton's copy, or None."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name),
             shutil.which(name)]
    try:
        import triton

        cands.append(os.path.join(os.path.dirname(triton.__file__), "backends",
                                  "nvidia", "bin", name))
    except ImportError:
        pass
    return next((c for c in cands if c and os.path.exists(c)), None)


def build_both(parent: str) -> dict:
    """{"this": (library, compiler output), "parent": (...)}: this tree's
    kernel library and the parent's sample.cu built alone."""
    from cloudscape_tpu_torch.ops import _cuda

    main = _cuda.build()
    with open(main + ".log") as f:
        libs = {"this": (main, f.read())}
    path = os.path.join(_cuda.BUILD_DIR, "bench_tiny3_parent.so")
    src = os.path.join(parent, "cloudscape_tpu_torch", "csrc", "sample.cu")
    done = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", path, src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for the parent's sample.cu:\n{done.stdout}")
    libs["parent"] = (path, done.stdout)
    return libs


def kernel_facts(path: str, log: str) -> dict:
    """{K9 kernel: (SASS instructions or None, registers or None)}, names
    demangled where `cu++filt` is there."""
    regs = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"Compiling entry function '(\w+)'.*?Used (\d+) registers", log, flags=re.S)
        if "tiny3_kernel" in m.group(1)}
    sass = {}
    dump = tool("cuobjdump")
    if dump:
        text = subprocess.run([dump, "-sass", path], capture_output=True,
                              text=True).stdout
        for block in re.split(r"\n\s*Function : ", text)[1:]:
            name = block.split(None, 1)[0]
            if "tiny3_kernel" in name:
                sass[name] = len(re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+\S", block,
                                            flags=re.M))
    names = sorted(set(regs) | set(sass))
    pretty = names
    filt = tool("cu++filt")
    if filt and names:
        out = subprocess.run([filt], input="\n".join(names), capture_output=True,
                             text=True).stdout.splitlines()
        pretty = out if len(out) == len(names) else names
    return {p: (sass.get(n), regs.get(n)) for n, p in zip(names, pretty)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="an unpacked older tree whose sample.cu is built beside this one")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_tiny3: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from cloudscape_tpu_torch.models.march_fast import BrickPack, build_cone_cache
    from cloudscape_tpu_torch.models.packs import procedural_noise_pack
    from cloudscape_tpu_torch.ops import _cuda, brick

    card = cs.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    libs = build_both(args.parent)
    entries = {}
    for name, (path, log) in libs.items():
        for kernel, (n_sass, n_regs) in kernel_facts(path, log).items():
            print(f"{name}: {kernel}: SASS "
                  f"{'not measured' if n_sass is None else f'{n_sass} instructions'}, "
                  f"{'registers not measured' if n_regs is None else f'{n_regs} registers'}",
                  flush=True)
        fn = (_cuda.lib() if name == "this" else ctypes.CDLL(path)).cs_sample_tiny3
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                       *[ctypes.c_void_p] * 4, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn

    def launcher(name, tv, qs):
        def call():
            out, a, held = brick.kernel_args("tiny3", tv.row, tv.row.numel(),
                                             (*tv.dims, tv.channels), tv.channels, qs)
            _cuda.check(entries[name](*a, _cuda.stream_handle(dev)), f"tiny3 {name}")
            del held
            return out
        return call

    bricks = BrickPack.from_noise(procedural_noise_pack(0, device=dev))
    params = cs.headline_params(dev, 0.35)
    _, recorded = cs.record_samples(
        lambda: build_cone_cache(params, bricks, 6, res=cs.CONE_RES, chunk=65536))
    torch.cuda.synchronize()
    calls = [(kind, tv, qs) for kname, kind, tv, qs in recorded if kname == "sample_tiny3"]
    cs.require(len(calls) == 3, f"the cone build made {len(calls)} K9 calls, not 3")
    kind4, tv4, qs4 = calls[0]
    calls.append((f"{kind4}, cut", tv4, [q.reshape(-1)[:SMALL_CALL] for q in qs4]))
    order = ("parent", "this")
    for kind, tv, qs in calls:
        want = brick.sample_tiny3_xyz_reference(tv, *qs)
        for name in order:
            got = launcher(name, tv, qs)()
            torch.cuda.synchronize()
            cs.require(cs.bitwise_equal(got, want),
                       f"tiny3 {name} on {kind}: not bitwise the plain version")
        times = {n: [] for n in order}
        for name in order + order[::-1]:
            times[name].append(cs.device_us(launcher(name, tv, qs), ("tiny3_kernel",))
                               ["span_us"])
        bound, by = cs.bound_us(cs.sample_bytes(tv, qs))
        yard = cs.device_us(lambda: torch.addcmul(*qs),
                            cs.KERNEL_NAMES["addcmul"])["span_us"]
        print(f"{kind}, {qs[0].numel()} samples: bound {bound:.2f} us ({by}); " + "; ".join(
            f"{k} {min(v):.2f}–{max(v):.2f} us (share {bound / (sum(v) / 2):.3f})"
            for k, v in times.items())
            + f"; addcmul yardstick {yard:.2f} us ({bound / yard:.3f}); bitwise the "
            f"plain version ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
