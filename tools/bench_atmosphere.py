#!/usr/bin/env python3
"""K10 and K11 (csrc/atmosphere.cu) against an older tree's, on one CUDA card.

Run from the repository root:

    python3 tools/bench_atmosphere.py --parent DIR [--variant NAME=VALUE[,NAME=VALUE]]...

DIR is an unpacked older tree (for example `git archive` of a parent commit
under `build/`). Builds this tree's kernel library and, with the same nvcc
flags, DIR's `cloudscape_tpu_torch/csrc/atmosphere.cu`; each `--variant`
builds this tree's atmosphere.cu again with the named compile-time
constants set otherwise (`kSkyLanes=16`, `kTransmittanceLanes=4`,
`kThreads=256`, ...). Then prints:

1. each build's registers (`-Xptxas -v`) and static SASS instructions a
   kernel (`cuobjdump -sass`, "not measured" where the card's machine has
   none); for a build of the one-thread-a-texel form (one step loop), the
   fewest SASS instructions and the fewest MUFU instructions a texel
   executes (`chip_smoke.least_instructions` / `least_mufu`), beside the
   frozen counts chip_smoke bounds the kernels by (`SERIAL_WORK`);
2. on the card, every build's K11 LUT and its K10 LUT (100 x 200 at both of
   chip_smoke's ATMO_SUNS, and the 5-row band) against the plain versions
   on the same inputs: bitwise, or the largest difference (the run then
   exits 1 after the timings);
3. each build's device µs with a cold L2 (`chip_smoke.device_us`) in turns
   (parent, this, the variants, then back) at K10 100 x 200, K10 5 x 200
   and K11 64 x 256, and at SCALE times as many texels (K10 100 x 3200,
   K11 64 x 4096): its two times and the share of the frozen bound
   (`chip_smoke.atmo_work`) over their mean;
4. per build, the line through each kernel's two sizes: its fixed cost a
   call (the intercept) and the share of the frozen bound its added texels
   reach (the slope);
5. the SM clock nvidia-smi reads every 100 ms while this tree's K10 keeps
   the card busy for about two seconds, beside the card's largest.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join("cloudscape_tpu_torch", "csrc", "atmosphere.cu")
KERNELS = {"sky_lut": "sky_kernel", "transmittance_lut": "transmittance_kernel"}
LANE_CONSTANTS = {"sky": "kSkyLanes", "transmittance": "kTransmittanceLanes",
                  "threads": "kThreads"}
# The wider call of each kernel, in multiples of the engine's texels.
SCALE = 16


def variant_source(text: str, spec: str) -> str:
    """This tree's atmosphere.cu with each `NAME=VALUE` of `spec` (comma
    separated) as the value of its `constexpr ... NAME = ...;`."""
    for item in spec.split(","):
        name, value = item.split("=")
        text, n = re.subn(rf"(constexpr \w+ {name} = )[^;]+;", rf"\g<1>{value};", text)
        if n != 1:
            raise SystemExit(f"--variant: no constant {name} in {SRC}")
    return text


def lanes_of(text: str):
    """{"sky", "transmittance": lanes a texel, "threads": a block} of a
    source, or None for the one-thread-a-texel form (no lane constants: the
    C entries then take no launch geometry)."""
    found = {k: re.search(rf"constexpr int {c} = (\d+);", text)
             for k, c in LANE_CONSTANTS.items()}
    return None if not all(found.values()) else {k: int(m.group(1))
                                                 for k, m in found.items()}


def build_all(parent: str, variants) -> list:
    """[(name, library, compiler output, lanes)]: this tree's kernel library,
    the parent's atmosphere.cu and each variant, the single sources built
    together, each alone with the library's flags."""
    from cloudscape_tpu_torch.ops import _cuda

    flags = [*_cuda.NVCC_FLAGS, *_cuda.SOURCE_FLAGS["atmosphere.cu"]]
    with open(os.path.join(ROOT, SRC)) as f:
        this_src = f.read()
    with open(os.path.join(parent, SRC)) as f:
        sources = [("parent", f.read())]
    sources += [(spec, variant_source(this_src, spec)) for spec in variants]
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    jobs = []
    for k, (name, text) in enumerate(sources):
        src = os.path.join(_cuda.BUILD_DIR, f"bench_atmosphere_{k}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = src[:-3] + ".so"
        jobs.append((name, lib, lanes_of(text), subprocess.Popen(
            [_cuda._nvcc(), *flags, "-shared", "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    main = _cuda.build()
    with open(main + ".log") as f:
        builds = [("this", main, f.read(), lanes_of(this_src))]
    for name, lib, lanes, proc in jobs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        builds.append((name, lib, out, lanes))
    # Parent first, then this tree, then the variants.
    return [builds[1], builds[0], *builds[2:]]


def kernel_facts(cs, path: str, log: str, serial: bool) -> dict:
    """{kernel: text} of a build: registers, static SASS and, for the
    one-thread form, the fewest instructions and MUFU a texel executes."""
    from bench_tiny3 import tool

    regs = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"Compiling entry function '(\w+)'.*?Used (\d+) registers", log, flags=re.S)}
    dump = tool("cuobjdump")
    funcs = cs.sass_functions(subprocess.run(
        [dump, "-sass", path], capture_output=True, text=True, check=True).stdout
        if dump else "")
    out = {}
    for kname, kernel in KERNELS.items():
        reg = next((n for name, n in regs.items() if kernel in name), None)
        ins = next((v for name, v in funcs.items() if kernel in name), None)
        text = f"{'not measured' if reg is None else reg} registers, "
        if ins is None:
            out[kname] = text + "SASS not measured"
            continue
        mufu = sum(op.startswith("MUFU") for _, _, op, _ in ins)
        text += f"{len(ins)} SASS instructions ({mufu} MUFU) in the kernel"
        if serial:
            steps = cs.ATMO_STEPS[kname]
            n = cs.least_instructions(ins, steps)
            m = cs.least_mufu(ins, steps)
            text += (f"; a texel executes at the least {n['per_texel']} instructions "
                     f"({n['pre']} + {steps} x {n['body']} + {n['post']}) and "
                     f"{m['per_texel']} MUFU ({m['pre']} + {steps} x {m['body']} + "
                     f"{m['post']}); frozen in chip_smoke: {cs.SERIAL_WORK[kname]}")
        out[kname] = text
    return out


def sm_clock_under_load(run, seconds: float = 2.0) -> str:
    """nvidia-smi's SM clock (MHz) sampled every 100 ms while back-to-back
    calls of run() keep the card busy for about `seconds`, and the card's
    largest SM clock."""
    import time

    import torch

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    calls = max(1, int(seconds / max(time.perf_counter() - t0, 1e-6)))
    query = ["nvidia-smi", "--format=csv,noheader,nounits"]
    smi = subprocess.Popen([*query, "--query-gpu=clocks.sm", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
    samples = sorted(int(x) for x in smi.communicate()[0].split() if x.isdigit())
    top = subprocess.run([*query, "--query-gpu=clocks.max.sm"], capture_output=True,
                         text=True).stdout.strip()
    if not samples:
        return f"not measured (largest {top} MHz)"
    return (f"{len(samples)} samples, {samples[0]}–{samples[-1]} MHz, median "
            f"{samples[len(samples) // 2]} MHz (largest {top} MHz)")


def entries(lib, lanes):
    """(K10 entry, K11 entry) of a library, typed for its form."""
    p, i = ctypes.c_void_p, ctypes.c_int
    g = [] if lanes is None else [i, i, i]
    sky, tr = lib.cs_sky_lut, lib.cs_transmittance_lut
    sky.argtypes = [p, i, i, p, i, i, i, i, *g, p, p]
    tr.argtypes = [i, i, *g, p, p]
    sky.restype = tr.restype = i
    return sky, tr


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="an unpacked older tree whose atmosphere.cu is built beside this one")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=VALUE[,NAME=VALUE]: this tree's atmosphere.cu with those "
                         "compile-time constants")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_atmosphere: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from cloudscape_tpu_torch.models import atmosphere
    from cloudscape_tpu_torch.ops import _cuda
    from cloudscape_tpu_torch.ops.atmosphere_kernel import launch_geometry

    card = cs.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    stream = _cuda.stream_handle(dev)
    builds = build_all(args.parent, args.variant)
    calls = {}
    for name, path, log, lanes in builds:
        for kname, text in kernel_facts(cs, path, log, lanes is None).items():
            print(f"{name}: {KERNELS[kname]}: {text}", flush=True)
        sky, tr = entries(_cuda.lib() if name == "this" else ctypes.CDLL(path), lanes)

        def k10(tlut, sun, rows, width=200, sky=sky, lanes=lanes, name=name):
            out = torch.empty((rows, width, 4), dtype=torch.float32, device=dev)
            g = () if lanes is None else launch_geometry(rows * width, lanes["sky"],
                                                         lanes["threads"])
            _cuda.check(sky(tlut.data_ptr(), tlut.shape[0], tlut.shape[1], sun.data_ptr(),
                            0, rows, width, 100, *g, out.data_ptr(), stream), f"K10 {name}")
            return out

        def k11(height=64, width=256, tr=tr, lanes=lanes, name=name):
            out = torch.empty((height, width, 4), dtype=torch.float32, device=dev)
            g = () if lanes is None else launch_geometry(
                height * width, lanes["transmittance"], lanes["threads"])
            _cuda.check(tr(width, height, *g, out.data_ptr(), stream), f"K11 {name}")
            return out

        calls[name] = (k10, k11)

    tlut = atmosphere._transmittance_lut_plain(device=dev)
    suns = [torch.tensor(s, dtype=torch.float32, device=dev) for s in cs.ATMO_SUNS]
    cases = [("K11 64 x 256", lambda c: c[1](), atmosphere._transmittance_lut_plain(
        device=dev))]
    for k, sun in enumerate(suns):
        for rows in (100, cs.ATMO_BAND):
            cases.append((f"K10 {rows} x 200, sun {cs.ATMO_SUNS[k]}",
                          lambda c, sun=sun, rows=rows: c[0](tlut, sun, rows),
                          atmosphere._sky_lut_rows_plain(tlut, sun, 0, rows=rows)))
    ok = True
    for what, run, want in cases:
        for name, c in calls.items():
            got = run(c)
            torch.cuda.synchronize()
            same = cs.bitwise_equal(got, want)
            ok &= same
            print(f"{name}: {what}: " + ("bitwise the plain version" if same else
                  f"NOT bitwise the plain version: max abs err "
                  f"{float((got - want).abs().max()):.3g}"), flush=True)

    order = list(calls)
    shapes = [("sky_lut", "K10 100 x 200", 100 * 200,
               lambda c: c[0](tlut, suns[0], 100)),
              ("sky_lut", f"K10 {cs.ATMO_BAND} x 200", cs.ATMO_BAND * 200,
               lambda c: c[0](tlut, suns[0], cs.ATMO_BAND)),
              ("transmittance_lut", "K11 64 x 256", 64 * 256, lambda c: c[1]()),
              ("sky_lut", f"K10 100 x {200 * SCALE}", 100 * 200 * SCALE,
               lambda c: c[0](tlut, suns[0], 100, 200 * SCALE)),
              ("transmittance_lut", f"K11 64 x {256 * SCALE}", 64 * 256 * SCALE,
               lambda c: c[1](64, 256 * SCALE))]
    mean_us = {}
    for kname, what, texels, run in shapes:
        nbytes, ins, mufu = cs.atmo_work(kname, texels,
                                         tlut.shape[0] * tlut.shape[1] if kname == "sky_lut"
                                         else 0)
        bound, by = cs.bound_us(nbytes, ins, mufu)
        times = {n: [] for n in order}
        for name in order + order[::-1]:
            times[name].append(cs.device_us(lambda: run(calls[name]),
                                            cs.KERNEL_NAMES[kname])["span_us"])
        mean_us[what] = {n: sum(v) / 2 for n, v in times.items()}
        print(f"{what}: bound {bound:.2f} us ({by}; issue term "
              f"{ins / cs.ALU_OPS_PER_S * 1e6:.2f} us, SFU term "
              f"{mufu / cs.SFU_OPS_PER_S * 1e6:.2f} us); " + "; ".join(
                  f"{n} {min(v):.2f}–{max(v):.2f} us (share {bound / (sum(v) / 2):.3f})"
                  for n, v in times.items()) + f" ({card})", flush=True)
    # The call's fixed cost and its marginal share: the line through the
    # engine's shape and SCALE times its texels.
    for kname, small, large in (("sky_lut", "K10 100 x 200", f"K10 100 x {200 * SCALE}"),
                                ("transmittance_lut", "K11 64 x 256",
                                 f"K11 64 x {256 * SCALE}")):
        texels = (100 * 200 if kname == "sky_lut" else 64 * 256) * (SCALE - 1)
        marginal_bound = texels * cs.SERIAL_WORK[kname][0] / cs.ALU_OPS_PER_S * 1e6
        print(f"{small} -> {large}: " + "; ".join(
            f"{n} fixed {(SCALE * mean_us[small][n] - mean_us[large][n]) / (SCALE - 1):.2f}"
            f" us, marginal share "
            f"{marginal_bound / (mean_us[large][n] - mean_us[small][n]):.3f}"
            for n in order) + f" ({card})", flush=True)
    print(f"SM clock under this tree's K10 100 x {200 * SCALE}: "
          f"{sm_clock_under_load(lambda: calls['this'][0](tlut, suns[0], 100, 200 * SCALE))}"
          f" ({card})", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
