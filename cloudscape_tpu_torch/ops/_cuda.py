"""Build and load the hand-written CUDA kernels of `cloudscape_tpu_torch/csrc`.

The kernels are plain CUDA C++ with a C interface, compiled at first use
with `nvcc -gencode arch=compute_90a,code=sm_90a -O3`, one nvcc per source,
all started together, then linked into one shared library and loaded with
ctypes. The library goes into `build/cloudscape_tpu_torch/`
beside the package, named by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one loads the earlier build. Nothing here
runs at import: a machine without `nvcc` imports the package and uses the
kernels' plain PyTorch versions for CPU tensors.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "cloudscape_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Flags of one source on top of NVCC_FLAGS. atmosphere.cu and composite.cu
# round as their plain versions' eager torch ops do, one product or sum at a
# time, so nvcc must not contract a*b + c into an FMA there (their headers
# say why).
SOURCE_FLAGS = {"atmosphere.cu": ["-fmad=false"], "composite.cu": ["-fmad=false"]}

_LOCK = threading.Lock()
_LIB = None
# The lock of the kernel wrappers' launch counts (`launches`). The kernels
# are called through ctypes, which releases the interpreter lock, and a
# mesh's shards call them from threads of their own (`parallel/sharding.py`),
# so a bare `launches += 1` could lose a count.
COUNT_LOCK = threading.Lock()
# True while a CUDA graph is captured (`tile_graphs.V3TileGraphs.capture`,
# on the thread of a card engine without a mesh): a wrapper's call then
# records its kernel into the graph and launches nothing, so it counts
# nothing. A graph's replay launches its kernels through no wrapper, so the
# counts are the launches the wrappers made.
capturing = False


def _nvcc() -> str:
    candidates = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                               "bin", "nvcc"), shutil.which("nvcc")]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels of cloudscape_tpu_torch cannot be built")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path() -> str:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        h.update(" ".join(SOURCE_FLAGS.get(os.path.basename(src), [])).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libcloudscape_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if their library is not built yet; returns its
    path. Each source compiles in its own nvcc process, all at once; the
    objects are then linked. The compiler's output (registers, spills per
    kernel) is kept in `<library>.log`. Raises on a failed build."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(os.path.basename(src), []),
               "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    objs = [obj for _, obj, _ in jobs]
    if not failed:
        cmd = [nvcc, "-shared", "-o", f"{tmp}.so", *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(proc.stderr)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    with open(path + ".log", "w") as f:
        f.write("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(f"{tmp}.so", path)
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(build())
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            handle.cs_accumulate.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
            handle.cs_accumulate.restype = i
            handle.cs_compact.argtypes = [p, ll, i, i, ll, i, i, p, p, p, i, p]
            handle.cs_compact.restype = i
            handle.cs_segscan.argtypes = [p, p, i, ll, i, i, i, p, p, ll, p]
            handle.cs_segscan.restype = i
            for fn in (handle.cs_noise_base, handle.cs_noise_detail,
                       handle.cs_noise_weather):
                fn.argtypes = [p, i, ctypes.c_uint, p]
                fn.restype = i
            geom = ctypes.POINTER(i)
            for fn in (handle.cs_sample_brick3, handle.cs_sample_tiny3,
                       handle.cs_sample_tex3):
                fn.argtypes = [p, i, geom, p, p, p, p, ll, p]
                fn.restype = i
            for fn in (handle.cs_sample_brick2, handle.cs_sample_tex2):
                fn.argtypes = [p, i, geom, p, p, p, ll, p]
                fn.restype = i
            handle.cs_sky_lut.argtypes = [p, i, i, p, i, i, i, i, i, i, i, p, p]
            handle.cs_sky_lut.restype = i
            handle.cs_transmittance_lut.argtypes = [i, i, i, i, i, p, p]
            handle.cs_transmittance_lut.restype = i
            handle.cs_composite.argtypes = [p, ll, geom, p, p, p,
                                            ctypes.POINTER(ctypes.c_float), i, p, p]
            handle.cs_composite.restype = i
            _LIB = handle
    return _LIB


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_handle(device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on `device`."""
    return torch.cuda.current_stream(device).cuda_stream
