"""cloudscape_tpu_torch — the cloudscape engine in PyTorch, with hand-written
CUDA kernels for Hopper.

A port of `cloudscape_tpu` (JAX), which stays the reference it is tested
against. This package imports neither `jax` nor `cloudscape_tpu`. It serves
the default `CloudSkyEngine` loop: procedural noise pack → brick tables →
transmittance and sky-view LUTs → per-cycle cone-density cache → dense tile
march → composite; the engine's full-hemisphere re-render, the v3
cell-gated march; the v2, exact brick, scan and hierarchical marches and
the engine kernels that serve them; the engine's whole API (`can_run`,
`set_performance`, save and restore to dicts and files, the radiance
map); multi-device meshes (`parallel/sharding.py`: the engine's tile and
whole-hemisphere renders sharded by rows, one thread per shard); the
tooling (`utils/profiling.py`, the `examples/` demo and screenshots); and
the baked density field (`models/field.py`: `build_density_field`,
`march_baked`, `occupied_ray_fraction`), a documented negative result.
Six steps run as CUDA kernels on a CUDA device
(`csrc/accum.cu`, `csrc/compact.cu`, `csrc/segscan.cu`, `csrc/noise.cu`);
for CPU tensors the same wrappers run their plain PyTorch versions.
"""

from cloudscape_tpu_torch.config import CloudConfig, PerfConfig, SunState

__version__ = "0.1.0"

__all__ = [
    "CloudConfig",
    "PerfConfig",
    "SunState",
    "CloudSkyEngine",
    "__version__",
]


def __getattr__(name):
    if name == "CloudSkyEngine":
        from cloudscape_tpu_torch.engine import CloudSkyEngine

        return CloudSkyEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
