"""CloudSkyEngine: host-side orchestration of the cloudscape pipeline (PyTorch port).

The port of `cloudscape_tpu.engine.CloudSkyEngine` on one device, or
with each tick's tile sharded over a device mesh (`mesh=`), for every
kernel: the staged kernels, the default `kernel="fast3"` (dense
tiles below `V3_TILE_MIN_RAYS` rays, the staged v2 march above; with
`tile_cull`, the v3 cell-gated march at each tile's cell bucket),
`kernel="fast2"` (the v2 march for every tile; with `tile_cull`, at each
tile's ray bucket) and `kernel="hier"` (the hierarchical window-lattice v3
march for every tile), and the unstaged `kernel="fast"` (the exact brick
march) and `kernel="reference"` (the scan march), and for their
full-hemisphere re-render (`render_full_hemisphere`: the v3 march for
fast3, the banded hierarchical v3 march for hier, the kernel's own tile
march over the whole map for the others). It owns the texture rings on
its device, schedules the amortized tile updates, integrates wind,
snapshots kernel parameters once per cycle, bakes the next cycle's
cone-density cache, sky LUT and tile-cull map across the current cycle's
ticks (`cone_prebake`), serves the amortized tick through the
display-pair fused `render_frame` by default, and exposes the user API
(sun/config/performance setters, the validate-then-enable `can_run` gate,
view and radiance-map rendering, save/restore and save_file/load_file).

Where the JAX engine donates buffers to jitted `dynamic_update_slice`s, this
one writes tiles, LUT slots and bake slices into its tensors in place; each
such site says so.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import json
import sys
import time as _time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from cloudscape_tpu_torch.config import CloudConfig, PerfConfig, SunState
from cloudscape_tpu_torch.models import atmosphere
from cloudscape_tpu_torch.models.compositor import composite, composite_display
from cloudscape_tpu_torch.models.density import MarchParams, NoisePack
from cloudscape_tpu_torch.models.march import RANDOM_VECTORS, march
from cloudscape_tpu_torch.models.march_fast import (
    BrickPack,
    ConeCache,
    bake_cone_cells,
    build_cone_cache,
    cone_capacity,
    cone_occupancy_finalize,
    cone_occupancy_slice,
    cull_finalize,
    cull_raw_slice,
    hier_v3_auto_policy,
    march_bricks,
    march_bricks_v2,
    march_bricks_v3,
    march_hierarchical_v3,
    march_hierarchical_v3_banded,
    march_tile_dense,
    select_cell_keep_frac,
    v3_auto_policy,
    wrap_cone_table,
)
from cloudscape_tpu_torch.models.packs import procedural_noise_pack
from cloudscape_tpu_torch.ops import (_cuda, accum, brick, compact, composite_kernel,
                                      segscan)
from cloudscape_tpu_torch.ops.brick import build_texture2
from cloudscape_tpu_torch.ops.octmap import texel_directions
from cloudscape_tpu_torch.parallel.sharding import (Mesh, P, axis_index,
                                                    replicate, shard_map)
from cloudscape_tpu_torch.temporal import FrameData, RingState
from cloudscape_tpu_torch.tile_graphs import V3TileGraphs
from cloudscape_tpu_torch.utils.profiling import span

# fast3 tiles without a cull bucket take the dense march below this many
# rays and the staged v2 march above (the JAX engine's threshold).
V3_TILE_MIN_RAYS = 65536
# Rays a pass chunk of `update_cycle`'s batched dense march (8.4 M samples
# at 128 steps): a 768² cycle's 589,824 rays are 9 chunks. Chunking changes
# no sample's value.
BATCH_DENSE_CHUNK = 65536
# fast3's per-tile live-cell capacity buckets for the v3 tile arm (tile
# cull); a tile above the last one takes the 1.0 bucket (dense arm).
V3_TILE_CELL_BUCKETS = (0.25, 0.375, 0.5, 0.65, 0.8)
# Cone-bake chunk of the JAX engine; it sets the compacted capacity
# (`cone_capacity`), so the port uses the same value.
_CONE_CHUNK = 65536
_KERNEL_MODES = ("fast3", "fast2", "hier", "fast", "reference")
# Tiles marched through `update_cycle`'s batched dense march
# (`_march_tiles_dense`), counted under `_cuda.COUNT_LOCK` as the kernel
# wrappers count their `launches`.
batched_tiles = 0
# Rotations that found the pending bake unfinished and built the snapshot's
# cone cache, sky LUT and tile-cull map synchronously (`engine.sync_bake`:
# the first snapshot, after `restore` or `set_performance`, and every
# `update_cycle` rotation), and the bake steps such rotations threw away,
# counted under `_cuda.COUNT_LOCK`.
sync_bakes = 0
dropped_bake_steps = 0
# The v3 tile graphs a card engine captured (one per cell bucket and tile
# shape) and the v3 tiles it marched by replaying one (`V3TileGraphs`),
# counted under `_cuda.COUNT_LOCK`.
v3_graph_captures = 0
v3_graph_replays = 0


def _count_batched(tiles: int) -> None:
    """Add `tiles` to `batched_tiles`, under `_cuda.COUNT_LOCK`."""
    global batched_tiles
    with _cuda.COUNT_LOCK:
        batched_tiles += tiles


def _count_sync_bake(dropped_steps: int) -> None:
    """Count one synchronous bake and the bake steps it threw away, under
    `_cuda.COUNT_LOCK`."""
    global sync_bakes, dropped_bake_steps
    with _cuda.COUNT_LOCK:
        sync_bakes += 1
        dropped_bake_steps += dropped_steps


def _count_v3_graphs(captures: int, replays: int) -> None:
    """Add to `v3_graph_captures` and `v3_graph_replays`, under
    `_cuda.COUNT_LOCK`."""
    global v3_graph_captures, v3_graph_replays
    with _cuda.COUNT_LOCK:
        v3_graph_captures += captures
        v3_graph_replays += replays


def _group_steps(costs, ticks: int) -> tuple:
    """Contiguous groups of steps with the given costs, at most `ticks` of
    them, whose heaviest group is as light as it can be: the least cap (a
    sum of consecutive costs, at least the dearest step) at which filling
    each group in order up to the cap takes `ticks` groups or fewer, then
    that filling. Returns each group's end (exclusive step index)."""
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)
    n = len(costs)

    def fill(cap):
        ends, start = [], 0
        for i in range(1, n + 1):
            if prefix[i] - prefix[start] > cap:
                ends.append(i - 1)
                start = i - 1
        return ends + [n]

    dearest = max(prefix[i + 1] - prefix[i] for i in range(n))
    caps = sorted({prefix[j] - prefix[i] for i in range(n) for j in range(i + 1, n + 1)})
    cap = next(c for c in caps if c >= dearest and len(fill(c)) <= ticks)
    return tuple(fill(cap))


def _probe_kernels(device) -> None:
    """Build the kernel library and launch each kernel the engine runs (K1
    accumulate, K2 compact, K3 segscan, the samplers K7 and K8 on a
    texture and K9 on a tiny table, the atmosphere LUTs K11 and K10, the
    composite K12) once on a tiny input on `device`; raises on a failed
    build or launch, or an output of the wrong shape or not finite. The brick-row samplers serve
    no engine path and are not probed. The comparisons with the plain
    versions are the tests' and chip_smoke's."""
    _cuda.lib()
    f32 = dict(dtype=torch.float32, device=device)
    n, steps = 2, 8
    acc = accum.accumulate(
        torch.full((n, steps), -0.1, **f32), torch.full((n, steps), -0.2, **f32),
        torch.linspace(0.0, 1.0, n * steps, **f32).reshape(n, steps),
        torch.ones((n,), **f32), torch.ones((n,), dtype=torch.bool, device=device),
        torch.linspace(0.1, 1.2, 12, **f32))
    mask = torch.tensor([1, 0, 1, 1, 0, 0, 1, 0], dtype=torch.bool, device=device)
    idx = compact.compact(mask, 3, 8, with_rank=True)[0]
    scan = segscan.segscan(torch.arange(8, **f32), mask)
    q = torch.linspace(-0.5, 1.5, 8, **f32)
    vol = torch.linspace(0.0, 1.0, 4 * 4 * 4 * 2, **f32).reshape(4, 4, 4, 2)
    samples = (brick.sample_tex3_xyz(brick.build_texture3(vol), q, q, q),
               brick.sample_tex2_xy(brick.build_texture2(vol[0]), q, q),
               brick.sample_tiny3_xyz(brick.build_tiny3(vol), q, q, q))
    tlut = atmosphere.transmittance_lut(16, 4, device=device)
    sky = atmosphere.sky_lut_rows(tlut, (0.3, 0.5, -0.8), 1, rows=2, width=8, height=4)
    pair = brick.build_texture2(vol.reshape(4, 4, 8), wrap="clamp")
    frame = composite_kernel.composite_display_pair(
        torch.tensor([[0.0, 1.0, 0.0], [0.6, 0.0, 0.8]], **f32), pair, pair, tlut,
        (0.3, 0.5, -0.8), 1.0, 0.5)
    if tuple(acc.shape) != (n, 4) or tuple(idx.shape) != (3,) \
            or tuple(scan.shape) != (8,) or any(tuple(s.shape) != (8, 2)
                                                for s in samples) \
            or tuple(tlut.shape) != (4, 16, 4) or tuple(sky.shape) != (2, 8, 4) \
            or tuple(frame.shape) != (2, 3):
        raise RuntimeError(f"probe shapes {tuple(acc.shape)}, {tuple(idx.shape)}, "
                           f"{tuple(scan.shape)}, "
                           f"{[tuple(s.shape) for s in samples]}, "
                           f"{tuple(tlut.shape)}, {tuple(sky.shape)}, "
                           f"{tuple(frame.shape)}")
    if not all(bool(torch.isfinite(t).all())
               for t in (acc, scan, tlut, sky, frame) + samples):
        raise RuntimeError("a probe's output is not finite")


@functools.lru_cache(maxsize=8)
def _cubemap_directions_np(size: int) -> np.ndarray:
    t = (np.arange(size, dtype=np.float32) + 0.5) / size * 2.0 - 1.0
    u, v = np.meshgrid(t, t, indexing="xy")
    one = np.ones_like(u)
    d = np.stack([
        np.stack([one, -v, -u], -1),   # +X
        np.stack([-one, -v, u], -1),   # -X
        np.stack([u, one, v], -1),     # +Y
        np.stack([u, -one, -v], -1),   # -Y
        np.stack([u, -v, one], -1),    # +Z
        np.stack([-u, -v, -one], -1),  # -Z
    ])
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def cubemap_directions(size: int, device="cuda") -> torch.Tensor:
    """[6, size, size, 3] unit directions of a cubemap's texel centers, GL
    face order and orientation (+X, −X, +Y, −Y, +Z, −Z), on `device`."""
    return torch.tensor(_cubemap_directions_np(size), device=device)


def cubemap_solid_angles(size: int, device="cuda") -> torch.Tensor:
    """[6, size, size] solid angle of each texel, the cosine-cubed form
    (2/size)² / ‖(u, v, 1)‖³ (close enough at probe sizes), on `device`."""
    t = (np.arange(size, dtype=np.float32) + 0.5) / size * 2.0 - 1.0
    u, v = np.meshgrid(t, t, indexing="xy")
    sa = (2.0 / size) ** 2 / np.power(u * u + v * v + 1.0, 1.5)
    return torch.tensor(np.broadcast_to(sa, (6, size, size)).astype(np.float32),
                        device=device)


def _prefilter_mip(colors, dirs_in, sa_in, dirs_out, exponent: float):
    """One roughness mip by spherical convolution: each output direction
    integrates the whole base cubemap (colors [n_in, 3] at dirs_in with
    solid angles sa_in) under the normalized lobe max(d_out·d_in, 0)^exponent,
    as one [n_out, n_in] weight matrix times the colors (no face seams)."""
    w = torch.clamp(dirs_out @ dirs_in.T, min=0.0)
    if exponent != 1.0:
        w = torch.pow(w, exponent)
    w = w * sa_in[None, :]
    return (w @ colors) / torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1e-12)


def _prepass_steps(steps: int) -> int:
    """Coarse probes per ray of the cull prepass and the v3 march: the
    largest divisor of `steps` that is at most steps / 4."""
    ps = max(1, steps // 4)
    while steps % ps:
        ps -= 1
    return ps


def tile_arm(kernel: str, bucket: Optional[float], n_rays: int) -> str:
    """The arm that marches a tile of `n_rays` rays (a mesh shard's own) for
    `kernel` at its tile-cull bucket (None without tile cull): the engine's
    one decision, which `_march_tile` dispatches on and whose name its span
    takes (`tile.<arm>`).

    ===========  ============================================================
    skip         a 0.0 bucket: no march, the tile written as zeros
    reference    "reference": the scan march `march` on the NoisePack
    exact        "fast": the exact brick march `march_bricks`, capacity 0.5
                 of the samples (generous for small tiles, not a guarantee:
                 a thin overcast scene can keep more, and the excess loses
                 its sun term), chunk min(region², 16384)
    hier         "hier": `march_hierarchical_v3`, every capacity bucket 1.0,
                 no ray select, ray stride 1 (the engine's buckets are
                 measured on the standard lattice and would undercount the
                 windows' live cells; only the 0.0 skip applies)
    v3           fast3 with a bucket strictly between 0 and 1, its live-cell
                 capacity: `_march_tile_v3`
    dense        fast3 without a cull bucket (or at 1.0) below
                 V3_TILE_MIN_RAYS rays: `march_tile_dense`
    v2           every other fast3 tile, and fast2: `march_bricks_v2`,
                 capacity 0.5; fast2's bucket below 1.0 is its kept-ray
                 fraction, ranked by the tile's window of the priority map
    ===========  ============================================================
    """
    if bucket == 0.0:
        return "skip"
    if kernel == "reference":
        return "reference"
    if kernel == "fast":
        return "exact"
    if kernel == "hier":
        return "hier"
    if kernel == "fast3":
        if bucket is not None and 0.0 < bucket < 1.0:
            return "v3"
        if n_rays < V3_TILE_MIN_RAYS:
            return "dense"
    return "v2"


def _march_tile_v3(dirs, params: MarchParams, bricks, cone_cache, sky_img,
                   cell_bucket: float, *, steps: int, light_steps: int,
                   axis_name: Optional[str] = None):
    """fast3's v3 tile arm: the v3 cell-gated march of a [H, W] tile at its
    live-cell bucket, hot bucket 0.5, ray stride 2, cell margin 0.1 and no
    ray select. The eager arm of `_march_tile` and the graphs the engine
    replays (`V3TileGraphs`) both call it."""
    n = int(np.prod(dirs.shape[:-1]))
    return march_bricks_v3(
        dirs, params, bricks, sky_img, steps=steps, light_steps=light_steps,
        chunk=min(n, 16384), cell_keep_frac=float(cell_bucket), hot_keep_frac=0.5,
        cone_cache=cone_cache, ray_keep_frac=None,
        prepass_steps=_prepass_steps(steps), ray_stride=2, cell_margin=0.1,
        axis_name=axis_name)


def _march_tile(arm: str, dirs, params: MarchParams, noise, sky_img, *, region: int,
                steps: int, light_steps: int, kernel: str,
                bucket: Optional[float] = None, cull_prio=None,
                axis_name: Optional[str] = None):
    """March a tile (or the whole map) by `arm`, `tile_arm`'s choice (not
    "skip"), in the span `tile.<arm>`. noise is the engine's `_noise_arg`.
    bucket: the tile's cull bucket strictly between 0 and 1, or None; the
    v3 arm's cell bucket and fast2's kept-ray fraction for the v2 arm,
    whose ranking reads cull_prio. region: the edge the exact arm and
    fast2's v2 arm chunk by (min(region², 16384); `kernel` is read for that
    alone), a mesh shard's row count on a shard. axis_name (inside
    `shard_map`): dirs' rows are sharded over that mesh axis, and the v3
    arm exchanges its prepass dilations' boundary rows with the
    neighbouring shards; the other arms are per-ray math on the shard's
    rows."""
    n = int(np.prod(dirs.shape[:-1]))
    with span("tile." + arm):
        if arm == "reference":
            return march(dirs, params, noise, sky_img, steps=steps,
                         light_steps=light_steps)
        if arm == "exact":
            return march_bricks(dirs, params, noise, sky_img, steps=steps,
                                light_steps=light_steps,
                                chunk=min(region * region, 16384), capacity_frac=0.5)
        bricks, cone_cache = noise
        if arm == "hier":
            return march_hierarchical_v3(
                dirs, params, bricks, sky_img, steps=steps, light_steps=light_steps,
                chunk=min(n, 16384), coarse_steps=min(32, max(8, steps // 4)),
                cell_keep_frac=1.0, hot_keep_frac=1.0, ray_keep_frac=None,
                cone_cache=cone_cache, prepass_steps=_prepass_steps(steps),
                ray_stride=1)
        if arm == "v3":
            return _march_tile_v3(dirs, params, bricks, cone_cache, sky_img, bucket,
                                  steps=steps, light_steps=light_steps,
                                  axis_name=axis_name)
        if arm == "dense":
            return march_tile_dense(dirs, params, bricks, sky_img, steps=steps,
                                    light_steps=light_steps, chunk=min(n, 16384),
                                    cone_cache=cone_cache)
        chunk = min(region * region if kernel == "fast2" else n, 16384)
        return march_bricks_v2(dirs, params, bricks, sky_img, steps=steps,
                               light_steps=light_steps, chunk=chunk,
                               capacity_frac=0.5, cone_cache=cone_cache,
                               ray_keep_frac=bucket, cull_prio=cull_prio)


def _build_display_pair(cloud_ring, cfrom: int, cto: int, sky_ring, b0: int,
                        b1: int):
    """The cycle's display-pair textures: the blend pair's textures are
    frozen between rotations (only `texture_to_update` is written within a
    cycle), so each is packed once a cycle, each texel holding from rgba
    (channels 0-3) ‖ to rgba (4-7), clamp wrap (the JAX engine packs the
    same texels into (4, 4) bricks at stride 3). `torch.cat` copies, so
    the textures never alias the ring, whose tiles are written in place."""
    cp = build_texture2(torch.cat([cloud_ring[cfrom], cloud_ring[cto]], dim=-1),
                        wrap="clamp")
    sp = build_texture2(torch.cat([sky_ring[b0], sky_ring[b1]], dim=-1),
                        wrap="clamp")
    return cp, sp


@dataclasses.dataclass
class _PendingCycle:
    """The NEXT cycle's state, frozen one rotation ahead and baked across the
    current cycle's ticks (`_advance_prebake`) in stage steps: occupancy
    slices → occupancy finalize (kernel K2) → cone-march slices → wrap →
    sky-LUT row bands (kernel K10) → (tile cull) cull prepass slices → cull
    finalize → the tile fractions' host read. One step a tick where the
    plan fits the cycle, else the tick's group of consecutive steps
    (`_derive_prebake_schedule`); either way the bake is complete before
    the next rotation, which makes this snapshot active. `fresh` skips the
    boundary tick itself; `steps_done` counts the steps taken."""

    frame_data: FrameData
    march_params: MarchParams
    vol: Optional[torch.Tensor]       # flat [nd*nh*nw + 1] cone volume
    occ: Any = None                   # flat bool occupancy buffer
    occ_done: int = 0
    idx: Any = None                   # compacted occupied-cell indices
    slices_done: int = 0
    cone: Optional[ConeCache] = None  # assembled cache once complete
    sky_rows: Any = None              # list of prebaked sky-LUT row bands
    sky: Any = None                   # prebaked sky-LUT image for the pickup
    raw: Any = None                   # [n_sub, prepass_steps] raw cull buffer
    cull_done: int = 0
    prio: Any = None                  # the cycle's cull priority map
    tile_keep: Any = None             # device tile-keep fractions (pre-read)
    tile_cell: Any = None             # device tile live-cell fractions
    buckets: Optional[List[float]] = None
    fresh: bool = True                # created this tick — skip one advance
    steps_done: int = 0               # stage steps baked so far


class CloudSkyEngine:
    """User-facing engine with the reference's parameter surface and
    scheduling semantics."""

    SKY_LUT_SHAPE = (100, 200, 4)

    def __init__(
        self,
        perf: PerfConfig = PerfConfig(),
        config: CloudConfig = CloudConfig(),
        sun: SunState = SunState(direction=(0.0, 0.5, -1.0)),
        noise: Optional[NoisePack] = None,
        now: float = 0.0,
        kernel: str = "fast3",
        mesh=None,
        cone_res=(32, 512, 512),
        tile_cull: bool = False,
        cone_prebake: Optional[bool] = None,
        *,
        device="cuda",
    ):
        """device: where every tensor of the engine lives (the card by
        default; a CPU engine says `device="cpu"`). noise defaults to
        `procedural_noise_pack(0)` generated on that device, the pack the
        JAX engine falls back to when the reference's assets are absent.

        kernel: the staged kernels, all against the per-cycle cone cache:
        "fast3" (default; tiles below V3_TILE_MIN_RAYS rays march densely,
        larger ones through the staged v2 march; the whole-map render is
        the v3 march), "fast2" (the v2 march for every tile and the
        whole-map render) or "hier" (config 5's hierarchical march: each
        ray's steps spread over its occupied window, through the v3 core;
        the whole-map render is its banded form); or the unstaged "fast"
        (the exact brick march,
        `march_bricks`, with its own sun march and no cone cache) or
        "reference" (the scan march, `march`, on the noise pyramids: the
        numerics anchor, slow). cone_res: (hf, z, x) resolution of the
        per-cycle cone cache; cone_prebake (default on for the staged
        kernels): bake the next cycle's cone cache, sky LUT and tile-cull
        map across the current cycle's ticks, taking the snapshot one
        rotation ahead.

        tile_cull: per-tile culling from a per-cycle cull map (the
        parameters are frozen for a cycle, so one prepass over the texel
        grid scores every tile). Each tile gets a bucket: 0.0 when its
        whole window scores empty (the march is skipped and zeros, exactly
        the all-culled result, are written), 1.0 when culling would remove
        too little (the unculled arm), else fast3's live-cell capacity
        (the v3 tile arm) or fast2's kept-ray fraction. Off by default:
        culled tiles are close to, not equal to, unculled ones. "hier"
        takes fast2's buckets but marches every tile that is not skipped
        whole. tile_cull and cone_prebake are ignored by the unstaged
        kernels, as in JAX.

        mesh: an optional `parallel.sharding.Mesh` (`make_mesh`): each
        tick's tile is marched with its rows sharded over the mesh, one
        thread per shard (`_update_tile`), the rings and every other
        state staying on `device`. The tile edge must be a multiple of the
        mesh size. The warm start, `update_cycle` and
        `render_full_hemisphere` stay unsharded, and `render_frame` takes
        `update_sky` + `render_view` (no fused tick), as in JAX. Composes
        with tile_cull: each shard culls its own rows from the tile's
        window of the priority map.

        can_run: set by `_validate_kernels` before the first snapshot (and
        again by `set_performance`); when it is false the engine builds
        nothing and `update_cycle`, `update_sky` and `render_frame` do no
        work (the reference's invalid-shader guard)."""
        if kernel not in _KERNEL_MODES:
            raise ValueError(f"unknown kernel {kernel!r}")
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.sharding.Mesh (make_mesh), "
                            f"got {type(mesh).__name__}")
        self.kernel = kernel
        self.device = torch.device(device)
        self.cone_res = tuple(cone_res)
        # "Staged" kernels march against the per-cycle cone-density cache;
        # only they cull tiles and prebake the next cycle.
        self._staged = kernel in ("fast2", "fast3", "hier")
        self.tile_cull = bool(tile_cull) and self._staged
        self.cone_prebake = self._staged if cone_prebake is None \
            else (bool(cone_prebake) and self._staged)
        self._pending: Optional[_PendingCycle] = None
        self._prio_map = None
        self._tile_buckets: Optional[List[float]] = None
        self.perf = perf.validate()
        self.mesh = mesh
        self._check_mesh(self.perf)
        self._mesh_noise_cache = None
        self.config = config
        self.sun = sun
        self.noise = noise if noise is not None else \
            procedural_noise_pack(0, device=self.device)
        self._bricks = None if kernel == "reference" else \
            BrickPack.from_noise(self.noise)
        self._cone_cache: Optional[ConeCache] = None
        self._v3_policy_cache = None
        # The v3 tile arm's CUDA graphs (`_march_tile_v3_graph`): a card
        # engine without a mesh whose culled tiles can take the v3 arm.
        self._v3_graphs = V3TileGraphs(self.device, _march_tile_v3) \
            if (self.device.type == "cuda" and mesh is None and self.tile_cull
                and tile_arm(kernel, V3_TILE_CELL_BUCKETS[0], 0) == "v3") else None

        # Baked once at load, like `transmittance_lut.gd:51-78`.
        self.transmittance = atmosphere.transmittance_lut(device=self.device)

        n = self.perf.texture_size
        self.cloud_ring = torch.zeros((3, n, n, 4), dtype=torch.float32,
                                      device=self.device)
        self.sky_ring = torch.zeros((3,) + self.SKY_LUT_SHAPE,
                                    dtype=torch.float32, device=self.device)
        self._display_pair = None

        self.frame_data = FrameData()
        self._head_frame_data = self.frame_data  # replaced by a copy at refresh
        self._picked_sky = None
        self._sun_srgb = False
        self._derive_prebake_schedule()
        self.ring = RingState()
        self._start_time: Optional[float] = None
        self.needs_full_sky_init = True
        self._sky_lut_needs_full_update = True  # sky_lut.gd `needs_full_update`
        # Validate-then-enable, like the reference's invalid-shader guard
        # (`cloud_sky.gd:362-364`). The JAX engine validates after its first
        # snapshot; here the snapshot's cone bake launches the kernels, so
        # validation comes first and a disabled engine takes no snapshot.
        self.can_run = self._validate_kernels()
        if self.can_run:
            self._refresh_frame_data(now)
        else:
            self._march_params = self.frame_data.to_march_params(self.device)

    def _check_mesh(self, perf: PerfConfig) -> None:
        """The JAX engine's mesh check: the tile's rows split evenly over
        the mesh; raises ValueError."""
        if self.mesh is not None and perf.update_region_size % self.mesh.size:
            raise ValueError(f"update_region_size {perf.update_region_size} is "
                             f"not a multiple of the mesh size {self.mesh.size}")

    def _check_shapes(self) -> None:
        """The shapes the tile update needs (what the JAX engine's abstract
        evaluation of its tile kernel checks); raises ValueError."""
        n, region = self.perf.texture_size, self.perf.update_region_size
        if region < 1 or n % region:
            raise ValueError(f"tile {region} does not divide texture {n}")
        if tuple(self.cloud_ring.shape) != (3, n, n, 4) or \
                tuple(self.sky_ring.shape) != (3,) + self.SKY_LUT_SHAPE:
            raise ValueError(f"rings {tuple(self.cloud_ring.shape)}, "
                             f"{tuple(self.sky_ring.shape)} do not fit texture {n}")
        if self.perf.march_steps < 1 or not \
                0 <= self.perf.light_steps <= len(RANDOM_VECTORS):
            raise ValueError(f"march_steps {self.perf.march_steps}, light_steps "
                             f"{self.perf.light_steps} (at most {len(RANDOM_VECTORS)})")
        if self._staged and (len(self.cone_res) != 3 or min(self.cone_res) < 2):
            raise ValueError(f"cone_res {self.cone_res}")
        nz = self.noise
        if not (nz.large and nz.small and nz.large[0].dim() == 4
                and nz.large[0].shape[-1] == 4 and nz.small[0].dim() == 4
                and nz.small[0].shape[-1] == 3 and nz.weather.dim() == 3
                and nz.weather.shape[-1] == 3):
            raise ValueError("noise pack levels are not [D, H, W, 4], "
                             "[D, H, W, 3] and a [H, W, 3] weather map")
        for t in (*nz.large, *nz.small, nz.weather, self.cloud_ring,
                  self.transmittance):
            if t.device.type != self.device.type:
                raise ValueError(f"a tensor on {t.device}, the engine on {self.device}")

    def _validate_kernels(self) -> bool:
        """Check the shapes and, on each card the engine or its mesh uses,
        build the kernels and launch each marching kernel once on a tiny
        input; the mesh's cards are probed here, before any shard thread
        starts. A failure disables the engine (one line on stderr) instead
        of raising from the render loop."""
        try:
            self._check_shapes()
            devices = [self.device] + ([] if self.mesh is None
                                       else self.mesh.distinct_devices())
            for d in dict.fromkeys(devices):
                if d.type == "cuda":
                    _probe_kernels(d)
                    torch.cuda.synchronize(d)
            return True
        except Exception as e:  # noqa: BLE001 — any failure disables
            first = (str(e).strip().splitlines() or [type(e).__name__])[0]
            print(f"cloudscape_tpu_torch: kernel validation failed, engine "
                  f"disabled: {first}", file=sys.stderr)
            return False

    # ------------------------------------------------------------------ API

    def set_sun(self, direction, energy: float = 1.0, color=(1.0, 1.0, 1.0),
                srgb_color: bool = False) -> None:
        """The `sun.gd` binding: picked up at the next texture-swap boundary
        (`cloud_sky.gd:165-167`)."""
        self.sun = SunState(tuple(direction), float(energy), tuple(color))
        self._sun_srgb = srgb_color

    def set_config(self, config: CloudConfig) -> None:
        """Dynamic parameter change; snapshotted at the next cycle boundary."""
        self.config = config

    def set_performance(self, perf: PerfConfig) -> None:
        """Performance-settings change (`cloud_sky.gd:35-50`): tear down the
        cloud ring, derive the tile schedule again (with the divisibility
        auto-correction), request a full warm re-init and validate again."""
        corrected = perf.validate()
        if corrected.texture_size != perf.texture_size:
            # `cloud_sky.gd:114` prints the same correction notice.
            print("cloudscape_tpu_torch: texture_size is not a multiple of "
                  f"sqrt(frames_to_update), changing to: {corrected.texture_size}")
        self._check_mesh(corrected)
        self.perf = corrected
        n = self.perf.texture_size
        self.cloud_ring = torch.zeros((3, n, n, 4), dtype=torch.float32,
                                      device=self.device)
        self._display_pair = None
        self.ring.reset()
        self._pending = None  # a snapshot and slices of the old shapes
        self._picked_sky = None
        self._v3_policy_cache = None
        self._prio_map = self._tile_buckets = None
        self._derive_prebake_schedule()
        self.request_full_sky_init()
        self.can_run = self._validate_kernels()

    def request_full_sky_init(self) -> None:
        """`cloud_sky.gd:120-121`."""
        self.needs_full_sky_init = True

    # ------------------------------------------------------------ scheduling

    def _now(self, now: Optional[float]) -> float:
        if now is not None:
            return float(now)
        if self._start_time is None:
            self._start_time = _time.monotonic()
        return _time.monotonic() - self._start_time

    # The card's own prebake costs: per sliced stage (ms a call, ms a unit:
    # an occupancy cell, a cone cell, a sky-LUT row, a cull ray), the
    # least-squares line through each stage's device-complete time at three
    # slice sizes up to the whole stage, from `python -m
    # cloudscape_tpu_torch.probe_prebake` at the serving point on an NVIDIA
    # H100 80GB HBM3 at 700.00 W: each term the median of three runs' fits
    # (PERF.md §5). Every stage costs its call far more than its units: the
    # occupancy (124 launches), cone (911) and cull (222 a 32,768-ray chunk)
    # stages are the host's launches, the sky LUT one launch of K10. Used
    # ONLY to size the prebake slices; correctness never depends on them
    # (every schedule reproduces the synchronous bake bitwise).
    _BAKE_COSTS = {
        "occ": (1.100, 3.286e-07),
        "cone": (14.36, 1.251e-07),
        "sky": (0.06827, 9.518e-05),
        "cull": (2.902, 4.165e-05),
    }
    # The per-tick budget of added bake work: 0.4x the steady serving tick
    # (15.83 ms, the median of the same runs' steady-tick medians), as the
    # JAX engine's budget is 0.4x its own steady tick.
    _BAKE_TICK_MS = 6.33

    def _derive_prebake_schedule(self) -> None:
        """Per-tick stage sizing for the amortized cycle bake: each stage
        step costs a call plus its units at `_BAKE_COSTS`, and is sized to
        fit the per-tick budget, `_BAKE_TICK_MS` to start with: (budget −
        per call) / per unit, at least one unit, so a stage whose call
        costs most of a tick is not split into ticks that each pay it.
        When the step count (with the boundary tick and a tick of slack)
        does not fit in frames_to_update ticks the budget grows until it
        does (`_bake_budget_ms` keeps the last, `_bake_ticks` the ticks the
        bake then takes), one step a tick: `_bake_group_ends`, each tick's
        end in `_bake_steps`, is 1, 2, 3, ...

        A plan that still does not fit (frames_to_update 4: ten ticks at
        the least) groups its consecutive steps into the frames_to_update
        − 1 ticks after the boundary, the heaviest tick as light as the
        steps' modelled costs allow (`_group_steps`; the finalizes, wrap and
        host read cost nothing in the model): `_bake_group_ends` holds each
        tick's end in `_bake_steps`, `_bake_budget_ms` the heaviest tick's
        modelled cost and `_bake_ticks` the boundary plus the bake's ticks.
        Every plan completes the bake before the next rotation, so the
        synchronous build runs only where no bake was pending or it was
        never advanced (`_refresh_frame_data`). With tile cull the prepass
        is sliced over the stride-subsampled texel grid (`_dirs_sub`)."""
        c = self._BAKE_COSTS
        n = int(np.prod(self.cone_res))
        self._cone_capacity = cone_capacity(n, 0.45, _CONE_CHUNK)
        sky_h = self.SKY_LUT_SHAPE[0]
        self._n_sub = 0
        if self.tile_cull:
            size = self.perf.texture_size
            self._cull_ps, self._cull_stride = self._v3_march_knobs()
            self._n_sub = (size // self._cull_stride) ** 2
            self._dirs_sub = texel_directions(size, device=self.device)[
                ::self._cull_stride, ::self._cull_stride].reshape(-1, 3)
        units = {"occ": n, "cone": self._cone_capacity, "sky": sky_h,
                 "cull": self._n_sub}

        def slice_at(stage: str, budget_ms: float) -> int:
            call_ms, unit_ms = c[stage]
            return min(max(int((budget_ms - call_ms) / unit_ms), 1), units[stage])

        def plan(budget_ms: float):
            sizes = {st: slice_at(st, budget_ms) for st in units if units[st]}
            while sky_h % sizes["sky"]:
                sizes["sky"] -= 1
            counts = {st: -(-units[st] // k) for st, k in sizes.items()}
            # skip, idx-finalize, wrap, (cull finalize + host read), slack
            total = 4 + (2 if self.tile_cull else 0) + sum(counts.values())
            return total, counts, sizes

        total_var_ms = sum(c[st][0] + u * c[st][1] for st, u in units.items() if u)
        avail = max(self.perf.frames_to_update - 6, 1)
        budget = max(self._BAKE_TICK_MS, total_var_ms / avail)
        total, counts, sizes = plan(budget)
        while total > self.perf.frames_to_update and budget < 4096.0:
            budget *= 1.1
            total, counts, sizes = plan(budget)
        self._bake_budget_ms, self._bake_ticks = budget, total
        self._n_occ, self._n_cone_slices, self._n_sky = \
            counts["occ"], counts["cone"], counts["sky"]
        self._occ_slice, self._cone_slice, self._sky_rows = \
            sizes["occ"], sizes["cone"], sizes["sky"]
        self._n_cull = counts.get("cull", 0)
        self._cull_slice = sizes.get("cull", 0)
        steps = ([("occupancy", "occ")] * self._n_occ + [("finalize", None)]
                 + [("cone", "cone")] * self._n_cone_slices + [("wrap", None)]
                 + [("sky_band", "sky")] * self._n_sky)
        if self.tile_cull:
            steps += ([("cull", "cull")] * self._n_cull
                      + [("cull_finalize", None), ("cull_read", None)])
        # The bake's steps in order, each taken once (`_prebake_stage`).
        self._bake_steps = tuple(name for name, _ in steps)
        self._bake_group_ends = tuple(range(1, len(steps) + 1))
        if total > self.perf.frames_to_update:
            costs = [c[st][0] + sizes[st] * c[st][1] if st else 0.0 for _, st in steps]
            ends = _group_steps(costs, self.perf.frames_to_update - 1)
            self._bake_group_ends = ends
            self._bake_budget_ms = max(sum(costs[a:b]) for a, b in zip((0,) + ends, ends))
            self._bake_ticks = 1 + len(ends)

    def _build_cone(self, params: MarchParams) -> ConeCache:
        with span("cone.build"):
            return build_cone_cache(params, self._bricks, self.perf.light_steps,
                                    res=self.cone_res, chunk=_CONE_CHUNK)

    def _refresh_frame_data(self, now: float) -> None:
        """`_update_per_frame_data` (`cloud_sky.gd:165-187`) minus the LUT
        render. With cone_prebake the snapshot pipeline is one cycle deep at
        every frames_to_update: the snapshot frozen at this rotation becomes
        active at the next, its cone cache, sky LUT and tile-cull map baked
        across this cycle's ticks. Where the pending bake is not ready (no
        bake pending, or ticks never advanced it: the first snapshot, after
        `restore` or `set_performance`, and `update_cycle`) they are built
        synchronously for this snapshot, inside the span
        `engine.sync_bake`, counted in `sync_bakes` with the pending steps
        thrown away in `dropped_bake_steps`. The unstaged kernels take the
        snapshot at once and build no cone cache."""
        with span("engine.snapshot"):
            self._v3_policy_cache = None  # per snapshot (render_full_hemisphere)
            if not self.cone_prebake:
                self.frame_data.update_light_data(self.sun, self._sun_srgb)
                self.frame_data.update_config(self.config)
                self.frame_data.integrate_wind(now)
                self._march_params = self.frame_data.to_march_params(self.device)
                if self._staged:
                    self._cone_cache = self._build_cone(self._march_params)
                    if self.tile_cull:
                        self._refresh_tile_cull()
                return

            head = self._head_frame_data
            head.update_light_data(self.sun, self._sun_srgb)
            head.update_config(self.config)
            head.integrate_wind(now)
            pend = self._pending
            ready = (pend is not None and pend.cone is not None
                     and pend.sky is not None
                     and (not self.tile_cull or pend.buckets is not None))
            if ready:
                self.frame_data = pend.frame_data
                self._march_params = pend.march_params
                self._cone_cache = pend.cone
                self._picked_sky = pend.sky
                if self.tile_cull:
                    self._prio_map = pend.prio
                    self._tile_buckets = pend.buckets
            else:
                with span("engine.sync_bake"):
                    _count_sync_bake(0 if pend is None else pend.steps_done)
                    self._picked_sky = None
                    self.frame_data = copy.deepcopy(head)
                    self._march_params = self.frame_data.to_march_params(self.device)
                    self._cone_cache = self._build_cone(self._march_params)
                    if self.tile_cull:
                        self._refresh_tile_cull()
            fd = copy.deepcopy(head)
            self._pending = _PendingCycle(
                frame_data=fd, march_params=fd.to_march_params(self.device),
                vol=torch.zeros((int(np.prod(self.cone_res)) + 1,),
                                dtype=torch.float32, device=self.device))

    def _prebake_stage(self) -> Optional[str]:
        """The (first) stage step the next `_advance_prebake` takes: "fresh"
        (the tick that made the pending cycle, which bakes nothing), else
        the next of the schedule's `_bake_steps`, in the bake's order
        "occupancy", "finalize", "cone", "wrap", "sky_band", then with tile
        cull "cull", "cull_finalize" and "cull_read"; None when there is no
        pending bake or it is done."""
        pend = self._pending
        if pend is None or not self.cone_prebake:
            return None
        if pend.fresh:
            return "fresh"
        steps = self._bake_steps
        return steps[pend.steps_done] if pend.steps_done < len(steps) else None

    def _prebake_stages(self) -> List[str]:
        """The stage steps the next `_advance_prebake` takes, in order: from
        the step `_prebake_stage` names to the end of its tick's group
        (`_bake_group_ends`; one step where the plan fits the cycle);
        ["fresh"] on the tick that made the pending cycle; [] when there is
        no pending bake or it is done."""
        stage = self._prebake_stage()
        if stage is None:
            return []
        if stage == "fresh":
            return [stage]
        done = self._pending.steps_done
        end = next(e for e in self._bake_group_ends if e > done)
        return list(self._bake_steps[done:end])

    def _advance_prebake(self) -> None:
        """The tick's stage steps of the pending cycle's bake
        (`_prebake_stages`): on a tick that bakes, the span `bake.tick`
        around them and a span `prebake.<stage>` around each."""
        stages = self._prebake_stages()
        if not stages:
            return
        if stages == ["fresh"]:
            self._pending.fresh = False
            return
        with span("bake.tick"):
            for stage in stages:
                with span("prebake." + stage):
                    self._bake_step(stage)

    def _bake_step(self, stage: str) -> None:
        """The pending cycle's bake step `stage` (not "fresh")."""
        pend = self._pending
        pend.steps_done += 1
        n = int(np.prod(self.cone_res))
        params = pend.march_params
        if stage == "occupancy":
            if pend.occ is None:
                pend.occ = torch.zeros((n,), dtype=torch.bool, device=self.device)
            i0 = min(pend.occ_done * self._occ_slice, max(n - self._occ_slice, 0))
            # In place: writes occ[i0 : i0 + slice], in one piece (each
            # piece is a round of launches; the slice is sized to a tick).
            cone_occupancy_slice(pend.occ, i0, params, self._bricks,
                                 count=self._occ_slice, res=self.cone_res,
                                 chunk=self._occ_slice)
            pend.occ_done += 1
        elif stage == "finalize":
            pend.idx = cone_occupancy_finalize(pend.occ, res=self.cone_res,
                                               chunk=_CONE_CHUNK)
            pend.occ = None
        elif stage == "cone":
            i0 = min(pend.slices_done * self._cone_slice,
                     max(self._cone_capacity - self._cone_slice, 0))
            # In place: writes the slice's cells into pend.vol, in one piece.
            bake_cone_cells(pend.vol, pend.idx, i0, params, self._bricks,
                            count=self._cone_slice,
                            light_steps=self.perf.light_steps,
                            res=self.cone_res, chunk=self._cone_slice)
            pend.slices_done += 1
        elif stage == "wrap":
            # The tick after the last cone slice (the JAX engine first packs
            # its cone brick table, over ticks of their own; the texture
            # needs no packing). A view of pend.vol, which no later bake
            # writes: the next cycle's bake gets a volume of its own.
            pend.cone = wrap_cone_table(pend.vol[:n], self.cone_res)
            pend.vol = None
            pend.idx = None
        elif stage == "sky_band":
            if pend.sky_rows is None:
                pend.sky_rows = []
            r0 = len(pend.sky_rows) * self._sky_rows
            pend.sky_rows.append(atmosphere.sky_lut_rows(
                self.transmittance, self._light_dir(pend.frame_data), r0,
                rows=self._sky_rows))
            if len(pend.sky_rows) >= self._n_sky:
                pend.sky = torch.cat(pend.sky_rows, dim=0)
                pend.sky_rows = None
        elif stage == "cull":
            if pend.raw is None:
                pend.raw = torch.zeros((self._n_sub, self._cull_ps),
                                       dtype=torch.float32, device=self.device)
            # The last slice overlaps the one before it.
            i0 = min(pend.cull_done * self._cull_slice,
                     max(self._n_sub - self._cull_slice, 0))
            # In place: writes raw rows [i0, i0 + slice).
            cull_raw_slice(pend.raw, self._dirs_sub, i0, params, self._bricks,
                           count=self._cull_slice, steps=self.perf.march_steps,
                           prepass_steps=self._cull_ps)
            pend.cull_done += 1
        elif stage == "cull_finalize":
            pend.prio, pend.tile_keep, pend.tile_cell = cull_finalize(
                pend.raw, texel_directions(self.perf.texture_size,
                                           device=self.device),
                self.perf.update_region_size, self._cull_stride)
            pend.raw = None
        else:  # "cull_read": the cycle's one host read of the tile fractions
            keep = pend.tile_keep.reshape(-1).cpu().numpy()
            cell = pend.tile_cell.reshape(-1).cpu().numpy()
            pend.tile_keep = pend.tile_cell = None
            pend.buckets = self._buckets_from_keep(keep, cell)

    # ------------------------------------------------------------ tile cull

    _TILE_BUCKETS = (0.0, 0.25, 0.5, 0.75, 1.0)

    def _compute_tile_cull(self, params: MarchParams):
        """The tile-cull state of one snapshot in one call: the priority map
        over the whole texel grid and the tiles' buckets, from one host read
        of the per-tile fractions. Returns (prio_map, buckets).

        The JAX engine takes `cull_priority_map` here; the port runs the
        prebake's two stages over the whole subsampled grid at once
        (`cull_raw_slice` of all n_sub rays, then `cull_finalize`), so the
        synchronous fallback and the prebake build the map one way. Both
        give the one-pass map's tile fractions bitwise and its priorities
        within 1e-6 (tests/test_torch_serving.py)."""
        with span("cull.build"):
            raw = torch.zeros((self._n_sub, self._cull_ps), dtype=torch.float32,
                              device=self.device)
            cull_raw_slice(raw, self._dirs_sub, 0, params, self._bricks,
                           count=self._n_sub, steps=self.perf.march_steps,
                           prepass_steps=self._cull_ps)
            prio, tile_keep, tile_cell = cull_finalize(
                raw, texel_directions(self.perf.texture_size, device=self.device),
                self.perf.update_region_size, self._cull_stride)
            return prio, self._buckets_from_keep(tile_keep.reshape(-1).cpu().numpy(),
                                                 tile_cell.reshape(-1).cpu().numpy())

    def _buckets_from_keep(self, keep, cell=None) -> List[float]:
        """Per-tile buckets from the tiles' fractions (row-major tile order;
        numpy float32, so the margins round as in the JAX engine).

        fast2: the ray-keep bucket of `_TILE_BUCKETS`, margin 1.1. fast3:
        0.0 for a tile with no ray above the keep margin (skipped), else the
        live-cell bucket of V3_TILE_CELL_BUCKETS, margin 1.12 (as
        `select_cell_keep_frac`; an overflow drops the farthest cells), or
        1.0 above the last (the dense arm: the cell gate would remove too
        little)."""
        buckets = []
        if self.kernel == "fast3":
            for k, c in zip(keep, cell):
                if k * 1.1 <= 0.0:
                    buckets.append(0.0)
                    continue
                buckets.append(next((b for b in V3_TILE_CELL_BUCKETS
                                     if c * 1.12 <= b), 1.0))
            return buckets
        for k in keep:
            buckets.append(next((b for b in self._TILE_BUCKETS if k * 1.1 <= b),
                                1.0))
        return buckets

    def _refresh_tile_cull(self) -> None:
        """The synchronous tile-cull build for the active snapshot. The JAX
        engine then warms one XLA executable per bucket
        (`_warm_tile_cull_variants`); the port compiles nothing here, and
        captures its v3 tile graphs at the first v3 tile of a tick
        (`_march_tile_v3_graph`)."""
        self._prio_map, self._tile_buckets = \
            self._compute_tile_cull(self._march_params)

    @property
    def _noise_arg(self):
        """The `noise` argument of `_march_tile` for this engine's kernel."""
        if self._staged:
            return (self._bricks, self._cone_cache)
        if self.kernel == "fast":
            return self._bricks
        return self.noise

    def _light_dir(self, frame_data: FrameData) -> torch.Tensor:
        return torch.from_numpy(np.asarray(frame_data.light_direction,
                                           np.float32)).to(self.device)

    @staticmethod
    def _light_floats(frame_data: FrameData) -> tuple:
        """The sun direction as host floats of `_light_dir`'s values: a
        kernel's launch arguments, which copy nothing to the card."""
        return tuple(np.asarray(frame_data.light_direction, np.float32).tolist())

    def _render_sky_image(self, sun_dir) -> torch.Tensor:
        """One full sky-view LUT through the same row bands the prebake
        renders, so a prebaked image equals a synchronous one."""
        rows = self._sky_rows
        return torch.cat([
            atmosphere.sky_lut_rows(self.transmittance, sun_dir, r0, rows=rows)
            for r0 in range(0, self.SKY_LUT_SHAPE[0], rows)], dim=0)

    def _render_sky_lut(self) -> None:
        """One LUT render + ring rotation (`sky_lut.gd:122-148`), three times
        on first use so all slots are valid (`sky_lut.gd:49-52`)."""
        with span("sky_lut.render"):
            renders = 3 if self._sky_lut_needs_full_update else 1
            self._sky_lut_needs_full_update = False
            sun_dir = self._light_dir(self.frame_data)
            picked = self._picked_sky
            for _ in range(renders):
                img = picked if (renders == 1 and picked is not None) \
                    else self._render_sky_image(sun_dir)
                self.sky_ring[self.ring.sky_lut_current] = img  # in place
                self.ring.advance_sky_lut()
            self._picked_sky = None

    def _update_tile(self, tex_idx: int, x0: int, y0: int,
                     bucket: Optional[float] = None, mesh=None) -> None:
        """Render one region² tile into cloud_ring[tex_idx] at (x0, y0) — the
        reference's per-frame compute dispatch (`cloud_sky.gd:234-248`) —
        by the arm `tile_arm` picks for its cull bucket (None: unculled):
        zeros for "skip" (`_clear_tile`), else the march, by replaying the
        v3 arm's graph on a card engine that has them
        (`_march_tile_v3_graph`), with the rows sharded over `mesh` when
        given, or by `_march_tile`. A bucket below 1.0 slices the tile's
        window of the cycle's priority map for fast2's ray ranking.

        mesh (the tick's tile of a mesh engine, as the JAX engine's sharded
        tile update): `shard_map`, one thread per shard.
        The parameters, the noise argument and the sky LUT are replicated;
        the window is sharded with the rays, so each shard culls its own
        rows (fast2's ray threshold is then per shard: close to, not equal
        to, the unsharded tile). Each shard takes the arm of its own rays,
        with its rows as the region and the mesh axis bound, so the v3 arm
        exchanges its prepass halo rows. The tile comes back on the mesh's
        first device. Either way it is written into the ring in place."""
        region = self.perf.update_region_size
        rays = region * region if mesh is None else region * region // mesh.size
        arm = tile_arm(self.kernel, bucket, rays)
        if arm == "skip":
            self._clear_tile(tex_idx, x0, y0)
            return
        if bucket is not None and bucket >= 1.0:
            bucket = None  # the 1.0 bucket marches unculled
        dirs = texel_directions(self.perf.texture_size, x0=x0, y0=y0, width=region,
                                height=region, device=self.device)
        window = None if bucket is None else \
            self._prio_map[y0:y0 + region, x0:x0 + region]
        kw = dict(steps=self.perf.march_steps, light_steps=self.perf.light_steps,
                  kernel=self.kernel, bucket=bucket)
        if arm == "v3" and self._v3_graphs is not None:
            tile = self._march_tile_v3_graph(dirs, bucket)
        elif mesh is not None:
            axis = mesh.axis_name
            noise = self._mesh_noise()
            params = replicate(self._march_params, mesh.devices)
            sky = replicate(self.sky_ring[self.ring.cloud_kernel_sky_slot], mesh.devices)

            def shard_fn(d, cp=None):
                i = axis_index(axis)
                return _march_tile(arm, d, params[i], noise[i], sky[i],
                                   region=max(d.shape[0], 1), cull_prio=cp,
                                   axis_name=axis, **kw)

            args = (dirs,) if window is None else (dirs, window)
            tile = shard_map(shard_fn, mesh, in_specs=(P(axis),) * len(args),
                             out_specs=P(axis))(*args)
        else:
            tile = _march_tile(arm, dirs, self._march_params, self._noise_arg,
                               self.sky_ring[self.ring.cloud_kernel_sky_slot],
                               region=region, cull_prio=window, **kw)
        self.cloud_ring[tex_idx, y0:y0 + region, x0:x0 + region] = tile  # in place

    def _march_tile_v3_graph(self, dirs, bucket: float):
        """The v3 arm of `_march_tile` for a card engine's tile, by replaying
        the CUDA graph of its cell bucket (`V3TileGraphs`): the tick's
        directions, sky-LUT slot, and the snapshot's parameters and cone
        table copied into the graphs' inputs, then one graph launch; the
        eager arm's tile, bitwise. The first such tile of a shape captures
        every bucket of V3_TILE_CELL_BUCKETS (the counterpart of the JAX
        engine's `_warm_fused_variants`), so no capture falls in a later
        tick. The span `tile.v3` around the copies, any captures and the
        replay, the span `v3.replay` around the replay (a replay opens no
        `v3.*` stage span); counted in `v3_graph_captures` and
        `v3_graph_replays`."""
        graphs = self._v3_graphs
        bricks, cone_cache = self._noise_arg
        with span("tile.v3"):
            graphs.load(dirs, self._march_params, bricks, cone_cache,
                        self.sky_ring[self.ring.cloud_kernel_sky_slot],
                        steps=self.perf.march_steps, light_steps=self.perf.light_steps)
            captures = graphs.capture(V3_TILE_CELL_BUCKETS + (bucket,))
            with span("v3.replay"):
                tile = graphs.replay(bucket)
        _count_v3_graphs(captures, 1)
        return tile

    def _mesh_noise(self) -> list:
        """The noise argument replicated over the mesh, one per shard
        (`replicate`: moved once to each distinct device), copied again
        only when it changes: the cone cache, once a cycle."""
        arg = self._noise_arg
        leaves = arg if isinstance(arg, tuple) else (arg,)
        cached = self._mesh_noise_cache
        if cached is None or any(a is not b for a, b in zip(cached[0], leaves)):
            cached = self._mesh_noise_cache = (leaves,
                                               replicate(arg, self.mesh.devices))
        return cached[1]

    def _clear_tile(self, tex_idx: int, x0: int, y0: int) -> None:
        """The tile-cull 0.0 bucket: a tile whose whole priority window sits
        below the keep margin renders what the march returns for all-culled
        rays, zeros, so the march is skipped: the span `tile.skip`, beside
        `_march_tile`'s arms."""
        region = self.perf.update_region_size
        with span("tile.skip"):
            self.cloud_ring[tex_idx, y0:y0 + region, x0:x0 + region] = 0.0  # in place

    def _write_tile(self) -> None:
        """This tick's tile at the cursor, at its cull bucket (`_update_tile`),
        sharded over the mesh when the engine has one."""
        x0, y0 = self.ring.update_position
        bucket = None
        if self.tile_cull and self._tile_buckets is not None:
            region = self.perf.update_region_size
            bucket = self._tile_buckets[(y0 // region) * (self.perf.texture_size // region)
                                        + x0 // region]
        self._update_tile(self.ring.texture_to_update, x0, y0, bucket, mesh=self.mesh)

    def _march_tiles_dense(self, tex_idx: int, start_tile: int, count: int) -> None:
        """The dense arm for `count` tiles from `start_tile` (row-major tile
        order) in one `march_tile_dense` call, chunked by BATCH_DENSE_CHUNK
        rays: the same rays, steps, cone cache and sky-LUT slot as one
        `_update_tile` a tile, so the same bits (the march is per ray and
        sample). The directions are the whole map's, permuted to tile order,
        and the tiles go back into the ring slot by one indexed write. The
        span `cycle.dense`."""
        region = self.perf.update_region_size
        size = self.perf.texture_size
        cols = size // region
        bricks, cone_cache = self._noise_arg
        with span("cycle.dense"):
            dirs = texel_directions(size, device=self.device).view(
                cols, region, cols, region, 3).permute(0, 2, 1, 3, 4).reshape(
                cols * cols, region, region, 3)[start_tile:start_tile + count]
            tiles = march_tile_dense(
                dirs, self._march_params, bricks,
                self.sky_ring[self.ring.cloud_kernel_sky_slot],
                steps=self.perf.march_steps, light_steps=self.perf.light_steps,
                chunk=BATCH_DENSE_CHUNK, cone_cache=cone_cache)
            # One in-place index_put into the ring slot, through its
            # tile-order view.
            by_tile = self.cloud_ring[tex_idx].view(
                cols, region, cols, region, 4).permute(0, 2, 1, 3, 4)
            k = torch.arange(start_tile, start_tile + count, device=self.device)
            by_tile[k // cols, k % cols] = tiles
        _count_batched(count)

    def _update_tiles_batch(self) -> None:
        """Render every remaining tile of the current cycle (unculled, as the
        JAX engine's batch) and advance the cursor/frame state to the cycle
        end. Where each tile takes the dense arm (`tile_arm`) the tiles
        march in one call
        (`_march_tiles_dense`); every other kernel, one `_update_tile` a
        tile."""
        n_frames = self.perf.frames_to_update
        region = self.perf.update_region_size
        tiles_per_row = self.perf.texture_size // region
        x, y = self.ring.update_position
        start_tile = (y // region) * tiles_per_row + (x // region)
        remaining = n_frames - self.ring.frame
        if remaining <= 0:
            return
        with span("cycle.tiles"):
            if tile_arm(self.kernel, None, region * region) == "dense":
                self._march_tiles_dense(self.ring.texture_to_update, start_tile,
                                        remaining)
            else:
                for k in range(remaining):
                    tile = start_tile + k
                    self._update_tile(self.ring.texture_to_update,
                                      (tile % tiles_per_row) * region,
                                      (tile // tiles_per_row) * region)
        self.ring.update_position = (0, 0)
        self.ring.frame = n_frames
        self._blend_amount = 1.0

    def _rotate(self, now: float) -> None:
        with span("engine.rotate"):
            self.ring.rotate_cloud()
            self._display_pair = None  # the blend pair changed
            self._refresh_frame_data(now)
            self._render_sky_lut()

    def update_cycle(self, now: Optional[float] = None) -> None:
        """Complete one full amortized cycle in one call (batch/offline use);
        the same rotation, snapshot and LUT phasing as `update_sky`."""
        if not self.can_run:
            return
        now = self._now(now)
        if self.needs_full_sky_init:
            self.needs_full_sky_init = False
            self.initialize_sky(now)
        if self.ring.frame >= self.perf.frames_to_update:
            self._rotate(now)
        self._update_tiles_batch()

    def initialize_sky(self, now: float) -> None:
        """Warm start (`cloud_sky.gd:123-127`): two full synchronous cycles
        so the sky is complete on the first visible frame."""
        self._display_pair = None
        self._refresh_frame_data(now)
        self._render_sky_lut()
        for _ in range(2):
            if self.ring.frame >= self.perf.frames_to_update:
                self._rotate(now)
            self._update_tiles_batch()

    def _begin_tick(self, now: Optional[float]) -> None:
        """The head of a per-frame tick (`cloud_sky.gd:129-152`): warm start
        on first use, rotation at a cycle boundary, and the display blend
        captured before the tile update (`cloud_sky.gd:152`)."""
        with span("tick.begin"):
            now = self._now(now)
            if self.needs_full_sky_init:
                self.needs_full_sky_init = False
                self.initialize_sky(now)
            if self.ring.frame >= self.perf.frames_to_update:
                self._rotate(now)
            self._blend_amount = self.ring.blend_amount(self.perf.frames_to_update)

    def _end_tick(self) -> None:
        """The tail of a tick: advance the cursor and the pending bake."""
        self.ring.advance_cursor(self.perf.update_region_size,
                                 self.perf.texture_size)
        self._advance_prebake()

    def update_sky(self, now: Optional[float] = None) -> None:
        """One per-frame tick (`cloud_sky.gd:129-163`): rotate rings at cycle
        boundaries, refresh FrameData + sky LUT, update one tile, advance
        the cursor, advance the pending bake. No work when `can_run` is
        false (`cloud_sky.gd:130-131`)."""
        if not self.can_run:
            return
        self._begin_tick(now)
        self._write_tile()
        self._end_tick()

    # --------------------------------------------------------------- display

    @property
    def blend_amount(self) -> float:
        return getattr(self, "_blend_amount",
                       self.ring.blend_amount(self.perf.frames_to_update))

    def render_view(self, eyedirs, deband: bool = False) -> torch.Tensor:
        """Composite the current sky for view directions eyedirs [..., 3]
        (world, on the engine's device) → [..., 3] linear HDR
        (`clouds.gdshader:104-116`)."""
        b0, b1 = self.ring.sky_back_textures
        with span("composite"):
            return composite(
                eyedirs.to(device=self.device, dtype=torch.float32),
                self.cloud_ring[self.ring.texture_to_blend_from],
                self.cloud_ring[self.ring.texture_to_blend_to],
                self.sky_ring[b0], self.sky_ring[b1], self.transmittance,
                self.blend_amount, self._light_dir(self.frame_data),
                self.config.sun_disk_scale, deband=deband)

    def _display_pair_tables(self):
        """The cycle's 8-channel display-pair textures, built on first
        use after a rotation (`_build_display_pair`); every place that
        changes the blend pair — rotation, warm start, restore — drops
        them."""
        if self._display_pair is None:
            b0, b1 = self.ring.sky_back_textures
            with span("display_pair.build"):
                self._display_pair = _build_display_pair(
                    self.cloud_ring, self.ring.texture_to_blend_from,
                    self.ring.texture_to_blend_to, self.sky_ring, b0, b1)
        return self._display_pair

    def _render_frame_fused(self, eyedirs, deband: bool) -> torch.Tensor:
        """The fused tick's body: this tick's tile (zeros for a 0.0 cull
        bucket, the JAX engine's `skip_march`), then `composite_display`
        over the display-pair tables, run in order on the current stream.
        What differs from the split tick is the composite: one pair row per
        texture per pixel from tables built once a cycle, where the split
        `composite` makes two bilinear fetches (from and to) per texture per
        pixel; on the card it is one launch of kernel K12, the sun passed as
        host floats, so the host copies nothing and never waits for the
        tile.

        The JAX engine compiles the fused executable for every bucket ahead
        of the cycle (`_warm_fused_variants`); the port's counterpart is the
        capture of a CUDA graph of the v3 tile arm for every cell bucket,
        on a card engine's first v3 tile (`_march_tile_v3_graph`)."""
        cloud_pair, sky_pair = self._display_pair_tables()
        self._write_tile()
        with span("composite_display"):
            return composite_display(
                eyedirs.to(device=self.device, dtype=torch.float32), cloud_pair,
                sky_pair, self.transmittance, self._light_floats(self.frame_data),
                self.config.sun_disk_scale, self._blend_amount, deband=deband)

    def render_frame(self, eyedirs, now: Optional[float] = None,
                     amortized: bool = True, fused: Optional[bool] = None,
                     deband: bool = False) -> torch.Tensor:
        """One-call serving API: advance the sim and composite a camera
        frame. amortized=True ticks one tile; amortized=False completes a
        whole cycle first and composites with `render_view`.

        fused (default: on when amortized without a mesh) serves the tick
        through `_render_frame_fused`: the same scheduling as `update_sky`,
        the composite over the cycle's display-pair tables. fused=False, and
        any tick of a mesh engine, is `update_sky` + `render_view`. The two
        agree to float reassociation (the pair lerps after one row fetch),
        with the rings bitwise equal. When `can_run` is false it only
        composites."""
        if fused is None:
            fused = amortized and self.mesh is None
        if not amortized:
            self.update_cycle(now)
            return self.render_view(eyedirs, deband=deband)
        if not fused or self.mesh is not None or not self.can_run:
            self.update_sky(now)
            return self.render_view(eyedirs, deband=deband)
        self._begin_tick(now)
        frame = self._render_frame_fused(eyedirs, deband)
        self._end_tick()
        return frame

    def _v3_march_knobs(self):
        """(prepass_steps, ray_stride) of the v3 march and the tile-cull
        prepass at this engine's shapes: `_prepass_steps(march_steps)`, and
        stride 2 when the texture edge is even."""
        return (_prepass_steps(self.perf.march_steps),
                2 if self.perf.texture_size % 2 == 0 else 1)

    def _v3_policy(self, params):
        """(ray, cell, hot) capacity buckets of the v3 render:
        `v3_auto_policy` over the full texel grid, cached for the cycle's
        snapshot (recomputed for explicitly passed params)."""
        cycle = params is self._march_params
        if cycle and self._v3_policy_cache is not None:
            return self._v3_policy_cache
        ps, stride = self._v3_march_knobs()
        rk, ck, hk, cell_frac, hot_frac = v3_auto_policy(
            texel_directions(self.perf.texture_size, device=self.device),
            params, self._bricks, steps=self.perf.march_steps,
            ray_stride=stride, prepass_steps=ps)
        if ps < 8:
            # Too few probes to rank rays by max-pre: keep every ray and let
            # the per-cell gate skip; rebase the cell/hot buckets to the
            # unculled totals.
            rk = 1.0
            ck = select_cell_keep_frac(cell_frac)
            hk = select_cell_keep_frac(hot_frac / max(ck, 1e-6), margin=1.2)
        if cycle:
            self._v3_policy_cache = (rk, ck, hk)
        return rk, ck, hk

    def render_full_hemisphere(self, params: Optional[MarchParams] = None,
                               sky_img=None) -> torch.Tensor:
        """Whole-map render with no amortization → [n, n, 4]: for fast3 the
        v3 cell-gated march with the cycle's cone cache and the snapshot's
        measured capacity buckets (K2, K3 on the card); for hier the
        banded hierarchical v3 march (4 row bands when the edge is a
        multiple of 4 and at least 256), its buckets from
        `hier_v3_auto_policy` over the whole texel grid, cached for the
        cycle's snapshot; for the other kernels their tile march over the
        whole map at the tiles' settings (fast2: v2 with the cone cache, K2
        and K1; fast: the exact brick march, K2; reference: the scan
        march)."""
        if params is None:
            params = self._march_params
        if sky_img is None:
            sky_img = self.sky_ring[self.ring.cloud_kernel_sky_slot]
        if self.kernel == "hier":
            return self._render_hier(params, sky_img)
        if self.kernel != "fast3":
            return _march_tile(
                tile_arm(self.kernel, None, self.perf.texture_size ** 2),
                texel_directions(self.perf.texture_size, device=self.device),
                params, self._noise_arg, sky_img,
                region=self.perf.update_region_size,
                steps=self.perf.march_steps,
                light_steps=self.perf.light_steps, kernel=self.kernel)
        rk, ck, hk = self._v3_policy(params)
        ps, stride = self._v3_march_knobs()
        n = self.perf.texture_size ** 2
        return march_bricks_v3(
            texel_directions(self.perf.texture_size, device=self.device),
            params, self._bricks, sky_img, steps=self.perf.march_steps,
            light_steps=self.perf.light_steps, chunk=min(n, 32768),
            cell_keep_frac=ck, hot_keep_frac=hk, cone_cache=self._cone_cache,
            ray_keep_frac=rk, prepass_steps=ps, ray_stride=stride)

    def _render_hier(self, params, sky_img) -> torch.Tensor:
        """The hier kernel's whole-map render (`render_full_hemisphere`).
        The window lattice takes ray stride 1 whatever the edge."""
        n_tex, steps = self.perf.texture_size, self.perf.march_steps
        bands = 4 if n_tex % 4 == 0 and n_tex >= 256 else 1
        coarse = min(32, max(8, steps // 4))
        ps, _ = self._v3_march_knobs()
        dirs = texel_directions(n_tex, device=self.device)
        cycle = params is self._march_params
        if cycle and self._v3_policy_cache is not None:
            rk, ck, hk = self._v3_policy_cache
        else:
            rk, ck, hk, _, _ = hier_v3_auto_policy(
                dirs, params, self._bricks, steps=steps, coarse_steps=coarse,
                bands=bands, prepass_steps=ps)
            if cycle:
                self._v3_policy_cache = (rk, ck, hk)
        return march_hierarchical_v3_banded(
            dirs, params, self._bricks, sky_img, bands=bands, steps=steps,
            light_steps=self.perf.light_steps,
            chunk=min(n_tex * n_tex // bands, 32768), coarse_steps=coarse,
            cell_keep_frac=ck, hot_keep_frac=hk, ray_keep_frac=rk,
            cone_cache=self._cone_cache, prepass_steps=ps, ray_stride=1)

    def render_radiance_map(self, size: int = 32, prefilter: bool = False):
        """Environment probe (the Sky resource's radiance cubemap,
        `cloud_sky/clouds_sky.tres:8`): the current sky composited over a
        6-face cubemap (`cubemap_directions`, GL face order).

        prefilter=False returns the sharp [6, size, size, 3] linear-HDR
        cubemap. prefilter=True returns the roughness mip chain: a list of
        [6, s, s, 3] levels at s = size, size/2, …, 4, level k the base
        convolved with a normalized cosine-power lobe of exponent
        2/r² − 2 at r = k / n_mips (`_prefilter_mip`, over the whole sphere,
        so face seams are exact)."""
        base = self.render_view(cubemap_directions(size, device=self.device))
        if not prefilter:
            return base
        n_in = 6 * size * size
        dirs_in = cubemap_directions(size, device=self.device).reshape(n_in, 3)
        sa_in = cubemap_solid_angles(size, device=self.device).reshape(n_in)
        colors = base.reshape(n_in, 3)
        sizes, s = [], size
        while s > 4:
            s //= 2
            sizes.append(s)
        sizes = sizes or [max(size // 2, 1)]
        mips = [base]
        for k, s in enumerate(sizes, start=1):
            r = k / len(sizes)
            exponent = max(2.0 / (r * r) - 2.0, 1.0) if r < 1.0 else 1.0
            out = _prefilter_mip(colors, dirs_in, sa_in,
                                 cubemap_directions(s, device=self.device).reshape(-1, 3),
                                 float(exponent))
            mips.append(out.reshape(6, s, s, 3))
        return mips

    # ------------------------------------------------------------ checkpoint

    def save(self) -> Dict[str, Any]:
        """Checkpointable state: parameters, wind integrals, ring indices and
        the texture rings, as numpy arrays and plain types (the JAX engine's
        `save()` format)."""
        return {
            "perf": dataclasses.asdict(self.perf),
            "config": dataclasses.asdict(self.config),
            "sun": dataclasses.asdict(self.sun),
            "frame_data": dataclasses.asdict(self.frame_data),
            "ring": dataclasses.asdict(self.ring),
            "cloud_ring": self.cloud_ring.cpu().numpy(),
            "sky_ring": self.sky_ring.cpu().numpy(),
            "sky_lut_needs_full_update": self._sky_lut_needs_full_update,
            "needs_full_sky_init": self.needs_full_sky_init,
            "blend_amount": self.blend_amount,
        }

    def save_file(self, path: str) -> None:
        """Write `save()` to one .npz: the two rings and the rest as a JSON
        header (uint8), the JAX engine's layout, so either package loads
        the other's file."""
        state = self.save()
        header = {k: v for k, v in state.items() if k not in ("cloud_ring", "sky_ring")}
        header["frame_data"] = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                                for k, v in header["frame_data"].items()}
        np.savez_compressed(
            path, cloud_ring=state["cloud_ring"], sky_ring=state["sky_ring"],
            header=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8))

    def load_file(self, path: str) -> None:
        """Restore from a `save_file` .npz (this engine's or the JAX
        engine's)."""
        with np.load(path) as z:
            state = json.loads(bytes(z["header"]).decode())
            state["cloud_ring"] = z["cloud_ring"]
            state["sky_ring"] = z["sky_ring"]
        self.restore(state)

    def restore(self, state: Dict[str, Any]) -> None:
        """Load a `save()` dict — this engine's or the JAX engine's."""
        def tup(v):
            return tuple(v) if isinstance(v, (list, tuple)) else v

        self.perf = PerfConfig(**state["perf"]).validate()
        self.config = CloudConfig(**{k: tup(v) for k, v in state["config"].items()})
        self.sun = SunState(**{k: tup(v) for k, v in state["sun"].items()})
        fd = FrameData()
        for k, v in state["frame_data"].items():
            setattr(fd, k, np.asarray(v) if isinstance(v, (list, np.ndarray)) else v)
        self.frame_data = fd
        ring = RingState()
        for k, v in state["ring"].items():
            setattr(ring, k, tup(v))
        self.ring = ring
        # np.array copies, so the rings never alias the caller's arrays.
        self.cloud_ring = torch.from_numpy(
            np.array(state["cloud_ring"], np.float32)).to(self.device)
        self.sky_ring = torch.from_numpy(
            np.array(state["sky_ring"], np.float32)).to(self.device)
        self._display_pair = None
        self._sky_lut_needs_full_update = state["sky_lut_needs_full_update"]
        self._blend_amount = state.get("blend_amount", 0.0)
        self.needs_full_sky_init = state.get(
            "needs_full_sky_init", not bool(np.any(np.asarray(state["cloud_ring"]))))
        self._march_params = self.frame_data.to_march_params(self.device)
        # The prebake pipeline restarts from the restored snapshot (the next
        # rotation takes the synchronous build once). As in the JAX engine,
        # the tile-cull map and buckets are kept until that rotation.
        self._head_frame_data = copy.deepcopy(self.frame_data)
        self._pending = None
        self._picked_sky = None
        self._v3_policy_cache = None
        self._derive_prebake_schedule()
        if self._staged:
            self._cone_cache = self._build_cone(self._march_params)
