"""Cloud marches on the noise textures and the per-cycle cone cache (torch).

The port of `cloudscape_tpu.models.march_fast`. The JAX package samples
brick tables; the port keeps the same values as channel-last textures
(`ops/brick.py`), sampled by kernels K7 and K8 on the card:

- `BrickPack`: the noise pack as textures, channels precombined (3-D
  textures optionally stored in bfloat16);
- the Schneider density on those textures (`clouds.glsl:109-137`), split at
  the erosion stage (`_density_pre_xyz` / `_density_finish_xyz`);
- the exact brick march (`march_bricks`): every sample's density, then the
  17-sample secondary (sun) march (`clouds.glsl:184-199`) on every sample
  (`compact=False`, `_march_chunk`) or only on the samples that can still
  be seen, compacted by kernel K2 (`_march_core`); the referee of every
  faster march, held against the scan march of `models/march.py`;
- the per-cycle cone-density cache (`ConeCache`): the sun march
  precomputed on a shell-aligned grid, either in one call
  (`build_cone_cache` = `cone_occupancy_indices` → the cone march of the
  occupied cells → `assemble_cone_cache`) or in slices spread over a
  cycle's ticks (`cone_occupancy_slice` → `cone_occupancy_finalize` →
  `bake_cone_cells` → `cone_table_rows` → `wrap_cone_table`); a 1-channel
  clamp-wrap texture;
- the dense tile march (`march_tile_dense`): every (ray, step) sample
  evaluated, then the phase-3 accumulation through kernel K1;
- the cell-gated v3 march (`march_bricks_v3`) and its capacity policy
  (`v3_auto_policy`): ray cull, live- and hot-cell compactions, and the
  hot-list accumulation through kernel K3 (segmented scan);
- the staged v2 march (`march_bricks_v2`) and its policy
  (`v2_auto_policy`): ray cull, one shared occupied-sample compaction,
  erosion and cone lookup on that list, phase 3 through K1. It serves the
  engine's "fast2" kernel and the "fast3" tiles of ≥ 65,536 rays;
- the hierarchical marches of config 5 and the engine's "hier" kernel
  (`march_hierarchical`, `march_hierarchical_v3`, their banded forms and
  `hier_v3_auto_policy`): each ray's step budget spread over its occupied
  window, found by a coarse pass;
- the tile-cull map (the engine's: `cull_raw_slice` → `cull_finalize`,
  sliced over a cycle's ticks or in one slice; the JAX API's one pass:
  `cull_priority_map`): per-ray priorities
  and per-tile ray-keep and live-cell fractions, from which the engine
  picks each tile's bucket (skip, v3 cell bucket or v2 ray bucket, dense).

Some of this surface exists for parity with the JAX API, and no engine
kernel reaches it (the tests hold it against JAX): `BrickPack.from_noise`'s
`dtype`, `march_bricks`' `approx_light`, `cone_cache_res` and dense
`compact=False` arm, the `[..., 3]` wrappers `_weather_rb`,
`_density_pre`, `_density_bricks` and `_cone_density`, the sliced bake's
`chunk`, and `march_bricks_v3`'s `debug_stage` probes, which time its
stages one by one on the card (chip_smoke.py phase 8c).

Every compaction goes through kernel K2 (`compact`).
Sample positions use the closed form p_i = p0 + dir·ss·i; the
accumulation is the prefix-product form of `clouds.glsl:206-210`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

from cloudscape_tpu_torch.config import GROUND_RADIUS, SKY_B_RADIUS, SKY_T_RADIUS
from cloudscape_tpu_torch.models.density import MarchParams, NoisePack
from cloudscape_tpu_torch.models.march import (RANDOM_VECTORS, ambient_colors,
                                               device_constant)
from cloudscape_tpu_torch.ops import math as m
from cloudscape_tpu_torch.ops.accum import accumulate
from cloudscape_tpu_torch.ops.brick import (
    SAMPLE_CHUNK,
    Texture2D,
    Texture3D,
    TinyVolume3D,
    build_texture2,
    build_texture3,
    build_tiny3,
    sample_tex2_xy,
    sample_tex3_xyz,
    sample_tiny3_xyz,
)
from cloudscape_tpu_torch.ops.compact import compact
from cloudscape_tpu_torch.ops.segscan import segscan
from cloudscape_tpu_torch.parallel.sharding import axis_size, ppermute
from cloudscape_tpu_torch.utils.profiling import span

Volume = Union[Texture3D, TinyVolume3D]

# Sun-march step length (`clouds.glsl:185`).
LSS = (SKY_T_RADIUS - SKY_B_RADIUS) / 64.0


@dataclasses.dataclass(frozen=True)
class BrickPack:
    """Texture mirror of a NoisePack with channels precombined (exact:
    FBM dot products and box-filter mips commute with lerp):
    large → (R, FBM), small → (hfbm), weather → (cloud_type, coverage).
    The JAX package's BrickPack holds the same values as brick tables."""

    large: Tuple[Volume, ...]
    small: Tuple[Volume, ...]
    weather: Texture2D

    @staticmethod
    def from_noise(noise: NoisePack, dtype=None) -> "BrickPack":
        """dtype: storage dtype of the 3-D noise textures, built in float32
        and cast (None keeps float32; `torch.bfloat16` halves them, opt-in).
        The samplers multiply their texels by float32 weights, so samples
        come out float32. The weather texture stays float32: its coverage
        channel feeds a hard threshold."""
        def cast(vol):
            if dtype is None:
                return vol
            if isinstance(vol, Texture3D):
                return dataclasses.replace(vol, texels=vol.texels.to(dtype))
            return dataclasses.replace(vol, row=vol.row.to(dtype))

        large = []
        for a in noise.large:
            combined = torch.stack(
                [a[..., 0], a[..., 1] * 0.625 + a[..., 2] * 0.25 + a[..., 3] * 0.125],
                dim=-1)
            large.append(cast(build_tiny3(combined) if combined.numel() <= 128
                              else build_texture3(combined)))
        small = []
        for a in noise.small:
            combined = (a[..., 0] * 0.625 + a[..., 1] * 0.25 + a[..., 2] * 0.125)[..., None]
            small.append(cast(build_tiny3(combined) if combined.numel() <= 128
                              else build_texture3(combined)))
        w = noise.weather
        weather = build_texture2(torch.stack([w[..., 0], w[..., 2]], dim=-1))
        return BrickPack(large=tuple(large), small=tuple(small), weather=weather)


def _sample_volume_xyz(vol: Volume, qx, qy, qz):
    """Trilinear fetch from a texture (K7) or a tiny volume (K9) → [..., C]."""
    if isinstance(vol, TinyVolume3D):
        return sample_tiny3_xyz(vol, qx, qy, qz)
    return sample_tex3_xyz(vol, qx, qy, qz)


def _weather_rb(bp: BrickPack, pxz, weather_pos):
    """(cloud_type, coverage) weather fetch (`clouds.glsl:169-174`) at
    pxz [..., 2] (world x, z)."""
    return _weather_rb_xy(bp, pxz[..., 0], pxz[..., 1], weather_pos)


def _weather_rb_xy(bp: BrickPack, px, pz, weather_pos):
    """`_weather_rb` on component planes."""
    return sample_tex2_xy(bp.weather,
                          px * 0.00006 + 0.5 + weather_pos[0],
                          pz * 0.00006 + 0.5 + weather_pos[1])


def _density_pre_xyz(px, py, pz, weather_rb, mip: float, params: MarchParams,
                     bp: BrickPack):
    """First half of the Schneider density (`clouds.glsl:109-125`): base
    shape + coverage remap, before detail erosion. Returns (pre, hf);
    erosion only reduces density and maps pre ≤ 0 to exactly 0, so `pre > 0`
    is an exact occupancy predicate."""
    hf = m.height_fraction(torch.sqrt(px * px + py * py + pz * pz),
                           SKY_B_RADIUS, SKY_T_RADIUS)
    offset = 20.0 * params.cloud_pos * 0.6
    bx = px + offset[0]
    bz = pz + offset[1]
    lod_l = int(min(max(mip - 2.0, 0.0), len(bp.large) - 1))
    n = _sample_volume_xyz(bp.large[lod_l], bx * 0.00008, py * 0.00008,
                           bz * 0.00008)  # [..., 2] (R, FBM)
    g = m.density_height_gradient(hf, weather_rb[..., 0])
    base_cloud = m.remap(n[..., 0], -(1.0 - n[..., 1]), 1.0, 0.0, 1.0)
    weather_coverage = params.cloud_coverage * weather_rb[..., 1]
    base_cloud = (base_cloud * g - (1.0 - weather_coverage)) / torch.clamp(
        weather_coverage, min=1e-6)
    return base_cloud * weather_coverage, hf


def _density_finish_xyz(pre, hf, px, py, pz, mip: float, params: MarchParams,
                        bp: BrickPack):
    """Second half (`clouds.glsl:127-136`): detail erosion + final shaping."""
    offset = 20.0 * params.cloud_pos * 0.6
    dx = (px + offset[0] - params.detailed_pos[0] * 40.0) * 0.001
    dy = (py - params.time * 40.0) * 0.001
    dz = (pz + offset[1] - params.detailed_pos[1] * 40.0) * 0.001
    lod_s = int(min(max(mip, 0.0), len(bp.small) - 1))
    hfbm = _sample_volume_xyz(bp.small[lod_s], dx, dy, dz)[..., 0]
    hfbm = hfbm + (1.0 - 2.0 * hfbm) * torch.clamp(hf * 4.0, 0.0, 1.0)
    base_cloud = m.remap(pre, hfbm * 0.4 * hf, 1.0, 0.0, 1.0)
    return torch.pow(torch.clamp(base_cloud, 0.0, 1.0), (1.0 - hf) * 0.8 + 0.5)


def _density_bricks_xyz(px, py, pz, weather_rb, mip: float,
                        params: MarchParams, bp: BrickPack):
    """Full Schneider density on brick tables. Returns (density, hf)."""
    pre, hf = _density_pre_xyz(px, py, pz, weather_rb, mip, params, bp)
    return _density_finish_xyz(pre, hf, px, py, pz, mip, params, bp), hf


def _density_pre(p, weather_rb, mip: float, params: MarchParams,
                 bp: BrickPack):
    """[..., 3] wrapper over `_density_pre_xyz`."""
    return _density_pre_xyz(p[..., 0], p[..., 1], p[..., 2], weather_rb, mip,
                            params, bp)


def _density_bricks(p, weather_rb, mip: float, params: MarchParams,
                    bp: BrickPack):
    """[..., 3] wrapper over `_density_bricks_xyz`."""
    return _density_bricks_xyz(p[..., 0], p[..., 1], p[..., 2], weather_rb,
                               mip, params, bp)


def _ray_setup(dirs, params: MarchParams, steps: int):
    """Per-ray geometry: (above, ndir, ss, p0, phase, ldir). Rays below the
    horizon are redirected straight up (their output is zeroed later)."""
    dev = dirs.device
    above = dirs[..., 1] > 0.0
    up = device_constant((0.0, 1.0, 0.0), dev)
    ndir = torch.where(above[..., None], dirs, up)
    cam = device_constant((0.0, GROUND_RADIUS, 0.0), dev)
    cam_b = cam.expand(ndir.shape)
    start = cam + ndir * m.intersect_sphere_far(cam_b, ndir, SKY_B_RADIUS)[..., None]
    end = cam + ndir * m.intersect_sphere_far(cam_b, ndir, SKY_T_RADIUS)[..., None]
    ss = m.norm3(end - start) / steps
    p0 = start + ndir * (m.hash_iq(start * 10.0) * ss)[..., None]

    ldir = params.light_direction / m.norm3(params.light_direction)
    costheta = m.dot3(ldir, ndir)
    phase = torch.maximum(
        torch.maximum(m.henyey_greenstein(costheta, 0.6),
                      m.henyey_greenstein(costheta, 0.4 - 1.4 * ldir[1])),
        m.henyey_greenstein(costheta, -0.2))
    return above, ndir, ss, p0, phase, ldir


def _sample_xyz(p0, ndir, tt):
    """World positions (px, py, pz) = p0 + ndir·t of the ray samples at
    distances tt [n, k]."""
    return tuple(p0[:, a, None] + ndir[:, a, None] * tt for a in range(3))


def _light_offsets(ldir, light_steps: int):
    """Cumulative cone offsets (`clouds.glsl:187`): after j steps the light
    sample sits at p + Σ_{k≤j} (ldir + RANDOM_VECTORS[k]·k)·lss; plus the
    distant sample's offset and lss."""
    rv = device_constant(RANDOM_VECTORS[:light_steps], ldir.device)
    k = torch.arange(light_steps, dtype=torch.float32, device=ldir.device)
    offsets = torch.cumsum((ldir[None, :] + rv * k[:, None]) * LSS, dim=0)
    return offsets, ldir * (18.0 * LSS), LSS


def _cone_density_xyz(px, py, pz, params: MarchParams, bp: BrickPack,
                      light_offsets, distant_offset, light_steps: int,
                      approx_weather: bool = False):
    """Secondary (sun) march density sum `cd` (`clouds.glsl:184-199`).
    approx_weather reuses the weather fetch at the sample position for the
    six cone samples (the cone spans ≲ 0.1 weather texel), saving 6 of the
    17 fetch rows."""
    cd = torch.zeros_like(px)
    shared_weather = (_weather_rb_xy(bp, px, pz, params.weather_pos)
                      if approx_weather else None)
    for j in range(light_steps):
        lx = px + light_offsets[j, 0]
        ly = py + light_offsets[j, 1]
        lz = pz + light_offsets[j, 2]
        lweather = (shared_weather if approx_weather
                    else _weather_rb_xy(bp, lx, lz, params.weather_pos))
        lt, _ = _density_bricks_xyz(lx, ly, lz, lweather, float(j), params, bp)
        cd = cd + lt

    lx = px + distant_offset[0]
    ly = py + distant_offset[1]
    lz = pz + distant_offset[2]
    lhf = m.height_fraction(torch.sqrt(lx * lx + ly * ly + lz * lz),
                            SKY_B_RADIUS, SKY_T_RADIUS)
    # Quirk preserved: no + weather_pos on the distant sample (`clouds.glsl:197`).
    lweather = sample_tex2_xy(bp.weather, lx * 0.00006 + 0.5,
                              lz * 0.00006 + 0.5)
    ldens, _ = _density_bricks_xyz(lx, ly, lz, lweather, 5.0, params, bp)
    return cd + torch.pow(ldens, (1.0 - lhf) * 0.8 + 0.5)


def _cone_density(p, params: MarchParams, bp: BrickPack, light_offsets,
                  distant_offset, light_steps: int, approx_weather: bool = False):
    """[..., 3] wrapper over `_cone_density_xyz`."""
    return _cone_density_xyz(p[..., 0], p[..., 1], p[..., 2], params, bp,
                             light_offsets, distant_offset, light_steps,
                             approx_weather)


def _ceil_to(v: int, mult: int) -> int:
    return (v + mult - 1) // mult * mult


def _map_rows(fn, chunk: int, *arrays):
    """fn over consecutive `chunk`-row slices of the arrays, concatenated
    along dim 0 (a tuple result concatenates element by element)."""
    n = arrays[0].shape[0]
    outs = [fn(*(a[i:i + chunk] for a in arrays)) for i in range(0, n, chunk)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))
    return torch.cat(outs, dim=0)


def _pad_blocks(flat, chunk: int, fill):
    """Pad the leading dim to a multiple of chunk with rows equal to `fill`
    and reshape to [k, chunk, ...]."""
    n_pad = (-flat.shape[0]) % chunk
    if n_pad:
        pad = torch.as_tensor(fill, dtype=flat.dtype, device=flat.device).expand(
            (n_pad,) + tuple(flat.shape[1:]))
        flat = torch.cat([flat, pad], dim=0)
    return flat.reshape((-1, chunk) + tuple(flat.shape[1:]))


def _compact_mask(mask_flat, capacity: int, total: int):
    """Indices of the first `capacity` set entries (ascending, fill=total),
    through kernel K2 (its plain version for CPU tensors); no rank."""
    return compact(mask_flat, capacity, total, with_rank=False)[0]


# ------------------------------------------------------------- cone cache

CONE_BRICK = (8, 4, 4)
CONE_STRIDE = (7, 3, 3)


@dataclasses.dataclass(frozen=True)
class ConeCache:
    """Shell-aligned cone-density field: cd precomputed on a
    (height-fraction, warped-z, warped-x) grid, valid for one FrameData
    snapshot (one amortized cycle). The horizontal axes use a sqrt warp
    x = sign(l)·l²·extent with l = 2(x̂ − 0.5), concentrating resolution
    near the viewer."""

    table: Texture3D  # [n_hf, n_z, n_x, 1], clamp-wrap (cd)
    extent: float = 220e3


def _cone_cache_coords_xyz(px, py, pz, extent: float):
    """World position components → cache uvw components (x̂, ẑ, hf)."""
    def warp(v):
        return 0.5 + 0.5 * torch.sign(v) * torch.sqrt(torch.abs(v) / extent)

    hf = m.height_fraction(torch.sqrt(px * px + py * py + pz * pz),
                           SKY_B_RADIUS, SKY_T_RADIUS)
    return warp(px), warp(pz), hf


def cone_capacity(n: int, sparse_capacity_frac: float, chunk: int) -> int:
    """Compacted-cell capacity of the sparse cone bake, shared by
    `build_cone_cache` and the sliced bake so both march the same cells."""
    capacity = max(int(n * sparse_capacity_frac), chunk)
    return capacity + (-capacity) % chunk


def _unwarp(c, extent: float):
    l = 2.0 * (c - 0.5)
    return torch.sign(l) * l * l * extent


def _cell_centers(flat_idx, res, extent: float):
    """World positions of cone-grid cells from flat cell indices (clamped
    to the grid; fill entries land on the last cell)."""
    nd, nh, nw = res
    n = nd * nh * nw
    safe = torch.clamp(flat_idx.to(torch.int64), max=n - 1)
    iz = safe // (nh * nw)
    iy = (safe // nw) % nh
    ix = safe % nw
    cx = _unwarp((ix.to(torch.float32) + 0.5) / nw, extent)
    cz = _unwarp((iy.to(torch.float32) + 0.5) / nh, extent)
    cr = SKY_B_RADIUS + ((iz.to(torch.float32) + 0.5) / nd) * (
        SKY_T_RADIUS - SKY_B_RADIUS)
    cy = torch.sqrt(torch.clamp(cr * cr - cx * cx - cz * cz, min=1.0))
    return cx, cy, cz


def _pre_positive(px, py, pz, params: MarchParams, bp: BrickPack):
    pre, _ = _density_pre_xyz(px, py, pz,
                              _weather_rb_xy(bp, px, pz, params.weather_pos),
                              0.0, params, bp)
    return pre > 0.0


def _dilate(occ_flat, res):
    """One-cell dilation per axis (the trilinear query footprint)."""
    occ = occ_flat.reshape(res)
    for ax in range(3):
        occ = occ | torch.roll(occ, 1, ax) | torch.roll(occ, -1, ax)
    return occ.reshape(-1)


def _cone_cells(cells, params: MarchParams, bp: BrickPack, light_steps: int,
                res, extent: float):
    """Cone-march density at the centers of the given flat cells."""
    ldir = params.light_direction / m.norm3(params.light_direction)
    light_offsets, distant_offset, _ = _light_offsets(ldir, light_steps)
    cx, cy, cz = _cell_centers(cells, res, extent)
    return _cone_density_xyz(cx, cy, cz, params, bp, light_offsets,
                             distant_offset, light_steps)


def cone_occupancy_indices(params: MarchParams, bp: BrickPack,
                           res=(16, 256, 256), extent: float = 220e3,
                           chunk: int = 16384,
                           sparse_capacity_frac: float = 0.45):
    """The cone bake's occupancy in one pass: the `pre > 0` predicate at
    every cell center of the grid, dilated by one cell per axis (the
    trilinear query footprint), compacted by kernel K2 into
    `cone_capacity` slots → the ascending occupied-cell indices, fill = n.
    The sliced form (`cone_occupancy_slice` → `cone_occupancy_finalize`)
    gives the same indices."""
    nd, nh, nw = res
    n = nd * nh * nw
    dev = bp.weather.texels.device
    xs = _unwarp((torch.arange(nw, dtype=torch.float32, device=dev) + 0.5) / nw, extent)
    zs = _unwarp((torch.arange(nh, dtype=torch.float32, device=dev) + 0.5) / nh, extent)
    hfs = (torch.arange(nd, dtype=torch.float32, device=dev) + 0.5) / nd
    r = SKY_B_RADIUS + hfs * (SKY_T_RADIUS - SKY_B_RADIUS)
    x = xs[None, None, :]
    z = zs[None, :, None]
    rr = r[:, None, None]
    # Beyond-horizon cells have no shell point; clamp onto the shell. The
    # same roundings as `_cell_centers` (r² − x² − z², left to right), so
    # the sliced occupancy keeps the same cells: grouped as r² − (x² + z²),
    # ~130 of the 8.4 M cells of a (32, 512, 512) grid came out otherwise.
    y = torch.sqrt(torch.clamp(rr * rr - x * x - z * z, min=1.0))
    px, py, pz = (v.expand(res).reshape(-1) for v in (x, y, z))
    occ = _dilate(_pre_positive(px, py, pz, params, bp), res)
    return _compact_mask(occ, cone_capacity(n, sparse_capacity_frac, chunk), n)


def assemble_cone_cache(cd_vol, extent: float = 220e3) -> ConeCache:
    """A fully baked [nd, nh, nw] cone-density volume as the cache's
    clamp-wrap texture (in one call; `cone_table_rows` + `wrap_cone_table`
    is the sliced form). The JAX package packs it into a brick table of
    CONE_BRICK bricks at CONE_STRIDE; the texture holds the same texels
    once and samples to the same values."""
    return ConeCache(table=build_texture3(cd_vol[..., None], wrap="clamp"),
                     extent=extent)


def build_cone_cache(params: MarchParams, bp: BrickPack,
                     light_steps: int = 6, res=(16, 256, 256),
                     extent: float = 220e3, chunk: int = 16384,
                     sparse_capacity_frac: float = 0.45) -> ConeCache:
    """Evaluate the cone density on the cache grid and pack it into a
    clamp-wrap brick table. res = (n_hf, n_z, n_x). The cone march runs only
    on the cells `cone_occupancy_indices` keeps; overflow leaves far cells
    at cd = 0."""
    n = res[0] * res[1] * res[2]
    idx = cone_occupancy_indices(params, bp, res, extent, chunk,
                                 sparse_capacity_frac)
    cd = torch.zeros((n + 1,), dtype=torch.float32, device=idx.device)
    # Fill entries (idx == n) land in the spare last slot and are dropped.
    cd[idx.to(torch.int64)] = _cone_cells(idx, params, bp, light_steps, res, extent)
    return assemble_cone_cache(cd[:n].reshape(res), extent)


def cone_occupancy_slice(occ, i0: int, params: MarchParams, bp: BrickPack,
                         count: int, res=(16, 256, 256),
                         extent: float = 220e3, chunk: int = 16384):
    """Stage 0 of the sliced cone bake: the `pre > 0` predicate for the flat
    cells [i0, i0 + count), written IN PLACE into the bool buffer `occ`
    ([nd*nh*nw]). All slices then `cone_occupancy_finalize` give the same
    cells as `build_cone_cache`'s occupancy pass (elementwise per cell).
    The cells are evaluated in pieces of at most `chunk`, which bounds the
    temporaries; the result does not depend on it."""
    for c0 in range(i0, i0 + count, chunk):
        k = min(chunk, i0 + count - c0)
        cx, cy, cz = _cell_centers(c0 + torch.arange(k, device=occ.device),
                                   res, extent)
        occ[c0:c0 + k] = _pre_positive(cx, cy, cz, params, bp)
    return occ


def cone_occupancy_finalize(occ, res=(16, 256, 256), chunk: int = 16384,
                            sparse_capacity_frac: float = 0.45):
    """Dilation + compaction (kernel K2) of the sliced occupancy buffer →
    the compacted cell indices, fill = n."""
    n = res[0] * res[1] * res[2]
    return _compact_mask(_dilate(occ, res),
                         cone_capacity(n, sparse_capacity_frac, chunk), n)


def bake_cone_cells(vol, idx, i0: int, params: MarchParams, bp: BrickPack,
                    count: int, light_steps: int = 6, res=(16, 256, 256),
                    extent: float = 220e3, chunk: int = 16384):
    """Stage 2 of the sliced cone bake: cone-march the compacted cells
    `idx[i0 : i0 + count]` and write them IN PLACE into the flat volume
    `vol` ([nd*nh*nw + 1]; the spare last slot absorbs fill entries), in
    pieces of at most `chunk` cells (the result does not depend on it)."""
    end = min(i0 + count, idx.shape[0])
    for c0 in range(i0, end, chunk):
        sl = idx[c0:min(c0 + chunk, end)]
        vol[sl.to(torch.int64)] = _cone_cells(sl, params, bp, light_steps, res,
                                              extent)
    return vol


def cone_table_rows(cd_vol, b0: int, count: int):
    """Rows [b0, b0 + count) of the cone cache's texture seen as [n, 1]
    (one texel a row, flat (hf, z, x) order): a view of `cd_vol`. Writing
    every range into an [n, 1] tensor, then `wrap_cone_table`, gives
    `build_cone_cache`'s texture."""
    return cd_vol.reshape(-1, 1)[b0:b0 + count]


def wrap_cone_table(table, res, extent: float = 220e3) -> ConeCache:
    """Metadata-only constructor around a fully written cone volume of n
    values in flat (hf, z, x) order, e.g. [n] or [n, 1] (it is not copied)."""
    return ConeCache(
        table=Texture3D(texels=table.reshape(tuple(res) + (1,)), dims=tuple(res),
                        channels=1, wrap="clamp"),
        extent=extent)


# ------------------------------------------------------------ dense march

def _accumulate_phase3(t, cd, hf, ss, phase, above, params: MarchParams,
                       atmos, lss: float):
    """Phase 3: fold the planes as the TPU path does (march_fast.py:1432-1440)
    and accumulate through kernel K1. t, cd, hf: [n, steps]."""
    atmosphere_sun, atmosphere_ambient, atmosphere_ground = atmos
    A = (-params.density) * t * ss[:, None]
    cd3 = (-params.density * lss * 3.0) * cd
    scal = torch.cat([atmosphere_sun.reshape(-1)[:3],
                      atmosphere_ambient.reshape(-1)[:3],
                      atmosphere_ground.reshape(-1)[:3],
                      torch.zeros(3, dtype=torch.float32, device=t.device)])
    return accumulate(A.contiguous(), cd3.contiguous(), hf.contiguous(),
                      phase.contiguous(), above.contiguous(), scal)


def _march_core_dense(above, ndir, ss, p0, phase, params: MarchParams,
                      bp: BrickPack, atmos, steps: int, chunk: int,
                      cone_cache: ConeCache):
    """Staged march evaluated densely on every (ray, step) sample: weather →
    pre → erosion (masked to pre > 0) → cone-cache lookup (masked to t > 0),
    then the phase-3 accumulation, a chunk of `chunk` rays at a time. Both
    phases are per ray, so the planes live one chunk at a time and the
    output does not depend on `chunk`."""
    n = ndir.shape[0]
    i_step = torch.arange(1, steps + 1, dtype=torch.float32, device=ndir.device)
    outs = []
    for r0 in range(0, n, chunk):
        sl = slice(r0, r0 + chunk)
        with span("dense.passes"):
            px, py, pz = _sample_xyz(p0[sl], ndir[sl], ss[sl, None] * i_step[None, :])
            weather = _weather_rb_xy(bp, px, pz, params.weather_pos)
            pre, hf = _density_pre_xyz(px, py, pz, weather, 0.0, params, bp)
            t = torch.where(pre > 0.0, _density_finish_xyz(
                pre, hf, px, py, pz, 0.0, params, bp), 0.0)
            qx, qz, qh = _cone_cache_coords_xyz(px, py, pz, cone_cache.extent)
            cd = torch.where(t > 0.0, sample_tex3_xyz(cone_cache.table, qx, qz, qh)[..., 0],
                             0.0)
        with span("dense.accumulate"):
            outs.append(_accumulate_phase3(t, cd, hf, ss[sl], phase[sl], above[sl],
                                           params, atmos, LSS))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def march_tile_dense(dirs, params: MarchParams, bp: BrickPack, sky_lut_img,
                     steps: int = 128, light_steps: int = 6,
                     chunk: int = 16384, cone_cache: ConeCache | None = None,
                     cone_res=(32, 512, 512)):
    """Dense small-tile march over world directions [..., 3] → [..., 4]
    (L rgb, alpha): the serving-tile arm of the engine's "fast3" kernel."""
    dirs = dirs.to(torch.float32)
    shape = dirs.shape[:-1]
    flat = dirs.reshape(-1, 3)
    n = flat.shape[0]
    if cone_cache is None:
        cone_cache = build_cone_cache(params, bp, light_steps, res=cone_res,
                                      chunk=min(chunk, max(n, 1)))
    with span("dense.setup"):
        atmos = ambient_colors(params, sky_lut_img)
        above, ndir, ss, p0, phase, _ = _ray_setup(flat, params, steps)
    out = _march_core_dense(above, ndir, ss, p0, phase, params, bp, atmos,
                            steps, min(chunk, max(n, 1)), cone_cache)
    return out.reshape(shape + (4,))


# ------------------------------------------------------- exact brick march
#
# `march_bricks`: every sample's density on the brick tables, and the sun
# march evaluated per sample (no cone cache unless one is given). The dense
# form (`_march_chunk`) runs the sun march on every sample; the compacted
# form (`_march_core`) runs it only on samples with t > 0 whose prefix
# transmittance exceeds t_cutoff, compacted by kernel K2. Phase 3 is plain
# PyTorch, the JAX package's prefix-product formula, so the referee does
# not depend on kernel K1, which the marches it referees run.

# Samples per piece of `_march_core`'s phase 2. Pieces bound only the
# memory of the per-sample temporaries (the samplers chunk their gathers by
# SAMPLE_CHUNK), so they are far larger than the JAX package's `chunk`-sized
# `lax.map` pieces; the output does not depend on them.
CONE_PIECE = 16 * SAMPLE_CHUNK


def _prefix_accumulate(t, cd, hf, dt, t_prefix, beers_mask, phase, params,
                       atmos, lss: float):
    """Phase B on [n, steps] planes (`clouds.glsl:201-210` in prefix-product
    form): L = Σ_i T_{<i}·radiance_i·(1 − dt_i)/max(t_i, 1e-7), alpha =
    1 − Π dt. beers_mask (or None) zeroes the sun term of the samples it
    excludes. Returns [n, 4]."""
    atmosphere_sun, atmosphere_ambient, atmosphere_ground = atmos
    beers = torch.exp(-params.density * cd * lss * 3.0)
    powder = 1.0 - torch.exp(-params.density * cd * lss * 6.0)
    beers_total = 2.0 * beers * powder
    if beers_mask is not None:
        beers_total = torch.where(beers_mask, beers_total, 0.0)
    ambient = atmosphere_ground + (atmosphere_ambient - atmosphere_ground) * \
        m.smoothstep(0.0, 1.0, hf)[..., None]
    radiance = (ambient + (beers_total * phase[:, None])[..., None] * atmosphere_sun) \
        * t[..., None]
    contrib = t_prefix[..., None] * (radiance - radiance * dt[..., None]) / \
        torch.clamp(t, min=1e-7)[..., None]
    L = torch.sum(contrib, dim=1)
    alpha = torch.clamp(1.0 - torch.prod(dt, dim=1), 0.0, 1.0)
    return torch.cat([L, alpha[..., None]], dim=-1)


def _transmittance(t, ss, params: MarchParams):
    """(dt, exclusive prefix product of dt) of [n, steps] densities."""
    dt = torch.exp(-params.density * t * ss[:, None])
    t_prefix = torch.cat([torch.ones_like(dt[:, :1]),
                          torch.cumprod(dt, dim=1)[:, :-1]], dim=1)
    return dt, t_prefix


def _march_chunk(dirs, params: MarchParams, bp: BrickPack, atmos,
                 steps: int, light_steps: int):
    """Dense Phase A+B for one chunk of rays: the density and the sun march
    at every sample, then the prefix-product accumulation. dirs: [n, 3] →
    [n, 4]."""
    above, ndir, ss, p0, phase, ldir = _ray_setup(dirs, params, steps)
    light_offsets, distant_offset, lss = _light_offsets(ldir, light_steps)
    i_step = torch.arange(1, steps + 1, dtype=torch.float32, device=dirs.device)
    px, py, pz = _sample_xyz(p0, ndir, ss[:, None] * i_step[None, :])
    weather = _weather_rb_xy(bp, px, pz, params.weather_pos)
    t, hf = _density_bricks_xyz(px, py, pz, weather, 0.0, params, bp)
    cd = _cone_density_xyz(px, py, pz, params, bp, light_offsets,
                           distant_offset, light_steps)
    dt, t_prefix = _transmittance(t, ss, params)
    out = _prefix_accumulate(t, cd, hf, dt, t_prefix, None, phase, params,
                             atmos, lss)
    return torch.where(above[:, None], out, 0.0)


def _flat_sample_xyz(geom, ip, steps: int):
    """World positions of the samples at flat indices ip (ray·steps +
    step) of a [rays, steps] lattice whose per-ray geometry sits in one
    row of geom (p0 xyz, ndir xyz, ss), gathered once per sample: as
    `_sample_xyz` places them, p0 + ndir·ss·(step + 1)."""
    g = geom[torch.clamp(ip // steps, max=geom.shape[0] - 1)]
    tt = g[:, 6] * ((ip % steps).to(torch.float32) + 1.0)
    return tuple(g[:, a] + g[:, 3 + a] * tt for a in range(3))


def _march_core(above, ndir, ss, p0, phase, ldir, params: MarchParams,
                bp: BrickPack, atmos, steps: int, light_steps: int,
                chunk: int, capacity_frac: float, t_cutoff: float,
                approx_light: bool = False, cone_cache: ConeCache | None = None):
    """Compacted march over prepared rays → [n, 4].

    1. Dense, `chunk` rays at a time: the primary density t and height
       fraction at every sample.
    2. The sun march only matters where t > 0 (the reference's own
       `if (t > 0)` guard) and where the prefix transmittance still
       exceeds t_cutoff. Those samples are compacted by kernel K2 into
       capacity_frac · n · steps slots (rounded up to `chunk`; overflow
       drops the sun term of the excess samples), their positions are
       recomputed from the flat indices, and each gets the 17-sample sun
       march, or one cone-cache lookup when `cone_cache` is given. The
       JAX package maps over every slot in `chunk`-sized pieces; this one
       reads the compacted count once and marches only the filled slots,
       in pieces of CONE_PIECE samples (fill slots are dropped by the
       scatter either way). The results are scattered back to an
       [n, steps] plane.
    3. The prefix-product accumulation, `chunk` rays at a time."""
    n = ndir.shape[0]
    dev = ndir.device
    light_offsets, distant_offset, lss = _light_offsets(ldir, light_steps)
    i_step = torch.arange(1, steps + 1, dtype=torch.float32, device=dev)
    total = n * steps

    def dense_chunk(p0c, ndirc, ssc):
        px, py, pz = _sample_xyz(p0c, ndirc, ssc[:, None] * i_step[None, :])
        weather = _weather_rb_xy(bp, px, pz, params.weather_pos)
        return _density_bricks_xyz(px, py, pz, weather, 0.0, params, bp)

    t, hf = _map_rows(dense_chunk, chunk, p0, ndir, ss)
    dt, t_prefix = _transmittance(t, ss, params)

    # ---- Phase 2: the sun march where it can matter.
    active = (t > 0.0) & (t_prefix > t_cutoff) & above[:, None]
    capacity = max(int(total * capacity_frac), chunk)
    capacity += (-capacity) % chunk
    idx = _compact_mask(active.reshape(-1), capacity, total)
    idx = idx[:int(torch.count_nonzero(idx < total))].to(torch.int64)
    geom = torch.cat([p0, ndir, ss[:, None]], dim=1)

    def cone_piece(ip):
        ax, ay, az = _flat_sample_xyz(geom, ip, steps)
        if cone_cache is not None:
            qx, qz, qh = _cone_cache_coords_xyz(ax, ay, az, cone_cache.extent)
            return sample_tex3_xyz(cone_cache.table, qx, qz, qh)[..., 0]
        return _cone_density_xyz(ax, ay, az, params, bp, light_offsets,
                                 distant_offset, light_steps,
                                 approx_weather=approx_light)

    cd = torch.zeros((total,), dtype=torch.float32, device=dev)
    if idx.numel():
        cd[idx] = _map_rows(cone_piece, CONE_PIECE, idx)
    cd = cd.reshape(n, steps)

    # ---- Phase 3: accumulation.
    def accum_chunk(tc, cdc, hfc, dtc, tpc, actc, phc):
        return _prefix_accumulate(tc, cdc, hfc, dtc, tpc, actc, phc, params,
                                  atmos, lss)

    out = _map_rows(accum_chunk, chunk, t, cd, hf, dt, t_prefix, active, phase)
    return torch.where(above[:, None], out, 0.0)


def _march_compact(flat, params: MarchParams, bp: BrickPack, atmos,
                   steps: int, light_steps: int, chunk: int,
                   capacity_frac: float, t_cutoff: float,
                   approx_light: bool = False,
                   cone_cache: ConeCache | None = None):
    """The compacted march over world directions [n, 3]: per-ray setup,
    then `_march_core`."""
    above, ndir, ss, p0, phase, ldir = _ray_setup(flat, params, steps)
    return _march_core(above, ndir, ss, p0, phase, ldir, params, bp, atmos,
                       steps, light_steps, chunk, capacity_frac, t_cutoff,
                       approx_light, cone_cache)


def march_bricks(dirs, params: MarchParams, bp: BrickPack, sky_lut_img,
                 steps: int = 128, light_steps: int = 6, chunk: int = 16384,
                 compact: bool = True, capacity_frac: float = 0.25,
                 t_cutoff: float = 1e-4, approx_light: bool = False,
                 cone_cache: ConeCache | None = None, cone_cache_res=None):
    """The exact brick march over world directions [..., 3] → [..., 4]
    (L rgb, alpha). compact=True: `_march_core` (K2 compaction of the
    samples the sun march can matter for); compact=False: the dense
    `_march_chunk`, `chunk` rays at a time (the last chunk padded with
    below-horizon rays, which march to zeros, and cut off). chunk bounds the
    memory of the dense passes. cone_cache (compact only) replaces the sun
    march with one cache lookup; cone_cache_res builds such a cache when
    none is given."""
    dirs = dirs.to(torch.float32)
    shape = tuple(dirs.shape[:-1])
    flat = dirs.reshape(-1, 3)
    n = flat.shape[0]
    atmos = ambient_colors(params, sky_lut_img)
    if cone_cache is None and cone_cache_res is not None:
        cone_cache = build_cone_cache(params, bp, light_steps, res=cone_cache_res,
                                      chunk=min(chunk, max(n, 1)))
    if compact:
        out = _march_compact(flat, params, bp, atmos, steps, light_steps,
                             min(chunk, max(n, 1)), capacity_frac, t_cutoff,
                             approx_light, cone_cache)
        return out.reshape(shape + (4,))
    if n <= chunk:
        return _march_chunk(flat, params, bp, atmos, steps,
                            light_steps).reshape(shape + (4,))
    blocks = _pad_blocks(flat, chunk, (0.0, -1.0, 0.0))
    out = torch.cat([_march_chunk(b, params, bp, atmos, steps, light_steps)
                     for b in blocks])[:n]
    return out.reshape(shape + (4,))


# ---------------------------------------------------- v3 cell-gated march
#
# The full-hemisphere re-render (`march_bricks_v3`): a coarse prepass scores
# rays and marks live coarse cells; the top rays are kept; live cells are
# compacted (K2) and their samples run the weather + pre-erosion passes;
# cells with any `pre > 0` sample are compacted again (K2) into the hot list,
# which runs erosion and the cone-cache lookup; the hot list is accumulated
# with segmented scans (K3) and reduced at its segment ends (K2). The JAX
# package's `lax.map` over padded chunks becomes a plain loop over chunks:
# padded rows were sliced off there, so their results are the same without
# them.

def _halo_rows(a, axis_name: str):
    """±1-row halo of a grid whose rows are sharded over the mesh axis
    `axis_name`: each shard receives its upper neighbour's last row and its
    lower neighbour's first row through a cyclic `ppermute` ring, whose
    wrap reproduces `torch.roll`'s, so a dilation of the halo'd block is
    bitwise the unsharded dilation of the whole grid. Returns [rows + 2,
    ...] (halo row 0 above, row -1 below)."""
    n = axis_size(axis_name)
    down = [(i, (i + 1) % n) for i in range(n)]
    up = [(i, (i - 1) % n) for i in range(n)]
    top = ppermute(a[-1:], axis_name, down)
    bot = ppermute(a[:1], axis_name, up)
    return torch.cat([top, a, bot], dim=0)


def _dilate_max(m2, axis_name: str | None = None):
    """3×3 max dilation of a 2-D grid with wrap-around, separable (rows then
    columns). axis_name: the grid's rows are sharded over that mesh axis,
    and the row pass takes a `_halo_rows` halo instead of `torch.roll`
    (bitwise equal)."""
    if axis_name is None:
        d = torch.maximum(m2, torch.maximum(torch.roll(m2, 1, 0),
                                            torch.roll(m2, -1, 0)))
    else:
        e = _halo_rows(m2, axis_name)
        d = torch.maximum(e[1:-1], torch.maximum(e[:-2], e[2:]))
    return torch.maximum(d, torch.maximum(torch.roll(d, 1, 1), torch.roll(d, -1, 1)))


def _cull_prepass(above, ndir, ss, p0, params: MarchParams, bp: BrickPack,
                  steps: int, prepass_steps: int, chunk: int,
                  cull_shape: tuple | None, ray_stride: int = 1,
                  cell_margin: float | None = None,
                  axis_name: str | None = None):
    """Coarse prepass shared by the ray cull and the v3 cell gate.

    Returns (prio, occ_cells, meta):

    - prio [n]: max `pre` over `prepass_steps` coarse samples per ray, with
      a 3×3 neighbour bonus (dilation − 0.1) when the 2-D ray grid is known,
      and −inf below the horizon;
    - occ_cells [n_coarse, prepass_steps] bool (None when cell_margin is
      None): `pre > -cell_margin` per (coarse ray, coarse cell), dilated 3×3
      across rays on a grid and ±1 along the ray;
    - meta (gh, gw, stride) mapping full rays to occ_cells rows (None without
      a grid: occ_cells is then per ray).

    Three arms: a 2-D grid with ray_stride > 1 dividing both sides scores
    every stride-th ray per axis and nearest-upsamples the dilated priority;
    a 2-D grid otherwise scores every ray; a flat ray list gets no dilation
    across rays. axis_name (inside `shard_map` only): the grid's rows are
    sharded over that mesh axis, and the dilations across rows exchange
    one boundary row with the neighbouring shards (`_halo_rows`), so the
    sharded priority and cell gate are bitwise the unsharded ones."""
    n = ndir.shape[0]
    dev = ndir.device
    i_pre = (torch.arange(prepass_steps, dtype=torch.float32, device=dev) + 1.0) \
        * float(steps // prepass_steps)
    cells = cell_margin is not None

    def prepass_chunk(p0c, ndirc, ssc):
        px, py, pz = _sample_xyz(p0c, ndirc, ssc[:, None] * i_pre[None, :])
        w =_weather_rb_xy(bp, px, pz, params.weather_pos)
        pre_p, _ = _density_pre_xyz(px, py, pz, w, 0.0, params, bp)
        top = torch.max(pre_p, dim=1).values
        if not cells:
            return top
        return top, pre_p > -cell_margin

    grid = cull_shape is not None and len(cull_shape) == 2
    sub = ray_stride > 1 and grid \
        and cull_shape[0] % ray_stride == 0 and cull_shape[1] % ray_stride == 0
    if sub:
        H, W = cull_shape
        hs, ws = H // ray_stride, W // ray_stride

        def coarse(a):
            return a.reshape((H, W) + a.shape[1:])[::ray_stride, ::ray_stride] \
                .reshape((hs * ws,) + a.shape[1:])

        above_p, ndir_p, ss_p, p0_p = coarse(above), coarse(ndir), coarse(ss), coarse(p0)
        n_p = hs * ws
    else:
        above_p, ndir_p, ss_p, p0_p, n_p = above, ndir, ss, p0, n

    mapped = _map_rows(prepass_chunk, min(chunk, n_p), p0_p, ndir_p, ss_p)
    occ_cells = None
    meta = None
    if cells:
        prio, occ = mapped
        if grid:
            gh, gw = (hs, ws) if sub else cull_shape
            o = occ.reshape(gh, gw, prepass_steps)
            if axis_name is None:
                o = o | torch.roll(o, 1, 0) | torch.roll(o, -1, 0)
            else:
                e = _halo_rows(o, axis_name)
                o = e[1:-1] | e[:-2] | e[2:]
            o = o | torch.roll(o, 1, 1) | torch.roll(o, -1, 1)
            occ = o.reshape(n_p, prepass_steps)
            meta = (gh, gw, ray_stride if sub else 1)
        pad0 = torch.zeros_like(occ[:, :1])
        occ_cells = occ | torch.cat([pad0, occ[:, :-1]], dim=1) \
            | torch.cat([occ[:, 1:], pad0], dim=1)
    else:
        prio = mapped
    neg_inf = float("-inf")
    prio = torch.where(above_p, prio, neg_inf)
    if sub:
        d2 = torch.maximum(prio.reshape(hs, ws),
                           _dilate_max(prio.reshape(hs, ws), axis_name) - 0.1)
        prio = d2.repeat_interleave(ray_stride, dim=0) \
            .repeat_interleave(ray_stride, dim=1).reshape(-1)
        return torch.where(above, prio, neg_inf), occ_cells, meta
    if grid:
        m2 = prio.reshape(cull_shape)
        prio = torch.where(above, torch.maximum(
            prio, _dilate_max(m2, axis_name).reshape(-1) - 0.1), neg_inf)
    return prio, occ_cells, meta


def _cull_priority(above, ndir, ss, p0, params: MarchParams, bp: BrickPack,
                   steps: int, prepass_steps: int, chunk: int,
                   cull_shape: tuple | None, ray_stride: int = 1):
    """Priority-only view of `_cull_prepass`."""
    return _cull_prepass(above, ndir, ss, p0, params, bp, steps, prepass_steps,
                         chunk, cull_shape, ray_stride)[0]


def _select_top_rays(prio, ray_cap: int, n: int):
    """Indices (ascending, fill = n) of about the top ray_cap rays by
    priority, without a sort: a 256-bin histogram over the useful `pre`
    range picks the first bin whose rays from it upward fit, then the rays
    at or above it are compacted in index order (kernel K2). Under tight
    capacity the lowest-priority bin drops first."""
    finite = torch.isfinite(prio)
    pb = torch.clamp((prio + 0.5) * 256.0, 0.0, 255.0).to(torch.int64)
    # Non-finite rays go to a spare bin 256 that the select ignores.
    hist = torch.bincount(torch.where(finite, pb, 256), minlength=257)[:256]
    above_cnt = torch.flip(torch.cumsum(torch.flip(hist, [0]), 0), [0])
    fits = (above_cnt <= ray_cap).to(torch.int32)
    # argmax returns the first maximum: the first fitting bin. If even the
    # top bin overflows, the drops stay inside the top bin.
    bsel = torch.where(fits.any(), torch.argmax(fits), 255)
    return _compact_mask(finite & (pb >= bsel), ray_cap, n)


def _ray_capacity(n: int, ray_keep_frac: float, align: int = 256) -> int:
    """Culled-ray capacity: ray_keep_frac·n rounded up to `align`, at least
    `align`, at most n."""
    cap = max(int(n * ray_keep_frac + align - 1) // align * align, align)
    return min(cap, n)


# ------------------------------------------------------- engine tile cull
#
# The engine's per-cycle cull map: the prepass over the whole texel grid,
# either in one call (`cull_priority_map`) or in ray slices spread over a
# cycle's ticks (`cull_raw_slice` → `cull_finalize`). Per tile it gives the
# fraction of rays above the keep margin (fast2's ray bucket) and the
# fraction of live coarse cells (fast3's v3 cell bucket).

def _tile_cell_fracs(occ_cells, gh: int, gw: int, stride: int, region: int):
    """Per-tile live (coarse ray, coarse cell) fraction of a dilated
    occupancy grid whose rows are the stride-subsampled [gh, gw] grid; a
    region² tile covers region/stride coarse rows and columns."""
    P = occ_cells.shape[-1]
    r = max(region // stride, 1)
    o = occ_cells.reshape(gh, gw, P).to(torch.float32)
    return o.reshape(gh // r, r, gw // r, r, P).mean(dim=(1, 3, 4))


def _tile_means(keep, region: int):
    """[H, W] → per region² tile means [H/region, W/region]."""
    H, W = keep.shape
    return keep.reshape(H // region, region, W // region, region).mean(dim=(1, 3))


def cull_raw_slice(buf, dirs_sub, i0: int, params: MarchParams, bp: BrickPack,
                   count: int, steps: int = 128, prepass_steps: int = 32,
                   chunk: int = 32768):
    """One slice of the engine's sliced cull prepass: the raw `pre` at the
    coarse probe samples of subsampled rays [i0, i0 + count) (not masked by
    the horizon; `cull_finalize` masks), written into `buf`
    [n_sub, prepass_steps] in place. Needs i0 + count ≤ n_sub."""
    _, ndir, ss, p0, _, _ = _ray_setup(dirs_sub[i0:i0 + count], params, steps)
    i_pre = (torch.arange(prepass_steps, dtype=torch.float32, device=ndir.device)
             + 1.0) * float(steps // prepass_steps)

    def prepass_chunk(p0c, ndirc, ssc):
        px, py, pz = _sample_xyz(p0c, ndirc, ssc[:, None] * i_pre[None, :])
        w = _weather_rb_xy(bp, px, pz, params.weather_pos)
        return _density_pre_xyz(px, py, pz, w, 0.0, params, bp)[0]

    buf[i0:i0 + count] = _map_rows(prepass_chunk, min(chunk, count), p0, ndir, ss)


def cull_finalize(raw, dirs, region: int, ray_stride: int = 2,
                  prepass_margin: float = 0.02, cell_margin: float = 0.1):
    """The tail of `cull_priority_map(cell_margin=...)` on a raw buffer that
    `cull_raw_slice` filled: per-ray priority (max over the cells, then the
    horizon mask), the neighbour bonus and nearest upsample, the per-tile
    keep fractions, and the per-tile live-cell fractions of the dilated
    occupancy (dilated before the horizon mask, as `_cull_prepass` does).
    dirs: [H, W, 3]. Returns (prio [H, W], tile_keep, tile_cell), both
    [H/region, W/region]."""
    H, W = dirs.shape[:2]
    hs, ws = H // ray_stride, W // ray_stride
    P = raw.shape[-1]
    neg_inf = float("-inf")
    above = dirs[..., 1] > 0.0
    above_sub = above[::ray_stride, ::ray_stride].reshape(-1)
    r2 = torch.where(above_sub, torch.max(raw, dim=1).values,
                     neg_inf).reshape(hs, ws)
    d2 = torch.maximum(r2, _dilate_max(r2) - 0.1)
    prio = d2.repeat_interleave(ray_stride, dim=0) \
        .repeat_interleave(ray_stride, dim=1)
    prio = torch.where(above, prio, neg_inf)
    tile_keep = _tile_means((prio > -prepass_margin).to(torch.float32), region)
    o = (raw > -cell_margin).reshape(hs, ws, P)
    o = o | torch.roll(o, 1, 0) | torch.roll(o, -1, 0)
    o = o | torch.roll(o, 1, 1) | torch.roll(o, -1, 1)
    o = o.reshape(hs * ws, P)
    pad0 = torch.zeros_like(o[:, :1])
    o = o | torch.cat([pad0, o[:, :-1]], dim=1) | torch.cat([o[:, 1:], pad0], dim=1)
    tile_cell = _tile_cell_fracs(o & above_sub[:, None], hs, ws, ray_stride,
                                 region)
    return prio, tile_keep, tile_cell


def cull_priority_map(dirs, params: MarchParams, bp: BrickPack,
                      steps: int = 128, prepass_steps: int = 32,
                      chunk: int = 32768, ray_stride: int = 2,
                      region: int | None = None,
                      prepass_margin: float = 0.02,
                      cell_margin: float | None = None):
    """The cull priority map of a whole [H, W, 3] direction grid, for the
    engine's per-tile culling (one map serves every tile of a cycle).
    Returns (prio [H, W], tile_keep [H/region, W/region] or None without a
    region); with cell_margin, also tile_cell, the per-tile live-cell
    fractions of `_cull_prepass`'s dilated occupancy with the rays below the
    horizon masked (fast3's per-tile v3 cell buckets). The engine builds
    its map through `cull_raw_slice` → `cull_finalize`; this one-pass form
    (and its region=None arm) is the JAX function's API, which the tests
    hold the port and the sliced form against."""
    dirs = dirs.to(torch.float32)
    shape = tuple(dirs.shape[:-1])
    flat = dirs.reshape(-1, 3)
    above, ndir, ss, p0, _, _ = _ray_setup(flat, params, steps)
    prio, occ_cells, meta = _cull_prepass(
        above, ndir, ss, p0, params, bp, steps, prepass_steps,
        min(chunk, max(flat.shape[0], 1)), shape, ray_stride, cell_margin)
    prio = prio.reshape(shape)
    if region is None:
        return (prio, None) if cell_margin is None else (prio, None, None)
    tile_keep = _tile_means((prio > -prepass_margin).to(torch.float32), region)
    if cell_margin is None:
        return prio, tile_keep
    H, W = shape
    gh, gw, stride = meta if meta is not None else (H, W, 1)
    above_sub = above.reshape(H, W)[::stride, ::stride].reshape(-1)
    tile_cell = _tile_cell_fracs(occ_cells & above_sub[:, None], gh, gw, stride,
                                 region)
    return prio, tile_keep, tile_cell


def v3_capacities(n: int, steps: int, chunk: int, cell_keep_frac: float,
                  ray_keep_frac: float | None = None, prepass_steps: int = 32,
                  hot_keep_frac: float = 0.5):
    """(kept rays, live-cell capacity cap_c, hot-cell capacity cap_h) of
    `march_bricks_v3` over n rays: Python ints from the JAX package's
    expressions, so both compact to the same lengths."""
    chunk = min(chunk, max(n, 1))
    if ray_keep_frac is not None and ray_keep_frac < 1.0:
        n = _ray_capacity(n, ray_keep_frac)
        chunk = min(chunk, n)
    total_cells = n * prepass_steps
    cap_c = min(_ceil_to(max(int(total_cells * cell_keep_frac), chunk), chunk),
                _ceil_to(total_cells, chunk))
    cap_h = min(_ceil_to(max(int(cap_c * hot_keep_frac), chunk), chunk), cap_c)
    return n, cap_c, cap_h


def _seg_end_reduce(cellsums, incl, head, ray_h, n: int, cap_h: int):
    """Per-ray totals of the hot list at its segment ends: segmented-scan
    the [3, cap_h] radiance channels `cellsums` in one call (K3; the
    log-transmittance scan `incl` already ran), compact the segment-end
    positions (K2; at most one per ray, since ray_h is sorted and the fill
    suffix merges into the last segment with +0), gather the totals there
    and write them to their rays. Returns
    ([3 × [n]] radiance, [n] log-transmittance)."""
    dev = incl.device
    seg_end = torch.cat([head[1:], torch.ones((1,), dtype=torch.bool, device=dev)])
    cap_e = min(_ceil_to(n, 128), cap_h)
    sidx = _compact_mask(seg_end, cap_e, cap_h)
    ssafe = torch.clamp(sidx, max=cap_h - 1).to(torch.int64)
    # Fill ends route to the spare slot n, which is sliced off.
    rid = torch.where(sidx < cap_h, ray_h[ssafe], n)

    def per_ray(tot):
        buf = torch.zeros((n + 1,), dtype=torch.float32, device=dev)
        buf[rid] = tot[ssafe]
        return buf[:n]

    bufs = [per_ray(s) for s in segscan(cellsums, head)]
    return bufs, per_ray(incl)


def _accumulate_segmented(t_h, cd_h, hf_h, g_h, ray_h, valid_h, n: int,
                          spc: int, params: MarchParams, atmos, lss: float):
    """Hot-list accumulation (`accum="segmented"`): the per-ray
    transmittance prefix and radiance sums computed on the [spc·cap_h] hot
    sample list, with no [n, steps] planes. Dead samples have t = 0, so
    dt = 1 and zero radiance: skipping them changes nothing. The prefix
    product Π exp(A_j) becomes exp(Σ A_j), the cross-cell part a segmented
    scan over each ray's ascending hot cells (K3), which keeps the sums
    ray-local. The JAX package takes this segment-end form on the TPU; off
    it, per-ray scatter-adds, which the tests hold this one against."""
    atmosphere_sun, atmosphere_ambient, atmosphere_ground = atmos
    cap_h = valid_h.shape[0]
    t_l = torch.where(valid_h[None, :], t_h.reshape(spc, cap_h), 0.0)
    cd_l = cd_h.reshape(spc, cap_h)
    hf_l = hf_h.reshape(spc, cap_h)
    ss_h = g_h[:, 6]
    phase_h = g_h[:, 7]

    A_l = (-params.density) * t_l * ss_h[None, :]  # log dt per lane, ≤ 0
    excl = torch.cat([torch.zeros((1, cap_h), dtype=torch.float32, device=t_l.device),
                      torch.cumsum(A_l[:-1], dim=0)], dim=0)
    cell_logdt = excl[-1] + A_l[-1]  # [cap_h] per-cell total

    head = torch.cat([torch.ones((1,), dtype=torch.bool, device=t_l.device),
                      ray_h[1:] != ray_h[:-1]])
    incl = segscan(cell_logdt, head)
    ray_excl = incl - cell_logdt

    dt_l = torch.exp(A_l)
    t_prefix = torch.exp(ray_excl[None, :] + excl)
    beers = torch.exp((-params.density * lss * 3.0) * cd_l)
    powder = 1.0 - torch.exp((-params.density * lss * 6.0) * cd_l)
    beers_total = torch.where(t_l > 0.0, 2.0 * beers * powder, 0.0)
    sm = m.smoothstep(0.0, 1.0, hf_l)
    bt_phase = beers_total * phase_h[None, :]
    shared = t_prefix * (1.0 - dt_l) * (t_l / torch.clamp(t_l, min=1e-7))

    # Each channel's sum is written into its row, so K3 scans the three
    # rows without a copy.
    cellsums = torch.empty((3, cap_h), dtype=torch.float32, device=t_l.device)
    for c in range(3):
        ambient_c = atmosphere_ground[c] + \
            (atmosphere_ambient[c] - atmosphere_ground[c]) * sm
        torch.sum(shared * (ambient_c + bt_phase * atmosphere_sun[c]), dim=0,
                  out=cellsums[c])

    bufs, logT = _seg_end_reduce(cellsums, incl, head, ray_h, n, cap_h)
    alpha = torch.clamp(1.0 - torch.exp(logT), 0.0, 1.0)
    return torch.stack(bufs + [alpha], dim=-1)


def _march_core3(above, ndir, ss, p0, phase, params: MarchParams,
                 bp: BrickPack, atmos, steps: int, chunk: int,
                 cell_keep_frac: float, cone_cache: ConeCache,
                 ray_keep_frac: float | None = None,
                 prepass_steps: int = 32, cull_shape: tuple | None = None,
                 ray_stride: int = 1, cell_margin: float = 0.1,
                 hot_keep_frac: float = 0.5, debug_stage: int = 0,
                 axis_name: str | None = None, accum: str = "segmented"):
    """Cell-gated march core (v3).

    1. `_cull_prepass` scores rays and marks live coarse cells (each covers
       steps/prepass_steps fine steps; `pre > -cell_margin` at its probe,
       dilated). Outside a live cell `pre ≤ 0` up to the margin, so the
       density is 0.
    2. With ray_keep_frac < 1 the top rays are kept (`_select_top_rays`).
    3. Live cells are compacted (K2) into cap_c slots; their samples, laid
       out lane-major (lane l's block is a [cap_c] slice), run the weather
       and pre-erosion passes.
    4. Cells with any `pre > 0` sample (the exact occupancy predicate) are
       compacted again (K2) into cap_h hot slots, which run erosion and the
       cone-cache lookup.
    5. accum="segmented": `_accumulate_segmented` on the hot list (K3, K2);
       accum="planes": t and cd scattered to [n, steps] planes, hf
       recomputed densely, phase 3 through K1.

    Overflow of either capacity drops the highest-index cells (size them
    with `v3_auto_policy`). Fine sample placement is the dense march's.

    debug_stage k in 1..9 returns after stage k a zero [n_out, 4] probe
    whose [0, 0] is the sum of that stage's tensors (as float32), the JAX
    package's probes; only stages 1..k run, so timing stage k against
    stage k − 1 gives that stage's cost. 1: the prepass (prio, occ_cells);
    2: the top-ray select (ridx, occ_cells; only with ray_keep_frac < 1,
    else the full render); 3: the live-cell compaction and the lane
    positions (sx, sy, sz); 4: the weather pass alone (w_r, w_b); 5: the
    weather and pre pass (pre_s, hf_s); 6: the hot-cell compaction (pre_h,
    hf_h, hx); 7: the erosion pass alone (t_h); 8: the erosion and cone
    pass (t_h, cd_h); 9: the accumulation before the scatter back, its
    [n, 4] output (segmented) or the t, cd and hf planes (planes). Other
    values render. Stages 4 and 7 run a pass that the render fuses with
    the next one; with debug_stage 0 the passes stay fused."""
    n = ndir.shape[0]
    n_out = n
    dev = ndir.device
    P = prepass_steps
    if steps % P:
        raise ValueError(f"prepass_steps {P} must divide steps {steps}")
    spc = steps // P

    def _dbg(*xs):
        probe = sum(torch.sum(x.to(torch.float32)) for x in xs)
        out = torch.zeros((n_out, 4), dtype=torch.float32, device=dev)
        out[0, 0] = probe
        return out

    with span("v3.prepass"):
        prio, occ_cells, meta = _cull_prepass(
            above, ndir, ss, p0, params, bp, steps, P, chunk, cull_shape,
            ray_stride, cell_margin, axis_name)
    if debug_stage == 1:
        return _dbg(prio, occ_cells)

    n_kept, cap_c, cap_h = v3_capacities(n, steps, chunk, cell_keep_frac,
                                         ray_keep_frac, P, hot_keep_frac)
    cull = ray_keep_frac is not None and ray_keep_frac < 1.0
    if cull:
        with span("v3.select"):
            ray_cap = n_kept
            chunk = min(chunk, ray_cap)
            ridx = _select_top_rays(prio, ray_cap, n)
            if debug_stage == 2:
                return _dbg(ridx, occ_cells)
            valid_r = ridx < n
            safe_r = torch.clamp(ridx, max=n - 1).to(torch.int64)
            g_r = torch.cat([p0, ndir, ss[:, None], phase[:, None]], dim=1)[safe_r]
            p0, ndir, ss, phase = g_r[:, 0:3], g_r[:, 3:6], g_r[:, 6], g_r[:, 7]
            above = above[safe_r] & valid_r
            ray_ids = safe_r
            n = ray_cap
    else:
        ray_ids = None

    with span("v3.live_compact"):
        # Per-(kept-)ray live-cell rows from the prepass's coarse grid.
        if meta is not None:
            gh, gw, stride = meta
            W = cull_shape[1]
            if ray_ids is None:
                if stride == 1:
                    occ_rows = occ_cells
                else:
                    occ_rows = occ_cells.reshape(gh, 1, gw, 1, P).expand(
                        gh, stride, gw, stride, P).reshape(n, P)
            else:
                ci = (ray_ids // W // stride) * gw + (ray_ids % W) // stride
                occ_rows = occ_cells[ci]
        elif ray_ids is None:
            occ_rows = occ_cells
        else:
            occ_rows = occ_cells[ray_ids]
        live = occ_rows & above[:, None]  # [n, P]
        total_cells = n * P

        # ---- Live-cell compaction (K2).
        cidx = _compact_mask(live.reshape(-1), cap_c, total_cells)
        valid_c = cidx < total_cells
        ray_i = torch.clamp(cidx // P, max=n - 1).to(torch.int64)
        cell_k = (cidx % P).to(torch.float32)

        # Per-ray geometry in one 8-wide row (p0 xyz, ndir xyz, ss, phase),
        # gathered once per cell.
        geom = torch.cat([p0, ndir, ss[:, None], phase[:, None]], dim=1)
        g = geom[ray_i]

        def lane_positions(gg, ck):
            """Sample positions of each cell's spc steps, lane-major: lane l's
            block is a [cells] slice, in the order the JAX march lays them."""
            return [torch.cat([gg[:, axis] + gg[:, 3 + axis]
                               * (gg[:, 6] * (ck * spc + float(l + 1)))
                               for l in range(spc)])
                    for axis in range(3)]

        sx, sy, sz = lane_positions(g, cell_k)
    if debug_stage == 3:
        return _dbg(sx, sy, sz)
    pass_len = chunk * P  # samples per pass chunk (a prepass chunk's count)

    def weather_chunk(bx, bz):
        w = _weather_rb_xy(bp, bx, bz, params.weather_pos)
        return w[..., 0], w[..., 1]

    def pre_chunk(bx, by_, bz):
        w = _weather_rb_xy(bp, bx, bz, params.weather_pos)
        return _density_pre_xyz(bx, by_, bz, w, 0.0, params, bp)

    with span("v3.pre"):
        if debug_stage == 4:
            return _dbg(*_map_rows(weather_chunk, pass_len, sx, sz))
        pre_s, hf_s = _map_rows(pre_chunk, pass_len, sx, sy, sz)
        pre_s = pre_s.reshape(spc, cap_c)
    if debug_stage == 5:
        return _dbg(pre_s, hf_s)

    # ---- Hot-cell compaction (K2): `pre > 0` is exact occupancy, so
    # erosion and the cone lookup run only on cells with an occupied sample.
    with span("v3.hot_compact"):
        hot = torch.any(pre_s > 0.0, dim=0) & valid_c  # [cap_c]
        hidx = _compact_mask(hot, cap_h, cap_c)
        hsafe = torch.clamp(hidx, max=cap_c - 1).to(torch.int64)
        valid_h = hidx < cap_c
        cidx_h = torch.where(valid_h, cidx[hsafe], total_cells)
        ray_h = torch.clamp(cidx_h // P, max=n - 1).to(torch.int64)
        cell_h = (cidx_h % P).to(torch.float32)
        g_h = geom[ray_h]
        hx, hy, hz = lane_positions(g_h, cell_h)
        pre_h = pre_s[:, hsafe].reshape(-1)
        hf_h = m.height_fraction(torch.sqrt(hx * hx + hy * hy + hz * hz),
                                 SKY_B_RADIUS, SKY_T_RADIUS)
    if debug_stage == 6:
        return _dbg(pre_h, hf_h, hx)

    def erosion_chunk(bpre, bhf, bx, by_, bz):
        return torch.where(bpre > 0.0, _density_finish_xyz(
            bpre, bhf, bx, by_, bz, 0.0, params, bp), 0.0)

    def erosion_cone_chunk(bpre, bhf, bx, by_, bz):
        t_c = erosion_chunk(bpre, bhf, bx, by_, bz)
        qx, qz, qh = _cone_cache_coords_xyz(bx, by_, bz, cone_cache.extent)
        cd_c = sample_tex3_xyz(cone_cache.table, qx, qz, qh)[..., 0]
        return t_c, torch.where(t_c > 0.0, cd_c, 0.0)

    with span("v3.erosion_cone"):
        if debug_stage == 7:
            return _dbg(_map_rows(erosion_chunk, pass_len, pre_h, hf_h, hx, hy, hz))
        t_h, cd_h = _map_rows(erosion_cone_chunk, pass_len, pre_h, hf_h, hx, hy, hz)
    if debug_stage == 8:
        return _dbg(t_h, cd_h)

    with span("v3.accumulate"):
        if accum == "segmented":
            out = _accumulate_segmented(t_h, cd_h, hf_h, g_h, ray_h, valid_h, n,
                                        spc, params, atmos, LSS)
            if debug_stage == 9:
                return _dbg(out)
        elif accum == "planes":
            # Per-lane scatters of the hot list into flat [n·steps] planes;
            # dead samples stay 0 (radiance ∝ t and 1 − dt = 0). Fill rows
            # point at total + l, in the spc spare slots sliced off after.
            total = n * steps
            base_h = torch.where(valid_h, ray_h * steps + (cidx_h % P) * spc, total)

            def scatter_plane(vals):
                vals = vals.reshape(spc, cap_h)
                buf = torch.zeros((total + spc,), dtype=torch.float32, device=dev)
                for l in range(spc):
                    buf[base_h + l] = vals[l]
                return buf[:total].reshape(n, steps)

            t = scatter_plane(t_h)
            cd = scatter_plane(cd_h)
            # hf plane: a dense recompute (positions + height fraction, no
            # gathers), the same float ops as the gathered passes.
            i_step = torch.arange(1, steps + 1, dtype=torch.float32, device=dev)

            def hf_chunk(p0c, ndirc, ssc):
                px, py, pz = _sample_xyz(p0c, ndirc, ssc[:, None] * i_step[None, :])
                return m.height_fraction(torch.sqrt(px * px + py * py + pz * pz),
                                         SKY_B_RADIUS, SKY_T_RADIUS)

            hf = _map_rows(hf_chunk, chunk, p0, ndir, ss)
            if debug_stage == 9:
                return _dbg(t, cd, hf)
            out = _accumulate_phase3(t, cd, hf, ss, phase, above, params, atmos, LSS)
        else:
            raise ValueError(f"unknown accum {accum!r}")
        if cull:
            # Kept rays back to their places; fills (ridx = n_out) land in
            # the spare last row.
            buf = torch.zeros((n_out + 1, 4), dtype=torch.float32, device=dev)
            buf[ridx.to(torch.int64)] = out
            out = buf[:n_out]
    return out


def march_bricks_v3(dirs, params: MarchParams, bp: BrickPack, sky_lut_img,
                    steps: int = 128, light_steps: int = 6,
                    chunk: int = 32768, cell_keep_frac: float = 0.5,
                    cone_cache: ConeCache | None = None,
                    cone_res=(32, 512, 512),
                    ray_keep_frac: float | None = None,
                    prepass_steps: int = 32, ray_stride: int = 1,
                    cell_margin: float = 0.1, hot_keep_frac: float = 0.5,
                    debug_stage: int = 0, axis_name: str | None = None,
                    accum: str = "segmented"):
    """Cell-gated march (`_march_core3`) over world directions [..., 3] →
    [..., 4] (L rgb, alpha): the full-hemisphere re-render. Fine sample
    placement is the dense march's; a [H, W] direction grid enables the
    prepass dilations and ray_stride. Size the buckets with
    `v3_auto_policy`. Builds a cone cache when none is given.

    debug_stage k in 1..9 returns `_march_core3`'s probe after stage k
    (reshaped to shape + (4,)): only stages 1..k run, so it times each
    stage on the card. Under a mesh the probe is the shard's.

    axis_name (inside `shard_map` only): dirs' rows are sharded over that
    mesh axis, and the prepass dilations exchange one boundary row with
    the neighbouring shards, so the cell gate is bitwise the unsharded
    one. Capacities are sized per shard: keep the buckets overflow-free
    for that equivalence. Unlike the JAX package, which keeps its Pallas
    segmented scan off the sharded path, each shard runs the hot list
    through kernel K3 on the card, as an unsharded march does."""
    dirs = dirs.to(torch.float32)
    shape = tuple(dirs.shape[:-1])
    flat = dirs.reshape(-1, 3)
    n = flat.shape[0]
    atmos = ambient_colors(params, sky_lut_img)
    if cone_cache is None:
        cone_cache = build_cone_cache(params, bp, light_steps, res=cone_res,
                                      chunk=min(chunk, max(n, 1)))
    above, ndir, ss, p0, phase, _ = _ray_setup(flat, params, steps)
    out = _march_core3(above, ndir, ss, p0, phase, params, bp, atmos, steps,
                       min(chunk, max(n, 1)), cell_keep_frac, cone_cache,
                       ray_keep_frac, prepass_steps,
                       shape if len(shape) == 2 else None, ray_stride,
                       cell_margin, hot_keep_frac, debug_stage, axis_name, accum)
    return out.reshape(shape + (4,))


# ------------------------------------------------------------- v3 policy
#
# Host-side bucket selection for `march_bricks_v3`, measured once per cycle
# snapshot or scene; the fractions come back as Python floats.

RAY_KEEP_BUCKETS = (0.3, 0.35, 0.4, 0.45, 0.5, 0.55, 0.6, 0.65, 0.7,
                    0.75, 0.8, 0.9, 1.0)


def select_ray_keep_frac(keep_frac: float, margin: float = 1.06,
                         buckets=RAY_KEEP_BUCKETS) -> float:
    """Smallest ray-capacity bucket ≥ margin × the measured keep fraction;
    1.0 disables culling."""
    need = keep_frac * margin
    for b in buckets:
        if need <= b:
            return b
    return 1.0


def cull_cell_stats(dirs, params: MarchParams, bp: BrickPack,
                    steps: int = 128, prepass_steps: int = 32,
                    chunk: int = 32768, ray_stride: int = 2,
                    cell_margin: float = 0.1, prepass_margin: float = 0.02):
    """(keep_frac, cell_frac): the cull prepass's ray keep fraction and the
    mean dilated-live-cell fraction over all rays, both from the march's own
    `_cull_prepass`, so the buckets cover what the march gates."""
    dirs = dirs.to(torch.float32)
    shape = tuple(dirs.shape[:-1])
    flat = dirs.reshape(-1, 3)
    above, ndir, ss, p0, _, _ = _ray_setup(flat, params, steps)
    return _cell_stats(above, ndir, ss, p0, params, bp, steps, prepass_steps,
                       min(chunk, max(flat.shape[0], 1)),
                       shape if len(shape) == 2 else None, ray_stride,
                       cell_margin, prepass_margin)


def _cell_stats(above, ndir, ss, p0, params: MarchParams, bp: BrickPack,
                steps: int, prepass_steps: int, chunk: int,
                cull_shape: tuple | None, ray_stride: int, cell_margin: float,
                prepass_margin: float):
    """(keep_frac, cell_frac) of `_cull_prepass` over prepared rays: the
    fraction of rays above the keep margin and the mean live-cell fraction
    over all rays (a stride-subsampled grid's rows expanded to every ray),
    as Python floats."""
    n = ndir.shape[0]
    prio, occ_cells, meta = _cull_prepass(above, ndir, ss, p0, params, bp, steps,
                                          prepass_steps, chunk, cull_shape,
                                          ray_stride, cell_margin)
    keep = (prio > -prepass_margin).to(torch.float32).mean()
    if meta is not None and meta[2] > 1:
        gh, gw, stride = meta
        P = occ_cells.shape[-1]
        occ_cells = occ_cells.reshape(gh, 1, gw, 1, P).expand(
            gh, stride, gw, stride, P).reshape(n, P)
    live = occ_cells & above[:, None]
    return float(keep), float(live.to(torch.float32).mean())


CELL_BUCKETS = (0.1, 0.125, 0.15, 0.175, 0.2, 0.225, 0.25, 0.275, 0.3,
                0.325, 0.35, 0.375, 0.4, 0.45, 0.5, 0.55, 0.6, 0.65, 0.7,
                0.8, 0.9, 1.0)


def select_cell_keep_frac(cell_frac: float, margin: float = 1.12,
                          buckets=CELL_BUCKETS) -> float:
    """Smallest cell-capacity bucket ≥ margin × the measured live-cell
    fraction. Overflow in `_march_core3` drops the highest-index cells."""
    need = cell_frac * margin
    for b in buckets:
        if need <= b:
            return b
    return 1.0


def hot_cell_fraction(dirs, params: MarchParams, bp: BrickPack,
                      steps: int = 128, prepass_steps: int = 32,
                      stride: int = 8, chunk: int = 16384) -> float:
    """Fraction of (ray, coarse-cell) blocks with any exact `pre > 0`
    sample, the quantity that sizes the hot capacity, probed on every
    stride-th ray at the full step count."""
    flat = dirs.to(torch.float32).reshape(-1, 3)[::stride]
    above, ndir, ss, p0, _, _ = _ray_setup(flat, params, steps)
    return _hot_fraction(above, ndir, ss, p0, params, bp, steps, prepass_steps,
                         min(chunk, max(flat.shape[0], 1)))


def _hot_fraction(above, ndir, ss, p0, params: MarchParams, bp: BrickPack,
                  steps: int, prepass_steps: int, chunk: int) -> float:
    """The fraction of (ray, coarse cell) blocks of prepared rays with any
    `pre > 0` sample at the fine positions."""
    n = ndir.shape[0]
    spc = steps // prepass_steps
    i_step = torch.arange(1, steps + 1, dtype=torch.float32, device=ndir.device)

    def dense_chunk(p0c, ndirc, ssc):
        px, py, pz = _sample_xyz(p0c, ndirc, ssc[:, None] * i_step[None, :])
        w = _weather_rb_xy(bp, px, pz, params.weather_pos)
        return _density_pre_xyz(px, py, pz, w, 0.0, params, bp)[0] > 0.0

    occ = _map_rows(dense_chunk, chunk, p0, ndir, ss)
    hot = torch.any(occ.reshape(n, prepass_steps, spc), dim=2) & above[:, None]
    return float(hot.to(torch.float32).mean())


def v3_auto_policy(dirs, params: MarchParams, bp: BrickPack,
                   steps: int = 128, ray_stride: int = 2,
                   cell_margin: float = 0.1, prepass_steps: int = 32):
    """Scene-adaptive knobs for `march_bricks_v3`. Returns (ray_keep_frac,
    cell_keep_frac, hot_keep_frac, cell_frac, hot_frac): the ray bucket from
    the cull keep fraction, the live-cell bucket from the live-cell fraction
    within the kept rays, the hot bucket from the exact occupied-cell
    fraction within the live capacity (margin 1.2)."""
    keep, cell_frac = cull_cell_stats(
        dirs, params, bp, steps=steps, ray_stride=ray_stride,
        cell_margin=cell_margin, prepass_steps=prepass_steps)
    hot_frac = hot_cell_fraction(dirs, params, bp, steps=steps,
                                 prepass_steps=prepass_steps)
    return _v3_buckets(keep, cell_frac, hot_frac)


def _v3_buckets(keep: float, cell_frac: float, hot_frac: float):
    """(ray_keep_frac, cell_keep_frac, hot_keep_frac, cell_frac, hot_frac):
    the buckets of the measured fractions."""
    rk = select_ray_keep_frac(keep)
    ck = select_cell_keep_frac(cell_frac / max(rk, 1e-6))
    hk = select_cell_keep_frac(hot_frac / max(rk * ck, 1e-6), margin=1.2)
    return rk, ck, hk, cell_frac, hot_frac


# ---------------------------------------------------- hierarchical marches
#
# bench/sweep.py's config 5 and the engine's "hier" kernel: a coarse pass
# finds each ray's occupied [a, b] window on the shell segment, and the fine
# march spends its whole step budget inside that window. v1
# (`march_hierarchical`) compacts the rays with an occupied window (K2) and
# marches them through `_march_core`; v3 (`march_hierarchical_v3`) runs the
# cell-gated `_march_core3` on the window lattice of every ray. The banded
# forms march horizontal row bands one after another, which bounds memory.

def _hier_windows(flat, params: MarchParams, bp: BrickPack, steps: int,
                  coarse_steps: int, chunk: int, occupancy_margin: float):
    """Per-ray occupied t-window on the shell segment, over all rays of
    `flat` [n, 3]: `coarse_steps` pre-erosion probes at mip 2 a ray, live
    where `pre > -occupancy_margin`, dilated one coarse cell along the ray
    (zero-padded, no wrap), the window from the first to the last live
    cell. Returns (above, ndir, phase, ldir, start, shelldist, a, b,
    any_occ), a and b as fractions of the segment."""
    above, ndir, ss, _, phase, ldir = _ray_setup(flat, params, steps)
    shelldist = ss * steps
    # _ray_setup's p0 carries the jitter; the window starts at the entry.
    start = _shell_entry(ndir)
    k_c = _probe_fractions(coarse_steps, flat.device)

    def coarse_chunk(startc, ndirc, sdc):
        px, py, pz = _sample_xyz(startc, ndirc, sdc[:, None] * k_c[None, :])
        w = _weather_rb_xy(bp, px, pz, params.weather_pos)
        return _density_pre_xyz(px, py, pz, w, 2.0, params, bp)[0]

    pre_c = _map_rows(coarse_chunk, chunk, start, ndir, shelldist)
    any_occ, a, b = _occupied_windows(pre_c, above, occupancy_margin)
    return above, ndir, phase, ldir, start, shelldist, a, b, any_occ


def _shell_entry(ndir):
    """Each ray's entry point into the cloud shell from the camera."""
    cam = torch.tensor([0.0, GROUND_RADIUS, 0.0], dtype=torch.float32,
                       device=ndir.device)
    return cam + ndir * m.intersect_sphere_far(cam.expand(ndir.shape), ndir,
                                               SKY_B_RADIUS)[..., None]


def _probe_fractions(coarse_steps: int, device):
    """The coarse probes' centres as fractions of the shell segment."""
    return (torch.arange(coarse_steps, dtype=torch.float32, device=device)
            + 0.5) / coarse_steps


def _occupied_windows(pre_c, above, occupancy_margin: float):
    """(any_occ, a, b) of coarse probes pre_c [n, coarse_steps]: a probe is
    live where `pre > -occupancy_margin`, dilated one probe along the ray
    (zero-padded, no wrap); the window runs from the first to the last live
    probe, at least one probe long."""
    coarse_steps = pre_c.shape[1]
    occ = pre_c > -occupancy_margin
    pad = torch.zeros_like(occ[:, :1])
    occ = occ | torch.cat([pad, occ[:, :-1]], dim=1) | torch.cat([occ[:, 1:], pad], dim=1)
    any_occ = torch.any(occ, dim=1) & above
    idx_c = torch.arange(coarse_steps, device=pre_c.device)[None, :]
    first = torch.min(torch.where(occ, idx_c, coarse_steps + 1), dim=1).values
    last = torch.max(torch.where(occ, idx_c, -1), dim=1).values
    a = torch.clamp(first.to(torch.float32) / coarse_steps, 0.0, 1.0)
    b = torch.clamp((last.to(torch.float32) + 1.0) / coarse_steps, 0.0, 1.0)
    return any_occ, a, torch.maximum(b, a + 1.0 / coarse_steps)


def _window_origin(start, ndir, shelldist, a, b, steps: int):
    """(ss, p0) of the fine march over each ray's [a, b] window: the step
    that spreads `steps` samples over it, and the jittered origin (the
    dither of `_ray_setup`, hashed from the shell entry)."""
    ss = (b - a) * shelldist / steps
    p0 = start + ndir * (a * shelldist + m.hash_iq(start * 10.0) * ss)[..., None]
    return ss, p0


def _hier_window_lattice(flat, params: MarchParams, bp: BrickPack,
                         steps: int, coarse_steps: int, chunk: int,
                         occupancy_margin: float):
    """The window-adjusted fine lattice of every ray, no compaction:
    (above_w, ndir, ss_w, p0_w, phase) with above_w = above & any_occ (a
    ray with an empty window renders zeros, as in `march_hierarchical`)."""
    above, ndir, phase, _, start, shelldist, a, b, any_occ = _hier_windows(
        flat, params, bp, steps, coarse_steps, chunk, occupancy_margin)
    ss_w, p0_w = _window_origin(start, ndir, shelldist, a, b, steps)
    return above & any_occ, ndir, ss_w, p0_w, phase


def march_hierarchical(dirs, params: MarchParams, bp: BrickPack, sky_lut_img,
                       steps: int = 128, light_steps: int = 6,
                       coarse_steps: int = 16, chunk: int = 16384,
                       capacity_frac: float = 0.25, t_cutoff: float = 1e-4,
                       ray_capacity_frac: float = 1.0,
                       occupancy_margin: float = 0.3,
                       approx_light: bool = False,
                       cone_cache: ConeCache | None = None):
    """Hierarchical march (config 5, v1) over world directions [..., 3] →
    [..., 4] (L rgb, alpha).

    1. `_hier_windows`: each ray's occupied window from the coarse pass.
    2. The rays with an occupied window are compacted (K2) into
       max(n·ray_capacity_frac, chunk) slots, rounded up to `chunk`. At
       the default 1.0 none can overflow; below it, overflowed rays render
       black, so lower it only for scenes of known, bounded occupancy.
    3. The compacted rays march `steps` samples over their windows through
       `_march_core` (its sample compaction through K2); the results go
       back to their rays and every other ray is zero."""
    dirs = dirs.to(torch.float32)
    shape = tuple(dirs.shape[:-1])
    flat = dirs.reshape(-1, 3)
    n = flat.shape[0]
    atmos = ambient_colors(params, sky_lut_img)
    above, ndir, phase, ldir, start, shelldist, a, b, any_occ = _hier_windows(
        flat, params, bp, steps, coarse_steps, chunk, occupancy_margin)

    ray_cap = _ceil_to(max(int(n * ray_capacity_frac), chunk), chunk)
    ridx = _compact_mask(any_occ, ray_cap, n).to(torch.int64)
    rsafe = torch.clamp(ridx, max=n - 1)
    ss_r, p0_r = _window_origin(start[rsafe], ndir[rsafe], shelldist[rsafe],
                                a[rsafe], b[rsafe], steps)
    out_r = _march_core(above[rsafe] & (ridx < n), ndir[rsafe], ss_r, p0_r,
                        phase[rsafe], ldir, params, bp, atmos, steps,
                        light_steps, chunk, capacity_frac, t_cutoff,
                        approx_light, cone_cache)
    # Fill slots (ridx = n) land in a spare last row, sliced off.
    out = torch.zeros((n + 1, 4), dtype=torch.float32, device=flat.device)
    out[ridx] = out_r
    return out[:n].reshape(shape + (4,))


def _banded(fn, dirs, bands: int, *args, **kwargs):
    """fn over `bands` horizontal row bands of dirs [H, W, 3], one call
    each, concatenated by rows."""
    H = dirs.shape[0]
    if H % bands:
        raise ValueError(f"rows {H} not divisible by bands {bands}")
    rows = H // bands
    return torch.cat([fn(dirs[i * rows:(i + 1) * rows], *args, **kwargs)
                      for i in range(bands)], dim=0)


def march_hierarchical_banded(dirs, *args, bands: int = 4, **kwargs):
    """`march_hierarchical` over `bands` row bands of dirs [H, W, 3], which
    bounds memory to a band's planes and compaction buffers. Rays are
    independent, so at capacities that do not overflow this is the
    monolithic render; capacities are pooled per band, so under overflow
    other samples drop."""
    return _banded(march_hierarchical, dirs, bands, *args, **kwargs)


def march_hierarchical_v3(dirs, params: MarchParams, bp: BrickPack,
                          sky_lut_img, steps: int = 128,
                          light_steps: int = 6, coarse_steps: int = 32,
                          chunk: int = 32768, cell_keep_frac: float = 0.5,
                          hot_keep_frac: float = 0.5,
                          ray_keep_frac: float | None = None,
                          cone_cache: ConeCache | None = None,
                          cone_res=(32, 512, 512), prepass_steps: int = 32,
                          ray_stride: int = 1, cell_margin: float = 0.1,
                          occupancy_margin: float = 0.3,
                          accum: str = "segmented"):
    """Hierarchical march through the v3 cell-gated core over world
    directions [..., 3] → [..., 4]: `_march_core3` on the window lattice
    (`_hier_window_lattice`), so the prepass probes the window-adjusted
    steps, the ray cull drops rays with an empty window, the cell gate
    skips the gaps inside wide windows and the hot compaction confines
    erosion and the cone lookup to occupied cells. Size the buckets with
    `hier_v3_auto_policy`. ray_stride stays 1 on the window lattice: each
    ray's coarse cell k spans its own t-range, so a stride neighbour's
    occupancy row does not describe it. Builds a cone cache when none is
    given."""
    dirs = dirs.to(torch.float32)
    shape = tuple(dirs.shape[:-1])
    flat = dirs.reshape(-1, 3)
    n = flat.shape[0]
    atmos = ambient_colors(params, sky_lut_img)
    if cone_cache is None:
        cone_cache = build_cone_cache(params, bp, light_steps, res=cone_res,
                                      chunk=min(chunk, max(n, 1)))
    above_w, ndir, ss_w, p0_w, phase = _hier_window_lattice(
        flat, params, bp, steps, coarse_steps, chunk, occupancy_margin)
    out = _march_core3(above_w, ndir, ss_w, p0_w, phase, params, bp, atmos,
                       steps, min(chunk, max(n, 1)), cell_keep_frac, cone_cache,
                       ray_keep_frac, prepass_steps,
                       shape if len(shape) == 2 else None, ray_stride,
                       cell_margin, hot_keep_frac, accum=accum)
    return out.reshape(shape + (4,))


def march_hierarchical_v3_banded(dirs, *args, bands: int = 4, **kwargs):
    """`march_hierarchical_v3` over `bands` row bands of dirs [H, W, 3].
    Not the monolithic render: the prepass's 3×3 dilation sees only the
    band's rows and the capacities are pooled per band (size them with
    `hier_v3_auto_policy(bands=...)`)."""
    return _banded(march_hierarchical_v3, dirs, bands, *args, **kwargs)


def _hier_cull_cell_stats(dirs, params: MarchParams, bp: BrickPack,
                          steps: int = 128, coarse_steps: int = 32,
                          prepass_steps: int = 32, chunk: int = 32768,
                          ray_stride: int = 1, cell_margin: float = 0.1,
                          prepass_margin: float = 0.02,
                          occupancy_margin: float = 0.3):
    """`cull_cell_stats` on the window lattice: (keep_frac, cell_frac) from
    `_cull_prepass` over the window-adjusted steps, as Python floats."""
    dirs = dirs.to(torch.float32)
    shape = tuple(dirs.shape[:-1])
    flat = dirs.reshape(-1, 3)
    ch = min(chunk, max(flat.shape[0], 1))
    above_w, ndir, ss_w, p0_w, _ = _hier_window_lattice(
        flat, params, bp, steps, coarse_steps, ch, occupancy_margin)
    return _cell_stats(above_w, ndir, ss_w, p0_w, params, bp, steps,
                       prepass_steps, ch, shape if len(shape) == 2 else None,
                       ray_stride, cell_margin, prepass_margin)


def hier_hot_cell_fraction(dirs, params: MarchParams, bp: BrickPack,
                           steps: int = 128, coarse_steps: int = 32,
                           prepass_steps: int = 32, stride: int = 8,
                           chunk: int = 16384,
                           occupancy_margin: float = 0.3) -> float:
    """`hot_cell_fraction` on the window lattice: the fraction of (ray,
    coarse cell) blocks with any `pre > 0` sample at the window-adjusted
    fine positions, on every stride-th ray (the window math is per ray, so
    the subset's windows are the full grid's)."""
    flat = dirs.to(torch.float32).reshape(-1, 3)[::stride]
    ch = min(chunk, max(flat.shape[0], 1))
    above_w, ndir, ss_w, p0_w, _ = _hier_window_lattice(
        flat, params, bp, steps, coarse_steps, ch, occupancy_margin)
    return _hot_fraction(above_w, ndir, ss_w, p0_w, params, bp, steps,
                         prepass_steps, ch)


def hier_v3_auto_policy(dirs, params: MarchParams, bp: BrickPack,
                        steps: int = 128, coarse_steps: int = 32,
                        ray_stride: int = 1, cell_margin: float = 0.1,
                        prepass_steps: int = 32, bands: int = 1):
    """`v3_auto_policy` on the window lattice, for `march_hierarchical_v3`:
    (ray_keep_frac, cell_keep_frac, hot_keep_frac, cell_frac, hot_frac).
    Windows concentrate live cells inside clouds, so the standard
    lattice's policy would undersize the buckets. With bands > 1 (for the
    banded march, whose capacities are pooled per band) each fraction is
    the maximum over the bands, so the buckets cover the densest band."""
    H = dirs.shape[0]
    if H % bands:
        raise ValueError(f"rows {H} not divisible by bands {bands}")
    rows = H // bands
    keep = cell_frac = hot_frac = 0.0
    for i in range(bands):
        band = dirs[i * rows:(i + 1) * rows]
        k, cf = _hier_cull_cell_stats(
            band, params, bp, steps=steps, coarse_steps=coarse_steps,
            ray_stride=ray_stride, cell_margin=cell_margin,
            prepass_steps=prepass_steps)
        hf = hier_hot_cell_fraction(band, params, bp, steps=steps,
                                    coarse_steps=coarse_steps,
                                    prepass_steps=prepass_steps)
        keep, cell_frac, hot_frac = max(keep, k), max(cell_frac, cf), max(hot_frac, hf)
    return _v3_buckets(keep, cell_frac, hot_frac)


# ------------------------------------------------------ v2 staged march
#
# The row-lean staged march (`march_bricks_v2`): a dense weather + pre pass
# over every (ray, step) sample, one shared compaction (K2) of the occupied
# samples, erosion and the cone-cache lookup on that list only, scatter
# back to [n, steps] planes and the phase-3 accumulation (K1). Optional
# ray cull (prepass priority or a given priority map) and a conservative
# occlusion cutoff. The JAX package's separate weather pass (two gather
# streams on the TPU) evaluates the same positions, so it is fused here.


def _occlusion_live(pre, hf, ss, params: MarchParams, t_cutoff: float):
    """Samples the conservative occlusion cutoff keeps: erosion only
    reduces density and is largest at hfbm = 1, so t ≥ t_lb below and the
    prefix transmittance T_ub ≥ the true prefix. Samples with T_ub ≤
    t_cutoff are provably invisible, and since T_ub only falls along the
    ray every later sample is dropped too (alpha error ≤ t_cutoff)."""
    t_lb = torch.pow(torch.clamp(m.remap(pre, 0.4 * hf, 1.0, 0.0, 1.0), 0.0, 1.0),
                     (1.0 - hf) * 0.8 + 0.5)
    dt_ub = torch.exp(-params.density * t_lb * ss[:, None])
    T_ub = torch.cat([torch.ones_like(dt_ub[:, :1]),
                      torch.cumprod(dt_ub, dim=1)[:, :-1]], dim=1)
    return T_ub > t_cutoff


def v2_capacity(total: int, capacity_frac: float, chunk: int) -> int:
    """Occupied-sample capacity of `_march_core2` over `total` samples: a
    Python int from the JAX package's expression, so both compact to the
    same length."""
    capacity = max(int(total * capacity_frac), chunk)
    return capacity + (-capacity) % chunk


def _march_core2(above, ndir, ss, p0, phase, params: MarchParams,
                 bp: BrickPack, atmos, steps: int, chunk: int,
                 capacity_frac: float, cone_cache: ConeCache,
                 weather_every: int = 1, ray_keep_frac: float | None = None,
                 prepass_steps: int = 32, cull_shape: tuple | None = None,
                 ray_stride: int = 1, t_cutoff: float = 0.0, cull_prio=None):
    """Staged march core (v2).

    1. With ray_keep_frac < 1, rays are scored by `_cull_priority` (or by a
       given `cull_prio` map, which skips the prepass) and the top
       `_ray_capacity` rays are kept (`_select_top_rays`, K2); the rest
       render as empty sky.
    2. Dense pass in chunks of `chunk` rays: weather and the pre-erosion
       density `pre` (and hf) at every sample; with t_cutoff > 0 the
       occlusion bound (`_occlusion_live`) masks samples out. With
       weather_every = K > 1 the weather is fetched at every K-th step
       only and lerped between those nodes (a measured quality loss in the
       JAX package, tests/test_march_v2.py; off by default).
    3. The occupied samples (`pre > 0`, the exact occupancy predicate) are
       compacted (K2) into `v2_capacity` slots; erosion and the cone-cache
       lookup run on that list and are scattered back to [n, steps] planes.
    4. Capacity overflow (K2's rank ≥ capacity) takes an ALU-only fallback:
       erosion at the detail noise's mean (hfbm = 0.5) and no sun term.
    5. Phase 3 through K1."""
    K = weather_every
    if K < 1 or steps % K:
        raise ValueError(f"weather_every {K} must divide steps {steps}")
    n = ndir.shape[0]
    n_out = n
    dev = ndir.device
    cull = ray_keep_frac is not None and ray_keep_frac < 1.0
    if cull:
        if cull_prio is not None:
            prio = torch.where(above, cull_prio.reshape(-1), float("-inf"))
        else:
            if steps % prepass_steps:
                raise ValueError(f"prepass_steps {prepass_steps} must divide "
                                 f"steps {steps}")
            prio = _cull_priority(above, ndir, ss, p0, params, bp, steps,
                                  prepass_steps, chunk, cull_shape, ray_stride)
        ray_cap = _ray_capacity(n, ray_keep_frac)
        chunk = min(chunk, ray_cap)
        ridx = _select_top_rays(prio, ray_cap, n)
        safe_r = torch.clamp(ridx, max=n - 1).to(torch.int64)
        g_r = torch.cat([p0, ndir, ss[:, None], phase[:, None]], dim=1)[safe_r]
        p0, ndir, ss, phase = g_r[:, 0:3], g_r[:, 3:6], g_r[:, 6], g_r[:, 7]
        above = above[safe_r] & (ridx < n)
        n = ray_cap
    total = n * steps
    i_step = torch.arange(1, steps + 1, dtype=torch.float32, device=dev)
    # The weather nodes' step numbers (i - 1) and the lerp fractions.
    i_node = torch.arange(steps // K + 1, dtype=torch.float32, device=dev) * K
    frac = (torch.arange(K, dtype=torch.float32, device=dev) / K)[None, None, :, None]

    # ---- Dense pass: weather + pre (+ hf), chunked over rays.
    def pre_chunk(p0c, ndirc, ssc):
        px, py, pz = _sample_xyz(p0c, ndirc, ssc[:, None] * i_step[None, :])
        if K == 1:
            w = _weather_rb_xy(bp, px, pz, params.weather_pos)
        else:
            wx, _, wz = _sample_xyz(p0c, ndirc, ssc[:, None] * (i_node[None, :] + 1.0))
            wn = _weather_rb_xy(bp, wx, wz, params.weather_pos)
            w0, w1 = wn[:, :-1, None, :], wn[:, 1:, None, :]
            w = (w0 + (w1 - w0) * frac).reshape(wn.shape[0], steps, 2)
        pre_c, hf_c = _density_pre_xyz(px, py, pz, w, 0.0, params, bp)
        occ = pre_c > 0.0
        if t_cutoff > 0.0:
            occ &= _occlusion_live(pre_c, hf_c, ssc, params, t_cutoff)
        return pre_c, hf_c, occ

    pre, hf, occupied = _map_rows(pre_chunk, chunk, p0, ndir, ss)
    occupied &= above[:, None]

    # ---- One shared compaction (K2): erosion → t, cone cache → cd.
    capacity = v2_capacity(total, capacity_frac, chunk)
    idx, rank = compact(occupied.reshape(-1), capacity, total)
    idx_l = idx.to(torch.int64)
    geom = torch.cat([p0, ndir, ss[:, None]], dim=1)  # [n, 7]
    g = geom[torch.clamp(idx_l // steps, max=n - 1)]
    tt_e = g[:, 6] * ((idx_l % steps).to(torch.float32) + 1.0)
    epx = g[:, 0] + g[:, 3] * tt_e
    epy = g[:, 1] + g[:, 4] * tt_e
    epz = g[:, 2] + g[:, 5] * tt_e
    pre_e = pre.reshape(-1)[torch.clamp(idx_l, max=total - 1)]
    hf_e = m.height_fraction(torch.sqrt(epx * epx + epy * epy + epz * epz),
                             SKY_B_RADIUS, SKY_T_RADIUS)

    def erosion_cone_chunk(bpre, bhf, bx, by_, bz):
        t_c = _density_finish_xyz(bpre, bhf, bx, by_, bz, 0.0, params, bp)
        qx, qz, qh = _cone_cache_coords_xyz(bx, by_, bz, cone_cache.extent)
        cd_c = sample_tex3_xyz(cone_cache.table, qx, qz, qh)[..., 0]
        return t_c, torch.where(t_c > 0.0, cd_c, 0.0)

    # Elementwise per sample: chunks of a dense chunk's sample count.
    t_e, cd_e = _map_rows(erosion_cone_chunk, chunk * steps, pre_e, hf_e,
                          epx, epy, epz)

    def scatter_back(vals):
        # Fill entries (idx = total) land in the spare last slot, sliced off.
        buf = torch.zeros((total + 1,), dtype=torch.float32, device=dev)
        buf[idx_l] = vals
        return buf[:total].reshape(n, steps)

    covered = occupied & (rank.reshape(n, steps) < capacity)
    t_fb = torch.pow(torch.clamp(m.remap(pre, 0.5 * 0.4 * hf, 1.0, 0.0, 1.0),
                                 0.0, 1.0), (1.0 - hf) * 0.8 + 0.5)
    t = torch.where(covered, scatter_back(t_e),
                    torch.where(occupied, t_fb, 0.0))
    cd = scatter_back(cd_e)  # uncovered samples: 0, no sun term

    out = _accumulate_phase3(t, cd, hf, ss, phase, above, params, atmos, LSS)
    if cull:
        # Kept rays back to their places; fills (ridx = n_out) land in the
        # spare last row.
        buf = torch.zeros((n_out + 1, 4), dtype=torch.float32, device=dev)
        buf[ridx.to(torch.int64)] = out
        out = buf[:n_out]
    return out


def march_bricks_v2(dirs, params: MarchParams, bp: BrickPack, sky_lut_img,
                    steps: int = 128, light_steps: int = 6,
                    chunk: int = 32768, capacity_frac: float = 0.25,
                    weather_every: int = 1,
                    cone_cache: ConeCache | None = None,
                    cone_res=(32, 512, 512),
                    ray_keep_frac: float | None = None,
                    prepass_steps: int = 32, ray_stride: int = 1,
                    t_cutoff: float = 1e-4, cull_prio=None):
    """Staged march (`_march_core2`) over world directions [..., 3] →
    [..., 4] (L rgb, alpha). Fine sample placement is the dense march's; a
    [H, W] direction grid enables the prepass dilation and ray_stride.
    With ray culling on, capacity_frac is a fraction of the kept samples:
    size both with `v2_auto_policy`. Builds a cone cache when none is
    given."""
    dirs = dirs.to(torch.float32)
    shape = tuple(dirs.shape[:-1])
    flat = dirs.reshape(-1, 3)
    n = flat.shape[0]
    atmos = ambient_colors(params, sky_lut_img)
    if cone_cache is None:
        cone_cache = build_cone_cache(params, bp, light_steps, res=cone_res,
                                      chunk=min(chunk, max(n, 1)))
    above, ndir, ss, p0, phase, _ = _ray_setup(flat, params, steps)
    out = _march_core2(above, ndir, ss, p0, phase, params, bp, atmos, steps,
                       min(chunk, max(n, 1)), capacity_frac, cone_cache,
                       weather_every, ray_keep_frac, prepass_steps,
                       shape if len(shape) == 2 else None, ray_stride,
                       t_cutoff, cull_prio)
    return out.reshape(shape + (4,))


# ------------------------------------------------------------- v2 policy

def occupied_sample_fraction(dirs, params: MarchParams, bp: BrickPack,
                             steps: int = 16, stride: int = 8,
                             t_cutoff: float = 1e-4) -> float:
    """Staged (ray, step) occupancy — `pre > 0` minus the occlusion cutoff
    at this coarse step count — probed on every stride-th ray: the quantity
    that sizes v2's capacity (match the march's t_cutoff)."""
    flat = dirs.to(torch.float32).reshape(-1, 3)[::stride]
    above, ndir, ss, p0, _, _ = _ray_setup(flat, params, steps)
    i_step = torch.arange(1, steps + 1, dtype=torch.float32, device=flat.device)
    px, py, pz = _sample_xyz(p0, ndir, ss[:, None] * i_step[None, :])
    weather = _weather_rb_xy(bp, px, pz, params.weather_pos)
    pre, hf = _density_pre_xyz(px, py, pz, weather, 0.0, params, bp)
    occ = (pre > 0.0) & above[:, None]
    if t_cutoff > 0.0:
        occ &= _occlusion_live(pre, hf, ss, params, t_cutoff)
    return float(occ.to(torch.float32).mean())


def ray_keep_fraction(dirs, params: MarchParams, bp: BrickPack,
                      steps: int = 128, prepass_steps: int = 32,
                      chunk: int = 32768, prepass_margin: float = 0.02,
                      ray_stride: int = 1) -> float:
    """Fraction of rays whose `_march_core2` cull priority exceeds
    −prepass_margin, from the march's own `_cull_priority` (dilation bonus
    included): the quantity that sizes ray_keep_frac."""
    dirs = dirs.to(torch.float32)
    shape = tuple(dirs.shape[:-1])
    flat = dirs.reshape(-1, 3)
    above, ndir, ss, p0, _, _ = _ray_setup(flat, params, steps)
    prio = _cull_priority(above, ndir, ss, p0, params, bp, steps, prepass_steps,
                          min(chunk, max(flat.shape[0], 1)),
                          shape if len(shape) == 2 else None, ray_stride)
    return float((prio > -prepass_margin).to(torch.float32).mean())


CAPACITY_BUCKETS = (0.09, 0.12, 0.15, 0.18, 0.2, 0.22, 0.25, 0.3, 0.35, 0.5)


def select_capacity_frac(occupied_frac: float, margin: float = 1.3,
                         buckets=CAPACITY_BUCKETS) -> float:
    """Smallest capacity bucket ≥ margin × the measured occupancy; above
    the last bucket, the last (overflow takes `_march_core2`'s fallback)."""
    need = occupied_frac * margin
    for b in buckets:
        if need <= b:
            return b
    return buckets[-1]


def v2_auto_policy(dirs, params: MarchParams, bp: BrickPack,
                   steps: int = 128, ray_stride: int = 2):
    """Scene-adaptive knobs for `march_bricks_v2`. Returns (ray_keep_frac,
    capacity_frac, t_cutoff, occupied_frac): the ray bucket from the cull
    keep fraction, the capacity bucket from the staged occupancy within the
    kept rays, and the occlusion cutoff only where it shrinks the capacity
    bucket."""
    keep = ray_keep_fraction(dirs, params, bp, steps=steps, ray_stride=ray_stride)
    rk = select_ray_keep_frac(keep)
    occ_plain = occupied_sample_fraction(dirs, params, bp, t_cutoff=0.0)
    occ_cut = occupied_sample_fraction(dirs, params, bp)
    cap_plain = select_capacity_frac(occ_plain / max(rk, 1e-6))
    cap_cut = select_capacity_frac(occ_cut / max(rk, 1e-6))
    if cap_cut < cap_plain:
        return rk, cap_cut, 1e-4, occ_cut
    return rk, cap_plain, 0.0, occ_plain
