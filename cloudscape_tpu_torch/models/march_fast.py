"""Dense cloud march of the serving tick and the per-cycle cone cache (torch).

The part of `cloudscape_tpu.models.march_fast` that the default engine's
serving loop runs:

- `BrickPack`: the noise pack as brick tables, channels precombined;
- the Schneider density on brick tables (`clouds.glsl:109-137`), split at
  the erosion stage (`_density_pre_xyz` / `_density_finish_xyz`);
- the per-cycle cone-density cache (`ConeCache`): the 17-sample secondary
  (sun) march (`clouds.glsl:184-199`) precomputed on a shell-aligned grid,
  either in one call (`build_cone_cache`) or in slices spread over a cycle's
  ticks (`cone_occupancy_slice` → `cone_occupancy_finalize` →
  `bake_cone_cells` → `cone_table_rows` → `wrap_cone_table`);
- the dense tile march (`march_tile_dense`): every (ray, step) sample
  evaluated, then the phase-3 accumulation through kernel K1.

Both occupancy compactions go through kernel K2 (`_compact_mask`).
Sample positions use the closed form p_i = p0 + dir·ss·i; the
accumulation is the prefix-product form of `clouds.glsl:206-210`.
Other marches (exact, v2, v3, hierarchical) are not ported yet (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

from cloudscape_tpu_torch.config import GROUND_RADIUS, SKY_B_RADIUS, SKY_T_RADIUS
from cloudscape_tpu_torch.models.density import MarchParams, NoisePack
from cloudscape_tpu_torch.models.march import RANDOM_VECTORS, ambient_colors
from cloudscape_tpu_torch.ops import math as m
from cloudscape_tpu_torch.ops.accum import accumulate
from cloudscape_tpu_torch.ops.brick import (
    BrickTable2D,
    BrickTable3D,
    TinyVolume3D,
    brick3_grid,
    build_brick2,
    build_brick3,
    build_brick3_rows,
    build_tiny3,
    sample_brick2_xy,
    sample_brick3_xyz,
    sample_tiny3_xyz,
)
from cloudscape_tpu_torch.ops.compact import compact

Volume = Union[BrickTable3D, TinyVolume3D]

# Sun-march step length (`clouds.glsl:185`).
LSS = (SKY_T_RADIUS - SKY_B_RADIUS) / 64.0


@dataclasses.dataclass(frozen=True)
class BrickPack:
    """Brick-table mirror of a NoisePack with channels precombined (exact:
    FBM dot products and box-filter mips commute with lerp):
    large → (R, FBM), small → (hfbm), weather → (cloud_type, coverage)."""

    large: Tuple[Volume, ...]
    small: Tuple[Volume, ...]
    weather: BrickTable2D

    @staticmethod
    def from_noise(noise: NoisePack) -> "BrickPack":
        large = []
        for a in noise.large:
            combined = torch.stack(
                [a[..., 0], a[..., 1] * 0.625 + a[..., 2] * 0.25 + a[..., 3] * 0.125],
                dim=-1)
            large.append(build_tiny3(combined) if combined.numel() <= 128
                         else build_brick3(combined, (4, 4, 4), (3, 3, 3)))
        small = []
        for a in noise.small:
            combined = (a[..., 0] * 0.625 + a[..., 1] * 0.25 + a[..., 2] * 0.125)[..., None]
            small.append(build_tiny3(combined) if combined.numel() <= 128
                         else build_brick3(combined, (8, 4, 4), (7, 3, 3)))
        w = noise.weather
        weather = build_brick2(torch.stack([w[..., 0], w[..., 2]], dim=-1),
                               (8, 8), (7, 7))
        return BrickPack(large=tuple(large), small=tuple(small), weather=weather)


def _sample_volume_xyz(vol: Volume, qx, qy, qz):
    if isinstance(vol, TinyVolume3D):
        return sample_tiny3_xyz(vol, qx, qy, qz)
    return sample_brick3_xyz(vol, qx, qy, qz)


def _weather_rb_xy(bp: BrickPack, px, pz, weather_pos):
    """(cloud_type, coverage) weather fetch (`clouds.glsl:169-174`)."""
    return sample_brick2_xy(bp.weather,
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


def _ray_setup(dirs, params: MarchParams, steps: int):
    """Per-ray geometry: (above, ndir, ss, p0, phase, ldir). Rays below the
    horizon are redirected straight up (their output is zeroed later)."""
    dev = dirs.device
    above = dirs[..., 1] > 0.0
    up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=dev)
    ndir = torch.where(above[..., None], dirs, up)
    cam = torch.tensor([0.0, GROUND_RADIUS, 0.0], dtype=torch.float32, device=dev)
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


def _light_offsets(ldir, light_steps: int):
    """Cumulative cone offsets (`clouds.glsl:187`): after j steps the light
    sample sits at p + Σ_{k≤j} (ldir + RANDOM_VECTORS[k]·k)·lss; plus the
    distant sample's offset and lss."""
    rv = torch.tensor(RANDOM_VECTORS[:light_steps], dtype=torch.float32,
                      device=ldir.device)
    k = torch.arange(light_steps, dtype=torch.float32, device=ldir.device)
    offsets = torch.cumsum((ldir[None, :] + rv * k[:, None]) * LSS, dim=0)
    return offsets, ldir * (18.0 * LSS), LSS


def _cone_density_xyz(px, py, pz, params: MarchParams, bp: BrickPack,
                      light_offsets, distant_offset, light_steps: int):
    """Secondary (sun) march density sum `cd` (`clouds.glsl:184-199`)."""
    cd = torch.zeros_like(px)
    for j in range(light_steps):
        lx = px + light_offsets[j, 0]
        ly = py + light_offsets[j, 1]
        lz = pz + light_offsets[j, 2]
        lweather = _weather_rb_xy(bp, lx, lz, params.weather_pos)
        lt, _ = _density_bricks_xyz(lx, ly, lz, lweather, float(j), params, bp)
        cd = cd + lt

    lx = px + distant_offset[0]
    ly = py + distant_offset[1]
    lz = pz + distant_offset[2]
    lhf = m.height_fraction(torch.sqrt(lx * lx + ly * ly + lz * lz),
                            SKY_B_RADIUS, SKY_T_RADIUS)
    # Quirk preserved: no + weather_pos on the distant sample (`clouds.glsl:197`).
    lweather = sample_brick2_xy(bp.weather, lx * 0.00006 + 0.5,
                                lz * 0.00006 + 0.5)
    ldens, _ = _density_bricks_xyz(lx, ly, lz, lweather, 5.0, params, bp)
    return cd + torch.pow(ldens, (1.0 - lhf) * 0.8 + 0.5)


def _compact_mask(mask_flat, capacity: int, total: int):
    """Indices of the first `capacity` set entries (ascending, fill=total),
    through kernel K2 (its plain version for CPU tensors)."""
    idx, _ = compact(mask_flat, capacity, total)
    return idx


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

    table: BrickTable3D  # clamp-wrap, 1 channel (cd)
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


def build_cone_cache(params: MarchParams, bp: BrickPack,
                     light_steps: int = 6, res=(16, 256, 256),
                     extent: float = 220e3, chunk: int = 16384,
                     sparse_capacity_frac: float = 0.45) -> ConeCache:
    """Evaluate the cone density on the cache grid and pack it into a
    clamp-wrap brick table. res = (n_hf, n_z, n_x). The cone march runs only
    on cells whose pre-erosion density is positive, dilated by one cell,
    compacted into `cone_capacity` slots by kernel K2; overflow leaves far
    cells at cd = 0."""
    nd, nh, nw = res
    n = nd * nh * nw
    dev = bp.weather.table.device
    xs = _unwarp((torch.arange(nw, dtype=torch.float32, device=dev) + 0.5) / nw, extent)
    zs = _unwarp((torch.arange(nh, dtype=torch.float32, device=dev) + 0.5) / nh, extent)
    hfs = (torch.arange(nd, dtype=torch.float32, device=dev) + 0.5) / nd
    r = SKY_B_RADIUS + hfs * (SKY_T_RADIUS - SKY_B_RADIUS)
    x = xs[None, None, :]
    z = zs[None, :, None]
    rr = r[:, None, None]
    # Beyond-horizon cells have no shell point; clamp onto the shell.
    y = torch.sqrt(torch.clamp(rr * rr - (x * x + z * z), min=1.0))
    px, py, pz = (v.expand(res).reshape(-1) for v in (x, y, z))
    occ = _dilate(_pre_positive(px, py, pz, params, bp), res)
    idx = _compact_mask(occ, cone_capacity(n, sparse_capacity_frac, chunk), n)
    cd = torch.zeros((n + 1,), dtype=torch.float32, device=dev)
    # Fill entries (idx == n) land in the spare last slot and are dropped.
    cd[idx.to(torch.int64)] = _cone_cells(idx, params, bp, light_steps, res, extent)
    table = build_brick3(cd[:n].reshape(nd, nh, nw, 1), CONE_BRICK, CONE_STRIDE,
                         wrap="clamp")
    return ConeCache(table=table, extent=extent)


def cone_occupancy_slice(occ, i0: int, params: MarchParams, bp: BrickPack,
                         count: int, res=(16, 256, 256),
                         extent: float = 220e3):
    """Stage 0 of the sliced cone bake: the `pre > 0` predicate for the flat
    cells [i0, i0 + count), written IN PLACE into the bool buffer `occ`
    ([nd*nh*nw]). All slices then `cone_occupancy_finalize` give the same
    cells as `build_cone_cache`'s occupancy pass (elementwise per cell)."""
    cells = i0 + torch.arange(count, device=occ.device)
    cx, cy, cz = _cell_centers(cells, res, extent)
    occ[i0:i0 + count] = _pre_positive(cx, cy, cz, params, bp)
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
                    extent: float = 220e3):
    """Stage 2 of the sliced cone bake: cone-march the compacted cells
    `idx[i0 : i0 + count]` and write them IN PLACE into the flat volume
    `vol` ([nd*nh*nw + 1]; the spare last slot absorbs fill entries)."""
    sl = idx[i0:i0 + count]
    vol[sl.to(torch.int64)] = _cone_cells(sl, params, bp, light_steps, res, extent)
    return vol


def cone_table_rows(cd_vol, b0: int, count: int):
    """Rows [b0, b0 + count) of the cone cache's brick table; writing every
    range then `wrap_cone_table` gives `build_cone_cache`'s table."""
    return build_brick3_rows(cd_vol[..., None], b0, count, CONE_BRICK,
                             CONE_STRIDE, wrap="clamp")


def wrap_cone_table(table, res, extent: float = 220e3) -> ConeCache:
    """Metadata-only constructor around a fully written cone brick table."""
    return ConeCache(
        table=BrickTable3D(table=table, dims=tuple(res), brick=CONE_BRICK,
                           stride=CONE_STRIDE,
                           grid=brick3_grid(res, CONE_STRIDE), channels=1,
                           wrap="clamp"),
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
    in chunks of `chunk` rays, then the phase-3 accumulation."""
    n = ndir.shape[0]
    i_step = torch.arange(1, steps + 1, dtype=torch.float32, device=ndir.device)
    t = torch.empty((n, steps), dtype=torch.float32, device=ndir.device)
    cd = torch.empty_like(t)
    hf = torch.empty_like(t)
    for r0 in range(0, n, chunk):
        sl = slice(r0, r0 + chunk)
        tt = ss[sl, None] * i_step[None, :]
        px = p0[sl, 0, None] + ndir[sl, 0, None] * tt
        py = p0[sl, 1, None] + ndir[sl, 1, None] * tt
        pz = p0[sl, 2, None] + ndir[sl, 2, None] * tt
        weather = _weather_rb_xy(bp, px, pz, params.weather_pos)
        pre, hf_c = _density_pre_xyz(px, py, pz, weather, 0.0, params, bp)
        t_c = torch.where(pre > 0.0, _density_finish_xyz(
            pre, hf_c, px, py, pz, 0.0, params, bp), 0.0)
        qx, qz, qh = _cone_cache_coords_xyz(px, py, pz, cone_cache.extent)
        cd_c = sample_brick3_xyz(cone_cache.table, qx, qz, qh)[..., 0]
        # In-place writes of this chunk's rows into the [n, steps] planes.
        t[sl] = t_c
        cd[sl] = torch.where(t_c > 0.0, cd_c, 0.0)
        hf[sl] = hf_c
    return _accumulate_phase3(t, cd, hf, ss, phase, above, params, atmos, LSS)


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
    atmos = ambient_colors(params, sky_lut_img)
    if cone_cache is None:
        cone_cache = build_cone_cache(params, bp, light_steps, res=cone_res,
                                      chunk=min(chunk, max(n, 1)))
    above, ndir, ss, p0, phase, _ = _ray_setup(flat, params, steps)
    out = _march_core_dense(above, ndir, ss, p0, phase, params, bp, atmos,
                            steps, min(chunk, max(n, 1)), cone_cache)
    return out.reshape(shape + (4,))
