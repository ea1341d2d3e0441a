"""Per-cycle baked density field (torch port of `cloudscape_tpu.models.field`).

A documented negative result, kept reproducible: baking the pre-erosion
density onto a warped world grid cannot meet the exact march's 40 dB gate
at any feasible resolution. The exact march's ~100 m noise features at up
to 220 km would need feature-sized cells; the image's PSNR saturates in
the 20s of dB as the grid grows (docs/PERF_NOTES.md "round 2 negative
results" for the JAX package; PERF.md for this port's sweep on the card).
The smooth half of the idea, the cone-integrated light density, bakes
well and is `march_fast.ConeCache`. `march_baked` works, at its measured
quality band, and `occupied_ray_fraction` sizes its ray capacity.

`MarchParams` is frozen for a cycle, so everything the march reads from
the noise tables is a function of position. The field bakes two
quantities onto a shell-aligned (hf, z̃, x̃) grid, one 2-channel texel a
cell (the JAX package packs them into 2-channel 4×4×4 brick rows):

- channel 0: `pre`, the pre-erosion Schneider density
  (`clouds.glsl:109-125`), at every fine cell;
- channel 1: `cd`, the cone (sun) march density sum
  (`clouds.glsl:184-199`), on the coarser `cone_res` grid and upsampled.

The horizontal axes use the cone cache's warp x = sign(l)·l²·extent, l =
2(x̂ − 0.5). Only the detail erosion (`clouds.glsl:127-136`) stays live in
`march_baked`, on the samples with `pre > 0`, compacted by kernel K2.
"""

from __future__ import annotations

import dataclasses

import torch

from cloudscape_tpu_torch.config import SKY_B_RADIUS, SKY_T_RADIUS
from cloudscape_tpu_torch.models.density import MarchParams
from cloudscape_tpu_torch.models.march import ambient_colors
from cloudscape_tpu_torch.models.march_fast import (
    CONE_PIECE,
    LSS,
    BrickPack,
    _ceil_to,
    _compact_mask,
    _cone_density_xyz,
    _density_finish_xyz,
    _density_pre_xyz,
    _flat_sample_xyz,
    _light_offsets,
    _map_rows,
    _occupied_windows,
    _prefix_accumulate,
    _probe_fractions,
    _ray_setup,
    _sample_xyz,
    _shell_entry,
    _transmittance,
    _weather_rb_xy,
)
from cloudscape_tpu_torch.ops import math as m
from cloudscape_tpu_torch.ops.brick import (
    Texture3D,
    build_texture3,
    sample_tex3_xyz,
)


@dataclasses.dataclass(frozen=True)
class DensityField:
    """One amortized cycle's baked (pre, cd) field. table: clamp-wrap
    2-channel texture on the (hf, z̃, x̃) grid."""

    table: Texture3D
    extent: float = 220e3


def _warp(v, extent: float):
    return 0.5 + 0.5 * torch.sign(v) * torch.sqrt(torch.abs(v) / extent)


def _unwarp(c, extent: float):
    l = 2.0 * (c - 0.5)
    return torch.sign(l) * l * l * extent


def field_coords_xyz(px, py, pz, extent: float):
    """World position components → field uvw components (x̃, z̃, hf)."""
    hf = m.height_fraction(torch.sqrt(px * px + py * py + pz * pz),
                           SKY_B_RADIUS, SKY_T_RADIUS)
    return _warp(px, extent), _warp(pz, extent), hf


def _grid_positions(res, extent: float, device=None):
    """Flattened world positions of all (hf, z̃, x̃) grid cell centres.
    res = (n_hf, n_z, n_x). Beyond-horizon cells clamp onto the shell (no
    march sample queries them: every sample is horizon-limited)."""
    nd, nh, nw = res

    def centres(k):
        return (torch.arange(k, dtype=torch.float32, device=device) + 0.5) / k

    xs = _unwarp(centres(nw), extent)
    zs = _unwarp(centres(nh), extent)
    r = SKY_B_RADIUS + centres(nd) * (SKY_T_RADIUS - SKY_B_RADIUS)
    x = xs[None, None, :].expand(res)
    z = zs[None, :, None].expand(res)
    rr = r[:, None, None]
    # r² − x² − z², left to right, as the JAX package and `_cell_centers`.
    y = torch.sqrt(torch.clamp(rr * rr - x * x - z * z, min=1.0))
    return x.reshape(-1), y.reshape(-1), z.reshape(-1)


def build_density_field(params: MarchParams, bp: BrickPack,
                        res=(32, 768, 768), cone_res=(16, 192, 192),
                        light_steps: int = 6, extent: float = 220e3,
                        chunk: int = 65536) -> DensityField:
    """Bake the (pre, cd) field for one snapshot, on the pack's device.

    `pre` is evaluated at every fine cell (2 texture fetches each). `cd` is
    smooth (a cone-integrated quantity), so it is evaluated on the smaller
    `cone_res` grid (~17 fetches each) and upsampled onto the fine grid
    (1 fetch each). Every pass runs `chunk` cells at a time; the cells are
    independent, so the field does not depend on `chunk`."""
    dev = bp.weather.texels.device
    nd, nh, nw = res
    px, py, pz = _grid_positions(res, extent, dev)

    def pre_chunk(bx, by_, bz):
        weather = _weather_rb_xy(bp, bx, bz, params.weather_pos)
        return _density_pre_xyz(bx, by_, bz, weather, 0.0, params, bp)[0]

    pre = _map_rows(pre_chunk, chunk, px, py, pz)

    ldir = params.light_direction / m.norm3(params.light_direction)
    light_offsets, distant_offset, _ = _light_offsets(ldir, light_steps)
    cx, cy, cz = _grid_positions(cone_res, extent, dev)

    def cone_chunk(bx, by_, bz):
        return _cone_density_xyz(bx, by_, bz, params, bp, light_offsets,
                                 distant_offset, light_steps)

    cd_coarse = _map_rows(cone_chunk, chunk, cx, cy, cz)
    cone_table = build_texture3(cd_coarse.reshape(tuple(cone_res) + (1,)),
                                wrap="clamp")

    def upsample_chunk(bx, by_, bz):
        qx, qz, qh = field_coords_xyz(bx, by_, bz, extent)
        return sample_tex3_xyz(cone_table, qx, qz, qh)[..., 0]

    cd = _map_rows(upsample_chunk, chunk, px, py, pz)
    vol = torch.stack([pre, cd], dim=-1).reshape(nd, nh, nw, 2)
    return DensityField(table=build_texture3(vol, wrap="clamp"), extent=extent)


def sample_field_xyz(field: DensityField, px, py, pz):
    """(pre, cd) at world position components: ONE texture fetch."""
    qx, qz, qh = field_coords_xyz(px, py, pz, field.extent)
    return sample_tex3_xyz(field.table, qx, qz, qh)


def occupied_ray_fraction(dirs, params: MarchParams, field: DensityField,
                          coarse_steps: int = 16,
                          occupancy_margin: float = 0.3) -> torch.Tensor:
    """Fraction of rays whose shell segment touches any cloud, per the
    baked field's coarse probe (a 0-d tensor): read once a cycle to size
    `march_baked`'s `ray_capacity_frac`, with a margin."""
    flat = dirs.to(torch.float32).reshape(-1, 3)
    above, ndir, ss, _, _, _ = _ray_setup(flat, params, 1)
    start = _shell_entry(ndir)
    shelldist = ss * 1.0
    k = _probe_fractions(coarse_steps, flat.device)
    px, py, pz = _sample_xyz(start, ndir, shelldist[:, None] * k[None, :])
    pre = sample_field_xyz(field, px, py, pz)[..., 0]
    occ = torch.any(pre > -occupancy_margin, dim=1) & above
    return torch.mean(occ.to(torch.float32))


def march_baked(dirs, params: MarchParams, bp: BrickPack,
                field: DensityField, sky_lut_img, steps: int = 128,
                coarse_steps: int = 16, chunk: int = 32768,
                ray_capacity_frac: float = 1.0,
                erosion_capacity_frac: float = 0.5,
                occupancy_margin: float = 0.3,
                jitter: bool = True):
    """Baked-field raymarch over world directions [..., 3] → [..., 4]
    (L rgb, alpha).

    1. A coarse probe of the field (`coarse_steps` rows a ray) finds each
       ray's occupied t-window, as `march_hierarchical` does.
    2. The rays with a window are compacted by K2 into
       max(n·ray_capacity_frac, chunk) slots, rounded up to `chunk`; the
       default 1.0 never overflows, and an overflowed ray renders black.
    3. Every slot's `steps` samples over its window read (pre, cd) from
       one field row each.
    4. The samples with `pre > 0` are compacted by K2 into
       max(slots·steps·erosion_capacity_frac, chunk) slots, rounded up to
       `chunk`, and get the detail erosion; every other sample's density
       is exactly 0, and so is an overflowed sample's (a visible hole).
       The JAX package erodes every slot; this erodes the filled ones, in
       pieces of CONE_PIECE samples (a fill slot's result is dropped
       either way).
    5. The prefix-product accumulation (`_march_core` phase 3's math),
       `chunk` slots at a time.
    6. The slots' results go back to their rays; every other ray is 0.

    Steps 3 and 5 run `chunk` slots at a time; slots are independent, so
    the output does not depend on it. Approximate by construction."""
    dirs = dirs.to(torch.float32)
    shape = tuple(dirs.shape[:-1])
    flat = dirs.reshape(-1, 3)
    n = flat.shape[0]
    dev = flat.device
    chunk = min(chunk, max(n, 1))
    atmos = ambient_colors(params, sky_lut_img)

    above, ndir, ss, _, phase, _ = _ray_setup(flat, params, steps)
    shelldist = ss * steps
    start = _shell_entry(ndir)

    # ---- 1. Coarse occupancy from the baked field (1 row per probe).
    k_c = _probe_fractions(coarse_steps, dev)

    def coarse_chunk(startc, ndirc, sdc):
        cpx, cpy, cpz = _sample_xyz(startc, ndirc, sdc[:, None] * k_c[None, :])
        return sample_field_xyz(field, cpx, cpy, cpz)[..., 0]

    pre_c = _map_rows(coarse_chunk, chunk, start, ndir, shelldist)
    any_occ, a, b = _occupied_windows(pre_c, above, occupancy_margin)

    # ---- 2. Ray compaction (K2).
    ray_cap = _ceil_to(max(int(n * ray_capacity_frac), chunk), chunk)
    ridx = _compact_mask(any_occ, ray_cap, n).to(torch.int64)
    rsafe = torch.clamp(ridx, max=n - 1)
    ndir_r, start_r, sd_r = ndir[rsafe], start[rsafe], shelldist[rsafe]
    a_r, b_r = a[rsafe], b[rsafe]
    above_r = above[rsafe] & (ridx < n)
    nr = ray_cap
    ss_r = (b_r - a_r) * sd_r / steps
    jit_r = m.hash_iq(start_r * 10.0) if jitter else torch.zeros_like(sd_r)
    p0_r = start_r + ndir_r * (a_r * sd_r + jit_r * ss_r)[..., None]

    # ---- 3. Fine dense phase: 1 field fetch per sample → (pre, cd, hf).
    i_step = torch.arange(1, steps + 1, dtype=torch.float32, device=dev)

    def dense_chunk(p0c, ndirc, ssc):
        fpx, fpy, fpz = _sample_xyz(p0c, ndirc, ssc[:, None] * i_step[None, :])
        qx, qz, hf = field_coords_xyz(fpx, fpy, fpz, field.extent)
        f = sample_tex3_xyz(field.table, qx, qz, hf)
        return f[..., 0], f[..., 1], hf

    pre, cd, hf = _map_rows(dense_chunk, chunk, p0_r, ndir_r, ss_r)

    # ---- 4. Compacted erosion (K2): t where pre > 0, exactly 0 elsewhere.
    total = nr * steps
    occupied = (pre > 0.0) & above_r[:, None]
    e_cap = _ceil_to(max(int(total * erosion_capacity_frac), chunk), chunk)
    eidx = _compact_mask(occupied.reshape(-1), e_cap, total)
    eidx = eidx[:int(torch.count_nonzero(eidx < total))].to(torch.int64)
    geom = torch.cat([p0_r, ndir_r, ss_r[:, None]], dim=1)
    pre_flat, hf_flat = pre.reshape(-1), hf.reshape(-1)

    def erosion_piece(ip):
        return _density_finish_xyz(pre_flat[ip], hf_flat[ip],
                                   *_flat_sample_xyz(geom, ip, steps), 0.0,
                                   params, bp)

    t = torch.zeros((total,), dtype=torch.float32, device=dev)
    if eidx.numel():
        t[eidx] = _map_rows(erosion_piece, CONE_PIECE, eidx)
    t = t.reshape(nr, steps)

    # ---- 5. Accumulation (`_march_core` phase 3's math).
    def accum_chunk(tc, cdc, hfc, ssc, phc):
        dt, t_prefix = _transmittance(tc, ssc, params)
        return _prefix_accumulate(tc, cdc, hfc, dt, t_prefix, tc > 0.0, phc,
                                  params, atmos, LSS)

    out_r = _map_rows(accum_chunk, chunk, t, cd, hf, ss_r, phase[rsafe])
    out_r = torch.where(above_r[:, None], out_r, 0.0)

    # ---- 6. Scatter the slots back; fill slots (ridx = n) land in a spare
    # last row, sliced off.
    out = torch.zeros((n + 1, 4), dtype=torch.float32, device=dev)
    out[ridx] = out_r
    return out[:n].reshape(shape + (4,))


# The JAX package's jitted forms; the port has no trace to cache.
march_baked_jit = march_baked
build_density_field_jit = build_density_field
