"""Benchmark sweep over BASELINE.md's five configs, on one CUDA card.

The counterpart of the repository's `bench/sweep.py` (JAX): run it as

    python -m cloudscape_tpu_torch.sweep                  # all configs
    python -m cloudscape_tpu_torch.sweep 1 4              # a subset
    python -m cloudscape_tpu_torch.sweep --out rows.json  # also write the rows

It prints one JSON line a row, ten rows for the five configs, with
sweep.py's keys (its `emit`, `bench/sweep.py:76-89`). Two things differ:

- Timing is device-complete: `_timed` warms once, then takes the median of
  three calls, each followed by `torch.cuda.synchronize()` and timed by the
  host's `time.perf_counter`. The result is not read back inside the
  window (sweep.py's `np.asarray` is a readback).
- Every row but config 1's also carries `quality_db_vs_exact`: the row's
  image against the exact brick march (`march_bricks(steps=<the row's>,
  chunk=32768, capacity_frac=0.2)`) on the same directions and parameters,
  by bench.py's PSNR (`bench.psnr_vs_exact`); config 5's referee runs in its
  four row bands. Config 1's row is that march itself.

Config 4's `pallas_base_gen_ms` keeps sweep.py's key, so that rows diff key
by key against SWEEP_r05.json; here it is K4's time for
`generate_base_noise(128, 0)` (csrc/noise.cu `base_kernel`) once the kernels
are built. `device` is the card's name and power limit, as in the bench.
`SIZES` holds the five configs' sizes; the tests pass a smaller copy.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from cloudscape_tpu_torch.bench import (device_name, hemisphere_dirs, median_time,
                                        psnr_vs_exact, resolve_device, scene_params,
                                        sync)

CONE_RES = (32, 512, 512)
SIZES = {
    1: dict(width=256, height=128, steps=32),
    2: dict(width=512, height=256, steps=64, cone_res=CONE_RES),
    3: dict(width=1024, height=512, steps=128, cone_res=CONE_RES),
    4: dict(width=512, height=256, steps=64, cone_res=CONE_RES,
            pack=(128, 32, 512)),
    5: dict(width=2048, height=1024, steps=128, cone_res=CONE_RES, bands=4,
            coarse_steps=32),
}
CONFIGS = (1, 2, 3, 4, 5)


def _timed(fn, device, reps: int = 3):
    """(median ms, output) of `reps` device-complete fn() calls after one
    warm call, whose output it returns (the marches are deterministic)."""
    out = fn()
    sync(device)
    return median_time(fn, device, reps)[0], out


def _clouds_frac(out) -> float:
    return float((out[..., 3] > 0.1).float().mean())


def _cone_name(res) -> str:
    return "x".join(map(str, res))


def run(which=CONFIGS, *, sizes=SIZES, device="cuda", noise=None) -> list:
    """The rows of the configs in `which`, each printed as one JSON line as
    it is made. noise (configs 1, 2, 3 and 5) defaults to
    `reference_noise_pack` on the device."""
    from cloudscape_tpu_torch.models import atmosphere
    from cloudscape_tpu_torch.models.march_fast import (
        BrickPack, build_cone_cache, hier_v3_auto_policy, march_bricks,
        march_bricks_v2, march_bricks_v3, march_hierarchical_banded,
        march_hierarchical_v3_banded, v2_auto_policy, v3_auto_policy)
    from cloudscape_tpu_torch.models.packs import (procedural_noise_pack,
                                                   reference_noise_pack)
    from cloudscape_tpu_torch.ops import noise_kernel

    dev = resolve_device(device)
    card = device_name(dev)
    records = []
    if noise is None:
        noise = reference_noise_pack(device=dev)
    bricks = BrickPack.from_noise(noise)
    tlut = atmosphere.transmittance_lut(device=dev)

    def scene(sun, coverage=0.35):
        sun = np.asarray(sun, np.float64)
        sun = sun / np.linalg.norm(sun)
        sky = atmosphere.sky_lut(tlut, torch.tensor(sun, dtype=torch.float32,
                                                    device=dev))
        return sky, scene_params(coverage, sun, dev)

    def dirs_of(s):
        return torch.from_numpy(hemisphere_dirs(s["width"], s["height"])).to(dev)

    def cone_of(p, bp, s):
        return build_cone_cache(p, bp, 6, res=s["cone_res"], chunk=65536)

    def exact_db(out, dirs, p, sky, steps, bp=bricks, bands=1):
        hb = dirs.shape[0] // bands
        exact = torch.cat([march_bricks(dirs[b * hb:(b + 1) * hb], p, bp, sky,
                                        steps=steps, chunk=32768, capacity_frac=0.2)
                           for b in range(bands)])
        return psnr_vs_exact(out.cpu().numpy(), exact.cpu().numpy())

    def emit(config, name, ms, w, h, extra):
        rec = {
            "config": config,
            "metric": name,
            "value": ms,
            "unit": "ms",
            "mrays_per_sec_per_chip": w * h / ms / 1e3,
            "device": card,
        }
        rec.update(extra)
        records.append(rec)
        print(json.dumps(rec), flush=True)

    def time_v3(config, name, dirs, p, sky, cc, s, bp=bricks):
        """The best-kernel row: the config through the v3 cell-gated march
        with measured auto-policy buckets."""
        steps = s["steps"]
        rk, ck, hk, cell_frac, hot_frac = v3_auto_policy(dirs, p, bp, steps=steps)
        ms, out = _timed(lambda: march_bricks_v3(
            dirs, p, bp, sky, steps=steps, chunk=32768, cell_keep_frac=ck,
            hot_keep_frac=hk, cone_cache=cc, ray_keep_frac=rk, ray_stride=2),
            device=dev)
        emit(config, name, ms, s["width"], s["height"],
             {"kernel": "v3", "ray_keep_frac": rk, "cell_keep_frac": ck,
              "hot_keep_frac": hk, "cell_frac": float(cell_frac),
              "hot_frac": float(hot_frac),
              "quality_db_vs_exact": exact_db(out, dirs, p, sky, steps, bp)})

    def time_v2(dirs, p, sky, cc, steps, bp=bricks):
        """(ms, output, ray keep, capacity) of the v2 march with its
        auto policy."""
        rk, cap, tc, _ = v2_auto_policy(dirs, p, bp, steps=steps)
        ms, out = _timed(lambda: march_bricks_v2(
            dirs, p, bp, sky, steps=steps, chunk=32768, capacity_frac=cap,
            cone_cache=cc, ray_keep_frac=rk, ray_stride=2, t_cutoff=tc), device=dev)
        return ms, out, rk, cap

    def tag(s, prefix):
        return f"{prefix}_{s['width']}x{s['height']}x{s['steps']}"

    if 1 in which:
        # Config 1: static noon sun, baked inputs, the exact march.
        s = sizes[1]
        sky, p = scene([0.05, 0.99, 0.05])
        dirs = dirs_of(s)
        ms, out = _timed(lambda: march_bricks(dirs, p, bricks, sky, steps=s["steps"],
                                              chunk=32768, capacity_frac=0.2),
                         device=dev)
        emit(1, tag(s, "static_noon"), ms, s["width"], s["height"],
             {"clouds_frac": _clouds_frac(out)})

    if 2 in which:
        # Config 2: animated wind and amortized update, timed as the full
        # map; the production path (v2, ray cull, cone cache).
        s = sizes[2]
        sky, p = scene([0.3, 0.4, -0.85])
        dirs = dirs_of(s)
        cc = cone_of(p, bricks, s)
        ms, out, rk, cap = time_v2(dirs, p, sky, cc, s["steps"])
        emit(2, tag(s, "wind_amortized") + "_fullmap", ms, s["width"], s["height"],
             {"kernel": "v2", "per_tile_ms_at_64frames": ms / 64.0,
              "ray_keep_frac": rk, "capacity_frac": cap,
              "quality_db_vs_exact": exact_db(out, dirs, p, sky, s["steps"])})
        time_v3(2, tag(s, "wind_amortized") + "_fullmap_v3", dirs, p, sky, cc, s)

    if 3 in which:
        # Config 3: full atmosphere and sun sweep (the headline's size).
        s = sizes[3]
        sky, p = scene([0.6, 0.25, -0.75])
        dirs = dirs_of(s)
        cc = cone_of(p, bricks, s)
        ms, out, rk, cap = time_v2(dirs, p, sky, cc, s["steps"])
        # The sky LUT's re-render (once a cycle when the sun moves).
        lut_ms, _ = _timed(lambda: atmosphere.sky_lut(
            tlut, torch.tensor([0.3, 0.5, -0.8], dtype=torch.float32, device=dev)),
            device=dev)
        emit(3, tag(s, "atmosphere_sweep"), ms, s["width"], s["height"],
             {"kernel": "v2", "sky_lut_ms": lut_ms, "ray_keep_frac": rk,
              "capacity_frac": cap,
              "quality_db_vs_exact": exact_db(out, dirs, p, sky, s["steps"])})
        time_v3(3, tag(s, "atmosphere_sweep") + "_v3", dirs, p, sky, cc, s)

    if 4 in which:
        # Config 4: fully procedural noise (K4–K6), no assets.
        s = sizes[4]
        base, detail, weather = s["pack"]
        gen_ms, _ = _timed(lambda: noise_kernel.generate_base_noise(base, 0, device=dev),
                           device=dev)
        pb = BrickPack.from_noise(procedural_noise_pack(
            seed=0, base_size=base, detail_size=detail, weather_size=weather,
            device=dev))
        sky, p = scene([0.3, 0.4, -0.85])
        dirs = dirs_of(s)
        cc = cone_of(p, pb, s)
        ms, out, rk, cap = time_v2(dirs, p, sky, cc, s["steps"], pb)
        emit(4, tag(s, "procedural_pallas"), ms, s["width"], s["height"],
             {"kernel": "v2", "pallas_base_gen_ms": gen_ms, "ray_keep_frac": rk,
              "capacity_frac": cap, "clouds_frac": _clouds_frac(out),
              "quality_db_vs_exact": exact_db(out, dirs, p, sky, s["steps"], pb)})
        time_v3(4, tag(s, "procedural_pallas") + "_v3", dirs, p, sky, cc, s, bp=pb)

    if 5 in which:
        # Config 5: the hierarchical march over row bands, with the
        # per-cycle cone cache.
        s = sizes[5]
        w, h, steps, bands = s["width"], s["height"], s["steps"], s["bands"]
        coarse = s["coarse_steps"]
        sky, p = scene([0.3, 0.4, -0.85])
        dirs = dirs_of(s)
        cc = cone_of(p, bricks, s)
        cone = _cone_name(s["cone_res"])
        name = f"hierarchical_{w}x{h}x{steps}"

        def db(out):
            return exact_db(out, dirs, p, sky, steps, bands=bands)

        ms, out = _timed(lambda: march_hierarchical_banded(
            dirs, p, bricks, sky, bands=bands, steps=steps, chunk=32768,
            capacity_frac=0.08, coarse_steps=coarse, cone_cache=cc), device=dev)
        emit(5, name, ms, w, h,
             {"clouds_frac": _clouds_frac(out), "cone_cache": cone, "bands": bands,
              "coarse_steps": coarse, "quality_db_vs_exact": db(out)})

        # The window-lattice v3 march, buckets per band by the band-aware
        # policy (ray_stride stays 1 on the window lattice).
        rk, ck, hk, cell_frac, hot_frac = hier_v3_auto_policy(
            dirs, p, bricks, steps=steps, coarse_steps=coarse, bands=bands)
        ms, out = _timed(lambda: march_hierarchical_v3_banded(
            dirs, p, bricks, sky, bands=bands, steps=steps, chunk=32768,
            coarse_steps=coarse, cell_keep_frac=ck, hot_keep_frac=hk,
            ray_keep_frac=rk, cone_cache=cc), device=dev)
        emit(5, name + "_v3", ms, w, h,
             {"kernel": "hier_v3", "ray_keep_frac": rk, "cell_keep_frac": ck,
              "hot_keep_frac": hk, "cell_frac": float(cell_frac),
              "hot_frac": float(hot_frac), "clouds_frac": _clouds_frac(out),
              "cone_cache": cone, "bands": bands, "coarse_steps": coarse,
              "quality_db_vs_exact": db(out)})

        # The standard-lattice v3 march over the same row bands, each with
        # its own measured policy.
        hb = h // bands
        band_ms, band_rows, outs = 0.0, [], []
        for b in range(bands):
            db_ = dirs[b * hb:(b + 1) * hb]
            rk, ck, hk, _, _ = v3_auto_policy(db_, p, bricks, steps=steps)
            ms, out = _timed(lambda: march_bricks_v3(
                db_, p, bricks, sky, steps=steps, chunk=32768, cell_keep_frac=ck,
                hot_keep_frac=hk, cone_cache=cc, ray_keep_frac=rk, ray_stride=2),
                device=dev)
            band_ms += ms
            band_rows.append({"band": b, "ms": ms, "policy": [rk, ck, hk]})
            outs.append(out)
        emit(5, name + "_v3flat", band_ms, w, h,
             {"kernel": "v3_banded_flat", "bands": band_rows, "cone_cache": cone,
              "quality_db_vs_exact": db(torch.cat(outs))})
    return records


def main(argv=None, **run_kwargs) -> None:
    """The command line: config numbers (default all) and `--out PATH`;
    run_kwargs go to `run` (the tests' sizes, device and pack)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    out_path = None
    if "--out" in argv:
        i = argv.index("--out")
        out_path = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    which = {int(a) for a in argv} or set(CONFIGS)
    unknown = which - set(CONFIGS)
    if unknown:
        raise SystemExit(f"unknown config(s) {sorted(unknown)}; choose from {CONFIGS}")
    records = run(which, **run_kwargs)
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(records, fh, indent=1)
        print(f"# wrote {len(records)} rows -> {out_path}", flush=True)


if __name__ == "__main__":
    main()
