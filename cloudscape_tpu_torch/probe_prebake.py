"""The prebake's stage costs and the serving tick's labelled ticks, on one CUDA card.

The counterpart of the repository's `bench/probe_prebake2.py` (JAX, TPU).
Run it as

    python -m cloudscape_tpu_torch.probe_prebake [--out PATH]

on bench.py's serving point (`bench.serving_engine`: fast3 `tile_cull`,
`PerfConfig(768, 64, 128)`, cone cache (32, 512, 512), coverage 0.35, the
fused `render_frame` of bench.py's 1280×720 view), after the warm start
and a warm cycle of 65 ticks:

1. each prebake stage on its own, device-complete (the call, then
   `torch.cuda.synchronize()`, by the host's clock; the median of REPS after
   a warm call), at several slice sizes: the occupancy slice
   (`cone_occupancy_slice`), the occupancy finalize (`cone_occupancy_finalize`,
   kernel K2), the cone-bake slice (`bake_cone_cells`), a sky-LUT band
   (`sky_lut_rows`, kernel K10), the cull slice (`cull_raw_slice`) and the
   cull finalize with the cycle's host read of the tile fractions;
2. for each sliced stage a per-call and a per-unit cost, the least-squares
   line through its sizes (`fit`), printed in the form of
   `CloudSkyEngine._BAKE_COSTS`;
3. TICKS labelled `render_frame` ticks across a cycle boundary, each timed
   device-complete with the prebake stage it ran (`stage_of`), the arm of
   its tile (skip, v3 bucket, dense: a tick's time follows it) and its
   K10 launches: every tick above 1.5× the median with its stage, the
   median per stage and arm, and the steady ticks' median, 0.4× of which
   is the per-tick bake budget (`_BAKE_TICK_MS`; the JAX engine's 14 ms is
   0.4× its own steady tick);
4. the schedule that the fitted costs and that budget give the engine
   (`schedule`), beside the one it runs now.

Every line it prints carries the card's name and power limit; the last is
one JSON record of all of it (also written to --out). With `device="cpu"`
(the tests, at tiny sizes) the times are the host's and name no device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from cloudscape_tpu_torch import bench
from cloudscape_tpu_torch.utils.profiling import device_activities

# Timed calls per stage size, after one warm call; the sizes of a stage
# take turns, so a drift of the host's speed moves them alike.
REPS = 7
TICKS = 70
# A tick above HITCH x the median is printed with its stage.
HITCH = 1.5
# The per-tick bake budget, as a share of the steady serving tick.
BUDGET_SHARE = 0.4
# Slice sizes of each sliced stage, as shares of its whole, up to the
# whole stage, which a schedule may put in one tick (the sky's unit is a
# row).
OCC_SHARES = (1 / 16, 1 / 4, 1)
CONE_SHARES = (1 / 16, 1 / 4, 1)
SKY_ROWS = (5, 25, 100)
CULL_SHARES = (1 / 8, 1 / 2, 1)


def stage_of(eng) -> str:
    """The prebake stage the next `update_sky` (or `render_frame`) runs:
    "boundary" where it rotates the rings (the new pending cycle bakes
    nothing that tick), else the engine's own `_prebake_stages`, several
    joined by "+" in order where the schedule groups steps into the tick
    (frames_to_update 4: "occupancy+finalize"), "steady" where it bakes
    nothing."""
    if eng.ring.frame >= eng.perf.frames_to_update:
        return "boundary"
    return "+".join(eng._prebake_stages()) or "steady"


def fit(sizes, ms) -> tuple[float, float]:
    """(ms a call, ms a unit): the least-squares line through (size, ms),
    the call's cost at least 0 and the unit's at least 1e-9 ms (a stage
    whose time does not grow with its size costs its call alone)."""
    x, y = np.asarray(sizes, np.float64), np.asarray(ms, np.float64)
    unit = float(((x - x.mean()) * (y - y.mean())).sum() / ((x - x.mean()) ** 2).sum())
    unit = max(unit, 1e-9)
    return max(float(y.mean() - unit * x.mean()), 0.0), unit


def schedule(eng) -> dict:
    """The engine's prebake schedule: slice sizes, steps per stage, the
    budget it settled on, the ticks it takes and each tick's steps (one a
    tick where the plan fits the cycle)."""
    ends = eng._bake_group_ends
    return {"occ": [eng._occ_slice, eng._n_occ],
            "cone": [eng._cone_slice, eng._n_cone_slices],
            "sky": [eng._sky_rows, eng._n_sky],
            "cull": [eng._cull_slice, eng._n_cull],
            "budget_ms": eng._bake_budget_ms, "ticks": eng._bake_ticks,
            "groups": [list(eng._bake_steps[a:b]) for a, b in zip((0,) + ends, ends)]}


def _call_ms(fn, dev) -> tuple[float, float]:
    """(device-complete ms, enqueue ms) of one fn() call."""
    bench.sync(dev)
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    bench.sync(dev)
    return (time.perf_counter() - t0) * 1e3, (t1 - t0) * 1e3


def _traced(fn, dev, walls, enqueues) -> dict:
    """The medians of `walls` and `enqueues`, and on a card one more call's
    device `launches` and the `device_ms` its kernels, copies and fills took
    (torch.profiler)."""
    out = dict(ms=statistics.median(walls), enqueue_ms=statistics.median(enqueues))
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            bench.sync(dev)
        ev = device_activities(prof.events())
        out.update(launches=len(ev),
                   device_ms=sum(e.time_range.elapsed_us() for e in ev) / 1e3)
    return out


def timed(fn, dev, reps: int = REPS) -> dict:
    """Medians over `reps` calls after a warm one: `ms` device-complete, and
    `enqueue_ms` until the call returns (the host's part: the card's work
    may still run); on a card also one traced call (`_traced`)."""
    fn()
    walls, enqueues = zip(*(_call_ms(fn, dev) for _ in range(reps)))
    return _traced(fn, dev, walls, enqueues)


def _sized(sizes, fn, dev, reps: int = REPS) -> dict:
    """A sliced stage timed at each size, the sizes in turns: {"sizes", "ms",
    "calls"}, `calls` each size's `timed`-like record."""
    for k in sizes:
        fn(k)
    times = {k: [] for k in sizes}
    for _ in range(reps):
        for k in sizes:
            times[k].append(_call_ms(lambda: fn(k), dev))
    calls = [_traced(lambda k=k: fn(k), dev, *zip(*times[k])) for k in sizes]
    return dict(sizes=list(sizes), ms=[c["ms"] for c in calls], calls=calls)


def stage_costs(eng, dev) -> dict:
    """Item 1 on the engine's pending cycle: the sliced stages' `_sized`
    records and the two finalizes' `timed` ones."""
    from cloudscape_tpu_torch.models import atmosphere
    from cloudscape_tpu_torch.models.march_fast import (
        bake_cone_cells, cone_occupancy_finalize, cone_occupancy_slice,
        cull_finalize, cull_raw_slice)
    from cloudscape_tpu_torch.ops.octmap import texel_directions

    params, bricks, res = eng._pending.march_params, eng._bricks, eng.cone_res
    n = int(np.prod(res))
    out = {}

    occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    out["occ"] = _sized([max(int(n * f), 1) for f in OCC_SHARES], lambda k:
                        cone_occupancy_slice(occ, 0, params, bricks, count=k, res=res,
                                             chunk=k), dev)
    cone_occupancy_slice(occ, 0, params, bricks, count=n, res=res,
                         chunk=out["occ"]["sizes"][-1])
    out["occ_finalize"] = timed(
        lambda: cone_occupancy_finalize(occ, res=res, chunk=65536), dev)

    idx = cone_occupancy_finalize(occ, res=res, chunk=65536)
    vol = torch.zeros((n + 1,), dtype=torch.float32, device=dev)
    cap = eng._cone_capacity
    out["cone"] = _sized([max(int(cap * f), 1) for f in CONE_SHARES], lambda k:
                         bake_cone_cells(vol, idx, 0, params, bricks, count=k,
                                         light_steps=eng.perf.light_steps, res=res,
                                         chunk=k), dev)

    sun = eng._light_dir(eng._pending.frame_data)
    out["sky"] = _sized([r for r in SKY_ROWS if r <= eng.SKY_LUT_SHAPE[0]], lambda r:
                        atmosphere.sky_lut_rows(eng.transmittance, sun, 0, rows=r), dev)

    if eng.tile_cull:
        raw = torch.zeros((eng._n_sub, eng._cull_ps), dtype=torch.float32, device=dev)
        steps = eng.perf.march_steps
        out["cull"] = _sized([max(int(eng._n_sub * f), 1) for f in CULL_SHARES],
                             lambda k: cull_raw_slice(raw, eng._dirs_sub, 0, params,
                                                      bricks, count=k, steps=steps,
                                                      prepass_steps=eng._cull_ps), dev)
        cull_raw_slice(raw, eng._dirs_sub, 0, params, bricks, count=eng._n_sub,
                       steps=steps, prepass_steps=eng._cull_ps)
        dirs = texel_directions(eng.perf.texture_size, device=dev)

        def finalize_and_read():
            _, keep, cell = cull_finalize(raw, dirs, eng.perf.update_region_size,
                                          eng._cull_stride)
            return keep.cpu(), cell.cpu()

        out["cull_finalize"] = timed(finalize_and_read, dev)
    return out


def labelled_ticks(eng, eye, dev, first: int, ticks: int) -> list:
    """Item 3: `ticks` render_frame ticks from `now = first / 60`, each
    {"tick", "stage", "arm", "ms", "sky_launches"}: the prebake stage it
    ran and the arm of the tile it marched (`engine.tile_arm`)."""
    from cloudscape_tpu_torch.engine import tile_arm
    from cloudscape_tpu_torch.ops import atmosphere_kernel

    rows = []
    for i in range(first, first + ticks):
        stage = stage_of(eng)
        before = atmosphere_kernel.launches["sky"]
        ms, _ = bench.timed_ms(lambda: eng.render_frame(eye, now=i / 60.0), dev)
        # The tick marched tile frame - 1 of the cycle's row-major sweep.
        rows.append(dict(tick=i, stage=stage, ms=ms,
                         arm=tile_arm(eng.kernel, eng._tile_buckets[eng.ring.frame - 1],
                                      eng.perf.update_region_size ** 2),
                         sky_launches=atmosphere_kernel.launches["sky"] - before))
    return rows


def run(device="cuda", *, texture_size: int = 768, frames: int = 64,
        tile_steps: int = 128, cone_res=bench.CONE_RES, view=(1280, 720),
        ticks: int = TICKS, noise=None, log=print) -> dict:
    """Items 1–4 on `device` (see the module docstring); the defaults are
    the serving point's sizes, the tests pass smaller ones. noise defaults
    to `reference_noise_pack` on the device."""
    from cloudscape_tpu_torch.models.packs import reference_noise_pack

    dev = bench.resolve_device(device)
    card = bench.device_name(dev)
    sun = np.array(bench.SUN)
    sun /= np.linalg.norm(sun)
    if noise is None:
        noise = reference_noise_pack(device=dev)
    eng = bench.serving_engine(dev, sun, noise, cone_res, texture_size, frames,
                               tile_steps)
    eye = torch.from_numpy(bench.view_dirs(*view)).to(dev)
    eng.render_frame(eye, now=0.0)  # the warm start
    n_warm = frames + 1
    for i in range(1, 1 + n_warm):
        eng.render_frame(eye, now=i / 60.0)
    bench.sync(dev)
    before = schedule(eng)

    costs = stage_costs(eng, dev)
    fitted = {st: fit(costs[st]["sizes"], costs[st]["ms"])
              for st in ("occ", "cone", "sky", "cull") if st in costs}
    def show(c):
        trace = (f", {c['launches']} launches, {c['device_ms']:.3f} ms device"
                 if "launches" in c else "")
        return f"{c['ms']:.3f} ms (enqueue {c['enqueue_ms']:.3f}{trace})"

    for st, (call_ms, unit_ms) in fitted.items():
        log(f"stage {st}: " + "; ".join(
            f"{k}: {show(c)}" for k, c in zip(costs[st]["sizes"], costs[st]["calls"]))
            + f"; fit {call_ms:.4f} ms a call + {unit_ms:.4g} ms a unit ({card})")
    for key in ("occ_finalize", "cull_finalize"):
        if key in costs:
            log(f"stage {key}: {show(costs[key])} ({card})")

    rows = labelled_ticks(eng, eye, dev, 1 + n_warm, ticks)
    med = statistics.median(r["ms"] for r in rows)
    by_stage, by_arm = {}, {}
    for r in rows:
        by_stage.setdefault(r["stage"], []).append(r["ms"])
        by_arm.setdefault((r["stage"], r["arm"]), []).append(r["ms"])
    steady = by_stage.get("steady", [med])
    budget_ms = BUDGET_SHARE * statistics.median(steady)
    log(f"labelled ticks: median {med:.2f} ms, max {max(r['ms'] for r in rows):.2f} "
        f"over {len(rows)} ({card})")
    for r in rows:
        if r["ms"] > HITCH * med:
            log(f"  tick {r['tick']} {r['stage']} ({r['arm']} tile): {r['ms']:.2f} ms "
                f"({r['ms'] / med:.2f}x the median; K10 x{r['sky_launches']}) ({card})")
    for (st, arm), v in by_arm.items():
        log(f"  median {st}, {arm} tile: {statistics.median(v):.2f} ms over {len(v)} "
            f"tick(s) ({card})")
    log(f"steady median {statistics.median(steady):.2f} ms; bake budget "
        f"{BUDGET_SHARE} x it = {budget_ms:.2f} ms ({card})")

    # Item 4: this engine's schedule under the fitted costs and budget.
    eng._BAKE_COSTS, eng._BAKE_TICK_MS = fitted, budget_ms
    eng._derive_prebake_schedule()
    after = schedule(eng)
    log(f"schedule now {before}; under the fitted costs {after} ({card})")
    return {"device": card, "stages": costs, "bake_costs": fitted,
            "bake_tick_ms": budget_ms, "ticks": rows, "median_ms": med,
            "steady_median_ms": statistics.median(steady),
            "stage_median_ms": {st: statistics.median(v) for st, v in by_stage.items()},
            "stage_arm_median_ms": {f"{st}/{arm}": statistics.median(v)
                                    for (st, arm), v in by_arm.items()},
            "schedule_now": before, "schedule_fitted": after}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON record here")
    args = ap.parse_args()
    rec = run(log=lambda s: print(s, flush=True))
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
