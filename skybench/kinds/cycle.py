"""A re-render cell: whole-map re-renders through `CloudSkyEngine.update_cycle`.

`update_cycle(now)` is the engine's one-call cycle (its batch and offline
entry): at the cycle boundary it takes a new snapshot (the wind
integrated to `now`, the sun set before the call), builds its cone cache,
sky-view LUT and tile-cull map, and marches every tile of the map, where
the serving tick spreads that over the cycle's frames. A call, followed
by `torch.cuda.synchronize()`, is what a whole new sky costs.

Set-up makes the noise textures on the device, builds the engine, runs
the warm start (the first call) and one call more, and keeps the engine's
checkpoint (`save()`). The window calls `update_cycle` with the sun of the
seed's stream, the engine's clock one cycle of frames on a call (so the
simulation never depends on the program's speed), until `seconds` have
passed: `rerender_ms` is the window over the calls completed. After the
window the check reads the maps of two calls, a uniform draw over the
window (`traffic.Reservoir`), and the mix's fixed quality scenes, each
rendered by one call from the restored checkpoint, against the plain
reference's march of the same snapshot. `quality_db` is the quality
scenes' mean PSNR: the same inputs in every run, so it moves only when
the program's fidelity does.
"""

from __future__ import annotations

import sys
import time

import torch

from skybench import common, scene, traffic
from skybench.reference import atmosphere as ref_atmo
from skybench.reference import clouds as ref_clouds
from skybench.reference import composite as ref_comp

END_TO_END = ("rerender_ms", "quality_db")
CHECK_STREAM = 3
# The calls of a 51-s window (about 65 of 0.8 s): the control's stand-in
# for a window's draw.
CONTROL_CALLS = 60


def _scene_kw(mix: dict) -> dict:
    return dict(density=mix["density"], coverage=mix["coverage"],
                ground_color=mix["ground_color"])


def snapshots(plan: traffic.CyclePlan, mix: dict, calls) -> dict:
    """{k: reference Scene} of the window's calls k, by the engine's wind
    integration: once at each call's clock, in order from call 0 (the
    warm start's repeated integrations at one clock add nothing)."""
    wind = scene.WindState(plan.wind_direction, mix["wind_speed"])
    out, want = {}, set(calls)
    for k in range(max(want) + 1):
        wind.integrate(plan.now(k))
        if k in want:
            out[k] = scene.snapshot(wind, plan.sun(k), **_scene_kw(mix))
    return out


def quality_snapshots(plan: traffic.CyclePlan, mix: dict) -> list:
    """The quality scenes' reference Scenes: each integrates the wind of
    the checkpoint (calls 0 and 1) once more, to its own clock."""
    out = []
    for j in range(len(plan.quality)):
        wind = scene.WindState(plan.wind_direction, mix["wind_speed"])
        for k in (0, 1):
            wind.integrate(plan.now(k))
        wind.integrate(plan.quality_now(j))
        out.append(scene.snapshot(wind, plan.quality_sun(j), **_scene_kw(mix)))
    return out


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device,
        hooks=None) -> dict:
    from cloudscape_tpu_torch import CloudConfig, PerfConfig, SunState
    from cloudscape_tpu_torch.engine import CloudSkyEngine
    from cloudscape_tpu_torch.models.packs import make_noise_pack

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    frames = cfg["frames_to_update"]
    plan = traffic.cycle_plan(mix, seed, frames)
    noise = scene.config_noise(cfg, dev)
    eng = CloudSkyEngine(
        perf=PerfConfig(texture_size=cfg["texture_size"], frames_to_update=frames,
                        march_steps=cfg["march_steps"], light_steps=cfg["light_steps"]),
        config=CloudConfig(wind_direction=plan.wind_direction, wind_speed=mix["wind_speed"],
                           density=mix["density"], cloud_coverage=mix["coverage"],
                           sun_disk_scale=mix["sun_disk_scale"],
                           ground_color=tuple(mix["ground_color"]) + (1.0,)),
        sun=SunState(direction=plan.sun(0)), noise=make_noise_pack(*noise),
        now=plan.now(0), kernel=cfg["kernel"], cone_res=tuple(cfg["cone_res"]),
        tile_cull=cfg["tile_cull"], device=dev)
    if not eng.can_run:
        raise RuntimeError("the engine failed its kernel validation")
    if hooks is not None:
        hooks.on_engine(eng)
    pick = traffic.Reservoir(seed, CHECK_STREAM, int(mix["cycle"]["checked_maps"]))
    kept, state = {}, {"offer": False}

    def call(k: int, now: float | None = None, sun=None):
        eng.set_sun(plan.sun(k) if sun is None else sun)
        eng.update_cycle(now=plan.now(k) if now is None else now)
        out = eng.cloud_ring[eng.ring.texture_to_update]
        if hooks is not None:
            out = hooks.after_cycle(eng, out)
        if state["offer"]:
            slot = pick.offer()
            if slot is not None:
                kept[slot] = (k, out.clone())
        return out

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    # Set-up: the warm start (call 0) and one call of the window's shape.
    for k in (0, 1):
        call(k)
    sync()
    checkpoint = eng.save()
    setup_done = time.perf_counter()

    state["offer"] = True
    count, k = 0, 2
    t_start = time.perf_counter()
    while True:
        call(k)
        sync()
        count, k = count + 1, k + 1
        if time.perf_counter() - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    state["offer"] = False

    out = {"setup_done": setup_done, "attempted": count, "memory_peak_bytes": memory_peak,
           "metrics": {"rerender_ms": common.window_mean_ms(window_s, count)}}
    if trace:
        out["layer"] = {}
        if on_card:
            summary = common.TraceSummary()
            start, traced = k, int(mix["cycle"]["traced_calls"])
            k += common.trace_groups(lambda j: call(start + j), traced, 1,
                                     lambda j: "update_cycle", summary)
            out["layer"]["trace"] = summary
            out["busy_s"], out["window_s"] = summary.busy_s, summary.window_s
            out["breakdown"] = summary.breakdown()
    quality = []
    for j in range(len(plan.quality)):
        eng.restore(checkpoint)
        quality.append(call(1, plan.quality_now(j), plan.quality_sun(j)).clone())
    sync()
    del eng
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    maps = dict(kept.values())
    out["checks"], out["metrics"]["quality_db"] = check(cfg, mix, plan, maps, quality,
                                                        noise, dev)
    print(f"skybench: {count} calls in {window_s:.3f} s, checked calls {sorted(maps)} "
          f"(ran to call {k - 1}); the check took {time.perf_counter() - t_check:.2f} s",
          file=sys.stderr)
    return out


def reference_maps(cfg: dict, scenes: list, noise, dev, dtype=torch.float64) -> list:
    """The plain reference's map of each Scene, in `dtype`."""
    tex = ref_clouds.Textures.build(*noise, dtype=dtype)
    tlut = ref_atmo.transmittance_lut(dtype=dtype, device=dev)
    dirs = ref_comp.map_directions(cfg["texture_size"], dtype=dtype, device=dev)
    return [ref_clouds.cloud_march(dirs, sc, tex, ref_atmo.sky_lut(tlut, sc.light_direction),
                                   steps=cfg["march_steps"], light_steps=cfg["light_steps"])
            for sc in scenes]


def check(cfg: dict, mix: dict, plan: traffic.CyclePlan, maps: dict, quality: list,
          noise, dev):
    """([(name, value, limit)], quality_db): the worst SNR of the checked
    calls' maps and the quality scenes' maps against the plain reference
    in float64, and the quality scenes' mean PSNR (the port's bench.py's
    definition). SNR, as the serving cells compare maps: a sparse map's
    PSNR stays high even without its clouds."""
    snaps = snapshots(plan, mix, sorted(maps))
    ks = sorted(maps)
    want = reference_maps(cfg, [snaps[k] for k in ks] + quality_snapshots(plan, mix),
                          noise, dev)
    got = [maps[k] for k in ks] + list(quality)
    snr = [common.snr_db(g, w) for g, w in zip(got, want)]
    qdb = [common.psnr_db(g, w) for g, w in zip(quality, want[len(ks):])]
    return [("map_snr_db", min(snr), cfg["limits"]["map_snr_db"])], sum(qdb) / len(qdb)


def control(cfg: dict, mix: dict, seed: int, dev, dtype) -> list:
    """The check's numbers with the plain reference in `dtype` put in the
    program's place, at the calls a full window of the seed would check."""
    plan = traffic.cycle_plan(mix, seed, cfg["frames_to_update"])
    noise = scene.config_noise(cfg, dev)
    ks = [2 + i for i in traffic.reservoir_picks(seed, CHECK_STREAM,
                                                 int(mix["cycle"]["checked_maps"]),
                                                 CONTROL_CALLS)]
    snaps = snapshots(plan, mix, ks)
    got = dict(zip(ks, reference_maps(cfg, [snaps[k] for k in ks], noise, dev, dtype)))
    quality = reference_maps(cfg, quality_snapshots(plan, mix), noise, dev, dtype)
    return check(cfg, mix, plan, got, quality, noise, dev)[0]
