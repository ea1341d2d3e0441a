"""A serving cell: `CloudSkyEngine.render_frame` ticks, closed loop.

Set-up makes the noise textures and the camera's views on the device,
builds the engine (warm start included in its first tick) and runs one
whole cycle of ticks, so every prebake stage and tile arm has run before
the window. The window then calls `render_frame` tick after tick, each
followed by `torch.cuda.synchronize()`, until `seconds` have passed:
`frame_ms` is the window over the ticks it completed, `frame_p99_ms` the
99th percentile of those ticks. The engine's clock is tick / fps from the
seed's origin, so the simulation never depends on the program's speed.

The check reads two ticks in consecutive cycles c and c + 1, c a uniform
draw over the window's cycles (`traffic.Reservoir`; ticks run on past the
window's close until the pair is complete): the displayed frame and the
two displayed cloud maps of each, against the plain reference's maps
(marched anew from the snapshots that the engine's schedule gives those
cycles) and its composite of them.

The traced run labels each tick by the engine's private prebake stage
(`_prebake_stage()`) and tile-cull buckets (`_tile_buckets`); a run whose
engine lacks either stops before its window, so that a renamed field can
never leave `bake_tick_ms.serve` or `v3_tick_ms.serve` silently empty.
"""

from __future__ import annotations

import sys
import time

import torch

from skybench import common, scene, traffic
from skybench.reference import atmosphere as ref_atmo
from skybench.reference import clouds as ref_clouds
from skybench.reference import composite as ref_comp

# The metrics this kind reports with --trace 0.
END_TO_END = ("frame_ms", "frame_p99_ms")
# The check's draws: the reservoir's stream, and the first cycle it offers
# (cycles c − 2 and c − 1 hold the displayed maps of cycle c).
CHECK_STREAM, FIRST_CHECKED_CYCLE = 3, 2


def tile_arm(bucket) -> str:
    """The fast3 tile arm of a tile-cull bucket (skip, v3 or dense)."""
    if bucket is None:
        return "dense"
    return "skip" if bucket == 0.0 else ("dense" if bucket >= 1.0 else "v3")


def checked_ticks(plan: traffic.ServePlan, seed: int, frames: int, cycles: int) -> tuple:
    """The pair of ticks a window of `cycles` whole cycles after set-up
    checks (the control's stand-in for a window's draw)."""
    (idx,) = traffic.reservoir_picks(seed, CHECK_STREAM, 1, cycles)
    c = FIRST_CHECKED_CYCLE + idx
    fa, fb = plan.check_offsets
    return c * frames + fa, (c + 1) * frames + fb


def snapshots(plan: traffic.ServePlan, mix: dict, frames: int, last_cycle: int) -> dict:
    """{cycle: reference Scene} for cycles −2 .. last_cycle, by the
    engine's schedule: the warm start's two cycles and cycle 0 take the
    snapshot at tick 0; a rotation at tick 64k (k ≥ 1) integrates the
    wind to that tick's clock and freezes the head with the sun set
    before it, and that snapshot, baked across cycle k, is active in
    cycle k + 1."""
    wind = scene.WindState(plan.wind_direction, mix["wind_speed"])
    kw = dict(density=mix["density"], coverage=mix["coverage"],
              ground_color=mix["ground_color"])
    wind.integrate(plan.now(0))
    first = scene.snapshot(wind, plan.sun(0), **kw)
    out = {-2: first, -1: first, 0: first, 1: first}
    for k in range(1, last_cycle):
        wind.integrate(plan.now(frames * k))
        out[k + 1] = scene.snapshot(wind, plan.sun(frames * k), **kw)
    return out


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device,
        hooks=None) -> dict:
    from cloudscape_tpu_torch import CloudConfig, PerfConfig, SunState
    from cloudscape_tpu_torch.engine import CloudSkyEngine
    from cloudscape_tpu_torch.models.packs import make_noise_pack

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    frames = cfg["frames_to_update"]
    plan = traffic.serve_plan(mix, seed, frames)
    large, small, weather = scene.config_noise(cfg, dev)
    vw, vh = cfg["view"]
    views = scene.camera_views(vw, vh, plan.yaws(), dev)
    eng = CloudSkyEngine(
        perf=PerfConfig(texture_size=cfg["texture_size"], frames_to_update=frames,
                        march_steps=cfg["march_steps"], light_steps=cfg["light_steps"]),
        config=CloudConfig(wind_direction=plan.wind_direction, wind_speed=mix["wind_speed"],
                           density=mix["density"], cloud_coverage=mix["coverage"],
                           sun_disk_scale=mix["sun_disk_scale"],
                           ground_color=tuple(mix["ground_color"]) + (1.0,)),
        sun=SunState(direction=plan.sun(0)), noise=make_noise_pack(large, small, weather),
        now=plan.now(0), kernel=cfg["kernel"], cone_res=tuple(cfg["cone_res"]),
        tile_cull=cfg["tile_cull"], device=dev)
    if not eng.can_run:
        raise RuntimeError("the engine failed its kernel validation")
    if trace and not (callable(getattr(eng, "_prebake_stage", None))
                      and isinstance(getattr(eng, "_tile_buckets", None), list)):
        raise RuntimeError("the engine has no _prebake_stage() or _tile_buckets list: the "
                           "traced run cannot label its ticks by bake stage and tile arm")
    if hooks is not None:
        hooks.on_engine(eng)
    pick = traffic.Reservoir(seed, CHECK_STREAM, 1)
    fa, fb = plan.check_offsets
    # kept: the checked pair, {tick: (frame, shown map from, shown map to)};
    # want: the tick that completes the pair last drawn.
    kept, state = {}, {"offer": False, "want": None}

    def tick(i: int):
        eng.set_sun(plan.sun(i))
        frame = eng.render_frame(views[plan.view_of(i)], now=plan.now(i))
        if hooks is not None:
            frame = hooks.after_tick(eng, frame)
        c, f = divmod(i, frames)
        take = i == state["want"]
        if state["offer"] and c >= FIRST_CHECKED_CYCLE and f == fa and pick.offer() is not None:
            kept.clear()
            state["want"], take = (c + 1) * frames + fb, True
        elif take:
            state["want"] = None
        if take:
            kept[i] = (frame.clone(), eng.cloud_ring[eng.ring.texture_to_blend_from].clone(),
                       eng.cloud_ring[eng.ring.texture_to_blend_to].clone())
        return frame

    def label() -> str:
        """The next tick's bake stage (a rotation, then none, comes first)."""
        stage = "rotate" if eng.ring.frame >= frames else (eng._prebake_stage() or "none")
        return f"bake:{stage}"

    def span(_) -> str:
        """The next tick's bake stage and, short of a rotation, its tile's arm."""
        if eng.ring.frame >= frames or not eng._tile_buckets:
            return f"tick|{label()}"
        return f"tick|{label()}|tile:{tile_arm(eng._tile_buckets[eng.ring.frame])}"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    # Set-up: the warm start (tick 0) and one whole cycle.
    i = 0
    for i in range(frames + 1):
        tick(i)
    sync()
    setup_done = time.perf_counter()

    times, labels = [], []
    state["offer"] = True
    t_start = time.perf_counter()
    while True:
        i += 1
        lab = label() if trace else None
        t0 = time.perf_counter()
        tick(i)
        sync()
        t1 = time.perf_counter()
        times.append(t1 - t0)
        if trace:
            labels.append((lab, tile_arm(eng._tile_buckets[eng.ring.frame - 1]
                                         if eng._tile_buckets else None)))
        if t1 - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    # Run on, untimed, until a pair is drawn and complete.
    while state["want"] is not None or not kept:
        state["offer"] = not kept
        i += 1
        tick(i)
    state["offer"] = False
    sync()

    out = {"setup_done": setup_done, "attempted": len(times), "memory_peak_bytes": memory_peak,
           "metrics": {"frame_ms": common.window_mean_ms(window_s, len(times)),
                       "frame_p99_ms": common.p99([t * 1e3 for t in times])}}
    if trace:
        out["layer"] = {"ticks": [(t * 1e3, lab, arm) for t, (lab, arm) in zip(times, labels)]}
        if on_card:
            summary = common.TraceSummary()
            start = i + 1
            calls = common.trace_groups(lambda k: tick(start + k), frames, 8, span, summary)
            i += calls
            out["layer"]["trace"] = summary
            out["busy_s"], out["window_s"] = summary.busy_s, summary.window_s
            out["breakdown"] = summary.breakdown()
    del eng, views
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    out["checks"] = check(cfg, mix, plan, kept, (large, small, weather), dev)
    print(f"skybench: {len(times)} ticks in {window_s:.3f} s, checked ticks {sorted(kept)} "
          f"(ran to tick {i}); the check took {time.perf_counter() - t_check:.2f} s",
          file=sys.stderr)
    return out


def reference_outputs(cfg: dict, mix: dict, plan: traffic.ServePlan, ticks, noise, dev,
                      dtype=torch.float64) -> dict:
    """{tick: (frame, shown map from, shown map to)} by the plain
    reference in `dtype`: the two displayed maps marched anew from the
    snapshots of cycles c − 2 and c − 1, and their composite for the
    tick's view, blend and active sun."""
    frames = cfg["frames_to_update"]
    cycles = [t // frames for t in ticks]
    snaps = snapshots(plan, mix, frames, max(cycles) + 1)
    tex = ref_clouds.Textures.build(*noise, dtype=dtype)
    tlut = ref_atmo.transmittance_lut(dtype=dtype, device=dev)
    dirs = ref_comp.map_directions(cfg["texture_size"], dtype=dtype, device=dev)
    skies, maps = {}, {}

    def sky(k):
        if k not in skies:
            skies[k] = ref_atmo.sky_lut(tlut, snaps[k].light_direction)
        return skies[k]

    def cloud_map(k):
        if k not in maps:
            maps[k] = ref_clouds.cloud_march(dirs, snaps[k], tex, sky(k),
                                             steps=cfg["march_steps"],
                                             light_steps=cfg["light_steps"])
        return maps[k]

    vw, vh = cfg["view"]
    out = {}
    for t, c in zip(ticks, cycles):
        eye = scene.camera_views(vw, vh, [plan.yaws()[plan.view_of(t)]], dev)[0].to(dtype)
        frame = ref_comp.composite(eye, cloud_map(c - 2), cloud_map(c - 1), sky(c - 2),
                                   sky(c - 1), tlut, (t % frames) / frames,
                                   mix["sun_disk_scale"], snaps[c].light_direction)
        out[t] = (frame, cloud_map(c - 2), cloud_map(c - 1))
    return out


def check(cfg: dict, mix: dict, plan: traffic.ServePlan, kept: dict, noise, dev) -> list:
    """[(name, value, limit)]: the worst SNR of the displayed maps and of
    the displayed frames at the checked ticks, against the plain reference
    in float64. SNR, not PSNR: a sparse sky's map is mostly empty, so its
    PSNR stays high even for a map without clouds."""
    want = reference_outputs(cfg, mix, plan, sorted(kept), noise, dev)
    maps = [common.snr_db(kept[t][j], want[t][j]) for t in kept for j in (1, 2)]
    frames = [common.snr_db(kept[t][0], want[t][0]) for t in kept]
    lim = cfg["limits"]
    return [("map_snr_db", min(maps), lim["map_snr_db"]),
            ("frame_snr_db", min(frames), lim["frame_snr_db"])]


# The whole cycles of a 51-s serving window (about 3,900 ticks of 64).
CONTROL_CYCLES = 60


def control(cfg: dict, mix: dict, seed: int, dev, dtype) -> list:
    """The check's numbers with the plain reference in `dtype` put in the
    program's place, at the ticks a full window of the seed would check."""
    plan = traffic.serve_plan(mix, seed, cfg["frames_to_update"])
    noise = scene.config_noise(cfg, dev)
    ticks = checked_ticks(plan, seed, cfg["frames_to_update"], CONTROL_CYCLES)
    got = reference_outputs(cfg, mix, plan, list(ticks), noise, dev, dtype)
    return check(cfg, mix, plan, got, noise, dev)
