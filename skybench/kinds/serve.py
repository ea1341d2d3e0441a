"""A serving cell: `CloudSkyEngine.render_frame` ticks, closed loop.

Set-up makes the noise textures and the camera's views on the device,
builds the engine (warm start included in its first tick) and runs one
whole cycle of ticks, so every prebake stage and tile arm has run before
the window. The window then calls `render_frame` tick after tick, each
followed by `torch.cuda.synchronize()`, until `seconds` have passed:
`frame_ms` is the window over the ticks it completed, `frame_p99_ms` the
99th percentile of those ticks. The engine's clock is tick / fps from the
seed's origin, so the simulation never depends on the program's speed.

A mix with a `cut` block (`traffic`) cuts the scene at its cut ticks:
before that tick's `render_frame` the kind sets the cut's sun and calls
`request_full_sky_init()`, the engine's public API. Set-up then runs on
through the first cut, so that the window builds nothing.

The check reads two ticks: one at frame fa of a cycle, a uniform draw
over the window's such ticks (`traffic.Reservoir`), and the tick one
cycle on (frame fb, unless a cut re-based the cycle in between); ticks
run on past the window's close until the pair is complete. Ticks whose
shown maps are the warm start's (cycles 0 and 1 of the first segment)
are not drawn. With cuts it also reads the first tick of one cut, a
uniform draw over the window's cuts on a stream of its own (so the
pair's draws do not move), running on past the window until it is held.
Each tick read gives its displayed frame and its two displayed cloud
maps, against the plain reference's maps (marched anew from the
snapshots that the engine's schedule gives those cycles) and its
composite of them.

The traced run labels each tick by the engine's private prebake stage
(`_prebake_stage()`) and tile-cull buckets (`_tile_buckets`), and a cut
tick as `cut`; a run whose engine lacks either stops before its window,
so that a renamed field can never leave `bake_tick_ms.serve` or
`v3_tick_ms.serve` silently empty. With cuts it traces a whole segment
from a cut tick, so that each traced pass holds one cut.
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
# The check's draws: the pair's reservoir stream, the first cycle it
# offers in the warm start's segment (cycles c − 2 and c − 1 hold the
# displayed maps of cycle c), and the stream of the cut's draw.
CHECK_STREAM, FIRST_CHECKED_CYCLE, CUT_STREAM = 3, 2, 5


def tile_arm(eng, bucket) -> str:
    """The arm that marches the engine's tile at a tile-cull bucket: the
    engine's own decision (`engine.tile_arm`)."""
    from cloudscape_tpu_torch.engine import tile_arm as arm

    region = eng.perf.update_region_size
    return arm(eng.kernel, bucket, region * region)


def last_setup_tick(plan: traffic.ServePlan) -> int:
    """Set-up runs ticks 0 .. this: the warm start, one whole cycle and,
    with cuts, the first cut."""
    return max(plan.frames, plan.cut_period)


def offered(plan: traffic.ServePlan, i: int) -> bool:
    """Whether the pair's draw offers tick i: frame fa, and maps shown
    that are not the warm start's."""
    seg, c, f = plan.where(i)
    return f == plan.check_offsets[0] and (seg > 0 or c >= FIRST_CHECKED_CYCLE)


def pair_end(plan: traffic.ServePlan, i: int) -> int:
    """The pair's second tick: one cycle on from i, at frame fb."""
    fa, fb = plan.check_offsets
    return i + plan.frames - fa + fb


def checked_ticks(plan: traffic.ServePlan, seed: int, offers: int) -> tuple:
    """The ticks that a window holding `offers` ticks the pair's draw
    offers checks (the control's stand-in for a window's draw): the
    pair, and with cuts the first tick of a cut drawn over that window's
    cuts (the first cut after it where it holds none)."""
    i = last_setup_tick(plan)
    ticks, cuts = [], []
    while len(ticks) < offers:
        i += 1
        if offered(plan, i):
            ticks.append(i)
        if plan.is_cut(i):
            cuts.append(i)
    (idx,) = traffic.reservoir_picks(seed, CHECK_STREAM, 1, offers)
    out = (ticks[idx], pair_end(plan, ticks[idx]))
    if not plan.cut_period:
        return out
    if not cuts:
        cuts = [(plan.segment(i) + 1) * plan.cut_period]
    (idx,) = traffic.reservoir_picks(seed, CUT_STREAM, 1, len(cuts))
    return out + (cuts[idx],)


def snapshots(plan: traffic.ServePlan, mix: dict, frames: int, last_cycle: int,
              segment: int = 0) -> dict:
    """{local cycle: reference Scene} for cycles −2 .. last_cycle of the
    segment `segment` (0: from the warm start; j: from cut j), by the
    engine's schedule. The segment's first tick (the warm start at tick
    0, or the cut) integrates the wind to its clock and takes the
    snapshot with its sun: the shown maps of cycles −2 to 1 and the
    active sun of cycles 0 and 1. A rotation at the segment's tick
    frames·k (k ≥ 1) integrates the wind to that tick's clock and
    freezes the head with the sun set before it, and that snapshot,
    baked across cycle k, is active in cycle k + 1. The wind carries
    over through each cut, integrated at every first tick and rotation
    in tick order, as the engine's is."""
    wind = scene.WindState(plan.wind_direction, mix["wind_speed"])
    kw = dict(density=mix["density"], coverage=mix["coverage"],
              ground_color=mix["ground_color"])
    for seg in range(segment + 1):
        start = seg * plan.cut_period
        wind.integrate(plan.now(start))
        first = scene.snapshot(wind, plan.sun(start), **kw)
        out = {-2: first, -1: first, 0: first, 1: first}
        # An earlier segment's rotations: those before the next cut.
        rotations = last_cycle if seg == segment else -(-plan.cut_period // frames)
        for k in range(1, rotations):
            wind.integrate(plan.now(start + frames * k))
            out[k + 1] = scene.snapshot(wind, plan.sun(start + frames * k), **kw)
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
    cut_pick = traffic.Reservoir(seed, CUT_STREAM, 1)
    # pair, cut: the checked pair and the checked cut's first tick, each
    # {tick: (frame, shown map from, shown map to)}; want: the tick that
    # completes the pair last drawn.
    pair, cut = {}, {}
    state = {"offer": False, "offer_cut": False, "want": None}

    def shown(frame):
        return (frame.clone(), eng.cloud_ring[eng.ring.texture_to_blend_from].clone(),
                eng.cloud_ring[eng.ring.texture_to_blend_to].clone())

    def tick(i: int):
        eng.set_sun(plan.sun(i))
        if plan.is_cut(i):
            eng.request_full_sky_init()
        frame = eng.render_frame(views[plan.view_of(i)], now=plan.now(i))
        if hooks is not None:
            frame = hooks.after_tick(eng, frame)
        take = i == state["want"]
        if state["offer"] and offered(plan, i) and pick.offer() is not None:
            pair.clear()
            state["want"], take = pair_end(plan, i), True
        elif take:
            state["want"] = None
        if take:
            pair[i] = shown(frame)
        if state["offer_cut"] and plan.is_cut(i) and cut_pick.offer() is not None:
            cut.clear()
            cut[i] = pair[i] if take else shown(frame)
        return frame

    def label(i: int) -> str:
        """Tick i's bake stage, read before it: a cut, a rotation, or the
        prebake's stage (none where it has none)."""
        if plan.is_cut(i):
            return "cut"
        stage = "rotate" if plan.where(i)[2] == 0 else (eng._prebake_stage() or "none")
        return f"bake:{stage}"

    def arm(i: int) -> str:
        """The arm of tick i's tile, by the cull buckets of its cycle."""
        return tile_arm(eng, eng._tile_buckets[plan.where(i)[2]] if eng._tile_buckets else None)

    def span(i: int) -> str:
        """Tick i's bake stage and, short of a cut or a rotation, its tile's arm."""
        lab = label(i)
        if lab in ("cut", "bake:rotate") or not eng._tile_buckets:
            return f"tick|{lab}"
        return f"tick|{lab}|tile:{arm(i)}"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    i = 0
    for i in range(last_setup_tick(plan) + 1):
        tick(i)
    sync()
    setup_done = time.perf_counter()

    times, labels = [], []
    state["offer"] = state["offer_cut"] = True
    t_start = time.perf_counter()
    while True:
        i += 1
        lab = label(i) if trace else None
        t0 = time.perf_counter()
        tick(i)
        sync()
        t1 = time.perf_counter()
        times.append(t1 - t0)
        if trace:
            labels.append((lab, arm(i)))
        if t1 - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    # Run on, untimed, until a pair is drawn and complete and, with cuts,
    # a cut is held.
    while state["want"] is not None or not pair or (plan.cut_period and not cut):
        state["offer"], state["offer_cut"] = not pair, not cut
        i += 1
        tick(i)
    state["offer"] = state["offer_cut"] = False
    sync()

    out = {"setup_done": setup_done, "attempted": len(times), "memory_peak_bytes": memory_peak,
           "metrics": {"frame_ms": common.window_mean_ms(window_s, len(times)),
                       "frame_p99_ms": common.p99([t * 1e3 for t in times])}}
    if trace:
        out["layer"] = {"ticks": [(t * 1e3, lab, arm) for t, (lab, arm) in zip(times, labels)]}
        if on_card:
            # With cuts, a whole segment from a cut tick.
            while plan.cut_period and not plan.is_cut(i + 1):
                i += 1
                tick(i)
            summary = common.TraceSummary()
            start = i + 1
            calls = common.trace_groups(lambda k: tick(start + k), plan.cut_period or frames,
                                        8, lambda k: span(start + k), summary)
            i += calls
            out["layer"]["trace"] = summary
            out["busy_s"], out["window_s"] = summary.busy_s, summary.window_s
            out["breakdown"] = summary.breakdown()
    del eng, views
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    kept = {**pair, **cut}
    out["checks"] = check(cfg, mix, plan, kept, (large, small, weather), dev)
    print(f"skybench: {len(times)} ticks in {window_s:.3f} s, checked ticks {sorted(kept)} "
          f"(ran to tick {i}); the check took {time.perf_counter() - t_check:.2f} s",
          file=sys.stderr)
    return out


def reference_outputs(cfg: dict, mix: dict, plan: traffic.ServePlan, ticks, noise, dev,
                      dtype=torch.float64) -> dict:
    """{tick: (frame, shown map from, shown map to)} by the plain
    reference in `dtype`: the two displayed maps marched anew from the
    snapshots of local cycles c − 2 and c − 1 of the tick's segment, and
    their composite for the tick's view, blend (its frame over frames)
    and active sun. A snapshot that several cycles share is marched once."""
    frames = cfg["frames_to_update"]
    where = [plan.where(t) for t in ticks]
    snaps = {}
    for seg in sorted({s for s, _, _ in where}):
        last = max(c for s, c, _ in where if s == seg)
        snaps.update({(seg, k): snap for k, snap in
                      snapshots(plan, mix, frames, last + 1, seg).items()})
    tex = ref_clouds.Textures.build(*noise, dtype=dtype)
    tlut = ref_atmo.transmittance_lut(dtype=dtype, device=dev)
    dirs = ref_comp.map_directions(cfg["texture_size"], dtype=dtype, device=dev)
    skies, maps = {}, {}

    def sky(snap):
        if snap not in skies:
            skies[snap] = ref_atmo.sky_lut(tlut, snap.light_direction)
        return skies[snap]

    def cloud_map(snap):
        if snap not in maps:
            maps[snap] = ref_clouds.cloud_march(dirs, snap, tex, sky(snap),
                                                steps=cfg["march_steps"],
                                                light_steps=cfg["light_steps"])
        return maps[snap]

    vw, vh = cfg["view"]
    out = {}
    for t, (seg, c, f) in zip(ticks, where):
        eye = scene.camera_views(vw, vh, [plan.yaws()[plan.view_of(t)]], dev)[0].to(dtype)
        shown_from, shown_to = snaps[(seg, c - 2)], snaps[(seg, c - 1)]
        frame = ref_comp.composite(eye, cloud_map(shown_from), cloud_map(shown_to),
                                   sky(shown_from), sky(shown_to), tlut, f / frames,
                                   mix["sun_disk_scale"], snaps[(seg, c)].light_direction)
        out[t] = (frame, cloud_map(shown_from), cloud_map(shown_to))
    return out


def check(cfg: dict, mix: dict, plan: traffic.ServePlan, kept: dict, noise, dev) -> list:
    """[(name, value, limit)]: the worst SNR of the displayed maps and of
    the displayed frames at the checked ticks (the pair, and a cut's first
    tick), against the plain reference in float64. SNR, not PSNR: a
    sparse sky's map is mostly empty, so its PSNR stays high even for a
    map without clouds."""
    want = reference_outputs(cfg, mix, plan, sorted(kept), noise, dev)
    maps = [common.snr_db(kept[t][j], want[t][j]) for t in kept for j in (1, 2)]
    frames = [common.snr_db(kept[t][0], want[t][0]) for t in kept]
    lim = cfg["limits"]
    return [("map_snr_db", min(maps), lim["map_snr_db"]),
            ("frame_snr_db", min(frames), lim["frame_snr_db"])]


# The ticks the pair's draw offers in a 51-s serving window: one a cycle
# without cuts (about 3,900 ticks of 64).
CONTROL_OFFERS = 60


def control(cfg: dict, mix: dict, seed: int, dev, dtype) -> list:
    """The check's numbers with the plain reference in `dtype` put in the
    program's place, at the ticks a full window of the seed would check."""
    plan = traffic.serve_plan(mix, seed, cfg["frames_to_update"])
    noise = scene.config_noise(cfg, dev)
    ticks = checked_ticks(plan, seed, CONTROL_OFFERS)
    got = reference_outputs(cfg, mix, plan, list(ticks), noise, dev, dtype)
    return check(cfg, mix, plan, got, noise, dev)
