"""The port's prebake at the upstream's fastest refresh, frames_to_update 4,
on the CPU: a plan of more stage steps than the cycle has ticks groups
consecutive steps into ticks, so the next cycle's cone cache, sky LUT and
tile-cull map are ready at every rotation; plans that fit (16, 64) are
left exactly as they were.

The engines run fast3 with tile cull at a 64² map, 16 steps and a (4, 32,
32) cone cache, on the benchmark's own noise (`skybench.scene`) at 16³ /
8³ / 64²; the reference is the benchmark's plain float64 one
(`skybench/reference/`), at the snapshot timing of its serving check
(`skybench.kinds.serve.snapshots`).
"""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cloudscape_tpu_torch import CloudConfig, PerfConfig, SunState, probe_prebake
from cloudscape_tpu_torch import engine as tengine
from cloudscape_tpu_torch.engine import CloudSkyEngine
from cloudscape_tpu_torch.models.packs import make_noise_pack
from cloudscape_tpu_torch.utils.profiling import reset_spans, span_stats
from skybench import common, scene, traffic
from skybench.kinds import serve

torch.set_num_threads(min(2, torch.get_num_threads()))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = torch.device("cpu")
# The benchmark's f4 configuration at the tiny sizes of skybench's own CPU
# runs (skybench/tests/conftest.py's TINY).
TINY = dict(texture_size=64, march_steps=16, cone_res=[4, 32, 32], view=[32, 18],
            noise={"seed": 0, "base": 16, "detail": 8, "weather": 64})
SEED = 3_000_000_123
CYCLES = 10


def _cfg(frames: int) -> dict:
    with open(os.path.join(ROOT, "skybench", "configs", "serve-768-f4.json")) as f:
        cfg = json.load(f)
    return dict(cfg, frames_to_update=frames, **TINY)


def _mix(**serve_change) -> dict:
    """The f4 cell's mix at coverage 0.7, since a 64² map at 0.35 holds few
    clouds (skybench/tests/conftest.py's TINY_TRAFFIC)."""
    mix = traffic.load("broken4-0.35")
    return dict(mix, coverage=0.7, serve=dict(mix["serve"], **serve_change))


def _engine(cfg: dict, mix: dict, plan: traffic.ServePlan, noise) -> CloudSkyEngine:
    """The serving cell's engine (skybench/kinds/serve.py's `run`)."""
    return CloudSkyEngine(
        perf=PerfConfig(texture_size=cfg["texture_size"],
                        frames_to_update=cfg["frames_to_update"],
                        march_steps=cfg["march_steps"], light_steps=cfg["light_steps"]),
        config=CloudConfig(wind_direction=plan.wind_direction, wind_speed=mix["wind_speed"],
                           density=mix["density"], cloud_coverage=mix["coverage"],
                           sun_disk_scale=mix["sun_disk_scale"],
                           ground_color=tuple(mix["ground_color"]) + (1.0,)),
        sun=SunState(direction=plan.sun(0)), noise=make_noise_pack(*noise),
        now=plan.now(0), kernel=cfg["kernel"], cone_res=tuple(cfg["cone_res"]),
        tile_cull=cfg["tile_cull"], device=DEV)


def _schedule(frames: int, tile_cull: bool = True, **shape) -> CloudSkyEngine:
    """An engine with only what `_derive_prebake_schedule` reads, at the
    serving point's shapes unless `shape` says otherwise."""
    eng = CloudSkyEngine.__new__(CloudSkyEngine)
    eng.cone_res = shape.get("cone_res", (32, 512, 512))
    eng.perf = PerfConfig(texture_size=shape.get("texture_size", 768),
                          frames_to_update=frames, march_steps=shape.get("march_steps", 128))
    eng.tile_cull = tile_cull
    eng.device = DEV
    eng._derive_prebake_schedule()
    return eng


def test_group_steps_lightens_the_heaviest_tick():
    """The grouping: contiguous groups, at most `ticks` of them, the
    heaviest as light as any grouping's, each filled in order up to it."""
    costs = [3.86, 0.0, 14.84, 0.0, 0.08, 9.04, 0.0, 0.0]
    assert tengine._group_steps(costs, 3) == (2, 4, 8)
    assert tengine._group_steps(costs, 1) == (8,)
    assert tengine._group_steps([1.0, 1.0, 1.0, 1.0], 2) == (2, 4)
    assert tengine._group_steps([1.0, 2.0], 5) == (1, 2)


@pytest.mark.parametrize("tile_cull", [True, False])
def test_f4_plan_completes_the_bake_inside_the_cycle(tile_cull):
    """At PerfConfig(768, 4, 128) with a (32, 512, 512) cone cache the
    plan's steps (ten ticks with the boundary and slack: more than the
    cycle's four) go into the three ticks after the boundary, every step
    once and in order; the heaviest tick is the cone march's."""
    eng = _schedule(4, tile_cull)
    ends = eng._bake_group_ends
    groups = [list(eng._bake_steps[a:b]) for a, b in zip((0,) + ends, ends)]
    want = [["occupancy", "finalize"], ["cone", "wrap"], ["sky_band"]]
    if tile_cull:
        want[2] += ["cull", "cull_finalize", "cull_read"]
    assert groups == want
    assert eng._bake_ticks == 4 <= eng.perf.frames_to_update
    call_ms, unit_ms = eng._BAKE_COSTS["cone"]
    assert eng._bake_budget_ms == pytest.approx(call_ms + eng._cone_capacity * unit_ms)


# The parent's plans where they fit, read from it before the grouping was
# added: (frames, shape) → the schedule `probe_prebake.schedule` reports.
FITTING_PLANS = {
    (16, "serving"): dict(occ=[8388608, 1], cone=[3801088, 1], sky=[100, 1],
                          cull=[147456, 1], budget_ms=14.925808884030014, ticks=10),
    (64, "serving"): dict(occ=[8388608, 1], cone=[3801088, 1], sky=[100, 1],
                          cull=[147456, 1], budget_ms=14.925808884030014, ticks=10),
    (16, "tiny"): dict(occ=[4096, 1], cone=[65536, 1], sky=[100, 1], cull=[1024, 1],
                       budget_ms=14.925808884030014, ticks=10),
    (64, "tiny"): dict(occ=[4096, 1], cone=[65536, 1], sky=[100, 1], cull=[1024, 1],
                       budget_ms=14.925808884030014, ticks=10),
}
# The parent's stage a tick (`probe_prebake.stage_of`) from the tick after
# the first rotation's, at the tiny size; then steady ticks to the boundary.
FITTING_TICKS = ["occupancy", "finalize", "cone", "wrap", "sky_band", "cull",
                 "cull_finalize", "cull_read"]


@pytest.mark.parametrize("frames", [16, 64])
def test_fitting_plans_and_ticks_are_unchanged(frames):
    """At 16 and 64 frames the plan (slices, steps a stage, budget, ticks)
    at the serving point's and the tiny shapes is the parent's, one step a
    tick, and an engine's ticks over a whole cycle run the parent's stages
    in the parent's ticks."""
    tiny = dict(texture_size=64, march_steps=16, cone_res=(4, 32, 32))
    for shape, kw in (("serving", {}), ("tiny", tiny)):
        eng = _schedule(frames, **kw)
        got = probe_prebake.schedule(eng)
        assert got.pop("groups") == [[step] for step in eng._bake_steps], shape
        assert got == FITTING_PLANS[frames, shape], shape
    cfg, mix = _cfg(frames), _mix()
    plan = traffic.serve_plan(mix, SEED, frames)
    eng = _engine(cfg, mix, plan, scene.config_noise(cfg, DEV))
    eng.render_frame(torch.zeros((2, 2, 3)) + torch.tensor([0.0, 1.0, 0.0]), now=plan.now(0))
    stages = []
    for i in range(1, frames + 1):
        stages.append(probe_prebake.stage_of(eng))
        eng.update_sky(now=plan.now(i))
    assert stages == (FITTING_TICKS + ["steady"] * (frames - 1 - len(FITTING_TICKS))
                      + ["boundary"])


def test_f4_rotations_pick_up_the_pending_bake():
    """Ten f4 cycles after the warm start: no rotation builds synchronously
    and no bake step is thrown away; each rotation's cone cache, sky LUT
    and buckets are the pending cycle's objects, and they are bitwise the
    synchronous bake of the same snapshot. Each baking tick is one
    `bake.tick` span around its `prebake.<stage>` steps."""
    cfg, mix = _cfg(4), _mix()
    plan = traffic.serve_plan(mix, SEED, 4)
    eng = _engine(cfg, mix, plan, scene.config_noise(cfg, DEV))
    view = scene.camera_views(8, 6, [0.0], DEV)[0]
    eng.render_frame(view, now=plan.now(0))  # the warm start
    sync0, dropped0 = tengine.sync_bakes, tengine.dropped_bake_steps
    stages, rotations = [], 0
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(1, 4 * CYCLES + 1):
            stages.append(probe_prebake.stage_of(eng))
            pend = eng._pending
            eng.set_sun(plan.sun(i))
            eng.render_frame(view, now=plan.now(i))
            if stages[-1] != "boundary":
                continue
            rotations += 1
            assert eng._cone_cache is pend.cone
            assert eng._tile_buckets is pend.buckets and eng._prio_map is pend.prio
            assert eng.sky_ring[(eng.ring.sky_lut_current - 1) % 3].equal(pend.sky)
            assert eng.frame_data is pend.frame_data
            cone = eng._build_cone(pend.march_params)
            assert torch.equal(cone.table.texels, pend.cone.table.texels)
            prio, buckets = eng._compute_tile_cull(pend.march_params)
            assert torch.equal(prio, pend.prio) and buckets == pend.buckets
            assert torch.equal(eng._render_sky_image(eng._light_dir(pend.frame_data)),
                               pend.sky)
    stats = span_stats()
    reset_spans()
    assert (tengine.sync_bakes - sync0, tengine.dropped_bake_steps - dropped0) == (0, 0)
    assert rotations == CYCLES and "engine.sync_bake" not in stats
    cycle = ["occupancy+finalize", "cone+wrap",
             "sky_band+cull+cull_finalize+cull_read", "boundary"]
    assert stages == cycle * CYCLES
    assert stats["bake.tick"]["count"] == 3 * CYCLES
    assert stats["bake.tick"]["parent"] is None
    for st in ("occupancy", "finalize", "cone", "wrap", "sky_band", "cull",
               "cull_finalize", "cull_read"):
        assert stats["prebake." + st]["count"] == CYCLES, st
        assert stats["prebake." + st]["parent"] == "bake.tick", st


def test_sync_bake_span_and_counters_where_no_bake_is_pending():
    """`update_cycle` bakes nothing across ticks, so each of its rotations
    builds synchronously: one `engine.sync_bake` and one count a call, the
    pending cycle it replaces never advanced (nothing dropped); a
    rotation that finds a half-baked cycle counts the steps it drops."""
    cfg, mix = _cfg(4), _mix()
    plan = traffic.serve_plan(mix, SEED, 4)
    eng = _engine(cfg, mix, plan, scene.config_noise(cfg, DEV))
    eng.update_cycle(now=plan.now(0))
    sync0, dropped0 = tengine.sync_bakes, tengine.dropped_bake_steps
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        eng.update_cycle(now=plan.now(4))
    stats = span_stats()
    reset_spans()
    assert stats["engine.sync_bake"]["count"] == 1
    assert stats["engine.sync_bake"]["parent"] == "engine.snapshot"
    assert stats["cone.build"]["parent"] == "engine.sync_bake"
    assert (tengine.sync_bakes - sync0, tengine.dropped_bake_steps - dropped0) == (1, 0)
    eng.update_sky(now=plan.now(8))  # a rotation (its pending never baked)
    eng.update_sky(now=plan.now(9))  # the first group: two steps
    assert eng._pending.steps_done == 2
    eng.update_cycle(now=plan.now(10))  # the cycle's rest, no bake
    eng.update_cycle(now=plan.now(12))  # a rotation that drops the two
    assert (tengine.sync_bakes - sync0, tengine.dropped_bake_steps - dropped0) == (3, 2)


# Map and frame SNR limits against the float64 reference (dB). The tiny
# march (16 steps, a (4, 32, 32) cone cache, v3 tiles at ray stride 2)
# lies farther from the reference than the card's: skybench's tiny serving
# runs read maps 15.0-15.9 dB and frames 22.2-26.6 dB, and hold them to 8
# and 18 dB (skybench/tests/conftest.py's TINY_LIMITS), the limits here.
MAP_DB, FRAME_DB = 8.0, 18.0
# The wind blows 1,500 m/s here, 100 m a 4-tick cycle (the cell's 10 m/s
# would hide a snapshot a cycle late), so a map marched from the next
# cycle's snapshot is another cloud field: the shown maps read -0.6 to
# 0.0 dB against it and 12.2-17.3 dB against their own (measured), and
# the check asks for this much more (dB) against their own.
TIMING_DB = 6.0
WIND_SPEED = 1500.0


@pytest.mark.parametrize("arm", ["v3", "v2"])
def test_f4_maps_match_the_reference_at_the_serve_timing(monkeypatch, arm):
    """The f4 engine's shown maps and frames, at ticks of cycles 2 to 5,
    against the reference marched from the snapshots the serve check
    assigns them (each snapshot active one cycle after the rotation that
    took it), within MAP_DB / FRAME_DB, and each map TIMING_DB closer to
    it than to the next cycle's. In the v2 case V3_TILE_MIN_RAYS is cut to
    the 32² tile's 1,024 rays and the cell buckets end at 0.5, so the
    tiles the cull fills take the staged v2 arm (the arm of the card's
    384² tiles with a 1.0 bucket) in the ticks and in the warm start."""
    if arm == "v2":
        monkeypatch.setattr(tengine, "V3_TILE_MIN_RAYS", 32 * 32)
        monkeypatch.setattr(tengine, "V3_TILE_CELL_BUCKETS", (0.25, 0.375, 0.5))
    cfg, mix = _cfg(4), dict(_mix(), wind_speed=WIND_SPEED)
    plan = traffic.serve_plan(mix, SEED, 4)
    noise = scene.config_noise(cfg, DEV)
    eng = _engine(cfg, mix, plan, noise)
    views = scene.camera_views(*cfg["view"], plan.yaws(), DEV)
    checked = [4 * c + 1 for c in range(2, 6)]
    kept = {}
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(checked[-1] + 1):
            eng.set_sun(plan.sun(i))
            frame = eng.render_frame(views[plan.view_of(i)], now=plan.now(i))
            if i in checked:
                kept[i] = (frame.clone(),
                           eng.cloud_ring[eng.ring.texture_to_blend_from].clone(),
                           eng.cloud_ring[eng.ring.texture_to_blend_to].clone())
    arms = {k[5:]: v["count"] for k, v in span_stats().items() if k.startswith("tile.")}
    reset_spans()
    assert arms.get(arm, 0) > 0, arms
    want = serve.reference_outputs(cfg, mix, plan, checked + [checked[-1] + 4], noise, DEV)
    for t in checked:
        c = t // 4
        frame, shown_from, shown_to = kept[t]
        ref_frame, ref_from, ref_to = want[t]
        assert common.snr_db(frame, ref_frame) >= FRAME_DB, t
        # (shown map, its reference, the reference a cycle late, the shown
        # map's cycle); cycles 0 and 1 share the first snapshot.
        for got, ref, late, k in ((shown_from, ref_from, ref_to, c - 2),
                                  (shown_to, ref_to, want[t + 4][2], c - 1)):
            db = common.snr_db(got, ref)
            assert db >= MAP_DB, (t, db)
            if k >= 1:
                assert db >= common.snr_db(got, late) + TIMING_DB, (t, db)
