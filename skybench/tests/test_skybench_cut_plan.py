"""The scene-cut plan of a serving mix (`traffic.serve_plan` with a `cut`
block) and the plain reference's schedule after a cut
(`kinds.serve.snapshots`), on the CPU; and that a mix without cuts keeps
the plan, the draws and the reference it had before cuts existed, held
against a frozen copy of those rules (the `_before_cuts_*` functions)."""

import math

import numpy as np
import pytest
import torch

from skybench import run, scene, traffic
from skybench.kinds import serve
from skybench.reference import atmosphere as ref_atmo
from skybench.reference import clouds as ref_clouds
from skybench.reference import composite as ref_comp
from skybench.tests.conftest import ROOT

BENCH = run.load_benchmark(ROOT)
# Every serving cell: (its ticks a cycle, its mix).
SERVE_CELLS = {w["name"]: (r["config"]["frames_to_update"], r["traffic"])
               for w in BENCH["workloads"]
               for r in [run.resolve(BENCH, w["name"], ROOT)] if r["traffic"]["kind"] == "serve"}
SEEDS = (7, 2 ** 31 + 11, 3_000_000_123)
SKIP_S = 3600.0


def _before_cuts_plan(mix: dict, seed: int, frames: int) -> dict:
    """The clock, sun, camera and check offsets of a seed as the plan drew
    them before cuts."""
    s = mix["serve"]
    r = np.random.default_rng(np.random.SeedSequence([seed & (2 ** 64 - 1), 1]))
    el_lo, el_hi = s["sun_elevation_deg"]
    views = int(s["camera_views"])
    step = 360.0 / views
    fa, fb = (int(v) for v in r.integers(0, frames, size=2))
    el0, az, yaw0 = float(r.uniform(el_lo, el_hi)), float(r.uniform(0.0, 360.0)), \
        float(r.uniform(0.0, 360.0))
    arc = float(s["sun_arc_deg_per_cycle"]) / frames
    t0, fps = float(mix["clock_origin_s"]), float(s["fps"])
    per_view = step / float(s["camera_pan_deg_per_s"]) * fps
    return {"now": lambda i: t0 + i / fps,
            "sun": lambda i: scene.sun_direction(el0 + arc * i, az),
            "view_of": lambda i: int(i / per_view) % views,
            "yaws": [yaw0 + k * step for k in range(views)], "offsets": (fa, fb)}


def _before_cuts_window_pair(seed: int, frames: int, offsets, ticks: int):
    """The pair a window of ticks frames + 1 .. ticks drew before cuts."""
    pick, kept, want = traffic.Reservoir(seed, 3, 1), [], None
    fa, fb = offsets
    for i in range(frames + 1, ticks + 1):
        c, f = divmod(i, frames)
        take = i == want
        if c >= 2 and f == fa and pick.offer() is not None:
            kept, want, take = [], (c + 1) * frames + fb, True
        elif take:
            want = None
        if take:
            kept.append(i)
    return kept


def _before_cuts_snapshots(old: dict, mix: dict, frames: int, last_cycle: int) -> dict:
    wind = scene.WindState(traffic.wind_direction(mix), mix["wind_speed"])
    kw = dict(density=mix["density"], coverage=mix["coverage"], ground_color=mix["ground_color"])
    wind.integrate(old["now"](0))
    first = scene.snapshot(wind, old["sun"](0), **kw)
    out = {-2: first, -1: first, 0: first, 1: first}
    for k in range(1, last_cycle):
        wind.integrate(old["now"](frames * k))
        out[k + 1] = scene.snapshot(wind, old["sun"](frames * k), **kw)
    return out


def _window_pair(plan: traffic.ServePlan, seed: int, ticks: int):
    """The pair the serve kind's draws keep over window ticks after set-up."""
    pick, kept, want = traffic.Reservoir(seed, serve.CHECK_STREAM, 1), [], None
    for i in range(serve.last_setup_tick(plan) + 1, ticks + 1):
        take = i == want
        if serve.offered(plan, i) and pick.offer() is not None:
            kept, want, take = [], serve.pair_end(plan, i), True
        elif take:
            want = None
        if take:
            kept.append(i)
    return kept


def _cut_mix(frames: int, after: int, at: int, skip: float = SKIP_S) -> dict:
    mix = traffic.load("broken-0.35")
    return dict(mix, serve=dict(mix["serve"], cut={"after_cycles": after, "at_frame": at,
                                                   "time_skip_s": skip}))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", sorted(SERVE_CELLS))
def test_a_mix_without_cuts_keeps_its_plan_and_draws(cell, seed):
    frames, mix = SERVE_CELLS[cell]
    plan, old = traffic.serve_plan(mix, seed, frames), _before_cuts_plan(mix, seed, frames)
    assert plan.cut_period == 0 and plan.check_offsets == old["offsets"]
    assert plan.yaws() == old["yaws"]
    for i in list(range(4 * frames + 3)) + [5_000, 12_345, 400_000]:
        assert not plan.is_cut(i) and plan.where(i) == (0,) + divmod(i, frames)
        assert plan.now(i) == old["now"](i) and plan.sun(i) == old["sun"](i)
        assert plan.view_of(i) == old["view_of"](i)
    fa, fb = old["offsets"]
    (idx,) = traffic.reservoir_picks(seed, 3, 1, 60)
    assert serve.checked_ticks(plan, seed, serve.CONTROL_OFFERS) == \
        ((2 + idx) * frames + fa, (3 + idx) * frames + fb)
    for ticks in (3 * frames, 40 * frames + 7, 61 * frames):
        assert _window_pair(plan, seed, ticks) == \
            _before_cuts_window_pair(seed, frames, old["offsets"], ticks)
    assert serve.snapshots(plan, mix, frames, 9) == _before_cuts_snapshots(old, mix, frames, 9)


def test_the_reference_without_cuts_is_as_before():
    """`reference_outputs` at a tiny size: the shown maps of cycles c − 2
    and c − 1 and their composite at blend (t mod frames) / frames, as
    before cuts."""
    mix = SERVE_CELLS["serve-768-f64.broken-0.35"][1]
    frames, seed, dev = 8, SEEDS[1], torch.device("cpu")
    cfg = dict(run.resolve(BENCH, "serve-768-f64.broken-0.35", ROOT)["config"],
               frames_to_update=frames, texture_size=8, march_steps=8, view=[6, 4],
               noise={"seed": 0, "base": 8, "detail": 4, "weather": 8})
    plan, old = traffic.serve_plan(mix, seed, frames), _before_cuts_plan(mix, seed, frames)
    noise = scene.config_noise(cfg, dev)
    ticks = [2 * frames + 3, 3 * frames, 5 * frames + 7]
    got = serve.reference_outputs(cfg, mix, plan, ticks, noise, dev)
    snaps = _before_cuts_snapshots(old, mix, frames, 6)
    tex = ref_clouds.Textures.build(*noise, dtype=torch.float64)
    tlut = ref_atmo.transmittance_lut(dtype=torch.float64)
    dirs = ref_comp.map_directions(8, dtype=torch.float64)
    for t in ticks:
        c = t // frames
        sky = [ref_atmo.sky_lut(tlut, snaps[k].light_direction) for k in (c - 2, c - 1)]
        maps = [ref_clouds.cloud_march(dirs, snaps[k], tex, s, steps=8,
                                       light_steps=cfg["light_steps"])
                for k, s in zip((c - 2, c - 1), sky)]
        eye = scene.camera_views(6, 4, [old["yaws"][old["view_of"](t)]], dev)[0].double()
        frame = ref_comp.composite(eye, maps[0], maps[1], sky[0], sky[1], tlut,
                                   (t % frames) / frames, mix["sun_disk_scale"],
                                   snaps[c].light_direction)
        for a, b in zip(got[t], (frame, maps[0], maps[1])):
            assert torch.equal(a, b), t


@pytest.mark.parametrize("frames", [4, 16, 64])
@pytest.mark.parametrize("after,at", [(1, 0), (1, "half"), (2, "last")])
def test_cuts_land_at_frame_f_of_a_rebased_cycle_and_skip_the_clock(frames, after, at):
    at = {"half": frames // 2, "last": frames - 1}.get(at, at)
    plans = [traffic.serve_plan(_cut_mix(frames, after, at), seed, frames) for seed in SEEDS]
    plan, period = plans[0], after * frames + at
    assert plan.cut_period == period
    span = range(5 * period + 1)
    cuts = [i for i in span if plan.is_cut(i)]
    assert cuts == [period * j for j in range(1, 6)]
    for j, c in enumerate(cuts, 1):
        assert plan.where(c) == (j, 0, 0)
        # The tick before: frame F − 1 of the re-based cycle A, or the last
        # frame of cycle A − 1 where F is 0.
        assert plan.where(c - 1) == ((j - 1, after, at - 1) if at else
                                     (j - 1, after - 1, frames - 1))
    for i in span:
        seg, cycle, f = plan.where(i)
        assert i == seg * period + cycle * frames + f and 0 <= f < frames
    for i in span[1:]:
        step = plan.now(i) - plan.now(i - 1)
        assert step == pytest.approx(1 / plan.fps + (SKIP_S if plan.is_cut(i) else 0.0),
                                     abs=1e-9)
    assert plan.now(cuts[-1]) == plan.t0 + cuts[-1] / plan.fps + SKIP_S * 5
    # Every seed does the same work: the same cut ticks and clock.
    for other in plans[1:]:
        assert [other.now(i) for i in span] == [plan.now(i) for i in span]
        assert [i for i in span if other.is_cut(i)] == cuts


def test_the_sun_is_drawn_afresh_only_at_cuts():
    frames, after, at = 16, 1, 5
    mix = _cut_mix(frames, after, at)
    plan, period = traffic.serve_plan(mix, SEEDS[2], frames), after * frames + at
    no_cut = traffic.serve_plan(traffic.load("broken-0.35"), SEEDS[2], frames)
    lo, hi = mix["serve"]["sun_elevation_deg"]
    arc = plan.arc_per_tick

    def angle(a, b):
        return math.degrees(math.acos(min(1.0, float(np.dot(a, b)))))

    jumps = []
    for i in range(1, 6 * period):
        if plan.is_cut(i):
            jumps.append(angle(plan.sun(i - 1), plan.sun(i)))
        else:
            assert angle(plan.sun(i - 1), plan.sun(i)) <= arc + 1e-6, i
    assert max(jumps) > 5.0
    for i in range(period):
        assert plan.sun(i) == no_cut.sun(i)
    for j in range(1, 6):
        el, az = plan.cut_sun(j)
        assert lo <= el <= hi and 0.0 <= az < 360.0
        for i in (j * period, j * period + 7):
            assert plan.sun(i) == scene.sun_direction(el + arc * (i - j * period), az)
    assert plan.cut_sun(1) != traffic.serve_plan(mix, SEEDS[0], frames).cut_sun(1)


def test_snapshots_after_a_cut_take_the_cut_snapshot():
    """After cut j at tick c the shown maps of local cycles −2 to 1 take
    the cut's snapshot (the wind integrated to now(c) through every first
    tick and rotation before it, in tick order, and the cut's sun); the
    rotation at c + frames takes the snapshot active in local cycle 2."""
    frames, after, at = 8, 2, 3
    mix = _cut_mix(frames, after, at)
    plan, period = traffic.serve_plan(mix, SEEDS[1], frames), after * frames + at
    kw = dict(density=mix["density"], coverage=mix["coverage"], ground_color=mix["ground_color"])
    for seg in (1, 2, 3):
        wind = scene.WindState(plan.wind_direction, mix["wind_speed"])
        for s in range(seg):
            # Segment s's first tick, then each rotation before the next cut.
            for t in range(s * period, (s + 1) * period, frames):
                wind.integrate(plan.now(t))
        c = seg * period
        wind.integrate(plan.now(c))
        want = scene.snapshot(wind, plan.sun(c), **kw)
        snaps = serve.snapshots(plan, mix, frames, after, seg)
        assert [snaps[k] for k in (-2, -1, 0, 1)] == [want] * 4
        assert want != serve.snapshots(plan, mix, frames, after, seg - 1)[0]
        wind.integrate(plan.now(c + frames))
        assert snaps[2] == scene.snapshot(wind, plan.sun(c + frames), **kw)


@pytest.mark.parametrize("after,at", [(0, 0), (1, -1), (1, 16), (2, 40)])
def test_a_cut_block_out_of_range_is_refused(after, at):
    with pytest.raises(ValueError):
        traffic.serve_plan(_cut_mix(16, after, at), SEEDS[0], 16)
