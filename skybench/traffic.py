"""The one traffic generator: it reads a mix's parameters from
`skybench/traffic/<name>.json` and draws, from the run's seed, the inputs
each kind of cell hands the program.

A mix's file names the kind of cell that drives it (`kind`: `serve` or
`cycle`, a module of `skybench/kinds/`), the scene's user parameters
(`coverage`, `wind_speed`, `wind_direction_deg`, `density`,
`sun_disk_scale`, `ground_color`), the clock's origin (`clock_origin_s`)
and a block of the kind's own. The wind and the clock are fixed by the
mix, so every seed drives the same cloud field through the same tiles:
the same work. The seed moves only what leaves the work unchanged: where
the sun starts and goes, where the camera looks, and which outputs of
the window are checked (a uniform sample of the whole window, drawn by
`Reservoir`).

A `serve` mix may script scene cuts (a teleport, fast travel or a time
skip in a game): `"cut": {"after_cycles": A, "at_frame": F,
"time_skip_s": S}` in its `serve` block, A >= 1 and 0 <= F < frames.
Cut j (j >= 1) falls at tick j * P, P = A * frames + F: the clock skips
S seconds ahead, the sun is drawn afresh, and the kind asks the engine
for a full sky init, which re-bases the cycle at that tick, as the warm
start does at tick 0. The cut ticks and the skip come from the mix, so
every seed does the same work.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os

import numpy as np

from skybench.scene import sun_direction

TRAFFIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "traffic")


def load(name: str, directory: str = TRAFFIC_DIR) -> dict:
    """The mix `name`'s parameters."""
    with open(os.path.join(directory, name + ".json")) as f:
        return json.load(f)


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *stream]))


# The seed's stream of the suns that scene cuts draw (1: the plan, 2: a
# cycle mix's quality scenes, 3: the checks' draws, 5: the serve check's
# draw of a cut).
CUT_SUN_STREAM = 4


class Reservoir:
    """A uniform sample of `size` items of a stream whose length is known
    only at its end (Algorithm R), its draws from the run's seed: the
    window's outputs that the check reads, from its whole length."""

    def __init__(self, seed: int, stream: int, size: int):
        self._rng = _rng(seed, stream)
        self.size = size
        self.seen = 0

    def offer(self):
        """The slot (0 .. size − 1) the next item of the stream takes, or
        None when the sample passes it over."""
        self.seen += 1
        if self.seen <= self.size:
            return self.seen - 1
        j = int(self._rng.integers(0, self.seen))
        return j if j < self.size else None


def reservoir_picks(seed: int, stream: int, size: int, items: int) -> list:
    """The item indices a `Reservoir` keeps from a stream of `items`."""
    res, kept = Reservoir(seed, stream, size), {}
    for i in range(items):
        slot = res.offer()
        if slot is not None:
            kept[slot] = i
    return sorted(kept.values())


def wind_direction(mix: dict) -> float:
    """The mix's wind direction in radians."""
    return math.radians(float(mix["wind_direction_deg"]))


@dataclasses.dataclass(frozen=True)
class ServePlan:
    """The serving session of one seed: tick i runs at clock `now(i)`,
    with the sun at `sun(i)` and the camera's view `view_of(i)`.

    Without cuts (`cut_period` 0) the clock is t0 + i / fps and the sun
    climbs `arc_per_tick` a tick from where the seed put it. With cuts,
    cut j falls at tick j * cut_period (`is_cut`): every tick from it on
    runs `time_skip_s` later, and the sun starts afresh from a draw of
    its own (`cut_sun`) and climbs from there. `where(i)` answers for
    every reader which segment (0 from the warm start, j from cut j),
    local cycle and frame tick i falls in. The check's pair of ticks
    starts at frame `check_offsets[0]`."""

    t0: float
    fps: float
    wind_direction: float
    sun_elevation0: float
    sun_azimuth: float
    arc_per_tick: float
    yaw0: float
    view_step: float
    views: int
    ticks_per_view: float
    check_offsets: tuple
    frames: int
    seed: int
    sun_elevation_range: tuple
    cut_period: int = 0
    time_skip_s: float = 0.0

    def segment(self, i: int) -> int:
        """The cuts at or before tick i: 0 before the first."""
        return i // self.cut_period if self.cut_period else 0

    def is_cut(self, i: int) -> bool:
        return self.cut_period > 0 and i > 0 and i % self.cut_period == 0

    def where(self, i: int) -> tuple:
        """(segment, local cycle, frame) of tick i: the cycle re-based
        at the segment's first tick."""
        seg = self.segment(i)
        return (seg,) + divmod(i - seg * self.cut_period, self.frames)

    def now(self, i: int) -> float:
        t = self.t0 + i / self.fps
        cuts = self.segment(i)
        return t + self.time_skip_s * cuts if cuts else t

    def cut_sun(self, j: int) -> tuple:
        """(elevation, azimuth) in degrees at cut j."""
        return _cut_sun(self.seed, j, *self.sun_elevation_range)

    def sun(self, i: int) -> tuple:
        seg = self.segment(i)
        if seg == 0:
            return sun_direction(self.sun_elevation0 + self.arc_per_tick * i, self.sun_azimuth)
        elevation, azimuth = self.cut_sun(seg)
        return sun_direction(elevation + self.arc_per_tick * (i - seg * self.cut_period),
                             azimuth)

    def yaws(self) -> list:
        return [self.yaw0 + k * self.view_step for k in range(self.views)]

    def view_of(self, i: int) -> int:
        return int(i / self.ticks_per_view) % self.views


@functools.lru_cache(maxsize=4096)
def _cut_sun(seed: int, j: int, el_lo: float, el_hi: float) -> tuple:
    r = _rng(seed, CUT_SUN_STREAM, j)
    return float(r.uniform(el_lo, el_hi)), float(r.uniform(0.0, 360.0))


def cut_period(mix: dict, frames: int) -> int:
    """P, the ticks from one cut to the next (0 for a mix without cuts);
    raises ValueError for a `cut` block out of range."""
    cut = mix["serve"].get("cut")
    if cut is None:
        return 0
    after, at = int(cut["after_cycles"]), int(cut["at_frame"])
    if after < 1 or not 0 <= at < frames:
        raise ValueError(f"cut after_cycles {after}, at_frame {at}: wants after_cycles >= 1 "
                         f"and 0 <= at_frame < {frames}")
    return after * frames + at


def serve_plan(mix: dict, seed: int, frames: int) -> ServePlan:
    """The plan of a `serve` cell; frames: the engine's ticks a cycle."""
    s = mix["serve"]
    r = _rng(seed, 1)
    el_lo, el_hi = s["sun_elevation_deg"]
    views = int(s["camera_views"])
    step = 360.0 / views
    fa, fb = (int(v) for v in r.integers(0, frames, size=2))
    period = cut_period(mix, frames)
    return ServePlan(
        t0=float(mix["clock_origin_s"]), fps=float(s["fps"]),
        wind_direction=wind_direction(mix),
        sun_elevation0=float(r.uniform(el_lo, el_hi)),
        sun_azimuth=float(r.uniform(0.0, 360.0)),
        arc_per_tick=float(s["sun_arc_deg_per_cycle"]) / frames,
        yaw0=float(r.uniform(0.0, 360.0)), view_step=step, views=views,
        ticks_per_view=step / float(s["camera_pan_deg_per_s"]) * float(s["fps"]),
        check_offsets=(fa, fb), frames=frames, seed=int(seed),
        sun_elevation_range=(float(el_lo), float(el_hi)), cut_period=period,
        time_skip_s=float(s["cut"]["time_skip_s"]) if period else 0.0)


@dataclasses.dataclass(frozen=True)
class CyclePlan:
    """The re-renders of one seed: call k completes a cycle at clock
    t0 + k · cycle_s with the sun at `sun(k)`; the fixed quality scenes
    (the same in every run) at `quality_now(j)`, `quality_sun(j)`."""

    t0: float
    cycle_s: float
    wind_direction: float
    suns: tuple
    quality: tuple

    def now(self, k: int) -> float:
        return self.t0 + k * self.cycle_s

    def sun(self, k: int) -> tuple:
        return self.suns[k % len(self.suns)]

    def quality_now(self, j: int) -> float:
        return self.quality[j][0]

    def quality_sun(self, j: int) -> tuple:
        return self.quality[j][1]


def _suns(r: np.random.Generator, count: int, el_range) -> tuple:
    return tuple(sun_direction(float(r.uniform(*el_range)), float(r.uniform(0.0, 360.0)))
                 for _ in range(count))


def cycle_plan(mix: dict, seed: int, frames: int) -> CyclePlan:
    """The plan of a `cycle` cell; frames: the engine's ticks a cycle,
    each 1 / fps of the engine's clock. The seed draws a stream of suns
    (reused in turn); the quality scenes come from the mix's own seed."""
    s = mix["cycle"]
    q = s["quality_scenes"]
    qr = _rng(int(q["seed"]), 2)
    quality = tuple((float(mix["clock_origin_s"]) + float(q["after_s"]) * (j + 1), sun)
                    for j, sun in enumerate(_suns(qr, int(q["count"]), s["sun_elevation_deg"])))
    return CyclePlan(t0=float(mix["clock_origin_s"]), cycle_s=frames / float(s["fps"]),
                     wind_direction=wind_direction(mix),
                     suns=_suns(_rng(seed, 1), int(s["suns"]), s["sun_elevation_deg"]),
                     quality=quality)
