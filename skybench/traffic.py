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
"""

from __future__ import annotations

import dataclasses
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


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) & (2 ** 64 - 1), stream]))


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
    """The serving session of one seed: tick i runs at clock
    t0 + i / fps, with the sun at `sun(i)` and the camera's view
    `view_of(i)`. The check reads a pair of ticks, at `check_offsets`
    into consecutive cycles c and c + 1, c a uniform draw over the
    window's cycles."""

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

    def now(self, i: int) -> float:
        return self.t0 + i / self.fps

    def sun(self, i: int) -> tuple:
        return sun_direction(self.sun_elevation0 + self.arc_per_tick * i, self.sun_azimuth)

    def yaws(self) -> list:
        return [self.yaw0 + k * self.view_step for k in range(self.views)]

    def view_of(self, i: int) -> int:
        return int(i / self.ticks_per_view) % self.views


def serve_plan(mix: dict, seed: int, frames: int) -> ServePlan:
    """The plan of a `serve` cell; frames: the engine's ticks a cycle."""
    s = mix["serve"]
    r = _rng(seed, 1)
    el_lo, el_hi = s["sun_elevation_deg"]
    views = int(s["camera_views"])
    step = 360.0 / views
    fa, fb = (int(v) for v in r.integers(0, frames, size=2))
    return ServePlan(
        t0=float(mix["clock_origin_s"]), fps=float(s["fps"]),
        wind_direction=wind_direction(mix),
        sun_elevation0=float(r.uniform(el_lo, el_hi)),
        sun_azimuth=float(r.uniform(0.0, 360.0)),
        arc_per_tick=float(s["sun_arc_deg_per_cycle"]) / frames,
        yaw0=float(r.uniform(0.0, 360.0)), view_step=step, views=views,
        ticks_per_view=step / float(s["camera_pan_deg_per_s"]) * float(s["fps"]),
        check_offsets=(fa, fb))


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
