"""The port's span recorder (`utils/profiling.py` `span`) on the CPU: off
unless a `torch.profiler` records, the aggregates it keeps when on, the
spans the engine opens in its tick and cycle, and the per-layer metrics
of the benchmark that read them.

The engines run at PerfConfig(32, 16, march_steps=16, light_steps=2) with
an (8, 64, 64) cone cache and tile cull on a 16³ / 8³ / 64² noise pack
made by the port's own generators (plain versions on the CPU).
"""

import copy
import os
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cloudscape_tpu_torch import CloudConfig, PerfConfig, SunState
from cloudscape_tpu_torch.engine import CloudSkyEngine
from cloudscape_tpu_torch.models.packs import make_noise_pack
from cloudscape_tpu_torch.ops.noise import (generate_base_noise, generate_detail_noise,
                                            generate_weather)
from cloudscape_tpu_torch.ops.octmap import texel_directions
from cloudscape_tpu_torch.parallel.sharding import make_mesh
from cloudscape_tpu_torch.utils import profiling
from cloudscape_tpu_torch.utils.profiling import reset_spans, span, span_stats

torch.set_num_threads(min(2, torch.get_num_threads()))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 16


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def fresh_spans():
    reset_spans()
    yield
    reset_spans()


# ---------------------------------------------------------- the recorder


def test_span_without_profiler_records_nothing(monkeypatch):
    """No profiler: no `record_function` is entered and nothing is kept."""
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    with span("outer"):
        with span("inner"):
            pass
    assert entered == []
    assert span_stats() == {}


def test_nested_spans_under_profiler():
    """count, total_s, self_s and parent of nested spans, and each span a
    `sky:<name>` CPU event of the profiler."""
    with _cpu_profile() as prof:
        with span("outer"):
            time.sleep(0.02)
            for _ in range(2):
                with span("inner"):
                    time.sleep(0.01)
    stats = span_stats()
    assert set(stats) == {"outer", "inner"}
    outer, inner = stats["outer"], stats["inner"]
    assert (outer["count"], inner["count"]) == (1, 2)
    assert (outer["parent"], inner["parent"]) == (None, "outer")
    assert inner["total_s"] >= 0.02 and outer["total_s"] >= 0.04
    assert inner["self_s"] == pytest.approx(inner["total_s"])
    assert outer["self_s"] == pytest.approx(outer["total_s"] - inner["total_s"], abs=1e-9)
    assert 0.02 <= outer["self_s"] < outer["total_s"]
    names = [e.name for e in prof.events()]
    assert names.count("sky:outer") == 1 and names.count("sky:inner") == 2


def test_span_stacks_are_per_thread():
    """A span opened in another thread while the main thread holds one is
    a top-level span of its thread, and counts are summed across threads."""
    def work():
        with span("shard"):
            pass

    with _cpu_profile():
        with span("main"):
            ts = [threading.Thread(target=work) for _ in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=30.0)
    assert not any(t.is_alive() for t in ts)
    stats = span_stats()
    assert stats["shard"]["count"] == 4 and stats["shard"]["parent"] is None
    assert stats["main"]["self_s"] == pytest.approx(stats["main"]["total_s"])


def test_device_activities_leave_span_annotations_out():
    """The card's activities of a trace: CUDA events, less the `sky:*`
    annotations spans leave on the card's timeline."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    evs = [SimpleNamespace(name=n, device_type=d) for n, d in (
        ("kernel_a", DeviceType.CUDA), ("sky:tile.v3", DeviceType.CUDA),
        ("Memcpy HtoD", DeviceType.CUDA), ("sky:tile.v3", DeviceType.CPU),
        ("aten::add", DeviceType.CPU))]
    assert [e.name for e in profiling.device_activities(evs)] == ["kernel_a", "Memcpy HtoD"]


def test_reset_spans_forgets():
    with _cpu_profile():
        with span("x"):
            pass
    assert span_stats()["x"]["count"] == 1
    reset_spans()
    assert span_stats() == {}


# ------------------------------------------------------ the engine's spans


@pytest.fixture(scope="module")
def warm():
    """A fast3 tile-cull engine after its warm start and tick 0, and the
    view it renders."""
    noise = make_noise_pack(generate_base_noise(16, seed=1, device="cpu"),
                            generate_detail_noise(8, seed=2, device="cpu"),
                            generate_weather(64, seed=3, device="cpu"))
    eng = CloudSkyEngine(perf=PerfConfig(32, FRAMES, march_steps=16, light_steps=2),
                         config=CloudConfig(cloud_coverage=0.6),
                         sun=SunState(direction=(0.3, 0.5, -0.8)), noise=noise,
                         cone_res=(8, 64, 64), device="cpu", kernel="fast3",
                         tile_cull=True)
    view = texel_directions(24, device="cpu")
    eng.render_frame(view, now=0.0)
    return eng, view


def _arm(bucket) -> str:
    """The fast3 arm of a tile-cull bucket."""
    if bucket is None or bucket >= 1.0:
        return "dense"
    return "skip" if bucket == 0.0 else "v3"


def test_ticks_record_tile_composite_and_prebake_spans(warm):
    """A whole cycle of fused ticks: one `tile.<arm>` and one
    `composite_display` a tick, and one `prebake.<stage>` for each step
    `_prebake_stage()` names (a rotation tick's pending bake is "fresh")."""
    eng, view = copy.deepcopy(warm[0]), warm[1]
    arms, stages = {}, {}
    with _cpu_profile():
        for i in range(1, FRAMES + 1):
            stage = "fresh" if eng.ring.frame >= FRAMES else eng._prebake_stage()
            eng.render_frame(view, now=i / 60)
            arm = _arm(eng._tile_buckets[eng.ring.frame - 1])
            arms[arm] = arms.get(arm, 0) + 1
            if stage not in (None, "fresh"):
                stages[stage] = stages.get(stage, 0) + 1
    stats = span_stats()
    got_arms = {k[5:]: v["count"] for k, v in stats.items() if k.startswith("tile.")}
    got_stages = {k[8:]: v["count"] for k, v in stats.items() if k.startswith("prebake.")}
    assert got_arms == arms and sum(arms.values()) == FRAMES
    assert "v3" in arms and "skip" in arms
    assert got_stages == stages and {"occupancy", "cone", "sky_band", "cull_read"} <= set(stages)
    assert stats["bake.tick"]["count"] == sum(stages.values())  # one step a tick here
    assert stats["prebake.cone"]["parent"] == "bake.tick"
    assert stats["composite_display"]["count"] == FRAMES
    assert "composite.kernel" not in stats  # the CPU takes K12's plain version
    assert stats["tick.begin"]["count"] == FRAMES
    assert stats["engine.rotate"]["count"] == 1
    assert stats["display_pair.build"]["count"] == 1
    assert stats["tile.v3"]["parent"] is None and stats["v3.prepass"]["parent"] == "tile.v3"
    for name in ("v3.live_compact", "v3.pre", "v3.hot_compact", "v3.erosion_cone",
                 "v3.accumulate"):
        assert stats[name]["count"] == arms["v3"], name
    assert "v3.select" not in stats  # the v3 tile arm culls cells, not rays


def test_update_cycle_records_cone_cull_and_dense_tiles(warm):
    """`update_cycle` at a boundary: the synchronous cone and cull builds
    inside the snapshot's `engine.sync_bake` (no ticks baked its pending
    cycle), then the remaining tiles' one batched dense march,
    `cycle.dense`, with its setup, passes and accumulation once each (one
    pass chunk at this size)."""
    eng = copy.deepcopy(warm[0])
    eng.update_cycle(now=1.0)  # the rest of the cycle: no boundary yet
    with _cpu_profile():
        eng.update_cycle(now=2.0)
    stats = span_stats()
    assert stats["cone.build"]["count"] == 1 and stats["cone.build"]["parent"] == "engine.sync_bake"
    assert stats["cull.build"]["count"] == 1 and stats["cull.build"]["parent"] == "engine.sync_bake"
    assert stats["engine.sync_bake"]["count"] == 1
    assert stats["engine.sync_bake"]["parent"] == "engine.snapshot"
    assert stats["engine.snapshot"]["parent"] == "engine.rotate"
    assert stats["cycle.tiles"]["count"] == 1
    assert stats["cycle.dense"]["count"] == 1
    assert stats["cycle.dense"]["parent"] == "cycle.tiles"
    assert "tile.dense" not in stats
    for name in ("dense.setup", "dense.passes", "dense.accumulate"):
        assert stats[name]["count"] == 1 and stats[name]["parent"] == "cycle.dense"
    assert not [k for k in stats if k.startswith(("prebake.", "bake.", "v3."))]


def test_mesh_shards_open_their_own_tile_spans(warm):
    """Under a mesh each shard's thread marches its rows inside its own
    `tile.<arm>` span, at the top of that thread's stack."""
    noise = warm[0].noise
    eng = CloudSkyEngine(perf=PerfConfig(32, FRAMES, march_steps=16, light_steps=2),
                         config=CloudConfig(cloud_coverage=0.6),
                         sun=SunState(direction=(0.3, 0.5, -0.8)), noise=noise,
                         cone_res=(8, 64, 64), device="cpu", kernel="fast3",
                         mesh=make_mesh(["cpu"] * 2))
    eng.render_frame(warm[1], now=0.0)
    with _cpu_profile():
        eng.render_frame(warm[1], now=1 / 60)
    stats = span_stats()
    assert stats["tile.dense"]["count"] == 2 and stats["tile.dense"]["parent"] is None
    assert stats["composite"]["count"] == 1


def test_outputs_bitwise_with_profiler_on_and_off(warm):
    """render_frame's frames and the cloud rings are the same bits with the
    span recorder live and off, across a cycle boundary."""
    on, off = copy.deepcopy(warm[0]), copy.deepcopy(warm[0])
    view = warm[1]
    with _cpu_profile():
        frames_on = [on.render_frame(view, now=i / 60) for i in range(1, FRAMES + 3)]
    frames_off = [off.render_frame(view, now=i / 60) for i in range(1, FRAMES + 3)]
    assert span_stats()["engine.rotate"]["count"] == 1
    for a, b in zip(frames_on, frames_off):
        assert torch.equal(a, b)
    assert torch.equal(on.cloud_ring, off.cloud_ring)
    assert torch.equal(on.sky_ring, off.sky_ring)


# ------------------------------------------------ the benchmark's readers


READERS = {
    "tile_v3_ms.serve": ("tile.v3",),
    "composite_ms.serve": ("composite_display",),
    "prebake_ms.serve": ("prebake.cone", "prebake.sky_band"),
    "cone_build_ms.cycle": ("cone.build",),
    "tile_dense_ms.cycle": ("tile.dense",),
    "cycle_dense_ms.cycle": ("cycle.dense",),
    "prebake_tick_ms.serve": ("bake.tick",),
    "v3_graph_share.serve": ("tile.v3", "v3.replay"),
    "composite_kernel_share.serve": ("composite_display", "composite.kernel"),
}
# Readers of a share of spans rather than a mean (tested on their own below).
SHARES = {"v3_graph_share.serve", "composite_kernel_share.serve"}


@pytest.mark.parametrize("metric", sorted(set(READERS) - SHARES))
def test_span_readers(metric):
    """Each new per-layer metric: None for a layer without a trace, else the
    mean ms of its spans (pooled over its names), other spans ignored."""
    from skybench import run

    read = run.reader(metric, ROOT)
    assert read({}) is None
    layer = {"trace": object()}
    assert read(layer) is None  # no span recorded
    with _cpu_profile():
        with span("tile.other"):
            time.sleep(0.002)
        for k, name in enumerate(READERS[metric]):
            for _ in range(k + 1):
                with span(name):
                    time.sleep(0.001 * (k + 1))
    stats = span_stats()
    hit = [stats[n] for n in READERS[metric]]
    want = sum(s["total_s"] for s in hit) * 1e3 / sum(s["count"] for s in hit)
    assert read(layer) == pytest.approx(want)
    assert read({}) is None


def test_readers_return_none_without_the_recorder(monkeypatch):
    """A program without `span_stats` (before the recorder) reads None."""
    from skybench import run

    monkeypatch.delattr(profiling, "span_stats")
    for metric in READERS:
        assert run.reader(metric, ROOT)({"trace": object()}) is None


def test_sync_bake_share_reader(monkeypatch):
    """`sync_bake_share.serve`: `engine.sync_bake` spans over `engine.rotate`
    spans; 0.0 where rotations were traced and none built synchronously;
    None without a trace, without a traced rotation, or for a program
    without the span (no `engine.sync_bakes` counter)."""
    from cloudscape_tpu_torch import engine
    from skybench import run

    read = run.reader("sync_bake_share.serve", ROOT)
    layer = {"trace": object()}
    assert read({}) is None and read(layer) is None
    with _cpu_profile():
        for _ in range(4):
            with span("engine.rotate"):
                pass
    assert read(layer) == 0.0 and read({}) is None
    with _cpu_profile():
        with span("engine.rotate"):
            with span("engine.sync_bake"):
                pass
    assert read(layer) == pytest.approx(1 / 5)
    monkeypatch.delattr(engine, "sync_bakes")
    assert read(layer) is None
    monkeypatch.undo()
    monkeypatch.delattr(profiling, "span_stats")
    assert read(layer) is None


def test_v3_graph_share_reader(monkeypatch):
    """`v3_graph_share.serve`: `v3.replay` spans over `tile.v3` spans; 1.0
    where every traced v3 tile replayed a graph, 0.0 where none did; None
    without a trace, without a traced v3 tile, or for a program without the
    span (no `engine.v3_graph_replays` counter)."""
    from cloudscape_tpu_torch import engine
    from skybench import run

    read = run.reader("v3_graph_share.serve", ROOT)
    layer = {"trace": object()}
    assert read({}) is None and read(layer) is None
    with _cpu_profile():
        for _ in range(3):
            with span("tile.v3"):
                with span("v3.replay"):
                    pass
    assert read(layer) == 1.0 and read({}) is None
    with _cpu_profile():
        with span("tile.v3"):
            with span("v3.prepass"):
                pass
    assert read(layer) == pytest.approx(3 / 4)
    reset_spans()
    with _cpu_profile():
        with span("tile.v3"):
            pass
    assert read(layer) == 0.0
    monkeypatch.delattr(engine, "v3_graph_replays")
    assert read(layer) is None
    monkeypatch.undo()
    monkeypatch.delattr(profiling, "span_stats")
    assert read(layer) is None


def test_composite_kernel_share_reader(monkeypatch):
    """`composite_kernel_share.serve`: `composite.kernel` spans over
    `composite_display` spans; 1.0 where every traced composite was one K12
    launch, 0.0 where none was; None without a trace, without a traced
    composite, or for a program without K12 (no `ops.composite_kernel`)."""
    from skybench import run

    read = run.reader("composite_kernel_share.serve", ROOT)
    layer = {"trace": object()}
    assert read({}) is None and read(layer) is None
    with _cpu_profile():
        for _ in range(3):
            with span("composite_display"):
                with span("composite.kernel"):
                    pass
    assert read(layer) == 1.0 and read({}) is None
    with _cpu_profile():
        with span("composite_display"):
            pass
    assert read(layer) == pytest.approx(3 / 4)
    reset_spans()
    with _cpu_profile():
        with span("composite_display"):
            pass
    assert read(layer) == 0.0
    monkeypatch.setitem(sys.modules, "cloudscape_tpu_torch.ops.composite_kernel", None)
    assert read(layer) is None
    monkeypatch.undo()
    monkeypatch.delattr(profiling, "span_stats")
    assert read(layer) is None


@pytest.mark.card
def test_fused_ticks_open_one_kernel_span_on_the_card():
    """On the card each fused tick's composite is one K12 launch inside
    one `composite.kernel` span, under its `composite_display`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = torch.device("cuda")
    noise = make_noise_pack(generate_base_noise(16, seed=1, device=card),
                            generate_detail_noise(8, seed=2, device=card),
                            generate_weather(64, seed=3, device=card))
    eng = CloudSkyEngine(perf=PerfConfig(32, FRAMES, march_steps=16, light_steps=2),
                         config=CloudConfig(cloud_coverage=0.6),
                         sun=SunState(direction=(0.3, 0.5, -0.8)), noise=noise,
                         cone_res=(8, 64, 64), device=card, kernel="fast3",
                         tile_cull=True)
    assert eng.can_run
    view = texel_directions(24, device=card)
    eng.render_frame(view, now=0.0)
    with _cpu_profile():
        for i in range(1, FRAMES + 1):
            eng.render_frame(view, now=i / 60)
    torch.cuda.synchronize()
    stats = span_stats()
    assert stats["composite_display"]["count"] == FRAMES
    assert stats["composite.kernel"]["count"] == FRAMES
    assert stats["composite.kernel"]["parent"] == "composite_display"
