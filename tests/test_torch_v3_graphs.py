"""The serving tick's v3 tile replayed as a CUDA graph (`tile_graphs.py`,
`CloudSkyEngine._march_tile_v3_graph`) against the eager arm, and the
constant tensors that make the arm capturable.

On the CPU the arm stays eager: no graph, no count, no `v3.replay` span.
The `card` case runs an engine with graphs against its eager twin (a
`copy.deepcopy` before the first tick, its graphs taken away) over three
whole cycles with their rotations, the prebake on, and checks the ring and
each displayed frame bitwise, the captures and replays counted, and the
kernel wrappers' counts on the ticks without a replay; then each bucket's
replay under the profiler against the eager call it captured, activity by
activity on the card's trace (a replay launches through no wrapper, so
the wrappers do not count its kernels). It skips without a CUDA card; on the
card, without the JAX test configuration: `python -m pytest --noconftest
tests/test_torch_v3_graphs.py -m card -q`.

The CPU engines run at PerfConfig(32, 16, march_steps=16, light_steps=2)
with an (8, 64, 64) cone cache and tile cull on a 16³ / 8³ / 64² noise
pack made by the port's own generators; the card's at a 128² map (32²
tiles, 64² at frames_to_update 4), 32 steps.
"""

import collections
import copy
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cloudscape_tpu_torch import CloudConfig, PerfConfig, SunState
from cloudscape_tpu_torch import engine as engine_mod
from cloudscape_tpu_torch import tile_graphs
from cloudscape_tpu_torch.config import GROUND_RADIUS
from cloudscape_tpu_torch.engine import V3_TILE_CELL_BUCKETS, CloudSkyEngine
from cloudscape_tpu_torch.models import march
from cloudscape_tpu_torch.models.march import RANDOM_VECTORS, device_constant
from cloudscape_tpu_torch.models.packs import make_noise_pack
from cloudscape_tpu_torch.ops import (_cuda, accum, atmosphere_kernel, brick, compact,
                                      composite_kernel, noise_kernel, segscan)
from cloudscape_tpu_torch.ops.noise import (generate_base_noise, generate_detail_noise,
                                            generate_weather)
from cloudscape_tpu_torch.ops.octmap import texel_directions
from cloudscape_tpu_torch.utils.profiling import reset_spans, span_stats

torch.set_num_threads(min(2, torch.get_num_threads()))


def _engine(device, frames=16, size=32, steps=16, light_steps=2, cone_res=(8, 64, 64)):
    noise = make_noise_pack(generate_base_noise(16, seed=1, device=device),
                            generate_detail_noise(8, seed=2, device=device),
                            generate_weather(64, seed=3, device=device))
    eng = CloudSkyEngine(perf=PerfConfig(size, frames, march_steps=steps,
                                         light_steps=light_steps),
                         config=CloudConfig(cloud_coverage=0.6),
                         sun=SunState(direction=(0.3, 0.5, -0.8)), noise=noise,
                         cone_res=cone_res, device=device, kernel="fast3",
                         tile_cull=True)
    assert eng.can_run
    return eng


# ------------------------------------------------------------- the CPU


def test_cpu_ticks_stay_eager():
    """A CPU engine has no graphs: its v3 tiles march eagerly with their
    `v3.*` stage spans, both counters stay put and no `v3.replay` opens."""
    eng = _engine("cpu")
    assert eng._v3_graphs is None
    before = (engine_mod.v3_graph_captures, engine_mod.v3_graph_replays)
    view = texel_directions(16, device="cpu")
    reset_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for i in range(eng.perf.frames_to_update + 2):
                eng.render_frame(view, now=i / 60)
        stats = span_stats()
    finally:
        reset_spans()
    assert (engine_mod.v3_graph_captures, engine_mod.v3_graph_replays) == before
    assert stats["tile.v3"]["count"] > 0
    assert stats["v3.prepass"]["count"] == stats["tile.v3"]["count"]
    assert "v3.replay" not in stats


@pytest.mark.parametrize("values", [
    (0.0, 1.0, 0.0), (0.0, GROUND_RADIUS, 0.0), RANDOM_VECTORS[:6], RANDOM_VECTORS[:2],
    (march._SQRT_HALF, march._SQRT_HALF, 0.0), (march._SQRT_HALF, -march._SQRT_HALF, 0.0)],
    ids=["up", "camera", "cone-6", "cone-2", "ambient", "ground"])
def test_device_constants_are_the_former_tensors(values):
    """Each cached constant is `torch.tensor(values, float32)` bit for bit,
    made once a device; cos 45° is the former host computation's."""
    got = device_constant(values, "cpu")
    want = torch.tensor(values, dtype=torch.float32, device="cpu")
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert device_constant(values, torch.device("cpu")) is got
    assert march._SQRT_HALF == float(torch.tensor(1.0) / torch.sqrt(torch.tensor(2.0)))


@pytest.mark.parametrize("wrap", ["clamp", "repeat"])
def test_sample2d_one_uv_is_the_former_fetch(wrap):
    """`sample2d` of one uv (the sky lookups of `ambient_colors`) fetches
    through 1-D indices: the former 0-d indexing's values, bit for bit,
    and row k of a batch's."""
    from cloudscape_tpu_torch.ops import sampling

    g = torch.Generator().manual_seed(5)
    tex = torch.rand((10, 20, 4), generator=g)
    uvs = torch.rand((7, 2), generator=g) * 1.4 - 0.2
    batch = sampling.sample2d(tex, uvs, wrap=wrap)
    h, w, _ = tex.shape
    flat = tex.reshape(-1, 4)
    for k in range(uvs.shape[0]):
        uv = uvs[k]
        got = sampling.sample2d(tex, uv, wrap=wrap)
        cx, cy = uv[0] * w - 0.5, uv[1] * h - 0.5
        x0, y0 = torch.floor(cx), torch.floor(cy)
        fx, fy = (cx - x0)[None], (cy - y0)[None]
        x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
        x1 = sampling._wrap_idx(x0 + 1, w, wrap)
        y1 = sampling._wrap_idx(y0 + 1, h, wrap)
        x0, y0 = sampling._wrap_idx(x0, w, wrap), sampling._wrap_idx(y0, h, wrap)
        c00, c10 = flat[y0 * w + x0], flat[y0 * w + x1]
        c01, c11 = flat[y1 * w + x0], flat[y1 * w + x1]
        top, bot = c00 + (c10 - c00) * fx, c01 + (c11 - c01) * fx
        want = top + (bot - top) * fy
        assert got.shape == (4,)
        assert torch.equal(got, want) and torch.equal(got, batch[k])


@pytest.mark.parametrize("module,arg", [
    (accum, 7), (compact, 7), (segscan, 7), (atmosphere_kernel, "sky"),
    (noise_kernel, "base"), (composite_kernel, "composite")],
    ids=["accum", "compact", "segscan", "atmosphere", "noise", "composite"])
def test_wrappers_count_nothing_while_capturing(monkeypatch, module, arg):
    """A wrapper's call while a graph is captured records its kernel and
    launches nothing, so its launch counter stays put; otherwise it counts
    one (the counters are set back after)."""
    def reading():
        n = module.launches[arg] if isinstance(module.launches, dict) else module.launches
        return n, dict(getattr(module, "sizes", {}))

    monkeypatch.setattr(module, "launches", copy.deepcopy(module.launches))
    if hasattr(module, "sizes"):
        monkeypatch.setattr(module, "sizes", collections.Counter(module.sizes))
    before = reading()
    monkeypatch.setattr(_cuda, "capturing", True)
    module._count_launch(arg)
    assert reading() == before
    monkeypatch.setattr(_cuda, "capturing", False)
    module._count_launch(arg)
    assert reading()[0] == before[0] + 1


def test_copied_engine_starts_without_graphs():
    """A deep copy of a graph cache is an empty cache on the same device
    with the same march (a graph cannot be copied)."""
    graphs = tile_graphs.V3TileGraphs("cpu", engine_mod._march_tile_v3)
    graphs._graphs[0.25] = object()
    twin = copy.deepcopy(graphs)
    assert twin._graphs == {} and twin._march is engine_mod._march_tile_v3
    assert twin.device == graphs.device


# ------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CASES = [pytest.param(b, 16, id=f"bucket-{b}") for b in V3_TILE_CELL_BUCKETS] \
    + [pytest.param(0.25, 4, id="f4-bucket-0.25"), pytest.param(None, 16, id="cull-buckets")]


def _counts():
    return (compact.launches, segscan.launches, dict(brick.launches),
            dict(brick.samples))


def _moved(before, after):
    return (after[0] - before[0], after[1] - before[1],
            {k: after[2][k] - before[2][k] for k in after[2]},
            {k: after[3][k] - before[3][k] for k in after[3]})


def _traced(fn):
    """fn()'s result, the number of copies and fills it ran, and its other
    activities on the card by name, from the profiler's trace (a graph
    replay's kernels are on it one by one, its copy nodes as kernels named
    memcpy*; the annotations of spans are left out). A trace can lose its
    earliest records, so idle margins and four marker kernels open it and
    one closes it; a trace that does not start and end with a marker is
    taken again (fn is called again) with margins four times as long, up
    to five times."""
    from cloudscape_tpu_torch.utils.profiling import device_activities

    margin = 0.05
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(margin)
            for _ in range(4):
                torch.cuda._sleep(1000)
            out = fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(margin)
        events = sorted(device_activities(prof.events()), key=lambda e: e.time_range.start)
        names = [e.name for e in events]
        if names and "spin_kernel" in names[0] and "spin_kernel" in names[-1]:
            names = [n for n in names if "spin_kernel" not in n]
            copies = [n for n in names if n.lower().startswith(("memcpy", "memset"))]
            return out, len(copies), collections.Counter(n for n in names if n not in copies)
        margin = min(4 * margin, 0.8)
    raise AssertionError("every trace lost its opening markers")


@pytest.mark.card
@pytest.mark.parametrize("bucket,frames", CASES)
def test_replayed_tiles_are_the_eager_tiles(card, monkeypatch, bucket, frames):
    """Three whole cycles of fused ticks with their rotations and the
    prebake swapping its snapshots in: the ring and every displayed frame
    of the engine with graphs are its eager twin's, bitwise; every v3 tick
    is one replay, and the first captured every bucket. The kernel
    wrappers count the launches they make: on a tick without a replay
    their counts move as the twin's. Then each bucket's replay is traced
    against the eager call it captured: the same tile and the same
    activities on the card, K2 and K3 among them. `bucket` forces every
    tile's cell bucket (every tick v3), None keeps the cull map's."""
    if bucket is not None:
        monkeypatch.setattr(CloudSkyEngine, "_buckets_from_keep",
                            lambda self, keep, cell=None: [bucket] * len(keep))
    eng = _engine(card, frames=frames, size=128, steps=32, light_steps=6,
                  cone_res=(16, 128, 128))
    twin = copy.deepcopy(eng)
    assert eng._v3_graphs is not None
    twin._v3_graphs = None
    view = texel_directions(48, device=card)
    captures0 = engine_mod.v3_graph_captures
    replays0 = engine_mod.v3_graph_replays
    v3_ticks = 0
    for i in range(3 * frames + 1):
        now = 0.5 + i / 60
        c0, r0 = _counts(), engine_mod.v3_graph_replays
        got = eng.render_frame(view, now=now)
        c1, replayed = _counts(), engine_mod.v3_graph_replays - r0
        want = twin.render_frame(view, now=now)
        c2 = _counts()
        torch.cuda.synchronize()
        assert torch.equal(got, want), (i, float((got - want).abs().max()))
        assert torch.equal(eng.cloud_ring, twin.cloud_ring), i
        if not replayed:
            assert _moved(c0, c1) == _moved(c1, c2), i
        # The tile this tick wrote (tick 0's after the warm start).
        tile = eng._tile_buckets[eng.ring.frame - 1] if eng._tile_buckets else None
        if tile is not None and 0.0 < tile < 1.0:
            v3_ticks += 1
    assert v3_ticks > 0
    if bucket is not None:
        assert v3_ticks == 3 * frames + 1
    assert engine_mod.v3_graph_replays - replays0 == v3_ticks
    assert engine_mod.v3_graph_captures - captures0 == len(V3_TILE_CELL_BUCKETS)
    assert float(eng.cloud_ring[..., 3].max()) > 0.0

    # Each bucket's graph replayed once more under the profiler, against
    # the eager call it captured on the same inputs: the same tile, and the
    # same activities on the card, K2 and K3 among them.
    graphs = eng._v3_graphs
    for b in V3_TILE_CELL_BUCKETS:
        replayed, replay_copies, replay_ran = _traced(lambda b=b: graphs.replay(b))
        eager, eager_copies, eager_ran = _traced(lambda b=b: graphs.eager(b))
        assert torch.equal(replayed, eager), b
        assert replay_ran == eager_ran, (b, replay_ran - eager_ran, eager_ran - replay_ran)
        assert replay_copies == eager_copies, b
        for name in ("compact_kernel", "segscan_kernel"):
            assert sum(n for k, n in replay_ran.items() if name in k) > 0, (b, name)
