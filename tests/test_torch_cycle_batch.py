"""`update_cycle`'s batched dense march (`CloudSkyEngine._march_tiles_dense`)
against the per-tile loop it replaces, and where the batch engages.

Where every tile of the batch would take fast3's dense arm (region² below
`V3_TILE_MIN_RAYS`), `_update_tiles_batch` marches the cycle's remaining
tiles in one `march_tile_dense` call; the ring must be the same bits as one
`_update_tile` a tile. Every other kernel keeps the loop.

The engines run at PerfConfig(32, 16, march_steps=16, light_steps=2) (8²
tiles) with an (8, 64, 64) cone cache and tile cull on a 16³ / 8³ / 64²
noise pack made by the port's generators. The `card` cases run the same
check on a CUDA card and skip without one; on the card, without the JAX
test configuration: `python -m pytest --noconftest
tests/test_torch_cycle_batch.py -m card -q`.
"""

import copy

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cloudscape_tpu_torch import CloudConfig, PerfConfig, SunState
from cloudscape_tpu_torch import engine as engine_mod
from cloudscape_tpu_torch.engine import CloudSkyEngine
from cloudscape_tpu_torch.models.packs import make_noise_pack
from cloudscape_tpu_torch.ops.noise import (generate_base_noise, generate_detail_noise,
                                            generate_weather)
from cloudscape_tpu_torch.utils.profiling import reset_spans, span_stats

torch.set_num_threads(min(2, torch.get_num_threads()))
FRAMES = 16
REGION = 8


def _engine(device, kernel="fast3"):
    """A tile-cull engine after its warm start and one more batched cycle,
    so the next `update_cycle` starts at a cycle boundary."""
    noise = make_noise_pack(generate_base_noise(16, seed=1, device=device),
                            generate_detail_noise(8, seed=2, device=device),
                            generate_weather(64, seed=3, device=device))
    eng = CloudSkyEngine(perf=PerfConfig(32, FRAMES, march_steps=16, light_steps=2),
                         config=CloudConfig(cloud_coverage=0.6),
                         sun=SunState(direction=(0.3, 0.5, -0.8)), noise=noise,
                         cone_res=(8, 64, 64), device=device, kernel=kernel,
                         tile_cull=True)
    assert eng.can_run
    eng.update_cycle(now=0.0)
    return eng


def _tile_loop(eng):
    """Make eng's batch the per-tile loop: one `_update_tile` a tile."""
    cols = eng.perf.texture_size // REGION

    def per_tile(tex_idx, start_tile, count):
        for k in range(count):
            row, col = divmod(start_tile + k, cols)
            eng._update_tile(tex_idx, col * REGION, row * REGION)

    eng._march_tiles_dense = per_tile


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def cpu_engine():
    return _engine("cpu")


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.card)])
@pytest.mark.parametrize("ticks", [0, 5], ids=["boundary", "after-5-ticks"])
@pytest.mark.parametrize("chunk", [None, 48], ids=["one-chunk", "ragged-chunks"])
def test_batched_cycle_is_the_tile_loop_bitwise(request, monkeypatch, device, ticks,
                                                chunk):
    """`update_cycle` from a cycle boundary (a rotation, then all 16 tiles)
    and after 5 ticks (the 11 remaining tiles): the batched ring, cursor and
    frame are the per-tile loop's, bitwise, with the batch in one pass chunk
    and in chunks of 48 rays (no multiple of a tile's 64)."""
    if chunk is not None:
        monkeypatch.setattr(engine_mod, "BATCH_DENSE_CHUNK", chunk)
    if device == "cuda":
        request.getfixturevalue("card")
        base = _engine(device)
    else:
        base = copy.deepcopy(request.getfixturevalue("cpu_engine"))
    for i in range(ticks):
        base.update_sky(now=1.0 + i / 60)
    assert base.ring.frame == (ticks if ticks else FRAMES)
    batched, looped = copy.deepcopy(base), copy.deepcopy(base)
    _tile_loop(looped)
    before = engine_mod.batched_tiles
    batched.update_cycle(now=2.0)
    assert engine_mod.batched_tiles - before == FRAMES - ticks
    looped.update_cycle(now=2.0)
    assert engine_mod.batched_tiles - before == FRAMES - ticks
    slot = batched.ring.texture_to_update
    assert looped.ring.texture_to_update == slot
    assert batched.ring.frame == looped.ring.frame == FRAMES
    assert batched.ring.update_position == looped.ring.update_position == (0, 0)
    got, want = batched.cloud_ring[slot], looped.cloud_ring[slot]
    assert float(want[..., 3].max()) > 0.0  # clouds in the tiles compared
    assert torch.equal(got, want), float((got - want).abs().max())
    assert torch.equal(batched.cloud_ring, looped.cloud_ring)


def _cycle_spans(eng):
    reset_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            eng.update_cycle(now=2.0)
        return span_stats()
    finally:
        reset_spans()


def test_batched_tiles_counts_the_batch(cpu_engine):
    """The warm start's two cycles and a boundary call's cycle each add
    FRAMES to `batched_tiles`; the batch records no `tile.*` span."""
    before = engine_mod.batched_tiles
    eng = _engine("cpu")
    assert engine_mod.batched_tiles - before == 3 * FRAMES
    stats = _cycle_spans(copy.deepcopy(cpu_engine))
    assert engine_mod.batched_tiles - before == 4 * FRAMES
    assert stats["cycle.dense"]["count"] == 1
    assert not [k for k in stats if k.startswith("tile.")]
    assert eng.ring.frame == FRAMES


@pytest.mark.parametrize("kernel,min_rays", [("fast2", None), ("fast3", REGION * REGION)],
                         ids=["fast2", "fast3-large-tiles"])
def test_other_arms_keep_the_tile_loop(monkeypatch, kernel, min_rays):
    """fast2, and fast3 once region² reaches V3_TILE_MIN_RAYS, take the v2
    arm a tile: `batched_tiles` stays put and each tile records its own
    `tile.v2` span under `cycle.tiles`."""
    if min_rays is not None:
        monkeypatch.setattr(engine_mod, "V3_TILE_MIN_RAYS", min_rays)
    before = engine_mod.batched_tiles
    eng = _engine("cpu", kernel=kernel)
    stats = _cycle_spans(eng)
    assert engine_mod.batched_tiles == before
    assert "cycle.dense" not in stats
    assert stats["tile.v2"]["count"] == FRAMES
    assert stats["tile.v2"]["parent"] == "cycle.tiles"
