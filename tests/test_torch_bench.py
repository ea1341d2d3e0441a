"""The port's bench (`cloudscape_tpu_torch/bench.py`) against the
repository's `bench.py` (JAX), on the CPU.

`bench.py` imports only numpy at module level, so its direction grids are
imported as they are; its measurements (bench.py:99-126, :196-213) are
copied below onto the JAX package, since bench.py runs them inside `main`.
The scene is bench.py's at a tiny size: tests/test_torch_integration.py's
pack (the JAX generators at base 16 seed 5, detail 32 seed 2, weather 64
seed 3; the port takes their float32 arrays unchanged), 64×32 rays at 32
steps (bench.py's `v3_auto_policy` call prepasses 32 steps, so no fewer),
an (8, 32, 32) cone cache, and a serving engine of `PerfConfig(128, 16,
32)` with a 64×36 view and 20 timed ticks.

Measured on the CPU: both packages measure the same fractions and pick
the same buckets (ray, cell, hot: 0.3, 0.9, 0.1); the headline image is
154.21 dB from JAX's (gate 60; this sparse scene has alpha > 0.1 on 0.15%
of its rays); `quality_db_vs_exact` reads 53.720 dB against JAX's 53.718
(gate: within 0.5 dB).
"""

import ast
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from cloudscape_tpu.models import atmosphere as jatmo
from cloudscape_tpu.models import march_fast as jmf
from cloudscape_tpu.models.density import MarchParams as JParams
from cloudscape_tpu.models.packs import make_noise_pack
from cloudscape_tpu.ops.noise import (generate_base_noise, generate_detail_noise,
                                      generate_weather)
from cloudscape_tpu.utils.image import psnr
from cloudscape_tpu_torch import bench
from cloudscape_tpu_torch.models import march_fast as tmf
from cloudscape_tpu_torch.models.packs import noise_pack_from_numpy

# Several test workers share the host's cores: keep torch's intra-op
# thread pool small so they do not oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH, HEIGHT, STEPS = 64, 32, 32
CONE_RES = (8, 32, 32)
TINY = dict(width=WIDTH, height=HEIGHT, steps=STEPS, cone_res=CONE_RES,
            texture_size=128, frames=16, tile_steps=32, timed_ticks=20,
            view=(64, 36))


def jax_pack():
    """tests/test_torch_integration.py's pack: (JAX's, the port's)."""
    jn = make_noise_pack(generate_base_noise(16, seed=5),
                         generate_detail_noise(32, seed=2),
                         generate_weather(64, seed=3))
    tn = noise_pack_from_numpy([np.asarray(a) for a in jn.large],
                               [np.asarray(a) for a in jn.small],
                               np.asarray(jn.weather), device="cpu")
    return jn, tn


def bench_keys() -> set:
    """Every key bench.py writes: its `rec = {...}` literal, each
    `rec[...] = ...` and the keys its failure path `setdefault`s."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "rec" \
                        and isinstance(node.value, ast.Dict):
                    keys |= {k.value for k in node.value.keys}
                if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name) \
                        and t.value.id == "rec":
                    keys.add(t.slice.value)
        if isinstance(node, ast.For) and any(
                isinstance(c, ast.Attribute) and c.attr == "setdefault"
                for c in ast.walk(node)):
            keys |= {e.value for e in node.iter.elts}
    return keys


@pytest.fixture(scope="module")
def runs():
    """The port's record at the tiny scene (its march_bricks_v3 outputs
    captured: the headline first) and JAX's values by bench.py's lines."""
    jn, tn = jax_pack()
    outs = []
    real_v3 = tmf.march_bricks_v3

    def spy(*args, **kwargs):
        out = real_v3(*args, **kwargs)
        outs.append(out.clone())
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmf, "march_bricks_v3", spy)
        rec = bench.run("cpu", noise=tn, **TINY)

    # bench.py:99-126 and :196-213, on the JAX package.
    bricks = jmf.BrickPack.from_noise(jn)
    tlut = jatmo.transmittance_lut()
    sun = np.array([0.3, 0.4, -0.85])
    sun /= np.linalg.norm(sun)
    sky = jatmo.sky_lut(tlut, jnp.asarray(sun, jnp.float32))
    params = JParams.create(
        cloud_pos=np.array([1.5, -0.3]),
        detailed_pos=np.array([0.4, 0.2]),
        weather_pos=np.array([0.01, 0.02]),
        time=12.5,
        cloud_coverage=0.35,
        light_direction=sun,
        ground_color=np.array([0.27, 0.19, 0.027]),
    )
    dirs = jnp.asarray(jbench.hemisphere_dirs(WIDTH, HEIGHT))
    keep = float(jmf.ray_keep_fraction(dirs, params, bricks, steps=STEPS,
                                       ray_stride=2))
    ray_keep, cell_keep, hot_keep, cell_frac, hot_frac = jmf.v3_auto_policy(
        dirs, params, bricks, steps=STEPS)
    cone = jmf.build_cone_cache(params, bricks, 6, res=CONE_RES, chunk=65536)
    out = np.asarray(jmf.march_bricks_v3(
        dirs, params, bricks, sky, steps=STEPS, chunk=32768, cell_keep_frac=cell_keep,
        hot_keep_frac=hot_keep, cone_cache=cone, ray_keep_frac=ray_keep, ray_stride=2))
    exact = np.asarray(jmf.march_bricks(dirs, params, bricks, sky, steps=STEPS,
                                        chunk=32768, capacity_frac=0.2))
    peak = max(float(np.abs(exact).max()), 1e-9)
    mse = float(((out - exact) ** 2).mean())
    jax_rec = dict(ray_keep_measured=keep, ray_keep_frac=ray_keep,
                   cell_keep_frac=cell_keep, hot_keep_frac=hot_keep,
                   cell_frac_measured=float(cell_frac), hot_frac_measured=float(hot_frac),
                   quality_db_vs_exact=10.0 * math.log10(peak * peak / max(mse, 1e-20)))
    return rec, outs[0].numpy(), jax_rec, out


@pytest.mark.parametrize("name,args", [("hemisphere_dirs", (64, 32)),
                                       ("hemisphere_dirs", (1024, 512)),
                                       ("view_dirs", (1280, 720))])
def test_direction_grids_are_bench_py_s(name, args):
    ours, theirs = getattr(bench, name)(*args), getattr(jbench, name)(*args)
    assert ours.dtype == theirs.dtype == np.float32
    assert np.array_equal(ours, theirs)


def test_record_keys_are_bench_py_s_plus_the_arm_medians(runs):
    rec = runs[0]
    expected = bench_keys() | {"per_tile_arm_ms"}
    assert "per_tile_hitch_p95" in expected and "quality_db_vs_exact" in expected
    assert set(rec) == expected


def test_policy_matches_jax(runs):
    rec, _, jax_rec, _ = runs
    for key in ("ray_keep_measured", "ray_keep_frac", "cell_keep_frac",
                "hot_keep_frac", "cell_frac_measured", "hot_frac_measured"):
        assert rec[key] == jax_rec[key], key


def test_headline_image_matches_jax(runs):
    rec, out, _, jax_out = runs
    assert out.shape == jax_out.shape == (HEIGHT, WIDTH, 4)
    assert rec["clouds_frac"] > 0.0
    assert psnr(out, jax_out) >= 60.0


def test_quality_vs_exact_matches_jax(runs):
    rec, _, jax_rec, _ = runs
    assert abs(rec["quality_db_vs_exact"] - jax_rec["quality_db_vs_exact"]) <= 0.5


def test_record_fields_finite(runs):
    rec = runs[0]
    assert rec["vs_baseline"] is None and rec["vs_baseline_with_bake"] is None
    # A CPU run has no device time.
    assert rec["per_tile_device_ms"] is None and rec["fps_equivalent_device"] is None
    assert rec["device"] == "cpu" and rec["finite"] and rec["per_tile_finite"]
    assert rec["metric"] == f"hemisphere_{WIDTH}x{HEIGHT}_rerender"
    assert len(rec["all_ms"]) == 5 and len(rec["tile_all_ms"]) == TINY["timed_ticks"]
    assert sum(rec["tile_bucket_hist"].values()) == TINY["frames"]
    assert set(rec["per_tile_arm_ms"]) <= {"skip", "v3", "dense"}
    nums = []
    for k, v in rec.items():
        if k in ("vs_baseline", "vs_baseline_with_bake", "per_tile_device_ms",
                 "fps_equivalent_device"):
            continue
        assert v is not None, k
        if isinstance(v, dict):
            nums += list(v.values())
        elif isinstance(v, list):
            nums += v
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            nums.append(v)
    assert nums and all(math.isfinite(x) for x in nums)


def test_failed_captures_are_null(monkeypatch):
    """A referee or the serving engine that raises nulls its fields; the
    headline and the key set stay."""
    _, tn = jax_pack()

    def broken(*args, **kwargs):
        raise RuntimeError("broken on purpose")

    monkeypatch.setattr(tmf, "march_bricks", broken)
    monkeypatch.setattr("cloudscape_tpu_torch.engine.CloudSkyEngine", broken)
    rec = bench.run("cpu", noise=tn, **TINY)
    assert set(rec) == bench_keys() | {"per_tile_arm_ms"}
    assert rec["value"] > 0.0 and rec["finite"]
    nulls = {k for k, v in rec.items() if v is None}
    assert nulls == {"vs_baseline", "vs_baseline_with_bake", "quality_db_vs_exact",
                     "quality_db_vs_exact_high_coverage", "high_coverage_policy"} \
        | set(bench.PER_TILE_KEYS)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CPU host's failure cannot show")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run("cuda")


class _Event:
    def __init__(self, name, start, end):
        self.name = name
        self.time_range = type("R", (), {"start": start, "end": end})()


def test_busy_us_unions_the_activities_between_markers():
    m = bench.MARKER
    opening, closing = _Event(f"void at::{m}(long)", 0, 1), _Event(m, 50, 51)
    inner = [_Event("k2", 20, 30), _Event("k1", 10, 25), _Event("copy", 40, 45),
             _Event("k3", 41, 42)]
    # [10, 30] and [40, 45]: 25 µs busy in 4 activities, in any order.
    assert bench.busy_us(inner[:2] + [closing, opening] + inner[2:]) == (25.0, 4)
    for lost in (inner + [closing], [opening] + inner, [opening, closing],
                 [opening, inner[0], closing, _Event("late", 60, 61)]):
        with pytest.raises(ValueError):
            bench.busy_us(lost)
