"""The port's sweep (`cloudscape_tpu_torch/sweep.py`) against the
repository's `bench/sweep.py` (JAX), on the CPU.

Each row's keys are held to the keys sweep.py's `emit` writes for that row
(read from its AST), plus `quality_db_vs_exact` on every row but config
1's; the row names to sweep.py's at its own sizes. The configs run at a
tiny size (`TINY`: 64×32 rays at 32 steps, an (8, 32, 32) cone cache,
config 4's pack at 16 / 32 / 64, config 5 at 16 coarse steps in 4 bands)
on tests/test_torch_bench.py's pack, and config 2's policies are held to
JAX's on the same scene.
"""

import ast
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from cloudscape_tpu.models import march_fast as jmf
from cloudscape_tpu.models.density import MarchParams as JParams
from cloudscape_tpu_torch import sweep

from test_torch_bench import jax_pack

torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONE = (8, 32, 32)
TINY = {1: dict(width=64, height=32, steps=32),
        2: dict(width=64, height=32, steps=32, cone_res=CONE),
        3: dict(width=64, height=32, steps=32, cone_res=CONE),
        4: dict(width=64, height=32, steps=32, cone_res=CONE, pack=(16, 32, 64)),
        5: dict(width=64, height=32, steps=32, cone_res=CONE, bands=4,
                coarse_steps=16)}


def sweep_rows() -> dict:
    """{config: [(metric name, keys), ...] in emission order}: the rows
    bench/sweep.py emits. Its `emit` calls with a literal name, and its
    `time_v3` calls (which emit under the name they are given)."""
    with open(os.path.join(ROOT, "bench", "sweep.py")) as f:
        tree = ast.parse(f.read())

    def lit_keys(d):
        return {k.value for k in d.keys} if isinstance(d, ast.Dict) else set()

    funcs = {n.name: n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    emit = funcs["emit"]
    base = next(lit_keys(n.value) for n in ast.walk(emit)
                if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict))
    v3_extra = next(lit_keys(c.args[5]) for c in ast.walk(funcs["time_v3"])
                    if isinstance(c, ast.Call) and getattr(c.func, "id", "") == "emit")
    calls = sorted((c for c in ast.walk(funcs["main"]) if isinstance(c, ast.Call)
                    and getattr(c.func, "id", "") in ("emit", "time_v3")
                    and isinstance(c.args[1], ast.Constant)),
                   key=lambda c: (c.lineno, c.col_offset))
    rows = {}
    for c in calls:
        extra = v3_extra if c.func.id == "time_v3" else \
            (lit_keys(c.args[5]) if len(c.args) > 5 else set())
        rows.setdefault(c.args[0].value, []).append((c.args[1].value, base | extra))
    return rows


@pytest.fixture(scope="module")
def packs():
    return jax_pack()


@pytest.fixture(scope="module")
def rows(packs):
    return sweep.run(sweep.CONFIGS, sizes=TINY, device="cpu", noise=packs[1])


@pytest.mark.parametrize("config", sweep.CONFIGS)
def test_row_keys_and_names_are_sweep_py_s(rows, config):
    theirs = sweep_rows()[config]
    ours = [r for r in rows if r["config"] == config]
    assert len(ours) == len(theirs)
    tiny, full = (f"{s['width']}x{s['height']}x{s['steps']}"
                  for s in (TINY[config], sweep.SIZES[config]))
    for row, (name, keys) in zip(ours, theirs):
        assert row["metric"].replace(tiny, full) == name
        assert set(row) == keys | ({"quality_db_vs_exact"} if config != 1 else set())
        assert row["device"] == "cpu" and row["value"] > 0.0
        if config != 1:
            assert np.isfinite(row["quality_db_vs_exact"])


def test_all_configs_make_ten_rows(rows):
    assert [r["config"] for r in rows] == [1, 2, 2, 3, 3, 4, 4, 5, 5, 5]
    assert sum(len(v) for v in sweep_rows().values()) == 10


def test_subset_and_out(packs, tmp_path, capsys):
    path = tmp_path / "rows.json"
    sweep.main(["1", "4", "--out", str(path)], sizes=TINY, device="cpu",
               noise=packs[1])
    lines = capsys.readouterr().out.splitlines()
    written = json.loads(path.read_text())
    assert [r["config"] for r in written] == [1, 4, 4]
    assert [json.loads(x) for x in lines[:-1]] == written
    assert lines[-1] == f"# wrote 3 rows -> {path}"


def test_unknown_config_is_refused():
    with pytest.raises(SystemExit, match="unknown config"):
        sweep.main(["6"], sizes=TINY, device="cpu")


def test_config2_policies_match_jax(rows, packs):
    s = TINY[2]
    bricks = jmf.BrickPack.from_noise(packs[0])
    sun = np.array([0.3, 0.4, -0.85])
    sun /= np.linalg.norm(sun)
    p = JParams.create(
        cloud_pos=np.array([1.5, -0.3]), detailed_pos=np.array([0.4, 0.2]),
        weather_pos=np.array([0.01, 0.02]), time=12.5, cloud_coverage=0.35,
        light_direction=sun, ground_color=np.array([0.27, 0.19, 0.027]))
    dirs = jnp.asarray(jbench.hemisphere_dirs(s["width"], s["height"]))
    rk, cap, _, _ = jmf.v2_auto_policy(dirs, p, bricks, steps=s["steps"])
    rk3, ck, hk, cell_frac, hot_frac = jmf.v3_auto_policy(dirs, p, bricks,
                                                          steps=s["steps"])
    v2, v3 = [r for r in rows if r["config"] == 2]
    assert (v2["ray_keep_frac"], v2["capacity_frac"]) == (rk, cap)
    assert (v3["ray_keep_frac"], v3["cell_keep_frac"], v3["hot_keep_frac"]) == (rk3, ck, hk)
    assert (v3["cell_frac"], v3["hot_frac"]) == (float(cell_frac), float(hot_frac))


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CPU host's failure cannot show")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sweep.run([1])
