"""Shared fixtures of the benchmark's own tests.

Run them from the repository's root: `python -m pytest skybench/tests -q`.
Tests that need a CUDA card carry the `card` marker and skip without one
(decided inside the `card` fixture, never at import); run them on the
card with `python -m pytest skybench/tests -q -m card`.
"""

import json
import os
import shutil

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Several test workers may share the host's cores.
torch.set_num_threads(min(4, torch.get_num_threads()))

# The tiny sizes of the CPU runs: every kind's path at a size the CPU's
# plain versions run in seconds, with limits of their own, since the tiny
# march is coarser and lies farther from the reference (readings in
# test_skybench_tiny.py).
TINY = {
    "serve-768-f64": dict(texture_size=64, frames_to_update=16, march_steps=16,
                          cone_res=[4, 32, 32], view=[32, 18],
                          noise={"seed": 0, "base": 16, "detail": 8, "weather": 64}),
}
TINY_LIMITS = {
    "serve-768-f64.broken-0.35": {"map_snr_db": 8.0, "frame_snr_db": 18.0},
    "serve-768-f64.fair-0.20": {"map_snr_db": 8.0, "frame_snr_db": 18.0},
    "serve-768-f64.cycle-0.35": {"map_snr_db": 8.0},
}
# A 64x64 map at coverage 0.35 holds few clouds: the tiny runs raise it.
TINY_TRAFFIC = {"broken-0.35": {"coverage": 0.7}, "cycle-0.35": {"coverage": 0.7}}
# The tiny runs' scene-cut cell: broken-0.35 at their coverage, a cut at
# every cycle boundary (at_frame 0, where the program renders whole maps)
# that skips an hour. Each cut draws a new sun, and at the tiny sizes the
# march's error in the viewed part of the map swings with it, so frames
# read lower than the cut-free cell's and take a limit of their own
# (readings in test_skybench_tiny.py).
TINY_CUT_CELL = "serve-768-f64.cut-tiny"
TINY_CUT = {"after_cycles": 1, "at_frame": 0, "time_skip_s": 3600.0}
TINY_CUT_LIMITS = {"map_snr_db": 8.0, "frame_snr_db": 4.0}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def make_root(path, sizes=TINY, mixes=TINY_TRAFFIC, limits=TINY_LIMITS) -> str:
    """A checkout-shaped folder at path: BENCHMARK.json and skybench's
    traffic, limit and metric files copied, each configuration at `sizes`,
    each mix changed by `mixes` and each cell's limits by `limits`."""
    sky = os.path.join(path, "skybench")
    for sub in ("traffic", "metrics", "limits"):
        shutil.copytree(os.path.join(ROOT, "skybench", sub), os.path.join(sky, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    os.makedirs(os.path.join(sky, "configs"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), path)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for entry in bench["configs"]:
        with open(os.path.join(ROOT, entry["file"])) as f:
            cfg = json.load(f)
        cfg.update(sizes.get(entry["name"], {}))
        with open(os.path.join(path, entry["file"]), "w") as f:
            json.dump(cfg, f)
    for name, change in mixes.items():
        mix_path = os.path.join(sky, "traffic", name + ".json")
        with open(mix_path) as f:
            mix = json.load(f)
        with open(mix_path, "w") as f:
            json.dump(dict(mix, **change), f)
    for cell, lim in limits.items():
        with open(os.path.join(sky, "limits", cell + ".json"), "w") as f:
            json.dump(lim, f)
    return str(path)


def add_serve_cell(root: str, cell: str, config: str, traffic: str, mix: dict,
                   limits: dict, end_to_end=("frame_ms", "frame_p99_ms")) -> None:
    """Add a serving cell to the checkout-shaped folder at root by files
    and entries alone: its mix and limits files, its `workloads` entry,
    and its name in the lists of the end-to-end metrics it reports."""
    sky = os.path.join(root, "skybench")
    with open(os.path.join(sky, "traffic", traffic + ".json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(sky, "limits", cell + ".json"), "w") as f:
        json.dump(limits, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                               "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] in end_to_end:
            m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


# A reader of the window's cut ticks, as a scene-cut cell would bring:
# their mean wall time (ms), from the ticks the kind labels "cut".
CUT_TICK_READER = '''def read(layer):
    ms = [t for t, label, _ in layer.get("ticks", []) if label == "cut"]
    return sum(ms) / len(ms) if ms else None
'''


def add_cut_tick_reader(root: str, cell: str) -> None:
    """Add `cut_tick_ms.serve` (CUT_TICK_READER) for `cell`, by a file and
    a `per_layer` entry."""
    with open(os.path.join(root, "skybench", "metrics", "cut_tick_ms.serve.py"), "w") as f:
        f.write(CUT_TICK_READER)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "cut_tick_ms.serve", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "engine tick",
                               "moves": "frame_ms", "workloads": [cell]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


@pytest.fixture
def tiny_cut_root(tmp_path):
    """The tiny root with the tiny scene-cut cell and its cut-tick reader
    added."""
    root = make_root(tmp_path)
    with open(os.path.join(root, "skybench", "traffic", "broken-0.35.json")) as f:
        mix = json.load(f)
    add_serve_cell(root, TINY_CUT_CELL, "serve-768-f64", "cut-tiny",
                   dict(mix, serve=dict(mix["serve"], cut=TINY_CUT)), TINY_CUT_LIMITS)
    add_cut_tick_reader(root, TINY_CUT_CELL)
    return root
