"""Everything a cell needs is found by name, and a later change adds a
cell, a configuration, a traffic mix and a per-layer metric by adding
files and entries alone."""

import json
import os
import re

import pytest

from skybench import run, traffic
from skybench.tests.conftest import ROOT, add_cut_tick_reader, add_serve_cell, make_root

BENCH = run.load_benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    r = run.resolve(BENCH, cell, ROOT)
    assert r["traffic"]["kind"] in ("serve", "cycle")
    limits = r["config"]["limits"]
    assert limits and all(isinstance(v, float) for v in limits.values())
    assert set(r["end_to_end"]) >= {"setup_s"} and len(r["end_to_end"]) >= 2
    assert set(r["end_to_end"]) - {"setup_s"} <= set(r["kind"].END_TO_END)
    assert r["per_layer"], "a cell reports at least one per-layer metric"
    for m in r["per_layer"]:
        assert callable(run.reader(m["name"], ROOT))
        assert m["moves"] in r["end_to_end"]
        assert m["name"] and run.reader(m["name"], ROOT)({}) is None


def test_benchmark_json_keeps_to_its_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(n for n in [x["name"] for x in BENCH["workloads"]])) == len(BENCH["workloads"])
    for e in BENCH["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("skybench/")
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, "skybench", "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(ROOT, "skybench", "limits", w["name"] + ".json"))
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path):
    """A new configuration, mix and metric beside the existing files:
    nothing that exists is edited, and the new cell resolves and runs
    its reader."""
    root = make_root(tmp_path)
    before = {p: open(os.path.join(root, p), "rb").read()
              for p in ("skybench/traffic/broken-0.35.json",
                        "skybench/metrics/device_idle.serve.py")}
    with open(os.path.join(root, "skybench/configs/serve-768-f16.json"), "w") as f:
        cfg = json.load(open(os.path.join(root, "skybench/configs/serve-768-f64.json")))
        json.dump(dict(cfg, frames_to_update=16), f)
    with open(os.path.join(root, "skybench/traffic/storm-0.90.json"), "w") as f:
        mix = json.load(open(os.path.join(root, "skybench/traffic/broken-0.35.json")))
        json.dump(dict(mix, coverage=0.9), f)
    with open(os.path.join(root, "skybench/limits/serve-768-f16.storm-0.90.json"), "w") as f:
        json.dump({"map_snr_db": 4.0, "frame_snr_db": 16.0}, f)
    with open(os.path.join(root, "skybench/metrics/ticks.serve.py"), "w") as f:
        f.write("def read(layer):\n    return float(len(layer.get('ticks', []))) or None\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append({"name": "serve-768-f16", "source": "x",
                             "file": "skybench/configs/serve-768-f16.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "serve-768-f16.storm-0.90", "config": "serve-768-f16",
                               "traffic": "storm-0.90", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if "frame_ms" in m["name"]:
            m["workloads"].append("serve-768-f16.storm-0.90")
    bench["per_layer"].append({"name": "ticks.serve", "unit": "ticks", "better": "higher",
                               "source": "host_clock", "layer": "engine tick",
                               "moves": "frame_ms", "workloads": ["serve-768-f16.storm-0.90"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    r = run.resolve(run.load_benchmark(root), "serve-768-f16.storm-0.90", root)
    assert r["config"]["frames_to_update"] == 16 and r["traffic"]["coverage"] == 0.9
    assert r["config"]["limits"]["frame_snr_db"] == 16.0 and r["kind"].END_TO_END[0] == "frame_ms"
    assert [m["name"] for m in r["per_layer"]] == ["ticks.serve"]
    assert run.reader("ticks.serve", root)({"ticks": [1, 2, 3]}) == 3.0
    for p, data in before.items():
        assert open(os.path.join(root, p), "rb").read() == data


def test_a_cut_cell_is_added_by_files_and_entries_alone(tmp_path):
    """A scene-cut cell (broken-0.35 with a `cut` block, as `cut-0.35`),
    its limits and a reader of its cut ticks beside the existing files:
    no existing file under skybench/ is edited, and the cell resolves,
    plans its cuts, checks the keys broken-0.35 checks and reads its cut
    ticks."""
    root = make_root(tmp_path, sizes={})
    sky = os.path.join(root, "skybench")
    before = {os.path.join(d, n): open(os.path.join(d, n), "rb").read()
              for d, _, names in os.walk(sky) for n in names}
    mix = json.load(open(os.path.join(sky, "traffic", "broken-0.35.json")))
    cut = {"after_cycles": 1, "at_frame": 32, "time_skip_s": 3600.0}
    limits = json.load(open(os.path.join(sky, "limits", "serve-768-f64.broken-0.35.json")))
    cell = "serve-768-f64.cut-0.35"
    add_serve_cell(root, cell, "serve-768-f64", "cut-0.35",
                   dict(mix, serve=dict(mix["serve"], cut=cut)), limits, end_to_end=("frame_ms",))
    add_cut_tick_reader(root, cell)
    r = run.resolve(run.load_benchmark(root), cell, root)
    assert r["traffic"]["kind"] == "serve" and r["kind"].END_TO_END[0] == "frame_ms"
    assert r["end_to_end"] == ["frame_ms", "setup_s"]
    assert set(r["config"]["limits"]) == {"map_snr_db", "frame_snr_db"}
    assert [m["name"] for m in r["per_layer"]] == ["cut_tick_ms.serve"]
    plan = traffic.serve_plan(r["traffic"], 2 ** 33 + 5, r["config"]["frames_to_update"])
    assert plan.cut_period == 96 and plan.is_cut(96) and plan.where(96 + 40) == (1, 0, 40)
    ticks = [(2.0, "bake:none", "v3"), (180.0, "cut", "dense"), (220.0, "cut", "dense")]
    assert run.reader("cut_tick_ms.serve", root)({"ticks": ticks}) == 200.0
    assert run.reader("cut_tick_ms.serve", root)({}) is None
    for p, data in before.items():
        assert open(p, "rb").read() == data, p
